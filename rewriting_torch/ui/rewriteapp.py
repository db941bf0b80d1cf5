"""GanRewriteApp: the interactive rewriting interface.

The port's counterpart of the JAX package's ``ui/rewriteapp.py``, over
the port's rewriters (on the card by default) and its own
``utils/renormalize``: the rewriter renders uint8 arrays, and the
canvases hold them as PNG data URLs.

A rebuild of reference rewrite/rewriteapp.py: a grid of canvases
rendering samples from the (edited) generator, paint-to-select copy /
paste / context-key trays, key search, solve-parameter textboxes, execute
change / erase / overfit buttons, toggle-original, and save/load of the
edit-request JSON (format verbatim: {"object": [imgnum, mask_url],
"paste": [...], "key": [[imgnum, mask_url], ...]}).

All interaction logic is plain Python on Properties, so the app is fully
drivable headless (tests) and renders as widgets in Jupyter."""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

import numpy as np

from ..utils import renormalize
from .labwidget import (Button, Datalist, Div, Image, Label, Menu, Property,
                        Textbox, Trigger, Widget, block_events)
from .paintwidget import PaintWidget


class GanRewriteApp(Widget):
    loss = Property(0.0)
    status = Property("ready")
    original_shown = Property(False)

    def __init__(self, gw, size: int = 256, mask_dir: str = "masks",
                 num_canvases: int = 9, **kwargs):
        super().__init__(**kwargs)
        self.gw = gw
        self.size = size
        self.mask_dir = mask_dir
        self.num_canvases = num_canvases

        # selection state (the edit request under construction)
        self.object_selection: Optional[Tuple[int, str]] = None
        self.paste_selection: Optional[Tuple[int, str]] = None
        self.key_selections: List[Tuple[int, str]] = []

        # search-highlight state (reference rewriteapp.py:125-131, 263-282)
        self.query_key = None
        self.query_rq = None
        self.query_vis = False

        # widgets
        self.canvases = [PaintWidget(width=size, height=size,
                                     oneshot=True)
                         for _ in range(num_canvases)]
        self.snap_images = [Image() for _ in range(num_canvases)]
        self.current_mask_item: Optional[int] = None
        for i, c in enumerate(self.canvases):
            c.on("mask", self._make_mask_cb(i))
        self.canvas_imgnums = list(range(num_canvases))
        self.object_tray = PaintWidget(width=size, height=size,
                                       disabled=True)
        self.paste_tray = PaintWidget(width=size, height=size,
                                      disabled=True)
        self.key_tray = Div()
        self.keytray_menu = Menu(choices=[])
        self.rank_box = Textbox("1", size=4)
        self.niter_box = Textbox("2001", size=6)
        self.piter_box = Textbox("10", size=4)
        self.lr_box = Textbox("0.05", size=6)
        self.query_box = Textbox("", size=24)
        self.imgnum_box = Textbox(f"0-{num_canvases - 1}", size=24)
        self.imgnum_box.on("value", lambda _: self.change_numbers())
        self.brushsize_box = Textbox("10", size=3)
        self.brushsize_box.on("value", lambda _: self.change_brushsize())
        self.saved_list = Datalist(choices=self.saved_names())
        self.loss_label = Label("")
        self.exec_button = Button("Execute Change")
        self.erase_button = Button("Execute Erase")
        self.overfit_button = Button("Execute Overfit")
        self.toggle_button = Button("Toggle Original")
        self.revert_button = Button("Revert")
        self.prev_button = Button("Prev")
        self.next_button = Button("Next")
        self.snap_button = Button("Snap")
        self.highlight_button = Button("Toggle Highlight")
        self.keyremove_button = Button("Remove Key")
        self.save_button = Button("Save")
        self.load_button = Button("Load")
        self.exec_button.on("click", lambda _: self.exec_request())
        self.erase_button.on("click", lambda _: self.exec_erase())
        self.overfit_button.on("click", lambda _: self.exec_overfit())
        self.toggle_button.on("click", lambda _: self.toggle_original())
        self.revert_button.on("click", lambda _: self.revert())
        self.prev_button.on("click", lambda _: self.prev_page())
        self.next_button.on("click", lambda _: self.next_page())
        self.snap_button.on("click", lambda _: self.snapshot_images())
        self.highlight_button.on("click", lambda _: self.toggle_highlight())
        self.keyremove_button.on("click", lambda _: self.keytray_remove())
        self.save_button.on("click", lambda _: self.save_by_name())
        self.load_button.on("click", lambda _: self.load_by_name())
        self._snapshot_params = None
        self.repaint_canvas_array()

    def _make_mask_cb(self, index):
        def cb(mask):
            if mask:
                self.current_mask_item = index
        return cb

    # -- canvases ----------------------------------------------------------------
    def repaint_canvas_array(self):
        """Render current model samples into the canvases; when highlight
        mode is on, overlay the active search key's response heatmap at its
        0.999 quantile level (reference rewriteapp.py:263-282)."""
        level = None
        if self.query_vis and self.query_rq is not None:
            level = float(np.asarray(
                self.query_rq.quantiles([0.999]))[0, 0])
        imgs = self.gw.render_image_batch(
            self.canvas_imgnums,
            key=self.query_key if self.query_vis else None, level=level,
            border_color=(255, 255, 255))
        for canvas, img in zip(self.canvases, imgs):
            canvas.image = renormalize.as_url(img)
            canvas.mask = ""
        for canvas in self.canvases[len(imgs):]:
            canvas.image = ""
            canvas.mask = ""
        self.current_mask_item = None  # repaint cleared every mask

    def show_images(self, imgnums):
        self.canvas_imgnums = list(imgnums)[:self.num_canvases]
        self.repaint_canvas_array()

    def change_numbers(self):
        """Parse the imgnum textbox ('0-8,12,20-22') into the canvas page
        (reference change_numbers, rewriteapp.py:293-308)."""
        sel = []
        for part in str(self.imgnum_box.value).split(","):
            p = part.split("-")
            try:
                lo = int(p[0])
                hi = int(p[1]) if len(p) > 1 else lo
            except ValueError:
                continue
            sel.extend(i for i in range(lo, hi + 1)
                       if 0 <= i < len(self.gw.zds))
            if len(sel) >= self.num_canvases:
                break
        self.canvas_imgnums = sel[:self.num_canvases]
        self.repaint_canvas_array()
        self.clear_images()

    def _set_page(self, imgnums):
        self.canvas_imgnums = imgnums
        # update the textbox (including the browser view) without
        # re-triggering the change_numbers listener
        with block_events():
            self.imgnum_box.value = ",".join(str(i) for i in imgnums)
        self.repaint_canvas_array()

    def next_page(self):
        """Page the canvases forward by one screenful."""
        start = (max(self.canvas_imgnums) + 1 if self.canvas_imgnums else 0)
        if start >= len(self.gw.zds):
            return
        end = min(start + self.num_canvases, len(self.gw.zds))
        self._set_page(list(range(start, end)))

    def prev_page(self):
        start = (min(self.canvas_imgnums) if self.canvas_imgnums
                 else len(self.gw.zds))
        lo = max(0, start - self.num_canvases)
        if lo == start:
            return
        self._set_page(list(range(lo, lo + self.num_canvases)))

    def change_brushsize(self):
        """(reference change_brushsize, rewriteapp.py:148-151)"""
        size = float(self.brushsize_box.value)
        for c in self.canvases:
            c.brushsize = size

    def snapshot_images(self):
        """Freeze current canvases into the snap row (reference
        snapshot_images, rewriteapp.py:285-287)."""
        for canvas, snap in zip(self.canvases, self.snap_images):
            snap.src = canvas.image

    def clear_images(self):
        for snap in self.snap_images:
            snap.src = ""

    def toggle_highlight(self):
        """Toggle the inline search-heatmap overlay (reference
        toggle_highlight, rewriteapp.py:348-352)."""
        self.query_vis = not self.query_vis
        self.repaint_canvas_array()

    # -- selections -----------------------------------------------------------------
    def _active_canvas(self, canvas_index):
        """Explicit index, or the canvas last painted on (reference
        current_mask_item tracking, rewriteapp.py:332-346)."""
        if canvas_index is None:
            canvas_index = self.current_mask_item
        assert canvas_index is not None, "paint a mask first"
        return canvas_index

    def pick_object(self, canvas_index: Optional[int] = None):
        """'Copy': record (imgnum, mask) painted on a canvas (reference
        exec_object path, rewriteapp.py:406-431)."""
        canvas_index = self._active_canvas(canvas_index)
        c = self.canvases[canvas_index]
        assert c.mask, "paint a mask first"
        imgnum = self.canvas_imgnums[canvas_index]
        self.object_selection = (imgnum, c.mask)
        self.object_tray.image = c.image
        self.object_tray.mask = c.mask
        self.status = f"object from image {imgnum}"
        return self.object_selection

    def pick_paste(self, canvas_index: Optional[int] = None):
        """'Paste': record the target location (reference exec_paste,
        rewriteapp.py:457-478) and preview the composite."""
        canvas_index = self._active_canvas(canvas_index)
        c = self.canvases[canvas_index]
        assert c.mask, "paint a mask first"
        imgnum = self.canvas_imgnums[canvas_index]
        self.paste_selection = (imgnum, c.mask)
        self.paste_tray.image = c.image
        self.paste_tray.mask = c.mask
        self.status = f"paste at image {imgnum}"
        if self.object_selection is not None:
            o_imgnum, o_mask = self.object_selection
            obj_acts, _, obj_area, _ = self.gw.object_from_selection(
                o_imgnum, o_mask)
            _, _, viz_out, _ = self.gw.paste_from_selection(
                imgnum, c.mask, obj_acts, obj_area)
            img = self.gw.render_object(viz_out)
            self.paste_tray.image = renormalize.as_url(img)
        return self.paste_selection

    def add_key(self, canvas_index: Optional[int] = None):
        """Add a painted context example; re-painting an imgnum replaces
        its mask (reference key_add, rewriteapp.py:246-261)."""
        canvas_index = self._active_canvas(canvas_index)
        c = self.canvases[canvas_index]
        assert c.mask, "paint a mask first"
        imgnum = self.canvas_imgnums[canvas_index]
        self.key_selections = [(i, m) for i, m in self.key_selections
                               if i != imgnum] + [(imgnum, c.mask)]
        self.status = f"{len(self.key_selections)} context keys"
        self.repaint_key_tray()
        return self.key_selections[-1]

    def clear_keys(self):
        self.key_selections = []
        self.repaint_key_tray()

    # -- key tray -------------------------------------------------------------------
    def repaint_key_tray(self):
        """Sync the key-tray menu + summary div with the selections
        (reference repaint_key_tray, rewriteapp.py:171-195)."""
        imgnums = [i for i, _ in self.key_selections]
        with block_events():
            self.keytray_menu.choices = imgnums
            sel = self.keytray_menu.selection
            # the browser sends selections as strings; tolerate both
            try:
                sel = int(sel)
            except (TypeError, ValueError):
                sel = None
            if sel not in imgnums:
                self.keytray_menu.selection = (imgnums[-1] if imgnums
                                               else None)
        self.key_tray.innerHTML = " ".join(
            f'<span data-click="{i}">key:{i}</span>' for i in imgnums)

    def keytray_remove(self, imgnum: Optional[int] = None):
        """Remove the selected (or given) context example (reference
        keytray_remove, rewriteapp.py:208-222)."""
        if imgnum is None:
            imgnum = self.keytray_menu.selection
        if imgnum is None:
            return
        imgnum = int(imgnum)
        before = len(self.key_selections)
        self.key_selections = [(i, m) for i, m in self.key_selections
                               if i != imgnum]
        if len(self.key_selections) != before:
            with block_events():
                self.keytray_menu.selection = None
            self.repaint_key_tray()
            self.status = f"{len(self.key_selections)} context keys"

    def keytray_show(self):
        """Page the canvases to the context-key images (reference
        keytray_show, rewriteapp.py:224-229)."""
        if self.key_selections:
            self._set_page([i for i, _ in self.key_selections]
                           [:self.num_canvases])

    def clear_object(self):
        self.object_selection = None
        self.object_tray.image = ""
        self.object_tray.mask = ""

    def clear_paste(self):
        self.paste_selection = None
        self.paste_tray.image = ""
        self.paste_tray.mask = ""

    def search(self, canvas_index: Optional[int] = None, k: int = None):
        """'Search': rank images by response to the painted key; stores the
        key + its response-quantile sketch so Toggle Highlight can overlay
        heatmaps inline (reference keytray_query/exec_query,
        rewriteapp.py:231-235, 389-404)."""
        k = k or self.num_canvases
        painted = (self.current_mask_item is not None
                   and self.canvases[self.current_mask_item].mask)
        if canvas_index is not None or painted:
            canvas_index = self._active_canvas(canvas_index)
            c = self.canvases[canvas_index]
            assert c.mask, "paint a mask first"
            imgnum = self.canvas_imgnums[canvas_index]
            key = self.gw.query_key_from_selection(imgnum, c.mask)
        else:
            assert self.key_selections, "no key painted"
            imgnum, mask = self.key_selections[-1]
            key = self.gw.query_key_from_selection(imgnum, mask)
        ranking, rq = self.gw.ranking_for_key(key, k=k)
        self.query_key = key
        self.query_rq = rq
        self.show_images([int(i) for i in np.asarray(ranking)[:k]])
        return ranking

    # -- the request -------------------------------------------------------------
    def current_request(self) -> dict:
        """UI-format JSON edit request (reference rewriteapp.py:570-574)."""
        assert self.paste_selection is not None, "no paste selection"
        req = {"paste": list(self.paste_selection)}
        if self.object_selection is not None:
            req["object"] = list(self.object_selection)
        if self.key_selections:
            req["key"] = [list(p) for p in self.key_selections]
        return req

    def save_request(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.current_request(), f, indent=1)

    def load_request(self, path: str):
        with open(path) as f:
            req = json.load(f)
        self.paste_selection = tuple(req["paste"])
        self.object_selection = (tuple(req["object"])
                                 if "object" in req else None)
        self.key_selections = [tuple(p) for p in req.get("key", [])]
        self.repaint_key_tray()
        return req

    # -- saved-mask directory browsing (reference rewriteapp.py:550-587) --------
    def saved_names(self) -> List[str]:
        """Names of saved edit requests in mask_dir (reference
        saved_names, rewriteapp.py:565-568)."""
        if not os.path.isdir(self.mask_dir):
            return []
        return sorted(n[:-5] for n in os.listdir(self.mask_dir)
                      if n.endswith(".json"))

    def save_by_name(self, name: Optional[str] = None):
        name = name or self.saved_list.value
        if not name:
            return
        self.save_request(os.path.join(self.mask_dir, f"{name}.json"))
        self.saved_list.choices = self.saved_names()
        self.status = f"saved as {name}"

    def load_by_name(self, name: Optional[str] = None):
        name = name or self.saved_list.value
        if not name or name not in self.saved_names():
            return
        self.load_request(os.path.join(self.mask_dir, f"{name}.json"))
        self.status = f"loaded {name}; exec to execute model change"

    # -- edit execution ------------------------------------------------------------
    def _solve_args(self):
        return dict(rank=int(self.rank_box.value),
                    niter=int(self.niter_box.value),
                    piter=int(self.piter_box.value),
                    lr=float(self.lr_box.value))

    def _loss_cb(self, it, loss):
        if it % 50 == 0:
            self.loss = float(loss)
            self.loss_label.value = f"iter {it} loss {float(loss):.4f}"

    def exec_request(self):
        """'Execute Change' (reference exec_request,
        rewriteapp.py:504-527)."""
        args = self._solve_args()
        self.status = "solving..."
        self.gw.apply_edit(self.current_request(),
                           update_callback=self._loss_cb, **args)
        self.status = "edited"
        self.repaint_canvas_array()

    def exec_erase(self, drank: int = 30):
        """(reference exec_erase, rewriteapp.py:480)"""
        args = self._solve_args()
        self.status = "erasing..."
        self.gw.apply_erase(self.current_request(), drank=drank,
                            update_callback=self._loss_cb, **args)
        self.status = "erased"
        self.repaint_canvas_array()

    def exec_overfit(self, niter: int = 20001, lr: float = 0.01):
        """(reference exec_overfit, rewriteapp.py:529)"""
        self.status = "overfitting..."
        self.gw.apply_overfit(self.current_request(), niter=niter, lr=lr,
                              update_callback=self._loss_cb)
        self.status = "overfit"
        self.repaint_canvas_array()

    # -- original toggling ---------------------------------------------------------
    def toggle_original(self):
        """Swap edited and pristine weights (reference rewriteapp.py:354-360,
        state-dict snapshot semantics 263-282); the params are dicts of
        device tensors, swapped whole, never copied."""
        if not self.original_shown:
            self._snapshot_params = self.gw.params
            self.gw.params = dict(self.gw.original_params)
            self.original_shown = True
        else:
            self.gw.params = self._snapshot_params
            self.original_shown = False
        self.repaint_canvas_array()

    def revert(self):
        self.gw.revert()
        self.original_shown = False
        self.repaint_canvas_array()

    # -- rendering --------------------------------------------------------------------
    def widget_html(self):
        rows = []
        rows.append("<div>images " + self.imgnum_box.widget_html()
                    + self.prev_button.widget_html()
                    + self.next_button.widget_html()
                    + " brush " + self.brushsize_box.widget_html()
                    + self.snap_button.widget_html()
                    + self.highlight_button.widget_html() + "</div>")
        rows.append("<div>" + "".join(
            c.widget_html() for c in self.canvases) + "</div>")
        rows.append("<div>" + "".join(
            s.widget_html() for s in self.snap_images) + "</div>")
        rows.append("<div>object:" + self.object_tray.widget_html()
                    + " paste:" + self.paste_tray.widget_html()
                    + " keys:" + self.key_tray.widget_html()
                    + self.keytray_menu.widget_html()
                    + self.keyremove_button.widget_html() + "</div>")
        controls = [("rank", self.rank_box), ("niter", self.niter_box),
                    ("piter", self.piter_box), ("lr", self.lr_box)]
        rows.append("<div>" + "".join(
            f"{name} {w.widget_html()}" for name, w in controls)
            + "</div>")
        rows.append("<div>" + "".join(
            b.widget_html() for b in [self.exec_button, self.erase_button,
                                      self.overfit_button,
                                      self.toggle_button,
                                      self.revert_button])
            + self.loss_label.widget_html() + "</div>")
        rows.append("<div>saved: " + self.saved_list.widget_html()
                    + self.save_button.widget_html()
                    + self.load_button.widget_html() + "</div>")
        return f'<div {self.std_attrs()}>' + "".join(rows) + "</div>"

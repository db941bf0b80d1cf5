"""The port's notebook UI (``rewriting_torch/ui``): the widget protocol of
tests/test_ui.py, and the rewriting app's headless flow against the JAX
package's app.

Both apps run over the toy ProgGAN of tests/test_ui.py (sizes
[16, 16, 8, 8], JAX key 3; the port's params converted from the JAX
tree) at layer 3, 20 z, four 16-pixel canvases, and get the same masks.
Canvases are compared as decoded pixels, not as data-URL strings (the
two PNG encoders differ):
- the canvases and the paste tray's composite within 1 LSB of the JAX
  app's; the request JSON equal;
- after ``exec_request`` (31 steps) each app's canvases equal its own
  rewriter's renders, and the two apps' lie within 8 LSB (mean under 1):
  the L1 solves on the request's own goal land whole Adam steps apart
  where the residual's sign is a rounding tie
  (tests/test_torch_serve.py);
- toggling the original shows the pre-edit canvases exactly and back;
- Search ranks the same images as the JAX app; the highlight overlay
  within 1 LSB of it; erase and overfit run and repaint; revert restores
  the first canvases exactly.
"""

import base64
import json
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from conftest import blob
from rewriting_tpu.models import ProgressiveGenerator as JaxProgGAN
from rewriting_tpu.rewrite import ProgressiveGanRewriter as JaxRewriter
from rewriting_tpu.ui import GanRewriteApp as JaxApp
from rewriting_tpu.utils.zdataset import z_dataset_for_model as jax_zds
from rewriting_torch.convert import params_from_jax
from rewriting_torch.models import ProgressiveGenerator
from rewriting_torch.rewrite import ProgressiveGanRewriter
from rewriting_torch.ui import (Button, Checkbox, Choice, ClickDiv, Datalist,
                                Div, GanRewriteApp, Image, Label, Menu, Model,
                                PaintWidget, Property, Range, Textarea,
                                Textbox, Trigger)
from rewriting_torch.ui.labwidget import capture_output
from rewriting_torch.utils.renormalize import decode_png, mask_to_url
from rewriting_torch.utils.zdataset import z_dataset_for_model

torch.set_num_threads(1)

LSB = 1
EDITED_LSB, EDITED_MEAN_LSB = 8, 1.0


def pixels(url):
    """The uint8 pixels of a PNG data URL."""
    data = base64.b64decode(re.sub("^data:image/.+;base64,", "", url))
    return decode_png(data).astype(np.int16)


# -- the widget protocol -------------------------------------------------------

def test_property_notification_and_independence():
    class M(Model):
        x = Property(1)
        fire = Trigger()

    m, other = M(), M()
    seen = []
    m.on("x", seen.append)
    m.x = 5
    assert m.x == 5 and seen == [5] and other.x == 1
    m.off("x", seen.append)
    m.x = 7
    assert seen == [5]
    events = []
    m.on("fire", events.append)
    m.trigger("fire", "boom")
    assert events == ["boom"] and m.fire is None


def test_widgets_render_and_bind():
    b = Button("Go")
    html = b._repr_html_()
    assert "Go" in html and b._view_id in html and "<script>" in html
    hits = []
    b.on("click", hits.append)
    b.set("click", True, _from_view=True)
    assert hits == [True]
    assert 'value="hello"' in Textbox("hello")._repr_html_()
    assert ">L</span>" in Label("L").widget_html()
    d = Div()
    d.show("<b>hi</b>")
    assert "<b>hi</b>" in d.widget_html()
    img = Image()
    img.render(np.zeros((4, 4, 3), np.float32))
    np.testing.assert_array_equal(pixels(img.src), np.full((4, 4, 3), 127))
    img.render(np.full((4, 4, 3), 200, np.uint8))
    np.testing.assert_array_equal(pixels(img.src), np.full((4, 4, 3), 200))
    ta = Textarea(value="hello\nworld", rows=3, cols=40)
    assert "<textarea" in ta._repr_html_() and 'rows="3"' in \
        ta._repr_html_()
    m = Menu(choices=["a", "b<c"], selection="b<c")
    assert "b&lt;c" in m._repr_html_() and "selected" in m._repr_html_()
    m.choices = ["x", "y"]
    assert "x" in m._repr_html_()
    dl = Datalist(choices=["one", "two"], value="one")
    assert "<datalist" in dl._repr_html_() and dl.datalist_id() in \
        dl._repr_html_()
    cd = ClickDiv(innerHTML='<span data-click="unit3">u3</span>')
    clicks = []
    cd.on("click", clicks.append)
    cd.set("click", "unit3", _from_view=True)
    assert clicks == ["unit3"]


def test_paintwidget_mask():
    p = PaintWidget(width=16, height=16)
    p.set_image(np.zeros((16, 16, 3), np.float32))
    assert p.image.startswith("data:image/png")
    url = mask_to_url(blob(16, 16, 8, 8, 4))
    p.set("mask", url, _from_view=True)
    assert p.mask == url
    p.clear()
    assert p.mask == ""
    p.set_image(np.full((16, 16, 3), 9, np.uint8))
    np.testing.assert_array_equal(pixels(p.image), np.full((16, 16, 3), 9))


def test_block_events_and_capture_output():
    a, b = Textbox(), Textbox()
    cascade = []
    b.on("value", cascade.append)
    a.on("value", lambda v: setattr(b, "value", f"derived-{v}"))
    a.value = "top"
    assert b.value == "derived-top" and cascade == []
    b.value = "direct"
    assert cascade == ["direct"]
    btn = Button("go")
    writes = []
    btn.on("write", writes.append)
    with capture_output(btn):
        print("hello from handler")
    assert len(writes) == 1 and "hello from handler" in writes[0]
    with pytest.raises(RuntimeError):
        with capture_output(btn):
            raise RuntimeError("boom")
    assert len(writes) == 2 and "boom" in writes[1]


def test_comm_protocol_roundtrip():
    tb = Textbox(value="init")

    class FakeComm:
        def __init__(self):
            self.sent = []

        def send(self, data):
            self.sent.append(data)

        def on_msg(self, fn):
            return fn

    comm = FakeComm()
    object.__setattr__(tb, "_comm", comm)
    tb.value = "from-python"
    assert {"name": "value", "value": "from-python"} in comm.sent
    n_sent = len(comm.sent)
    seen = []
    tb.on("value", seen.append)
    tb.set("value", "from-view", _from_view=True)
    assert tb.value == "from-view" and seen == ["from-view"]
    assert len(comm.sent) == n_sent


def test_widget_js_is_well_formed():
    """Balanced delimiters outside string literals, and every element id
    the JS looks up exists in the widget's HTML (tests/test_ui.py's
    lint)."""
    pairs = {")": "(", "]": "[", "}": "{"}
    for cls in (Button, Checkbox, Choice, ClickDiv, Datalist, Div, Image,
                Label, Menu, Range, Textarea, Textbox, PaintWidget):
        w = cls()
        js, html = w.widget_js(), w._repr_html_()
        stack, in_str, i = [], None, 0
        while i < len(js):
            c = js[i]
            if in_str:
                if c == "\\":
                    i += 2
                    continue
                if c == in_str:
                    in_str = None
            elif c in "'\"":
                in_str = c
            elif c in "([{":
                stack.append(c)
            elif c in ")]}":
                assert stack and stack[-1] == pairs[c], cls.__name__
                stack.pop()
            i += 1
        assert not stack and in_str is None, cls.__name__
        for ref in re.findall(r'getElementById\("([^"]+)"\)', js):
            assert f'id="{ref}"' in html, (cls.__name__, ref)


def test_ipython_is_imported_only_to_display():
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys, rewriting_torch.ui; "
         "print(sorted(n for n in sys.modules if n.split('.')[0] in "
         "('IPython', 'matplotlib', 'PIL', 'jax')))"],
        capture_output=True, text=True, timeout=120,
        cwd=os.path.join(os.path.dirname(__file__), ".."))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


# -- the app, headless, against the JAX app ------------------------------------

@pytest.fixture(scope="module")
def apps():
    jm = JaxProgGAN(sizes=[16, 16, 8, 8])
    jparams = jm.init_params(jax.random.PRNGKey(3))
    jgw = JaxRewriter(jm, jparams, jax_zds(jm, 20), layernum=3,
                      stats_batch_size=10)
    tm = ProgressiveGenerator(sizes=[16, 16, 8, 8], device="cpu")
    params = params_from_jax(tm, jax.tree_util.tree_map(np.asarray,
                                                        jparams))
    gw = ProgressiveGanRewriter(tm, params, z_dataset_for_model(tm, 20),
                                layernum=3, stats_batch_size=10,
                                device="cpu")
    return (GanRewriteApp(gw, size=16, num_canvases=4),
            JaxApp(jgw, size=16, num_canvases=4))


def canvases(app):
    return np.stack([pixels(c.image) for c in app.canvases])


def gap(a, b):
    return int(np.abs(a - b).max())


def _paint(app, index, cy, cx, r):
    h, w = app.gw.v_shape[1:3]
    app.canvases[index].set("mask", mask_to_url(blob(h, w, cy, cx, r)),
                            _from_view=True)


def test_app_flow_against_jax(apps, tmp_path):
    app, japp = apps
    first = canvases(app)
    assert first.shape == (4, 16, 16, 3)
    assert gap(first, canvases(japp)) <= LSB
    assert "Execute Change" in app.widget_html()
    for a in (app, japp):
        _paint(a, 0, 2, 2, 2)
        a.pick_object()
        _paint(a, 1, 5, 5, 2)
        a.pick_paste(1)
        _paint(a, 1, 5, 5, 3)
        a.add_key(1)
    assert app.current_request() == japp.current_request()
    assert gap(pixels(app.paste_tray.image),
               pixels(japp.paste_tray.image)) <= LSB
    path = str(tmp_path / "edit.json")
    app.save_request(path)
    app.clear_keys()
    assert app.load_request(path) == json.loads(json.dumps(
        japp.current_request()))
    for a in (app, japp):
        a.niter_box.value = "31"
        a.exec_request()
        assert a.status == "edited" and a.loss_label.value.startswith("iter")
    edited, jedited = canvases(app), canvases(japp)
    for a, shown in ((app, edited), (japp, jedited)):
        own = np.stack([np.asarray(im) for im in a.gw.render_image_batch(
            a.canvas_imgnums)]).astype(np.int16)
        np.testing.assert_array_equal(shown, own)
    diff = np.abs(edited - jedited)
    assert diff.max() <= EDITED_LSB and diff.mean() <= EDITED_MEAN_LSB
    assert gap(edited, first) > 0
    app.toggle_original()
    assert app.original_shown
    np.testing.assert_array_equal(canvases(app), first)
    app.toggle_original()
    assert not app.original_shown
    np.testing.assert_array_equal(canvases(app), edited)
    app.revert()
    japp.revert()
    np.testing.assert_array_equal(canvases(app), first)


def test_app_search_and_highlight_against_jax(apps):
    app, japp = apps
    h, w = app.gw.k_shape[1:3]
    for a in (app, japp):
        a.show_images(range(4))
        a.canvases[0].set("mask", mask_to_url(blob(h, w, h // 2, w // 2, 2)),
                          _from_view=True)
        a.search(0)
    assert app.canvas_imgnums == japp.canvas_imgnums
    assert all(0 <= i < 20 for i in app.canvas_imgnums)
    assert gap(canvases(app), canvases(japp)) <= LSB
    plain = canvases(app)
    for a in (app, japp):
        a.toggle_highlight()
        assert a.query_vis
    assert gap(canvases(app), plain) > 0
    assert gap(canvases(app), canvases(japp)) <= LSB
    for a in (app, japp):
        a.toggle_highlight()
        a.show_images(range(4))


def test_app_erase_overfit_paging_and_keys(apps, tmp_path):
    app, _ = apps
    first = canvases(app)
    _paint(app, 0, 3, 3, 2)
    app.pick_object(0)
    _paint(app, 1, 5, 5, 2)
    app.pick_paste(1)
    app.niter_box.value = "11"
    app.exec_erase(drank=2)
    assert app.status == "erased" and gap(canvases(app), first) > 0
    app.revert()
    app.exec_overfit(niter=11)
    assert app.status == "overfit"
    app.revert()
    np.testing.assert_array_equal(canvases(app), first)
    app.imgnum_box.value = "2-5,9"
    assert app.canvas_imgnums == [2, 3, 4, 5]
    app.next_page()
    assert app.canvas_imgnums == [6, 7, 8, 9]
    app.prev_page()
    assert app.canvas_imgnums == [2, 3, 4, 5]
    app.show_images(range(4))
    app.brushsize_box.value = "25"
    assert all(c.brushsize == 25 for c in app.canvases)
    app.clear_keys()
    for i in (0, 1):
        _paint(app, i, 3, 3, 2)
        app.add_key(i)
    app.keytray_remove(1)
    assert [i for i, _ in app.key_selections] == [0]
    assert 'data-click="0"' in app.key_tray.innerHTML
    app.snapshot_images()
    assert all(s.src == c.image for s, c in zip(app.snap_images,
                                                app.canvases))
    app.clear_images()
    app.mask_dir = str(tmp_path / "masks")
    app.saved_list.value = "myedit"
    app.save_by_name()
    assert app.saved_names() == ["myedit"]
    app.clear_object()
    app.clear_paste()
    app.load_by_name("myedit")
    assert app.paste_selection is not None
    app.clear_keys()

"""Editing server: an HTTP API over the rewriting engine.

The port's counterpart of the JAX package's ``serve.py``, the serving face
of the system: a long-running process holds the generator and a rewriter
on the card, accepts edit-request JSONs over HTTP, solves them (one at a
time or as one batch) and serves previews as PNGs.

Endpoints (JSON unless noted):
  GET  /status                 -> model/layer/edit info
  POST /edit                   -> {"request": <edit json>, "rank": 1,
                                   "niter": 2001, "method": "insert" |
                                   "fast" | "erase"}; solves and commits
  POST /edit_batch             -> {"requests": [<edit json>, ...]}; solves
                                   all as one batch, returns per-edit
                                   losses; commits nothing
  POST /commit_batch_edit      -> {"index": k}; commits edit k of the batch
  POST /revert                 -> restore pristine weights
  GET  /preview?imgnum=3       -> PNG of the current model's image 3
       [&batch_index=k]           (or of batch edit k)
  POST /save?path=...          -> persist current params (npz, paramio)

Errors come back as JSON: 404 for an unknown path, 500 with the
exception's text for a request that failed.

Threads: ``ThreadingHTTPServer`` serves each request on a thread of its
own.  Every request that touches the rewriter or the card runs under the
service's lock, on the rewriter's device, and waits for the card before
it answers, so a request's device error is its own 500; the process-wide
cuDNN settings of the deterministic solves and the kernels' launch
counters see one request at a time.  ``status`` only reads attributes.

A rewriter with a mesh (``gw.mesh``, ``parallel.make_mesh``) solves
``/edit_batch`` over the mesh's ranks (``batch_apply_edits(mesh=)``).  The
JAX package's server is one controller of its device mesh; the port's is
one process a rank: rank 0 serves HTTP (:func:`serve`), and every other
rank builds the same rewriter (so its statistics are collective) and then
runs :meth:`EditingService.work` until rank 0 stops it.  Rank 0 sends each
collective request (an ``/edit_batch``, or the stop) to the others with
its current edit weight, which the other requests change on rank 0 alone;
every other request stays on rank 0.  A batch that fails on any rank fails
on all of them, so rank 0 answers it with a 500 and every rank goes on
serving.

Command line (runs on the card)::

    python3 -m rewriting_torch.serve --dataset church --layer 8
        [--port 8765] [--toy]

loads the dataset's checkpoint through ``models/zoo.py`` (truncation 0.5)
with 1000 z of statistics; ``--toy`` serves a small seeded ProgGAN and
needs no checkpoint.  Started by ``torchrun`` with more than one rank, it
builds a mesh of them all and serves as above.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from .parallel import comm
from .utils import renormalize


class EditingService:
    """Thread-safe wrapper around a rewriter for serving.  With a mesh on
    the rewriter it is built on every rank, at the same point (it makes
    the job's control group)."""

    def __init__(self, gw):
        self.gw = gw
        self.lock = threading.Lock()
        self.edits_applied = 0
        self._batch_weights = None
        self.mesh = getattr(gw, "mesh", None)
        self._control = None if self.mesh is None else comm.control_group()

    def _collective(self, request):
        """Rank 0: send `request` (an ``/edit_batch``'s arguments, or None
        to stop) and the current edit weight to the other ranks, which
        then take their part in it (:meth:`work`)."""
        if self.mesh is not None:
            comm.broadcast_object(request, self._control)
            comm.broadcast(self.gw.target_weight().contiguous(), 0,
                           self.mesh.group("data"))

    def work(self) -> None:
        """Ranks other than 0: take part in rank 0's collective requests
        until it stops.  A batch that fails raises on every rank
        (``batch_apply_edits``' agreement): rank 0 answers it with a 500,
        and the others go on to the next request."""
        while True:
            request = comm.broadcast_object(None, self._control)
            weight = comm.broadcast(
                torch.empty_like(self.gw.target_weight()).contiguous(), 0,
                self.mesh.group("data"))
            if request is None:
                return
            self.gw.set_target_weight(weight)
            try:
                with self._on_device():
                    self._edit_batch(**request)
            except Exception:   # noqa: BLE001 - rank 0 answers it with a 500
                pass

    def stop_workers(self) -> None:
        """Rank 0: end the other ranks' :meth:`work`."""
        with self.lock:
            self._collective(None)

    @contextlib.contextmanager
    def _on_device(self):
        """The lock, the rewriter's device current, and on success a wait
        for the card (its errors surface in this request)."""
        device = torch.device(self.gw.device)
        with self.lock:
            if device.type != "cuda":
                yield
                return
            with torch.cuda.device(device):
                yield
                torch.cuda.synchronize(device)

    def status(self):
        return {"model": type(self.gw.model).__name__,
                "window": [self.gw.firstlayer, self.gw.lastlayer],
                "edits_applied": self.edits_applied,
                "k_shape": list(self.gw.k_shape),
                "zds_size": len(self.gw.zds)}

    def edit(self, request, rank=1, niter=2001, piter=10, lr=0.05,
             method="insert"):
        # rank 0 serves an edit alone: the statistics it reads (the erase's
        # unit scales, the gandissect key's quantiles) take no collective
        alone = (self.gw.statistics_alone() if self.mesh is not None
                 else contextlib.nullcontext())
        with self._on_device(), alone:
            if method == "fast":
                o_imgnum, o_mask = request["object"]
                keys = request.get("key", [request["paste"]])
                obj_acts, _, obj_area, _ = self.gw.object_from_selection(
                    o_imgnum, o_mask)
                goal_in, goal_out, _, _ = self.gw.paste_from_selection(
                    request["paste"][0], request["paste"][1], obj_acts,
                    obj_area)
                d = self.gw.multi_key_from_selection(keys, rank=rank)
                self.gw.fast_linear_insert(goal_in, goal_out, d,
                                           niter=niter, lr=lr)
            elif method == "erase":
                self.gw.apply_erase(request, rank=rank, niter=niter,
                                    piter=piter, lr=lr)
            else:
                self.gw.apply_edit(request, rank=rank, niter=niter,
                                   piter=piter, lr=lr)
            self.edits_applied += 1
            count = self.edits_applied   # this edit's, not a later one's
        return {"ok": True, "edits_applied": count}

    def _edit_batch(self, **kwargs):
        from .rewrite.multi import batch_apply_edits
        return batch_apply_edits(self.gw, mesh=self.mesh, **kwargs)

    def edit_batch(self, requests, rank=1, niter=2001, lr=0.05):
        kwargs = {"requests": requests, "rank": rank, "niter": niter,
                  "lr": lr}
        with self._on_device():
            self._collective(kwargs)
            weights, losses = self._edit_batch(**kwargs)
            self._batch_weights = weights
        return {"ok": True, "n": len(weights),
                "final_losses": [float(v) for v in losses]}

    def _batch_weight(self, index: int):
        if self._batch_weights is None:
            raise ValueError("no batch solved yet: POST /edit_batch first")
        return self._batch_weights[index]

    def commit_batch_edit(self, index: int):
        with self._on_device():
            self.gw.set_target_weight(self._batch_weight(index))
            self.edits_applied += 1
        return {"ok": True}

    def revert(self):
        with self._on_device():
            self.gw.revert()
            self.edits_applied = 0
        return {"ok": True}

    def preview_png(self, imgnum: int, batch_index: int = None) -> bytes:
        with self._on_device():
            if batch_index is None:
                img = self.gw.render_image(imgnum)
            else:
                from .rewrite.multi import preview_edits
                img = renormalize.as_image(np.clip(preview_edits(
                    self.gw, [self._batch_weight(batch_index)],
                    self.gw.zds.zs[imgnum:imgnum + 1])[0, 0], -1, 1))
        return renormalize.encode_png(img)

    def save(self, path: str):
        from .utils.paramio import save_params
        with self._on_device():
            save_params(path, self.gw.params)
        return {"ok": True, "path": path}


def make_handler(service: EditingService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self):
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"{}")

        def do_GET(self):
            url = urllib.parse.urlparse(self.path)
            q = dict(urllib.parse.parse_qsl(url.query))
            try:
                if url.path == "/status":
                    self._json(service.status())
                elif url.path == "/preview":
                    data = service.preview_png(
                        int(q.get("imgnum", 0)),
                        int(q["batch_index"]) if "batch_index" in q
                        else None)
                    self.send_response(200)
                    self.send_header("Content-Type", "image/png")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                else:
                    self._json({"error": "not found"}, 404)
            except Exception as e:  # noqa: BLE001 - served as JSON
                self._json({"error": str(e)}, 500)

        def do_POST(self):
            url = urllib.parse.urlparse(self.path)
            q = dict(urllib.parse.parse_qsl(url.query))
            try:
                body = self._body()
                if url.path == "/edit":
                    self._json(service.edit(
                        body["request"], rank=body.get("rank", 1),
                        niter=body.get("niter", 2001),
                        piter=body.get("piter", 10),
                        lr=body.get("lr", 0.05),
                        method=body.get("method", "insert")))
                elif url.path == "/edit_batch":
                    self._json(service.edit_batch(
                        body["requests"], rank=body.get("rank", 1),
                        niter=body.get("niter", 2001),
                        lr=body.get("lr", 0.05)))
                elif url.path == "/commit_batch_edit":
                    self._json(service.commit_batch_edit(
                        int(body["index"])))
                elif url.path == "/revert":
                    self._json(service.revert())
                elif url.path == "/save":
                    self._json(service.save(q.get("path",
                                                  "edited_params.npz")))
                else:
                    self._json({"error": "not found"}, 404)
            except Exception as e:  # noqa: BLE001
                self._json({"error": str(e)}, 500)

    return Handler


def serve(gw, host: str = "127.0.0.1", port: int = 8765):
    """The editing server over rewriter `gw`, bound and not yet serving:
    call its ``serve_forever()`` (in a thread, as the tests do); port 0
    takes a free one (``server_address[1]``).  With a mesh on `gw`, call it
    on rank 0 while the other ranks run :func:`serve_workers`, and stop
    them with ``httpd.service.stop_workers()`` when done."""
    service = EditingService(gw)
    httpd = ThreadingHTTPServer((host, port), make_handler(service))
    httpd.service = service
    return httpd


def serve_workers(gw) -> None:
    """A rank other than 0 of a served mesh: rank 0's collective requests
    until it stops them."""
    EditingService(gw).work()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="the editing server")
    ap.add_argument("--dataset", default="church")
    ap.add_argument("--layer", type=int, default=8)
    ap.add_argument("--port", type=int, default=8765)
    ap.add_argument("--toy", action="store_true",
                    help="serve a small seeded ProgGAN (no checkpoints)")
    args = ap.parse_args(argv)
    from .utils.zdataset import z_dataset_for_model
    mesh, kw = None, {}
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        from .parallel import make_mesh
        mesh = make_mesh()
        kw = {"device": mesh.device}
    if args.toy:
        from .models import ProgressiveGenerator
        from .rewrite import ProgressiveGanRewriter
        model = ProgressiveGenerator(sizes=[32, 32, 16, 16], **kw)
        params = model.init_params(seed=0)
        zds = z_dataset_for_model(model, 100)
        gw = ProgressiveGanRewriter(model, params, zds, layernum=3,
                                    mesh=mesh, **kw)
    else:
        from .models.zoo import load_seq_stylegan
        from .rewrite import SeqStyleGanRewriter
        model, params = load_seq_stylegan(args.dataset, truncation=0.5,
                                          **kw)
        zds = z_dataset_for_model(model, 1000)
        gw = SeqStyleGanRewriter(model, params, zds, args.layer, mesh=mesh,
                                 **kw)
    if mesh is not None and mesh.coords["data"] != 0:
        serve_workers(gw)
        return
    httpd = serve(gw, port=args.port)
    print(f"editing server on :{httpd.server_address[1]}", flush=True)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        if mesh is not None:
            httpd.service.stop_workers()


if __name__ == "__main__":
    main()

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

Command line (runs on the card)::

    python3 -m rewriting_torch.serve --dataset church --layer 8
        [--port 8765] [--toy]

loads the dataset's checkpoint through ``models/zoo.py`` (truncation 0.5)
with 1000 z of statistics; ``--toy`` serves a small seeded ProgGAN and
needs no checkpoint.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from .utils import renormalize


class EditingService:
    """Thread-safe wrapper around a rewriter for serving."""

    def __init__(self, gw):
        self.gw = gw
        self.lock = threading.Lock()
        self.edits_applied = 0
        self._batch_weights = None

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
        with self._on_device():
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

    def edit_batch(self, requests, rank=1, niter=2001, lr=0.05):
        from .rewrite.multi import batch_apply_edits
        with self._on_device():
            weights, losses = batch_apply_edits(self.gw, requests, rank=rank,
                                                niter=niter, lr=lr)
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
    takes a free one (``server_address[1]``)."""
    service = EditingService(gw)
    httpd = ThreadingHTTPServer((host, port), make_handler(service))
    httpd.service = service
    return httpd


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="the editing server")
    ap.add_argument("--dataset", default="church")
    ap.add_argument("--layer", type=int, default=8)
    ap.add_argument("--port", type=int, default=8765)
    ap.add_argument("--toy", action="store_true",
                    help="serve a small seeded ProgGAN (no checkpoints)")
    args = ap.parse_args(argv)
    from .utils.zdataset import z_dataset_for_model
    if args.toy:
        from .models import ProgressiveGenerator
        from .rewrite import ProgressiveGanRewriter
        model = ProgressiveGenerator(sizes=[32, 32, 16, 16])
        params = model.init_params(seed=0)
        zds = z_dataset_for_model(model, 100)
        gw = ProgressiveGanRewriter(model, params, zds, layernum=3)
    else:
        from .models.zoo import load_seq_stylegan
        from .rewrite import SeqStyleGanRewriter
        model, params = load_seq_stylegan(args.dataset, truncation=0.5)
        zds = z_dataset_for_model(model, 1000)
        gw = SeqStyleGanRewriter(model, params, zds, args.layer)
    httpd = serve(gw, port=args.port)
    print(f"editing server on :{httpd.server_address[1]}", flush=True)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()


if __name__ == "__main__":
    main()

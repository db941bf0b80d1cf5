"""The port's editing server (``rewriting_torch/serve.py``) against the JAX
package's, both over a real socket on ephemeral ports.

Both serve the toy ProgGAN of tests/test_serve.py (sizes [16, 16, 8, 8],
JAX key 3, the port's params converted from the JAX tree) at layer 3,
and get the same requests in turn:
- ``/status``: the same JSON;
- ``/preview``: decoded PNGs within 1 LSB before an edit and after
  ``/revert``.  After a 21-step ``/edit`` each server's preview equals its
  own rewriter's render, and the two packages' previews lie within
  EDITED_LSB of each other (measured 3, mean 0.18): their L1 solves on
  the request's own goal land whole Adam steps apart where the residual's
  sign is a rounding tie (0.23 in the weight; tests/
  test_torch_linear_insert.py's docstring);
- ``/edit_batch``: per-edit final losses within 1% of each other, the
  cross-package tolerance of tests/test_torch_multi_edit.py on a
  request's own goal; batch previews within 1 LSB of the port's
  ``preview_edits``, and ``/commit_batch_edit``;
- ``/save``: each package's npz read by the other;
- the errors: 404 for an unknown path, 500 with an error for a bad body,
  an image number out of range and a batch preview before any batch.

An edit served from a handler thread equals the same ``apply_edit`` made
in the main thread bit for bit; twelve clients at once lose no edit
from the count; ``main --toy`` raises without CUDA (the entry points'
default).
"""

import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from conftest import blob
from rewriting_tpu.models import ProgressiveGenerator as JaxProgGAN
from rewriting_tpu.rewrite import ProgressiveGanRewriter as JaxRewriter
from rewriting_tpu.serve import serve as jax_serve
from rewriting_tpu.utils import paramio as jax_paramio
from rewriting_tpu.utils.zdataset import z_dataset_for_model as jax_zds
from rewriting_torch import serve as serve_mod
from rewriting_torch.convert import params_from_jax
from rewriting_torch.models import ProgressiveGenerator
from rewriting_torch.rewrite import ProgressiveGanRewriter
from rewriting_torch.rewrite.multi import preview_edits
from rewriting_torch.utils import paramio
from rewriting_torch.utils.renormalize import (as_image, decode_png,
                                               mask_to_url)
from rewriting_torch.utils.zdataset import z_dataset_for_model

torch.set_num_threads(1)

LSB = 1
EDITED_LSB, EDITED_MEAN_LSB = 8, 1.0
LOSS_RTOL = 1e-2


def _start(httpd):
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return f"http://127.0.0.1:{httpd.server_address[1]}"


def _rewriters():
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
    return jgw, gw


@pytest.fixture(scope="module")
def servers():
    jgw, gw = _rewriters()
    jhttpd, httpd = jax_serve(jgw, port=0), serve_mod.serve(gw, port=0)
    yield {"jax": (_start(jhttpd), jgw, jhttpd.service),
           "torch": (_start(httpd), gw, httpd.service)}
    for h in (jhttpd, httpd):
        h.shutdown()
        h.server_close()


def _get(url):
    with urllib.request.urlopen(url, timeout=120) as r:
        return r.status, r.read(), r.headers.get("Content-Type")


def _post(url, obj):
    req = urllib.request.Request(
        url, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, json.loads(r.read())


def _preview(base, query="imgnum=3"):
    code, png, ctype = _get(f"{base}/preview?{query}")
    assert code == 200 and ctype == "image/png"
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    return decode_png(png).astype(np.int16)


def _request(gw):
    vh, vw = gw.v_shape[1:3]
    return {"object": [0, mask_to_url(blob(vh, vw, 2, 2, 2))],
            "paste": [3, mask_to_url(blob(vh, vw, 5, 5, 2))]}


def _both(servers, fn):
    return {name: fn(base, gw) for name, (base, gw, _) in servers.items()}


def _lsb(imgs):
    return int(np.abs(imgs["jax"] - imgs["torch"]).max())


def test_status_previews_edit_and_revert(servers):
    status = _both(servers, lambda b, gw: json.loads(_get(b + "/status")[1]))
    assert status["torch"] == status["jax"]
    assert status["torch"]["window"] == ["layer3.conv", "layer3.conv"]
    assert status["torch"]["edits_applied"] == 0

    before = _both(servers, lambda b, gw: _preview(b))
    assert before["torch"].shape == (16, 16, 3) and _lsb(before) <= LSB
    request = _request(servers["torch"][1])
    out = _both(servers, lambda b, gw: _post(
        b + "/edit", {"request": request, "rank": 1, "niter": 21}))
    assert out["torch"] == out["jax"] == (200, {"ok": True,
                                                "edits_applied": 1})
    edited = _both(servers, lambda b, gw: _preview(b))
    for name, (_, gw, _) in servers.items():
        np.testing.assert_array_equal(
            edited[name], np.asarray(gw.render_image(3)).astype(np.int16))
    gap = np.abs(edited["jax"] - edited["torch"])
    assert gap.max() <= EDITED_LSB and gap.mean() <= EDITED_MEAN_LSB
    assert np.abs(edited["torch"] - before["torch"]).max() > 0
    assert _both(servers, lambda b, gw: _post(b + "/revert", {}))[
        "torch"] == (200, {"ok": True})
    after = _both(servers, lambda b, gw: _preview(b))
    np.testing.assert_array_equal(after["torch"], before["torch"])
    assert _lsb(after) <= LSB


def test_batch_losses_previews_and_commit(servers):
    base, gw, service = servers["torch"]
    vh, vw = gw.v_shape[1:3]
    other = {"object": [1, mask_to_url(blob(vh, vw, 3, 3, 2))],
             "paste": [2, mask_to_url(blob(vh, vw, 4, 4, 2))]}
    requests = [_request(gw), other]
    out = _both(servers, lambda b, gw: _post(
        b + "/edit_batch", {"requests": requests, "niter": 5}))
    assert out["torch"][0] == 200 and out["torch"][1]["n"] == 2
    got = np.array(out["torch"][1]["final_losses"])
    want = np.array(out["jax"][1]["final_losses"])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    for k in (0, 1):
        served = _preview(base, f"imgnum=3&batch_index={k}")
        direct = as_image(np.clip(preview_edits(
            gw, [service._batch_weights[k]], gw.zds.zs[3:4])[0, 0], -1, 1))
        assert np.abs(served - direct.astype(np.int16)).max() <= LSB
    assert _post(base + "/commit_batch_edit", {"index": 1}) == (
        200, {"ok": True})
    assert torch.equal(gw.target_weight(), service._batch_weights[1])
    assert json.loads(_get(base + "/status")[1])["edits_applied"] == 1
    for name in servers:
        _post(servers[name][0] + "/revert", {})


def test_save_is_read_by_both_packages(servers, tmp_path):
    base, gw, _ = servers["torch"]
    path = str(tmp_path / "torch_params.npz")
    assert _post(f"{base}/save?path={path}", {}) == (200, {"ok": True,
                                                           "path": path})
    jax_tree = jax_paramio.load_params(path)
    for stage, sub in gw.params.items():
        for name, t in sub.items():
            np.testing.assert_array_equal(
                np.asarray(jax_tree[stage][name]), t.numpy())
    jpath = str(tmp_path / "jax_params.npz")
    _post(f"{servers['jax'][0]}/save?path={jpath}", {})
    back = paramio.load_params(jpath, device="cpu")
    for stage, sub in gw.params.items():
        for name, t in sub.items():
            assert torch.equal(back[stage][name], t)


def test_errors(servers):
    base = servers["torch"][0]
    for url in (base + "/nope",):
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(url)
        assert e.value.code == 404
        assert json.loads(e.value.read()) == {"error": "not found"}
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base + "/nope", {})
    assert e.value.code == 404
    for path, body in (("/edit", {}), ("/commit_batch_edit", {})):
        req = urllib.request.Request(
            base + path, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=60)
        assert e.value.code == 500
        assert "error" in json.loads(e.value.read())
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(base + "/preview?imgnum=999")
    assert e.value.code == 500


def test_batch_preview_before_a_batch_is_an_error():
    _, gw = _rewriters()
    httpd = serve_mod.serve(gw, port=0)
    base = _start(httpd)
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(base + "/preview?imgnum=0&batch_index=0")
        assert e.value.code == 500
        assert "edit_batch" in json.loads(e.value.read())["error"]
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_handler_thread_edit_equals_main_thread_edit(servers):
    base, gw, _ = servers["torch"]
    request = _request(gw)
    _post(base + "/revert", {})
    _post(base + "/edit", {"request": request, "niter": 11,
                           "method": "fast"})
    served = gw.target_weight().clone()
    _post(base + "/revert", {})
    _post(base + "/edit", {"request": request, "niter": 11})
    served_insert = gw.target_weight().clone()
    gw.revert()
    gw.apply_edit(request, rank=1, niter=11)
    assert torch.equal(gw.target_weight(), served_insert)
    assert not torch.equal(served, served_insert)
    gw.revert()


def test_concurrent_requests_are_serialized(servers):
    """Many client threads at once, the interpreter switching threads
    often: every edit is counted (no lost update of ``edits_applied``),
    every answer is a 200, and previews between edits stay PNGs."""
    import sys
    base, gw, _ = servers["torch"]
    request = _request(gw)
    _post(base + "/revert", {})
    answers, errors = [], []

    def client(k):
        try:
            for _ in range(3):
                answers.append(_post(base + "/edit", {
                    "request": request, "niter": 2, "method": "fast"})[0])
                answers.append(_get(f"{base}/preview?imgnum={k}")[0])
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert errors == [] and answers == [200] * 72
    assert json.loads(_get(base + "/status")[1])["edits_applied"] == 36
    _post(base + "/revert", {})


def test_main_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_mod.main(["--toy", "--port", "0"])

"""The port's leaf utilities against the JAX package's: params files both
packages read (``utils/paramio.py``), the timers and trace regions
(``utils/profiling.py``), ``EasyDict`` and the notebook HTML helper
(``utils/show.py``).

A params file written by either package loads in the other bit for bit,
nested lists and scalars included, and so does a ProgGAN rewriter's
edited params tree; the HTML of ``show`` has the JAX package's structure,
and its images decode to the same pixels (the PNG encoders differ, so the
base64 text does).
"""

import base64
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import blob
from rewriting_tpu.models import ProgressiveGenerator as JaxProgGAN
from rewriting_tpu.utils import easydict as jax_easydict
from rewriting_tpu.utils import paramio as jax_paramio
from rewriting_tpu.utils import show as jax_show
from rewriting_torch.convert import params_from_jax
from rewriting_torch.models import ProgressiveGenerator
from rewriting_torch.rewrite import ProgressiveGanRewriter
from rewriting_torch.utils import paramio, profiling, show
from rewriting_torch.utils.easydict import EasyDict
from rewriting_torch.utils.renormalize import decode_png, mask_to_url
from rewriting_torch.utils.zdataset import z_dataset_for_model

torch.set_num_threads(1)


def _tree(seed=0):
    """Nested dicts, a list of blocks (as the JAX package's resnet layers
    are stored) and a scalar, as numpy arrays."""
    rng = np.random.RandomState(seed)
    return {"a": {"weight": rng.randn(2, 3).astype(np.float32),
                  "bias": np.zeros(2, np.float32)},
            "blocks": [{"conv": rng.randn(4, 2, 3, 3).astype(np.float32)},
                       {"conv": rng.randn(4, 4, 3, 3).astype(np.float32),
                        "steps": np.arange(3, dtype=np.int32)}],
            "scalar": np.float32(3.5)}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _assert_same_tree(got, want):
    assert type(got) is type(want) or (isinstance(got, dict)
                                       and isinstance(want, dict))
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def test_paramio_jax_file_loads_in_the_port(tmp_path):
    tree = _tree()
    path = str(tmp_path / "jax.npz")
    jax_paramio.save_params(path, jax.tree_util.tree_map(jnp.asarray, tree))
    loaded = paramio.load_params(path, device="cpu")
    assert isinstance(loaded["blocks"], list)
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
               for _, t in _leaves(loaded))
    _assert_same_tree(jax.tree_util.tree_map(lambda t: t.numpy(), loaded),
                      tree)


def test_paramio_port_file_loads_in_jax(tmp_path):
    tree = _tree(1)
    port_tree = jax.tree_util.tree_map(torch.from_numpy,
                                       jax.tree_util.tree_map(np.array, tree))
    path = str(tmp_path / "sub" / "port.npz")
    paramio.save_params(path, port_tree)
    with np.load(path) as port_file:
        jax_paramio.save_params(str(tmp_path / "jax.npz"), tree)
        with np.load(str(tmp_path / "jax.npz")) as jax_file:
            assert sorted(port_file.files) == sorted(jax_file.files)
    _assert_same_tree(jax_paramio.load_params(path), tree)
    _assert_same_tree(paramio.load_params(path, device="cpu"), port_tree)


def test_paramio_edited_rewriter_roundtrip(tmp_path):
    """An edited ProgGAN's params, saved by the port, load in both packages
    bit for bit and render the same images."""
    jm = JaxProgGAN(sizes=[8, 8, 8])
    jp = jax.tree_util.tree_map(np.asarray,
                                jm.init_params(jax.random.PRNGKey(0)))
    model = ProgressiveGenerator(sizes=[8, 8, 8], device="cpu")
    zds = z_dataset_for_model(model, 10)
    gw = ProgressiveGanRewriter(model, params_from_jax(model, jp), zds,
                                layernum=2, stats_batch_size=5, device="cpu")
    vh, vw = gw.v_shape[1:3]
    gw.apply_edit({"object": [0, mask_to_url(blob(vh, vw, 1, 1, 1))],
                   "paste": [1, mask_to_url(blob(vh, vw, 2, 2, 1))]},
                  rank=1, niter=11)
    assert not torch.equal(gw.target_weight(),
                           gw.original_params["layer2.conv"]["weight"])
    path = str(tmp_path / "edited.npz")
    paramio.save_params(path, gw.params)
    loaded = paramio.load_params(path, device="cpu")
    _assert_same_tree(jax.tree_util.tree_map(lambda t: t.numpy(), loaded),
                      jax.tree_util.tree_map(lambda t: t.numpy(), gw.params))
    assert torch.equal(model(loaded, zds.zs[:2]), model(gw.params,
                                                        zds.zs[:2]))
    jloaded = jax_paramio.load_params(path)
    np.testing.assert_allclose(np.asarray(jm(jloaded, zds.zs[:2])),
                               model(gw.params, zds.zs[:2]).numpy(),
                               atol=2e-5, rtol=1e-4)


def test_timed_and_annotate(tmp_path):
    out, ms = profiling.timed(lambda x: x * 2 + 1, torch.arange(8.0),
                              iters=3)
    assert torch.equal(out, torch.arange(8.0) * 2 + 1)
    assert ms >= 0.0
    res, _ = profiling.timed(lambda: {"a": [torch.ones(2)]}, warmup=0)
    assert torch.equal(res["a"][0], torch.ones(2))
    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir):
        with profiling.annotate("region"):
            torch.ones(4).sum()
    with open(os.path.join(logdir, "trace.json")) as f:
        trace = json.load(f)
    assert any(e.get("name") == "region" for e in trace["traceEvents"])


def test_easydict_matches_jax():
    d = EasyDict({"a": 1, "nested": {"b": 2}}, c=3)
    j = jax_easydict.EasyDict({"a": 1, "nested": {"b": 2}}, c=3)
    assert d == j and d.a == 1 and d.nested.b == 2 and d.c == 3
    assert isinstance(d.nested, EasyDict)
    d.e = {"f": 4}
    assert d["e"].f == 4
    del d.a
    assert "a" not in d
    with pytest.raises(AttributeError):
        d.missing
    with pytest.raises(AttributeError):
        del d.missing


_IMG = re.compile(r'<img src="data:image/png;base64,([^"]+)">')


def _split_images(html):
    """(the HTML with each image replaced by a marker, the images)."""
    images = [decode_png(base64.b64decode(m)) for m in _IMG.findall(html)]
    return _IMG.sub("<img>", html), images


@pytest.mark.parametrize("case", ["array", "dict", "row"])
def test_show_html_matches_jax(case):
    rng = np.random.RandomState(0)
    img = np.clip(rng.randn(6, 5, 3) * 0.5, -1, 1).astype(np.float32)
    table = np.arange(6, dtype=np.float32).reshape(2, 3) / 7
    args = {"array": (img,),
            "dict": ({"image": img, "values": table, "name": "x<y"},),
            "row": ([img, "caption", [table, img]], "after")}[case]
    show.reset()
    jax_show.reset()
    got, got_images = _split_images(show.show(*args))
    want, want_images = _split_images(jax_show.show(*args))
    assert got == want
    assert len(got_images) == len(want_images) >= 1
    for g, w in zip(got_images, want_images):
        np.testing.assert_array_equal(g, w)
    # the port's images: a uint8 array shows as it is
    _, images = _split_images(show.html(np.full((6, 5, 3), 7, np.uint8)))
    assert len(images) == 1 and (images[0] == 7).all()


def test_show_row_buffer():
    show.reset()
    show.a("alpha")
    show.a("beta")
    out = show.flush()
    assert "alpha" in out and "beta" in out
    show.a("x", cols=2)
    show.a("y", cols=2)
    assert show._buffer is None
    show.a("pending")
    out = show("body")
    assert out.index("pending") < out.index("body")
    show.reset()

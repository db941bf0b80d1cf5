"""The port's ProgGAN against the JAX package's: the model, its converters,
the zoo's loader and ``ProgressiveGanRewriter``.

- Parity with ``tests/goldens/proggan_tiny.npz`` (made by the reference
  torch code): the forward and the context / target / rendering split at
  layer3's conv, at tests/test_proggan.py's 2e-5 abs and 1e-4 relative.
- The TF-variable converter, the old ``features.N`` names and
  ``zoo.load_proggan(path=)`` give the JAX package's arrays bit for bit.
- ``pipeline_fast`` is ``pipeline``: the JAX package's s2d tail engages
  only at >= 512 px with <= 32 channels and is not ported.
- ``ProgressiveGanRewriter`` on the same weights and seeded z: the key
  statistics and keys (1e-5 and 1e-4 of the largest entry, as
  tests/test_torch_rewriter_ops.py holds them), the renders (1e-5 of the
  largest entry), and the solves held as tests/test_torch_linear_insert.py
  holds them: on the request's own goal the first loss within 1e-5 abs
  and the last within 10% of each other (ties in the L1 residual, that
  file's docstring; the tiny model's goal has large values, so ties move
  the fast Λ·D solve's losses by 1.3e-3 here); on the goal plus seeded
  noise of 1e-2 the Λ·D losses within 1e-4 abs (measured 4.3e-6) and the
  weights within 2e-2 (measured 8.2e-6); every change in span(D).
"""

import argparse
import os

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from conftest import blob
from rewriting_tpu.models import proggan as jax_proggan
from rewriting_tpu.models import zoo as jax_zoo
from rewriting_tpu.rewrite import ProgressiveGanRewriter as JaxRewriter
from rewriting_tpu.utils.zdataset import standard_z_sample as jax_z_sample
from rewriting_tpu.utils.zdataset import z_dataset_for_model as jax_zds
from rewriting_torch.convert import params_from_jax, params_to_numpy
from rewriting_torch.core import DataBag
from rewriting_torch.models import proggan, zoo
from rewriting_torch.rewrite import ProgressiveGanRewriter, projected_conv
from rewriting_torch.utils.renormalize import mask_to_url
from rewriting_torch.utils.zdataset import (standard_z_sample,
                                            z_dataset_for_model)

torch.set_num_threads(1)

NITER = 41


def nchw(x):
    return np.transpose(np.asarray(x), (0, 3, 1, 2))


@pytest.fixture(scope="module")
def golden(goldens):
    g = goldens("proggan_tiny")
    sd = {k[len("sd."):]: g[k] for k in g.files if k.startswith("sd.")}
    return g, sd


def test_sizes_and_forward_parity(golden):
    g, sd = golden
    model, params = proggan.from_state_dict(sd, device="cpu")
    assert model.sizes == [16, 16, 8, 4] and model.resolution == 16
    assert model.z_dim == 16 and model.output_layer == "output_16x16"
    out = model(params, g["z"])
    assert out.shape == (3, 16, 16, 3)
    np.testing.assert_allclose(nchw(out), g["out"], atol=2e-5, rtol=1e-4)


def test_intermediate_parity_and_surgery(golden):
    g, sd = golden
    model, params = proggan.from_state_dict(sd, device="cpu")
    context = model.pipeline.subsequence(upto_layer="layer3.conv")
    target = model.pipeline.subsequence(first_layer="layer3.conv",
                                        last_layer="layer3.conv")
    rendering = model.pipeline.subsequence(after_layer="layer3.conv")
    with torch.no_grad():
        k = context(params, model.make_bag(g["z"]))
        # layer3 upsamples: its context ends after the 2x nearest upsample
        want_k = g["layer3_norm_out"].repeat(2, axis=2).repeat(2, axis=3)
        np.testing.assert_allclose(k["fmap"].numpy(), want_k, atol=2e-5,
                                   rtol=1e-4)
        v = target(params, k)
        np.testing.assert_allclose(v["fmap"].numpy(), g["layer3_conv_out"],
                                   atol=2e-5, rtol=1e-4)
        x = rendering(params, v)
    np.testing.assert_allclose(x["output"].numpy(), g["out"], atol=2e-5,
                               rtol=1e-4)


def test_random_init_and_jax_params_carry_across():
    model = proggan.ProgressiveGenerator(sizes=[8, 8, 4], device="cpu")
    params = model.init_params(seed=0)
    out = model(params, standard_z_sample(2, model.z_dim))
    assert out.shape == (2, 8, 8, 3) and float(out.abs().max()) <= 1.0
    jm = jax_proggan.ProgressiveGenerator(sizes=[8, 8, 4])
    jp = jax.tree_util.tree_map(np.asarray,
                                jm.init_params(jax.random.PRNGKey(1)))
    tp = params_from_jax(model, jp)
    z = standard_z_sample(3, 8, seed=4)
    np.testing.assert_allclose(model(tp, z).numpy(), np.asarray(jm(jp, z)),
                               atol=2e-5, rtol=1e-4)
    back = params_to_numpy(tp)
    for stage, sub in jp.items():
        for name, arr in sub.items():
            np.testing.assert_array_equal(back[stage][name], arr)


def test_pipeline_fast_is_pipeline():
    """Where no block qualifies for the s2d tail (< 512 px or > 32
    channels), pipeline_fast is the seq pipeline itself and the two
    agree bit for bit; where the tail engages it is another pipeline
    (held in tests/test_torch_s2d.py)."""
    model = proggan.ProgressiveGenerator(sizes=[8, 8, 4], device="cpu")
    assert model.pipeline_fast is model.pipeline
    params = model.init_params(seed=2)
    z = standard_z_sample(2, 8)
    assert torch.equal(model(params, z), model(params, z, fast=False))
    tail = proggan.ProgressiveGenerator(
        sizes=[16, 16, 16, 16, 16, 16, 16, 16, 8], device="cpu")
    assert tail.pipeline_fast is not tail.pipeline
    assert tail._fast_overrides


def test_z_prefix_stability():
    a = standard_z_sample(10, 16, seed=1)
    b = standard_z_sample(100, 16, seed=1)
    np.testing.assert_array_equal(a, b[:10])
    np.testing.assert_array_equal(b, jax_z_sample(100, 16, seed=1))


def _tf_variables(sizes, seed=0):
    """Original-TF-style ProgGAN variables for `sizes`."""
    rng = np.random.RandomState(seed)
    tf = {}
    depths = [d for d in sizes[1:] for _ in (0, 1)]
    in_c = sizes[0]
    for i, out_c in enumerate(depths):
        res = 4 * (2 ** (i // 2))
        if i == 0:
            name, shape = "%dx%d/Dense" % (res, res), (in_c, out_c * 16)
        elif i == 1:
            name, shape = "%dx%d/Conv" % (res, res), (3, 3, in_c, out_c)
        elif i % 2 == 0:   # transposed conv, stored (kh, kw, out, in)
            name, shape = "%dx%d/Conv0_up" % (res, res), (3, 3, out_c, in_c)
        else:
            name, shape = "%dx%d/Conv1" % (res, res), (3, 3, in_c, out_c)
        tf[f"{name}/weight"] = rng.randn(*shape).astype(np.float32)
        tf[f"{name}/bias"] = rng.randn(out_c).astype(np.float32)
        in_c = out_c
    tf["ToRGB_lod0/weight"] = rng.randn(1, 1, in_c, 3).astype(np.float32)
    tf["ToRGB_lod0/bias"] = rng.randn(3).astype(np.float32)
    return tf


def test_tf_converter_matches_jax():
    tf = _tf_variables([16, 16, 8, 4])
    got = proggan.state_dict_from_tf_parameters(tf)
    want = jax_proggan.state_dict_from_tf_parameters(tf)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    model, params = proggan.from_tf_parameters(tf, device="cpu")
    jm, jp = jax_proggan.from_tf_parameters(tf)
    assert model.sizes == jm.sizes == [16, 16, 8, 4]
    z = standard_z_sample(2, 16, seed=3)
    np.testing.assert_allclose(model(params, z).numpy(),
                               np.asarray(jm(jp, z)), atol=2e-5, rtol=1e-4)


def _old_names(sd):
    """The golden state dict in the old ``features.N`` naming."""
    old = {}
    layers = sorted({int(k.split(".")[0][5:]) for k in sd
                     if k.startswith("layer")})
    for n in layers:
        old[f"features.{n - 1}.conv.weight"] = sd[f"layer{n}.conv.weight"]
        old[f"features.{n - 1}.wscale.b"] = sd[f"layer{n}.wscale.b"]
    old["output.conv.weight"] = sd["output_16x16.conv.weight"]
    old["output.wscale.b"] = sd["output_16x16.wscale.b"]
    return old


def test_old_names_match_jax(golden):
    _, sd = golden
    old = _old_names(sd)
    got = zoo._proggan_from_old_names(old)
    want = jax_zoo._proggan_from_old_names(old)
    assert got.keys() == want.keys() == sd.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("form", ["plain", "state_dict+args", "old_names"])
def test_load_proggan_path_matches_jax(golden, tmp_path, form):
    """A file written here loads through both zoos by ``path=``, bit for
    bit; a ``state_dict`` wrapper beside an ``argparse.Namespace`` goes
    through the port's ``weights_only`` unpickler."""
    _, sd = golden
    tensors = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    if form == "old_names":
        tensors = _old_names(tensors)
    obj = tensors
    if form == "state_dict+args":
        obj = {"state_dict": tensors,
               "args": argparse.Namespace(size=16, lr=0.001)}
    path = tmp_path / "proggan_churchoutdoor.pth"
    torch.save(obj, path)
    model, params = zoo.load_proggan("church", path=str(path), device="cpu")
    jm, jp = jax_zoo.load_proggan("church", path=str(path))
    assert model.sizes == jm.sizes
    want = params_from_jax(model, jax.tree_util.tree_map(np.asarray, jp))
    assert params.keys() == want.keys()
    for stage in want:
        for name in want[stage]:
            assert torch.equal(params[stage][name], want[stage][name])
    again, _ = zoo.load_pretrained("church", path=str(path), device="cpu")
    assert again.sizes == model.sizes


def test_load_proggan_missing_file(tmp_path, monkeypatch):
    """A missing checkpoint raises naming the file and the URL its download
    failed from (the zoo's URL at a loopback port nothing listens on)."""
    closed = chip_smoke.closed_url()
    monkeypatch.setattr(zoo, "PROGGAN_URL", closed)
    monkeypatch.setenv("REWRITING_TPU_WEIGHTS", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="proggan_bedroom") as e:
        zoo.load_proggan("bedroom", device="cpu")
    assert closed + zoo.PROGGAN_ZOO["bedroom"] in str(e.value)
    assert os.listdir(tmp_path) == []


# -- the rewriter ------------------------------------------------------------

def _close(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0)


@pytest.fixture(scope="module")
def pair():
    """JAX and port rewriters at layer 3 of a tiny ProgGAN on the same
    weights and 200 seeded z, and a request painted on its 8x8 window."""
    jm = jax_proggan.ProgressiveGenerator(sizes=[16, 16, 8, 8])
    jp = jax.tree_util.tree_map(np.asarray,
                                jm.init_params(jax.random.PRNGKey(3)))
    tm = proggan.ProgressiveGenerator(sizes=[16, 16, 8, 8], device="cpu")
    tp = params_from_jax(tm, jp)
    jr = JaxRewriter(jm, jp, jax_zds(jm, 200), layernum=3,
                     stats_batch_size=50)
    tr = ProgressiveGanRewriter(tm, tp, z_dataset_for_model(tm, 200),
                                layernum=3, stats_batch_size=50,
                                device="cpu")
    vh, vw = tr.v_shape[1:3]
    request = {"object": [0, mask_to_url(blob(vh, vw, 2, 2, 2))],
               "paste": [5, mask_to_url(blob(vh, vw, 5, 4, 2))],
               "key": [[5, mask_to_url(blob(vh, vw, 5, 4, 2))],
                       [6, mask_to_url(blob(vh, vw, 4, 4, 2))]]}
    return {"jr": jr, "tr": tr, "req": request}


def test_rewriter_window_statistics_and_keys(pair):
    jr, tr, req = pair["jr"], pair["tr"], pair["req"]
    assert (tr.firstlayer, tr.lastlayer) == ("layer3.conv", "layer3.conv")
    assert tr.k_shape == jr.k_shape == (1, 8, 8, 16)
    assert tr.v_shape == jr.v_shape == (1, 8, 8, 8)
    assert tr.x_shape == jr.x_shape == (1, 16, 16, 3)
    _close(tr.c_matrix.numpy(), jr.c_matrix)
    _close(tr.context_acts(tr.context_of(3)).numpy(),
           jr.context_acts(jr.context_of(3)))
    _close(tr.multi_key_from_selection(req["key"]).numpy(),
           jr.multi_key_from_selection(req["key"]), rel=1e-4)
    _close(tr.query_key_from_selection(*req["paste"]).numpy(),
           jr.query_key_from_selection(*req["paste"]), rel=1e-4)
    conv, tail, scale, demod = tr.fast_parts_cached()
    assert (scale, demod) == jr.fast_parts_cached()[2:] == (1.0, False)
    bag = DataBag(fmap=torch.ones(1, 2))
    assert tail(tr.params, bag) is bag


def test_rewriter_renders(pair):
    jr, tr, req = pair["jr"], pair["tr"], pair["req"]
    img = tr.render_image(4)
    assert img.dtype == np.uint8 and img.shape == (16, 16, 3)
    assert np.abs(img.astype(int)
                  - np.asarray(jr.render_image(4)).astype(int)).max() <= 1
    batch = tr.render_image_batch([1, 2, 3])
    assert len(batch) == 3 and all(b.shape == (16, 16, 3) for b in batch)
    _close(tr.sample_image_from_latent(tr.zds.zs[:2]).numpy(),
           jr.sample_image_from_latent(jr.zds.zs[:2]))
    obj = tr.object_from_selection(*req["object"])
    boxed = tr.render_object(obj[1], box=obj[3])
    assert (boxed == np.array([255, 0, 0], np.uint8)).all(-1).any()


def _losses(fn, *args, **kwargs):
    seen = []
    fn(*args, update_callback=lambda i, l: seen.append(float(l)), **kwargs)
    return np.asarray(seen)


def _check_in_span(tr, w0, direction):
    delta = tr.target_weight() - w0
    assert float(delta.abs().max()) > 1e-3
    outside = (delta - projected_conv(delta, direction)).norm()
    assert outside <= 1e-4 * delta.norm()


def test_apply_edit_matches_jax(pair):
    jr, tr, req = pair["jr"], pair["tr"], pair["req"]
    w0 = tr.target_weight().clone()
    got = tr.apply_edit(req, niter=NITER)
    want = _losses(jr.apply_edit, req, niter=NITER)
    assert got.shape == want.shape == (NITER,)
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=0)
    assert abs(got[-1] - want[-1]) <= 0.1 * want[-1]
    assert got[-1] < got[0]
    _check_in_span(tr, w0, tr.multi_key_from_selection(req["key"]))
    tr.revert()
    jr.revert()
    assert torch.equal(tr.target_weight(), w0)


@pytest.mark.parametrize("goal", ["request", "tie-free"])
def test_fast_linear_insert_matches_jax(pair, goal):
    """The fast Λ·D solve on the request's goal (the first loss within 1e-5,
    the last within 10%: ties) and on it plus seeded noise of 1e-2 (every
    loss within 1e-4, the weights within 2e-2, as
    tests/test_torch_linear_insert.py holds them)."""
    jr, tr, req = pair["jr"], pair["tr"], pair["req"]
    goals = {}
    for name, rw in (("j", jr), ("t", tr)):
        obj = rw.object_from_selection(*req["object"])
        goals[name] = rw.paste_from_selection(*req["paste"], obj[0], obj[2])
    d = np.asarray(jr.multi_key_from_selection(req["key"]))
    td = torch.from_numpy(np.array(d))
    jout = np.asarray(jr.target_acts(goals["j"][1]))
    if goal == "tie-free":
        jout = jout + (np.random.RandomState(0).randn(*jout.shape)
                       * 1e-2).astype(np.float32)
    tout = torch.from_numpy(np.ascontiguousarray(jout.transpose(0, 3, 1, 2)))
    w0 = tr.target_weight().clone()
    got = tr.fast_linear_insert(goals["t"][0], DataBag(fmap=tout), td,
                                niter=NITER)
    want = _losses(jr.fast_linear_insert, goals["j"][0],
                   {"fmap": jax.numpy.asarray(jout)}, d, niter=NITER)
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=0)
    if goal == "request":
        assert abs(got[-1] - want[-1]) <= 0.1 * want[-1]
    else:
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
        np.testing.assert_allclose(tr.target_weight().numpy(),
                                   np.asarray(jr.target_weight()), atol=2e-2,
                                   rtol=0)
    _check_in_span(tr, w0, td)
    tr.revert()
    jr.revert()


def test_apply_erase_matches_jax(pair):
    jr, tr, req = pair["jr"], pair["tr"], pair["req"]
    w0 = tr.target_weight().clone()
    got = tr.apply_erase(req, drank=4, niter=NITER)
    want = _losses(jr.apply_erase, req, drank=4, niter=NITER)
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=0)
    assert abs(got[-1] - want[-1]) <= 0.1 * want[-1]
    _check_in_span(tr, w0, tr.multi_key_from_selection(req["key"]))
    tr.revert()

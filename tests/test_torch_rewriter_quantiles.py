"""The rewriter's quantile statistics and the methods built on them,
against the JAX package's, on the weights of tests/goldens/
stylegan2_tiny.npz (layer 4) and proggan_tiny.npz (layer 3):

- ``quantiles_for_units``: quantiles within 1e-4 of each unit's range
  (the activations differ by fp32 rounding, so the sketches hold values
  that differ by as much; measured 2e-5), and the port's ``unit_rq.npz``
  read back, and the JAX package's read by the port;
- ``quantiles_for_covariance_adjusted_directions`` (the Pre window's
  override too): on StyleGAN2 within 1e-3 of the range, the keys being
  solved against C in float64 from a C that differs by 1e-5 (measured
  1.4e-4).  ProgGAN's C is ill-conditioned at this layer (condition
  number 7.4e7), so C^-1 turns the activations' rounding into 30% of the
  range; there the port's sketch is held to the JAX package's sketch of
  the port's own keys through the JAX package's solve: bit for bit;
- ``ranking_for_key``: the same top 12 image numbers in the same order,
  its sketch's quantiles within 1e-4 of the range;
- ``gandissect`` keys: the same one-hot units, at ranks 1 and 3, where
  the top scores lie well apart (checked, > 1e-3 of the largest);
- ``render_image_batch`` with the ranking's key at the heat's 0.99
  quantile: renders within 1 LSB but for the outline's border pixels
  (at most 1% moved, as tests/test_torch_imgviz.py holds them);
- the watermark erase by ``gandissect``: the same units zeroed, the
  weights bit for bit the JAX package's, the images within 1 LSB.

The dome2tree and multikey_markandbottom requests name images of the
published model; here their numbers are taken modulo the 200 seeded z.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import blob
from rewriting_tpu.metrics import watermark as jax_watermark
from rewriting_tpu.models import proggan as jax_proggan
from rewriting_tpu.models.stylegan2 import SeqStyleGAN2 as JaxSeqStyleGAN2
from rewriting_tpu.models.stylegan2 import params_from_state_dict
from rewriting_tpu.rewrite import ProgressiveGanRewriter as JaxProgRewriter
from rewriting_tpu.rewrite import SeqPreStyleGanRewriter as JaxPre
from rewriting_tpu.rewrite import SeqStyleGanRewriter as JaxRewriter
from rewriting_tpu.rewrite import solve as jax_solve
from rewriting_tpu.stats import quantile as jax_quantile
from rewriting_tpu.utils.zdataset import z_dataset_for_model as jax_zds
from rewriting_torch.convert import params_from_jax
from rewriting_torch.metrics import watermark
from rewriting_torch.models import proggan
from rewriting_torch.models.stylegan2 import SeqStyleGAN2
from rewriting_torch.rewrite import (ProgressiveGanRewriter,
                                     SeqPreStyleGanRewriter,
                                     SeqStyleGanRewriter)
from rewriting_torch.stats import RunningQuantile
from rewriting_torch.utils.renormalize import decode_png, mask_to_url
from rewriting_torch.utils.zdataset import z_dataset_for_model

torch.set_num_threads(1)

MASKS = os.path.join(os.path.dirname(__file__), "..", "notebooks", "masks",
                     "stylegan", "church")
SAMPLES, BATCH = 200, 50
QS = np.linspace(0, 1, 21)


def _modulo(request, n):
    return {k: ([[i % n, m] for i, m in v] if k == "key"
                else [v[0] % n, v[1]]) for k, v in request.items()}


def _stylegan(goldens):
    g = goldens("stylegan2_tiny")
    sd = {k[len("sd."):]: g[k] for k in g.files if k.startswith("sd.")}
    jm = JaxSeqStyleGAN2(16, style_dim=64, n_mlp=2)
    jp = jax.tree_util.tree_map(np.asarray, params_from_state_dict(jm, sd))
    tm = SeqStyleGAN2(16, style_dim=64, n_mlp=2, device="cpu")
    return jm, jp, tm, params_from_jax(tm, jp)


@pytest.fixture(scope="module", params=["stylegan", "proggan"])
def pair(request, goldens, tmp_path_factory):
    """JAX and port rewriters on a golden's weights, each with a cachedir,
    and a request."""
    root = tmp_path_factory.mktemp(request.param)
    if request.param == "stylegan":
        jm, jp, tm, tp = _stylegan(goldens)
        jcls, tcls, layer = JaxRewriter, SeqStyleGanRewriter, 4
        with open(os.path.join(MASKS, "dome2tree.json")) as f:
            req = _modulo(json.load(f), SAMPLES)
    else:
        g = goldens("proggan_tiny")
        sd = {k[len("sd."):]: g[k] for k in g.files if k.startswith("sd.")}
        jm, jp = jax_proggan.from_state_dict(sd)
        jp = jax.tree_util.tree_map(np.asarray, jp)
        tm, tp = proggan.from_state_dict(sd, device="cpu")
        jcls, tcls, layer = JaxProgRewriter, ProgressiveGanRewriter, 3
        req = None
    jr = jcls(jm, jp, jax_zds(jm, SAMPLES), layernum=layer,
              stats_batch_size=BATCH, cachedir=str(root / "jax"))
    tr = tcls(tm, tp, z_dataset_for_model(tm, SAMPLES), layernum=layer,
              stats_batch_size=BATCH, cachedir=str(root / "torch"),
              device="cpu")
    if req is None:
        kh, kw = tr.k_shape[1:3]
        req = {"object": [0, mask_to_url(blob(kh, kw, 2, 2, 2))],
               "paste": [5, mask_to_url(blob(kh, kw, 5, 4, 2))],
               "key": [[5, mask_to_url(blob(kh, kw, 5, 4, 2))],
                       [6, mask_to_url(blob(kh, kw, 4, 4, 2))]]}
    return {"jr": jr, "tr": tr, "req": req, "root": root, "kind":
            request.param, "model": (jm, jp, tm, tp, layer)}


def _assert_sketches_close(got, want, rel=1e-4):
    g, w = got.quantiles(QS), np.asarray(want.quantiles(QS))
    assert isinstance(g, np.ndarray) and g.shape == w.shape
    span = np.maximum(w[:, -1] - w[:, 0], 1e-12)[:, None]
    assert (np.abs(g - w) / span).max() <= rel, (np.abs(g - w) / span).max()
    assert got.count == want.count


def test_quantiles_for_units_and_its_cache(pair):
    jr, tr = pair["jr"], pair["tr"]
    got = tr.quantiles_for_units()
    assert tr.quantiles_for_units() is got
    assert got.count == SAMPLES * tr.k_shape[1] * tr.k_shape[2]
    _assert_sketches_close(got, jr.quantiles_for_units())
    # the port's cache read back, and the JAX package's read by the port
    m, p = tr.model, tr.original_params
    for cachedir in ("torch", "jax"):
        again = type(tr)(m, p, tr.zds, layernum=int(tr.firstlayer[5]),
                         stats_batch_size=BATCH, device="cpu",
                         cachedir=str(pair["root"] / cachedir))
        back = again.quantiles_for_units()
        want = got if cachedir == "torch" else jr.quantiles_for_units()
        np.testing.assert_array_equal(back.quantiles(QS),
                                      np.asarray(want.quantiles(QS)))


def test_quantiles_for_covariance_adjusted_directions(pair, goldens):
    jr, tr = pair["jr"], pair["tr"]
    got = tr.quantiles_for_covariance_adjusted_directions()
    assert os.path.isfile(tr.rf("unit_cad.npz"))
    assert got.count == SAMPLES * tr.k_shape[1] * tr.k_shape[2]
    if pair["kind"] == "proggan":
        want = jax_quantile.RunningQuantile()
        c = tr.c_matrix.numpy()
        for lo in range(0, SAMPLES, BATCH):
            acts = tr.context_acts(tr._context(tr.params, tr.model.make_bag(
                tr.zds.zs[lo:lo + BATCH]))).reshape(-1, tr.k_shape[-1])
            want.add(jax_solve.solve_spd(c, acts.numpy()))
        np.testing.assert_array_equal(got.quantiles(QS),
                                      np.asarray(want.quantiles(QS)))
        return
    _assert_sketches_close(
        got, jr.quantiles_for_covariance_adjusted_directions(), rel=1e-3)
    # the Pre window adjusts through its own covariance_adjusted_key
    jm, jp, tm, tp, layer = pair["model"]
    jpre = JaxPre(jm, jp, jax_zds(jm, 60), layernum=layer,
                  stats_batch_size=30)
    tpre = SeqPreStyleGanRewriter(tm, tp, z_dataset_for_model(tm, 60),
                                  layernum=layer, stats_batch_size=30,
                                  device="cpu")
    pre = tpre.quantiles_for_covariance_adjusted_directions()
    _assert_sketches_close(
        pre, jpre.quantiles_for_covariance_adjusted_directions(), rel=1e-3)
    plain = SeqStyleGanRewriter(tm, tp, z_dataset_for_model(tm, 60),
                                layernum=layer, stats_batch_size=30,
                                device="cpu")
    other = plain.quantiles_for_covariance_adjusted_directions()
    assert not np.allclose(other.quantiles(QS), pre.quantiles(QS))


@pytest.fixture(scope="module")
def ranked(pair):
    jr, tr, req = pair["jr"], pair["tr"], pair["req"]
    key = tr.query_key_from_selection(*req["paste"])
    got = tr.ranking_for_key(key)
    want = jr.ranking_for_key(jnp.asarray(key.numpy()))
    return key, got, want


def test_ranking_for_key_matches_jax(pair, ranked):
    tr = pair["tr"]
    key, (idx, rq), (jidx, jrq) = ranked
    assert isinstance(idx, np.ndarray) and idx.shape == (12,)
    np.testing.assert_array_equal(idx, np.asarray(jidx))
    assert isinstance(rq, RunningQuantile)
    assert rq.count == SAMPLES * tr.k_shape[1] * tr.k_shape[2]
    _assert_sketches_close(rq, jrq)
    # the top image's response (alone, not in a batch of 50) peaks at the
    # sketch's maximum
    heat = torch.einsum("bhwc,c->bhw", tr.context_acts(
        tr.context_of(int(idx[0]))), key)
    span = float(rq.max()[0] - rq.min()[0])
    np.testing.assert_allclose(float(heat.max()), float(rq.max()[0]),
                               atol=1e-5 * span, rtol=0)


def test_render_image_batch_at_the_ranking_level(pair, ranked):
    jr, tr = pair["jr"], pair["tr"]
    key, (idx, rq), _ = ranked
    level = float(rq.quantiles([0.99])[0, 0])
    got = tr.render_image_batch(list(idx[:5]), key=key, level=level,
                                batch_size=3)
    want = jr.render_image_batch([int(i) for i in idx[:5]],
                                 key=jnp.asarray(key.numpy()), level=level,
                                 batch_size=3)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == np.uint8 and g.shape == w.shape == (16, 16, 3)
        moved = (np.abs(g.astype(np.int16) - w).max(-1) > 1).mean()
        assert moved <= 0.01
    plain = tr.render_image_batch(list(idx[:5]), batch_size=3)
    assert any((g != p).any() for g, p in zip(got, plain))  # outlined


@pytest.mark.parametrize("rank", [1, 3])
def test_gandissect_keys_match_jax(pair, rank):
    jr, tr, req = pair["jr"], pair["tr"], pair["req"]
    got = tr.multi_key_from_selection(req["key"], rank=rank,
                                      key_method="gandissect")
    want = np.asarray(jr.multi_key_from_selection(req["key"], rank=rank,
                                                  key_method="gandissect"))
    assert got.shape == (rank, tr.k_shape[-1]) and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.sum(1) == 1).all()
    # the units chosen are well apart from the next in score
    obs, w = tr._gather_masked_obs(req["key"], keep_all=True)
    ranks = tr.quantiles_for_units().normalize(obs.T).T
    score = (-np.log(np.maximum(1.0 - ranks, 1e-20)) * w).sum(0) / w.sum()
    top = np.sort(score)[::-1]
    assert (np.diff(top[:rank + 1]) < -1e-3 * top[0]).all()


def test_gandissect_key_method_on_the_constructor(pair):
    """key_method="gandissect" is the default of the rewriter's keys."""
    tr = pair["tr"]
    rw = type(tr)(tr.model, tr.original_params, tr.zds,
                  layernum=int(tr.firstlayer[5]), stats_batch_size=BATCH,
                  key_method="gandissect", device="cpu",
                  cachedir=str(pair["root"] / "torch"))
    np.testing.assert_array_equal(
        rw.multi_key_from_selection(pair["req"]["key"], rank=2).numpy(),
        tr.multi_key_from_selection(pair["req"]["key"], rank=2,
                                    key_method="gandissect").numpy())


def _pngs(directory):
    out = {}
    for name in sorted(os.listdir(directory)):
        if name.endswith(".png"):
            with open(os.path.join(directory, name), "rb") as f:
                out[name] = decode_png(f.read()).astype(np.int16)
    return out


def test_watermark_gandissect_erase_matches_jax(goldens, tmp_path):
    """erase_watermark(erasemethod="gandissect") at layer 6 with drank 3:
    the same units zeroed in the weight (bit for bit the JAX package's)
    and the images within 1 LSB."""
    jm, jp, tm, tp = _stylegan(goldens)
    n = 24
    with open(os.path.join(MASKS, "multikey_markandbottom.json")) as f:
        req = _modulo(json.load(f), n)
    kw = dict(drank=3, erasemethod="gandissect", sample_size=n)
    gw = watermark.erase_watermark(tm, tp, tp, req, 6,
                                   str(tmp_path / "port"), **kw)
    jgw = jax_watermark.erase_watermark(jm, jp, jp, req, 6,
                                        str(tmp_path / "jax"), **kw)
    w, w0 = gw.target_weight(), gw.original_params[gw.weight_stage()][
        "weight"]
    np.testing.assert_array_equal(w.numpy(), np.asarray(jgw.target_weight()))
    changed = (w != w0).flatten(0, -4).any(0).any(-1).any(-1)  # per unit
    units = gw.multi_key_from_selection(req["key"], rank=3).argmax(1)
    assert sorted(torch.nonzero(changed)[:, 0].tolist()) == \
        sorted(units.tolist())
    assert float(w[..., units, :, :].abs().max()) == 0.0
    got, want = _pngs(str(tmp_path / "port" / "images")), \
        _pngs(str(tmp_path / "jax" / "images"))
    assert sorted(got) == sorted(want) and len(got) == n
    for name in want:
        assert np.abs(got[name] - want[name]).max() <= 1, name

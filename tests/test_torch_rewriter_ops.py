"""The rest of the port's rewriting engine against the JAX package's:
the query key, the svd and mean directions, normdissect units, the erase
goal and its solve, zero, the rgb selections, image patches, the Tiny and
Pre rewriters, and the per-unit mean (``RunningMean``, ``tally_mean``)
with its npz cache.

Both packages get the same weights (``params_from_jax``), the same seeded
z and the published dome2tree request at 16 px.  Tolerances: activations,
goals, statistics and renders 1e-5 of the largest entry (fp32 sums in
another order; measured ~1e-7); keys through the float64 solve against C
1e-4 of the largest entry, as tests/test_torch_rewriter.py's
covariance-adjusted key; the L1 solves on the request's own goals: the
first loss within 1e-5 abs, every loss within 5e-4 abs (measured 1.4e-4
for the erase, 1.2e-4 in the Tiny window).  Much of such a goal equals the
unedited window output up to rounding, so the sign of the L1 residual
there is rounding noise that differs between the packages, and Adam turns
it into a whole step (tests/test_torch_rewriter.py's module docstring;
tests/test_torch_linear_insert.py holds the solves on a goal without such
ties to 1e-4).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rewriting_tpu.models.stylegan2 import SeqStyleGAN2 as JaxSeqStyleGAN2
from rewriting_tpu.rewrite import SeqPreStyleGanRewriter as JaxPre
from rewriting_tpu.rewrite import SeqStyleGanRewriter as JaxRewriter
from rewriting_tpu.rewrite import SeqTinyStyleGanRewriter as JaxTiny
from rewriting_tpu.rewrite import solve as jax_solve
from rewriting_tpu.stats import running as jax_running
from rewriting_tpu.stats import tally as jax_tally
from rewriting_tpu.utils.zdataset import z_dataset_for_model as jax_zds
from rewriting_torch.convert import params_from_jax
from rewriting_torch.models.stylegan2 import SeqStyleGAN2
from rewriting_torch.rewrite import (SeqPreStyleGanRewriter,
                                     SeqStyleGanRewriter,
                                     SeqTinyStyleGanRewriter, projected_conv)
from rewriting_torch.stats import RunningMean, tally
from rewriting_torch.utils.zdataset import z_dataset_for_model

torch.set_num_threads(1)

REQUEST = os.path.join(os.path.dirname(__file__), "..", "notebooks", "masks",
                       "stylegan", "church", "dome2tree.json")
LAYER, NITER, BATCH = 4, 41, 100


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0)


def _models(seed):
    jm = JaxSeqStyleGAN2(16, style_dim=64, n_mlp=2)
    jp = jm.init_params(jax.random.PRNGKey(seed))
    tm = SeqStyleGAN2(16, style_dim=64, n_mlp=2, device="cpu")
    tp = params_from_jax(tm, jax.tree_util.tree_map(np.asarray, jp))
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def req():
    with open(REQUEST) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """JAX and port rewriters at layer 4 on the same weights, each with a
    cachedir."""
    jm, jp, tm, tp = _models(21)
    root = tmp_path_factory.mktemp("caches")
    jr = JaxRewriter(jm, jp, jax_zds(jm, 1000), layernum=LAYER,
                     stats_batch_size=BATCH, cachedir=str(root / "jax"))
    tr = SeqStyleGanRewriter(tm, tp, z_dataset_for_model(tm, 1000),
                             layernum=LAYER, stats_batch_size=BATCH,
                             cachedir=str(root / "torch"), device="cpu")
    return jr, tr


def test_query_key_matches_jax(pair, req):
    jr, tr = pair
    got = tr.query_key_from_selection(*req["paste"])
    want = np.asarray(jr.query_key_from_selection(*req["paste"]))
    assert got.shape == (tr.k_shape[-1],) and got.device.type == "cpu"
    np.testing.assert_allclose(float(got.norm()), 1.0, atol=1e-5)
    _close(got.numpy(), want, rel=1e-4)


@pytest.mark.parametrize("method,rank", [("svd", 1), ("svd", 2),
                                         ("mean", 1)])
def test_svd_and_mean_directions_match_jax(pair, req, method, rank):
    """The two key methods through the covariance_adjusted_key hook, with
    the object's selection as a second key example."""
    jr, tr = pair
    pairs = req["key"] + [req["object"]]
    got = tr.multi_key_from_selection(pairs, rank=rank,
                                      key_method=method).numpy()
    want = np.asarray(jr.multi_key_from_selection(pairs, rank=rank,
                                                  key_method=method))
    assert got.shape == (rank, tr.k_shape[-1])
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    # the first direction is signed along the mean; a later singular
    # vector of the svd has no fixed sign
    signs = np.sign((got * want).sum(1))[:, None]
    assert signs[0, 0] == 1
    _close(signs * got, want, rel=1e-4)


def test_key_methods_and_gandissect(pair, req):
    """gandissect gives one-hot units (held against the JAX package in
    tests/test_torch_rewriter_quantiles.py), also as the constructor's
    key method; unknown methods and a rank-2 mean raise."""
    jr, tr = pair
    got = tr.multi_key_from_selection(req["key"], rank=2,
                                      key_method="gandissect")
    assert got.shape == (2, tr.k_shape[-1]) and (got.sum(1) == 1).all()
    rw = SeqStyleGanRewriter(tr.model, tr.original_params, tr.zds,
                             layernum=LAYER, key_method="gandissect",
                             stats_batch_size=BATCH, cachedir=tr.cachedir,
                             device="cpu")
    assert torch.equal(rw.multi_key_from_selection(req["key"], rank=2), got)
    with pytest.raises(ValueError):
        SeqStyleGanRewriter(tr.model, tr.original_params, tr.zds,
                            layernum=LAYER, key_method="nope", device="cpu")
    with pytest.raises(ValueError):
        tr.multi_key_from_selection(req["key"], key_method="nope")
    with pytest.raises(ValueError):
        tr.multi_key_from_selection(req["key"], rank=2, key_method="mean")


def test_square_scales_and_their_cache_match_jax(pair):
    """The per-unit mean square over the 1000 z, and its unit_rs.npz cache
    read by the other package."""
    jr, tr = pair
    got = tr.square_scales_for_units()
    _close(got.numpy(), np.asarray(jr.square_scales_for_units()))
    assert tr.square_scales_for_units() is got
    args = {"sample_size": 1000, "batch_size": BATCH}
    jcache = jax_tally.load_cached_state(jr.rf("unit_rs.npz"), args)
    tcache = tally.load_cached_state(tr.rf("unit_rs.npz"), args)
    assert set(jcache) == set(tcache) == {"count", "mean", "constructor"}
    _close(RunningMean.from_state_dict(jcache).mean().numpy(), got.numpy())
    back = jax_running.RunningMean.from_state_dict(tcache)
    np.testing.assert_array_equal(np.asarray(back.mean()), got.numpy())
    assert back.count == 1000 * tr.k_shape[1] * tr.k_shape[2]


def test_normdissect_units_match_jax(pair, req):
    jr, tr = pair
    got = tr.normdissect_units(req["key"], 30).numpy()
    want = np.asarray(jr.normdissect_units(req["key"], 30))
    assert got.dtype == np.int64 and got.shape == (30,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tight", [True, False], ids=["tight", "whole"])
def test_erase_goals_match_jax(pair, req, tight):
    jr, tr = pair
    jr.tight_paste = tr.tight_paste = tight
    try:
        got = tr.erase_from_selection(*req["paste"], req["key"], 30)
        want = jr.erase_from_selection(*req["paste"], req["key"], 30)
    finally:
        jr.tight_paste = tr.tight_paste = True
    for g, w in zip(got, want):
        _close(tr.target_acts(g).numpy(), np.asarray(w["fmap"]))
        _close(tr.rendered_image(g).numpy(), np.asarray(w["output"]))
    if not tight:
        assert tuple(got[1]["fmap"].shape[2:]) == tr.v_shape[1:3]


def test_apply_erase_matches_jax(pair, req):
    """apply_erase (drank 30): the port's losses against the JAX solve run
    on the JAX erase goal (the JAX apply_erase returns none), and the
    change stays in span(D)."""
    jr, tr = pair
    goal = jr.erase_from_selection(*req["paste"], req["key"], 30)
    jd = jr.multi_key_from_selection(req["key"], rank=1)
    _, jlosses = jax_solve.insert_solve(
        jr._window_fn, jr.target_weight(), (goal[0], jr.params),
        jr.target_acts(goal[1]), jd, niter=NITER, piter=10, lr=0.05)
    w0 = tr.target_weight()
    seen = []
    try:
        losses = tr.apply_erase(req, rank=1, drank=30, niter=NITER,
                                update_callback=lambda i, l: seen.append(i))
        delta = tr.target_weight() - w0
    finally:
        tr.revert()
    assert seen == list(range(NITER))
    np.testing.assert_allclose(losses[0], np.asarray(jlosses)[0], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(losses, np.asarray(jlosses), atol=5e-4,
                               rtol=0)
    d = tr.multi_key_from_selection(req["key"], rank=1)
    outside = (delta - projected_conv(delta, d)).norm()
    assert delta.abs().max() > 1e-3 and outside <= 1e-4 * delta.norm()


@pytest.mark.parametrize("amount", [0.0, 0.5])
def test_zero_matches_jax(pair, req, amount):
    jr, tr = pair
    d = jr.multi_key_from_selection(req["key"], rank=1)
    try:
        jr.zero(d, amount=amount)
        tr.zero(torch.from_numpy(np.array(d)), amount=amount)
        _close(tr.target_weight().numpy(), np.asarray(jr.target_weight()))
        zs = tr.zds.zs[:2]
        _close(tr.sample_image_from_latent(zs).numpy(),
               np.asarray(jr.sample_image_from_latent(jnp.asarray(zs))),
               rel=1e-4)
    finally:
        jr.revert()
        tr.revert()


def test_rgb_selections_match_jax(pair, req):
    jr, tr = pair
    got = tr.rgb_from_selection(*req["object"])
    want = jr.rgb_from_selection(*req["object"])
    _close(got[0], want[0])
    _close(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert got[3] == want[3]
    pasted = tr.rgbpaste_from_selection(*req["paste"], got[0], got[2])
    jpasted = jr.rgbpaste_from_selection(*req["paste"], want[0], want[2])
    np.testing.assert_array_equal(pasted[0].numpy(), np.asarray(jpasted[0]))
    _close(pasted[1], jpasted[1])
    assert pasted[2] == jpasted[2]


@pytest.mark.parametrize("seed,size", [((0, 0), 4), ((1, 2), 2)])
def test_sample_image_patch_matches_jax(pair, seed, size):
    jr, tr = pair
    zs = tr.zds.zs[:2]
    got = tr.sample_image_patch(zs, size, seed=seed).numpy()
    want = np.asarray(jr.sample_image_patch(jnp.asarray(zs), size,
                                            seed=seed))
    assert got.shape == (2, 2 * size, 2 * size, 3)
    _close(got, want)


# ---------------------------------------------------------------------------
# The Tiny (dconv only) and Pre (adain .. activate) windows
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["tiny", "pre"])
def variant(request):
    jm, jp, tm, tp = _models(22)
    jcls, tcls = {"tiny": (JaxTiny, SeqTinyStyleGanRewriter),
                  "pre": (JaxPre, SeqPreStyleGanRewriter)}[request.param]
    jr = jcls(jm, jp, jax_zds(jm, 1000), layernum=LAYER,
              stats_batch_size=BATCH)
    tr = tcls(tm, tp, z_dataset_for_model(tm, 1000), layernum=LAYER,
              stats_batch_size=BATCH, device="cpu")
    return request.param, jr, tr


def test_variant_window_and_statistics(variant):
    name, jr, tr = variant
    assert (tr.firstlayer, tr.lastlayer) == (jr.firstlayer, jr.lastlayer)
    assert tr.target_pipe.stage_names() == jr.target_pipe.stage_names()
    assert (tr.k_shape, tr.v_shape) == (jr.k_shape, jr.v_shape)
    _close(tr.c_matrix.numpy(), jr.c_matrix)
    _close(tr.target_weight().numpy(), np.asarray(jr.target_weight()))
    assert tr.weight_stage() == f"layer{LAYER}.sconv.mconv.dconv"


@pytest.mark.parametrize("method", ["zca", "svd"])
def test_variant_directions_match_jax(variant, req, method):
    """Pre's svd key solves against C·diag(style) of each selection's
    bag."""
    _, jr, tr = variant
    got = tr.multi_key_from_selection(req["key"], key_method=method).numpy()
    want = np.asarray(jr.multi_key_from_selection(req["key"],
                                                  key_method=method))
    _close(np.sign((got * want).sum()) * got, want, rel=1e-4)


def test_variant_apply_edit_matches_jax(variant, req):
    """A 41-step apply_edit in each window against the JAX solve on the
    JAX goal and direction (Pre's solve writes the dconv's weight)."""
    _, jr, tr = variant
    obj = jr.object_from_selection(*req["object"])
    goal = jr.paste_from_selection(*req["paste"], obj[0], obj[2])
    jd = jr.multi_key_from_selection(req["key"], rank=1)
    _, jlosses = jax_solve.insert_solve(
        jr._window_fn, jr.target_weight(), (goal[0], jr.params),
        jr.target_acts(goal[1]), jd, niter=NITER, piter=10, lr=0.05)
    w0 = tr.target_weight()
    try:
        losses = tr.apply_edit(req, niter=NITER)
        delta = tr.target_weight() - w0
        assert tr.params[tr.weight_stage()]["weight"] is tr.target_weight()
    finally:
        tr.revert()
    np.testing.assert_allclose(losses[0], np.asarray(jlosses)[0], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(losses, np.asarray(jlosses), atol=5e-4,
                               rtol=0)
    assert losses[-1] < losses[0] and delta.abs().max() > 1e-3


# ---------------------------------------------------------------------------
# RunningMean and tally_mean
# ---------------------------------------------------------------------------

def test_running_mean_matches_jax():
    rng = np.random.RandomState(3)
    batches = [rng.randn(n, 5, 3).astype(np.float32) for n in (7, 1, 12)]
    got, want = RunningMean(), jax_running.RunningMean()
    for b in batches:
        got.add(torch.from_numpy(b))
        want.add(jnp.asarray(b))
    _close(got.mean().numpy(), np.asarray(want.mean()))
    _close(got.mean().numpy(), np.concatenate(batches).mean(0))
    assert got.count == want.count == 20.0


class _Zds:
    def __init__(self, zs):
        self.zs = zs

    def __len__(self):
        return len(self.zs)

    def batches(self, batch_size):
        for i in range(0, len(self.zs), batch_size):
            yield self.zs[i:i + batch_size], len(self.zs[i:i + batch_size])


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_tally_mean_and_its_cache_match_jax(tmp_path, writer):
    """tally_mean over 23 z in batches of 5 (a short last batch), and its
    cache written by either package read by the other: same keys, same
    values, and a mismatched key recomputes."""
    zs = np.random.RandomState(4).randn(23, 6).astype(np.float32)
    w = np.random.RandomState(5).randn(6, 4).astype(np.float32)
    zds = _Zds(zs)
    path = str(tmp_path / "mean.npz")
    if writer == "jax":
        first = jax_tally.tally_mean(lambda z: jnp.tanh(z @ w), zds,
                                     batch_size=5, cachefile=path)
        calls = []
        back = tally.tally_mean(lambda z: calls.append(1), zds,
                                batch_size=5, cachefile=path)
        assert calls == []
        np.testing.assert_array_equal(back.mean().numpy(),
                                      np.asarray(first.mean()))
    else:
        first = tally.tally_mean(lambda z: torch.tanh(z @ torch.from_numpy(w)),
                                 zds, batch_size=5, cachefile=path)
        back = jax_tally.tally_mean(lambda z: 1 / 0, zds, batch_size=5,
                                    cachefile=path)
        np.testing.assert_array_equal(np.asarray(back.mean()),
                                      first.mean().numpy())
    _close(np.asarray(first.mean()), np.tanh(zs @ w).mean(0))
    assert back.count == 23.0
    again = tally.tally_mean(lambda z: torch.zeros(len(z), 4), zds,
                             batch_size=4, cachefile=path)
    assert float(again.mean().abs().max()) == 0.0

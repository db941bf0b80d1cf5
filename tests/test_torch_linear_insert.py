"""The port's Λ·D solves and the gradient-projected insert against the JAX
package's, at an even layer (4: dconv, noise, activate) and an upsampling
layer (3: the window runs the blur, and the fast solve's tail is blur,
noise, activate).

Both packages get the same weights (``params_from_jax``), the same 1000
seeded z, the dome2tree request at 16 px, and the JAX package's direction
D, so the solves start from the same point.  Each solve runs 41 steps on
two goals:

- ``dome2tree``, the request's own goal.  Much of it equals the unedited
  window output up to rounding, so the sign of the L1 residual there is
  rounding noise that differs between the packages, and Adam, which
  normalizes each element's step, turns such a sign into a whole step of
  lr (tests/test_torch_rewriter.py's module docstring).  Held: the first
  loss within 1e-5 abs; the Λ·D solves' losses within 1e-4 abs (measured
  2.9e-5 at layer 3, 1.6e-7 at layer 4); the projected-gradient solve's
  last losses within 10% of each other (measured 1.8e-3 apart at layer
  3), as tests/test_torch_rewriter.py holds the layer-3 insert.  (That
  solve's loss jumps up at each projection, in both packages: Adam's
  step off the projected gradient leaves span(D), and the projection
  takes it back.)  Weights are not compared element by element here: a
  tie moves one by up to several steps (measured 0.25 at layer 3).
- ``tie-free``, the same goal plus seeded noise of 1e-2, so no residual is
  rounding noise.  Held: the first loss within 1e-5, every loss within
  1e-4 (measured at most 8.2e-6); the Λ·D solves' weights within
  test_final_weight's 2e-2 abs (measured 7.1e-3); the projected-gradient
  solve's weights with at most 1e-3 of the elements beyond 2e-2 (measured
  2.2e-4 at layer 4: where the projected gradient's cosine is near 0, its
  sign is noise, and Adam steps by lr all the same).

Within the port, the fast solve and the direct one are the same Λ·D
trajectory: losses within 1e-5 (measured 3e-8).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rewriting_tpu.models.stylegan2 import SeqStyleGAN2 as JaxSeqStyleGAN2
from rewriting_tpu.rewrite import SeqStyleGanRewriter as JaxRewriter
from rewriting_tpu.rewrite import solve as jax_solve
from rewriting_tpu.utils.zdataset import z_dataset_for_model as jax_zds
from rewriting_torch.convert import params_from_jax
from rewriting_torch.models.stylegan2 import SeqStyleGAN2
from rewriting_torch.rewrite import (SeqPreStyleGanRewriter,
                                     SeqStyleGanRewriter, projected_conv)
from rewriting_torch.rewrite import solve
from rewriting_torch.utils.zdataset import z_dataset_for_model

torch.set_num_threads(1)

REQUEST = os.path.join(os.path.dirname(__file__), "..", "notebooks", "masks",
                       "stylegan", "church", "dome2tree.json")
NITER, BATCH = 41, 100
LAYERS = (3, 4)


@pytest.fixture(scope="module", params=LAYERS, ids=lambda n: f"layer{n}")
def pair(request):
    """JAX and port rewriters at one layer on the same weights, the goal
    of the dome2tree request in each and the JAX direction."""
    layer = request.param
    with open(REQUEST) as f:
        req = json.load(f)
    jm = JaxSeqStyleGAN2(16, style_dim=64, n_mlp=2)
    jp = jm.init_params(jax.random.PRNGKey(11))
    tm = SeqStyleGAN2(16, style_dim=64, n_mlp=2, device="cpu")
    tp = params_from_jax(tm, jax.tree_util.tree_map(np.asarray, jp))
    jr = JaxRewriter(jm, jp, jax_zds(jm, 1000), layernum=layer,
                     stats_batch_size=BATCH)
    tr = SeqStyleGanRewriter(tm, tp, z_dataset_for_model(tm, 1000),
                             layernum=layer, stats_batch_size=BATCH,
                             device="cpu")
    goals = {}
    for name, rw in (("j", jr), ("t", tr)):
        obj = rw.object_from_selection(*req["object"])
        goals[name] = rw.paste_from_selection(*req["paste"], obj[0], obj[2])
    d = np.asarray(jr.multi_key_from_selection(req["key"], rank=1))
    return {"layer": layer, "req": req, "jr": jr, "tr": tr, "jg": goals["j"],
            "tg": goals["t"], "D": d}


GOALS = ("dome2tree", "tie-free")


def _jax_args(p, goal="dome2tree"):
    jr, g = p["jr"], p["jg"]
    out = jr.target_acts(g[1])
    if goal == "tie-free":
        out = out + jnp.asarray(_noise(out.shape))
    return (jr.target_weight(), (g[0], jr.params), out, jnp.asarray(p["D"]))


def _torch_args(p, goal="dome2tree"):
    tr, g = p["tr"], p["tg"]
    out = g[1]["fmap"]
    if goal == "tie-free":
        n, c, h, w = out.shape
        out = out + torch.from_numpy(np.ascontiguousarray(
            _noise((n, h, w, c)).transpose(0, 3, 1, 2)))
    return (tr.target_weight(), (g[0], tr.params), out,
            torch.from_numpy(np.array(p["D"])))


def _noise(shape):
    return (np.random.RandomState(0).randn(*shape) * 1e-2).astype(np.float32)


def _check(got, want, w0, direction, goal, linear=True):
    (tw, tl), (jw, jl) = got, want
    jl = np.asarray(jl)
    assert tl.shape == jl.shape == (NITER,)
    np.testing.assert_allclose(tl[0], jl[0], atol=1e-5, rtol=0)
    if linear or goal == "tie-free":
        np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)
    else:
        assert abs(tl[-1] - jl[-1]) <= 0.1 * jl[-1]
    if goal == "tie-free":
        diff = np.abs(tw.numpy() - np.asarray(jw))
        if linear:
            np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=2e-2,
                                       rtol=0)
        else:
            assert (diff > 2e-2).mean() <= 1e-3
    delta = tw - w0
    assert delta.abs().max() > 1e-3
    outside = (delta - projected_conv(delta, direction)).norm()
    assert outside <= 1e-4 * delta.norm()


@pytest.mark.parametrize("goal", GOALS)
def test_linear_insert_solve_matches_jax(pair, goal):
    jw0, jgoal, jout, jd = _jax_args(pair, goal)
    tw0, tgoal, tout, td = _torch_args(pair, goal)
    want = jax_solve.linear_insert_solve(pair["jr"]._window_fn, jw0, jgoal,
                                         jout, jd, niter=NITER, lr=0.05)
    got = solve.linear_insert_solve(pair["tr"]._window_fn, tw0, tgoal, tout,
                                    td, niter=NITER, lr=0.05)
    _check(got, want, tw0, td, goal)


@pytest.mark.parametrize("goal", GOALS)
def test_fast_linear_insert_solve_matches_jax(pair, goal):
    jr, tr = pair["jr"], pair["tr"]
    jw0, _, jout, jd = _jax_args(pair, goal)
    tw0, _, tout, td = _torch_args(pair, goal)
    jconv, jtail, jscale, jdemod = jr.fast_parts_cached()
    conv, tail, scale, demod = tr.fast_parts_cached()
    assert (scale, demod) == (jscale, jdemod)
    want = jax_solve.fast_linear_insert_solve(
        jconv, jtail, pair["jg"][0], jr.params, jout, jw0, jd, jscale,
        niter=NITER, lr=0.05, use_demod=jdemod)
    got = solve.fast_linear_insert_solve(
        conv, tail, pair["tg"][0], tr.params, tout, tw0, td, scale,
        niter=NITER, lr=0.05, use_demod=demod)
    _check(got, want, tw0, td, goal)
    if goal == "dome2tree":
        # the same Λ·D trajectory as the port's direct solve
        direct = solve.linear_insert_solve(
            tr._window_fn, tw0, (pair["tg"][0], tr.params), tout, td,
            niter=NITER, lr=0.05)
        np.testing.assert_allclose(got[1], direct[1], atol=1e-5, rtol=0)


def test_fast_parts_at_the_layer(pair):
    """The window's bare conv: the transposed conv at the upsampling layer
    (its map grows to 2h+1) and the padded conv at the even one, against
    the JAX package's on the same input and kernel; the tail is the
    stages after the dconv."""
    jconv, _, jscale, _ = pair["jr"].fast_parts_cached()
    conv, tail, scale, demod = pair["tr"].fast_parts_cached()
    assert scale == jscale and demod
    assert pair["tr"].fast_parts_cached() is pair["tr"].fast_parts_cached()
    rng = np.random.RandomState(2)
    x = rng.randn(2, 6, 4, 4).astype(np.float32)
    w = rng.randn(5, 6, 3, 3).astype(np.float32)
    got = conv(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    want = np.asarray(jconv(jnp.asarray(x.transpose(0, 2, 3, 1)),
                            jnp.asarray(w))).transpose(0, 3, 1, 2)
    size = 9 if pair["layer"] % 2 else 4
    assert got.shape == want.shape == (2, 5, size, size)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    names = tail.stage_names()
    layer = pair["layer"]
    assert names[-1] == f"layer{layer}.sconv.activate"
    assert (f"layer{layer}.sconv.mconv.blur" in names) == bool(layer % 2)


@pytest.mark.parametrize("goal", GOALS)
def test_low_rank_gradient_matches_jax(pair, goal):
    """insert_solve with the gradient projected onto span(D) before each
    Adam step (and the weight projected every piter steps)."""
    jw0, jgoal, jout, jd = _jax_args(pair, goal)
    tw0, tgoal, tout, td = _torch_args(pair, goal)
    want = jax_solve.insert_solve(pair["jr"]._window_fn, jw0, jgoal, jout,
                                  jd, niter=NITER, piter=10, lr=0.05,
                                  low_rank_gradient=True)
    got = solve.insert_solve(pair["tr"]._window_fn, tw0, tgoal, tout, td,
                             niter=NITER, piter=10, lr=0.05,
                             low_rank_gradient=True)
    _check(got, want, tw0, td, goal, linear=False)


def test_low_rank_gradient_alone_keeps_the_span(pair):
    """Without the weight projection, the projected gradient alone keeps
    Adam's update in span(D) (Adam's update is elementwise in the
    gradient, so only to within its normalization: the check is that the
    change is mostly in the span, and more so than without it)."""
    tw0, tgoal, tout, td = _torch_args(pair)
    fn = pair["tr"]._window_fn
    kw = dict(niter=11, lr=0.05, low_rank_insert=False)
    with_proj, _ = solve.insert_solve(fn, tw0, tgoal, tout, td,
                                      low_rank_gradient=True, **kw)
    without, _ = solve.insert_solve(fn, tw0, tgoal, tout, td, **kw)

    def inside(w):
        delta = w - tw0
        return float(projected_conv(delta, td).norm() / delta.norm())
    assert inside(with_proj) > inside(without)


def test_rewriter_routes_the_solves(pair):
    """linear_insert commits its weight; update_callback sees every step
    after the loop; return_timing adds the elapsed ms; fast_linear_insert
    commits its weight and agrees with the direct solve."""
    tr = pair["tr"]
    goal_in, goal_out = pair["tg"][0], pair["tg"][1]
    d = torch.from_numpy(np.array(pair["D"]))
    try:
        direct = tr.linear_insert(goal_in, goal_out, d, niter=5)
        w_direct = tr.target_weight()
        tr.revert()
        seen = []
        timed, ms = tr.linear_insert(goal_in, goal_out, d, niter=5,
                                     update_callback=lambda i, l: seen.append(
                                         (i, float(l))), return_timing=True)
        np.testing.assert_array_equal(timed, direct)
        assert torch.equal(tr.target_weight(), w_direct)
        assert [i for i, _ in seen] == list(range(5))
        assert [l for _, l in seen] == [float(v) for v in direct]
        assert ms > 0
        tr.revert()
        fast = tr.fast_linear_insert(goal_in, goal_out, d, niter=5)
        assert not torch.equal(tr.target_weight(), tr.original_params[
            tr.firstlayer]["weight"])
        np.testing.assert_allclose(fast, direct, atol=1e-5, rtol=0)
    finally:
        tr.revert()


def test_pre_rewriter_falls_back_to_the_direct_solve():
    """SeqPre's window starts at adain, before the linear conv, so it has
    no fast parts (as in the JAX package) and fast_linear_insert runs the
    direct Λ·D solve on the dconv's weight."""
    tm = SeqStyleGAN2(16, style_dim=64, n_mlp=2, device="cpu")
    tp = tm.init_params(seed=2)
    with open(REQUEST) as f:
        req = json.load(f)
    rw = SeqPreStyleGanRewriter(tm, tp, z_dataset_for_model(tm, 1000),
                                layernum=4, stats_batch_size=BATCH,
                                device="cpu")
    assert rw.fast_parts_cached() is None
    obj = rw.object_from_selection(*req["object"])
    goal = rw.paste_from_selection(*req["paste"], obj[0], obj[2])
    d = rw.multi_key_from_selection(req["key"])
    fast = rw.fast_linear_insert(goal[0], goal[1], d, niter=5)
    w_fast = rw.target_weight()
    rw.revert()
    direct = rw.linear_insert(goal[0], goal[1], d, niter=5)
    np.testing.assert_array_equal(fast, direct)
    assert torch.equal(rw.target_weight(), w_fast)
    assert torch.equal(rw.params["layer4.sconv.mconv.dconv"]["weight"],
                       w_fast)

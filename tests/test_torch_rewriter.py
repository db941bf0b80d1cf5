"""The port's edit loop against the JAX package's SeqStyleGanRewriter.

Both rewriters get the same weights (carried across with
``params_from_jax``), the same 1000 seeded z and the published church
request ``dome2tree.json`` at a tiny size (16 px, edit layer 4), and the
intermediate results are compared one by one.  Tolerances, and why:

- second moment, ZCA, keys, goals and samples: fp32 with reordered sums,
  1e-5 relative to the largest entry (measured ~1e-7);
- the direction D, up to sign: 1e-5 (measured 3e-7);
- the solve: its L1 gradient is a sign, so a tie broken the other way moves
  an element by a whole Adam step; over 61 steps the losses agree to 1e-4
  (measured 1.4e-5) and the final weights to 2e-2 (measured 4.5e-3, against
  a weight change of 0.84).
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
from rewriting_tpu.stats import running as jax_running
from rewriting_tpu.stats import tally as jax_tally
from rewriting_tpu.utils.zdataset import z_dataset_for_model as jax_zds
from rewriting_torch.convert import params_from_jax
from rewriting_torch.models.stylegan2 import SeqStyleGAN2
from rewriting_torch.rewrite import SeqStyleGanRewriter, projected_conv
from rewriting_torch.rewrite.solve import rank_one_conv
from rewriting_torch.stats import running, tally
from rewriting_torch.utils.zdataset import z_dataset_for_model

torch.set_num_threads(1)

REQUEST = os.path.join(os.path.dirname(__file__), "..", "notebooks", "masks",
                       "stylegan", "church", "dome2tree.json")
LAYER, NITER, PITER = 4, 61, 10
# 50 z a batch (the chip run uses 10) keeps the JAX scan short
BATCH = 50


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0)


@pytest.fixture(scope="module")
def edit():
    """Both rewriters, and every intermediate of one edit in each."""
    with open(REQUEST) as f:
        req = json.load(f)
    jm = JaxSeqStyleGAN2(16, style_dim=64, n_mlp=2)
    jp = jm.init_params(jax.random.PRNGKey(3))
    tm = SeqStyleGAN2(16, style_dim=64, n_mlp=2, device="cpu")
    tp = params_from_jax(tm, jax.tree_util.tree_map(np.asarray, jp))
    jr = JaxRewriter(jm, jp, jax_zds(jm, 1000), layernum=LAYER,
                     stats_batch_size=BATCH)
    tr = SeqStyleGanRewriter(tm, tp, z_dataset_for_model(tm, 1000),
                             layernum=LAYER, stats_batch_size=BATCH,
                             device="cpu")
    out = {"req": req, "jr": jr, "tr": tr,
           "w0": tr.target_weight().clone()}
    for name, rw in (("j", jr), ("t", tr)):
        obj = rw.object_from_selection(*req["object"])
        goal = rw.paste_from_selection(*req["paste"], obj[0], obj[2])
        mkey = rw.multi_key_from_selection(req["key"], rank=1)
        out[name] = {"obj": obj, "goal": goal, "D": np.asarray(mkey)}
    jw0 = jr.target_weight()
    jgoal, tgoal = out["j"]["goal"], out["t"]["goal"]
    # the JAX insert returns no losses: run its solve directly, as insert does
    jw, jlosses = jax_solve.insert_solve(
        jr._window_fn, jw0, (jgoal[0], jr.params), jr.target_acts(jgoal[1]),
        jnp.asarray(out["j"]["D"]), niter=NITER, piter=PITER, lr=0.05)
    jr.set_target_weight(jw)
    out["j"]["losses"] = np.asarray(jlosses)
    out["t"]["losses"] = tr.insert(tgoal[0], tgoal[1],
                                   torch.as_tensor(out["t"]["D"]),
                                   niter=NITER, piter=PITER, lr=0.05)
    zs = np.stack([jr.zds[i] for i in (0, 819, 960)])
    out["j"]["sample"] = np.asarray(jr.sample_image_from_latent(
        jnp.asarray(zs)))
    out["t"]["sample"] = tr.sample_image_from_latent(zs).numpy()
    return out


def test_split_and_shapes(edit):
    jr, tr = edit["jr"], edit["tr"]
    assert (tr.firstlayer, tr.lastlayer) == (jr.firstlayer, jr.lastlayer)
    assert (tr.k_shape, tr.v_shape, tr.x_shape) == (jr.k_shape, jr.v_shape,
                                                    jr.x_shape)
    names = (tr.context_pipe.stage_names() + tr.target_pipe.stage_names()
             + tr.rendering_pipe.stage_names())
    assert names == tr.model.pipeline.stage_names()


def test_second_moment(edit):
    _close(edit["tr"].c_matrix.numpy(), edit["jr"].c_matrix)


def test_zca(edit):
    _close(edit["tr"].zca_matrix.numpy(), edit["jr"].zca_matrix)


def test_covariance_adjusted_key(edit):
    k = np.random.RandomState(0).randn(edit["tr"].k_shape[-1]).astype(
        np.float32)
    _close(edit["tr"].covariance_adjusted_query_key(k),
           edit["jr"].covariance_adjusted_query_key(k), rel=1e-4)


def test_direction_up_to_sign(edit):
    got, want = edit["t"]["D"], edit["j"]["D"]
    assert got.shape == want.shape == (1, edit["tr"].k_shape[-1])
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    sign = np.sign((got * want).sum())
    np.testing.assert_allclose(sign * got, want, atol=1e-5, rtol=0)


def test_object_selection(edit):
    got, want = edit["t"]["obj"], edit["j"]["obj"]
    _close(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    assert got[3] == want[3]


@pytest.mark.parametrize("part", [0, 1, 2], ids=["goal_in", "goal_out",
                                                 "viz_out"])
def test_paste_goals(edit, part):
    got, want = edit["t"]["goal"], edit["j"]["goal"]
    assert got[3] == want[3]
    _close(edit["tr"].target_acts(got[part]).numpy(),
           np.asarray(want[part]["fmap"]))
    if "output" in want[part]:
        _close(edit["tr"].rendered_image(got[part]).numpy(),
               np.asarray(want[part]["output"]))


def test_loss_trajectory(edit):
    got, want = edit["t"]["losses"], edit["j"]["losses"]
    assert got.shape == want.shape == (NITER,)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert got[-1] < got[0]


def test_final_weight(edit):
    got = edit["tr"].target_weight().numpy()
    want = np.asarray(edit["jr"].target_weight())
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)
    # the change lies in span(D) along the input channels
    delta = edit["tr"].target_weight() - edit["w0"]
    direction = torch.as_tensor(edit["t"]["D"])
    assert delta.abs().max() > 0.1
    outside = (delta - projected_conv(delta, direction)).norm()
    assert outside <= 1e-4 * delta.norm()


def test_edited_sample(edit):
    _close(edit["t"]["sample"], edit["j"]["sample"], rel=1e-3)


def test_revert_restores_the_original(edit):
    tr = edit["tr"]
    zs = tr.zds.zs[:2]
    edited_weight = tr.target_weight()
    edited = tr.sample_image_from_latent(zs)
    tr.revert()
    try:
        assert torch.equal(tr.target_weight(), edit["w0"])
        reverted = tr.sample_image_from_latent(zs)
        assert float((edited - reverted).abs().max()) > 0
    finally:
        tr.set_target_weight(edited_weight)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_stats_cache_shared_between_packages(edit, tmp_path, writer):
    """An r2m.npz cache written by either package loads in the other, and
    a port rewriter given the JAX package's cache reads it in place of
    its own statistics."""
    args = {"sample_size": 1000, "layer": edit["tr"].firstlayer}
    path = str(tmp_path / "r2m.npz")
    mom = np.random.RandomState(4).rand(8, 8).astype(np.float32)
    if writer == "jax":
        obj = jax_running.RunningSecondMoment(
            {"count": jnp.float32(10.0), "mom": jnp.asarray(mom)})
        jax_tally.save_cached_state(path, obj, args)
        back = running.RunningSecondMoment.from_state_dict(
            tally.load_cached_state(path, args))
        got = back.moment().numpy()
    else:
        obj = running.RunningSecondMoment(
            {"count": torch.tensor(10.0), "mom": torch.from_numpy(mom)})
        tally.save_cached_state(path, obj, args)
        back = jax_running.RunningSecondMoment.from_state_dict(
            jax_tally.load_cached_state(path, args))
        got = np.asarray(back.moment())
    np.testing.assert_array_equal(got, mom)
    assert back.count == 10.0
    assert tally.load_cached_state(path, {**args, "sample_size": 5}) is None
    if writer == "jax":
        cachedir = tmp_path / "cache"
        jax_tally.save_cached_state(
            str(cachedir / "r2m.npz"),
            jax_running.RunningSecondMoment({
                "count": jnp.float32(1000.0),
                "mom": jnp.asarray(edit["jr"].c_matrix)}),
            {"sample_size": 1000, "layer": edit["tr"].firstlayer})
        tr = edit["tr"]
        cached = SeqStyleGanRewriter(
            tr.model, tr.original_params, tr.zds, layernum=LAYER,
            cachedir=str(cachedir), device="cpu")
        np.testing.assert_array_equal(cached.c_matrix.numpy(),
                                      np.asarray(edit["jr"].c_matrix))


def test_apply_edit_is_the_same_edit(edit):
    """apply_edit (object, paste, key, solve) repeats the fixture's steps
    exactly: same losses and weight, bit for bit, on the CPU."""
    tr = edit["tr"]
    edited_weight = tr.target_weight()
    tr.revert()
    try:
        losses = tr.apply_edit(edit["req"], rank=1, niter=NITER, piter=PITER,
                               lr=0.05)
        np.testing.assert_array_equal(losses, edit["t"]["losses"])
        assert torch.equal(tr.target_weight(), edited_weight)
    finally:
        tr.set_target_weight(edited_weight)


def _directions(rank, channels):
    q, _ = np.linalg.qr(np.random.RandomState(6).randn(channels, rank))
    return q.T.astype(np.float32)


@pytest.mark.parametrize("shape,rank", [((6, 5, 3, 3), 2),
                                        ((1, 6, 5, 3, 3), 1),
                                        ((1, 6, 5, 3, 3), 3)])
def test_projected_conv_matches_jax(shape, rank):
    w = np.random.RandomState(5).randn(*shape).astype(np.float32)
    d = _directions(rank, shape[-3])
    got = projected_conv(torch.from_numpy(w), torch.from_numpy(d)).numpy()
    want = np.asarray(jax_solve.projected_conv(jnp.asarray(w),
                                               jnp.asarray(d)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_rank_one_conv_matches_jax():
    w = np.random.RandomState(5).randn(6, 5, 3, 3).astype(np.float32)
    d = _directions(1, 5)[0]
    got = rank_one_conv(torch.from_numpy(w), torch.from_numpy(d)).numpy()
    want = np.asarray(jax_solve.rank_one_conv(jnp.asarray(w),
                                              jnp.asarray(d)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# An edit at an upsampling layer (3: the window runs the blur, whose
# gradient the solve needs) and the options of sample_edited's command line
# ---------------------------------------------------------------------------

LAYER3 = 3


@pytest.fixture(scope="module")
def edit3():
    """JAX and port rewriters at layer 3 on the same weights, and the
    object, goal and direction of the dome2tree request in each."""
    with open(REQUEST) as f:
        req = json.load(f)
    jm = JaxSeqStyleGAN2(16, style_dim=64, n_mlp=2)
    jp = jm.init_params(jax.random.PRNGKey(8))
    tm = SeqStyleGAN2(16, style_dim=64, n_mlp=2, device="cpu")
    tp = params_from_jax(tm, jax.tree_util.tree_map(np.asarray, jp))
    jr = JaxRewriter(jm, jp, jax_zds(jm, 1000), layernum=LAYER3,
                     stats_batch_size=BATCH)
    tr = SeqStyleGanRewriter(tm, tp, z_dataset_for_model(tm, 1000),
                             layernum=LAYER3, stats_batch_size=BATCH,
                             device="cpu")
    out = {"req": req, "jr": jr, "tr": tr, "w0": tr.target_weight().clone(),
           "jw0": jr.target_weight()}
    for name, rw in (("j", jr), ("t", tr)):
        obj = rw.object_from_selection(*req["object"])
        goal = rw.paste_from_selection(*req["paste"], obj[0], obj[2])
        out[name] = {"obj": obj, "goal": goal,
                     "D": np.asarray(rw.multi_key_from_selection(
                         req["key"], rank=1))}
    return out


def _solve_both(e, low_rank_insert=True, tight=True):
    """The 61-step solve in both packages from the pristine weight (the
    JAX insert returns no losses: its solve is run as insert runs it)."""
    jr, tr = e["jr"], e["tr"]
    jgoal, tgoal = e["j"]["goal"], e["t"]["goal"]
    if not tight:
        jr.tight_paste = tr.tight_paste = False
        try:
            jgoal, tgoal = (rw.paste_from_selection(
                *e["req"]["paste"], e[k]["obj"][0], e[k]["obj"][2])
                for rw, k in ((jr, "j"), (tr, "t")))
        finally:
            jr.tight_paste = tr.tight_paste = True
    jw, jlosses = jax_solve.insert_solve(
        jr._window_fn, e["jw0"], (jgoal[0], jr.params),
        jr.target_acts(jgoal[1]), jnp.asarray(e["j"]["D"]), niter=NITER,
        piter=PITER, lr=0.05, low_rank_insert=low_rank_insert)
    tr.revert()
    tr.low_rank_insert = low_rank_insert
    try:
        tlosses = tr.insert(tgoal[0], tgoal[1], torch.as_tensor(e["t"]["D"]),
                            niter=NITER, piter=PITER, lr=0.05)
        tw = tr.target_weight()
    finally:
        tr.low_rank_insert = True
        tr.revert()
    return (np.asarray(jw), np.asarray(jlosses)), (tw, tlosses), (jgoal,
                                                                  tgoal)


def test_layer3_window_and_statistics(edit3):
    """The layer-3 window (dconv, blur, noise, activate), its shapes, the
    key second moment and the direction, against the JAX package."""
    jr, tr = edit3["jr"], edit3["tr"]
    assert tr.target_pipe.stage_names() == jr.target_pipe.stage_names()
    assert "layer3.sconv.mconv.blur" in tr.target_pipe.stage_names()
    assert (tr.k_shape, tr.v_shape) == (jr.k_shape, jr.v_shape) == (
        (1, 4, 4, 512), (1, 8, 8, 512))
    _close(tr.c_matrix.numpy(), jr.c_matrix)
    got, want = edit3["t"]["D"], edit3["j"]["D"]
    np.testing.assert_allclose(np.sign((got * want).sum()) * got, want,
                               atol=1e-5, rtol=0)
    _close(tr.target_acts(edit3["t"]["goal"][1]).numpy(),
           np.asarray(edit3["j"]["goal"][1]["fmap"]))


def test_layer3_window_gradient_matches_jax(edit3):
    """The gradient the solve needs, through dconv, the blur, noise and
    activate of the layer-3 window, against jax.grad: 1e-5 of the largest
    entry, for a smooth loss.  (The solve's L1 gradient is not compared
    element by element: much of the goal equals the unedited window output
    up to rounding, so the sign of those residuals is rounding noise that
    differs between the packages; here the two L1 gradients differ by 26%
    of their largest entry.)"""
    jr, tr = edit3["jr"], edit3["tr"]
    jgoal, tgoal = edit3["j"]["goal"], edit3["t"]["goal"]
    want = jax.grad(lambda w: jnp.mean(jnp.square(
        jr.target_acts(jgoal[1]) - jr._window_fn(w, (jgoal[0], jr.params)))))(
            edit3["jw0"])
    w = edit3["w0"].clone().requires_grad_(True)
    torch.mean(torch.square(
        tgoal[1]["fmap"] - tr._window_fn(w, (tgoal[0], tr.params)))).backward()
    _close(w.grad.numpy(), np.asarray(want))


@pytest.mark.parametrize("low_rank", [True, False],
                         ids=["low-rank", "full-rank"])
def test_layer3_edit_matches_jax(edit3, low_rank):
    """The 61-step L1 solve through the blur's gradient, with the
    projection and without it (low_rank_insert=False, --full_rank): the
    first loss agrees to 1e-5 and both fall to within 10% of each other
    (the L1 signs at the ties, above, steer the steps apart); the change
    stays in span(D) only with the projection."""
    (jw, jlosses), (tw, tlosses), _ = _solve_both(edit3,
                                                  low_rank_insert=low_rank)
    assert tlosses.shape == jlosses.shape == (NITER,)
    np.testing.assert_allclose(tlosses[0], jlosses[0], atol=1e-5, rtol=0)
    assert tlosses[-1] < 0.8 * tlosses[0] and jlosses[-1] < 0.8 * jlosses[0]
    assert abs(tlosses[-1] - jlosses[-1]) <= 0.1 * jlosses[-1]
    delta = tw - edit3["w0"]
    direction = torch.as_tensor(edit3["t"]["D"])
    outside = (delta - projected_conv(delta, direction)).norm()
    assert delta.abs().max() > 0.1
    if low_rank:
        assert outside <= 1e-4 * delta.norm()
    else:
        assert outside > 0.5 * delta.norm()


@pytest.mark.parametrize("part", [0, 1], ids=["goal_in", "goal_out"])
def test_whole_map_paste_matches_jax(edit3, part):
    """tight_paste=False (--no_tight_paste): the goals keep the whole
    feature map and the rgb output uncropped, as in the JAX package."""
    _, _, (jgoal, tgoal) = _solve_both(edit3, tight=False)
    assert tgoal[3] == jgoal[3]
    got = edit3["tr"].target_acts(tgoal[part]).numpy()
    want = np.asarray(jgoal[part]["fmap"])
    assert got.shape[1:3] == (edit3["tr"].v_shape[1:3] if part else
                              edit3["tr"].k_shape[1:3])
    _close(got, want)
    _close(edit3["tr"].rendered_image(tgoal[part]).numpy(),
           np.asarray(jgoal[part]["output"]))


@pytest.mark.parametrize("key", [0, 1])
def test_single_key_matches_jax(edit, key):
    """single_key (--single_context), at layer 4: only that key example
    shapes the direction, which matches the JAX package's to 1e-5 up to
    sign; the port's apply_edit equals its own insert with that key bit
    for bit; the edited weight matches the JAX apply_edit's to 2e-2 but
    for ties of the L1 sign (module docstring), which move an element by
    up to a whole Adam step (lr 0.05) -- at most 1e-4 of the elements
    (measured 71 of 2.4M for the second key)."""
    jr, tr = edit["jr"], edit["tr"]
    # dome2tree has one key example: add the object's as a second
    req = dict(edit["req"], key=edit["req"]["key"] + [edit["req"]["object"]])
    t_kept, j_kept = tr.target_weight(), jr.target_weight()
    tr.revert()
    jr.revert()
    try:
        losses = tr.apply_edit(req, rank=1, niter=NITER, piter=PITER,
                               lr=0.05, single_key=key)
        tw = tr.target_weight().clone()
        tr.revert()
        mkey = tr.multi_key_from_selection([req["key"][key]], rank=1)
        jkey = np.asarray(jr.multi_key_from_selection([req["key"][key]],
                                                      rank=1))
        got = mkey.numpy()
        np.testing.assert_allclose(np.sign((got * jkey).sum()) * got, jkey,
                                   atol=1e-5, rtol=0)
        again = tr.insert(edit["t"]["goal"][0], edit["t"]["goal"][1], mkey,
                          niter=NITER, piter=PITER, lr=0.05)
        np.testing.assert_array_equal(losses, again)
        assert torch.equal(tr.target_weight(), tw)
        jr.apply_edit(req, rank=1, niter=NITER, piter=PITER, lr=0.05,
                      single_key=key)
        diff = np.abs(tw.numpy() - np.asarray(jr.target_weight()))
        assert (diff > 2e-2).mean() <= 1e-4 and diff.max() <= 2 * 0.05
    finally:
        tr.set_target_weight(t_kept)
        jr.set_target_weight(j_kept)

"""Many edits solved as one batch (``rewrite/multi.py``) against the port's
own single solves and against the JAX package's vmapped batch.

Four windows, each on the same weights in both packages and 3 requests
painted on the window's map: the tiny ProgGAN of tests/test_multi_edit.py
at layer 3 (the bare conv), a tiny SeqStyleGAN2 at the upsampling layer 3
(dconv .. activate: the edits' rank-1 convs are one grouped transposed
conv, then the blur), at the plain layer 4, and SeqPre at layer 4, whose
window has no fast decomposition (the direct solve, the stacked weights
in the model's own dconv).

Held:
- ``build_goals`` equal to the JAX package's (1e-5 of the largest entry;
  the directions, through the float64 key solve, 1e-4);
- the batch against the port's single solves on the same goals: the final
  losses within 1e-4 abs (measured at most 1.5e-8), every change in
  span(D) (1e-5 abs, tests/test_multi_edit.py's), and the weights within
  1e-4 abs where the batch's convolutions round as the single solve's do
  (ProgGAN and the plain layer: measured 2.4e-7 each).  At the
  upsampling layer the grouped transposed conv's weight gradient rounds
  otherwise (1.9e-6 on a 512-channel probe), and in SeqPre's window the
  grouped dconv; L1 and Adam turn such rounding into whole steps where a
  gradient is near 0 (tests/test_torch_linear_insert.py's docstring), so
  there the weights are held within 2e-2, the cross-package tolerance of
  the single Λ·D solves (measured 9.4e-3 and 1.1e-3 after 15 steps);
- the batch against the JAX batch: on the requests' own goals, where
  ties in the residual differ between the packages, the final losses
  within 1% of each other (measured 2.0e-3 relative, ProgGAN, whose goal
  has values near 1); on the goals plus seeded noise of 1e-2 the losses
  within 1e-4 abs and the weights within 2e-2
  (tests/test_torch_linear_insert.py's), but for SeqPre's weights, which
  the JAX package's own test does not hold (measured 4.7e-2 apart);
- ``preview_edits`` batched within 1e-5 abs of one edit at a time (the
  grouped conv rounds otherwise; measured 2.4e-6), and within 2e-5 abs and
  1e-4 relative of the JAX previews of the same weights.
"""

import jax
import numpy as np
import pytest
import torch

from conftest import blob
from rewriting_tpu.models import ProgressiveGenerator as JaxProgGAN
from rewriting_tpu.models import SeqStyleGAN2 as JaxSeqStyleGAN2
from rewriting_tpu.rewrite import ProgressiveGanRewriter as JaxProgRewriter
from rewriting_tpu.rewrite import SeqPreStyleGanRewriter as JaxPre
from rewriting_tpu.rewrite import SeqStyleGanRewriter as JaxRewriter
from rewriting_tpu.rewrite import multi as jax_multi
from rewriting_tpu.utils.zdataset import z_dataset_for_model as jax_zds
from rewriting_torch.convert import params_from_jax
from rewriting_torch.core import DataBag
from rewriting_torch.models import ProgressiveGenerator, SeqStyleGAN2
from rewriting_torch.rewrite import (ProgressiveGanRewriter,
                                     SeqPreStyleGanRewriter,
                                     SeqStyleGanRewriter, multi,
                                     projected_conv)
from rewriting_torch.utils.renormalize import mask_to_url
from rewriting_torch.utils.zdataset import z_dataset_for_model

torch.set_num_threads(1)

NITER, EDITS = 15, 3
# case -> (weights within this of the single solves: see the docstring)
WEIGHT_TOL = {"proggan3": 1e-4, "stylegan2_up3": 2e-2,
              "stylegan2_plain4": 1e-4, "seqpre4": 2e-2}


def _build(case):
    if case == "proggan3":
        jm = JaxProgGAN(sizes=[16, 16, 8, 8])
        tm = ProgressiveGenerator(sizes=[16, 16, 8, 8], device="cpu")
        classes, layer, key = (JaxProgRewriter, ProgressiveGanRewriter), 3, 3
        nz = 20
    else:
        jm = JaxSeqStyleGAN2(16, style_dim=32, n_mlp=2)
        tm = SeqStyleGAN2(16, style_dim=32, n_mlp=2, device="cpu")
        layer, key = (3 if case == "stylegan2_up3" else 4), 5
        classes = ((JaxPre, SeqPreStyleGanRewriter) if case == "seqpre4"
                   else (JaxRewriter, SeqStyleGanRewriter))
        nz = 100     # enough keys for a full-rank 512-channel moment
    jp = jax.tree_util.tree_map(np.asarray,
                                jm.init_params(jax.random.PRNGKey(key)))
    jr = classes[0](jm, jp, jax_zds(jm, nz), layernum=layer,
                    stats_batch_size=20)
    tr = classes[1](tm, params_from_jax(tm, jp), z_dataset_for_model(tm, nz),
                    layernum=layer, stats_batch_size=20, device="cpu")
    vh, vw = tr.v_shape[1:3]
    requests = [{"object": [i, mask_to_url(blob(vh, vw, 2 + i % 3, 2, 2))],
                 "paste": [i + 4, mask_to_url(blob(vh, vw, 5, 5 - i % 2, 2))]}
                for i in range(EDITS)]
    return {"case": case, "jr": jr, "tr": tr, "reqs": requests}


@pytest.fixture(scope="module", params=sorted(WEIGHT_TOL))
def pair(request):
    return _build(request.param)


@pytest.fixture(scope="module")
def batches(pair):
    """(port goals, the port's batch, the JAX batch) on the requests."""
    tr, jr, reqs = pair["tr"], pair["jr"], pair["reqs"]
    goals = multi.build_goals(tr, reqs)
    got = multi.batch_apply_edits(tr, reqs, niter=NITER, lr=0.05)
    want = jax_multi.batch_apply_edits(jr, reqs, niter=NITER, lr=0.05)
    return goals, got, want


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0)


def test_build_goals_match_jax(pair, batches):
    goals = batches[0]
    jgoals = jax_multi.build_goals(pair["jr"], pair["reqs"])
    assert pair["tr"].tight_paste and pair["jr"].tight_paste
    assert len(goals) == len(jgoals) == EDITS
    for (gin, gout, d), (jgin, jgout, jd) in zip(goals, jgoals):
        _close(gin["fmap"].permute(0, 2, 3, 1).numpy(), jgin["fmap"])
        _close(gout.permute(0, 2, 3, 1).numpy(), jgout)
        _close(d.numpy(), jd, rel=1e-4)
        assert tuple(gout.shape[2:]) == tuple(pair["tr"].v_shape[1:3])


def _single(tr, goal, niter):
    """The port's single solve of one goal: its weight and final loss."""
    gin, gout, d = goal
    losses = tr.fast_linear_insert(gin, DataBag(gin, fmap=gout), d,
                                   niter=niter, lr=0.05)
    w = tr.target_weight()
    tr.revert()
    return w, losses[-1]


def test_batch_matches_single_solves(pair, batches):
    tr = pair["tr"]
    goals, (weights, losses), _ = batches
    assert len(weights) == EDITS and losses.shape == (EDITS,)
    assert np.isfinite(losses).all()
    w0 = tr.target_weight()
    assert torch.equal(w0, tr.original_params[tr.weight_stage()]["weight"])
    assert (tr.fast_parts_cached() is None) == (pair["case"] == "seqpre4")
    for i in (0, EDITS - 1):
        assert weights[i].shape == w0.shape
        w, loss = _single(tr, goals[i], NITER)
        np.testing.assert_allclose(losses[i], loss, atol=1e-4, rtol=0)
        np.testing.assert_allclose(weights[i].numpy(), w.numpy(),
                                   atol=WEIGHT_TOL[pair["case"]], rtol=0)
        delta = weights[i] - w0
        np.testing.assert_allclose(
            delta.numpy(), projected_conv(delta, goals[i][2]).numpy(),
            atol=1e-5)
    assert float((weights[0] - weights[1]).abs().max()) > 1e-6


def test_batch_matches_jax_batch(pair, batches):
    _, (_, losses), (_, jlosses) = batches
    np.testing.assert_allclose(losses, np.asarray(jlosses), atol=0,
                               rtol=1e-2)


def test_batch_matches_jax_batch_tie_free(pair, monkeypatch):
    """Both batches on the requests' goals plus seeded noise of 1e-2, so no
    residual is rounding noise."""
    tr, jr, reqs = pair["tr"], pair["jr"], pair["reqs"]
    goals = multi.build_goals(tr, reqs)
    jgoals = jax_multi.build_goals(jr, reqs)
    noisy, jnoisy = [], []
    for i, ((gin, gout, d), (jgin, jgout, jd)) in enumerate(zip(goals,
                                                                 jgoals)):
        n, c, h, w = gout.shape
        noise = (np.random.RandomState(i).randn(n, h, w, c)
                 * 1e-2).astype(np.float32)
        noisy.append((gin, gout + torch.from_numpy(np.ascontiguousarray(
            noise.transpose(0, 3, 1, 2))), torch.from_numpy(np.array(jd))))
        jnoisy.append((jgin, jgout + noise, jd))
    monkeypatch.setattr(multi, "build_goals", lambda gw, r, rank=1: noisy)
    monkeypatch.setattr(jax_multi, "build_goals",
                        lambda gw, r, rank=1: jnoisy)
    weights, losses = multi.batch_apply_edits(tr, reqs, niter=NITER)
    jweights, jlosses = jax_multi.batch_apply_edits(jr, reqs, niter=NITER)
    np.testing.assert_allclose(losses, np.asarray(jlosses), atol=1e-4,
                               rtol=0)
    if pair["case"] == "seqpre4":
        # the JAX package holds its own SeqPre batch by the losses and the
        # Λ·D constraint only (tests/test_multi_edit.py:83-90): its vmapped
        # direct solve already moves the weights by more than 2e-2
        return
    for w, jw in zip(weights, jweights):
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=2e-2,
                                   rtol=0)


def test_preview_edits_match_jax(pair, batches):
    tr, jr = pair["tr"], pair["jr"]
    _, _, (jweights, _) = batches
    weights = [torch.from_numpy(np.array(w)) for w in jweights]
    zs = tr.zds.zs[:2]
    batched = multi.preview_edits(tr, weights, zs)
    single = multi.preview_edits(tr, weights, zs, batched=False)
    size = tr.x_shape[1]
    assert batched.shape == single.shape == (EDITS, 2, size, size, 3)
    np.testing.assert_allclose(batched, single, atol=1e-5, rtol=0)
    want = jax_multi.preview_edits(jr, jweights, zs)
    np.testing.assert_allclose(batched, np.asarray(want), atol=2e-5,
                               rtol=1e-4)
    assert np.abs(batched[0] - batched[1]).max() > 1e-6
    assert torch.equal(tr.target_weight(),
                       tr.original_params[tr.weight_stage()]["weight"])

"""How far two runs of the Λ·D edit solve land apart on one CUDA device.

Church-256 at its published widths (random weights, seed 0), the layer-7
rewriter (an upsampling layer: the window runs the FIR blur) and the
goals of four edit requests.  For each of cuDNN's default and its
deterministic algorithms, it runs the fast Λ·D solve of the first request
twice alone, and the four as one batch twice
(``solve.fast_linear_insert_solve_batched``), for 1 step and for
``--steps`` steps, and prints the weights' max abs difference and the
losses' between the runs: alone vs alone, batch vs batch, batch vs alone.
Then the first step's gradient of the single solve, computed twice: how
far apart, how large, and the share of its elements near 0, whose sign
Adam's first step turns into a whole step of lr.  With ``--where``,
instead: which computation of an edit differs run to run with cuDNN's
default algorithms: the goals built twice (forward passes only), each
solve's precomputed terms (the fast solve's base convolution, the
batch's Λ = 0 anchor), the solves and ``batch_apply_edits`` run twice as
the port runs them, and ``batch_apply_edits`` run twice inside
``precision.deterministic()``.

    python3 scripts/probe_solve_determinism.py [--steps 2001] [--where]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from rewriting_torch.core import DataBag  # noqa: E402
from rewriting_torch.models.stylegan2 import SeqStyleGAN2  # noqa: E402
from rewriting_torch import _native_build as _build  # noqa: E402
from rewriting_torch.rewrite import SeqStyleGanRewriter, solve  # noqa: E402
from rewriting_torch.rewrite.multi import build_goals, fold_bags  # noqa: E402
from rewriting_torch.utils.zdataset import z_dataset_for_model  # noqa: E402

REQUESTS = ("dome2tree", "sky2tree", "spire2tree", "tree2building")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=2001)
    ap.add_argument("--where", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("probe_solve_determinism: no CUDA device")
    _build.build_all(["blur2d"])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    model = SeqStyleGAN2(256, style_dim=512, n_mlp=8, device="cuda")
    rw = SeqStyleGanRewriter(model, model.init_params(seed=0),
                             z_dataset_for_model(model, 1000), layernum=7)
    requests = []
    for name in REQUESTS:
        with open(os.path.join(ROOT, "notebooks", "masks", "stylegan",
                               "church", f"{name}.json")) as f:
            requests.append(json.load(f))
    goals = build_goals(rw, requests)
    conv_fn, tail_fn, scale, use_demod = rw.fast_parts_cached()
    bag = fold_bags([g[0] for g in goals])
    goal_out = torch.cat([g[1] for g in goals])
    directions = torch.stack([g[2] for g in goals])
    out0 = torch.cat([rw._target(rw.params, g[0])["fmap"] for g in goals])
    w0 = rw.target_weight()

    def alone(n):
        g = goals[0]
        return solve.fast_linear_insert_solve(
            conv_fn, tail_fn, g[0], rw.params, g[1], w0, g[2], scale,
            niter=n, use_demod=use_demod)

    def batch(n):
        return solve.fast_linear_insert_solve_batched(
            conv_fn, tail_fn, bag, rw.params, goal_out, w0, directions,
            scale, niter=n, use_demod=use_demod, out0=out0)

    def apart(a, b):
        return float((a - b).abs().max())

    if args.where:
        where(rw, requests, goals, alone, batch, apart, args.steps)
        return
    rows = []
    for deterministic in (False, True):
        torch.backends.cudnn.deterministic = deterministic
        for n in (1, args.steps):
            s1, s2 = alone(n), alone(n)
            b1, b2 = batch(n), batch(n)
            row = {"cudnn_deterministic": deterministic, "steps": n,
                   "alone_vs_alone_w": apart(s1[0], s2[0]),
                   "alone_vs_alone_loss": float(np.abs(s1[1] - s2[1]).max()),
                   "batch_vs_batch_w": apart(b1[0], b2[0]),
                   "batch_vs_alone_w": apart(b1[0][0], s1[0]),
                   "batch_vs_alone_loss": float(
                       np.abs(b1[1][:, 0] - s1[1]).max()),
                   "edit_max_abs": apart(s1[0], w0)}
            rows.append(row)
            print(json.dumps(row), flush=True)
    torch.backends.cudnn.deterministic = False

    def first_gradient():
        gin, gout, d = goals[0]
        lam = torch.zeros((w0.shape[1], d.shape[0], 3, 3), device="cuda",
                          requires_grad=True)
        w4 = w0[0]
        with torch.no_grad():
            x = gin["fmap"]
            x_d = torch.einsum("di,bihw->bdhw", d, x)
            base = conv_fn(x, w4 * scale)
        out = base + conv_fn(x_d, lam * scale)
        w = w4 + torch.einsum("odyx,di->oiyx", lam, d)
        w_sq = torch.sum(torch.square(w * scale), dim=(-2, -1))
        out = out * torch.rsqrt(torch.square(gin["style"]) @ w_sq.t()
                                + 1e-8)[:, :, None, None]
        out = tail_fn(rw.params, DataBag(gin, fmap=out))["fmap"]
        torch.mean(torch.abs(gout - out)).backward()
        return lam.grad
    g1, g2 = first_gradient(), first_gradient()
    print(json.dumps({
        "first_gradient_twice_max_abs": apart(g1, g2),
        "first_gradient_max_abs": float(g1.abs().max()),
        "share_below_1e-9": float((g1.abs() < 1e-9).float().mean()),
        "sign_flips": float((torch.sign(g1) != torch.sign(g2)).float()
                            .mean())}))


def where(rw, requests, goals, alone, batch, apart, steps: int) -> None:
    """Each part of an edit computed twice with cuDNN's default
    algorithms (the solves' loops deterministic, as the port runs them),
    and how far apart the two are."""
    from rewriting_torch.ops import precision
    from rewriting_torch.rewrite.multi import batch_apply_edits

    again = build_goals(rw, requests)
    row = {"goals_in": max(apart(a[0]["fmap"], b[0]["fmap"])
                           for a, b in zip(goals, again)),
           "goals_out": max(apart(a[1], b[1]) for a, b in zip(goals, again)),
           "directions": max(apart(a[2], b[2])
                             for a, b in zip(goals, again))}
    conv_fn = rw.fast_parts_cached()[0]
    w4 = rw.target_weight()[0]
    with torch.no_grad():
        x = goals[0][0]["fmap"]
        row["base_conv"] = apart(conv_fn(x, w4), conv_fn(x, w4))
        t1, t2 = (rw._target(rw.params, goals[0][0])["fmap"]
                  for _ in range(2))
        row["target_forward"] = apart(t1, t2)
    s1, s2 = alone(steps), alone(steps)
    b1, b2 = batch(steps), batch(steps)
    row.update({"steps": steps, "alone_twice_w": apart(s1[0], s2[0]),
                "batch_twice_w": apart(b1[0], b2[0])})
    w1, _ = batch_apply_edits(rw, requests, niter=steps)
    w2, _ = batch_apply_edits(rw, requests, niter=steps)
    row["batch_apply_edits_twice_w"] = max(apart(a, b)
                                           for a, b in zip(w1, w2))
    with precision.deterministic():
        w1, _ = batch_apply_edits(rw, requests, niter=steps)
        w2, _ = batch_apply_edits(rw, requests, niter=steps)
    row["batch_apply_edits_twice_w_deterministic"] = max(
        apart(a, b) for a, b in zip(w1, w2))
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()

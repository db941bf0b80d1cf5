"""Why the host-bound edit solve runs slower a step in a child process.

Times the four layer-7 edits of ``chip_smoke.BATCH_REQUESTS`` solved as
one batch (``batch_apply_edits``, `--steps` steps, cuDNN's deterministic
algorithms, church-256 at its published widths, seeded weights) in turns:

1. in a child process (``comm.spawn``, one rank, gloo) while this process
   has not touched the card;
2. in this process;
3. in a child again, while this process holds its own CUDA context and
   model on the card;
4. in this process again.

Prints each run's ms a step (the solve's own timing) and the card's name
and power limit.

    python3 scripts/probe_child_solve.py [--steps 501]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def solve_ms_a_step(steps: int) -> float:
    """Build church-256, a layer-7 rewriter over 1000 z and solve the four
    requests as one batch; the solve's ms a step."""
    import chip_smoke as cs
    from rewriting_torch.models.stylegan2 import SeqStyleGAN2
    from rewriting_torch.ops.precision import apply_parity_tier
    from rewriting_torch.rewrite import SeqStyleGanRewriter
    from rewriting_torch.rewrite.multi import batch_apply_edits
    from rewriting_torch.utils.zdataset import z_dataset_for_model

    apply_parity_tier()
    model = SeqStyleGAN2(256, style_dim=512, n_mlp=8, channel_multiplier=2,
                         device="cuda")
    params = model.init_params(seed=0)
    rw = SeqStyleGanRewriter(model, params, z_dataset_for_model(model, 1000),
                             7, device="cuda")
    requests = []
    for name in cs.BATCH_REQUESTS:
        with open(os.path.join(cs.MASKS, "church", f"{name}.json")) as f:
            requests.append(json.load(f))
    ms = batch_apply_edits(rw, requests, niter=steps, return_timing=True)[2]
    return ms / steps


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=501)
    args = ap.parse_args(argv)
    from rewriting_torch import _native_build as _build
    from rewriting_torch.parallel import comm

    _build.build_all(("blur2d", "upconv_blur", "upsample2x"))
    runs = [("child, this process off the card",
             lambda: comm.spawn(solve_ms_a_step, 1, device="cuda:0",
                                backend="gloo", args=(args.steps,))[0]),
            ("this process", lambda: solve_ms_a_step(args.steps)),
            ("child, this process on the card",
             lambda: comm.spawn(solve_ms_a_step, 1, device="cuda:0",
                                backend="gloo", args=(args.steps,))[0]),
            ("this process again", lambda: solve_ms_a_step(args.steps))]
    for label, run in runs:
        print(f"{label}: {run():.4f} ms a step ({args.steps} steps)",
              flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(f"card: {smi.stdout.strip().splitlines()[0]}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""Phase 37 of ``chip_smoke.py`` alone, on one CUDA device: the Neural
Best Buddies copy-paste baseline (``rewriting_torch/baselines/nbb.py``)
at church-256.

Builds the blur kernel (K2), samples 4 church-256 PNGs (seed 0) with
``sample_clean`` into a temporary directory, then runs
``chip_smoke.check_nbb`` on the first two: ``neural_best_buddies`` with 10
pairs a level on the card and on the CPU, held together, then
``nbb_paste`` with its defaults on the card, copying the dome2tree
request's object region.  Prints each level's counts and each stage's
seconds, the kernels' launches in the phase (all 0) and the card's name
and power limit; exits non-zero if a check fails.

    python3 scripts/smoke_slice14.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch

    import chip_smoke as cs
    from rewriting_torch.metrics.sample import sample_clean
    from rewriting_torch.models.stylegan2 import SeqStyleGAN2
    from rewriting_torch import _native_build as _build
    from rewriting_torch.ops import blur2d as kblur
    from rewriting_torch.ops.precision import apply_parity_tier

    if not torch.cuda.is_available():
        print("smoke_slice14: no CUDA device", file=sys.stderr)
        return 1
    t_all = time.time()
    apply_parity_tier()
    t0 = time.time()
    _build.build_all(("blur2d",))
    kblur.library()
    cs.phase("build", t0)
    with tempfile.TemporaryDirectory(prefix="smoke_slice14_") as work:
        t0 = time.time()
        clean_dir = os.path.join(work, "clean")
        church = SeqStyleGAN2(256, style_dim=512, n_mlp=8,
                              channel_multiplier=2, device="cuda")
        sample_clean(church, church.init_params(seed=0), clean_dir, n=4,
                     batch_size=4)
        del church
        cs.phase("set-up", t0)
        t0 = time.time()
        base = cs.slice12_counts()
        res = cs.check_nbb(clean_dir)
        launches = {k: v - base[k] for k, v in cs.slice12_counts().items()}
        print(f"launches on phase 37: {launches}")
        if any(launches.values()):
            raise AssertionError(f"phase 37 launched {launches}")
        print(json.dumps({"nbb": res}))
        cs.phase("37 NBB copy-paste baseline at church-256", t0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(f"card: {smi.stdout.strip()}")
    cs.phase("all", t_all)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Phase 38 of ``chip_smoke.py`` alone, on one CUDA device: the sharded
samplers (``rewriting_torch/parallel``) at faces-1024 (StyleGAN2,
``channel_multiplier=2``, depth uncut) on seeded weights written under
the released file name and loaded through the zoo, batch 8.

Builds the kernels, writes the seeded checkpoint in a temporary directory,
then runs ``chip_smoke.check_sharded_faces``: K1 and its one-pass mode
against their plain versions at the spatial bands' slab shapes; a job of
4 ranks sharing the card over gloo with the 1 x 4 and 2 x 2 bands (K1's
gate on at every layer, then the "default" schedule from 256 px) against
one device's ``pipeline_fast``, and the int8 schedule on dp, tp and the
1 x 4 bands against one device's int8 forward, each quantization's int8
values counted.  Prints each rank's numbers and launches, the phase's
seconds and the card's name and power limit; exits non-zero if a check
fails.  ``--repeat N`` runs the job N times in the one call (the bands'
seconds vary with the host).

    python3 scripts/smoke_slice15.py [--repeat N]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    import torch

    import chip_smoke as cs
    from rewriting_torch import _native_build as _build
    from rewriting_torch.ops import blur2d as kblur
    from rewriting_torch.ops import upconv_blur as kup
    from rewriting_torch.ops.precision import apply_parity_tier

    args = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    args.add_argument("--repeat", type=int, default=1)
    args = args.parse_args(argv)
    if not torch.cuda.is_available():
        print("smoke_slice15: no CUDA device", file=sys.stderr)
        return 1
    t_all = time.time()
    apply_parity_tier()
    t0 = time.time()
    _build.build_all(("blur2d", "upconv_blur", "upconv_blur_bf16"))
    kblur.library(), kup.library(), kup.library_bf16()
    cs.phase("build", t0)
    with tempfile.TemporaryDirectory(prefix="smoke_slice15_") as work:
        t0 = time.time()
        weights = os.path.join(work, "weights")
        files = cs.write_seeded_weights(weights, {}, which=("faces",))
        print("seeded checkpoint: " + ", ".join(
            f"{k} {v:.1f} MiB" for k, v in files.items()))
        cs.phase("set-up", t0)
        for _ in range(args.repeat):
            t0 = time.time()
            kernels = {name: {} for name in ("blur2d", "upconv_blur",
                                             "upconv_blur_bf16",
                                             "upsample2x")}
            sharded = cs.check_sharded_faces(weights)
            cs.add_slice15(kernels, sharded)
            print(json.dumps({"sharded_faces": sharded}))
            print(json.dumps({"slice15_launches": {
                k: v["slice15_launches"] for k, v in kernels.items()}}))
            cs.phase("38 sharded paths at faces-1024", t0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(f"card: {smi.stdout.strip()}")
    cs.phase("all", t_all)
    return 0


if __name__ == "__main__":
    sys.exit(main())

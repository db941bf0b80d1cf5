"""Phase 39 of ``chip_smoke.py`` alone, on one CUDA device: JPEG reading
(``rewriting_torch/csrc/jpegdec.cpp``, built with the host compiler at
first use) for FID and the patch-FID real samples, and every other image
file through PIL.

Writes pytorch-fid's Inception on seeded weights under its released file
name in a temporary ``$REWRITING_TPU_WEIGHTS``, then runs
``chip_smoke.check_jpeg``: every fixture of ``tests/data/jpeg`` against
PIL's decode of it stored as a PNG (0 LSB), ``read_batches`` images/s of
256 copies of the 256x256 4:2:0 fixture (on its default pool of threads
and on one) and of its PNG twin, the median ms of one decode, FID's
statistics and ``get_gt_samples`` of 64 JPEGs against the same pixels as
PNGs, the truncated fixture refused, the CMYK one and every file of
``tests/data/images`` (``scripts/make_image_fixtures.py``) read as PIL on
the card's host reads them, alone and through ``read_batches``, PIL's
version, and no kernel launched.  Prints the phase's numbers and seconds
and the card's name and power limit; exits non-zero if a check fails.
``--repeat N`` runs the phase N times in the one call (the decode rates
vary with the host).

    python3 scripts/smoke_slice16.py [--repeat N]
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

    args = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    args.add_argument("--repeat", type=int, default=1)
    args = args.parse_args(argv)
    if not torch.cuda.is_available():
        print("smoke_slice16: no CUDA device", file=sys.stderr)
        return 1
    t_all = time.time()
    with tempfile.TemporaryDirectory(prefix="smoke_slice16_") as work:
        t0 = time.time()
        weights = os.path.join(work, "weights")
        files = cs.write_seeded_weights(weights, {}, which=("inception",))
        print("seeded weights: " + ", ".join(
            f"{k} {v:.1f} MiB" for k, v in files.items()))
        cs.phase("set-up", t0)
        for i in range(args.repeat):
            t0 = time.time()
            kernels = {name: {} for name in ("blur2d", "upconv_blur",
                                             "upconv_blur_bf16",
                                             "upsample2x")}
            rundir = os.path.join(work, f"run{i}")
            os.makedirs(rundir)
            with cs.weights_env(weights):
                jpeg = cs.check_jpeg(rundir, cs.slice12_counts)
            cs.add_slice16(kernels, jpeg)
            print(json.dumps({"jpeg": jpeg}))
            print(json.dumps({"jpeg_launches": {
                k: v["jpeg_launches"] for k, v in kernels.items()}}))
            cs.phase("39 JPEG reading", t0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(f"card: {smi.stdout.strip()}")
    cs.phase("all", t_all)
    return 0


if __name__ == "__main__":
    sys.exit(main())

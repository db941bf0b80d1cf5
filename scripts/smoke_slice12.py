"""Phases 34-36 of ``chip_smoke.py`` alone, on one CUDA device: faces-1024
(StyleGAN2, ``channel_multiplier=2``) and ProgGAN celebhq-1024 on seeded
weights written under their released file names and loaded through the
zoo, and the ``SemanticSegmenter`` encoders and decoders no caller sets.

Builds the three kernels, writes the two seeded checkpoints and samples 4
church-256 PNGs (seed 0) for phase 36 in a temporary directory, then runs
``chip_smoke.run_slice12``: ``pipeline_fast`` (s2d tail), ``fused=True``
and K1 against the seq pipeline; K1's one-pass bf16 mode against its
plain version; the recommended, int8 and "default" schedules against
"highest" (PSNR, images/s); an edit bit for bit with and without an
installed schedule; the skip upsample's two forms; celebhq-1024's tail
and schedule; each segmenter arch and decoder, card against CPU.  Prints
the phases' lines and seconds, the kernels' rows and the card's name and
power limit; exits non-zero if a check fails.

    python3 scripts/smoke_slice12.py
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
    from rewriting_torch.ops import upconv_blur as kup
    from rewriting_torch.ops import upsample2x as kup2
    from rewriting_torch.ops.precision import apply_parity_tier

    if not torch.cuda.is_available():
        print("smoke_slice12: no CUDA device", file=sys.stderr)
        return 1
    t_all = time.time()
    apply_parity_tier()
    t0 = time.time()
    _build.build_all(("blur2d", "upconv_blur", "upconv_blur_bf16",
                      "upsample2x"))
    kblur.library(), kup.library(), kup.library_bf16(), kup2.library()
    for line in _build.build_logs.get("upconv_blur", "").splitlines():
        if "registers" in line or "spill" in line:
            print("K1 ptxas -v:", line.strip())
    cs.phase("build", t0)
    with tempfile.TemporaryDirectory(prefix="smoke_slice12_") as work:
        t0 = time.time()
        weights = os.path.join(work, "weights")
        files = cs.write_seeded_weights(weights, {},
                                        which=("faces", "celebhq"))
        print("seeded 1024 checkpoints: " + ", ".join(
            f"{k} {v:.1f} MiB" for k, v in files.items()))
        clean_dir = os.path.join(work, "clean")
        church = SeqStyleGAN2(256, style_dim=512, n_mlp=8,
                              channel_multiplier=2, device="cuda")
        sample_clean(church, church.init_params(seed=0), clean_dir, n=4,
                     batch_size=4)
        del church
        cs.phase("set-up", t0)
        kernels = {name: {} for name in ("blur2d", "upconv_blur",
                                         "upsample2x")}
        results, launches = cs.run_slice12(weights, clean_dir,
                                           cs.slice12_counts)
        print(f"launches on phases 34-36: {launches}")
        cs.add_slice12(kernels, results, launches)
    print(json.dumps({"kernels": [kernels["upconv_blur_bf16"]]}))
    print(json.dumps({"slice12_launches": {
        k: v["slice12_launches"] for k, v in kernels.items()}}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(f"card: {smi.stdout.strip()}")
    cs.phase("all", t_all)
    return 0


if __name__ == "__main__":
    sys.exit(main())

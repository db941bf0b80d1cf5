"""Phase 41 of ``chip_smoke.py`` alone, on one CUDA device: the published
files downloaded on a miss from a loopback server.

Builds the kernels, writes what phases 12, 15 and 25 write (a seeded
church-256 rosinality checkpoint with a latent_avg, a seeded ProgGAN
church-256 in the old ``features.N`` names, the seeded Inception, SlimNet,
face parser and unified parsing), then runs ``chip_smoke.check_downloads``
on them: the zoo, the mask registry and ``scripts/torch_fetch_weights.py``
fetch each file from a loopback HTTP server byte for byte, the downloaded
church-256 samples 16 z on the card (K2), a missing file is refused by
its URL.  Prints the phase's numbers, the card's name and power limit, and
the library versions; exits non-zero if a check fails.

    python3 scripts/smoke_slice19.py
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
    import numpy as np
    import torch

    import chip_smoke as cs
    from rewriting_torch import _native_build as _build
    from rewriting_torch.models.proggan import ProgressiveGenerator
    from rewriting_torch.models.stylegan2 import SeqStyleGAN2
    from rewriting_torch.ops import blur2d as kblur
    from rewriting_torch.ops import upconv_blur as kup
    from rewriting_torch.ops import upsample2x as kup2
    from rewriting_torch.ops.precision import apply_parity_tier

    if not torch.cuda.is_available():
        print("smoke_slice19: no CUDA device", file=sys.stderr)
        return 1
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, numpy {np.__version__}")
    t_all = time.time()
    apply_parity_tier()
    t0 = time.time()
    names = ("blur2d", "upconv_blur", "upconv_blur_bf16", "upsample2x")
    _build.build_all(names)
    kblur.library(), kup.library(), kup.library_bf16(), kup2.library()
    cs.phase("build", t0)
    with tempfile.TemporaryDirectory(prefix="smoke_slice19_") as work:
        t0 = time.time()
        weights = os.path.join(work, "weights")
        os.makedirs(weights)
        checkpoint = os.path.join(work, "stylegan2_church.pt")
        church = SeqStyleGAN2(256, style_dim=512, n_mlp=8,
                              channel_multiplier=2, device="cuda")
        torch.save(cs.rosinality_checkpoint(church, cs.with_latent_avg(
            church, church.init_params(seed=0))), checkpoint)
        del church
        pg = ProgressiveGenerator(resolution=256, device="cuda")
        proggan = os.path.join(work, "proggan_churchoutdoor.pth")
        torch.save(cs.proggan_checkpoint(pg, pg.init_params(seed=0)),
                   proggan)
        del pg
        files = cs.write_seeded_weights(
            weights, cs.upp_labeldata(),
            which=("inception", "slimnet", "face", "upp"))
        print("seeded weights: " + ", ".join(
            f"{k} {v:.1f} MiB" for k, v in files.items()))
        cs.phase("set-up", t0)
        t0 = time.time()
        res = cs.check_downloads(checkpoint, proggan, weights)
        print(json.dumps({"downloads": res}))
        cs.phase("41 downloads on a miss", t0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(f"card: {smi.stdout.strip()}")
    cs.phase("all", t_all)
    return 0


if __name__ == "__main__":
    sys.exit(main())

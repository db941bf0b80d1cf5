"""Phase 40 of ``chip_smoke.py`` alone, on one CUDA device: the port's
twelve notebooks (``notebooks/torch/``) run with no Jupyter.

Builds the kernels, writes seeded checkpoints under their released names
in a temporary ``$REWRITING_TPU_WEIGHTS`` (StyleGAN2 church-256 with a
latent_avg, faces-1024, ProgGAN kitchen-256, SlimNet, the face parser,
unified parsing and the colour segmenter), then runs
``chip_smoke.check_notebooks``: each notebook on the card on its
released-checkpoint branch, the stats notebooks cut to
``chip_smoke.NOTEBOOK_IMAGES`` images, the interface and reflection
uncut; K2 launched by the interface; reflection's renders against the
same cells on the CPU.
Prints each notebook's seconds and launches, the card's name and power
limit; exits non-zero if a check fails.

    python3 scripts/smoke_slice18.py
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
    from rewriting_torch import _native_build as _build
    from rewriting_torch.models.stylegan2 import SeqStyleGAN2
    from rewriting_torch.ops import blur2d as kblur
    from rewriting_torch.ops import upconv_blur as kup
    from rewriting_torch.ops import upsample2x as kup2
    from rewriting_torch.ops.precision import apply_parity_tier

    if not torch.cuda.is_available():
        print("smoke_slice18: no CUDA device", file=sys.stderr)
        return 1
    t_all = time.time()
    apply_parity_tier()
    t0 = time.time()
    names = ("blur2d", "upconv_blur", "upconv_blur_bf16", "upsample2x")
    _build.build_all(names)
    kblur.library(), kup.library(), kup.library_bf16(), kup2.library()
    cs.phase("build", t0)
    with tempfile.TemporaryDirectory(prefix="smoke_slice18_") as work:
        t0 = time.time()
        weights = os.path.join(work, "weights")
        os.makedirs(weights)
        church = SeqStyleGAN2(256, style_dim=512, n_mlp=8,
                              channel_multiplier=2, device="cuda")
        torch.save(cs.rosinality_checkpoint(church, cs.with_latent_avg(
            church, church.init_params(seed=0))),
            os.path.join(weights, "stylegan2_church.pt"))
        del church
        files = cs.write_seeded_weights(
            weights, cs.upp_labeldata(),
            which=("slimnet", "face", "upp", "color", "faces"))
        files.update(cs.write_notebook_weights(weights))
        print("seeded weights: " + ", ".join(
            f"{k} {v:.1f} MiB" for k, v in files.items()))
        cs.phase("set-up", t0)
        t0 = time.time()
        res = cs.check_notebooks(weights)
        print(json.dumps({"notebooks": res}))
        cs.phase("40 notebooks", t0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(f"card: {smi.stdout.strip()}")
    cs.phase("all", t_all)
    return 0


if __name__ == "__main__":
    sys.exit(main())

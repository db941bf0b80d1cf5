"""Phases 29-32 of ``chip_smoke.py`` alone, on one CUDA device: the
editing server, its command line and the notebook app; the staged and
fused metric pipelines; the experiment DAG; the patch FID sweep and the
real-image samples.

Builds what those phases take from the earlier ones, at church-256's
published widths with random weights from seed 0: the three kernels,
phase 5's layer-8 dome2tree edit (its weight), 64 clean PNGs (K1 on at
every layer, as phase 9 keeps them), 32 PNGs of the edited model, the
checkpoint file under rosinality's names and the seeded slice-9 weights,
in a temporary directory.  Prints each phase's lines, its seconds and the
kernels' launches, and the card's name and power limit; exits non-zero
if a phase fails.

    python3 scripts/smoke_slice10.py [29] [30] [31] [32]

(all four without arguments; phase 32 needs phase 30's staged PNGs, so
32 runs 30 too).
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


def main(argv) -> int:
    import torch

    import chip_smoke as cs
    from rewriting_torch.metrics.sample import sample_clean
    from rewriting_torch.metrics.sample_edited import sample_edited
    from rewriting_torch.models.stylegan2 import SeqStyleGAN2
    from rewriting_torch import _native_build as _build
    from rewriting_torch.ops import blur2d as kblur
    from rewriting_torch.ops import upconv_blur as kup
    from rewriting_torch.ops import upsample2x as kup2
    from rewriting_torch.ops.precision import apply_parity_tier

    if not torch.cuda.is_available():
        print("smoke_slice10: no CUDA device", file=sys.stderr)
        return 1
    which = tuple(argv) or ("29", "30", "31", "32")
    t_all = time.time()
    apply_parity_tier()
    _build.build_all(("blur2d", "upconv_blur", "upsample2x"))
    kblur.library(), kup.library(), kup2.library()

    def counts():
        return {"k1": kup.launches, "k2": kblur.launches,
                "k2_backward": kblur.backward_launches,
                "k2_general": kblur.general_launches,
                "k3": kup2.launches, "k3_general": kup2.general_launches}

    t0 = time.time()
    model = SeqStyleGAN2(256, style_dim=512, n_mlp=8, channel_multiplier=2,
                         device="cuda")
    params = model.init_params(seed=0)
    with tempfile.TemporaryDirectory(prefix="smoke_slice10_") as work:
        loop, rw8 = cs.run_edit_loop(model, params, niter=2001)
        edited_weight = loop.pop("edited_weight")
        del rw8
        clean_dir = os.path.join(work, "clean")
        edited_dir = os.path.join(work, "edited")
        with open(cs.MASK) as f:
            request = json.load(f)
        kup.set_fused_upconv("on", min_res=0)
        try:
            sample_clean(model, params, clean_dir, n=64, batch_size=16)
            sample_edited(model, params, request, 8, edited_dir, n=32,
                          batch_size=16)
        finally:
            kup.set_fused_upconv("off", min_res=256)
        weights = os.path.join(work, "weights9")
        cs.write_seeded_weights(weights, cs.upp_labeldata())
        torch.save(cs.rosinality_checkpoint(model, cs.with_latent_avg(
            model, params)), os.path.join(weights, "stylegan2_church.pt"))
        cs.phase("set-up", t0)
        _, launches = cs.run_slice10(model, params, edited_weight, clean_dir,
                                     edited_dir, work, weights, counts,
                                     which)
    print(f"launches: {launches}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(f"card: {smi.stdout.strip()}")
    cs.phase("all", t_all)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

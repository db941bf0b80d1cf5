"""Phase 33 of ``chip_smoke.py`` alone, on one CUDA device: the
multi-device paths (dp sampling and ``sample_clean(mesh=)``, the
rewriter's sharded key statistics, the batched edits split over ranks,
tensor, spatial and pipeline parallelism) in a 1-rank NCCL job and in
jobs of 2 and 4 ranks sharing the card over gloo.

Builds what phase 33 holds its jobs against, at church-256's published
widths with random weights from seed 0: the three kernels, 64 clean PNGs
(K1 on at every layer, as phase 9 keeps them), phase 5's layer-8 key
moment over 1000 z and phase 16's four edits at layer 7 solved as one
batch (2001 steps), in a temporary directory.  Prints the phase's lines
and seconds and the card's name and power limit; exits non-zero if a
check fails.  The times are ranks sharing one card, not a scaling figure.

    python3 scripts/smoke_slice11.py [--nccl N]

With ``--nccl N`` the checks run instead in one NCCL job of N ranks, rank r
on ``cuda:r`` (a host of N cards): dp x sp 2 x N/2 and 1 x N.
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
    import argparse

    import torch

    import chip_smoke as cs
    from rewriting_torch.metrics.sample import sample_clean
    from rewriting_torch.models.stylegan2 import SeqStyleGAN2
    from rewriting_torch import _native_build as _build
    from rewriting_torch.ops import blur2d as kblur
    from rewriting_torch.ops import upconv_blur as kup
    from rewriting_torch.ops import upsample2x as kup2
    from rewriting_torch.ops.precision import apply_parity_tier
    from rewriting_torch.rewrite import SeqStyleGanRewriter
    from rewriting_torch.rewrite.multi import batch_apply_edits
    from rewriting_torch.utils.zdataset import z_dataset_for_model

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nccl", type=int, default=None,
                    help="one NCCL job of this many ranks, one a card")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("smoke_slice11: no CUDA device", file=sys.stderr)
        return 1
    jobs = cs.MESH_JOBS
    if args.nccl:
        n = args.nccl
        jobs = ((n, "nccl", ("sample", "dp", "moment", "edits", "tp", "sp",
                             "gpipe"), (2, 1) if n % 2 == 0 else (1,)),)
    t_all = time.time()
    apply_parity_tier()
    _build.build_all(("blur2d", "upconv_blur", "upsample2x"))
    kblur.library(), kup.library(), kup2.library()
    model = SeqStyleGAN2(256, style_dim=512, n_mlp=8, channel_multiplier=2,
                         device="cuda")
    params = model.init_params(seed=0)
    with tempfile.TemporaryDirectory(prefix="smoke_slice11_") as work:
        t0 = time.time()
        clean_dir = os.path.join(work, "clean")
        kup.set_fused_upconv("on", min_res=0)
        try:
            sample_clean(model, params, clean_dir, n=64, batch_size=16)
        finally:
            kup.set_fused_upconv("off", min_res=256)
        rw8 = SeqStyleGanRewriter(model, params,
                                  z_dataset_for_model(model, 1000), 8,
                                  device="cuda")
        rw7 = SeqStyleGanRewriter(model, params,
                                  z_dataset_for_model(model, 1000), 7,
                                  device="cuda")
        requests = []
        for name in cs.BATCH_REQUESTS:
            with open(os.path.join(cs.MASKS, "church", f"{name}.json")) as f:
                requests.append(json.load(f))
        losses = batch_apply_edits(rw7, requests, niter=2001)[1]
        r2m7 = cs.moment_cache(rw7)
        del rw7
        torch.cuda.synchronize()
        cs.phase("33's single-device results", t0)
        t0 = time.time()
        multi = cs.check_multi_device(model, params, clean_dir,
                                      rw8.c_matrix, r2m7, losses, work,
                                      jobs=jobs)
        print(json.dumps({"multi_device": multi}))
        cs.phase("33 multi-device paths", t0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(f"card: {smi.stdout.strip().splitlines()[0]}")
    cs.phase("all", t_all)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""Tensor parallelism's forward at faces-1024 under each precision tier,
for one or more checkouts of the repo, on one CUDA device.

``parallel/tensor.py::tensor_sharded_sampler`` (``fast=True``) of
StyleGAN2 faces-1024 (``SeqStyleGAN2(1024, 512, 8, channel_multiplier=2)``,
seeded weights, depth uncut), batch 8, on a 4-way ``model`` axis whose 4
ranks share the card over gloo (as ``chip_smoke.py``'s phase 38 runs
them), K1's gate as it stands by default.  Three tiers: none ("highest"),
the "default" schedule from 256 px and the int8 schedule from 512 px
(phase 38's).  Each is warmed once and timed ``--runs`` times, rank 0's
seconds a forward; a tier that raises is reported with its error.  The
ranks share one card, so no time is a scaling figure.

Each ``--root`` (a checkout; default this one) runs in a fresh Python in
the order given, so ``--root A --root B --root B --root A`` compares two
checkouts within one call.  Prints one JSON line a run, then the card's
name and power limit.

    python3 scripts/time_tp_tiers.py [--root DIR ...] [--runs N]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 8
TIERS = (("highest", None), ("default", 256), ("int8", 512))


def job(spec: dict) -> dict:
    """One rank: every tier's warm-up and timed forwards."""
    import torch
    import torch.distributed as dist

    from rewriting_torch.models.stylegan2 import (SeqStyleGAN2,
                                                  mixed_precision_schedule)
    from rewriting_torch.ops import precision
    from rewriting_torch.ops.precision import apply_parity_tier
    from rewriting_torch.parallel import (comm, make_mesh,
                                          tensor_shard_params,
                                          tensor_sharded_sampler)
    from rewriting_torch.utils.zdataset import standard_z_sample

    apply_parity_tier()
    device = comm.default_device()
    model = SeqStyleGAN2(1024, 512, 8, channel_multiplier=2, device=device)
    params = model.init_params(seed=0)
    mesh = make_mesh(axis="model")
    local = tensor_shard_params(model, params, mesh, axis="model")
    del params
    sample = tensor_sharded_sampler(model, mesh)
    z = standard_z_sample(BATCH, model.z_dim, seed=38)
    noise = model.prepare_noise(BATCH)
    out = {}
    for tier, least in TIERS:
        precision.set_precision_schedule(
            None if least is None
            else mixed_precision_schedule(least, tier=tier))
        try:
            sample(local, z, noise)                 # warm
            secs = []
            for _ in range(spec["runs"]):
                dist.barrier()
                torch.cuda.synchronize(device)
                t1 = time.time()
                sample(local, z, noise)
                torch.cuda.synchronize(device)
                secs.append(time.time() - t1)
            out[tier] = {"s": secs}
        except Exception as e:      # noqa: BLE001 - the parent's int8 raises
            out[tier] = {"raises": f"{type(e).__name__}: {e}"[:200]}
        finally:
            precision.set_precision_schedule(None)
    return out


def one(root: str, runs: int) -> dict:
    """Every tier in the checkout `root` (this process imports it)."""
    sys.path.insert(0, root)
    import torch

    from rewriting_torch import _native_build as _build
    from rewriting_torch.parallel import comm

    t0 = time.time()
    _build.build_all(("blur2d", "upconv_blur", "upconv_blur_bf16"))
    built = time.time() - t0
    device = f"cuda:{torch.cuda.current_device()}"
    ranks = comm.spawn(job, 4, device=device, backend="gloo",
                       timeout_s=1200.0, args=({"runs": runs},))
    return {"root": root, "build_s": built, "tiers": ranks[0]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", action="append", default=None)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("time_tp_tiers: no CUDA device", file=sys.stderr)
        return 1
    if args.one is not None:
        print(json.dumps(one(args.one, args.runs)), flush=True)
        return 0
    for root in args.root or [HERE]:
        root = os.path.abspath(root)
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", root, "--runs", str(args.runs)],
                              cwd=root, capture_output=True, text=True,
                              timeout=1500)
        if proc.returncode != 0:
            print(proc.stderr[-3000:], file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(f"card: {smi.stdout.strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

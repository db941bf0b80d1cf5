"""A dry run of every multi-device path in a job of N ranks.

The port's counterpart of the JAX package's multichip dry run: the same six
steps, through the public entry points, on tiny shapes, each rank one
process of a job that :func:`comm.spawn` starts:

1. data-parallel sampling of a ProgGAN over the mesh;
2. the rewriter with its key statistics sharded over the mesh;
3. N edit requests solved as one batch split over the ranks, and their
   previews;
4. dp x sp sampling of a StyleGAN2 on a 2 x N/2 mesh (skipped for odd N);
5. tensor-parallel sampling over an N-way ``model`` axis;
6. the style MLP as an N-stage GPipe ring.

Each step checks its result against the single-device one.  Rank 0 prints
one line of the form the JAX dry run prints; the exit code is non-zero if
any rank failed.

    python3 -m rewriting_torch.parallel.dryrun --ranks N [--device cpu]
        [--backend gloo]

runs on the card by default (NCCL, rank r on ``cuda:r``); ``--backend
gloo`` lets several ranks share one card.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

TOL = 1e-4      # sharded vs single-device results, of the largest value


def _close(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    scale = max(float(want.abs().max()), 1e-12)
    err = float((got - want).abs().max()) / scale
    if tuple(got.shape) != tuple(want.shape) or not err <= TOL:
        raise AssertionError(f"{what}: {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}, {err:.3e} of max apart")


def steps(n: int) -> str:
    """The six steps on this rank of a job of `n`; rank 0's report line."""
    from ..models import ProgressiveGenerator, SeqStyleGAN2
    from ..rewrite import ProgressiveGanRewriter
    from ..rewrite.multi import batch_apply_edits, preview_edits
    from ..utils.renormalize import mask_to_url
    from ..utils.zdataset import z_dataset_for_model
    from . import (comm, make_mesh, make_mesh_2d, pipelined_style_mapper,
                   sharded_sampler, spatial_sharded_sampler,
                   tensor_shard_params, tensor_sharded_sampler)
    device = comm.default_device()
    mesh = make_mesh(n)
    data = mesh.group("data")

    model = ProgressiveGenerator(sizes=[16, 16, 8, 8], device=device)
    params = model.init_params(seed=0)
    batch = 2 * n
    zds = z_dataset_for_model(model, 4 * n)

    # 1. data-parallel sampling over the mesh
    z = zds.zs[:batch]
    imgs = comm.all_gather(sharded_sampler(model, mesh)(params, z), data)
    _close(imgs, model(params, z), "dp sampling")

    # 2. the rewriter with the key second moment sharded on the mesh
    gw = ProgressiveGanRewriter(model, params, zds, layernum=3,
                                stats_batch_size=n, mesh=mesh,
                                device=device)
    single = ProgressiveGanRewriter(model, params, zds, layernum=3,
                                    stats_batch_size=n, device=device)
    _close(gw.c_matrix, single.c_matrix, "sharded statistics")

    # 3. the batched edit solve, one edit a rank, and the previews
    vh, vw = gw.v_shape[1:3]
    yy, xx = np.mgrid[0:vh, 0:vw]

    def mask(cy, cx):
        return mask_to_url(((yy - cy) ** 2 + (xx - cx) ** 2 <= 4)
                           .astype(np.float32))

    requests = [{"object": [i, mask(2 + i % 3, 2)],
                 "paste": [i + 1, mask(5, 5 - i % 2)]} for i in range(n)]
    weights, losses = batch_apply_edits(gw, requests, rank=1, niter=3,
                                        lr=0.05, mesh=mesh)
    alone, alone_losses = batch_apply_edits(single, requests, rank=1,
                                            niter=3, lr=0.05)
    if len(weights) != n or not np.isfinite(losses).all():
        raise AssertionError(f"{len(weights)} edits, losses {losses}")
    np.testing.assert_allclose(losses, alone_losses, rtol=1e-4, atol=1e-6)
    previews = preview_edits(gw, weights, zds.zs[:2])
    if previews.shape != (n, 2, 16, 16, 3):
        raise AssertionError(f"previews {previews.shape}")

    # 4. batch x spatial (dp x sp) sampling of StyleGAN2 on a 2-D mesh
    sg = SeqStyleGAN2(16, style_dim=16, n_mlp=2, device=device)
    sgp = sg.init_params(seed=1)
    sp = max(1, n // 2)
    if 2 * sp == n:
        mesh2 = make_mesh_2d(2, sp)
        z2 = zds.zs[:4, :16]
        block = spatial_sharded_sampler(sg, mesh2)(sgp, z2)
        imgs2 = comm.all_gather(comm.all_gather(
            block, mesh2.group("spatial"), dim=1), mesh2.group("data"))
        _close(imgs2, sg(sgp, z2), "dp x sp sampling")

    # 5. tensor parallelism over an n-way model axis
    mesh_tp = make_mesh(n, axis="model")
    placed = tensor_shard_params(sg, sgp, mesh_tp, axis="model")
    z_tp = zds.zs[:2, :16]
    imgs_tp = tensor_sharded_sampler(sg, mesh_tp, axis_model="model")(
        placed, z_tp)
    _close(imgs_tp, sg(sgp, z_tp), "tp sampling")

    # 6. the style MLP as an n-stage GPipe ring
    sg_pp = SeqStyleGAN2(16, style_dim=16, n_mlp=n, device=device)
    sgpp = sg_pp.init_params(seed=2)
    mesh_pp = make_mesh(n, axis="stage")
    z_pp = zds.zs[:n, :16]
    w_pp = pipelined_style_mapper(sg_pp, mesh_pp, axis="stage")(sgpp, z_pp)
    seq = sg_pp.pipeline.subsequence(upto_layer="latents")(
        sgpp, sg_pp.make_bag(z_pp))["latent"]
    _close(w_pp, seq, "GPipe style MLP")

    spmsg = (f"2x{sp} dp x sp sampling OK" if 2 * sp == n
             else "dp x sp skipped (odd device count)")
    spmsg += (f", tp sampling over {n}-way model axis OK"
              f", {n}-stage GPipe style MLP OK")
    return (f"dryrun_multichip({n}): sampling {tuple(imgs.shape)}, "
            f"sharded stats C{tuple(gw.c_matrix.shape)}, "
            f"{n} mesh-sharded edits + previews, " + spmsg)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="dry run of the multi-device paths in a job of N ranks")
    ap.add_argument("--ranks", type=int, required=True)
    ap.add_argument("--device", default=None,
                    help="cpu, or cuda (the default: rank r on cuda:r)")
    ap.add_argument("--backend", default=None,
                    help="gloo or nccl (default: nccl on cuda, gloo on cpu)")
    args = ap.parse_args(argv)
    from ..utils.device import resolve_device
    from . import comm
    device = resolve_device(args.device)      # raises without CUDA
    if device.type == "cpu":
        dev = "cpu"
    elif args.backend == "gloo":                # ranks sharing one card
        dev = str(device) if device.index is not None else "cuda:0"
    elif args.ranks > torch.cuda.device_count():
        raise SystemExit(f"NCCL takes one rank a GPU: {args.ranks} ranks, "
                         f"{torch.cuda.device_count()} GPUs; pass --backend "
                         "gloo to share one")
    else:
        dev = None                              # rank r on cuda:r
    lines = comm.spawn(steps, args.ranks, device=dev, backend=args.backend,
                       args=(args.ranks,))
    print(lines[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Sample clean images from a generator into a results directory.

The port's counterpart of the JAX package's ``metrics/sample.py``
(reference metrics/sample.py): one image per z seed (image number == seed;
the FID split offsets the seeds by 1000007), a lightbox gallery page, and
PNG writing on worker threads.  Images are generated in batches through
``model(params, z)`` (the sampling pipeline, ``pipeline_fast``) and
quantised to uint8 on the device; each batch's copy to the host is queued
behind it on the stream, and the host waits for batch i's copy only after
it has queued batch i+1, so the card computes while the host encodes.
The JAX package's multi-stream transport is not ported: that queued copy
takes its place.

With ``mesh=`` (``parallel.make_mesh``; called on every rank) generation
is data-parallel: each rank renders its share of every batch
(``parallel.sharded_sampler``, the noise of its images' global
positions) and writes its own images' PNGs; rank 0 writes the lightbox,
and the ranks meet at a barrier at the end.  The directory equals the
single-device run's.

Command line (JAX package :136-163; reference metrics/sample.py:13-38)::

    python3 -m rewriting_torch.metrics.sample --dataset church [--n 10000]
        [--batch_size 16] [--fid_samples] [--results results/samples]
        [--mesh]

loads the dataset's checkpoint through ``models/zoo.py`` with truncation
0.5, on the card, and writes ``<results>/<dataset>_clean[_fid]/`` with a
``done.txt`` marker at the end; a finished directory is skipped.
``--mesh`` samples data-parallel over every rank of the job, one process
a rank (``torchrun --nproc_per_node N -m rewriting_torch.metrics.sample
... --mesh``): rank 0 reserves the directory and marks it done after the
others have finished.
"""

from __future__ import annotations

import argparse
import os
import shutil

import numpy as np
import torch
import torch.distributed as dist

from ..parallel import comm, make_mesh
from ..parallel.comm import share
from ..parallel.mesh import sharded_sampler
from ..utils import pbar
from ..utils.imgsave import SaveImagePool
from ..utils.pidfile import mark_job_done, reserve_dir
from ..utils.zdataset import standard_z_sample

FID_OFFSET = 1000007  # reference sample.py:20

# zc -> byte scale: the same float32 constants as renormalize(x, "zc",
# "byte") (0.5 / float32(1/255), not exactly 127.5)
_BYTE_SCALE = float(np.float32(0.5) / np.float32(1.0 / 255.0))


def per_image_z(model, imgnums) -> np.ndarray:
    """The reference's z contract: image i uses the FIRST vector of seed i
    (z_sample_for_model(size=1, seed=imgnum), sample.py:34)."""
    return np.stack([standard_z_sample(1, model.z_dim, seed=int(i))[0]
                     for i in imgnums])


def write_lightbox(outdir: str) -> None:
    """Create outdir and put the +lightbox.html gallery page next to the
    numbered PNGs."""
    os.makedirs(outdir, exist_ok=True)
    lightbox = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "..", "utils", "lightbox.html")
    shutil.copyfile(lightbox, os.path.join(outdir, "+lightbox.html"))


def pad_batch(arr: np.ndarray, batch_size: int) -> np.ndarray:
    """Pad a tail batch to batch_size rows by repeating the last row, so
    every batch has one shape (the padded rows are dropped by the
    consumer's zip against the true image numbers)."""
    if arr.shape[0] >= batch_size:
        return arr
    return np.concatenate(
        [arr, np.repeat(arr[-1:], batch_size - arr.shape[0], axis=0)],
        axis=0)


def quantize_uint8(imgs: torch.Tensor) -> torch.Tensor:
    """zc float images -> uint8 on their device (4x fewer bytes to copy).
    Round-trip-equivalent with renormalize(x, "zc", "byte"): the same fp32
    scale and offset, rounded after the multiply and again after the add
    (two operations, not one fused multiply-add), and the truncating
    cast."""
    y = torch.clamp(imgs, -1.0, 1.0) * _BYTE_SCALE
    y = y + _BYTE_SCALE
    return torch.floor(torch.clamp(y, 0.0, 255.0)).to(torch.uint8)


def default_sample_fn(model):
    """(params, z) -> (B, H, W, 3) zc images, through ``model(params,
    z)``."""
    return lambda p, z: model(p, z)


def sample_clean(model, params, outdir: str, n: int = 10000,
                 batch_size: int = 16, offset: int = 0,
                 sample_fn=None, mesh=None) -> None:
    """Write {outdir}/{imgnum}.png for imgnum in [0, n), image i from the z
    of seed i + offset, through ``sample_fn(params, z)`` ((B, H, W, 3) zc
    images; ``default_sample_fn(model)`` if None).  With `mesh` (a 1-D
    ``data`` mesh, ``parallel.make_mesh``), generation is data-parallel
    (`batch_size` a multiple of the mesh size): ``sample_fn`` (the
    sharded sampler if None) returns this rank's rows of each batch, and
    this rank writes those images."""
    first, mine = 0, batch_size
    if mesh is not None:
        first, last = share(batch_size, mesh.group("data"))
        mine = last - first
        if sample_fn is None:
            sample_fn = sharded_sampler(model, mesh)
    if sample_fn is None:
        sample_fn = default_sample_fn(model)
    if mesh is None or dist.get_rank() == 0:
        write_lightbox(outdir)
    os.makedirs(outdir, exist_ok=True)
    saver = SaveImagePool()

    def write(nums, host, copied):
        if copied is not None:
            copied.synchronize()
        for num, img in zip(nums, host.numpy()):
            saver.add(img, os.path.join(outdir, f"{num}.png"))

    try:
        pending = None
        for lo in pbar.pbar(range(0, n, batch_size)):
            nums = list(range(lo, min(lo + batch_size, n)))
            zs = pad_batch(per_image_z(model, [i + offset for i in nums]),
                           batch_size)
            nums = nums[first:first + mine]     # this rank's images
            imgs = quantize_uint8(sample_fn(params, zs))[:len(nums)]
            batch = (nums,) + _queue_copy(imgs)
            if pending is not None:
                write(*pending)    # batch i-1, while batch i runs
            pending = batch
        if pending is not None:
            write(*pending)
    finally:
        saver.close()  # flushes queued writes; idempotent
    if mesh is not None:
        comm.barrier()


def _queue_copy(imgs: torch.Tensor):
    """(host tensor, event): the copy of a CUDA tensor to pinned host
    memory, queued on the stream, and the event that marks its end; a CPU
    tensor is its own copy."""
    if imgs.device.type != "cuda":
        return imgs, None
    host = torch.empty(imgs.shape, dtype=imgs.dtype, pin_memory=True)
    host.copy_(imgs, non_blocking=True)
    copied = torch.cuda.Event()
    copied.record()
    return host, copied


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Sample clean images from a generator")
    ap.add_argument("--dataset", choices=["faces", "church", "horse",
                                          "kitchen", "bedroom", "car",
                                          "cat", "places"], required=True)
    ap.add_argument("--fid_samples", action="store_true")
    ap.add_argument("--n", type=int, default=10000)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--results", default="results/samples")
    ap.add_argument("--mesh", action="store_true",
                    help="data-parallel generation over every rank of the "
                    "job")
    args = ap.parse_args(argv)
    name = f"{args.dataset}_clean" + ("_fid" if args.fid_samples else "")
    outdir = os.path.join(args.results, name)
    mesh = None
    if args.mesh:
        mesh = make_mesh()
        # rank 0 claims the directory; the others follow its decision
        go = torch.ones((), device=mesh.device)
        if mesh.coords["data"] == 0:
            try:
                reserve_dir(outdir)
            except SystemExit:
                go.zero_()
        if not comm.broadcast(go, 0, mesh.group("data")).item():
            return
    else:
        reserve_dir(outdir)
    from ..models.zoo import load_seq_stylegan
    model, params = load_seq_stylegan(
        args.dataset, truncation=0.5,
        **({} if mesh is None else {"device": mesh.device}))
    sample_clean(model, params, outdir, n=args.n, batch_size=args.batch_size,
                 offset=FID_OFFSET if args.fid_samples else 0, mesh=mesh)
    if mesh is None or mesh.coords["data"] == 0:
        mark_job_done(outdir)


if __name__ == "__main__":
    main()

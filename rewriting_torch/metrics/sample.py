"""Sample clean images from a generator into a results directory.

The port's counterpart of the JAX package's ``metrics/sample.py``
(reference metrics/sample.py): one image per z seed (image number == seed;
the FID split offsets the seeds by 1000007), a lightbox gallery page, and
PNG writing on worker threads.  Images are generated in batches through
``model(params, z)`` (the sampling pipeline, ``pipeline_fast``) and
quantised to uint8 on the device; each batch's copy to the host is queued
behind it on the stream, and the host waits for batch i's copy only after
it has queued batch i+1, so the card computes while the host encodes.
The JAX package's multi-stream transport and its device mesh are not
ported.
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import torch

from ..utils import pbar
from ..utils.imgsave import SaveImagePool
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


def sample_clean(model, params, outdir: str, n: int = 10000,
                 batch_size: int = 16, offset: int = 0) -> None:
    """Write {outdir}/{imgnum}.png for imgnum in [0, n), image i from the z
    of seed i + offset, through ``model(params, z)`` ((B, H, W, 3) zc
    images)."""
    write_lightbox(outdir)
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
            imgs = quantize_uint8(model(params, zs))[:len(nums)]
            batch = (nums,) + _queue_copy(imgs)
            if pending is not None:
                write(*pending)    # batch i-1, while batch i runs
            pending = batch
        if pending is not None:
            write(*pending)
    finally:
        saver.close()  # flushes queued writes; idempotent


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

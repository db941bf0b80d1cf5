"""Segment sampled images and save per-image label maps.

The port's counterpart of the JAX package's ``metrics/seg_stats.py``
(reference metrics/seg_stats.py: 10k images, one ``.pth`` per image; here
one ``.npz`` per image, its ``seg`` array int64 whatever the labels'
dtype on the device).  PNGs are decoded batch by batch ahead of the
consumer (``native.read_batches``); each batch's labels are copied to
pinned host memory behind it on the stream, and the host waits for batch
i's copy only after it has queued batch i+1, so the card segments while
the host writes (the scheme of ``metrics/sample.py``).  A segmenter with
``segment_batch_device`` hands back uint8 labels (an eighth of the int64
bytes); one with ``accepts_uint8`` takes the bytes and normalizes them on
its device; any other takes zc float batches.

Command line (reference seg_stats.py:41-58; runs on the card)::

    python3 -m rewriting_torch.metrics.seg_stats church_clean [--n 10000]
        [--results results/samples]

segments ``<results>/<exp_name>/{i}.png`` with the experiment's segmenter
(``load_seg.load_seg_model``) into ``<results>/seg/<exp_name>/{i}.npz``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..native import read_batches
from ..utils import pbar, renormalize
from ..utils.pidfile import mark_job_done, reserve_dir
from ..utils.workerpool import WorkerBase, WorkerPool
from .sample import _queue_copy, pad_batch


class SaveSegWorker(WorkerBase):
    def work(self, path, seg):
        # int64 in the file whatever the copy's dtype: the reference's
        # torch.save(long) artifact
        np.savez_compressed(path, seg=np.asarray(seg, np.int64))


class SaveSegPool(WorkerPool):
    def __init__(self, **kwargs):
        super().__init__(worker=SaveSegWorker, **kwargs)


def segment_images(segmodel, imgs, downsample: int = 1):
    """Labels of a (B, H, W, 3) uint8 batch (numpy or a tensor) by the
    segmenter's own entry: ``segment_batch_device`` (device uint8 labels),
    ``segment_batch`` of the bytes where it ``accepts_uint8``, else
    ``segment_batch`` of zc float32 host images.  `downsample` reaches
    ``segment_batch`` only when it is not 1, so a segmenter without the
    argument still works at 1."""
    if hasattr(segmodel, "segment_batch_device"):
        return segmodel.segment_batch_device(imgs, downsample=downsample)
    kw = {} if downsample == 1 else {"downsample": downsample}
    if getattr(segmodel, "accepts_uint8", False):
        return segmodel.segment_batch(imgs, **kw)
    if isinstance(imgs, torch.Tensor):
        imgs = imgs.cpu().numpy()
    return segmodel.segment_batch(renormalize.renormalize(
        np.asarray(imgs).astype(np.float32) / 255.0, "pt", "zc"), **kw)


def queue_labels(labels):
    """(host tensor, event) of a batch of labels: a device tensor's copy
    queued behind it (``sample._queue_copy``); host labels as they are."""
    if isinstance(labels, torch.Tensor):
        return _queue_copy(labels)
    return torch.from_numpy(np.asarray(labels)), None


def process(segmodel, img_path: str, result_path: str, n: int = 10000,
            batch_size: int = 8):
    """Segment {img_path}/{i}.png -> {result_path}/{i}.npz for i < n
    (reference seg_stats.py:16-27)."""
    os.makedirs(result_path, exist_ok=True)
    saver = SaveSegPool()
    paths = [os.path.join(img_path, f"{i}.png") for i in range(n)]

    def write(nums, host, copied):
        if copied is not None:
            copied.synchronize()
        for num, seg in zip(nums, host.numpy()):
            saver.add(os.path.join(result_path, f"{num}.npz"), seg)

    try:
        pending = None
        start = 0
        for imgs in pbar.pbar(read_batches(paths, batch_size),
                              total=(n + batch_size - 1) // batch_size):
            nums = list(range(start, start + imgs.shape[0]))
            start += imgs.shape[0]
            labels = segment_images(segmodel, pad_batch(imgs, batch_size))
            batch = (nums,) + queue_labels(labels[:len(nums)])
            if pending is not None:
                write(*pending)    # batch i-1, while batch i runs
            pending = batch
        if pending is not None:
            write(*pending)
    finally:
        saver.close()  # flushes queued writes; idempotent


def main(argv=None) -> None:
    ap = argparse.ArgumentParser("seg")
    ap.add_argument("exp_name", type=str)
    ap.add_argument("--n", type=int, default=10000)
    ap.add_argument("--results", default="results/samples")
    args = ap.parse_args(argv)
    from .load_seg import load_seg_model
    img_path = os.path.join(args.results, args.exp_name)
    result_path = os.path.join(args.results, "seg", args.exp_name)
    reserve_dir(result_path)
    segmodel = load_seg_model(args.exp_name)
    process(segmodel, img_path, result_path, n=args.n)
    mark_job_done(result_path)


if __name__ == "__main__":
    main()

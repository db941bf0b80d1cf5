"""Bulk image saving off the device-driving thread.

The port's counterpart of the JAX package's ``utils/imgsave.py``: a worker
pool writes PNGs so the thread that drives the device never blocks on disk
(``SaveImagePool``), plus ``save_image_set`` for nested arrays of images
with a %d filename pattern and an mtime-based skip.  The encoder is the
port's own (``renormalize.encode_png``, zlib + numpy); there is no PIL, so
only ``.png`` is written.
"""

from __future__ import annotations

import os

import numpy as np

from . import pbar, renormalize
from .workerpool import WorkerBase, WorkerPool, default_nworkers


def _is_image_like(data) -> bool:
    return isinstance(data, np.ndarray) and data.ndim == 3


def all_items_and_filenames(img_array, filename_pattern, index=()):
    for i, data in enumerate(img_array):
        inner = index + (i,)
        if _is_image_like(data):
            yield data, (filename_pattern % inner)
        else:
            yield from all_items_and_filenames(data, filename_pattern, inner)


def expand_last_filename(img_array, filename_pattern):
    index, data = (), img_array
    while not _is_image_like(data):
        index += (len(data) - 1,)
        data = data[len(data) - 1]
    return filename_pattern % index


def num_items(img_array):
    num = 1
    while not _is_image_like(img_array):
        num *= len(img_array)
        img_array = img_array[-1]
    return num


def save_png(img: np.ndarray, filename: str) -> None:
    """Write an (H, W, C) uint8 array, or a float zc-normalised one, as a
    PNG file."""
    if not filename.endswith(".png"):
        raise ValueError(f"only .png is written, got {filename}")
    if img.dtype != np.uint8:
        img = renormalize.renormalize(img, "zc", "byte")
    os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
    with open(filename, "wb") as f:
        f.write(renormalize.encode_png(img))


class SaveImageWorker(WorkerBase):
    """Writes one image per task."""

    def work(self, img, filename):
        save_png(np.asarray(img), filename)


class SaveImagePool(WorkerPool):
    """Async image writer; up to 8 worker threads (zlib releases the
    GIL)."""

    def __init__(self, nworkers=None, **kwargs):
        if nworkers is None:
            nworkers = default_nworkers(8)
        super().__init__(worker=SaveImageWorker, nworkers=nworkers, **kwargs)


def save_image_set(img_array, filename_pattern, sourcefile=None):
    """Save a (nested) array of images with a %d-pattern filename; skipped
    entirely if the last file is newer than `sourcefile`."""
    if sourcefile is not None:
        last = expand_last_filename(img_array, filename_pattern)
        if os.path.isfile(last) and (os.path.getmtime(last)
                                     >= os.path.getmtime(sourcefile)):
            pbar.descnext(None)
            return
    pool = SaveImagePool()
    for img, filename in pbar.pbar(
            all_items_and_filenames(img_array, filename_pattern),
            total=num_items(img_array)):
        pool.add(img, filename)
    pool.join()

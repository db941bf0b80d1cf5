"""Bulk image reading for the metrics: one file, or a readahead
stream of batches.

The port's counterpart of the read side of the JAX package's
``native/__init__.py`` (:169-220), over the port's own PNG decoder
(``utils/renormalize.decode_png``, zlib and numpy) where the JAX package
has a C++ decoder with a PIL fallback.  PIL is not a dependency of the
port, so an image is a PNG: any other file raises ``ValueError`` naming
it.  The images the port and the JAX package write are PNGs.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from collections import deque

import numpy as np

from ..utils.renormalize import decode_png


def read_image(path: str) -> np.ndarray:
    """The uint8 pixels of a PNG file in its own mode, as ``numpy.asarray``
    of a PIL image gives them: (H, W) greyscale, (H, W, 2|3|4)
    otherwise."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        img = decode_png(data)
    except ValueError as e:
        raise ValueError(f"cannot read {path}: {e} (the port reads 8-bit "
                         "PNG files only)") from e
    return img[:, :, 0] if img.shape[2] == 1 else img


def read_image_rgb(path: str) -> np.ndarray:
    """The (H, W, 3) uint8 RGB array of a PNG file: alpha dropped, grey
    copied to each channel (PIL's ``convert("RGB")``)."""
    img = read_image(path)
    if img.ndim == 2:
        img = img[:, :, None]
    if img.shape[2] in (1, 2):       # grey, grey + alpha
        return np.repeat(img[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(img[:, :, :3])


def read_batches(paths, batch_size: int, workers: int = None,
                 readahead: int = 2):
    """Yield (B, H, W, 3) uint8 batches of the image files in `paths`,
    decoded on a thread pool `readahead` batches ahead of the consumer.
    Order is kept; the last batch holds the remainder.  (zlib's inflate
    releases the GIL; the rows' unfiltering in numpy mostly does not.)"""
    paths = list(paths)
    if not paths:
        return
    if workers is None:
        workers = min(8, os.cpu_count() or 1)
    window = max(batch_size * (readahead + 1), workers)
    with cf.ThreadPoolExecutor(workers) as ex:
        futs = deque(ex.submit(read_image_rgb, p) for p in paths[:window])
        nxt = window
        batch = []
        while futs:
            batch.append(futs.popleft().result())
            if nxt < len(paths):
                futs.append(ex.submit(read_image_rgb, paths[nxt]))
                nxt += 1
            if len(batch) == batch_size or not futs:
                yield np.stack(batch)
                batch = []

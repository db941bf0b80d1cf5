"""Real-dataset and generated-image sampling for FID ground-truth
statistics and patch-FID crops (reference utils/get_samples.py).

The port's counterpart of the JAX package's ``metrics/samples.py``.  The
reference hardcodes lab-internal dataset paths (get_samples.py:12-30);
here every function takes an explicit image root.  Images are read with
the port's reader (``native.read_image_rgb``: 8-bit PNG and Huffman JPEG
by its own decoders, with PIL's pixels, any other file by PIL, as the JAX
package reads it), their shorter side
resized with PIL's BILINEAR algorithm (``renormalize.resize_bilinear``,
channel by channel),
centre-cropped to the model resolution and normalized to zero-centred
float32 (reference get_transform, get_samples.py:58-65).  Generated
images come from ``model(params, z)`` on the model's device.
"""

from __future__ import annotations

import os
import random
from typing import List, Optional, Sequence

import numpy as np

from ..native import read_image_rgb
from ..utils import pbar
from ..utils.parallelfolder import walk_image_files
from ..utils.renormalize import resize_bilinear


def get_image_paths(root: str, n: Optional[int] = None,
                    seed: int = 1) -> List[str]:
    """Up to n image paths under root (reference get_samples.py:33-55).

    If `root + '.txt'` exists it is read as a newline-separated list of
    paths relative to root (the reference's precomputed LSUN file lists);
    otherwise the tree is walked.  Selection is shuffled with a SEEDED rng
    (the reference uses the global `random` — seeding keeps stats
    reproducible across runs)."""
    root = os.path.expanduser(root)
    listing = root.rstrip("/") + ".txt"
    if os.path.exists(listing):
        with open(listing) as f:
            all_files = [os.path.join(root, line.strip())
                         for line in f if line.strip()]
    else:
        all_files = walk_image_files(root)
    random.Random(seed).shuffle(all_files)
    return all_files if n is None else all_files[:n]


def load_image(path: str, size: int) -> np.ndarray:
    """One image (PNG or JPEG) -> (size, size, 3) zero-centered float32:
    resize the shorter side to `size` (PIL's ``resize((nw, nh),
    BILINEAR)``), centre crop (reference get_transform,
    get_samples.py:58-65)."""
    img = read_image_rgb(path)
    h, w = img.shape[:2]
    scale = size / min(w, h)
    nw, nh = max(int(round(w * scale)), size), max(
        int(round(h * scale)), size)
    img = np.stack([resize_bilinear(np.ascontiguousarray(img[:, :, c]),
                                    (nh, nw)) for c in range(3)], axis=-1)
    left, top = (nw - size) // 2, (nh - size) // 2
    arr = img[top:top + size, left:left + size].astype(np.float32)
    return arr / 255.0 * 2.0 - 1.0


def get_gt_samples(root: str, size: int, n: int,
                   seed: int = 1) -> np.ndarray:
    """(n, size, size, 3) zc real images (PNG or JPEG files, such as an
    LSUN directory's photos) sampled from root (reference get_gt_samples,
    get_samples.py:86-94)."""
    paths = get_image_paths(root, n, seed=seed)
    return np.stack([load_image(p, size)
                     for p in pbar.pbar(paths, desc="gt samples")])


def gt_sample_batches(root: str, size: int, n: int, batch_size: int = 50,
                      seed: int = 1):
    """Lazy batch iterator over real images (for FID feature streaming
    without holding 50k images in host memory)."""
    paths = get_image_paths(root, n, seed=seed)
    for lo in range(0, len(paths), batch_size):
        yield np.stack([load_image(p, size)
                        for p in paths[lo:lo + batch_size]])


def _random_crops(images: Sequence[np.ndarray], crop_sizes: Sequence[int],
                  rng: random.Random) -> List[np.ndarray]:
    """One random crop per (image, crop size); crops are independent per
    size, like the reference (get_samples.py:67-84)."""
    out: List[List[np.ndarray]] = [[] for _ in crop_sizes]
    for img in images:
        h = img.shape[0]
        for i, cs in enumerate(crop_sizes):
            yi = rng.randint(0, h - cs)
            xi = rng.randint(0, h - cs)
            out[i].append(img[yi:yi + cs, xi:xi + cs])
    return [np.stack(group) for group in out]


def get_cropped_gt_samples(root: str, size: int, n: int,
                           crop_sizes: Sequence[int] = (32,),
                           seed: int = 1) -> List[np.ndarray]:
    """Random fixed-size crops of real images, one list entry per crop
    size (reference get_cropped_gt_samples, get_samples.py:67-84) — the
    ground-truth side of the patch-FID sweep."""
    images = get_gt_samples(root, size, n, seed=seed)
    return _random_crops(list(images), crop_sizes, random.Random(seed))


def get_fake_samples(model, params, n: int, batch_size: int = 10
                     ) -> np.ndarray:
    """(n, H, W, 3) generated zc images under the per-image z-seed
    contract (reference get_samples, get_samples.py:114-129; z seed ==
    imgnum), through ``model(params, z)``, as host float32."""
    import torch

    from .sample import per_image_z
    out = []
    for lo in pbar.pbar(range(0, n, batch_size), desc="fake samples"):
        nums = list(range(lo, min(lo + batch_size, n)))
        zs = per_image_z(model, nums)
        if len(zs) < batch_size:  # keep one compiled shape
            zs = np.concatenate([zs, np.zeros(
                (batch_size - len(zs),) + zs.shape[1:], zs.dtype)])
        with torch.no_grad():
            imgs = model(params, zs)
        out.append(imgs.cpu().numpy()[:len(nums)])
    return np.concatenate(out)[:n]


def get_cropped_fake_samples(model, params, n: int,
                             crop_sizes: Sequence[int] = (32,),
                             batch_size: int = 10,
                             seed: int = 1) -> List[np.ndarray]:
    """Random crops of generated images (reference
    get_cropped_fake_samples, get_samples.py:146-169)."""
    images = get_fake_samples(model, params, n, batch_size=batch_size)
    return _random_crops(list(images), crop_sizes, random.Random(seed))


def gt_stats(root: str, size: int, n: int, batch_size: int = 50,
             feature_fn=None, seed: int = 1):
    """(mu, sigma) FID statistics of real images under root — the
    ground-truth stats the reference computes from its dataset paths
    (get_fid.py:36 via get_samples); the Inception features run on the
    card unless `feature_fn` says otherwise."""
    from . import fid as fid_mod
    if feature_fn is None:
        feature_fn = fid_mod.FeatureExtractor(batch_size=batch_size)
    return fid_mod.compute_feature_stats(
        gt_sample_batches(root, size, n, batch_size, seed=seed), feature_fn)

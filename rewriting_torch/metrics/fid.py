"""Fréchet Inception Distance: feature statistics and the Fréchet
distance.

The port's counterpart of the JAX package's ``metrics/fid.py`` (reference
metrics/fid.py: pool_3 activations :90-131, the Fréchet distance
:137-187, ``mu``/``sigma`` npz statistics).  Features stream batch by
batch into a ``stats.RunningCovariance`` on the device, so a 50k-image
set never holds its activation matrix; the distance is host scipy.  The
npz files are the JAX package's: each package reads the other's.

Command line (reference fid.py:248-282)::

    python3 -m rewriting_torch.metrics.fid A B [--batch_size 50]
        [--inception_weights pt_inception-2015-12-05.pth]

A and B are image directories (PNG and JPEG files; numeric stems in
numeric order) or ``.npz`` statistics; it prints the FID.  The Inception
weights come from ``--inception_weights``, else from
``$REWRITING_TPU_WEIGHTS/pt_inception-2015-12-05.pth``.  Runs on the card.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Iterable, Optional, Tuple

import numpy as np
import scipy.linalg
import torch

from ..native import read_batches
from ..stats.running import RunningCovariance
from ..utils.device import resolve_device
from ..utils.renormalize import renormalize

WEIGHTS_FILENAME = "pt_inception-2015-12-05.pth"


def calculate_frechet_distance(mu1, sigma1, mu2, sigma2,
                               eps: float = 1e-6) -> float:
    """||mu1 - mu2||^2 + Tr(s1 + s2 - 2 sqrt(s1 s2)), in float64 (reference
    fid.py:137-187, with its retry at eps on the diagonal and its check of
    the imaginary part)."""
    mu1, mu2 = np.atleast_1d(np.asarray(mu1)), np.atleast_1d(np.asarray(mu2))
    sigma1 = np.atleast_2d(np.asarray(sigma1, np.float64))
    sigma2 = np.atleast_2d(np.asarray(sigma2, np.float64))
    diff = mu1.astype(np.float64) - mu2.astype(np.float64)

    def _sqrtm(a):
        out = scipy.linalg.sqrtm(a)
        return out[0] if isinstance(out, tuple) else out

    covmean = _sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = _sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            m = np.max(np.abs(covmean.imag))
            raise ValueError(f"Imaginary component {m}")
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


class FeatureExtractor:
    """FID's feature function: InceptionV3's pool3 on `device` (default
    ``cuda``).  Without `params` it reads pytorch-fid's checkpoint from
    ``$REWRITING_TPU_WEIGHTS`` and raises if it is missing: features of
    other weights are not FID's.  ``allow_random=True`` takes seeded weights
    instead, for runs of the pipeline only."""

    def __init__(self, params=None, batch_size: int = 50,
                 allow_random: bool = False, device=None):
        from . import inception
        device = resolve_device(device)
        if params is None:
            from ..models.zoo import load_state, weights_dir
            path = os.path.join(weights_dir(), WEIGHTS_FILENAME)
            if os.path.exists(path):
                params = inception.params_from_torch_state_dict(
                    load_state(path))
            elif allow_random:
                params = inception.init_params(0)
            else:
                raise FileNotFoundError(
                    f"FID Inception weights not found at {path}; place the "
                    "pytorch-fid checkpoint there (or pass allow_random=True "
                    "for a run of the pipeline: its numbers are NOT FID).")
        self.net = inception.InceptionV3Features(params, device=device)
        self.device = device
        self.batch_size = batch_size

    def __call__(self, images) -> np.ndarray:
        return self.device_features(images).cpu().numpy()

    def device_features(self, images) -> torch.Tensor:
        """(B, 2048) features on the device of (B, H, W, 3) images in [-1,
        1] or uint8 (a host batch is moved there first)."""
        with torch.no_grad():
            return self.net(torch.as_tensor(images).to(self.device))


def compute_feature_stats(batches: Iterable, feature_fn: Callable
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """(mu, sigma), float32, of the features of a stream of NHWC image
    batches.  The running covariance stays where the features are: on the
    device for a ``FeatureExtractor``."""
    cov = RunningCovariance()
    dev_fn = getattr(feature_fn, "device_features", feature_fn)
    for batch in batches:
        cov.add(torch.as_tensor(dev_fn(batch), dtype=torch.float32))
    return (cov.mean().cpu().numpy(),
            cov.covariance(unbiased=True).cpu().numpy())


def save_stats(path: str, mu, sigma) -> None:
    """The reference's ``mu``/``sigma`` npz (get_fid.py, fid.py)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, mu=np.asarray(mu), sigma=np.asarray(sigma))


def load_stats(path: str) -> Tuple[np.ndarray, np.ndarray]:
    d = np.load(path)
    return d["mu"], d["sigma"]


def parity_images(seed: int, n: int = 64, size: int = 128) -> np.ndarray:
    """The fixed uint8 image set (n, size, size, 3) of the FID parity check
    against pytorch-fid: seeded coarse noise upsampled 16x plus fine noise,
    quantized (the JAX package's, pixel for pixel)."""
    rng = np.random.RandomState(seed)
    coarse = rng.uniform(0.15, 0.85, (n, size // 16, size // 16, 3))
    imgs = np.kron(coarse, np.ones((1, 16, 16, 1)))
    imgs = imgs + rng.uniform(-0.08, 0.08, imgs.shape)
    return (np.clip(imgs, 0.0, 1.0) * 255.0).round().astype(np.uint8)


def _image_dir_batches(path: str, batch_size: int, as_uint8: bool = False):
    """The images of `path` (``*.png``, ``*.jpg``, ``*.jpeg``, each read by
    its signature: a JPEG decodes to PIL's pixels) in batches, numeric
    stems in numeric order (the samplers' ``{imgnum}.png``) before the
    others; uint8, or zc float32 as the JAX package normalizes them on the
    host."""
    def key(f):
        # isdecimal, not isdigit: int() rejects some Unicode digits
        stem = os.path.splitext(f)[0]
        return (0, int(stem), f) if stem.isdecimal() else (1, 0, f)

    files = sorted((f for f in os.listdir(path)
                    if f.lower().endswith((".png", ".jpg", ".jpeg"))),
                   key=key)
    for batch in read_batches([os.path.join(path, f) for f in files],
                              batch_size):
        if not as_uint8:
            batch = renormalize(batch.astype(np.float32) / 255.0, "pt", "zc")
        yield batch


def compute_fid(a, b, feature_fn: Optional[Callable] = None,
                batch_size: int = 50, device=None) -> float:
    """FID between two sources, each an image directory, an (N, H, W, 3)
    array or tensor in [-1, 1], an iterable of batches, or a statistics
    ``.npz`` (reference fid.py:232-245).  `feature_fn` defaults to a
    ``FeatureExtractor`` on `device`; directories then go to it as uint8,
    normalized on the device."""
    if feature_fn is None:
        feature_fn = FeatureExtractor(batch_size=batch_size, device=device)

    def stats_of(src):
        if isinstance(src, str) and src.endswith(".npz"):
            return load_stats(src)
        if isinstance(src, str):
            return compute_feature_stats(
                _image_dir_batches(src, batch_size, as_uint8=isinstance(
                    feature_fn, FeatureExtractor)), feature_fn)
        if hasattr(src, "shape"):
            return compute_feature_stats(
                (src[i:i + batch_size] for i in range(0, len(src),
                                                      batch_size)),
                feature_fn)
        return compute_feature_stats(src, feature_fn)

    mu1, s1 = stats_of(a)
    mu2, s2 = stats_of(b)
    return calculate_frechet_distance(mu1, s1, mu2, s2)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="FID between two image "
                                 "directories or statistics files")
    ap.add_argument("path_a")
    ap.add_argument("path_b")
    ap.add_argument("--batch_size", type=int, default=50)
    ap.add_argument("--inception_weights", default=None,
                    help="pytorch-fid's or torchvision's InceptionV3 .pth")
    args = ap.parse_args(argv)
    feature_fn = None
    if args.inception_weights:
        from ..models.zoo import load_state
        from .inception import params_from_torch_state_dict
        feature_fn = FeatureExtractor(
            params_from_torch_state_dict(load_state(args.inception_weights)),
            args.batch_size)
    print(compute_fid(args.path_a, args.path_b, feature_fn, args.batch_size))


if __name__ == "__main__":
    main()

"""FID statistics of a generator or an image directory, and the FID
between two statistics files.

The port's counterpart of the JAX package's ``metrics/get_fid.py`` (a
working equivalent of reference metrics/get_fid.py, whose imports are
broken upstream).  Statistics are ``mu``/``sigma`` npz files over 50k
images (reference N, get_fid.py:8).

Command line::

    python3 -m rewriting_torch.metrics.get_fid [--dataset church]
        [--image_dir DIR] [--out stats.npz] [--n 50000]
    python3 -m rewriting_torch.metrics.get_fid --compare A.npz B.npz

The first writes the statistics of the dataset's StyleGAN2 (through
``models/zoo.py``, truncation 0.5, on the card) or of a directory's PNGs;
the second prints the FID between two statistics files.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..utils import pbar
from . import fid as fid_mod
from .sample import per_image_z

N = 50000


def model_stats(model, params, n: int = N, batch_size: int = 50,
                feature_fn=None, offset: int = 0):
    """(mu, sigma) over `n` images of ``model(params, z)``, image i from the
    z of seed i + offset (the samplers' contract); the images stay on the
    model's device.  `feature_fn` defaults to a ``FeatureExtractor`` there."""
    if feature_fn is None:
        feature_fn = fid_mod.FeatureExtractor(batch_size=batch_size,
                                              device=model.device)

    def batches():
        for lo in pbar.pbar(range(0, n, batch_size)):
            nums = [i + offset for i in range(lo, min(lo + batch_size, n))]
            zs = per_image_z(model, nums)
            if len(zs) < batch_size:
                zs = np.concatenate([zs, np.zeros(
                    (batch_size - len(zs),) + zs.shape[1:], zs.dtype)])
            with torch.no_grad():
                yield model(params, zs)[:len(nums)]

    return fid_mod.compute_feature_stats(batches(), feature_fn)


def save_model_stats(path: str, model, params, **kwargs) -> None:
    if os.path.exists(path):
        print(path, "exists")
        return
    mu, sigma = model_stats(model, params, **kwargs)
    fid_mod.save_stats(path, mu, sigma)


def save_dir_stats(path: str, image_dir: str, batch_size: int = 50,
                   feature_fn=None) -> None:
    if os.path.exists(path):
        print(path, "exists")
        return
    if feature_fn is None:
        feature_fn = fid_mod.FeatureExtractor(batch_size=batch_size)
    mu, sigma = fid_mod.compute_feature_stats(
        fid_mod._image_dir_batches(image_dir, batch_size, as_uint8=isinstance(
            feature_fn, fid_mod.FeatureExtractor)), feature_fn)
    fid_mod.save_stats(path, mu, sigma)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="FID statistics")
    ap.add_argument("--dataset", default="church")
    ap.add_argument("--image_dir", default=None,
                    help="compute stats for a directory instead")
    ap.add_argument("--out", default=None)
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--compare", nargs=2, default=None,
                    metavar=("A.npz", "B.npz"))
    args = ap.parse_args(argv)
    if args.compare:
        m1, s1 = fid_mod.load_stats(args.compare[0])
        m2, s2 = fid_mod.load_stats(args.compare[1])
        print(fid_mod.calculate_frechet_distance(m1, s1, m2, s2))
        return
    out = args.out or (f"{args.dataset}_stats.npz" if not args.image_dir
                       else "dir_stats.npz")
    if args.image_dir:
        save_dir_stats(out, args.image_dir)
    else:
        from ..models.zoo import load_seq_stylegan
        model, params = load_seq_stylegan(args.dataset, truncation=0.5)
        save_model_stats(out, model, params, n=args.n)


if __name__ == "__main__":
    main()

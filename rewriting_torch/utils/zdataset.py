"""Deterministic latent sampling.

The port's own copy of the JAX package's ``utils/zdataset.py:16-40``: z
vectors come from ``numpy.random.RandomState(seed).standard_normal(size *
depth)``, so z_i is prefix-stable (independent of how many are drawn) and
identical in both packages.  Saved edit requests name images by number,
so this contract is what keeps them valid.
"""

from __future__ import annotations

import numpy as np


def standard_z_sample(size: int, depth: int, seed: int = 1) -> np.ndarray:
    """(size, depth) float32 standard normal, prefix-stable in `size`."""
    rng = np.random.RandomState(seed)
    return rng.standard_normal(size * depth).reshape(size, depth).astype(
        np.float32)


class ZDataset:
    """A fixed, seeded set of z latents; indexing gives one (depth,)
    vector and ``zs`` the whole (N, depth) array."""

    def __init__(self, zs: np.ndarray):
        self.zs = np.asarray(zs, dtype=np.float32)

    def __len__(self):
        return self.zs.shape[0]

    def __getitem__(self, i) -> np.ndarray:
        return self.zs[i]


def z_dataset_for_model(model, size: int = 100, seed: int = 1) -> ZDataset:
    """Seeded z dataset sized to a model's latent dim."""
    return ZDataset(standard_z_sample(size, model.z_dim, seed))

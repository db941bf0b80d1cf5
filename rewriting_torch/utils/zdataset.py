"""Deterministic latent sampling.

The port's own copy of the JAX package's ``utils/zdataset.py``: z
vectors come from ``numpy.random.RandomState(seed).standard_normal(size *
depth)``, so z_i is prefix-stable (independent of how many are drawn) and
identical in both packages.  Saved edit requests name images by number,
so this contract is what keeps them valid.  The loaders (:71-118) give an
endless stream of seeded training epochs, the fixed test set and a
grouping of a stream into epochs.
"""

from __future__ import annotations

import itertools

import numpy as np


def standard_z_sample(size: int, depth: int, seed: int = 1) -> np.ndarray:
    """(size, depth) float32 standard normal, prefix-stable in `size`."""
    rng = np.random.RandomState(seed)
    return rng.standard_normal(size * depth).reshape(size, depth).astype(
        np.float32)


def standard_y_sample(size: int, num_classes: int, seed: int = 1
                      ) -> np.ndarray:
    """(size,) int64 uniform class labels."""
    rng = np.random.RandomState(seed)
    return rng.randint(num_classes, size=size).astype(np.int64)


class ZDataset:
    """A fixed, seeded set of z latents; indexing gives one (depth,)
    vector and ``zs`` the whole (N, depth) array."""

    def __init__(self, zs: np.ndarray):
        self.zs = np.asarray(zs, dtype=np.float32)

    def __len__(self):
        return self.zs.shape[0]

    def __getitem__(self, i) -> np.ndarray:
        return self.zs[i]

    def batches(self, batch_size: int, pad_to_full: bool = False):
        """Yield (batch, valid_count) in order.  With `pad_to_full` the
        last short batch is zero-padded to `batch_size`, so every batch has
        one shape; valid_count says how many rows are real."""
        for i in range(0, len(self), batch_size):
            b = self.zs[i:i + batch_size]
            valid = b.shape[0]
            if pad_to_full and valid < batch_size:
                b = np.concatenate(
                    [b, np.zeros((batch_size - valid,) + b.shape[1:],
                                 dtype=b.dtype)], axis=0)
            yield b, valid


def z_dataset_for_model(model, size: int = 100, seed: int = 1,
                        indices=None) -> ZDataset:
    """Seeded z dataset sized to a model's latent dim; with `indices`, the
    z of those image numbers (of a draw as long as the largest needs)."""
    depth = model.z_dim
    if indices is not None:
        indices = np.asarray(indices, dtype=np.int64)
        zs = standard_z_sample(int(indices.max()) + 1, depth, seed)[indices]
    else:
        zs = standard_z_sample(size, depth, seed)
    return ZDataset(zs)


def z_sample_for_model(model, size: int = 100, seed: int = 1) -> np.ndarray:
    """(size, z_dim) seeded z of a model."""
    return standard_z_sample(size, model.z_dim, seed)


def training_loader(model, batch_size: int, epoch_size: int = 10000):
    """Endless (B, z_dim) batches: epoch e (from 1) is the z set of seed
    e + 1, its last batch short."""
    epoch = 1
    while True:
        zds = z_dataset_for_model(model, size=epoch_size, seed=epoch + 1)
        for batch, valid in zds.batches(batch_size):
            yield batch[:valid]
        epoch += 1


def testing_loader(model, batch_size: int, test_size: int = 1000):
    """The (B, z_dim) batches of the fixed seed-1 test set."""
    zds = z_dataset_for_model(model, size=test_size, seed=1)
    return (batch[:valid] for batch, valid in zds.batches(batch_size))


def epoch_grouper(loader, epoch_size: int):
    """Group a stream of batches into epochs of `epoch_size` batches, each
    an iterator; ends when the stream does."""
    it = iter(loader)
    while True:
        chunk = itertools.islice(it, epoch_size)
        try:
            first = next(chunk)
        except StopIteration:
            return
        yield itertools.chain((first,), chunk)

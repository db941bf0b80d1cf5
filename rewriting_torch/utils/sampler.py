"""Deterministic dataset samplers and resolution-independent coordinate
sampling.

The port's copy of the JAX package's ``utils/sampler.py`` (reference
utils/sampler.py) with its determinism contracts: the published per-seed
index sequences are part of the fixture compatibility surface.

The RNG-touching algorithm bodies -- the ``random.Random(seed)`` shuffle
in :class:`FixedRandomSubsetSampler` and every line of
:func:`coordinate_sample` (``RandomState(s)``, the ``rng.choice`` square
draw, the grid-jitter formula, and their call order) -- follow reference
sampler.py:48-107 line for line.  Any reordering or API substitution
changes the drawn index vectors and breaks compatibility with the
reference's per-seed samples.  ``subsample_folder`` reads any image file
the JAX package reads (``native.read_image``)."""

from __future__ import annotations

import random

import numpy


class FixedSubsetSampler:
    """A fixed explicit sequence of dataset indices
    (reference sampler.py:20-46)."""

    def __init__(self, samples):
        self.samples = list(samples)

    def __iter__(self):
        return iter(self.samples)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, key):
        return self.samples[key]

    def dereference(self, indices):
        """Output indices -> original dataset indices."""
        return [self.samples[i] for i in indices]

    def subset(self, new_subset):
        return FixedSubsetSampler(self.dereference(new_subset))


class FixedRandomSubsetSampler(FixedSubsetSampler):
    """Seeded shuffle of range(len(data_source))[start:end] — always the
    same sequence (reference sampler.py:48-78, seeded random.Random)."""

    def __init__(self, data_source, start=None, end=None, seed=1):
        rng = random.Random(seed)
        shuffled = list(range(len(data_source)))
        rng.shuffle(shuffled)
        self.data_source = data_source
        super().__init__(shuffled[start:end])

    def class_subset(self, class_filter):
        if isinstance(class_filter, int):
            def rule(d):
                return d[1] == class_filter
        else:
            rule = class_filter
        return self.subset([i for i, j in enumerate(self.samples)
                            if rule(self.data_source[j])])


def coordinate_sample(shape, sample_size, seeds, grid=13, seed=1,
                      flat=False):
    """Sample grid-jittered coordinates of a feature map, deterministically
    per seed and *resolution-independent*: the same (seed, grid) picks the
    same relative locations at any shape (reference sampler.py:81-107).
    Returns (len(seeds), 2, sample_size) or flat raveled indices."""
    assert sample_size <= grid
    if flat:
        sampind = numpy.zeros((len(seeds), sample_size), dtype=int)
    else:
        sampind = numpy.zeros((len(seeds), 2, sample_size), dtype=int)
    for j, s in enumerate(seeds):
        rng = numpy.random.RandomState(s)
        square_count = grid ** len(shape)
        square = numpy.stack(numpy.unravel_index(
            rng.choice(square_count, square_count)[:sample_size],
            (grid,) * len(shape)))
        uniform = (square + rng.uniform(size=square.shape)) / grid
        coords = (uniform * numpy.array(shape)[:, None]).astype(int)
        if flat:
            sampind[j] = numpy.ravel_multi_index(coords, dims=shape)
        else:
            sampind[j] = coords
    return sampind


def subsample_folder(indir: str, outdir: str, size: int = 100,
                     seed: int = 1):
    """Copy a seeded random subset of the images under indir into a flat
    outdir, deduplicating basenames with _N suffixes (the reference's
    ``python -m utils.sampler indir outdir --size N`` utility,
    sampler.py:109-147).  Returns the copied filenames."""
    import itertools
    import os
    import shutil
    from .parallelfolder import ParallelImageFolders

    if os.path.exists(outdir):
        raise FileExistsError(f"{outdir} already exists")
    os.makedirs(outdir)
    dataset = ParallelImageFolders([indir])
    sampler = FixedRandomSubsetSampler(dataset, end=size, seed=seed)

    def unique_name(source, taken):
        stem, ext = os.path.splitext(os.path.basename(source))
        candidates = itertools.chain(
            [stem + ext], (f"{stem}_{n}{ext}" for n in itertools.count(1)))
        return next(c for c in candidates if c not in taken)

    taken, copied = set(), []
    for i in sampler.dereference(range(min(size, len(sampler)))):
        sourcefile = dataset.images[i][0]
        filename = unique_name(sourcefile, taken)
        taken.add(filename)
        shutil.copy(sourcefile, os.path.join(outdir, filename))
        copied.append(filename)
    return copied


def main():  # pragma: no cover - CLI (reference sampler.py:109-147)
    import argparse
    parser = argparse.ArgumentParser(
        description="copy a seeded random subset of an image folder",
        prog=f"python -m {__package__}.sampler")
    parser.add_argument("indir")
    parser.add_argument("outdir")
    parser.add_argument("--size", type=int, default=100)
    parser.add_argument("--seed", type=int, default=1)
    args = parser.parse_args()
    copied = subsample_folder(args.indir, args.outdir, args.size, args.seed)
    print(f"copied {len(copied)} images to {args.outdir}")


if __name__ == "__main__":  # pragma: no cover
    main()

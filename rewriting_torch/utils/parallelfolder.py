"""Parallel image-folder dataset: walks several directory trees that hold
corresponding files (image / segmentation / ...) and serves them as
tuples, keyed and verified by matching relative path stems.

The port's counterpart of the JAX package's ``utils/parallelfolder.py``
(a rebuild of the netdissect ``parallelfolder`` module the reference
imports, reference utils/segdata.py:2, utils/sampler.py:110): ``len()``,
index -> tuple of loaded images, and an ``.images`` list of path tuples.
An image is an array as ``numpy.asarray`` of the JAX package's PIL image
gives it: (H, W) for greyscale or palette indices, (H, W, C) otherwise.
Files are read by ``native.read_image``: 8-bit PNG and Huffman JPEG by the
port's own decoders, every other kind (WebP, BMP, GIF among the
extensions listed) by PIL, as in the JAX package.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence, Tuple, Union

from ..native import read_image

IMAGE_EXTENSIONS = (".png", ".webp", ".jpg", ".jpeg", ".bmp", ".gif")


def walk_image_files(root: str):
    """Sorted image paths under root (the single tree-walker shared with
    metrics/samples.py so one extension list governs both).  Lists every
    extension of ``IMAGE_EXTENSIONS``, which ``native.read_image`` reads."""
    root = os.path.expanduser(root)
    out = []
    for dirpath, _dirnames, filenames in sorted(os.walk(root)):
        for fn in sorted(filenames):
            if fn.lower().endswith(IMAGE_EXTENSIONS):
                out.append(os.path.join(dirpath, fn))
    return out


def _walk_images(root: str) -> dict:
    """{relative stem: full path} for every image under root.  Two files
    differing only by extension would shadow each other in the stem key
    space: that is an error, not a quiet drop."""
    out = {}
    root = os.path.expanduser(root)
    for path in walk_image_files(root):
        rel = os.path.relpath(os.path.splitext(path)[0], root)
        if rel in out:
            raise ValueError(
                f"ambiguous stem {rel!r} under {root}: "
                f"{out[rel]} vs {path}")
        out[rel] = path
    return out


class ParallelImageFolders:
    """Dataset over N folders of stem-matched images.

    transform: a callable applied to every loaded image array, or one
    callable per folder (None entries pass the array through)."""

    def __init__(self, image_roots: Sequence[str],
                 transform: Union[Callable, Sequence[Optional[Callable]],
                                  None] = None):
        if isinstance(image_roots, str):
            image_roots = [image_roots]
        maps = [_walk_images(root) for root in image_roots]
        stems = sorted(set.intersection(*(set(m) for m in maps)))
        for root, m in zip(image_roots, maps):
            extra = set(m) - set(stems)
            if extra:
                raise ValueError(
                    f"unmatched files under {root}: {sorted(extra)[:5]}")
        if not stems:
            raise ValueError(f"no images found under {list(image_roots)}")
        self.images: List[Tuple[str, ...]] = [
            tuple(m[stem] for m in maps) for stem in stems]
        if transform is not None and not isinstance(transform, (list, tuple)):
            transform = [transform] * len(image_roots)
        self.transforms = transform

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, index: int):
        loaded = []
        for i, path in enumerate(self.images[index]):
            im = read_image(path)
            if self.transforms is not None and self.transforms[i] is not None:
                im = self.transforms[i](im)
            loaded.append(im)
        return tuple(loaded)

"""The smile count: how many of a directory's sampled faces smile.

The port's counterpart of the JAX package's ``metrics/num_smiles.py``
(reference metrics/num_smiles.py, which depends on the external,
unvendored pytorch_slim_cnn SlimNet).  The classifier is any
``fn(images) -> (B,)`` of bools or 0/1, given (B, H, W, 3) float32 images
in [-1, 1] as a host array.  Without one: SlimNet on
``$REWRITING_TPU_WEIGHTS/celeba_20.pth`` where that file is (the
reference's criterion, 'Smiling' sigmoid > 0.5), else the face parser's
mouth heuristic (the inner-mouth class visible), which tracks open-mouth
smiles.

Command line::

    python3 -m rewriting_torch.metrics.num_smiles DIR [--n 10000]

counts ``DIR/0.png`` .. ``DIR/{n-1}.png`` on the card and prints the
count.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Optional

import numpy as np
import torch

from ..native import read_batches
from ..utils import pbar
from ..utils.renormalize import renormalize


def count_smiles(image_dir: str, n: int = 10000, batch_size: int = 16,
                 classifier: Optional[Callable] = None) -> int:
    """The number of ``{i}.png``, i < n, that `classifier` calls smiling,
    read in batches of `batch_size` (the last holds the remainder)."""
    if classifier is None:
        classifier = default_classifier()
    paths = [os.path.join(image_dir, f"{i}.png") for i in range(n)]
    total = 0
    for batch in pbar.pbar(read_batches(paths, batch_size),
                           total=-(-n // batch_size)):
        zc = renormalize(batch.astype(np.float32) / 255.0, "pt", "zc")
        total += int(torch.as_tensor(classifier(zc)).sum())
    return total


def default_classifier(device=None):
    """SlimNet on its checkpoint where the file is, else the mouth
    heuristic; on `device` (default ``cuda``)."""
    from ..models.zoo import weights_dir
    from .slimnet import WEIGHTS_FILENAME, slimnet_classifier
    path = os.path.join(weights_dir(), WEIGHTS_FILENAME)
    if os.path.isfile(path):
        return slimnet_classifier(path, device=device)
    return mouth_heuristic_classifier(device=device)


def mouth_heuristic_classifier(params=None, device=None):
    """The face parser's fallback: a face smiles when its 'mouth' (inner
    mouth) class covers more than 0.1% of the image.  `params` stand in for
    the released face parser's (``FaceSegmenter``'s default); on `device`
    (default ``cuda``).  Returns (B,) bools on the device."""
    from ..segment.faceparse import FACE_CLASSES, FaceSegmenter
    seg = FaceSegmenter(params=params, device=device)
    mouth = FACE_CLASSES.index("mouth")

    def classify(images):
        labels = seg.segment_batch(images)[:, 0]
        frac = (labels == mouth).float().mean(dim=(1, 2))
        return frac > 0.001
    return classify


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Count smiling faces")
    ap.add_argument("image_dir")
    ap.add_argument("--n", type=int, default=10000)
    args = ap.parse_args(argv)
    print(count_smiles(args.image_dir, n=args.n))


if __name__ == "__main__":
    main()

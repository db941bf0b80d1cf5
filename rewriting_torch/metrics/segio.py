"""Per-image segmentation files, shared by the effectiveness and damage
metrics.

The port's counterpart of the JAX package's ``metrics/segio.py``: a
segmentation is ``{base}.npz`` (its ``seg`` array, the format the
segmentation statistics write) or the reference's ``{base}.pth``
(one tensor), read with ``torch.load(weights_only=True)``.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def load_seg(path_base: str) -> np.ndarray:
    """The segmentation saved at `path_base` (``.npz`` first, then
    ``.pth``)."""
    if os.path.exists(path_base + ".npz"):
        with np.load(path_base + ".npz", allow_pickle=False) as f:
            return f["seg"]
    if os.path.exists(path_base + ".pth"):
        return torch.load(path_base + ".pth", map_location="cpu",
                          weights_only=True).numpy()
    raise FileNotFoundError(path_base + ".{npz,pth}")

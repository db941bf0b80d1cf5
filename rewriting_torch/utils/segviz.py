"""Segmentation visualization: label maps -> high-contrast colour images.

The port's counterpart of the JAX package's ``utils/segviz.py``
(reference utils/segviz.py segment_visualization).  Images are uint8
arrays; ``swatch_image`` returns one where the JAX package returns a PIL
image.
"""

from __future__ import annotations

import numpy as np

from .upsample import resize_bilinear


def _golden_palette(n: int) -> np.ndarray:
    """Deterministic high-contrast palette: golden-ratio hue walk."""
    hues = (np.arange(n) * 0.61803398875) % 1.0
    sat = np.where(np.arange(n) % 2 == 0, 0.85, 0.6)
    val = np.where(np.arange(n) % 3 == 0, 0.95, 0.75)
    h6 = hues * 6.0
    c = val * sat
    x = c * (1 - np.abs(h6 % 2 - 1))
    m = val - c
    rgb = np.zeros((n, 3))
    for i in range(n):
        k = int(h6[i]) % 6
        rgb[i] = [(c[i], x[i], 0), (x[i], c[i], 0), (0, c[i], x[i]),
                  (0, x[i], c[i]), (x[i], 0, c[i]), (c[i], 0, x[i])][k]
    rgb += m[:, None]
    rgb[0] = 0.0  # label 0 = background = black
    return (rgb * 255).astype(np.uint8)


_PALETTE = _golden_palette(2048)


def segment_visualization(seg, size=None) -> np.ndarray:
    """(H, W) int label map -> (size) RGB uint8 visualization
    (reference segviz.py:28); a multilabel (M, H, W) map shows the first
    nonzero layer."""
    seg = np.asarray(seg)
    if seg.ndim == 3:
        first = seg[0].copy()
        for layer in seg[1:]:
            first = np.where(first == 0, layer, first)
        seg = first
    rgb = _PALETTE[seg % len(_PALETTE)]
    if size is not None:
        rgb = resize_bilinear(rgb.astype(np.float32), size)
        rgb = np.clip(rgb, 0, 255).astype(np.uint8)
    return rgb


def high_contrast_palette():
    return _PALETTE.copy()


def swatch_image(label: int, size: int = 15) -> np.ndarray:
    """A (size, size, 3) uint8 solid-colour swatch for a label: the legend
    cell (reference segviz.py:12-14)."""
    color = _PALETTE[label % len(_PALETTE)]
    return np.broadcast_to(color, (size, size, 3)).copy()


def segment_key(seg, segmodel, max_labels: int = 6):
    """Legend for a label map: up to max_labels (swatch, label-name) pairs
    ordered by descending pixel count, dropping zero-count labels
    (reference segviz.py:17-27).  `segmodel` is any segmenter exposing
    get_label_and_category_names()."""
    seglabels, _ = segmodel.get_label_and_category_names()
    bc = np.bincount(np.asarray(seg).reshape(-1))
    result = []
    for ind in np.argsort(bc)[::-1]:
        if len(result) >= max_labels or bc[ind] == 0:
            break
        name = seglabels[ind]
        if not isinstance(name, str):  # (name, category) tuples
            name = name[0]
        result.append((swatch_image(int(ind)), name))
    return result

"""Image visualization: heatmaps, masked overlays, top-k grids.

The port's counterpart of the JAX package's ``utils/imgviz.py``
(reference utils/imgviz.py): activation heatmaps over generated images,
mask overlays with dimmed surroundings and colored borders, and grids of
top-activating images for a unit.  Host-side numpy; arrays are NHWC (or
HWC).  Without PIL, every image it returns is a ``uint8 (H, W, 3)`` numpy
array where the JAX package returns a PIL image, with the same pixels."""

from __future__ import annotations

import numpy as np

from . import renormalize
from .upsample import resize_bilinear


# simple "hot"-style colormap (black -> red -> yellow -> white)
def _hot_colormap(x):
    x = np.clip(x, 0.0, 1.0)
    r = np.clip(3 * x, 0, 1)
    g = np.clip(3 * x - 1, 0, 1)
    b = np.clip(3 * x - 2, 0, 1)
    return np.stack([r, g, b], axis=-1)


def border_from_mask(mask: np.ndarray, thickness: int = 1,
                     outside: bool = True) -> np.ndarray:
    """Boolean border ring of a boolean mask (reference imgviz.py:309+)."""
    m = np.asarray(mask) > 0
    grown = m.copy()
    for _ in range(thickness):
        g = grown
        grown = (g | np.roll(g, 1, 0) | np.roll(g, -1, 0)
                 | np.roll(g, 1, 1) | np.roll(g, -1, 1))
    shrunk = m.copy()
    for _ in range(thickness):
        s = shrunk
        shrunk = (s & np.roll(s, 1, 0) & np.roll(s, -1, 0)
                  & np.roll(s, 1, 1) & np.roll(s, -1, 1))
    return (grown & ~m) if outside else (m & ~shrunk)


class ImageVisualizer:
    def __init__(self, size, image_size=None, data_size=None,
                 quantiles=None, level=None, percent_level=None):
        if isinstance(size, int):
            size = (size, size)
        self.size = tuple(size)
        self.image_size = image_size
        self.data_size = data_size
        self.quantiles = quantiles
        self.default_level = level
        self.percent_level = percent_level

    # -- scalar helpers -------------------------------------------------------
    def range_for(self, activations, unit=None):
        a = self._unit_acts(activations, unit)
        return float(a.min()), float(a.max())

    def level_for(self, activations, unit=None, percent_level=None):
        """Threshold level: the dataset-level per-unit quantile when a
        quantile sketch is attached, else the sample's own quantile
        (reference imgviz.py:211-227)."""
        if percent_level is None:
            percent_level = self.percent_level
        if percent_level is None:
            percent_level = 0.95
        if self.quantiles is not None and unit is not None:
            return float(np.asarray(
                self.quantiles.quantiles([percent_level]))[unit, 0])
        a = self._unit_acts(activations, unit)
        return float(np.quantile(a, percent_level))

    def _unit_acts(self, activations, unit):
        a = np.asarray(activations, np.float32)
        if unit is not None:
            a = a[..., unit] if a.shape[-1] > 4 else a[unit]
        return np.squeeze(a)

    # -- renderers -------------------------------------------------------------
    def image(self, imagedata):
        """(H,W,C) zc image -> uint8 image at self.size."""
        img = np.asarray(imagedata, np.float32)
        if img.ndim == 4:
            img = img[0]
        img = resize_bilinear(img, self.size)
        return renormalize.as_image(img)

    def heatmap(self, activations, unit=None, mode="bilinear"):
        """Per-unit activation heatmap -> uint8 image (reference
        imgviz.py:56-74)."""
        a = self._unit_acts(activations, unit)
        lo, hi = a.min(), a.max()
        norm = (a - lo) / (hi - lo + 1e-12)
        if mode == "nearest":
            reps = (self.size[0] // a.shape[0], self.size[1] // a.shape[1])
            norm = np.kron(norm, np.ones(reps))
            norm = norm[:self.size[0], :self.size[1]]
        else:
            norm = resize_bilinear(norm, self.size)
        return (_hot_colormap(norm) * 255).astype(np.uint8)

    def mask_for(self, activations, unit=None, level=None,
                 percent_level=None):
        if level is None:
            level = (self.default_level if self.default_level is not None
                     else self.level_for(activations, unit, percent_level))
        a = self._unit_acts(activations, unit)
        up = resize_bilinear(a, self.size)
        return up > level

    def masked_image(self, imagedata, activations=None, unit=None,
                     level=None, percent_level=None, mask=None,
                     border_color=(255, 255, 0), thickness=2,
                     outside_bright=0.25):
        """Dim the image outside the mask and draw a border around it
        (reference imgviz.py:83-123)."""
        img = np.asarray(imagedata, np.float32)
        if img.ndim == 4:
            img = img[0]
        img = resize_bilinear(img, self.size)
        byte = renormalize.renormalize(img, "zc", "byte").astype(np.float32)
        if mask is None:
            assert activations is not None
            mask = self.mask_for(activations, unit, level, percent_level)
        else:
            mask = resize_bilinear(np.asarray(mask, np.float32),
                                   self.size) > 0.5
        out = byte * (outside_bright + (1 - outside_bright)
                      * mask[:, :, None])
        border = border_from_mask(mask, thickness=thickness)
        out[border] = np.asarray(border_color, np.float32)
        return np.clip(out, 0, 255).astype(np.uint8)

    def masked_delta(self, imagedata, delta, unit=None, **kwargs):
        """Overlay where |delta| is large (reference imgviz.py:124-158)."""
        d = self._unit_acts(np.abs(np.asarray(delta)).sum(-1)
                            if np.asarray(delta).ndim == 3
                            else np.abs(delta), unit)
        return self.masked_image(imagedata, activations=d, **kwargs)

    # -- grids ------------------------------------------------------------------
    def masked_images_for_topk(self, images, acts, topk_indices, unit,
                               k=None, **kwargs):
        """Row of masked top-k images for one unit. `images`/`acts` are
        indexable by sample id (reference imgviz.py:237-295)."""
        idxs = list(np.asarray(topk_indices)[:k])
        return [self.masked_image(images[i], acts[i], unit=unit, **kwargs)
                for i in idxs]

    def image_row(self, images, gap=5, bg=255):
        """Concatenate uint8 images horizontally, top-aligned, with gaps."""
        h = max(im.shape[0] for im in images)
        w = sum(im.shape[1] for im in images) + gap * (len(images) - 1)
        row = np.full((h, w, 3), bg, np.uint8)
        x = 0
        for im in images:
            row[:im.shape[0], x:x + im.shape[1]] = im
            x += im.shape[1] + gap
        return row


def strip_image_from_grid_row(row, gap=5, bg=255):
    """Split a row image back into cells (reference imgviz.py:297-307)."""
    arr = np.asarray(row)
    run = np.flatnonzero((arr != bg).any(axis=(0, 2)))
    if len(run) == 0:
        return []
    splits = np.split(run, np.where(np.diff(run) > 1)[0] + 1)
    return [arr[:, seg[0]:seg[-1] + 1] for seg in splits]

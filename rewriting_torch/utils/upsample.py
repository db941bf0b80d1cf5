"""Bilinear resize of feature maps onto image pixels, with
receptive-field-aligned coordinates.

The port's own copy of the JAX package's ``utils/upsample.py`` (reference
utils/upsample.py): the (scale, offset) that a stack of convolutions maps
output-grid coordinates by (``convconfig_scale_offset``), the output size
of such a stack, a half-pixel aligned, edge-clamped ``resize_bilinear``
of numpy data, ``upsampler`` and the sizing-transform crawl
(``find_sizer``, ``image_size_from_source``).

``upsampler``'s function also takes a tensor ``(B, H, W[, C])`` and
resizes it where it lies, by the same coordinates and edge clamp (a
gather and a lerp in torch, in float32): dissection upsamples every
batch of activations on the device.  ``utils/imgviz`` resizes heatmaps
and masks with ``resize_bilinear``; ``utils/renormalize.resize_bilinear``
is another function, PIL's bilinear resize of images.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def convconfig_scale_offset(convconfigs):
    """Compose (kernel, stride, padding) stages into the affine map from
    output-grid coordinates to input coordinates: x_in = scale * x_out +
    offset."""
    scale, offset = 1.0, 0.0
    for k, s, p in reversed(convconfigs):
        offset = offset * s + (k - 1) / 2.0 - p
        scale = scale * s
    return scale, offset


def sequence_scale_offset(convconfigs):
    """The reference's name for :func:`convconfig_scale_offset` (on
    explicit configs rather than modules)."""
    return convconfig_scale_offset(convconfigs)


def convconfig_data_size(convconfigs, data_size):
    """Output spatial size of the conv stack applied to `data_size`."""
    size = np.asarray(data_size, float)
    for k, s, p in convconfigs:
        size = np.floor((size + 2 * p - k) / s) + 1
    return tuple(int(v) for v in size)


def _axis_coords(target_n, data_n):
    # proportional stretch with half-pixel alignment
    scale = target_n / data_n
    offset = scale / 2.0 - 0.5
    return (np.arange(target_n) - offset) / scale


def _taps(data_hw, target_shape, scale_offset):
    """Per axis: (index below, index above, weight of the one above) of
    each target pixel's source coordinate, clamped to the data."""
    (h, w), (th, tw) = data_hw, target_shape
    if scale_offset is None:
        ys = _axis_coords(th, h)
        xs = _axis_coords(tw, w)
    else:
        (sy, oy), (sx, ox) = scale_offset
        ys = (np.arange(th) - oy) / sy
        xs = (np.arange(tw) - ox) / sx
    out = []
    for coords, n in ((ys, h), (xs, w)):
        coords = np.clip(coords, 0, n - 1)
        i0 = np.floor(coords).astype(int)
        out.append((i0, np.minimum(i0 + 1, n - 1), coords - i0))
    return out


def resize_bilinear(data: np.ndarray, target_shape: Tuple[int, int],
                    scale_offset=None) -> np.ndarray:
    """Bilinear resize of (H, W) or (H, W, C) data to target_shape, with
    optional per-axis (scale, offset) mapping from data grid to target
    pixels (edge-clamped)."""
    data = np.asarray(data, np.float32)
    (y0, y1, wy), (x0, x1, wx) = _taps(data.shape[:2], target_shape,
                                       scale_offset)
    wy = wy[:, None]
    wx = wx[None, :]
    if data.ndim == 3:
        wy = wy[..., None]
        wx = wx[..., None]
    a = data[y0][:, x0]
    b = data[y0][:, x1]
    c = data[y1][:, x0]
    d = data[y1][:, x1]
    return (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
            + c * wy * (1 - wx) + d * wy * wx)


def resize_bilinear_batch(data: torch.Tensor, target_shape,
                          scale_offset=None) -> torch.Tensor:
    """:func:`resize_bilinear` of each of a batch (B, H, W[, C]) of
    tensors, on their device, in float32."""
    data = data.to(torch.float32)
    (y0, y1, wy), (x0, x1, wx) = (
        tuple(torch.as_tensor(v, device=data.device) for v in t)
        for t in _taps(tuple(data.shape[1:3]), target_shape, scale_offset))
    trail = (1,) * (data.dim() - 3)
    wy = wy.to(torch.float32).reshape((-1, 1) + trail)
    wx = wx.to(torch.float32).reshape((1, -1) + trail)
    top, bottom = data[:, y0], data[:, y1]
    a, b = top[:, :, x0], top[:, :, x1]
    c, d = bottom[:, :, x0], bottom[:, :, x1]
    return (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
            + c * wy * (1 - wx) + d * wy * wx)


def upsampler(target_shape, data_shape=None, image_size=None,
              scale_offset=None):
    """fn(data) that upsamples (H, W[, C]) or (B, H, W[, C]) data to
    target_shape, aligned by the receptive field when `scale_offset`
    (from :func:`sequence_scale_offset`) is given.  numpy data gives a
    numpy array (one image at a time); a tensor (B, H, W[, C]) a tensor
    on its device."""
    so = None
    if scale_offset is not None:
        s, o = scale_offset
        if image_size is not None:
            # feature grid -> image grid -> target pixels
            sy = target_shape[0] / image_size[0]
            sx = target_shape[1] / image_size[1]
            so = ((s * sy, o * sy), (s * sx, o * sx))
        else:
            so = ((s, o), (s, o))    # the target is image space

    def up(data):
        if isinstance(data, torch.Tensor):
            return resize_bilinear_batch(data, tuple(target_shape), so)
        data = np.asarray(data)
        if data.ndim >= 3 and data_shape is not None \
                and data.shape[:2] != tuple(data_shape):
            return np.stack([up(d) for d in data])      # batched
        if data.ndim == 4 or (data.ndim == 3 and data_shape is not None
                              and data.shape[0] != data_shape[0]):
            return np.stack([up(d) for d in data])
        return resize_bilinear(data, tuple(target_shape), so)
    return up


# class names of the reference's sizing transforms (torchvision's Resize,
# RandomCrop, RandomResizedCrop, CenterCrop), matched by name so any
# transform of the same role works
_SIZER_TYPENAMES = ("Resize", "RandomCrop", "RandomResizedCrop",
                    "CenterCrop")


def find_sizer(source):
    """The last crop/resize transform attached to a dataset: `source`
    itself, else its ``.transform``, else each of its ``.transforms`` from
    the last."""
    if source is None:
        return None
    if type(source).__name__ in _SIZER_TYPENAMES and hasattr(source, "size"):
        return source
    t = getattr(source, "transform", None)
    if t is not None:
        return find_sizer(t)
    ts = getattr(source, "transforms", None)
    if ts is not None:
        for t in reversed(list(ts)):
            result = find_sizer(t)
            if result is not None:
                return result
    return None


def image_size_from_source(source):
    """(H, W) a dataset or model produces: its last sizing transform's
    size, else its ``resolution``, else its ``image_size``."""
    sizer = find_sizer(source)
    if sizer is not None:
        size = sizer.size
    elif hasattr(source, "resolution"):
        size = source.resolution
    elif hasattr(source, "image_size"):
        size = source.image_size
    else:
        raise ValueError(
            f"cannot infer image size from {type(source).__name__!r}: no "
            "sizing transform, resolution, or image_size attribute")
    if hasattr(size, "__len__"):
        return tuple(size)
    return (size, size)

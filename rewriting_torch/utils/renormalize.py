"""Painted masks from base64 PNG data URLs, PNG writing, and image
normalisations, without PIL.

The port's own counterpart of the JAX package's ``utils/renormalize.py``:
``renormalize`` (:41-49) and ``mask_from_url`` (:72-99), which decodes with
PIL, converts to RGB, resizes with ``Image.BILINEAR`` and reads channel 0
over 255.  PIL is not a dependency of the port, so this module carries:

- a PNG decoder (zlib + numpy): 8-bit greyscale, greyscale+alpha, RGB and
  RGBA, non-interlaced, filter types 0-4;
- its counterpart, a PNG encoder (zlib + numpy) of 8-bit images with the
  "up" row filter, as the JAX package's native encoder writes them
  (``native/pngenc.cpp``);
- the RGB conversion of PIL's ``convert("RGB")``: alpha is dropped, grey is
  copied to every channel, so channel 0 is the first sample of a pixel;
- PIL's BILINEAR resize of 8-bit data: a triangle filter whose support
  grows with the reduction factor, coefficients normalized and rounded to
  22-bit fixed point, a horizontal pass then a vertical pass, each rounded
  back to 8 bits (Pillow's ``libImaging/Resample.c``).
"""

from __future__ import annotations

import base64
import functools
import math
import re
import struct
import zlib
from typing import Optional, Tuple

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel (8-bit, no palette)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_PRECISION_BITS = 32 - 8 - 2

# name -> (offset, scale) per channel: value = (x - offset) / scale; the
# generator's zero-centred output and 8-bit pixels (the JAX package has
# more, which no code of the port reads)
OFFSET_SCALE = {
    "zc": ([0.5, 0.5, 0.5], [0.5, 0.5, 0.5]),
    "byte": ([0.0, 0.0, 0.0], [1 / 255.0, 1 / 255.0, 1 / 255.0]),
}


def renormalize(data, source: str = "zc", target: str = "zc") -> np.ndarray:
    """Convert an (..., H, W, 3) array between normalisations; "byte" is
    uint8 in [0, 255], cut by truncation."""
    so, ss = (np.array(v, np.float32) for v in OFFSET_SCALE[source])
    to, ts = (np.array(v, np.float32) for v in OFFSET_SCALE[target])
    out = np.asarray(data, np.float32) * (ss / ts) + (so - to) / ts
    if target == "byte":
        out = np.clip(out, 0, 255).astype(np.uint8)
    return out


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))


def encode_png(img: np.ndarray, level: int = 2) -> bytes:
    """PNG bytes of an (H, W) or (H, W, 1|2|3|4) uint8 array: greyscale,
    greyscale+alpha, RGB or RGBA; rows after the first "up"-filtered."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"encode_png takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, ch = img.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}.get(ch)
    if ctype is None or h < 1 or w < 1:
        raise ValueError(f"encode_png: cannot write shape {img.shape}")
    rows = img.reshape(h, w * ch)
    raw = np.empty((h, 1 + w * ch), np.uint8)
    raw[0, 0] = 0
    raw[0, 1:] = rows[0]
    raw[1:, 0] = 2
    raw[1:, 1:] = rows[1:] - rows[:-1]          # wraps mod 256
    header = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    return (_PNG_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter_row(ftype: int, line: np.ndarray, prev: np.ndarray,
                  bpp: int) -> np.ndarray:
    if ftype == 0:
        return line
    if ftype == 1:  # Sub: cumulative sum along each sample of a pixel
        return (np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1)
                & 0xFF).astype(np.int64)
    if ftype == 2:  # Up
        return (line + prev) & 0xFF
    if ftype not in (3, 4):
        raise ValueError(f"bad PNG filter type {ftype}")
    cur = [int(v) for v in line]
    up = [int(v) for v in prev]
    for x in range(len(cur)):
        left = cur[x - bpp] if x >= bpp else 0
        if ftype == 3:  # Average
            pred = (left + up[x]) >> 1
        else:  # Paeth
            pred = _paeth(left, up[x], up[x - bpp] if x >= bpp else 0)
        cur[x] = (cur[x] + pred) & 0xFF
    return np.asarray(cur, np.int64)


def decode_png(data: bytes) -> np.ndarray:
    """(H, W, samples) uint8 array of an 8-bit, non-interlaced, non-palette
    PNG."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError("PNG has no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type "
                         f"{color}, interlace {interlace}")
    bpp = _CHANNELS[color]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (stride + 1):
        raise ValueError("truncated PNG image data")
    rows = raw[:h * (stride + 1)].reshape(h, stride + 1).astype(np.int64)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        prev = _unfilter_row(int(rows[y, 0]), rows[y, 1:], prev, bpp)
        out[y] = prev
    return out.reshape(h, w, bpp)


def _bilinear(x: float) -> float:
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


@functools.lru_cache(maxsize=64)
def _resample_coeffs(in_size: int, out_size: int):
    """Pillow's precompute_coeffs + normalize_coeffs_8bpc for the bilinear
    filter: per output sample, (first input index, fixed-point taps)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    coeffs = []
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [_bilinear((x + xmin - center + 0.5) / filterscale)
             for x in range(xmax)]
        ww = 0.0
        for v in k:
            ww += v
        if ww != 0.0:
            k = [v / ww for v in k]
        fixed = [int((0.5 if v >= 0 else -0.5) + v * (1 << _PRECISION_BITS))
                 for v in k]
        coeffs.append((xmin, np.asarray(fixed, np.int64)))
    return coeffs


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One 8-bit bilinear pass of Pillow's resize along `axis` of a 2-d
    uint8 array."""
    img = np.moveaxis(img, axis, 1).astype(np.int64)
    out = np.empty((img.shape[0], out_size), np.uint8)
    for xx, (xmin, k) in enumerate(_resample_coeffs(img.shape[1], out_size)):
        ss = (1 << (_PRECISION_BITS - 1)) + img[:, xmin:xmin + len(k)] @ k
        out[:, xx] = np.clip(ss >> _PRECISION_BITS, 0, 255)
    return np.moveaxis(out, 1, axis)


def resize_bilinear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """PIL's ``Image.resize((W, H), BILINEAR)`` of a 2-d uint8 array to
    ``size = (H, W)``: the horizontal pass first, then the vertical."""
    if img.shape[1] != size[1]:
        img = _resample_axis(img, size[1], axis=1)
    if img.shape[0] != size[0]:
        img = _resample_axis(img, size[0], axis=0)
    return img


def mask_from_url(url: str, size: Optional[Tuple[int, int]] = None
                  ) -> np.ndarray:
    """Decode a painted mask data URL to an (H, W) float32 array in [0, 1]:
    channel 0 of the RGB image, resized to ``size = (H, W)`` if given."""
    png = base64.b64decode(re.sub("^data:image/.+;base64,", "", url))
    red = decode_png(png)[:, :, 0]
    if size is not None:
        red = resize_bilinear(red, tuple(size))
    return red.astype(np.float32) / 255.0

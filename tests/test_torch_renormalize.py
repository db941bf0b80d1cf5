"""The port's PIL-free mask decoder against the JAX package's, which
decodes with PIL: every mask of the published church requests, at the
sizes the rewriter asks for, and PNGs written with each filter type."""

import base64
import glob
import json
import os
import struct
import zlib

import numpy as np
import pytest

from rewriting_tpu.utils.renormalize import mask_from_url as pil_mask_from_url
from rewriting_torch.utils.renormalize import decode_png, mask_from_url

MASKS = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..",
                                      "notebooks", "masks", "stylegan",
                                      "church", "*.json")))
SIZES = [None, (8, 8), (16, 16), (32, 32), (64, 64)]


def _urls(path):
    with open(path) as f:
        req = json.load(f)
    urls = [req[k][1] for k in ("object", "paste", "query") if k in req]
    return urls + [k[1] for k in req.get("key", [])]


@pytest.mark.parametrize("path", MASKS, ids=[os.path.basename(p)[:-5]
                                             for p in MASKS])
def test_church_masks_match_pil(path):
    """Within 1/255 of PIL's decode and BILINEAR resize (measured maximum:
    0, bit-identical)."""
    urls = _urls(path)
    assert urls
    for url in urls:
        for size in SIZES:
            want = pil_mask_from_url(url, size=size)
            got = mask_from_url(url, size=size)
            assert got.dtype == want.dtype == np.float32
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, atol=1 / 255, rtol=0)


def _png(pixels, color_type, ftype):
    """Encode uint8 (H, W, samples) pixels with one filter type on every
    row (type 4, Paeth, exercises the others' predictors too)."""
    h, w, bpp = pixels.shape
    raw = pixels.reshape(h, w * bpp).astype(np.int64)
    rows = []
    prev = np.zeros(w * bpp, np.int64)
    for y in range(h):
        line = raw[y]
        left = np.concatenate([np.zeros(bpp, np.int64), line[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if ftype == 0:
            pred = np.zeros_like(line)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prev
        elif ftype == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        rows.append(bytes([ftype]) + bytes(((line - pred) & 0xFF).tolist()))
        prev = line

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body)))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("color_type,samples", [(0, 1), (2, 3), (4, 2),
                                                (6, 4)],
                         ids=["grey", "rgb", "grey_alpha", "rgba"])
@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_png_filters_match_pil(color_type, samples, ftype):
    """Each filter type and colour type decodes to PIL's pixels, and the
    mask (channel 0 of PIL's RGB conversion, resized) to PIL's mask."""
    import PIL.Image
    import io
    pixels = np.random.RandomState(ftype * 7 + samples).randint(
        0, 256, (13, 21, samples)).astype(np.uint8)
    png = _png(pixels, color_type, ftype)
    np.testing.assert_array_equal(decode_png(png), pixels)
    im = np.asarray(PIL.Image.open(io.BytesIO(png)))
    np.testing.assert_array_equal(im.reshape(pixels.shape), pixels)
    url = "data:image/png;base64," + base64.b64encode(png).decode()
    for size in (None, (5, 9), (13, 21), (7, 21), (13, 4)):
        np.testing.assert_array_equal(mask_from_url(url, size=size),
                                      pil_mask_from_url(url, size=size))


def test_unsupported_png_raises():
    png = bytearray(_png(np.zeros((2, 2, 1), np.uint8), 0, 0))
    png[24] = 16  # bit depth 16
    with pytest.raises(ValueError, match="unsupported PNG"):
        decode_png(bytes(png))
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a")

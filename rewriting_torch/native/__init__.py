"""Image reading for the metrics: one file, or a readahead stream of
batches.

The port's counterpart of the read side of the JAX package's
``native/__init__.py`` (:169-220), which decodes 8-bit PNG in C++ and
hands every other file to PIL.  The port does the same with its own
decoders, picked by the file's signature as PIL's ``open`` picks them (not
by its extension): PNG through ``utils/renormalize.decode_png`` (zlib and
numpy), and JPEG through ``csrc/jpegdec.cpp`` (host C++, built at first
use by ``_native_build``, called through ctypes, which releases the GIL),
whose pixels equal PIL's decode bit for bit.  A file these decoders do not
read -- a palette, 1/2/4/16-bit or interlaced PNG, a CMYK, 4:1:1,
arithmetic, 12-bit or lossless JPEG, WebP, BMP, GIF, TIFF ... -- goes to
PIL (imported there and nowhere else in the port), which decodes it as it
does for the JAX package.  Truncated or corrupt PNG and JPEG data raises
``ValueError`` naming the file, and is not retried with PIL; so does any
other file on a host without PIL.
"""

from __future__ import annotations

import concurrent.futures as cf
import ctypes
import functools
import io
import os
from collections import deque

import numpy as np

from .. import _native_build
from ..utils.renormalize import UnreadFormat, decode_png, to_rgb

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8\xff"

# jpegdec.cpp's JpegError codes
JPEG_ERRORS = {
    -1: "not a JPEG stream",
    -2: "truncated: the data ends before the image does",
    -3: "corrupt JPEG data",
    -4: "bad Huffman table",
    -5: "bad Huffman code in the entropy-coded data",
    -6: "a scan's component has no quantization table",
    -7: "arithmetic coding is not read",
    -8: "lossless and hierarchical JPEG are not read",
    -9: "sample precisions other than 8 bits (such as 12-bit) are not read",
    -10: "only 1 (grey) or 3 (YCbCr, RGB) components are read, not CMYK "
         "or YCCK",
    -11: "sampling factors other than 1x1, 2x1 and 2x2 below the largest "
         "are not read",
    -12: "a zero image dimension (a height set by DNL) is not read",
    -13: "bad scan header or progression",
    -14: "progressive scans that leave low-frequency coefficients "
         "unrefined (libjpeg's block smoothing) are not read",
    -15: "out of memory",
    -16: "missing or misordered restart marker",
    -17: "a scan comes before the frame header",
    -18: "a scan uses an undefined Huffman table",
}
# the codes of streams that are well formed but of a kind jpegdec.cpp does
# not read: libjpeg reads them (or refuses them itself), so they go to PIL
JPEG_NOT_READ = frozenset((-7, -8, -9, -10, -11, -12, -14))


@functools.lru_cache(maxsize=None)
def _jpeg_library():
    lib = _native_build.load("jpegdec")
    intp = ctypes.POINTER(ctypes.c_int)
    lib.jpeg_get_info.argtypes = [ctypes.c_char_p, ctypes.c_long, intp,
                                  intp, intp]
    lib.jpeg_get_info.restype = ctypes.c_int
    lib.jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                ctypes.c_void_p]
    lib.jpeg_decode.restype = ctypes.c_int
    return lib


def _jpeg_error(code: int) -> ValueError:
    kind = UnreadFormat if code in JPEG_NOT_READ else ValueError
    return kind(JPEG_ERRORS.get(code, f"JPEG error {code}"))


def decode_jpeg(data: bytes) -> np.ndarray:
    """The uint8 pixels of a JPEG stream: (H, W, 1) for one component,
    (H, W, 3) RGB for three, equal to PIL's decode (libjpeg-turbo's
    defaults: the accurate integer IDCT, fancy upsampling).  Raises
    ``UnreadFormat`` saying what is not read, and ``ValueError`` saying
    what a corrupt stream lacks."""
    lib = _jpeg_library()
    data = bytes(data)
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    code = lib.jpeg_get_info(data, len(data), ctypes.byref(w),
                             ctypes.byref(h), ctypes.byref(c))
    if code:
        raise _jpeg_error(code)
    try:
        out = np.empty((h.value, w.value, c.value), np.uint8)
    except MemoryError as e:   # a declared frame the host cannot allocate
        raise ValueError(f"out of memory for its {w.value}x{h.value} frame "
                         f"({e})") from e
    code = lib.jpeg_decode(data, len(data), out.ctypes.data)
    if code:
        raise _jpeg_error(code)
    return out


def _pil_decode(data: bytes, name: str, kind: str, rgb: bool) -> np.ndarray:
    """PIL's decode of a file the port's decoders do not read, as the JAX
    package reads it: ``numpy.asarray`` of the image in its own mode, or of
    its ``convert("RGB")``."""
    try:
        import PIL.Image
    except ImportError:
        raise ValueError(
            f"cannot read {name} ({kind}): the port's own decoders read "
            "8-bit PNG and Huffman JPEG, and PIL, which reads the other "
            "kinds, is not installed") from None
    try:
        with PIL.Image.open(io.BytesIO(data)) as im:
            return np.array(im.convert("RGB") if rgb else im)
    except (OSError, SyntaxError, EOFError, ValueError,
            PIL.Image.DecompressionBombError) as e:
        raise ValueError(f"cannot read {name} ({kind}, through PIL): "
                         f"{e}") from e


def decode_image(data: bytes, name: str = "the data",
                 rgb: bool = False) -> np.ndarray:
    """The pixels of an image file's bytes: in its own mode, as
    ``numpy.asarray`` of a PIL image gives them ((H, W) greyscale or
    palette indices, (H, W, 2|3|4) otherwise; PIL's dtype, such as uint16
    for a 16-bit grey PNG), or with `rgb` the (H, W, 3) uint8 array of
    PIL's ``convert("RGB")``.  8-bit PNG and Huffman JPEG are decoded by the
    port, every other file by PIL.  Raises ``ValueError`` naming `name`
    where the data is truncated or corrupt, or where neither reads it."""
    if data.startswith(PNG_SIGNATURE):
        decode, kind = decode_png, "PNG"
    elif data.startswith(JPEG_SIGNATURE):
        decode, kind = decode_jpeg, "JPEG"
    else:
        return _pil_decode(data, name, "neither PNG nor JPEG", rgb)
    try:
        img = decode(data)
    except UnreadFormat as e:
        return _pil_decode(data, name, f"{kind}: {e}", rgb)
    except ValueError as e:
        raise ValueError(f"cannot read {name} ({kind}): {e}") from e
    if rgb:
        return to_rgb(img)
    return img[:, :, 0] if img.shape[2] == 1 else img


def read_image(path: str) -> np.ndarray:
    """The pixels of an image file in its own mode (``decode_image``)."""
    with open(path, "rb") as f:
        return decode_image(f.read(), path)


def read_image_rgb(path: str) -> np.ndarray:
    """The (H, W, 3) uint8 RGB array of an image file: PIL's
    ``convert("RGB")``, alpha dropped, grey copied to each channel."""
    with open(path, "rb") as f:
        return decode_image(f.read(), path, rgb=True)


def read_batches(paths, batch_size: int, workers: int = None,
                 readahead: int = 2):
    """Yield (B, H, W, 3) uint8 batches of the image files in `paths`,
    decoded on a thread pool `readahead` batches ahead of the consumer.
    Order is kept; the last batch holds the remainder.  (A JPEG decodes
    with the GIL released; of a PNG, zlib's inflate releases it and the
    rows' unfiltering in numpy mostly does not.)"""
    paths = list(paths)
    if not paths:
        return
    if workers is None:
        workers = min(8, os.cpu_count() or 1)
    window = max(batch_size * (readahead + 1), workers)
    with cf.ThreadPoolExecutor(workers) as ex:
        futs = deque(ex.submit(read_image_rgb, p) for p in paths[:window])
        nxt = window
        batch = []
        while futs:
            batch.append(futs.popleft().result())
            if nxt < len(paths):
                futs.append(ex.submit(read_image_rgb, paths[nxt]))
                nxt += 1
            if len(batch) == batch_size or not futs:
                yield np.stack(batch)
                batch = []

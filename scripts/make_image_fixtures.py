"""Write the fixtures of ``tests/data/images/``: image files that the port
hands to PIL, as the JAX package does, and JPEG files of kinds PIL does not
write, all 24x40 from seeded numpy content (``make_jpeg_fixtures.content``):

- PNG that the port's own decoder does not read, written here with zlib
  and struct: palette (bit depths 1, 2, 4 and 8, with and without
  ``tRNS``), grey at 1, 2, 4 and 16 bits, 16-bit RGB, RGBA and
  grey+alpha, and Adam7 interlaced files (which PIL cannot write), beside
  an 8-bit grey+alpha file that the port reads itself;
- WebP (lossless and lossy), BMP and GIF, written by PIL;
- JPEG written here: 4:1:1 and 4:4:0 (an encoder of baseline JPEG on
  PIL's own quantization and Huffman tables), multi-scan sequential files
  made by splitting the one scan of a baseline file PIL wrote into a scan
  per component (or Y, then Cb and Cr together), and a progressive file
  cut after its DC scan, which libjpeg smooths.

The port decodes the multi-scan JPEGs itself and hands the rest to PIL;
``chip_smoke.py`` phase 39 and ``tests/test_torch_images.py`` hold every
file against PIL's decode.  The helpers (``png_bytes``, ``split_scans``,
``encode_jpeg``) also build the tests' own cases.

    python3 scripts/make_image_fixtures.py [--out tests/data/images]

Needs PIL and numpy; rewrites every fixture.
"""

from __future__ import annotations

import argparse
import io
import os
import struct
import sys
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from make_jpeg_fixtures import content  # noqa: E402

SIZE = (24, 40)   # every fixture's (H, W), so read_batches stacks them

# -- PNG ---------------------------------------------------------------------

# colour type -> samples per pixel
PNG_SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Adam7's passes: (x0, y0, dx, dy)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, w * spp) samples -> (h, bytes per row) uint8, big-endian,
    sub-byte samples packed from the high bit, each row padded."""
    h, n = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, 2 * n)
    if depth == 8:
        return samples.astype(np.uint8)
    per = 8 // depth
    padded = np.zeros((h, -(-n // per) * per), np.int64)
    padded[:, :n] = samples
    groups = padded.reshape(h, -1, per)
    shifts = depth * np.arange(per - 1, -1, -1)
    return (groups << shifts).sum(axis=2).astype(np.uint8)


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _filter_rows(rows: np.ndarray, bpp: int, first: int) -> bytes:
    """Rows filtered with types first, first + 1, ... (mod 5), each row's
    filter byte before it."""
    out = bytearray()
    prev = np.zeros(rows.shape[1], np.int64)
    for y, row in enumerate(rows.astype(np.int64)):
        ftype = (first + y) % 5
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if ftype == 0:
            pred = np.zeros_like(row)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prev
        elif ftype == 3:
            pred = (left + prev) >> 1
        else:
            pred = np.array([_paeth(a, b, c)
                             for a, b, c in zip(left, prev, upleft)],
                            np.int64)
        out.append(ftype)
        out += ((row - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = row
    return bytes(out)


def png_bytes(pixels: np.ndarray, depth: int, colour: int,
              palette: np.ndarray = None, trns: bytes = None,
              interlace: bool = False) -> bytes:
    """A PNG of `pixels` ((H, W) or (H, W, samples) integers: palette
    indices for colour type 3) at bit depth `depth`, its rows filtered
    with every filter type in turn, Adam7-interlaced if asked."""
    pixels = np.asarray(pixels)
    if pixels.ndim == 2:
        pixels = pixels[:, :, None]
    h, w, spp = pixels.shape
    if spp != PNG_SAMPLES[colour]:
        raise ValueError(f"{spp} samples for colour type {colour}")
    bpp = max(1, spp * depth // 8)
    if interlace:
        raw = b""
        for i, (x0, y0, dx, dy) in enumerate(ADAM7):
            sub = pixels[y0::dy, x0::dx]
            if sub.size:
                raw += _filter_rows(_pack_rows(sub.reshape(
                    sub.shape[0], -1), depth), bpp, i)
    else:
        raw = _filter_rows(_pack_rows(pixels.reshape(h, -1), depth), bpp, 0)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, colour, 0, 0, int(interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return out + _chunk(b"IDAT", zlib.compress(raw, 9)) + _chunk(b"IEND",
                                                                 b"")


# name: (colour type, bit depth, tRNS)
PNG_KINDS = {
    "palette_1bit": (3, 1, False),
    "palette_2bit_trns": (3, 2, True),
    "palette_4bit": (3, 4, False),
    "palette_4bit_trns": (3, 4, True),
    "palette_8bit": (3, 8, False),
    "palette_8bit_trns": (3, 8, True),
    "grey_1bit": (0, 1, False),
    "grey_2bit": (0, 2, False),
    "grey_4bit": (0, 4, False),
    "grey_16bit": (0, 16, False),
    "rgb_16bit": (2, 16, False),
    "rgba_16bit": (6, 16, False),
    "grey_alpha_8bit": (4, 8, False),
    "grey_alpha_16bit": (4, 16, False),
    "rgb_8bit": (2, 8, False),
}


def png_case(kind: str, seed: int, h: int, w: int,
             interlace: bool = False) -> bytes:
    """A seeded PNG of one of ``PNG_KINDS``."""
    rng = np.random.RandomState(seed)
    img = content(seed, h, w).astype(np.int64)
    grey = (img * [299, 587, 114]).sum(axis=2) // 1000
    colour, depth, trns = PNG_KINDS[kind]
    palette = trns_bytes = None
    if colour == 3:
        n = min(1 << depth, 40)
        palette = rng.randint(0, 256, (n, 3))
        pixels = (grey * n) >> 8
        if trns:
            trns_bytes = bytes(rng.randint(0, 256, rng.randint(1, n + 1))
                               .astype(np.uint8))
    elif colour == 0:
        pixels = grey >> (8 - depth) if depth <= 8 else grey * 257 + \
            rng.randint(0, 257, grey.shape)
    else:
        alpha = rng.randint(0, 256, (h, w, 1))
        chans = {2: img, 4: np.concatenate([grey[:, :, None], alpha], 2),
                 6: np.concatenate([img, alpha], 2)}[colour]
        pixels = chans if depth == 8 else chans * 257 + rng.randint(
            0, 257, chans.shape)
    return png_bytes(pixels, depth, colour, palette, trns_bytes, interlace)


# -- JPEG --------------------------------------------------------------------

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43,
    36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53,
    60, 61, 54, 47, 55, 62, 63])   # natural index of each zigzag position


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def _huffman(bits: bytes, vals: bytes):
    """(decode {(length, code): symbol}, encode {symbol: (code, length)})."""
    dec, enc, code, k = {}, {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            dec[(length, code)] = vals[k]
            enc[vals[k]] = (code, length)
            code, k = code + 1, k + 1
        code <<= 1
    return dec, enc


def parse_baseline(data: bytes) -> dict:
    """The pieces of a one-scan baseline JPEG without restart markers: the
    header segments before its SOS, the frame's components, the scan's
    table choices, the Huffman tables and the quantized coefficients of
    every block of the MCU grid, in zigzag order."""
    pos, header, huff, quant, frame = 2, [], {}, {}, None
    while True:
        marker = data[pos + 1]
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        body = data[pos + 4:pos + 2 + length]
        pos += 2 + length
        if marker == 0xDA:
            break
        if marker not in (0xC0, 0xC4, 0xDB, 0xFE) and not \
                0xE0 <= marker <= 0xEF:
            raise ValueError(f"not a plain baseline JPEG (marker {marker:x})")
        header.append((marker, body))
        if marker == 0xC4:
            i = 0
            while i < len(body):
                n = sum(body[i + 1:i + 17])
                huff[(body[i] >> 4, body[i] & 15)] = _huffman(
                    body[i + 1:i + 17], body[i + 17:i + 17 + n])
                i += 17 + n
        elif marker == 0xDB:
            i = 0
            while i < len(body):
                quant[body[i] & 15] = np.frombuffer(body[i + 1:i + 65],
                                                    np.uint8).astype(int)
                i += 65
        elif marker == 0xC0:
            h, w = struct.unpack(">HH", body[1:5])
            frame = {"size": (h, w), "comps": [
                (body[6 + 3 * i], body[7 + 3 * i] >> 4,
                 body[7 + 3 * i] & 15, body[8 + 3 * i])
                for i in range(body[5])]}
    ns = body[0]
    tables = {body[1 + 2 * i]: (body[2 + 2 * i] >> 4, body[2 + 2 * i] & 15)
              for i in range(ns)}
    end = pos
    while data[end] != 0xFF or data[end + 1] == 0:
        end += 2 if data[end] == 0xFF else 1
    raw = data[pos:end].replace(b"\xff\x00", b"\xff")
    bits = "".join(f"{b:08b}" for b in raw)
    at = 0

    def symbol(dec):
        nonlocal at
        for length in range(1, 17):
            sym = dec.get((length, int(bits[at:at + length], 2)))
            if sym is not None:
                at += length
                return sym
        raise ValueError("bad Huffman code")

    def value(s):
        nonlocal at
        if s == 0:
            return 0
        v = int(bits[at:at + s], 2)
        at += s
        return v if v >= 1 << (s - 1) else v - (1 << s) + 1

    comps = frame["comps"]
    hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
    h, w = frame["size"]
    mcux, mcuy = _ceil(w, 8 * hmax), _ceil(h, 8 * vmax)
    coefs = [np.zeros((mcuy * cv, mcux * ch, 64), np.int64)
             for _, ch, cv, _ in comps]
    pred = [0] * len(comps)
    for my in range(mcuy):
        for mx in range(mcux):
            for ci, (cid, ch, cv, _) in enumerate(comps):
                dc, ac = (huff[(0, tables[cid][0])][0],
                          huff[(1, tables[cid][1])][0])
                for by in range(cv):
                    for bx in range(ch):
                        block = coefs[ci][my * cv + by, mx * ch + bx]
                        pred[ci] += value(symbol(dc))
                        block[0] = pred[ci]
                        k = 1
                        while k < 64:
                            rs = symbol(ac)
                            if rs == 0:
                                break
                            k += rs >> 4
                            if rs & 15:
                                block[k] = value(rs & 15)
                            k += 1
    return {"header": header, "frame": frame, "tables": tables,
            "huff": huff, "quant": quant, "coefs": coefs, "mcu": (mcux, mcuy)}


class _Bits:
    """An entropy-coded segment under construction, 0xFF bytes stuffed."""

    def __init__(self):
        self.bits = []

    def put(self, code: int, length: int) -> None:
        self.bits.append(format(code, f"0{length}b") if length else "")

    def value(self, v: int) -> None:
        """`v`'s magnitude category's extra bits (none for 0)."""
        s = abs(v).bit_length()
        self.put(v if v >= 0 else v + (1 << s) - 1, s)

    def bytes(self) -> bytes:
        bits = "".join(self.bits)
        bits += "1" * (-len(bits) % 8)
        out = bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))
        return out.replace(b"\xff", b"\xff\x00")


def _encode_block(out: _Bits, block, pred: int, dc: dict, ac: dict) -> int:
    diff = int(block[0]) - pred
    out.put(*dc[abs(diff).bit_length()])
    out.value(diff)
    run = 0
    for k in range(1, 64):
        c = int(block[k])
        if c == 0:
            run += 1
            continue
        while run > 15:
            out.put(*ac[0xF0])
            run -= 16
        out.put(*ac[(run << 4) | abs(c).bit_length()])
        out.value(c)
        run = 0
    if run:
        out.put(*ac[0x00])
    return int(block[0])


def write_scans(parts: dict, groups) -> bytes:
    """A sequential JPEG of `parts` (``parse_baseline``'s, or
    ``encode_jpeg``'s) with one scan per group of component indices: a
    group of one is a non-interleaved scan over that component's own
    blocks, a larger group an interleaved scan over the MCU grid."""
    comps = parts["frame"]["comps"]
    h, w = parts["frame"]["size"]
    hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
    mcux, mcuy = parts["mcu"]
    out = b"\xff\xd8" + b"".join(_segment(m, b) for m, b in parts["header"])
    for group in groups:
        bits, pred = _Bits(), {ci: 0 for ci in group}

        def code(ci, by, bx):
            cid = comps[ci][0]
            td, ta = parts["tables"][cid]
            pred[ci] = _encode_block(bits, parts["coefs"][ci][by, bx],
                                     pred[ci], parts["huff"][(0, td)][1],
                                     parts["huff"][(1, ta)][1])

        if len(group) == 1:
            ci = group[0]
            _, ch, cv, _ = comps[ci]
            for by in range(_ceil(_ceil(h * cv, vmax), 8)):
                for bx in range(_ceil(_ceil(w * ch, hmax), 8)):
                    code(ci, by, bx)
        else:
            for my in range(mcuy):
                for mx in range(mcux):
                    for ci in group:
                        _, ch, cv, _ = comps[ci]
                        for by in range(cv):
                            for bx in range(ch):
                                code(ci, my * cv + by, mx * ch + bx)
        sos = bytes([len(group)])
        for ci in group:
            cid = comps[ci][0]
            td, ta = parts["tables"][cid]
            sos += bytes([cid, td << 4 | ta])
        out += _segment(0xDA, sos + b"\x00\x3f\x00") + bits.bytes()
    return out + b"\xff\xd9"


def split_scans(jpeg: bytes, groups) -> bytes:
    """The baseline JPEG `jpeg` (one interleaved scan, as PIL writes it)
    with its coefficients re-coded as the scans `groups` (lists of
    component indices), on its own Huffman tables."""
    return write_scans(parse_baseline(jpeg), groups)


def _dct_matrix() -> np.ndarray:
    u, x = np.mgrid[0:8, 0:8]
    m = np.sqrt(2 / 8) * np.cos((2 * x + 1) * u * np.pi / 16)
    m[0] /= np.sqrt(2)
    return m


def encode_jpeg(img: np.ndarray, sampling, quality: int = 75) -> bytes:
    """A baseline YCbCr JPEG of the (H, W, 3) uint8 `img` whose luma has
    the sampling factors `sampling` = (h, v) and whose chroma is 1x1
    (averaged over each h x v block), on the quantization and Huffman
    tables PIL writes at `quality`."""
    import PIL.Image

    ref = io.BytesIO()
    PIL.Image.fromarray(img).save(ref, "JPEG", quality=quality)
    parts = parse_baseline(ref.getvalue())
    hs, vs = sampling
    h, w = img.shape[:2]
    mh, mw = 8 * vs, 8 * hs
    ph, pw = _ceil(h, mh) * mh, _ceil(w, mw) * mw
    rgb = np.pad(img.astype(np.float64), ((0, ph - h), (0, pw - w), (0, 0)),
                 mode="edge")
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    planes = [0.299 * r + 0.587 * g + 0.114 * b,
              -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
              0.5 * r - 0.418688 * g - 0.081312 * b + 128]
    planes = [planes[0]] + [p.reshape(ph // vs, vs, pw // hs, hs)
                            .mean(axis=(1, 3)) for p in planes[1:]]
    dct = _dct_matrix()
    coefs = []
    for ci, plane in enumerate(planes):
        q = parts["quant"][0 if ci == 0 else 1]
        blocks = (plane - 128).reshape(plane.shape[0] // 8, 8,
                                       plane.shape[1] // 8, 8)
        freq = np.einsum("ux,axby,vy->abuv", dct, blocks, dct)
        zz = freq.reshape(freq.shape[0], freq.shape[1], 64)[:, :, ZIGZAG]
        coefs.append(np.round(zz / q).astype(np.int64))
    comps = [(1, hs, vs, 0), (2, 1, 1, 1), (3, 1, 1, 1)]
    sof = struct.pack(">BHHB", 8, h, w, 3) + b"".join(
        bytes([cid, ch << 4 | cv, tq]) for cid, ch, cv, tq in comps)
    header = [(m, sof if m == 0xC0 else b) for m, b in parts["header"]]
    return write_scans({"header": header,
                        "frame": {"size": (h, w), "comps": comps},
                        "tables": {1: (0, 0), 2: (1, 1), 3: (1, 1)},
                        "huff": parts["huff"], "coefs": coefs,
                        "mcu": (pw // mw, ph // mh)}, [[0, 1, 2]])


def dc_scan_only(jpeg: bytes) -> bytes:
    """A progressive JPEG cut after its first scan (the DC band), EOI
    appended: well formed, its AC coefficients never sent, so libjpeg
    smooths its blocks."""
    second = jpeg.index(b"\xff\xda", jpeg.index(b"\xff\xda") + 2)
    while True:   # back up over the tables that precede the second scan
        prev = max(jpeg.rfind(b"\xff\xc4", 0, second),
                   jpeg.rfind(b"\xff\xdb", 0, second))
        if prev < 0 or prev + 2 + struct.unpack(
                ">H", jpeg[prev + 2:prev + 4])[0] != second:
            break
        second = prev
    return jpeg[:second] + b"\xff\xd9"


def jpeg_cases(seed: int, h: int, w: int) -> dict:
    """name -> JPEG bytes of the kinds the fixtures hold, from seeded
    content of size (h, w)."""
    import PIL.Image

    img = content(seed, h, w)

    def pil(**options) -> bytes:
        buf = io.BytesIO()
        PIL.Image.fromarray(img).save(buf, "JPEG", **options)
        return buf.getvalue()

    base_420, base_444 = pil(quality=80), pil(quality=90, subsampling=0)
    return {
        "ycc_411": encode_jpeg(img, (4, 1)),
        "ycc_440": encode_jpeg(img, (1, 2)),
        "multiscan_444": split_scans(base_444, [[0], [1], [2]]),
        "multiscan_420": split_scans(base_420, [[2], [0], [1]]),
        "multiscan_420_y_cbcr": split_scans(base_420, [[0], [1, 2]]),
        "progressive_dc_only": dc_scan_only(pil(quality=85,
                                                progressive=True)),
    }


def other_cases(seed: int, h: int, w: int) -> dict:
    """name -> bytes of the WebP, BMP and GIF files, written by PIL."""
    import PIL.Image

    im = PIL.Image.fromarray(content(seed, h, w))
    out = {}
    for name, fmt, options in (("lossless.webp", "WEBP", {"lossless": True}),
                               ("lossy.webp", "WEBP", {"quality": 80}),
                               ("rgb.bmp", "BMP", {}),
                               ("palette.gif", "GIF", {})):
        buf = io.BytesIO()
        im.save(buf, fmt, **options)
        out[name] = buf.getvalue()
    return out


def fixtures() -> dict:
    """file name -> bytes of every fixture."""
    h, w = SIZE
    files = {}
    for seed, kind in enumerate(PNG_KINDS):
        if kind != "rgb_8bit":
            files[f"{kind}.png"] = png_case(kind, seed, h, w)
    for seed, kind in enumerate(("rgb_8bit", "palette_4bit_trns",
                                 "grey_16bit", "grey_alpha_8bit")):
        files[f"adam7_{kind}.png"] = png_case(kind, 40 + seed, h, w,
                                              interlace=True)
    for name, data in jpeg_cases(60, h, w).items():
        files[f"{name}.jpg"] = data
    files.update(other_cases(70, h, w))
    return files


def main(argv=None) -> int:
    args = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    args.add_argument("--out", default=os.path.join(ROOT, "tests", "data",
                                                    "images"))
    args = args.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    total = 0
    for name, data in sorted(fixtures().items()):
        with open(os.path.join(args.out, name), "wb") as f:
            f.write(data)
        total += len(data)
        print(f"{name}: {len(data)} bytes")
    print(f"total {total} bytes in {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

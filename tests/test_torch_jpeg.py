"""The port's JPEG decoder (``rewriting_torch/csrc/jpegdec.cpp`` through
``native``) against the JAX package's reader, which hands a JPEG to PIL
(libjpeg-turbo with its defaults).

Held bit for bit (0 LSB, no value apart), on JPEGs PIL writes from seeded
numpy content (smooth fields with edges, and noise):
- ``read_image_rgb`` equal to the JAX package's, ``read_image`` equal to
  ``numpy.asarray`` of PIL's image in its own mode, over 4:4:4, 4:2:2,
  4:2:0, grey, progressive (4:2:0, 4:4:4, grey), optimized tables,
  restart markers (every 3 blocks, every MCU row) and RGB (Adobe
  transform 0), at quality 50, 75, 95 and 100 and sizes 1x1 to 256x256
  (9x4: chroma two samples wide, replicated, not fancy-upsampled),
  and a hypothesis property over size, quality, sampling and progression;
- files PIL does not write but reads: Huffman tables left out (the
  standard ones), the colour rule of JFIF, Adobe's transform and the
  component IDs, quantization tables (8- and 16-bit) large enough that
  the IDCT overshoots, where libjpeg-turbo's SIMD IDCT saturates;
- the fixtures of ``tests/data/jpeg`` equal their PNG twins and PIL's
  decode;
- FID's image directories, ``samples.load_image`` and ``get_gt_samples``
  and NBB's listing on JPEGs equal the JAX package's.

Refused with ``ValueError`` naming the file, and not handed to PIL: a
truncated stream, one cut inside a progressive refinement scan, a bad
Huffman code, a frame larger than its data, a misnumbered restart marker,
and frames of tiny files that declare more than the host will allocate
(65535x65535 grey, 16384x16384 4:2:0) under an address-space limit.  The
kinds the decoder does not read go to PIL, as in the JAX package: CMYK,
arithmetic and 4:1:1 frames and a WebP named ``.jpg`` read as the JAX
package reads them; a zero dimension, 12-bit and lossless frames raise in
both packages, the port's ``ValueError`` naming the file and the kind.
Mutated fixtures raise or decode and never crash the process; threads
decode as one does; the host build is keyed on its source and raises with
the compiler's output.
"""

import io
import os
import re
import stat
import struct
import subprocess
import sys

import numpy as np
import PIL.Image
import PIL.ImageFile
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from rewriting_tpu import native as jax_native
from rewriting_tpu.baselines import nbbviz as jax_nbbviz
from rewriting_tpu.metrics import fid as jax_fid
from rewriting_tpu.metrics import samples as jax_samples
from rewriting_torch import _native_build as _build
from rewriting_torch import native
from rewriting_torch.baselines import nbbviz
from rewriting_torch.metrics import fid, samples

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "data", "jpeg")

# (9, 4): chroma two samples wide, which libjpeg upsamples by replication
SIZES = [(1, 1), (9, 4), (7, 9), (17, 33), (131, 257), (256, 256)]
QUALITIES = (50, 75, 95, 100)
OPTIONS = {
    "444": {"subsampling": 0},
    "422": {"subsampling": 1},
    "420": {"subsampling": 2},
    "grey": {"grey": True},
    "progressive_420": {"progressive": True},
    "progressive_444": {"progressive": True, "subsampling": 0},
    "progressive_grey": {"progressive": True, "grey": True},
    "optimized_422": {"optimize": True, "subsampling": 1},
    "restart_blocks": {"restart_marker_blocks": 3},
    "restart_rows_420": {"restart_marker_rows": 1, "subsampling": 2},
    "rgb_444": {"keep_rgb": True, "subsampling": 0},
}


def content(kind: str, h: int, w: int, seed: int) -> np.ndarray:
    """Seeded (h, w, 3) uint8: noise, or smooth fields with hard edges."""
    rng = np.random.RandomState(seed)
    if kind == "noise":
        return rng.randint(0, 256, (h, w, 3), np.uint8)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    f = rng.uniform(0.03, 0.2, 3)
    img = np.stack([128 + 110 * np.sin(x * f[c] + c) * np.cos(y * f[c] - c)
                    for c in range(3)], -1)
    img[(x + 2 * y).astype(int) % 23 < 4] = rng.uniform(0, 255, 3)
    img[(3 * x - y).astype(int) % 41 < 3] = rng.uniform(0, 255, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def write_jpeg(path, img: np.ndarray, quality: int, options: dict) -> None:
    options = dict(options)
    im = PIL.Image.fromarray(img)
    if options.pop("grey", False):
        im = im.convert("L")
    # PIL writes a progressive JPEG through one buffer of about w*h bytes,
    # too small for noise at quality 100: give it room
    block = PIL.ImageFile.MAXBLOCK
    PIL.ImageFile.MAXBLOCK = max(block, 8 * img.shape[0] * img.shape[1])
    try:
        im.save(path, "JPEG", quality=quality, **options)
    finally:
        PIL.ImageFile.MAXBLOCK = block


def assert_reads_as_pil(path) -> None:
    path = str(path)
    got = native.read_image_rgb(path)
    assert got.dtype == np.uint8 and got.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(got, jax_native.read_image_rgb(path),
                                  err_msg=path)
    own = native.read_image(path)
    want = np.asarray(PIL.Image.open(path))
    assert own.shape == want.shape, path
    np.testing.assert_array_equal(own, want, err_msg=path)


@pytest.mark.parametrize("size", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
@pytest.mark.parametrize("option", list(OPTIONS))
def test_matches_pil_bit_for_bit(tmp_path, option, size):
    h, w = size
    for quality in QUALITIES:
        for seed, kind in enumerate(("smooth", "noise")):
            path = tmp_path / f"{kind}_q{quality}.jpg"
            write_jpeg(path, content(kind, h, w, seed + quality), quality,
                       OPTIONS[option])
            assert_reads_as_pil(path)


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(h=st.integers(1, 70), w=st.integers(1, 70),
       quality=st.integers(1, 100), subsampling=st.sampled_from([0, 1, 2]),
       progressive=st.booleans(), noise=st.booleans(),
       seed=st.integers(0, 2 ** 16))
def test_property_matches_pil(tmp_path, h, w, quality, subsampling,
                              progressive, noise, seed):
    path = tmp_path / "x.jpg"
    write_jpeg(path, content("noise" if noise else "smooth", h, w, seed),
               quality, {"subsampling": subsampling,
                         "progressive": progressive})
    assert_reads_as_pil(path)


# -- files PIL reads but does not write ----------------------------------------

def segments(data: bytes):
    """(offset, marker, length) of each marker segment before the first
    scan's entropy-coded data, SOS included."""
    out, pos = [], 2
    while True:
        assert data[pos] == 0xFF
        marker = data[pos + 1]
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        out.append((pos, marker, length))
        if marker == 0xDA:
            return out
        pos += 2 + length


def without(data: bytes, marker: int) -> bytes:
    """`data` with every segment of `marker` before the first scan cut."""
    cuts = [(p, p + 2 + n) for p, m, n in segments(data) if m == marker]
    assert cuts
    for start, end in reversed(cuts):
        data = data[:start] + data[end:]
    return data


def patched(data: bytes, marker: int, offset: int, value: bytes) -> bytes:
    """`value` written at `offset` into the body of the first `marker`
    segment (after its length)."""
    pos = next(p for p, m, _ in segments(data) if m == marker) + 4 + offset
    return data[:pos] + value + data[pos + len(value):]


def jpeg_bytes(img, **options) -> bytes:
    buf = io.BytesIO()
    write_jpeg(buf, img, options.pop("quality", 90), options)
    return buf.getvalue()


def component_ids(data: bytes, ids: bytes) -> bytes:
    """The three components renamed `ids` in the frame and scan headers."""
    for k in range(3):
        data = patched(data, 0xC0, 6 + 3 * k, ids[k:k + 1])
        data = patched(data, 0xDA, 1 + 2 * k, ids[k:k + 1])
    return data


def test_files_pil_reads_but_does_not_write(tmp_path):
    img = content("smooth", 40, 56, 3)
    base = jpeg_bytes(img, subsampling=0)
    rgb = jpeg_bytes(img, subsampling=0, keep_rgb=True)
    adobe = next(p for p, m, _ in segments(rgb) if m == 0xEE)
    cases = {
        # no DHT: libjpeg takes Annex K's tables, as for motion JPEG
        "standard_tables": without(jpeg_bytes(img, subsampling=2), 0xC4),
        # no JFIF marker: IDs 1, 2, 3 say YCbCr, 'R', 'G', 'B' say RGB,
        # anything else YCbCr
        "ids_123": without(base, 0xE0),
        "ids_rgb": component_ids(without(base, 0xE0), b"RGB"),
        "ids_other": component_ids(without(base, 0xE0), b"xyz"),
        # JFIF wins over the IDs
        "jfif_ids_rgb": component_ids(base, b"RGB"),
        # Adobe's transform 1 says YCbCr over the IDs 'R', 'G', 'B'
        "adobe_transform_1": rgb[:adobe + 15] + b"\x01" + rgb[adobe + 16:],
    }
    assert rgb[adobe + 4:adobe + 9] == b"Adobe" and rgb[adobe + 15] == 0
    for name, data in cases.items():
        path = tmp_path / f"{name}.jpg"
        path.write_bytes(data)
        assert_reads_as_pil(path)
    # the colour rule does change what these decode to
    apart = np.asarray(PIL.Image.open(tmp_path / "ids_rgb.jpg")) != \
        np.asarray(PIL.Image.open(tmp_path / "ids_123.jpg"))
    assert apart.any()


def with_quant_tables(data: bytes, tables) -> bytes:
    """`data` with each DQT before the first scan replaced by 16-bit tables
    of the values `tables(index)` gives (64 each, zigzag order)."""
    out, last = data[:2], segments(data)
    for pos, marker, length in last:
        if marker != 0xDB:
            out += data[pos:pos + 2 + length]
            continue
        body, new, i = data[pos + 4:pos + 2 + length], b"", 0
        while i < len(body):
            index = body[i] & 15
            new += bytes([0x10 | index]) + struct.pack(
                ">64H", *tables(index, body[i + 1:i + 65]))
            i += 65
        out += b"\xff\xdb" + struct.pack(">H", len(new) + 2) + new
    pos, _, length = last[-1]
    return out + data[pos + 2 + length:]


@pytest.mark.parametrize("scale", [4, 16, "random16"])
def test_overshooting_quant_tables_match_pil(tmp_path, scale):
    """Quantization tables far above the encoder's throw the IDCT's values
    out of range (and, at 16 bits, past int16 in the dequantization):
    PIL's libjpeg-turbo runs its SIMD IDCT, which saturates there, and the
    port computes the same pixels."""
    rng = np.random.RandomState(7)
    for i in range(12):
        h, w = rng.randint(8, 40, 2)
        img = content("noise" if i % 2 else "smooth", h, w, i)
        base = jpeg_bytes(img, quality=90, subsampling=i % 3,
                          progressive=i % 4 == 3)
        if scale == "random16":
            tables = lambda index, q: rng.randint(1, 65536, 64)
        else:
            tables = lambda index, q: [min(255, v * scale) for v in q]
        path = tmp_path / f"{i}.jpg"
        path.write_bytes(with_quant_tables(base, tables))
        assert_reads_as_pil(path)


def test_fixtures_equal_their_png_twins():
    pairs = sorted(f[:-4] for f in os.listdir(FIXTURES) if f.endswith(".jpg")
                   and os.path.exists(os.path.join(FIXTURES, f[:-4] + ".png")))
    assert len(pairs) >= 9
    for name in pairs:
        jpg, png = (os.path.join(FIXTURES, name + ext)
                    for ext in (".jpg", ".png"))
        np.testing.assert_array_equal(native.read_image(jpg),
                                      native.read_image(png), err_msg=name)
        np.testing.assert_array_equal(
            np.asarray(PIL.Image.open(png)), np.asarray(PIL.Image.open(jpg)),
            err_msg=name)
        assert_reads_as_pil(jpg)
    total = sum(os.path.getsize(os.path.join(FIXTURES, f))
                for f in os.listdir(FIXTURES))
    assert total < 1.5 * 2 ** 20
    path = os.path.join(FIXTURES, "truncated.jpg")
    with pytest.raises(ValueError, match=f"{re.escape(path)}.*truncated"):
        native.read_image_rgb(path)
    # a CMYK JPEG is a kind jpegdec does not read: PIL reads it
    assert_reads_as_pil(os.path.join(FIXTURES, "cmyk.jpg"))


# -- what the port refuses -----------------------------------------------------

def entropy_start(data: bytes, scan: int = 0) -> int:
    """Offset of the entropy-coded data of scan `scan` (0 the first)."""
    starts = [m.end() + struct.unpack(">H", data[m.end():m.end() + 2])[0]
              for m in re.finditer(b"\xff\xda", data)]
    return starts[scan]


def progressive_refinement_cut(data: bytes) -> bytes:
    """`data` cut in the middle of its first AC refinement scan."""
    for m in re.finditer(b"\xff\xda", data):
        head = m.end()
        n = data[head + 2]
        ss, se, a = data[head + 3 + 2 * n:head + 6 + 2 * n]
        if ss > 0 and a >> 4:
            start = head + struct.unpack(">H", data[head:head + 2])[0]
            end = data.index(b"\xff", start + 1)
            while data[end + 1] == 0:
                end = data.index(b"\xff", end + 2)
            return data[:(start + end) // 2]
    raise AssertionError("no AC refinement scan")


# the cases of `refused` whose kind jpegdec does not read, handed to PIL
BY_PIL = ("zero_height", "cmyk", "12_bit", "arithmetic", "lossless", "411",
          "webp")


def refused():
    img = content("smooth", 64, 80, 7)
    base = jpeg_bytes(img, subsampling=2)
    e = entropy_start(base)
    sof = next(p for p, m, _ in segments(base) if m == 0xC0)
    restart = jpeg_bytes(img, subsampling=2, restart_marker_blocks=2)
    rst = restart.index(b"\xff\xd0", entropy_start(restart))
    cmyk, webp = io.BytesIO(), io.BytesIO()
    PIL.Image.fromarray(img).convert("CMYK").save(cmyk, "JPEG")
    PIL.Image.fromarray(img).save(webp, "WEBP")
    return {
        "truncated": (base[:len(base) // 2], "truncated"),
        "progressive_refinement_cut": (progressive_refinement_cut(
            jpeg_bytes(img, progressive=True)), "truncated"),
        "bad_huffman_code": (base[:e] + b"\xff\x00\xff\x00" + base[e:],
                             "Huffman code"),
        "frame_larger_than_data": (patched(base, 0xC0, 1, b"\x10\x00\x10\x00"),
                                   "truncated"),
        "zero_height": (patched(base, 0xC0, 1, b"\x00\x00"), "zero image"),
        "misnumbered_restart": (restart[:rst + 1] + b"\xd3" + restart[rst + 2:],
                                "restart marker"),
        # the kinds jpegdec does not read go to PIL: read as the JAX
        # package reads them (why None), or refused by PIL in both
        # packages, the port naming the file and the kind
        "cmyk": (cmyk.getvalue(), None),
        "12_bit": (patched(base, 0xC0, 0, b"\x0c"), "12-bit"),
        "arithmetic": (base[:sof + 1] + b"\xc9" + base[sof + 2:], None),
        "lossless": (base[:sof + 1] + b"\xc3" + base[sof + 2:], "lossless"),
        "411": (patched(jpeg_bytes(img, subsampling=0), 0xC0, 7, b"\x41"),
                None),
        # read by signature, not by extension: a WebP named .jpg
        "webp": (webp.getvalue(), None),
    }


@pytest.mark.parametrize("case", list(refused()))
def test_refused_with_the_file_named(tmp_path, case):
    """Corrupt data raises naming the file; a kind the decoder does not
    read reads as the JAX package reads it through PIL, or raises in both
    packages."""
    data, why = refused()[case]
    path = tmp_path / f"{case}.jpg"
    path.write_bytes(data)
    if why is None:
        assert_reads_as_pil(path)
        return
    if case in BY_PIL:    # PIL refuses it for the JAX package too
        with pytest.raises(OSError):
            jax_native.read_image_rgb(str(path))
    for read in (native.read_image, native.read_image_rgb):
        with pytest.raises(ValueError,
                           match=f"{re.escape(str(path))}.*{why}"):
            read(str(path))


_UNDER_AN_ADDRESS_LIMIT = """
import resource, sys
from rewriting_torch import native
native._jpeg_library()
with open("/proc/self/status") as f:
    size = next(int(line.split()[1]) for line in f
                if line.startswith("VmSize:")) * 1024
hard = resource.getrlimit(resource.RLIMIT_AS)[1]
resource.setrlimit(resource.RLIMIT_AS, (size + 2 ** 30, hard))
try:
    native.read_image_rgb(sys.argv[1])
except ValueError as e:
    print(e)
"""


# (grey SOF, 65535x65535): the output array of 4 GiB is refused; (4:2:0
# SOF, 16384x16384): its 768 MiB fit, the decoder's coefficients do not
HUGE_FRAMES = {"grey_65535_square": (True, b"\xff\xff\xff\xff",
                                     "out of memory for its 65535x65535 frame"),
               "420_16384_square": (False, b"\x40\x00\x40\x00",
                                    "out of memory$")}


@pytest.mark.parametrize("case", list(HUGE_FRAMES))
def test_frames_larger_than_memory_refused(tmp_path, case):
    """A tiny stream whose SOF declares a frame the host cannot allocate
    raises ValueError naming the file, in a process limited to 1 GiB of
    address space more than it holds (a host that will not overcommit)."""
    grey, dims, why = HUGE_FRAMES[case]
    base = jpeg_bytes(content("smooth", 64, 80, 7), subsampling=2,
                      grey=grey)
    path = tmp_path / f"{case}.jpg"
    path.write_bytes(patched(base, 0xC0, 1, dims))
    proc = subprocess.run([sys.executable, "-c", _UNDER_AN_ADDRESS_LIMIT,
                           str(path)], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert re.match(f"cannot read {re.escape(str(path))} .*{why}",
                    proc.stdout.strip()), proc.stdout


@pytest.mark.parametrize("fixture", ["baseline_420_q75_256",
                                     "progressive_420_q90_256"])
def test_mutants_raise_or_decode(fixture):
    """Byte mutants (1-3 bytes set at random past the SOI) and cuts of a
    fixture: each raises ValueError or decodes to a uint8 image; none
    takes the process down."""
    with open(os.path.join(FIXTURES, fixture + ".jpg"), "rb") as f:
        data = f.read()
    rng = np.random.RandomState(len(data))
    outcomes = {"decoded": 0, "refused": 0}
    for i in range(200):
        mutant = bytearray(data)
        if i % 10 == 9:
            mutant = mutant[:rng.randint(3, len(data))]
        else:
            for pos in rng.randint(2, len(data), rng.randint(1, 4)):
                mutant[pos] = rng.randint(0, 256)
        try:
            img = native.decode_jpeg(bytes(mutant))
        except ValueError:
            outcomes["refused"] += 1
            continue
        assert img.dtype == np.uint8 and img.ndim == 3
        outcomes["decoded"] += 1
    assert outcomes["refused"] > 0 and outcomes["decoded"] > 0, outcomes


def test_threads_decode_as_one_does():
    paths = sorted(os.path.join(FIXTURES, f) for f in os.listdir(FIXTURES)
                   if f.endswith("_256.jpg")) * 3
    serial = np.stack([native.read_image_rgb(p) for p in paths])
    for workers in (2, 4):
        batches = list(native.read_batches(paths, 5, workers=workers))
        assert len(batches[-1]) == (len(paths) % 5 or 5)
        np.testing.assert_array_equal(np.concatenate(batches), serial)


# -- the readers that take JPEGs, against the JAX package's --------------------

def test_fid_image_dir_batches_mixed_png_and_jpeg(tmp_path):
    rng = np.random.RandomState(2)
    for i, name in enumerate(("0.png", "1.jpg", "2.jpeg", "10.jpg", "3.png",
                              "a.jpg", "b.png")):
        img = content("smooth" if i % 2 else "noise", 24, 40, i)
        if name.endswith(".png"):
            PIL.Image.fromarray(img).save(tmp_path / name)
        else:
            write_jpeg(tmp_path / name, img, int(rng.randint(50, 101)),
                       {"subsampling": i % 3})
    for as_uint8 in (True, False):
        got = list(fid._image_dir_batches(str(tmp_path), 3, as_uint8))
        want = list(jax_fid._image_dir_batches(str(tmp_path), 3, as_uint8))
        assert [len(b) for b in got] == [len(b) for b in want] == [3, 3, 1]
        for a, b in zip(got, want):
            assert a.dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("shape,size,grey", [((100, 61), 32, False),
                                             ((33, 47), 16, True),
                                             ((64, 64), 64, False),
                                             ((9, 300), 8, False)])
def test_load_image_of_a_jpeg_matches_pil(tmp_path, shape, size, grey):
    path = tmp_path / "x.jpg"
    write_jpeg(path, content("smooth", *shape, sum(shape)), 85,
               {"grey": grey})
    got = samples.load_image(str(path), size)
    assert got.shape == (size, size, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_samples.load_image(str(path),
                                                              size))


def test_gt_samples_of_jpegs_match_jax(tmp_path):
    for i in range(6):
        write_jpeg(tmp_path / f"{i}.jpg", content("smooth", 20, 30, i), 80,
                   {"progressive": bool(i % 2)})
    np.testing.assert_array_equal(samples.get_gt_samples(str(tmp_path), 16, 4),
                                  jax_samples.get_gt_samples(str(tmp_path),
                                                             16, 4))


def test_nbb_listing_picks_up_jpeg_sources(tmp_path):
    src, results = tmp_path / "pairs", tmp_path / "results"
    src.mkdir()
    for name in ("pairs_1.jpg", "pairs_2.png", "pairs_3.jpeg", "pairs_4.JPG",
                 "pairs_5.webp", "pairs_6.txt"):
        (src / name).write_bytes(b"")
    (results / "2").mkdir(parents=True)
    (results / "2" / "BtoA.npy").write_bytes(b"")
    got = nbbviz.check_missing(str(src), str(results))
    assert got == jax_nbbviz.check_missing(str(src), str(results)) == \
        [1, 3, 4, 5]


# -- the host build ----------------------------------------------------------

def test_host_build_is_keyed_on_the_source(tmp_path, monkeypatch):
    """A stand-in compiler named by ``$CXX`` shows the ``.cpp`` route builds
    once per source hash, raises with the compiler's stderr when it fails,
    and raises when the compiler is missing."""
    calls = tmp_path / "calls"
    cxx = tmp_path / "cxx"
    cxx.write_text(
        "#!/bin/sh\n"
        f"echo \"$@\" >> {calls}\n"
        'for a; do prev=$a; done\n'
        'if grep -q BROKEN "$prev"; then echo "error: bad source" >&2; '
        'exit 2; fi\n'
        'out=""; while [ $# -gt 0 ]; do [ "$1" = -o ] && out=$2; shift; '
        'done\n'
        'echo lib > "$out"\n')
    cxx.chmod(cxx.stat().st_mode | stat.S_IEXEC)
    src_dir = tmp_path / "csrc"
    src_dir.mkdir()
    (src_dir / "h.cpp").write_text('extern "C" int f() { return 0; }\n')
    monkeypatch.setattr(_build, "SOURCE_DIR", src_dir)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setenv("CXX", str(cxx))
    lines = lambda: calls.read_text().splitlines() if calls.exists() else []
    lib = _build.build("h")
    assert lib == tmp_path / "_build" / "libh.so"
    assert len(lines()) == 1
    assert lines()[0].split()[:4] == list(_build.CXX_FLAGS)
    _build.build("h")
    assert len(lines()) == 1              # same source: no second build
    (src_dir / "h.cpp").write_text('extern "C" int f() { return 1; }\n')
    _build.build("h")
    assert len(lines()) == 2              # new source: built again
    (src_dir / "h.cpp").write_text("BROKEN\n")
    with pytest.raises(RuntimeError, match="bad source"):
        _build.build("h")
    assert not [p for p in os.listdir(tmp_path / "_build")
                if p.endswith(".tmp")]
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    (src_dir / "h.cpp").write_text('extern "C" int f() { return 2; }\n')
    with pytest.raises(RuntimeError, match="compiler"):
        _build.build("h")


def test_jpegdec_builds_from_the_repository():
    lib = _build.build("jpegdec")
    assert lib == _build.BUILD_DIR / "libjpegdec.so" and lib.is_file()
    assert _build.source_path("jpegdec").suffix == ".cpp"
    stamp = lib.with_name(lib.name + ".sha256")
    assert stamp.read_text() == _build._digest(_build.source_path("jpegdec"))

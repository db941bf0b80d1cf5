"""The port reads every image file the JAX package reads, and the last
public names of the JAX package get their counterparts.

The JAX package decodes 8-bit PNG natively and hands every other file to
PIL (``rewriting_tpu/native/__init__.py:169-180``); the port decodes 8-bit
PNG and Huffman JPEG itself and hands PIL the rest
(``rewriting_torch/native``).  Held with no tolerance (0 values apart), on
files made from numpy-seeded pixels:
- ``read_image_rgb`` equal to the JAX package's and ``read_image`` equal
  to ``numpy.asarray`` of PIL's image in its own mode (shape and dtype
  too) on every fixture of ``tests/data/images`` and on PNG of every
  colour type and bit depth (palette with and without ``tRNS``, grey at
  1, 2, 4 and 16 bits, 16-bit colour, grey+alpha), plain and Adam7
  interlaced (built here with zlib and struct: PIL cannot write it), at
  sizes down to 1x1; WebP (lossless and lossy), BMP and GIF; CMYK, 4:1:1
  and 4:4:0 JPEG, a progressive JPEG that libjpeg smooths, and
  multi-scan sequential JPEGs, which the port decodes itself;
- ``distances._load_image``, ``renormalize.mask_from_url``, ``from_url``
  and ``from_image`` and ``ParallelImageFolders`` equal to the JAX
  package's on PNG, palette PNG, JPEG and WebP;
- with PIL blocked (a child process), PNG and JPEG still read and any
  other file raises ``ValueError`` naming the file and PIL; truncated or
  corrupt PNG and JPEG data raise ``ValueError`` naming the file without
  PIL being imported.
The names of part C against the JAX package: ``zdataset``'s samplers,
batches and loaders exactly; ``GanRewriter.is_empty_mask`` exactly;
``SeqStyleGAN2.apply_bag`` at fp32's atol 1e-4 (the convolutions sum in
another order, as in ``tests/test_torch_stylegan2.py``);
``upfirdn2d_general`` within 1e-5 of values of size 1 (one depthwise
convolution's order of sums); ``StagePipeline.param_names``,
``subsequence`` and ``bag`` exactly.
"""

import base64
import io
import os
import re
import struct
import subprocess
import sys
import types
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

from rewriting_tpu import native as jax_native
from rewriting_tpu.core.bag import bag as jax_bag
from rewriting_tpu.core.stages import subsequence as jax_subsequence
from rewriting_tpu.metrics import distances as jax_distances
from rewriting_tpu.models.stylegan2 import SeqStyleGAN2 as JaxSeqStyleGAN2
from rewriting_tpu.ops.upfirdn2d import \
    upfirdn2d_general as jax_upfirdn2d_general
from rewriting_tpu.rewrite.rewriter import GanRewriter as JaxGanRewriter
from rewriting_tpu.utils import renormalize as jax_renormalize
from rewriting_tpu.utils import zdataset as jax_zdataset
from rewriting_tpu.utils.parallelfolder import \
    ParallelImageFolders as JaxFolders
from rewriting_torch import native
from rewriting_torch.convert import params_from_jax
from rewriting_torch.core import DataBag
from rewriting_torch.core.bag import bag
from rewriting_torch.core.stages import subsequence
from rewriting_torch.metrics import distances
from rewriting_torch.models.stylegan2 import SeqStyleGAN2
from rewriting_torch.ops.upfirdn2d import upfirdn2d, upfirdn2d_general
from rewriting_torch.rewrite.rewriter import GanRewriter
from rewriting_torch.utils import renormalize, zdataset
from rewriting_torch.utils.parallelfolder import ParallelImageFolders

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGES = os.path.join(ROOT, "tests", "data", "images")
CMYK = os.path.join(ROOT, "tests", "data", "jpeg", "cmyk.jpg")
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import make_image_fixtures as fx  # noqa: E402

torch.set_num_threads(1)

SIZES = [(1, 1), (3, 5), (9, 13), (17, 8)]


def assert_reads_as_jax_and_pil(path) -> None:
    path = str(path)
    got = native.read_image_rgb(path)
    assert got.dtype == np.uint8 and got.flags["C_CONTIGUOUS"], path
    np.testing.assert_array_equal(got, jax_native.read_image_rgb(path),
                                  err_msg=path)
    own = native.read_image(path)
    with PIL.Image.open(path) as im:
        want = np.asarray(im)
    assert own.shape == want.shape and own.dtype == want.dtype, path
    np.testing.assert_array_equal(own, want, err_msg=path)


def _write(tmp_path, name: str, data: bytes) -> str:
    path = tmp_path / name
    path.write_bytes(data)
    return str(path)


# -- the files the JAX package reads ------------------------------------------

@pytest.mark.parametrize("name", sorted(os.listdir(IMAGES)) + ["cmyk.jpg"])
def test_fixtures_read_as_jax_and_pil(name):
    assert_reads_as_jax_and_pil(CMYK if name == "cmyk.jpg"
                                else os.path.join(IMAGES, name))


def test_fixture_set():
    """Every kind the slice adds is in ``tests/data/images``, all of one
    size (phase 39 stacks them), well under 1 MB; the multi-scan JPEGs are
    the port's own decode, the rest PIL's."""
    names = sorted(os.listdir(IMAGES))
    assert names == sorted(fx.fixtures())
    assert sum(os.path.getsize(os.path.join(IMAGES, n)) for n in names) \
        < 2 ** 20 // 8
    for name in names:
        assert native.read_image_rgb(os.path.join(IMAGES, name)).shape == \
            fx.SIZE + (3,)
    for name in names:
        with open(os.path.join(IMAGES, name), "rb") as f:
            data = f.read()
        if name.startswith("multiscan"):
            native.decode_jpeg(data)    # no PIL
        elif name.endswith(".jpg"):
            with pytest.raises(renormalize.UnreadFormat):
                native.decode_jpeg(data)


@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("kind", list(fx.PNG_KINDS))
def test_png_kinds(tmp_path, kind, interlace):
    for seed, (h, w) in enumerate(SIZES):
        path = _write(tmp_path, f"{kind}_{h}x{w}.png",
                      fx.png_case(kind, seed, h, w, interlace))
        assert_reads_as_jax_and_pil(path)


def test_adam7_is_read_as_its_plain_twin(tmp_path):
    """The Adam7 writer puts every pixel where PIL finds it."""
    for kind in ("rgb_8bit", "palette_4bit", "grey_16bit"):
        for seed, (h, w) in enumerate(SIZES + [(24, 40)]):
            plain, adam7 = (native.read_image(_write(
                tmp_path, f"{kind}{i}.png", fx.png_case(kind, seed, h, w, i)))
                for i in (0, 1))
            np.testing.assert_array_equal(plain, adam7)


@pytest.mark.parametrize("size", SIZES + [(24, 40)],
                         ids=[f"{h}x{w}" for h, w in SIZES + [(24, 40)]])
def test_webp_bmp_gif(tmp_path, size):
    for name, data in fx.other_cases(sum(size), *size).items():
        assert_reads_as_jax_and_pil(_write(tmp_path, name, data))


@pytest.mark.parametrize("size", [(1, 1), (7, 9), (17, 33), (40, 24)],
                         ids=["1x1", "7x9", "17x33", "40x24"])
def test_jpeg_kinds(tmp_path, size):
    """CMYK, 4:1:1 and 4:4:0 and the smoothed progressive file go to PIL;
    the multi-scan sequential files are the port's own decode, equal to
    PIL's."""
    img = fx.content(sum(size), *size)
    buf = io.BytesIO()
    PIL.Image.fromarray(img).convert("CMYK").save(buf, "JPEG", quality=85)
    cases = dict(fx.jpeg_cases(sum(size), *size), cmyk=buf.getvalue())
    for name, data in cases.items():
        assert_reads_as_jax_and_pil(_write(tmp_path, name + ".jpg", data))
    for name in ("multiscan_444", "multiscan_420", "multiscan_420_y_cbcr"):
        assert native.decode_jpeg(cases[name]).shape == size + (3,)


def test_multiscan_equals_its_one_scan_source(tmp_path):
    """A baseline file split into scans decodes as the file itself."""
    img = fx.content(5, 33, 47)
    for subsampling in (0, 1, 2):
        buf = io.BytesIO()
        PIL.Image.fromarray(img).save(buf, "JPEG", quality=90,
                                      subsampling=subsampling)
        for groups in ([[0], [1], [2]], [[1], [2], [0]], [[0], [1, 2]],
                       [[0, 2], [1]]):
            split = fx.split_scans(buf.getvalue(), groups)
            np.testing.assert_array_equal(native.decode_jpeg(split),
                                          native.decode_jpeg(buf.getvalue()))
            assert_reads_as_jax_and_pil(_write(tmp_path, "s.jpg", split))


# -- the readers built on it --------------------------------------------------

def _kinds(tmp_path) -> dict:
    """name -> path of one file of each kind `_load_image` is held on."""
    rng = np.random.RandomState(3)
    img = rng.randint(0, 256, (16, 20, 3), np.uint8)
    files = {}
    for name, mode in (("rgb.png", "RGB"), ("rgba.png", "RGBA"),
                       ("grey.png", "L"), ("photo.jpg", "RGB"),
                       ("photo.webp", "RGB")):
        im = PIL.Image.fromarray(img)
        if mode == "RGBA":
            im = PIL.Image.fromarray(np.dstack([img, img[:, :, 0]]))
        im.convert(mode).save(tmp_path / name)
        files[name] = str(tmp_path / name)
    PIL.Image.fromarray(img).quantize(20).save(tmp_path / "palette.png")
    files["palette.png"] = str(tmp_path / "palette.png")
    files["16bit.png"] = _write(tmp_path, "16bit.png",
                                fx.png_case("rgb_16bit", 4, 16, 20))
    return files


def test_load_image_matches_jax(tmp_path):
    """The damage metric's reader on every kind of file."""
    for name, path in _kinds(tmp_path).items():
        got = distances._load_image(path)
        assert got.shape == (16, 20, 3) and got.dtype == np.float32, name
        np.testing.assert_array_equal(got, jax_distances._load_image(path),
                                      err_msg=name)


def _url(data: bytes, kind: str) -> str:
    return f"data:image/{kind};base64," + base64.b64encode(data).decode()


def _url_cases() -> dict:
    rng = np.random.RandomState(9)
    mask = np.zeros((24, 30), np.uint8)
    mask[5:17, 8:25] = 255
    mask[rng.rand(24, 30) < 0.1] = 128
    rgb = np.dstack([mask, 255 - mask, rng.randint(0, 256, (24, 30))]
                    ).astype(np.uint8)
    jpg, pal = io.BytesIO(), io.BytesIO()
    PIL.Image.fromarray(rgb).save(jpg, "JPEG", quality=90)
    PIL.Image.fromarray(rgb).quantize(12).save(pal, "PNG")
    return {"png": _url(renormalize.encode_png(rgb), "png"),
            "palette_png": _url(pal.getvalue(), "png"),
            "jpeg": _url(jpg.getvalue(), "jpeg")}


@pytest.mark.parametrize("size", [None, (5, 9), (24, 30), (48, 17)],
                         ids=["none", "5x9", "24x30", "48x17"])
@pytest.mark.parametrize("kind", ["png", "palette_png", "jpeg"])
def test_data_urls_match_jax(kind, size):
    url = _url_cases()[kind]
    np.testing.assert_array_equal(
        renormalize.mask_from_url(url, size=size),
        jax_renormalize.mask_from_url(url, size=size))
    for target in ("zc", "pt", "imagenet", "byte"):
        got = renormalize.from_url(url, target, size=size)
        want = jax_renormalize.from_url(url, target, size=size)
        assert got.dtype == want.dtype, target
        np.testing.assert_array_equal(got, want, err_msg=target)
    if size is None:
        got = renormalize.from_url(url, "image")
        assert got.dtype == np.uint8 and got.shape == (24, 30, 3)
        np.testing.assert_array_equal(got, np.asarray(
            jax_renormalize.from_url(url, "image").convert("RGB")))
    data = base64.b64decode(url.split(",", 1)[1])
    with PIL.Image.open(io.BytesIO(data)) as im:
        for mode in ("RGB", "L"):     # from_image converts to RGB itself
            arr = native.decode_image(data, rgb=True)
            if mode == "L":
                arr = np.asarray(PIL.Image.fromarray(arr).convert("L"))
            np.testing.assert_array_equal(
                renormalize.from_image(arr, "zc", size),
                jax_renormalize.from_image(im.convert("RGB").convert(mode),
                                           "zc", size), err_msg=mode)


def test_is_empty_mask_matches_jax():
    blank = renormalize.mask_to_url(np.zeros((6, 7)))
    dot = np.zeros((6, 7))
    dot[2, 3] = 1
    for url in [blank, renormalize.mask_to_url(dot)] + list(
            _url_cases().values()):
        got = GanRewriter.is_empty_mask(None, url)
        assert got == JaxGanRewriter.is_empty_mask(None, url)
    assert GanRewriter.is_empty_mask(None, blank)


def test_parallel_image_folders_of_mixed_files(tmp_path):
    """A tree of PNG, JPEG, WebP and palette PNG files beside their
    labels: the port's arrays equal ``numpy.asarray`` of the JAX
    package's PIL images, in their own modes."""
    rng = np.random.RandomState(4)
    img, lab = tmp_path / "img", tmp_path / "lab"
    img.mkdir()
    lab.mkdir()
    for i, ext in enumerate((".png", ".jpg", ".webp", ".png", ".gif",
                             ".bmp")):
        pixels = rng.randint(0, 256, (10, 14, 3), np.uint8)
        im = PIL.Image.fromarray(pixels)
        if i == 3:
            im = im.quantize(9)
        im.save(img / f"{i}{ext}")
        labels = rng.randint(0, 5, (10, 14))
        (lab / f"{i}.png").write_bytes(fx.png_bytes(
            labels, 4, 3, palette=rng.randint(0, 256, (5, 3))))
    roots = [str(img), str(lab)]
    ds, jds = ParallelImageFolders(roots), JaxFolders(roots)
    assert len(ds) == len(jds) == 6 and ds.images == jds.images
    for i in range(6):
        for got, want in zip(ds[i], jds[i]):
            want = np.asarray(want)
            assert got.shape == want.shape and got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        assert ds[i][1].shape == (10, 14)       # palette indices


# -- without PIL, and corrupt data --------------------------------------------

def _png_of_raw(w: int, h: int, raw: bytes) -> bytes:
    """An 8-bit RGB PNG whose inflated image data is `raw`, as it is."""
    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def _corrupt_cases() -> dict:
    """name -> (bytes, what the message says) of truncated and corrupt PNG
    and JPEG data, which the port refuses without asking PIL."""
    rng = np.random.RandomState(2)
    png = renormalize.encode_png(rng.randint(0, 256, (20, 24, 3), np.uint8))
    idat = png.index(b"IDAT") + 4            # the zlib stream's start
    flipped = bytearray(png)
    flipped[idat + 40] ^= 0xFF
    with open(os.path.join(ROOT, "tests", "data", "jpeg",
                           "baseline_420_q75_256.jpg"), "rb") as f:
        jpg = f.read()
    sos = jpg.index(b"\xff\xda")
    start = sos + 2 + int.from_bytes(jpg[sos + 2:sos + 4], "big")
    return {
        "png_truncated": (png[:len(png) * 2 // 3], "truncated"),
        "png_corrupt_zlib": (bytes(flipped), "corrupt"),
        "png_bad_filter": (_png_of_raw(1, 1, b"\x09\0\0\0"),
                           "filter type 9"),
        "png_no_ihdr": (png[:8] + png[33:], "IHDR"),
        "png_short_ihdr": (png[:8] + b"\0\0\0\x05IHDR" + png[16:21]
                           + b"\0\0\0\0" + png[33:], "header"),
        "jpeg_truncated": (jpg[:len(jpg) // 2], "truncated"),
        "jpeg_bad_huffman_code": (jpg[:start] + b"\xff\x00\xff\x00"
                                  + jpg[start:], "Huffman code"),
    }


@pytest.mark.parametrize("case", list(_corrupt_cases()))
def test_corrupt_data_raises_without_asking_pil(tmp_path, monkeypatch, case):
    data, why = _corrupt_cases()[case]
    path = _write(tmp_path, case + (".png" if case[0] == "p" else ".jpg"),
                  data)

    def no_pil(*args):
        raise AssertionError("handed to PIL")

    monkeypatch.setattr(native, "_pil_decode", no_pil)
    for read in (native.read_image, native.read_image_rgb):
        with pytest.raises(ValueError, match=f"{re.escape(path)}.*{why}"):
            read(path)


_CHILD = """
import json, sys
blocked = sys.argv[1] == "blocked"
if blocked:
    sys.modules["PIL"] = None   # any import of PIL now raises ImportError
from rewriting_torch import native
out = {}
for path in sys.argv[2:]:
    try:
        out[path] = list(native.read_image_rgb(path).shape)
    except ValueError as e:
        out[path] = str(e)
out["PIL imported"] = any(n.split(".")[0] == "PIL" for n, m in
                          sys.modules.items() if m is not None)
print(json.dumps(out))
"""


def _child(blocked: bool, paths) -> dict:
    import json
    proc = subprocess.run([sys.executable, "-c", _CHILD,
                           "blocked" if blocked else "free"] + list(paths),
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout)


def test_without_pil(tmp_path):
    """With PIL blocked, 8-bit PNG and Huffman JPEG (one multi-scan) still
    read; any other file raises naming the file and PIL; corrupt PNG and
    JPEG raise as they do with PIL, which is never imported for them."""
    jpeg_dir = os.path.join(ROOT, "tests", "data", "jpeg")
    read = [os.path.join(jpeg_dir, "baseline_420_q75_256.jpg"),
            os.path.join(jpeg_dir, "baseline_420_q75_256.png"),
            os.path.join(IMAGES, "grey_alpha_8bit.png"),
            os.path.join(IMAGES, "multiscan_420.jpg")]
    by_pil = [os.path.join(IMAGES, n) for n in
              ("lossy.webp", "palette_4bit.png", "adam7_rgb_8bit.png",
               "ycc_411.jpg", "rgb.bmp")] + [CMYK]
    corrupt = {_write(tmp_path, case + (".png" if case[0] == "p"
                                        else ".jpg"), data): why
               for case, (data, why) in _corrupt_cases().items()}
    out = _child(True, read + by_pil + list(corrupt))
    assert out.pop("PIL imported") is False
    for path in read:
        assert out[path] == list(native.read_image_rgb(path).shape), path
    for path in by_pil:
        assert re.match(f"cannot read {re.escape(path)} .*PIL", out[path]), \
            out[path]
    for path, why in corrupt.items():
        assert re.match(f"cannot read {re.escape(path)} .*{why}",
                        out[path]), out[path]
    # PIL is importable and still never imported for these files
    out = _child(False, read + list(corrupt))
    assert out.pop("PIL imported") is False
    assert all(isinstance(v, str) for k, v in out.items() if k in corrupt)


# -- the last public names ----------------------------------------------------

def test_zdataset_names_match_jax():
    model = types.SimpleNamespace(z_dim=8)
    np.testing.assert_array_equal(zdataset.standard_y_sample(50, 7, seed=3),
                                  jax_zdataset.standard_y_sample(50, 7, 3))
    assert zdataset.standard_y_sample(5, 7).dtype == np.int64
    np.testing.assert_array_equal(zdataset.z_sample_for_model(model, 9, 2),
                                  jax_zdataset.z_sample_for_model(model, 9, 2))
    for indices in ([4, 0, 11], np.arange(3, 7)):
        np.testing.assert_array_equal(
            zdataset.z_dataset_for_model(model, indices=indices).zs,
            jax_zdataset.z_dataset_for_model(model, indices=indices).zs)
    zds = zdataset.z_dataset_for_model(model, 11)
    jzds = jax_zdataset.z_dataset_for_model(model, 11)
    for pad in (False, True):
        got, want = list(zds.batches(4, pad)), list(jzds.batches(4, pad))
        assert [v for _, v in got] == [v for _, v in want] == [4, 4, 3]
        for (a, _), (b, _) in zip(got, want):
            np.testing.assert_array_equal(a, b)
    train = zdataset.training_loader(model, 4, epoch_size=10)
    jtrain = jax_zdataset.training_loader(model, 4, epoch_size=10)
    for _ in range(7):      # into the second epoch
        np.testing.assert_array_equal(next(train), next(jtrain))
    for a, b in zip(zdataset.testing_loader(model, 8, 20),
                    jax_zdataset.testing_loader(model, 8, 20)):
        np.testing.assert_array_equal(a, b)
    assert sum(len(b) for b in zdataset.testing_loader(model, 8, 20)) == 20
    groups = zdataset.epoch_grouper(range(7), 3)
    jgroups = jax_zdataset.epoch_grouper(range(7), 3)
    assert [list(g) for g in groups] == [list(g) for g in jgroups] == \
        [[0, 1, 2], [3, 4, 5], [6]]


@pytest.fixture(scope="module")
def pair():
    jm = JaxSeqStyleGAN2(16, style_dim=32, n_mlp=2)
    jp = jm.init_params(jax.random.PRNGKey(5))
    tm = SeqStyleGAN2(16, style_dim=32, n_mlp=2, device="cpu")
    tp = params_from_jax(tm, jax.tree_util.tree_map(np.asarray, jp))
    return jm, jp, tm, tp


def test_apply_bag_matches_jax(pair):
    jm, jp, tm, tp = pair
    z = np.random.RandomState(6).randn(2, 32).astype(np.float32)
    jbag = jax_bag(latent=jnp.asarray(z))
    jbag.update(jm.prepare_noise(2))
    want = np.asarray(jm.apply_bag(jp, jbag)["output"])
    with torch.no_grad():
        out = tm.apply_bag(tp, tm.make_bag(z))
        seq = tm.pipeline(tp, tm.make_bag(z))["output"]
    assert isinstance(out, DataBag)
    np.testing.assert_array_equal(out["output"].numpy(), seq.numpy())
    np.testing.assert_allclose(out["output"].permute(0, 2, 3, 1).numpy(),
                               want, atol=1e-4, rtol=0)


def test_param_names_and_subsequence_match_jax(pair):
    jm, jp, tm, tp = pair
    assert tm.pipeline.param_names(tp) == jm.pipeline.param_names(jp)
    for query in (dict(upto_layer="layer4.sconv.mconv.dconv"),
                  dict(first_layer="layer3", last_layer="layer4"),
                  dict(after_layer="layer4.sconv.activate")):
        got = subsequence(tm.pipeline, **query)
        want = jax_subsequence(jm.pipeline, **query)
        assert got.stage_names() == want.stage_names() == \
            tm.pipeline.subsequence(**query).stage_names()
        assert got.param_names(tp) == want.param_names(jp)
        assert set(got.param_names(tp)) <= set(tp)
    with pytest.raises(ValueError):
        subsequence(tm.pipeline, first_layer="layer4", upto_layer="layer3")


def test_bag_matches_jax():
    got, want = bag(latent=1, fmap=2), jax_bag(latent=1, fmap=2)
    assert isinstance(got, DataBag) and dict(got) == dict(want)
    assert got.fmap == 2 and bag() == {}


UPFIRDN_CASES = {
    "up_y": dict(up_y=2),
    "up_x_down_y": dict(up_x=3, down_y=2, pad_x=(2, 1)),
    "crop": dict(down_x=2, pad_x=(-1, 2), pad_y=(1, -2)),
    "all": dict(up_x=2, up_y=3, down_x=3, down_y=2, pad_x=(1, 2),
                pad_y=(3, 0)),
}


@pytest.mark.parametrize("case", list(UPFIRDN_CASES))
def test_upfirdn2d_general_matches_jax(case):
    kw = UPFIRDN_CASES[case]
    rng = np.random.RandomState(len(case))
    x = rng.randn(2, 3, 9, 11).astype(np.float32)
    kernel = rng.rand(4, 3).astype(np.float32)
    got = upfirdn2d_general(torch.from_numpy(x), kernel, **kw).numpy()
    want = np.asarray(jax_upfirdn2d_general(
        jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(kernel), **kw))
    assert got.transpose(0, 2, 3, 1).shape == want.shape
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), want, atol=1e-5,
                               rtol=0)
    square = rng.rand(3, 3).astype(np.float32)
    np.testing.assert_array_equal(
        upfirdn2d(torch.from_numpy(x), square, up=2, down=1,
                  pad=(1, -1)).numpy(),
        upfirdn2d_general(torch.from_numpy(x), square, up_x=2, up_y=2,
                          pad_x=(1, -1), pad_y=(1, -1)).numpy())

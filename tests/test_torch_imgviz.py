"""The port's image helpers against the JAX package's: ``utils/upsample``
(numpy on both sides: exact), ``renormalize.as_image``/``as_url``/
``mask_to_url``, ``utils/imgviz`` and the rewriter's renders.

The port returns ``uint8 (H, W, 3)`` numpy arrays where the JAX package
returns PIL images; each is compared with ``np.asarray`` of the JAX
image.  Limits: the helpers on the same input are exact; the renders come
from two forwards that sum in other orders, so a pixel may differ by 1
LSB (the uint8 cast, as in tests/test_torch_sample.py), and an outline
drawn where a heatmap crosses its level may move by a pixel where the two
heatmaps straddle it (at most 1% of the pixels; measured 0).
"""

import base64
import io

import jax
import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

from rewriting_tpu.models.stylegan2 import SeqStyleGAN2 as JaxSeqStyleGAN2
from rewriting_tpu.rewrite import SeqStyleGanRewriter as JaxRewriter
from rewriting_tpu.utils import imgviz as jax_imgviz
from rewriting_tpu.utils import renormalize as jax_renormalize
from rewriting_tpu.utils import upsample as jax_upsample
from rewriting_tpu.utils.zdataset import z_dataset_for_model as jax_zds
from rewriting_torch.convert import params_from_jax
from rewriting_torch.models.stylegan2 import SeqStyleGAN2
from rewriting_torch.rewrite import SeqStyleGanRewriter
from rewriting_torch.utils import imgviz, renormalize, upsample
from rewriting_torch.utils.zdataset import z_dataset_for_model

torch.set_num_threads(1)


def _pil(url):
    data = base64.b64decode(url.split(",", 1)[1])
    return np.asarray(PIL.Image.open(io.BytesIO(data)).convert("RGB"))


def _image(seed, h=12, w=10):
    return np.random.RandomState(seed).uniform(-1.2, 1.2, (h, w, 3)).astype(
        np.float32)


def _lsb(a, b):
    return int(np.abs(np.asarray(a, np.int16)
                      - np.asarray(b, np.int16)).max())


# ---------------------------------------------------------------------------
# utils/upsample.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,target,so", [
    ((5, 7), (16, 20), None), ((5, 7, 3), (9, 9), None),
    ((4, 4), (16, 16), ((4.0, 1.5), (4.0, 1.5))),
    ((8, 8), (4, 4), None), ((1, 1), (3, 3), None), ((3, 9), (7, 2), None),
    ((6, 5, 2), (12, 10), ((2.0, 0.5), (2.0, 0.5))),
    ((4, 4, 1), (16, 16), ((4.0, 1.5), (4.0, 1.5))),
    ((4, 4), (16, 16), ((8.0, 3.5), (2.0, 1.5)))])
def test_resize_bilinear_matches_jax(shape, target, so):
    data = np.random.RandomState(1).randn(*shape).astype(np.float32)
    got = upsample.resize_bilinear(data, target, so)
    np.testing.assert_array_equal(
        got, jax_upsample.resize_bilinear(data, target, so))


# ---------------------------------------------------------------------------
# renormalize: as_image, as_url, mask_to_url
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("source", ["zc", "pt"])
def test_as_image_matches_jax(source):
    img = _image(3)
    if source == "pt":
        img = (img + 1) / 2
    got = renormalize.as_image(img, source)
    assert got.dtype == np.uint8 and got.shape == img.shape
    np.testing.assert_array_equal(
        got, np.asarray(jax_renormalize.as_image(img, source)))


@pytest.mark.parametrize("size", [None, (7, 5), (20, 24)])
def test_as_url_matches_jax(size):
    """The data URLs decode (with PIL) to the same pixels; a resize is
    PIL's BILINEAR, as the JAX package's."""
    img = _image(4)
    got = renormalize.as_url(img, size=size)
    assert got.startswith("data:image/png;base64,")
    np.testing.assert_array_equal(_pil(got),
                                  _pil(jax_renormalize.as_url(img,
                                                              size=size)))
    # a uint8 image is taken as it is
    byte = renormalize.as_image(img)
    np.testing.assert_array_equal(_pil(renormalize.as_url(byte)), byte)


def test_mask_to_url_round_trip_matches_jax():
    mask = np.zeros((16, 16), np.float32)
    mask[3:9, 5:12] = 1.0
    mask[10, 2] = 0.5
    got = renormalize.mask_to_url(mask)
    want = jax_renormalize.mask_to_url(mask)
    np.testing.assert_array_equal(_pil(got), _pil(want))
    np.testing.assert_array_equal(renormalize.mask_from_url(got, (8, 8)),
                                  jax_renormalize.mask_from_url(want, (8, 8)))


# ---------------------------------------------------------------------------
# utils/imgviz.py
# ---------------------------------------------------------------------------

@pytest.fixture
def iv_pair():
    return imgviz.ImageVisualizer((16, 20)), \
        jax_imgviz.ImageVisualizer((16, 20))


def test_image_and_heatmap_match_jax(iv_pair):
    iv, jiv = iv_pair
    img = _image(5)
    acts = np.random.RandomState(6).rand(4, 5, 7).astype(np.float32)
    np.testing.assert_array_equal(iv.image(img), np.asarray(jiv.image(img)))
    for unit, mode in ((2, "bilinear"), (0, "nearest")):
        got = iv.heatmap(acts, unit=unit, mode=mode)
        assert got.dtype == np.uint8 and got.shape == (16, 20, 3)
        np.testing.assert_array_equal(
            got, np.asarray(jiv.heatmap(acts, unit=unit, mode=mode)))
    assert iv.level_for(acts, unit=1) == jiv.level_for(acts, unit=1)
    assert iv.range_for(acts, unit=1) == jiv.range_for(acts, unit=1)


@pytest.mark.parametrize("kw", [
    {"level": 0.5}, {"percent_level": 0.8}, {"unit": 3},
    {"border_color": (255, 0, 0), "thickness": 3, "outside_bright": 1.0}])
def test_masked_image_matches_jax(iv_pair, kw):
    iv, jiv = iv_pair
    img = _image(7)
    acts = np.random.RandomState(8).rand(6, 5, 4).astype(np.float32)
    if "unit" not in kw:
        acts = acts[..., 0]
    got = iv.masked_image(img, activations=acts, **kw)
    np.testing.assert_array_equal(
        got, np.asarray(jiv.masked_image(img, activations=acts, **kw)))
    mask = np.zeros((4, 5), np.float32)
    mask[1:3, 2:4] = 1
    np.testing.assert_array_equal(
        iv.masked_image(img, mask=mask),
        np.asarray(jiv.masked_image(img, mask=mask)))
    delta = np.random.RandomState(9).randn(6, 5, 3).astype(np.float32)
    np.testing.assert_array_equal(
        iv.masked_delta(img, delta, level=1.0),
        np.asarray(jiv.masked_delta(img, delta, level=1.0)))


def test_grids_match_jax(iv_pair):
    iv, jiv = iv_pair
    images = [_image(s) for s in range(3)]
    acts = np.random.RandomState(10).rand(3, 4, 4, 5).astype(np.float32)
    got = iv.masked_images_for_topk(images, acts, [2, 0], unit=1)
    want = jiv.masked_images_for_topk(images, acts, [2, 0], unit=1)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    small = renormalize.as_image(_image(11, 10, 6))
    row = iv.image_row(got + [small], gap=4)
    jrow = jiv.image_row(want + [PIL.Image.fromarray(small)], gap=4)
    np.testing.assert_array_equal(row, np.asarray(jrow))
    cells = imgviz.strip_image_from_grid_row(row, gap=4)
    jcells = jax_imgviz.strip_image_from_grid_row(jrow, gap=4)
    assert len(cells) == len(jcells)
    for g, w in zip(cells, jcells):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert imgviz.strip_image_from_grid_row(np.full((3, 4, 3), 255,
                                                    np.uint8)) == []


def test_border_from_mask_matches_jax():
    m = np.zeros((9, 9), bool)
    m[2:6, 3:7] = True
    for outside in (True, False):
        np.testing.assert_array_equal(
            imgviz.border_from_mask(m, 2, outside),
            jax_imgviz.border_from_mask(m, 2, outside))


# ---------------------------------------------------------------------------
# The rewriter's renders
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rewriters():
    jm = JaxSeqStyleGAN2(16, style_dim=64, n_mlp=2)
    jp = jm.init_params(jax.random.PRNGKey(31))
    tm = SeqStyleGAN2(16, style_dim=64, n_mlp=2, device="cpu")
    tp = params_from_jax(tm, jax.tree_util.tree_map(np.asarray, jp))
    jr = JaxRewriter(jm, jp, jax_zds(jm, 40), layernum=4,
                     stats_batch_size=20)
    tr = SeqStyleGanRewriter(tm, tp, z_dataset_for_model(tm, 40),
                             layernum=4, stats_batch_size=20, device="cpu")
    return jr, tr


def _assert_render(got, want, outline=False):
    want = np.asarray(want)
    assert got.dtype == np.uint8 and got.shape == want.shape == (16, 16, 3)
    if outline:
        moved = (np.abs(got.astype(np.int16) - want).max(-1) > 1).mean()
        assert moved <= 0.01
    else:
        assert _lsb(got, want) <= 1


def test_render_image_matches_jax(rewriters):
    jr, tr = rewriters
    _assert_render(tr.render_image(3), jr.render_image(3))


def test_render_image_batch_matches_jax(rewriters):
    """Plain, and with a key's response outlined at a level (the UI's
    search highlight), over two batches."""
    jr, tr = rewriters
    nums = [0, 5, 7, 11, 2]
    got = tr.render_image_batch(nums, batch_size=3)
    want = jr.render_image_batch(nums, batch_size=3)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        _assert_render(g, w)
    key = np.random.RandomState(12).randn(tr.k_shape[-1]).astype(np.float32)
    key /= np.linalg.norm(key)
    got = tr.render_image_batch(nums, key=torch.from_numpy(key), level=0.3,
                                batch_size=3)
    want = jr.render_image_batch(nums, key=jnp.asarray(key), level=0.3,
                                 batch_size=3)
    for g, w in zip(got, want):
        _assert_render(g, w, outline=True)


def test_render_object_matches_jax(rewriters):
    """The target bag of an object selection, rendered plain and with its
    box outlined in red."""
    jr, tr = rewriters
    mask = np.zeros((16, 16), np.float32)
    mask[4:12, 6:14] = 1.0
    url = renormalize.mask_to_url(mask)
    got = tr.object_from_selection(1, url)
    want = jr.object_from_selection(1, url)
    assert got[3] == want[3]
    _assert_render(tr.render_object(got[1]), jr.render_object(want[1]))
    boxed = tr.render_object(got[1], box=got[3])
    _assert_render(boxed, jr.render_object(want[1], box=want[3]))
    assert (boxed == np.array([255, 0, 0], np.uint8)).all(-1).any()

"""The port's Neural Best Buddies baseline (``rewriting_torch.baselines``)
against the JAX package's, on the CPU.

- The golden: ``sparse_correspondence`` and ``top_k_in_clusters`` on
  tests/goldens/nbb_correspondence.npz's pyramids (the reference
  algorithm's own run): points equal, responses within 1e-5.
- The primitives on the same seeded numpy inputs: ``find_mapping`` equal
  wherever its float64 top-two margin exceeds 1e-5 (the count under it is
  asserted); ``find_best_buddies``, ``upsample_mapping`` (exact and odd
  shapes), ``get_M``, ``extract_receptive_field`` and
  ``mutual_nearest_neighbors`` equal; ``warp``, ``warp_to_mid`` and
  ``default_reconstruct`` within 1e-6 of max.
- ``sparse_correspondence`` on small pyramids at VGG16's channel ratios,
  with ``k_per_level`` None and 4, with scikit-learn hidden from both
  packages (the Lloyd fallback), on odd-size and non-square pyramids:
  points equal, responses within 1e-5.
- End to end, ``neural_best_buddies`` and ``nbb_paste`` at 32-48 px: the
  port on its default pyramid, the JAX package on a ``feature_fn`` of the
  same ``lpips.init_params(0)`` weights: pairs equal, the pasted image
  within 1e-6, ``mls_warp`` and ``poisson_blend`` within 1e-9; under 16
  px both raise ValueError.
- ``nbbviz``: drawn arrays byte-equal, ``save_correspondence``'s PNGs
  decode to them, ``check_missing``'s lists equal.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rewriting_tpu.baselines import nbb as jnbb
from rewriting_tpu.baselines import nbbviz as jviz
from rewriting_tpu.metrics import lpips as jax_lpips
from rewriting_torch.baselines import nbb, nbbviz
from rewriting_torch.metrics import lpips
from rewriting_torch.utils.renormalize import decode_png

torch.set_num_threads(1)

MARGIN = 1e-5       # find_mapping's candidates closer than this may swap
RESP_TOL = 1e-5     # accumulated responses, absolute
CLOSE = 1e-6        # warps, reconstructions, the pasted image: of max
HOST_TOL = 1e-9     # mls_warp, poisson_blend (the same host numpy)

VGG_RATIOS = (1, 2, 4, 8, 8)    # relu1_2 .. relu5_3 widths over 64


def t(x):
    return torch.as_tensor(np.asarray(x))


def close(got, want, rel=CLOSE):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0)


def vgg_like(rng, h, w, c, zero_share=0.2):
    """Rectified seeded normals with a share of all-zero positions (the
    exact ties of VGG's ReLU zeros)."""
    f = np.maximum(rng.randn(h, w, c), 0).astype(np.float32)
    f[rng.rand(h, w) < zero_share] = 0
    return f


def pyramid(rng, h, w, base=4, levels=5, bias=0.0):
    return [vgg_like(rng, max(1, h >> i), max(1, w >> i),
                     base * VGG_RATIOS[i]) + np.float32(bias)
            for i in range(levels)]


def assert_same_correspondence(got, want):
    assert len(got[0]) == len(want[0])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], atol=RESP_TOL, rtol=0)
    assert got[0].dtype == np.int64 and got[2].dtype == np.float32


# ---------------------------------------------------------------------------
# the golden
# ---------------------------------------------------------------------------

def test_golden_correspondence(goldens):
    pytest.importorskip("sklearn")
    g = goldens("nbb_correspondence")
    pyr_a = [g[f"pyr_a_{i}"] for i in range(1, 6)]
    pyr_b = [g[f"pyr_b_{i}"] for i in range(1, 6)]
    pa, pb, resp = nbb.sparse_correspondence(
        pyr_a, pyr_b, tau=float(g["tau"]),
        k_per_level=int(g["k_per_level"]), border=int(g["border"]),
        device="cpu")
    assert_same_correspondence((pa, pb, resp),
                               (g["pts_a"], g["pts_b"], g["resp"]))
    ta, tb, tr = nbb.top_k_in_clusters(pa, pb, resp, int(g["k_final"]))
    np.testing.assert_array_equal(ta, g["top_a"])
    np.testing.assert_array_equal(tb, g["top_b"])
    np.testing.assert_allclose(tr, g["top_resp"], atol=RESP_TOL, rtol=0)


# ---------------------------------------------------------------------------
# the primitives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,w,c,patch,radius", [
    (12, 12, 16, 5, 3), (9, 14, 24, 3, 2), (1, 1, 8, 3, 2), (2, 5, 8, 5, 3)])
def test_find_mapping(h, w, c, patch, radius):
    rng = np.random.RandomState(h * 100 + w)
    A = vgg_like(rng, h, w, c)
    A[:h // 2, :w // 2] = 0     # whole zero patches: exact ties
    A = jnbb.normalize_per_pix(A)
    B = jnbb.normalize_per_pix(vgg_like(rng, h, w, c))
    init = np.stack([np.clip(np.mgrid[0:h, 0:w][i]
                             + rng.randint(-2, 3, (h, w)), 0, (h, w)[i] - 1)
                     for i in range(2)], axis=-1)
    want = jnbb.find_mapping(A, B, patch, init, radius)
    got = nbb.find_mapping(t(A), t(B), patch, t(init), radius)
    assert got.dtype == torch.int64 and tuple(got.shape) == (h, w, 2)
    _, margin = nbb.mapping_margin(t(A).double(), t(B).double(), patch,
                                   t(init), radius)
    wide = (margin > MARGIN).numpy()
    np.testing.assert_array_equal(got.numpy()[wide], want[wide])
    # the narrow positions are the zero patches' exact ties (margin 0),
    # which both packages break to the first candidate
    narrow = ~wide
    assert (margin.numpy()[narrow] == 0).all()
    np.testing.assert_array_equal(got.numpy()[narrow], want[narrow])
    if min(h, w) >= 9:
        assert 0 < narrow.sum() < wide.sum()


def test_find_best_buddies_and_fields():
    rng = np.random.RandomState(7)
    h, w = 9, 11
    a2b = np.stack([rng.randint(0, h, (h, w)), rng.randint(0, w, (h, w))],
                   axis=-1)
    b2a = a2b.copy()
    # make some cycles: b2a[a2b[p]] = p at a third of the positions
    for y, x in zip(*np.nonzero(rng.rand(h, w) < 0.33)):
        b2a[a2b[y, x, 0], a2b[y, x, 1]] = (y, x)
    for boxes in ((None, None), (([1, 2], [7, 9]), ([0, 3], [8, 10]))):
        want = jnbb.find_best_buddies(a2b, b2a, *boxes)
        got = nbb.find_best_buddies(t(a2b), t(b2a), *boxes)
        assert len(want[0]) > 0
        for g, wnt in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), wnt)
    for y, x, r in ((0, 0, 3), (4, 5, 2), (8, 10, 3)):
        assert (nbb.extract_receptive_field(y, x, r, (h, w))
                == jnbb.extract_receptive_field(y, x, r, (h, w)))


@pytest.mark.parametrize("src,shape", [((5, 6), None), ((5, 6), (10, 12)),
                                        ((4, 4), (9, 9)), ((9, 9), (18, 19)),
                                        ((2, 3), (5, 7))])
def test_upsample_mapping(src, shape):
    rng = np.random.RandomState(src[0] * 10 + src[1])
    m = np.stack([rng.randint(0, src[0], src), rng.randint(0, src[1], src)],
                 axis=-1)
    want = jnbb.upsample_mapping(m, shape=shape)
    got = nbb.upsample_mapping(t(m), shape=shape)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_masks_and_responses():
    rng = np.random.RandomState(9)
    F = vgg_like(rng, 13, 10, 32)
    for tau in (0.0, 0.05, 0.3):
        np.testing.assert_array_equal(nbb.get_M(t(F), tau).numpy(),
                                      jnbb.get_M(F, tau))
    close(nbb._stretch01(nbb.response_l2(t(F))),
          jnbb._stretch01(jnbb.response_l2(F)))
    close(nbb.normalize_per_pix(t(F)), jnbb.normalize_per_pix(F))
    flat = np.ones((4, 4, 3), np.float32)
    assert not nbb.get_M(t(flat)).any() and not jnbb.get_M(flat).any()
    np.testing.assert_array_equal(nbb.identity_map(3, 5).numpy(),
                                  jnbb.identity_map(3, 5))


@pytest.mark.parametrize("patch", [1, 3, 5])
def test_warps(patch):
    rng = np.random.RandomState(patch)
    h, w, c = 10, 7, 6
    A = rng.rand(h, w, c).astype(np.float32)
    B = rng.rand(h, w, c).astype(np.float32)
    m = np.stack([rng.randint(0, h, (h, w)), rng.randint(0, w, (h, w))],
                 axis=-1)
    close(nbb.warp(t(B), patch, t(m)), jnbb.warp(B, patch, m))
    close(nbb.warp_to_mid(t(B), t(A), patch, t(m)),
          jnbb.warp_to_mid(B, A, patch, m))


@pytest.mark.parametrize("src,dst,shape", [(5, 4, None), (3, 2, (9, 7)),
                                           (5, 3, None)])
def test_default_reconstruct(src, dst, shape):
    rng = np.random.RandomState(src * 10 + dst)
    F = vgg_like(rng, 4, 3, 16)
    want = jnbb.default_reconstruct(F, src, dst, 8, seed=3, out_shape=shape)
    got = nbb.default_reconstruct(t(F), src, dst, 8, seed=3, out_shape=shape)
    close(got, want)
    # a legacy reconstruct_fn without out_shape is fitted either way
    def legacy(F, s, d, c):
        return jnbb.default_reconstruct(np.asarray(F), s, d, c)
    close(nbb._call_reconstruct(legacy, t(F), src, dst, 8, (7, 5)),
          jnbb._call_reconstruct(legacy, F, src, dst, 8, (7, 5)))


def test_mutual_nearest_neighbors():
    rng = np.random.RandomState(0)
    fa = rng.randn(6, 7, 8).astype(np.float32)
    fb = np.roll(fa, 2, axis=1) + 0.3 * rng.randn(6, 7, 8).astype(np.float32)
    want = jnbb.mutual_nearest_neighbors(fa, fb)
    got = nbb.mutual_nearest_neighbors(fa, fb, device="cpu")
    assert len(want) > 10 and got == [(int(a), int(b)) for a, b in want]
    assert len(nbb.mutual_nearest_neighbors(fa, fa, device="cpu")) == 42


def test_top_k_in_clusters_keeps_types():
    rng = np.random.RandomState(1)
    pa = rng.randint(0, 30, (40, 2))
    pb = rng.randint(0, 30, (40, 2))
    resp = rng.rand(40).astype(np.float32)
    pytest.importorskip("sklearn")
    want = jnbb.top_k_in_clusters(pa, pb, resp, 6)
    got = nbb.top_k_in_clusters(pa, pb, resp, 6)
    as_tensors = nbb.top_k_in_clusters(t(pa), t(pb), t(resp), 6)
    for g, tt, wnt in zip(got, as_tensors, want):
        np.testing.assert_array_equal(g, wnt)
        np.testing.assert_array_equal(tt.numpy(), wnt)
    # k over n keeps every pair, in order
    assert nbb.top_k_in_clusters(pa, pb, resp, 41)[0] is pa


# ---------------------------------------------------------------------------
# sparse_correspondence
# ---------------------------------------------------------------------------

@pytest.fixture
def no_sklearn(monkeypatch):
    """Both packages take the Lloyd fallback."""
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.cluster", None)


@pytest.mark.parametrize("k_per_level", [None, 4])
@pytest.mark.parametrize("size", [(32, 32), (36, 36), (24, 40)],
                         ids=["32", "odd36", "24x40"])
def test_sparse_correspondence(size, k_per_level):
    if k_per_level is not None:
        pytest.importorskip("sklearn")
    rng = np.random.RandomState(size[0] + size[1])
    pyr_a = pyramid(rng, *size)
    pyr_b = [np.roll(f, 1, axis=1) for f in pyr_a]
    pyr_b = [f + 0.1 * vgg_like(rng, *f.shape) for f in pyr_b]
    want = jnbb.sparse_correspondence(pyr_a, pyr_b, k_per_level=k_per_level,
                                      border=2)
    got = nbb.sparse_correspondence(pyr_a, pyr_b, k_per_level=k_per_level,
                                    border=2, device="cpu")
    assert len(want[0]) > (2 if k_per_level else 40)
    assert_same_correspondence(got, want)


def test_sparse_correspondence_lloyd_fallback(no_sklearn):
    with pytest.raises(ImportError):
        from sklearn.cluster import KMeans  # noqa: F401
    rng = np.random.RandomState(5)
    pyr_a = pyramid(rng, 32, 32)
    pyr_b = [f + 0.2 * vgg_like(rng, *f.shape) for f in pyr_a]
    want = jnbb.sparse_correspondence(pyr_a, pyr_b, k_per_level=5, border=2)
    got = nbb.sparse_correspondence(pyr_a, pyr_b, k_per_level=5, border=2,
                                    device="cpu")
    assert len(want[0]) > 2
    assert_same_correspondence(got, want)
    want_top = jnbb.top_k_in_clusters(*want, 3)
    got_top = nbb.top_k_in_clusters(*got, 3)
    for g, wnt in zip(got_top[:2], want_top[:2]):
        np.testing.assert_array_equal(g, wnt)


def test_nonsquare_keeps_right_half():
    """As tests/test_nbb.py holds the JAX package: on a landscape pyramid
    the right half survives the per-axis border filter."""
    rng = np.random.RandomState(4)
    h, w = 16, 32
    pyr = [rng.rand(h // 2 ** i, w // 2 ** i, 8).astype(np.float32) + 0.3
           for i in range(3)]
    want = jnbb.sparse_correspondence(pyr, pyr, tau=0.0, border=2)
    got = nbb.sparse_correspondence(pyr, pyr, tau=0.0, border=2,
                                    device="cpu")
    assert_same_correspondence(got, want)
    pa, pb, _ = got
    np.testing.assert_array_equal(pa, pb)
    assert pa[:, 1].max() > h
    assert pa[:, 1].max() <= w - 2 and pa[:, 0].max() <= h - 2


def test_refinement_in_chunks(monkeypatch):
    """The refinement and find_mapping cut into the smallest chunks give
    the same result."""
    rng = np.random.RandomState(11)
    pyr_a = pyramid(rng, 32, 32)
    pyr_b = [f + 0.1 * vgg_like(rng, *f.shape) for f in pyr_a]
    whole = nbb.sparse_correspondence(pyr_a, pyr_b, border=2, device="cpu")
    monkeypatch.setattr(nbb, "_REFINE_CANDIDATES", 1)
    monkeypatch.setattr(nbb, "_GATHER_BYTES", 1)
    stats = {}
    cut = nbb.sparse_correspondence(pyr_a, pyr_b, border=2, device="cpu",
                                    stats=stats)
    for g, wnt in zip(cut, whole):
        np.testing.assert_array_equal(g, wnt)
    levels = stats["levels"]
    assert [lv["level"] for lv in levels] == [5, 4, 3, 2, 1]
    assert levels[0]["parents"] == 0
    for lv in levels[1:]:
        assert lv["parents"] > 0 and lv["children"] >= lv["kept"]
    assert levels[-1]["mapping"]["a2b"].shape == (32, 32, 2)


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_feature_fn():
    params = jax.tree_util.tree_map(lambda v: jnp.asarray(v.numpy()),
                                    lpips.init_params(0))

    def fn(images):
        x = (np.asarray(images, np.float32) - jax_lpips._SHIFT) \
            / jax_lpips._SCALE
        return [np.asarray(f) for f in jax_lpips.vgg16_taps(params, x)]
    return fn


def smooth_images(seed, size):
    """Two zc images, b a shifted and re-noised copy of a."""
    rng = np.random.RandomState(seed)
    coarse = rng.uniform(-1, 1, (size // 4 + 2, size // 4 + 2, 3))
    a = coarse.repeat(4, 0).repeat(4, 1)[:size, :size]
    b = np.roll(a, 3, axis=1) + 0.05 * rng.randn(size, size, 3)
    return a.astype(np.float32), np.clip(b, -1, 1).astype(np.float32)


def test_default_feature_pyramid(jax_feature_fn):
    a, b = smooth_images(0, 40)
    imgs = np.stack([a, b])
    got = nbb.default_feature_pyramid(imgs, device="cpu")
    want = jax_feature_fn(imgs)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, wnt in zip(got, want):
        close(g, wnt, rel=1e-5)


@pytest.mark.parametrize("size", [12, 14])
def test_small_images_raise(size, jax_feature_fn):
    """Under 16 pixels relu5_3's map is empty: the JAX package fails on
    it with ValueError (numpy's reflect pad), the port names the size."""
    img = np.zeros((1, size, size, 3), np.float32)
    with pytest.raises(ValueError):
        jnbb.neural_best_buddies(img, img, k=2, feature_fn=jax_feature_fn)
    with pytest.raises(ValueError, match=f"{size}x{size} pixels"):
        nbb.neural_best_buddies(img, img, k=2, device="cpu")


@pytest.mark.parametrize("size", [32, 48])
def test_neural_best_buddies(size, jax_feature_fn):
    a, b = smooth_images(size, size)
    want = jnbb.neural_best_buddies(a[None], b[None], k=6,
                                    feature_fn=jax_feature_fn)
    stats = {}
    got = nbb.neural_best_buddies(a[None], b[None], k=6, device="cpu",
                                  stats=stats)
    assert len(want) > 0 and got == [((int(p[0][0]), int(p[0][1])),
                                      (int(p[1][0]), int(p[1][1])))
                                     for p in want]
    assert len(stats["levels"]) == 5 and stats["pairs"] >= len(got)
    # a tensor feature_fn on the port's side gives the same
    fn = lambda imgs: nbb.default_feature_pyramid(imgs, device="cpu")
    assert nbb.neural_best_buddies(t(a[None]), t(b[None]), k=6,
                                   feature_fn=fn, device="cpu") == got


def test_nbb_paste(jax_feature_fn):
    a, b = smooth_images(3, 40)
    mask = np.zeros((40, 40), np.float32)
    mask[10:26, 8:22] = 1
    want, want_pairs = jnbb.nbb_paste(a, b, mask, k=6,
                                      feature_fn=jax_feature_fn)
    stats = {}
    got, pairs = nbb.nbb_paste(a, b, mask, k=6, device="cpu", stats=stats)
    assert len(pairs) > 2 and pairs == [tuple(tuple(int(v) for v in q)
                                              for q in p)
                                        for p in want_pairs]
    assert got.dtype == np.float64
    close(got, want)
    assert {"pyramid_s", "top_k_s", "mls_s", "poisson_s"} <= set(stats)
    # the host stages, on the same points
    src = [p[0] for p in pairs]
    dst = [p[1] for p in pairs]
    warped = nbb.mls_warp(a, src, dst)
    close(warped, jnbb.mls_warp(a, src, dst), rel=HOST_TOL)
    wmask = nbb.mls_warp(mask[..., None], src, dst)[..., 0] > 0.5
    close(nbb.poisson_blend(b, warped, wmask),
          jnbb.poisson_blend(b, warped, wmask), rel=HOST_TOL)


# ---------------------------------------------------------------------------
# nbbviz
# ---------------------------------------------------------------------------

def test_nbbviz_draws_as_the_jax_package(tmp_path):
    rng = np.random.RandomState(2)
    a = rng.randint(0, 256, (24, 30, 3)).astype(np.uint8)
    b = rng.randint(0, 256, (24, 30, 3)).astype(np.uint8)
    pairs = [((3, 4), (5, 6)), ((20, 29), (0, 0)), ((12, 1), (23, 15)),
             ((7, 7), (7, 7)), ((0, 15), (11, 28)), ((18, 9), (2, 20)),
             ((9, 22), (16, 3))]
    for i in (0, 4, 5, 9):
        np.testing.assert_array_equal(nbbviz.color_map(i), jviz.color_map(i))
    for level in (0, 1, 2, 3, 4):
        for got, want in zip(nbbviz.draw_correspondence(a, b, pairs, level),
                             jviz.draw_correspondence(a, b, pairs, level)):
            assert got.dtype == np.uint8 and np.array_equal(got, want)
        np.testing.assert_array_equal(
            nbbviz.draw_points(a, [p[0] for p in pairs], level=level),
            jviz.draw_points(a, [p[0] for p in pairs], level=level))
    np.testing.assert_array_equal(
        nbbviz.draw_points(a, [p[1] for p in pairs], unicolor=True),
        jviz.draw_points(a, [p[1] for p in pairs], unicolor=True))
    for center in ((0, 0), (23, 29), (-3, 40), (12, 15)):
        for fn in ("draw_dot", "draw_square", "draw_circle"):
            np.testing.assert_array_equal(
                getattr(nbbviz, fn)(a, center, [9, 8, 7]),
                getattr(jviz, fn)(a, center, [9, 8, 7]))
    out = tmp_path / "viz"
    nbbviz.save_correspondence(a, b, pairs, str(out), level=3, name="_x")
    want_a, want_b = jviz.draw_correspondence(a, b, pairs, level=3)
    for name, want in (("A_level_3_x.png", want_a),
                       ("B_level_3_x.png", want_b)):
        np.testing.assert_array_equal(
            decode_png((out / name).read_bytes()), want)


def test_check_missing(tmp_path):
    src = tmp_path / "church"
    src.mkdir()
    for name in ("church_3.png", "church_10.jpg", "church_7.png",
                 "church_x.png", "other_5.png", "church_2.txt"):
        (src / name).write_bytes(b"")
    results = tmp_path / "results"
    (results / "7").mkdir(parents=True)
    (results / "7" / "BtoA.npy").write_bytes(b"")
    (results / "3").mkdir()
    for limit in (None, 2, 10000):
        assert (nbbviz.check_missing(str(src), str(results), limit=limit)
                == jviz.check_missing(str(src), str(results), limit=limit))
    assert nbbviz.check_missing(str(src), str(results)) == [3, 10]
    empty = tmp_path / "empty"
    empty.mkdir()
    for mod in (nbbviz, jviz):
        with pytest.raises(ValueError, match="empty_<num>.png"):
            mod.check_missing(str(empty), str(results))

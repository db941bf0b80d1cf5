"""The port's FID (``native`` reading, ``metrics/inception``, ``fid``,
``get_fid``) against the JAX package's, on the same params and inputs.

- The Fréchet distance, streamed feature statistics, the stats files and
  the FID of two PNG directories through a cheap feature function: 1e-6
  relative (measured 0 to 1.8e-7).  Each package reads the other's stats.
- The reader: PNGs of the port's encoder and of PIL (whose rows are Paeth
  and Average filtered, among others) and a JPEG decode to PIL's pixels;
  batches keep their order and carry the remainder last; a WebP and a
  CMYK JPEG, which the port hands to PIL, read as the JAX package reads
  them.
- InceptionV3's features of 2 images at 299 pixels, uint8 and float,
  within 1e-4 of the largest (measured 4e-7); the checkpoint read from the
  weights directory, the converter and its inverse bit for bit.
- ``model_stats`` on a tiny ``SeqStyleGAN2`` through a cheap feature
  function: 1e-5 of the largest entry (the two forwards round apart,
  measured 1.3e-6); both ``main``s with their loaders patched.
"""

import io

import jax
import numpy as np
import PIL.Image
import pytest
import torch

from rewriting_tpu import native as jax_native
from rewriting_tpu.metrics import fid as jax_fid
from rewriting_tpu.metrics import get_fid as jax_get_fid
from rewriting_tpu.metrics import inception as jax_inception
from rewriting_tpu.models import zoo as jax_zoo
from rewriting_tpu.models.stylegan2 import SeqStyleGAN2 as JaxSeqStyleGAN2
from rewriting_torch import native
from rewriting_torch.convert import params_from_jax
from rewriting_torch.core.tree import leaves
from rewriting_torch.metrics import fid, get_fid, inception
from rewriting_torch.models import zoo
from rewriting_torch.models.stylegan2 import SeqStyleGAN2
from rewriting_torch.utils.renormalize import encode_png

torch.set_num_threads(1)

TOL = 1e-4


def rel_err(got, want):
    return float(np.abs(np.asarray(got, np.float64) - np.asarray(want))
                 .max() / np.abs(np.asarray(want)).max())


def cheap(x):
    """A feature function both packages can run: 12 pixel values."""
    return x.reshape(x.shape[0], -1)[:, ::97][:, :12]


# -- the Fréchet distance and the statistics --------------------------------------

def test_frechet_distance_matches_jax():
    rng = np.random.RandomState(0)
    for dim in (8, 64):
        mu1, mu2 = rng.randn(dim), rng.randn(dim)
        a, b = rng.randn(dim, dim), rng.randn(dim, 2 * dim)
        s1, s2 = a @ a.T + np.eye(dim), b @ b.T / dim
        got = fid.calculate_frechet_distance(mu1, s1, mu2, s2)
        want = jax_fid.calculate_frechet_distance(mu1, s1, mu2, s2)
        assert abs(got - want) <= 1e-6 * abs(want)
        assert abs(fid.calculate_frechet_distance(mu1, s1, mu1, s1)) < 1e-6
    s1, s2 = np.diag([1.0, 2.0, 3.0, 4.0]), np.diag([2.0, 2.0, 1.0, 1.0])
    want = 4 + np.sum(np.diag(s1) + np.diag(s2)
                      - 2 * np.sqrt(np.diag(s1) * np.diag(s2)))
    got = fid.calculate_frechet_distance(np.zeros(4), s1, np.ones(4), s2)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_feature_stats_match_jax_and_direct():
    feats = np.random.RandomState(1).randn(300, 6).astype(np.float32)
    batches = [feats[i:i + 64] for i in range(0, 300, 64)]
    mu, sigma = fid.compute_feature_stats(iter(batches), lambda x: x)
    assert mu.dtype == sigma.dtype == np.float32
    jmu, jsigma = jax_fid.compute_feature_stats(iter(batches), lambda x: x)
    assert rel_err(mu, jmu) <= 1e-6 and rel_err(sigma, jsigma) <= 1e-6
    np.testing.assert_allclose(mu, feats.mean(0), atol=1e-5)
    np.testing.assert_allclose(sigma, np.cov(feats.T), atol=1e-4)
    # float64 features go in as float32, as they do in the JAX package
    mu64, _ = fid.compute_feature_stats(
        iter(batches), lambda x: torch.as_tensor(x, dtype=torch.float64))
    assert mu64.dtype == np.float32


def test_stats_files_read_across_packages(tmp_path):
    rng = np.random.RandomState(2)
    mu, sigma = rng.randn(5).astype(np.float32), np.eye(5, dtype=np.float32)
    fid.save_stats(str(tmp_path / "a" / "torch.npz"), mu, sigma)
    jax_fid.save_stats(str(tmp_path / "jax.npz"), mu + 1, sigma * 2)
    for path, m in ((tmp_path / "a" / "torch.npz", mu),
                    (tmp_path / "jax.npz", mu + 1)):
        got, want = fid.load_stats(str(path)), jax_fid.load_stats(str(path))
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[0], m)
    p, q = str(tmp_path / "a" / "torch.npz"), str(tmp_path / "jax.npz")
    assert fid.compute_fid(p, p, feature_fn=cheap) < 1e-8
    assert fid.compute_fid(p, q, feature_fn=cheap) == pytest.approx(
        jax_fid.compute_fid(p, q, feature_fn=cheap), rel=1e-6)


def test_parity_images_match_jax():
    for seed in (1, 2):
        np.testing.assert_array_equal(fid.parity_images(seed, n=8),
                                      jax_fid.parity_images(seed, n=8))


# -- reading images ----------------------------------------------------------------

def _pil_png(arr, mode):
    b = io.BytesIO()
    PIL.Image.fromarray(arr, mode).save(b, format="png")
    return b.getvalue()


def test_read_image_rgb_matches_pil(tmp_path):
    rng = np.random.RandomState(0)
    img = rng.randint(0, 255, (37, 53, 3), np.uint8)
    grad = (np.arange(40)[:, None] * np.arange(60)[None, :] % 256)
    cases = {"port": encode_png(img),
             "rgb": _pil_png(img, "RGB"),
             "gradient": _pil_png(np.dstack([grad, grad[::-1], grad // 2])
                                  .astype(np.uint8), "RGB"),
             "rgba": _pil_png(rng.randint(0, 255, (20, 31, 4), np.uint8),
                              "RGBA"),
             "grey": _pil_png(rng.randint(0, 255, (20, 31), np.uint8), "L"),
             "grey_alpha": _pil_png(rng.randint(0, 255, (9, 7, 2), np.uint8),
                                    "LA")}
    for name, data in cases.items():
        path = tmp_path / f"{name}.png"
        path.write_bytes(data)
        want = np.asarray(PIL.Image.open(io.BytesIO(data)).convert("RGB"))
        got = native.read_image_rgb(str(path))
        assert got.dtype == np.uint8 and got.flags["C_CONTIGUOUS"]
        np.testing.assert_array_equal(got, want, err_msg=name)
        np.testing.assert_array_equal(got, jax_native.read_image_rgb(
            str(path)), err_msg=name)
    jpg = tmp_path / "photo.jpg"
    PIL.Image.fromarray(img).save(jpg)
    got = native.read_image_rgb(str(jpg))
    assert got.dtype == np.uint8 and got.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(got, jax_native.read_image_rgb(str(jpg)))
    np.testing.assert_array_equal(
        got, np.asarray(PIL.Image.open(jpg).convert("RGB")))
    # kinds the port's decoders do not read: PIL reads them, as in the
    # JAX package
    webp = tmp_path / "photo.webp"
    PIL.Image.fromarray(img).save(webp)
    cmyk = tmp_path / "cmyk.jpg"
    PIL.Image.fromarray(img).convert("CMYK").save(cmyk)
    for path in (webp, cmyk):
        got = native.read_image_rgb(str(path))
        assert got.dtype == np.uint8 and got.shape == img.shape
        np.testing.assert_array_equal(got, jax_native.read_image_rgb(
            str(path)), err_msg=path.name)


def test_read_batches_order_and_tail(tmp_path):
    rng = np.random.RandomState(0)
    n, bs = 23, 8
    paths, imgs = [], []
    for i in range(n):
        img = rng.randint(0, 255, (16, 16, 3), np.uint8)
        path = tmp_path / f"{i}.png"
        if i % 2:
            PIL.Image.fromarray(img).save(path)
        else:
            path.write_bytes(encode_png(img))
        paths.append(str(path))
        imgs.append(img)
    batches = list(native.read_batches(paths, bs, workers=4, readahead=2))
    assert [b.shape[0] for b in batches] == [8, 8, 7]
    assert all(b.dtype == np.uint8 and b.shape[1:] == (16, 16, 3)
               for b in batches)
    np.testing.assert_array_equal(np.concatenate(batches), np.stack(imgs))
    for got, want in zip(batches, jax_native.read_batches(paths, bs,
                                                          workers=2)):
        np.testing.assert_array_equal(got, want)
    assert list(native.read_batches([], bs)) == []
    gen = native.read_batches(paths, bs, workers=2)
    next(gen)
    gen.close()


@pytest.fixture(scope="module")
def image_dirs(tmp_path_factory):
    """Two directories of 13 PNGs (stems 0..12, numeric order differs from
    lexicographic, and one other name), one written by the port's encoder,
    one by PIL."""
    root = tmp_path_factory.mktemp("fid_dirs")
    rng = np.random.RandomState(3)
    dirs = {}
    for name in ("port", "pil"):
        d = root / name
        d.mkdir()
        for i in list(range(13)) + ["extra"]:
            img = rng.randint(0, 256, (32, 32, 3), np.uint8)
            if name == "port":
                (d / f"{i}.png").write_bytes(encode_png(img))
            else:
                PIL.Image.fromarray(img).save(d / f"{i}.png")
        dirs[name] = str(d)
    return dirs


@pytest.mark.parametrize("writer", ["port", "pil"])
def test_image_dir_batches_and_fid_match_jax(image_dirs, writer):
    d = image_dirs[writer]
    for as_uint8 in (True, False):
        got = list(fid._image_dir_batches(d, 5, as_uint8=as_uint8))
        want = list(jax_fid._image_dir_batches(d, 5, as_uint8=as_uint8))
        assert [len(b) for b in got] == [5, 5, 4]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    other = image_dirs["pil" if writer == "port" else "port"]
    got = fid.compute_fid(d, other, feature_fn=cheap, batch_size=5)
    want = jax_fid.compute_fid(d, other, feature_fn=cheap, batch_size=5)
    assert got > 0 and abs(got - want) <= 1e-6 * want
    assert fid.compute_fid(d, d, feature_fn=cheap, batch_size=5) < 1e-6 * got


# -- Inception ----------------------------------------------------------------

@pytest.fixture(scope="module")
def inception_sd():
    """Seeded params in pytorch-fid's layout (identity BatchNorms)."""
    return inception.state_dict_from_params(inception.init_params(0))


def test_inception_converter_round_trip(inception_sd):
    """The inverse converter's file reads back bit for bit, in both
    packages, and ``convert.tree_from_jax`` carries the JAX package's tree
    across leaf for leaf."""
    from rewriting_torch.convert import tree_from_jax
    params = inception.params_from_torch_state_dict(inception_sd)
    want = inception.init_params(0)
    got, want = dict(leaves(params)), dict(leaves(want))
    assert got.keys() == want.keys() and len(got) == 2 * 94
    for k in got:
        assert torch.equal(got[k], want[k]), k
    assert sum(v.numel() for v in got.values()) == 21_768_352
    carried = dict(leaves(tree_from_jax(jax.tree_util.tree_map(
        np.asarray, jax_inception.params_from_torch_state_dict(
            {k: v.numpy() for k, v in inception_sd.items()})))))
    assert carried.keys() == got.keys()
    for k in got:
        assert torch.equal(carried[k], got[k]), k


@pytest.mark.parametrize("kind", ["uint8", "float"])
def test_inception_features_match_jax(inception_sd, kind):
    params = inception.params_from_torch_state_dict(inception_sd)
    jparams = jax_inception.params_from_torch_state_dict(
        {k: v.numpy() for k, v in inception_sd.items()})
    u8 = np.random.RandomState(4).randint(0, 256, (2, 64, 64, 3), np.uint8)
    x = u8 if kind == "uint8" else (u8.astype(np.float32) / 255.0) * 2.0 \
        - 1.0
    fe = fid.FeatureExtractor(params, device="cpu")
    feats = fe(x)
    assert feats.shape == (2, 2048) and feats.dtype == np.float32
    want = np.asarray(jax_inception.InceptionV3Features()(jparams, x))
    assert rel_err(feats, want) <= TOL
    if kind == "float":
        assert rel_err(fe(u8), feats) <= TOL
        dev = fe.device_features(torch.from_numpy(u8))
        assert isinstance(dev, torch.Tensor) and dev.shape == (2, 2048)


@pytest.fixture(scope="module")
def small_dirs(tmp_path_factory):
    """Two directories of 6 PNGs (32 x 32) for the command lines, which
    run Inception at 299 pixels in both packages."""
    root = tmp_path_factory.mktemp("small")
    rng = np.random.RandomState(5)
    dirs = []
    for name in ("a", "b"):
        (root / name).mkdir()
        for i in range(6):
            img = rng.randint(0, 256, (32, 32, 3), np.uint8)
            (root / name / f"{i}.png").write_bytes(encode_png(img))
        dirs.append(str(root / name))
    return dirs


@pytest.fixture(scope="module")
def weights_dir(inception_sd, tmp_path_factory):
    root = tmp_path_factory.mktemp("weights")
    torch.save(inception_sd, root / fid.WEIGHTS_FILENAME)
    return str(root)


def test_feature_extractor_reads_the_weights_dir(weights_dir, inception_sd,
                                                 monkeypatch,
                                                 tmp_path):
    monkeypatch.setenv("REWRITING_TPU_WEIGHTS", weights_dir)
    fe = fid.FeatureExtractor(device="cpu")
    want = dict(leaves(inception.params_from_torch_state_dict(
        inception_sd)))
    got = {k[len("convs."):].replace("__", "."): v
           for k, v in fe.net.state_dict().items()}
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k
    monkeypatch.setenv("REWRITING_TPU_WEIGHTS", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="NOT FID"):
        fid.FeatureExtractor(device="cpu")
    assert fid.FeatureExtractor(allow_random=True, device="cpu").net \
        .resize_to == 299


# -- generator statistics and the command lines ------------------------------

SIZE, STYLE_DIM, N_MLP = 16, 64, 2


@pytest.fixture(scope="module")
def pair():
    jm = JaxSeqStyleGAN2(SIZE, style_dim=STYLE_DIM, n_mlp=N_MLP)
    jp = jm.init_params(jax.random.PRNGKey(1))
    tm = SeqStyleGAN2(SIZE, style_dim=STYLE_DIM, n_mlp=N_MLP, device="cpu")
    tp = params_from_jax(tm, jax.tree_util.tree_map(np.asarray, jp))
    return jm, jp, tm, tp


def test_model_stats_matches_jax(pair):
    """12 images in batches of 5 (the tail padded with zero z), seeds from
    3: the per-image z contract."""
    jm, jp, tm, tp = pair
    seen = []

    def spy(x):
        seen.append(x)
        return cheap(x)
    mu, sigma = get_fid.model_stats(tm, tp, n=12, batch_size=5,
                                    feature_fn=spy, offset=3)
    jmu, jsigma = jax_get_fid.model_stats(
        jm, jp, n=12, batch_size=5, offset=3,
        feature_fn=lambda x: cheap(np.asarray(x)))
    assert [len(x) for x in seen] == [5, 5, 2]
    assert isinstance(seen[0], torch.Tensor) and seen[0].shape[1:] == (
        SIZE, SIZE, 3)
    assert rel_err(mu, jmu) <= 1e-5 and rel_err(sigma, jsigma) <= 1e-5


def test_fid_main(small_dirs, weights_dir, monkeypatch, capsys):
    """The FID command line on two directories with --inception_weights,
    against the JAX package's command line on the weights directory's
    copy of the same checkpoint (one 2048-dimensional matrix square root
    each, about 10 s on the CPU)."""
    monkeypatch.setenv("REWRITING_TPU_WEIGHTS", weights_dir)
    monkeypatch.setattr(fid, "resolve_device",
                        lambda d=None: torch.device("cpu"))
    args = small_dirs + ["--batch_size", "4"]
    fid.main(args + ["--inception_weights",
                     f"{weights_dir}/{fid.WEIGHTS_FILENAME}"])
    got = float(capsys.readouterr().out)
    monkeypatch.setattr("sys.argv", ["fid"] + args)
    jax_fid.main()
    want = float(capsys.readouterr().out)
    assert got > 0 and abs(got - want) <= 1e-3 * want


def test_get_fid_main(pair, small_dirs, weights_dir, monkeypatch, capsys,
                      tmp_path):
    """Model statistics of the patched loader's model, a directory's
    statistics and --compare, each against the JAX package's command line
    on the same loader and files."""
    jm, jp, tm, tp = pair
    monkeypatch.setenv("REWRITING_TPU_WEIGHTS", weights_dir)
    monkeypatch.setattr(zoo, "load_seq_stylegan", lambda *a, **k: (tm, tp))
    monkeypatch.setattr(jax_zoo, "load_seq_stylegan",
                        lambda *a, **k: (jm, jp))
    monkeypatch.setattr(fid, "resolve_device",
                        lambda d=None: torch.device("cpu"))
    out = {}
    for name, main in (("torch", get_fid.main), ("jax", None)):
        model = str(tmp_path / f"{name}_model.npz")
        folder = str(tmp_path / f"{name}_dir.npz")
        argv = [["--n", "6", "--out", model],
                ["--image_dir", small_dirs[0], "--out", folder]]
        for a in argv:
            if main is not None:
                main(a)
            else:
                monkeypatch.setattr("sys.argv", ["get_fid"] + a)
                jax_get_fid.main()
        out[name] = (fid.load_stats(model), fid.load_stats(folder))
    for got, want in zip(out["torch"], out["jax"]):
        assert rel_err(got[0], want[0]) <= TOL
        assert rel_err(got[1], want[1]) <= 10 * TOL
    rng = np.random.RandomState(6)
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    for path in (a, b):
        feats = rng.randn(40, 12)
        fid.save_stats(path, feats.mean(0), np.cov(feats.T))
    get_fid.main(["--compare", a, b])
    got = float(capsys.readouterr().out.strip().splitlines()[-1])
    monkeypatch.setattr("sys.argv", ["get_fid", "--compare", a, b])
    jax_get_fid.main()
    assert got == float(capsys.readouterr().out.strip().splitlines()[-1])
    get_fid.main(["--n", "6", "--out", str(tmp_path / "torch_model.npz")])
    assert "exists" in capsys.readouterr().out

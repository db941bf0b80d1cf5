"""The paper's staged and fused metric pipelines in the port
(``metrics/{seg_stats,seg_correct_mod,fused_pipeline}.py``) against each
other and against the JAX package's, on a tiny SeqStyleGAN2 whose params
are the JAX package's converted.

Held:
- ``run_fused`` against the port's staged path (``sample_clean``, then
  ``seg_stats.process``, then ``fid.compute_feature_stats`` over the PNGs)
  at the same batch size: byte-identical PNGs, equal int64 labels and
  bit-identical statistics (the same bytes, batches and update order);
- each artifact against the JAX package's: the fused PNGs within 1 LSB
  of the JAX package's fused PNGs (the two forwards round apart); the
  labels of both packages' ``seg_stats.process`` over the same PNGs
  equal; the statistics of both packages over the same PNGs within 1e-6
  of the largest entry (measured 0);
- a duck-typed segmenter gets zc float batches in both drivers, its labels
  equal in both; ``seg_downsample`` reaches a ``segment_batch`` that takes
  it, and one that does not raises ``TypeError`` naming it;
- ``seg_correct_mod.compute_dl`` and ``main`` equal to the JAX package's,
  on ``.npz`` and ``.pth`` files;
- the segmenters' two names where the JAX package has them:
  ``accepts_uint8`` on unified parsing, the semantic and the merged
  segmenters; ``segment_batch_device`` on the face parser only, device
  uint8 labels equal to its int64 ``segment_batch``, and labels equal to
  the JAX package's on the bisenet_tiny golden wherever the top-two score
  margin exceeds 1e-4 of the largest (tests/test_torch_faceparse.py's
  rule); ``seg_stats.process`` through the face parser (device labels)
  and the colour segmenter (uint8 in) against the JAX package's on the
  same PNGs, by the same rule.
"""

import io
import os
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rewriting_tpu.metrics import fid as jax_fid
from rewriting_tpu.metrics import seg_correct_mod as jax_correct
from rewriting_tpu.metrics import seg_stats as jax_seg_stats
from rewriting_tpu.metrics.fused_pipeline import run_fused as jax_run_fused
from rewriting_tpu.models.stylegan2 import SeqStyleGAN2 as JaxSeqStyleGAN2
from rewriting_tpu.segment import faceparse as jface
from rewriting_tpu.segment import segmenter as jsegmenter
from rewriting_tpu.segment import semantic as jsem
from rewriting_torch.convert import params_from_jax
from rewriting_torch.metrics import fid, seg_correct_mod, seg_stats
from rewriting_torch.metrics.fused_pipeline import run_fused
from rewriting_torch.metrics.sample import sample_clean
from rewriting_torch.models.stylegan2 import SeqStyleGAN2
from rewriting_torch.segment import faceparse, segmenter, semantic
from rewriting_torch.segment.nn import resize_nearest
from rewriting_torch.utils.renormalize import decode_png, encode_png

torch.set_num_threads(1)

N, BS = 12, 4      # n > 10: '10.png' sorts before '2.png' as text
TOL = 1e-4
COLOURS = ["black", "blue", "brown", "gray", "green", "orange", "pink",
           "purple", "red", "white", "yellow"]


@pytest.fixture(scope="module")
def models():
    jm = JaxSeqStyleGAN2(16, style_dim=32, n_mlp=2)
    jparams = jm.init_params(jax.random.PRNGKey(0))
    tm = SeqStyleGAN2(16, style_dim=32, n_mlp=2, device="cpu")
    params = params_from_jax(tm, jax.tree_util.tree_map(np.asarray,
                                                        jparams))
    return (jm, jparams), (tm, params)


class ToySeg:
    """The device path of the face parser: uint8 labels on the images'
    device."""

    def segment_batch_device(self, xs, downsample: int = 1):
        assert downsample == 1
        x = torch.as_tensor(xs)
        assert x.dtype == torch.uint8
        return (x[..., 0] > 127).to(torch.uint8)[:, None]

    def segment_batch(self, xs, downsample: int = 1):
        return self.segment_batch_device(xs, downsample).long()


class JaxToySeg:
    def segment_batch_device(self, xs, downsample: int = 1):
        return (jnp.asarray(xs)[..., 0] > 127).astype(jnp.uint8)[:, None]

    def segment_batch(self, xs, downsample: int = 1):
        return np.asarray(self.segment_batch_device(xs)).astype(np.int64)


class ToyFeatures:
    """``FeatureExtractor``'s ``device_features`` contract: 12 features."""

    def device_features(self, images):
        x = torch.as_tensor(images).float() / 255.0
        return x.reshape(x.shape[0], -1)[:, :12]

    def __call__(self, images):
        return self.device_features(images).numpy()


class JaxToyFeatures:
    def device_features(self, images):
        x = jnp.asarray(images, jnp.float32) / 255.0
        return x.reshape(x.shape[0], -1)[:, :12]

    def __call__(self, images):
        return np.asarray(self.device_features(images))


class HostSeg:
    """A duck-typed segmenter: zc float host batches in, host labels out."""

    def segment_batch(self, xs):
        xs = np.asarray(xs)
        assert xs.dtype == np.float32 and xs.min() < -0.01, \
            "duck-typed segmenters must receive zc floats"
        return (xs[..., 1] > 0).astype(np.int64)[:, None]


class DownSeg(HostSeg):
    def segment_batch(self, xs, downsample=1):
        return super().segment_batch(xs)[:, :, ::downsample, ::downsample]


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _seg(directory, i):
    return np.load(os.path.join(directory, f"{i}.npz"))["seg"]


def _staged_stats(directory, features, fid_mod):
    return fid_mod.compute_feature_stats(
        fid_mod._image_dir_batches(directory, BS, as_uint8=True), features)


@pytest.fixture(scope="module")
def fused(models, tmp_path_factory):
    """The port's staged and fused runs and the JAX package's fused run."""
    (jm, jparams), (tm, params) = models
    root = tmp_path_factory.mktemp("pipeline")
    staged_img, staged_seg = str(root / "staged"), str(root / "staged_seg")
    sample_clean(tm, params, staged_img, n=N, batch_size=BS)
    seg_stats.process(ToySeg(), staged_img, staged_seg, n=N, batch_size=BS)
    staged_stats = _staged_stats(staged_img, ToyFeatures(), fid)
    out = str(root / "fused")
    stats = run_fused(tm, params, out, segmodel=ToySeg(),
                      feature_fn=ToyFeatures(), n=N, batch_size=BS,
                      stats_path=str(root / "stats.npz"))
    jout = str(root / "jax_fused")
    jstats = jax_run_fused(jm, jparams, jout, segmodel=JaxToySeg(),
                           feature_fn=JaxToyFeatures(), n=N, batch_size=BS)
    return {"root": root, "staged": (staged_img, staged_seg, staged_stats),
            "fused": (out, stats), "jax": (jout, jstats)}


def test_fused_matches_staged(fused):
    staged_img, staged_seg, (mu_s, sig_s) = fused["staged"]
    out, (mu_f, sig_f) = fused["fused"]
    for i in range(N):
        assert _bytes(os.path.join(staged_img, f"{i}.png")) == \
            _bytes(os.path.join(out, f"{i}.png")), f"image {i}"
        a, b = _seg(staged_seg, i), _seg(os.path.join(out, "seg"), i)
        assert a.dtype == b.dtype == np.int64 and a.shape == (1, 16, 16)
        np.testing.assert_array_equal(a, b)
    assert os.path.exists(os.path.join(out, "+lightbox.html"))
    assert mu_f.dtype == np.float32 and sig_f.shape == (12, 12)
    np.testing.assert_array_equal(mu_f, mu_s)
    np.testing.assert_array_equal(sig_f, sig_s)
    saved = np.load(fused["root"] / "stats.npz")
    np.testing.assert_array_equal(saved["mu"], mu_f)
    np.testing.assert_array_equal(saved["sigma"], sig_f)


def test_artifacts_match_jax(fused, tmp_path):
    out, _ = fused["fused"]
    jout, _ = fused["jax"]
    for i in range(N):
        a = decode_png(_bytes(os.path.join(out, f"{i}.png")))
        b = decode_png(_bytes(os.path.join(jout, f"{i}.png")))
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, i
        # the JAX labels are those of its own pixels
        np.testing.assert_array_equal(
            _seg(os.path.join(jout, "seg"), i)[0], b[..., 0] > 127)
    # both packages' staged segmentation and statistics of the same PNGs
    seg_stats.process(ToySeg(), jout, str(tmp_path / "t"), n=N,
                      batch_size=BS)
    jax_seg_stats.process(JaxToySeg(), jout, str(tmp_path / "j"), n=N,
                          batch_size=BS)
    for i in range(N):
        np.testing.assert_array_equal(_seg(tmp_path / "t", i),
                                      _seg(tmp_path / "j", i))
    for got, want in zip(_staged_stats(jout, ToyFeatures(), fid),
                         _staged_stats(jout, JaxToyFeatures(), jax_fid)):
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_fused_sample_only(models, tmp_path):
    _, (tm, params) = models
    out = str(tmp_path / "imgs_only")
    assert run_fused(tm, params, out, n=3, batch_size=2) is None
    assert sorted(os.listdir(out)) == ["+lightbox.html", "0.png", "1.png",
                                       "2.png"]


def test_duck_typed_segmenter_and_downsample(models, tmp_path):
    _, (tm, params) = models
    staged_img = str(tmp_path / "imgs")
    sample_clean(tm, params, staged_img, n=3, batch_size=2)
    seg_stats.process(HostSeg(), staged_img, str(tmp_path / "staged"), n=3,
                      batch_size=2)
    jax_seg_stats.process(HostSeg(), staged_img, str(tmp_path / "jax"), n=3,
                          batch_size=2)
    out = str(tmp_path / "duck")
    run_fused(tm, params, out, segmodel=HostSeg(), n=3, batch_size=2)
    for i in range(3):
        a = _seg(tmp_path / "staged", i)
        assert a.dtype == np.int64
        np.testing.assert_array_equal(a, _seg(os.path.join(out, "seg"), i))
        np.testing.assert_array_equal(a, _seg(tmp_path / "jax", i))
    out2 = str(tmp_path / "down")
    run_fused(tm, params, out2, segmodel=DownSeg(), n=2, batch_size=2,
              seg_downsample=2)
    full = _seg(os.path.join(out, "seg"), 0)
    np.testing.assert_array_equal(_seg(os.path.join(out2, "seg"), 0),
                                  full[:, ::2, ::2])
    with pytest.raises(TypeError, match="downsample"):
        run_fused(tm, params, str(tmp_path / "bad"), segmodel=HostSeg(),
                  n=2, batch_size=2, seg_downsample=2)


def _write_labels(directory, kind, rng, n=4):
    os.makedirs(directory)
    for i in range(n):
        seg = rng.choice([0, 5, 7, 1708, 1709], (3, 8, 8)).astype(np.int64)
        if kind == "npz":
            np.savez_compressed(os.path.join(directory, f"{i}.npz"), seg=seg)
        else:
            torch.save(torch.from_numpy(seg),
                       os.path.join(directory, f"{i}.pth"))


@pytest.mark.parametrize("kind", ["npz", "pth"])
def test_compute_dl_matches_jax(tmp_path, kind):
    rng = np.random.RandomState(0)
    before, after = str(tmp_path / "before"), str(tmp_path / "after")
    _write_labels(before, kind, rng)
    _write_labels(after, kind, rng)
    for args in [((5,), 0, (1708,), 2), ((5, 7), 1, (1708, 1709), 0)]:
        got = seg_correct_mod.compute_dl(before, after, range(4), *args)
        assert got == jax_correct.compute_dl(before, after, range(4), *args)
        assert got[1] > 0
    # a direct count over the same files
    total = count = 0
    for i in range(4):
        b = seg_correct_mod.load_seg(os.path.join(before, str(i)))[2]
        a = seg_correct_mod.load_seg(os.path.join(after, str(i)))[0]
        total += int((a[b == 1708] == 5).sum())
        count += int((b == 1708).sum())
    assert seg_correct_mod.compute_dl(before, after, range(4)) == (total,
                                                                   count)


def test_seg_correct_mod_main_matches_jax(tmp_path, monkeypatch):
    rng = np.random.RandomState(1)
    results = tmp_path / "results"
    _write_labels(str(results / "seg" / "church_clean"), "npz", rng)
    _write_labels(str(results / "seg" / "dome2spire"), "npz", rng)
    monkeypatch.setenv("REWRITING_TPU_MASKS",
                       os.path.join(os.path.dirname(__file__), "..",
                                    "notebooks", "masks", "stylegan"))
    outs = []
    for main in (seg_correct_mod.main, jax_correct.main):
        buf = io.StringIO()
        argv = ["--exp_name", "dome2spire", "--num", "4", "--results",
                str(results)]
        if main is jax_correct.main:
            monkeypatch.setattr("sys.argv", ["seg_correct_mod"] + argv)
            argv = None
        with redirect_stdout(buf):
            main() if argv is None else main(argv)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and "ratio=" in outs[0]


def test_seg_stats_main(models, tmp_path, monkeypatch):
    _, (tm, params) = models
    results = tmp_path / "results"
    sample_clean(tm, params, str(results / "church_clean"), n=3,
                 batch_size=2)
    from rewriting_torch.metrics import load_seg
    monkeypatch.setattr(load_seg, "load_seg_model", lambda name: ToySeg())
    seg_stats.main(["church_clean", "--n", "3", "--results", str(results)])
    done = results / "seg" / "church_clean"
    assert (done / "done.txt").exists()
    assert sorted(n for n in os.listdir(done) if n.endswith(".npz")) == [
        "0.npz", "1.npz", "2.npz"]


# -- the segmenters' names ---------------------------------------------------

def test_segmenter_names_follow_the_jax_package():
    for port, jax_cls in ((segmenter.UnifiedParsingSegmenter,
                           jsegmenter.UnifiedParsingSegmenter),
                          (semantic.SemanticSegmenter,
                           jsem.SemanticSegmenter),
                          (faceparse.FaceSegmenter, jface.FaceSegmenter)):
        assert getattr(port, "accepts_uint8", False) == \
            getattr(jax_cls, "accepts_uint8", False), port
        assert hasattr(port, "segment_batch_device") == \
            hasattr(jax_cls, "segment_batch_device"), port
    assert segmenter.UnifiedParsingSegmenter.accepts_uint8
    assert not hasattr(segmenter.UnifiedParsingSegmenter,
                       "segment_batch_device")
    assert hasattr(faceparse.FaceSegmenter, "segment_batch_device")
    merged = segmenter.MergedSegmenter([segmenter.NoSegmenter()])
    assert merged.accepts_uint8 is False
    assert not hasattr(merged, "segment_batch_device")


def margin(scores):
    s = np.sort(np.asarray(scores), axis=1)
    return s[:, -1] - s[:, -2]


@pytest.fixture(scope="module")
def face(goldens):
    g = goldens("bisenet_tiny")
    sd = {k[3:]: g[k] for k in g.files if k.startswith("sd.")}
    return (faceparse.FaceSegmenter(
                params=faceparse.BiSeNet().params_from_torch(sd),
                device="cpu"),
            jface.FaceSegmenter(params=jface.BiSeNet().params_from_torch(sd)))


@pytest.fixture(scope="module")
def colour(goldens):
    g = goldens("dilated_resnet")
    enc = {k[len("r18.sd."):]: g[k] for k in g.files
           if k.startswith("r18.sd.")}
    ppm = semantic.PPMDecoder(len(COLOURS), 512)
    dec = ppm.params_to_torch(ppm.init_params(0))
    fmt = {"byteorder": "BGR", "mean": [0.485, 0.456, 0.406],
           "stdev": [0.229, 0.224, 0.225]}
    kw = dict(arch="resnet18dilated", category="color", imageformat=fmt,
              segsizes=[32])
    params = {"encoder": semantic.resnet18_deepstem_from_torch(enc),
              "decoder": ppm.params_from_torch(dec)}
    jparams = {"encoder": jsem.resnet18_deepstem_from_torch(enc),
               "decoder": jsem.PPMDecoder(len(COLOURS), 512)
               .params_from_torch(dec)}
    return (semantic.SemanticSegmenter(params, COLOURS, device="cpu", **kw),
            jsem.SemanticSegmenter(jparams, COLOURS, **kw))


def test_face_segment_batch_device_matches_jax(face):
    seg, jseg = face
    u8 = np.random.RandomState(7).randint(0, 256, (2, 64, 64, 3), np.uint8)
    for d in (1, 2):
        labels = seg.segment_batch_device(u8, downsample=d)
        assert labels.dtype == torch.uint8 and labels.device.type == "cpu"
        assert labels.shape == (2, 1, 64 // d, 64 // d)
        np.testing.assert_array_equal(labels.long().numpy(),
                                      seg.segment_batch(u8, d).numpy())
        want = np.asarray(jseg.segment_batch_device(u8, downsample=d))
        assert want.dtype == np.uint8
        scores = seg.scores(u8).numpy()
        sure = margin(scores) > TOL * np.abs(scores).max()
        assert sure.mean() > 0.99
        held = resize_nearest(torch.from_numpy(sure),
                              (64 // d, 64 // d)).numpy()
        np.testing.assert_array_equal(labels.numpy()[:, 0][held],
                                      want[:, 0][held])


def _png_dir(directory, n=4, size=32, seed=3):
    os.makedirs(directory)
    imgs = np.random.RandomState(seed).randint(0, 256, (n, size, size, 3),
                                               np.uint8)
    for i, img in enumerate(imgs):
        with open(os.path.join(directory, f"{i}.png"), "wb") as f:
            f.write(encode_png(img))
    return imgs


@pytest.mark.parametrize("which", ["face", "colour"])
def test_process_through_real_segmenters_matches_jax(which, face, colour,
                                                     tmp_path):
    """The device path (the face parser) and the uint8 path (the colour
    segmenter) of seg_stats.process in both packages on the same PNGs."""
    seg, jseg = face if which == "face" else colour
    imgs = _png_dir(str(tmp_path / "imgs"))
    seg_stats.process(seg, str(tmp_path / "imgs"), str(tmp_path / "t"), n=4,
                      batch_size=3)
    jax_seg_stats.process(jseg, str(tmp_path / "imgs"), str(tmp_path / "j"),
                          n=4, batch_size=3)
    if which == "face":
        scores = seg.scores(imgs).numpy()
        sure = margin(scores) > TOL * np.abs(scores).max()
        sure = resize_nearest(torch.from_numpy(sure), (32, 32)).numpy()
    else:
        sure = margin(seg.raw_seg_prediction(imgs).numpy()) > TOL
    assert sure.mean() > 0.99
    for i in range(4):
        a, b = _seg(tmp_path / "t", i), _seg(tmp_path / "j", i)
        assert a.dtype == b.dtype == np.int64 and a.shape == (1, 32, 32)
        np.testing.assert_array_equal(a[0][sure[i]], b[0][sure[i]])
        np.testing.assert_array_equal(
            a, seg.segment_batch(imgs[i:i + 1]).numpy()[0])

"""The port's face parser, colour segmenter, SlimNet and smile count
against the JAX package's, on the same params and inputs.

- BiSeNet on the bisenet_tiny golden's converted weights: the golden's
  output and the JAX package's within 1e-4 of the largest (measured
  8.9e-7 at most).
- ``FaceSegmenter`` at 256- and 512-pixel inputs, uint8 and float: labels
  equal to the JAX package's wherever the top-two score margin exceeds
  1e-4 of the largest score (one 512-pixel label of the four runs falls
  inside the margin and differs); uint8 equal to float.
- The colour ``SemanticSegmenter`` (deep-stem dilated ResNet-18, PPM):
  the encoder against dilated_resnet.npz's r18 features (2e-5 of their
  scale, as tests/test_semantic_misc.py holds the JAX package), the
  softmax maps against the JAX package's within 1e-4, labels where the
  margin exceeds 1e-4, uint8 against float; other architectures raise.
- SlimNet's logits within 1e-4 of the largest, at its input size and
  through the antialiased resize (measured 8.6e-7); the converter's errors;
  a training checkpoint read through the weights directory.
- ``count_smiles`` with an injected classifier at batch sizes that do and
  do not divide n, against the JAX package's; the mouth heuristic's
  decisions against the JAX package's; ``default_classifier`` and ``main``.
"""

import jax
import numpy as np
import PIL.Image
import pytest
import torch

from rewriting_tpu.metrics import num_smiles as jax_smiles
from rewriting_tpu.metrics import slimnet as jax_slimnet
from rewriting_tpu.segment import faceparse as jface
from rewriting_tpu.segment import semantic as jsem
from rewriting_torch.core.tree import leaves
from rewriting_torch.metrics import num_smiles, slimnet
from rewriting_torch.segment import faceparse, semantic
from rewriting_torch.segment.nn import resize_nearest

torch.set_num_threads(1)

TOL = 1e-4
COLOURS = ["black", "blue", "brown", "gray", "green", "orange", "pink",
           "purple", "red", "white", "yellow"]


def nchw(x):
    return np.transpose(np.asarray(x), (0, 3, 1, 2))


def rel_err(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


def margin(p):
    s = np.sort(np.asarray(p), axis=1)
    return s[:, -1] - s[:, -2]


@pytest.fixture(scope="module")
def bisenet_sd(goldens):
    g = goldens("bisenet_tiny")
    return g, {k[3:]: g[k] for k in g.files if k.startswith("sd.")}


@pytest.fixture(scope="module")
def face_segmenters(bisenet_sd):
    _, sd = bisenet_sd
    return (faceparse.FaceSegmenter(
                params=faceparse.BiSeNet().params_from_torch(sd),
                device="cpu"),
            jface.FaceSegmenter(params=jface.BiSeNet().params_from_torch(sd)))


def test_bisenet_matches_golden_and_jax(bisenet_sd):
    g, sd = bisenet_sd
    net = faceparse.BiSeNet()
    with torch.no_grad():
        out = net(net.params_from_torch(sd), torch.from_numpy(g["x"]))
    assert out.shape == (1, 19, 64, 64)
    assert rel_err(out.numpy(), g["out"]) <= TOL
    jnet = jface.BiSeNet()
    want = jnet(jnet.params_from_torch(sd), np.transpose(g["x"],
                                                         (0, 2, 3, 1)))
    assert rel_err(out.numpy(), nchw(want)) <= TOL


@pytest.mark.parametrize("size", [256, 512])
@pytest.mark.parametrize("kind", ["uint8", "float"])
def test_face_segmenter_matches_jax(face_segmenters, size, kind):
    seg, jseg = face_segmenters
    u8 = np.random.RandomState(size).randint(0, 256, (1, size, size, 3),
                                             np.uint8)
    x = u8 if kind == "uint8" else (u8.astype(np.float32) / 255.0) * 2.0 \
        - 1.0
    labels = seg.segment_batch(x)
    assert labels.dtype == torch.int64 and labels.shape == (1, 1, size,
                                                            size)
    want = jseg.segment_batch(x)
    scores = seg.scores(x).numpy()
    sure = torch.from_numpy(margin(scores) > TOL * np.abs(scores).max())
    assert sure.float().mean() > 0.99
    for d in (1, 2):
        got = seg.segment_batch(torch.from_numpy(x), downsample=d).numpy()
        held = resize_nearest(sure, (size // d, size // d)).numpy()
        np.testing.assert_array_equal(
            got[:, 0][held], jseg.segment_batch(x, downsample=d)[:, 0][held])
    if kind == "float":
        np.testing.assert_array_equal(labels.numpy(),
                                      seg.segment_batch(u8).numpy())


# -- the colour segmenter ----------------------------------------------------


@pytest.fixture(scope="module")
def colour(goldens):
    g = goldens("dilated_resnet")
    enc = {k[len("r18.sd."):]: g[k] for k in g.files
           if k.startswith("r18.sd.")}
    ppm = semantic.PPMDecoder(len(COLOURS), 512)
    dec = ppm.params_to_torch(ppm.init_params(0))
    fmt = {"byteorder": "BGR", "mean": [0.485, 0.456, 0.406],
           "stdev": [0.229, 0.224, 0.225]}
    params = {"encoder": semantic.resnet18_deepstem_from_torch(enc),
              "decoder": semantic.PPMDecoder(len(COLOURS), 512)
              .params_from_torch(dec)}
    jparams = {"encoder": jsem.resnet18_deepstem_from_torch(enc),
               "decoder": jsem.PPMDecoder(len(COLOURS), 512)
               .params_from_torch(dec)}
    kw = dict(arch="resnet18dilated", category="color", imageformat=fmt,
              segsizes=[64])
    return {"g": g, "params": params,
            "seg": semantic.SemanticSegmenter(params, COLOURS, device="cpu",
                                              **kw),
            "jseg": jsem.SemanticSegmenter(jparams, COLOURS, **kw)}


def test_dilated_resnet18_matches_golden(colour):
    g = colour["g"]
    feats = semantic.resnet18_dilated_features(colour["params"]["encoder"],
                                               torch.from_numpy(g["x"]))
    for i in range(4):
        ref = g[f"r18.feat_{i}"]
        scale = max(np.abs(ref).max(), 1e-6)
        np.testing.assert_allclose(feats[i].numpy() / scale, ref / scale,
                                   atol=2e-5, err_msg=f"feat_{i}")


def test_colour_segmenter_matches_jax(colour):
    seg, jseg = colour["seg"], colour["jseg"]
    u8 = np.random.RandomState(5).randint(0, 256, (2, 64, 64, 3), np.uint8)
    zc = (u8.astype(np.float32) / 255.0) * 2.0 - 1.0
    pred = seg.raw_seg_prediction(zc).numpy()
    assert pred.shape == (2, len(COLOURS), 64, 64)
    np.testing.assert_allclose(pred, nchw(jseg.raw_seg_prediction(zc)),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(seg.raw_seg_prediction(u8).numpy(), pred,
                               atol=TOL, rtol=0)
    labels = seg.segment_batch(torch.from_numpy(zc))
    assert labels.dtype == torch.int64 and labels.shape == (2, 1, 64, 64)
    sure = margin(pred) > TOL
    assert sure.mean() > 0.99
    np.testing.assert_array_equal(labels.numpy()[:, 0][sure],
                                  jseg.segment_batch(zc)[:, 0][sure])
    score, mask = seg.predict_single_class(zc, 3)
    jscore, jmask = jseg.predict_single_class(zc, 3)
    np.testing.assert_allclose(score.numpy(), np.asarray(jscore), atol=TOL,
                               rtol=0)
    np.testing.assert_array_equal(mask.numpy()[sure], np.asarray(jmask)[sure])
    assert seg.get_label_and_category_names() == \
        jseg.get_label_and_category_names()


def test_semantic_segmenter_refuses_what_is_not_ported():
    """An encoder or decoder that neither package has is refused, naming
    the choices; every one of the JAX package's is taken (the new ones are
    held in tests/test_torch_semantic_archs.py)."""
    for kw in ({"arch": "vgg16"},
               {"arch": "resnet18dilated", "decoder": "upernet"}):
        with pytest.raises(ValueError, match="resnet18dilated"):
            semantic.SemanticSegmenter(None, COLOURS, device="cpu", **kw)
    assert set(semantic.SemanticSegmenter.FC_DIMS) == {
        "resnet50dilated", "resnet18dilated", "resnet101dilated",
        "resnet101", "mobilenetv2dilated", "resnext101"}
    assert set(semantic.SemanticSegmenter.DECODERS) == {
        "ppm", "ppm_deepsup", "c1", "c1_deepsup"}
    seg = semantic.SemanticSegmenter(None, ["-", "a", "b"],
                                     arch="resnet18dilated",
                                     decoder="ppm_deepsup", segsizes=[32],
                                     device="cpu")
    out = seg.segment_batch(np.zeros((1, 32, 32, 3), np.float32))
    assert out.shape == (1, 1, 32, 32) and int(out.max()) < 3


# -- SlimNet -------------------------------------------------------------------

@pytest.fixture(scope="module")
def slim_sd():
    return slimnet.init_random_state_dict(0)


@pytest.mark.parametrize("size", [(178, 218), (256, 256)],
                         ids=["native", "resized"])
def test_slimnet_logits_match_jax(slim_sd, size):
    clf = slimnet.SlimNetClassifier(state_dict=dict(slim_sd), device="cpu")
    jclf = jax_slimnet.SlimNetClassifier(state_dict=dict(slim_sd))
    imgs = np.random.RandomState(1).uniform(-1, 1, (2,) + size + (3,)).astype(
        np.float32)
    logits = clf.logits(imgs)
    assert logits.shape == (2, 40)
    want = np.asarray(jclf.logits(imgs))
    assert rel_err(logits.numpy(), want) <= TOL
    smiling = 1.0 / (1.0 + np.exp(-want[:, slimnet.SMILING])) > 0.5
    np.testing.assert_array_equal(clf(imgs).numpy(), smiling)
    params = slimnet.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                            jclf.params))
    got, want = dict(leaves(params)), dict(leaves(clf.params))
    assert got.keys() == want.keys()
    for name in got:
        assert torch.equal(got[name], want[name]), name


def test_slimnet_converter_errors(slim_sd):
    bad = dict(slim_sd)
    bad.pop("slim_module_2.dws.pointwise.weight")
    with pytest.raises(KeyError, match="layout mismatch"):
        slimnet.params_from_state_dict(bad)
    with pytest.raises(KeyError, match="slim_module_2.dws.pointwise"):
        jax_slimnet.params_from_state_dict(bad)
    extra = dict(slim_sd)
    extra["mystery.weight"] = np.zeros((1,), np.float32)
    with pytest.raises(ValueError, match="unconsumed"):
        slimnet.params_from_state_dict(extra)
    wrong = dict(slim_sd)
    wrong["conv_1.conv.weight"] = np.zeros((96, 3, 7, 7), np.float32)
    wrong["slim_module_1.dws.depthwise.weight"] = np.zeros(
        (128, 128, 3, 3), np.float32)
    with pytest.raises(ValueError, match="depthwise"):
        slimnet.params_from_state_dict(wrong)


def test_slimnet_reads_a_training_checkpoint(slim_sd, tmp_path,
                                             monkeypatch):
    """celeba_20.pth as SlimNet's training script saves it; the weights
    directory puts it before the mouth heuristic."""
    path = tmp_path / slimnet.WEIGHTS_FILENAME
    torch.save({"epoch": 20, "model_state_dict": {
        k: torch.from_numpy(v) for k, v in slim_sd.items()}}, path)
    clf = slimnet.slimnet_classifier(str(path), device="cpu")
    ref = slimnet.SlimNetClassifier(state_dict=dict(slim_sd), device="cpu")
    imgs = np.random.RandomState(2).uniform(-1, 1, (1, 178, 218, 3))
    torch.testing.assert_close(clf.logits(imgs), ref.logits(imgs), rtol=0,
                               atol=0)
    monkeypatch.setenv("REWRITING_TPU_WEIGHTS", str(tmp_path))
    clf = num_smiles.default_classifier(device="cpu")
    assert isinstance(clf, slimnet.SlimNetClassifier)
    assert clf.attr == slimnet.SMILING


# -- the smile count -----------------------------------------------------------

@pytest.fixture(scope="module")
def smile_dir(tmp_path_factory):
    """Six 8x8 PNGs written by PIL; 1, 3 and 4 red-dominant: the
    injected classifier's 'smiles'."""
    root = tmp_path_factory.mktemp("smiles")
    rng = np.random.RandomState(0)
    for i in range(6):
        arr = rng.randint(0, 100, (8, 8, 3), np.uint8)
        if i in {1, 3, 4}:
            arr[:, :, 0] = 250
        PIL.Image.fromarray(arr).save(root / f"{i}.png")
    return str(root)


def red_classifier(images_zc):
    return images_zc[:, :, :, 0].mean((1, 2)) > 0.5


@pytest.mark.parametrize("batch_size", [2, 4])
def test_count_smiles_with_injected_classifier(smile_dir, batch_size):
    got = num_smiles.count_smiles(smile_dir, n=6, batch_size=batch_size,
                                  classifier=red_classifier)
    assert got == 3 == jax_smiles.count_smiles(
        smile_dir, n=6, batch_size=batch_size, classifier=red_classifier)
    seen = []

    def spy(images):
        seen.append(images)
        return red_classifier(images)
    num_smiles.count_smiles(smile_dir, n=5, batch_size=batch_size,
                            classifier=spy)
    assert [len(b) for b in seen] == [batch_size] * (5 // batch_size) + \
        ([5 % batch_size] if 5 % batch_size else [])
    assert all(b.dtype == np.float32 and b.min() >= -1 and b.max() <= 1
               for b in seen)


def test_mouth_heuristic_matches_jax(bisenet_sd, tmp_path):
    _, sd = bisenet_sd
    clf = num_smiles.mouth_heuristic_classifier(
        params=faceparse.BiSeNet().params_from_torch(sd), device="cpu")
    jclf = jax_smiles.mouth_heuristic_classifier(
        params=jface.BiSeNet().params_from_torch(sd))
    imgs = np.random.RandomState(4).uniform(-1, 1, (3, 64, 64, 3)).astype(
        np.float32)
    imgs[1] *= 0.1
    got = clf(imgs)
    assert got.dtype == torch.bool and got.shape == (3,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jclf(imgs)))


def test_default_classifier_and_main(bisenet_sd, smile_dir, tmp_path,
                                     monkeypatch, capsys):
    """Without celeba_20.pth the face parser's heuristic counts; main
    prints the count of the classifier it builds."""
    _, sd = bisenet_sd
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
               tmp_path / faceparse.WEIGHTS_FILENAME)
    monkeypatch.setenv("REWRITING_TPU_WEIGHTS", str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        num_smiles.default_classifier()
    clf = num_smiles.default_classifier(device="cpu")
    count = num_smiles.count_smiles(smile_dir, n=6, batch_size=4,
                                    classifier=clf)
    default = num_smiles.default_classifier
    monkeypatch.setattr(num_smiles, "default_classifier",
                        lambda: default(device="cpu"))
    num_smiles.main([smile_dir, "--n", "6"])
    assert capsys.readouterr().out.strip() == str(count)
    assert count == jax_smiles.count_smiles(smile_dir, n=6, batch_size=4)

"""The port's segmenters (``segment/``: nn, prroi, resnet, upernet,
segmenter) against the JAX package's, on the same params and inputs.

- The resizes at a shrink and at a growth, the adaptive pool, the conv
  (groups, dilation, relu6), the max pool and the BatchNorm folding: 1e-5
  of the largest entry (measured up to 1.9e-6; the conv and the folding
  0), but the corner-aligned bilinear, 1e-4 (measured 1.2e-5 at 64 -> 16:
  the two packages round the source coordinate i * 63 / 15 apart);
  nearest: equal.
- PrRoI: the JAX package's to 1e-6 (measured 1.3e-7), and the
  numerical-integration cases of tests/test_segment.py.
- The ResNet-18 and ResNet-50 features, and UPerNet's head outputs before
  their softmax (``UPerNet.logits``; the JAX package's softmax made the
  identity), on the upernet_tiny golden's converted weights: 1e-4 of the
  largest (measured 1.3e-6 and 2.5e-6: the golden's BatchNorms blow the
  logits up to 2.6e3, so softmax maps agree only to 6.5e-4 where two
  classes nearly tie: a softmax moves by up to a quarter of its logits'
  change there).
  UPerNet against the golden as tests/test_segment_parity.py holds the
  JAX package: features 1e-5 of their scale, decisions 95%.
- ``UnifiedParsingSegmenter`` on ``LABELDATA``: labels equal to the JAX
  package's wherever the top-two softmax margin exceeds 1e-4 (it does at
  every pixel here, so the quads are held whole), with and without quads,
  uint8 against float; ``predict_single_class`` of an object, a material
  and a part: scores 1e-3, masks where the margin exceeds 1e-4.
- ``NoSegmenter``, ``MergedSegmenter``; ``load_segmenter("netpqc")`` and
  ``load_seg_model`` of every registry entry from a weights directory
  holding the goldens' state dicts, against the JAX loaders.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rewriting_tpu.metrics import load_seg as jax_load_seg
from rewriting_tpu.segment import nn as jnn
from rewriting_tpu.segment import prroi as jprroi
from rewriting_tpu.segment import resnet as jresnet
from rewriting_tpu.segment import segmenter as jseg
from rewriting_tpu.segment.upernet import UPerNet as JaxUPerNet
from rewriting_torch.core.tree import leaves
from rewriting_torch.metrics import load_seg
from rewriting_torch.segment import (MergedSegmenter, NoSegmenter,
                                     UnifiedParsingSegmenter, load_segmenter)
from rewriting_torch.segment import nn as tnn
from rewriting_torch.segment import prroi, resnet
from rewriting_torch.segment import upernet as tupernet
from rewriting_torch.segment.faceparse import FaceSegmenter
from rewriting_torch.segment.segmenter import upernet_for
from rewriting_torch.segment.semantic import PPMDecoder

torch.set_num_threads(1)

TOL = 1e-4
LABELDATA = {
    "object": ["-", "sky", "building", "tree"],
    "part": ["-", "roof", "window", "tree"],
    "material": ["-", "brick", "glass"],
    "scene": ["-", "outdoor"],
    "object_part": {"building": ["roof", "window", "tree"]},
}
COLOURS = ["black", "blue", "brown", "gray", "green", "orange", "pink",
           "purple", "red", "white", "yellow"]


def nchw(x):
    return np.transpose(np.asarray(x), (0, 3, 1, 2))


def nhwc_t(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x,
                                                              (0, 3, 1, 2))))


def rel_err(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / max(np.abs(np.asarray(want)).max(), 1e-30))


def margin(p):
    """The top-two margin along axis 1 of (B, C, H, W) scores."""
    s = np.sort(np.asarray(p), axis=1)
    return s[:, -1] - s[:, -2]


# -- functional layers -----------------------------------------------------------

RESIZES = [((16, 16), (64, 64)), ((64, 64), (16, 16)), ((37, 53), (20, 31)),
           ((20, 31), (37, 53)), ((256, 256), (178, 218)),
           ((30, 30), (123, 123))]


@pytest.mark.parametrize("src,dst", RESIZES,
                         ids=[f"{a[0]}to{b[0]}" for a, b in RESIZES])
def test_resizes_match_jax(src, dst):
    rng = np.random.RandomState(0)
    x = rng.randn(2, *src, 3).astype(np.float32)
    t = nhwc_t(x)
    got = tnn.resize_bilinear(t, dst).numpy()
    assert rel_err(got, nchw(jnn.resize_bilinear(jnp.asarray(x), dst))) \
        <= 1e-5
    got = tnn.resize_bilinear(t, dst, align_corners=True).numpy()
    want = jnn.resize_bilinear(jnp.asarray(x), dst, align_corners=True)
    assert rel_err(got, nchw(want)) <= TOL
    np.testing.assert_array_equal(
        tnn.resize_nearest(t, dst).numpy(),
        nchw(jnn.resize_nearest(jnp.asarray(x), dst)))
    labels = rng.randint(0, 19, (2, 1) + src)
    np.testing.assert_array_equal(
        tnn.resize_nearest(torch.from_numpy(labels), dst).numpy(),
        np.asarray(jax.image.resize(labels, (2, 1) + dst, "nearest")))
    got = tnn.adaptive_avg_pool(t, dst).numpy()
    assert rel_err(got, nchw(jnn.adaptive_avg_pool(jnp.asarray(x), dst))) \
        <= 1e-5


def test_conv_pool_and_fold_match_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 9, 11, 8).astype(np.float32)
    sd = {"c.weight": rng.randn(8, 4, 3, 3).astype(np.float32),
          "c.bias": rng.randn(8).astype(np.float32),
          "bn.weight": rng.rand(8).astype(np.float32) + 0.5,
          "bn.bias": rng.randn(8).astype(np.float32),
          "bn.running_mean": rng.randn(8).astype(np.float32),
          "bn.running_var": rng.rand(8).astype(np.float32) + 0.5}
    for bn in ("bn", None):
        p = tnn.fold_bn(sd, "c", bn)
        jp = jnn.fold_bn(sd, "c", bn)
        for k in ("weight", "bias"):
            np.testing.assert_allclose(p[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=0)
        for kw in ({"groups": 2, "padding": 2, "dilation": 2, "relu": True},
                   {"groups": 2, "stride": 2, "padding": 1, "relu6": True}):
            got = tnn.conv(nhwc_t(x), p, **kw).numpy()
            assert rel_err(got, nchw(jnn.conv(jnp.asarray(x), jp, **kw))) \
                <= 1e-5
    np.testing.assert_array_equal(tnn.maxpool(nhwc_t(x)).numpy(),
                                  nchw(jnn.maxpool(jnp.asarray(x))))


# -- PrRoI ---------------------------------------------------------------------------

def _bilinear_at(fmap, ys, xs):
    """The zero-extended bilinear interpolant, evaluated densely."""
    h, w = fmap.shape
    out = np.zeros((len(ys), len(xs)))
    for i in range(h):
        wy = np.maximum(0.0, 1.0 - np.abs(ys - i))
        for j in range(w):
            wx = np.maximum(0.0, 1.0 - np.abs(xs - j))
            out += fmap[i, j] * wy[:, None] * wx[None, :]
    return out


def test_prroi_matches_jax_and_numerical_integration():
    rng = np.random.RandomState(0)
    h, w, pooled = 5, 7, 3
    fmap = rng.randn(h, w).astype(np.float32)
    x = fmap[None, None]
    out = prroi.prroi_pool_full_image(torch.from_numpy(x), pooled).numpy()
    want = jprroi.prroi_pool_full_image(jnp.asarray(fmap[None, :, :, None]),
                                        pooled)
    assert rel_err(out, nchw(want)) <= 1e-6
    n = 2000
    for py in range(pooled):
        for px in range(pooled):
            ys = np.linspace(py * h / pooled, (py + 1) * h / pooled, n)
            xs = np.linspace(px * w / pooled, (px + 1) * w / pooled, n)
            np.testing.assert_allclose(out[0, 0, py, px],
                                       _bilinear_at(fmap, ys, xs).mean(),
                                       atol=5e-3, err_msg=f"bin {py},{px}")
    feats = rng.randn(2, 3, 6, 8).astype(np.float32)
    rois = np.array([[1, 0.5, 1.0, 7.0, 5.5], [0, 0, 0, 8, 6]], np.float32)
    got = prroi.prroi_pool2d(torch.from_numpy(feats), rois, 2, 3, 1.0)
    want = jprroi.prroi_pool2d(np.transpose(feats, (0, 2, 3, 1)), rois, 2, 3)
    assert got.shape == (2, 3, 2, 3)
    assert rel_err(got.numpy(), nchw(want)) <= 1e-6


def test_prroi_edge_cases():
    """A constant map's interior bins stay constant (its far edge decays);
    a linear ramp rises; a full-image RoI equals the full-image pool; 1x1
    bins at integer offsets are the trapezoid of adjacent samples."""
    x = torch.full((1, 2, 6, 6), 3.5)
    out = prroi.prroi_pool_full_image(x, 3)
    np.testing.assert_allclose(out[0, :, 1, 1].numpy(), 3.5, rtol=1e-5)
    assert out[0, 0, 2, 2] < 3.5
    ramp = torch.arange(8, dtype=torch.float32).expand(1, 1, 8, 8)
    out = prroi.prroi_pool_full_image(ramp, 2)
    assert out[0, 0, 0, 0] < out[0, 0, 0, 1]
    roi = np.array([[0, 0, 0, 8, 8]], np.float32)
    np.testing.assert_allclose(prroi.prroi_pool2d(ramp, roi, 2, 2).numpy(),
                               out.numpy(), rtol=1e-5)
    x = np.random.RandomState(0).randn(1, 1, 4, 4).astype(np.float32)
    want = 0.5 * (x + np.pad(x, ((0, 0), (0, 0), (0, 1), (0, 0)))[:, :, 1:])
    want = 0.5 * (want + np.pad(want, ((0, 0), (0, 0), (0, 0),
                                       (0, 1)))[:, :, :, 1:])
    np.testing.assert_allclose(
        prroi.prroi_pool_full_image(torch.from_numpy(x), 4).numpy(), want,
        atol=1e-5)


# -- backbones and UPerNet -----------------------------------------------------

@pytest.fixture(scope="module")
def upp(goldens):
    g = goldens("upernet_tiny")
    enc = {k[4:]: g[k] for k in g.files if k.startswith("enc.")}
    dec = {k[4:]: g[k] for k in g.files if k.startswith("dec.")}
    object_part = {2: [1, 2, 3]}
    jnet = JaxUPerNet({"object": 4, "part": 3, "material": 3, "scene": 2},
                      [2], object_part)
    return {"g": g, "enc": enc, "dec": dec, "jnet": jnet,
            "jparams": jnet.params_from_torch(enc, dec),
            "net": upernet_for(LABELDATA),
            "params": upernet_for(LABELDATA).params_from_torch(enc, dec)}


def test_resnet_features_match_jax(upp, goldens):
    img = np.random.RandomState(2).uniform(-2, 2, (1, 64, 64, 3)).astype(
        np.float32)
    feats = resnet.resnet50_features(upp["params"]["encoder"], nhwc_t(img))
    jfeats = jresnet.resnet50_features(upp["jparams"]["encoder"], img)
    assert [tuple(f.shape) for f in feats] == \
        [(1, 256, 16, 16), (1, 512, 8, 8), (1, 1024, 4, 4), (1, 2048, 2, 2)]
    for f, jf in zip(feats, jfeats):
        assert rel_err(f.numpy(), nchw(jf)) <= TOL
    g = goldens("bisenet_tiny")
    sd = {k[3:]: g[k] for k in g.files if k.startswith("sd.")}
    p18 = resnet.resnet18_from_torch(sd, "cp.resnet.")
    jp18 = jresnet.resnet18_from_torch(sd, "cp.resnet.")
    feats = resnet.resnet18_features(p18, nhwc_t(img))
    jfeats = jresnet.resnet18_features(jp18, img)
    assert [tuple(f.shape) for f in feats] == \
        [(1, 128, 8, 8), (1, 256, 4, 4), (1, 512, 2, 2)]
    for f, jf in zip(feats, jfeats):
        assert rel_err(f.numpy(), nchw(jf)) <= TOL
    for p in (resnet.init_resnet18(0), resnet.init_resnet50(0)):
        assert all(v.dtype == torch.float32 for _, v in leaves(p))


def test_upernet_matches_jax_and_golden(upp, monkeypatch):
    g = upp["g"]
    img = np.transpose(g["img"], (0, 2, 3, 1))
    with torch.no_grad():
        out = upp["net"](upp["params"], torch.from_numpy(g["img"]),
                         seg_size=(64, 64))
    feats = resnet.resnet50_features(upp["params"]["encoder"],
                                     torch.from_numpy(g["img"]))
    for i in range(4):
        ref = g[f"feat_{i}"]
        assert rel_err(feats[i].numpy(), ref) <= 1e-5, i
    for key, mine in [("object", out["object"]),
                      ("material", out["material"]),
                      ("part_0", out["part"][0])]:
        agree = (mine.numpy().argmax(1) == g[key].argmax(1)).mean()
        assert agree > 0.95, (key, agree)
    assert int(out["scene"].argmax()) == int(g["scene"].argmax())
    # the heads' outputs before the softmax (the JAX package's softmax made
    # the identity)
    monkeypatch.setattr(jax.nn, "softmax", lambda x, axis=-1: x)
    with torch.no_grad():
        logits = upp["net"].logits(upp["params"], torch.from_numpy(g["img"]),
                                   seg_size=(64, 64))
    jlogits = upp["jnet"](upp["jparams"], img, seg_size=(64, 64))
    for key in ("object", "material"):
        assert rel_err(logits[key].numpy(), nchw(jlogits[key])) <= TOL, key
    assert rel_err(logits["part"].numpy(), nchw(jlogits["part"][0])) <= TOL
    assert rel_err(logits["scene"].numpy(), jlogits["scene"]) <= TOL
    assert logits["object"].shape == (1, 4, 64, 64)


def test_upernet_init_params_widths():
    net = upernet_for(LABELDATA)
    params = net.init_params(0)
    dec = params["decoder"]
    assert dec["conv_fusion"]["weight"].shape == (512, 2048, 3, 3)
    assert dec["object_head_out"]["weight"].shape == (4, 512, 1, 1)
    assert dec["part_head_out"]["weight"].shape == (3, 512, 1, 1)
    assert len(dec["ppm_conv"]) == len(tupernet.POOL_SCALES)


# -- unified parsing ----------------------------------------------------------

@pytest.fixture(scope="module")
def upp_segmenters(upp):
    out = {}
    for segdiv in (None, "quad"):
        out[segdiv] = (
            UnifiedParsingSegmenter(upp["params"], LABELDATA, segsizes=[64],
                                    segdiv=segdiv, device="cpu"),
            jseg.UnifiedParsingSegmenter(upp["jparams"], LABELDATA,
                                         segsizes=[64], segdiv=segdiv))
    return out


IMAGES = np.random.RandomState(3).uniform(-1, 1, (2, 64, 64, 3)).astype(
    np.float32)


@pytest.mark.parametrize("segdiv", [None, "quad"], ids=["plain", "quad"])
def test_unified_parsing_segment_batch_matches_jax(upp_segmenters, segdiv):
    seg, jseg_ = upp_segmenters[segdiv]
    segs = seg.segment_batch(torch.from_numpy(IMAGES))
    assert segs.dtype == torch.int64 and segs.device.type == "cpu"
    assert segs.shape == (2, 5 if segdiv else 3, 64, 64)
    want = jseg_.segment_batch(IMAGES)
    pred, parts = seg.raw_seg_prediction(IMAGES)
    confident = ((margin(pred["object"]) > TOL)
                 & (margin(pred["material"]) > TOL)
                 & (margin(parts[0]) > TOL))
    assert confident.all()
    np.testing.assert_array_equal(segs.numpy(), want)
    assert seg.num_classes == jseg_.num_classes
    assert seg.get_label_and_category_names() == \
        jseg_.get_label_and_category_names()
    if segdiv:
        divided = segs[:, 3:][segs[:, 3:] > 0]
        assert divided.numel() and int(divided.min()) > seg.num_object_classes


def test_unified_parsing_uint8_matches_float(upp_segmenters):
    """uint8 goes straight to the BGR mean subtraction; float through
    (x + 1) / 2 * 255: the labels agree."""
    seg, _ = upp_segmenters[None]
    u8 = np.random.RandomState(11).randint(0, 256, (2, 64, 64, 3), np.uint8)
    zc = (u8.astype(np.float32) / 255.0) * 2.0 - 1.0
    pu, _ = seg.raw_seg_prediction(torch.from_numpy(u8))
    pf, _ = seg.raw_seg_prediction(zc)
    for k in pu:
        np.testing.assert_allclose(pu[k].numpy(), pf[k].numpy(), atol=1e-3,
                                   rtol=0)
    assert (seg.segment_batch(u8) == seg.segment_batch(zc)).float().mean() \
        > 0.995


@pytest.mark.parametrize("classnum", [2, 5, 7],
                         ids=["object", "material", "part"])
def test_predict_single_class_matches_jax(upp_segmenters, classnum):
    seg, jseg_ = upp_segmenters[None]
    score, mask = seg.predict_single_class(IMAGES, classnum)
    jscore, jmask = jseg_.predict_single_class(IMAGES, classnum)
    assert score.shape == mask.shape == (2, 64, 64)
    assert mask.dtype == torch.bool
    np.testing.assert_allclose(score.numpy(), np.asarray(jscore), atol=1e-3,
                               rtol=0)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    with pytest.raises(ValueError):
        seg.predict_single_class(IMAGES, 99)


def test_no_and_merged_segmenters():
    a = NoSegmenter()
    x = torch.zeros((2, 16, 16, 3))
    assert a.segment_batch(x).shape == (2, 1, 16, 16)
    m = MergedSegmenter([a, a])
    jm = jseg.MergedSegmenter([jseg.NoSegmenter(), jseg.NoSegmenter()])
    out = m.segment_batch(x)
    np.testing.assert_array_equal(out.numpy(),
                                  jm.segment_batch(np.zeros((2, 16, 16, 3))))
    assert out[:, 0].max() == 0 and (out[:, 1] == 1).all()
    assert m.get_label_and_category_names() == \
        jm.get_label_and_category_names()
    score, mask = m.predict_single_class(x, 1)
    assert score.shape == mask.shape == (2, 16, 16)
    assert a.segment_batch(x, downsample=2).shape == (2, 1, 8, 8)


# -- loading the released models --------------------------------------------------

def _save(sd, path):
    torch.save({k: torch.as_tensor(np.array(v)) for k, v in sd.items()},
               path)


@pytest.fixture(scope="module")
def weights_dir(upp, goldens, tmp_path_factory):
    """The goldens' state dicts under the released file names: upp/ (the
    UPerNet golden, LABELDATA), the colour model (dilated_resnet's r18
    encoder, a seeded PPM decoder with identity BatchNorms, 11 colours at
    segsize 64) and the face parser (bisenet_tiny)."""
    root = tmp_path_factory.mktemp("weights")
    os.makedirs(root / "upp")
    _save(upp["enc"], root / "upp" / "encoder_epoch_40.pth")
    _save(upp["dec"], root / "upp" / "decoder_epoch_40.pth")
    with open(root / "upp" / "labels.json", "w") as f:
        json.dump(LABELDATA, f)
    colour = root / "segmodel" / "color-resnet18dilated-ppm_deepsup"
    os.makedirs(colour)
    g = goldens("dilated_resnet")
    _save({k[len("r18.sd."):]: g[k] for k in g.files
           if k.startswith("r18.sd.")}, colour / "encoder_epoch_20.pth")
    ppm = PPMDecoder(len(COLOURS), 512)
    _save(ppm.params_to_torch(ppm.init_params(0)),
          colour / "decoder_epoch_20.pth")
    with open(colour / "labels.json", "w") as f:
        json.dump({"labels": [{"name": c} for c in COLOURS],
                   "imageformat": {"byteorder": "BGR",
                                   "mean": [0.485, 0.456, 0.406],
                                   "stdev": [0.229, 0.224, 0.225]},
                   "segsizes": [64]}, f)
    g = goldens("bisenet_tiny")
    _save({k[3:]: g[k] for k in g.files if k.startswith("sd.")},
          root / "face-parsing-02dd3f6f.pth")
    return str(root)


def test_load_segmenter_netpqc_matches_jax(weights_dir, monkeypatch):
    monkeypatch.setenv("REWRITING_TPU_WEIGHTS", weights_dir)
    seg, labels = load_segmenter("netpqc", device="cpu")
    jseg_, jlabels = jseg.load_segmenter("netpqc")
    assert labels == jlabels
    assert len(labels) == seg.segmenters[0].num_classes + len(COLOURS)
    assert isinstance(seg, MergedSegmenter) and len(seg.segmenters) == 2
    upp_t, col_t = seg.segmenters
    upp_j, col_j = jseg_.segmenters
    for mine, theirs in ((upp_t.params, upp_j.params),
                         (col_t.params, col_j.params)):
        got = dict(leaves(mine))
        want = dict(leaves(jax.tree_util.tree_map(np.asarray, theirs)))
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert col_t.imageformat["byteorder"] == "BGR" and col_t.segsizes == [64]
    upp_t.segsizes = upp_j.segsizes = [64]
    segs = seg.segment_batch(torch.from_numpy(IMAGES[:1]))
    assert segs.shape == (1, 6, 64, 64)
    np.testing.assert_array_equal(segs.numpy(),
                                  jseg_.segment_batch(IMAGES[:1]))
    assert int(segs[:, 5].min()) >= upp_t.num_classes


def test_load_segmenter_flags(upp, weights_dir, monkeypatch):
    """'netq' builds from given params, with quads and no colour model;
    'c' or 'x' demand their released model."""
    seg, labels = load_segmenter("netq", params=upp["params"],
                                 labeldata=LABELDATA, device="cpu")
    assert isinstance(seg, UnifiedParsingSegmenter)
    assert seg.segdiv == "quad" and labels[0] == "-"
    monkeypatch.setenv("REWRITING_TPU_WEIGHTS", os.path.join(weights_dir,
                                                             "none"))
    with pytest.raises(FileNotFoundError, match="color"):
        load_segmenter("netqc", params=upp["params"], labeldata=LABELDATA,
                       device="cpu")
    with pytest.raises(FileNotFoundError, match="unified-parsing"):
        load_segmenter("netp", device="cpu")
    monkeypatch.setenv("REWRITING_TPU_WEIGHTS", weights_dir)
    with pytest.raises(FileNotFoundError, match="texture"):
        load_segmenter("netx", device="cpu")
    with pytest.raises(ValueError):
        load_segmenter("upp", device="cpu")


@pytest.mark.parametrize("exp", sorted(load_seg.info))
def test_load_seg_model_every_entry(exp, weights_dir, monkeypatch):
    monkeypatch.setenv("REWRITING_TPU_WEIGHTS", weights_dir)
    model = load_seg.load_seg_model(exp, device="cpu")
    jmodel = jax_load_seg.load_seg_model(exp)
    assert type(model).__name__ == type(jmodel).__name__
    assert model.get_label_and_category_names() == \
        jmodel.get_label_and_category_names()
    if isinstance(model, FaceSegmenter):
        assert model.device.type == "cpu"
    else:
        assert [s.device.type for s in model.segmenters] == ["cpu", "cpu"]


def test_state_dicts_round_trip_through_both_converters():
    """Params written in the released layouts (identity BatchNorms: the
    seeded files of chip_smoke.py) read back bit for bit, and the JAX
    package's converters read the same tensors."""
    from rewriting_tpu.segment import faceparse as jface
    from rewriting_tpu.segment import semantic as jsem
    from rewriting_torch.segment import faceparse, semantic

    def same(mine, theirs):
        got, want = dict(leaves(mine)), dict(leaves(theirs))
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(
                want[k]), err_msg=k)

    net = upernet_for(LABELDATA)
    params = net.init_params(0)
    enc, dec = net.params_to_torch(params)
    same(net.params_from_torch(enc, dec), params)
    jnet = JaxUPerNet({"object": 4, "part": 3, "material": 3, "scene": 2},
                      [2], {2: [1, 2, 3]})
    same(params, jnet.params_from_torch(enc, dec))
    bise = faceparse.BiSeNet()
    params = bise.init_params(0)
    sd = bise.params_to_torch(params)
    same(bise.params_from_torch(sd), params)
    same(params, jface.BiSeNet().params_from_torch(sd))
    params = semantic.init_resnet18_deepstem(0)
    sd = semantic.resnet18_deepstem_to_torch(params)
    same(semantic.resnet18_deepstem_from_torch(sd), params)
    same(params, jsem.resnet18_deepstem_from_torch(sd))
    ppm = semantic.PPMDecoder(num_class=5, fc_dim=512)
    params = ppm.init_params(0)
    sd = ppm.params_to_torch(params)
    same(ppm.params_from_torch(sd), params)
    same(params, jsem.PPMDecoder(5, 512).params_from_torch(sd))


def test_jax_trees_carry_across(upp, goldens):
    """``convert.tree_from_jax`` turns the JAX package's params (UPerNet
    with its ResNet-50, BiSeNet with its ResNet-18, the deep-stem ResNet-18
    and PPM) into the port's, leaf for leaf: the same names, lists and
    values as the port's own converters give."""
    from rewriting_tpu.segment import faceparse as jface
    from rewriting_tpu.segment import semantic as jsem
    from rewriting_torch.convert import tree_from_jax
    from rewriting_torch.segment import faceparse, semantic

    def carried(jtree, want):
        got = tree_from_jax(jax.tree_util.tree_map(np.asarray, jtree))
        got, want = dict(leaves(got)), dict(leaves(want))
        assert got.keys() == want.keys()
        for k in got:
            assert torch.equal(got[k], want[k]), k

    carried(upp["jparams"], upp["params"])
    g = goldens("bisenet_tiny")
    sd = {k[3:]: g[k] for k in g.files if k.startswith("sd.")}
    carried(jface.BiSeNet().params_from_torch(sd),
            faceparse.BiSeNet().params_from_torch(sd))
    g = goldens("dilated_resnet")
    enc = {k[len("r18.sd."):]: g[k] for k in g.files
           if k.startswith("r18.sd.")}
    ppm = semantic.PPMDecoder(11, 512)
    dec = ppm.params_to_torch(ppm.init_params(0))
    carried({"encoder": jsem.resnet18_deepstem_from_torch(enc),
             "decoder": jsem.PPMDecoder(11, 512).params_from_torch(dec)},
            {"encoder": semantic.resnet18_deepstem_from_torch(enc),
             "decoder": ppm.params_from_torch(dec)})

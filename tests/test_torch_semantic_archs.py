"""The port's ``SemanticSegmenter`` encoders and decoders beyond the
released texture and colour models (``segment/semantic.py``,
``segment/resnet.py``): the dilated ResNet-50, ResNet-101 (dilated and
not), MobileNetV2Dilated, ResNeXt101, and the C1 and C1DeepSup decoders,
against the torch-made goldens (``dilated_resnet.npz``, ``segzoo.npz``)
and the JAX package on the same converted weights.

Spec: tests/test_semantic_misc.py (``test_dilated_resnet_parity`` r50
entries, ``test_mobilenetv2_dilated_parity``, ``test_resnext101_parity``,
``test_deepsup_decoders_parity``, ``test_c1_decoder_shapes``,
``test_semantic_segmenter_new_archs``).

Tolerances, the JAX tests' own: features over their largest value 2e-5
(dilated ResNet-50), 3e-5 (MobileNetV2), 5e-5 (ResNeXt101) against the
golden and the JAX package; the decoders' softmax maps 2e-5 abs; the
segmenters' summed softmax maps 1e-4 abs against the JAX package on the
same weights, and their labels equal where the top two classes are more
than 1e-4 apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rewriting_tpu.segment import resnet as jresnet
from rewriting_tpu.segment import semantic as jsem
from rewriting_torch.convert import tree_from_jax
from rewriting_torch.segment import resnet, semantic

torch.set_num_threads(1)


def _sd(g, name):
    return {k[len(name) + 4:]: g[k] for k in g.files
            if k.startswith(f"{name}.sd.")}


def leaves(tree, path=()):
    """(path, tensor) of a params tree, in a fixed order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (i,))
    else:
        yield path, tree


def _held(got, ref, atol, label):
    scale = max(np.abs(ref).max(), 1e-6)
    np.testing.assert_allclose(got / scale, ref / scale, atol=atol,
                               err_msg=label)


def _nhwc(x):
    return jnp.asarray(np.transpose(x, (0, 2, 3, 1)))


def _nchw(a):
    return np.transpose(np.asarray(a), (0, 3, 1, 2))


@pytest.mark.parametrize("arch", ["r50", "mbv2", "rnx"])
def test_encoder_parity(goldens, arch):
    """Each encoder's stage features against the reference's (the golden)
    and the JAX package's, from the same state dict: the r50 entries of
    the dilated-ResNet golden (dilate 8, the dilate // 2 rule on the
    formerly strided conv), MobileNetV2Dilated (the _nostride_dilate of
    blocks 7-17, the original-stride residual rule) and the undilated
    ResNeXt101 (grouped bottlenecks)."""
    golden = "dilated_resnet" if arch == "r50" else "segzoo"
    g = goldens(golden)
    sd = _sd(g, arch)
    x = g["x"]
    if arch == "r50":
        params = resnet.resnet50_from_torch(sd)
        feats = semantic.resnet50_dilated_features(params, torch.tensor(x), 8)
        jfeats = jsem.resnet50_dilated_features(
            jresnet.resnet50_from_torch(sd), _nhwc(x), dilate_scale=8)
        atol, n = 2e-5, 4
    elif arch == "mbv2":
        params = semantic.mobilenetv2_from_torch(sd)
        feats = semantic.mobilenetv2_dilated_features(params,
                                                      torch.tensor(x), 8)
        jfeats = jsem.mobilenetv2_dilated_features(
            jsem.mobilenetv2_from_torch(sd), _nhwc(x), dilate_scale=8)
        atol, n = 3e-5, 5
    else:
        params = semantic.resnext101_from_torch(sd)
        feats = semantic.resnext101_features(params, torch.tensor(x))
        jfeats = jsem.resnext101_features(jsem.resnext101_from_torch(sd),
                                          _nhwc(x))
        atol, n = 5e-5, 4
        assert feats[3].shape[1] == 2048
    assert len(feats) == n
    for i in range(n):
        got = feats[i].numpy()
        _held(got, g[f"{arch}.feat_{i}"], atol, f"{arch} feat_{i}")
        _held(got, _nchw(jfeats[i]), atol, f"{arch} feat_{i} vs JAX")


def test_state_dicts_round_trip(goldens):
    """The new encoders' ``*_to_torch`` write back what ``*_from_torch``
    read (identity BatchNorms), and ResNet-101 reads with its depth."""
    g = goldens("segzoo")
    for name, read, write in (
            ("mbv2", semantic.mobilenetv2_from_torch,
             semantic.mobilenetv2_to_torch),
            ("rnx", semantic.resnext101_from_torch,
             semantic.resnext101_to_torch)):
        params = read(_sd(g, name))
        again = read(write(params))
        for (path, a), (_, b) in zip(leaves(params), leaves(again)):
            assert torch.equal(a, b), (name, path)
    p101 = resnet.init_resnet50(0, layers=resnet.R101_LAYERS)
    assert len(p101["layer3"]) == 23
    back = resnet.resnet50_from_torch(
        resnet.resnet50_to_torch(p101, layers=resnet.R101_LAYERS),
        layers=resnet.R101_LAYERS)
    assert len(back["layer3"]) == 23


@pytest.mark.parametrize("name", ["ppmds", "c1ds"])
def test_deepsup_decoders_parity(goldens, name):
    """PPMDeepsup and C1DeepSup at inference, from their checkpoints'
    keys, against the golden and the JAX package."""
    g = goldens("segzoo")
    cls, jcls = {"ppmds": (semantic.PPMDeepsupDecoder,
                           jsem.PPMDeepsupDecoder),
                 "c1ds": (semantic.C1DeepSupDecoder,
                          jsem.C1DeepSupDecoder)}[name]
    sd = _sd(g, name)
    dec = cls(num_class=7, fc_dim=64)
    params = dec.params_from_torch(sd)
    conv5, conv4 = g["ppmds.conv5"], g["ppmds.conv4"]
    out = dec(params, [torch.tensor(conv4), torch.tensor(conv5)],
              seg_size=(32, 32)).numpy()
    np.testing.assert_allclose(out, g[f"{name}.out"], atol=2e-5)
    jdec = jcls(num_class=7, fc_dim=64)
    jout = jdec(jdec.params_from_torch(sd), [_nhwc(conv4), _nhwc(conv5)],
                seg_size=(32, 32))
    np.testing.assert_allclose(out, _nchw(jout), atol=2e-5)
    again = dec.params_from_torch(dec.params_to_torch(params))
    for (_, a), (_, b) in zip(leaves(params), leaves(again)):
        assert torch.equal(a, b)


def test_c1_decoder_shapes():
    dec = semantic.C1Decoder(num_class=7, fc_dim=32)
    params = dec.init_params(0)
    conv_out = [None, None, None, torch.zeros((1, 32, 4, 4))]
    out = dec(params, conv_out, seg_size=(16, 16))
    assert tuple(out.shape) == (1, 7, 16, 16)
    np.testing.assert_allclose(out.sum(1).numpy(), 1.0, atol=1e-5)
    assert tuple(dec.logits(params, conv_out).shape) == (1, 7, 4, 4)


@pytest.mark.parametrize("arch,decoder", [
    ("mobilenetv2dilated", "c1_deepsup"), ("resnext101", "ppm_deepsup"),
    ("resnet50dilated", "c1"), ("resnet101", "ppm"),
    ("resnet101dilated", "ppm_deepsup")])
def test_semantic_segmenter_new_archs(arch, decoder):
    """Each new arch and decoder through the whole SemanticSegmenter, on
    the JAX package's seeded weights carried across: the summed softmax
    maps and the labels against the JAX segmenter's; ResNeXt101 and
    ResNet-101 run undilated, as the reference wraps them."""
    labels = ["-", "a", "b"]
    imgs = np.random.RandomState(0).uniform(-1, 1, (1, 64, 64, 3)).astype(
        np.float32)
    jseg = jsem.SemanticSegmenter(None, labels, decoder=decoder, arch=arch,
                                  segsizes=[64])
    seg = semantic.SemanticSegmenter(
        tree_from_jax(jax.tree_util.tree_map(np.asarray, jseg.params)),
        labels, decoder=decoder, arch=arch, segsizes=[64], device="cpu")
    assert seg.dilate_scale == jseg.dilate_scale
    assert seg.decoder.fc_dim == jseg.decoder.fc_dim
    pred = seg.raw_seg_prediction(imgs).numpy()
    jpred = _nchw(jseg.raw_seg_prediction(imgs))
    np.testing.assert_allclose(pred, jpred, atol=1e-4)
    out = seg.segment_batch(imgs)
    assert tuple(out.shape) == (1, 1, 64, 64) and int(out.max()) < 3
    top = np.sort(jpred, axis=1)
    sure = top[:, -1] - top[:, -2] > 1e-4
    np.testing.assert_array_equal(out.numpy()[:, 0][sure],
                                  np.argmax(jpred, axis=1)[sure])


def test_seeded_segmenters_take_every_arch():
    """Every arch with seeded weights (params=None) runs; the ones the
    reference wraps undilated are set so."""
    imgs = np.zeros((1, 32, 32, 3), np.float32)
    for arch in semantic.SemanticSegmenter.FC_DIMS:
        seg = semantic.SemanticSegmenter(None, ["-", "a"], arch=arch,
                                         decoder="c1", segsizes=[32],
                                         device="cpu")
        assert seg.dilate_scale == (32 if arch in ("resnet101",
                                                   "resnext101") else 8)
        assert tuple(seg.segment_batch(imgs).shape) == (1, 1, 32, 32)

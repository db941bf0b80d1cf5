"""The semantic segmentation zoo: dilated ResNet, MobileNetV2 and
ResNeXt encoders, PPM and C1 decoders, and the single-category segmenter
around them, on NCHW tensors.

The port's counterpart of the JAX package's ``segment/semantic.py``
(reference utils/segmodel/models.py: ResnetDilated :209,
MobileNetV2Dilated :272, C1DeepSup :327, C1 :364, PPM :390, PPMDeepsup
:438; segmodel/resnext.py; utils/segmenter.py:392 SemanticSegmenter):
the encoders ``resnet18dilated`` (the released texture and colour models
that ``load_segmenter``'s 'x' and 'c' flags load), ``resnet50dilated``
(the class default), ``resnet101dilated``, ``resnet101`` and
``resnext101`` (both undilated, as the reference wraps them in its plain
Resnet) and ``mobilenetv2dilated``; the decoders ``ppm``,
``ppm_deepsup``, ``c1`` and ``c1_deepsup`` (each deep-supervision variant
is its plain one at inference); multi-resolution voting and argmax
labels.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from ..utils.device import resolve_device
from .nn import (adaptive_avg_pool, conv, generator, init_conv,
                 params_from_layout, resize_bilinear, state_dict_from_layout)
from .resnet import (BASIC, BOTTLENECK, R18_LAYERS, R18_PLANES, R50_LAYERS,
                     R101_LAYERS, deep_stem, in_params, in_state_dict,
                     init_deep_stem, init_resnet50, layout)
from .segmenter import BaseSegmenter, as_images, to_device

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _layer_dilations(dilate_scale: int):
    """Each layer's dilation and stride after the reference's
    _nostride_dilate (segmodel models.py:209-270): in a dilated layer the
    formerly strided conv gets dilate // 2, every other 3x3 conv dilate."""
    if dilate_scale == 8:
        return [1, 1, 2, 4], [1, 2, 1, 1]
    if dilate_scale == 16:
        return [1, 1, 1, 2], [1, 2, 2, 1]
    return [1, 1, 1, 1], [1, 2, 2, 2]


def _dilated_bottleneck(p: Dict, x, stride: int, dilate: int,
                        first_block: bool, groups: int = 1):
    # conv2 is the (formerly) strided 3x3; groups > 1 for ResNeXt's
    # GroupBottleneck (reference segmodel/resnext.py:32-68)
    d2 = max(dilate // 2, 1) if first_block else dilate
    out = conv(x, p["conv1"], relu=True)
    out = conv(out, p["conv2"], stride=stride, padding=d2, dilation=d2,
               relu=True, groups=groups)
    out = conv(out, p["conv3"])
    res = conv(x, p["downsample"], stride=stride) if "downsample" in p \
        else x
    return F.relu(out + res)


def resnet50_dilated_features(params: Dict, x, dilate_scale: int = 8,
                              layers=None) -> List:
    """The CSAIL deep-stem bottleneck resnet (50, or 101 with
    ``layers=R101_LAYERS``), layer3/layer4 dilated to output stride
    `dilate_scale` (reference ResnetDilated, segmodel models.py:209-270);
    32 is undilated."""
    x = deep_stem(params, x)
    dilations, strides = _layer_dilations(dilate_scale)
    outs = []
    for li, nblocks in enumerate(layers or R50_LAYERS):
        for bi in range(nblocks):
            stride = strides[li] if bi == 0 else 1
            x = _dilated_bottleneck(params[f"layer{li + 1}"][bi], x,
                                    stride, dilations[li], bi == 0)
        outs.append(x)
    return outs


def _dilated_basic_block(p: Dict, x, stride: int, dilate: int,
                         first_block: bool):
    # conv1 is a BasicBlock's (formerly) strided 3x3
    d1 = max(dilate // 2, 1) if first_block else dilate
    out = conv(x, p["conv1"], stride=stride, padding=d1, dilation=d1,
               relu=True)
    out = conv(out, p["conv2"], padding=dilate, dilation=dilate)
    res = conv(x, p["downsample"], stride=stride) if "downsample" in p \
        else x
    return F.relu(out + res)


def resnet18_dilated_features(params: Dict, x, dilate_scale: int = 8
                              ) -> List:
    """The CSAIL deep-stem resnet18 (BasicBlocks), dilated to output stride
    `dilate_scale`: the texture and colour models' encoder (segarch
    'resnet18dilated', reference segmenter.py:28-34)."""
    x = deep_stem(params, x)
    dilations, strides = _layer_dilations(dilate_scale)
    outs = []
    for li, nblocks in enumerate(R18_LAYERS):
        for bi in range(nblocks):
            stride = strides[li] if bi == 0 else 1
            x = _dilated_basic_block(params[f"layer{li + 1}"][bi], x,
                                     stride, dilations[li], bi == 0)
        outs.append(x)
    return outs


def init_resnet18_deepstem(seed=0) -> Dict:
    """Seeded params of the deep-stem resnet18; CPU tensors."""
    gen = generator(seed)
    params = init_deep_stem(gen)
    in_c = 128
    for li, (nblocks, planes) in enumerate(zip(R18_LAYERS, R18_PLANES)):
        blocks = []
        for bi in range(nblocks):
            p = {"conv1": init_conv(gen, planes, in_c, 3),
                 "conv2": init_conv(gen, planes, planes, 3)}
            if bi == 0 and (li > 0 or in_c != planes):
                p["downsample"] = init_conv(gen, planes, in_c, 1)
            blocks.append(p)
            in_c = planes
        params[f"layer{li + 1}"] = blocks
    return params


def resnet18_deepstem_from_torch(sd: Dict, prefix: str = "") -> Dict:
    return params_from_layout(sd, layout(prefix, R18_LAYERS, BASIC, True,
                                         in_state_dict(sd, prefix)))


def resnet18_deepstem_to_torch(params: Dict, prefix: str = "") -> Dict:
    return state_dict_from_layout(params, layout(
        prefix, R18_LAYERS, BASIC, True, in_params(params)))


# -- MobileNetV2Dilated (reference segmodel/models.py:272-325 over the
# vendored mobilenet.py InvertedResidual stack) ------------------------------

# (expand ratio t, out channels c, repeats n, stride s): mobilenet.py:93-101
MBV2_SETTINGS = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
                 (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
MBV2_DOWN_IDX = [2, 4, 7, 14]  # features after which a stage ends (:283)


def _mbv2_block_plan(dilate_scale: int) -> List[Dict]:
    """Each block's expand ratio, widths, depthwise stride and dilation and
    residual, after the reference's _nostride_dilate (models.py:284-311):
    features[7:14] dilate 2 and features[14:] dilate 4 at scale 8,
    features[14:] dilate 2 at scale 16.  The residual is decided by the
    ORIGINAL stride (mobilenet.py:53)."""
    plan = []
    in_c = 32
    idx = 1
    for t, c, n, s in MBV2_SETTINGS:
        for bi in range(n):
            stride = s if bi == 0 else 1
            if dilate_scale == 8:
                dilate = 2 if 7 <= idx < 14 else (4 if idx >= 14 else None)
            elif dilate_scale == 16:
                dilate = 2 if idx >= 14 else None
            else:
                dilate = None
            if dilate is not None:
                dw_stride = 1
                dw_dil = dilate // 2 if stride == 2 else dilate
            else:
                dw_stride, dw_dil = stride, 1
            plan.append(dict(t=t, in_c=in_c, out_c=c, dw_stride=dw_stride,
                             dw_dil=dw_dil,
                             residual=(stride == 1 and in_c == c)))
            in_c = c
            idx += 1
    return plan


def mobilenetv2_dilated_features(params: Dict, x, dilate_scale: int = 8
                                 ) -> List:
    """The reference MobileNetV2Dilated with return_feature_maps
    (models.py:313-325): the map after each stage's last block, and the
    last."""
    x = conv(x, params["stem"], stride=2, padding=1, relu6=True)
    outs = []
    for idx, (p, cfg) in enumerate(zip(params["blocks"],
                                       _mbv2_block_plan(dilate_scale)),
                                   start=1):
        h = x
        if cfg["t"] != 1:
            h = conv(h, p["expand"], relu6=True)
        h = conv(h, p["dw"], stride=cfg["dw_stride"], padding=cfg["dw_dil"],
                 dilation=cfg["dw_dil"], groups=cfg["in_c"] * cfg["t"],
                 relu6=True)
        h = conv(h, p["project"])
        x = x + h if cfg["residual"] else h
        if idx in MBV2_DOWN_IDX:
            outs.append(x)
    outs.append(x)
    return outs


def init_mobilenetv2(seed=0) -> Dict:
    """Seeded params of MobileNetV2Dilated; CPU tensors."""
    gen = generator(seed)
    params: Dict = {"stem": init_conv(gen, 32, 3, 3)}
    blocks = []
    for cfg in _mbv2_block_plan(8):
        hidden = cfg["in_c"] * cfg["t"]
        p = {}
        if cfg["t"] != 1:
            p["expand"] = init_conv(gen, hidden, cfg["in_c"], 1)
        p["dw"] = init_conv(gen, hidden, 1, 3)
        p["project"] = init_conv(gen, cfg["out_c"], hidden, 1)
        blocks.append(p)
    params["blocks"] = blocks
    return params


def _mbv2_layout(prefix: str) -> List:
    """features.0 the stem, features.1 .. 17 the InvertedResiduals: (dw,
    bn, relu6, 1x1, bn), or with expansion (1x1, bn, relu6, dw, bn, relu6,
    1x1, bn); MobileNetV2Dilated drops the last 1x1 conv, features.18."""
    rows = [(("stem",), prefix + "0.0", prefix + "0.1")]
    for idx, cfg in enumerate(_mbv2_block_plan(8), start=1):
        base = f"{prefix}{idx}.conv."
        names = (("dw", "0", "1"), ("project", "3", "4")) if cfg["t"] == 1 \
            else (("expand", "0", "1"), ("dw", "3", "4"),
                  ("project", "6", "7"))
        rows += [(("blocks", idx - 1, n), base + c, base + b)
                 for n, c, b in names]
    return rows


def mobilenetv2_from_torch(sd: Dict, prefix: str = "features.") -> Dict:
    """The vendored MobileNetV2's state dict (mobilenet.py:30-119),
    BatchNorms folded."""
    return params_from_layout(sd, _mbv2_layout(prefix))


def mobilenetv2_to_torch(params: Dict, prefix: str = "features.") -> Dict:
    return state_dict_from_layout(params, _mbv2_layout(prefix))


# -- ResNeXt101 (reference segmodel/resnext.py: GroupBottleneck, expansion
# 2, 32 groups, deep stem; undilated in the reference's Resnet wrapper,
# models.py:1043-1045) --------------------------------------------------------

RNX101_LAYERS = [3, 4, 23, 3]
RNX101_PLANES = [128, 256, 512, 1024]
RNX_GROUPS = 32


def resnext101_features(params: Dict, x, dilate_scale: int = 32) -> List:
    """The deep-stem ResNeXt101; dilate_scale 8 or 16 dilates as the
    resnets do, 32 is undilated."""
    x = deep_stem(params, x)
    dilations, strides = _layer_dilations(dilate_scale)
    outs = []
    for li, nblocks in enumerate(RNX101_LAYERS):
        for bi in range(nblocks):
            stride = strides[li] if bi == 0 else 1
            x = _dilated_bottleneck(params[f"layer{li + 1}"][bi], x,
                                    stride, dilations[li], bi == 0,
                                    groups=RNX_GROUPS)
        outs.append(x)
    return outs


def init_resnext101(seed=0) -> Dict:
    """Seeded params of the deep-stem ResNeXt101; CPU tensors."""
    gen = generator(seed)
    params = init_deep_stem(gen)
    in_c = 128
    for li, (nblocks, planes) in enumerate(zip(RNX101_LAYERS,
                                               RNX101_PLANES)):
        blocks = []
        for bi in range(nblocks):
            p = {"conv1": init_conv(gen, planes, in_c, 1),
                 "conv2": init_conv(gen, planes, planes // RNX_GROUPS, 3,
                                    scale=(planes * 9) ** -0.5),
                 "conv3": init_conv(gen, planes * 2, planes, 1)}
            if bi == 0:
                p["downsample"] = init_conv(gen, planes * 2, in_c, 1)
            blocks.append(p)
            in_c = planes * 2
        params[f"layer{li + 1}"] = blocks
    return params


def resnext101_from_torch(sd: Dict, prefix: str = "") -> Dict:
    """A ResNeXt101 state dict, BatchNorms folded (the resnets' layout)."""
    return params_from_layout(sd, layout(prefix, RNX101_LAYERS, BOTTLENECK,
                                         True, in_state_dict(sd, prefix)))


def resnext101_to_torch(params: Dict, prefix: str = "") -> Dict:
    return state_dict_from_layout(params, layout(
        prefix, RNX101_LAYERS, BOTTLENECK, True, in_params(params)))


class PPMDecoder:
    """The pyramid pooling decoder (reference PPM, segmodel
    models.py:390-437): conv5 pooled at scales 1, 2, 3 and 6, 1x1 convs,
    concatenated, a 3x3 conv and the class head; softmax at `seg_size`."""

    POOL_SCALES = (1, 2, 3, 6)

    def __init__(self, num_class: int, fc_dim: int = 2048):
        self.num_class = num_class
        self.fc_dim = fc_dim

    def __call__(self, params: Dict, conv_out, seg_size=None):
        return torch.softmax(self.logits(params, conv_out, seg_size), dim=1)

    def logits(self, params: Dict, conv_out, seg_size=None):
        """The class scores before their softmax, at `seg_size`."""
        conv5 = conv_out[-1]
        ppm = [conv5]
        for i, scale in enumerate(self.POOL_SCALES):
            pooled = adaptive_avg_pool(conv5, (scale, scale))
            pooled = conv(pooled, params["ppm"][i], relu=True)
            ppm.append(resize_bilinear(pooled, conv5.shape[-2:]))
        x = conv(torch.cat(ppm, dim=1), params["conv_last_0"], padding=1,
                 relu=True)
        x = conv(x, params["conv_last_1"])
        return x if seg_size is None else resize_bilinear(x, seg_size)

    def init_params(self, seed=0) -> Dict:
        gen = generator(seed)
        return {"ppm": [init_conv(gen, 512, self.fc_dim, 1)
                        for _ in self.POOL_SCALES],
                "conv_last_0": init_conv(
                    gen, 512, self.fc_dim + 512 * len(self.POOL_SCALES), 3),
                "conv_last_1": init_conv(gen, self.num_class, 512, 1)}

    def _layout(self):
        return ([(("ppm", i), f"ppm.{i}.1", f"ppm.{i}.2")
                 for i in range(len(self.POOL_SCALES))]
                + [(("conv_last_0",), "conv_last.0", "conv_last.1"),
                   (("conv_last_1",), "conv_last.4", None)])

    def params_from_torch(self, sd: Dict) -> Dict:
        return params_from_layout(sd, self._layout())

    def params_to_torch(self, params: Dict) -> Dict:
        return state_dict_from_layout(params, self._layout())


class PPMDeepsupDecoder(PPMDecoder):
    """PPMDeepsup (reference segmodel models.py:438-498): PPM at inference
    (the deep-supervision branch runs only in training) with PPM's key
    layout, so its checkpoint's deepsup keys go unread."""


class C1Decoder:
    """One 3x3 conv and the class head (reference C1, segmodel
    models.py:364-388); softmax at `seg_size`."""

    def __init__(self, num_class: int, fc_dim: int = 2048):
        self.num_class = num_class
        self.fc_dim = fc_dim

    def __call__(self, params: Dict, conv_out, seg_size=None):
        return torch.softmax(self.logits(params, conv_out, seg_size), dim=1)

    def logits(self, params: Dict, conv_out, seg_size=None):
        """The class scores before their softmax, at `seg_size`."""
        x = conv(conv_out[-1], params["cbr"], padding=1, relu=True)
        x = conv(x, params["conv_last"])
        return x if seg_size is None else resize_bilinear(x, seg_size)

    def init_params(self, seed=0) -> Dict:
        gen = generator(seed)
        return {"cbr": init_conv(gen, self.fc_dim // 4, self.fc_dim, 3),
                "conv_last": init_conv(gen, self.num_class,
                                       self.fc_dim // 4, 1)}

    def _layout(self):
        return [(("cbr",), "cbr.0", "cbr.1"),
                (("conv_last",), "conv_last", None)]

    def params_from_torch(self, sd: Dict) -> Dict:
        return params_from_layout(sd, self._layout())

    def params_to_torch(self, params: Dict) -> Dict:
        return state_dict_from_layout(params, self._layout())


class C1DeepSupDecoder(C1Decoder):
    """C1DeepSup (reference segmodel models.py:327-362): C1 at inference
    (the deep-supervision branch runs only in training), same keys."""


def _resnet101_dilated(params, x, dilate_scale):
    return resnet50_dilated_features(params, x, dilate_scale,
                                     layers=R101_LAYERS)


def _init_resnet101(seed):
    return init_resnet50(seed, layers=R101_LAYERS)


class SemanticSegmenter(BaseSegmenter):
    """A single-category segmenter (reference SemanticSegmenter,
    utils/segmenter.py:392): input normalized as the model's
    ``imageformat`` says, multi-resolution softmax voting, argmax labels
    in channel 0.  On `device` (default ``cuda``); ``params=None`` draws
    seeded weights.  ``resnet101`` and ``resnext101`` run undilated
    (dilate_scale 32), as the reference wraps them in its plain Resnet."""

    FC_DIMS = {"resnet50dilated": 2048, "resnet18dilated": 512,
               "resnet101dilated": 2048, "resnet101": 2048,
               "mobilenetv2dilated": 320, "resnext101": 2048}
    DECODERS = {"ppm": PPMDecoder, "ppm_deepsup": PPMDeepsupDecoder,
                "c1": C1Decoder, "c1_deepsup": C1DeepSupDecoder}
    # arch -> (features(params, x, dilate_scale), init(seed))
    ENCODERS = {
        "resnet50dilated": (resnet50_dilated_features, init_resnet50),
        "resnet101dilated": (_resnet101_dilated, _init_resnet101),
        "resnet101": (_resnet101_dilated, _init_resnet101),
        "resnet18dilated": (resnet18_dilated_features,
                            init_resnet18_deepstem),
        "mobilenetv2dilated": (mobilenetv2_dilated_features,
                               init_mobilenetv2),
        "resnext101": (resnext101_features, init_resnext101),
    }

    def __init__(self, params: Optional[Dict], labels: Sequence[str],
                 decoder="ppm", segsizes=None, dilate_scale: int = 8,
                 arch: str = "resnet50dilated", category: str = "object",
                 imageformat: Optional[Dict] = None, device=None):
        if arch not in self.FC_DIMS or decoder not in self.DECODERS:
            raise ValueError(f"arch {arch!r}, decoder {decoder!r}: one of "
                             f"{sorted(self.FC_DIMS)} and "
                             f"{sorted(self.DECODERS)}")
        self.device = resolve_device(device)
        self.labels = list(labels)
        self.segsizes = segsizes or [256]
        if arch in ("resnext101", "resnet101"):
            dilate_scale = 32
        self.dilate_scale = dilate_scale
        self.arch = arch
        self.category = category
        self.decoder = self.DECODERS[decoder](num_class=len(self.labels),
                                              fc_dim=self.FC_DIMS[arch])
        # {'byteorder': 'RGB' | 'BGR', 'mean', 'stdev' or 'scale'} on [0, 1]
        # inputs (the reference reads it from the model's labels.json)
        self.imageformat = imageformat or {
            "byteorder": "RGB", "mean": list(IMAGENET_MEAN),
            "stdev": list(IMAGENET_STD)}
        if params is None:
            params = {"encoder": self.ENCODERS[arch][1](0),
                      "decoder": self.decoder.init_params(1)}
        self.params = to_device(params, self.device)

    # segment_batch normalizes uint8 images on the device: the drivers
    # hand it their bytes (metrics/seg_stats.py)
    accepts_uint8 = True

    def get_label_and_category_names(self):
        return ([(label, self.category) for label in self.labels],
                [self.category])

    def normalize(self, images):
        """(B, 3, H, W) model input of (B, H, W, 3) images in [-1, 1], or
        uint8 (bytes / 255: the same [0, 1] scale), as the imageformat
        says."""
        x = as_images(images, self.device)
        mean = torch.tensor(self.imageformat["mean"], dtype=torch.float32,
                            device=self.device)
        std = torch.tensor(self.imageformat.get(
            "stdev", self.imageformat.get("scale", [1, 1, 1])),
            dtype=torch.float32, device=self.device)
        if x.dtype == torch.uint8:
            x = x.float() / 255.0
        else:
            x = (x.float() + 1.0) / 2.0
        if self.imageformat.get("byteorder", "RGB") == "BGR":
            x = x.flip(-1)
        return ((x - mean) / std).permute(0, 3, 1, 2)

    def raw_seg_prediction(self, images, downsample: int = 1):
        """The summed softmax maps (B, C, H/d, W/d) over the segsizes."""
        x = self.normalize(images)
        h, w = x.shape[-2:]
        seg_shape = (h // downsample, w // downsample)
        pred = 0.0
        with torch.no_grad():
            for s in self.segsizes:
                resized = x if (s, s) == (h, w) else \
                    adaptive_avg_pool(x, (s, s))
                feats = self.ENCODERS[self.arch][0](
                    self.params["encoder"], resized, self.dilate_scale)
                pred = pred + self.decoder(self.params["decoder"], feats,
                                           seg_size=seg_shape)
        return pred

    def segment_batch(self, images, downsample: int = 1):
        """(B, 1, H/d, W/d) int64 labels on the device."""
        pred = self.raw_seg_prediction(images, downsample)
        return torch.argmax(pred, dim=1)[:, None]

    def predict_single_class(self, images, classnum: int,
                             downsample: int = 1):
        pred = self.raw_seg_prediction(images, downsample)
        return pred[:, classnum], torch.argmax(pred, dim=1) == classnum

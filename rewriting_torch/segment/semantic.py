"""The released texture and colour segmenters: a dilated deep-stem
ResNet-18 with a PPM decoder, and the single-category segmenter around
it, on NCHW tensors.

The port's counterpart of the part of the JAX package's
``segment/semantic.py`` that ``load_segmenter``'s 'x' and 'c' flags run
(reference utils/segmodel/models.py: ResnetDilated :209, PPM :390,
PPMDeepsup :438; utils/segmenter.py:392 SemanticSegmenter): the encoder
``resnet18dilated``, the ``ppm`` and ``ppm_deepsup`` decoders (the two are
one at inference), multi-resolution voting and argmax labels.  The JAX
package's other encoders (resnet50/101 dilated, resnet101, MobileNetV2,
ResNeXt101) and its C1 decoders have no caller there; they are not ported
yet, and asking for one raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from ..utils.device import resolve_device
from .nn import (adaptive_avg_pool, conv, generator, init_conv,
                 params_from_layout, resize_bilinear, state_dict_from_layout)
from .resnet import (BASIC, R18_LAYERS, R18_PLANES, deep_stem, in_params,
                     in_state_dict, init_deep_stem, layout)
from .segmenter import BaseSegmenter, as_images, to_device

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
NOT_PORTED = ("the port's SemanticSegmenter runs arch='resnet18dilated' "
              "with decoder 'ppm' or 'ppm_deepsup' (what load_segmenter "
              "loads); the JAX package's other encoders and C1 decoders "
              "are ROADMAP queue 1 item 11")


def _layer_dilations(dilate_scale: int):
    """Each layer's dilation and stride after the reference's
    _nostride_dilate (segmodel models.py:209-270): in a dilated layer the
    formerly strided conv gets dilate // 2, every other 3x3 conv dilate."""
    if dilate_scale == 8:
        return [1, 1, 2, 4], [1, 2, 1, 1]
    if dilate_scale == 16:
        return [1, 1, 1, 2], [1, 2, 2, 1]
    return [1, 1, 1, 1], [1, 2, 2, 2]


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


class SemanticSegmenter(BaseSegmenter):
    """A single-category segmenter (reference SemanticSegmenter,
    utils/segmenter.py:392): input normalized as the model's
    ``imageformat`` says, multi-resolution softmax voting, argmax labels
    in channel 0.  On `device` (default ``cuda``); ``params=None`` draws
    seeded weights."""

    FC_DIMS = {"resnet18dilated": 512}
    DECODERS = {"ppm": PPMDecoder, "ppm_deepsup": PPMDeepsupDecoder}

    def __init__(self, params: Optional[Dict], labels: Sequence[str],
                 decoder="ppm", segsizes=None, dilate_scale: int = 8,
                 arch: str = "resnet50dilated", category: str = "object",
                 imageformat: Optional[Dict] = None, device=None):
        if arch not in self.FC_DIMS or decoder not in self.DECODERS:
            raise NotImplementedError(
                f"arch {arch!r}, decoder {decoder!r}: {NOT_PORTED}")
        self.device = resolve_device(device)
        self.labels = list(labels)
        self.segsizes = segsizes or [256]
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
            params = {"encoder": init_resnet18_deepstem(0),
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
                feats = resnet18_dilated_features(self.params["encoder"],
                                                  resized, self.dilate_scale)
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

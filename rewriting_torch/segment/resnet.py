"""ResNet feature extractors of the segmenters (NCHW, inference, each
BatchNorm folded into its conv).

The port's counterpart of the JAX package's ``segment/resnet.py``:

- resnet50 (CSAIL variant): a deep 3x3 stem to 128 channels, bottleneck
  layers [3, 4, 6, 3] ([3, 4, 23, 3] for resnet101, ``R101_LAYERS``); the
  four stage features (reference utils/upsegmodel/resnet.py:103-150,
  encoder wrapper models.py:230-248);
- resnet18 (torchvision's 7x7 stem): feat8, feat16, feat32 for BiSeNet
  (reference metrics/face-parsing.PyTorch/resnet.py:58-78).

Params are the JAX package's trees, of tensors: ``layer{i}`` is a list of
blocks.  ``*_from_torch`` read the released state dicts (``*_to_torch``
write params back in their layout, with identity BatchNorms); ``init_*``
draw seeded weights (normal over sqrt(fan-in), zero bias) at the same
widths.
"""

from __future__ import annotations

from typing import Dict, List

import torch.nn.functional as F

from .nn import (conv, generator, init_conv, maxpool, params_from_layout,
                 state_dict_from_layout)

# -- blocks -------------------------------------------------------------------


def bottleneck(p: Dict, x, stride: int):
    out = conv(x, p["conv1"], relu=True)
    out = conv(out, p["conv2"], stride=stride, padding=1, relu=True)
    out = conv(out, p["conv3"])
    res = conv(x, p["downsample"], stride=stride) if "downsample" in p \
        else x
    return F.relu(out + res)


def basic_block(p: Dict, x, stride: int):
    out = conv(x, p["conv1"], stride=stride, padding=1, relu=True)
    out = conv(out, p["conv2"], padding=1)
    res = conv(x, p["downsample"], stride=stride) if "downsample" in p \
        else x
    return F.relu(out + res)


def layout(prefix: str, layers, convs, deep_stem: bool, has_downsample
           ) -> List:
    """The convs of a resnet (``nn.params_from_layout``): its stem (the
    deep stem's three 3x3 convs, or one 7x7), then each block's `convs` and
    its downsample projection where ``has_downsample(li, bi)``."""
    stem = ("conv1", "conv2", "conv3") if deep_stem else ("conv1",)
    rows = [((n,), prefix + n, prefix + "bn" + n[-1]) for n in stem]
    for li, nblocks in enumerate(layers):
        for bi in range(nblocks):
            base = f"{prefix}layer{li + 1}.{bi}."
            path = (f"layer{li + 1}", bi)
            rows += [(path + (n,), base + n, base + "bn" + n[-1])
                     for n in convs]
            if has_downsample(li, bi):
                rows.append((path + ("downsample",), base + "downsample.0",
                             base + "downsample.1"))
    return rows


def in_state_dict(sd: Dict, prefix: str):
    """``has_downsample`` of a state dict."""
    return lambda li, bi: \
        f"{prefix}layer{li + 1}.{bi}.downsample.0.weight" in sd


def in_params(params: Dict):
    """``has_downsample`` of a params tree."""
    return lambda li, bi: "downsample" in params[f"layer{li + 1}"][bi]


# -- resnet50 (CSAIL deep stem) ------------------------------------------------

R50_LAYERS = [3, 4, 6, 3]
R101_LAYERS = [3, 4, 23, 3]
R50_PLANES = [64, 128, 256, 512]
BOTTLENECK = ("conv1", "conv2", "conv3")
BASIC = ("conv1", "conv2")


def deep_stem(params: Dict, x):
    """The CSAIL deep stem: three 3x3 convs (the first of stride 2) and a
    3x3 max pool of stride 2."""
    x = conv(x, params["conv1"], stride=2, padding=1, relu=True)
    x = conv(x, params["conv2"], padding=1, relu=True)
    x = conv(x, params["conv3"], padding=1, relu=True)
    return maxpool(x)


def resnet50_features(params: Dict, x) -> List:
    """NCHW `x` -> [c2, c3, c4, c5], the stage features at strides 4, 8, 16
    and 32."""
    x = deep_stem(params, x)
    outs = []
    for li, nblocks in enumerate(R50_LAYERS):
        for bi in range(nblocks):
            stride = 2 if (bi == 0 and li > 0) else 1
            x = bottleneck(params[f"layer{li + 1}"][bi], x, stride)
        outs.append(x)
    return outs


def init_deep_stem(gen) -> Dict:
    return {"conv1": init_conv(gen, 64, 3, 3),
            "conv2": init_conv(gen, 64, 64, 3),
            "conv3": init_conv(gen, 128, 64, 3)}


def init_resnet50(seed=0, layers=None) -> Dict:
    """Seeded params of the deep-stem bottleneck resnet: 50 by default,
    101 with ``layers=R101_LAYERS``; CPU tensors."""
    gen = generator(seed)
    params = init_deep_stem(gen)
    in_c = 128
    for li, (nblocks, planes) in enumerate(zip(layers or R50_LAYERS,
                                               R50_PLANES)):
        blocks = []
        for bi in range(nblocks):
            p = {"conv1": init_conv(gen, planes, in_c, 1),
                 "conv2": init_conv(gen, planes, planes, 3),
                 "conv3": init_conv(gen, planes * 4, planes, 1)}
            if bi == 0:
                p["downsample"] = init_conv(gen, planes * 4, in_c, 1)
            blocks.append(p)
            in_c = planes * 4
        params[f"layer{li + 1}"] = blocks
    return params


def resnet50_from_torch(sd: Dict, prefix: str = "", layers=None) -> Dict:
    """A CSAIL deep-stem bottleneck resnet's state dict, BatchNorms folded;
    `layers` the depth (resnet50 by default, ``R101_LAYERS``)."""
    return params_from_layout(sd, layout(prefix, layers or R50_LAYERS,
                                         BOTTLENECK, True,
                                         in_state_dict(sd, prefix)))


def resnet50_to_torch(params: Dict, prefix: str = "", layers=None) -> Dict:
    return state_dict_from_layout(params, layout(
        prefix, layers or R50_LAYERS, BOTTLENECK, True, in_params(params)))


# -- resnet18 (7x7 stem) for BiSeNet -----------------------------------------

R18_LAYERS = [2, 2, 2, 2]
R18_PLANES = [64, 128, 256, 512]


def resnet18_features(params: Dict, x):
    """NCHW `x` -> (feat8, feat16, feat32) at strides 8, 16 and 32
    (reference face-parsing resnet.py:71-78)."""
    x = conv(x, params["conv1"], stride=2, padding=3, relu=True)
    x = maxpool(x)
    feats = []
    for li, nblocks in enumerate(R18_LAYERS):
        for bi in range(nblocks):
            stride = 2 if (bi == 0 and li > 0) else 1
            x = basic_block(params[f"layer{li + 1}"][bi], x, stride)
        feats.append(x)
    return feats[1], feats[2], feats[3]


def init_resnet18(seed=0) -> Dict:
    gen = generator(seed)
    params = {"conv1": init_conv(gen, 64, 3, 7)}
    in_c = 64
    for li, (nblocks, planes) in enumerate(zip(R18_LAYERS, R18_PLANES)):
        blocks = []
        for bi in range(nblocks):
            p = {"conv1": init_conv(gen, planes, in_c, 3),
                 "conv2": init_conv(gen, planes, planes, 3)}
            if bi == 0 and li > 0:
                p["downsample"] = init_conv(gen, planes, in_c, 1)
            blocks.append(p)
            in_c = planes
        params[f"layer{li + 1}"] = blocks
    return params


def resnet18_from_torch(sd: Dict, prefix: str = "") -> Dict:
    return params_from_layout(sd, layout(prefix, R18_LAYERS, BASIC, False,
                                         in_state_dict(sd, prefix)))


def resnet18_to_torch(params: Dict, prefix: str = "") -> Dict:
    return state_dict_from_layout(params, layout(
        prefix, R18_LAYERS, BASIC, False, in_params(params)))

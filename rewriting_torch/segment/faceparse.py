"""The BiSeNet face parser (19 classes), on NCHW tensors.

The port's counterpart of the JAX package's ``segment/faceparse.py``, the
vendored face-parsing.PyTorch BiSeNet (reference metrics/
face-parsing.PyTorch/model.py:230-260): a resnet18 context path with
attention refinement and global context, the stride-8 feature standing in
for the spatial path, feature fusion, and a 1x1 class head upsampled with
aligned corners.  The InPlace-ABN module is frozen BatchNorm, folded into
the convs at conversion.

``FaceSegmenter`` keeps the reference's protocol (metrics/load_seg.py:
11-35): nearest resize to 512, the main head's argmax, the labels resized
back (nearest, half-pixel centres, as ``jax.image.resize``).
"""

from __future__ import annotations

import os
from typing import Dict

import torch

from ..utils.device import resolve_device
from .nn import (conv, generator, global_avg_pool, init_conv,
                 params_from_layout, resize_bilinear, resize_nearest,
                 state_dict_from_layout)
from .resnet import (BASIC, R18_LAYERS, in_params, in_state_dict,
                     init_resnet18, layout, resnet18_features)
from .segmenter import BaseSegmenter, as_images, to_device

# face-parsing's classes, background at 0
FACE_CLASSES = ["background", "skin", "l_brow", "r_brow", "l_eye", "r_eye",
                "eye_g", "l_ear", "r_ear", "ear_r", "nose", "mouth",
                "u_lip", "l_lip", "neck", "neck_l", "cloth", "hair", "hat"]
WEIGHTS_FILENAME = "face-parsing-02dd3f6f.pth"
SIZE = 512


def _arm(p: Dict, x):
    """Attention refinement (reference model.py:67-91)."""
    feat = conv(x, p["conv"], padding=1, relu=True)
    atten = torch.sigmoid(conv(global_avg_pool(feat), p["conv_atten"]))
    return feat * atten


def _ffm(p: Dict, fsp, fcp):
    """Feature fusion (reference model.py:180-211)."""
    feat = conv(torch.cat([fsp, fcp], dim=1), p["convblk"], relu=True)
    atten = conv(global_avg_pool(feat), p["conv1"], relu=True)
    atten = torch.sigmoid(conv(atten, p["conv2"]))
    return feat * atten + feat


class BiSeNet:
    def __init__(self, n_classes: int = 19):
        self.n_classes = n_classes

    def __call__(self, params: Dict, x):
        """x (B, 3, H, W) in [-1, 1] -> the main head's class scores (B,
        n_classes, H, W), upsampled with aligned corners (reference
        model.py:241-253; the auxiliary heads serve training only)."""
        h, w = x.shape[-2:]
        feat8, feat16, feat32 = resnet18_features(params["resnet"], x)
        cp = params["cp"]
        avg = conv(global_avg_pool(feat32), cp["conv_avg"], relu=True)
        feat32_sum = _arm(cp["arm32"], feat32) + avg
        feat32_up = resize_nearest(feat32_sum, feat16.shape[-2:])
        feat32_up = conv(feat32_up, cp["conv_head32"], padding=1, relu=True)
        feat16_sum = _arm(cp["arm16"], feat16) + feat32_up
        feat16_up = resize_nearest(feat16_sum, feat8.shape[-2:])
        feat16_up = conv(feat16_up, cp["conv_head16"], padding=1, relu=True)
        fuse = _ffm(params["ffm"], feat8, feat16_up)
        head = params["conv_out"]
        out = conv(conv(fuse, head["conv"], padding=1, relu=True),
                   head["conv_out"])
        return resize_bilinear(out, (h, w), align_corners=True)

    def init_params(self, seed=0) -> Dict:
        """Seeded params (normal over sqrt(fan-in), zero bias); CPU
        tensors."""
        gen = generator(seed)
        params = {"resnet": init_resnet18(gen)}
        cp = {name: init_conv(gen, o, i, k)
              for name, (o, i, k) in [("conv_avg", (128, 512, 1)),
                                      ("conv_head32", (128, 128, 3)),
                                      ("conv_head16", (128, 128, 3))]}
        for arm, in_c in [("arm16", 256), ("arm32", 512)]:
            cp[arm] = {"conv": init_conv(gen, 128, in_c, 3),
                       "conv_atten": init_conv(gen, 128, 128, 1)}
        params["cp"] = cp
        params["ffm"] = {"convblk": init_conv(gen, 256, 256, 1),
                         "conv1": init_conv(gen, 64, 256, 1),
                         "conv2": init_conv(gen, 256, 64, 1)}
        params["conv_out"] = {"conv": init_conv(gen, 256, 256, 3),
                              "conv_out": init_conv(gen, self.n_classes,
                                                    256, 1)}
        return params

    def params_from_torch(self, sd: Dict) -> Dict:
        """The face-parsing state dict, BatchNorms folded."""
        return params_from_layout(sd, _layout(in_state_dict(sd,
                                                            "cp.resnet.")))

    def params_to_torch(self, params: Dict) -> Dict:
        """`params` in the face-parsing layout, identity BatchNorms."""
        return state_dict_from_layout(params, _layout(in_params(
            params["resnet"])))


def _layout(has_downsample):
    rows = [(("resnet",) + path, ck, bn) for path, ck, bn in layout(
        "cp.resnet.", R18_LAYERS, BASIC, False, has_downsample)]
    rows += [(("cp", name), f"cp.{name}.conv", f"cp.{name}.bn")
             for name in ("conv_avg", "conv_head32", "conv_head16")]
    for arm in ("arm16", "arm32"):
        rows += [(("cp", arm, "conv"), f"cp.{arm}.conv.conv",
                  f"cp.{arm}.conv.bn"),
                 (("cp", arm, "conv_atten"), f"cp.{arm}.conv_atten",
                  f"cp.{arm}.bn_atten")]
    rows += [(("ffm", "convblk"), "ffm.convblk.conv", "ffm.convblk.bn"),
             (("ffm", "conv1"), "ffm.conv1", None),
             (("ffm", "conv2"), "ffm.conv2", None),
             (("conv_out", "conv"), "conv_out.conv.conv", "conv_out.conv.bn"),
             (("conv_out", "conv_out"), "conv_out.conv_out", None)]
    return rows


class FaceSegmenter(BaseSegmenter):
    """The reference's protocol (metrics/load_seg.py:11-35).  Params from
    `params`, else from `weights_path` (default
    ``$REWRITING_TPU_WEIGHTS/face-parsing-02dd3f6f.pth``); on `device`
    (default ``cuda``)."""

    def __init__(self, params=None, weights_path=None, device=None):
        self.device = resolve_device(device)
        self.net = BiSeNet(n_classes=len(FACE_CLASSES))
        if params is None:
            from ..models.zoo import load_state, weights_dir
            if weights_path is None:
                weights_path = os.path.join(weights_dir(), WEIGHTS_FILENAME)
            if not os.path.exists(weights_path):
                raise FileNotFoundError(
                    f"face parser weights not found at {weights_path}; "
                    f"place {WEIGHTS_FILENAME} from "
                    "rewriting.csail.mit.edu/data/models/ there.")
            params = self.net.params_from_torch(load_state(weights_path))
        self.params = to_device(params, self.device)

    def get_label_and_category_names(self):
        return [(c, "face") for c in FACE_CLASSES], ["face"]

    def scores(self, images):
        """BiSeNet's class scores (B, 19, 512, 512) of (B, H, W, 3) images
        in [-1, 1] or uint8, resized to 512 (nearest; bytes are resized,
        then normalized on the device: the same values, nearest being
        value-preserving)."""
        x = as_images(images, self.device).permute(0, 3, 1, 2)
        x = resize_nearest(x, (SIZE, SIZE))
        x = x.float() / 255.0 * 2.0 - 1.0 if x.dtype == torch.uint8 \
            else x.float()
        with torch.no_grad():
            return self.net(self.params, x)

    def segment_batch_device(self, images, downsample: int = 1):
        """(B, 1, H/d, W/d) uint8 labels on the device of (B, H, W, 3)
        images, uint8 or in [-1, 1]: the 19 classes fit a byte, so the
        drivers copy an eighth of the int64 labels' bytes to the host
        (``metrics/seg_stats.py``, ``metrics/fused_pipeline.py``)."""
        h, w = as_images(images).shape[1:3]
        labels = torch.argmax(self.scores(images), dim=1)[:, None]
        return resize_nearest(labels.to(torch.uint8),
                              (h // downsample, w // downsample))

    def segment_batch(self, images, downsample: int = 1):
        """(B, 1, H/d, W/d) int64 labels on the device."""
        return self.segment_batch_device(images, downsample).long()

"""UPerNet, the unified-parsing network (inference), on NCHW tensors.

The port's counterpart of the JAX package's ``segment/upernet.py``, the
CSAIL unified parsing network behind the reference's 'netpqc' segmenter
(reference utils/upsegmodel/models.py:252-427, SegmentationModule
:48-76): a resnet50 encoder feeds a PPM pyramid (PrRoI pooled: exact hat
integrals), an FPN top-down pass, and the object, part, material and scene
heads; the softmax maps are resized to ``seg_size``.  The convolutions
are cuDNN's (fp32, the parity tier): no TPU kernel covered them.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from .nn import (conv, generator, init_conv, params_from_layout,
                 resize_bilinear, state_dict_from_layout)
from .prroi import prroi_pool_full_image
from .resnet import (init_resnet50, resnet50_features, resnet50_from_torch,
                     resnet50_to_torch)

POOL_SCALES = (1, 2, 3, 6)
FPN_INPLANES = (256, 512, 1024, 2048)
# the released decoder is built with fpn_dim=512 (reference
# models.py:286-291 via build_decoder, fc_dim=2048)
FPN_DIM = 512
FC_DIM = 2048  # resnet50 conv5 channels
HEADS = ("scene", "object", "part", "material")


class UPerNet:
    """``nr_classes``: the 'object', 'part', 'material' and 'scene' head
    widths; ``object_with_part`` and ``object_part`` give the part heads of
    each object (reference SegmentationModule.__init__, models.py:64-73)."""

    def __init__(self, nr_classes: Dict[str, int],
                 object_with_part: Sequence[int],
                 object_part: Dict[int, List[int]]):
        self.nr_classes = dict(nr_classes)
        self.object_with_part = list(object_with_part)
        self.object_part = {int(k): list(v) for k, v in object_part.items()}

    def __call__(self, params: Dict, img, seg_size=None) -> Dict:
        """img (B, 3, H, W), preprocessed (BGR, mean subtracted) -> softmax
        maps ``object`` and ``material`` (B, C, h, w) at `seg_size` (else at
        the FPN's finest level), ``part`` a list of maps, one an owning
        object, and ``scene`` (B, C)."""
        out = self.logits(params, img, seg_size)
        parts, first = [], 0
        for obj in self.object_with_part:
            n = len(self.object_part[obj])
            parts.append(torch.softmax(out["part"][:, first:first + n],
                                       dim=1))
            first += n
        return {"scene": torch.softmax(out["scene"], dim=1),
                "object": torch.softmax(out["object"], dim=1),
                "material": torch.softmax(out["material"], dim=1),
                "part": parts}

    def logits(self, params: Dict, img, seg_size=None) -> Dict:
        """The heads' outputs before their softmax: ``scene`` (B, C),
        ``object``, ``material`` and ``part`` (every object's parts side by
        side) (B, C, h, w)."""
        conv_out = resnet50_features(params["encoder"], img)
        dec = params["decoder"]
        conv5 = conv_out[-1]
        ppm_out = [conv5]
        for i, scale in enumerate(POOL_SCALES):
            pooled = prroi_pool_full_image(conv5, scale)
            pooled = conv(pooled, dec["ppm_conv"][i], relu=True)
            ppm_out.append(resize_bilinear(pooled, conv5.shape[-2:]))
        f = conv(torch.cat(ppm_out, dim=1), dec["ppm_last_conv"], padding=1,
                 relu=True)

        out: Dict = {}
        x = conv(f, dec["scene_head_conv"], padding=1, relu=True)
        x = conv(torch.mean(x, dim=(2, 3), keepdim=True),
                 dec["scene_head_out"])
        out["scene"] = x[:, :, 0, 0]

        fpn_features = [f]
        for i in reversed(range(len(conv_out) - 1)):
            lateral = conv(conv_out[i], dec["fpn_in"][i], relu=True)
            f = lateral + resize_bilinear(f, lateral.shape[-2:])
            fpn_features.append(conv(f, dec["fpn_out"][i], padding=1,
                                     relu=True))
        fpn_features.reverse()  # [P2 .. P5]

        def head(x, name):
            x = conv(conv(x, dec[f"{name}_head_conv"], padding=1, relu=True),
                     dec[f"{name}_head_out"])
            return x if seg_size is None else resize_bilinear(x, seg_size)

        out["material"] = head(fpn_features[0], "material")
        size2 = fpn_features[0].shape[-2:]
        fusion = torch.cat([fpn_features[0]] + [resize_bilinear(p, size2)
                                                for p in fpn_features[1:]],
                           dim=1)
        x = conv(fusion, dec["conv_fusion"], padding=1, relu=True)
        out["object"] = head(x, "object")
        out["part"] = head(x, "part")
        return out

    def init_params(self, seed=0) -> Dict:
        """Seeded params at the released widths (normal over sqrt(fan-in),
        zero bias); CPU tensors."""
        gen = generator(seed)
        encoder = init_resnet50(gen)
        dec: Dict = {"ppm_conv": [init_conv(gen, 512, FC_DIM, 1)
                                  for _ in POOL_SCALES]}
        dec["ppm_last_conv"] = init_conv(
            gen, FPN_DIM, FC_DIM + len(POOL_SCALES) * 512, 3)
        dec["fpn_in"], dec["fpn_out"] = [], []
        for inplane in FPN_INPLANES[:-1]:
            dec["fpn_in"].append(init_conv(gen, FPN_DIM, inplane, 1))
            dec["fpn_out"].append(init_conv(gen, FPN_DIM, FPN_DIM, 3))
        dec["conv_fusion"] = init_conv(gen, FPN_DIM,
                                       len(FPN_INPLANES) * FPN_DIM, 3)
        for name in HEADS:
            dec[f"{name}_head_conv"] = init_conv(gen, FPN_DIM, FPN_DIM, 3)
            dec[f"{name}_head_out"] = init_conv(gen, self.nr_classes[name],
                                                FPN_DIM, 1)
        return {"encoder": encoder, "decoder": dec}

    def params_from_torch(self, enc_sd: Dict, dec_sd: Dict) -> Dict:
        """The released encoder and decoder state dicts, BatchNorms folded
        (key layout of reference upsegmodel/models.py:252-320)."""
        return {"encoder": resnet50_from_torch(enc_sd),
                "decoder": params_from_layout(dec_sd, DECODER_LAYOUT)}

    def params_to_torch(self, params: Dict):
        """(encoder, decoder) state dicts of `params` in the released
        layout, with identity BatchNorms."""
        return (resnet50_to_torch(params["encoder"]),
                state_dict_from_layout(params["decoder"], DECODER_LAYOUT))


def _decoder_layout():
    rows = [(("ppm_conv", i), f"ppm_conv.{i}.0", f"ppm_conv.{i}.1")
            for i in range(len(POOL_SCALES))]
    rows.append((("ppm_last_conv",), "ppm_last_conv.0", "ppm_last_conv.1"))
    for i in range(len(FPN_INPLANES) - 1):
        rows.append((("fpn_in", i), f"fpn_in.{i}.0", f"fpn_in.{i}.1"))
    for i in range(len(FPN_INPLANES) - 1):
        rows.append((("fpn_out", i), f"fpn_out.{i}.0.0", f"fpn_out.{i}.0.1"))
    rows.append((("conv_fusion",), "conv_fusion.0", "conv_fusion.1"))
    for name in HEADS:
        rows.append(((f"{name}_head_conv",), f"{name}_head.0.0",
                     f"{name}_head.0.1"))
        out_idx = 2 if name == "scene" else 1
        rows.append(((f"{name}_head_out",), f"{name}_head.{out_idx}", None))
    return rows


DECODER_LAYOUT = _decoder_layout()

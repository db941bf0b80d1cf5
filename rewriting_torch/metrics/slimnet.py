"""SlimNet, the CelebA attribute classifier of the smile count, on NCHW
tensors.

The port's counterpart of the JAX package's ``metrics/slimnet.py``.  The
reference (metrics/num_smiles.py:11-28) loads the external
``pytorch_slim_cnn.slimnet.SlimNet`` checkpoint ``celeba_20.pth`` and
counts images whose 'Smiling' sigmoid exceeds 0.5.  The upstream model is
not vendored, so the JAX package reconstructs Slim-CNN (Sharma & Foroosh,
"Slim-CNN: A Light-Weight CNN for Face Attribute Prediction"):

    conv7x7 (3 -> 96, stride 2) + BN + ReLU
    [maxpool 3x3/2 -> SlimModule] x 4   (squeeze 16 / 32 / 48 / 64)
    maxpool -> global average pool -> fc (512 -> 40)

    SlimModule(in, s): squeeze 1x1 (in -> s); two expands, 1x1 (s -> 4s)
    and depthwise-separable 3x3 (s -> 4s), concatenated to 8s; a
    depthwise-separable 3x3 (8s -> 8s); plus a projected skip.

Convs pad "SAME" as XLA does (the odd pad after, at stride 2), each
followed by its folded BatchNorm (a per-channel scale and bias) and ReLU;
depthwise convs run as ``groups=``.  The converter validates: it consumes
every tensor of the checkpoint or raises with a table of what is there.

Params: ``{"stem": {"w" (O, I, k, k), "scale", "bias"}, "module{i}":
{"squeeze", "exp1", "exp3_dw", "exp3_pw", "dws_dw", "dws_pw", "skip"},
"fc": {"w" (512, 40), "b"}}``: the JAX package's names, its HWIO conv
weights in torch's order (``params_from_jax`` carries a JAX tree across).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..core.tree import tree_map
from ..utils.device import resolve_device

# CelebA's attributes in the reference's order (metrics/num_smiles.py:
# 23-32); 'Smiling' is index 31
CELEBA_ATTRS = [
    "5_o_Clock_Shadow", "Arched_Eyebrows", "Attractive", "Bags_Under_Eyes",
    "Bald", "Bangs", "Big_Lips", "Big_Nose", "Black_Hair", "Blond_Hair",
    "Blurry", "Brown_Hair", "Bushy_Eyebrows", "Chubby", "Double_Chin",
    "Eyeglasses", "Goatee", "Gray_Hair", "Heavy_Makeup", "High_Cheekbones",
    "Male", "Mouth_Slightly_Open", "Mustache", "Narrow_Eyes", "No_Beard",
    "Oval_Face", "Pale_Skin", "Pointy_Nose", "Receding_Hairline",
    "Rosy_Cheeks", "Sideburns", "Smiling", "Straight_Hair", "Wavy_Hair",
    "Wearing_Earrings", "Wearing_Hat", "Wearing_Lipstick",
    "Wearing_Necklace", "Wearing_Necktie", "Young",
]
SMILING = CELEBA_ATTRS.index("Smiling")
WEIGHTS_FILENAME = "celeba_20.pth"
INPUT_SIZE = (178, 218)  # the reference's Resize((178, 218)), (h, w)

# the four slim modules' squeeze widths; a module puts out 8x its squeeze
SQUEEZES = (16, 32, 48, 64)
STEM_OUT = 96

# the checkpoint's layout: ours -> (conv key, bn key, depthwise); {i} is
# the slim module 1..4
_STEM = [("stem", "conv_1.conv", "conv_1.bn", False)]
_MODULE = [
    ("squeeze", "slim_module_{i}.sse.squeeze.conv",
     "slim_module_{i}.sse.squeeze.bn", False),
    ("exp1", "slim_module_{i}.sse.expand1.conv",
     "slim_module_{i}.sse.expand1.bn", False),
    ("exp3_dw", "slim_module_{i}.sse.expand3.depthwise",
     "slim_module_{i}.sse.expand3.bn1", True),
    ("exp3_pw", "slim_module_{i}.sse.expand3.pointwise",
     "slim_module_{i}.sse.expand3.bn2", False),
    ("dws_dw", "slim_module_{i}.dws.depthwise",
     "slim_module_{i}.dws.bn1", True),
    ("dws_pw", "slim_module_{i}.dws.pointwise",
     "slim_module_{i}.dws.bn2", False),
    ("skip", "slim_module_{i}.skip.conv", "slim_module_{i}.skip.bn", False),
]


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, np.float32)


def _fold_bn(sd, prefix, eps=1e-5):
    """BN ``prefix.{weight,bias,running_mean,running_var}`` -> (scale,
    bias), taken out of `sd`."""
    g = _np(sd.pop(f"{prefix}.weight"))
    b = _np(sd.pop(f"{prefix}.bias"))
    m = _np(sd.pop(f"{prefix}.running_mean"))
    v = _np(sd.pop(f"{prefix}.running_var"))
    sd.pop(f"{prefix}.num_batches_tracked", None)
    scale = g / np.sqrt(v + eps)
    return scale, b - m * scale


def _conv_bn(sd, conv_key, bn_key, depthwise=False):
    w = _np(sd.pop(f"{conv_key}.weight"))
    cb = sd.pop(f"{conv_key}.bias", None)
    scale, bias = _fold_bn(sd, bn_key)
    if cb is not None:
        bias = bias + scale * _np(cb)
    if depthwise and w.shape[1] != 1:
        raise ValueError(f"{conv_key}: a depthwise conv's weight is "
                         f"(O, 1, k, k), got {w.shape}")
    return {"w": torch.tensor(w), "scale": torch.tensor(scale),
            "bias": torch.tensor(bias)}


def params_from_state_dict(sd) -> Dict:
    """Validating converter: consumes every tensor of the checkpoint or
    raises with a table of what is left against what was expected."""
    sd = dict(sd)
    try:
        params = {ours: _conv_bn(sd, ck, bk, dw) for ours, ck, bk, dw in _STEM}
        for i in range(1, 5):
            params[f"module{i}"] = {
                ours: _conv_bn(sd, ck.format(i=i), bk.format(i=i), dw)
                for ours, ck, bk, dw in _MODULE}
        params["fc"] = {"w": torch.tensor(_np(sd.pop("fc.weight")).T),
                        "b": torch.tensor(_np(sd.pop("fc.bias")))}
    except KeyError as e:
        table = "\n".join(f"  {k}: {tuple(np.shape(v))}"
                          for k, v in sorted(sd.items()))
        raise KeyError(
            f"SlimNet checkpoint layout mismatch at {e}; remaining "
            f"checkpoint tensors:\n{table}\nIf the real celeba_20.pth "
            "uses other key names, update _STEM/_MODULE in "
            "rewriting_torch/metrics/slimnet.py.") from e
    leftover = [k for k in sd if not k.endswith("num_batches_tracked")]
    if leftover:
        raise ValueError(f"unconsumed SlimNet tensors: {leftover}")
    return params


def params_from_jax(tree: Dict) -> Dict:
    """The port's params from the JAX package's tree (numpy): conv
    weights HWIO -> OIHW, the rest as they are; CPU tensors."""
    def leaf(name, v):
        arr = np.asarray(v, np.float32)
        if name == "w" and arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        return torch.tensor(arr)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else leaf(k, v)
                for k, v in node.items()}
    return walk(tree)


def init_random_state_dict(seed: int = 0) -> Dict[str, np.ndarray]:
    """A seeded state dict in the checkpoint's layout (numpy
    ``RandomState``, the JAX package's draws in its order)."""
    rng = np.random.RandomState(seed)
    sd = {}

    def conv(key, o, i, k, dw=False):
        sd[f"{key}.weight"] = rng.randn(o, 1 if dw else i, k, k).astype(
            np.float32) * 0.1

    def bn(key, c):
        sd[f"{key}.weight"] = np.abs(rng.randn(c)).astype(np.float32) + .5
        sd[f"{key}.bias"] = rng.randn(c).astype(np.float32) * 0.1
        sd[f"{key}.running_mean"] = rng.randn(c).astype(np.float32) * 0.1
        sd[f"{key}.running_var"] = np.abs(
            rng.randn(c)).astype(np.float32) + 0.5

    conv("conv_1.conv", STEM_OUT, 3, 7)
    bn("conv_1.bn", STEM_OUT)
    in_c = STEM_OUT
    for i, s in enumerate(SQUEEZES, start=1):
        p = f"slim_module_{i}"
        conv(f"{p}.sse.squeeze.conv", s, in_c, 1)
        bn(f"{p}.sse.squeeze.bn", s)
        conv(f"{p}.sse.expand1.conv", 4 * s, s, 1)
        bn(f"{p}.sse.expand1.bn", 4 * s)
        conv(f"{p}.sse.expand3.depthwise", s, s, 3, dw=True)
        bn(f"{p}.sse.expand3.bn1", s)
        conv(f"{p}.sse.expand3.pointwise", 4 * s, s, 1)
        bn(f"{p}.sse.expand3.bn2", 4 * s)
        conv(f"{p}.dws.depthwise", 8 * s, 8 * s, 3, dw=True)
        bn(f"{p}.dws.bn1", 8 * s)
        conv(f"{p}.dws.pointwise", 8 * s, 8 * s, 1)
        bn(f"{p}.dws.bn2", 8 * s)
        conv(f"{p}.skip.conv", 8 * s, in_c, 1)
        bn(f"{p}.skip.bn", 8 * s)
        in_c = 8 * s
    sd["fc.weight"] = rng.randn(len(CELEBA_ATTRS), in_c).astype(
        np.float32) * 0.1
    sd["fc.bias"] = rng.randn(len(CELEBA_ATTRS)).astype(np.float32) * 0.1
    return sd


def _same_pad(x, k: int, stride: int):
    """XLA's "SAME" padding of the last two axes: total (ceil(n / s) - 1) s
    + k - n, the odd pixel after."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def _apply_conv_bn(p, x, stride: int = 1):
    w = p["w"]
    # depthwise iff the weight has one input channel (no other conv here
    # reads a 1-channel input)
    groups = w.shape[0] if w.shape[1] == 1 else 1
    out = F.conv2d(_same_pad(x, w.shape[-1], stride), w, None, stride,
                   groups=groups)
    return F.relu(out * p["scale"][:, None, None] + p["bias"][:, None, None])


def _maxpool(x):
    return F.max_pool2d(x, 3, 2)


def forward(params: Dict, x):
    """x (B, 3, H, W) in [-1, 1] -> (B, 40) logits."""
    x = _apply_conv_bn(params["stem"], x, stride=2)
    for i in range(1, 5):
        x = _maxpool(x)
        m = params[f"module{i}"]
        s = _apply_conv_bn(m["squeeze"], x)
        e1 = _apply_conv_bn(m["exp1"], s)
        e3 = _apply_conv_bn(m["exp3_pw"], _apply_conv_bn(m["exp3_dw"], s))
        sse = torch.cat([e1, e3], dim=1)
        dws = _apply_conv_bn(m["dws_pw"], _apply_conv_bn(m["dws_dw"], sse))
        x = dws + _apply_conv_bn(m["skip"], x)
    # upstream pools after every module: the loop covered conv_1 .. module
    # 3, this is module 4's, before the global average
    x = torch.mean(_maxpool(x), dim=(2, 3))
    return x @ params["fc"]["w"] + params["fc"]["b"]


def load_checkpoint(path: str) -> Dict:
    """The tensors of a SlimNet checkpoint: a training checkpoint's
    ``model_state_dict`` (what SlimNet.load_pretrained reads), a
    ``state_dict`` wrapper, or a flat dict; the rest (epoch, optimizer
    state) dropped."""
    from ..models.zoo import load_state
    ckpt = load_state(path)
    for key in ("model_state_dict", "state_dict"):
        if isinstance(ckpt, dict) and isinstance(ckpt.get(key), dict):
            ckpt = ckpt[key]
            break
    return {k: v for k, v in ckpt.items() if isinstance(v, torch.Tensor)}


class SlimNetClassifier:
    """``clf(images)`` -> (B,) bool for one CelebA attribute, as the
    reference uses it: images resized to (178, 218) (bilinear, antialiased
    when it shrinks, as ``jax.image.resize``), sigmoid > 0.5 on
    'Smiling' (metrics/num_smiles.py:34-48).  On `device` (default
    ``cuda``)."""

    def __init__(self, state_dict=None, checkpoint: str = None,
                 attr: int = SMILING, device=None):
        self.device = resolve_device(device)
        if state_dict is None:
            state_dict = load_checkpoint(checkpoint)
        self.params = tree_map(lambda t: t.to(self.device),
                               params_from_state_dict(state_dict))
        self.attr = attr

    def logits(self, images):
        """(B, H, W, 3) images in [-1, 1] -> (B, 40) logits."""
        x = torch.as_tensor(images, dtype=torch.float32).to(self.device)
        x = x.permute(0, 3, 1, 2)
        if tuple(x.shape[-2:]) != INPUT_SIZE:
            x = F.interpolate(x, size=INPUT_SIZE, mode="bilinear",
                              align_corners=False, antialias=True)
        with torch.no_grad():
            return forward(self.params, x)

    def __call__(self, images):
        return torch.sigmoid(self.logits(images))[:, self.attr] > 0.5


def slimnet_classifier(checkpoint: str, attr: int = SMILING, device=None):
    return SlimNetClassifier(checkpoint=checkpoint, attr=attr, device=device)

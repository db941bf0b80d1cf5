"""Carry one set of weights between the JAX package and the port.

The JAX package's parameter tree, given as nested dicts of numpy arrays,
uses the same stage names and torch-order weights as the port.  For
StyleGAN2 only the const input (NHWC ``(1, 4, 4, C)`` there, ``(1, C, 4,
4)`` here) and the noise buffers (``(1, h, w, 1)`` there, ``(1, 1, h, w)``
here) change layout; a ProgGAN tree (OIHW conv weights and biases only)
carries across as it is, and so do the metric networks' and segmenters'
(InceptionV3, the ResNets, UPerNet, BiSeNet, the dilated ResNet-18 with
PPM: OIHW convs in nested dicts and lists) through :func:`tree_from_jax`.
SlimNet keeps HWIO weights there: ``metrics.slimnet.params_from_jax``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .core.tree import tree_map

# (stage, param name prefix) of the NHWC arrays in the JAX package's tree
_NHWC = (("input", "input"), ("noises", "noise_"))


def _is_nhwc(stage: str, name: str) -> bool:
    return any(stage == s and name.startswith(p) for s, p in _NHWC)


def params_from_jax(model, tree: Dict[str, dict]) -> Dict[str, dict]:
    """The port's params (tensors on ``model.device``) from the JAX
    package's parameter tree of numpy arrays."""
    def convert(stage, name, value):
        if isinstance(value, dict):
            return {k: convert(stage, k, v) for k, v in value.items()}
        arr = np.asarray(value, np.float32)
        if _is_nhwc(stage, name):
            arr = arr.transpose(0, 3, 1, 2)
        return torch.tensor(arr, device=model.device)
    return {stage: convert(stage, stage, sub) for stage, sub in tree.items()}


def params_to_numpy(params: Dict[str, dict]) -> Dict[str, dict]:
    """Inverse of :func:`params_from_jax`: nested dicts of numpy arrays in
    the JAX package's layout."""
    def convert(stage, name, value):
        if isinstance(value, dict):
            return {k: convert(stage, k, v) for k, v in value.items()}
        arr = value.detach().cpu().numpy()
        if _is_nhwc(stage, name):
            arr = arr.transpose(0, 2, 3, 1)
        return np.array(arr)
    return {stage: convert(stage, stage, sub) for stage, sub in params.items()}


def tree_from_jax(tree, device=None):
    """A JAX package params tree of numpy arrays (nested dicts and lists)
    as float32 tensors on `device` (default: the CPU), layouts kept."""
    return tree_map(lambda a: torch.tensor(np.asarray(a, np.float32),
                                           device=device), tree)

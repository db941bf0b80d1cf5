"""Fused bias + leaky-ReLU + scale: ``y = sqrt(2) * leaky_relu(x + b, 0.2)``.

Counterpart of the JAX package's ``ops/fused_act.py:26``.  It was never a
Pallas kernel there (XLA fuses it into the conv epilogue), so here it is
plain PyTorch elementwise code.  ``bias`` is per channel, channel axis 1
(NCHW feature maps and (B, D) style vectors alike).
"""

from __future__ import annotations

import math

import torch

SQRT2 = math.sqrt(2.0)


def fused_leaky_relu(x: torch.Tensor, bias=None, negative_slope: float = 0.2,
                     scale: float = SQRT2) -> torch.Tensor:
    """y = scale * leaky_relu(x + bias); bias broadcasts over axis 1."""
    if bias is not None:
        x = x + bias.reshape((1, -1) + (1,) * (x.dim() - 2))
    return scale * torch.where(x >= 0, x, negative_slope * x)

"""Matmul/conv precision policy.

Counterpart of the JAX package's ``ops/precision.py`` (tier at :28,
``schedule_suspended`` at :48-107), cut to what this port uses: the one
parity tier, "highest" — full fp32 for every matmul and convolution.  On
the card that means TF32 off for both cuBLAS and cuDNN; PyTorch leaves
cuDNN's TF32 on by default, so :func:`apply_parity_tier` turns it off.

Per-stage mixed-precision schedules are not ported yet.
:func:`schedule_suspended` marks the code that must always run at the
global tier (statistics and the edit solve), as in the JAX package, so a
sampling schedule, once added, cannot leak into the edit math.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

TIER = "highest"

_SCHEDULE_SUSPENDED: contextvars.ContextVar = contextvars.ContextVar(
    "precision_schedule_suspended", default=False)


def apply_parity_tier() -> None:
    """Set the global fp32 tier: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def schedule_suspended():
    """Pin the global tier for the code run within."""
    token = _SCHEDULE_SUSPENDED.set(True)
    try:
        yield
    finally:
        _SCHEDULE_SUSPENDED.reset(token)

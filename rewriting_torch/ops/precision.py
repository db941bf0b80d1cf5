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

:func:`deterministic` pins cuDNN to its deterministic algorithms for the
edits: the goals, the solves and their precomputed terms
(:func:`run_deterministic` marks such a function).  cuDNN's default
algorithms sum in an order that varies run to run, the weight gradients'
and on an H100 the forward convolutions' too (``scripts/
probe_solve_determinism.py --where``: the window's forward 4.8e-7 apart,
the fast solve's base convolution 3e-5), and an L1 loss under Adam turns
each flipped sign of a near-0 gradient into a whole step of lr, so
without it one solve run twice lands 1e-2 apart in the weights.  Sampling
and the statistics keep cuDNN's default algorithms: a rounding there does
not grow.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools

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


@contextlib.contextmanager
def deterministic():
    """cuDNN's deterministic algorithms (and no autotuning) for the code
    run within; the previous settings are put back after.  TF32 stays as
    the parity tier set it."""
    old = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = old


def run_deterministic(fn):
    """`fn` run inside :func:`deterministic` (a decorator)."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with deterministic():
            return fn(*args, **kwargs)
    return run

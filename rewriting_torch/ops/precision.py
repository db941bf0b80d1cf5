"""Matmul/conv precision policy: the global tier, per-stage schedules and
the int8 serving tier.

Counterpart of the JAX package's ``ops/precision.py`` (the tier at :28,
``set_precision_schedule`` and ``stage_scope`` at :54-78,
``schedule_suspended`` and ``suspend_schedule_in`` at :81-104,
``get_tier``, ``int8_active`` and ``get_precision`` at :107-135,
``cast_pytree`` at :138-149, here :func:`cast_params` on a dict of
tensors).  The names, signatures and semantics are the JAX package's; the
tiers are lax precisions there, which the TPU reads.  On Hopper they mean:

- ``"highest"`` (the default, the parity tier): fp32 with TF32 off in
  cuBLAS and cuDNN (:func:`apply_parity_tier`), and K1
  (``ops/upconv_blur.py``) in its 3xTF32 mode.
- ``"high"``: the same fp32 library convolutions and matmuls, and K1's
  3xTF32 split, the counterpart of the bf16x3 split the JAX kernel spells
  out (``pallas_upconv.py:58-78``).  A library call has no multi-pass
  mode, and one TF32 pass is less exact than bf16x3, so "high" computes
  as "highest" does.
- ``"default"``: bf16 operands with fp32 accumulation in the
  convolutions and matmuls of the stage (:func:`tiered`); K1 runs its
  one-pass bf16 mode.  PyTorch's bf16 convolutions and matmuls return
  their fp32 sums rounded to bf16, which :func:`tiered` widens to fp32 at
  once: one bf16 rounding of each output that the TPU's fp32 accumulator
  output does not have.  A sum split over ranks (tp's row layers) takes
  that rounding once, after its all-reduce (:func:`tiered_sum`).
  Activations stay fp32 between ops, as in the JAX package.
- ``"int8"``: ``ops/quant.conv2d_w8a8`` at the dconv sites
  (``models/stylegan2._make_dconv``), ``"default"`` for every other op of
  the stage.

Blur, noise and activation (K2, K3, the fused leaky ReLU, the RGB skip's
upsample) stay fp32 at every tier, as the JAX kernels do
(``pallas_upfirdn.py`` reads no precision).  The tier is read where each
op runs (:func:`get_precision`, :func:`int8_active`), never through a
process-wide flag; TF32 stays off everywhere.

A schedule applies where a pipeline has entered a stage's scope
(``core/stages.StagePipeline`` enters :func:`stage_scope` around every
stage).  :func:`schedule_suspended` pins the global tier for the code run
within: the statistics, the solves and the rewriter's renders enter it,
so an installed sampling schedule never changes an edit, bit for bit.

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
from typing import Callable, Optional

import torch

TIERS = ("highest", "high", "default")

_PRECISION = "highest"
# stage name -> tier override (or None to keep the global tier), read
# only inside a stage scope
_SCHEDULE: Optional[Callable[[str], Optional[str]]] = None
_CURRENT_STAGE: contextvars.ContextVar = contextvars.ContextVar(
    "precision_stage", default=None)
_SCHEDULE_SUSPENDED: contextvars.ContextVar = contextvars.ContextVar(
    "precision_schedule_suspended", default=False)


def apply_parity_tier() -> None:
    """Turn TF32 off in matmuls and convolutions: every fp32 library call
    computes in fp32, the "highest" and "high" tiers."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def set_precision(p: str) -> None:
    """Set the global tier: "highest" (the default), "high" or
    "default"."""
    global _PRECISION
    if p not in TIERS:
        raise ValueError(f"precision tier {p!r}: one of {TIERS}")
    _PRECISION = p


def set_precision_schedule(
        schedule: Optional[Callable[[str], Optional[str]]]) -> None:
    """Install (or clear, with None) a per-stage schedule:
    ``schedule(stage_name)`` returns a tier ("highest", "high", "default"
    or "int8") for the ops run inside that stage, or None to keep the
    global tier (``models.stylegan2.mixed_precision_schedule``)."""
    global _SCHEDULE
    _SCHEDULE = schedule


@contextlib.contextmanager
def stage_scope(name: str):
    """Marks the ops run within as pipeline stage `name`'s."""
    token = _CURRENT_STAGE.set(name)
    try:
        yield
    finally:
        _CURRENT_STAGE.reset(token)


@contextlib.contextmanager
def schedule_suspended():
    """Pin the global tier for the code run within: a stage's schedule
    override is ignored."""
    token = _SCHEDULE_SUSPENDED.set(True)
    try:
        yield
    finally:
        _SCHEDULE_SUSPENDED.reset(token)


def suspend_schedule_in(fn):
    """`fn` run inside :func:`schedule_suspended` (a decorator)."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with schedule_suspended():
            return fn(*args, **kwargs)
    return wrapped


def get_tier() -> str:
    """The tier's name where this runs: the active stage's schedule
    override, else the global tier.  May be "int8"."""
    tier = _PRECISION
    if _SCHEDULE is not None and not _SCHEDULE_SUSPENDED.get():
        stage = _CURRENT_STAGE.get()
        if stage is not None:
            override = _SCHEDULE(stage)
            if override is not None:
                tier = override
    return tier


def int8_active() -> bool:
    """True where the resolved tier is the int8 serving tier."""
    return get_tier() == "int8"


def get_precision() -> str:
    """The tier of the ops without an int8 path: "default" inside an int8
    stage."""
    tier = get_tier()
    return tier if tier in TIERS else "default"


def tiered(fn, *tensors, **kwargs):
    """``fn(*tensors, **kwargs)`` at the current tier: under "default"
    (and "int8") the tensors go in as bf16, and the result comes back
    widened to fp32; else they go in as they are."""
    if get_precision() != "default":
        return fn(*tensors, **kwargs)
    return fn(*(t.to(torch.bfloat16) for t in tensors), **kwargs).float()


def tiered_sum(fn, reduce, *tensors, **kwargs):
    """``reduce(fn(*tensors, **kwargs))``, where `fn` computes this rank's
    part of a sum that `reduce` completes over ranks (an all-reduce), at
    the current tier as one call on the whole computes it: under
    "default" (and "int8") the operands rounded to bf16 and the part
    computed and reduced in fp32, then the sum rounded to bf16 once, where
    :func:`tiered` would round each rank's part."""
    if get_precision() != "default":
        return reduce(fn(*tensors, **kwargs))
    part = fn(*(t.to(torch.bfloat16).float() for t in tensors), **kwargs)
    return reduce(part).to(torch.bfloat16).float()


def cast_params(tree, dtype):
    """The params tree with every floating tensor cast to `dtype` (the
    JAX package's ``cast_pytree``)."""
    if isinstance(tree, dict):
        return {k: cast_params(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_params(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


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

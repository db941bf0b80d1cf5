"""Timing and tracing helpers.

The port's counterpart of the JAX package's ``utils/profiling.py``
(:13-45), after the reference's wall-clock measurements
(ganrewrite.py ``return_timing`` with ``torch.cuda.synchronize``):

- ``timed``: a function's milliseconds a call, the device synchronised
  before each clock read;
- ``trace``: a ``torch.profiler`` trace of a region, exported as a Chrome
  trace (``chrome://tracing``, Perfetto) into a directory;
- ``annotate``: a named region in such a trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch


def _synchronize(result) -> None:
    """Wait for the CUDA device of the first CUDA tensor in `result` (a
    tensor, or a tuple, list or dict of them); nothing to wait for on the
    CPU."""
    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            torch.cuda.synchronize(result.device)
    elif isinstance(result, dict):
        for value in result.values():
            _synchronize(value)
    elif isinstance(result, (list, tuple)):
        for value in result:
            _synchronize(value)


def timed(fn: Callable, *args, iters: int = 1, warmup: int = 1, **kwargs):
    """(result, elapsed ms a call) over `iters` calls after `warmup`, the
    device of the result synchronised before each clock read."""
    result = None
    for _ in range(warmup):
        result = fn(*args, **kwargs)
    _synchronize(result)
    t0 = time.perf_counter()
    for _ in range(iters):
        result = fn(*args, **kwargs)
    _synchronize(result)
    return result, (time.perf_counter() - t0) * 1000.0 / iters


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the region (CPU, and CUDA where there is a device) and
    write its Chrome trace to ``logdir/trace.json``; yields the
    profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named region in profiler traces."""
    with torch.profiler.record_function(name):
        yield

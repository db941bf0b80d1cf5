"""The rewriter's running statistics: the per-unit mean and the
uncentered second moment, its key statistic.

Counterpart of the JAX package's ``stats/running.py`` (``RunningMean``
:95-110, the second moment :112-155): a state dict (``{"count", "mean"}``
or ``{"count", "mom"}``) with ``init``/``update`` functions and a thin
object around it, whose ``state_dict`` round-trips through the npz cache in
the same format as the JAX package's.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

State = Dict[str, torch.Tensor]


class _Running:
    """A state dict of tensors that saves to, and loads from, the npz
    cache's arrays with a ``constructor`` tag."""

    _constructor = ""

    def __init__(self, state: State = None):
        self.state = state

    @property
    def count(self) -> float:
        return float(self.state["count"])

    def state_dict(self) -> Dict[str, np.ndarray]:
        d = {k: v.detach().cpu().numpy() for k, v in self.state.items()}
        d["constructor"] = np.array(self._constructor)
        return d

    @classmethod
    def from_state_dict(cls, d, device=None):
        return cls({k: torch.as_tensor(np.asarray(v), device=device)
                    for k, v in d.items() if k != "constructor"})


def mean_init(shape, device=None, dtype=torch.float32) -> State:
    return {"count": torch.zeros((), dtype=torch.float32, device=device),
            "mean": torch.zeros(shape, dtype=dtype, device=device)}


def mean_update(state: State, batch: torch.Tensor) -> State:
    """mean' = mean + (mean of batch - mean) * N / (n + N) over the rows
    of batch (N, ...)."""
    nb = float(batch.shape[0])
    count = state["count"] + nb
    bmean = torch.mean(batch, dim=0)
    return {"count": count,
            "mean": state["mean"] + (bmean - state["mean"]) * (nb / count)}


class RunningMean(_Running):
    """Accumulates the mean of rows over batches."""

    _constructor = "rewriting_torch.stats.RunningMean"

    def add(self, batch: torch.Tensor) -> None:
        if self.state is None:
            self.state = mean_init(batch.shape[1:], batch.device,
                                   batch.dtype)
        self.state = mean_update(self.state, batch)

    def mean(self) -> torch.Tensor:
        return self.state["mean"]


def second_moment_init(dim: int, device=None,
                       dtype=torch.float32) -> State:
    return {"count": torch.zeros((), dtype=torch.float32, device=device),
            "mom": torch.zeros((dim, dim), dtype=dtype, device=device)}


def second_moment_update(state: State, batch: torch.Tensor) -> State:
    """batch (N, C): mom' = mom + (batchᵀbatch - N·mom) / (n + N), in fp32
    (the incremental weighting does not overflow)."""
    nb = float(batch.shape[0])
    count = state["count"] + nb
    xtx = batch.t() @ batch
    return {"count": count,
            "mom": state["mom"] + (xtx - nb * state["mom"]) / count}


class RunningSecondMoment(_Running):
    """Accumulates E[x xᵀ] over batches of rows."""

    _constructor = "rewriting_torch.stats.RunningSecondMoment"

    def add(self, batch: torch.Tensor) -> None:
        if self.state is None:
            self.state = second_moment_init(batch.shape[-1], batch.device,
                                            batch.dtype)
        self.state = second_moment_update(self.state, batch)

    def moment(self) -> torch.Tensor:
        return self.state["mom"]

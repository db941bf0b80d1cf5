"""The uncentered second moment, the rewriter's key statistic.

Counterpart of the JAX package's ``stats/running.py`` (:112-155): a state
dict ``{"count", "mom"}`` with ``init``/``update`` functions and a thin
object around it, whose ``state_dict`` round-trips through the npz cache in
the same format as the JAX package's.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

State = Dict[str, torch.Tensor]


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


class RunningSecondMoment:
    """Accumulates E[x xᵀ] over batches of rows."""

    _constructor = "rewriting_torch.stats.RunningSecondMoment"

    def __init__(self, state: State = None):
        self.state = state

    def add(self, batch: torch.Tensor) -> None:
        if self.state is None:
            self.state = second_moment_init(batch.shape[-1], batch.device,
                                            batch.dtype)
        self.state = second_moment_update(self.state, batch)

    def moment(self) -> torch.Tensor:
        return self.state["mom"]

    @property
    def count(self) -> float:
        return float(self.state["count"])

    def state_dict(self) -> Dict[str, np.ndarray]:
        d = {k: v.detach().cpu().numpy() for k, v in self.state.items()}
        d["constructor"] = np.array(self._constructor)
        return d

    @classmethod
    def from_state_dict(cls, d, device=None) -> "RunningSecondMoment":
        return cls({k: torch.as_tensor(np.asarray(v), device=device)
                    for k, v in d.items() if k != "constructor"})

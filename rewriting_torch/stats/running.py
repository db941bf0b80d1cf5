"""Streaming statistics as reducer states over device tensors.

Counterpart of the JAX package's ``stats/running.py``: every reducer is a
state dict of tensors with ``init``/``update`` (and, where the JAX package
has one, ``merge``) functions and a thin object around it, whose
``state_dict`` round-trips through the npz cache in the same format as the
JAX package's, so a cache written by either package loads in the other
(the ``constructor`` tag names the package that wrote it and is ignored
on loading).

- ``RunningMean`` and the uncentered ``RunningSecondMoment`` (the
  rewriter's key statistic);
- ``RunningVariance``, ``RunningCovariance`` and ``RunningCrossCovariance``
  with Chan's stable updates and merges;
- ``RunningBincount``, ``RunningTopK`` (a concatenation, then
  ``torch.topk`` along the units), ``RunningAllIntersectionAndUnion``
  (indicator matmuls);
- ``GatherTensor`` (host numpy, as in the JAX package) and the
  conditional reducers, one inner reducer per condition, keyed in the
  state dict as ``c.{repr(condition)}.{key}``.

Each reducer keeps its state on the device of the first batch it is
given; ``from_state_dict`` and ``set_state_dict`` take the device to load
onto.
"""

from __future__ import annotations

import ast
from typing import Dict, Optional

import numpy as np
import torch

from .quantile import RunningQuantile

State = Dict[str, torch.Tensor]


def _np_state(state: State) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy().copy() for k, v in state.items()}


def _tensor_state(d, device) -> State:
    return {k: torch.as_tensor(np.asarray(v), device=device)
            for k, v in d.items() if k != "constructor"}


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
        d = _np_state(self.state)
        d["constructor"] = np.array(self._constructor)
        return d

    @classmethod
    def from_state_dict(cls, d, device=None):
        obj = cls.__new__(cls)
        obj.state = _tensor_state(d, device)
        return obj

    def set_state_dict(self, d, device=None) -> None:
        self.state = _tensor_state(d, device)


def _zero_count(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=device)


def _merge_weight(count_a, count_b):
    """b's share of the merged count, 0 where both are empty."""
    count = count_a + count_b
    return count, torch.where(count > 0,
                              count_b / torch.clamp(count, min=1e-20),
                              torch.zeros_like(count))


# -- mean ----------------------------------------------------------------------

def mean_init(shape, device=None, dtype=torch.float32) -> State:
    return {"count": _zero_count(device),
            "mean": torch.zeros(shape, dtype=dtype, device=device)}


def mean_update(state: State, batch: torch.Tensor) -> State:
    """mean' = mean + (mean of batch - mean) * N / (n + N) over the rows
    of batch (N, ...)."""
    nb = float(batch.shape[0])
    count = state["count"] + nb
    bmean = torch.mean(batch, dim=0)
    return {"count": count,
            "mean": state["mean"] + (bmean - state["mean"]) * (nb / count)}


def mean_merge(a: State, b: State) -> State:
    count, w = _merge_weight(a["count"], b["count"])
    return {"count": count, "mean": a["mean"] + (b["mean"] - a["mean"]) * w}


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


# -- uncentered second moment --------------------------------------------------

def second_moment_init(dim: int, device=None,
                       dtype=torch.float32) -> State:
    return {"count": _zero_count(device),
            "mom": torch.zeros((dim, dim), dtype=dtype, device=device)}


def second_moment_update(state: State, batch: torch.Tensor) -> State:
    """batch (N, C): mom' = mom + (batchᵀbatch - N·mom) / (n + N), in fp32
    (the incremental weighting does not overflow)."""
    nb = float(batch.shape[0])
    count = state["count"] + nb
    xtx = batch.t() @ batch
    return {"count": count,
            "mom": state["mom"] + (xtx - nb * state["mom"]) / count}


def second_moment_merge(a: State, b: State) -> State:
    count, w = _merge_weight(a["count"], b["count"])
    return {"count": count, "mom": a["mom"] + (b["mom"] - a["mom"]) * w}


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


# -- per-unit variance ---------------------------------------------------------

def variance_init(shape, device=None, dtype=torch.float32) -> State:
    return {"count": _zero_count(device),
            "mean": torch.zeros(shape, dtype=dtype, device=device),
            "m2": torch.zeros(shape, dtype=dtype, device=device)}


def variance_update(state: State, batch: torch.Tensor) -> State:
    nb = float(batch.shape[0])
    count = state["count"] + nb
    bmean = torch.mean(batch, dim=0)
    bm2 = torch.sum(torch.square(batch - bmean), dim=0)
    delta = bmean - state["mean"]
    w = nb / count
    return {"count": count,
            "mean": state["mean"] + delta * w,
            "m2": state["m2"] + bm2 + torch.square(delta) * state["count"]
            * w}


def variance_merge(a: State, b: State) -> State:
    count = a["count"] + b["count"]
    safe = torch.clamp(count, min=1e-20)
    delta = b["mean"] - a["mean"]
    return {"count": count,
            "mean": a["mean"] + delta * (b["count"] / safe),
            "m2": a["m2"] + b["m2"]
            + torch.square(delta) * a["count"] * b["count"] / safe}


def _unbiased_div(m, n, unbiased):
    return m / torch.clamp(n - (1.0 if unbiased else 0.0), min=1e-20)


class RunningVariance(_Running):
    _constructor = "rewriting_torch.stats.RunningVariance"

    def add(self, batch: torch.Tensor) -> None:
        if self.state is None:
            self.state = variance_init(batch.shape[1:], batch.device,
                                       batch.dtype)
        self.state = variance_update(self.state, batch)

    def mean(self) -> torch.Tensor:
        return self.state["mean"]

    def variance(self, unbiased=True) -> torch.Tensor:
        return _unbiased_div(self.state["m2"], self.state["count"], unbiased)

    def stdev(self, unbiased=True) -> torch.Tensor:
        return torch.sqrt(self.variance(unbiased))


# -- covariance ----------------------------------------------------------------

def covariance_init(dim: int, device=None, dtype=torch.float32) -> State:
    return {"count": _zero_count(device),
            "mean": torch.zeros((dim,), dtype=dtype, device=device),
            "cmom2": torch.zeros((dim, dim), dtype=dtype, device=device)}


def covariance_update(state: State, batch: torch.Tensor) -> State:
    nb = float(batch.shape[0])
    count = state["count"] + nb
    bmean = torch.mean(batch, dim=0)
    centered = batch - bmean
    delta = bmean - state["mean"]
    w = nb / count
    return {"count": count,
            "mean": state["mean"] + delta * w,
            "cmom2": state["cmom2"] + centered.t() @ centered
            + torch.outer(delta, delta) * state["count"] * w}


def covariance_merge(a: State, b: State) -> State:
    count = a["count"] + b["count"]
    safe = torch.clamp(count, min=1e-20)
    delta = b["mean"] - a["mean"]
    return {"count": count,
            "mean": a["mean"] + delta * (b["count"] / safe),
            "cmom2": a["cmom2"] + b["cmom2"]
            + torch.outer(delta, delta) * a["count"] * b["count"] / safe}


class RunningCovariance(_Running):
    _constructor = "rewriting_torch.stats.RunningCovariance"

    def add(self, batch: torch.Tensor) -> None:
        if self.state is None:
            self.state = covariance_init(batch.shape[-1], batch.device,
                                         batch.dtype)
        self.state = covariance_update(self.state, batch)

    def mean(self) -> torch.Tensor:
        return self.state["mean"]

    def covariance(self, unbiased=True) -> torch.Tensor:
        return _unbiased_div(self.state["cmom2"], self.state["count"],
                             unbiased)

    def correlation(self) -> torch.Tensor:
        cov = self.covariance()
        rstd = torch.rsqrt(torch.clamp(torch.diag(cov), min=1e-30))
        return cov * rstd[:, None] * rstd[None, :]

    def variance(self, unbiased=True) -> torch.Tensor:
        return torch.diag(self.covariance(unbiased))


# -- cross covariance ----------------------------------------------------------

def cross_covariance_init(dim_a: int, dim_b: int, device=None,
                          dtype=torch.float32) -> State:
    return {"count": _zero_count(device),
            "mean_a": torch.zeros((dim_a,), dtype=dtype, device=device),
            "mean_b": torch.zeros((dim_b,), dtype=dtype, device=device),
            "cmom2": torch.zeros((dim_a, dim_b), dtype=dtype, device=device)}


def cross_covariance_update(state: State, a: torch.Tensor, b: torch.Tensor
                            ) -> State:
    nb = float(a.shape[0])
    count = state["count"] + nb
    amean, bmean = torch.mean(a, dim=0), torch.mean(b, dim=0)
    da, db = amean - state["mean_a"], bmean - state["mean_b"]
    w = nb / count
    return {"count": count,
            "mean_a": state["mean_a"] + da * w,
            "mean_b": state["mean_b"] + db * w,
            "cmom2": state["cmom2"] + (a - amean).t() @ (b - bmean)
            + torch.outer(da, db) * state["count"] * w}


class RunningCrossCovariance(_Running):
    _constructor = "rewriting_torch.stats.RunningCrossCovariance"

    def add(self, a: torch.Tensor, b: torch.Tensor) -> None:
        if self.state is None:
            self.state = cross_covariance_init(a.shape[-1], b.shape[-1],
                                               a.device, a.dtype)
        self.state = cross_covariance_update(self.state, a, b)

    def mean(self):
        return self.state["mean_a"], self.state["mean_b"]

    def cross_covariance(self, unbiased=True) -> torch.Tensor:
        return _unbiased_div(self.state["cmom2"], self.state["count"],
                             unbiased)


# -- bincount ------------------------------------------------------------------

def bincount_init(size: int, device=None) -> State:
    return {"count": _zero_count(device),
            "bins": torch.zeros((size,), dtype=torch.float32,
                                device=device)}


def bincount_update(state: State, batch: torch.Tensor) -> State:
    """Counts of the values 0 .. size-1 of the batch; others are dropped,
    as by the JAX package's fixed-length bincount."""
    size = state["bins"].shape[0]
    counts = torch.bincount(batch.reshape(-1), minlength=size)[:size]
    return {"count": state["count"] + batch.shape[0],
            "bins": state["bins"] + counts}


class RunningBincount(_Running):
    _constructor = "rewriting_torch.stats.RunningBincount"

    def __init__(self, size: int = 1024, state=None):
        super().__init__(state)
        self.size = size

    def add(self, batch: torch.Tensor, size: Optional[int] = None) -> None:
        if self.state is None:
            self.state = bincount_init(size or self.size, batch.device)
        self.state = bincount_update(self.state, batch)

    def result(self) -> torch.Tensor:
        return self.state["bins"]


# -- top-k ---------------------------------------------------------------------

def topk_init(units: int, k: int, device=None) -> State:
    return {"count": torch.zeros((), dtype=torch.int32, device=device),
            "values": torch.full((units, k), -float("inf"),
                                 dtype=torch.float32, device=device),
            "indices": torch.zeros((units, k), dtype=torch.int32,
                                   device=device)}


def topk_update(state: State, batch: torch.Tensor) -> State:
    """batch (B, units): the batch's scores merged into each unit's top
    k, with their sample numbers (count .. count + B - 1)."""
    b = batch.shape[0]
    scores = batch.t().to(torch.float32)                   # (units, B)
    idx = state["count"] + torch.arange(b, dtype=torch.int32,
                                        device=batch.device)
    all_vals = torch.cat([state["values"], scores], dim=1)
    all_idx = torch.cat([state["indices"], idx.expand(scores.shape)], dim=1)
    top_vals, pos = torch.topk(all_vals, state["values"].shape[1], dim=1)
    return {"count": state["count"] + b, "values": top_vals,
            "indices": torch.gather(all_idx, 1, pos)}


class RunningTopK(_Running):
    """Each unit's top k scores over the samples and the sample numbers
    that reached them."""

    _constructor = "rewriting_torch.stats.RunningTopK"

    def __init__(self, k: int = 100, state=None):
        super().__init__(state)
        self.k = k

    def add(self, batch: torch.Tensor) -> None:
        if batch.dim() == 1:
            batch = batch[:, None]
        if self.state is None:
            self.state = topk_init(batch.shape[1], self.k, batch.device)
        self.state = topk_update(self.state, batch)

    def result(self):
        """(values (units, k), indices (units, k)), each row descending."""
        return self.state["values"], self.state["indices"]

    @property
    def count(self) -> int:
        return int(self.state["count"])


# -- GatherTensor --------------------------------------------------------------

class GatherTensor:
    """One data row per (unit, rank) slot, allocated on the first add:
    e.g. the image crops of each unit's top-k samples, gathered without
    holding every sample (host numpy)."""

    def __init__(self, topk: Optional[RunningTopK] = None,
                 k: Optional[int] = None):
        self.topk = topk
        self.k = k if k is not None else (topk.k if topk else None)
        self._data = None

    def add(self, unit: int, rank: int, value) -> None:
        value = np.asarray(value)
        if self._data is None:
            units = (self.topk.state["values"].shape[0]
                     if self.topk is not None else unit + 1)
            self._data = np.zeros((units, self.k) + value.shape,
                                  value.dtype)
        if unit >= self._data.shape[0]:
            grown = np.zeros((unit + 1,) + self._data.shape[1:],
                             self._data.dtype)
            grown[:self._data.shape[0]] = self._data
            self._data = grown
        self._data[unit, rank] = value

    def result(self):
        return self._data

    def state_dict(self):
        return {"constructor": np.array("rewriting_torch.stats.GatherTensor"),
                "k": np.array(self.k),
                "data": self._data if self._data is not None
                else np.zeros((0, 0))}

    def set_state_dict(self, d) -> None:
        self.k = int(d["k"])
        data = np.asarray(d["data"])
        self._data = data if data.size else None


# -- all-pairs intersection and union ------------------------------------------

def iou_init(n_a: int, n_b: int, device=None) -> State:
    return {"intersection": torch.zeros((n_a, n_b), dtype=torch.float32,
                                        device=device),
            "total_a": torch.zeros((n_a,), dtype=torch.float32,
                                   device=device),
            "total_b": torch.zeros((n_b,), dtype=torch.float32,
                                   device=device),
            "count": _zero_count(device)}


def iou_update(state: State, masks_a: torch.Tensor, masks_b: torch.Tensor
               ) -> State:
    """masks_* (N, units) 0/1 indicators per sample position; the
    intersections as one indicator matmul."""
    a = masks_a.to(torch.float32)
    b = masks_b.to(torch.float32)
    return {"intersection": state["intersection"] + a.t() @ b,
            "total_a": state["total_a"] + a.sum(0),
            "total_b": state["total_b"] + b.sum(0),
            "count": state["count"] + a.shape[0]}


class RunningAllIntersectionAndUnion(_Running):
    _constructor = "rewriting_torch.stats.RunningAllIntersectionAndUnion"

    def add(self, masks_a: torch.Tensor, masks_b: torch.Tensor) -> None:
        if self.state is None:
            self.state = iou_init(masks_a.shape[1], masks_b.shape[1],
                                  masks_a.device)
        self.state = iou_update(self.state, masks_a, masks_b)

    def iou(self) -> torch.Tensor:
        inter = self.state["intersection"]
        union = (self.state["total_a"][:, None]
                 + self.state["total_b"][None, :] - inter)
        return inter / torch.clamp(union, min=1e-20)

    def intersection(self) -> torch.Tensor:
        return self.state["intersection"]


# -- conditional reducers ------------------------------------------------------

class _RunningConditional:
    """One inner reducer per condition (a data-dependent label set, so a
    host-side dict); `kwargs` construct each inner reducer."""

    _constructor = ""

    def __init__(self, **kwargs):
        self.stats = {}
        self.kwargs = kwargs

    def _inner(self):
        raise NotImplementedError

    def add(self, condition, *batches) -> None:
        if condition not in self.stats:
            self.stats[condition] = self._inner()
        self.stats[condition].add(*batches)

    def keys(self):
        return self.stats.keys()

    def conditional(self, condition):
        return self.stats[condition]

    def has_conditional(self, condition) -> bool:
        return condition in self.stats

    def most_common_conditions(self, n):
        counts = sorted(((s.count, c) for c, s in self.stats.items()),
                        reverse=True)
        return [c for _, c in counts[:n]]

    def state_dict(self):
        d = {"constructor": np.array(self._constructor),
             "conditions": np.array([repr(c) for c in self.stats])}
        for c, s in self.stats.items():
            for k, v in s.state_dict().items():
                d[f"c.{c!r}.{k}"] = v
        return d

    def set_state_dict(self, d, device=None) -> None:
        for c_repr in d["conditions"]:
            prefix = f"c.{c_repr}."
            sub = {k[len(prefix):]: v for k, v in d.items()
                   if k.startswith(prefix)}
            try:
                cond = ast.literal_eval(str(c_repr))
            except (ValueError, SyntaxError):
                cond = str(c_repr)
            inner = self._inner()
            inner.set_state_dict(sub, device)
            self.stats[cond] = inner


class RunningConditionalMean(_RunningConditional):
    _constructor = "rewriting_torch.stats.RunningConditionalMean"

    def _inner(self):
        return RunningMean(**self.kwargs)


class RunningConditionalVariance(_RunningConditional):
    _constructor = "rewriting_torch.stats.RunningConditionalVariance"

    def _inner(self):
        return RunningVariance(**self.kwargs)


class RunningConditionalTopK(_RunningConditional):
    _constructor = "rewriting_torch.stats.RunningConditionalTopK"

    def _inner(self):
        return RunningTopK(**self.kwargs)


class RunningConditionalQuantile(_RunningConditional):
    _constructor = "rewriting_torch.stats.RunningConditionalQuantile"

    def _inner(self):
        return RunningQuantile(**self.kwargs)

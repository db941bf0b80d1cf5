"""Streaming per-unit quantile sketch (KLL: multi-level sorted buffers
with random-offset halving).

Counterpart of the JAX package's ``stats/quantile.py`` (``RunningQuantile``
:59-328), after the reference's utils/runningstats.py:269-620:

- The level buffers are tensors ``(units, cap)`` on the sketch's device.
  Ingest writes a batch into level 0 in place; a full level is compacted
  by ``torch.sort`` along the units' rows and a strided slice from a
  random offset, and the survivors (of doubled weight) move one level up.
  Batches never go to the host.
- The fill counters are host integers: the compaction cadence depends
  only on how many values arrive, not on the values.
- The random offsets come from ``np.random.RandomState(seed)`` in the
  JAX package's order, one draw per compaction, so fed the same float32
  stream the two packages' sketches hold the same level buffers (a sort
  of equal values gives equal rows whatever the algorithm).
- The query side (``quantiles``, ``normalize``, ``integrate``, ``mean``,
  ``min``, ``max``) runs in host numpy on the merged summary and returns
  numpy arrays: it is called once per statistic, not per batch.

Exact extremes, and estimates within 1/1000 of the rank range for
adversarially ordered streams at the default resolution
(tests/test_torch_stats.py).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..utils.device import resolve_device


class RunningQuantile:
    """Per-unit streaming quantiles over batches shaped (N, units).

    The buffers live on `device` when one is given (``"cuda"`` raises
    without CUDA), else on the device of the first batch; batches are
    moved there."""

    def __init__(self, resolution: int = 6 * 1024, seed: int = 0,
                 state=None, device=None):
        self.resolution = int(resolution)
        self.cap = max(32, int(resolution) // 2)
        self.rng = np.random.RandomState(seed)
        self.device = None if device is None else resolve_device(device)
        self.units: Optional[int] = None
        self.count = 0.0
        self.batchcount = 0
        self.levels: List[torch.Tensor] = []
        self.fill: List[int] = []
        self.extremes: Optional[torch.Tensor] = None    # (units, 2)
        # query-side caches, valid while _version is unchanged
        self._version = 0
        self._summary_cache = None
        self._flat_cache = {}
        if state is not None:
            self.set_state_dict(state)

    # -- ingest -------------------------------------------------------------
    def _new_level(self) -> torch.Tensor:
        return torch.zeros((self.units, self.cap), dtype=torch.float32,
                           device=self.device)

    def _ensure(self, units: int) -> None:
        if self.units is None:
            self.units = units
            self.levels = [self._new_level()]
            self.fill = [0]
            inf = torch.full((units,), float("inf"), dtype=torch.float32,
                             device=self.device)
            self.extremes = torch.stack([inf, -inf], dim=1)
        if units != self.units:
            raise ValueError(f"batch of {units} units, sketch of "
                             f"{self.units}")

    def add(self, batch) -> None:
        """batch (N, units), or (N,) for one unit."""
        batch = torch.as_tensor(batch)
        if self.device is None:
            self.device = batch.device
        batch = batch.to(device=self.device, dtype=torch.float32)
        if batch.dim() == 1:
            batch = batch[:, None]
        self._ensure(batch.shape[1])
        x = batch.t()                                    # (units, N)
        self.extremes = torch.stack(
            [torch.minimum(self.extremes[:, 0], x.amin(dim=1)),
             torch.maximum(self.extremes[:, 1], x.amax(dim=1))], dim=1)
        self.count += batch.shape[0]
        self.batchcount += 1
        self._version += 1
        n = x.shape[1]
        pos = 0
        while pos < n:
            if self.fill[0] == self.cap:
                self._compact(0)
            take = min(self.cap - self.fill[0], n - pos)
            self.levels[0][:, self.fill[0]:self.fill[0] + take] = \
                x[:, pos:pos + take]
            self.fill[0] += take
            pos += take

    def _compact(self, level: int) -> None:
        """Sort the full level and keep every other value from a random
        offset; the survivors move one level up (compacting it first if
        they do not fit)."""
        survivors = torch.sort(self.levels[level], dim=1).values[
            :, int(self.rng.randint(2))::2]
        self.fill[level] = 0
        if level + 1 == len(self.levels):
            self.levels.append(self._new_level())
            self.fill.append(0)
        if self.cap - self.fill[level + 1] < survivors.shape[1]:
            self._compact(level + 1)
        f = self.fill[level + 1]
        self.levels[level + 1][:, f:f + survivors.shape[1]] = survivors
        self.fill[level + 1] += survivors.shape[1]

    # -- summary (host numpy) -------------------------------------------------
    def _summary(self):
        """(values (units, M) sorted, weights (units, M)) merged across
        levels; memoized until the next add."""
        if (self._summary_cache is not None
                and self._summary_cache[0] == self._version):
            return self._summary_cache[1]
        vals, weights = [], []
        for lvl, (buf, f) in enumerate(zip(self.levels, self.fill)):
            if f > 0:
                vals.append(buf[:, :f].cpu().numpy())
                weights.append(np.full(f, 2.0 ** lvl, np.float32))
        if not vals:
            units = self.units or 1
            out = (np.zeros((units, 1), np.float32),
                   np.ones((units, 1), np.float32))
        else:
            v = np.concatenate(vals, axis=1)
            w = np.concatenate(weights)
            order = np.argsort(v, axis=1)
            out = np.take_along_axis(v, order, axis=1), w[order]
        self._summary_cache = (self._version, out)
        return out

    def _np_extremes(self) -> np.ndarray:
        return self.extremes.cpu().numpy()

    # Crossover between the two _row_searchsorted strategies, the JAX
    # package's: the flat search over a cached offset copy wins for few
    # queries a unit, the per-row loop for many (its searches stay log2(M)
    # deep where the flat one's are log2(U*M)).
    _FLAT_SEARCH_MAX_N = 128

    def _flat_index(self, key, a):
        """Offset-flattened copy of row-sorted a (U, M), cached per sketch
        version; None when a is not finite (the offsets would be NaN)."""
        hit = self._flat_cache.get(key)
        if hit is not None and hit[0] == self._version:
            return hit[1]
        a64 = np.asarray(a, np.float64)
        if not np.isfinite(a64).all():
            entry = None
        else:
            lo = a64.min() - 1.0
            hi = a64.max() + 1.0
            span = (hi - lo) + 1.0
            offs = np.arange(a64.shape[0], dtype=np.float64)[:, None] * span
            entry = ((a64 - lo) + offs).ravel(), lo, hi, offs
        self._flat_cache[key] = (self._version, entry)
        return entry

    def _row_searchsorted(self, key, a, b, side="left"):
        """Per-row searchsorted: a (U, M) row-sorted, b (U, N) -> indices
        (U, N) in [0, M]; one flat search for few queries a row, a loop
        over the rows for many."""
        a = np.asarray(a)
        b = np.asarray(b)
        U, M = a.shape
        entry = (self._flat_index(key, a)
                 if b.shape[1] <= self._FLAT_SEARCH_MAX_N else None)
        if entry is not None and np.isfinite(b).all():
            a_flat, lo, hi, offs = entry
            b64 = np.clip(b.astype(np.float64), lo, hi)
            flat = np.searchsorted(a_flat, (b64 - lo) + offs, side)
            return flat - np.arange(U)[:, None] * M
        return np.stack([np.searchsorted(a[u], b[u], side)
                         for u in range(U)])

    def quantiles(self, qs) -> np.ndarray:
        """(units, len(qs)) estimates of the quantiles qs in [0, 1]; 0 and
        1 give the exact extremes."""
        qs = np.atleast_1d(np.asarray(qs, dtype=np.float64))
        v, w = self._summary()
        extremes = self._np_extremes()
        cum = np.cumsum(w, axis=1)
        total = cum[:, -1:]
        # midpoint rank of each summary value, strictly increasing per row
        positions = (cum - w / 2.0) / total
        U, M = positions.shape
        i = self._row_searchsorted("positions", positions,
                                   np.broadcast_to(qs, (U, len(qs))),
                                   side="right")
        lo_i = np.clip(i - 1, 0, M - 1)
        hi_i = np.clip(i, 0, M - 1)
        plo = np.take_along_axis(positions, lo_i, axis=1)
        phi = np.take_along_axis(positions, hi_i, axis=1)
        vlo = np.take_along_axis(v.astype(np.float64), lo_i, axis=1)
        vhi = np.take_along_axis(v.astype(np.float64), hi_i, axis=1)
        denom = phi - plo
        t = np.clip((qs[None, :] - plo)
                    / np.where(denom > 0, denom, 1.0), 0.0, 1.0)
        out = vlo + t * (vhi - vlo)
        # outside the summary's rank range: the exact extremes
        out = np.where(qs[None, :] < positions[:, :1],
                       extremes[:, :1].astype(np.float64), out)
        out = np.where(qs[None, :] > positions[:, -1:],
                       extremes[:, 1:].astype(np.float64), out)
        out = out.astype(np.float32)
        out[:, qs <= 0.0] = extremes[:, :1]
        out[:, qs >= 1.0] = extremes[:, 1:]
        return out

    def normalize(self, values) -> np.ndarray:
        """Estimated CDF per unit: values (units, N) -> ranks in [0, 1]
        ((units,) -> (units,))."""
        values = np.asarray(values, dtype=np.float32)
        squeeze = values.ndim == 1
        if squeeze:
            values = values[:, None]
        v, w = self._summary()
        cum = np.cumsum(w, axis=1)
        total = cum[:, -1]
        idx = self._row_searchsorted("values", v, values, side="right")
        ranks = np.where(idx > 0,
                         np.take_along_axis(cum, np.maximum(idx - 1, 0),
                                            axis=1), 0.0)
        out = np.clip((ranks / total[:, None]).astype(np.float32), 0.0, 1.0)
        return out[:, 0] if squeeze else out

    def integrate(self, fun) -> np.ndarray:
        """sum_i w_i fun(v_i) per unit over the summary."""
        v, w = self._summary()
        return np.sum(np.asarray(fun(v)) * w, axis=1)

    def mean(self) -> np.ndarray:
        v, w = self._summary()
        return np.sum(v * w, axis=1) / np.sum(w, axis=1)

    def min(self) -> np.ndarray:
        return self._np_extremes()[:, 0]

    def max(self) -> np.ndarray:
        return self._np_extremes()[:, 1]

    @property
    def size(self) -> float:
        return self.count

    # -- serialization --------------------------------------------------------
    def state_dict(self):
        d = {"constructor": np.array("rewriting_torch.stats.RunningQuantile"),
             "resolution": np.array(self.resolution),
             "cap": np.array(self.cap),
             "count": np.array(self.count),
             "batchcount": np.array(self.batchcount),
             "units": np.array(self.units if self.units else 0),
             "fill": np.array(self.fill, np.int64),
             "extremes": (self._np_extremes().copy()
                          if self.extremes is not None
                          else np.zeros((0, 2), np.float32))}
        for i, (buf, f) in enumerate(zip(self.levels, self.fill)):
            d[f"level_{i}"] = buf[:, :f].cpu().numpy().copy()
        return d

    def set_state_dict(self, d, device=None) -> None:
        """Load a state dict (of either package); onto `device` if given,
        else the sketch's own device (the CPU if it has none yet).  A
        dict without ``resolution`` keeps the sketch's own: the tally
        cache keys on it and ``load_cached_state`` takes the key out."""
        if device is not None:
            self.device = resolve_device(device)
        self._version += 1
        self._summary_cache = None
        self._flat_cache = {}
        self.resolution = int(d.get("resolution", self.resolution))
        self.cap = int(d["cap"])
        self.count = float(d["count"])
        self.batchcount = int(d.get("batchcount", 0))
        units = int(d["units"])
        self.units = units if units else None
        self.fill = [int(f) for f in d["fill"]]
        self.extremes = torch.as_tensor(
            np.asarray(d["extremes"], np.float32), device=self.device)
        self.levels = []
        for i, f in enumerate(self.fill):
            buf = np.zeros((units, self.cap), np.float32)
            buf[:, :f] = np.asarray(d[f"level_{i}"], np.float32)
            self.levels.append(torch.as_tensor(buf, device=self.device))

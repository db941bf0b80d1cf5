"""Drive a compute closure over z batches into a reducer, with the
arg-keyed npz cache.

Counterpart of the JAX package's ``stats/tally.py``: ``load_cached_state``
and ``save_cached_state`` (:35-60) keep its file format (the state arrays
plus the cache-key arguments as npz entries), so a cache written by either
package loads in the other.  Each ``tally_*`` feeds ``compute(zbatch)`` of
every batch of the z dataset (the last may be short) to its reducer, with
the z batch on `device`, without autograd; the cache is keyed on the
sample and batch sizes and the tally's own arguments (``k``,
``resolution``, ``size``).  ``tally_second_moment`` is the loop that the
JAX package's ``tally_second_moment_scan`` (:422-460) compiles into one
program; with ``mesh=`` each rank of the mesh takes its share of every z
batch and the ranks' states are merged by an all-reduce, and
``cached_second_moment`` adds the cache, which on a mesh rank 0 alone
writes.

The conditional tallies take ``compute(zbatch) -> [(condition, rows),
...]``; ``conditional_samples`` makes those pairs from activations and
segmentations on the device.  The IoU, mutual-information and
information-quality statistics of the conditional reducers run in host
numpy and return numpy arrays, as the JAX package computes them.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..parallel import comm
from . import running
from .quantile import RunningQuantile
from .running import RunningMean, RunningSecondMoment


def load_cached_state(cachefile: Optional[str], args: dict):
    """The cached state dict, or None if absent or its key arguments
    differ from `args`."""
    if cachefile is None or not os.path.exists(cachefile):
        return None
    with np.load(cachefile, allow_pickle=False) as f:
        dat = dict(f)
    for a, v in args.items():
        if a not in dat or str(dat[a]) != str(v):
            print(f"{cachefile} differs at {a}: {dat.get(a)} vs {v}; "
                  "recomputing")
            return None
        del dat[a]
    return dat


def save_cached_state(cachefile: Optional[str], obj, args: dict) -> None:
    if cachefile is None:
        return
    d = obj.state_dict()
    for a, v in args.items():
        if a in d and str(d[a]) != str(v):
            raise ValueError(f"cache argument {a!r} = {v} collides with a "
                             f"state entry {d[a]}")
        d[a] = np.array(v)
    os.makedirs(os.path.dirname(cachefile) or ".", exist_ok=True)
    np.savez(cachefile, **d)


class _States:
    """Several reducers saved into one npz, each under its prefix."""

    def __init__(self, **reducers):
        self.reducers = reducers

    def state_dict(self):
        return {f"{name}.{k}": v for name, r in self.reducers.items()
                for k, v in r.state_dict().items()}

    @staticmethod
    def part(cached: dict, name: str) -> dict:
        prefix = f"{name}."
        return {k[len(prefix):]: v for k, v in cached.items()
                if k.startswith(prefix)}


class _Arrays:
    """Arrays saved as they are."""

    def __init__(self, arrays: dict):
        self.arrays = arrays

    def state_dict(self):
        return dict(self.arrays)


def _zbatches(zs: np.ndarray, batch_size: int, device):
    for i in range(0, len(zs), batch_size):
        yield torch.as_tensor(zs[i:i + batch_size], device=device)


def _cache_args(zds, batch_size, extra=None) -> dict:
    args = {"sample_size": len(zds), "batch_size": batch_size}
    args.update(extra or {})
    return args


def _tally(reducer, compute: Callable, zds, batch_size: int,
           cachefile: Optional[str], device, extra_args=None,
           conditional: bool = False):
    """Feed every batch's ``compute`` to `reducer` (a tuple is passed on
    as its arguments; with `conditional`, each (condition, rows) pair of
    the list), or load it from `cachefile`."""
    args = _cache_args(zds, batch_size, extra_args)
    cached = load_cached_state(cachefile, args)
    if cached is not None:
        reducer.set_state_dict(cached, device)
        return reducer
    with torch.no_grad():
        for z in _zbatches(zds.zs, batch_size, device):
            out = compute(z)
            if conditional:
                for cond, rows in out:
                    reducer.add(cond, rows)
            elif isinstance(out, tuple):
                reducer.add(*out)
            else:
                reducer.add(out)
    save_cached_state(cachefile, reducer, args)
    return reducer


def tally_second_moment(rows_fn: Callable[[torch.Tensor], torch.Tensor],
                        zs: np.ndarray, batch_size: int, device, mesh=None,
                        axis: str = "data") -> RunningSecondMoment:
    """Uncentered second moment of ``rows_fn(zbatch)`` (rows, dim) over all
    z, in batches of `batch_size`.

    With `mesh` (called on every rank, each with the same z) each rank of
    `axis` takes its share of every batch, the first ranks one z more
    where the batch does not divide; the ranks' states are then merged by
    an all-reduce of (count x moment, count) in the reducer's float32, so
    every rank holds the moment of all z."""
    r = RunningSecondMoment()
    if mesh is None:
        with torch.no_grad():
            for z in _zbatches(zs, batch_size, device):
                r.add(rows_fn(z))
        return r
    group = mesh.group(axis)
    if min(batch_size, len(zs)) < group.size:     # the same on every rank
        raise ValueError(f"{len(zs)} z in batches of {batch_size} leave "
                         f"some of {group.size} ranks no rows")
    with torch.no_grad():
        for i in range(0, len(zs), batch_size):
            counts = comm.uneven_counts(len(zs[i:i + batch_size]), group.size)
            lo = i + sum(counts[:group.index])
            if counts[group.index]:
                r.add(rows_fn(torch.as_tensor(
                    zs[lo:lo + counts[group.index]], device=device)))
    count = comm.all_reduce(r.state["count"].clone(), group)
    total = comm.all_reduce(r.state["mom"] * r.state["count"], group)
    r.state = {"count": count, "mom": total / count}
    return r


def cached_second_moment(rows_fn, zs: np.ndarray, batch_size: int, device,
                         cachefile: Optional[str], args: dict, mesh=None,
                         axis: str = "data") -> RunningSecondMoment:
    """:func:`tally_second_moment` with the npz cache keyed on `args`.  On
    a mesh every rank decides from the same file (a barrier first, so no
    rank reads while another writes), the ranks tally together, and rank
    0 alone writes the cache, then a second barrier: every rank returns
    the all-reduced state with the whole cache file on disk."""
    if mesh is not None:
        comm.barrier()
    cached = load_cached_state(cachefile, args)
    if cached is not None:
        return RunningSecondMoment.from_state_dict(cached, device)
    r = tally_second_moment(rows_fn, zs, batch_size, device, mesh, axis)
    if mesh is None or dist.get_rank() == 0:
        save_cached_state(cachefile, r, args)
    if mesh is not None:
        comm.barrier()
    return r


def tally_mean(compute, zds, batch_size: int = 10,
               cachefile: Optional[str] = None, device=None) -> RunningMean:
    return _tally(RunningMean(), compute, zds, batch_size, cachefile, device)


def tally_variance(compute, zds, batch_size=10, cachefile=None,
                   device=None):
    return _tally(running.RunningVariance(), compute, zds, batch_size,
                  cachefile, device)


def tally_covariance(compute, zds, batch_size=10, cachefile=None,
                     device=None):
    return _tally(running.RunningCovariance(), compute, zds, batch_size,
                  cachefile, device)


def tally_cross_covariance(compute, zds, batch_size=10, cachefile=None,
                           device=None):
    """compute returns the pair (a rows, b rows)."""
    return _tally(running.RunningCrossCovariance(), compute, zds,
                  batch_size, cachefile, device)


def tally_bincount(compute, zds, batch_size=10, size=1024, cachefile=None,
                   device=None):
    return _tally(running.RunningBincount(size=size), compute, zds,
                  batch_size, cachefile, device, {"size": size})


def tally_topk(compute, zds, k=100, batch_size=10, cachefile=None,
               device=None):
    return _tally(running.RunningTopK(k=k), compute, zds, batch_size,
                  cachefile, device, {"k": k})


def tally_quantile(compute, zds, resolution=6 * 1024, batch_size=10,
                   cachefile=None, device=None):
    return _tally(RunningQuantile(resolution=resolution), compute, zds,
                  batch_size, cachefile, device, {"resolution": resolution})


def tally_all_intersection_and_union(compute, zds, batch_size=10,
                                     cachefile=None, device=None):
    return _tally(running.RunningAllIntersectionAndUnion(), compute, zds,
                  batch_size, cachefile, device)


def gather_topk(compute, zds, topk, k=None, batch_size=10, device=None):
    """Each unit's top-k samples' rows of ``compute(zbatch)`` (one row a
    sample) in a ``GatherTensor``; only batches holding a needed sample
    are computed."""
    idx = topk.result()[1].cpu().numpy()
    k = k or idx.shape[1]
    needed = {}
    for unit in range(idx.shape[0]):
        for rank in range(k):
            needed.setdefault(int(idx[unit, rank]), []).append((unit, rank))
    gt = running.GatherTensor(topk=topk, k=k)
    with torch.no_grad():
        for lo in range(0, len(zds), batch_size):
            hit = [i for i in range(lo, min(lo + batch_size, len(zds)))
                   if i in needed]
            if not hit:
                continue
            out = compute(torch.as_tensor(zds.zs[lo:lo + batch_size],
                                          device=device)).cpu().numpy()
            for i in hit:
                for unit, rank in needed[i]:
                    gt.add(unit, rank, out[i - lo])
    return gt


def tally_topk_and_quantile(compute, zds, k=100, resolution=6 * 1024,
                            batch_size=10, cachefile=None, device=None):
    """One pass into a top-k (of compute's first output, e.g. per-image
    maxima) and a quantile sketch (of its second, e.g. every pixel);
    both cached in one npz under ``topk.`` and ``rq.``."""
    topk = running.RunningTopK(k=k)
    rq = RunningQuantile(resolution=resolution)
    args = _cache_args(zds, batch_size, {"k": k, "resolution": resolution})
    cached = load_cached_state(cachefile, args)
    if cached is not None:
        topk.set_state_dict(_States.part(cached, "topk"), device)
        rq.set_state_dict(_States.part(cached, "rq"), device)
        return topk, rq
    with torch.no_grad():
        for z in _zbatches(zds.zs, batch_size, device):
            maxval, flat = compute(z)
            topk.add(maxval)
            rq.add(flat)
    save_cached_state(cachefile, _States(topk=topk, rq=rq), args)
    return topk, rq


def tally_cat(compute, zds, batch_size=10, cachefile=None, device=None
              ) -> torch.Tensor:
    """compute's outputs over the dataset, concatenated along the rows
    (through the host, as the cache holds them)."""
    args = _cache_args(zds, batch_size)
    cached = load_cached_state(cachefile, args)
    if cached is None:
        with torch.no_grad():
            result = np.concatenate(
                [compute(z).cpu().numpy()
                 for z in _zbatches(zds.zs, batch_size, device)], axis=0)
        save_cached_state(cachefile, _Arrays({"cat": result}), args)
    else:
        result = cached["cat"]
    return torch.as_tensor(result, device=device)


def tally_cat_dict(compute, zds, batch_size=10, cachefile=None, device=None
                   ) -> dict:
    """compute returns {key: rows} a batch; each key's rows concatenated
    over the dataset."""
    args = _cache_args(zds, batch_size)
    result = load_cached_state(cachefile, args)
    if result is None:
        outs = {}
        with torch.no_grad():
            for z in _zbatches(zds.zs, batch_size, device):
                for key, rows in compute(z).items():
                    outs.setdefault(key, []).append(rows.cpu().numpy())
        result = {key: np.concatenate(v, axis=0) for key, v in outs.items()}
        save_cached_state(cachefile, _Arrays(result), args)
    return {key: torch.as_tensor(v, device=device)
            for key, v in result.items()}


def tally_conditional_mean(compute, zds, batch_size=10, cachefile=None,
                           device=None):
    """compute returns [(condition, rows), ...] a batch."""
    return _tally(running.RunningConditionalMean(), compute, zds, batch_size,
                  cachefile, device, conditional=True)


def tally_conditional_topk(compute, zds, k=100, batch_size=10,
                           cachefile=None, device=None):
    return _tally(running.RunningConditionalTopK(k=k), compute, zds,
                  batch_size, cachefile, device, {"k": k}, conditional=True)


def tally_conditional_quantile(compute, zds, resolution=6 * 1024,
                               batch_size=10, cachefile=None, device=None):
    return _tally(running.RunningConditionalQuantile(resolution=resolution),
                  compute, zds, batch_size, cachefile, device,
                  {"resolution": resolution}, conditional=True)


def conditional_samples(acts, segs):
    """Pair activations with segmentation labels: [(0, all rows), (label,
    the rows at positions with that label), ...], labels ascending, 0
    (unlabelled) not among them.

    acts (B, H, W, C); segs (B, M, H', W') integer maps, M labels a
    position, nearest-neighbour aligned onto the activations' grid.  Both
    stay on their device."""
    acts = torch.as_tensor(acts)
    segs = torch.as_tensor(segs, device=acts.device)
    b, h, w, c = acts.shape
    if tuple(segs.shape[-2:]) != (h, w):
        ys = torch.arange(h, device=acts.device) * segs.shape[-2] // h
        xs = torch.arange(w, device=acts.device) * segs.shape[-1] // w
        segs = segs[:, :, ys][:, :, :, xs]
    flat_acts = acts.reshape(-1, c)
    flat_segs = segs.permute(0, 2, 3, 1).reshape(-1, segs.shape[1])
    out = [(0, flat_acts)]
    for label in torch.unique(flat_segs).tolist():
        if label == 0:
            continue
        mask = (flat_segs == label).any(dim=1)
        out.append((int(label), flat_acts[mask]))
    return out


# -- IoU and information statistics of conditional reducers (host numpy) ----

def iou_from_conditional_indicator_mean(condmv) -> np.ndarray:
    """(conditions, units) IoU of each unit's 0/1 indicator with each
    condition, from a conditional mean of the indicators."""
    uncond = condmv.conditional(0)
    act = uncond.mean().cpu().numpy()
    conditions = max(condmv.keys()) + 1
    gt = np.zeros(conditions, np.float32)
    isect = np.zeros((conditions, act.shape[0]), np.float32)
    for k in condmv.keys():
        gt[k] = condmv.conditional(k).count / uncond.count
        isect[k] = condmv.conditional(k).mean().cpu().numpy() * gt[k]
    union = act[None, :] + gt[:, None] - isect
    return isect / np.maximum(union, 1e-20)


def intersection_over_union(arr):
    return arr[0, 0] / np.maximum(1 - arr[1, 1], 1e-20)


def mutual_information(arr):
    """arr is [[p(a&b), p(a&!b)], [p(!a&b), p(!a&!b)]] (+ trailing
    dims)."""
    total = 0.0
    with np.errstate(divide="ignore", invalid="ignore"):
        for j in range(2):
            for k in range(2):
                joint = arr[j, k]
                ind = arr[j].sum(axis=0) * arr[:, k].sum(axis=0)
                total = total + np.nan_to_num(joint * np.log(joint / ind))
    return np.maximum(total, 0)


def joint_entropy(arr):
    total = 0.0
    with np.errstate(divide="ignore", invalid="ignore"):
        for j in range(2):
            for k in range(2):
                joint = arr[j, k]
                total = total + np.nan_to_num(joint * np.log(joint))
    return np.maximum(-total, 0)


def information_quality_ratio(arr):
    with np.errstate(divide="ignore", invalid="ignore"):
        iqr = mutual_information(arr) / joint_entropy(arr)
    return np.nan_to_num(iqr)


def intersection_from_conditional_quantile(
        condq, statistic=lambda x: x[0, 0], cutoff=0.95, min_batches=2):
    """(units, conditions[, cutoffs]) statistic of each unit thresholded
    at its unconditional `cutoff` quantile against each condition, from
    per-condition quantile sketches."""
    cutoff = np.atleast_1d(np.asarray(cutoff, np.float64))
    uncond = condq.conditional(0)
    scores = np.zeros((uncond.units, max(condq.keys()) + 1) + cutoff.shape,
                      np.float32)
    actlevel = uncond.quantiles(cutoff)                 # (units, n_cutoffs)
    for c in sorted(condq.keys()):
        rq = condq.conditional(c)
        if c == 0 or rq.batchcount < min_batches:
            continue
        condp = rq.normalize(actlevel)
        truth = float(rq.count) / uncond.count
        isect = truth * (1 - condp)
        pred = (1 - cutoff)[None, :]
        union = pred + truth - isect
        arr = np.stack([isect, pred - isect, truth - isect,
                        1 - union]).reshape((2, 2) + isect.shape)
        scores[:, c, ...] = statistic(arr)
    return scores if cutoff.shape != (1,) else scores[..., 0]


def iou_from_conditional_quantile(condq, cutoff=0.95, min_batches=2):
    return intersection_from_conditional_quantile(
        condq, statistic=intersection_over_union, cutoff=cutoff,
        min_batches=min_batches)


def mi_from_conditional_quantile(condq, cutoff=0.95, min_batches=2):
    return intersection_from_conditional_quantile(
        condq, statistic=mutual_information, cutoff=cutoff,
        min_batches=min_batches)


def iqr_from_conditional_quantile(condq, cutoff=0.95, min_batches=2):
    return intersection_from_conditional_quantile(
        condq, statistic=information_quality_ratio, cutoff=cutoff,
        min_batches=min_batches)

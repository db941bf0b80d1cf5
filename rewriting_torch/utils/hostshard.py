"""Multi-host work-unit sharding for experiment pipelines.

The port's counterpart of the JAX package's ``utils/hostshard.py``.  The
reference scales across machines at the *job* level: each host loops over
work units and claims them with pidfile locks (reference utils/pidfile.py).
Here every host runs the same program, learns its (index, count) -- from
``torch.distributed`` when a process group is already up, else from the
environment -- takes the strided slice of the work-unit list, and drops
per-unit done-markers so restarts skip completed units on any host (the
markers are plain files, safe on any shared filesystem).

Two layers compose:
- ``shard_units``: deterministic strided assignment (no coordination);
- ``claim_units``: optional lock-based work stealing for heterogeneous
  hosts (wraps pidfile's lock + done protocol per unit).
"""

from __future__ import annotations

import os
from typing import Callable, Iterable, Iterator, List, Optional, Sequence

from . import pidfile

# (index variable, count variable), in the order they are read
ENV_PAIRS = (("REWRITING_TPU_SHARD", "REWRITING_TPU_NUM_SHARDS"),
             ("RANK", "WORLD_SIZE"))


def process_identity(process_index: Optional[int] = None,
                     process_count: Optional[int] = None):
    """(index, count) from explicit args, a ``torch.distributed`` process
    group that is already initialised, or the environment pairs
    REWRITING_TPU_SHARD/REWRITING_TPU_NUM_SHARDS, then RANK/WORLD_SIZE.
    Both halves of a pair must be set.  Nothing is initialised here: a
    job-sharding decision takes no device or network dependency."""
    if process_index is not None and process_count is not None:
        return int(process_index), int(process_count)
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    for i_var, n_var in ENV_PAIRS:
        env_i, env_n = os.environ.get(i_var), os.environ.get(n_var)
        if env_i is not None and env_n is not None:
            return int(env_i), int(env_n)
    return 0, 1


def shard_units(units: Sequence, process_index: Optional[int] = None,
                process_count: Optional[int] = None) -> List:
    """Deterministic strided slice of the work-unit list for this host.
    Strided (not blocked) so early units of every stride finish first and
    partial runs cover the range uniformly."""
    i, n = process_identity(process_index, process_count)
    return list(units[i::n])


def claim_units(units: Iterable, workdir: str,
                unit_name: Callable = str,
                redo: bool = False) -> Iterator:
    """Lock-based work stealing over shared storage: yields ``(unit,
    mark_done)`` for each unit this process claims (skipping done and
    locked ones); the caller calls ``mark_done()`` after completing it.
    Restart-safe: done units are skipped, stale locks from dead local pids
    are taken over (reference pidfile.py:39-63 semantics per unit)."""
    for unit in units:
        d = os.path.join(workdir, unit_name(unit))
        os.makedirs(d, exist_ok=True)
        donefile = os.path.join(d, "done.txt")
        if os.path.isfile(donefile) and not redo:
            continue
        if os.path.isfile(donefile):
            os.remove(donefile)
        lockpath = os.path.join(d, "lockfile.pid")
        if pidfile.pidfile_taken(lockpath, verbose=False):
            continue

        def mark_done(d=d):
            pidfile.mark_job_done(d)
        try:
            yield unit, mark_done
        finally:
            # release on resume: an un-marked unit becomes claimable again
            # (a crash mid-unit leaves the lock; peers take it over by the
            # stale-pid rule)
            try:
                os.remove(lockpath)
            except OSError:
                pass

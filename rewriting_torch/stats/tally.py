"""Drive a compute closure over z batches into the second-moment reducer,
with the arg-keyed npz cache.

Counterpart of the JAX package's ``stats/tally.py``: ``load_cached_state``
and ``save_cached_state`` (:35-60) keep its file format (the state arrays
plus the cache-key arguments as npz entries), so a cache written by either
package loads in the other; ``tally_second_moment`` is the loop that
``tally_second_moment_scan`` (:422-460) compiles into one program there.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from .running import RunningSecondMoment


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
        if a in d:
            raise ValueError(f"cache argument {a!r} collides with a state "
                             "entry")
        d[a] = np.array(v)
    os.makedirs(os.path.dirname(cachefile) or ".", exist_ok=True)
    np.savez(cachefile, **d)


def tally_second_moment(rows_fn: Callable[[torch.Tensor], torch.Tensor],
                        zs: np.ndarray, batch_size: int,
                        device) -> RunningSecondMoment:
    """Uncentered second moment of ``rows_fn(zbatch)`` (rows, dim) over all
    z, in batches of `batch_size` (the last one may be short)."""
    r = RunningSecondMoment()
    with torch.no_grad():
        for i in range(0, len(zs), batch_size):
            zb = torch.as_tensor(zs[i:i + batch_size], device=device)
            r.add(rows_fn(zb))
    return r

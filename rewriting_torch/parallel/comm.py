"""The collectives of the multi-device paths, over ``torch.distributed``.

The JAX package runs one controller over a device mesh and lets its
compiler insert the collectives.  The port runs one process per rank (set
up by ``torchrun`` or by :func:`spawn`), and its parallel modules call the
few collectives they need from here: all-reduce, all-gather, broadcast, the
pipeline's hop to the next stage and the spatial bands' halo exchange.
An all-reduce takes the sum or the maximum (:func:`max_over`, the int8
tier's whole-tensor scales); both backends take either, gloo on CUDA
tensors too.

A :class:`Group` is the ranks of one mesh axis.  On an NCCL group, and on a
gloo group holding CPU tensors, every operation is the backend's own.  A
gloo group takes only all-reduce and broadcast on CUDA tensors (PyTorch's
backend table); it is what several ranks sharing one card use, since NCCL
refuses two ranks on one GPU.  There the all-gather is built from an
all-reduce of a zero-filled buffer in which each rank writes its own part
(adding zeros is exact), and the module counter ``built`` counts each such
operation.  The hop and the halo exchange are all-gathers of the little
they move.  Nothing is staged through the host.

Also here: the shares of a batch (:func:`share`, :func:`uneven_counts`),
the gather of uneven shares back in order (:func:`gather_in_order`), and
:func:`agree`, which makes a failure on some ranks a failure on all.

A collective that fails raises; nothing here retries or falls back.
"""

from __future__ import annotations

import datetime
import os
import socket
import time
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

# collectives built from a zero-filled all-reduce since the counter was last
# set to 0 (gloo on CUDA tensors)
built = 0

# the device init_process_group gave this process's rank
_device: Optional[torch.device] = None

# the reductions all_reduce takes
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def default_device(device=None) -> torch.device:
    """`device`, else the device :func:`init_process_group` gave this rank,
    else ``cuda:{LOCAL_RANK}``; raises for CUDA where there is none."""
    if device is None and _device is not None and dist.is_initialized():
        return _device
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        count = torch.cuda.device_count()
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                           % max(count, 1))
    return dev


def init_process_group(rank: Optional[int] = None,
                       world_size: Optional[int] = None,
                       init_method: Optional[str] = None, device=None,
                       backend: Optional[str] = None) -> torch.device:
    """Join the default process group and return this rank's device.

    Without `rank`, the rank and world size come from ``torchrun``'s
    environment (``env://``), or, where that is absent, the process is a
    job of one rank on a free local port.  The device defaults to
    ``cuda:{LOCAL_RANK}`` (:func:`default_device`); the backend to NCCL on
    CUDA and gloo on the CPU.  ``backend="gloo"`` with a CUDA device is
    how several ranks share one card."""
    global _device
    device = default_device(device)
    if rank is None:
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            rank, world_size = (int(os.environ["RANK"]),
                                int(os.environ["WORLD_SIZE"]))
            init_method = init_method or "env://"
        else:
            rank, world_size = 0, 1
    if init_method is None:
        if world_size != 1:
            raise ValueError("init_process_group needs init_method for a "
                             f"job of {world_size} ranks")
        init_method = f"tcp://localhost:{free_port()}"
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"NCCL needs a CUDA device, got {device}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    _device = device
    return device


def destroy_process_group() -> None:
    global _device
    if dist.is_initialized():
        dist.destroy_process_group()
    _device = None


def _rank_main(rank: int, world: int, init_method: str, device, backend,
               fn, args, results) -> None:
    try:
        if torch.device(device).type == "cpu":   # the host's cores shared
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        init_process_group(rank, world, init_method, device, backend)
        try:
            out = fn(*args)
        finally:
            destroy_process_group()
        results.put((rank, True, out))
    except BaseException as e:      # reported to the parent, which raises
        import traceback
        results.put((rank, False, f"{type(e).__name__}: {e}\n"
                     f"{traceback.format_exc()}"))
        raise


def spawn(fn, ranks: int, device=None, backend: Optional[str] = None,
          args: tuple = (), timeout_s: float = 1800.0) -> list:
    """Run ``fn(*args)`` in a job of `ranks` fresh processes (the spawn
    method), each joined to a process group on a free local port, and
    return their results in rank order.  `fn` and its arguments and result
    must pickle; `device` is every rank's (default ``cuda:{rank}``).
    Raises if any rank fails, naming the first; kills what is left."""
    import multiprocessing
    import queue
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    init_method = f"tcp://localhost:{free_port()}"
    procs = []
    for rank in range(ranks):
        dev = device if device is not None else \
            str(default_device(f"cuda:{rank}"))
        procs.append(ctx.Process(target=_rank_main, args=(
            rank, ranks, init_method, dev, backend, fn, args, results)))
    for p in procs:
        p.start()
    got = {}
    deadline = time.time() + timeout_s
    try:
        while len(got) < ranks:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if p.exitcode is not None and r not in got]
                if dead:
                    raise RuntimeError(f"rank {dead[0][0]} of {ranks} "
                                       f"exited with {dead[0][1]} and no "
                                       "result")
                if time.time() > deadline:
                    raise TimeoutError(f"a job of {ranks} ranks gave "
                                       f"{len(got)} results in {timeout_s} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {ranks} failed: {out}")
            got[rank] = out
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks exited with {bad}")
    return [got[r] for r in range(ranks)]


class Group:
    """The ranks of one mesh axis: their process group (None for the whole
    job), this rank's index among them and the mesh's device."""

    def __init__(self, ranks: Sequence[int], pg, device: torch.device):
        self.ranks = tuple(int(r) for r in ranks)
        self.pg = pg
        self.size = len(self.ranks)
        self.index = self.ranks.index(dist.get_rank())
        self.device = device
        self.backend = str(dist.get_backend(pg))

    def native(self, t: torch.Tensor) -> bool:
        """Whether the backend has every operation for tensors like `t`."""
        return self.backend != "gloo" or t.device.type == "cpu"


def share(n: int, group: Group) -> Tuple[int, int]:
    """[lo, hi) of this rank's even share of `n` items."""
    if n % group.size:
        raise ValueError(f"{n} items do not split evenly over {group.size} "
                         "ranks")
    per = n // group.size
    return group.index * per, (group.index + 1) * per


def uneven_counts(n: int, ranks: int):
    """Items a rank of `ranks` takes of `n`, the first ones one more where
    they do not divide (numpy's ``array_split``)."""
    return [n // ranks + (1 if r < n % ranks else 0) for r in range(ranks)]


def same_device(a, b) -> bool:
    """Whether two devices are one (``cuda`` is the current CUDA device)."""
    a, b = torch.device(a), torch.device(b)

    def index(d):
        return torch.cuda.current_device() if d.type == "cuda" and \
            d.index is None else d.index
    return a.type == b.type and index(a) == index(b)


def all_reduce(t: torch.Tensor, group: Group, op: str = "sum"
               ) -> torch.Tensor:
    """The sum (or, with ``op="max"``, the maximum) over the group's ranks,
    in place; returns `t`."""
    if op not in _OPS:
        raise ValueError(f"all_reduce op {op!r}: one of {tuple(_OPS)}")
    if group.size > 1:
        dist.all_reduce(t, op=_OPS[op], group=group.pg)
    return t


def max_over(*groups: Optional[Group]):
    """``reduce(t)``: the elementwise maximum of `t` over the ranks of all
    the `groups` (None and groups of one rank are skipped), all-reduced in
    place one group after the other; every rank of them calls it at the
    same point.  The sharded samplers hand it to ``ops.quant.
    whole_tensor_scales``."""
    live = tuple(g for g in groups if g is not None and g.size > 1)

    def reduce(t: torch.Tensor) -> torch.Tensor:
        for g in live:
            all_reduce(t, g, op="max")
        return t
    return reduce


def broadcast(t: torch.Tensor, src: int, group: Group) -> torch.Tensor:
    """The group's rank `src` (an index in the group) copied into `t` on
    every rank, in place; returns `t`."""
    if group.size > 1:
        dist.broadcast(t, src=group.ranks[src], group=group.pg)
    return t


def _built_from_all_reduce(parts: torch.Tensor, group: Group
                           ) -> torch.Tensor:
    """All-reduce of `parts` (zeros but where this rank wrote), counted."""
    global built
    built += 1
    return all_reduce(parts, group)


def all_gather(t: torch.Tensor, group: Group, dim: int = 0) -> torch.Tensor:
    """Every rank's `t` (one shape on all) concatenated along `dim`, in the
    group's rank order."""
    if group.size == 1:
        return t
    t = t.contiguous()
    if group.native(t):
        parts = [torch.empty_like(t) for _ in range(group.size)]
        dist.all_gather(parts, t, group=group.pg)
    else:
        buf = t.new_zeros((group.size,) + tuple(t.shape))
        buf[group.index] = t
        parts = list(_built_from_all_reduce(buf, group))
    return torch.cat(parts, dim)


def gather_in_order(local: Sequence[torch.Tensor], counts: Sequence[int],
                    group: Group, like: torch.Tensor) -> torch.Tensor:
    """Every rank's `local` items (rank r holds counts[r], each shaped and
    typed as `like`) stacked in rank order on every rank.  Uneven counts
    are padded to the largest with zeros for the gather and dropped
    after."""
    most = max(counts)
    piece = like.new_zeros((most,) + tuple(like.shape))
    for i, t in enumerate(local):
        piece[i] = t
    whole = all_gather(piece, group)
    return torch.cat([whole[r * most:r * most + c]
                      for r, c in enumerate(counts)])


def agree(error: Optional[BaseException], group: Group) -> None:
    """Raise on every rank of the group if any rank's `error` is not None:
    a rank that failed raises its own error, the others a RuntimeError
    with the failed ranks' messages.  Every rank calls it at the same
    point, after work that may fail on some ranks alone and before the
    collective that would wait for them."""
    if group.size == 1:
        if error is not None:
            raise error
        return
    failed = torch.zeros(group.size, device=group.device)
    failed[group.index] = error is not None
    if int(all_reduce(failed, group).count_nonzero()) == 0:
        return
    messages = [None] * group.size
    dist.all_gather_object(
        messages, None if error is None
        else f"{type(error).__name__}: {error}", group=group.pg)
    if error is not None:
        raise error
    raise RuntimeError("; ".join(f"rank {group.ranks[r]} failed: {m}"
                                 for r, m in enumerate(messages)
                                 if m is not None))


def hop(out: Optional[torch.Tensor], like: torch.Tensor, send: bool,
        recv: bool, group: Group) -> Optional[torch.Tensor]:
    """One hop down the chain of the group's ranks: `out` goes to the next
    rank where `send`, and where `recv` the previous rank's is returned (a
    tensor shaped like `like`).  An all-gather of every rank's `out`
    (zeros where it sends nothing), so every rank calls it at every hop."""
    if group.size == 1:
        return None
    mine = out if send else torch.zeros_like(like)
    whole = all_gather(mine[None], group)
    return whole[group.index - 1] if recv else None


def halo_rows(band: torch.Tensor, group: Group, rows: int = 1
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the `rows` rows just above this rank's band, those just below) of
    an NCHW map cut into bands of rows, one a rank in group order: the
    neighbours' edge rows, zeros at the map's true edges.  An all-gather
    of every rank's (top, bottom) edge rows."""
    if band.shape[2] < rows:
        raise ValueError(f"a band of {band.shape[2]} rows cannot give a "
                         f"halo of {rows}")
    i, n = group.index, group.size
    edges = torch.stack([band[:, :, :rows], band[:, :, -rows:]])
    above, below = torch.zeros_like(edges[0]), torch.zeros_like(edges[1])
    if n == 1:
        return above, below
    whole = all_gather(edges[None], group)
    if i > 0:
        above = whole[i - 1, 1]
    if i < n - 1:
        below = whole[i + 1, 0]
    return above, below


def barrier() -> None:
    """Wait for every rank of the job."""
    if dist.is_initialized():
        dist.barrier()


def control_group():
    """A gloo group of the whole job for small host messages (the server's
    requests to its worker ranks), with a timeout of a year: a server may
    wait days between requests.  Every rank must call it, at the same
    point."""
    return dist.new_group(backend="gloo",
                          timeout=datetime.timedelta(days=365))


def broadcast_object(obj, pg):
    """Rank 0's picklable `obj` on every rank of the process group `pg` (a
    :func:`control_group`)."""
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=pg)
    return box[0]

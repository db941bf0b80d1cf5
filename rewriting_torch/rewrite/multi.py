"""Many edit requests solved at once, and their previews.

Counterpart of the JAX package's ``rewrite/multi.py``: ``build_goals``
(:24), ``batch_apply_edits`` (:46) and ``preview_edits`` (:113).  The
goals are built with ``tight_paste`` off, so every edit has the window's
whole feature map and the goals stack.  Where the JAX package vmaps the
single solve over the edit axis, the port solves all edits in one loop
(``solve.fast_linear_insert_solve_batched``, or
``solve.linear_insert_solve_batched`` where the window has no fast
decomposition, as for SeqPre): the goals are folded into the batch
edit-major (E·B rows), and each edit's conv is one group of one grouped
convolution (``ops/grouped.py``), so a step runs the window once for all
edits.  With ``mesh=`` the edits are split over the ranks of the mesh's
``data`` axis (``parallel/mesh.py``), each rank solving its own share in
that one loop, and every rank gets every edit's weight and loss back in
request order.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..core import DataBag
from ..ops import precision
from ..parallel import comm
from . import solve


def build_goals(gw, requests: Sequence[dict], rank: int = 1):
    """Per request (goal_in bag, goal_out, direction), with the window's
    whole map (tight_paste off); goal_out is the window's NCHW output map,
    so ``DataBag(goal_in, fmap=goal_out)`` is the goal bag a single solve
    takes (the JAX package returns its NHWC map)."""
    old_tp = gw.tight_paste
    gw.tight_paste = False
    try:
        goals = []
        for request in requests:
            o_imgnum, o_mask = request["object"]
            p_imgnum, p_mask = request["paste"]
            keys = request.get("key", [(p_imgnum, p_mask)])
            obj_acts, _, obj_area, _ = gw.object_from_selection(o_imgnum,
                                                                o_mask)
            goal_in, goal_out, _, _ = gw.paste_from_selection(
                p_imgnum, p_mask, obj_acts, obj_area)
            direction = gw.multi_key_from_selection(keys, rank=rank)
            goals.append((goal_in, goal_out["fmap"], direction))
    finally:
        gw.tight_paste = old_tp
    return goals


def fold_bags(bags: Sequence[DataBag]) -> DataBag:
    """One bag of the E bags' rows, edit-major: each key's tensors are
    concatenated along the batch, so a key equal in every bag (the noise
    inputs) is repeated and one that differs is stacked."""
    return DataBag({key: (torch.cat([bag[key] for bag in bags])
                          if value.dim() else value)
                    for key, value in bags[0].items()})


@precision.run_deterministic
def batch_apply_edits(gw, requests: Sequence[dict], rank: int = 1,
                      niter: int = 2001, lr: float = 0.05,
                      return_timing: bool = False, mesh=None,
                      axis: str = "data"):
    """Solve every request at once: (one edited target weight per request,
    the (E,) final losses), and with ``return_timing`` the solve's
    milliseconds.  ``gw.params`` is left as it is: the caller commits an
    edit with ``gw.set_target_weight`` or keeps all of them.  The goals
    and the solve run with cuDNN's deterministic algorithms: the batch
    repeats bit for bit.

    With `mesh` (called on every rank, each with the same rewriter and
    requests) the E edits are split over the ranks of `axis`, in request
    order: uneven splits work, the first ranks taking one edit more (a
    rank past the last edit takes none and only joins the gather).  The
    weights and losses come back on every rank; the timing is this
    rank's own solve (0 with no edit).  A request that fails on any rank
    (a bad mask, a missing key) raises on every rank (``comm.agree``), so
    no rank is left waiting in the gather."""
    if mesh is None:
        return _solve(gw, requests, rank, niter, lr, return_timing)
    group = mesh.group(axis)
    if gw.key_method == "gandissect":
        # the key's quantiles are rank 0's cache, read by every rank at
        # this one point: a rank's share of the goals may hold no request
        gw.quantiles_for_units()
    error = None
    try:
        if not requests:
            raise ValueError("no edit requests")
        counts = comm.uneven_counts(len(requests), group.size)
        lo = sum(counts[:group.index])
        mine = list(requests[lo:lo + counts[group.index]])
        out = (_solve(gw, mine, rank, niter, lr, return_timing) if mine
               else ([], np.zeros(0, np.float32), 0.0))
    except Exception as e:      # noqa: BLE001 - raised on every rank below
        error = e
    comm.agree(error, group)
    w0 = gw.target_weight()
    weights = comm.gather_in_order(out[0], counts, group, like=w0)
    losses = comm.gather_in_order(
        list(torch.as_tensor(np.asarray(out[1]), device=w0.device)),
        counts, group, like=w0.new_zeros(()))
    return ((list(weights), losses.cpu().numpy())
            + ((out[2],) if return_timing else ()))


def _solve(gw, requests: Sequence[dict], rank: int, niter: int, lr: float,
           return_timing: bool):
    goals = build_goals(gw, requests, rank=rank)
    bag = fold_bags([g[0] for g in goals])
    goal_out = torch.cat([g[1] for g in goals])
    directions = torch.stack([g[2] for g in goals])
    # each edit's unedited window output, as its single solve has it at
    # Λ = 0 (the solves' out0)
    out0 = torch.cat([gw._target(gw.params, g[0])["fmap"] for g in goals])
    parts = gw.fast_parts_cached()
    if parts is not None:
        conv_fn, tail_fn, scale, use_demod = parts
        out = solve.fast_linear_insert_solve_batched(
            conv_fn, tail_fn, bag, gw.params, goal_out, gw.target_weight(),
            directions, scale, niter=niter, lr=lr, use_demod=use_demod,
            out0=out0, return_timing=return_timing)
    else:
        # no fast decomposition (SeqPre's window starts at adain): the
        # direct solve, the weight stack in the window's own conv
        out = solve.linear_insert_solve_batched(
            gw._window_fn, gw.target_weight(), (bag, gw.params), goal_out,
            directions, niter=niter, lr=lr, out0=out0,
            return_timing=return_timing)
    weights: List[torch.Tensor] = list(out[0])
    return (weights, out[1][-1]) + tuple(out[2:])


def preview_edits(gw, edited_weights: Sequence, z,
                  batched: bool = True) -> np.ndarray:
    """The same latents rendered under each edited weight: (E, B, H, W, 3)
    NHWC.  Batched, the context runs once and the target and rendering
    stages once over the E·B rows, the weights stacked as one grouped
    conv; else one render per edit."""
    stage = gw.weight_stage()
    z = torch.as_tensor(np.asarray(z), dtype=torch.float32, device=gw.device)

    def render(weight, bag):
        p = dict(gw.params)
        p[stage] = {**gw.params[stage], "weight": weight}
        return gw.rendered_image(gw._render(p, gw._target(p, bag)))

    with precision.schedule_suspended():
        context = gw._context(gw.params, gw.model.make_bag(z))
        if not batched:
            return np.stack([render(w, context).cpu().numpy()
                             for w in edited_weights])
        edits = len(edited_weights)
        stack = torch.stack([w.reshape(w.shape[-4:]) for w in edited_weights])
        images = render(stack, fold_bags([context] * edits))
    return images.reshape((edits, z.shape[0]) + tuple(images.shape[1:])) \
        .cpu().numpy()

"""The rank-constrained weight solve of the linear associative memory.

Counterpart of the JAX package's ``rewrite/solve.py``: ``projected_conv``
and ``rank_one_conv`` (:39-56), the float64 ``zca_from_cov`` and
``solve_spd`` (:58-80), ``insert_solve`` (:90-196), and the two solves of
the update ``w = w0 + Λ·D``: ``linear_insert_solve`` (:287-342) and its
low-rank decomposition ``fast_linear_insert_solve`` (:199-285).  The JAX
package compiles each solve into one ``lax.scan``; here each is an eager
loop with ``torch.optim.Adam``, the update rule that optax's Adam mirrors.

Every solve runs with cuDNN's deterministic algorithms
(``precision.deterministic``), its precomputed terms too, so it repeats
bit for bit on the card.  Every solve returns ``(weight, per-step
losses)``, or with
``return_timing`` ``(weight, losses, elapsed ms)``, the time from a
synchronised start to a synchronised end of the loop; ``update_callback``
is called with ``(step, loss)`` for every step once the loop has ended,
so the loop never waits on the device for it.

The batched forms of the two Λ·D solves (``linear_insert_solve_batched``,
``fast_linear_insert_solve_batched``) solve E edits of one weight in one
loop, where the JAX package vmaps the single solve: Λ has a leading edit
axis, the E goals are folded into the batch edit-major (E·B rows,
``ops/grouped.py``), each edit's conv is one group of a grouped
convolution, and the step descends the sum of the E mean-abs losses, so
each edit follows its own solve's Adam trajectory.  They return the E
weights stacked and the per-step losses as (niter, E).

Both take ``out0``, each edit's window output at Λ = 0 as its single
solve computes it (batch B, folded as the goals are).  A convolution over
E·B rows may round otherwise than over B, and where the goal equals the
unedited output a single solve's residual is exactly 0, so L1's
subgradient there is 0; rounding noise would give it a sign, which Adam
turns into whole steps.  So each step's output is shifted by ``out0``
minus the batch's own output at Λ = 0, a constant of the size of
rounding, which makes the two agree bit for bit at Λ = 0.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from ..core import DataBag
from ..ops import precision
from ..ops.grouped import folded, side_by_side


def projected_conv(weight: torch.Tensor, direction: torch.Tensor
                   ) -> torch.Tensor:
    """Project a conv weight onto span(direction) along its input-channel
    axis.  Weight is (O, I, kh, kw) or (G, O, I, kh, kw); direction is
    (rank, I) with orthonormal rows."""
    if weight.dim() == 5:
        cosine = torch.einsum("goiyx,di->godyx", weight, direction)
        return torch.einsum("godyx,di->goiyx", cosine, direction)
    cosine = torch.einsum("oiyx,di->odyx", weight, direction)
    return torch.einsum("odyx,di->oiyx", cosine, direction)


def rank_one_conv(weight: torch.Tensor, direction: torch.Tensor
                  ) -> torch.Tensor:
    """Component of an (O, I, kh, kw) weight along one (I,) direction."""
    cosine = torch.sum(weight * direction[None, :, None, None], dim=1,
                       keepdim=True)
    return cosine * direction[None, :, None, None]


def zca_from_cov(cov: torch.Tensor) -> torch.Tensor:
    """C^{-1/2} by a float64 eigendecomposition on the host; the square
    roots of the eigenvalues are clamped at 1e-20 before the reciprocal."""
    c = cov.detach().cpu().numpy().astype(np.float64)
    evals, evecs = np.linalg.eigh(c)
    inv_sqrt = 1.0 / np.maximum(np.sqrt(np.maximum(evals, 0.0)), 1e-20)
    zca = (evecs * inv_sqrt[None, :]) @ evecs.T
    return torch.as_tensor(zca, dtype=cov.dtype, device=cov.device)


def solve_spd(c_matrix: torch.Tensor, k) -> np.ndarray:
    """x = C^{-1} k for SPD C, in float64 on the host; k is (C,) or (N, C)
    rows, and x comes back as float32 in the same shape."""
    c = c_matrix.detach().cpu().numpy().astype(np.float64)
    kk = np.asarray(k, np.float64)
    single = kk.ndim == 1
    x = np.linalg.solve(c, kk[:, None] if single else kk.T)
    return (x[:, 0] if single else x.T).astype(np.float32)


class _Timer:
    """Wall time of a solve between two device synchronisations."""

    def __init__(self, device: torch.device, on: bool):
        self.device, self.on = device, on
        self.ms = None
        if on:
            self._sync()
            self.t0 = time.perf_counter()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def stop(self):
        if self.on:
            self._sync()
            self.ms = (time.perf_counter() - self.t0) * 1000.0


def _finish(w: torch.Tensor, losses, timer: _Timer,
            update_callback: Optional[Callable]):
    """(w, losses as numpy[, elapsed ms]) after the callbacks."""
    timer.stop()
    losses = (torch.stack(losses).cpu().numpy() if losses
              else np.zeros((0,), np.float32))
    if update_callback is not None:
        for it, loss in enumerate(losses):
            update_callback(it, loss)
    if timer.on:
        return w, losses, timer.ms
    return w, losses


def _adam_loop(param: torch.Tensor, loss_fn: Callable, niter: int,
               lr: float, after_backward=None, after_step=None):
    """`niter` Adam steps on `param` (which requires grad) of
    ``loss_fn()``; ``after_backward()`` may rewrite the gradient and
    ``after_step(it)`` the parameter.  A batch of solves returns one loss
    per edit, and the step descends their sum: each edit's Λ gets its own
    loss's gradient, as in its own solve.  Returns the per-step losses
    (device scalars, or (E,) vectors).  The loop runs at the parity tier;
    its callers, the solves, run it with cuDNN's deterministic algorithms
    (``precision.run_deterministic``), so a solve repeats bit for bit on
    the card."""
    opt = torch.optim.Adam([param], lr=lr)
    losses = []
    with precision.schedule_suspended():
        for it in range(niter):
            opt.zero_grad(set_to_none=True)
            loss = loss_fn()
            (loss if loss.dim() == 0 else loss.sum()).backward()
            if after_backward is not None:
                after_backward()
            opt.step()
            losses.append(loss.detach())
            if after_step is not None:
                after_step(it)
    return losses


@precision.run_deterministic
def insert_solve(window_fn: Callable, weight0: torch.Tensor, goal_in,
                 goal_out: torch.Tensor, direction, niter: int = 2001,
                 piter: int = 10, lr: float = 0.05,
                 low_rank_insert: bool = True,
                 low_rank_gradient: bool = False,
                 update_callback: Optional[Callable] = None,
                 return_timing: bool = False):
    """Minimize ``mean|goal_out - window_fn(w, goal_in)|`` by Adam from
    ``weight0``.  With ``low_rank_insert`` the change stays in
    span(direction): after step 0, every `piter` steps and the last step,
    w is reset to ``ortho + projected_conv(w, direction)`` with ``ortho =
    weight0 - projected_conv(weight0, direction)``; without it the steps
    are plain Adam (JAX package :113-116).  With ``low_rank_gradient`` the
    gradient is projected onto span(direction) before each Adam step."""
    direction = torch.as_tensor(direction, dtype=weight0.dtype,
                                device=weight0.device)
    timer = _Timer(weight0.device, return_timing)
    weight0 = weight0.detach()
    ortho = weight0 - projected_conv(weight0, direction)
    w = weight0.clone().requires_grad_(True)

    def project_grad():
        w.grad.copy_(projected_conv(w.grad, direction))

    def project(it):
        if low_rank_insert and (it % piter == 0 or it == niter - 1):
            with torch.no_grad():
                w.copy_(ortho + projected_conv(w, direction))

    losses = _adam_loop(
        w, lambda: torch.mean(torch.abs(goal_out - window_fn(w, goal_in))),
        niter, lr, project_grad if low_rank_gradient else None, project)
    return _finish(w.detach(), losses, timer, update_callback)


def _lift(lam: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """Λ (..., O, rank, kh, kw) -> the weight change Λ·D (..., O, I, kh,
    kw)."""
    return torch.einsum("...odyx,di->...oiyx", lam, direction)


@precision.run_deterministic
def linear_insert_solve(window_fn: Callable, weight0: torch.Tensor,
                        goal_in, goal_out: torch.Tensor, direction,
                        niter: int = 2001, lr: float = 0.05,
                        update_callback: Optional[Callable] = None,
                        return_timing: bool = False):
    """The reference's other parameterization (ganrewrite.py:201-252):
    Adam on Λ, zero at the start, with ``w = weight0 + Λ·D``, so the
    change lies in span(direction) by construction."""
    direction = torch.as_tensor(direction, dtype=weight0.dtype,
                                device=weight0.device)
    timer = _Timer(weight0.device, return_timing)
    weight0 = weight0.detach()
    shape = list(weight0.shape)
    shape[-3] = direction.shape[0]
    lam = torch.zeros(shape, dtype=weight0.dtype, device=weight0.device,
                      requires_grad=True)
    losses = _adam_loop(
        lam, lambda: torch.mean(torch.abs(
            goal_out - window_fn(weight0 + _lift(lam, direction), goal_in))),
        niter, lr)
    with torch.no_grad():
        w = weight0 + _lift(lam, direction)
    return _finish(w, losses, timer, update_callback)


@precision.run_deterministic
def fast_linear_insert_solve(conv_fn: Callable, tail_fn: Callable,
                             goal_in_bag, params, goal_out: torch.Tensor,
                             w0: torch.Tensor, direction, scale: float,
                             niter: int = 2001, lr: float = 0.05,
                             use_demod: bool = False,
                             update_callback: Optional[Callable] = None,
                             return_timing: bool = False):
    """``linear_insert_solve`` with the window's conv split by linearity:
    with ``w = w0 + Λ·D``, ``conv(x, w) = conv(x, w0) + conv(D·x, Λ)``.
    The first term is computed once; each step runs the rank-r conv, the
    demodulation from ``style²`` (with ``use_demod``) and ``tail_fn``.
    The same Λ and the same Adam trajectory as the direct solve, up to
    the order of the sums.

    ``conv_fn(x, kernel_oihw)`` is the window's bare linear conv of an
    NCHW map (with its upsampling), without the weight scale or the
    demodulation, which are applied here; ``tail_fn(params, bag)`` runs
    the window's stages after the conv."""
    direction = torch.as_tensor(direction, dtype=w0.dtype, device=w0.device)
    timer = _Timer(w0.device, return_timing)
    w0 = w0.detach()
    w0_4d = w0[0] if w0.dim() == 5 else w0
    x = goal_in_bag["fmap"]
    with torch.no_grad():
        x_d = torch.einsum("di,bihw->bdhw", direction, x)
        base = conv_fn(x, w0_4d * scale)        # constant across the steps
        style2 = (torch.square(goal_in_bag["style"]) if use_demod
                  else None)                    # (B, I)

    def window(lam):
        out = base + conv_fn(x_d, lam * scale)
        if use_demod:
            w = w0_4d + _lift(lam, direction)
            w_sq = torch.sum(torch.square(w * scale), dim=(-2, -1))  # (O, I)
            out = out * torch.rsqrt(style2 @ w_sq.t() + 1e-8)[:, :, None,
                                                                None]
        return tail_fn(params, DataBag(goal_in_bag, fmap=out))["fmap"]

    o, _, kh, kw = w0_4d.shape
    lam = torch.zeros((o, direction.shape[0], kh, kw), dtype=w0.dtype,
                      device=w0.device, requires_grad=True)
    losses = _adam_loop(
        lam, lambda: torch.mean(torch.abs(goal_out - window(lam))), niter, lr)
    with torch.no_grad():
        w = w0_4d + _lift(lam, direction)
    return _finish(w[None] if w0.dim() == 5 else w, losses, timer,
                   update_callback)


def _lift_batched(lam: torch.Tensor, directions: torch.Tensor
                  ) -> torch.Tensor:
    """Λ (E, O, rank, kh, kw) and D (E, rank, I) -> the E weight changes
    (E, O, I, kh, kw)."""
    return torch.einsum("eodyx,edi->eoiyx", lam, directions)


def _per_edit_l1(goal_out: torch.Tensor, out: torch.Tensor, edits: int
                 ) -> torch.Tensor:
    """(E,) mean |goal_out - out| over each edit's rows of two maps folded
    edit-major."""
    return torch.abs(goal_out - out).reshape(edits, -1).mean(1)


def _stacked(w: torch.Tensor, weight0: torch.Tensor) -> torch.Tensor:
    """(E, O, I, kh, kw) -> E weights in weight0's shape, stacked."""
    return w[:, None] if weight0.dim() == 5 else w


def _anchored(window: Callable, lam: torch.Tensor, out0: torch.Tensor):
    """``window`` shifted so that it gives ``out0`` at Λ = 0 (the module
    docstring)."""
    with torch.no_grad():
        shift = out0 - window(torch.zeros_like(lam))
    return lambda lam_: window(lam_) + shift


@precision.run_deterministic
def linear_insert_solve_batched(window_fn: Callable, weight0: torch.Tensor,
                                goal_in, goal_out: torch.Tensor, directions,
                                out0: torch.Tensor, niter: int = 2001,
                                lr: float = 0.05,
                                return_timing: bool = False):
    """E ``linear_insert_solve``s of one weight in one loop: Adam on Λ (E,
    O, rank, kh, kw), zero at the start, with edit e's weight ``weight0 +
    Λ_e·D_e``.  ``window_fn(ws, goal_in)`` runs the window with the (E, O,
    I, kh, kw) stack of weights over `goal_in` folded edit-major (E·B
    rows); `goal_out` is folded the same way, `directions` is (E, rank,
    I)."""
    directions = torch.as_tensor(directions, dtype=weight0.dtype,
                                 device=weight0.device)
    edits, rank = directions.shape[:2]
    timer = _Timer(weight0.device, return_timing)
    w4 = weight0.detach()
    w4 = w4[0] if w4.dim() == 5 else w4
    o, _, kh, kw = w4.shape
    lam = torch.zeros((edits, o, rank, kh, kw), dtype=w4.dtype,
                      device=w4.device, requires_grad=True)
    window = _anchored(lambda lam_: window_fn(
        w4 + _lift_batched(lam_, directions), goal_in), lam, out0)
    losses = _adam_loop(
        lam, lambda: _per_edit_l1(goal_out, window(lam), edits), niter, lr)
    with torch.no_grad():
        w = w4 + _lift_batched(lam, directions)
    return _finish(_stacked(w, weight0), losses, timer, None)


@precision.run_deterministic
def fast_linear_insert_solve_batched(conv_fn: Callable, tail_fn: Callable,
                                     goal_in_bag, params,
                                     goal_out: torch.Tensor,
                                     w0: torch.Tensor, directions,
                                     scale: float, out0: torch.Tensor,
                                     niter: int = 2001, lr: float = 0.05,
                                     use_demod: bool = False,
                                     return_timing: bool = False):
    """E ``fast_linear_insert_solve``s of one weight in one loop.  The E
    goals are folded edit-major in ``goal_in_bag`` and `goal_out` (E·B
    rows), `directions` is (E, rank, I).  Each step runs the E rank-r
    convs as one grouped conv (``conv_fn(x, kernel, groups)``, x (B, E·r,
    H, W) and the kernel (E·O, r, kh, kw)), each edit's demodulation from
    its own ``style²`` and weight, and ``tail_fn`` once over all E·B
    rows."""
    directions = torch.as_tensor(directions, dtype=w0.dtype,
                                 device=w0.device)
    edits, rank, in_c = directions.shape
    timer = _Timer(w0.device, return_timing)
    w0 = w0.detach()
    w0_4d = w0[0] if w0.dim() == 5 else w0
    o, _, kh, kw = w0_4d.shape
    x = goal_in_bag["fmap"]
    b, h, w = x.shape[0] // edits, x.shape[2], x.shape[3]
    with torch.no_grad():
        x_d = torch.einsum("edi,ebihw->ebdhw", directions,
                           x.reshape(edits, b, in_c, h, w))
        x_d = side_by_side(x_d.reshape(edits * b, rank, h, w), edits)
        base = conv_fn(x, w0_4d * scale)        # constant across the steps
        style2 = (torch.square(goal_in_bag["style"]).reshape(edits, b, in_c)
                  if use_demod else None)       # (E, B, I)

    def window(lam):
        out = base + folded(conv_fn(x_d, (lam * scale).reshape(
            edits * o, rank, kh, kw), edits), edits)
        if use_demod:
            ws = w0_4d + _lift_batched(lam, directions)
            w_sq = torch.sum(torch.square(ws * scale), dim=(-2, -1))
            demod = torch.rsqrt(torch.bmm(style2, w_sq.transpose(1, 2))
                                + 1e-8)         # (E, B, O)
            out = out * demod.reshape(edits * b, o)[:, :, None, None]
        return tail_fn(params, DataBag(goal_in_bag, fmap=out))["fmap"]

    lam = torch.zeros((edits, o, rank, kh, kw), dtype=w0.dtype,
                      device=w0.device, requires_grad=True)
    window = _anchored(window, lam, out0)
    losses = _adam_loop(
        lam, lambda: _per_edit_l1(goal_out, window(lam), edits), niter, lr)
    with torch.no_grad():
        ws = w0_4d + _lift_batched(lam, directions)
    return _finish(_stacked(ws, w0), losses, timer, None)

"""The rank-constrained weight solve of the linear associative memory.

Counterpart of the JAX package's ``rewrite/solve.py``: ``projected_conv``
and ``rank_one_conv`` (:39-56), the float64 ``zca_from_cov`` and
``solve_spd`` (:58-80) and ``insert_solve`` (:90-196).  The JAX package
compiles the solve into one ``lax.scan``; here it is an eager loop with
``torch.optim.Adam``, the update rule that optax's Adam mirrors.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from ..ops import precision


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


def insert_solve(window_fn: Callable, weight0: torch.Tensor, goal_in,
                 goal_out: torch.Tensor, direction, niter: int = 2001,
                 piter: int = 10, lr: float = 0.05,
                 low_rank_insert: bool = True
                 ) -> Tuple[torch.Tensor, np.ndarray]:
    """Minimize ``mean|goal_out - window_fn(w, goal_in)|`` by Adam from
    ``weight0``.  With ``low_rank_insert`` the change stays in
    span(direction): after step 0, every `piter` steps and the last step,
    w is reset to ``ortho + projected_conv(w, direction)`` with ``ortho =
    weight0 - projected_conv(weight0, direction)``; without it the steps
    are plain Adam (JAX package :113-116).  Returns (weight, per-step
    losses)."""
    direction = torch.as_tensor(direction, dtype=weight0.dtype,
                                device=weight0.device)
    weight0 = weight0.detach()
    ortho = weight0 - projected_conv(weight0, direction)
    w = weight0.clone().requires_grad_(True)
    opt = torch.optim.Adam([w], lr=lr)
    losses = []
    with precision.schedule_suspended():
        for it in range(niter):
            opt.zero_grad(set_to_none=True)
            loss = torch.mean(torch.abs(goal_out - window_fn(w, goal_in)))
            loss.backward()
            opt.step()
            losses.append(loss.detach())
            if low_rank_insert and (it % piter == 0 or it == niter - 1):
                with torch.no_grad():
                    w.copy_(ortho + projected_conv(w, direction))
    losses = (torch.stack(losses).cpu().numpy() if losses
              else np.zeros((0,), np.float32))
    return w.detach(), losses

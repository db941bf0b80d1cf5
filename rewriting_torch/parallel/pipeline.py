"""Pipeline parallelism: a GPipe executor over the ranks of a mesh axis.

Counterpart of the JAX package's ``parallel/pipeline.py`` (:35-137).  Rank
s of the ``stage`` axis holds stage s's weights; the batch is cut into M
microbatches that flow s -> s+1 one hop a tick (``comm.hop``), and the
schedule is M + S - 1 ticks (the GPipe fill/drain bubble is (S-1)/M of
it).  Tick t, rank s works iff s <= t < s + M; rank 0 feeds microbatch t,
the last rank banks its output t - (S - 1), and at the end the last
rank's outputs are broadcast to every rank.

As in the JAX package the target is an equal-shape stack, the style MLP
of StyleGAN2 (:func:`pipelined_style_mapper`); the conv trunk's maps grow
4x a resolution, so its scale axes are batch, rows (``mesh.py``) and
channels (``tensor.py``).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ..core import tree_map
from ..models.stylegan2 import _equal_linear
from . import comm
from .mesh import Mesh


def _gpipe_local(stage_fn: Callable, local, x: torch.Tensor,
                 group: comm.Group, n_micro: Optional[int]) -> torch.Tensor:
    """GPipe over `group` with this rank's stage params `local`."""
    s, n = group.index, group.size
    m = n_micro or n
    b = x.shape[0]
    if b % m:
        raise ValueError(f"a batch of {b} does not cut into {m} "
                         "microbatches")
    micro = x.reshape((m, b // m) + tuple(x.shape[1:]))
    banked = torch.zeros_like(micro)
    buf = None
    for t in range(m + n - 1):
        active = s <= t < s + m
        out = None
        if active:
            out = stage_fn(local, micro[t] if s == 0 else buf)
            if s == n - 1:
                banked[t - (n - 1)] = out
        buf = comm.hop(out, micro[0], active and s < n - 1,
                       s > 0 and s - 1 <= t < s - 1 + m, group)
    comm.broadcast(banked, n - 1, group)
    return banked.reshape(x.shape)


def gpipe(stage_fn: Callable, stacked_params, x: torch.Tensor, mesh: Mesh,
          axis: str = "stage", n_micro: Optional[int] = None
          ) -> torch.Tensor:
    """Run `x` (B, ...) through S = mesh.shape[axis] stages, stage s on rank
    s of `axis`: ``stage_fn(params_s, microbatch)`` (same shape out as
    in), where `stacked_params` is a tree whose leaves have a leading stage
    axis of S; each rank moves only its own stage's slice to its device.
    B must cut into `n_micro` microbatches (default S).  Returns (B, ...)
    on every rank."""
    group = mesh.group(axis)
    local = tree_map(lambda t: torch.as_tensor(t)[group.index]
                     .to(mesh.device), stacked_params)
    return _gpipe_local(stage_fn, local, torch.as_tensor(x).to(mesh.device),
                        group, n_micro)


def pipelined_style_mapper(model, mesh: Mesh, axis: str = "stage",
                           n_micro: Optional[int] = None):
    """(params, z) -> w: the style MLP of a SeqStyleGAN2 as a GPipe
    pipeline.  Rank s holds the n_mlp / S consecutive EqualLinear layers of
    stage s; the latent pixel norm runs replicated first.  The same
    ``_equal_linear`` math in the same order as the seq ``style.*``
    stages: on the CPU bit for bit the seq stages run on the same
    microbatches (a product's rounding may depend on its batch size)."""
    group = mesh.group(axis)
    s_count = group.size
    if model.n_mlp % s_count:
        raise ValueError(f"n_mlp {model.n_mlp} does not split into "
                         f"{s_count} stages")
    per = model.n_mlp // s_count
    scale = (1.0 / math.sqrt(model.style_dim)) * model.lr_mlp
    lr_mul = model.lr_mlp

    def stage_fn(local, x):
        for layer in local:
            x = _equal_linear(layer, x, scale, lr_mul, "fused_lrelu")
        return x

    def run(params, z):
        first = group.index * per
        local = [{k: params[f"style.{i + 1}"][k].to(mesh.device)
                  for k in ("weight", "bias")}
                 for i in range(first, first + per)]
        z = torch.as_tensor(z).to(mesh.device)
        x = z * torch.rsqrt(torch.mean(z * z, dim=1, keepdim=True) + 1e-8)
        with torch.no_grad():
            return _gpipe_local(stage_fn, local, x, group, n_micro)
    return run

"""Meshes of ranks, and data- and spatially-parallel sampling, statistics
and edits.

Counterpart of the JAX package's ``parallel/mesh.py`` (:28-121).  The JAX
package drives a device mesh from one process and its compiler inserts the
collectives; the port is SPMD: one process per rank, every entry point
called on every rank, each rank computing its own share and meeting the
others in the explicit collectives of ``comm.py``.  The public results
equal the single-device ones.

- :class:`Mesh` lays the job's ranks out on named axes, row-major (the
  last axis varies fastest), with one process group for each line of
  ranks along an axis.  :func:`make_mesh` and :func:`make_mesh_2d` build
  one over the whole job, joining it first if the process has not
  (``torchrun``'s environment, else a job of one rank).  Meshes run on
  ``cuda`` unless given ``device="cpu"``.
- A rank's share of a batch is a slice of the GLOBAL batch: every rank is
  handed the same global inputs and takes its rows (:func:`shard_batch`).
  Its noise is the reference noise of its images' global positions
  (``RandomState(0).randn(batch, h*w)`` is prefix-stable in the global
  batch); its own local prefix would be rank 0's rows on every rank.
- :func:`sharded_sampler`: each rank renders its share through the model's
  own ``__call__`` (``pipeline_fast``, K1 where its gate passes) and gets
  its images back.
- :func:`sharded_second_moment`: each rank's xᵀx of its share, all-reduced
  with the row count.
- :func:`vmapped_multi_edit`: the edits split over the ranks, each solved
  by the caller's function, gathered back in order.
- :func:`spatial_sharded_sampler`: batch over ``data`` and image rows over
  ``spatial``.  Each rank of the spatial axis holds a band of rows of the
  maps that are tall enough (at least one row a rank: the halo every
  stage needs); the lower resolutions run replicated, and the first
  banded stage takes its rows from the whole map.  Before each 3x3 conv,
  up-conv and RGB-skip upsample the band gets one row from each
  neighbour (``comm.halo_rows``), zeros at the image's true edges; the
  blur after an up-conv runs on the band padded in width only, so K2
  launches with a pad of 0.  It runs the seq stages, which
  ``pipeline_fast`` equals with K1 off; with K1's gate on it raises,
  naming the gate.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..core import DataBag, Stage, StagePipeline, tree_map
from ..models.stylegan2 import (_demod, _reference_noise, modconv_linear,
                                noise_key, stage_resolution)
from ..ops import make_kernel
from ..ops.precision import int8_active, tiered
from ..ops.upconv_blur import fused_upconv_active
from ..ops.upfirdn2d import apply_blur, blur_taps
from . import comm
from .comm import gather_in_order, same_device, share, uneven_counts


class Mesh:
    """The job's ranks on named axes, row-major: ``shape[axis]`` ranks
    along each, ``coords[axis]`` this rank's place, :meth:`group` the
    ranks that share every other coordinate with it."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device=None):
        shape = tuple(int(s) for s in shape)
        if len(shape) != len(axis_names) or len(set(axis_names)) != \
                len(axis_names):
            raise ValueError(f"mesh shape {shape} and axes {axis_names}")
        self.device = comm.default_device(device)
        if not dist.is_initialized():
            comm.init_process_group(device=self.device)
        world = dist.get_world_size()
        if math.prod(shape) != world:
            raise ValueError(f"a mesh of {shape} needs {math.prod(shape)} "
                             f"ranks; the job has {world}")
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, shape))
        self.size = world
        rank = dist.get_rank()
        self.coords = dict(zip(self.axis_names,
                               (int(c) for c in np.unravel_index(rank,
                                                                 shape))))
        grid = np.arange(world).reshape(shape)
        self._groups: Dict[str, comm.Group] = {}
        # every rank creates every group, in one order (new_group's rule)
        for i, name in enumerate(self.axis_names):
            for line in np.moveaxis(grid, i, -1).reshape(-1, shape[i]):
                ranks = [int(r) for r in line]
                pg = None if len(ranks) == world else dist.new_group(ranks)
                if rank in ranks:
                    self._groups[name] = comm.Group(ranks, pg, self.device)

    def group(self, axis: str) -> comm.Group:
        if axis not in self._groups:
            raise KeyError(f"no mesh axis {axis!r}; have {self.axis_names}")
        return self._groups[axis]


def make_mesh(n_devices: Optional[int] = None, axis: str = "data",
              device=None) -> Mesh:
    """A 1-D mesh over the whole job (`n_devices` must be its size)."""
    mesh_device = comm.default_device(device)
    if not dist.is_initialized():
        comm.init_process_group(device=mesh_device)
    n = dist.get_world_size() if n_devices is None else n_devices
    return Mesh((n,), (axis,), mesh_device)


def make_mesh_2d(n_data: int, n_spatial: int, axes=("data", "spatial"),
                 device=None) -> Mesh:
    """(data x spatial) mesh, or any two axes, for batch + spatial or batch
    + tensor sharding."""
    return Mesh((n_data, n_spatial), tuple(axes), device)


def shard_batch(x, mesh: Mesh, axis: str = "data") -> torch.Tensor:
    """This rank's rows of the global batch `x`, on the mesh's device."""
    x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                        else x)
    lo, hi = share(x.shape[0], mesh.group(axis))
    return x[lo:hi].to(mesh.device)


def replicate(x, mesh: Mesh):
    """`x` (a tensor or a tree of them) on the mesh's device, rank 0's
    values on every rank."""
    group = comm.Group(range(mesh.size), None, mesh.device)

    def one(t):
        t = torch.as_tensor(t).to(mesh.device).contiguous()
        return comm.broadcast(t, 0, group)
    return tree_map(one, x)


def _noise_rows(model, noise: Optional[dict], batch: int, lo: int,
                hi: int) -> dict:
    """Rows [lo, hi) of the global batch's noise inputs: `noise`, or the
    reference noise of a batch of `batch`."""
    full = noise if noise is not None else model.prepare_noise(batch)
    return {k: torch.as_tensor(v, device=model.device)[lo:hi]
            for k, v in full.items()}


def _check_device(model, mesh: Mesh) -> None:
    if not same_device(model.device, mesh.device):
        raise ValueError(f"the model is on {model.device}, the mesh's rank "
                         f"on {mesh.device}")


def sharded_sampler(model, mesh: Mesh, axis: str = "data"):
    """(params, z[, noise]) -> this rank's images: z and noise are the
    global batch's, the images (B / mesh.shape[axis], H, W, 3) those of
    this rank's rows, through ``model(params, z, noise)`` (``model(params,
    z)`` for a model without noise inputs, ProgGAN's)."""
    _check_device(model, mesh)
    group = mesh.group(axis)
    noisy = hasattr(model, "prepare_noise")

    def sample(params, z, noise=None):
        z = torch.as_tensor(z)
        lo, hi = share(z.shape[0], group)
        if not noisy:
            return model(params, z[lo:hi])
        return model(params, z[lo:hi],
                     _noise_rows(model, noise, z.shape[0], lo, hi))
    return sample


def sharded_second_moment(rows_fn, mesh: Mesh, axis: str = "data"):
    """z-batch -> (xᵀx, n) of ``rows_fn`` over the global batch: each rank
    takes its rows of the batch, and the products and counts are
    all-reduced."""
    group = mesh.group(axis)

    def moment(zbatch):
        zbatch = torch.as_tensor(zbatch)
        lo, hi = share(zbatch.shape[0], group)
        rows = rows_fn(zbatch[lo:hi].to(mesh.device))
        xtx = comm.all_reduce(rows.t() @ rows, group)
        n = comm.all_reduce(torch.tensor(float(rows.shape[0]),
                                         device=rows.device), group)
        return xtx, n
    return moment


def vmapped_multi_edit(insert_fn, mesh: Mesh, axis: str = "data"):
    """Many independent edit solves: ``run(weights0, goals_in, goals_out,
    directions)``, each argument (a tensor or a tree of them) stacked on a
    leading edit axis, returns ``insert_fn`` of every edit (a tensor, or
    a tuple of them) stacked in edit order on every rank.  The edits are
    split over the ranks (uneven splits too, each rank at least one edit),
    each rank solving its own in turn."""
    group = mesh.group(axis)

    def run(weights0, goals_in, goals_out, directions):
        e = int(torch.as_tensor(directions).shape[0])
        counts = uneven_counts(e, group.size)
        if min(counts) < 1:
            raise ValueError(f"{e} edits over {group.size} ranks leave a "
                             "rank without an edit to show the results' "
                             "shapes")
        lo = sum(counts[:group.index])
        results = []
        for i in range(lo, lo + counts[group.index]):
            def pick(t, i=i):
                return torch.as_tensor(t)[i].to(mesh.device)
            results.append(insert_fn(*(tree_map(pick, a) for a in (
                weights0, goals_in, goals_out, directions))))
        if isinstance(results[0], tuple):
            return tuple(gather_in_order([r[j] for r in results], counts,
                                         group, results[0][j])
                         for j in range(len(results[0])))
        return gather_in_order(results, counts, group, results[0])
    return run


# ---------------------------------------------------------------------------
# dp x sp: bands of image rows
# ---------------------------------------------------------------------------

HALO = 1        # rows a band takes from each neighbour before a stage


class _Bands:
    """This rank's band of rows on the spatial axis, at each resolution
    where the bands are at least ``HALO`` rows tall."""

    def __init__(self, group: comm.Group):
        self.group = group

    def banded(self, res: Optional[int]) -> bool:
        n = self.group.size
        return res is not None and res % n == 0 and res // n >= HALO

    def span(self, res: int) -> Tuple[int, int]:
        rows = res // self.group.size
        return self.group.index * rows, (self.group.index + 1) * rows

    def rows(self, x: torch.Tensor, lo: int, hi: int, res: int
             ) -> torch.Tensor:
        """Rows [lo, hi) of a map of `res` rows, zeros outside it, from the
        whole map (a replicated stage's) or from this rank's band of it and
        its neighbours' halo rows."""
        if x.shape[2] == res:
            have, first = x, 0
        else:
            above, below = comm.halo_rows(x, self.group, HALO)
            have = torch.cat([above, x, below], 2)
            first = self.span(res)[0] - HALO
        start, stop = lo - first, hi - first
        piece = have[:, :, max(start, 0):min(stop, have.shape[2])]
        top, bottom = max(0, -start), max(0, stop - have.shape[2])
        if (top or bottom) and x.shape[2] != res:
            raise ValueError(f"rows [{lo}, {hi}) reach past the halo")
        return F.pad(piece, (0, 0, top, bottom)) if top or bottom else piece


def _check_not_int8() -> None:
    if int8_active():
        raise ValueError("the int8 tier's per-tensor activation scale needs "
                         "the whole map: the spatial bands do not take it")


def _band_conv(bands: _Bands, in_c: int, res: int):
    """The dconv of a 3x3 layer on this rank's band: its rows and one more
    on each side, padded in width only."""
    scale = 1.0 / math.sqrt(in_c * 9)

    def fn(params, d: DataBag) -> DataBag:
        _check_not_int8()
        a, b = bands.span(res)
        x = bands.rows(d["fmap"], a - HALO, b + HALO, res)
        w = params["weight"][0] * scale
        out = tiered(F.conv2d, x, w, padding=(0, 1))
        return DataBag(d, fmap=out * _demod(w, d["style"])[:, :, None, None])
    return fn


def _band_upconv(bands: _Bands, in_c: int, res: int):
    """The stride-2 transposed dconv of an upsampling layer for this rank's
    band [a, b) of its `res`-row output: the input rows [(a-2)//2,
    (b+1)//2] give the full-width conv's rows [a-1, b+1], all that the
    4-tap blur (pad 1) of rows [a, b) reads."""
    scale = 1.0 / math.sqrt(in_c * 9)

    def fn(params, d: DataBag) -> DataBag:
        _check_not_int8()
        a, b = bands.span(res)
        lo, hi = (a - 2) // 2, (b + 1) // 2
        x = bands.rows(d["fmap"], lo, hi + 1, res // 2)
        w = params["weight"][0] * scale
        y = modconv_linear(x, w, True, 3)            # rows 2*lo ...
        start = a - 1 - 2 * lo
        y = y[:, :, start:start + (b - a) + 3]
        return DataBag(d, fmap=y * _demod(w, d["style"])[:, :, None, None])
    return fn


def _band_blur(blur_kernel):
    """The up-conv's blur on the band (rows already haloed): the width
    padded by 1 on each side, then K2 with a pad of 0."""
    taps = blur_taps(make_kernel(blur_kernel), (0, 0), 2)

    def fn(params, d: DataBag) -> DataBag:
        return DataBag(d, fmap=apply_blur(
            F.pad(d["fmap"], (1, 1, 0, 0)).contiguous(), taps))
    return fn


def _band_noise(bands: _Bands, res: int):
    def fn(params, d: DataBag) -> DataBag:
        x = d["fmap"]
        noise = d.get(noise_key(res, res))
        if noise is None:
            noise = _reference_noise(x.shape[0], res, res, x.device)
        a, b = bands.span(res)
        return DataBag(d, fmap=x + params["weight"] * noise[:, :, a:b])
    return fn


def _band_up_rgb(bands: _Bands, blur_kernel, res: int):
    """The RGB skip's 2x FIR upsample (zeros inserted, pad (2, 1), the
    4-tap kernel x 4) of this rank's band [a, b): the skip's rows
    [(a-2)//2, (b+1)//2] give the inserted rows [a-2, b+1] it reads."""
    kern = make_kernel(blur_kernel) * 4.0
    kflip = torch.from_numpy(np.ascontiguousarray(np.flip(kern, (0, 1))))

    def fn(params, d: DataBag) -> DataBag:
        a, b = bands.span(res)
        lo, hi = (a - 2) // 2, (b + 1) // 2
        x = bands.rows(d["output"], lo, hi + 1, res // 2)
        n, c, h, w = x.shape
        xd = x.new_zeros((n, c, 2 * h, 2 * w))
        xd[:, :, ::2, ::2] = x
        start = a - 2 - 2 * lo
        xd = F.pad(xd[:, :, start:start + (b - a) + 3], (2, 1, 0, 0))
        wdw = kflip.to(x.device, x.dtype).expand(c, 1, *kflip.shape)
        return DataBag(d, output=F.conv2d(xd, wdw, groups=c))
    return fn


def band_pipeline(model, group: comm.Group) -> StagePipeline:
    """The seq pipeline of `model` with its stages at the banded
    resolutions working on this rank's band of rows (spatial `group`)."""
    if len(model.blur_kernel) != 4:
        raise ValueError("the spatial bands take the 4-tap blur of "
                         f"StyleGAN2, got {model.blur_kernel}")
    bands = _Bands(group)
    overrides = {}
    for name, spec in model._param_specs.items():
        res = stage_resolution(name)
        if spec[0] != "dconv" or not bands.banded(res):
            continue
        prefix = name[:-len(".mconv.dconv")]
        in_c, upsample = spec[1], spec[4]
        overrides[name] = (_band_upconv if upsample else _band_conv)(
            bands, in_c, res)
        overrides[f"{prefix}.noise"] = _band_noise(bands, res)
        if upsample:
            overrides[f"{prefix}.mconv.blur"] = _band_blur(model.blur_kernel)
    for stage in model.pipeline.stages:
        res = stage_resolution(stage.name)
        if stage.name.startswith("up_rgb") and bands.banded(res):
            overrides[stage.name] = _band_up_rgb(bands, model.blur_kernel,
                                                 res)
    return StagePipeline([Stage(s.name, overrides.get(s.name, s.fn))
                          for s in model.pipeline.stages])


def _check_k1_off(model) -> None:
    for name, spec in model._param_specs.items():
        if spec[0] == "dconv" and spec[4] and fused_upconv_active(
                spec[1], spec[2], stage_resolution(name)):
            raise RuntimeError(
                "spatial_sharded_sampler runs the seq stages on bands and "
                "has no K1 path: K1's gate (ops.upconv_blur."
                "set_fused_upconv) is on for "
                f"{name}; set it 'off' for spatial sampling")


def spatial_sharded_sampler(model, mesh: Mesh, axis_data: str = "data",
                            axis_spatial: str = "spatial"):
    """(params, z[, noise]) -> this rank's block of the images: its rows of
    the global batch (over `axis_data`) and its band of image rows (over
    `axis_spatial`), (B / n_data, H / n_spatial, W, 3).  Equals the
    single-device ``model(params, z, noise)`` with K1's gate off, the
    only state it takes."""
    _check_device(model, mesh)
    data, spatial = mesh.group(axis_data), mesh.group(axis_spatial)
    if model.size % spatial.size:
        raise ValueError(f"{model.size} rows do not split over "
                         f"{spatial.size} ranks")
    pipe = band_pipeline(model, spatial)

    def sample(params, z, noise=None):
        _check_k1_off(model)
        z = torch.as_tensor(z)
        lo, hi = share(z.shape[0], data)
        bag = model.make_bag(z[lo:hi], _noise_rows(model, noise, z.shape[0],
                                                   lo, hi))
        with torch.no_grad():
            out = pipe(params, bag)["output"]
        return out.permute(0, 2, 3, 1).contiguous()
    return sample

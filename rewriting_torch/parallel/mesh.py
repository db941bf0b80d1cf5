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
  ``spatial``, through ``pipeline_fast`` as one device runs it.  Each
  rank of the spatial axis holds a band of rows of the maps that are tall
  enough (at least one row a rank: the halo every stage needs); the lower
  resolutions run replicated (K1 on the whole map where its gate
  passes), and the first banded stage takes its rows from the whole map.
  Before each 3x3 conv, up-conv and RGB-skip upsample the band gets one
  row from each neighbour (``comm.halo_rows``), zeros at the image's true
  edges; the blur after a seq up-conv runs on the band padded in width
  only, so K2 launches with a pad of 0.  Where K1's gate passes, K1
  launches on the band's input rows and one more on each side, and the
  output rows its zero padding at the slab's edges reaches are dropped.
  In place of the s2d tail the bands run its seq stages, as
  :func:`parallel.tensor.tp_pipeline` does (the tail gains nothing on an
  H100), with the tail's dconvs at "default" in an int8 stage, as the
  tail's convs are on one device.

Under an int8 stage each rank quantizes its share of a map with the whole
map's scale: the samplers install ``ops/quant.whole_tensor_scales`` with
the max over the axes the map is split across (``comm.max_over``), as the
JAX package's single-device semantics under its mesh give.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..core import DataBag, Stage, StagePipeline, tree_map
from ..models.stylegan2 import (_demod, _make_dconv, _reference_noise,
                                modconv_linear, modconv_w8a8, noise_key,
                                stage_resolution)
from ..ops import make_kernel
from ..ops.precision import get_precision, int8_active, tiered
from ..ops.quant import whole_tensor_scales
from ..ops.upconv_blur import (fused_epilogue_active, fused_upconv_active,
                               upconv_blur)
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
    reduce_max = comm.max_over(group)

    def sample(params, z, noise=None):
        z = torch.as_tensor(z)
        lo, hi = share(z.shape[0], group)
        # an int8 stage's scale is the global batch's, as on one device
        with whole_tensor_scales(reduce_max):
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


def _band_conv(bands: _Bands, in_c: int, res: int, int8: bool = True):
    """The dconv of a 3x3 layer on this rank's band: its rows and one more
    on each side, padded in width only; in an int8 stage on the int8 core
    with the whole map's scale (the sampler's ``whole_tensor_scales``),
    unless ``int8=False`` (an s2d tail layer's)."""
    scale = 1.0 / math.sqrt(in_c * 9)

    def fn(params, d: DataBag) -> DataBag:
        a, b = bands.span(res)
        x = bands.rows(d["fmap"], a - HALO, b + HALO, res)
        w = params["weight"][0] * scale
        if int8 and int8_active():
            out = modconv_w8a8(x, w, False, 3, row_pad=0)
        else:
            out = tiered(F.conv2d, x, w, padding=(0, 1))
        return DataBag(d, fmap=out * _demod(w, d["style"])[:, :, None, None])
    return fn


def _slab(bands: _Bands, x: torch.Tensor, res: int):
    """(the input rows [lo, hi] of an up-conv's `res`-row output band [a,
    b), lo): lo = (a-2)//2, hi = (b+1)//2, zeros past the image's edges.
    The stride-2 conv of these rows gives the full-width conv's rows
    [2 lo, 2 hi + 2], of which [a-1, b+1] are all that the 4-tap blur
    (pad 1) of rows [a, b) reads."""
    a, b = bands.span(res)
    lo, hi = (a - 2) // 2, (b + 1) // 2
    return bands.rows(x, lo, hi + 1, res // 2), lo


def _band_upconv(bands: _Bands, in_c: int, res: int, int8: bool = True):
    """The stride-2 transposed dconv of an upsampling layer for this rank's
    band [a, b) of its `res`-row output, from the input rows of
    :func:`_slab`: its rows [a-1, b+1], for the blur; in an int8 stage on
    the int8 core with the whole map's scale, unless ``int8=False``."""
    scale = 1.0 / math.sqrt(in_c * 9)

    def fn(params, d: DataBag) -> DataBag:
        a, b = bands.span(res)
        x, lo = _slab(bands, d["fmap"], res)
        w = params["weight"][0] * scale
        conv = modconv_w8a8 if int8 and int8_active() else modconv_linear
        y = conv(x, w, True, 3)                      # rows 2*lo ...
        start = a - 1 - 2 * lo
        y = y[:, :, start:start + (b - a) + 3]
        return DataBag(d, fmap=y * _demod(w, d["style"])[:, :, None, None])
    return fn


def _band_fused_upconv(bands: _Bands, prefix: str, in_c: int, out_c: int,
                       res: int, blur_kernel, seq_fn):
    """``pipeline_fast``'s fused up-conv for this rank's band [a, b) of its
    `res`-row output: where K1's gate passes, K1 launched on the input rows
    of :func:`_slab` (zeros past the image's edges, as K1's own padding
    gives there), and of its 2 (hi - lo + 1) output rows those [a - 2 lo,
    b - 2 lo) kept, which K1's zero padding at the slab's edges does not
    reach; with the epilogue, the noise is the slab's rows of the global
    noise map, zeros outside the image.  At the stage's tier, as
    ``pipeline_fast``: the one-pass bf16 mode under "default" and "int8".
    Else `seq_fn`, the band's seq up-conv.  Takes the full params."""
    scale = 1.0 / math.sqrt(in_c * 9)
    k = np.asarray(blur_kernel, np.float64)
    kf = tuple(float(v) for v in (k / k.sum()) * 2.0)

    def fn(params, d: DataBag) -> DataBag:
        own = params.get(f"{prefix}.mconv.dconv", {})
        if not fused_upconv_active(in_c, out_c, res):
            return seq_fn(own, d)
        a, b = bands.span(res)
        x, lo = _slab(bands, d["fmap"], res)
        x = x.contiguous()
        w = own["weight"][0] * scale
        wf = torch.flip(w, (-2, -1))
        demod = _demod(w, d["style"])
        tier = get_precision()
        keep = slice(a - 2 * lo, b - 2 * lo)
        if not fused_epilogue_active(in_c, out_c, res):
            y = upconv_blur(x, wf, kf, tier=tier)[:, :, keep]
            return DataBag(d, fmap=y * demod[:, :, None, None])
        noise = bands.rows(_noise_map(d, x, res), 2 * lo,
                           2 * lo + 2 * x.shape[2], res)
        noise = params[f"{prefix}.noise"]["weight"] * noise
        bias = params[f"{prefix}.activate"]["bias"]
        y = upconv_blur(x, wf, kf, demod, noise, bias, tier=tier)
        return DataBag(d, fmap=y[:, :, keep].contiguous())
    fn._full_params = True
    return fn


def _unless(active, in_c: int, out_c: int, res: int, fn):
    """`fn`, or the identity where K1's gate `active` (its up-conv's, or
    its epilogue's) passes for the layer, as ``pipeline_fast``'s blur,
    noise and activate stages do at a fused layer."""
    def run(params, d: DataBag) -> DataBag:
        return d if active(in_c, out_c, res) else fn(params, d)
    return run


def _band_blur(blur_kernel):
    """The up-conv's blur on the band (rows already haloed): the width
    padded by 1 on each side, then K2 with a pad of 0."""
    taps = blur_taps(make_kernel(blur_kernel), (0, 0), 2)

    def fn(params, d: DataBag) -> DataBag:
        return DataBag(d, fmap=apply_blur(
            F.pad(d["fmap"], (1, 1, 0, 0)).contiguous(), taps))
    return fn


def _noise_map(d: DataBag, x: torch.Tensor, res: int) -> torch.Tensor:
    """The global `res` x `res` noise of the bag's images: its input, or
    the reference noise."""
    noise = d.get(noise_key(res, res))
    if noise is None:
        noise = _reference_noise(x.shape[0], res, res, x.device)
    return noise


def _band_noise(bands: _Bands, res: int):
    def fn(params, d: DataBag) -> DataBag:
        x = d["fmap"]
        a, b = bands.span(res)
        return DataBag(d, fmap=x + params["weight"]
                       * _noise_map(d, x, res)[:, :, a:b])
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
    """``pipeline_fast`` of `model` with its stages at the banded
    resolutions working on this rank's band of rows (spatial `group`): the
    seq stages, K1 where its gate passes (:func:`_band_fused_upconv`), and
    the s2d tail's seq stages in its place."""
    if len(model.blur_kernel) != 4:
        raise ValueError("the spatial bands take the 4-tap blur of "
                         f"StyleGAN2, got {model.blur_kernel}")
    bands = _Bands(group)
    tail = model._s2d_names
    overrides = {}
    for name, spec in model._param_specs.items():
        if spec[0] != "dconv":
            continue
        res = stage_resolution(name)
        in_c, out_c, upsample = spec[1], spec[2], spec[4]
        int8 = name not in tail
        if not bands.banded(res):
            if not int8:
                overrides[name] = _make_dconv(in_c, 3, upsample, int8=False)
            continue
        prefix = name[:-len(".mconv.dconv")]
        noise = _band_noise(bands, res)
        if not upsample:
            overrides[name] = _band_conv(bands, in_c, res, int8)
            overrides[f"{prefix}.noise"] = noise
            continue
        dconv = _band_upconv(bands, in_c, res, int8)
        blur = _band_blur(model.blur_kernel)
        if name in model._fast_overrides and int8:      # K1's layers
            dconv = _band_fused_upconv(bands, prefix, in_c, out_c, res,
                                       model.blur_kernel, dconv)
            blur = _unless(fused_upconv_active, in_c, out_c, res, blur)
            noise = _unless(fused_epilogue_active, in_c, out_c, res, noise)
        overrides[name] = dconv
        overrides[f"{prefix}.mconv.blur"] = blur
        overrides[f"{prefix}.noise"] = noise
    for stage in model.pipeline.stages:
        res = stage_resolution(stage.name)
        if stage.name.startswith("up_rgb") and bands.banded(res):
            overrides[stage.name] = _band_up_rgb(bands, model.blur_kernel,
                                                 res)
    return StagePipeline([
        Stage(seq.name, overrides.get(seq.name,
                                      seq.fn if seq.name in tail else s.fn))
        for s, seq in zip(model.pipeline_fast.stages, model.pipeline.stages)])


def spatial_sharded_sampler(model, mesh: Mesh, axis_data: str = "data",
                            axis_spatial: str = "spatial"):
    """(params, z[, noise]) -> this rank's block of the images: its rows of
    the global batch (over `axis_data`) and its band of image rows (over
    `axis_spatial`), (B / n_data, H / n_spatial, W, 3).  Computes the
    single-device ``model(params, z, noise)``, ``pipeline_fast`` under
    K1's gate and the precision schedule as they stand: K1 on each band's
    slab, the s2d tail's seq stages on bands, an int8 stage's scale the
    whole map's (over both axes)."""
    _check_device(model, mesh)
    data, spatial = mesh.group(axis_data), mesh.group(axis_spatial)
    if model.size % spatial.size:
        raise ValueError(f"{model.size} rows do not split over "
                         f"{spatial.size} ranks")
    pipe = band_pipeline(model, spatial)
    reduce_max = comm.max_over(data, spatial)

    def sample(params, z, noise=None):
        z = torch.as_tensor(z)
        lo, hi = share(z.shape[0], data)
        bag = model.make_bag(z[lo:hi], _noise_rows(model, noise, z.shape[0],
                                                   lo, hi))
        with torch.no_grad(), whole_tensor_scales(reduce_max):
            out = pipe(params, bag)["output"]
        return out.permute(0, 2, 3, 1).contiguous()
    return sample

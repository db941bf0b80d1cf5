"""Tensor (model) parallelism for the StyleGAN2 generator.

Counterpart of the JAX package's ``parallel/tensor.py`` (:50-161): the same
Megatron-style alternation of the trunk and the style MLP over a mesh
axis, the same divisibility fallback (a leaf whose axis does not divide
the axis size is replicated), the same specs.  Where the JAX package
annotates the weights and its compiler inserts the collectives, the port
holds only its shard of each sharded weight (:func:`tensor_shard_params`)
and makes the collectives explicit:

- conv k (trunk order, k = N - 2 for ``layerN``) is **column-parallel**
  for even k: dconv weight ``(1, O, I, kh, kw)`` split on O, activate
  bias split, the map in and the style whole.  The seq stages run as they
  are on the shards: the demodulation sums over I, which every rank holds.
- odd k is **row-parallel** (every up-conv, ``layer3``, ``layer5``, ...):
  the weight split on I and the modulation that makes the per-I style
  split to match, so the map arrives split on channels from the column
  layer before.  The conv's output and the demodulation's sum of squares
  over I are partial sums; both are all-reduced before the demodulation
  divides and before noise, bias and activation.  Under K1's gate the
  up-conv runs K1 WITHOUT its fused epilogue on the partial sums (the
  blur is linear, so it may run before the reduce); noise, bias and
  activation follow the all-reduce.  In an int8 stage the partial sums
  are dequantized with the whole weight's and the whole map's scales
  before the all-reduce (``ops/quant.py``), as the JAX package's int32
  sum over all input channels is.
- ``to_rgb`` consumes a column layer's split output: weight and
  modulation split on I, and the 3-channel output all-reduced before its
  bias and the skip.
- the style MLP alternates the same way on its ``(O, I)`` weights, with
  ``lr_mul``: odd-numbered layers split on O (bias too), even-numbered on
  I, whose output is all-reduced before the bias and activation.
- noise injection is the layer's one scalar weight times the noise map: it
  applies to each channel shard unchanged.

A stage whose input arrives whole where its weight wants it split takes
its own channels (no communication); one that arrives split where its
weight is whole (the fallback) is all-gathered first.

The specs are tuples in the JAX package's ``PartitionSpec`` form: the
axis name at the split dimension, ``None`` elsewhere, ``()`` replicated.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core import DataBag, Stage, StagePipeline
from ..models.stylegan2 import (_equal_linear, _fused_lrelu_stage,
                                _make_dconv, _noise_inject, _rgb_product,
                                modconv_w8a8, stage_resolution)
from ..ops import fused_leaky_relu, make_kernel, upsample2d
from ..ops import upconv_blur as _kup
from ..ops.precision import get_precision, int8_active, tiered, tiered_sum
from ..ops.quant import whole_tensor_scales
from . import comm
from .comm import share
from .mesh import Mesh, _check_device, _noise_rows

_LAYER_RE = re.compile(r"^layer(\d+)\.")
_STYLE_RE = re.compile(r"^style\.(\d+)$")
_TORGB_RE = re.compile(r"^to_rgb(\d+)\.")


def _spec(ndim: int, dim: int, axis: str) -> tuple:
    return tuple(axis if i == dim else None for i in range(ndim))


def _group_specs(name: str, group: dict, n: int, axis: str) -> dict:
    """The specs of one stage's leaves (shapes or tensors), the JAX
    package's rules."""
    def split(shape, dim):
        ok = len(shape) > dim and shape[dim] % n == 0
        return _spec(len(shape), dim, axis) if ok else ()

    def shape(leaf):
        return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)

    def rep(tree):
        return {k: rep(v) if isinstance(v, dict) else ()
                for k, v in tree.items()}

    m, s, r = (_LAYER_RE.match(name), _STYLE_RE.match(name),
               _TORGB_RE.match(name))
    if m:
        column = (int(m.group(1)) - 2) % 2 == 0
        out = {}
        for key, leaf in group.items():
            sh = shape(leaf)
            if name.endswith(".mconv.dconv") and key == "weight":
                out[key] = split(sh, 1 if column else 2)
            elif name.endswith(".mconv.modulation") and not column:
                out[key] = split(sh, 0)
            elif name.endswith(".activate") and key == "bias" and column:
                out[key] = split(sh, 0)
            else:
                out[key] = ()
        return out
    if s:
        column = (int(s.group(1)) - 1) % 2 == 0
        out = {}
        for key, leaf in group.items():
            sh = shape(leaf)
            if key == "weight":
                out[key] = split(sh, 0 if column else 1)
            elif key == "bias" and column:
                out[key] = split(sh, 0)
            else:
                out[key] = ()
        return out
    if r:
        out = rep(group)
        if "weight" in group:
            out["weight"] = split(shape(group["weight"]), 2)
        if "modulation" in group:
            i_c = shape(group["modulation"]["weight"])[0]
            if i_c % n == 0:
                out["modulation"] = {"weight": (axis, None),
                                     "bias": (axis,)}
        return out
    return rep(group)


def tp_param_sharding(model, params, mesh: Mesh, axis: str = "model"
                      ) -> Dict[str, dict]:
    """The spec of every leaf of a SeqStyleGAN2 params tree for tensor
    parallelism over `axis` (the JAX package's ``tp_param_sharding``, its
    specs as tuples)."""
    n = mesh.shape[axis]
    return {name: _group_specs(name, group, n, axis)
            for name, group in params.items()}


def _shard(leaf, spec, index: int, n: int, device):
    """`leaf` (a tensor or a dict of them) cut to share `index` of `n`
    where `spec` splits it, on `device`."""
    if isinstance(leaf, dict):
        return {k: _shard(v, spec[k] if isinstance(spec, dict) else spec,
                          index, n, device) for k, v in leaf.items()}
    if spec:
        dim = next(i for i, a in enumerate(spec) if a is not None)
        size = leaf.shape[dim] // n
        leaf = leaf.narrow(dim, index * size, size)
    return leaf.contiguous().to(device)


def tensor_shard_params(model, params, mesh: Mesh, axis: str = "model"
                        ) -> Dict[str, dict]:
    """This rank's params: each split leaf cut to its 1/n along its split
    dimension, the others whole, all on the mesh's device.  Every rank
    passes the same whole tree."""
    specs = tp_param_sharding(model, params, mesh, axis)
    group = mesh.group(axis)
    return {name: _shard(sub, specs[name], group.index, group.size,
                         mesh.device)
            for name, sub in params.items()}


def param_shapes(model) -> Dict[str, dict]:
    """The whole shapes of a SeqStyleGAN2's params, from its specs."""
    out = {}
    for name, spec in model._param_specs.items():
        kind = spec[0]
        if kind == "linear":
            out[name] = {"weight": (spec[2], spec[1]), "bias": (spec[2],)}
        elif kind == "dconv":
            out[name] = {"weight": (1, spec[2], spec[1], spec[3], spec[3])}
        elif kind == "act_bias":
            out[name] = {"bias": (spec[1],)}
        elif kind == "to_rgb":
            out[name] = {"modulation": {"weight": (spec[1], model.style_dim),
                                        "bias": (spec[1],)},
                         "weight": (1, 3, spec[1], 1, 1), "bias": (3,)}
        else:
            out[name] = {}
    return out


def _match(x: torch.Tensor, channels: int, group: comm.Group
           ) -> torch.Tensor:
    """`x` with `channels` along dim 1: whole, or this rank's share of its
    whole channels (taken locally, or all-gathered from the shares)."""
    have = x.shape[1]
    if have == channels:
        return x
    if have > channels:
        return x[:, group.index * channels:(group.index + 1) * channels]
    return comm.all_gather(x, group, dim=1)


def _tp_style(in_dim: int, lr_mul: float, row: bool, group: comm.Group):
    scale = (1.0 / math.sqrt(in_dim)) * lr_mul

    def fn(params, d: DataBag) -> DataBag:
        w = params["weight"]
        x = _match(d["latent"], w.shape[1], group)
        if not row:
            return DataBag(d, latent=_equal_linear(params, x, scale, lr_mul,
                                                   "fused_lrelu"))
        out = tiered_sum(torch.matmul, _sum_over(group), x,
                         (w * scale).t())
        return DataBag(d, latent=fused_leaky_relu(out,
                                                  params["bias"] * lr_mul))
    return fn


def _tp_latents(seq_fn, style_dim: int, group: comm.Group):
    def fn(params, d: DataBag) -> DataBag:
        return seq_fn(params, DataBag(d, latent=_match(d["latent"],
                                                       style_dim, group)))
    return fn


def _tp_adain(group: comm.Group):
    def fn(params, d: DataBag) -> DataBag:
        style = d["style"]
        x = _match(d["fmap"], style.shape[1], group)
        return DataBag(d, fmap=style[:, :, None, None] * x)
    return fn


def _sum_over(group: comm.Group):
    def reduce(t: torch.Tensor) -> torch.Tensor:
        return comm.all_reduce(t, group)
    return reduce


def _row_demod(w: torch.Tensor, style: torch.Tensor, group: comm.Group):
    """rsqrt of the demodulation's sum over ALL input channels, from this
    rank's (O, I/n) share: the partial sums all-reduced first."""
    sq = tiered_sum(torch.matmul, _sum_over(group), style * style,
                    torch.sum(w * w, dim=(-2, -1)).t())
    return torch.rsqrt(sq + 1e-8)


def _conv_part(upsample: bool):
    """A row layer's bare conv of (B, I/n, H, W) by (O, I/n, 3, 3) in the
    dtype it is given: ``modconv_linear`` without its tier."""
    def conv(x, w):
        if upsample:
            return F.conv_transpose2d(x, w.transpose(0, 1), stride=2)
        return F.conv2d(x, w, padding=1)
    return conv


def _tp_row_dconv(in_c: int, out_c: int, upsample: bool, res, fast: bool,
                  blur_kernel, group: comm.Group, int8: bool = True):
    """A row-parallel dconv: the conv of this rank's input channels, its
    partial sums and the demodulation's all-reduced, then demodulated.  On
    ``pipeline_fast``, where K1's gate passes, K1 without its epilogue
    (conv and blur on the partial sums) at the stage's tier.  In an int8
    stage the int32 partial sums are dequantized with the whole weight's
    per-output-channel scales (the max over the ranks' shares) and the
    whole map's activation scale (the sampler's ``whole_tensor_scales``),
    then all-reduced: the one-device sum over all input channels, up to
    the fp32 rounding of that sum.  ``int8=False``: an s2d tail layer's,
    whose int8 stage computes at "default" on one device."""
    scale = 1.0 / math.sqrt(in_c * 9)
    k = np.asarray(blur_kernel, np.float64)
    kf = tuple(float(v) for v in (k / k.sum()) * 2.0)

    def fn(params, d: DataBag) -> DataBag:
        w = params["weight"][0] * scale
        x = d["fmap"]
        if fast and upsample and _kup.fused_upconv_active(in_c, out_c, res):
            y = comm.all_reduce(_kup.upconv_blur(
                x, torch.flip(w, (-2, -1)), kf, tier=get_precision()), group)
        elif int8 and int8_active():
            y = comm.all_reduce(modconv_w8a8(
                x, w, upsample, 3, weight_max=comm.max_over(group)), group)
        else:
            y = tiered_sum(_conv_part(upsample), _sum_over(group), x, w)
        demod = _row_demod(w, d["style"], group)
        return DataBag(d, fmap=y * demod[:, :, None, None])
    return fn


def _tp_to_rgb(in_c: int, style_dim: int, skip: bool, blur_kernel,
               group: comm.Group):
    mod_scale = 1.0 / math.sqrt(style_dim)
    conv_scale = 1.0 / math.sqrt(in_c)
    kern = make_kernel(blur_kernel)

    def fn(params, d: DataBag) -> DataBag:
        w = params["weight"][0, :, :, 0, 0] * conv_scale      # (3, I or I/n)
        style = _equal_linear(params["modulation"], d["style"], mod_scale,
                              1.0, None)
        x = _match(d["fmap"], w.shape[1], group) * style[:, :, None, None]
        if w.shape[1] != in_c:
            out = tiered_sum(_rgb_product, _sum_over(group), x, w)
        else:
            out = tiered(_rgb_product, x, w)
        out = out + params["bias"][None, :, None, None]
        if skip:
            prev = d["output"]
            if prev.shape[2:] != out.shape[2:]:
                prev = upsample2d(prev, kern, factor=2)
            out = out + prev
        return DataBag(d, output=out)
    return fn


def tp_pipeline(model, group: comm.Group, fast: bool = True
                ) -> StagePipeline:
    """`model`'s ``pipeline_fast`` (or seq ``pipeline``) over tp-sharded
    params of the `group`'s axis."""
    n = group.size
    specs = {name: _group_specs(name, shapes, n, "tp")
             for name, shapes in param_shapes(model).items()}
    # pipeline_fast's s2d tail runs its seq stages under tp: the shards'
    # partial sums are all-reduced on NCHW maps.  Its dconvs keep the
    # tail's tier: an int8 stage computes them at "default" as the tail's
    # convs do on one device
    tail = model._s2d_names if fast else set()
    base = model.pipeline_fast if fast else model.pipeline
    base = StagePipeline([seq if seq.name in tail else s
                          for s, seq in zip(base.stages,
                                            model.pipeline.stages)])
    overrides = {}
    for name, spec in model._param_specs.items():
        if spec[0] == "linear" and _STYLE_RE.match(name):
            overrides[name] = _tp_style(spec[1], spec[3],
                                        specs[name]["weight"][1:2] == ("tp",),
                                        group)
        elif spec[0] == "dconv":
            prefix = name[:-len(".mconv.dconv")]
            overrides[f"{prefix}.mconv.adain"] = _tp_adain(group)
            if specs[name]["weight"][2:3] == ("tp",):          # row
                overrides[name] = _tp_row_dconv(
                    spec[1], spec[2], spec[4], stage_resolution(name), fast,
                    model.blur_kernel, group, int8=name not in tail)
                overrides[f"{prefix}.noise"] = _noise_inject
                overrides[f"{prefix}.activate"] = _fused_lrelu_stage
            elif name in tail:                                 # column
                overrides[name] = _make_dconv(spec[1], 3, spec[4],
                                              int8=False)
        elif spec[0] == "to_rgb":
            overrides[name] = _tp_to_rgb(spec[1], model.style_dim,
                                         name != "to_rgb1.rgb",
                                         model.blur_kernel, group)
    for stage in base.stages:
        if stage.name == "latents":
            overrides[stage.name] = _tp_latents(stage.fn, model.style_dim,
                                                group)
    return StagePipeline([Stage(s.name, overrides.get(s.name, s.fn))
                          for s in base.stages])


def tensor_sharded_sampler(model, mesh: Mesh, axis_model: str = "model",
                           axis_data: Optional[str] = None,
                           fast: bool = True):
    """(tp-sharded params, z[, noise]) -> images, from the global batch z:
    replicated over the model axis, and with `axis_data` this rank's rows
    of the batch (a 2-D data x model mesh).  fast=True runs
    ``pipeline_fast`` (K1 where its gate passes, without its epilogue on
    the row layers), fast=False the seq stages."""
    _check_device(model, mesh)
    group = mesh.group(axis_model)
    pipe = tp_pipeline(model, group, fast=fast)
    data = mesh.group(axis_data) if axis_data else None
    # an int8 stage's map is split over the batch (data) and, at a row
    # layer, the channels (model); a column layer's is whole on the model
    # axis, where the max over equal shares changes nothing
    reduce_max = comm.max_over(data, group)

    def sample(params, z, noise=None):
        z = torch.as_tensor(z)
        lo, hi = share(z.shape[0], data) if data else (0, z.shape[0])
        bag = model.make_bag(z[lo:hi], _noise_rows(model, noise, z.shape[0],
                                                   lo, hi))
        with torch.no_grad(), whole_tensor_scales(reduce_max):
            out = pipe(params, bag)["output"]
        return out.permute(0, 2, 3, 1).contiguous()
    return sample

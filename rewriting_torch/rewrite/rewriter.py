"""The rewriting engine: treat one conv layer as a linear associative
memory and rewrite it with a rank-constrained weight edit.

Counterpart of the JAX package's ``rewrite/rewriter.py``: ``GanRewriter``
(:42-694), ``ProgressiveGanRewriter`` (:697-716), ``SeqStyleGanRewriter``
(:718-799) and its Tiny and Pre variants (:801-857), all of it: the
three-way split, the shape probe, the key second moment and its ZCA; the
per-unit quantile sketches of the keys and of the covariance-adjusted
keys; the query key, the Search ranking (``ranking_for_key``) and the
``zca``, ``svd``, ``mean`` and ``gandissect`` context directions; the
pasted goal (tight or whole-map, with or without the object's alpha) and
the erase goal with its normdissect units; the three solves (projected
Adam, with or without its gradient projected; the direct ``Λ·D`` solve;
its fast decomposition) and ``zero``; the all-weights "overfit" baseline
(``all_weights_insert``, ``apply_overfit``); the renders; revert.

The generator splits into context / target / rendering sub-pipelines by
stage name; all three read the one params dict, so an edit is a new weight
in ``self.params`` and ``original_params`` keeps the pristine tree.  Edit
requests are the UI's JSON: ``{"object": [imgnum, mask_url], "paste":
[imgnum, mask_url], "key": [[imgnum, mask_url], ...]}``.

Layout: the model runs NCHW; the public accessors (``context_acts``,
``target_acts``, ``rendered_image``, ``k_shape``/``v_shape``/``x_shape``
and the arrays of ``object_from_selection``) are NHWC like the JAX
package's, and masks and geometry index the activations through them.
The renders are ``uint8 (H, W, 3)`` numpy arrays where the JAX package
returns PIL images.

The solves return their per-step losses (the JAX package's return
nothing), and with ``return_timing`` ``(losses, elapsed ms)``.  The edits
(``apply_edit``, ``apply_erase``, ``apply_overfit``: goals and solves) run
with cuDNN's deterministic algorithms, so one repeats bit for bit on the
card; the statistics and renders keep its default ones.  The
quantile sketches' queries and ``ranking_for_key``'s image numbers are
host numpy, as the JAX package computes them.
"""

from __future__ import annotations

import contextlib
import math
import os
import random
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core import DataBag, leaves, tree_map
from ..models.proggan import conv2d_grouped
from ..models.stylegan2 import modconv_linear, params_to
from ..ops import precision
from ..parallel import comm
from ..parallel.comm import same_device
from ..stats import tally
from ..stats.quantile import RunningQuantile
from ..utils import imgviz, renormalize
from ..utils.device import resolve_device
from . import geometry, solve


KEY_METHODS = ("zca", "gandissect", "svd", "mean")


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _check_key_method(key_method: str) -> None:
    if key_method not in KEY_METHODS:
        raise ValueError(f"key_method {key_method!r}: one of {KEY_METHODS}")


class GanRewriter:
    """Rewriter over a stage-pipeline generator; subclasses pick the edit
    window with :meth:`maplayers`.  `model` provides ``pipeline``,
    ``make_bag(z)``, ``z_dim`` and ``device``.  Runs on ``device`` (default
    ``cuda``), which must be the model's.

    ``mesh`` (``parallel.make_mesh``) shards the key statistics' pass over
    the ranks of its ``data`` axis: the rewriter is then built on every
    rank, each tallying its share of every z batch, and every rank holds
    the same moment (``tally.cached_second_moment``: rank 0 alone writes
    its cache).  The other cached statistics (``unit_rs.npz``,
    ``unit_rq.npz``, ``unit_cad.npz``) are rank 0's: it tallies one and
    writes its file, and every other rank reads that file
    (:meth:`_rank0_tally`)."""

    def __init__(self, model, params, zds, layernum,
                 cachedir: Optional[str] = None,
                 low_rank_insert: bool = True,
                 low_rank_gradient: bool = False,
                 tight_paste: bool = True,
                 key_method: str = "zca",
                 stats_batch_size: int = 10,
                 mesh=None,
                 device=None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, rewriter asked "
                             f"for {self.device}")
        _check_key_method(key_method)
        precision.apply_parity_tier()
        self.model = model
        self.zds = zds
        self.cachedir = cachedir
        self.low_rank_insert = low_rank_insert
        self.low_rank_gradient = low_rank_gradient
        self.tight_paste = tight_paste
        self.key_method = key_method
        self.stats_batch_size = stats_batch_size
        self.mesh = mesh
        if mesh is not None and not same_device(mesh.device, self.device):
            raise ValueError(f"the mesh's rank is on {mesh.device}, the "
                             f"rewriter on {self.device}")
        self.unit_rs = None
        self.unit_rq: Optional[RunningQuantile] = None
        self.cad_rq: Optional[RunningQuantile] = None
        self._alone = False

        self.firstlayer, self.lastlayer = self.maplayers(layernum)
        # own copy of the params dict: edits never touch the caller's tree
        self.params: Dict = params_to(params, self.device)
        self.original_params: Dict = dict(self.params)

        pipe = model.pipeline
        self.context_pipe = pipe.subsequence(upto_layer=self.firstlayer)
        self.target_pipe = pipe.subsequence(first_layer=self.firstlayer,
                                            last_layer=self.lastlayer)
        self.rendering_pipe = pipe.subsequence(after_layer=self.lastlayer)

        # probe shapes (reference ganrewrite.py:59-66)
        k_bag = self.context_of(0)
        v_bag = self._target(self.params, k_bag)
        x_bag = self._render(self.params, v_bag)
        self.k_shape = tuple(self.context_acts(k_bag).shape)   # (1,H,W,C)
        self.v_shape = tuple(self.target_acts(v_bag).shape)
        self.x_shape = tuple(self.rendered_image(x_bag).shape)

        self.c_matrix = self.collect_2nd_moment()
        self.zca_matrix = solve.zca_from_cov(self.c_matrix)

    # -- the three sub-pipelines, without autograd, at the global tier: keys,
    # goals, statistics, solves and the rewriter's renders suspend any
    # installed sampling schedule (JAX package rewriter.py:88-98) ----------
    @torch.no_grad()
    @precision.suspend_schedule_in
    def _context(self, params, bag: DataBag) -> DataBag:
        return self.context_pipe(params, bag)

    @torch.no_grad()
    @precision.suspend_schedule_in
    def _target(self, params, bag: DataBag) -> DataBag:
        return self.target_pipe(params, bag)

    @torch.no_grad()
    @precision.suspend_schedule_in
    def _render(self, params, bag: DataBag) -> DataBag:
        return self.rendering_pipe(params, bag)

    def _window_fn(self, w, goal):
        """The target window's output with `w` as the edited weight."""
        bag, p = goal
        p = dict(p)
        p[self.weight_stage()] = {**p[self.weight_stage()], "weight": w}
        return self.target_pipe(p, bag)["fmap"]

    # -- model-family hooks ---------------------------------------------------
    def maplayers(self, layernum: int) -> Tuple[str, str]:
        raise NotImplementedError

    def context_acts(self, bag: DataBag) -> torch.Tensor:
        return _nhwc(bag["fmap"])

    def target_acts(self, bag: DataBag) -> torch.Tensor:
        return _nhwc(bag["fmap"])

    def rendered_image(self, bag: DataBag) -> torch.Tensor:
        return _nhwc(bag["output"])

    def merge_target_output(self, bag: DataBag, new_acts,
                            crop_bounds) -> DataBag:
        """Renderable bag with NHWC `new_acts` as its feature map; the
        accumulated rgb output is cropped to `crop_bounds` if given."""
        new = DataBag(bag)
        if crop_bounds is not None and "output" in new:
            t, l, b, r = crop_bounds
            new["output"] = new["output"][:, :, t:b, l:r]
        new["fmap"] = torch.as_tensor(
            np.ascontiguousarray(np.asarray(new_acts).transpose(0, 3, 1, 2)),
            device=self.device)
        return new

    # -- basics -----------------------------------------------------------------
    def get_z(self, imgnum: int) -> torch.Tensor:
        return torch.as_tensor(self.zds[imgnum][None], device=self.device)

    def context_of(self, imgnum: int) -> DataBag:
        return self._context(self.params,
                             self.model.make_bag(self.get_z(imgnum)))

    def sample_image_from_latent(self, z) -> torch.Tensor:
        """(B, H, W, 3) images of latents z through the current weights."""
        bag = self.model.make_bag(z)
        return self.rendered_image(self._render(
            self.params, self._target(self.params,
                                      self._context(self.params, bag))))

    def weight_stage(self) -> str:
        """The stage whose weight the edit rewrites."""
        return self.firstlayer

    def target_weight(self) -> torch.Tensor:
        return self.params[self.weight_stage()]["weight"]

    def set_target_weight(self, w: torch.Tensor) -> None:
        stage = self.weight_stage()
        self.params = dict(self.params)
        self.params[stage] = {**self.params[stage], "weight": w}

    def revert(self) -> None:
        """Restore the pristine weights, every leaf (the overfit baseline
        rewrites them all)."""
        self.params = dict(self.original_params)

    def is_empty_mask(self, mask_url: str) -> bool:
        """True where the painted mask of a data URL is 0 everywhere."""
        return renormalize.mask_from_url(mask_url).sum() == 0.0

    def rf(self, fn: str) -> Optional[str]:
        """The cache file `fn`, or None without a cache dir; under a mesh
        every rank names the same file."""
        if self.cachedir is None:
            return None
        return os.path.join(self.cachedir, fn)

    @contextlib.contextmanager
    def statistics_alone(self):
        """Within, a statistic is tallied on this rank alone, with no
        collective, as without a mesh: rank 0 reads or writes its cache
        file, another rank tallies it uncached.  The server enters it for
        the requests rank 0 serves alone.  What is tallied within is
        dropped on leaving: every rank then holds the same statistics, so
        all of them enter the next collective read together."""
        old = (self._alone, self.unit_rs, self.unit_rq, self.cad_rq)
        self._alone = True
        try:
            yield
        finally:
            self._alone, self.unit_rs, self.unit_rq, self.cad_rq = old

    def _rank0_tally(self, fn: str, rows, tally_fn):
        """``tally_fn(rows, cachefile)``, the statistic of the rows function
        `rows`, cached as `fn`.  Under a mesh (every rank calling it at the
        same point) rank 0 alone runs it, tallying and writing the file or
        reading it; ``comm.agree`` then orders that write before every
        other rank's read (and raises on every rank if rank 0 failed), and
        each other rank reads the file: its rows function raises, so no
        rank but 0 tallies."""
        path = self.rf(fn)
        if self.mesh is None or path is None:
            return tally_fn(rows, path)
        rank = dist.get_rank()
        if self._alone:
            return tally_fn(rows, path if rank == 0 else None)
        out, error = None, None
        if rank == 0:
            try:
                out = tally_fn(rows, path)
            except Exception as e:      # noqa: BLE001 - raised on every rank
                error = e
        comm.agree(error, comm.Group(range(self.mesh.size), None,
                                     self.mesh.device))
        if rank != 0:
            def unread(zbatch):
                raise RuntimeError(f"rank {rank} did not read {path}, which "
                                   "rank 0 wrote")
            out = tally_fn(unread, path)
        return out

    # -- statistics -------------------------------------------------------------
    def _key_rows(self, zbatch) -> torch.Tensor:
        """(pixels, C) context activations of a z batch."""
        acts = self.context_acts(self._context(self.params,
                                               self.model.make_bag(zbatch)))
        return acts.reshape(-1, acts.shape[-1])

    def collect_2nd_moment(self) -> torch.Tensor:
        """Uncentered second moment C = E[k kᵀ] of the context keys over
        the z dataset; npz-cached in the JAX package's format; sharded over
        the mesh's ``data`` axis if the rewriter has a mesh."""
        cachefile = (None if self.cachedir is None
                     else os.path.join(self.cachedir, "r2m.npz"))
        args = {"sample_size": len(self.zds), "layer": self.firstlayer}
        with precision.schedule_suspended():
            r = tally.cached_second_moment(
                self._key_rows, self.zds.zs, self.stats_batch_size,
                self.device, cachefile, args, mesh=self.mesh)
        return r.moment()

    def covariance_adjusted_query_key(self, k) -> np.ndarray:
        """C^{-1} k."""
        return solve.solve_spd(self.c_matrix, k)

    def covariance_adjusted_key(self, k, kout_bag) -> np.ndarray:
        """The adjusted key of rows `k` of the context bag `kout_bag`; a
        subclass may read the bag (``SeqPreStyleGanRewriter``)."""
        return self.covariance_adjusted_query_key(k)

    def zca_whitened_query_key(self, k) -> torch.Tensor:
        """C^{-1/2} k; rows in, rows out (the ZCA matrix is symmetric)."""
        k = torch.as_tensor(k, dtype=torch.float32, device=self.device)
        if k.dim() == 1:
            return self.zca_matrix @ k
        return k @ self.zca_matrix

    def square_scales_for_units(self) -> torch.Tensor:
        """(C,) mean squared context activation of each unit over the z
        dataset, npz-cached as ``unit_rs.npz``."""
        if self.unit_rs is None:
            with precision.schedule_suspended():
                self.unit_rs = self._rank0_tally(
                    "unit_rs.npz", lambda z: torch.square(self._key_rows(z)),
                    lambda rows, path: tally.tally_mean(
                        rows, self.zds, batch_size=self.stats_batch_size,
                        cachefile=path, device=self.device)).mean()
        return self.unit_rs

    def quantiles_for_units(self) -> RunningQuantile:
        """Quantile sketch of each unit's context activation over the z
        dataset, npz-cached as ``unit_rq.npz``."""
        if self.unit_rq is None:
            with precision.schedule_suspended():
                self.unit_rq = self._rank0_tally(
                    "unit_rq.npz", self._key_rows, self._quantiles)
        return self.unit_rq

    def _quantiles(self, rows, cachefile):
        return tally.tally_quantile(rows, self.zds,
                                    batch_size=self.stats_batch_size,
                                    cachefile=cachefile, device=self.device)

    def quantiles_for_covariance_adjusted_directions(self) -> RunningQuantile:
        """Quantile sketch of the context keys adjusted through the
        ``covariance_adjusted_key`` hook (so a subclass's override
        applies), npz-cached as ``unit_cad.npz``."""
        if self.cad_rq is None:
            def rows(zbatch):
                bag = self._context(self.params, self.model.make_bag(zbatch))
                flat = self.context_acts(bag).reshape(-1, self.k_shape[-1])
                return torch.as_tensor(self.covariance_adjusted_key(
                    flat.cpu().numpy(), bag), device=self.device)

            with precision.schedule_suspended():
                self.cad_rq = self._rank0_tally("unit_cad.npz", rows,
                                                self._quantiles)
        return self.cad_rq

    def _key_response(self, key: torch.Tensor, zbatch):
        """The response of the context activations to a (C,) key on a z
        batch: (each image's maximum (B, 1), every pixel's (B·H·W, 1))."""
        acts = self._context(self.params, self.model.make_bag(zbatch))["fmap"]
        heat = torch.einsum("bchw,c->bhw", acts, key)
        return heat.reshape(heat.shape[0], -1).amax(dim=1)[:, None], \
            heat.reshape(-1, 1)

    def ranking_for_key(self, key, k: int = 12):
        """The UI's Search: the `k` images of the z dataset whose response
        to `key` peaks highest (numpy image numbers, best first), and the
        quantile sketch of the response over every pixel."""
        key = torch.as_tensor(key, dtype=torch.float32, device=self.device)
        with precision.schedule_suspended():
            topk, rq = tally.tally_topk_and_quantile(
                lambda zbatch: self._key_response(key, zbatch), self.zds,
                k=k, batch_size=self.stats_batch_size, device=self.device)
        return topk.result()[1][0].cpu().numpy(), rq

    # -- selections (masks -> activations) ---------------------------------------
    def _mask_at(self, mask_url, shape) -> np.ndarray:
        """The mask decoded at a feature map's (H, W)."""
        return renormalize.mask_from_url(mask_url, size=tuple(shape))

    def _context_np(self, imgnum) -> Tuple[DataBag, np.ndarray]:
        """(context bag, its NHWC activations as numpy) of one image."""
        bag = self.context_of(imgnum)
        return bag, self.context_acts(bag).cpu().numpy()

    def query_key_from_selection(self, imgnum, mask) -> torch.Tensor:
        """(C,) unit key: the mask-weighted mean context activation,
        adjusted by C^{-1} (reference ganrewrite.py:427-436)."""
        area = self._mask_at(mask, self.k_shape[1:3])
        _, k_acts = self._context_np(imgnum)
        mean = (k_acts[0] * area[:, :, None]).sum((0, 1)) / (1e-10
                                                             + area.sum())
        k = self.covariance_adjusted_query_key(mean)
        return torch.as_tensor(k / (1e-10 + np.linalg.norm(k)),
                               device=self.device)

    def object_from_selection(self, imgnum, mask):
        """The copied object's target activations, cropped to the mask's
        bounding box: (acts (1,h,w,C), target bag, area (h,w), bounds)."""
        area = self._mask_at(mask, self.v_shape[1:3])
        v_bag = self._target(self.params, self.context_of(imgnum))
        v_acts = self.target_acts(v_bag).cpu().numpy()
        t, l, b, r = geometry.positive_bounding_box(area)
        return v_acts[:, t:b, l:r, :], v_bag, area[t:b, l:r], (t, l, b, r)

    def paste_from_selection(self, imgnum, mask, obj_acts, obj_area):
        """(goal_in, goal_out, viz_out, bounds) of the paste edit; the
        object is blended by its mask."""
        area = self._mask_at(mask, self.v_shape[1:3])
        source_bag, source_acts = self._context_np(imgnum)
        unchanged_bag = self._target(self.params, source_bag)
        unchanged_acts = self.target_acts(unchanged_bag).cpu().numpy()
        target_acts, bounds = geometry.paste_clip_at_center(
            unchanged_acts, obj_acts, geometry.centered_location(area),
            obj_area)
        full_target_acts = target_acts
        if self.tight_paste:
            source_acts, target_acts, source_bounds, target_bounds = (
                geometry.crop_clip_to_bounds(source_acts, target_acts,
                                             bounds))
        else:
            source_bounds, target_bounds = None, None
        goal_in = self.merge_target_output(source_bag, source_acts,
                                           source_bounds)
        goal_out = self.merge_target_output(unchanged_bag, target_acts,
                                            target_bounds)
        viz_out = self.merge_target_output(unchanged_bag, full_target_acts,
                                           None)
        return goal_in, goal_out, viz_out, bounds

    def erase_from_selection(self, imgnum, mask, context_mask_pairs, drank):
        """(goal_in, goal_out) of the erase edit: the goal is the target
        window's output with the top-`drank` normdissect units of the
        context zeroed (reference ganrewrite.py:472-496)."""
        k_area = self._mask_at(mask, self.k_shape[1:3])
        area = self._mask_at(mask, self.v_shape[1:3])
        source_bag, source_acts = self._context_np(imgnum)
        unchanged_bag = self._target(self.params, source_bag)
        d_units = self.normdissect_units(context_mask_pairs,
                                         drank).cpu().numpy()
        erased = source_acts.copy()
        erased[..., d_units] = 0.0
        erased_out = self._target(self.params, self.merge_target_output(
            source_bag, erased, None))
        target_acts = self.target_acts(erased_out).cpu().numpy()
        if self.tight_paste:
            source_bounds = geometry.positive_bounding_box(k_area)
            target_bounds = geometry.positive_bounding_box(area)
        else:
            source_bounds, target_bounds = None, None
        goal_in = self.merge_target_output(source_bag, source_acts,
                                           source_bounds)
        goal_out = self.merge_target_output(unchanged_bag, target_acts,
                                            target_bounds)
        return goal_in, goal_out

    def rgb_from_selection(self, imgnum, mask):
        """The object's pixels cropped to the mask's bounding box: (rgb
        (1,h,w,3), the whole image, area (h,w), bounds)."""
        area = self._mask_at(mask, self.x_shape[1:3])
        x = self.sample_image_from_latent(self.get_z(imgnum)).cpu().numpy()
        t, l, b, r = geometry.positive_bounding_box(area)
        return x[:, t:b, l:r, :], x, area[t:b, l:r], (t, l, b, r)

    def rgbpaste_from_selection(self, imgnum, mask, obj_rgb, obj_area):
        """(z, the image with the object pasted at the mask, bounds)."""
        area = self._mask_at(mask, self.x_shape[1:3])
        source_z = self.get_z(imgnum)
        unchanged = self.sample_image_from_latent(source_z).cpu().numpy()
        changed, bounds = geometry.paste_clip_at_center(
            unchanged, obj_rgb, geometry.centered_location(area), obj_area)
        return source_z, changed, bounds

    # -- context directions ---------------------------------------------------
    def normdissect_units(self, imgnum_mask_pairs, rank) -> torch.Tensor:
        """The `rank` units of largest mask-weighted squared activation
        relative to their mean square over the z dataset (reference
        ganrewrite.py:453-470)."""
        obs, wts = self._gather_masked_obs(imgnum_mask_pairs, keep_all=True)
        sq = self.square_scales_for_units().cpu().numpy()
        score = (obs ** 2) / sq[None, :]
        mean_score = (score * wts).sum(0) / wts.sum()
        return torch.as_tensor(np.argsort(-mean_score)[:rank].copy(),
                               device=self.device)

    def _gather_masked_obs(self, imgnum_mask_pairs, keep_all=False):
        """(pixels, C) context activations and their (pixels, 1) mask
        weights over all selection pairs; only the masked pixels unless
        `keep_all`."""
        all_obs, all_w = [], []
        for imgnum, mask in imgnum_mask_pairs:
            _, k_acts = self._context_np(imgnum)
            area = self._mask_at(mask, self.k_shape[1:3])
            all_obs.append(k_acts.reshape(-1, k_acts.shape[-1]))
            all_w.append(area.reshape(-1, 1))
        obs = np.concatenate(all_obs)
        w = np.concatenate(all_w)
        if keep_all:
            return obs, w
        sel = w[:, 0] > 0
        return obs[sel], w[sel]

    def multi_key_from_selection(self, imgnum_mask_pairs, rank=1,
                                 key_method=None) -> torch.Tensor:
        """The (rank, C) orthonormal context directions D (reference
        ganrewrite.py:333-425).  'zca': whiten the masked keys, take their
        top right-singular vectors, map them back to row space,
        orthonormalize and align their signs with the whitened mean.
        'gandissect': each unit's quantile rank of its activations over
        the selections (``quantiles_for_units``), scored by the
        mask-weighted mean of -log(1 - rank), and the top `rank` units
        one-hot.  'svd'/'mean': each pair's masked keys through the
        ``covariance_adjusted_key`` hook, then their top left-singular
        vectors (the first signed along the mean) or their normalized
        mean (rank 1)."""
        key_method = key_method or self.key_method
        _check_key_method(key_method)
        if key_method == "zca":
            obs, w = self._gather_masked_obs(imgnum_mask_pairs)
            zca_k = self.zca_whitened_query_key(obs).cpu().numpy() * w
            _, _, vh = np.linalg.svd(zca_k, full_matrices=False)
            top_e_vec = vh[:rank].T                          # (C, rank)
            row_dirs = self.zca_whitened_query_key(top_e_vec.T).cpu().numpy()
            just_avg = zca_k.sum(0)
            q, _ = np.linalg.qr(row_dirs.T)                  # (C, rank)
            signs = np.sign((q * just_avg[:, None]).sum(0))
            signs[signs == 0] = 1.0
            return torch.as_tensor((q * signs[None, :]).T, device=self.device)
        if key_method == "gandissect":
            obs, w = self._gather_masked_obs(imgnum_mask_pairs, keep_all=True)
            ranks = self.quantiles_for_units().normalize(obs.T).T
            logscore = -np.log(np.maximum(1.0 - ranks, 1e-20))
            mean_logscore = (logscore * w).sum(0) / w.sum()
            top = np.argsort(-mean_logscore)[:rank]
            result = np.zeros((rank, obs.shape[1]), np.float32)
            result[np.arange(rank), top] = 1.0
            return torch.as_tensor(result, device=self.device)
        adjusted = []
        for imgnum, mask in imgnum_mask_pairs:
            k_bag, k_acts = self._context_np(imgnum)
            area = self._mask_at(mask, self.k_shape[1:3])
            weighted = (k_acts.reshape(-1, k_acts.shape[-1])
                        * area.reshape(-1, 1))
            nonzero = weighted[np.linalg.norm(weighted, axis=1) > 0]
            if len(nonzero):
                adjusted.append(np.asarray(
                    self.covariance_adjusted_key(nonzero, k_bag)))
        all_k = np.concatenate(adjusted)
        just_avg = all_k.mean(0)
        if key_method == "mean":
            if rank != 1:
                raise ValueError("key_method 'mean' gives one direction")
            return torch.as_tensor((just_avg / np.linalg.norm(just_avg))[None],
                                   device=self.device)
        u, _, _ = np.linalg.svd(all_k.T, full_matrices=True)
        if (just_avg * u[:, 0]).sum() < 0:
            u[:, 0] = -u[:, 0]
        return torch.as_tensor(np.ascontiguousarray(u.T[:rank]),
                               device=self.device)

    # -- the weight solves -------------------------------------------------------
    def _commit(self, out):
        """Commit a solve's weight; its losses, with the time if timed."""
        self.set_target_weight(out[0])
        return out[1] if len(out) == 2 else (out[1], out[2])

    def insert(self, goal_in: DataBag, goal_out: DataBag, context,
               update_callback=None, niter=2001, piter=10, lr=0.05,
               return_timing=False):
        """Rank-constrained solve (unconstrained with low_rank_insert off);
        commits the new weight into self.params (reference
        ganrewrite.py:254-298).  The direct Λ·D solve is linear_insert."""
        return self._commit(solve.insert_solve(
            self._window_fn, self.target_weight(), (goal_in, self.params),
            goal_out["fmap"], context, niter=niter, piter=piter, lr=lr,
            low_rank_insert=self.low_rank_insert,
            low_rank_gradient=self.low_rank_gradient,
            update_callback=update_callback, return_timing=return_timing))

    def linear_insert(self, goal_in, goal_out, context, update_callback=None,
                      niter=2001, lr=0.05, return_timing=False):
        """The direct Λ·D solve (reference ganrewrite.py:201-252)."""
        return self._commit(solve.linear_insert_solve(
            self._window_fn, self.target_weight(), (goal_in, self.params),
            goal_out["fmap"], context, niter=niter, lr=lr,
            update_callback=update_callback, return_timing=return_timing))

    def _fast_parts(self, goal_in):
        """(conv_fn, tail_fn, scale, use_demod) of the decomposed solve,
        or None where the window does not start at the linear conv."""
        return None

    def fast_parts_cached(self):
        """_fast_parts, made once per rewriter."""
        if not hasattr(self, "_fast_parts_memo"):
            self._fast_parts_memo = self._fast_parts(None)
        return self._fast_parts_memo

    def fast_linear_insert(self, goal_in, goal_out, context,
                           update_callback=None, niter=2001, lr=0.05,
                           return_timing=False):
        """The Λ·D solve with the window's full conv computed once
        (solve.fast_linear_insert_solve); the direct one where the window
        does not decompose."""
        parts = self.fast_parts_cached()
        if parts is None:
            return self.linear_insert(goal_in, goal_out, context,
                                      update_callback=update_callback,
                                      niter=niter, lr=lr,
                                      return_timing=return_timing)
        conv_fn, tail_fn, scale, use_demod = parts
        return self._commit(solve.fast_linear_insert_solve(
            conv_fn, tail_fn, goal_in, self.params, goal_out["fmap"],
            self.target_weight(), context, scale, niter=niter, lr=lr,
            use_demod=use_demod, update_callback=update_callback,
            return_timing=return_timing))

    def zero(self, context, amount=0.0) -> None:
        """GANdissect's erase: the weight's component along the context
        directions set to `amount` times that of an all-ones weight
        (reference ganrewrite.py:190-199)."""
        w = self.target_weight()
        context = torch.as_tensor(context, dtype=w.dtype, device=w.device)
        ortho = w - solve.projected_conv(w, context)
        self.set_target_weight(
            ortho + amount * solve.projected_conv(torch.ones_like(w),
                                                  context))

    @precision.run_deterministic
    def all_weights_insert(self, x_target, z, bounds=None,
                           update_callback=None, niter: int = 20001,
                           lr: float = 0.01, feature_loss_fn=None,
                           feature_weight: float = 1e-2) -> np.ndarray:
        """The "overfit" baseline (reference ganrewrite.py:300-331): Adam
        on every leaf of the params through the whole pipeline, towards
        the (1, H, W, 3) image `x_target` from latent `z`, by the L1
        distance inside `bounds` (t, l, b, r; the whole image if None),
        plus ``feature_weight`` times the mean squared distance of
        ``feature_loss_fn`` of the two (NHWC) crops when given (the
        reference's VGG16 features).  ``update_callback(step, loss)`` every
        50 steps.  Runs with cuDNN's deterministic algorithms.  Commits the
        new params; returns the per-step losses."""
        x_target = torch.as_tensor(np.asarray(x_target), dtype=torch.float32,
                                   device=self.device)
        bag = self.model.make_bag(torch.as_tensor(z, device=self.device))
        params = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                           self.params)
        if bounds is None:
            gt = x_target
        else:
            t, l, b, r = bounds
            gt = x_target[:, t:b, l:r, :]

        def loss_fn():
            out = _nhwc(self.model.pipeline(params, bag)["output"])
            pred = out if bounds is None else out[:, t:b, l:r, :]
            loss = torch.mean(torch.abs(gt - pred))
            if feature_loss_fn is not None:
                loss = loss + feature_weight * torch.mean(torch.square(
                    feature_loss_fn(gt) - feature_loss_fn(pred)))
            return loss

        opt = torch.optim.Adam([t for _, t in leaves(params)], lr=lr)
        losses = []
        with precision.schedule_suspended():
            for it in range(niter):
                opt.zero_grad(set_to_none=True)
                loss = loss_fn()
                loss.backward()
                opt.step()
                losses.append(loss.detach())
                if update_callback is not None and it % 50 == 0:
                    update_callback(it, losses[-1])
        self.params = tree_map(lambda t: t.detach(), params)
        return torch.stack(losses).cpu().numpy()

    # -- edit-request entry points -------------------------------------------
    @precision.run_deterministic
    def apply_edit(self, request, rank=1, niter=2001, piter=10, lr=0.05,
                   update_callback=None, single_key: int = -1,
                   return_timing=False):
        """Apply a UI-format JSON edit request; returns the solve's
        per-step losses.  With ``single_key >= 0`` only that key example
        of the request shapes the context direction."""
        o_imgnum, o_mask = request["object"]
        p_imgnum, p_mask = request["paste"]
        key_examples = request.get("key", [(p_imgnum, p_mask)])
        if single_key >= 0:
            key_examples = [key_examples[single_key]]
        obj_acts, _, obj_area, _ = self.object_from_selection(o_imgnum,
                                                              o_mask)
        goal_in, goal_out, _, _ = self.paste_from_selection(
            p_imgnum, p_mask, obj_acts, obj_area)
        mkey = self.multi_key_from_selection(key_examples, rank=rank)
        return self.insert(goal_in, goal_out, mkey,
                           update_callback=update_callback, niter=niter,
                           piter=piter, lr=lr, return_timing=return_timing)

    @precision.run_deterministic
    def apply_erase(self, request, rank=1, drank=30, niter=2001, piter=10,
                    lr=0.05, update_callback=None):
        """Erase the request's paste region: zero its top-`drank` context
        units in the goal and solve (reference ganrewrite.py:135-146);
        returns the losses."""
        p_imgnum, p_mask = request["paste"]
        key_examples = request.get("key", [(p_imgnum, p_mask)])
        goal_in, goal_out = self.erase_from_selection(
            p_imgnum, p_mask, key_examples, drank)
        mkey = self.multi_key_from_selection(key_examples, rank=rank)
        return self.insert(goal_in, goal_out, mkey,
                           update_callback=update_callback, niter=niter,
                           piter=piter, lr=lr)

    @precision.run_deterministic
    def apply_overfit(self, request, niter: int = 20001, lr: float = 0.01,
                      update_callback=None, feature_loss_fn=None
                      ) -> np.ndarray:
        """The overfit baseline on a UI request: the object's pixels
        pasted at the paste mask, then ``all_weights_insert`` towards that
        image inside the pasted box (reference ganrewrite.py:171-181);
        returns the losses.  The target image's forwards run with cuDNN's
        deterministic algorithms too, as ``apply_edit``'s goals do."""
        o_imgnum, o_mask = request["object"]
        p_imgnum, p_mask = request["paste"]
        rgb_clip, _, obj_area, _ = self.rgb_from_selection(o_imgnum, o_mask)
        host_z, changed_rgb, bounds = self.rgbpaste_from_selection(
            p_imgnum, p_mask, rgb_clip, obj_area)
        return self.all_weights_insert(changed_rgb, host_z, bounds=bounds,
                                       update_callback=update_callback,
                                       niter=niter, lr=lr,
                                       feature_loss_fn=feature_loss_fn)

    # -- renders: uint8 (H, W, 3) arrays ---------------------------------------
    def render_object(self, target_bag, box=None) -> np.ndarray:
        """Render a target bag; `box` (t, l, b, r in target-map
        coordinates) is outlined in red (reference ganrewrite.py:596-608).
        """
        img = self.rendered_image(self._render(self.params,
                                               target_bag)).cpu().numpy()
        if box is None:
            return renormalize.as_image(img[0])
        t, l, b, r = box
        lowres = np.zeros(self.v_shape[1:3], np.float32)
        lowres[t:b, l:r] = 1.0
        iv = imgviz.ImageVisualizer(img.shape[1:3])
        return iv.masked_image(img[0], mask=lowres, border_color=(255, 0, 0),
                               thickness=3, outside_bright=1.0)

    def render_image(self, imgnum) -> np.ndarray:
        img = self.sample_image_from_latent(self.get_z(imgnum)).cpu().numpy()
        return renormalize.as_image(img[0])

    def render_image_batch(self, imgnums, key=None, level=None,
                           batch_size=8, **kwargs):
        """Renders of the images; with (key, level), each with the key's
        response thresholded at `level` outlined, the UI's search
        highlight (reference ganrewrite.py:626-650)."""
        out = []
        iv = None
        if key is not None and level is not None:
            key = torch.as_tensor(key, dtype=torch.float32,
                                  device=self.device)
            iv = imgviz.ImageVisualizer(self.x_shape[1:3])
        for i in range(0, len(imgnums), batch_size):
            zb = np.stack([self.zds[j] for j in imgnums[i:i + batch_size]])
            imgs = self.sample_image_from_latent(zb).cpu().numpy()
            if iv is None:
                out.extend(renormalize.as_image(im) for im in imgs)
                continue
            acts = self.context_acts(self._context(
                self.params, self.model.make_bag(zb)))
            heat = torch.sum(acts * key, dim=-1).cpu().numpy()
            out.extend(iv.masked_image(im, activations=heat[j],
                                       level=float(level), **kwargs)
                       for j, im in enumerate(imgs))
        return out


class ProgressiveGanRewriter(GanRewriter):
    """Edit window = the bare conv of a ProgGAN block (reference
    ganrewrite.py:78-81)."""

    def maplayers(self, layernum):
        name = f"layer{layernum}.conv"
        return name, name

    def _fast_parts(self, goal_in):
        """The block's conv at its padding, nothing after it, scale 1 and
        no demodulation."""
        padding = self.model._conv_specs[self.firstlayer[:-len(".conv")]][3]

        def conv_fn(x, w, groups=1):
            return conv2d_grouped(x, w, padding, groups)

        def tail_fn(params, bag):
            return bag  # the window is the bare conv
        return conv_fn, tail_fn, 1.0, False


class SeqStyleGanRewriter(GanRewriter):
    """Edit window = dconv .. activate of one StyleGAN2 layer
    (reference ganrewrite.py:662-665)."""

    def maplayers(self, layernum):
        prefix = "conv" if layernum == 2 else "sconv"
        return (f"layer{layernum}.{prefix}.mconv.dconv",
                f"layer{layernum}.{prefix}.activate")

    def _fast_parts(self, goal_in):
        """The window's bare conv (``F.conv_transpose2d`` at an upsampling
        layer, ``F.conv2d`` otherwise; grouped with ``groups``) and the
        stages after it; demod on."""
        spec = self.model._param_specs.get(self.firstlayer)
        if spec is None or spec[0] != "dconv":
            return None      # the window starts before the linear conv
        _, in_c, _, k, upsample = spec
        scale = 1.0 / math.sqrt(in_c * k * k)

        def conv_fn(x, w, groups=1):
            return modconv_linear(x, w, upsample, k, groups)

        if self.firstlayer == self.lastlayer:
            def tail_fn(params, bag):
                return bag
        else:
            tail_fn = self.model.pipeline.subsequence(
                after_layer=self.firstlayer, last_layer=self.lastlayer)
        return conv_fn, tail_fn, scale, True

    def sample_image_patch(self, z, act_crop_size: int, seed=(None, None)
                           ) -> torch.Tensor:
        """(B, h, w, 3) image patch rendered from an `act_crop_size`
        square crop of the window's input, at `seed` (row, column) or a
        random place (reference ganrewrite.py:667-698)."""
        bag = self._context(self.params, self.model.make_bag(z))
        h, w = bag["fmap"].shape[2:4]
        if act_crop_size > h:
            raise ValueError(f"crop {act_crop_size} > map {h}")
        if seed[0] is not None:
            xi, yi = seed
        else:
            xi = random.randint(0, h - act_crop_size)
            yi = random.randint(0, w - act_crop_size)
        cropped = _patched_bag(bag, xi, yi, act_crop_size)
        return self.rendered_image(self._render(
            self.params, self._target(self.params, cropped)))


def _patched_bag(bag: DataBag, xi, yi, size) -> DataBag:
    """The bag with its NCHW feature map cropped to the square at (xi,
    yi), and its rgb output to the same place (2x larger where the output
    is at twice the map's resolution)."""
    new = DataBag(bag)
    fmap = bag["fmap"]
    new["fmap"] = fmap[:, :, xi:xi + size, yi:yi + size]
    if "output" in bag:
        out = bag["output"]
        f = 1 if out.shape[2:4] == fmap.shape[2:4] else 2
        new["output"] = out[:, :, f * xi:f * (xi + size),
                            f * yi:f * (yi + size)]
    return new


class SeqTinyStyleGanRewriter(SeqStyleGanRewriter):
    """Edit window = the dconv alone: no nonlinearity in the target
    (reference ganrewrite.py:732-739)."""

    def maplayers(self, layernum):
        prefix = "conv" if layernum == 2 else "sconv"
        name = f"layer{layernum}.{prefix}.mconv.dconv"
        return name, name


class SeqPreStyleGanRewriter(SeqStyleGanRewriter):
    """Edit window = adain .. activate: the style modulation is inside the
    window, so the keys are adjusted by C·diag(style) (reference
    ganrewrite.py:742-760).  The rewritten weight is the dconv's."""

    def maplayers(self, layernum):
        prefix = "conv" if layernum == 2 else "sconv"
        return (f"layer{layernum}.{prefix}.mconv.adain",
                f"layer{layernum}.{prefix}.activate")

    def weight_stage(self) -> str:
        return self.firstlayer.replace(".adain", ".dconv")

    def covariance_adjusted_key(self, k, kout_bag) -> np.ndarray:
        """(C·diag(style))^{-1} k, with the style of this selection's bag,
        in float64 on the host."""
        style = kout_bag["style"][0].detach().cpu().numpy()
        cs = self.c_matrix.detach().cpu().numpy() * style[None, :]
        kk = np.asarray(k, np.float64)
        single = kk.ndim == 1
        x = np.linalg.solve(cs.astype(np.float64),
                            kk[:, None] if single else kk.T)
        return (x[:, 0] if single else x.T).astype(np.float32)

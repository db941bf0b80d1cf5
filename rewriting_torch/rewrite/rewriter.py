"""The rewriting engine: treat one conv layer as a linear associative
memory and rewrite it with a rank-constrained weight edit.

Counterpart of the JAX package's ``rewrite/rewriter.py`` ``GanRewriter``
(:42-694) and ``SeqStyleGanRewriter`` (:718), cut to this port's edit
loop: the three-way split, the shape probe, the key second moment and its
ZCA, the ``zca`` context direction, the pasted goal (tight or whole-map),
the Adam solve with its projection (or without, ``low_rank_insert=False``),
one key of a request (``single_key``), and revert.

The generator splits into context / target / rendering sub-pipelines by
stage name; all three read the one params dict, so an edit is a new weight
in ``self.params`` and ``original_params`` keeps the pristine tree.  Edit
requests are the UI's JSON: ``{"object": [imgnum, mask_url], "paste":
[imgnum, mask_url], "key": [[imgnum, mask_url], ...]}``.

Layout: the model runs NCHW; the public accessors (``context_acts``,
``target_acts``, ``rendered_image``, ``k_shape``/``v_shape``/``x_shape``
and the arrays of ``object_from_selection``) are NHWC like the JAX
package's, and masks and geometry index the activations through them.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core import DataBag
from ..models.stylegan2 import params_to
from ..ops import precision
from ..stats import running, tally
from ..utils import renormalize
from ..utils.device import resolve_device
from . import geometry, solve


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class GanRewriter:
    """Rewriter over a stage-pipeline generator; subclasses pick the edit
    window with :meth:`maplayers`.  `model` provides ``pipeline``,
    ``make_bag(z)``, ``z_dim`` and ``device``.  Runs on ``device`` (default
    ``cuda``), which must be the model's."""

    def __init__(self, model, params, zds, layernum,
                 cachedir: Optional[str] = None,
                 low_rank_insert: bool = True,
                 tight_paste: bool = True,
                 key_method: str = "zca",
                 stats_batch_size: int = 10,
                 device=None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, rewriter asked "
                             f"for {self.device}")
        if key_method != "zca":
            raise NotImplementedError(
                f"key_method {key_method!r}: only 'zca' is ported")
        precision.apply_parity_tier()
        self.model = model
        self.zds = zds
        self.cachedir = cachedir
        self.low_rank_insert = low_rank_insert
        self.tight_paste = tight_paste
        self.key_method = key_method
        self.stats_batch_size = stats_batch_size

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

    # -- the three sub-pipelines, without autograd ---------------------------
    @torch.no_grad()
    def _context(self, params, bag: DataBag) -> DataBag:
        return self.context_pipe(params, bag)

    @torch.no_grad()
    def _target(self, params, bag: DataBag) -> DataBag:
        return self.target_pipe(params, bag)

    @torch.no_grad()
    def _render(self, params, bag: DataBag) -> DataBag:
        return self.rendering_pipe(params, bag)

    def _window_fn(self, w, goal):
        """The target window's output with `w` as the edited weight."""
        bag, p = goal
        p = dict(p)
        p[self.firstlayer] = {**p[self.firstlayer], "weight": w}
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

    def target_weight(self) -> torch.Tensor:
        return self.params[self.firstlayer]["weight"]

    def set_target_weight(self, w: torch.Tensor) -> None:
        self.params = dict(self.params)
        self.params[self.firstlayer] = {**self.params[self.firstlayer],
                                        "weight": w}

    def revert(self) -> None:
        """Restore the pristine weights."""
        self.params = dict(self.original_params)

    def rf(self, fn: str) -> Optional[str]:
        return None if self.cachedir is None else os.path.join(self.cachedir,
                                                               fn)

    # -- statistics -------------------------------------------------------------
    def collect_2nd_moment(self) -> torch.Tensor:
        """Uncentered second moment C = E[k kᵀ] of the context keys over
        the z dataset; npz-cached in the JAX package's format."""
        cachefile = self.rf("r2m.npz")
        args = {"sample_size": len(self.zds), "layer": self.firstlayer}
        cached = tally.load_cached_state(cachefile, args)
        if cached is not None:
            r = running.RunningSecondMoment.from_state_dict(cached,
                                                            self.device)
        else:
            def rows(zbatch):
                acts = self.context_acts(self._context(
                    self.params, self.model.make_bag(zbatch)))
                return acts.reshape(-1, acts.shape[-1])
            with precision.schedule_suspended():
                r = tally.tally_second_moment(rows, self.zds.zs,
                                              self.stats_batch_size,
                                              self.device)
            tally.save_cached_state(cachefile, r, args)
        return r.moment()

    def covariance_adjusted_query_key(self, k) -> np.ndarray:
        """C^{-1} k."""
        return solve.solve_spd(self.c_matrix, k)

    def zca_whitened_query_key(self, k) -> torch.Tensor:
        """C^{-1/2} k; rows in, rows out (the ZCA matrix is symmetric)."""
        k = torch.as_tensor(k, dtype=torch.float32, device=self.device)
        if k.dim() == 1:
            return self.zca_matrix @ k
        return k @ self.zca_matrix

    # -- selections (masks -> activations) ---------------------------------------
    def _mask_at(self, mask_url, shape) -> np.ndarray:
        """The mask decoded at a feature map's (H, W)."""
        return renormalize.mask_from_url(mask_url, size=tuple(shape))

    def object_from_selection(self, imgnum, mask):
        """The copied object's target activations, cropped to the mask's
        bounding box: (acts (1,h,w,C), target bag, area (h,w), bounds)."""
        area = self._mask_at(mask, self.v_shape[1:3])
        v_bag = self._target(self.params, self.context_of(imgnum))
        v_acts = self.target_acts(v_bag).cpu().numpy()
        t, l, b, r = geometry.positive_bounding_box(area)
        return v_acts[:, t:b, l:r, :], v_bag, area[t:b, l:r], (t, l, b, r)

    def paste_from_selection(self, imgnum, mask, obj_acts, obj_area):
        """(goal_in, goal_out, viz_out, bounds) of the paste edit."""
        area = self._mask_at(mask, self.v_shape[1:3])
        source_bag = self.context_of(imgnum)
        source_acts = self.context_acts(source_bag).cpu().numpy()
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

    # -- context directions ---------------------------------------------------
    def _gather_masked_obs(self, imgnum_mask_pairs):
        """(pixels, C) context activations under the masks and their
        (pixels, 1) mask weights, over all selection pairs."""
        all_obs, all_w = [], []
        for imgnum, mask in imgnum_mask_pairs:
            k_acts = self.context_acts(self.context_of(imgnum)).cpu().numpy()
            area = self._mask_at(mask, self.k_shape[1:3])
            all_obs.append(k_acts.reshape(-1, k_acts.shape[-1]))
            all_w.append(area.reshape(-1, 1))
        obs = np.concatenate(all_obs)
        w = np.concatenate(all_w)
        sel = w[:, 0] > 0
        return obs[sel], w[sel]

    def multi_key_from_selection(self, imgnum_mask_pairs, rank=1
                                 ) -> torch.Tensor:
        """The (rank, C) orthonormal context directions D of the 'zca'
        method: whiten the masked keys, take their top right-singular
        vectors, map them back to row space, orthonormalize and align
        their signs with the whitened mean (reference ganrewrite.py:
        333-425)."""
        obs, w = self._gather_masked_obs(imgnum_mask_pairs)
        zca_k = self.zca_whitened_query_key(obs).cpu().numpy() * w
        _, _, vh = np.linalg.svd(zca_k, full_matrices=False)
        top_e_vec = vh[:rank].T                              # (C, rank)
        row_dirs = self.zca_whitened_query_key(top_e_vec.T).cpu().numpy()
        just_avg = zca_k.sum(0)
        q, _ = np.linalg.qr(row_dirs.T)                      # (C, rank)
        signs = np.sign((q * just_avg[:, None]).sum(0))
        signs[signs == 0] = 1.0
        return torch.as_tensor((q * signs[None, :]).T, device=self.device)

    # -- the weight solve -------------------------------------------------------
    def insert(self, goal_in: DataBag, goal_out: DataBag, context,
               niter=2001, piter=10, lr=0.05) -> np.ndarray:
        """Rank-constrained solve (unconstrained with low_rank_insert off);
        commits the new weight into self.params and returns the per-step
        losses."""
        w, losses = solve.insert_solve(
            self._window_fn, self.target_weight(), (goal_in, self.params),
            goal_out["fmap"], context, niter=niter, piter=piter, lr=lr,
            low_rank_insert=self.low_rank_insert)
        self.set_target_weight(w)
        return losses

    def apply_edit(self, request, rank=1, niter=2001, piter=10, lr=0.05,
                   single_key: int = -1) -> np.ndarray:
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
        return self.insert(goal_in, goal_out, mkey, niter=niter,
                           piter=piter, lr=lr)


class SeqStyleGanRewriter(GanRewriter):
    """Edit window = dconv .. activate of one StyleGAN2 layer
    (reference ganrewrite.py:662-665)."""

    def maplayers(self, layernum):
        prefix = "conv" if layernum == 2 else "sconv"
        return (f"layer{layernum}.{prefix}.mconv.dconv",
                f"layer{layernum}.{prefix}.activate")

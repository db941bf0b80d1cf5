"""Neural Best Buddies baseline: sparse cross-image correspondences,
MLS warping and Poisson blending.

Counterpart of the JAX package's ``baselines/nbb.py``, the paper's
copy-paste comparison method (the reference's vendored
baselines/neural_best_buddies: algorithms/neural_best_buddies.py, MLS
warp util/MLS.py, poisson blending pyflow/poisson_image_editing.py).
The correspondence engine follows the reference algorithm step for step,
on tensors on the device:

1. a 5-level feature pyramid per image (by default the LPIPS VGG16 taps
   of ``metrics/lpips.py``, on the device),
2. at the coarsest level, patch-correlation nearest-neighbour mappings in
   both directions (reference find_mapping, neural_best_buddies.py:27-63)
   and their cycle-consistent pairs, the "best buddies" (:157-172),
3. coarse-to-fine refinement: each surviving pair's children are the
   finer level's buddies inside its x2-upsampled receptive fields
   (:147-153, :174-178), searched on *common-appearance* features (each
   image's own features averaged with the other's warped and
   reconstructed ones: transfer_style_local :335-349, warp :65-76,
   warp_to_mid :78-92); all parents at once, in bounded chunks,
4. responses accumulated across levels (:195-204), pairs under the
   normalized-response threshold tau dropped (:222-235), and the
   spatially spread top k picked by k-means in (ya, xa, yb, xb) space
   (:303-325; on the host),
5. a moving-least-squares warp and a Poisson blend (host numpy, scipy
   sparse).

The order of every result is the reference's: candidates scanned
row-major with the first maximum winning, parents in reverse order,
children in row-major order, the first occurrence of a point kept.  The
entry points (``default_feature_pyramid``, ``mutual_nearest_neighbors``,
``sparse_correspondence``, ``neural_best_buddies``, ``nbb_paste``) run
on `device` (default ``cuda``); the primitives run where their tensors
are.  No TPU kernel covered any of it, so no kernel of the port's own
runs here.
"""

from __future__ import annotations

import inspect
import math
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device

# per level L (1-indexed, L=1 finest): square patch side and search radius
# (reference patch_size_list / search_box_radius_list, :21-22)
PATCH_SIZES = (5, 5, 3, 3, 3)
SEARCH_RADII = (3, 3, 2, 2, 2)

# bytes of one gathered block of B patches in find_mapping, and parent x
# box candidates a chunk of the refinement: bounds on transient memory
_GATHER_BYTES = 1 << 29
_REFINE_CANDIDATES = 1 << 24

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def _as_tensor(x, device) -> torch.Tensor:
    """An fp32 tensor on `device` of an array or a tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)


def _clock(device: torch.device) -> float:
    """Host seconds after the device's queued work is done."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


# ---------------------------------------------------------------------------
# features
# ---------------------------------------------------------------------------

def _vgg_pyramid(net, images, device) -> List[torch.Tensor]:
    x = _as_tensor(images, device).permute(0, 3, 1, 2)
    with torch.no_grad():
        taps = net.taps((x - net.shift) / net.scale)
    if len(taps) < len(PATCH_SIZES):
        raise ValueError(
            f"images of {x.shape[2]}x{x.shape[3]} pixels are too small for "
            f"NBB's {len(PATCH_SIZES)}-level VGG16 pyramid: relu5_3's map is "
            "empty under 16 pixels a side")
    return [t.permute(0, 2, 3, 1).contiguous() for t in taps]


def default_feature_pyramid(images, device=None) -> List[torch.Tensor]:
    """(B, H, W, 3) zc images -> the five NHWC VGG16 tap maps, fine to
    coarse, on `device` (default ``cuda``), from ``lpips.init_params(0)``:
    seeded stand-ins for the published weights (random weights still give
    meaningful correlation structure; pass a `feature_fn` built on
    converted weights for the real method).  Images under 16 pixels a side
    leave relu5_3's map empty: ValueError."""
    from ..metrics.lpips import LPIPS
    dev = resolve_device(device)
    return _vgg_pyramid(LPIPS(device=dev), images, dev)


def _normalize_feats(f: torch.Tensor) -> torch.Tensor:
    flat = f.reshape(-1, f.shape[-1])
    return flat / (torch.linalg.vector_norm(flat, dim=1, keepdim=True)
                   + 1e-10)


def mutual_nearest_neighbors(fa, fb, device=None) -> List[Tuple[int, int]]:
    """Best buddies between (H, W, C) feature maps: pairs (ia, ib) of flat
    indices that are each other's nearest neighbour under cosine
    similarity, on `device` (default ``cuda``)."""
    dev = resolve_device(device)
    sim = _normalize_feats(_as_tensor(fa, dev)) @ _normalize_feats(
        _as_tensor(fb, dev)).T
    a2b = sim.argmax(dim=1).cpu().numpy()
    b2a = sim.argmax(dim=0).cpu().numpy()
    return [(ia, int(ib)) for ia, ib in enumerate(a2b) if b2a[ib] == ia]


# ---------------------------------------------------------------------------
# the reference algorithm's primitives (neural_best_buddies.py), on tensors
# ---------------------------------------------------------------------------

def normalize_per_pix(F: torch.Tensor) -> torch.Tensor:
    """Unit-norm the channel vector at every spatial position
    (reference feature_metric.normalize_per_pix)."""
    n = torch.sqrt((F * F).sum(-1, keepdim=True))
    return F / torch.clamp(n, min=1e-12)


def _stretch01(x: torch.Tensor) -> torch.Tensor:
    """Min-max normalize to [0, 1]; constant maps -> 0
    (reference feature_metric.stretch_tensor_0_to_1)."""
    lo, hi = x.min(), x.max()
    if bool(hi == lo):
        return torch.zeros_like(x)
    return (x - lo) / (hi - lo)


def response_l2(F: torch.Tensor) -> torch.Tensor:
    """sqrt(sum_c F^2): the per-position activation response used for
    ranking pairs (reference feature_metric.response, style='l2')."""
    return torch.sqrt((F * F).sum(-1))


def get_M(F: torch.Tensor, tau: float = 0.05) -> torch.Tensor:
    """Boolean high-activation mask: normalized SQUARED response >= tau
    (reference get_M, neural_best_buddies.py:117-123 — note it uses the
    squared response, unlike the l2 response used for ranking)."""
    return _stretch01((F * F).sum(-1)) >= tau


def identity_map(h: int, w: int, device="cpu") -> torch.Tensor:
    """(H, W, 2) int64 map of own coordinates (reference identity_map)."""
    yy, xx = torch.meshgrid(torch.arange(h, device=device),
                            torch.arange(w, device=device), indexing="ij")
    return torch.stack([yy, xx], dim=-1)


def _fit_index(src: int, dst: int) -> np.ndarray:
    return np.minimum((np.arange(dst) * src) // dst, src - 1)


def _fit_shape(arr, shape):
    """Nearest index-resize of the leading two axes to (H, W), of a tensor
    or a numpy array."""
    th, tw = shape
    sh, sw = arr.shape[:2]
    if (sh, sw) == (th, tw):
        return arr
    yi, xi = _fit_index(sh, th), _fit_index(sw, tw)
    if isinstance(arr, torch.Tensor):
        yi = torch.as_tensor(yi, device=arr.device)
        xi = torch.as_tensor(xi, device=arr.device)
    return arr[yi][:, xi]


def upsample_mapping(mapping: torch.Tensor, factor: int = 2,
                     shape=None) -> torch.Tensor:
    """Nearest-upsample a (H, W, 2) coordinate map, scaling the stored
    coordinates (reference upsample_mapping, :113-115).

    `shape` gives the target (H, W) for pyramids whose levels are not
    exact 2x halvings (odd sizes floor-halve through the extractor's
    pools): the grid is index-resized and the coordinates scale by the
    true per-axis ratio, rounded half to even in float64 on the host.
    When shape IS the exact factor-multiple, this is the reference path."""
    sh, sw = mapping.shape[:2]
    if shape is None or tuple(shape) == (factor * sh, factor * sw):
        m = factor * mapping
        return m.repeat_interleave(factor, 0).repeat_interleave(factor, 1)
    th, tw = shape
    m = _fit_shape(mapping.cpu().numpy(), shape).astype(np.float64)
    cy = np.clip(np.rint(m[..., 0] * (th / sh)), 0, th - 1)
    cx = np.clip(np.rint(m[..., 1] * (tw / sw)), 0, tw - 1)
    return torch.as_tensor(np.stack([cy, cx], axis=-1).astype(np.int64),
                           device=mapping.device)


def _reflect_index(n: int, d: int) -> np.ndarray:
    """Source indices of numpy's ``np.pad(mode="reflect")`` by d a side
    (a length-1 axis repeats its one entry)."""
    if n == 0:
        raise ValueError("can't reflect-pad an empty feature map")
    i = np.arange(-d, n + d)
    if n == 1:
        return np.zeros_like(i)
    period = 2 * (n - 1)
    i = np.mod(i, period)
    return np.where(i > n - 1, period - i, i)


def _reflect_pad(F: torch.Tensor, d: int) -> torch.Tensor:
    """(H, W, C) -> (H + 2d, W + 2d, C), reflected as ``np.pad``."""
    h, w = F.shape[:2]
    iy = torch.as_tensor(_reflect_index(h, d), device=F.device)
    ix = torch.as_tensor(_reflect_index(w, d), device=F.device)
    return F.index_select(0, iy).index_select(1, ix)


def _scan(A: torch.Tensor, B: torch.Tensor, patch: int,
          initial_mapping: torch.Tensor, radius: int):
    """Yield (score, cy, cx) for each search-box candidate in row-major
    (dy, dx) order: the (H, W) patch correlations of A's patches with B's
    patches at the candidate (cy, cx), -inf where the candidate lies
    outside B.  Each score adds the patch offsets' dot products in
    row-major (u, v) order; the offsets are gathered in blocks of at most
    ``_GATHER_BYTES``."""
    h, w, c = A.shape
    d = patch // 2
    Ap = _reflect_pad(A, d)
    Bp = _reflect_pad(B, d)
    wp = w + 2 * d
    Bflat = Bp.reshape(-1, c)
    offsets = [(u, v) for u in range(patch) for v in range(patch)]
    per = max(1, _GATHER_BYTES // max(1, h * w * c * A.element_size()))
    blocks = []
    for i in range(0, len(offsets), per):
        block = offsets[i:i + per]
        a = torch.stack([Ap[u:u + h, v:v + w] for u, v in block])
        shift = torch.as_tensor([u * wp + v for u, v in block],
                                device=A.device)[:, None, None]
        blocks.append((a, shift))
    iy = initial_mapping[..., 0].long()
    ix = initial_mapping[..., 1].long()
    for dy in range(-radius, radius + 1):
        cy = iy + dy
        vy = (cy >= 0) & (cy < h)
        cyc = cy.clamp(0, h - 1)
        for dx in range(-radius, radius + 1):
            cx = ix + dx
            valid = vy & (cx >= 0) & (cx < w)
            cxc = cx.clamp(0, w - 1)
            base = (cyc * wp + cxc)[None]
            score = torch.zeros((h, w), dtype=A.dtype, device=A.device)
            for a, shift in blocks:
                s = (a * Bflat[base + shift]).sum(-1)
                for k in range(len(s)):
                    score = score + s[k]
            yield (torch.where(valid, score, torch.full_like(score,
                                                             -math.inf)),
                   cyc, cxc)


def find_mapping(A: torch.Tensor, B: torch.Tensor, patch: int,
                 initial_mapping: torch.Tensor, radius: int) -> torch.Tensor:
    """Per-position nearest-neighbour map A -> B by patch correlation
    within a search box around the initial mapping (reference
    find_mapping/find_closest_patch_index, :27-63).

    A/B are (H, W, C) per-pixel-normalized features; returns (H, W, 2)
    int64 coordinates into B.  Every position at once, candidate by
    candidate; the candidate scan order (row-major, strict >, so the first
    maximum wins) is the reference's torch.max tie-breaking."""
    h, w = A.shape[:2]
    best = torch.full((h, w), -math.inf, dtype=A.dtype, device=A.device)
    by = torch.zeros((h, w), dtype=torch.int64, device=A.device)
    bx = torch.zeros_like(by)
    for score, cy, cx in _scan(A, B, patch, initial_mapping, radius):
        take = score > best
        best = torch.where(take, score, best)
        by = torch.where(take, cy, by)
        bx = torch.where(take, cx, bx)
    return torch.stack([by, bx], dim=-1)


def mapping_margin(A: torch.Tensor, B: torch.Tensor, patch: int,
                   initial_mapping: torch.Tensor, radius: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(best score, best minus second-best score) of ``find_mapping``'s
    candidates at every position, in A's dtype: where the margin is
    within rounding of 0, two orders of summation may pick different
    candidates (checks of two devices or packages use it)."""
    h, w = A.shape[:2]
    top = torch.full((h, w), -math.inf, dtype=A.dtype, device=A.device)
    second = top.clone()
    for score, _, _ in _scan(A, B, patch, initial_mapping, radius):
        second = torch.maximum(second, torch.minimum(score, top))
        top = torch.maximum(top, score)
    return top, top - second


def find_best_buddies(a_to_b: torch.Tensor, b_to_a: torch.Tensor,
                      box_a=None, box_b=None):
    """Cycle-consistent pairs: positions whose forward map maps straight
    back (reference find_best_buddies, :157-172).  Optional [top_left,
    bottom_right) boxes restrict the a positions and the mapped b
    positions.  Returns (pts_a, pts_b) int64 tensors of shape (n, 2) in
    row-major scan order."""
    h, w = a_to_b.shape[:2]
    my, mx = a_to_b[..., 0], a_to_b[..., 1]
    back = b_to_a[my, mx]
    yy, xx = identity_map(h, w, a_to_b.device).unbind(-1)
    cyc = (back[..., 0] == yy) & (back[..., 1] == xx)
    if box_a is not None:
        (t1, b1) = box_a
        cyc &= (yy >= t1[0]) & (yy < b1[0]) & (xx >= t1[1]) & (xx < b1[1])
    if box_b is not None:
        (t2, b2) = box_b
        cyc &= (my >= t2[0]) & (my < b2[0]) & (mx >= t2[1]) & (mx < b2[1])
    ys, xs = torch.nonzero(cyc, as_tuple=True)
    pts_a = torch.stack([ys, xs], dim=-1)
    pts_b = torch.stack([my[ys, xs], mx[ys, xs]], dim=-1)
    return pts_a, pts_b


def extract_receptive_field(y: int, x: int, radius: int, shape):
    """The x2-upsampled receptive field of a coarse position, as a
    [top_left, bottom_right) box (reference extract_receptive_field)."""
    cy, cx = 2 * y, 2 * x
    return ([max(cy - radius, 0), max(cx - radius, 0)],
            [min(cy + radius + 1, shape[0]), min(cx + radius + 1, shape[1])])


def warp(B: torch.Tensor, patch: int, mapping: torch.Tensor) -> torch.Tensor:
    """Patch-average warp of B into the mapping's source frame: every
    output patch accumulates the B patch its center maps to, then
    normalizes by coverage (reference warp, :65-76)."""
    return _patch_average(B, None, patch, mapping)


def warp_to_mid(B: torch.Tensor, A: torch.Tensor, patch: int,
                mapping: torch.Tensor) -> torch.Tensor:
    """Common-appearance midpoint warp: like warp() but each accumulated
    patch is the average of A's own patch and the mapped B patch
    (reference warp_to_mid, :78-92)."""
    return _patch_average(B, A, patch, mapping)


def _patch_average(B, A, patch, mapping):
    h, w, c = B.shape
    d = patch // 2
    wp = w + 2 * d
    Bflat = _reflect_pad(B, d).reshape(-1, c)
    Ap = None if A is None else _reflect_pad(A, d)
    acc = torch.zeros((h + 2 * d, wp, c), dtype=B.dtype, device=B.device)
    cnt = torch.zeros((h + 2 * d, wp, 1), dtype=B.dtype, device=B.device)
    base = mapping[..., 0].long() * wp + mapping[..., 1].long()
    for u in range(patch):
        for v in range(patch):
            src = Bflat[base + (u * wp + v)]
            if Ap is not None:
                src = 0.5 * (Ap[u:u + h, v:v + w] + src)
            acc[u:u + h, v:v + w] += src
            cnt[u:u + h, v:v + w] += 1
    return (acc / cnt)[d:d + h, d:d + w]


# ---------------------------------------------------------------------------
# k-means top-k (host)
# ---------------------------------------------------------------------------

def _kmeans_labels(feats: np.ndarray, k: int, iters: int = 50) -> np.ndarray:
    """Deterministic Lloyd's k-means: first point + farthest-point init,
    fixed iteration cap.  Fallback when scikit-learn is absent."""
    n = len(feats)
    centers = [feats[0]]
    for _ in range(1, k):
        d2 = np.min([((feats - c) ** 2).sum(1) for c in centers], axis=0)
        centers.append(feats[int(np.argmax(d2))])
    centers = np.stack(centers)
    labels = np.full(n, -1, np.int64)
    for _ in range(iters):
        d2 = ((feats[:, None, :] - centers[None]) ** 2).sum(-1)
        new_labels = d2.argmin(1)
        if (new_labels == labels).all():
            break
        labels = new_labels
        for i in range(k):
            sel = feats[labels == i]
            if len(sel):
                centers[i] = sel.mean(0)
    return labels


def _top_k_keep(pts_a: np.ndarray, pts_b: np.ndarray, resp: np.ndarray,
                k: int) -> Optional[np.ndarray]:
    """Indices of ``top_k_in_clusters``'s pick, None to keep every pair."""
    n = len(pts_a)
    # strict >: with k == n the reference still runs k-means, which
    # REORDERS the pairs by cluster index — and downstream per-parent
    # refinement + first-max tie-breaks depend on that order (:304-305)
    if k > n:
        return None
    feats = np.concatenate([np.asarray(pts_a, np.float64),
                            np.asarray(pts_b, np.float64)], axis=1)
    try:
        from sklearn.cluster import KMeans
        labels = KMeans(n_clusters=k, random_state=0).fit(feats).labels_
    except ImportError:
        # sklearn is optional: a deterministic Lloyd fallback (farthest-
        # point init) keeps the spread-selection heuristic working; exact
        # cluster boundaries may differ from the reference's sklearn
        # k-means
        labels = _kmeans_labels(feats, k)
    keep = []
    for i in range(k):
        # the first pair of the cluster's largest positive response
        cand = np.nonzero((labels == i) & (resp > 0.0))[0]
        if len(cand):
            keep.append(cand[int(np.argmax(resp[cand]))])
    return np.asarray(keep, np.int64)


def top_k_in_clusters(pts_a, pts_b, resp, k: int):
    """Spatially-spread top-k: k-means the pairs in (ya, xa, yb, xb)
    space and keep the highest-response pair per cluster (reference
    top_k_in_clusters, :303-325, sklearn KMeans random_state=0), on the
    host.  Numpy arrays or tensors in, the same out."""
    keep = _top_k_keep(*(np.asarray(t.cpu()) if isinstance(t, torch.Tensor)
                         else np.asarray(t) for t in (pts_a, pts_b, resp)),
                       k)
    if keep is None:
        return pts_a, pts_b, resp
    if isinstance(pts_a, torch.Tensor):
        keep = torch.as_tensor(keep, device=pts_a.device)
    return pts_a[keep], pts_b[keep], resp[keep]


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

def default_reconstruct(F: torch.Tensor, src_level: int, dst_level: int,
                        out_channels: int, seed: int = 0,
                        out_shape=None) -> torch.Tensor:
    """Deterministic stand-in for the reference's deconvolutional feature
    inversion (vgg19_model.deconve — an iterative optimization): nearest
    2x upsample per level step plus a fixed seeded linear projection into
    the finer level's channel count, rectified like the VGG taps it
    imitates.  The projection is drawn in numpy on the host; the
    upsample, the product and the ReLU run where F is.  `out_shape` fits
    the result to the finer level's true (H, W) when the pyramid is not an
    exact 2x halving (odd sizes)."""
    f = 2 ** (src_level - dst_level)
    out = F.repeat_interleave(f, 0).repeat_interleave(f, 1)
    if out_shape is not None:
        out = _fit_shape(out, out_shape)
    rng = np.random.RandomState(seed + 100 * src_level + dst_level)
    proj = rng.randn(F.shape[-1], out_channels).astype(_NP_DTYPES[F.dtype])
    proj /= math.sqrt(F.shape[-1])
    return torch.relu(out @ torch.as_tensor(proj, device=F.device))


def _call_reconstruct(fn, F, src_level, dst_level, out_channels, out_shape):
    """Invoke a reconstruct_fn, passing out_shape only if it accepts it
    (legacy signatures predate non-exact-2x pyramid support), and fit the
    result, as an fp32 tensor on F's device, to the target shape either
    way."""
    try:
        takes_shape = "out_shape" in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        takes_shape = False
    if takes_shape:
        out = fn(F, src_level, dst_level, out_channels, out_shape=out_shape)
    else:
        out = fn(F, src_level, dst_level, out_channels)
    return _fit_shape(_as_tensor(out, F.device), out_shape)


def _refine(pts_a, pts_b, resp, ga, gb, ra, rb, radius, shape):
    """Children of every parent pair (reference find_neural_best_buddies'
    non-deepest branch, :147-153, appended in reverse parent order per
    replace_refined_correspondence, :180-193): the level's buddies (ga,
    gb; row-major) whose a point lies in the parent's upsampled receptive
    field in A and whose b point lies in its field in B, in row-major
    order, each with the parent's response plus its own.  A position of A
    has at most one buddy, so each parent's candidates are its field's
    (2 radius + 1)^2 positions, scanned row-major, in chunks of at most
    ``_REFINE_CANDIDATES`` parent x position pairs."""
    h, w = shape
    dev = pts_a.device
    side = 2 * radius + 1
    off = torch.arange(-radius, radius + 1, device=dev)
    dy, dx = off.repeat_interleave(side), off.repeat(side)
    slot = torch.full((h * w,), -1, dtype=torch.int64, device=dev)
    slot[ga[:, 0] * w + ga[:, 1]] = torch.arange(len(ga), device=dev)
    parents = torch.arange(len(pts_a) - 1, -1, -1, device=dev)
    step = max(1, _REFINE_CANDIDATES // (side * side))
    out_a, out_b, out_r = [], [], []
    for s in range(0, len(parents), step):
        i = parents[s:s + step]
        cy = 2 * pts_a[i, 0:1] + dy
        cx = 2 * pts_a[i, 1:2] + dx
        ok = (cy >= 0) & (cy < h) & (cx >= 0) & (cx < w)
        g = slot[cy.clamp(0, h - 1) * w + cx.clamp(0, w - 1)]
        ok &= g >= 0
        b = gb[g.clamp(min=0)]
        yb, xb = 2 * pts_b[i, 0:1], 2 * pts_b[i, 1:2]
        ok &= ((b[..., 0] >= (yb - radius).clamp(min=0))
               & (b[..., 0] < (yb + radius + 1).clamp(max=h))
               & (b[..., 1] >= (xb - radius).clamp(min=0))
               & (b[..., 1] < (xb + radius + 1).clamp(max=w)))
        p, q = torch.nonzero(ok, as_tuple=True)
        ca = torch.stack([cy[p, q], cx[p, q]], dim=-1)
        cb = b[p, q]
        out_a.append(ca)
        out_b.append(cb)
        out_r.append(resp[i[p]] + 0.5 * (ra[ca[:, 0], ca[:, 1]]
                                         + rb[cb[:, 0], cb[:, 1]]))
    if not out_a:
        return (torch.zeros((0, 2), dtype=torch.int64, device=dev),
                torch.zeros((0, 2), dtype=torch.int64, device=dev),
                torch.zeros((0,), dtype=resp.dtype, device=dev))
    return torch.cat(out_a), torch.cat(out_b), torch.cat(out_r)


def _first_occurrences(pts: torch.Tensor, width: int) -> torch.Tensor:
    """Mask of the first pair with each point (make_correspondence_unique,
    :241-253), order kept."""
    n = len(pts)
    if n == 0:
        return torch.zeros((0,), dtype=torch.bool, device=pts.device)
    key = pts[:, 0] * width + pts[:, 1]
    index = torch.arange(n, device=pts.device)
    first = torch.full((int(key.max()) + 1,), n, dtype=torch.int64,
                       device=pts.device)
    first.scatter_reduce_(0, key, index, reduce="amin")
    return first[key] == index


def sparse_correspondence(pyr_a: Sequence, pyr_b: Sequence,
                          reconstruct_fn: Optional[Callable] = None,
                          tau: float = 0.05,
                          k_per_level: Optional[int] = None,
                          border: int = 7,
                          l_final: int = 1,
                          device=None,
                          stats: Optional[dict] = None):
    """The full reference NBB pipeline (run loop, :361-414) over a
    fine->coarse feature pyramid pair ((H/2^(L-1), W/2^(L-1), C_L) maps,
    arrays or tensors, level L = pyr[L-1]), on `device` (default
    ``cuda``).

    Returns (pts_a, pts_b, resp) as numpy arrays: correspondence pixel
    coordinates at the finest-level resolution scaled by 2^(l_final-1),
    after per-level refinement, response thresholding, optional per-level
    k-means capping (on the host), dedup, and border filtering.
    `reconstruct_fn(F, src_level, dst_level, out_channels)` inverts
    features one level finer for the common-appearance average (default:
    default_reconstruct).  A `stats` dict receives, under "levels", each
    level's counts and seconds and, on the CPU, the inputs and results of
    its two mappings."""
    dev = resolve_device(device)
    reconstruct_fn = reconstruct_fn or default_reconstruct
    levels = [] if stats is None else stats.setdefault("levels", [])
    l_start = len(pyr_a)
    F_A = _as_tensor(pyr_a[l_start - 1], dev)
    F_B = _as_tensor(pyr_b[l_start - 1], dev)
    F_Am, F_Bm = F_A, F_B
    map_ab = identity_map(*F_A.shape[:2], device=dev)
    map_ba = map_ab.clone()
    pts_a = pts_b = resp = None
    for L in range(l_start, l_final - 1, -1):
        patch = PATCH_SIZES[L - 1]
        radius = SEARCH_RADII[L - 1]
        t0 = _clock(dev)
        A, B = normalize_per_pix(F_Am), normalize_per_pix(F_Bm)
        a2b = find_mapping(A, B, patch, map_ab, radius)
        b2a = find_mapping(B, A, patch, map_ba, radius)
        t1 = _clock(dev)
        # per-pair response: average of the two endpoints' normalized l2
        # responses of the *unmixed* features (calculate_activations,
        # :195-204); accumulates across levels during refinement (:187)
        ra = _stretch01(response_l2(F_A))
        rb = _stretch01(response_l2(F_B))
        parents = 0 if pts_a is None else len(pts_a)
        ga, gb = find_best_buddies(a2b, b2a)
        if L == l_start:
            pts_a, pts_b = ga, gb
            resp = 0.5 * (ra[pts_a[:, 0], pts_a[:, 1]]
                          + rb[pts_b[:, 0], pts_b[:, 1]])
        else:
            pts_a, pts_b, resp = _refine(pts_a, pts_b, resp, ga, gb, ra, rb,
                                         radius, a2b.shape[:2])
        children = len(pts_a)
        # response threshold at both endpoints (:222-235)
        ma, mb = get_M(F_A, tau), get_M(F_B, tau)
        keep = (ma[pts_a[:, 0], pts_a[:, 1]]
                & mb[pts_b[:, 0], pts_b[:, 1]])
        pts_a, pts_b, resp = pts_a[keep], pts_b[keep], resp[keep]
        t2 = _clock(dev)
        if k_per_level is not None:
            pts_a, pts_b, resp = top_k_in_clusters(pts_a, pts_b, resp,
                                                   int(k_per_level))
        t3 = _clock(dev)
        if stats is not None:
            levels.append({
                "level": L, "shape": list(F_A.shape), "parents": parents,
                "buddies": len(ga), "children": children,
                "kept": len(pts_a), "find_mapping_s": t1 - t0,
                "refine_s": t2 - t1, "kmeans_s": t3 - t2,
                "reconstruct_s": 0.0,
                "mapping": {"A": A.cpu(), "B": B.cpu(),
                            "map_ab": map_ab.cpu(), "map_ba": map_ba.cpu(),
                            "a2b": a2b.cpu(), "b2a": b2a.cpu(),
                            "patch": patch, "radius": radius}})
        if L > l_final:
            # common-appearance transfer to the next finer level
            # (transfer_style_local, :335-349): warp each image's features
            # into the other's frame, reconstruct one level finer, and
            # average with the true finer-level features
            t3 = _clock(dev)
            F_An = _as_tensor(pyr_a[L - 2], dev)
            F_Bn = _as_tensor(pyr_b[L - 2], dev)
            RB = _call_reconstruct(reconstruct_fn, warp(F_B, patch, a2b),
                                   L, L - 1, F_An.shape[-1],
                                   tuple(F_An.shape[:2]))
            RA = _call_reconstruct(reconstruct_fn, warp(F_A, patch, b2a),
                                   L, L - 1, F_Bn.shape[-1],
                                   tuple(F_Bn.shape[:2]))
            F_Am = 0.5 * (F_An + RB)
            F_Bm = 0.5 * (F_Bn + RA)
            F_A, F_B = F_An, F_Bn
            # non-exact halvings (odd sizes) resize to the true next shape
            map_ab = upsample_mapping(a2b, shape=tuple(F_An.shape[:2]))
            map_ba = upsample_mapping(b2a, shape=tuple(F_Bn.shape[:2]))
            if stats is not None:
                levels[-1]["reconstruct_s"] = _clock(dev) - t3
    # finalize (make_correspondence_unique + scale_correspondence +
    # remove_border_correspondence, :241-253, :289-301, :254-281)
    first = _first_occurrences(pts_a, F_A.shape[1])
    pts_a, pts_b, resp = pts_a[first], pts_b[first], resp[first]
    scale = 2 ** (l_final - 1)
    pts_a = pts_a * scale
    pts_b = pts_b * scale
    if border > 0:
        # per-axis bounds (y vs height, x vs width).  The reference forces
        # square inputs (vgg19_model.py:27 image_height = image_width) and
        # bounds both axes by image_width (:248-269), so this coincides
        # with it on every input it supports while staying correct for
        # non-square pyramids.
        h0, w0 = pyr_a[0].shape[:2]
        hi = torch.as_tensor([h0 - border, w0 - border], device=dev)
        ok = ((pts_a >= border) & (pts_a <= hi)
              & (pts_b >= border) & (pts_b <= hi)).all(dim=1)
        pts_a, pts_b, resp = pts_a[ok], pts_b[ok], resp[ok]
    return pts_a.cpu().numpy(), pts_b.cpu().numpy(), resp.cpu().numpy()


def neural_best_buddies(images_a, images_b, k: int = 10,
                        feature_fn: Optional[Callable] = None,
                        tau: float = 0.05,
                        k_per_level: Optional[int] = None,
                        border: Optional[int] = None,
                        reconstruct_fn: Optional[Callable] = None,
                        device=None, stats: Optional[dict] = None):
    """Top-k sparse correspondences between two (1, H, W, 3) zc images,
    returned as pixel coordinates [((ya, xa), (yb, xb)), ...] — the
    reference algorithm end to end (run + top_k_in_clusters with
    k_final=k, neural_best_buddies.py:361-414) on `device` (default
    ``cuda``).  `feature_fn(images)` gives a fine->coarse pyramid (default:
    ``default_feature_pyramid`` on `device`).  A `stats` dict receives
    the pyramids' and the final k-means' seconds and
    ``sparse_correspondence``'s."""
    dev = resolve_device(device)
    t0 = _clock(dev)
    if feature_fn is None:
        from ..metrics.lpips import LPIPS
        net = LPIPS(device=dev)     # lpips.init_params(0), built once
        pyr_a = _vgg_pyramid(net, images_a, dev)
        pyr_b = _vgg_pyramid(net, images_b, dev)
    else:
        pyr_a, pyr_b = feature_fn(images_a), feature_fn(images_b)
    pyr_a = [_as_tensor(f[0], dev) for f in pyr_a]
    pyr_b = [_as_tensor(f[0], dev) for f in pyr_b]
    t1 = _clock(dev)
    if border is None:
        # reference default --border_size 7 is calibrated for 224px
        # inputs; scale it for smaller test images
        border = max(1, min(7, pyr_a[0].shape[0] // 32))
    pts_a, pts_b, resp = sparse_correspondence(
        pyr_a, pyr_b, reconstruct_fn=reconstruct_fn, tau=tau,
        k_per_level=k_per_level, border=border, device=dev, stats=stats)
    t2 = time.perf_counter()
    n_pairs = len(pts_a)
    pts_a, pts_b, resp = top_k_in_clusters(pts_a, pts_b, resp, k)
    if stats is not None:
        stats.update(pyramid_s=t1 - t0, pairs=n_pairs,
                     top_k_s=time.perf_counter() - t2)
    # feature grid -> image pixels (finest tap may sit below image res)
    h_img = (images_a.shape if isinstance(images_a, torch.Tensor)
             else np.shape(images_a))[1]
    scale = max(1, h_img // max(1, pyr_a[0].shape[0]))
    order = np.argsort(-resp, kind="stable")
    return [((int(pts_a[i, 0]) * scale, int(pts_a[i, 1]) * scale),
             (int(pts_b[i, 0]) * scale, int(pts_b[i, 1]) * scale))
            for i in order]


# ---------------------------------------------------------------------------
# moving least squares warp (similarity variant), host numpy
# ---------------------------------------------------------------------------

def mls_warp(image, src_points, dst_points, alpha: float = 1.0):
    """Warp (H, W, C) so that dst control points map onto src ones
    (backward warping with MLS affine deformation; reference util/MLS.py).
    Points are (y, x)."""
    image = np.asarray(image, np.float32)
    h, w = image.shape[:2]
    p = np.asarray(dst_points, np.float64)  # control pts in OUTPUT space
    q = np.asarray(src_points, np.float64)  # their positions in INPUT
    if len(p) == 0:
        return image.copy()
    gy, gx = np.mgrid[0:h, 0:w]
    v = np.stack([gy, gx], axis=-1).astype(np.float64)  # (H, W, 2)
    # weights w_i = 1 / |p_i - v|^(2*alpha)
    d2 = ((v[:, :, None, :] - p[None, None, :, :]) ** 2).sum(-1)
    wgt = 1.0 / np.maximum(d2, 1e-8) ** alpha           # (H, W, n)
    wsum = wgt.sum(-1, keepdims=True)
    pstar = (wgt[..., None] * p).sum(2) / wsum          # (H, W, 2)
    qstar = (wgt[..., None] * q).sum(2) / wsum
    ph = p[None, None] - pstar[:, :, None, :]           # (H, W, n, 2)
    qh = q[None, None] - qstar[:, :, None, :]
    # affine MLS: M = (sum w p̂ᵀ p̂)^-1 (sum w p̂ᵀ q̂)
    A = np.einsum("hwn,hwni,hwnj->hwij", wgt, ph, ph)
    B = np.einsum("hwn,hwni,hwnj->hwij", wgt, ph, qh)
    # regularize and solve
    A += np.eye(2)[None, None] * 1e-8
    M = np.linalg.solve(A, B)
    src = np.einsum("hwi,hwij->hwj", v - pstar, M) + qstar
    sy = np.clip(src[..., 0], 0, h - 1)
    sx = np.clip(src[..., 1], 0, w - 1)
    y0 = np.floor(sy).astype(int)
    x0 = np.floor(sx).astype(int)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    fy = (sy - y0)[..., None]
    fx = (sx - x0)[..., None]
    out = (image[y0, x0] * (1 - fy) * (1 - fx)
           + image[y0, x1] * (1 - fy) * fx
           + image[y1, x0] * fy * (1 - fx)
           + image[y1, x1] * fy * fx)
    return out.astype(image.dtype)


# ---------------------------------------------------------------------------
# poisson blending, host scipy
# ---------------------------------------------------------------------------

def poisson_blend(target, source, mask):
    """Seamless cloning: solve the Poisson equation with source gradients
    inside mask and target boundary values (reference
    pyflow/poisson_image_editing.py). target/source (H, W, C), mask (H, W)
    boolean."""
    import scipy.sparse
    import scipy.sparse.linalg
    target = np.asarray(target, np.float64)
    source = np.asarray(source, np.float64)
    mask = np.asarray(mask) > 0
    h, w = mask.shape
    idx = -np.ones((h, w), np.int64)
    ys, xs = np.nonzero(mask)
    idx[ys, xs] = np.arange(len(ys))
    n = len(ys)
    if n == 0:
        return target.copy()
    rows, cols, vals = [], [], []
    b = np.zeros((n, target.shape[2]))
    for eq, (y, x) in enumerate(zip(ys, xs)):
        rows.append(eq)
        cols.append(eq)
        vals.append(4.0)
        lap = 4.0 * source[y, x]
        for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            yy, xx = y + dy, x + dx
            if not (0 <= yy < h and 0 <= xx < w):
                lap -= source[y, x]
                b[eq] += target[y, x]
                continue
            lap -= source[yy, xx]
            if mask[yy, xx]:
                rows.append(eq)
                cols.append(idx[yy, xx])
                vals.append(-1.0)
            else:
                b[eq] += target[yy, xx]
        b[eq] += lap
    A = scipy.sparse.csr_matrix((vals, (rows, cols)), shape=(n, n))
    out = target.copy()
    sol = scipy.sparse.linalg.spsolve(A, b)
    out[ys, xs] = sol.reshape(n, -1)
    return out


def nbb_paste(image_a, image_b, mask_a, k: int = 10,
              feature_fn: Optional[Callable] = None, device=None,
              stats: Optional[dict] = None):
    """The full baseline: find correspondences on `device` (default
    ``cuda``), MLS-warp image_a's masked region into image_b's frame,
    poisson-blend on the host (what the reference's main.py does).
    image_a/image_b are (H, W, 3) zc arrays, mask_a (H, W); returns the
    blended float64 image and the pairs.  A `stats` dict receives
    ``neural_best_buddies``'s entries and the MLS and Poisson seconds."""
    image_a, image_b = np.asarray(image_a), np.asarray(image_b)
    pairs = neural_best_buddies(image_a[None], image_b[None], k=k,
                                feature_fn=feature_fn, device=device,
                                stats=stats)
    t0 = time.perf_counter()
    src_pts = [p[0] for p in pairs]
    dst_pts = [p[1] for p in pairs]
    warped = mls_warp(image_a, src_pts, dst_pts)
    warped_mask = mls_warp(np.asarray(mask_a, np.float32)[..., None],
                           src_pts, dst_pts)[..., 0] > 0.5
    t1 = time.perf_counter()
    out = poisson_blend(image_b, warped, warped_mask)
    if stats is not None:
        stats["mls_s"] = t1 - t0
        stats["poisson_s"] = time.perf_counter() - t1
    return out, pairs

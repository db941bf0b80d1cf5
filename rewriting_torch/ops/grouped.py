"""Many edits of one conv weight in one convolution.

A batch of G edits runs as one program: the bag's rows are folded
edit-major (G·B rows: edit 0's B rows, then edit 1's, ...), and a conv
whose weight has a leading edit axis ``(G, O, I, k, k)`` runs as one
grouped convolution over the G maps laid side by side in channels.  The
edit solves (``rewrite/solve.py``), the models' conv stages and the
previews (``rewrite/multi.py``) share these two reshapes.
"""

from __future__ import annotations

import torch


def side_by_side(x: torch.Tensor, groups: int) -> torch.Tensor:
    """(G·B, C, H, W) folded edit-major -> (B, G·C, H, W)."""
    gb, c, h, w = x.shape
    b = gb // groups
    return x.reshape(groups, b, c, h, w).transpose(0, 1).reshape(
        b, groups * c, h, w)


def folded(y: torch.Tensor, groups: int) -> torch.Tensor:
    """Inverse of :func:`side_by_side`: (B, G·C, H, W) -> (G·B, C, H, W)."""
    b, gc, h, w = y.shape
    c = gc // groups
    return y.reshape(b, groups, c, h, w).transpose(0, 1).reshape(
        groups * b, c, h, w)

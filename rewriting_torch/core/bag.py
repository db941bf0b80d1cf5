"""DataBag — a dict of named tensors flowing through a stage pipeline.

Counterpart of the JAX package's ``core/bag.py`` (``DataBag`` :21, ``bag``
:53).  Conventional keys:

    latent  - z, then W (after the mapping network), then (B, n_latent, D)
    style   - the per-layer style vector picked from latent
    fmap    - the current feature map, NCHW
    output  - the accumulated RGB skip output, NCHW
    noise_{h}x{w} - the per-resolution noise input, (B, 1, h, w)
"""

from __future__ import annotations


class DataBag(dict):
    """Dict with attribute access."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        self[name] = value

    def __delattr__(self, name):
        try:
            del self[name]
        except KeyError:
            raise AttributeError(name)

    def copy(self) -> "DataBag":
        return DataBag(self)


def bag(**kwargs) -> DataBag:
    """A DataBag of the keyword arguments."""
    return DataBag(**kwargs)

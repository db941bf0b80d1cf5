"""Save and load a params tree (an edited model, say) as one npz file.

The port's counterpart of the JAX package's ``utils/paramio.py``
(:34-69), in the same format, so a file written by one package loads in
the other bit for bit: one array per leaf, its key the path of dict keys
joined by ``||``; a list or tuple stores its length under ``__seq__`` and
its items under their indices, and loads back as a list.  Arrays are
stored in the layout of the tree as it is: the port's StyleGAN2 const
input and noise buffers are NCHW where the JAX package's are NHWC, so a
StyleGAN2 tree crosses packages through ``convert.params_from_jax`` /
``params_to_numpy``; a ProgGAN tree crosses as it is.

The JAX package's Orbax pair (:72-101), which saves sharded arrays with
their layout, is JAX persistence and is not ported.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from .device import resolve_device

_SEP = "||"


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}{_SEP}"))
    elif isinstance(tree, (list, tuple)):
        out[f"{prefix}__seq__"] = np.array(len(tree))
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}{_SEP}"))
    else:
        if isinstance(tree, torch.Tensor):
            tree = tree.detach().cpu().numpy()
        out[prefix.rstrip(_SEP)] = np.asarray(tree)
    return out


def save_params(path: str, params: Dict) -> None:
    """Write the tree (tensors on any device, or arrays) to `path`."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **_flatten(params))


def load_params(path: str, device=None) -> Dict:
    """The tree of a file that either package wrote, its leaves tensors
    on ``device`` (default ``cuda``)."""
    device = resolve_device(device)
    with np.load(path, allow_pickle=False) as f:
        data = {k: f[k] for k in f.files}
    root: Dict = {}
    seqs = {k[:-len("__seq__") - len(_SEP)] for k in data
            if k.endswith(f"{_SEP}__seq__")}
    for key, value in data.items():
        if key.endswith("__seq__"):
            continue
        parts = key.split(_SEP)
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = torch.from_numpy(value).to(device)

    def listify(node, prefix=""):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v, f"{prefix}{k}{_SEP}") for k, v in node.items()}
        if prefix.rstrip(_SEP) in seqs or (prefix == "" and "" in seqs):
            return [out[str(i)] for i in range(len(out))]
        return out

    return listify(root)

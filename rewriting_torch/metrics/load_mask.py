"""Edit-request registry: the published paper edits.

The port's counterpart of the JAX package's ``metrics/load_mask.py``
(reference metrics/load_mask.py).  Masks are small JSON edit-request files
(an image number and painted mask data URLs).  A named edit resolves to
``<masks dir>/<dataset>/<file>``, the masks dir being
``$REWRITING_TPU_MASKS`` or else ``./masks``.  The port never downloads:
a missing file raises and names the place to put it.
"""

from __future__ import annotations

import json
import os
from typing import Tuple

MASK_URLS = "http://rewriting.csail.mit.edu/data/masks/"

# name -> [clean dataset, mask filename, layer number]
# (reference load_mask.py:7-12)
name2info = {
    "dome2spire": ["church", "dome2spire.json", 8],
    "dome2tree": ["church", "dome2tree.json", 8],
    "dome2castle": ["church", "dome2castle.json", 6],
    "smile": ["faces", "smile.json", 10],
}


def masks_dir() -> str:
    return os.environ.get("REWRITING_TPU_MASKS", "masks")


def load_mask_info(mask: str) -> Tuple[str, str, int]:
    """(mask_path, dataset, layernum) for a named edit."""
    dataset, maskname, layernum = name2info[mask]
    mask_path = os.path.join(masks_dir(), dataset, maskname)
    if not os.path.exists(mask_path):
        raise FileNotFoundError(
            f"edit-request JSON {maskname} not found at {mask_path}; place "
            f"the published file from {MASK_URLS}{maskname} there (or set "
            f"$REWRITING_TPU_MASKS to a directory holding "
            f"{dataset}/{maskname})")
    return mask_path, dataset, layernum


def load_mask_request(mask: str) -> dict:
    path, _, _ = load_mask_info(mask)
    with open(path) as f:
        return json.load(f)

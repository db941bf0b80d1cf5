"""Edit-request registry: the published paper edits.

The port's counterpart of the JAX package's ``metrics/load_mask.py``
(reference metrics/load_mask.py).  Masks are small JSON edit-request files
(an image number and painted mask data URLs).  A named edit resolves to
``<masks dir>/<dataset>/<file>``, the masks dir being
``$REWRITING_TPU_MASKS`` or else ``./masks``.  A missing file is
downloaded from the publication server (``MASK_URLS``) and written there
as the JAX package writes it (``json.dump(..., indent=1)`` of the parsed
response, so the two write the same bytes), through a ``.tmp`` file; a
failed download raises ``FileNotFoundError`` naming the file, the URL and
``$REWRITING_TPU_MASKS``.
"""

from __future__ import annotations

import json
import os
from typing import Tuple

from ..utils import download

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
    """(mask_path, dataset, layernum) for a named edit, downloaded if
    absent (reference load_mask.py:16-24)."""
    dataset, maskname, layernum = name2info[mask]
    basedir = os.path.join(masks_dir(), dataset)
    mask_path = os.path.join(basedir, maskname)
    if not os.path.exists(mask_path):
        os.makedirs(basedir, exist_ok=True)
        url = MASK_URLS + maskname
        tmp = mask_path + ".tmp"
        try:
            with download.open_url(url) as r:
                result = json.load(r)
            with open(tmp, "w") as f:
                json.dump(result, f, indent=1)
            os.replace(tmp, mask_path)
        except download.ERRORS as e:
            raise FileNotFoundError(
                f"edit-request JSON {maskname} not found at {mask_path} "
                f"and its download from {url} failed ({e}); place the "
                f"published file there (or set $REWRITING_TPU_MASKS to a "
                f"directory holding {dataset}/{maskname})") from e
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return mask_path, dataset, layernum


def load_mask_request(mask: str) -> dict:
    path, _, _ = load_mask_info(mask)
    with open(path) as f:
        return json.load(f)

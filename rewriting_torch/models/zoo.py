"""The published StyleGAN2 and ProgGAN checkpoints, loaded from local
files and downloaded on a miss.

The port's counterpart of the JAX package's ``models/zoo.py``: the
reference's table of eight rosinality StyleGAN2 checkpoints (reference
utils/stylegan2/__init__.py:17-47) and of eight ProgGAN checkpoints
(reference utils/proggan.py:8-30), and loaders that turn one into
``(SeqStyleGAN2, params)`` or ``(ProgressiveGenerator, params)``.

A checkpoint is looked up at ``path`` if given (a missing ``path`` raises
and downloads nothing), else as its file name in ``$REWRITING_TPU_WEIGHTS``
(the variable the JAX package reads, so the two share one weights
directory), else in ``~/.cache/rewriting_torch``.  A file absent from that
directory is downloaded from its publication server (``STYLEGAN2_URL``,
``PROGGAN_URL``) into it, as the JAX package and the reference do, through
a ``.tmp`` file (``utils.download``, a fixed timeout a connection); a
failed download raises ``FileNotFoundError`` naming the file, the
directory, the URL and the download's own error.
``scripts/torch_fetch_weights.py`` fetches every published file at once.

Files are read with ``torch.load(weights_only=True)``, which runs no code
from the file: it rebuilds tensors, containers and scalars, and here also
the ``SAFE_GLOBALS``: ``argparse.Namespace``, which a rosinality training
checkpoint keeps under ``args`` beside ``g_ema``, and numpy's scalars and
dtypes, which a training checkpoint may hold as its epoch or loss
(pytorch-slim-cnn's ``celeba_20.pth``).  A file holding any other object
raises ``pickle.UnpicklingError`` naming the file.
"""

from __future__ import annotations

import argparse
import os
import pickle
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils import download
from . import proggan
from .stylegan2 import SeqStyleGAN2, params_from_state_dict

# name -> (filename, size) (reference utils/stylegan2/__init__.py:18-29)
STYLEGAN2_ZOO = {
    "bedroom": ("stylegan2_bedroom.pt", 256),
    "car": ("stylegan2_car.pt", 512),
    "cat": ("stylegan2_cat.pt", 256),
    "church": ("stylegan2_church.pt", 256),
    "faces": ("stylegan2_faces.pt", 1024),
    "horse": ("stylegan2_horse.pt", 256),
    "kitchen": ("stylegan2_kitchen.pt", 256),
    "places": ("stylegan2_places.pt", 256),
}
STYLEGAN2_URL = "https://rewriting.csail.mit.edu/models/"

# domain -> filename (reference utils/proggan.py:12-21)
PROGGAN_ZOO = {
    "bedroom": "proggan_bedroom-d8a89ff1.pth",
    "church": "proggan_churchoutdoor-7e701dd5.pth",
    "conferenceroom": "proggan_conferenceroom-21e85882.pth",
    "diningroom": "proggan_diningroom-3aa0ab80.pth",
    "kitchen": "proggan_kitchen-67f1e16c.pth",
    "livingroom": "proggan_livingroom-5ef336dd.pth",
    "restaurant": "proggan_restaurant-b8578299.pth",
    "celebhq": "proggan_celebhq-620d161c.pth",
}
PROGGAN_URL = "http://gandissect.csail.mit.edu/models/"


def _numpy_scalar_globals() -> tuple:
    """numpy's scalar rebuilder and dtypes, the types torch's
    ``weights_only`` documentation names for a numpy scalar: the rebuilder
    under both its numpy 1 and numpy 2 module names (a file keeps the name
    of the numpy that wrote it), the dtype classes of ``np.dtypes``."""
    core = getattr(np, "_core", None) or np.core
    scalar = core.multiarray.scalar
    module = getattr(np, "dtypes", None)    # numpy >= 1.25
    dtypes = [t for t in (vars(module).values() if module else ())
              if isinstance(t, type) and issubclass(t, np.dtype)]
    return ((scalar, "numpy.core.multiarray.scalar"),
            (scalar, "numpy._core.multiarray.scalar"), np.dtype, *dtypes)


# the non-tensor types a checkpoint may hold: rosinality's training
# script saves its argparse.Namespace as "args"; a training checkpoint's
# epoch or loss may be a numpy scalar
SAFE_GLOBALS = (argparse.Namespace, *_numpy_scalar_globals())


def weights_dir() -> str:
    return os.environ.get(
        "REWRITING_TPU_WEIGHTS",
        os.path.join(os.path.expanduser("~"), ".cache", "rewriting_torch"))


def _resolve(filename: str, url_base: str, path: Optional[str]) -> str:
    """The checkpoint's local path: `path` if given, else its file in
    ``weights_dir()``, downloaded from ``url_base + filename`` if absent."""
    if path is not None:
        if os.path.isfile(path):
            return path
        raise FileNotFoundError(f"checkpoint {filename} not found at {path}")
    local = os.path.join(weights_dir(), filename)
    if os.path.isfile(local):
        return local
    url = url_base + filename
    try:
        return download.fetch(url, local)
    except download.ERRORS as e:
        raise FileNotFoundError(
            f"checkpoint {filename} not found at {local} and its download "
            f"from {url} failed ({e}). Place the file there, or in "
            f"$REWRITING_TPU_WEIGHTS (now {weights_dir()}).") from e


def load_state(path: str) -> dict:
    """The checkpoint's dicts of CPU tensors (and any ``SAFE_GLOBALS``);
    a file holding another object raises naming `path`."""
    with torch.serialization.safe_globals(list(SAFE_GLOBALS)):
        try:
            return torch.load(path, map_location="cpu", weights_only=True)
        except pickle.UnpicklingError as e:
            raise pickle.UnpicklingError(
                f"{path}: refused by the weights_only unpickler (an object "
                f"outside zoo.SAFE_GLOBALS, or not a checkpoint): {e}") from e


def load_seq_stylegan(category: str, path: Optional[str] = None,
                      truncation: float = 1.0, size: Optional[int] = None,
                      device=None) -> Tuple[SeqStyleGAN2, dict]:
    """(model, params) of a published StyleGAN2 checkpoint, on ``device``
    (default ``cuda``); the reference samples its models with
    ``truncation=0.5``."""
    filename, default_size = STYLEGAN2_ZOO[category]
    sd = load_state(_resolve(filename, STYLEGAN2_URL, path))
    model = SeqStyleGAN2(size=size or default_size, style_dim=512, n_mlp=8,
                         truncation=truncation, device=device)
    return model, params_from_state_dict(model, sd)


def load_proggan(domain: str, path: Optional[str] = None, device=None
                 ) -> Tuple[proggan.ProgressiveGenerator, dict]:
    """(model, params) of a published ProgGAN checkpoint, on ``device``
    (default ``cuda``); with `path`, `domain` only names it.  A file that
    wraps its weights in ``state_dict`` or names them in the old
    ``features.N`` style loads as well."""
    filename = PROGGAN_ZOO[domain] if path is None else \
        PROGGAN_ZOO.get(domain, domain)
    sd = load_state(_resolve(filename, PROGGAN_URL, path))
    if "state_dict" in sd:
        sd = sd["state_dict"]
    if "features.0.conv.weight" in sd:
        sd = _proggan_from_old_names(sd)
    return proggan.from_state_dict(sd, device=device)


def _proggan_from_old_names(sd: dict) -> dict:
    """The ``layerN``/``output_DxD`` names of a state dict in the old
    ``features.N`` naming (reference proggan.py:298-325)."""
    out = {}
    i = 0
    while f"features.{i}.conv.weight" in sd:
        out[f"layer{i + 1}.conv.weight"] = sd[f"features.{i}.conv.weight"]
        out[f"layer{i + 1}.wscale.b"] = sd[f"features.{i}.wscale.b"]
        i += 1
    res = 4 * (2 ** ((i - 1) // 2))
    out[f"output_{res}x{res}.conv.weight"] = sd["output.conv.weight"]
    out[f"output_{res}x{res}.wscale.b"] = sd["output.wscale.b"]
    return out


def load_pretrained(domain: str, **kwargs):
    """The reference's name for ``load_proggan`` (proggan.py:8)."""
    return load_proggan(domain, **kwargs)

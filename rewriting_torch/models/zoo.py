"""The published StyleGAN2 checkpoints, loaded from local files.

The port's counterpart of the StyleGAN2 part of the JAX package's
``models/zoo.py`` (:1-118): the reference's table of eight rosinality
checkpoints (reference utils/stylegan2/__init__.py:17-47) and a loader
that turns one into ``(SeqStyleGAN2, params)``.

A checkpoint is looked up at ``path`` if given, else as its file name in
``$REWRITING_TPU_WEIGHTS`` (the variable the JAX package reads, so the two
share one weights directory), else in ``~/.cache/rewriting_torch``.  The
port downloads nothing: a missing file raises ``FileNotFoundError`` naming
the file, the directory and the URL to fetch it from.

Files are read with ``torch.load(weights_only=True)``: a rosinality file
is dicts of tensors, which that unpickler reads without running code.  A
file that holds other objects makes it raise; no published file has been
tried yet (none is in the repository).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

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


def weights_dir() -> str:
    return os.environ.get(
        "REWRITING_TPU_WEIGHTS",
        os.path.join(os.path.expanduser("~"), ".cache", "rewriting_torch"))


def _resolve(filename: str, url_base: str, path: Optional[str]) -> str:
    """The checkpoint's local path; raises if it is not on disk."""
    if path is None:
        path = os.path.join(weights_dir(), filename)
    if os.path.isfile(path):
        return path
    raise FileNotFoundError(
        f"checkpoint {filename} not found at {path}. The port downloads "
        f"nothing: place the file from {url_base}{filename} there, or in "
        f"$REWRITING_TPU_WEIGHTS (now {weights_dir()}).")


def load_state(path: str) -> dict:
    """The checkpoint's dicts of CPU tensors."""
    return torch.load(path, map_location="cpu", weights_only=True)


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

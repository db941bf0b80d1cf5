"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for another device.
Asking for ``cuda`` where there is none raises: nothing falls back to the
CPU silently.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``torch.device`` for an entry point's ``device`` argument
    (None means ``cuda``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was asked for (the entry points' default) but no CUDA "
            "device is available; pass device='cpu' to run on the CPU")
    return dev

"""Progress-bar wrappers (tqdm if available), with quiet mode and
status-message helpers.

The port's copy of the JAX package's ``utils/pbar.py``: ``pbar(iterable)``,
``descnext(desc)``, ``post(k=v)``, ``print(...)``, and a ``quiet()``
context manager."""

from __future__ import annotations

import builtins
import contextlib
import sys

try:
    from tqdm import tqdm
    HAVE_TQDM = True
except ImportError:  # pragma: no cover
    tqdm = None
    HAVE_TQDM = False

_QUIET = [False]
_NEXT_DESC = [None]
_CURRENT = [None]


def __call__(*args, **kwargs):  # pragma: no cover
    return pbar(*args, **kwargs)


def pbar(iterable=None, total=None, desc=None, **kwargs):
    """Wrap an iterable with a progress bar unless quiet."""
    if desc is None and _NEXT_DESC[0] is not None:
        desc = _NEXT_DESC[0]
        _NEXT_DESC[0] = None
    if _QUIET[0] or not HAVE_TQDM:
        return iterable if iterable is not None else _Null()
    bar = tqdm(iterable, total=total, desc=desc, leave=False,
               file=sys.stderr, **kwargs)
    _CURRENT[0] = bar
    return bar


class _Null:
    def update(self, *a):
        pass

    def close(self):
        pass

    def set_postfix(self, **kw):
        pass


def descnext(desc):
    """Set the description for the next bar (reference pbar.descnext)."""
    _NEXT_DESC[0] = desc


def post(**kwargs):
    """Attach postfix key=values to the active bar."""
    bar = _CURRENT[0]
    if bar is not None and hasattr(bar, "set_postfix"):
        try:
            bar.set_postfix(**kwargs)
        except Exception:
            pass


def desc(text):
    bar = _CURRENT[0]
    if bar is not None and hasattr(bar, "set_description"):
        bar.set_description(text)


def print(*args, **kwargs):
    """Print without corrupting an active bar."""
    if HAVE_TQDM and not _QUIET[0]:
        tqdm.write(" ".join(str(a) for a in args))
    else:
        builtins.print(*args, **kwargs)


@contextlib.contextmanager
def quiet():
    """Suppress progress bars inside the context (reference pbar.quiet)."""
    old = _QUIET[0]
    _QUIET[0] = True
    try:
        yield
    finally:
        _QUIET[0] = old


class reporthook:
    """Download-style (count, blocksize, total) callback bar."""

    def __init__(self, desc=None):
        self.bar = None
        self.desc = desc

    def __call__(self, count, blocksize, total):
        if self.bar is None and HAVE_TQDM and not _QUIET[0]:
            self.bar = tqdm(total=total, unit="b", unit_scale=True,
                            desc=self.desc, leave=False)
        if self.bar is not None:
            self.bar.update(blocksize)

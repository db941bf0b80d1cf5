"""Notebook HTML layout helper.

The port's counterpart of the JAX package's ``utils/show.py``, after the
reference's show module (utils/show.py): lay out nested arrays of
displayable things (images, text, widgets) as HTML rows and columns in
Jupyter.  ``show(a, [b, c])`` renders a as one block and [b, c] as a row.
Outside IPython it returns the HTML string.

Images are (H, W, 3) arrays: ``uint8``, the port's images, as they are,
and float ones as zc-normalised, both through the port's own
``renormalize.as_url``; there is no PIL branch."""

from __future__ import annotations

import html as _html
import sys
import types

import numpy as np

from . import renormalize


def _to_html(obj) -> str:
    # widgets from the labwidget framework render themselves
    if hasattr(obj, "_repr_html_"):
        return obj._repr_html_()
    if isinstance(obj, np.ndarray):
        if obj.ndim == 3:  # an image: uint8 as it is, float as zc
            return f'<img src="{renormalize.as_url(obj)}">'
        return f"<pre>{_html.escape(np.array2string(obj, precision=3))}</pre>"
    if isinstance(obj, dict):
        rows = "".join(
            f"<tr><td style='text-align:right;padding:0 8px'>"
            f"{_html.escape(str(k))}</td><td>{_to_html(v)}</td></tr>"
            for k, v in obj.items())
        return f"<table>{rows}</table>"
    if isinstance(obj, (list, tuple)):
        cells = "".join(
            f"<div style='display:inline-block;vertical-align:top;"
            f"margin:2px'>{_to_html(o)}</div>" for o in obj)
        return f"<div>{cells}</div>"
    return f"<div>{_html.escape(str(obj))}</div>"


def html(*args) -> str:
    """Build the HTML string for a sequence of blocks."""
    return "".join(f"<div style='margin:2px'>{_to_html(a)}</div>"
                   for a in args)


def show(*args):
    """Display blocks in Jupyter; returns the HTML string otherwise.

    Any row accumulated with :func:`a` is flushed first (reference
    utils/show.py:143-146 behavior: ``show()`` with no args == flush)."""
    out = ""
    global _buffer
    if _buffer is not None:
        pending, _buffer = _buffer, None
        out += html(pending)
    out += html(*args)
    try:
        from IPython import get_ipython
        from IPython.display import display, HTML
        if get_ipython() is not None:  # only display inside a live kernel
            if out:
                display(HTML(out))
            return None
    except ImportError:
        pass
    return out


def a(x, cols=None):
    """Append ``x`` to an implicit row buffer; the row is rendered on the
    next ``flush()``/``show()``, or automatically once it holds ``cols``
    items.  Incremental row-builder matching reference utils/show.py:122-129
    (``show.a``), which the reference stats notebooks use to lay out image
    grids one cell at a time."""
    global _buffer
    if _buffer is None:
        _buffer = []
    _buffer.append(x)
    if cols is not None and len(_buffer) >= cols:
        flush()


def reset():
    """Drop any accumulated row without rendering it
    (reference utils/show.py:132-134)."""
    global _buffer
    _buffer = None


def flush():
    """Render the accumulated row, if any (reference utils/show.py:137-141).
    Returns the HTML string outside IPython (same contract as show())."""
    return show()


_buffer = None


def blocks(items):
    """Vertical stack."""
    return list(items)


def rows(items):
    """Horizontal row."""
    return [list(items)]


class _CallableShowModule(types.ModuleType):
    """Makes ``from rewriting_torch.utils import show; show(img)`` work with
    the module itself callable — the CallableModule trick the reference
    installs at utils/show.py:153-164 and its notebooks depend on."""

    def __call__(self, *args, **kwargs):
        return show(*args, **kwargs)


sys.modules[__name__].__class__ = _CallableShowModule

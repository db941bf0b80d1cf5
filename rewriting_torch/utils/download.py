"""Fetching a published file on a miss, as the JAX package's zoo and mask
registry do (``urllib``; proxies from the environment, as ``urllib``
reads them).

Every connection waits at most ``TIMEOUT`` seconds for a connect or a
read, so a host without a network fails instead of hanging.  ``fetch``
writes through ``dest + ".tmp"`` and moves it into place only when the
whole body has arrived; on any failure the partial file is removed.
"""

from __future__ import annotations

import http.client
import os
import shutil
import urllib.error
import urllib.request

TIMEOUT = 60.0      # seconds a connect or a read may wait

# what a failed fetch raises: URLError and HTTPError (OSError
# subclasses), timeouts, a malformed URL (ValueError), a broken response
ERRORS = (OSError, ValueError, http.client.HTTPException)


def open_url(url: str):
    """The response to a GET of `url` (a context manager)."""
    return urllib.request.urlopen(url, timeout=TIMEOUT)


def fetch(url: str, dest: str) -> str:
    """Download `url` to `dest` (its directory made); returns `dest`.
    Raises one of ``ERRORS`` and leaves no ``.tmp`` behind on failure,
    including a body shorter than its Content-Length (as ``urlretrieve``
    refuses one)."""
    os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
    tmp = dest + ".tmp"
    try:
        with open_url(url) as response, open(tmp, "wb") as f:
            shutil.copyfileobj(response, f)
            size = f.tell()
            want = response.headers.get("Content-Length")
        if want is not None and size < int(want):
            raise urllib.error.ContentTooShortError(
                f"{url}: got {size} of {want} bytes", None)
        os.replace(tmp, dest)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return dest

"""EasyDict: attribute-access dict (reference: utils/easydict.py).

The port's copy of the JAX package's ``utils/easydict.py``.  The DataBag
(``core/bag.py``) is the bag of tensors on the compute path; EasyDict is
the host-side convenience for configs and experiment records, and turns
nested dicts into EasyDicts."""

from __future__ import annotations


class EasyDict(dict):
    def __init__(self, *args, **kwargs):
        super().__init__()
        for a in args:
            self.update(a)
        self.update(kwargs)

    def update(self, other=None, **kwargs):
        d = dict(other or {})
        d.update(kwargs)
        for k, v in d.items():
            self[k] = v

    def __setitem__(self, k, v):
        if isinstance(v, dict) and not isinstance(v, EasyDict):
            v = EasyDict(v)
        super().__setitem__(k, v)

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

"""Retain and edit intermediate activations of a stage pipeline.

Counterpart of the JAX package's ``core/instrument.py`` (:27-147), after
the reference's InstrumentedModel (utils/nethook.py:16-281), which patches
layer ``forward`` methods.  Here a retain or edit point is a stage
inserted into a copy of the model's stage list after the stages a name
matches; retained bags ride through the bag under reserved keys and are
collected after the forward.

API as the reference's: ``retain_layer(s)``, ``stop_retaining_layers``,
``retained_layer``, ``retained_features``, ``edit_layer(rule=...)`` or
``edit_layer(ablation=..., replacement=...)`` with the convex rule
(nethook.py:284-293), ``remove_edits``.

Layout: the models run NCHW; the hooks give the JAX package's NHWC.  An
edit rule sees the feature map as (B, H, W, C) and returns it so (a
per-channel ``ablation`` of shape (C,) broadcasts over channels, as in
the JAX package), and a retained bag holds every 4-D tensor as NHWC
(``fmap``, the rgb ``output``, the noise inputs).  The transposes happen
only at the hooks.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from .bag import DataBag
from .stages import Stage, StagePipeline

_RETAIN_PREFIX = "_retained:"


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def apply_ablation_replacement(x, ablation=None, replacement=None):
    """x' = (1 - a) * x + a * v (reference nethook.py:284-293)."""
    if ablation is not None:
        x = x * (1 - ablation)
        if replacement is not None:
            x = x + ablation * replacement
    return x


class InstrumentedPipeline:
    """Wraps (model, params) with retain/edit instrumentation of the
    model's seq ``pipeline``."""

    def __init__(self, model, params):
        self.model = model
        self.params = params
        self._retained: Dict[str, Optional[DataBag]] = {}
        self._edits: Dict[str, Callable] = {}
        self._compiled: Optional[StagePipeline] = None

    # -- configuration -------------------------------------------------------
    def layer_names(self):
        return self.model.pipeline.stage_names()

    def retain_layer(self, layername: str):
        self.retain_layers([layername])

    def retain_layers(self, layernames):
        for name in layernames:
            self._retained[name] = None
        self._compiled = None

    def stop_retaining_layers(self, layernames):
        for name in layernames:
            self._retained.pop(name, None)
        self._compiled = None

    def edit_layer(self, layername: str, rule: Optional[Callable] = None,
                   ablation=None, replacement=None):
        """Attach a rule applied to the bag after `layername`: `rule` maps
        the NHWC fmap to an NHWC fmap (or, before the model has a fmap,
        bag -> bag); or pass ablation / replacement (scalars or arrays that
        broadcast against NHWC) for the convex rule."""
        if rule is None:
            def as_tensor(v):
                return None if v is None else torch.as_tensor(
                    v, dtype=torch.float32, device=self.model.device)
            a, r = as_tensor(ablation), as_tensor(replacement)

            def rule(x):
                return apply_ablation_replacement(x, a, r)
        self._edits[layername] = rule
        self._compiled = None

    def remove_edits(self, layername: Optional[str] = None):
        if layername is None:
            self._edits.clear()
        else:
            self._edits.pop(layername, None)
        self._compiled = None

    # -- the instrumented pipeline --------------------------------------------
    def _instrumented(self) -> StagePipeline:
        if self._compiled is not None:
            return self._compiled
        base = self.model.pipeline
        hook_after = {}  # index of the last stage matched by each name
        for name in dict.fromkeys(list(self._retained) + list(self._edits)):
            lo, hi = base._span(name)
            hook_after.setdefault(hi - 1, []).append(name)
        stages = []
        for i, stage in enumerate(base.stages):
            stages.append(stage)
            for name in hook_after.get(i, []):
                if name in self._edits:
                    stages.append(Stage(f"_edit:{name}",
                                        self._make_edit(name)))
                if name in self._retained:
                    stages.append(Stage(f"{_RETAIN_PREFIX}{name}",
                                        _make_retain(name)))
        self._compiled = StagePipeline(stages)
        return self._compiled

    def _make_edit(self, name):
        def edit_stage(params, bag: DataBag) -> DataBag:
            rule = self._edits[name]  # late-bound: rules can be swapped
            if "fmap" not in bag:
                out = rule(bag)
                return out if isinstance(out, DataBag) else DataBag(
                    bag, fmap=out)
            out = rule(_nhwc(bag["fmap"]))
            if isinstance(out, DataBag):
                return out
            return DataBag(bag, fmap=_nchw(out))
        return edit_stage

    # -- execution ------------------------------------------------------------
    def __call__(self, z, **kwargs):
        """The instrumented forward of latents z: the (B, H, W, 3) NHWC
        image (or the final bag if the pipeline makes no ``output``)."""
        bag = self.model.make_bag(z, **kwargs)
        with torch.no_grad():
            out = self._instrumented()(self.params, bag)
        for key in [k for k in out if k.startswith(_RETAIN_PREFIX)]:
            self._retained[key[len(_RETAIN_PREFIX):]] = out.pop(key)
        return _nhwc(out["output"]) if "output" in out else out

    def retained_layer(self, layername: str, clear: bool = False):
        """The bag after `layername` in the last call, 4-D tensors NHWC
        (the reference's nethook.py:103-115 returns the layer output; take
        ``['fmap']`` for it)."""
        val = self._retained.get(layername)
        if clear:
            self._retained[layername] = None
        return val

    def retained_features(self, clear: bool = False):
        return {k: self.retained_layer(k, clear=clear)
                for k in self._retained}


def _make_retain(name):
    key = _RETAIN_PREFIX + name

    def retain_stage(params, bag: DataBag) -> DataBag:
        snapshot = DataBag({k: (_nhwc(v) if v.dim() == 4 else v)
                            for k, v in bag.items()
                            if not k.startswith(_RETAIN_PREFIX)})
        return DataBag(bag, **{key: snapshot})
    return retain_stage

"""Functional stage pipelines: model surgery as slicing.

Counterpart of the JAX package's ``core/stages.py`` (``StagePipeline`` at
:52, its ``param_names`` at :143, ``subsequence`` at :148).  A model is an
ordered tuple of named stage functions ``fn(params_subtree, bag) -> bag``
plus a flat params dict ``{stage_name: {param_name: tensor}}``.  Stage
names are dotted paths (``layer4.sconv.mconv.dconv``), so a query may name
a stage or any enclosing prefix.  Weights are shared between slices because every slice
reads the one params dict passed at call time.  Each stage runs inside
``ops.precision.stage_scope(stage.name)``, where an installed precision
schedule reads its name (JAX package :75-82).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

from ..ops.precision import stage_scope
from .bag import DataBag

StageFn = Callable[[Dict[str, Any], DataBag], DataBag]


class Stage:
    """A named function over (params_subtree, bag)."""

    __slots__ = ("name", "fn")

    def __init__(self, name: str, fn: StageFn):
        self.name = name
        self.fn = fn

    def __repr__(self):
        return f"Stage({self.name!r})"


def _matches(stage_name: str, query: str) -> bool:
    """True if `query` names this stage or an enclosing dotted prefix."""
    return stage_name == query or stage_name.startswith(query + ".")


class StagePipeline:
    """An ordered, immutable sequence of named stages;
    ``pipeline(params, bag)`` applies every stage in order."""

    def __init__(self, stages: Sequence[Stage]):
        self.stages: Tuple[Stage, ...] = tuple(stages)
        names = [s.name for s in self.stages]
        if len(set(names)) != len(names):
            dupes = sorted({n for n in names if names.count(n) > 1})
            raise ValueError(f"duplicate stage names: {dupes}")

    def __call__(self, params: Dict[str, Any], bag: DataBag) -> DataBag:
        for stage in self.stages:
            # a stage fn may take the FULL params dict (fn._full_params =
            # True): the fused stages of pipeline_fast read the params of
            # several seq stages; the seq pipeline never does
            with stage_scope(stage.name):
                if getattr(stage.fn, "_full_params", False):
                    bag = stage.fn(params, bag)
                else:
                    bag = stage.fn(params.get(stage.name, {}), bag)
        return bag

    def stage_names(self) -> Tuple[str, ...]:
        return tuple(s.name for s in self.stages)

    def __len__(self):
        return len(self.stages)

    def __repr__(self):
        return f"StagePipeline({list(self.stage_names())})"

    def _span(self, query: str) -> Tuple[int, int]:
        """[start, end) indices of the stages matched by a dotted name."""
        idxs = [i for i, s in enumerate(self.stages) if _matches(s.name, query)]
        if not idxs:
            raise KeyError(f"no stage matches {query!r}; have "
                           f"{list(self.stage_names())}")
        lo, hi = min(idxs), max(idxs) + 1
        if idxs != list(range(lo, hi)):
            raise ValueError(f"stages matching {query!r} are not contiguous")
        return lo, hi

    def subsequence(
        self,
        first_layer: Optional[str] = None,
        last_layer: Optional[str] = None,
        after_layer: Optional[str] = None,
        upto_layer: Optional[str] = None,
    ) -> "StagePipeline":
        """Slice the pipeline: first/last are inclusive, after/upto are
        exclusive; an empty or inverted span raises ValueError."""
        if first_layer is not None and after_layer is not None:
            raise ValueError("give only one of first_layer/after_layer")
        if last_layer is not None and upto_layer is not None:
            raise ValueError("give only one of last_layer/upto_layer")
        start, stop = 0, len(self.stages)
        if first_layer is not None:
            start = self._span(first_layer)[0]
        elif after_layer is not None:
            start = self._span(after_layer)[1]
        if last_layer is not None:
            stop = self._span(last_layer)[1]
        elif upto_layer is not None:
            stop = self._span(upto_layer)[0]
        if start >= stop:
            raise ValueError(
                f"empty or inverted subsequence (first={first_layer!r} "
                f"after={after_layer!r} last={last_layer!r} "
                f"upto={upto_layer!r})")
        return StagePipeline(self.stages[start:stop])

    def param_names(self, params: Dict[str, Any]) -> Tuple[str, ...]:
        """The keys of `params` owned by stages of this pipeline."""
        return tuple(s.name for s in self.stages if s.name in params)


def subsequence(pipeline: StagePipeline, **kwargs) -> StagePipeline:
    """Functional alias of :meth:`StagePipeline.subsequence`."""
    return pipeline.subsequence(**kwargs)

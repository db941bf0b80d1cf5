from .bag import DataBag
from .stages import Stage, StagePipeline
from .tree import leaves, tree_map

__all__ = ["DataBag", "Stage", "StagePipeline", "leaves", "tree_map"]

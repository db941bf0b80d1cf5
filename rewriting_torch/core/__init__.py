from .bag import DataBag
from .stages import Stage, StagePipeline

__all__ = ["DataBag", "Stage", "StagePipeline"]

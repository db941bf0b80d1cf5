"""Segmenters: unified parsing, the texture and colour models, the face
parser, and the merged and null segmenters."""

from .segmenter import (BaseSegmenter, MergedSegmenter, NoSegmenter,
                        UnifiedParsingSegmenter, load_segmenter)

__all__ = ["BaseSegmenter", "MergedSegmenter", "NoSegmenter",
           "UnifiedParsingSegmenter", "load_segmenter"]

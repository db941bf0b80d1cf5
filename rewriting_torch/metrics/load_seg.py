"""Experiment -> segmenter and source/target label registry.

The port's counterpart of the JAX package's ``metrics/load_seg.py``
(reference metrics/load_seg.py): the registry, and ``load_seg_model``,
which builds an experiment's segmenter from the released weights in
``$REWRITING_TPU_WEIGHTS``.
"""

from __future__ import annotations

# BiSeNet face-parsing classes (reference load_seg.py:46); its predictions
# are 1-indexed
face_atts = ["skin", "l_brow", "r_brow", "l_eye", "r_eye", "eye_g",
             "l_ear", "r_ear", "ear_r", "nose", "mouth", "u_lip", "l_lip",
             "neck", "neck_l", "cloth", "hair", "hat"]
smile_src = [face_atts.index("u_lip") + 1, face_atts.index("l_lip") + 1,
             face_atts.index("mouth") + 1]

# experiment -> [segmenter, source channel, target channel, source labels,
# target labels] (reference load_seg.py:49-54)
info = {
    "dome2spire": ["netpqc", 2, 0, [1708], [5]],
    "church_clean": ["netpqc", None, None, None, None],
    "smile": ["face", 0, None, smile_src, None],
    "faces_clean": ["face", None, None, None, None],
}


def register_experiment(exp_name, segmenter_name, srcc, tgtc, srcs, tgts):
    """Add an experiment (dome2tree and dome2castle reuse dome2spire's
    pipeline with their own target labels)."""
    info[exp_name] = [segmenter_name, srcc, tgtc, srcs, tgts]


def load_seg_info_from_exp_name(exp_name: str):
    """(segmenter, source channel, target channel, source labels, target
    labels) of an experiment."""
    segmenter_name, srcc, tgtc, srcs, tgts = info[exp_name]
    return segmenter_name, srcc, tgtc, srcs, tgts


def load_seg_model(exp_name: str, device=None):
    """The segmenter of an experiment (reference load_seg.py:36-43): the
    face parser, or ``load_segmenter``'s; on `device` (default ``cuda``)."""
    seg_name = load_seg_info_from_exp_name(exp_name)[0]
    if seg_name == "face":
        from ..segment.faceparse import FaceSegmenter
        return FaceSegmenter(device=device)
    from ..segment import load_segmenter
    return load_segmenter(seg_name, device=device)[0]

"""Multi-field segmentation dataset over paired image/segmentation
folders with bit-packed label channels (reference utils/segdata.py:1-74).

The port's counterpart of the JAX package's ``utils/segdata.py``: images
are arrays as ``numpy.asarray`` of the JAX package's PIL images gives them
(``native.read_image``, which hands PIL what its own decoders do not
read).

Each dataset directory holds ``imgdir``/``segdir`` trees of corresponding
images plus a ``labelnames.json`` describing how labels are packed into
the segmentation image's channels: each field reads channel ``index``,
shifts by ``bitshift`` and masks with ``bitmask``.  Label id 0 is
reserved for "no label" and field label ranges are concatenated into one
global label space (reference segdata.py:36-52)."""

from __future__ import annotations

import json
import os
from typing import Callable, Optional

import numpy as np

from .parallelfolder import ParallelImageFolders


class FieldDef:
    """One bit-packed label field (reference segdata.py:6-12)."""

    def __init__(self, field, index, bitshift, bitmask, labels):
        self.field = field
        self.index = index
        self.bitshift = bitshift
        self.bitmask = bitmask
        self.labels = labels


class MultiSegmentDataset:
    """index -> (image, segout, bincount): the image as a uint8 array (or
    the transform's result), segout an (n_categories, H, W) int64 array in
    the global label space and bincount a per-label pixel histogram
    (reference segdata.py:55-68).
    The last 25% of the pairs are reserved for validation
    (reference segdata.py:45-52)."""

    def __init__(self, directory: str,
                 transform: Optional[Callable] = None,
                 imgdir: str = "img", segdir: str = "seg",
                 val: bool = False, size: Optional[int] = None):
        self.segdataset = ParallelImageFolders(
            [os.path.join(directory, imgdir),
             os.path.join(directory, segdir)],
            transform=[transform, None])
        self.fields = []
        with open(os.path.join(directory, "labelnames.json")) as f:
            for defn in json.load(f):
                self.fields.append(FieldDef(
                    defn["field"], defn["index"], defn["bitshift"],
                    defn["bitmask"], defn["label"]))
        self.labels = ["-"]  # label 0 reserved: "no label"
        self.categories = []
        self.label_category = [0]
        for fieldnum, field in enumerate(self.fields):
            self.categories.append(field.field)
            field.firstchannel = len(self.labels)
            field.channels = len(field.labels) - 1
            for lab in field.labels[1:]:
                self.labels.append(lab)
                self.label_category.append(fieldnum)
        first_val = int(len(self.segdataset) * 0.75)
        self.val = val
        self.first = first_val if val else 0
        self.length = (len(self.segdataset) - first_val if val
                       else first_val)
        if size:
            self.length = min(size, self.length)

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, index: int):
        img, segimg = self.segdataset[index + self.first]
        segin = np.asarray(segimg, np.uint8)
        if segin.ndim == 2:
            segin = segin[..., None]
        segout = np.zeros((len(self.categories),) + segin.shape[:2],
                          np.int64)
        for i, field in enumerate(self.fields):
            fielddata = ((segin[:, :, field.index].astype(np.int64)
                          >> field.bitshift) & field.bitmask)
            # reference formula (segdata.py:62-65) with one fix: an
            # unlabeled pixel (fielddata 0) maps to the reserved global 0
            # for EVERY field — upstream's firstchannel+data-1 bleeds it
            # into the previous field's last label for fields > 0.
            segout[i] = np.where(fielddata == 0, 0,
                                 field.firstchannel + fielddata - 1)
        bincount = np.bincount(segout.flatten(),
                               minlength=len(self.labels))
        return img, segout, bincount

"""Segmenters: unified parsing ('netpqc'), merged and null segmenters, and
the loader of the released models.

The port's counterpart of the JAX package's ``segment/segmenter.py``
(reference utils/segmenter.py).  Every segmenter keeps one contract:
``segment_batch(images)`` takes (B, H, W, 3) images, a tensor in [-1, 1]
or uint8 (numpy arrays are moved to the segmenter's device), and returns
(B, M, H, W) int64 label maps on the device.  For unified parsing channel
0 is the object class, 1 the material (offset into the shared numbering),
2 the part, and with quads 3-4 the quadrant-divided objects (reference
segment_batch, segmenter.py:281-318).  The quads' 8-connected components
are found on the host (scipy), the labels moved down and back.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..core.tree import tree_map
from ..utils.device import resolve_device
from .nn import adaptive_avg_pool
from .upernet import UPerNet

# BGR mean subtraction (reference segmenter.py:255-258: the released model
# was trained on BGR caffe-style inputs)
MEAN_BGR = (102.9801, 115.9465, 122.7717)


def to_device(params, device):
    """A params tree as float32 tensors on `device`."""
    return tree_map(lambda t: torch.as_tensor(t, dtype=torch.float32)
                    .to(device), params)


def as_images(images, device=None) -> torch.Tensor:
    """(B, H, W, 3) images as a tensor on `device` (default: where they
    are)."""
    x = torch.as_tensor(images)
    return x if device is None else x.to(device)


class BaseSegmenter:
    def get_label_and_category_names(self):
        raise NotImplementedError

    def segment_batch(self, tensor_images, downsample=1):
        raise NotImplementedError

    def predict_single_class(self, tensor_images, classnum, downsample=1):
        raise NotImplementedError


class NoSegmenter(BaseSegmenter):
    """(reference segmenter.py:116-147); its labels lie where the images
    do."""

    def get_label_and_category_names(self):
        return [("-", "-")], ["-"]

    def segment_batch(self, tensor_images, downsample=1):
        x = as_images(tensor_images)
        return torch.zeros((x.shape[0], 1, x.shape[1] // downsample,
                            x.shape[2] // downsample), dtype=torch.int64,
                           device=x.device)

    def predict_single_class(self, tensor_images, classnum, downsample=1):
        x = as_images(tensor_images)
        shape = (x.shape[0], x.shape[1] // downsample,
                 x.shape[2] // downsample)
        return (torch.zeros(shape, device=x.device),
                torch.zeros(shape, dtype=torch.bool, device=x.device))


class MergedSegmenter(BaseSegmenter):
    """Several segmenters' channels side by side, each one's labels
    appended and its label values shifted by the labels before it,
    background included, as the reference does (segmenter.py:82-113)."""

    def __init__(self, component_segmenters: Sequence[BaseSegmenter]):
        self.segmenters = list(component_segmenters)
        # uint8 images go to segment_batch when every component takes them
        self.accepts_uint8 = all(getattr(s, "accepts_uint8", False)
                                 for s in self.segmenters)
        self.labels = []
        self.cats = []
        self.offsets = []
        for seg in self.segmenters:
            self.offsets.append(len(self.labels))
            labels, cats = seg.get_label_and_category_names()
            self.labels.extend(labels)
            for c in cats:
                if c not in self.cats:
                    self.cats.append(c)

    def get_label_and_category_names(self):
        return self.labels, self.cats

    def segment_batch(self, tensor_images, downsample=1):
        return torch.cat([seg.segment_batch(tensor_images, downsample) + off
                          for off, seg in zip(self.offsets, self.segmenters)],
                         dim=1)

    def predict_single_class(self, tensor_images, classnum, downsample=1):
        """A merged class number, routed to the segmenter that owns it
        (reference segmenter.py:107-113)."""
        seg = self.segmenters[-1]
        for i, s in enumerate(self.segmenters):
            if i + 1 == len(self.offsets) or \
                    classnum < self.offsets[i + 1]:
                seg = s
                classnum -= self.offsets[i]
                break
        return seg.predict_single_class(tensor_images, classnum,
                                        downsample=downsample)


def _components(seg_batch: np.ndarray):
    """(image index, bounding box, the component's mask within it) of each
    connected component of each image's object map, per class value,
    8-connected (the reference's skimage.morphology.label)."""
    import scipy.ndimage
    eight = np.ones((3, 3), int)
    for i, seg in enumerate(seg_batch):
        for value in np.unique(seg):
            if value == 0:
                continue
            labeled, _ = scipy.ndimage.label(seg == value, structure=eight)
            for comp, box in enumerate(scipy.ndimage.find_objects(labeled),
                                       start=1):
                yield i, box, labeled[box] == comp


def _object_part(labeldata: Dict):
    """(object name -> number, {object number: [part numbers]}) of a
    labels json."""
    object_to_num = {k: v for v, k in enumerate(labeldata["object"])}
    part_to_num = {k: v for v, k in enumerate(labeldata["part"])}
    object_part = {object_to_num[k]: [part_to_num[p] for p in v]
                   for k, v in labeldata["object_part"].items()}
    return object_to_num, object_part


def upernet_for(labeldata: Dict) -> UPerNet:
    """The UPerNet whose heads a labels json describes."""
    _, object_part = _object_part(labeldata)
    return UPerNet({"object": len(labeldata["object"]),
                    "part": sum(len(v) for v in object_part.values()),
                    "material": len(labeldata["material"]),
                    "scene": len(labeldata.get("scene", ["-"]))},
                   sorted(object_part.keys()), object_part)


class UnifiedParsingSegmenter(BaseSegmenter):
    """The 'netpqc' multilabel segmenter (reference segmenter.py:150-389):
    multi-resolution voting over softmax maps, the shared
    object/material/part numbering, optional quad subdivision.  Takes a
    labels json's dict and UPerNet params; on `device` (default
    ``cuda``)."""

    def __init__(self, params, labeldata: Dict, segsizes=None, segdiv=None,
                 all_parts: bool = False, device=None):
        self.device = resolve_device(device)
        self.segsizes = segsizes or [256]
        self.segdiv = segdiv or "undivided"
        mult = 5 if self.segdiv == "quad" else 1
        self.divmult = mult
        self.labeldata = labeldata
        object_to_num, object_part = _object_part(labeldata)
        object_with_part = sorted(object_part.keys())
        self.net = upernet_for(labeldata)
        self.params = to_device(params, self.device)

        # the shared numbering: 0, objects, [divided], materials, parts
        # (reference segmenter.py:179-216)
        first_partnumber = ((len(labeldata["object"]) - 1) * mult + 1
                            + (len(labeldata["material"]) - 1))
        if all_parts:
            partobjects = list(labeldata["object_part"].keys())
        else:
            partobjects = [p for p in ["sky", "building", "person"]
                           if p in labeldata["object_part"]]
        partnumbers, partnames = {}, []
        part_index = []
        for owner in partobjects:
            numeric = []
            for part in labeldata["object_part"][owner]:
                if part in object_to_num:
                    numeric.append(object_to_num[part])
                elif part in partnumbers:
                    numeric.append(partnumbers[part])
                else:
                    partnumbers[part] = len(partnames) + first_partnumber
                    partnames.append(part)
                    numeric.append(partnumbers[part])
            part_index.append(np.array(numeric, np.int64))
        self.objects_with_parts = [object_to_num[o] for o in partobjects]
        self._owner_head = {object_to_num[o]: object_with_part.index(
            object_to_num[o]) for o in partobjects}
        self.part_index = part_index
        self._part_index = [torch.as_tensor(t, device=self.device)
                            for t in part_index]
        self.part_names = partnames
        self.num_classes = (1 + (len(labeldata["object"]) - 1) * mult
                            + (len(labeldata["material"]) - 1)
                            + len(partnames))
        self.num_object_classes = len(labeldata["object"]) - 1

    # segment_batch takes uint8 images and normalizes them on the device:
    # the drivers hand it their bytes (metrics/seg_stats.py).  Its 1847
    # labels do not fit a byte, so it has no uint8 segment_batch_device.
    accepts_uint8 = True

    def get_label_and_category_names(self):
        """(reference segmenter.py:220-242)"""
        suffixes = ["t", "l", "b", "r"] if self.segdiv == "quad" else []
        divided = [("%s-%s" % (label, s), "part")
                   for s in suffixes
                   for label in self.labeldata["object"][1:]]
        labelcats = (
            [(label, "object") for label in self.labeldata["object"]]
            + divided
            + [(label, "material")
               for label in self.labeldata["material"][1:]]
            + [(label, "part") for label in self.part_names])
        return labelcats, ["object", "part", "material"]

    def normalize(self, tensor_images):
        """(B, 3, H, W) model input of (B, H, W, 3) images in [-1, 1], or
        uint8 (the model's own 0-255 scale: the bytes go straight to the
        BGR mean subtraction)."""
        x = as_images(tensor_images, self.device)
        if x.dtype == torch.uint8:
            x = x.float()
        else:
            x = (x.float() + 1.0) / 2.0 * 255.0
        x = x.flip(-1) - torch.tensor(MEAN_BGR, device=self.device)
        return x.permute(0, 3, 1, 2)

    def raw_seg_prediction(self, tensor_images, downsample: int = 1):
        """Multi-resolution voting on softmax maps (reference
        segmenter.py:244-280): ``({"object", "material"}: (B, C, h, w),
        {owner's index: (B, parts, h, w)})``."""
        x = self.normalize(tensor_images)
        y, xdim = x.shape[-2:]
        seg_shape = (y // downsample, xdim // downsample)
        pred = {k: 0.0 for k in ["object", "material"]}
        part_pred = {i: 0.0 for i in range(len(self.part_index))}
        with torch.no_grad():
            for s in self.segsizes:
                resized = x if (s, s) == (y, xdim) else \
                    adaptive_avg_pool(x, (s, s))
                r = self.net(self.params, resized, seg_size=seg_shape)
                for k in pred:
                    pred[k] = pred[k] + r[k]
                for i, owner in enumerate(self.objects_with_parts):
                    part_pred[i] = part_pred[i] + r["part"][
                        self._owner_head[owner]]
        return pred, part_pred

    def segment_batch(self, tensor_images, downsample: int = 1):
        """(B, 3 [+2], H, W) int64 multilabel maps on the device
        (reference segmenter.py:281-318)."""
        pred, part_pred = self.raw_seg_prediction(tensor_images, downsample)
        obj = torch.argmax(pred["object"], dim=1)
        mat = torch.argmax(pred["material"], dim=1)
        b, h, w = obj.shape
        channels = 5 if self.segdiv == "quad" else 3
        segs = torch.zeros((b, channels, h, w), dtype=torch.int64,
                           device=obj.device)
        segs[:, 0] = obj
        offset = (len(self.labeldata["object"]) - 1) * self.divmult
        segs[:, 1] = torch.where(mat == 0, 0, mat + offset)
        for i, object_index in enumerate(self.objects_with_parts):
            part = self._part_index[i][torch.argmax(part_pred[i], dim=1)]
            segs[:, 2] = torch.where(segs[:, 0] == object_index, part,
                                     segs[:, 2])
        if self.segdiv == "quad":
            segs = torch.as_tensor(self.expand_segment_quad(
                segs.cpu().numpy()), device=segs.device)
        return segs

    def predict_single_class(self, tensor_images, classnum: int,
                             downsample: int = 1):
        """(the class's score map, its argmax mask), each (B, H, W)
        (reference segmenter.py:320-361)."""
        pred, part_pred = self.raw_seg_prediction(tensor_images, downsample)
        material_offset = (len(self.labeldata["object"]) - 1) * self.divmult
        if material_offset < classnum < material_offset + len(
                self.labeldata["material"]):
            c = classnum - material_offset
            return (pred["material"][:, c],
                    torch.argmax(pred["material"], dim=1) == c)
        result, mask = None, None
        if classnum < len(self.labeldata["object"]):
            result = pred["object"][:, classnum]
            mask = torch.argmax(pred["object"], dim=1) == classnum
        for i, object_index in enumerate(self.objects_with_parts):
            local = np.nonzero(self.part_index[i] == classnum)[0]
            if len(local) == 0:
                continue
            local = int(local[0])
            mask2 = (torch.argmax(pred["object"], dim=1) == object_index) \
                & (torch.argmax(part_pred[i], dim=1) == local)
            mask = mask2 if mask is None else (mask | mask2)
            add = part_pred[i][:, local]
            result = add if result is None else result + add
        if result is None:
            raise ValueError(f"unrecognized class {classnum}")
        return result, mask

    def expand_segment_quad(self, segs: np.ndarray):
        """Split each object component into t/l/b/r quadrant labels, on the
        host (reference segmenter.py:363-389), within its bounding box."""
        segs[:, 3:] = segs[:, 0:1]
        n = self.num_object_classes
        for i, box, mask in _components(segs[:, 0]):
            rows = np.nonzero(mask.any(axis=1))[0]
            cols = np.nonzero(mask.any(axis=0))[0]
            vmid = (rows[0] + rows[-1] + 1) // 2
            hmid = (cols[0] + cols[-1] + 1) // 2
            quad = np.repeat(mask[None], 4, axis=0).astype(np.int64)
            quad[0, vmid:, :] = 0  # top
            quad[1, :, hmid:] = 0  # right
            quad[2, :vmid, :] = 0  # bottom
            quad[3, :, :hmid] = 0  # left
            segs[i, 3][box] += quad[0] * n + quad[2] * (3 * n)
            segs[i, 4][box] += quad[1] * (2 * n) + quad[3] * (4 * n)
        small = segs[:, 3:] <= n
        segs[:, 3:][small] = 0
        return segs


# -- the loader ----------------------------------------------------------------

def load_segmenter(segmenter_name: str = "netpqc", params=None,
                   labeldata: Optional[Dict] = None, device=None):
    """(segmenter, label list) (reference utils/segmenter.py:16-41).  The
    flags after 'net': p all parts, q quad subdivision, x the texture
    model, c the colour model; 'netpqc' is unified parsing with all parts
    and quads, merged with the colour segmenter.  Without `params` and
    `labeldata` the released unified-parsing model is read from
    ``$REWRITING_TPU_WEIGHTS/upp/``.  On `device` (default ``cuda``)."""
    if not segmenter_name.startswith("net"):
        raise ValueError(f"unknown segmenter {segmenter_name!r}")
    device = resolve_device(device)
    flags = segmenter_name[3:]
    segdiv = "quad" if "q" in flags else None
    all_parts = "p" in flags
    if params is None or labeldata is None:
        params, labeldata = _load_released_upp()
    segmodels = [UnifiedParsingSegmenter(params, labeldata, segdiv=segdiv,
                                         all_parts=all_parts, device=device)]
    if "x" in flags:
        segmodels.append(_load_released_semantic("texture", device))
    if "c" in flags:
        segmodels.append(_load_released_semantic("color", device))
    seg = segmodels[0] if len(segmodels) == 1 else \
        MergedSegmenter(segmodels)
    labels, cats = seg.get_label_and_category_names()
    return seg, [label for label, cat in labels]


def _load_released_semantic(vocab: str, device):
    """A released texture or colour segmenter from
    ``$REWRITING_TPU_WEIGHTS/segmodel/{vocab}-resnet18dilated-ppm_deepsup/``:
    ``encoder_epoch_*.pth``, ``decoder_epoch_*.pth`` and ``labels.json``
    (reference ensure_segmenter_downloaded, segmenter.py:651-669)."""
    from ..models.zoo import load_state, weights_dir
    from .semantic import (PPMDecoder, SemanticSegmenter,
                           resnet18_deepstem_from_torch)
    base = os.path.join(weights_dir(), "segmodel",
                        f"{vocab}-resnet18dilated-ppm_deepsup")
    encs = sorted(glob.glob(os.path.join(base, "encoder_epoch_*.pth")))
    decs = sorted(glob.glob(os.path.join(base, "decoder_epoch_*.pth")))
    lab = os.path.join(base, "labels.json")
    if not (encs and decs and os.path.exists(lab)):
        raise FileNotFoundError(
            f"{vocab} semantic model not found under {base}; place "
            "encoder/decoder epoch .pth and labels.json from the "
            "netdissect segmodel release there.")
    with open(lab) as f:
        meta = json.load(f)
    label_names = [(label["name"] if isinstance(label, dict) else str(label))
                   for label in meta["labels"]]
    dec = PPMDecoder(num_class=len(label_names), fc_dim=512)
    params = {"encoder": resnet18_deepstem_from_torch(load_state(encs[-1])),
              "decoder": dec.params_from_torch(load_state(decs[-1]))}
    return SemanticSegmenter(params, label_names, arch="resnet18dilated",
                             category=vocab,
                             imageformat=meta.get("imageformat"),
                             segsizes=meta.get("segsizes", [256]),
                             device=device)


def _load_released_upp():
    """(params, labels json) of the released unified-parsing model under
    ``$REWRITING_TPU_WEIGHTS/upp/``: ``encoder_epoch_40.pth``,
    ``decoder_epoch_40.pth``, ``labels.json``."""
    from ..models.zoo import load_state, weights_dir
    base = os.path.join(weights_dir(), "upp")
    enc = os.path.join(base, "encoder_epoch_40.pth")
    dec = os.path.join(base, "decoder_epoch_40.pth")
    lab = os.path.join(base, "labels.json")
    if not all(os.path.exists(p) for p in [enc, dec, lab]):
        raise FileNotFoundError(
            f"unified-parsing checkpoint not found under {base}; place "
            "encoder_epoch_40.pth / decoder_epoch_40.pth / labels.json "
            "from the CSAIL unifiedparsing release there.")
    with open(lab) as f:
        labeldata = json.load(f)
    net = upernet_for(labeldata)
    return net.params_from_torch(load_state(enc), load_state(dec)), labeldata

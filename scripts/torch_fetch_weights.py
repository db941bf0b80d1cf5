"""Fetch the published weights and edit requests where the port reads them.

The port's counterpart of ``scripts/fetch_weights.py``, with its groups and
URLs; it imports only the port, so it runs where jax is absent:

    export REWRITING_TPU_WEIGHTS=/path/to/weights  # else ~/.cache/...
    python3 scripts/torch_fetch_weights.py [--only stylegan2 proggan ...]

The zoo's and the mask registry's URLs are the port's own constants
(``models/zoo.py``, ``metrics/load_mask.py``).  Every file lands where the
port's readers look: the checkpoints, ``pt_inception-2015-12-05.pth``,
``vgg16_features.pth`` (torchvision's VGG16, which ``metrics/distances.py``
reads under that name), ``face-parsing-02dd3f6f.pth``, ``celeba_20.pth``
and ``upp/`` in ``$REWRITING_TPU_WEIGHTS``; the edit requests in
``$REWRITING_TPU_MASKS/<dataset>/`` (else ``./masks``).  A file already
present is kept; a fetched one is written through ``.tmp`` and moved into
place whole.  A failed fetch is reported and the rest go on; the exit code
is then 1.  The last line is a JSON summary: files fetched, present and
failed.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from rewriting_torch.metrics import fid, load_mask, slimnet  # noqa: E402
from rewriting_torch.models import zoo  # noqa: E402
from rewriting_torch.segment import faceparse  # noqa: E402
from rewriting_torch.utils import download  # noqa: E402

UPP_BASE = "http://netdissect.csail.mit.edu/data/segmodel/upp-resnet50-upernet"
UPP_FILES = ["decoder_epoch_40.pth", "encoder_epoch_40.pth", "labels.json"]
FACE_URL = ("https://rewriting.csail.mit.edu/data/models/"
            "face-parsing-02dd3f6f.pth")
FID_INCEPTION_URL = ("https://github.com/mseitzer/pytorch-fid/releases/"
                     "download/fid_weights/pt_inception-2015-12-05-"
                     "6726825d.pth")
VGG16_URL = "https://download.pytorch.org/models/vgg16-397923af.pth"
SLIMNET_URL = ("https://github.com/gtamba/pytorch-slim-cnn/raw/master/"
               "models/celeba_20.pth")
GROUPS = ("stylegan2", "proggan", "upp", "face", "fid", "vgg", "slimnet",
          "masks")


def plan(groups) -> list:
    """[(url, destination)] of the files of `groups`, in the order of
    ``GROUPS``."""
    wd = zoo.weights_dir()
    files = []
    if "stylegan2" in groups:
        files += [(zoo.STYLEGAN2_URL + name, os.path.join(wd, name))
                  for name, _ in zoo.STYLEGAN2_ZOO.values()]
    if "proggan" in groups:
        files += [(zoo.PROGGAN_URL + name, os.path.join(wd, name))
                  for name in zoo.PROGGAN_ZOO.values()]
    if "upp" in groups:
        files += [(f"{UPP_BASE}/{name}", os.path.join(wd, "upp", name))
                  for name in UPP_FILES]
    if "face" in groups:
        files.append((FACE_URL, os.path.join(wd, faceparse.WEIGHTS_FILENAME)))
    if "fid" in groups:
        files.append((FID_INCEPTION_URL, os.path.join(wd, fid.WEIGHTS_FILENAME)))
    if "vgg" in groups:
        files.append((VGG16_URL, os.path.join(wd, "vgg16_features.pth")))
    if "slimnet" in groups:
        files.append((SLIMNET_URL, os.path.join(wd, slimnet.WEIGHTS_FILENAME)))
    if "masks" in groups:
        files += [(load_mask.MASK_URLS + name,
                   os.path.join(load_mask.masks_dir(), dataset, name))
                  for dataset, name, _ in load_mask.name2info.values()]
    return files


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--only", nargs="*", default=None, choices=GROUPS,
                    help="a subset of the groups (default: all)")
    args = ap.parse_args(argv)
    groups = set(args.only or GROUPS)
    fetched = have = 0
    failed = []
    for url, dest in plan(groups):
        if os.path.exists(dest):
            print("have", dest)
            have += 1
            continue
        print("fetch", url, "->", dest, flush=True)
        try:
            download.fetch(url, dest)
            fetched += 1
        except download.ERRORS as e:
            print(f"FAILED {url}: {e}", file=sys.stderr)
            failed.append(url)
    print(json.dumps({"fetched": fetched, "have": have,
                      "failed": len(failed), "weights": zoo.weights_dir(),
                      "masks": load_mask.masks_dir()}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

"""The port's real-weights runbook: which published files are present, then
the gated suite ``tests/test_torch_real_weights.py`` on them.

The port's counterpart of ``scripts/real_weights_report.py``; it imports
only the port, so it runs where jax is absent:

    export REWRITING_TPU_WEIGHTS=/path/to/weights
    python3 scripts/torch_fetch_weights.py        # where a network is at hand
    python3 scripts/torch_real_weights_report.py

It lists each artifact under the names the port reads (present files of
all), runs the suite in a child pytest, and prints one JSON line an
artifact with the passes, skips and failures of the tests that need it,
then one JSON line of the totals.  A test skips only for a missing file;
the exit code is 1 if any test failed or errored (or the suite did not
run), else 0.  The reference-side fixtures under ``goldens/`` are written
by the JAX package's ``scripts/make_goldens.py`` where the reference code
is at hand; this script only looks for them.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import xml.etree.ElementTree as ET

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from rewriting_torch.metrics import load_mask  # noqa: E402
from rewriting_torch.models import zoo  # noqa: E402

SUITE = os.path.join("tests", "test_torch_real_weights.py")


def artifacts() -> dict:
    """{artifact: [its files]}, each in the place the port reads it."""
    wd, masks = zoo.weights_dir(), load_mask.masks_dir()
    return {
        "stylegan2 zoo": [os.path.join(wd, name)
                          for name, _ in zoo.STYLEGAN2_ZOO.values()],
        "proggan zoo": [os.path.join(wd, name)
                        for name in zoo.PROGGAN_ZOO.values()],
        "FID inception": [os.path.join(wd, "pt_inception-2015-12-05.pth")],
        "VGG16 (LPIPS)": [os.path.join(wd, "vgg16_features.pth")],
        "LPIPS lin heads": [os.path.join(wd, "lpips_vgg_lins.pth")],
        "unified parsing segmenter": [
            os.path.join(wd, "upp", name) for name in (
                "encoder_epoch_40.pth", "decoder_epoch_40.pth",
                "labels.json")],
        "face parser": [os.path.join(wd, "face-parsing-02dd3f6f.pth")],
        "SlimNet": [os.path.join(wd, "celeba_20.pth")],
        "published masks": [os.path.join(masks, dataset, name) for
                            dataset, name, _ in load_mask.name2info.values()],
        "forward fixtures": [os.path.join(wd, "goldens", name) for name in (
            "stylegan2_church_forward.npz", "proggan_church_forward.npz")],
        "FID parity value": [os.path.join(wd, "goldens", "fid_parity.json")],
    }


# each test of the suite -> the artifacts it needs
NEEDS = {
    "test_stylegan2_zoo_loads_and_renders": ["stylegan2 zoo"],
    "test_proggan_zoo_loads_and_renders": ["proggan zoo"],
    "test_stylegan2_church_matches_reference_torch": ["stylegan2 zoo",
                                                      "forward fixtures"],
    "test_proggan_church_matches_reference_torch": ["proggan zoo",
                                                    "forward fixtures"],
    "test_fid_real_inception_self_consistency": ["FID inception"],
    "test_fid_matches_pytorch_fid_reference": ["FID inception",
                                               "FID parity value"],
    "test_upernet_real_weights_labels_church": ["unified parsing segmenter",
                                                "stylegan2 zoo"],
    "test_lpips_real_lin_heads_convert_and_rescale": ["VGG16 (LPIPS)",
                                                      "LPIPS lin heads"],
    "test_lpips_real_vgg_monotone": ["VGG16 (LPIPS)"],
    "test_published_mask_drives_edit": ["stylegan2 zoo", "published masks"],
    "test_slimnet_real_checkpoint_loads_and_classifies": ["SlimNet"],
}


def outcomes(junit_xml: str) -> dict:
    """{test id: "passed" | "skipped" | "failed"} of a junit report."""
    out = {}
    for case in ET.parse(junit_xml).getroot().iter("testcase"):
        kinds = {child.tag for child in case}
        out[case.get("name")] = (
            "failed" if kinds & {"failure", "error"} else
            "skipped" if "skipped" in kinds else "passed")
    return out


def main(argv=None) -> int:
    argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawTextHelpFormatter).parse_args(argv)
    table = artifacts()
    print(f"== artifacts ($REWRITING_TPU_WEIGHTS {zoo.weights_dir()}, "
          f"masks {load_mask.masks_dir()})")
    for name, files in table.items():
        have = sum(os.path.isfile(f) for f in files)
        print(f"  {'OK  ' if have == len(files) else 'MISS'} {name} "
              f"({have}/{len(files)} files)")

    print("== gated suite", SUITE, flush=True)
    with tempfile.TemporaryDirectory(prefix="real_weights_") as tmp:
        xml = os.path.join(tmp, "suite.xml")
        # --noconftest: tests/conftest.py sets up jax for the JAX
        # package's tests, and the suite needs none of it
        cmd = [sys.executable, "-m", "pytest", SUITE, "--noconftest", "-v",
               "-rs", "--tb=short", "-p", "no:cacheprovider",
               f"--junitxml={xml}"]
        rc = subprocess.run(cmd, cwd=ROOT).returncode
        results = outcomes(xml) if os.path.isfile(xml) else {}

    print("== report")
    totals = {"passed": 0, "skipped": 0, "failed": 0}
    counts = {name: dict(totals) for name in table}
    for test, outcome in results.items():
        totals[outcome] += 1
        for name in NEEDS.get(test.split("[")[0], ()):
            counts[name][outcome] += 1
    for name, files in table.items():
        print(json.dumps({"artifact": name, "present": sum(
            os.path.isfile(f) for f in files), "files": len(files),
            **counts[name]}))
    print(json.dumps({"suite": SUITE, "pytest_rc": rc, **totals}))
    if totals["failed"] or rc not in (0, 5) or not results:
        print("FAILURES above: the port disagrees with the reference on "
              "real files, or the suite did not run", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

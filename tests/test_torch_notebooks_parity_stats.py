"""The port's dome2tree segmentation statistics notebook against the
JAX notebook on the same weights (the generator's and the segmenter's,
carried across as tests/test_torch_notebooks_parity.py does): the
sampled PNGs before and after the edit within 1 LSB; ``before_counts``
and ``after_counts`` equal but for pixels whose top-two object score
margin is 1e-4 or less (the repo's label rule: such pixels may take
either label), and ``moved`` within the share of such pixels.  Both
notebooks run at their own tiny sizes (24 images of a 16-px ProgGAN)."""

import os

import numpy as np
import torch

from rewriting_torch.utils.renormalize import decode_png
from test_torch_notebooks_parity import LSB, run_pair

torch.set_num_threads(1)

MARGIN = 1e-4               # labels where the top-two margin exceeds it


def unsure_pixels(segmodel, path, n):
    """The count of pixels of {path}/{i}.png, i < n, whose object label
    has a top-two score margin of MARGIN or less."""
    from rewriting_torch.native import read_image_rgb
    from rewriting_torch.utils.renormalize import renormalize
    imgs = np.stack([renormalize(read_image_rgb(os.path.join(
        path, f"{i}.png")).astype(np.float32) / 255.0, "pt", "zc")
        for i in range(n)])
    pred, _ = segmodel.raw_seg_prediction(torch.as_tensor(imgs))
    top = pred["object"].topk(2, dim=1).values
    return int((top[:, 0] - top[:, 1] <= MARGIN).sum())


def test_dome2tree_matches_the_jax_notebook(tmp_path):
    with run_pair("stats/segmentation-stats-dome2tree", tmp_path,
                  carry_segmenter=True) as (jns, tns):
        n = tns["n_images"]
        assert n == jns["n_images"] and tns["seglabels"] == \
            list(jns["seglabels"])
        for key in ("before_dir", "after_dir"):
            for i in range(n):
                a, b = (decode_png(open(os.path.join(ns[key], f"{i}.png"),
                                        "rb").read()).astype(np.int16)
                        for ns in (jns, tns))
                assert np.abs(a - b).max() <= LSB, (key, i)
        total = int(tns["total"])
        unsure = 0
        for key, counts in (("before_dir", "before_counts"),
                            ("after_dir", "after_counts")):
            diff = np.abs(tns[counts] - np.asarray(jns[counts])).sum()
            # each pixel labelled apart moves one count between two labels
            here = unsure_pixels(tns["segmodel"], tns[key], n) if diff else 0
            unsure += here
            assert diff <= 2 * here, (counts, diff, here)
        assert abs(tns["moved"] - jns["moved"]) <= unsure / total

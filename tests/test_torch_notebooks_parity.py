"""The port's editing interface and reflection study against the JAX
notebooks on the same weights (tests/test_torch_notebooks_parity_stats.py
holds the dome2tree segmentation statistics likewise), and phase 40's
check of the notebooks on the CPU.

Each pair runs in one sandbox (``chip_smoke.notebook_sandbox``: an empty
``$REWRITING_TPU_WEIGHTS``, and both packages' publication URLs at a
closed loopback port, so both take their tiny branch).  The JAX
notebook runs first, on the CPU; its generator's params (and, for
dome2tree, its segmenter's) are carried into the port notebook by cells
run after the port's model and segmenter cells (``convert.
params_from_jax``, ``tree_from_jax``): the JAX tiny branch draws its
params from ``jax.random``, which the port does not reproduce.  Then:
- interface: ``zds``'s z equal; the nine canvases' pixels within 1 LSB;
  the edited layer's weight as the same edit: the difference within 1e-2
  of the change in norm (measured 9.1e-4) and within one Adam step (the
  learning rate, 0.05) at each element (measured 0.037).  The solve's L1
  gradient is a sign, so a rounding tie broken the other way moves an
  element by a whole step (tests/test_torch_rewriter.py's rule): the
  weights do not agree to 1e-4 of their max abs (measured 7.1e-3);
- reflection: ``unit`` equal, ``acts``, ``imgs`` and ``edited`` within
  atol 2e-5 and rtol 1e-4 (tests/test_torch_proggan.py's).
"""

import base64
import contextlib
import pathlib
import re

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from rewriting_torch.metrics import load_mask
from rewriting_torch.models import zoo
from rewriting_torch.utils.renormalize import decode_png
from rewriting_tpu.metrics import load_mask as jax_load_mask
from rewriting_tpu.models import zoo as jax_zoo

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
EDIT_TOL = 1e-2             # |weight - JAX's| over |the change|, in norm
ADAM_STEP = 0.05            # the solve's learning rate
LSB = 1
ATOL, RTOL = 2e-5, 1e-4     # ProgGAN renders (tests/test_torch_proggan.py)

CARRY_PARAMS = """\
from rewriting_torch.convert import params_from_jax
params = params_from_jax(model, JAX_PARAMS)
"""
CARRY_SEGMENTER = """\
from rewriting_torch.convert import tree_from_jax
segmodel, seglabels = load_segmenter(
    'netq', params=tree_from_jax(JAX_SEG_PARAMS, device),
    labeldata=labeldata, device=device)
"""


def closed_publication_servers():
    """Both packages' zoo and mask registry URLs at a loopback port nothing
    listens on, within: each downloads a missing file, so a notebook's
    miss fails at once, reaching no other host, and it takes its tiny
    branch."""
    return chip_smoke.publication_urls(chip_smoke.closed_url(), zoo,
                                       load_mask, jax_zoo, jax_load_mask)


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@contextlib.contextmanager
def run_pair(name, tmp_path, carry_segmenter=False):
    """(JAX namespace, port namespace) of notebook `name`, run in one
    sandbox, the port on the JAX notebook's weights; the sandbox (where
    the notebooks' directories are) lasts as long as the context."""
    weights = tmp_path / "weights"
    weights.mkdir()
    with closed_publication_servers(), chip_smoke.notebook_sandbox(
            REWRITING_TPU_WEIGHTS=str(weights)):
        jns = chip_smoke.run_notebook(str(ROOT / "notebooks" /
                                          f"{name}.ipynb"))
        ns = {"__name__": "__main__",
              "JAX_PARAMS": numpy_tree(jns["params"])}
        overrides = {0: "device = 'cpu'", 1: CARRY_PARAMS}
        if carry_segmenter:
            ns["JAX_SEG_PARAMS"] = numpy_tree(jns["segmodel"].params)
            overrides[2] = CARRY_SEGMENTER
        tns = chip_smoke.run_notebook(
            str(ROOT / "notebooks" / "torch" / f"{name}.ipynb"), overrides,
            ns)
        yield jns, tns


def pixels(url):
    data = base64.b64decode(re.sub("^data:image/.+;base64,", "", url))
    return decode_png(data).astype(np.int16)


def test_interface_matches_the_jax_notebook(tmp_path):
    with run_pair("rewriting-interface", tmp_path) as (jns, tns):
        assert jns["real_weights"] is False and tns["real_weights"] is False
        np.testing.assert_array_equal(tns["zds"].zs, jns["zds"].zs)
        want = np.asarray(jns["gw"].target_weight())
        got = tns["gw"].target_weight().numpy()
        before = tns["gw"].original_params[tns["gw"].weight_stage()][
            "weight"].numpy()
        change = np.linalg.norm(want - before)
        assert change > 0.1 * np.linalg.norm(before)   # the edit moved it
        assert np.linalg.norm(got - want) <= EDIT_TOL * change
        assert np.abs(got - want).max() <= ADAM_STEP
        assert len(tns["interface"].canvases) == 9
        for a, b in zip(jns["interface"].canvases,
                        tns["interface"].canvases):
            assert np.abs(pixels(a.image) - pixels(b.image)).max() <= LSB


def test_reflection_matches_the_jax_notebook(tmp_path):
    with run_pair("reflection-rule-change", tmp_path) as (jns, tns):
        assert tns["unit"] == jns["unit"]
        for key in ("acts", "imgs", "edited"):
            np.testing.assert_allclose(tns[key], np.asarray(jns[key]),
                                       atol=ATOL, rtol=RTOL, err_msg=key)
        # the ablation changed the renders
        assert np.abs(tns["edited"] - tns["imgs"][:4]).max() > 1e-3


def test_phase40_runs_on_the_cpu_when_asked(tmp_path):
    """``chip_smoke.check_notebooks`` with ``device="cpu"`` on seeded
    checkpoints under their released names: reflection on ProgGAN
    kitchen-256 (held against its own CPU run) and the attribute
    comparison with the face parser, each on its released-checkpoint
    branch; on an empty weights directory the phase refuses the tiny
    branch."""
    weights = tmp_path / "weights"
    weights.mkdir()
    chip_smoke.write_notebook_weights(str(weights))
    chip_smoke.write_seeded_weights(str(weights), {}, which=("face",))
    names = ("reflection-rule-change", "stats/attribute-comparison")
    out = chip_smoke.check_notebooks(str(weights), device="cpu",
                                     names=names)
    assert sorted(out) == sorted(names)
    assert all(row["real_branch"] and all(row["finite"].values())
               for row in out.values())
    cpu = out["reflection-rule-change"]["cpu"]
    assert max(cpu["rel"].values()) == 0.0
    assert cpu["units"][0] == cpu["units"][1]
    empty = tmp_path / "empty"
    empty.mkdir()
    with closed_publication_servers(), pytest.raises(
            AssertionError, match="released-checkpoint branch"):
        chip_smoke.check_notebooks(str(empty), device="cpu",
                                   names=names[:1])


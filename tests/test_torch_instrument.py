"""The port's InstrumentedPipeline against the JAX package's, on the tiny
ProgGAN of tests/test_instrument_viz.py and on a tiny SeqStyleGAN2, with
the same weights (``params_from_jax``) and seeded z.

The port's models run NCHW; the hooks hand out the JAX package's NHWC: a
rule sees and returns the fmap as (B, H, W, C), a per-channel (C,)
ablation broadcasts over channels, and a retained bag holds its 4-D
tensors as NHWC.  Outputs and retained tensors are held within 2e-5 abs
and 1e-4 relative of the JAX package's (tests/test_proggan.py's forward
tolerance); within the port, a retained fmap equals the direct
subsequence's bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

from rewriting_tpu.core.instrument import InstrumentedPipeline as JaxInst
from rewriting_tpu.models import ProgressiveGenerator as JaxProgGAN
from rewriting_tpu.models import SeqStyleGAN2 as JaxSeqStyleGAN2
from rewriting_torch.convert import params_from_jax
from rewriting_torch.core.instrument import (InstrumentedPipeline,
                                             apply_ablation_replacement)
from rewriting_torch.models import ProgressiveGenerator, SeqStyleGAN2
from rewriting_torch.utils.zdataset import standard_z_sample

torch.set_num_threads(1)

# model -> (a layer, the block whose output is ablated per channel, its C)
LAYERS = {"proggan": ("layer2.conv", "layer3", 8),
          "stylegan2": ("layer4.sconv.mconv.adain", "layer3.sconv", 512)}


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=2e-5,
                               rtol=1e-4)


@pytest.fixture(scope="module", params=sorted(LAYERS))
def models(request):
    if request.param == "proggan":
        jm = JaxProgGAN(sizes=[8, 8, 8])
        tm = ProgressiveGenerator(sizes=[8, 8, 8], device="cpu")
    else:
        jm = JaxSeqStyleGAN2(16, style_dim=32, n_mlp=2)
        tm = SeqStyleGAN2(16, style_dim=32, n_mlp=2, device="cpu")
    jp = jax.tree_util.tree_map(np.asarray,
                                jm.init_params(jax.random.PRNGKey(0)))
    z = standard_z_sample(2, tm.z_dim, seed=4)
    return {"name": request.param, "jm": jm, "jp": jp, "tm": tm,
            "tp": params_from_jax(tm, jp), "z": z,
            "layers": LAYERS[request.param]}


def test_retain_layer(models):
    layer = models["layers"][0]
    inst = InstrumentedPipeline(models["tm"], models["tp"])
    jinst = JaxInst(models["jm"], models["jp"])
    inst.retain_layer(layer)
    jinst.retain_layer(layer)
    out = inst(models["z"])
    _close(out, jinst(models["z"]))
    assert out.shape == (2,) + tuple(np.asarray(jinst(models["z"])).shape[1:])
    bag, jbag = inst.retained_layer(layer), jinst.retained_layer(layer)
    assert set(bag) == set(jbag)
    for key in jbag:
        assert tuple(bag[key].shape) == tuple(np.shape(jbag[key])), key
        _close(bag[key], jbag[key])
    # the retained fmap is the direct subsequence's, NHWC, bit for bit
    ctx = models["tm"].pipeline.subsequence(last_layer=layer)
    with torch.no_grad():
        direct = ctx(models["tp"], models["tm"].make_bag(models["z"]))
    assert torch.equal(bag["fmap"], direct["fmap"].permute(0, 2, 3, 1))
    assert set(inst.retained_features()) == {layer}
    assert inst.retained_layer(layer, clear=True) is not None
    assert inst.retained_layer(layer) is None
    inst.stop_retaining_layers([layer])
    inst(models["z"])
    assert inst.retained_features() == {}


def test_edit_layer_rule_and_ablation(models):
    layer = models["layers"][0]
    inst = InstrumentedPipeline(models["tm"], models["tp"])
    jinst = JaxInst(models["jm"], models["jp"])
    base = inst(models["z"][:1])
    inst.edit_layer(layer, rule=lambda x: x * 0.0)
    jinst.edit_layer(layer, rule=lambda x: x * 0.0)
    edited = inst(models["z"][:1])
    _close(edited, jinst(models["z"][:1]))
    assert float((edited - base).abs().max()) > 1e-5
    inst.remove_edits()
    assert torch.equal(inst(models["z"][:1]), base)
    inst.edit_layer(layer, ablation=1.0, replacement=0.0)
    np.testing.assert_allclose(inst(models["z"][:1]).numpy(), edited.numpy(),
                               atol=1e-6)
    inst.remove_edits(layer)
    assert torch.equal(inst(models["z"][:1]), base)


def test_per_channel_ablation(models):
    """A (C,) ablation and replacement act on channels, as in the JAX
    package's NHWC; the rule sees (B, H, W, C)."""
    _, block, channels = models["layers"]
    rng = np.random.RandomState(1)
    ablation = rng.rand(channels).astype(np.float32)
    ablation[::3] = 1.0
    replacement = rng.randn(channels).astype(np.float32)
    inst = InstrumentedPipeline(models["tm"], models["tp"])
    jinst = JaxInst(models["jm"], models["jp"])
    for pipe in (inst, jinst):
        pipe.edit_layer(block, ablation=ablation, replacement=replacement)
        pipe.retain_layer(block)
    _close(inst(models["z"]), jinst(models["z"]))
    fmap = inst.retained_layer(block)["fmap"]
    assert fmap.shape[-1] == channels
    _close(fmap, jinst.retained_layer(block)["fmap"])
    full = torch.from_numpy(ablation == 1.0)
    assert torch.equal(fmap[..., full],
                       torch.from_numpy(replacement)[full].expand(
                           fmap[..., full].shape))
    seen = []

    def rule(x):
        seen.append(tuple(x.shape))
        return apply_ablation_replacement(x, torch.from_numpy(ablation))
    inst.edit_layer(block, rule=rule)
    inst(models["z"])
    assert seen and seen[0][-1] == channels


def test_retain_and_edit_same_layer(models):
    layer = models["layers"][0]
    inst = InstrumentedPipeline(models["tm"], models["tp"])
    inst.retain_layer(layer)
    inst.edit_layer(layer, rule=lambda x: x * 0.0)
    out = inst(models["z"][:1])
    assert out.shape[0] == 1 and out.shape[-1] == 3
    # one retain and one edit stage; the retained value is after the rule
    names = inst._instrumented().stage_names()
    assert names.count(f"_edit:{layer}") == 1
    assert names.count(f"_retained:{layer}") == 1
    assert float(inst.retained_layer(layer)["fmap"].abs().max()) == 0.0


def test_instrumented_pipeline_carries_retained_bags(models):
    layer = models["layers"][0]
    inst = InstrumentedPipeline(models["tm"], models["tp"])
    inst.retain_layer(layer)
    with torch.no_grad():
        out = inst._instrumented()(models["tp"],
                                   models["tm"].make_bag(models["z"]))
    assert any(k.startswith("_retained:") for k in out)
    assert inst.layer_names() == models["tm"].pipeline.stage_names()

"""The port's StyleGAN2 (the seq pipeline and ``pipeline_fast``) against
the JAX package's, on one set of weights carried across with
``params_from_jax``.

Tolerances: fp32 on both sides, atol 1e-4: the convolutions sum in a
different order in XLA and in PyTorch (measured maximum of the forward
difference: 6.7e-6).  ``pipeline_fast`` against the JAX one (K1 in
interpret mode) and against the port's seq pipeline: 1e-4 of the largest
output, the limit of tests/test_stylegan2.py:343.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rewriting_tpu.core import DataBag as JaxBag
from rewriting_tpu.models.stylegan2 import (
    SeqStyleGAN2 as JaxSeqStyleGAN2, params_from_state_dict)
from rewriting_tpu.ops import pallas_upconv as jax_upconv
from rewriting_torch.convert import params_from_jax, params_to_numpy
from rewriting_torch.core import DataBag
from rewriting_torch.models.stylegan2 import SeqStyleGAN2
from rewriting_torch.ops import upconv_blur

torch.set_num_threads(1)

ATOL = 1e-4
SIZE, STYLE_DIM, N_MLP = 16, 64, 2


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _nchw_to_nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.fixture(scope="module")
def pair():
    jm = JaxSeqStyleGAN2(SIZE, style_dim=STYLE_DIM, n_mlp=N_MLP)
    jp = jm.init_params(jax.random.PRNGKey(3))
    tm = SeqStyleGAN2(SIZE, style_dim=STYLE_DIM, n_mlp=N_MLP, device="cpu")
    tp = params_from_jax(tm, _np_tree(jp))
    z = np.random.RandomState(5).randn(3, STYLE_DIM).astype(np.float32)
    return jm, jp, tm, tp, z


def test_stage_names_match(pair):
    jm, _, tm, _, _ = pair
    assert tm.pipeline.stage_names() == jm.pipeline.stage_names()


def test_params_round_trip(pair):
    _, jp, _, tp, _ = pair
    back = params_to_numpy(tp)
    want = _np_tree(jp)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(want)):
        assert a.shape == b.shape and np.array_equal(a, b)


def test_init_params_distributions(pair):
    """The port's seeded init has the JAX package's tree, shapes and
    distributions, and is the same on every call."""
    jm, jp, tm, _, _ = pair
    a = params_to_numpy(tm.init_params(seed=11))
    b = params_to_numpy(tm.init_params(seed=11))
    want = _np_tree(jp)
    assert jax.tree_util.tree_structure(a) == \
        jax.tree_util.tree_structure(want)
    for x, y, w in zip(jax.tree_util.tree_leaves(a),
                       jax.tree_util.tree_leaves(b),
                       jax.tree_util.tree_leaves(want)):
        assert x.shape == w.shape and np.array_equal(x, y)
    # EqualLinear weight ~ N(0, 1/lr_mul^2); dconv ~ N(0, 1); noise 0
    assert abs(a["style.1"]["weight"].std() * tm.lr_mlp - 1) < 0.05
    assert abs(a["layer4.sconv.mconv.dconv"]["weight"].std() - 1) < 0.05
    assert a["layer4.sconv.noise"]["weight"].tolist() == [0.0]
    np.testing.assert_array_equal(a["noises"]["noise_3"],
                                  want["noises"]["noise_3"])


def test_forward_matches_jax(pair):
    jm, jp, tm, tp, z = pair
    want = np.asarray(jm(jp, jnp.asarray(z), fast=False))
    got = tm(tp, z, fast=False).numpy()
    assert got.shape == (3, SIZE, SIZE, 3)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_forward_prefix_stable_in_batch(pair):
    """Noise and z are numpy-seeded per sample: image 0 does not depend on
    the batch it is drawn in (up to the conv's summation order)."""
    _, _, tm, tp, z = pair
    np.testing.assert_allclose(tm(tp, z[:1]).numpy(), tm(tp, z)[:1].numpy(),
                               atol=ATOL, rtol=0)


def _split(pipe, layer):
    first = f"layer{layer}.sconv.mconv.dconv"
    last = f"layer{layer}.sconv.activate"
    return (pipe.subsequence(upto_layer=first),
            pipe.subsequence(first_layer=first, last_layer=last),
            pipe.subsequence(after_layer=last))


@pytest.mark.parametrize("boundary", [0, 1, 2],
                         ids=["context", "target", "rendering"])
def test_split_at_layer4_matches_jax(pair, boundary):
    """Every stage boundary of the three-way split at layer 4: the bag's
    feature map, rgb output, style and latent after each part."""
    jm, jp, tm, tp, z = pair
    jbag = JaxBag(latent=jnp.asarray(z))
    jbag.update(jm.prepare_noise(z.shape[0]))
    tbag = tm.make_bag(z)
    with torch.no_grad():
        for jpart, tpart in list(zip(_split(jm.pipeline, 4),
                                     _split(tm.pipeline, 4)))[:boundary + 1]:
            jbag = jpart(jp, jbag)
            tbag = tpart(tp, tbag)
    assert sorted(tbag) == sorted(jbag)
    for key in ("fmap", "output"):
        if key in jbag:
            np.testing.assert_allclose(_nchw_to_nhwc(tbag[key]),
                                       np.asarray(jbag[key]), atol=ATOL,
                                       rtol=0, err_msg=key)
    for key in ("style", "latent"):
        np.testing.assert_allclose(tbag[key].numpy(), np.asarray(jbag[key]),
                                   atol=ATOL, rtol=0, err_msg=key)


@pytest.mark.parametrize("query,want", [
    (dict(upto_layer="layer4.sconv.mconv.dconv"), None),
    (dict(first_layer="layer3", last_layer="layer3"), None),
    (dict(after_layer="layer4.sconv.activate"), None),
    (dict(first_layer="layer4", upto_layer="layer3"), ValueError),
    (dict(first_layer="layer4.sconv", after_layer="layer3"), ValueError),
    (dict(first_layer="layer99"), KeyError),
])
def test_subsequence_matches_jax(pair, query, want):
    """Surgery over dotted prefixes selects the same stages; an empty or
    inverted span and an unknown name raise as in the JAX package."""
    jm, _, tm, _, _ = pair
    if want is not None:
        with pytest.raises(want):
            tm.pipeline.subsequence(**query)
        with pytest.raises(want):
            jm.pipeline.subsequence(**query)
        return
    assert tm.pipeline.subsequence(**query).stage_names() == \
        jm.pipeline.subsequence(**query).stage_names()


def test_truncation_matches_jax(pair):
    jm, jp, _, _, z = pair
    jt = JaxSeqStyleGAN2(SIZE, style_dim=STYLE_DIM, n_mlp=N_MLP,
                         truncation=0.5)
    tt = SeqStyleGAN2(SIZE, style_dim=STYLE_DIM, n_mlp=N_MLP, truncation=0.5,
                      device="cpu")
    jp = dict(jp)
    avg = np.random.RandomState(2).randn(STYLE_DIM).astype(np.float32)
    jp["latents"] = {"latent_avg": jnp.asarray(avg)}
    want = np.asarray(jt(jp, jnp.asarray(z), fast=False))
    got = tt(params_from_jax(tt, _np_tree(jp)), z, fast=False).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.fixture(scope="module")
def golden_port(goldens):
    """tests/goldens/stylegan2_tiny.npz (made by the reference torch code):
    its state dict through the JAX converter, carried across."""
    g = goldens("stylegan2_tiny")
    sd = {k[len("sd."):]: g[k] for k in g.files if k.startswith("sd.")}
    jm = JaxSeqStyleGAN2(SIZE, style_dim=STYLE_DIM, n_mlp=N_MLP)
    tm = SeqStyleGAN2(SIZE, style_dim=STYLE_DIM, n_mlp=N_MLP, device="cpu")
    tp = params_from_jax(tm, _np_tree(params_from_state_dict(jm, sd)))
    want = {k: g[k] for k in ("z", "out", "layer3_adain", "layer3_dconv",
                              "layer3_act")}
    return tm, tp, want


@pytest.mark.parametrize("key", ["out", "layer3_adain", "layer3_dconv",
                                 "layer3_act"])
def test_golden(golden_port, key):
    """The golden's output and its layer-3 window activations (NCHW), run
    by the port: atol 1e-4 (measured maxima: out 6.9e-6, layer3_adain
    2.2e-5, layer3_dconv 4.3e-6, layer3_act 4.8e-6)."""
    tm, tp, want = golden_port
    z = want["z"]
    if key == "out":
        got = tm(tp, z, fast=False).numpy().transpose(0, 3, 1, 2)
    else:
        first = "layer3.sconv.mconv.dconv"
        with torch.no_grad():
            bag = tm.pipeline.subsequence(upto_layer=first)(tp, tm.make_bag(z))
            if key != "layer3_adain":
                last = first if key == "layer3_dconv" else \
                    "layer3.sconv.activate"
                bag = tm.pipeline.subsequence(first_layer=first,
                                              last_layer=last)(tp, bag)
        assert isinstance(bag, DataBag)
        got = bag["fmap"].numpy()
    np.testing.assert_allclose(got, want[key], atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# pipeline_fast (K1) and the NHWC __call__
# ---------------------------------------------------------------------------

def _live_epilogue(tree, seed):
    """The tree with random noise weights and activate biases, so the
    fused epilogue's noise and bias terms are not zero."""
    rng = np.random.RandomState(seed)
    tree = dict(tree)
    for name in list(tree):
        if name.endswith(".noise"):
            tree[name] = {"weight": rng.randn(1).astype(np.float32)}
        elif name.endswith(".activate"):
            n = np.asarray(tree[name]["bias"]).shape[0]
            tree[name] = {"bias": rng.randn(n).astype(np.float32) * 0.1}
    return tree


def _fast_pair(blur_kernel):
    jm = JaxSeqStyleGAN2(SIZE, style_dim=STYLE_DIM, n_mlp=N_MLP,
                         blur_kernel=blur_kernel)
    jp = _live_epilogue(_np_tree(jm.init_params(jax.random.PRNGKey(4))), 9)
    tm = SeqStyleGAN2(SIZE, style_dim=STYLE_DIM, n_mlp=N_MLP,
                      blur_kernel=blur_kernel, device="cpu")
    return jm, jp, tm, params_from_jax(tm, jp)


def _jax_fast(jm, jp, z, epilogue=True):
    """The JAX pipeline_fast with K1 on at every resolution (interpret mode
    on the CPU), the gates restored after (tests/test_stylegan2.py:333)."""
    jax_upconv.set_fused_upconv("on", min_res=0)
    jax_upconv.set_fused_epilogue(epilogue)
    try:
        return np.asarray(jm(jax.tree_util.tree_map(jnp.asarray, jp),
                             jnp.asarray(z), fast=True))
    finally:
        jax_upconv.set_fused_upconv("off", min_res=256)
        jax_upconv.set_fused_epilogue(True)


def _torch_fast(tm, tp, z, epilogue=True):
    """The port's pipeline_fast with K1 forced on at every resolution
    (its plain version on the CPU), the gates restored after."""
    upconv_blur.set_fused_upconv("on", min_res=0)
    upconv_blur.set_fused_epilogue(epilogue)
    try:
        return tm(tp, z).numpy()
    finally:
        upconv_blur.set_fused_upconv("off", min_res=256)
        upconv_blur.set_fused_epilogue(True)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("epilogue", [True, False],
                         ids=["epilogue", "no-epilogue"])
def test_pipeline_fast_matches_jax_and_seq(epilogue):
    """The port's pipeline_fast (K1's plain version on the CPU) against the
    JAX pipeline_fast with K1 forced on, and against the port's seq
    pipeline: 1e-4 of max |output|."""
    jm, jp, tm, tp = _fast_pair((1, 3, 3, 1))
    z = np.random.RandomState(6).randn(2, STYLE_DIM).astype(np.float32)
    want = _jax_fast(jm, jp, z, epilogue)
    got = _torch_fast(tm, tp, z, epilogue)
    seq = tm(tp, z, fast=False).numpy()
    assert got.shape == (2, SIZE, SIZE, 3)
    assert _rel(got, want) < 1e-4
    assert 0.0 < _rel(got, seq) < 1e-4   # 0.0: the fused stages never ran


@pytest.mark.parametrize("blur_kernel", [(1, 2, 3, 1), (1, 2, 1)],
                         ids=["asymmetric-4tap", "3tap"])
def test_pipeline_fast_other_blur_kernels(blur_kernel):
    """An asymmetric 4-tap FIR takes K1 (its taps flipped the right way);
    a 3-tap FIR installs no fused stage, so pipeline_fast is the seq
    pipeline exactly.  Both against the JAX package: 1e-4 of max."""
    jm, jp, tm, tp = _fast_pair(blur_kernel)
    z = np.random.RandomState(7).randn(2, STYLE_DIM).astype(np.float32)
    want = _jax_fast(jm, jp, z)
    got = _torch_fast(tm, tp, z)
    seq = tm(tp, z, fast=False).numpy()
    assert _rel(got, want) < 1e-4
    if len(blur_kernel) == 4:
        assert 0.0 < _rel(got, seq) < 1e-4
    else:
        np.testing.assert_array_equal(got, seq)
        assert all(s.fn is f.fn for s, f in zip(tm.pipeline.stages,
                                                  tm.pipeline_fast.stages))


def test_call_returns_nhwc(pair):
    """__call__ returns (B, H, W, 3), the JAX layout, on both pipelines:
    the seq one is the NCHW pipeline output transposed."""
    _, _, tm, tp, z = pair
    with torch.no_grad():
        nchw = tm.pipeline(tp, tm.make_bag(z))["output"]
    got = tm(tp, z, fast=False)
    assert tuple(got.shape) == (3, SIZE, SIZE, 3) and got.is_contiguous()
    assert torch.equal(got, nchw.permute(0, 2, 3, 1))
    assert tuple(tm(tp, z).shape) == (3, SIZE, SIZE, 3)


def test_fused_gate_modes(pair):
    """"off", the default as in the JAX package, runs the seq stages inside
    pipeline_fast (bit for bit), and so does "on" at the default min_res
    of 256 on this 16-pixel model; "on" with min_res=0 runs K1.  The gate
    takes the JAX signatures; unknown modes and the unported subpixel
    pipeline raise."""
    _, _, tm, tp, z = pair
    assert upconv_blur._FUSED_MODE == "off"
    assert upconv_blur._FUSED_MIN_RES == 256
    assert not upconv_blur.fused_upconv_active(512, 512, 256)
    assert not upconv_blur.fused_epilogue_active(512, 512)
    seq = tm(tp, z, fast=False)
    assert torch.equal(tm(tp, z), seq)
    upconv_blur.set_fused_upconv("on")
    try:
        assert upconv_blur.fused_upconv_active(512, 512, 256)
        assert not upconv_blur.fused_upconv_active(512, 512, 16)
        assert torch.equal(tm(tp, z), seq)
        upconv_blur.set_fused_upconv("on", min_res=0)
        assert upconv_blur.fused_epilogue_active(512, 512, 16)
        assert not torch.equal(tm(tp, z), seq)
    finally:
        upconv_blur.set_fused_upconv("off", min_res=256)
    with pytest.raises(ValueError):
        upconv_blur.set_fused_upconv("sometimes")
    # fused=True runs the subpixel alternate (tests/test_torch_s2d.py
    # holds it against the JAX package and the golden)
    fused = tm(tp, z, fused=True)
    assert float((fused - seq).abs().max()) <= 1e-5 * float(seq.abs().max())


def test_fast_pipeline_stage_names_match_jax(pair):
    jm, _, tm, _, _ = pair
    assert tm.pipeline_fast.stage_names() == \
        jm.pipeline_fast.stage_names() == tm.pipeline.stage_names()
    fused = [s.name for s in tm.pipeline_fast.stages
             if getattr(s.fn, "_full_params", False)]
    assert fused == [f"layer{i}.sconv.mconv.dconv" for i in (3, 5)]

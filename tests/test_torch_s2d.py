"""The port's s2d tails (StyleGAN2 ``models/stylegan2.py``, ProgGAN
``models/proggan.py``) and the subpixel alternate ``fused=True``, against
the port's seq pipeline and the JAX package's, on one set of weights
carried across with ``params_from_jax``; and the tails and a mixed
schedule under the port's tp and dp in a 4-rank gloo job.

Spec: tests/test_stylegan2.py (``test_fast_s2d_tail_pipeline_matches_seq``,
``test_fast_s2d_tail_chained_up_layers``, ``test_fused_pipeline_matches_seq``,
``test_composite_up_dconv_matches_dconv_plus_blur``), tests/test_proggan.py
(``test_proggan_fast_s2d_tail_matches_seq``), tests/test_review_fixes.py
(the two ``..._degrades_gracefully``), tests/test_ops.py
(``test_conv3x3_s2d_matches_plain_conv``), tests/test_parallel_tp_pp.py
(``test_tp_composes_with_fast_tail``, ``test_tp_composes_with_mixed_schedule``)
and tests/test_sharded_stats.py (``test_fast_s2d_tail_under_mesh_sharding``).

Tolerances, the JAX tests' but one:
- the tails and ``fused=True`` against the seq pipeline and against the
  JAX package's ``pipeline_fast``: 1e-4 of the largest output (the same
  products regrouped: measured 2.5e-7-1.4e-6);
- ``fused=True`` against the seq pipeline 1e-5 abs, against the torch
  golden 3e-4 abs, 1e-3 rel;
- the s2d conv and the composite up-kernel 1e-4 abs and rel;
- tp (fast and seq) against the unsharded forward 2e-5 abs, tp fast
  against tp seq 2e-4 abs; dp of the tail against the seq forward 1e-4
  of the largest value;
- tp under a "default" schedule against the unsharded forward under the
  same schedule: PSNR > 40 dB, not the JAX test's 5e-5 abs (its CPU
  computes "default" in fp32; here each rank's partial sums are rounded
  to bf16 by PyTorch's bf16 convolutions before the all-reduce).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import rewriting_torch.models.stylegan2 as tsg
from conftest import tiny_channel_stylegan
from rewriting_tpu.core import DataBag as JaxBag
from rewriting_tpu.models import ProgressiveGenerator as JaxProgGAN
from rewriting_tpu.models import stylegan2 as jsg
from rewriting_torch.convert import params_from_jax
from rewriting_torch.core import DataBag
from rewriting_torch.models import ProgressiveGenerator
from test_torch_parallel import run_job

torch.set_num_threads(1)

REL = 1e-4
CHAINED = {4: 24, 8: 24, 16: 24, 32: 24, 64: 24, 128: 24, 256: 24, 512: 16,
           1024: 8}
INTERRUPTED = {4: 16, 8: 16, 16: 16, 32: 16, 64: 16, 128: 16, 256: 16,
               512: 8, 1024: 24}


def tiny_torch(size, s2d_tail_max_c=None, style_dim=32, n_mlp=1, ch=None):
    """The port's counterpart of conftest.tiny_channel_stylegan."""
    table = ch or {4: 16, 8: 16, 16: 16, 32: 16, 64: 16, 128: 16, 256: 16,
                   512: 8, 1024: 8}
    orig = tsg.CHANNELS
    tsg.CHANNELS = lambda cm: dict(table)
    try:
        return tsg.SeqStyleGAN2(size, style_dim=style_dim, n_mlp=n_mlp,
                                s2d_tail_max_c=s2d_tail_max_c, device="cpu")
    finally:
        tsg.CHANNELS = orig


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _nhwc(t):
    return t.detach().numpy()


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-9))


def _pair(size, batch, **kw):
    jm = tiny_channel_stylegan(size, **kw)
    tm = tiny_torch(size, **kw)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = params_from_jax(tm, _np_tree(jp))
    z = np.random.RandomState(1).randn(batch, 32).astype(np.float32)
    return jm, jp, tm, tp, z


@pytest.mark.parametrize("case", ["tail512", "chained1024",
                                  "interrupted1024"])
def test_fast_s2d_tail_pipeline_matches_seq(case):
    """pipeline_fast with the s2d tail (engaged where the JAX gate
    engages: the same overridden stages) against the port's seq pipeline
    and the JAX package's pipeline_fast: the 512 tail, the chained up
    layers at 1024 (``s2d_tail_max_c=16``) and the tail interrupted by a
    wider 1024 layer (ended by a d2s bridge at its adain)."""
    size, batch, kw = {
        "tail512": (512, 2, {}),
        "chained1024": (1024, 1, {"s2d_tail_max_c": 16, "ch": CHAINED}),
        "interrupted1024": (1024, 1, {"s2d_tail_max_c": 8,
                                      "ch": INTERRUPTED})}[case]
    jm, jp, tm, tp, z = _pair(size, batch, **kw)
    assert sorted(tm._fast_overrides) == sorted(jm._fast_overrides)
    assert tm._s2d_tail == jm._s2d_tail
    if case == "chained1024":
        assert {"layer15.sconv.mconv.dconv",
                "layer17.sconv.mconv.dconv"} <= set(tm._fast_overrides)
    if case == "interrupted1024":
        assert "layer17.sconv.mconv.adain" in tm._fast_overrides
        assert "layer17.sconv.mconv.dconv" not in tm._fast_overrides
    seq = _nhwc(tm(tp, z, fast=False))
    fast = _nhwc(tm(tp, z))
    jfast = np.asarray(jm(jp, jnp.asarray(z), fast=True))
    assert 0.0 < _rel(fast, seq) < REL
    assert _rel(fast, jfast) < REL


def test_no_tail_below_the_gate():
    """A model with no layer of <= 32 channels at >= 512 px has no s2d
    override: its pipeline_fast differs from the seq pipeline only at
    K1's four stages of each upsampling layer, as the JAX package's."""
    tm = tsg.SeqStyleGAN2(32, style_dim=16, n_mlp=1, device="cpu")
    jm = jsg.SeqStyleGAN2(size=32, style_dim=16, n_mlp=1)
    assert sorted(tm._fast_overrides) == sorted(jm._fast_overrides)
    assert not tm._s2d_names
    assert all(k.endswith((".mconv.dconv", ".mconv.blur", ".noise",
                           ".activate")) for k in tm._fast_overrides)


def test_fused_pipeline_matches_seq(goldens):
    """fused=True (the subpixel up-dconvs, the seq blur after them)
    against the seq pipeline, the JAX package's fused pipeline and the
    torch golden."""
    g = goldens("stylegan2_tiny")
    sd = {k[len("sd."):]: g[k] for k in g.files if k.startswith("sd.")}
    jm = jsg.SeqStyleGAN2(size=16, style_dim=64, n_mlp=2)
    jp = jsg.params_from_state_dict(jm, sd)
    tm = tsg.SeqStyleGAN2(16, style_dim=64, n_mlp=2, device="cpu")
    tp = tsg.params_from_state_dict(tm, sd)
    z = g["z"]
    seq = _nhwc(tm(tp, z, fast=False))
    fused = _nhwc(tm(tp, z, fused=True))
    np.testing.assert_allclose(fused, seq, atol=1e-5)
    np.testing.assert_allclose(fused.transpose(0, 3, 1, 2), g["out"],
                               atol=3e-4, rtol=1e-3)
    jfused = np.asarray(jm(jp, jnp.asarray(z), fused=True))
    np.testing.assert_allclose(fused, jfused, atol=1e-5)
    assert sorted(tm._fused_overrides) == sorted(jm._fused_overrides)


def test_conv3x3_s2d_matches_plain_conv():
    """The s2d 3x3 conv is a regrouping of the plain SAME conv; its
    transformed kernel is the JAX package's."""
    rng = np.random.RandomState(1)
    for h, ci, co in ((8, 3, 5), (16, 32, 32), (12, 64, 32)):
        x = rng.randn(2, ci, h, h).astype(np.float32)
        w = rng.randn(co, ci, 3, 3).astype(np.float32)
        want = F.conv2d(torch.tensor(x), torch.tensor(w), padding=1)
        got = tsg._conv3x3_s2d(torch.tensor(x), torch.tensor(w))
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4,
                                   rtol=1e-4)
        jgot = np.asarray(jsg._conv3x3_s2d(jnp.asarray(x.transpose(0, 2, 3,
                                                                   1)),
                                           jnp.asarray(w)))
        np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), jgot,
                                   atol=1e-4, rtol=1e-4)
        np.testing.assert_array_equal(
            tsg._s2d_kernel_transform(torch.tensor(w)).numpy(),
            np.asarray(jsg._s2d_kernel_transform(jnp.asarray(w))))
    x = torch.tensor(rng.randn(2, 3, 6, 8).astype(np.float32))
    assert torch.equal(tsg._d2s_of(tsg._s2d_of(x)), x)


def test_composite_up_dconv_matches_dconv_plus_blur():
    """The tail's blur-folded up-dconv is the seq dconv then the blur; its
    composite kernel is the JAX package's; and the subpixel up-dconv is
    the seq dconv."""
    rng = np.random.RandomState(0)
    ci, co, h = 6, 5, 12
    x = torch.tensor(rng.randn(2, ci, h, h).astype(np.float32))
    w5 = torch.tensor(rng.randn(1, co, ci, 3, 3).astype(np.float32))
    style = torch.tensor(rng.randn(2, ci).astype(np.float32))
    d = DataBag(fmap=x, style=style)
    seq = tsg._make_dconv(ci, 3, True)({"weight": w5}, d)
    blur = tsg._make_blur([1, 3, 3, 1], (1, 1), 2)
    want = blur({}, seq)["fmap"]
    fast = tsg._make_fast_up_dconv_s2d(ci, co, 3, True, [1, 3, 3, 1])
    got = tsg._d2s_of(fast({"weight": w5}, d)["fmap"])
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4,
                               rtol=1e-4)
    sub = tsg._make_subpixel_up_dconv(ci, co, 3, True)({"weight": w5}, d)
    np.testing.assert_allclose(sub["fmap"].numpy(), seq["fmap"].numpy(),
                               atol=1e-5, rtol=1e-5)
    wf = torch.flip(w5[0], (-2, -1))
    np.testing.assert_allclose(
        tsg._composite_up_kernel(wf, tsg.make_kernel([1, 3, 3, 1]), co,
                                 ci).numpy(),
        np.asarray(jsg._composite_up_kernel(
            jnp.asarray(wf.numpy()), jsg.make_kernel([1, 3, 3, 1]), co, ci)),
        atol=1e-6)
    jd = JaxBag(fmap=jnp.asarray(x.numpy().transpose(0, 2, 3, 1)),
                style=jnp.asarray(style.numpy()))
    jsub = jsg._make_subpixel_up_dconv(ci, co, 3, True)(
        {"weight": jnp.asarray(w5.numpy())}, jd)["fmap"]
    np.testing.assert_allclose(sub["fmap"].numpy().transpose(0, 2, 3, 1),
                               np.asarray(jsub), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("sizes", [
    [32, 16, 16, 16, 16, 16, 16, 16, 8],
    [32, 16, 16, 16, 16, 16, 16, 16, 16, 8],
    [32, 16, 16, 16, 16, 16, 16, 16, 16, 48]],
    ids=["tail512", "chained1024", "interrupted1024"])
def test_proggan_fast_s2d_tail_matches_seq(sizes):
    """ProgGAN's pipeline_fast (the nearest upsample folded into the conv,
    the s2d layout) against the seq pipeline and the JAX package's, at 512
    and 1024 px, and interrupted by a wider last block (bridged at its
    pixel norm); the same stages overridden as in the JAX package."""
    jm = JaxProgGAN(sizes=sizes)
    tm = ProgressiveGenerator(sizes=sizes, device="cpu")
    assert sorted(tm._fast_overrides) == sorted(jm._fast_overrides)
    assert tm._fast_overrides and tm.pipeline_fast is not tm.pipeline
    assert tm._s2d_tail == jm._s2d_tail
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = params_from_jax(tm, _np_tree(jp))
    z = np.random.RandomState(1).randn(1, 32).astype(np.float32)
    seq = _nhwc(tm(tp, z, fast=False))
    fast = _nhwc(tm(tp, z))
    jfast = np.asarray(jm(jp, jnp.asarray(z)))
    assert _rel(fast, seq) < REL
    assert _rel(fast, jfast) < REL


def test_proggan_below_the_gate_has_no_tail():
    for resolution in (8, 256):
        tm = ProgressiveGenerator(resolution=resolution, device="cpu")
        assert not tm._fast_overrides and tm.pipeline_fast is tm.pipeline


MESH_JOB = """
import rewriting_torch.models.stylegan2 as tsg
from rewriting_torch.convert import params_from_jax
from rewriting_torch.models.stylegan2 import mixed_precision_schedule
from rewriting_torch.ops import precision
from rewriting_torch.parallel import (make_mesh, sharded_sampler,
                                      tensor_shard_params,
                                      tensor_sharded_sampler)


def tiny(size, table):
    orig = tsg.CHANNELS
    tsg.CHANNELS = lambda cm: dict(table)
    try:
        return tsg.SeqStyleGAN2(size, style_dim=32, n_mlp=1, device="cpu")
    finally:
        tsg.CHANNELS = orig


mt = make_mesh(axis="model", device="cpu")
md = make_mesh(axis="data", device="cpu")
# the tail under tp (fast and seq) and dp
m = tiny(512, load("table"))
p = params_from_jax(m, load("tail_params"))
z = load("tail_z")
results["tail_single_fast"] = m(p, z)
local = tensor_shard_params(m, p, mt, axis="model")
results["tp_fast"] = tensor_sharded_sampler(m, mt)(local, z)
results["tp_seq"] = tensor_sharded_sampler(m, mt, fast=False)(local, z)
z8 = load("dp_z")
results["dp"] = comm.all_gather(sharded_sampler(m, md)(p, z8), md.group("data"))
results["dp_seq"] = m(p, z8, fast=False)
# a mixed schedule under tp, against the unsharded forward under it
s = tiny(64, load("table"))
sp = params_from_jax(s, load("mixed_params"))
zs = load("mixed_z")
slocal = tensor_shard_params(s, sp, mt, axis="model")
precision.set_precision_schedule(mixed_precision_schedule(min_res=16))
try:
    results["mixed_single"] = s(sp, zs)
    results["mixed_tp"] = tensor_sharded_sampler(s, mt)(slocal, zs)
finally:
    precision.set_precision_schedule(None)
results["highest_single"] = s(sp, zs)
"""


@pytest.fixture(scope="module")
def mesh_job(tmp_path_factory):
    table = {4: 16, 8: 16, 16: 16, 32: 16, 64: 16, 128: 16, 256: 16, 512: 8,
             1024: 8}
    jm = tiny_channel_stylegan(512)
    jp = _np_tree(jm.init_params(jax.random.PRNGKey(9)))
    jm64 = tiny_channel_stylegan(64)
    jp64 = _np_tree(jm64.init_params(jax.random.PRNGKey(11)))
    rng = np.random.RandomState(10)
    inputs = {"table": table, "tail_params": jp,
              "tail_z": rng.randn(2, 32).astype(np.float32),
              "dp_z": rng.randn(8, 32).astype(np.float32),
              "mixed_params": jp64,
              "mixed_z": rng.randn(2, 32).astype(np.float32)}
    ranks = run_job(tmp_path_factory.mktemp("s2d_mesh"), 4, MESH_JOB,
                    inputs, timeout=600)
    return jm, jp, inputs, ranks


def test_tp_composes_with_fast_tail(mesh_job):
    """tp over 4 ranks with the s2d tail engaged (under tp the tail's
    layers run their seq stages on the shards) against the unsharded
    pipeline_fast of the port and the JAX package; fast under tp against
    seq under tp."""
    jm, jp, inputs, ranks = mesh_job
    jref = np.asarray(jm(jp, jnp.asarray(inputs["tail_z"]), fast=True))
    for r in ranks:
        ref = _nhwc(r["tail_single_fast"])
        np.testing.assert_allclose(_nhwc(r["tp_fast"]), ref, rtol=0,
                                   atol=2e-5)
        np.testing.assert_allclose(_nhwc(r["tp_fast"]), jref, rtol=0,
                                   atol=2e-5)
        np.testing.assert_allclose(_nhwc(r["tp_fast"]), _nhwc(r["tp_seq"]),
                                   rtol=0, atol=2e-4)


def _psnr(out, ref):
    peak = ref.max() - ref.min()
    return 10 * np.log10(peak * peak / np.mean(np.square(out - ref)))


def test_tp_composes_with_mixed_schedule(mesh_job):
    """A "default" schedule from 16 px under tp against the unsharded
    forward under the same schedule: each rank's partial conv sums come
    out of PyTorch's bf16 convolutions rounded to bf16 before the
    all-reduce, so they are held at bf16's level, PSNR > 40 dB (the JAX
    package's CPU computes "default" in fp32: its test's 5e-5 abs does not
    carry over); the schedule is active (the render differs from the
    "highest" one) and the tp render is nearer the scheduled one."""
    for r in mesh_job[3]:
        ref = _nhwc(r["mixed_single"])
        tp = _nhwc(r["mixed_tp"])
        highest = _nhwc(r["highest_single"])
        assert _psnr(tp, ref) > 40.0
        assert _rel(ref, highest) > 0


def test_fast_s2d_tail_under_mesh_sharding(mesh_job):
    """dp over 4 ranks of the tail's pipeline_fast: each rank renders its
    2 of the 8 images; gathered, within 1e-4 of the largest value of the
    unsharded seq forward."""
    for r in mesh_job[3]:
        out, ref = _nhwc(r["dp"]), _nhwc(r["dp_seq"])
        assert out.shape == (8, 512, 512, 3)
        assert _rel(out, ref) < REL

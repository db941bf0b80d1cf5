"""The port's precision policy (``ops/precision.py``: the global tier,
per-stage schedules, their suspension, ``cast_params``), the schedules of
both model families, the int8 tier (``ops/quant.py``), K1's one-pass bf16
plain version and ``upfirdn2d_matmul``, against the JAX package.

Spec: tests/test_stylegan2.py (``test_mixed_precision_schedule``,
``test_recommended_precision_schedule_scale_aware``,
``test_precision_schedule_suspension``, ``test_int8_tier_schedule``),
tests/test_proggan.py (``test_proggan_mixed_precision_schedule``) and
tests/test_ops.py (``test_quantize_weight_roundtrip_bound``,
``test_conv2d_w8a8_matches_integer_emulation``,
``test_upsample2d_narrow_channel_matmul_dispatch``).

Tolerances:
- schedules and tiers: exact (names and decisions);
- the int8 primitives: bit for bit against the JAX package (the same
  rounding: half to even, the clip, the ``_EPS`` floor, an exact int32
  sum, the fp32 dequantize), and the integer GEMM bit for bit against its
  float64 plain version;
- the int8 schedule on the torch golden: PSNR > 30 dB against the fp32
  forward (the JAX test's floor); against the JAX package under the same
  schedule, with the port's other ops of the int8 stages in fp32 as the
  JAX package's CPU computes them, 1e-3 of the largest value (a
  quantization step of either side's activations can round the other way
  where the fp32 values upstream differ in their last bits);
  under suspension bit for bit the forward without a schedule;
- a "default" schedule on the golden: PSNR > 30 dB against "highest"
  (bf16 operands; the JAX package's CPU computes fp32 at every tier, so
  there is nothing to hold it against there);
- K1's one-pass plain version against ``upconv_blur_pallas`` in
  interpret mode fed the same bf16-rounded operands at HIGHEST: 1e-5 of
  the largest output (fp32, the K1 tests' bound);
- ``upfirdn2d_matmul``: its operator matrices equal the JAX package's,
  its output within 2e-5 (the JAX test's) of the JAX package's and of the
  port's ``upsample2d``.
"""

import importlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rewriting_tpu.models import proggan as jpg
from rewriting_tpu.models import stylegan2 as jsg
from rewriting_tpu.ops import precision as jprecision
from rewriting_tpu.ops import quant as jquant
from rewriting_tpu.ops.pallas_upconv import upconv_blur_pallas
from rewriting_torch.core import DataBag, Stage, StagePipeline
from rewriting_torch.models import proggan as tpg
from rewriting_torch.models import stylegan2 as tsg
from rewriting_torch.ops import precision, quant
from rewriting_torch.ops import upconv_blur as kup

torch.set_num_threads(1)

jup = importlib.import_module("rewriting_tpu.ops.upfirdn2d")
tup = importlib.import_module("rewriting_torch.ops.upfirdn2d")


@pytest.fixture(autouse=True)
def _clean_policy():
    """Every test starts and ends at the global "highest" with no schedule
    installed, in both packages."""
    for p in (precision, jprecision):
        p.set_precision("highest")
        p.set_precision_schedule(None)
    yield
    for p in (precision, jprecision):
        p.set_precision("highest")
        p.set_precision_schedule(None)


def _names_1024():
    return tsg.SeqStyleGAN2(1024, style_dim=32, n_mlp=2,
                            device="cpu").pipeline.stage_names()


def _decides(p, schedule, stage):
    """The tier each package resolves for `stage` under `schedule`."""
    p.set_precision_schedule(schedule)
    try:
        with p.stage_scope(stage):
            return p.get_tier()
    finally:
        p.set_precision_schedule(None)


def test_stage_resolution_matches_jax():
    names = _names_1024()
    assert [tsg.stage_resolution(n) for n in names] == \
        [jsg.stage_resolution(n) for n in names]
    assert tsg.stage_resolution("layer2.conv.mconv.dconv") == 4
    assert tsg.stage_resolution("layer12.sconv.mconv.dconv") == 128
    assert tsg.stage_resolution("up_rgb1") == 8
    assert tsg.stage_resolution("to_rgb3.rgb") == 16
    assert tsg.stage_resolution("style.3") is None
    # the mesh module reads the model's own
    from rewriting_torch.parallel import mesh, tensor
    assert mesh.stage_resolution is tsg.stage_resolution
    assert tensor.stage_resolution is tsg.stage_resolution
    pnames = tpg.ProgressiveGenerator(resolution=256,
                                      device="cpu").pipeline.stage_names()
    expected = {"layer1": 4, "layer2": 4, "layer3": 8, "layer4": 8,
                "layer5": 16, "layer6": 16, "layer7": 32, "layer8": 32,
                "layer9": 64, "layer10": 64, "layer11": 128,
                "layer12": 128, "layer13": 256, "layer14": 256,
                "output_256x256": 256, "input": None, "output": None}
    for n in pnames:
        assert tpg.stage_resolution(n) == jpg.stage_resolution(n) == \
            expected[n.split(".")[0]]


@pytest.mark.parametrize("kw", [
    {"min_res": 16, "tier": "default", "keep_rgb": False},
    {"min_res": 16, "tier": "default"},
    {"min_res": 128, "tier": "int8", "pin": ("layer13",)},
    {"min_res": 512, "tier": "high", "keep_rgb": False,
     "pin": ("layer15", "to_rgb8")}])
def test_mixed_precision_schedule(kw):
    """The StyleGAN2 schedule decides as the JAX package's on every stage
    of a 1024 model; installed, it sets the tier inside matching stage
    scopes only."""
    tsched = tsg.mixed_precision_schedule(**kw)
    jsched = jsg.mixed_precision_schedule(**kw)
    for n in _names_1024():
        assert tsched(n) == jsched(n), n
        assert _decides(precision, tsched, n) == \
            _decides(jprecision, jsched, n), n
    precision.set_precision_schedule(tsg.mixed_precision_schedule(
        min_res=16, tier="default", keep_rgb=False))
    assert precision.get_precision() == "highest"
    with precision.stage_scope("layer5.sconv.mconv.dconv"):
        assert precision.get_precision() == "default"
    with precision.stage_scope("layer4.sconv.mconv.dconv"):
        assert precision.get_precision() == "highest"
    with precision.stage_scope("style.2"):
        assert precision.get_precision() == "highest"


def test_proggan_mixed_precision_schedule():
    pnames = tpg.ProgressiveGenerator(resolution=256,
                                      device="cpu").pipeline.stage_names()
    for kw in ({"min_res": 128}, {"min_res": 128, "keep_rgb": False},
               {"min_res": 16, "tier": "int8"}):
        tsched = tpg.mixed_precision_schedule(**kw)
        jsched = jpg.mixed_precision_schedule(**kw)
        assert [tsched(n) for n in pnames] == [jsched(n) for n in pnames]
    precision.set_precision_schedule(tpg.mixed_precision_schedule(128))
    with precision.stage_scope("layer12.conv"):
        assert precision.get_precision() == "default"
    with precision.stage_scope("layer10.conv"):
        assert precision.get_precision() == "highest"
    with precision.stage_scope("output_256x256.conv"):
        assert precision.get_precision() == "highest"


def test_recommended_precision_schedule_scale_aware():
    """The recommended schedules decide as the JAX package's at every
    size it lists and at one it does not, for every stage of a 1024
    model; ProgGAN's at any size."""
    names = _names_1024()
    for size in (128, 256, 512, 1024):
        fake = types.SimpleNamespace(size=size)
        t = tsg.recommended_precision_schedule(fake)
        j = jsg.recommended_precision_schedule(fake)
        assert [t(n) for n in names] == [j(n) for n in names], size
    t1024 = tsg.recommended_precision_schedule(
        types.SimpleNamespace(size=1024))
    precision.set_precision("high")
    assert _decides(precision, t1024, "layer17.sconv.mconv.dconv") == \
        "default"
    assert _decides(precision, t1024, "layer15.sconv.mconv.dconv") == "high"
    pnames = tpg.ProgressiveGenerator(resolution=1024,
                                      device="cpu").pipeline.stage_names()
    tp = tpg.recommended_precision_schedule(types.SimpleNamespace(size=1024))
    jp = jpg.recommended_precision_schedule(types.SimpleNamespace(size=1024))
    assert [tp(n) for n in pnames] == [jp(n) for n in pnames]
    assert tp("layer5.conv") == "default" and tp("layer4.conv") is None
    assert tp("output_1024x1024.conv") is None


def test_precision_schedule_suspension():
    """schedule_suspended and suspend_schedule_in pin the global tier
    inside a matching stage; a StagePipeline enters each stage's scope, so
    a stage sees its own tier."""
    precision.set_precision_schedule(tsg.mixed_precision_schedule(
        min_res=16, tier="default", keep_rgb=False))
    seen = []

    def probe(params, d):
        seen.append(precision.get_precision())
        return d

    with precision.stage_scope("layer5.sconv.mconv.dconv"):
        probe(None, None)
        with precision.schedule_suspended():
            probe(None, None)
        precision.suspend_schedule_in(probe)(None, None)
    pipe = StagePipeline([Stage("layer4.sconv.mconv.dconv", probe),
                          Stage("layer5.sconv.mconv.dconv", probe),
                          Stage("to_rgb4.rgb", probe)])
    pipe({}, DataBag())
    precision.suspend_schedule_in(pipe)({}, DataBag())
    assert seen == ["default", "highest", "highest",
                    "highest", "default", "default",
                    "highest", "highest", "highest"]
    with pytest.raises(ValueError):
        precision.set_precision("bf16")


def _golden(goldens):
    g = goldens("stylegan2_tiny")
    sd = {k[len("sd."):]: g[k] for k in g.files if k.startswith("sd.")}
    jm = jsg.SeqStyleGAN2(size=16, style_dim=64, n_mlp=2)
    tm = tsg.SeqStyleGAN2(16, style_dim=64, n_mlp=2, device="cpu")
    return (g, jm, jsg.params_from_state_dict(jm, sd), tm,
            tsg.params_from_state_dict(tm, sd))


def _psnr(out, ref):
    return 10 * np.log10(4.0 / np.mean(np.square(out - ref)))


def test_int8_tier_schedule(goldens, monkeypatch):
    """An int8 schedule routes the dconvs through conv2d_w8a8 (the other
    ops of its stages at "default"): the port stays within W8A8 noise of
    its fp32 forward, and under suspension renders bit for bit its forward
    without a schedule.  Against the JAX package, whose CPU computes
    "default" in fp32, the port's other ops are held in fp32 too."""
    g, jm, jp, tm, tp = _golden(goldens)
    z = g["z"]
    sched = dict(min_res=8, tier="int8", keep_rgb=True)
    precision.set_precision_schedule(tsg.mixed_precision_schedule(**sched))
    with precision.stage_scope("layer4.sconv.mconv.dconv"):
        assert precision.int8_active()
        assert precision.get_precision() == "default"
    with precision.stage_scope("to_rgb3.rgb"):
        assert not precision.int8_active()
    with precision.schedule_suspended():
        with precision.stage_scope("layer4.sconv.mconv.dconv"):
            assert not precision.int8_active()
    quant_out = tm(tp, z, fast=False).numpy()
    with precision.schedule_suspended():
        pinned = tm(tp, z, fast=False).numpy()
    precision.set_precision_schedule(None)
    ref = tm(tp, z, fast=False).numpy()
    err = quant_out - ref
    assert np.abs(err).max() > 0, "the int8 path did not run"
    assert _psnr(quant_out, ref) > 30.0
    np.testing.assert_array_equal(pinned, ref)
    jprecision.set_precision_schedule(jsg.mixed_precision_schedule(**sched))
    try:
        jquant_out = np.asarray(jm(jp, jnp.asarray(z), fast=False))
    finally:
        jprecision.set_precision_schedule(None)
    monkeypatch.setattr(tsg, "tiered", lambda fn, *t, **kw: fn(*t, **kw))
    precision.set_precision_schedule(tsg.mixed_precision_schedule(**sched))
    int8_only = tm(tp, z, fast=False).numpy()
    assert np.abs(int8_only - jquant_out).max() <= \
        1e-3 * np.abs(jquant_out).max()


def test_default_tier_rounds_the_operands(goldens):
    """Under "default" a conv or matmul takes bf16 operands and returns
    fp32; the global "high" computes as "highest" bit for bit; a
    "default" schedule from 8 px on the golden stays above 30 dB."""
    rng = np.random.RandomState(0)
    x = torch.tensor(rng.randn(2, 8, 6, 6).astype(np.float32))
    w = torch.tensor(rng.randn(4, 8, 3, 3).astype(np.float32))
    precision.set_precision_schedule(lambda name: "default")
    with precision.stage_scope("any"):
        got = precision.tiered(F.conv2d, x, w, padding=1)
    assert got.dtype == torch.float32
    assert torch.equal(got, F.conv2d(x.bfloat16(), w.bfloat16(),
                                     padding=1).float())
    assert torch.equal(precision.tiered(F.conv2d, x, w, padding=1),
                       F.conv2d(x, w, padding=1))
    precision.set_precision_schedule(None)
    g, _, _, tm, tp = _golden(goldens)
    ref = tm(tp, g["z"]).numpy()
    precision.set_precision("high")
    assert np.array_equal(tm(tp, g["z"]).numpy(), ref)
    precision.set_precision("highest")
    precision.set_precision_schedule(tsg.mixed_precision_schedule(8))
    low = tm(tp, g["z"]).numpy()
    assert 0 < np.abs(low - ref).max() and _psnr(low, ref) > 30.0


def test_cast_params():
    tree = {"a": {"w": torch.ones(2), "n": torch.arange(3)},
            "b": [torch.zeros(1, dtype=torch.float64)]}
    out = precision.cast_params(tree, torch.bfloat16)
    assert out["a"]["w"].dtype == torch.bfloat16
    assert out["a"]["n"].dtype == torch.int64
    assert out["b"][0].dtype == torch.bfloat16
    assert tree["a"]["w"].dtype == torch.float32


def test_quantize_weight_roundtrip_bound():
    w = np.random.RandomState(3).randn(8, 16, 3, 3).astype(np.float32)
    w_i8, scale = quant.quantize_weight_per_channel(torch.tensor(w), axis=0)
    assert w_i8.dtype == torch.int8 and tuple(scale.shape) == (8, 1, 1, 1)
    back = quant.dequantize(w_i8, scale).numpy()
    np.testing.assert_array_less(
        np.abs(back - w), np.broadcast_to(scale.numpy() / 2 + 1e-7, w.shape))
    jw, js = jquant.quantize_weight_per_channel(jnp.asarray(w), axis=0)
    np.testing.assert_array_equal(w_i8.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(js))
    w[0] = 0.0
    w_i8, scale = quant.quantize_weight_per_channel(torch.tensor(w), axis=0)
    assert np.isfinite(quant.dequantize(w_i8, scale).numpy()).all()


@pytest.mark.parametrize("case", ["same", "up", "narrow"])
def test_conv2d_w8a8_matches_jax(case):
    """conv2d_w8a8 bit for bit the JAX package's (the plain conv and the
    up-conv's lhs-dilated one), and its integer GEMM its float64 plain
    version; "narrow" pads the GEMM's rows, columns and outputs."""
    rng = np.random.RandomState(4)
    (b, h, ci, co), pad, dil = {
        "same": ((2, 8, 16, 8), ((1, 1), (1, 1)), None),
        "up": ((2, 5, 12, 8), ((2, 2), (2, 2)), (2, 2)),
        "narrow": ((1, 3, 3, 5), ((1, 1), (1, 1)), None)}[case]
    x = rng.randn(b, h, h, ci).astype(np.float32)
    w = (rng.randn(co, ci, 3, 3) * 0.1).astype(np.float32)
    w_i8, w_scale = quant.quantize_weight_per_channel(torch.tensor(w))
    xt = torch.tensor(x.transpose(0, 3, 1, 2))
    got = quant.conv2d_w8a8(xt, w_i8, w_scale, padding=pad,
                            lhs_dilation=dil)
    jw, js = jquant.quantize_weight_per_channel(jnp.asarray(w))
    want = np.asarray(jquant.conv2d_w8a8(jnp.asarray(x), jw, js,
                                         padding=pad, lhs_dilation=dil))
    np.testing.assert_array_equal(got.numpy().transpose(0, 2, 3, 1), want)
    x_i8, _ = quant.quantize_activation(xt)
    assert torch.equal(quant.int_conv(x_i8, w_i8, pad, dil),
                       quant.int_conv_reference(x_i8, w_i8, pad, dil))
    with pytest.raises(ValueError):
        quant.conv2d_w8a8(xt, w_i8, w_scale, window_strides=(2, 2))


@pytest.mark.parametrize("shape,tiling,epilogue", [
    ((8, 8, 16, 8), {}, False), ((16, 12, 8, 16), {"th": 4}, False),
    ((8, 8, 16, 8), {}, True)], ids=["8x8", "16x12-row-tiles", "epilogue"])
def test_k1_one_pass_plain_version_matches_pallas(shape, tiling, epilogue):
    """K1's one-pass plain version (x and the taps rounded to bf16, the
    rest fp32) against upconv_blur_pallas in interpret mode fed the same
    rounded operands at HIGHEST."""
    h, w, ic, oc = shape
    rng = np.random.RandomState(7)
    x = rng.randn(2, h, w, ic).astype(np.float32)
    wt = (rng.randn(3, 3, ic, oc) * 0.1).astype(np.float32)
    kf = (0.25, 0.75, 0.75, 0.25)
    extra, jextra = (), {}
    if epilogue:
        demod = (rng.rand(2, oc) + 0.5).astype(np.float32)
        noise = rng.randn(1, 2 * h, 2 * w, 1).astype(np.float32)
        bias = rng.randn(oc).astype(np.float32)
        extra = (torch.tensor(demod),
                 torch.tensor(noise.transpose(0, 3, 1, 2).copy()),
                 torch.tensor(bias))
        jextra = dict(demod=jnp.asarray(demod), noise=jnp.asarray(noise),
                      bias=jnp.asarray(bias))
    xt = torch.tensor(x.transpose(0, 3, 1, 2).copy())
    wf = torch.tensor(wt.transpose(3, 2, 0, 1).copy())
    got = kup.upconv_blur(xt, wf, kf, *extra, tier="default").numpy()
    rounded = [np.asarray(torch.tensor(a).bfloat16().float())
               for a in (x, wt)]
    want = np.asarray(upconv_blur_pallas(
        jnp.asarray(rounded[0]), jnp.asarray(rounded[1]), kf=kf,
        interpret=True, **tiling, **jextra))
    got = got.transpose(0, 2, 3, 1)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    exact = kup.upconv_blur(xt, wf, kf, *extra).numpy().transpose(0, 2, 3, 1)
    assert np.abs(got - exact).max() > 1e-5 * np.abs(exact).max()
    with pytest.raises(ValueError):
        kup.upconv_blur(xt, wf, kf, *extra, tier="bf16")
    # the mode's kernel (csrc/upconv_blur_bf16.cu) takes its tile from
    # _plan_bf16: 128 positions a block at most, within the shared memory
    for b, i, hh, o in ((8, 128, 256, 64), (16, 256, 128, 128),
                        (8, 512, 4, 512)):
        g = kup._geometry_bf16(kup._plan_bf16(b, i, hh, hh, o))
        assert g["m_valid"] <= 128 and g["smem"] <= 232448


def test_upsample2d_narrow_channel_matmul_dispatch():
    """upfirdn2d_matmul's operator matrices are the JAX package's (a
    negative pad too), and the separable form matches the JAX package's
    and the port's depthwise upsample2d."""
    taps = tup.separable_taps([1, 3, 3, 1])
    assert taps == jup.separable_taps([1, 3, 3, 1])
    for args in ((16, taps, 2, 1, 2, 1), (12, taps, 1, 2, -1, 2),
                 (9, (0.5, 0.5), 2, 1, 0, 1)):
        np.testing.assert_array_equal(tup._upfirdn1d_matrix(*args),
                                      jup._upfirdn1d_matrix(*args))
    x = np.random.RandomState(0).randn(2, 16, 16, 3).astype(np.float32)
    xt = torch.tensor(x.transpose(0, 3, 1, 2).copy())
    got = tup.upfirdn2d_matmul(xt, taps, taps, up=2, pad=(2, 1), gain=4.0)
    assert tuple(got.shape) == (2, 3, 32, 32)
    want = tup.upsample2d(xt, tup.make_kernel([1, 3, 3, 1]))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5,
                               rtol=2e-5)
    jgot = np.asarray(jup.upfirdn2d_matmul(jnp.asarray(x), taps, taps, up=2,
                                           pad=(2, 1), gain=4.0))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), jgot,
                               atol=2e-5, rtol=2e-5)


def test_whole_tensor_scales():
    """Within ``whole_tensor_scales`` an activation's scale is the max over
    every rank's share (here `reduce_max` stands for the other ranks, one
    of whose |x| reaches 3.0), an empty share adds 0 with the ``_EPS``
    floor kept, and outside it nothing changes; a row-parallel weight
    takes each output channel's max over the shares the same way."""
    rng = np.random.RandomState(0)
    x = torch.tensor(rng.uniform(-1, 1, (2, 3, 4, 4)).astype(np.float32))
    alone = quant.quantize_activation(x)
    seen = []

    def others(t):
        seen.append(t.clone())
        return torch.clamp_min(t, 3.0)
    with quant.whole_tensor_scales(others):
        x_i8, scale = quant.quantize_activation(x)
        empty_i8, empty_scale = quant.quantize_activation(x[:0])
    assert float(seen[0]) == float(x.abs().max()) and float(seen[1]) == 0.0
    assert float(scale) == float(torch.tensor(3.0) / 127.0)
    assert torch.equal(x_i8, torch.round(x / scale).to(torch.int8))
    assert empty_i8.shape == (0, 3, 4, 4) and float(empty_scale) == float(scale)
    with quant.whole_tensor_scales(lambda t: t):
        _, floor = quant.quantize_activation(torch.zeros(0, 3))
    assert float(floor) == float(torch.tensor(quant._EPS) / 127.0)
    again = quant.quantize_activation(x)
    assert torch.equal(again[0], alone[0]) and torch.equal(again[1], alone[1])
    w = torch.tensor(rng.randn(4, 6, 3, 3).astype(np.float32))
    w_i8, w_scale = quant.quantize_weight_per_channel(
        w[:, :3], reduce_max=lambda t: torch.maximum(
            t, w[:, 3:].abs().amax(dim=(1, 2, 3), keepdim=True)))
    whole_i8, whole_scale = quant.quantize_weight_per_channel(w)
    assert torch.equal(w_scale, whole_scale)
    assert torch.equal(w_i8, whole_i8[:, :3])
"""The port's fused up-conv + blur (K1, rewriting_torch/ops/upconv_blur.py)
against the JAX package's.

The CUDA kernel runs only on the card, where chip_smoke.py holds it against
its plain version; here the plain version ``upconv_blur_reference`` is held
against ``upconv_blur_pallas`` in interpret mode and against the JAX
``upconv_blur_reference``, on the cases of tests/test_pallas.py:89-174.
Inputs are numpy arrays from a seed, NHWC and HWIO for the JAX package,
NCHW and OIHW for the port.  Limit: 1e-5 of max |JAX|, the limit
tests/test_pallas.py holds the Pallas kernel to.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from rewriting_tpu.ops import pallas_upconv as jax_upconv
from rewriting_tpu.ops.fused_act import fused_leaky_relu as jax_lrelu
from rewriting_tpu.ops.pallas_upconv import (
    upconv_blur_pallas, upconv_blur_reference as jax_upconv_reference)
from rewriting_torch.ops import upconv_blur as kup
from rewriting_torch.ops.upconv_blur import (blur_taps, upconv_blur,
                                             upconv_blur_cuda,
                                             upconv_blur_reference)

torch.set_num_threads(1)

RTOL = 1e-5
KF_STD = (0.25, 0.75, 0.75, 0.25)
KF_ASYM = (0.1, 0.5, 0.9, 0.5)

# (h, w, in_c, out_c, Pallas tiling): tests/test_pallas.py:96-101
SHAPES = [((8, 8, 16, 8), {}), ((16, 12, 8, 16), {}), ((4, 4, 4, 4), {}),
          ((16, 8, 8, 16), {"th": 4}), ((8, 8, 8, 16), {"ob": 8})]
SHAPE_IDS = ["8x8-16to8", "16x12-8to16", "4x4-single-tile", "row-tiles",
             "o-blocks"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _case(h, w, ic, oc, seed, batch=2):
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, h, w, ic).astype(np.float32)
    wt = (rng.randn(3, 3, ic, oc) * 0.1).astype(np.float32)
    return x, wt


def _port(x, wt, kf, demod=None, noise=None, bias=None):
    """The port's plain K1 on the JAX layouts: x NHWC -> NCHW, wt HWIO ->
    the (O, I, 3, 3) correlation taps, noise (B, 2H, 2W, 1) -> NCHW."""
    extra = ()
    if demod is not None:
        extra = (_t(demod), _t(noise.transpose(0, 3, 1, 2)), _t(bias))
    y = upconv_blur_reference(_t(x.transpose(0, 3, 1, 2)),
                              _t(wt.transpose(3, 2, 0, 1)), kf, *extra)
    return y.numpy().transpose(0, 2, 3, 1)


def _close(got, want):
    assert got.shape == want.shape
    rel = np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)
    assert rel < RTOL, rel


@pytest.mark.parametrize("shape,tiling", SHAPES, ids=SHAPE_IDS)
def test_plain_matches_pallas_interpret(shape, tiling):
    """Against K1 itself, upconv_blur_pallas(interpret=True), at each of
    its tilings, and against the JAX reference of the same math."""
    h, w, ic, oc = shape
    x, wt = _case(h, w, ic, oc, seed=sum(shape))
    got = _port(x, wt, KF_STD)
    assert got.shape == (2, 2 * h, 2 * w, oc)
    _close(got, np.asarray(upconv_blur_pallas(jnp.asarray(x),
                                              jnp.asarray(wt),
                                              interpret=True, **tiling)))
    _close(got, np.asarray(jax_upconv_reference(jnp.asarray(x),
                                                jnp.asarray(wt))))


def test_asymmetric_taps_match_pallas():
    """Both packages take kf in FIR orientation and flip it inside (the
    regression of tests/test_pallas.py:113-121)."""
    x, wt = _case(8, 8, 16, 8, seed=5, batch=1)
    got = _port(x, wt, KF_ASYM)
    _close(got, np.asarray(upconv_blur_pallas(
        jnp.asarray(x), jnp.asarray(wt), kf=KF_ASYM, interpret=True)))
    _close(got, np.asarray(jax_upconv_reference(jnp.asarray(x),
                                                jnp.asarray(wt),
                                                kf=KF_ASYM)))
    assert np.abs(got - _port(x, wt, KF_ASYM[::-1])).max() > 1e-3


@pytest.mark.parametrize("noise_batch", [2, 1],
                         ids=["per-batch-noise", "broadcast-noise"])
def test_epilogue_matches_pallas(noise_batch):
    """The demod + noise + bias + leaky-ReLU epilogue, with a noise map per
    batch index and one broadcast to every index
    (tests/test_pallas.py:143-174)."""
    b, h, w, ic, oc = 2, 8, 8, 16, 8
    rng = np.random.RandomState(2)
    x = rng.randn(b, h, w, ic).astype(np.float32)
    wt = (rng.randn(3, 3, ic, oc) * 0.1).astype(np.float32)
    demod = (rng.rand(b, oc) + 0.5).astype(np.float32)
    noise = rng.randn(noise_batch, 2 * h, 2 * w, 1).astype(np.float32)
    bias = rng.randn(oc).astype(np.float32)
    got = _port(x, wt, KF_STD, demod, noise, bias)
    j = [jnp.asarray(v) for v in (x, wt, demod, noise, bias)]
    _close(got, np.asarray(upconv_blur_pallas(
        j[0], j[1], demod=j[2], noise=j[3], bias=j[4], interpret=True)))
    chain = jax_upconv_reference(j[0], j[1]) * j[2][:, None, None, :] + j[3]
    _close(got, np.asarray(jax_lrelu(chain, j[4])))


def test_dispatch_on_cpu_is_the_plain_version():
    x, wt = _case(4, 6, 8, 8, seed=3)
    xt, wf = _t(x.transpose(0, 3, 1, 2)), _t(wt.transpose(3, 2, 0, 1))
    assert torch.equal(upconv_blur(xt, wf, KF_STD),
                       upconv_blur_reference(xt, wf, KF_STD))
    with pytest.raises(RuntimeError, match="no path for device"):
        upconv_blur(xt.to("meta"), wf.to("meta"), KF_STD)


def test_wrapper_checks_its_inputs():
    """The kernel wrapper raises before any build on a CPU tensor; the
    epilogue's three inputs go together; the blur has four taps."""
    x = torch.zeros((1, 8, 4, 4))
    wf = torch.zeros((8, 8, 3, 3))
    with pytest.raises(ValueError, match="CUDA tensor"):
        upconv_blur_cuda(x, wf, KF_STD)
    with pytest.raises(ValueError, match="go together"):
        upconv_blur_reference(x, wf, KF_STD, demod=torch.ones((1, 8)))
    with pytest.raises(ValueError, match="4 blur taps"):
        blur_taps((1, 2, 1))
    flipped = np.asarray(KF_ASYM[::-1], np.float32)
    np.testing.assert_array_equal(blur_taps(KF_ASYM),
                                  np.outer(flipped, flipped))


def test_gate_modes():
    """"off" is the default, as in the JAX package, with min_res 256;
    "on" runs K1 where the gates pass; the epilogue switch is on by default
    and counts only when K1 runs.  The functions take the JAX arguments."""
    assert kup._FUSED_MODE == "off" and kup._FUSED_MIN_RES == 256
    assert not (kup.fused_upconv_active(256, 128, 256)
                or kup.fused_epilogue_active(256, 128, 256))
    try:
        kup.set_fused_upconv("on")
        assert kup.fused_upconv_active(256, 128, 256)
        assert kup.fused_upconv_active(256, 128)
        assert not kup.fused_upconv_active(512, 512, 128)
        kup.set_fused_epilogue(False)
        assert not kup.fused_epilogue_active(256, 128, 256)
        kup.set_fused_epilogue(True)
        assert kup.fused_epilogue_active(256, 128, 256)
        kup.set_fused_upconv("on", min_res=0)
        assert kup.fused_upconv_active(512, 512, 8)
        kup.set_fused_upconv("off")
        assert kup._FUSED_MIN_RES == 0     # min_res=None leaves it as is
        assert not (kup.fused_upconv_active(512, 512, 8)
                    or kup.fused_epilogue_active(512, 512, 8))
    finally:
        kup.set_fused_upconv("off", min_res=256)
        kup.set_fused_epilogue(True)
    with pytest.raises(ValueError):
        kup.set_fused_upconv("sometimes")


# (in_c, out_c, output res): the church-256 upsampling layers, then a
# narrow, a not-multiple-of-8 and a low-resolution case
GATE_LAYERS = [(512, 512, 8), (512, 512, 16), (512, 512, 32),
               (512, 512, 64), (512, 256, 128), (256, 128, 256),
               (48, 64, 256), (68, 64, 256), (128, 128, 16)]


@pytest.mark.parametrize("mode", ["off", "on"])
@pytest.mark.parametrize("min_res", [None, 0, 256])
def test_gate_matches_jax(mode, min_res):
    """fused_upconv_active and fused_epilogue_active give the JAX
    package's answers for each mode and min_res, on each layer, with the
    res given and left out.  Both modules' state is restored."""
    saved = (jax_upconv._FUSED_MODE, jax_upconv._FUSED_MIN_RES)
    try:
        for mod in (jax_upconv, kup):
            mod.set_fused_upconv(mode, min_res)
        for in_c, out_c, res in GATE_LAYERS:
            for r in (res, None):
                assert (kup.fused_upconv_active(in_c, out_c, r)
                        == jax_upconv.fused_upconv_active(in_c, out_c, r))
                assert (kup.fused_epilogue_active(in_c, out_c, r)
                        == jax_upconv.fused_epilogue_active(in_c, out_c, r))
    finally:
        jax_upconv.set_fused_upconv(*saved)
        kup.set_fused_upconv("off", min_res=256)


@pytest.mark.parametrize("min_res", [0, 256])
def test_gate_auto_is_on(min_res):
    """The port's "auto" is "on" with the same gates (it needs no TPU
    probe)."""
    try:
        answers = {}
        for mode in ("auto", "on"):
            kup.set_fused_upconv(mode, min_res)
            answers[mode] = [kup.fused_upconv_active(*layer)
                             for layer in GATE_LAYERS]
        assert answers["auto"] == answers["on"]
        assert any(answers["on"])
    finally:
        kup.set_fused_upconv("off", min_res=256)


@pytest.mark.parametrize("kf", [KF_STD, KF_ASYM], ids=["std", "asym"])
def test_chip_smoke_composite_yardstick(kf):
    """chip_smoke.py's yardstick (b), the blur-folded (4O, I, 3, 3)
    composite conv and its phase interleave, computes K1's function."""
    x, wt = _case(6, 7, 5, 3, seed=8)
    xt, wf = _t(x.transpose(0, 3, 1, 2)), _t(wt.transpose(3, 2, 0, 1))
    comp = chip_smoke.composite_up_kernel(torch, wf, kf)
    got = chip_smoke.composite_upconv(torch, xt, comp)
    want = upconv_blur_reference(xt, wf, kf)
    _close(got.numpy(), want.numpy())


@pytest.mark.parametrize("kf", [KF_STD, KF_ASYM], ids=["std", "asym"])
def test_chip_smoke_library_yardstick(kf):
    """chip_smoke.py's one-call yardstick: conv_transpose2d with the 6x6
    weight (the convT weight fully convolved with outer(kf, kf)), stride
    2, padding 2, computes K1's function."""
    x, wt = _case(6, 7, 5, 3, seed=9)
    xt, wf = _t(x.transpose(0, 3, 1, 2)), _t(wt.transpose(3, 2, 0, 1))
    got = chip_smoke.library_upconv(
        torch, xt, chip_smoke.library_up_kernel(torch, wf, kf))
    _close(got.numpy(), upconv_blur_reference(xt, wf, kf).numpy())


def test_tf32_round_is_cvt_rna():
    """Round to 10 mantissa bits, ties away from zero, as
    cvt.rna.tf32.f32 does."""
    ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1 + ulp / 2, 1 + 3 * ulp / 2, -(1 + ulp / 2),
                      1 + ulp / 4, 1 + 3 * ulp / 4, 3.0e-3])
    got = kup._tf32_round(x)
    want = torch.tensor([1.0, 1 + ulp, 1 + 2 * ulp, -(1 + ulp), 1.0,
                         1 + ulp, float(np.float32(3.0e-3))])
    np.testing.assert_array_equal(got[:6].numpy(), want[:6].numpy())
    assert abs(float(got[6]) - 3.0e-3) <= 3.0e-3 * 2.0 ** -11
    assert int(got.view(torch.int32)[6]) & 0x1FFF == 0


@pytest.mark.parametrize("in_c", [256, 512])
def test_split_3xtf32_is_as_exact_as_fp32(in_c):
    """At K1's reduction depths (I x 9), the 3xTF32 split product is within
    1e-6 of max |fp64| (fp32's own error is about 4e-7); one TF32 product
    is more than 1e-5 off, so the check can tell the two apart."""
    k = in_c * 9
    rng = np.random.RandomState(in_c)
    a = rng.randn(64, k).astype(np.float32)
    b = (rng.randn(k, 32) / np.sqrt(k)).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    at, bt = _t(a), _t(b)
    split = kup._split_matmul_3xtf32(at, bt).double().numpy()
    plain = (kup._tf32_round(at) @ kup._tf32_round(bt)).double().numpy()
    scale = np.abs(want).max()
    assert np.abs(split - want).max() / scale < 1e-6
    assert np.abs(plain - want).max() / scale > 1e-5


def _grid(b, h, w, out_c, t):
    """The launcher's grid (csrc/upconv_blur.cu): output-channel blocks,
    tiles, batch groups."""
    return (-(-out_c // (16 * t.warps_n)), -(-h // t.th) * -(-w // t.tw),
            -(-b // t.nimg))


def _covered_once(n, starts, size):
    count = np.zeros(n, np.int64)
    for s in starts:
        count[s:s + size] += 1
    return bool((count == 1).all())


PLAN_SHAPES = ([(b, i, h, h, o) for b in (1, 16)
                for i, h, o in chip_smoke.UPCONV_SHAPES]
               + [(2, 64, 12, 20, 64), (3, 9, 4, 4, 17), (5, 8, 1, 1, 8),
                  (1, 16, 100, 5, 24), (2, 72, 9, 30, 40)])


@pytest.mark.parametrize("shape", PLAN_SHAPES,
                         ids=["x".join(map(str, s)) for s in PLAN_SHAPES])
def test_plan_tiles_cover_every_output_once(shape):
    """The tile of each church-256 layer at batch 1 and 16, and of ragged
    shapes: the blocks' output channels, images and output rows and
    columns each cover the output exactly once; a block's warps hold its
    positions (the tile and its halo), it has at most 384 threads (168
    registers each) and at most 227 KB of shared memory; the church-256
    layers at batch 16 give a grid of at least 132 blocks."""
    b, in_c, h, w, out_c = shape
    t = kup._plan(b, in_c, h, w, out_c)
    g = kup._geometry(t)
    assert t.kc % 8 == 0 and (t.nimg == 1 or (t.th, t.tw) == (h, w))
    assert g["m_valid"] <= t.warps_m * 32
    assert g["threads"] <= 384
    assert g["smem"] <= 232448
    oblocks, tiles, bgroups = _grid(b, h, w, out_c, t)
    tiles_x = -(-w // t.tw)
    assert tiles == -(-h // t.th) * tiles_x
    assert _covered_once(out_c, range(0, oblocks * g["nblk"], g["nblk"]),
                         g["nblk"])
    assert _covered_once(b, range(0, bgroups * t.nimg, t.nimg), t.nimg)
    count = np.zeros((2 * h, 2 * w), np.int64)
    for by in range(tiles):
        u0, w0 = (by // tiles_x) * t.th, (by % tiles_x) * t.tw
        count[2 * u0:2 * u0 + 2 * t.th, 2 * w0:2 * w0 + 2 * t.tw] += 1
    assert (count == 1).all()
    if b == 16 and (in_c, h, out_c) in chip_smoke.UPCONV_SHAPES:
        assert oblocks * tiles * bgroups >= 132

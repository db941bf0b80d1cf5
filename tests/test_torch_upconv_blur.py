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
    """"auto" (the default) and "on" run K1, "off" the seq stages; the
    epilogue switch is on by default and counts only when K1 runs."""
    assert kup.fused_upconv_active() and kup.fused_epilogue_active()
    try:
        kup.set_fused_upconv("on")
        assert kup.fused_upconv_active()
        kup.set_fused_epilogue(False)
        assert not kup.fused_epilogue_active()
        kup.set_fused_epilogue(True)
        kup.set_fused_upconv("off")
        assert not (kup.fused_upconv_active()
                    or kup.fused_epilogue_active())
    finally:
        kup.set_fused_upconv("auto")
        kup.set_fused_epilogue(True)


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

"""The port's 2x polyphase FIR upsample (K3, rewriting_torch/ops/
upsample2x.py) against the JAX package's.

The CUDA kernel runs only on the card, where chip_smoke.py holds it against
its plain version; here the plain version ``upsample2x_reference`` is held
against ``upsample2x_pallas`` in interpret mode (as tests/test_pallas.py:
15-40 runs it) and against the JAX ``upfirdn2d``, and the port's
``upsample2d`` dispatch against the JAX one.  Inputs are NHWC numpy arrays
from a seed, transposed to NCHW for the port.  Limit: 1e-5 abs (fp32, the
same taps summed in the same order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
from rewriting_tpu.ops import upfirdn2d as jax_upfirdn2d
from rewriting_tpu.ops.pallas_upfirdn import _phase_taps, upsample2x_pallas
from rewriting_tpu.ops.upfirdn2d import make_kernel as jax_make_kernel
from rewriting_tpu.ops.upfirdn2d import upsample2d as jax_upsample2d
from rewriting_torch.ops import make_kernel, upfirdn2d, upsample2d
from rewriting_torch.ops import upsample2x as kup2
from rewriting_torch.ops.upsample2x import (phase_offsets, upsample2x_cuda,
                                            upsample2x_reference)

torch.set_num_threads(1)

ATOL = 1e-5

# (NHWC shape, taps): tests/test_pallas.py:15-28 and odd sizes, 2-, 3- and
# asymmetric 4-tap FIRs; the pad is upsample2d's for the tap count
CASES = [((2, 16, 16, 128), (1, 3, 3, 1)), ((1, 12, 20, 64), (1, 3, 3, 1)),
         ((1, 9, 7, 64), (1, 2, 1)), ((2, 5, 6, 72), (1, 1)),
         ((1, 8, 8, 64), (1, 2, 3, 1))]
IDS = [f"{s[1]}x{s[2]}x{s[3]}-k{len(t)}" for s, t in CASES]


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.numpy().transpose(0, 2, 3, 1)


def _case(shape, taps):
    x = np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32)
    kern = np.asarray(jax_make_kernel(list(taps))) * 4.0
    k = kern.shape[0]
    pad = ((k - 2 + 1) // 2 + 1, (k - 2) // 2)
    return x, kern, pad


def _port(x, kern, pad):
    kflip = np.ascontiguousarray(np.flip(kern, (0, 1)))
    return _nhwc(upsample2x_reference(_nchw(x), kflip, pad))


@pytest.mark.parametrize("shape,taps", CASES, ids=IDS)
def test_plain_matches_pallas_interpret(shape, taps):
    """Against K3, upsample2x_pallas, in interpret mode."""
    x, kern, pad = _case(shape, taps)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(upsample2x_pallas(jnp.asarray(x), kern, pad))
    got = _port(x, kern, pad)
    assert got.shape == (shape[0], 2 * shape[1], 2 * shape[2], shape[3])
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("shape,taps", CASES, ids=IDS)
def test_plain_matches_upfirdn2d(shape, taps):
    """Against the JAX upfirdn2d (zero insertion, pad, correlation) and the
    port's own."""
    x, kern, pad = _case(shape, taps)
    want = np.asarray(jax_upfirdn2d(jnp.asarray(x), jnp.asarray(kern), up=2,
                                    down=1, pad=pad))
    np.testing.assert_allclose(_port(x, kern, pad), want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        _nhwc(upfirdn2d(_nchw(x), kern, up=2, pad=pad)), want, atol=ATOL,
        rtol=0)


@pytest.mark.parametrize("k,pad0", [(4, 2), (3, 2), (2, 1), (5, 3), (4, -1)])
def test_phase_offsets_match_jax(k, pad0):
    """The taps each output phase reads, and the input offsets, as the JAX
    kernel's _phase_taps computes them."""
    kern = np.arange(1, k * k + 1, dtype=np.float32).reshape(k, k)
    taps, halo, _ = _phase_taps(kern, pad0)
    offs = phase_offsets(k, pad0)
    kflip = np.flip(kern, (0, 1))
    for a in (0, 1):
        for b in (0, 1):
            want = sorted(taps[(a, b)])
            got = sorted(((dy + halo, dx + halo), float(kflip[i, j]))
                         for i, dy in offs[a] for j, dx in offs[b])
            assert got == want


@pytest.mark.parametrize("channels", [3, 8, 64, 72, 68])
def test_upsample2d_dispatch_matches_jax(channels, monkeypatch):
    """upsample2d sends maps of >= 64 channels, a multiple of 8, to K3's
    plain version on the CPU and other maps to upfirdn2d; both agree with
    the JAX upsample2d."""
    calls = []

    def counted(*args):
        calls.append(args[0].shape)
        return upsample2x_reference(*args)
    monkeypatch.setattr(kup2, "upsample2x_reference", counted)
    x = np.random.RandomState(9).randn(2, 8, 6, channels).astype(np.float32)
    want = np.asarray(jax_upsample2d(
        jnp.asarray(x), jnp.asarray(jax_make_kernel([1, 3, 3, 1]))))
    got = upsample2d(_nchw(x), make_kernel([1, 3, 3, 1]))
    np.testing.assert_allclose(_nhwc(got), want, atol=ATOL, rtol=0)
    assert len(calls) == (channels >= 64 and channels % 8 == 0)


def test_wrapper_checks_its_inputs():
    """The kernel wrapper raises on a CPU tensor before any build; the
    plain version refuses pads that do not give a 2x output."""
    kflip = np.ones((4, 4), np.float32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        upsample2x_cuda(torch.zeros((1, 64, 4, 4)), kflip, (2, 1))
    with pytest.raises(ValueError, match="2x output"):
        upsample2x_reference(torch.zeros((1, 64, 4, 4)), kflip, (1, 1))
    assert kup2.is_2x(4, (2, 1)) and not kup2.is_2x(4, (2, 2))


@pytest.mark.parametrize("taps", [(1, 3, 3, 1), (1, 2, 3, 1)])
def test_chip_smoke_library_yardstick(taps):
    """chip_smoke.py's yardstick, a depthwise stride-2 conv_transpose2d
    with the unflipped taps, computes K3's function for 4-tap FIRs."""
    x = torch.from_numpy(np.random.RandomState(4).randn(2, 3, 5, 6).astype(
        np.float32))
    kern = make_kernel(list(taps)) * 4.0
    kflip = np.ascontiguousarray(np.flip(kern, (0, 1)))
    np.testing.assert_allclose(
        chip_smoke.up2_library(torch, x, kern).numpy(),
        upsample2x_reference(x, kflip, (2, 1)).numpy(), atol=ATOL, rtol=0)

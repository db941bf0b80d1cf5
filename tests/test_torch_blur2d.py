"""The port's FIR ops (rewriting_torch/ops) against the JAX package's.

The CUDA kernel itself runs only on the card, where chip_smoke.py holds it
and its backward against their plain versions; here the plain version
``blur2d_reference`` is held against the Pallas kernels it stands for, run
as tests/test_pallas.py runs them on the CPU (interpret mode), and against
the XLA ``upfirdn2d``; its gradient against ``jax.grad``; and the adjoint
formula the CUDA backward launches against autograd.  Inputs are NHWC
numpy arrays from a seed, transposed to NCHW for the port.
"""

import os
import stat

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rewriting_tpu.ops import upfirdn2d as jax_upfirdn2d
from rewriting_tpu.ops.pallas_upfirdn import blur2d_pallas, blur2d_pallas_bs
from rewriting_tpu.ops.upfirdn2d import (blur2d as jax_blur2d,
                                         make_kernel as jax_make_kernel,
                                         upsample2d as jax_upsample2d)
from rewriting_torch.ops import _build, make_kernel, upfirdn2d, upsample2d
from rewriting_torch.ops.blur2d import (adjoint, blur2d_backward_reference,
                                        blur2d_cuda, blur2d_reference)
from rewriting_torch.ops.upfirdn2d import blur2d

torch.set_num_threads(1)

# (NHWC shape, taps, gain, pad): tests/test_pallas.py:15-40 and :65-86
BLUR_CASES = [
    ((2, 16, 16, 128), (1, 3, 3, 1), 1.0, (1, 1)),
    ((1, 12, 20, 64), (1, 2, 1), 1.0, (1, 1)),
    ((2, 32, 32, 128), (1, 3, 3, 1), 4.0, (2, 1)),
    ((2, 33, 33, 64), (1, 3, 3, 1), 4.0, (1, 1)),
    ((1, 16, 16, 8), (1, 3, 3, 1), 4.0, (2, 1)),
    ((1, 35, 35, 8), (1, 3, 3, 1), 4.0, (1, 1)),
    ((1, 18, 18, 8), (1, 3, 3, 1), 4.0, (1, 1)),
]
BLUR_IDS = [f"{s[1]}x{s[2]}x{s[3]}-k{len(t)}-pad{p[0]}{p[1]}"
            for s, t, _, p in BLUR_CASES]


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.numpy().transpose(0, 2, 3, 1)


def _case(shape, taps, gain):
    x = np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32)
    kern = np.asarray(jax_make_kernel(list(taps))) * gain
    return x, kern


def _port_blur(x, kern, pad):
    kflip = np.ascontiguousarray(np.flip(kern, (0, 1)))
    return _nhwc(blur2d_reference(_nchw(x), kflip, pad))


@pytest.mark.parametrize("shape,taps,gain,pad", BLUR_CASES, ids=BLUR_IDS)
def test_blur_reference_matches_pallas_interpret(shape, taps, gain, pad):
    """Against K2a, blur2d_pallas, in interpret mode: 1e-5 abs (fp32; the
    same taps summed in the same order)."""
    x, kern = _case(shape, taps, gain)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(blur2d_pallas(jnp.asarray(x), kern, pad))
    np.testing.assert_allclose(_port_blur(x, kern, pad), want, atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("shape,taps,gain,pad", BLUR_CASES, ids=BLUR_IDS)
def test_blur_reference_matches_pallas_blockspec(shape, taps, gain, pad):
    """Against K2b, blur2d_pallas_bs(interpret=True): 1e-4 abs and rel,
    the tolerance tests/test_pallas.py holds that kernel to."""
    x, kern = _case(shape, taps, gain)
    want = np.asarray(blur2d_pallas_bs(jnp.asarray(x), kern, pad,
                                       interpret=True))
    np.testing.assert_allclose(_port_blur(x, kern, pad), want, atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("shape,taps,gain,pad", BLUR_CASES, ids=BLUR_IDS)
def test_blur_reference_matches_upfirdn2d(shape, taps, gain, pad):
    """Against the JAX upfirdn2d (XLA depthwise conv), and the port's own
    upfirdn2d against both: 1e-5 abs."""
    x, kern = _case(shape, taps, gain)
    want = np.asarray(jax_upfirdn2d(jnp.asarray(x), jnp.asarray(kern),
                                    up=1, down=1, pad=pad))
    np.testing.assert_allclose(_port_blur(x, kern, pad), want, atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(_nhwc(upfirdn2d(_nchw(x), kern, pad=pad)),
                               want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("up,down,pad", [(2, 1, (2, 1)), (1, 2, (1, 1)),
                                         (2, 1, (-1, 2)), (1, 1, (-2, -1)),
                                         (2, 2, (1, -1))])
def test_upfirdn2d_matches_jax(up, down, pad):
    """Zero-insert, pad (negative crops), flipped-FIR correlation and
    downsampling against the JAX upfirdn2d: 1e-5 abs."""
    x = np.random.RandomState(7).randn(2, 11, 13, 5).astype(np.float32)
    kern = np.random.RandomState(8).rand(4, 3).astype(np.float32)
    want = np.asarray(jax_upfirdn2d(jnp.asarray(x), jnp.asarray(kern),
                                    up=up, down=down, pad=pad))
    got = _nhwc(upfirdn2d(_nchw(x), kern, up=up, down=down, pad=pad))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("channels", [3, 64])
def test_upsample2d_matches_jax(channels):
    """The RGB-skip upsample (JAX: banded matmul at <=8 channels, depthwise
    conv above): 1e-5 abs."""
    x = np.random.RandomState(9).randn(2, 8, 8, channels).astype(np.float32)
    kern = np.asarray(jax_make_kernel([1, 3, 3, 1]))
    want = np.asarray(jax_upsample2d(jnp.asarray(x), jnp.asarray(kern)))
    got = _nhwc(upsample2d(_nchw(x), make_kernel([1, 3, 3, 1])))
    assert got.shape == (2, 16, 16, channels)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_blur2d_dispatch_on_cpu_matches_jax():
    """The model's blur stage call (gain 4, pad (1,1) after a (2H+1) up-conv
    map) takes the plain version on a CPU tensor: 1e-5 abs."""
    x = np.random.RandomState(3).randn(2, 17, 17, 64).astype(np.float32)
    kern = make_kernel([1, 3, 3, 1])
    want = np.asarray(jax_blur2d(jnp.asarray(x), jnp.asarray(kern), (1, 1),
                                 upsample_factor=2))
    got = _nhwc(blur2d(_nchw(x), kern, (1, 1), upsample_factor=2))
    assert got.shape == (2, 16, 16, 64)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_blur2d_refuses_other_devices():
    x = torch.empty((1, 4, 9, 9), device="meta")
    with pytest.raises(RuntimeError, match="no path for device"):
        blur2d(x, make_kernel([1, 3, 3, 1]), (1, 1))


@pytest.mark.parametrize("bad", ["cpu", "dtype", "layout", "taps"])
def test_blur2d_cuda_checks_its_inputs(bad):
    """The kernel wrapper raises before any build on what the kernel does
    not take (checked on the CPU: the device check comes first)."""
    kflip = np.ones((4, 4), np.float32) / 16
    x = torch.zeros((1, 4, 9, 9))
    if bad == "cpu":
        with pytest.raises(ValueError, match="CUDA tensor"):
            blur2d_cuda(x, kflip, (1, 1))
        return
    # the remaining checks follow the device check; patch the device test
    # by handing the wrapper a tensor subclass claiming to be on CUDA
    class FakeCuda(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda")
    if bad == "dtype":
        x, err = x.double(), TypeError
    elif bad == "layout":
        x, err = x.transpose(2, 3), ValueError
    else:
        kflip, err = np.ones((4, 3), np.float32), ValueError
    with pytest.raises(err):
        blur2d_cuda(x.as_subclass(FakeCuda), kflip, (1, 1))


def test_nvcc_command_targets_sm90a():
    """The build command (built, not run): nvcc for sm_90a into a shared
    library with a plain C interface; no source includes PyTorch."""
    src = _build.SOURCE_DIR / "blur2d.cu"
    out = _build.library_path("blur2d")
    cmd = _build.nvcc_command("/usr/local/cuda/bin/nvcc", src, out)
    assert cmd[0] == "/usr/local/cuda/bin/nvcc"
    assert "arch=compute_90a,code=sm_90a" in cmd
    i = cmd.index("arch=compute_90a,code=sm_90a")
    assert cmd[i - 1] == "-gencode"
    for flag in ("-std=c++17", "-O3", "-shared", "-fPIC"):
        assert flag in cmd
    assert cmd[-3:] == ["-o", str(out), str(src)]
    assert out.parent.name == "_build" and out.name == "libblur2d.so"
    for cu in _build.SOURCE_DIR.glob("*.cu"):
        text = cu.read_text()
        assert "torch/extension.h" not in text and 'extern "C"' in text


def test_build_is_keyed_on_the_source(tmp_path, monkeypatch):
    """A stand-in nvcc shows the build runs once per source hash and
    raises with nvcc's stderr when the compiler fails."""
    calls = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f"echo x >> {calls}\n"
        'for a; do last=$prev; prev=$a; done\n'
        'if grep -q BROKEN "$prev"; then echo "error: bad source" >&2; '
        'exit 2; fi\n'
        'out=""; while [ $# -gt 0 ]; do [ "$1" = -o ] && out=$2; shift; '
        'done\n'
        'echo lib > "$out"\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    src_dir = tmp_path / "csrc"
    src_dir.mkdir()
    (src_dir / "k.cu").write_text('extern "C" int f() { return 0; }\n')
    monkeypatch.setattr(_build, "SOURCE_DIR", src_dir)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    ncalls = lambda: len(calls.read_text().split()) if calls.exists() else 0
    lib = _build.build("k")
    assert lib == tmp_path / "_build" / "libk.so" and lib.read_text() == \
        "lib\n"
    assert ncalls() == 1
    _build.build("k")
    assert ncalls() == 1                  # same source: no second build
    (src_dir / "k.cu").write_text('extern "C" int f() { return 1; }\n')
    _build.build("k")
    assert ncalls() == 2                  # new source: built again
    (src_dir / "k.cu").write_text("BROKEN\n")
    with pytest.raises(RuntimeError, match="bad source"):
        _build.build("k")
    assert not [p for p in os.listdir(tmp_path / "_build")
                if p.endswith(".tmp")]


# ---------------------------------------------------------------------------
# The blur's gradient: the adjoint formula the CUDA backward launches
# ---------------------------------------------------------------------------

# (NCHW shape, taps, gain, pad): the model's (pad (1, 1) after an up-conv,
# gain 4), pad (2, 1), a crop, a 3-tap FIR and non-square maps
GRAD_CASES = [((2, 8, 17, 17), (1, 3, 3, 1), 4.0, (1, 1)),
              ((1, 4, 12, 20), (1, 3, 3, 1), 4.0, (2, 1)),
              ((1, 3, 11, 9), (1, 2, 1), 1.0, (1, 1)),
              ((2, 2, 10, 13), (1, 2, 3, 1), 1.0, (-1, 3)),
              ((1, 5, 9, 9), (1, 3, 3, 1), 1.0, (0, 0))]
GRAD_IDS = [f"{s[2]}x{s[3]}-k{len(t)}-pad{p[0]}{p[1]}"
            for s, t, _, p in GRAD_CASES]


def _grad_case(shape, taps, gain, pad):
    rng = np.random.RandomState(sum(shape) + len(taps))
    x = rng.randn(*shape).astype(np.float32)
    kern = np.asarray(jax_make_kernel(list(taps))) * gain
    kflip = np.ascontiguousarray(np.flip(kern, (0, 1)))
    out = blur2d_reference(torch.from_numpy(x), kflip, pad)
    g = rng.randn(*out.shape).astype(np.float32)
    return x, kern, kflip, g


@pytest.mark.parametrize("shape,taps,gain,pad", GRAD_CASES, ids=GRAD_IDS)
def test_blur_gradient_matches_jax_grad(shape, taps, gain, pad):
    """The gradient of the port's blur (autograd through the plain version)
    against jax.grad of the JAX upfirdn2d blur: 1e-5 abs."""
    import jax
    x, kern, kflip, g = _grad_case(shape, taps, gain, pad)
    xt = torch.from_numpy(x).requires_grad_(True)
    (blur2d_reference(xt, kflip, pad) * torch.from_numpy(g)).sum().backward()
    g_nhwc = jnp.asarray(g.transpose(0, 2, 3, 1))
    want = jax.grad(lambda v: jnp.sum(jax_upfirdn2d(
        v, jnp.asarray(kern), up=1, down=1, pad=pad) * g_nhwc))(
            jnp.asarray(x.transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("shape,taps,gain,pad", GRAD_CASES, ids=GRAD_IDS)
def test_adjoint_formula_matches_autograd(shape, taps, gain, pad):
    """The formula the CUDA backward launches -- the blur of the output
    gradient with the rotated taps and pads (k-1-p0, k-1-p1) -- through
    the plain version, against autograd of the plain version: the input's
    shape, 1e-5 abs."""
    x, _, kflip, g = _grad_case(shape, taps, gain, pad)
    xt = torch.from_numpy(x).requires_grad_(True)
    blur2d_reference(xt, kflip, pad).backward(torch.from_numpy(g))
    got = blur2d_backward_reference(torch.from_numpy(g), kflip, pad)
    assert got.shape == xt.shape
    np.testing.assert_allclose(got.numpy(), xt.grad.numpy(), atol=1e-5,
                               rtol=0)
    taps_rot, apad = adjoint(kflip, pad)
    k = kflip.shape[0]
    np.testing.assert_array_equal(taps_rot, kflip[::-1, ::-1])
    assert apad == (k - 1 - pad[0], k - 1 - pad[1])


def test_blur_function_launches_forward_and_adjoint(monkeypatch):
    """Blur2dFunction's plumbing, with the launch replaced by the plain
    version on the CPU: the forward and the backward each make one launch,
    counted apart, the backward with the adjoint's taps and pads; the
    gradient equals autograd's."""
    from rewriting_torch.ops import blur2d as kb
    seen = []

    def fake_launch(x, kflip, pad):
        seen.append((np.array(kflip), tuple(pad)))
        return blur2d_reference(x, kflip, pad)
    monkeypatch.setattr(kb, "_launch", fake_launch)
    monkeypatch.setattr(kb, "launches", 0)
    monkeypatch.setattr(kb, "backward_launches", 0)
    x, _, kflip, g = _grad_case(*GRAD_CASES[1])
    xt = torch.from_numpy(x).requires_grad_(True)
    kb.Blur2dFunction.apply(xt, kflip, (2, 1)).backward(torch.from_numpy(g))
    assert (kb.launches, kb.backward_launches) == (1, 1)
    np.testing.assert_array_equal(seen[1][0], kflip[::-1, ::-1])
    assert seen[0][1] == (2, 1) and seen[1][1] == (1, 2)
    x2 = torch.from_numpy(x).requires_grad_(True)
    blur2d_reference(x2, kflip, (2, 1)).backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), x2.grad.numpy(), atol=1e-5,
                               rtol=0)

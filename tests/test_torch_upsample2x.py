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

import ctypes
import re

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


# ---------------------------------------------------------------------------
# The separable kernel: its factors and phase taps, its cut of a launch, its
# block/warp/lane/row loops transliterated to numpy, and its launch path
# ---------------------------------------------------------------------------

from rewriting_torch import _native_build as _build  # noqa: E402
from rewriting_torch.ops import blur2d as kb  # noqa: E402
from rewriting_torch.ops.upfirdn2d import upsample_taps  # noqa: E402

# the 1-D tap lists upsample2d is given: 2-, 3- and 4-tap, and asymmetric
SEP_TAPS = [(1, 1), (1, 2, 1), (1, 3, 3, 1), (1, 2, 3, 1)]
SEP_IDS = ["".join(map(str, t)) for t in SEP_TAPS]
RANK2 = chip_smoke.rank2_kflip(np)
STAGES = 4       # kStages in csrc/upsample2x.cu
RING_PAD = 8     # kRingPad


def _up_kflip(taps):
    """(kflip, pad) of upsample2d for a 1-D tap list: gain 4, flipped."""
    kern = make_kernel(list(taps)) * 4.0
    k = kern.shape[0]
    return (np.ascontiguousarray(np.flip(kern, (0, 1))),
            ((k - 1) // 2 + 1, (k - 2) // 2))


@pytest.mark.parametrize("taps", SEP_TAPS, ids=SEP_IDS)
def test_factors_exact_for_make_kernel_taps(taps):
    """make_kernel's taps (gain 4, flipped) are rank 1: their factors give
    them back to within 1 ulp of the largest tap, and the prepared taps
    take the separable path."""
    kflip, pad = _up_kflip(taps)
    col, row = kb.separable_factors(kflip)
    err = np.abs(np.outer(col.astype(np.float64), row) - kflip).max()
    assert err <= np.spacing(np.abs(kflip).max())
    t = kup2.up2_taps(kflip, pad)
    assert t.factors is not None and t.phases is not None
    assert 1 <= t.phases.span <= kup2.SEP_MAX_SPAN


def test_rank2_taps_have_no_factors():
    assert kb.separable_factors(RANK2) is None
    t = kup2.up2_taps(RANK2, (2, 1))
    assert t.factors is None and t.phases is None


@pytest.mark.parametrize("k,pad0", [(4, 2), (3, 2), (2, 1), (1, 0), (4, 1),
                                    (4, 3), (5, 3), (8, 4), (4, -1), (4, 6)])
def test_sep_phases_match_jax_phase_taps(k, pad0):
    """The separable kernel's phase taps: for factors (col, row) of
    k x k taps, outer(col[a], row[b]) placed at (n, m) holds, for each of
    the four output phases, the taps and input offsets the JAX kernel's
    _phase_taps gives (offsets shifted by its halo, which is -d0), to
    1 ulp of the largest tap; nothing lies past the span."""
    rng = np.random.RandomState(k * 10 + pad0 + 5)
    col0 = (rng.rand(k) + 0.5).astype(np.float32)
    row0 = (rng.rand(k) + 0.5).astype(np.float32)
    kflip = np.outer(col0, row0).astype(np.float32)
    kern = np.ascontiguousarray(np.flip(kflip, (0, 1)))
    taps, halo, _ = _phase_taps(kern, pad0)
    ph = kup2.sep_phases(col0, row0, k, pad0)
    assert halo == -ph.d0
    tol = np.spacing(np.float32(np.abs(kflip).max()))
    for a in (0, 1):
        for b in (0, 1):
            got = np.outer(ph.col[a].astype(np.float64), ph.row[b])
            want = np.zeros_like(got)
            for (dy, dx), coef in taps[(a, b)]:
                want[dy, dx] = coef
            np.testing.assert_allclose(got, want, atol=tol, rtol=0)
            assert not got[ph.span:].any() and not got[:, ph.span:].any()


def _emulate_sep(x, a):
    """upsample2x_sep_kernel's loops in numpy, on a (planes, h, w) float32
    array and the SepArgs the wrapper would hand the launcher: blocks of 4
    warps, segments of `lanes` lanes, a ring of STAGES rows a warp (NaN
    until copied, so a read of an uncopied entry shows), its fetches, the
    pairs each lane reads, the window and the stores.  Returns the output
    (NaN where nothing was stored) and how often each output was stored."""
    planes, h, w = a.planes, a.h, a.w
    d0, D, S, M, rows = a.d0, a.span, a.lanes, a.chunks, a.rows
    cw = np.array(a.col, np.float32)[:, :D]
    rw = np.array(a.row, np.float32)[:, :D]
    span_in = 4 * S * M
    rs = span_in + RING_PAD
    bands, spans = -(-h // rows), -(-w // span_in)
    tasks = planes * bands * spans
    nseg = 32 // S
    blocks = -(-(-(-tasks // nseg)) // 4)
    vec_in, vec_out = w % 4 == 0, w % 2 == 0
    wo = 2 * w
    xf = x.reshape(-1)
    yf = np.full(planes * 4 * h * w, np.nan, np.float32)
    count = np.zeros(yf.shape, np.int64)
    c_lo, sh = d0 & ~3, d0 & 3
    nrows = rows + D - 1
    for blk in range(blocks):
        for warp in range(4):
            ring = np.full((STAGES, nseg * rs), np.nan, np.float32)
            for seg in range(nseg):
                task = (blk * 4 + warp) * nseg + seg
                active = task < tasks
                span = task % spans if active else 0
                band = (task // spans) % bands if active else 0
                plane = task // (spans * bands) if active else 0
                y0 = band * rows
                y_end = min(y0 + rows, h)
                cs0 = span * span_in
                c_org = cs0 + c_lo
                xp, yp = plane * h * w, plane * 4 * h * w

                def fetch(r):
                    if not (active and r < nrows):
                        return
                    dst = ring[r % STAGES, seg * rs:(seg + 1) * rs]
                    iy = y0 + d0 + r
                    row_in = 0 <= iy < h
                    src = xp + (iy if row_in else 0) * w
                    for sl in range(S):
                        if vec_in:
                            for t in range(sl, rs // 4, S):
                                ix = c_org + 4 * t
                                ok = row_in and 0 <= ix < w
                                assert not ok or ix + 4 <= w
                                dst[4 * t:4 * t + 4] = (
                                    xf[src + ix:src + ix + 4] if ok else 0)
                        else:
                            for c in range(sl, rs, S):
                                ix = c_org + c
                                ok = row_in and 0 <= ix < w
                                dst[c] = xf[src + ix] if ok else 0

                # each lane's window of D horizontal rows
                win = np.zeros((S, D, 2 * M, 4), np.float32)
                for r in range(STAGES - 1):
                    fetch(r)
                for r in range(nrows):
                    fetch(r + STAGES - 1)
                    src = ring[r % STAGES, seg * rs:(seg + 1) * rs]
                    win[:, :-1] = win[:, 1:].copy()
                    yy = y0 + r - (D - 1)
                    for sl in range(S):
                        for g in range(2 * M):
                            v0 = 2 * (sl + S * g) + sh
                            assert v0 + D + 1 <= rs
                            v = src[v0:v0 + D + 1]
                            for q in range(2):
                                for b in range(2):
                                    win[sl, D - 1, g, 2 * q + b] = np.float32(
                                        (rw[b] * v[q:q + D]).sum())
                        if not (r >= D - 1 and active and yy < y_end):
                            continue
                        for ap in range(2):
                            yrow = yp + (2 * yy + ap) * wo
                            for g in range(2 * M):
                                o = (cw[ap][:, None] * win[sl, :, g]).sum(0)
                                ox = 2 * cs0 + 4 * (sl + S * g)
                                if vec_out:
                                    if ox < wo:
                                        assert ox + 4 <= wo
                                        yf[yrow + ox:yrow + ox + 4] = o
                                        count[yrow + ox:yrow + ox + 4] += 1
                                    continue
                                for q in range(4):
                                    if ox + q < wo:
                                        yf[yrow + ox + q] = o[q]
                                        count[yrow + ox + q] += 1
    shape = (planes, 2 * h, 2 * w)
    return yf.reshape(shape), count.reshape(shape)


# (planes, h, w, taps, pad or None for upsample2d's, band rows or None for
# the plan's): chip_smoke.UP2_EDGES' sizes (w % 4 of 0 and not), narrow
# planes several to a warp with a part-filled last warp, rows of 2 and 3
# chunks and of 2 spans, odd pads, crops, and forced short bands
EMU_CASES = [
    (6, 33, 17, (1, 3, 3, 1), None, None),
    (5, 5, 7, (1, 2, 1), None, None),
    (9, 9, 9, (1, 1), None, None),
    (3, 16, 16, (1, 2, 3, 1), None, None),
    (3, 12, 20, (1, 3, 3, 1), None, 3),
    (2, 6, 130, (1, 3, 3, 1), None, None),
    (1, 4, 400, (1, 2, 3, 1), None, 2),
    (3, 7, 8, (1, 3, 3, 1), (1, 2), 2),
    (3, 7, 13, (1, 3, 3, 1), (3, 0), None),
    (2, 6, 12, (1, 3, 3, 1), (-1, 4), None),
    (2, 6, 11, (1, 2, 3, 1), (6, -3), 4),
    (4, 5, 6, (1,), None, None),
]
EMU_IDS = [f"{p}x{h}x{w}-k{len(t)}-pad{pad}-rows{r}"
           for p, h, w, t, pad, r in EMU_CASES]


@pytest.mark.parametrize("planes,h,w,taps,pad,rows", EMU_CASES, ids=EMU_IDS)
def test_sep_kernel_loops_match_reference(planes, h, w, taps, pad, rows):
    """The separable kernel's loops, transliterated to numpy
    (_emulate_sep) with the arguments the wrapper builds, store every
    output once and agree with upsample2x_reference: 1e-5 abs (fp32, the
    sums in another order)."""
    kflip, upad = _up_kflip(taps)
    pad = upad if pad is None else pad
    t = kup2.up2_taps(kflip, pad)
    plan = kup2.sep_plan(planes, h, w)
    if rows is not None:
        plan = plan._replace(rows=rows)
    args = kup2.sep_args(t, planes, h, w, plan)
    x = np.random.RandomState(planes * h + w).randn(planes, h, w).astype(
        np.float32)
    got, count = _emulate_sep(x, args)
    assert (count == 1).all()
    want = upsample2x_reference(torch.from_numpy(x)[None], kflip, pad)[0]
    np.testing.assert_allclose(got, want.numpy(), atol=ATOL, rtol=0)


def _up2_plan_shapes():
    shapes = [(n * c, h, w) for n, c, h, w in chip_smoke.UP2_SHAPES]
    shapes += [(n * c, h, w) for n, c, h, w, _ in chip_smoke.UP2_EDGES]
    shapes += [(c, h, h) for _, c, h, _ in chip_smoke.UP2_SHAPES]
    return shapes


@pytest.mark.parametrize("planes,h,w", _up2_plan_shapes())
def test_sep_plan_covers_every_input_once(planes, h, w):
    """At K3's shapes, the cut the wrapper plans (sep_plan: bands of at
    most SEP_BAND_ROWS input rows), numbered as upsample2x_sep_kernel numbers
    its tasks and pairs: the tasks cover every input row of every plane
    once, a task's lanes every input column once (2 pairs of 2 columns a
    chunk), and a launch fits its limits."""
    p = kup2.sep_plan(planes, h, w)
    assert p.lanes in (1, 2, 4, 8, 16, 32) and 1 <= p.chunks <= 3
    assert 1 <= p.rows <= kup2.SEP_BAND_ROWS
    nseg = 32 // p.lanes
    blocks = -(-p.warps // 4)
    assert blocks < 2 ** 31
    assert 4 * 4 * STAGES * nseg * (4 * p.lanes * p.chunks + RING_PAD) \
        <= 48 * 1024
    task = np.arange(blocks * 4 * nseg)
    task = task[task < p.tasks]
    assert task.size == p.tasks
    span = task % p.spans
    band = (task // p.spans) % p.bands
    plane = task // (p.spans * p.bands)
    assert plane.max() == planes - 1
    y0 = band * p.rows
    y_end = np.minimum(y0 + p.rows, h)
    rows = np.zeros((planes * p.spans, h + 1), np.int64)
    np.add.at(rows, (plane * p.spans + span, y0), 1)
    np.add.at(rows, (plane * p.spans + span, y_end), -1)
    assert (np.cumsum(rows, axis=1)[:, :h] == 1).all()
    sl, g, q = np.meshgrid(np.arange(p.lanes), np.arange(2 * p.chunks),
                           np.arange(2), indexing="ij")
    cols = (np.arange(p.spans)[:, None] * 4 * p.lanes * p.chunks
            + (2 * (sl + p.lanes * g) + q).ravel()[None, :]).ravel()
    np.testing.assert_array_equal(np.bincount(cols[cols < w],
                                              minlength=w), 1)


def test_taps_are_prepared_once():
    """One Up2Taps per distinct taps and pad (and one per kernel and pad
    for upsample2d); an Up2Taps of the same pad comes back as it is;
    another pad is another object; bad kernels and pads raise."""
    kflip, pad = _up_kflip((1, 3, 3, 1))
    t = kup2.up2_taps(kflip, pad)
    assert kup2.up2_taps(kflip.copy(), pad) is t
    assert kup2.up2_taps(t, pad) is t
    assert kup2.up2_taps(kflip, (1, 2)) is not t
    kern = make_kernel([1, 3, 3, 1])
    u = upsample_taps(kern, pad)
    assert upsample_taps(kern.copy(), pad) is u
    np.testing.assert_array_equal(np.asarray(u), kflip)
    assert not t.kflip.flags.writeable
    with pytest.raises(ValueError, match="square kernel"):
        kup2.up2_taps(np.ones((4, 3), np.float32), pad)
    with pytest.raises(ValueError, match="square kernel"):
        kup2.up2_taps(np.ones((9, 9), np.float32), (5, 3))
    with pytest.raises(ValueError, match="2x output"):
        kup2.up2_taps(kflip, (2, 2))


def test_sep_args_mirror_the_source():
    """SepArgs lays out the fields of ``struct SepArgs`` in
    csrc/upsample2x.cu, in order: eight ints, then the column and row
    phase taps, two rows of SEP_MAX_SPAN each."""
    src = (_build.SOURCE_DIR / "upsample2x.cu").read_text()
    body = re.search(r"struct SepArgs \{(.*?)\};", src, re.S).group(1)
    names = []
    for decl in body.split(";"):
        decl = decl.strip()
        if decl:
            ctype, rest = decl.split(None, 1)
            names += [(ctype, n.strip()) for n in rest.split(",")]
    assert [n.split("[")[0] for _, n in names] == [
        f[0] for f in kup2.SepArgs._fields_]
    assert [t for t, _ in names] == ["int"] * 8 + ["float"] * 2
    assert names[-1][1] == "row[2][kMaxSpan]"
    assert re.search(r"constexpr int kMaxSpan = kMaxTaps / 2 \+ 1;", src)
    assert ctypes.sizeof(kup2.SepArgs) == 4 * (8 + 4 * kup2.SEP_MAX_SPAN)


class _FakeCuda(torch.Tensor):
    """A CPU tensor that claims to be on the card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _stand_in(monkeypatch):
    """A stand-in library that records each launcher call; the counters
    set to 0.  Returns the list of calls."""
    calls = []

    class FakeLib:
        @staticmethod
        def upsample2x_sep_f32(*args):
            calls.append(("sep",) + args)
            return 0

        @staticmethod
        def upsample2x_f32(*args):
            calls.append(("general",) + args)
            return 0
    monkeypatch.setattr(kup2, "library", lambda: FakeLib)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 77, raising=False)
    monkeypatch.setattr(kup2, "launches", 0)
    monkeypatch.setattr(kup2, "general_launches", 0)
    return calls


@pytest.mark.parametrize("kind", ["make_kernel", "rank2"])
def test_launch_path_calls_the_launcher(monkeypatch, kind):
    """upsample2x_cuda on a tensor that claims to be on the card, with a
    stand-in library: rank-1 taps call the separable launcher with the
    planned SepArgs, rank-2 taps the general one with its taps; the record
    is made once per (taps, shape) and reused; ``launches`` counts both,
    ``general_launches`` the general kernel only."""
    calls = _stand_in(monkeypatch)
    if kind == "rank2":
        kflip, pad = RANK2, (2, 1)
    else:
        kflip, pad = _up_kflip((1, 3, 3, 1))
    taps = kup2.up2_taps(kflip, pad)
    taps.records.clear()
    shape = (2, 64, 9, 12)
    x = torch.zeros(shape).as_subclass(_FakeCuda)
    y = upsample2x_cuda(x, kflip, pad)
    y2 = upsample2x_cuda(x, taps, pad)
    x3 = torch.zeros((1, 64, 5, 5)).as_subclass(_FakeCuda)
    upsample2x_cuda(x3, taps, pad)
    assert tuple(y.shape) == tuple(y2.shape) == (2, 64, 18, 24)
    assert len(taps.records) == 2 and len(calls) == 3
    general = int(kind == "rank2")
    assert (kup2.launches, kup2.general_launches) == (3, 3 * general)
    what, xp, yp, *args, stream = calls[0]
    assert (xp, stream) == (x.data_ptr(), 77) and yp == y.data_ptr()
    if kind == "rank2":
        assert what == "general"
        assert args == [128, 9, 12, 2, 4, taps.taps_ptr]
        return
    assert what == "sep"
    sep = taps.records[x.shape][3]
    assert args == [ctypes.addressof(sep)]
    plan = kup2.sep_plan(128, 9, 12)
    assert (sep.planes, sep.h, sep.w, sep.d0, sep.span) == (128, 9, 12, -1, 3)
    assert (sep.lanes, sep.chunks, sep.rows) == tuple(plan[:3])
    np.testing.assert_array_equal(np.array(sep.col, np.float32),
                                  taps.phases.col)
    np.testing.assert_array_equal(np.array(sep.row, np.float32),
                                  taps.phases.row)


def test_upsample2d_takes_the_separable_kernel(monkeypatch):
    """upsample2d on wide maps that claim to be on the card launches the
    separable kernel with its cached taps (general_launches stays 0), and
    leaves the 3-channel map to upfirdn2d."""
    calls = _stand_in(monkeypatch)
    kern = make_kernel([1, 3, 3, 1])
    for n, c, h, w in chip_smoke.UP2_SHAPES:
        x = torch.zeros((1, c, h // 8, w // 8)).as_subclass(_FakeCuda)
        upsample2d(x, kern)
    assert [c[0] for c in calls] == ["sep"] * 3
    assert (kup2.launches, kup2.general_launches) == (3, 0)
    upsample2d(torch.zeros((1, 3, 4, 4)), kern)
    assert kup2.launches == 3


@pytest.mark.parametrize("bad", ["dtype", "layout", "grad"])
def test_wrapper_refuses_what_the_kernels_do_not_take(monkeypatch, bad):
    """On a tensor that claims to be on the card: another dtype, a
    non-contiguous tensor or one that requires a gradient raise before any
    launch; so does a launcher's nonzero return code."""
    calls = _stand_in(monkeypatch)
    kflip, pad = _up_kflip((1, 3, 3, 1))
    x = torch.zeros((1, 64, 6, 6))
    if bad == "dtype":
        x, err = x.double(), ValueError
    elif bad == "layout":
        x, err = x.transpose(2, 3), ValueError
    else:
        x, err = x.requires_grad_(True), RuntimeError
    with pytest.raises(err):
        upsample2x_cuda(x.as_subclass(_FakeCuda), kflip, pad)
    assert not calls and kup2.launches == 0

    class Failing:
        @staticmethod
        def upsample2x_sep_f32(*args):
            return 1
    monkeypatch.setattr(kup2, "library", lambda: Failing)
    taps = kup2.up2_taps(kflip, pad)
    taps.records.clear()
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        upsample2x_cuda(torch.zeros((1, 64, 6, 6)).as_subclass(_FakeCuda),
                        taps, pad)
    taps.records.clear()
    assert kup2.launches == 0

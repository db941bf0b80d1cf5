"""K1's one-pass bf16 kernel (rewriting_torch/csrc/upconv_blur_bf16.cu) on
the CPU: its tile plan, its weight packing and a numpy transliteration of
its index maps.

The kernel runs only on the card, where chip_smoke.py holds it against its
plain version.  Here ``_emulate`` repeats, block by block, what the kernel
does with its indices: the position table and the staged halo, the fp32
chunk and its rounding into position-major bf16 rows, each lane's ldmatrix
row address at the 4 shifts and the fragments ldmatrix hands the wgmma,
the B tiles read through the descriptor's strides from the packed weights,
the phase/tap table, the accumulators' fragment layout, the blur in
channel rounds and the epilogue.  It is held against
``upconv_blur_reference(..., tier="default")`` and against
``upconv_blur_pallas`` in interpret mode fed the same bf16-rounded
operands, at 1e-5 of max |reference| (the products of bf16 values are
exact in fp32; only the order of the sums differs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from rewriting_tpu.ops.pallas_upconv import upconv_blur_pallas
from rewriting_torch.ops import upconv_blur as kup

torch.set_num_threads(1)

RTOL = 1e-5
KF = (0.25, 0.75, 0.75, 0.25)
KF_ASYM = (0.1, 0.5, 0.9, 0.5)
SMEM = 232448

# the kernel's constants (csrc/upconv_blur_bf16.cu)
ROWS, N, KC, CC, XROW = 128, 64, 32, 32, 80
TAP_BYTES, LBO, SBO = 4096, 1024, 128
# (tap, phase 2 py + px, shift index) in the kernel's mma_step order; shift
# index 0..3 is (1,1), (1,0), (0,1), (0,0)
TAPS = ((0, 0, 0), (1, 1, 1), (3, 2, 2), (4, 3, 3), (2, 0, 1), (5, 2, 3),
        (6, 0, 2), (7, 1, 3), (8, 0, 3))


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def _lanes():
    """(warp 0..7, lane 0..31) index grids of a block's 256 threads."""
    return np.meshgrid(np.arange(8), np.arange(32), indexing="ij")


def _a_rows(g, t, lpad):
    """Each lane's ldmatrix row: the staged position at shift (1, 1) and
    the byte offset of its 8 channels, as the kernel computes them."""
    warp, lane = _lanes()
    m = (warp >> 2) * 64 + (warp & 3) * 16 + (lane & 15)
    plane = (t.th + 2) * (t.tw + 2)
    xh, xw, pw = t.th + 3, g["xw"], t.tw + 2
    rem = m % plane
    srow = np.where(m < g["m_valid"],
                    (m // plane) * xh * xw + (rem // pw) * xw + rem % pw
                    + lpad, 0)
    return srow * XROW + 16 * (lane >> 4)


def _ldmatrix_a(xb_bytes, addr):
    """What 4 ldmatrix.x4 hand a warpgroup-wide wgmma as its A (64 x 16 per
    warpgroup, both warpgroups: 128 x 16): lane l of a warp gives the row
    address of row l % 8 of matrix l // 8; thread t receives from matrix j
    the elements (row t // 4, columns 2 (t % 4), +1) as register j; the
    wgmma reads register 0 as (row t // 4, k 2 (t % 4) + {0, 1}), 1 as row
    + 8, 2 as k + 8, 3 as row + 8 and k + 8."""
    vals = xb_bytes.view(np.uint16)
    a = np.zeros((128, 16), np.float32)
    for warp in range(8):
        for t in range(32):
            for j in range(4):
                src = addr[warp, 8 * j + t // 4] // 2 + 2 * (t % 4)
                pair = vals[src:src + 2]
                row = (warp >> 2) * 64 + (warp & 3) * 16 + t // 4 + 8 * (j & 1)
                k = 2 * (t % 4) + 8 * (j >> 1)
                a[row, k:k + 2] = (pair.astype(np.uint32) << 16).view(
                    np.float32)
    return a


def _b_tile(w_bytes, base):
    """B (16 k x 64 n) of a K-major no-swizzle descriptor at byte `base`:
    core matrix (k // 8, n // 8) at LBO, SBO strides, row n % 8 of 16
    bytes, value k % 8."""
    vals = w_bytes.view(np.uint16)
    k, n = np.meshgrid(np.arange(16), np.arange(N), indexing="ij")
    idx = (base + (k // 8) * LBO + (n // 8) * SBO + (n % 8) * 16
           + (k % 8) * 2) // 2
    return (vals[idx].astype(np.uint32) << 16).view(np.float32)


def _emulate(x, wf, kf, demod=None, noise=None, bias=None, tile=None):
    """The kernel's thread and block loops on numpy arrays: x (B, I, H, W),
    wf (O, I, 3, 3) float32; returns (B, O, 2H, 2W)."""
    bsz, in_c, h, w = x.shape
    out_c = wf.shape[0]
    t = tile or kup._plan_bf16(bsz, in_c, h, w, out_c)
    g = kup._geometry_bf16(t)
    assert g["m_valid"] <= ROWS and g["smem"] <= SMEM
    oblocks, tiles, bgroups = kup._grid_bf16(bsz, h, w, out_c, t)
    tiles_x = -(-w // t.tw)
    nchunks = -(-in_c // KC)
    wpk = kup.pack_weights_bf16(torch.from_numpy(wf)).view(
        torch.uint8).numpy().reshape(-1)
    assert wpk.size == oblocks * nchunks * 9 * TAP_BYTES
    taps = kup.flipped_taps(kf)
    ph, pw, xh, xw = t.th + 2, t.tw + 2, t.th + 3, g["xw"]
    assert xw % 4 == 0 and xw >= t.tw + 6
    plane, npos, xplane = ph * pw, g["npos"], xh * xw
    pr, pc, rr, rc = 2 * ph, g["pc"], 2 * t.th + 3, g["rc"]
    assert pc % 4 == 0 and rc % 4 == 0 and pc >= 2 * pw + 3
    ho, wo = 2 * h, 2 * w
    xflat = x.reshape(-1)
    y = np.full((bsz, out_c, ho, wo), np.nan, np.float32)
    shifts = (0, XROW, XROW * xw, XROW * (xw + 1))
    warp, lane = _lanes()
    for ob in range(oblocks):
        for by in range(tiles):
            for bz in range(bgroups):
                u0, w0 = (by // tiles_x) * t.th, (by % tiles_x) * t.tw
                bimg0 = bz * t.nimg
                # the box starts 16-byte aligned, lpad columns early
                lpad = (w0 - 2) & 3
                assert (w0 - 2 - lpad) % 4 == 0 and lpad + t.tw + 3 <= xw
                a_lane = _a_rows(g, t, lpad)
                s = np.arange(npos)
                img, r, c = s // (xh * xw), (s // xw) % xh, s % xw
                iy, ix = u0 - 2 + r, w0 - 2 - lpad + c
                inside = ((bimg0 + img < bsz) & (iy >= 0) & (iy < h)
                          & (ix >= 0) & (ix < w))
                pos = np.where(inside, img * in_c * h * w + iy * w + ix, -1)
                base = bimg0 * in_c * h * w
                acc = np.zeros((4, ROWS, N), np.float32)
                for ch in range(nchunks):
                    # the TMA box (or cp.async): fp32 [image][channel]
                    # [row][column], zeros outside the maps and past in_c
                    xf = np.zeros(KC * npos, np.float32)
                    for k in range(KC):
                        if ch * KC + k < in_c:
                            ok = pos >= 0
                            dst = s + ((s // xplane) * (KC - 1) + k) * xplane
                            xf[dst[ok]] = xflat[base + (ch * KC + k) * h * w
                                                + pos[ok]]
                    # the rounding pass: a thread rounds channels 8 grp ..
                    # + 7 of one position into its 80-byte row
                    xb = np.zeros((npos, XROW // 2), np.float32)
                    for grp in range(4):
                        src = s + ((s // xplane) * (KC - 1) + 8 * grp) * xplane
                        for j in range(8):
                            xb[:, 8 * grp + j] = _bf16(xf[src + j * xplane])
                    xb_bytes = (xb.view(np.uint32) >> 16).astype(
                        np.uint16).view(np.uint8).reshape(-1)
                    w_bytes = wpk[(ob * nchunks + ch) * 9 * TAP_BYTES:
                                  (ob * nchunks + ch + 1) * 9 * TAP_BYTES]
                    for ks in range(2):
                        a = [_ldmatrix_a(xb_bytes, a_lane + so + 32 * ks)
                             for so in shifts]
                        for tap, p, sh in TAPS:
                            bt = _b_tile(w_bytes, tap * TAP_BYTES
                                         + ks * 2 * LBO)
                            acc[p] += a[sh].astype(np.float64) @ bt
                # every accumulator into the phase planes, as each thread
                # holds them
                pst = g["pst"]
                assert pst >= pr * pc and pst % 4 == 0 and (2 * pst) % 32
                ps = np.full(N * t.nimg * pst, np.nan, np.float32)
                for hf in range(2):
                    m = ((warp >> 2) * 64 + (warp & 3) * 16 + (lane >> 2)
                         + 8 * hf)
                    ok = m < g["m_valid"]
                    im, lv, lw = m // plane, (m % plane) // pw, m % pw
                    dst = im * pst + 2 * lv * pc + 2 * lw + 3
                    for nb in range(N // 8):
                        for e in range(2):
                            ch = nb * 8 + 2 * (lane & 3) + e
                            i = nb * 4 + 2 * hf + e
                            n = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1)
                            assert (n == ch).all()
                            d = dst + ch * t.nimg * pst
                            for p in range(4):
                                ps[(d + (p >> 1) * pc + (p & 1))[ok]] = \
                                    acc[p][m[ok], n[ok]]
                ps = ps.reshape(N * t.nimg, pst)[:, :pr * pc].reshape(
                    N * t.nimg, pr, pc)
                # the blur in rounds of CC channels
                for rnd in range(N // CC):
                    planes = CC * t.nimg
                    psr = ps[rnd * planes:(rnd + 1) * planes]
                    # groups of 4 outputs: column c reads stored columns
                    # c + 4 .. c + 7, two aligned float4 at 4 grp + 4
                    rs = np.zeros((planes, rr, rc), np.float32)
                    for grp in range(g["cg"]):
                        for k in range(4):
                            cc = 4 * grp + k
                            assert cc + 7 < 4 * grp + 12 <= pc
                            rs[:, :, cc] = sum(
                                np.float32(taps[j]) * psr[:, 1:rr + 1,
                                                          cc + 4 + j]
                                for j in range(4))
                    rows = min(2 * t.th, ho - 2 * u0)
                    for ci in range(planes):
                        o = ob * N + rnd * CC + ci // t.nimg
                        b = bimg0 + ci % t.nimg
                        if o >= out_c or b >= bsz:
                            continue
                        cols = min(2 * t.tw, wo - 2 * w0)
                        v = sum(np.float32(taps[k])
                                * rs[ci, k:k + rows, :cols] for k in range(4))
                        if demod is not None:
                            nz = noise[b if noise.shape[0] > 1 else 0, 0,
                                       2 * u0:2 * u0 + rows,
                                       2 * w0:2 * w0 + cols]
                            v = v * demod[b, o] + nz + bias[o]
                            v = np.float32(np.sqrt(2.0)) * np.where(
                                v >= 0, v, np.float32(0.2) * v)
                        y[b, o, 2 * u0:2 * u0 + rows,
                          2 * w0:2 * w0 + cols] = v
    return y


def _case(b, in_c, h, w, out_c, seed, epilogue=False, noise_b=1):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, in_c, h, w).astype(np.float32)
    wf = (rng.randn(out_c, in_c, 3, 3) / (3.0 * in_c ** 0.5)).astype(
        np.float32)
    extra = ()
    if epilogue:
        extra = ((rng.rand(b, out_c) + 0.5).astype(np.float32),
                 rng.randn(noise_b, 1, 2 * h, 2 * w).astype(np.float32),
                 rng.randn(out_c).astype(np.float32))
    return x, wf, extra


def _reference(x, wf, kf, extra):
    return kup.upconv_blur_reference(
        torch.from_numpy(x), torch.from_numpy(wf), kf,
        *(torch.from_numpy(e) for e in extra), tier="default").numpy()


def _close(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= RTOL, rel


# (b, in_c, h, w, out_c, epilogue, noise batch, tile or None for the plan):
# ragged channels (72 -> 40: a zero-padded last chunk and output block),
# ragged maps, whole-image tiles with several images a block, a tile that
# cuts both axes, per-batch noise, asymmetric taps
EMULATE_CASES = [
    (2, 40, 9, 30, 24, False, 1, None),
    (3, 72, 9, 30, 40, True, 3, None),
    (1, 16, 10, 5, 8, True, 1, None),
    (3, 8, 2, 3, 72, False, 1, kup.TileBf16(3, 2, 3)),
    (2, 40, 11, 13, 16, True, 1, kup.TileBf16(1, 4, 6)),
]


@pytest.mark.parametrize("case", EMULATE_CASES,
                         ids=["x".join(map(str, c[:5])) + ("-epi" if c[5]
                                                           else "")
                              for c in EMULATE_CASES])
def test_emulated_kernel_matches_plain_version(case):
    """The transliterated kernel against the plain bf16 version."""
    b, in_c, h, w, out_c, epilogue, noise_b, tile = case
    x, wf, extra = _case(b, in_c, h, w, out_c, seed=in_c + h,
                         epilogue=epilogue, noise_b=noise_b)
    kf = KF_ASYM if epilogue else KF
    _close(_emulate(x, wf, kf, *extra, tile=tile),
           _reference(x, wf, kf, extra))


@pytest.mark.parametrize("epilogue", [False, True], ids=["plain", "epi"])
def test_emulated_kernel_matches_pallas(epilogue):
    """The transliterated kernel against the JAX package's kernel in
    interpret mode, fed the same bf16-rounded x and taps at HIGHEST."""
    b, in_c, h, w, out_c = 2, 24, 8, 12, 16
    x, wf, extra = _case(b, in_c, h, w, out_c, seed=3, epilogue=epilogue)
    jextra = {}
    if epilogue:
        demod, noise, bias = extra
        jextra = dict(demod=jnp.asarray(demod),
                      noise=jnp.asarray(noise.transpose(0, 2, 3, 1)),
                      bias=jnp.asarray(bias))
    xr = _bf16(x).transpose(0, 2, 3, 1)              # NHWC
    wr = _bf16(wf).transpose(2, 3, 1, 0)             # HWIO taps
    want = np.asarray(upconv_blur_pallas(
        jnp.asarray(np.ascontiguousarray(xr)),
        jnp.asarray(np.ascontiguousarray(wr)), kf=KF, interpret=True,
        **jextra)).transpose(0, 3, 1, 2)
    _close(_emulate(x, wf, KF, *extra), want)


def test_packed_weights_layout():
    """pack_weights_bf16: the bf16 rounding of .to(torch.bfloat16), zeros
    past O and I, and value (o, i, dy, dx) where the B descriptor of its
    chunk, tap and k step reads it."""
    rng = np.random.RandomState(5)
    wf = rng.randn(70, 40, 3, 3).astype(np.float32)
    packed = kup.pack_weights_bf16(torch.from_numpy(wf))
    assert packed.dtype == torch.bfloat16
    assert tuple(packed.shape) == (2, 2, 9, 4, 8, 8, 8)
    raw = packed.view(torch.uint8).numpy().reshape(-1)
    rounded = _bf16(wf)
    chunk = 9 * TAP_BYTES
    for ob in range(2):
        for c in range(2):
            w_bytes = raw[(ob * 2 + c) * chunk:(ob * 2 + c + 1) * chunk]
            for tap in range(9):
                for ks in range(2):
                    bt = _b_tile(w_bytes, tap * TAP_BYTES + ks * 2 * LBO)
                    want = np.zeros((16, N), np.float32)
                    o = slice(ob * N, min(70, ob * N + N))
                    i0 = c * KC + 16 * ks
                    i1 = min(40, i0 + 16)
                    if i1 > i0:
                        want[:i1 - i0, :o.stop - o.start] = \
                            rounded[o, i0:i1, tap // 3, tap % 3].T
                    np.testing.assert_array_equal(bt, want)


def _covered_once(n, starts, size):
    count = np.zeros(n, np.int64)
    for s in starts:
        count[s:s + size] += 1
    return bool((count == 1).all())


TIMED = [(16, 256, 128, 128, 128), (8, 128, 256, 256, 64)]
PLAN_SHAPES = (
    [(b, i, h, h, o) for b in (1, 16) for i, h, o in chip_smoke.UPCONV_SHAPES]
    + [(8, 512, h, h, 512) for h in (4, 8, 16, 32, 64)]
    + [(8, 512, 64, 64, 256), (8, 256, 128, 128, 128)] + TIMED
    + [(16, 512, 8, 8, 512), (3, 72, 9, 30, 40), (1, 64, 100, 5, 24),
       (16, 8, 1, 1, 8), (5, 8, 2, 2, 8), (2, 64, 12, 20, 64)])


@pytest.mark.parametrize("shape", PLAN_SHAPES,
                         ids=["x".join(map(str, s)) for s in PLAN_SHAPES])
def test_plan_bf16_covers_every_output_once(shape):
    """The one-pass tile of church-256's and faces-1024's up-conv layers
    and of ragged shapes: output-channel blocks, image groups and output
    rows and columns each cover the output exactly once; a block's 128
    positions hold its tile and halo; the shared memory fits 227 KB; the
    accumulators are the 128 registers a thread the source's note states;
    the two timed shapes give a grid of at least 132 blocks."""
    b, in_c, h, w, out_c = shape
    t = kup._plan_bf16(b, in_c, h, w, out_c)
    g = kup._geometry_bf16(t)
    assert t.nimg == 1 or (t.th, t.tw) == (h, w)
    assert g["m_valid"] <= ROWS and g["smem"] <= SMEM
    assert g["acc_regs"] == 128 and g["threads"] == 256
    oblocks, tiles, bgroups = kup._grid_bf16(b, h, w, out_c, t)
    tiles_x = -(-w // t.tw)
    assert _covered_once(out_c, range(0, oblocks * N, N), N)
    assert _covered_once(b, range(0, bgroups * t.nimg, t.nimg), t.nimg)
    count = np.zeros((2 * h, 2 * w), np.int64)
    for by in range(tiles):
        u0, w0 = (by // tiles_x) * t.th, (by % tiles_x) * t.tw
        count[2 * u0:2 * u0 + 2 * t.th, 2 * w0:2 * w0 + 2 * t.tw] += 1
    assert (count == 1).all()
    if shape in TIMED:
        assert oblocks * tiles * bgroups >= 132


def test_plan_bf16_takes_the_fewest_blocks():
    """Over every tile the kernel takes (128 positions, 227 KB of shared
    memory), the plan's needs the fewest tiles (each block computes 128
    positions whatever its tile)."""
    for h, w in ((128, 128), (256, 256), (9, 30), (100, 5), (16, 16)):
        t = kup._plan_bf16(1, 64, h, w, 64)
        best = min(-(-h // th) * -(-w // tw)
                   for th in range(1, h + 1) for tw in range(1, w + 1)
                   if (th + 2) * (tw + 2) <= ROWS
                   and kup._geometry_bf16(kup.TileBf16(1, th, tw))["smem"]
                   <= SMEM)
        assert -(-h // t.th) * -(-w // t.tw) == best


def test_cuda_wrapper_refuses_cpu_and_grad():
    """The wrapper launches on a CUDA tensor or raises: on a CPU tensor it
    raises, and the dispatcher takes the plain version there."""
    x, wf, _ = _case(1, 16, 4, 4, 8, seed=0)
    xt, wt = torch.from_numpy(x), torch.from_numpy(wf)
    with pytest.raises(ValueError):
        kup.upconv_blur_cuda(xt, wt, KF, tier="default")
    got = kup.upconv_blur(xt, wt, KF, tier="default")
    assert torch.equal(got, kup.upconv_blur_reference(xt, wt, KF,
                                                      tier="default"))

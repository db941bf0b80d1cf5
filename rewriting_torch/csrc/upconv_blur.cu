// Fused StyleGAN2 up-conv + FIR blur (+ epilogue) on NCHW float32:
//
//   y = blur4x4(conv_transpose_3x3_stride2(x, w)) * 4
//   optionally y = sqrt(2) * leaky_relu(y * demod[b,o] + noise + bias[o], 0.2)
//
// Replaces the JAX package's TPU kernel ops/pallas_upconv.py::
// upconv_blur_pallas (pallas_call at :232, body _upconv_blur_body :81-156).
// It runs in the sampling pipeline (pipeline_fast) at the upsampling layers
// of StyleGAN2 that the gate admits: at church-256, (B,512,4,4) ..
// (B,256,128,128) in, 2H x 2W out.
//
// What it computes, as the TPU kernel does:
//  1. The stride-2 transposed conv splits by output parity into four
//     (row-phase, col-phase) pre-blur signals over the UNdilated grid.  With
//     the correlation taps wf (the dconv weight flipped and scaled), tap d
//     of an axis feeds phase p from input shift s: d=0 -> (0, x[v-1]),
//     d=1 -> (1, x[v]), d=2 -> (0, x[v]) (pallas_upconv.py:52-55).  So each
//     of the 9 taps is a GEMM: A = the input at the tap's shift (positions
//     x input channels), B = wf[:, :, dy, dx] (input x output channels),
//     accumulated into the tap's phase.  9 MACs per (input pixel, I, O).
//  2. The 4x4 blur (pad 1) over the interleaved phase signals, with the
//     flipped taps, as two 4-tap passes (rows, then columns): its taps are
//     always an outer product.
//  3. The epilogue, then one coalesced write of each output.
//
// What bounds it on an H100: operations.  At (16,256,128,128) -> 128 the
// conv is 77.3 G useful MACs.  The products run on the tensor cores as
// 3xTF32 (below): 3 * 2 * MACs = 464 GFLOP at the TF32 peak of 495 TFLOP/s
// is 0.94 ms, plus the blur and epilogue (21 fp32 operations an output,
// 0.04 ms at 67 TFLOP/s): 0.98 ms.  Bytes: 0.82 GB, 0.24 ms at 3.35 TB/s.
//
// The design:
//  - Implicit GEMM on mma.sync.m16n8k8 TF32 with fp32 accumulators (inline
//    PTX, no CUTLASS).  3xTF32: each operand is split once, when its
//    fragment is read from shared memory, into hi = tf32(a) and lo =
//    tf32(a - hi) (round to nearest, as cvt.rna.tf32.f32); each product
//    is lo*hi + hi*lo + hi*hi, issued in that order.  The error is that of
//    fp32 (plain TF32 is 1e3 times worse and is not used).
//  - A warp holds 32 positions x 16 output channels x 4 phases: 64 fp32
//    accumulators.  Per 8 input channels it reads the input at the 4
//    distinct shifts (16 values) and the 9 taps' weights (36 values) and
//    issues 9 x 2 x 2 x 3 = 108 mma.  Each tap's three products are summed
//    afresh and added to the accumulator in fp32 (see tap()).
//  - A block: warps_m x warps_n warps over a tile of nimg whole images or
//    of one image's th x tw input positions, plus the one-position phase
//    halo the blur needs, recomputed (blocks share nothing); its position
//    axis is the tile's (image, row, column) flattened, so at 4x4 and 8x8
//    a tile holds several whole images and no warp works on padding
//    beyond the last 32-row group.  The tile and the channel chunk kc are
//    chosen per layer shape in ops/upconv_blur.py::_plan.
//  - The x chunk (kc channels with a 1-pixel zero halo) and the weight
//    slice go through a 3-stage cp.async ring in dynamic shared memory:
//    the next chunks load while the current one multiplies.  Every input
//    channel is summed in one block, in order: no atomics, so the result
//    is the same on every run.
//  - After the loop the accumulators of all the block's channels go to
//    shared memory interleaved; the blur's row pass slides its 4 taps
//    along half rows, the column pass down output columns (one shared
//    read an output each), then the epilogue and coalesced writes.
//  - grid = (O / (16 warps_n), tiles, B / nimg); batches beyond the grid's
//    z limit are launched in slices.
//
// This is the "highest" and "high" tiers' kernel.  The one-pass bf16 mode
// of the "default" and "int8" tiers (the TPU kernel's DEFAULT precision) is
// csrc/upconv_blur_bf16.cu.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMT = 2;                  // m16 tiles of a warp
constexpr int kNT = 2;                  // n8 tiles of a warp
constexpr int kWarpM = 16 * kMT;        // positions of a warp
constexpr int kWarpN = 8 * kNT;         // output channels of a warp
constexpr int kStages = 3;              // cp.async ring depth
constexpr int kMaxThreads = 384;        // 168 registers a thread
constexpr int kMaxGrid = 65535;
constexpr int kMaxSmem = 232448;        // bytes a block may have on sm_90

// A block's tile, chosen per layer shape by ops/upconv_blur.py::_plan
struct Tile {
  int nimg, th, tw, warps_m, warps_n, kc;
};

// Sizes derived from a tile (ops/upconv_blur.py::_geometry is the same),
// computed on the host and passed as a kernel parameter
struct Geo {
  int ph, pw;      // phase positions of a tile side, halo included
  int plane;       // ph * pw
  int xh, xw;      // staged input rows / columns of an image
  int m_valid;     // positions of a block: nimg * ph * pw
  int nblk;        // output channels of a block
  int xk, wk;      // floats per staged input channel of x and of the weights
  int pr, pc;      // interleaved phase rows and row stride
  int rr, rc;      // row-pass rows and row stride
  int ring, epi;   // floats of the ring and of the epilogue's buffers
};

// n rounded up to 8 mod 32: fragment reads of 4 channels x 8 positions
// then fall in 32 distinct banks
inline int pad_banks(int n) {
  return n + ((8 - n % 32) % 32 + 32) % 32;
}

inline Geo geometry(const Tile& t) {
  Geo g;
  g.ph = t.th + 2;
  g.pw = t.tw + 2;
  g.plane = g.ph * g.pw;
  g.xh = t.th + 3;
  g.xw = t.tw + 3;
  g.m_valid = t.nimg * g.ph * g.pw;
  g.nblk = t.warps_n * kWarpN;
  g.xk = pad_banks(t.nimg * g.xh * g.xw);
  g.wk = pad_banks(9 * g.nblk);
  g.pr = 2 * g.ph;
  g.pc = 2 * g.pw + 1;
  g.rr = 2 * t.th + 3;
  g.rc = 2 * t.tw + 1;
  g.ring = kStages * t.kc * (g.xk + g.wk);
  g.epi = g.nblk * t.nimg * (g.pr * g.pc + g.rr * g.rc);
  return g;
}

struct Taps {
  float v[4];  // the flipped 1-D blur taps with the gain
};

// v rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: the rounding of cvt.rna.tf32.f32, in two integer operations, which
// time faster than the cvt (scripts/compare_upconv.py --ablations)
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// N bytes global -> shared; zeros where !valid
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(d),
               "l"(src), "n"(N), "r"(valid ? N : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

// Stage input channels [i0, i0 + kc): x of the block's images and tile
// with its halo (zeros outside the images), and the weights packed (I, 9,
// O) for the block's output channels.  The block's origin is read again
// from blockIdx, which holds no register through the main loop.
__device__ __forceinline__ void load_chunk(
    float* xs, float* ws, const float* x, const float* wp, int i0,
    const Tile& t, const Geo& g, int batch, int in_c, int out_c, int h,
    int w, int tiles_x) {
  const int ob0 = blockIdx.x * g.nblk;
  const int u0 = (blockIdx.y / tiles_x) * t.th;
  const int w0 = (blockIdx.y % tiles_x) * t.tw;
  const int bimg0 = blockIdx.z * t.nimg;
  const size_t hw = static_cast<size_t>(h) * w;
  const int plane = t.nimg * g.xh * g.xw;
  for (int p = threadIdx.x; p < plane; p += blockDim.x) {
    const int img = p / (g.xh * g.xw);
    const int r = (p / g.xw) % g.xh;
    const int c = p % g.xw;
    const int b = bimg0 + img;
    const int iy = u0 - 2 + r;
    const int ix = w0 - 2 + c;
    const bool inside = b < batch && iy >= 0 && iy < h && ix >= 0 && ix < w;
    const float* src =
        inside ? x + (static_cast<size_t>(b) * in_c + i0) * hw +
                     static_cast<size_t>(iy) * w + ix
               : x;
    for (int k = 0; k < t.kc; ++k) {
      const bool v = inside && i0 + k < in_c;
      cp_async<4>(xs + k * g.xk + p, v ? src + k * hw : x, v);
    }
  }
  for (int e = threadIdx.x; e < 9 * g.nblk; e += blockDim.x) {
    const int tap = e / g.nblk;
    const int n = e % g.nblk;
    const int o = ob0 + n;
    const float* src = wp + (static_cast<size_t>(i0) * 9 + tap) * out_c + o;
    for (int k = 0; k < t.kc; ++k) {
      const bool v = o < out_c && i0 + k < in_c;
      cp_async<4>(ws + k * g.wk + e,
                  v ? src + static_cast<size_t>(k) * 9 * out_c : wp, v);
    }
  }
}

// The A fragments of input shift (SY, SX) for the warp's kMT tiles, split
template <int SY, int SX>
__device__ __forceinline__ void load_a(uint32_t (&ah)[kMT][4],
                                       uint32_t (&al)[kMT][4],
                                       const float* xa, int xk, int xw,
                                       const int (&base)[kMT][2]) {
  const int so = (1 - SY) * xw + (1 - SX);
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    split(xa[base[mt][0] + so], ah[mt][0], al[mt][0]);
    split(xa[base[mt][1] + so], ah[mt][1], al[mt][1]);
    split(xa[4 * xk + base[mt][0] + so], ah[mt][2], al[mt][2]);
    split(xa[4 * xk + base[mt][1] + so], ah[mt][3], al[mt][3]);
  }
}

// One tap into phase P: its B fragments, split, and the 3xTF32 products.
// Chaining every mma into the accumulator gives about ten times fp32's
// error (the tensor cores do not round their sums as fp32 adds do;
// scripts/compare_upconv.py --ablations measures it).  So the products of
// a tap, or of the four taps of phase 0 in one step of 8 input channels
// (into d0), are summed afresh and added to the accumulator in fp32.
template <int P, bool kIntoD0>
__device__ __forceinline__ void tap(float (&acc)[kMT][kNT][4][4],
                                    float (&d0)[kMT][kNT][4],
                                    const uint32_t (&ah)[kMT][4],
                                    const uint32_t (&al)[kMT][4],
                                    const float* wb, int wk) {
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    uint32_t bh0, bl0, bh1, bl1;
    split(wb[nt * 8], bh0, bl0);
    split(wb[4 * wk + nt * 8], bh1, bl1);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      if (kIntoD0) {
        mma(d0[mt][nt], al[mt], bh0, bh1);
        mma(d0[mt][nt], ah[mt], bl0, bl1);
        mma(d0[mt][nt], ah[mt], bh0, bh1);
      } else {
        float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma(d, al[mt], bh0, bh1);
        mma(d, ah[mt], bl0, bl1);
        mma(d, ah[mt], bh0, bh1);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][nt][P][q] += d[q];
      }
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads)
upconv_blur_kernel(const float* __restrict__ x, const float* __restrict__ wp,
                   float* __restrict__ y, int batch, int in_c, int out_c,
                   int h, int w, int tiles_x, Tile t, Geo g, Taps taps,
                   const float* __restrict__ demod,
                   const float* __restrict__ noise, long long noise_bstride,
                   const float* __restrict__ bias) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp % t.warps_m;
  const int wn = warp / t.warps_m;
  const int gq = lane >> 2;   // fragment row group
  const int tq = lane & 3;    // fragment column in the group
  const int plane = g.plane;

  // staged-x offset of each fragment row of this thread: position m is
  // (image, phase row lv, phase column lw); phase position lv is input
  // row u0 - 1 + lv, and shift s reads staged row lv + 1 - s
  int base[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = wm * kWarpM + mt * 16 + hf * 8 + gq;
      const int rem = m % plane;
      base[mt][hf] = m < g.m_valid ? (m / plane) * g.xh * g.xw +
                                         (rem / g.pw) * g.xw + rem % g.pw
                                   : 0;
    }

  float acc[kMT][kNT][4][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][nt][p][q] = 0.0f;

  const int stage_floats = t.kc * (g.xk + g.wk);
  const int nchunks = (in_c + t.kc - 1) / t.kc;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nchunks) {
      float* st = smem + s * stage_floats;
      load_chunk(st, st + t.kc * g.xk, x, wp, s * t.kc, t, g, batch, in_c,
                 out_c, h, w, tiles_x);
    }
    cp_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    cp_wait<kStages - 2>();
    __syncthreads();   // chunk c has landed; chunk c - 1 is consumed
    const int nxt = c + kStages - 1;
    if (nxt < nchunks) {
      float* st = smem + (nxt % kStages) * stage_floats;
      load_chunk(st, st + t.kc * g.xk, x, wp, nxt * t.kc, t, g, batch, in_c,
                 out_c, h, w, tiles_x);
    }
    cp_commit();
    const float* xs = smem + (c % kStages) * stage_floats;
    const float* ws = xs + t.kc * g.xk;
    for (int kk = 0; kk < t.kc; kk += 8) {
      const float* xa = xs + (kk + tq) * g.xk;
      const float* wb = ws + (kk + tq) * g.wk + wn * kWarpN + gq;
      uint32_t ah[kMT][4], al[kMT][4];
      float d0[kMT][kNT][4] = {};
      // tap (dy, dx) is weight slice 3 * dy + dx; its phase and shift per
      // axis: d=0 -> (0, 1), d=1 -> (1, 0), d=2 -> (0, 0)
      load_a<1, 1>(ah, al, xa, g.xk, g.xw, base);
      tap<0, true>(acc, d0, ah, al, wb + 0 * g.nblk, g.wk);  // (0, 0)
      load_a<1, 0>(ah, al, xa, g.xk, g.xw, base);
      tap<1, false>(acc, d0, ah, al, wb + 1 * g.nblk, g.wk);  // (0, 1)
      tap<0, true>(acc, d0, ah, al, wb + 2 * g.nblk, g.wk);  // (0, 2)
      load_a<0, 1>(ah, al, xa, g.xk, g.xw, base);
      tap<2, false>(acc, d0, ah, al, wb + 3 * g.nblk, g.wk);  // (1, 0)
      tap<0, true>(acc, d0, ah, al, wb + 6 * g.nblk, g.wk);  // (2, 0)
      load_a<0, 0>(ah, al, xa, g.xk, g.xw, base);
      tap<3, false>(acc, d0, ah, al, wb + 4 * g.nblk, g.wk);  // (1, 1)
      tap<2, false>(acc, d0, ah, al, wb + 5 * g.nblk, g.wk);  // (1, 2)
      tap<1, false>(acc, d0, ah, al, wb + 7 * g.nblk, g.wk);  // (2, 1)
      tap<0, true>(acc, d0, ah, al, wb + 8 * g.nblk, g.wk);  // (2, 2)
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mt][nt][0][q] += d0[mt][nt][q];
    }
  }
  cp_wait<0>();
  __syncthreads();   // the ring is free: it becomes the blur's buffers

  const int ob0 = blockIdx.x * g.nblk;
  const int u0 = (blockIdx.y / tiles_x) * t.th;
  const int w0 = (blockIdx.y % tiles_x) * t.tw;
  const int bimg0 = blockIdx.z * t.nimg;
  // every channel's phase signals, interleaved: plane ci = ch * nimg + img,
  // local row 2 * lv + py is pre-blur row 2 * (u0 - 1) + 2 * lv + py
  const int planes = g.nblk * t.nimg;
  float* ps = smem;                          // [planes][pr][pc]
  float* rs = smem + planes * g.pr * g.pc;   // [planes][rr][rc]
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = wm * kWarpM + mt * 16 + hf * 8 + gq;
      if (m >= g.m_valid) continue;
      const int img = m / plane;
      const int lv = (m % plane) / g.pw;
      const int lw = m % g.pw;
      float* dst = ps + (2 * lv) * g.pc + 2 * lw;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int ci = (wn * kWarpN + nt * 8 + 2 * tq + cc) * t.nimg + img;
#pragma unroll
          for (int p = 0; p < 4; ++p)
            dst[(ci * g.pr + (p >> 1)) * g.pc + (p & 1)] =
                acc[mt][nt][p][2 * hf + cc];
        }
    }
  __syncthreads();
  // rows: output column c reads local columns c + 1 .. c + 4.  A thread
  // takes half a row and slides the 4 taps along it
  for (int it = threadIdx.x; it < 2 * planes * g.rr; it += blockDim.x) {
    const int q = it >> 1;
    const int c0 = (it & 1) * t.tw;
    const int ci = q / g.rr;
    const int lr = q - ci * g.rr;
    const float* src = ps + (ci * g.pr + lr + 1) * g.pc + c0 + 1;
    float* dst = rs + (ci * g.rr + lr) * g.rc + c0;
    float s0 = src[0], s1 = src[1], s2 = src[2];
    for (int c = 0; c < t.tw; ++c) {
      const float s3 = src[c + 3];
      dst[c] = fmaf(taps.v[3], s3,
                    fmaf(taps.v[2], s2, fmaf(taps.v[1], s1, taps.v[0] * s0)));
      s0 = s1;
      s1 = s2;
      s2 = s3;
    }
  }
  __syncthreads();
  // columns: output row r reads row-pass rows r .. r + 3.  A thread takes
  // one output column of a plane and slides down it; then the epilogue
  // and one write, neighbouring threads on neighbouring columns
  const int ho = 2 * h;
  const int wo = 2 * w;
  const int otw = 2 * t.tw;
  const int rows = min(2 * t.th, ho - 2 * u0);
  for (int it = threadIdx.x; it < planes * otw; it += blockDim.x) {
    const int ci = it / otw;
    const int cc = it - ci * otw;
    const int o = ob0 + ci / t.nimg;
    const size_t b = bimg0 + ci % t.nimg;
    const int ox = 2 * w0 + cc;
    if (o >= out_c || b >= static_cast<size_t>(batch) || ox >= wo) continue;
    const float* src = rs + ci * g.rr * g.rc + cc;
    float* dst = y + ((b * out_c + o) * ho + 2 * u0) * static_cast<size_t>(wo)
                 + ox;
    const float* nz = nullptr;
    float dm = 0.0f, bi = 0.0f;
    if (demod != nullptr) {
      dm = demod[b * out_c + o];
      bi = bias[o];
      nz = noise + b * noise_bstride + static_cast<size_t>(2 * u0) * wo + ox;
    }
    float s0 = src[0], s1 = src[g.rc], s2 = src[2 * g.rc];
    for (int r = 0; r < rows; ++r) {
      const float s3 = src[(r + 3) * g.rc];
      float v = fmaf(taps.v[3], s3,
                     fmaf(taps.v[2], s2, fmaf(taps.v[1], s1, taps.v[0] * s0)));
      s0 = s1;
      s1 = s2;
      s2 = s3;
      if (nz != nullptr) {
        v = fmaf(v, dm, nz[static_cast<size_t>(r) * wo]) + bi;
        v = 1.41421356237309515f * (v >= 0.0f ? v : 0.2f * v);
      }
      dst[static_cast<size_t>(r) * wo] = v;
    }
  }
}

}  // namespace

// Launches the fused up-conv + blur of x (batch, in_c, h, w) into y
// (batch, out_c, 2h, 2w).  wp holds the correlation taps packed (in_c, 9,
// out_c); taps4 (host memory) the flipped 1-D blur taps with the gain.
// With demod != nullptr the epilogue runs: demod (batch, out_c), noise
// (batch or 1, 2h, 2w) with the given batch stride (0 broadcasts one map),
// bias (out_c).  The tile (nimg, th, tw, warps_m, warps_n, kc) comes from
// ops/upconv_blur.py::_plan.  Returns a CUDA error code: that of
// cudaFuncSetAttribute where it fails, else cudaGetLastError() after the
// launches; does not synchronise.
extern "C" int upconv_blur_f32(const float* x, const float* wp, float* y,
                               int batch, int in_c, int out_c, int h, int w,
                               const float* taps4, const float* demod,
                               const float* noise, long long noise_bstride,
                               const float* bias, int nimg, int th, int tw,
                               int warps_m, int warps_n, int kc,
                               cudaStream_t stream) {
  const Tile t{nimg, th, tw, warps_m, warps_n, kc};
  if (batch < 1 || in_c < 1 || out_c < 1 || h < 1 || w < 1 || nimg < 1 ||
      th < 1 || tw < 1 || warps_m < 1 || warps_n < 1 || kc < 8 || kc % 8 ||
      (nimg > 1 && (th != h || tw != w))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geo g = geometry(t);
  const int threads = warps_m * warps_n * 32;
  const size_t smem = 4 * static_cast<size_t>(g.ring > g.epi ? g.ring
                                                              : g.epi);
  if (threads > kMaxThreads || warps_m * kWarpM < g.m_valid ||
      smem > static_cast<size_t>(kMaxSmem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool smem_raised = false;
  if (smem > 48 * 1024 && !smem_raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        upconv_blur_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_raised = true;
  }
  const int tiles_y = (h + th - 1) / th;
  const int tiles_x = (w + tw - 1) / tw;
  const long long tiles = static_cast<long long>(tiles_y) * tiles_x;
  const int oblocks = (out_c + g.nblk - 1) / g.nblk;
  if (tiles > kMaxGrid) return static_cast<int>(cudaErrorInvalidValue);
  Taps taps;
  for (int i = 0; i < 4; ++i) taps.v[i] = taps4[i];
  const size_t in_plane = static_cast<size_t>(in_c) * h * w;
  const size_t out_plane = static_cast<size_t>(out_c) * 4 * h * w;
  const long long per_launch = static_cast<long long>(kMaxGrid) * nimg;
  for (long long b0 = 0; b0 < batch; b0 += per_launch) {
    const int nb = static_cast<int>(batch - b0 < per_launch ? batch - b0
                                                             : per_launch);
    const float* dm = demod ? demod + b0 * out_c : nullptr;
    const float* nz = demod ? noise + b0 * noise_bstride : nullptr;
    const dim3 grid(oblocks, static_cast<unsigned>(tiles),
                    (nb + nimg - 1) / nimg);
    upconv_blur_kernel<<<grid, threads, smem, stream>>>(
        x + b0 * in_plane, wp, y + b0 * out_plane, nb, in_c, out_c, h, w,
        tiles_x, t, g, taps, dm, nz, noise_bstride, bias);
  }
  return static_cast<int>(cudaGetLastError());
}

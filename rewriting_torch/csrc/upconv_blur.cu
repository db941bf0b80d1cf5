// Fused StyleGAN2 up-conv + FIR blur (+ epilogue) on NCHW float32:
//
//   y = blur4x4(conv_transpose_3x3_stride2(x, w)) * 4
//   optionally y = sqrt(2) * leaky_relu(y * demod[b,o] + noise + bias[o], 0.2)
//
// Replaces the JAX package's TPU kernel ops/pallas_upconv.py::
// upconv_blur_pallas (:166, body _upconv_blur_body :81-156).  It runs in the
// sampling pipeline (pipeline_fast) at every upsampling layer of StyleGAN2:
// at church-256, (B,512,4,4) .. (B,256,128,128) in, 2H x 2W out.
//
// What it computes, as the TPU kernel does, without its blocks:
//  1. The stride-2 transposed conv splits by output parity into four
//     (row-phase, col-phase) pre-blur signals over the UNdilated grid.  With
//     the correlation taps wf (the dconv weight flipped and scaled), tap d
//     of an axis feeds phase p at shift s: d=0 -> (0, x[v-1]), d=1 ->
//     (1, x[v]), d=2 -> (0, x[v]) (pallas_upconv.py:52-55).  That is 9 MACs
//     per (input pixel, I, O): no zero-inserted map, no 4x composite.
//  2. The 4x4 blur (pad 1) reads the interleaved phase signals P at
//     P[r + i - 1, c + j - 1], i, j in 0..3, with the flipped taps.
//  3. The epilogue, then one write of each output.
//
// What bounds it on an H100: operations.  9*I*O FMAs per input pixel; at
// (16,256,128,128) -> 128 that is 154.6 GFLOP against 0.34 GB of output and
// 0.27 GB of input, 2.31 ms at the fp32 (non-tensor-core) peak of 67 TFLOP/s
// and 0.18 ms at 3.35 TB/s.  Products are plain fp32 FMAs (no TF32).
//
// The design (simple, right first):
//  - A block owns one batch index, a 16 x 16 tile of input positions (a
//    32 x 32 output tile) and 16 output channels.  It computes the phase
//    signals at 18 x 18 positions: the tile plus the one-position halo the
//    blur needs, recomputed, so blocks share nothing (27% extra MACs).
//  - It loops over the input channels 8 at a time, staging the 19 x 19 input
//    tile (zeros outside the image, so the conv's zero padding and the
//    halo rows at the first and last tile come for free) and the 8 x 9 x 16
//    weight slice in shared memory.
//  - Each of its 324 threads owns two neighbouring phase positions and 8
//    output channels: 64 fp32 accumulators in registers.  Per input channel
//    it reads 6 inputs and 72 weights (broadcast float4 loads) for 144 FMAs.
//  - After the loop the accumulators go to shared memory interleaved, 8
//    channels at a time (42 KB, under the 48 KB static limit), and every
//    thread computes blurred outputs with coalesced writes.
//  - grid = (O/16, tiles, B); batches above 65535 are launched in slices.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;               // input positions per tile side
constexpr int kPhase = kTile + 2;       // phase positions per side, halo in
constexpr int kXTile = kTile + 3;       // staged input rows / columns
constexpr int kXStride = kXTile + 1;
constexpr int kOB = 16;                 // output channels of a block
constexpr int kOG = 8;                  // output channels of a thread
constexpr int kIC = 8;                  // input channels staged per step
constexpr int kPairs = kPhase / 2;      // column pairs per phase row
constexpr int kGroupThreads = kPhase * kPairs;            // 162
constexpr int kThreads = (kOB / kOG) * kGroupThreads;     // 324
constexpr int kOut = 2 * kTile;         // output rows / columns of a tile
constexpr int kPTile = 2 * kPhase;      // interleaved phase rows / columns
constexpr int kPStride = kPTile + 1;
constexpr int kXFloats = kIC * kXTile * kXStride;
constexpr int kWFloats = kIC * 9 * kOB;
constexpr int kPFloats = kOG * kPTile * kPStride;
constexpr int kSmemFloats =
    kPFloats > kXFloats + kWFloats ? kPFloats : kXFloats + kWFloats;
constexpr int kMaxGrid = 65535;

static_assert(kXFloats % 4 == 0, "the weight slice must be 16-byte aligned");
static_assert(kSmemFloats * 4 <= 48 * 1024, "static shared memory limit");

struct Taps {
  float v[16];  // the 4x4 flipped blur taps with the gain, row-major
};

// acc[q][P][o] += w[o] * in_q for the 8 output channels of a thread; the
// phase P is a template argument so the accumulators stay in registers
template <int P>
__device__ __forceinline__ void tap_fma(float (&acc)[2][4][kOG],
                                        const float4 wa, const float4 wb,
                                        float in0, float in1) {
  const float wt[kOG] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
  for (int o = 0; o < kOG; ++o) {
    acc[0][P][o] = fmaf(wt[o], in0, acc[0][P][o]);
    acc[1][P][o] = fmaf(wt[o], in1, acc[1][P][o]);
  }
}

__global__ void __launch_bounds__(kThreads)
upconv_blur_kernel(const float* __restrict__ x, const float* __restrict__ wp,
                   float* __restrict__ y, int in_c, int out_c, int h, int w,
                   int tiles_x, Taps taps, const float* __restrict__ demod,
                   const float* __restrict__ noise, long long noise_bstride,
                   const float* __restrict__ bias) {
  __shared__ __align__(16) float smem[kSmemFloats];
  float* xs = smem;              // [kIC][kXTile][kXStride]
  float* ws = smem + kXFloats;   // [kIC][9][kOB]
  float* ps = smem;              // [kOG][kPTile][kPStride], after the loop

  const int ob0 = blockIdx.x * kOB;
  const int u0 = (blockIdx.y / tiles_x) * kTile;
  const int w0 = (blockIdx.y % tiles_x) * kTile;
  const size_t b = blockIdx.z;
  const int t = threadIdx.x;
  const int og = t / kGroupThreads;
  const int pp = t % kGroupThreads;
  const int lv = pp / kPairs;          // phase row, 0..17
  const int lw = 2 * (pp % kPairs);    // first of two phase columns

  // acc[q][p][o]: phase position lw + q, phase p = 2*row_phase + col_phase
  float acc[2][4][kOG];
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int o = 0; o < kOG; ++o) acc[q][p][o] = 0.0f;

  const float* xb = x + b * in_c * h * w;
  for (int i0 = 0; i0 < in_c; i0 += kIC) {
    // input rows u0-2 .. u0+16 and columns w0-2 .. w0+16: phase position
    // v reads x[v-1] and x[v], and the phase tile starts at u0-1
    for (int e = t; e < kIC * kXTile * kXTile; e += kThreads) {
      const int il = e / (kXTile * kXTile);
      const int r = (e / kXTile) % kXTile;
      const int c = e % kXTile;
      const int i = i0 + il;
      const int iy = u0 - 2 + r;
      const int ix = w0 - 2 + c;
      float v = 0.0f;
      if (i < in_c && iy >= 0 && iy < h && ix >= 0 && ix < w) {
        v = __ldg(xb + (static_cast<size_t>(i) * h + iy) * w + ix);
      }
      xs[(il * kXTile + r) * kXStride + c] = v;
    }
    // weights packed (I, 3, 3, O): the slice [i0, i0+8) x 9 x [ob0, ob0+16)
    for (int e = t; e < kWFloats; e += kThreads) {
      const int il = e / (9 * kOB);
      const int tap = (e / kOB) % 9;
      const int o = e % kOB;
      const int i = i0 + il;
      const int oo = ob0 + o;
      ws[e] = (i < in_c && oo < out_c)
                  ? __ldg(wp + (static_cast<size_t>(i) * 9 + tap) * out_c + oo)
                  : 0.0f;
    }
    __syncthreads();

#pragma unroll 2
    for (int il = 0; il < kIC; ++il) {
      const float* r0 = xs + (il * kXTile + lv) * kXStride + lw;  // x[v-1]
      const float* r1 = r0 + kXStride;                             // x[v]
      const float a = r0[0], bb = r0[1], c = r0[2];
      const float d = r1[0], e = r1[1], f = r1[2];
      const float4* wv =
          reinterpret_cast<const float4*>(ws + il * 9 * kOB + og * kOG);
      // tap (dy, dx) = wv[4 * (3 * dy + dx)]: the phase it feeds and the
      // inputs of the two positions (pallas_upconv.py:52-55 on both axes)
      tap_fma<0>(acc, wv[0], wv[1], a, bb);     // (0, 0)
      tap_fma<1>(acc, wv[4], wv[5], bb, c);     // (0, 1)
      tap_fma<0>(acc, wv[8], wv[9], bb, c);     // (0, 2)
      tap_fma<2>(acc, wv[12], wv[13], d, e);    // (1, 0)
      tap_fma<3>(acc, wv[16], wv[17], e, f);    // (1, 1)
      tap_fma<2>(acc, wv[20], wv[21], e, f);    // (1, 2)
      tap_fma<0>(acc, wv[24], wv[25], d, e);    // (2, 0)
      tap_fma<1>(acc, wv[28], wv[29], e, f);    // (2, 1)
      tap_fma<0>(acc, wv[32], wv[33], e, f);    // (2, 2)
    }
    __syncthreads();
  }

  const int ho = 2 * h;
  const int wo = 2 * w;
  for (int g = 0; g < kOB / kOG; ++g) {
    // one channel group's phase signals, interleaved: local row 2*lv + py
    // is pre-blur row 2*(u0-1) + 2*lv + py
    if (og == g) {
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int o = 0; o < kOG; ++o) {
            const int row = 2 * lv + (p >> 1);
            const int col = 2 * (lw + q) + (p & 1);
            ps[(o * kPTile + row) * kPStride + col] = acc[q][p][o];
          }
    }
    __syncthreads();
    for (int idx = t; idx < kOG * kOut * kOut; idx += kThreads) {
      const int ol = idx / (kOut * kOut);
      const int rr = (idx / kOut) % kOut;
      const int cc = idx % kOut;
      const int o = ob0 + g * kOG + ol;
      const int oy = 2 * u0 + rr;
      const int ox = 2 * w0 + cc;
      if (o >= out_c || oy >= ho || ox >= wo) continue;
      // output (oy, ox) reads pre-blur (oy + i - 1, ox + j - 1): local
      // row rr + i + 1
      const float* src = ps + (ol * kPTile + rr + 1) * kPStride + cc + 1;
      float v = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v = fmaf(taps.v[i * 4 + j], src[i * kPStride + j], v);
      if (demod != nullptr) {
        v = v * demod[b * out_c + o] +
            noise[b * noise_bstride + static_cast<size_t>(oy) * wo + ox];
        v = v + bias[o];
        v = 1.41421356237309515f * (v >= 0.0f ? v : 0.2f * v);
      }
      y[((b * out_c + o) * ho + oy) * static_cast<size_t>(wo) + ox] = v;
    }
    __syncthreads();
  }
}

}  // namespace

// Launches the fused up-conv + blur of x (batch, in_c, h, w) into y
// (batch, out_c, 2h, 2w).  wp holds the correlation taps packed (in_c, 3, 3,
// out_c); taps16 (host memory) the 4x4 flipped blur taps with the gain.
// With demod != nullptr the epilogue runs: demod (batch, out_c), noise
// (batch or 1, 2h, 2w) with the given batch stride (0 broadcasts one map),
// bias (out_c).  Returns cudaGetLastError() after the launches; does not
// synchronise.
extern "C" int upconv_blur_f32(const float* x, const float* wp, float* y,
                               int batch, int in_c, int out_c, int h, int w,
                               const float* taps16, const float* demod,
                               const float* noise, long long noise_bstride,
                               const float* bias, cudaStream_t stream) {
  if (batch < 1 || in_c < 1 || out_c < 1 || h < 1 || w < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles_y = (h + kTile - 1) / kTile;
  const int tiles_x = (w + kTile - 1) / kTile;
  const long long tiles = static_cast<long long>(tiles_y) * tiles_x;
  const int oblocks = (out_c + kOB - 1) / kOB;
  if (tiles > kMaxGrid) return static_cast<int>(cudaErrorInvalidValue);
  Taps taps;
  for (int i = 0; i < 16; ++i) taps.v[i] = taps16[i];
  const size_t in_plane = static_cast<size_t>(in_c) * h * w;
  const size_t out_plane = static_cast<size_t>(out_c) * 4 * h * w;
  for (int b0 = 0; b0 < batch; b0 += kMaxGrid) {
    const int nb = batch - b0 < kMaxGrid ? batch - b0 : kMaxGrid;
    const float* dm = demod ? demod + static_cast<size_t>(b0) * out_c : nullptr;
    const float* nz = demod ? noise + b0 * noise_bstride : nullptr;
    upconv_blur_kernel<<<dim3(oblocks, static_cast<unsigned>(tiles), nb),
                         kThreads, 0, stream>>>(
        x + b0 * in_plane, wp, y + b0 * out_plane, in_c, out_c, h, w,
        tiles_x, taps, dm, nz, noise_bstride, bias);
  }
  return static_cast<int>(cudaGetLastError());
}

// Depthwise FIR blur on NCHW float32: upfirdn2d(x, k, up=1, down=1, pad).
//
// Replaces the JAX package's TPU kernels ops/pallas_upfirdn.py::blur2d_pallas
// (:85) and ::blur2d_pallas_bs (:230); the two differ only in how the TPU
// fetches the row halo, so one kernel serves both.  It runs after every up-conv of the
// StyleGAN2 seq pipeline: a 4x4 [1,3,3,1] outer-product FIR with gain 4 over
// a (2H+1)-square map, pad (1,1), giving a 2H-square map.
//
// What bounds it on an H100: memory.  Each output costs K*K = 16 FMAs and
// 4 bytes written, each input 4 bytes read, so it sits far below the card's
// ridge point (67 TFLOP/s fp32 against 3.35 TB/s).  At (8,128,257,257) ->
// (8,128,256,256) it must read 270.5 MB and write 268.4 MB: about 161 us at
// the data sheet's 3.35 TB/s.
//
// What the design does about it: every input element is read from device
// memory about once and every output written exactly once.  Each (n, c)
// plane is independent.  A block owns a 32x32 output tile of one plane; it
// stages the (32+K-1)-square input tile, halo included, in shared memory with
// coalesced row reads (neighbouring threads on neighbouring addresses), and
// fills the out-of-range part of the halo with zeros itself, so no padded
// copy of the input is ever made.  Each thread then computes four outputs
// of one column from shared memory with the taps in registers (passed by
// value as a kernel argument), accumulating in fp32 in the same tap order as
// the plain version.  The halo re-read is (35/32)^2 - 1 = 20% of the input
// for K = 4 and mostly hits L2.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTaps = 8;
constexpr int kTileW = 32;
constexpr int kTileH = 32;
constexpr int kThreadsY = 8;
constexpr int kMaxGridZ = 65535;

struct Taps {
  float v[kMaxTaps * kMaxTaps];
};

template <int K>
__global__ void __launch_bounds__(kTileW * kThreadsY)
blur2d_kernel(const float* __restrict__ x, float* __restrict__ y, int h,
              int w, int ho, int wo, int pad0, Taps taps) {
  __shared__ float tile[kTileH + K - 1][kTileW + K - 1];
  const size_t plane = blockIdx.z;
  const float* xp = x + plane * h * w;
  float* yp = y + plane * ho * wo;
  const int ox0 = blockIdx.x * kTileW;
  const int oy0 = blockIdx.y * kTileH;
  // output (oy, ox) correlates padded rows oy..oy+K-1, i.e. input rows
  // oy-pad0 .. oy-pad0+K-1; a negative pad0 crops
  const int iy0 = oy0 - pad0;
  const int ix0 = ox0 - pad0;
  for (int r = threadIdx.y; r < kTileH + K - 1; r += kThreadsY) {
    const int iy = iy0 + r;
    const bool row_in = iy >= 0 && iy < h;
    for (int c = threadIdx.x; c < kTileW + K - 1; c += kTileW) {
      const int ix = ix0 + c;
      tile[r][c] = (row_in && ix >= 0 && ix < w)
                       ? __ldg(xp + static_cast<size_t>(iy) * w + ix)
                       : 0.0f;
    }
  }
  __syncthreads();

  float k[K * K];
#pragma unroll
  for (int t = 0; t < K * K; ++t) k[t] = taps.v[t];

  const int ox = ox0 + threadIdx.x;
  if (ox >= wo) return;
#pragma unroll
  for (int s = 0; s < kTileH / kThreadsY; ++s) {
    const int ty = threadIdx.y + s * kThreadsY;
    const int oy = oy0 + ty;
    if (oy < ho) {
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < K; ++i) {
#pragma unroll
        for (int j = 0; j < K; ++j) {
          acc = fmaf(k[i * K + j], tile[ty + i][threadIdx.x + j], acc);
        }
      }
      yp[static_cast<size_t>(oy) * wo + ox] = acc;
    }
  }
}

template <int K>
void launch(const float* x, float* y, int planes, int h, int w, int ho,
            int wo, int pad0, const Taps& taps, cudaStream_t stream) {
  const dim3 block(kTileW, kThreadsY);
  const unsigned gx = (wo + kTileW - 1) / kTileW;
  const unsigned gy = (ho + kTileH - 1) / kTileH;
  // grid.z is capped at 65535: launch the planes in slices
  for (int p0 = 0; p0 < planes; p0 += kMaxGridZ) {
    const int np = planes - p0 < kMaxGridZ ? planes - p0 : kMaxGridZ;
    const size_t in_off = static_cast<size_t>(p0) * h * w;
    const size_t out_off = static_cast<size_t>(p0) * ho * wo;
    blur2d_kernel<K><<<dim3(gx, gy, np), block, 0, stream>>>(
        x + in_off, y + out_off, h, w, ho, wo, pad0, taps);
  }
}

}  // namespace

// Launches the blur of `planes` independent (h, w) planes of x into the
// (ho, wo) planes of y, with the k x k flipped taps (row-major, host memory)
// and the top/left pad `pad0`.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for an unsupported k); does not synchronise.
extern "C" int blur2d_f32(const float* x, float* y, int planes, int h, int w,
                          int ho, int wo, int pad0, int k,
                          const float* taps_host, cudaStream_t stream) {
  if (k < 1 || k > kMaxTaps || planes < 1 || ho < 1 || wo < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Taps taps;
  for (int t = 0; t < kMaxTaps * kMaxTaps; ++t) {
    taps.v[t] = t < k * k ? taps_host[t] : 0.0f;
  }
  switch (k) {
    case 1: launch<1>(x, y, planes, h, w, ho, wo, pad0, taps, stream); break;
    case 2: launch<2>(x, y, planes, h, w, ho, wo, pad0, taps, stream); break;
    case 3: launch<3>(x, y, planes, h, w, ho, wo, pad0, taps, stream); break;
    case 4: launch<4>(x, y, planes, h, w, ho, wo, pad0, taps, stream); break;
    case 5: launch<5>(x, y, planes, h, w, ho, wo, pad0, taps, stream); break;
    case 6: launch<6>(x, y, planes, h, w, ho, wo, pad0, taps, stream); break;
    case 7: launch<7>(x, y, planes, h, w, ho, wo, pad0, taps, stream); break;
    case 8: launch<8>(x, y, planes, h, w, ho, wo, pad0, taps, stream); break;
  }
  return static_cast<int>(cudaGetLastError());
}

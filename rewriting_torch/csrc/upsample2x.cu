// Polyphase 2x FIR upsample on NCHW float32: upfirdn2d(x, k, up=2, down=1,
// pad) for the pads that give exactly (2H, 2W) (every StyleGAN2 upsample).
//
// Replaces the JAX package's TPU kernel ops/pallas_upfirdn.py::
// upsample2x_pallas (:150, body _up2_body :126, taps _phase_taps :101),
// which ops/upfirdn2d.py::upsample2d sends maps of 64 or more channels to.
// Output row t = 2y + a takes kflip[i] * x[y + (a + i - pad0) / 2] for each
// tap i with (a + i - pad0) even, and likewise along the columns: each
// output phase reads the undilated input, so no zero-inserted map exists.
//
// What bounds it on an H100: memory.  Each output costs (K/2)^2 = 4 FMAs
// for K = 4 and 4 bytes written, each input 4 bytes read; at
// (16,128,128,128) -> (16,128,256,256) it must read 134 MB and write
// 537 MB: about 0.20 ms at 3.35 TB/s.
//
// The design: each (n, c) plane is independent.  A block owns a 32 x 32
// output tile of one plane; it stages the 16 x 16 input tile it reads, with
// its halo, in shared memory (coalesced row reads, zeros outside the image,
// so no padded copy of the input is made), and each thread computes four
// outputs of one column, all of one output phase, so it loops over that
// phase's taps only (4 of 16 for K = 4), in the plain version's tap order.
// The halo re-read is at most (21/16)^2 - 1 of the input and mostly hits
// L2.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTaps = 8;
constexpr int kTileW = 32;
constexpr int kTileH = 32;
constexpr int kThreadsY = 8;
constexpr int kIn = kTileH / 2 + kMaxTaps / 2 + 1;  // staged rows / cols
constexpr int kMaxGridZ = 65535;

struct Taps {
  float v[kMaxTaps * kMaxTaps];
};

__device__ __forceinline__ int floor_half(int a) {
  return a >= 0 ? a / 2 : -((1 - a) / 2);
}

template <int K>
__global__ void __launch_bounds__(kTileW * kThreadsY)
upsample2x_kernel(const float* __restrict__ x, float* __restrict__ y, int h,
                  int w, int pad0, Taps taps) {
  __shared__ float tile[kIn][kIn + 1];
  const size_t plane = blockIdx.z;
  const int ho = 2 * h;
  const int wo = 2 * w;
  const float* xp = x + plane * h * w;
  float* yp = y + plane * ho * wo;
  const int ox0 = blockIdx.x * kTileW;
  const int oy0 = blockIdx.y * kTileH;
  // output t reads dilated index t + i - pad0, i.e. input (t + i - pad0)/2:
  // the tile's first input row / column
  const int iy0 = floor_half(oy0 - pad0);
  const int ix0 = floor_half(ox0 - pad0);
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  for (int e = tid; e < kIn * kIn; e += kTileW * kThreadsY) {
    const int r = e / kIn;
    const int c = e % kIn;
    const int iy = iy0 + r;
    const int ix = ix0 + c;
    tile[r][c] = (iy >= 0 && iy < h && ix >= 0 && ix < w)
                     ? __ldg(xp + static_cast<size_t>(iy) * w + ix)
                     : 0.0f;
  }
  __syncthreads();

  const int ox = ox0 + threadIdx.x;
  if (ox >= wo) return;
  // a thread's column, and its rows (oy0 + threadIdx.y + 8s), keep one
  // parity each, so it reads the same taps for all its outputs: the first
  // tap that lands on a sample, every second one after it
  const int j0 = (pad0 - ox) & 1;
  const int cx = floor_half(ox + j0 - pad0) - ix0;
  const int i0 = (pad0 - oy0 - static_cast<int>(threadIdx.y)) & 1;
  // the thread's taps, tk[m][n] = taps[i0 + 2m][j0 + 2n], picked with
  // compile-time indices so they stay in registers (0 past the kernel)
  constexpr int kHalf = (K + 1) / 2;
  float tk[kHalf][kHalf];
#pragma unroll
  for (int m = 0; m < kHalf; ++m) {
#pragma unroll
    for (int n = 0; n < kHalf; ++n) {
      const int ie = 2 * m, io = 2 * m + 1, je = 2 * n, jo = 2 * n + 1;
      const float tee = (ie < K && je < K) ? taps.v[ie * K + je] : 0.0f;
      const float teo = (ie < K && jo < K) ? taps.v[ie * K + jo] : 0.0f;
      const float toe = (io < K && je < K) ? taps.v[io * K + je] : 0.0f;
      const float too = (io < K && jo < K) ? taps.v[io * K + jo] : 0.0f;
      tk[m][n] = i0 ? (j0 ? too : toe) : (j0 ? teo : tee);
    }
  }
#pragma unroll
  for (int s = 0; s < kTileH / kThreadsY; ++s) {
    const int oy = oy0 + threadIdx.y + s * kThreadsY;
    if (oy >= ho) continue;
    const int ry = floor_half(oy + i0 - pad0) - iy0;
    float acc = 0.0f;
#pragma unroll
    for (int m = 0; m < kHalf; ++m) {
#pragma unroll
      for (int n = 0; n < kHalf; ++n) {
        if (i0 + 2 * m < K && j0 + 2 * n < K) {
          acc = fmaf(tk[m][n], tile[ry + m][cx + n], acc);
        }
      }
    }
    yp[static_cast<size_t>(oy) * wo + ox] = acc;
  }
}

template <int K>
void launch(const float* x, float* y, int planes, int h, int w, int pad0,
            const Taps& taps, cudaStream_t stream) {
  const dim3 block(kTileW, kThreadsY);
  const unsigned gx = (2 * w + kTileW - 1) / kTileW;
  const unsigned gy = (2 * h + kTileH - 1) / kTileH;
  for (int p0 = 0; p0 < planes; p0 += kMaxGridZ) {
    const int np = planes - p0 < kMaxGridZ ? planes - p0 : kMaxGridZ;
    const size_t in_off = static_cast<size_t>(p0) * h * w;
    upsample2x_kernel<K><<<dim3(gx, gy, np), block, 0, stream>>>(
        x + in_off, y + 4 * in_off, h, w, pad0, taps);
  }
}

}  // namespace

// Launches the 2x upsample of `planes` independent (h, w) planes of x into
// the (2h, 2w) planes of y, with the k x k flipped taps (gain included,
// row-major, host memory) and the top/left pad `pad0`; the caller checks
// that pad0 + pad1 == k - 1.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for an unsupported k); does not synchronise.
extern "C" int upsample2x_f32(const float* x, float* y, int planes, int h,
                              int w, int pad0, int k, const float* taps_host,
                              cudaStream_t stream) {
  if (k < 1 || k > kMaxTaps || planes < 1 || h < 1 || w < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Taps taps;
  for (int t = 0; t < kMaxTaps * kMaxTaps; ++t) {
    taps.v[t] = t < k * k ? taps_host[t] : 0.0f;
  }
  switch (k) {
    case 1: launch<1>(x, y, planes, h, w, pad0, taps, stream); break;
    case 2: launch<2>(x, y, planes, h, w, pad0, taps, stream); break;
    case 3: launch<3>(x, y, planes, h, w, pad0, taps, stream); break;
    case 4: launch<4>(x, y, planes, h, w, pad0, taps, stream); break;
    case 5: launch<5>(x, y, planes, h, w, pad0, taps, stream); break;
    case 6: launch<6>(x, y, planes, h, w, pad0, taps, stream); break;
    case 7: launch<7>(x, y, planes, h, w, pad0, taps, stream); break;
    case 8: launch<8>(x, y, planes, h, w, pad0, taps, stream); break;
  }
  return static_cast<int>(cudaGetLastError());
}

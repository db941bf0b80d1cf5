// Depthwise FIR blur on NCHW float32: upfirdn2d(x, k, up=1, down=1, pad).
//
// Replaces the JAX package's TPU kernels ops/pallas_upfirdn.py::blur2d_pallas
// (:85) and ::blur2d_pallas_bs (:230); the two differ only in how the TPU
// fetches the row halo, so one source serves both.  It runs after every
// up-conv of the StyleGAN2 seq pipeline: a 4x4 [1,3,3,1] outer-product FIR
// with gain 4 over a (2H+1)-square map, pad (1,1), giving a 2H-square map;
// its backward is the same blur with the taps rotated by 180 degrees.
//
// What bounds it on an H100: memory.  Each input is 4 bytes read and each
// output 4 bytes written, against 2k FMAs an output when the taps are
// separable, far below the card's ridge point (67 TFLOP/s fp32 against
// 3.35 TB/s).  At (10,128,257,257) -> (10,128,256,256) it must read 338 MB
// and write 336 MB: about 201 us at the data sheet's 3.35 TB/s.
//
// Two kernels:
//
// blur2d_sep_f32, for taps that are an outer product col x row (the model's
// always are: make_kernel of a 1-D list, and its 180-degree rotation).  A
// warp owns row bands of R output rows over a span of columns; each lane
// owns 4 adjacent output columns of each of M chunks.  Narrow planes (at
// most 64 columns) give each plane a segment of S < 32 lanes, so that one
// warp carries 32/S planes and no lane idles.  Input rows stream into a
// ring of kStages rows in shared memory, private to the warp, by 4-byte
// cp.async copies (rows of width 257 are not 16-byte aligned; neighbouring
// lanes copy neighbouring addresses, and out-of-range columns and rows are
// filled with zeros by the copy itself, so no padded input is made).  The
// copies of the next kStages-1 rows are in flight while a row is computed,
// and the warp waits only on its own copies (__syncwarp, no block barrier).
// Each lane reads its 4+k-1 inputs of a row as float4s, runs the horizontal
// k-tap pass into a sliding window of the last k filtered rows held in
// registers, and the vertical k-tap pass over that window gives one output
// row: 2k FMAs an output in fp32, each input read from device memory once
// in its band (the k-1 halo rows of a band are read again, mostly from L2).
// Rows of width divisible by 4 are stored as float4.  No plane is split
// across warps in its reduction and nothing is atomic: results are the
// same from run to run.  The band height, lanes and chunks come from the
// caller (ops/blur2d.py::_sep_plan).
//
// blur2d_f32, the general k x k kernel for taps that are not rank 1 (the
// first version, kept as it was): a block owns a 32x32 output tile of one
// plane, stages the (32+K-1)-square input tile in shared memory with the
// zero halo, then each thread computes four outputs of one column with the
// k*k taps in registers, in the same tap order as the plain version.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

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

// ---------------------------------------------------------------------------
// The separable row-band kernel
// ---------------------------------------------------------------------------

namespace {

constexpr int kSepWarps = 4;    // warps a block
constexpr int kStages = 4;      // input rows a warp has in its ring
constexpr int kHalo = 8;        // ring columns beyond a segment's outputs
constexpr int kMaxChunks = 3;   // chunks of 4*S columns a lane takes

struct SepTaps {
  float col[kMaxTaps];
  float row[kMaxTaps];
};

__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      bool valid) {
  // 4 bytes global -> shared; a source size of 0 writes a zero
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Task t of a segment: span t % spans, band (t / spans) % bands, plane
// t / (spans * bands); segments of a warp take consecutive tasks, so the
// bands of one plane run side by side and share their halo rows in L2.
template <int K, int M>
__global__ void __launch_bounds__(kSepWarps * 32)
blur2d_sep_kernel(const float* __restrict__ x, float* __restrict__ y, int h,
                  int w, int ho, int wo, int pad0, int lanes_log2, int rows,
                  int bands, int spans, long long tasks, int vec,
                  SepTaps taps) {
  extern __shared__ float4 smem4[];
  const int S = 1 << lanes_log2;
  const int nseg = 32 >> lanes_log2;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int seg = lane >> lanes_log2;
  const int sl = lane & (S - 1);
  const int span_cols = 4 * S * M;        // output columns of a task
  const int rs = span_cols + kHalo;       // ring floats of a segment's row
  const int need = span_cols + K - 1;     // input columns of a task's row

  const long long task =
      (static_cast<long long>(blockIdx.x) * kSepWarps + warp) * nseg + seg;
  const bool active = task < tasks;
  long long plane = 0;
  int band = 0, span = 0;
  if (active) {
    span = static_cast<int>(task % spans);
    const long long pb = task / spans;
    band = static_cast<int>(pb % bands);
    plane = pb / bands;
  }
  const int oy0 = band * rows;
  const int oy_end = min(oy0 + rows, ho);
  const int cs0 = span * span_cols;
  const float* xp = x + static_cast<size_t>(plane) * h * w;
  float* yp = y + static_cast<size_t>(plane) * ho * wo;
  float* ring = reinterpret_cast<float*>(smem4) +
                static_cast<size_t>(warp * kStages * nseg + seg) * rs;
  const int slot = nseg * rs;             // floats between ring slots
  const int nrows = rows + K - 1;         // input rows a band reads

  // copy input row r of the band into slot r % kStages; every lane
  // commits one group, empty or not, so that the counts stay in step
  auto fetch = [&](int r) {
    if (active && r < nrows) {
      float* dst = ring + (r % kStages) * slot;
      const int iy = oy0 - pad0 + r;
      const bool row_in = iy >= 0 && iy < h;
      const float* src = xp + static_cast<ptrdiff_t>(row_in ? iy : 0) * w;
      for (int c = sl; c < need; c += S) {
        const int ix = cs0 + c - pad0;
        const bool ok = row_in && ix >= 0 && ix < w;
        copy4(dst + c, ok ? src + ix : x, ok);
      }
    }
    copy_commit();
  };

  float cw[K], rw[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    cw[i] = taps.col[i];
    rw[i] = taps.row[i];
  }
  constexpr int kVec = (K + 6) / 4;       // float4s holding 4 + K - 1 inputs
  float win[K][M][4];
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q) win[i][m][q] = 0.0f;

#pragma unroll
  for (int r = 0; r < kStages - 1; ++r) fetch(r);
#pragma unroll 1
  for (int r = 0; r < nrows; ++r) {
    __syncwarp();  // every lane is done reading the slot about to be refilled
    fetch(r + kStages - 1);
    copy_wait<kStages - 1>();
    __syncwarp();  // row r is in the ring for the whole warp
    const float4* src =
        reinterpret_cast<const float4*>(ring + (r % kStages) * slot);
#pragma unroll
    for (int i = 0; i + 1 < K; ++i)
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int q = 0; q < 4; ++q) win[i][m][q] = win[i + 1][m][q];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      float v[4 * kVec];
#pragma unroll
      for (int t = 0; t < kVec; ++t) {
        const float4 f = src[sl + S * m + t];
        v[4 * t] = f.x;
        v[4 * t + 1] = f.y;
        v[4 * t + 2] = f.z;
        v[4 * t + 3] = f.w;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < K; ++j) acc = fmaf(rw[j], v[q + j], acc);
        win[K - 1][m][q] = acc;
      }
    }
    const int oy = oy0 + r - (K - 1);
    if (r >= K - 1 && active && oy < oy_end) {
      float* yrow = yp + static_cast<size_t>(oy) * wo;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        float o[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float acc = 0.0f;
#pragma unroll
          for (int i = 0; i < K; ++i) acc = fmaf(cw[i], win[i][m][q], acc);
          o[q] = acc;
        }
        const int ox = cs0 + 4 * (sl + S * m);
        if (vec) {
          if (ox < wo) {
            *reinterpret_cast<float4*>(yrow + ox) =
                make_float4(o[0], o[1], o[2], o[3]);
          }
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (ox + q < wo) yrow[ox + q] = o[q];
          }
        }
      }
    }
  }
  copy_wait<0>();
}

template <int K>
cudaError_t launch_sep_k(int chunks, dim3 grid, size_t smem,
                         cudaStream_t stream, const float* x, float* y,
                         int h, int w, int ho, int wo, int pad0,
                         int lanes_log2, int rows, int bands, int spans,
                         long long tasks, int vec, const SepTaps& taps) {
  const dim3 block(kSepWarps * 32);
  switch (chunks) {
    case 1:
      blur2d_sep_kernel<K, 1><<<grid, block, smem, stream>>>(
          x, y, h, w, ho, wo, pad0, lanes_log2, rows, bands, spans, tasks,
          vec, taps);
      break;
    case 2:
      blur2d_sep_kernel<K, 2><<<grid, block, smem, stream>>>(
          x, y, h, w, ho, wo, pad0, lanes_log2, rows, bands, spans, tasks,
          vec, taps);
      break;
    case 3:
      blur2d_sep_kernel<K, 3><<<grid, block, smem, stream>>>(
          x, y, h, w, ho, wo, pad0, lanes_log2, rows, bands, spans, tasks,
          vec, taps);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// The separable launcher's arguments, prepared once per taps and input
// shape by the caller (ops/blur2d.py::SepArgs mirrors this layout).
struct SepArgs {
  int planes, h, w, ho, wo, pad0, k;
  int lanes, chunks, rows;
  float col[kMaxTaps];
  float row[kMaxTaps];
};

// Launches the separable blur of `planes` independent (h, w) planes of x
// into the (ho, wo) planes of y: the correlation of each zero-padded plane
// (top/left pad `pad0`, negative crops) with the k x k taps
// outer(col, row), in row bands of `rows` output rows, `lanes` lanes a
// plane's row (a power of 2 up to 32) and `chunks` chunks of 4*lanes
// columns a lane (1..3); all of these from *a, in host memory.  Stores
// float4 when wo is a multiple of 4 and y is 16-byte aligned.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for
// arguments it does not take); does not synchronise.
extern "C" int blur2d_sep_f32(const float* x, float* y, const SepArgs* a,
                              cudaStream_t stream) {
  const int k = a->k, ho = a->ho, wo = a->wo, rows = a->rows;
  const int lanes = a->lanes, chunks = a->chunks;
  int lanes_log2 = 0;
  while ((1 << lanes_log2) < lanes) ++lanes_log2;
  if (k < 1 || k > kMaxTaps || k - 1 > kHalo || a->planes < 1 || ho < 1 ||
      wo < 1 || rows < 1 || lanes < 1 || lanes > 32 ||
      (1 << lanes_log2) != lanes || chunks < 1 || chunks > kMaxChunks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SepTaps taps;
  for (int t = 0; t < kMaxTaps; ++t) {
    taps.col[t] = t < k ? a->col[t] : 0.0f;
    taps.row[t] = t < k ? a->row[t] : 0.0f;
  }
  const int span_cols = 4 * lanes * chunks;
  const int bands = (ho + rows - 1) / rows;
  const int spans = (wo + span_cols - 1) / span_cols;
  const long long tasks = static_cast<long long>(a->planes) * bands * spans;
  const int nseg = 32 / lanes;
  const long long warps = (tasks + nseg - 1) / nseg;
  const long long blocks = (warps + kSepWarps - 1) / kSepWarps;
  const size_t smem = sizeof(float) * kSepWarps * kStages * nseg *
                      static_cast<size_t>(span_cols + kHalo);
  if (blocks > 0x7fffffffLL || smem > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vec = wo % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const dim3 grid(static_cast<unsigned>(blocks));
  cudaError_t err = cudaErrorInvalidValue;
  switch (k) {
#define BLUR2D_SEP_CASE(K)                                                   \
  case K:                                                                    \
    err = launch_sep_k<K>(chunks, grid, smem, stream, x, y, a->h, a->w, ho,  \
                          wo, a->pad0, lanes_log2, rows, bands, spans,       \
                          tasks, vec, taps);                                 \
    break;
    BLUR2D_SEP_CASE(1)
    BLUR2D_SEP_CASE(2)
    BLUR2D_SEP_CASE(3)
    BLUR2D_SEP_CASE(4)
    BLUR2D_SEP_CASE(5)
    BLUR2D_SEP_CASE(6)
    BLUR2D_SEP_CASE(7)
    BLUR2D_SEP_CASE(8)
#undef BLUR2D_SEP_CASE
  }
  return static_cast<int>(err);
}

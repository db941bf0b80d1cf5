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
// What bounds it on an H100: memory.  Each input is 4 bytes read and each
// output 4 bytes written, against about k FMAs an output when the taps are
// separable; at (16,128,128,128) -> (16,128,256,256) it must read 134 MB
// and write 537 MB: about 0.20 ms at the data sheet's 3.35 TB/s.  Writes
// are four fifths of the bytes.
//
// Two kernels:
//
// upsample2x_sep_f32, for taps that are an outer product col x row (every
// make_kernel of a 1-D list is).  Each axis splits into its two phases:
// output row 2y + a is sum_n C[a][n] * x[y + d0 + n], with n < D <= k/2 + 1
// and the phase taps C (and R along the columns) laid out by the caller
// (ops/upsample2x.py::sep_phases) with zeros where a phase has no tap.  A
// warp owns row bands of input rows over a span of input columns; narrow
// planes give each plane a segment of S < 32 lanes, so that one warp
// carries 32/S planes, as K2's separable kernel does.  A lane owns 4 input
// columns of each of M chunks, as 2 pairs 2S columns apart, so that each
// float4 store of a segment writes one contiguous run of output bytes
// (a lane's pair gives 4 adjacent outputs).  Input rows stream into a ring
// of kStages rows in shared memory, private to the warp: 16-byte cp.async
// copies when a row is a whole number of float4s, else 4-byte copies; the
// copy zero-fills pads and crops, so no padded input is made, and the warp
// waits only on its own copies (__syncwarp, no block barrier).  For every
// input row a lane runs the horizontal pass of both column phases into a
// sliding window of the last D filtered rows held in registers; the
// vertical pass of both row phases over that window gives output rows 2y
// and 2y + 1, stored as float4s when 2W is a multiple of 4, with streaming
// stores.  Each input is read from device memory once in its band (the
// D - 1 halo rows of a band again, mostly from L2) and each output written
// once.  Nothing is atomic: results are the same from run to run.  The
// band height, lanes and chunks come from the caller (ops/upsample2x.py::
// sep_plan: bands of 4 input rows, which measured faster than longer ones).
//
// upsample2x_f32, the general kernel for taps that are not rank 1 (the
// first version, kept as it was): a block owns a 32 x 32 output tile of
// one plane; it stages the 16 x 16 input tile it reads, with its halo, in
// shared memory (zeros outside the image), and each thread computes four
// outputs of one column, all of one output phase, so it loops over that
// phase's taps only, in the plain version's tap order.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

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

// ---------------------------------------------------------------------------
// The separable polyphase row-band kernel
// ---------------------------------------------------------------------------

namespace {

constexpr int kSepWarps = 4;    // warps a block
constexpr int kStages = 4;      // input rows a warp has in its ring
constexpr int kMaxSpan = kMaxTaps / 2 + 1;  // D: input rows an output reads
constexpr int kRingPad = 8;     // ring columns beyond a segment's inputs
constexpr int kMaxChunks = 3;   // chunks of 4*S input columns a lane takes

struct SepTaps {
  float col[2][kMaxSpan];  // C[a][n]: output row 2y + a, input row y + d0 + n
  float row[2][kMaxSpan];  // R[b][n]: output col 2x + b, input col x + d0 + n
};

// The helpers below are copies of csrc/blur2d.cu's, so that this source
// stands alone (the build hashes only the .cu file).
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      bool valid) {
  // 4 bytes global -> shared; a source size of 0 writes a zero
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       bool valid) {
  // 16 bytes global -> shared, both aligned; a source size of 0 writes zeros
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Streaming stores (st.global.cs, evict first): the output is written once
// and never read here.  Plain write-back stores made the kernel a third
// slower on an H100 (the "stwb" variant of scripts/compare_upsample.py;
// numbers in PERF.md): alone, neither the reads nor the writes were slow,
// together they were.
__device__ __forceinline__ void store4(float* p, float4 v) {
  __stcs(reinterpret_cast<float4*>(p), v);
}

// Task t of a segment: span t % spans, band (t / spans) % bands, plane
// t / (spans * bands), as in K2's separable kernel.  D is the phase taps'
// span (rows and columns), M the chunks a lane takes.
template <int D, int M>
__global__ void __launch_bounds__(kSepWarps * 32)
upsample2x_sep_kernel(const float* __restrict__ x, float* __restrict__ y,
                      int h, int w, int d0, int lanes_log2, int rows,
                      int bands, int spans, long long tasks, int vec_in,
                      int vec_out, SepTaps taps) {
  extern __shared__ float4 smem4[];
  const int S = 1 << lanes_log2;
  const int nseg = 32 >> lanes_log2;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int seg = lane >> lanes_log2;
  const int sl = lane & (S - 1);
  const int span_in = 4 * S * M;          // input columns of a task
  const int rs = span_in + kRingPad;      // ring floats of a segment's row

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
  const int y0 = band * rows;             // the band's first input row
  const int y_end = min(y0 + rows, h);
  const int cs0 = span * span_in;         // the span's first input column
  const int wo = 2 * w;
  // ring index 0 holds input column c_org, a multiple of 4 at or left of
  // the span's first column cs0 + d0 that a tap reads; pair p of the span
  // reads ring indices 2p + sh .. 2p + sh + D
  const int c_org = cs0 + (d0 & ~3);
  const int sh = d0 & 3;
  const float* xp = x + static_cast<size_t>(plane) * h * w;
  float* yp = y + static_cast<size_t>(plane) * 4 * h * w;
  float* ring = reinterpret_cast<float*>(smem4) +
                static_cast<size_t>(warp * kStages * nseg + seg) * rs;
  const int slot = nseg * rs;             // floats between ring slots
  const int nrows = rows + D - 1;         // input rows a band reads

  // copy input row y0 + d0 + r of the band into slot r % kStages; every
  // lane commits one group, empty or not, so that the counts stay in step
  auto fetch = [&](int r) {
    if (active && r < nrows) {
      float* dst = ring + (r % kStages) * slot;
      const int iy = y0 + d0 + r;
      const bool row_in = iy >= 0 && iy < h;
      const float* src = xp + static_cast<ptrdiff_t>(row_in ? iy : 0) * w;
      if (vec_in) {  // w % 4 == 0: a float4 lies wholly in or out of a row
        for (int t = sl; t < rs / 4; t += S) {
          const int ix = c_org + 4 * t;
          const bool ok = row_in && ix >= 0 && ix < w;
          copy16(dst + 4 * t, ok ? src + ix : x, ok);
        }
      } else {
        for (int c = sl; c < rs; c += S) {
          const int ix = c_org + c;
          const bool ok = row_in && ix >= 0 && ix < w;
          copy4(dst + c, ok ? src + ix : x, ok);
        }
      }
    }
    copy_commit();
  };

  float cw[2][D], rw[2][D];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int n = 0; n < D; ++n) {
      cw[a][n] = taps.col[a][n];
      rw[a][n] = taps.row[a][n];
    }
  // win[n][g][2q + b]: the horizontal result of window row n, pair g of
  // the lane, input column q of the pair, output column phase b
  float win[D][2 * M][4];
#pragma unroll
  for (int n = 0; n < D; ++n)
#pragma unroll
    for (int g = 0; g < 2 * M; ++g)
#pragma unroll
      for (int q = 0; q < 4; ++q) win[n][g][q] = 0.0f;

#pragma unroll
  for (int r = 0; r < kStages - 1; ++r) fetch(r);
#pragma unroll 1
  for (int r = 0; r < nrows; ++r) {
    __syncwarp();  // every lane is done reading the slot about to be refilled
    fetch(r + kStages - 1);
    copy_wait<kStages - 1>();
    __syncwarp();  // row r is in the ring for the whole warp
    const float* src = ring + (r % kStages) * slot;
#pragma unroll
    for (int n = 0; n + 1 < D; ++n)
#pragma unroll
      for (int g = 0; g < 2 * M; ++g)
#pragma unroll
        for (int q = 0; q < 4; ++q) win[n][g][q] = win[n + 1][g][q];
#pragma unroll
    for (int g = 0; g < 2 * M; ++g) {
      const float* v0 = src + 2 * (sl + S * g) + sh;
      float v[D + 1];
#pragma unroll
      for (int n = 0; n <= D; ++n) v[n] = v0[n];
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          float acc = 0.0f;
#pragma unroll
          for (int n = 0; n < D; ++n) acc = fmaf(rw[b][n], v[q + n], acc);
          win[D - 1][g][2 * q + b] = acc;
        }
    }
    const int yy = y0 + r - (D - 1);
    if (r >= D - 1 && active && yy < y_end) {
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        float* yrow = yp + static_cast<size_t>(2 * yy + a) * wo;
#pragma unroll
        for (int g = 0; g < 2 * M; ++g) {
          float o[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            float acc = 0.0f;
#pragma unroll
            for (int n = 0; n < D; ++n) {
              acc = fmaf(cw[a][n], win[n][g][q], acc);
            }
            o[q] = acc;
          }
          const int ox = 2 * cs0 + 4 * (sl + S * g);
          if (vec_out) {
            if (ox < wo) {
              store4(yrow + ox, make_float4(o[0], o[1], o[2], o[3]));
            }
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              if (ox + q < wo) __stcs(yrow + ox + q, o[q]);
            }
          }
        }
      }
    }
  }
  copy_wait<0>();
}

template <int D>
cudaError_t launch_sep_d(int chunks, dim3 grid, size_t smem,
                         cudaStream_t stream, const float* x, float* y,
                         int h, int w, int d0, int lanes_log2, int rows,
                         int bands, int spans, long long tasks, int vec_in,
                         int vec_out, const SepTaps& taps) {
  const dim3 block(kSepWarps * 32);
  switch (chunks) {
#define UP2_SEP_CHUNKS(M)                                                    \
  case M:                                                                    \
    upsample2x_sep_kernel<D, M><<<grid, block, smem, stream>>>(              \
        x, y, h, w, d0, lanes_log2, rows, bands, spans, tasks, vec_in,       \
        vec_out, taps);                                                      \
    break;
    UP2_SEP_CHUNKS(1)
    UP2_SEP_CHUNKS(2)
    UP2_SEP_CHUNKS(3)
#undef UP2_SEP_CHUNKS
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// The separable launcher's arguments, prepared once per taps and input
// shape by the caller (ops/upsample2x.py::SepArgs mirrors this layout).
struct SepArgs {
  int planes, h, w, d0, span, lanes, chunks, rows;
  float col[2][kMaxSpan];
  float row[2][kMaxSpan];
};

// Launches the separable 2x upsample of `planes` independent (h, w)
// planes of x into the (2h, 2w) planes of y: output (2i + a, 2j + b) is
// sum_{n, m < span} col[a][n] * row[b][m] * x[i + d0 + n, j + d0 + m],
// zero outside the plane, in row bands of `rows` input rows, `lanes`
// lanes a plane's row (a power of 2 up to 32) and `chunks` chunks of
// 4*lanes input columns a lane (1..3); all of these from *a, in host
// memory.  Copies 16 bytes at a time when w is a multiple of 4 and x is
// 16-byte aligned, stores float4 when 2w is a multiple of 4 and y is
// 16-byte aligned.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments it does not take); does not
// synchronise.
extern "C" int upsample2x_sep_f32(const float* x, float* y, const SepArgs* a,
                                  cudaStream_t stream) {
  const int h = a->h, w = a->w, rows = a->rows, span = a->span;
  const int lanes = a->lanes, chunks = a->chunks;
  int lanes_log2 = 0;
  while ((1 << lanes_log2) < lanes) ++lanes_log2;
  if (span < 1 || span > kMaxSpan || a->planes < 1 || h < 1 || w < 1 ||
      rows < 1 || lanes < 1 || lanes > 32 || (1 << lanes_log2) != lanes ||
      chunks < 1 || chunks > kMaxChunks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SepTaps taps;
  for (int p = 0; p < 2; ++p) {
    for (int n = 0; n < kMaxSpan; ++n) {
      taps.col[p][n] = a->col[p][n];
      taps.row[p][n] = a->row[p][n];
    }
  }
  const int span_in = 4 * lanes * chunks;
  const int bands = (h + rows - 1) / rows;
  const int spans = (w + span_in - 1) / span_in;
  const long long tasks = static_cast<long long>(a->planes) * bands * spans;
  const int nseg = 32 / lanes;
  const long long warps = (tasks + nseg - 1) / nseg;
  const long long blocks = (warps + kSepWarps - 1) / kSepWarps;
  const size_t smem = sizeof(float) * kSepWarps * kStages * nseg *
                      static_cast<size_t>(span_in + kRingPad);
  if (blocks > 0x7fffffffLL || smem > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vec_in = w % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_out =
      w % 2 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const dim3 grid(static_cast<unsigned>(blocks));
  cudaError_t err = cudaErrorInvalidValue;
  switch (span) {
#define UP2_SEP_SPAN(D)                                                      \
  case D:                                                                    \
    err = launch_sep_d<D>(chunks, grid, smem, stream, x, y, h, w, a->d0,     \
                          lanes_log2, rows, bands, spans, tasks, vec_in,     \
                          vec_out, taps);                                    \
    break;
    UP2_SEP_SPAN(1)
    UP2_SEP_SPAN(2)
    UP2_SEP_SPAN(3)
    UP2_SEP_SPAN(4)
    UP2_SEP_SPAN(5)
#undef UP2_SEP_SPAN
  }
  return static_cast<int>(err);
}

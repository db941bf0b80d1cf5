// K1's one-pass bf16 mode on Hopper: the fused StyleGAN2 up-conv + FIR blur
// (+ epilogue) on NCHW float32, with the conv's operands rounded to bf16:
//
//   y = blur4x4(conv_transpose_3x3_stride2(bf16(x), bf16(w))) * 4
//   optionally y = sqrt(2) * leaky_relu(y * demod[b,o] + noise + bias[o], 0.2)
//
// Replaces the JAX package's TPU kernel ops/pallas_upconv.py::
// upconv_blur_pallas (pallas_call at :232, body _upconv_blur_body :81-156)
// at DEFAULT precision (:58-78), which the "default" and "int8" tiers of a
// precision schedule (ops/precision.py) select: x and the correlation taps
// wf rounded to bf16 (to nearest even), the 9 taps' products summed in fp32
// on the tensor cores, the blur and the epilogue in fp32.  The 3xTF32 modes
// ("highest", "high") are csrc/upconv_blur.cu.
//
// What it computes (as csrc/upconv_blur.cu, whose notes derive it): the
// stride-2 transposed conv splits by output parity into four phase signals
// over the undilated grid; tap (dy, dx) of wf feeds phase (py, px) from the
// input at shift (sy, sx), per axis d=0 -> (0, 1), d=1 -> (1, 0), d=2 ->
// (0, 0).  So each tap is a GEMM: A = the input at the tap's shift
// (positions x input channels), B = wf[:, :, dy, dx] (input x output
// channels).  Then the 4x4 blur (two 4-tap passes) over the interleaved
// phases, the epilogue and one write of each output.
//
// What bounds it on an H100: bytes.  At (16,256,128,128) -> 128 the inputs
// and outputs are 0.805 GB in fp32, 0.241 ms at 3.35 TB/s; the conv is 77.3
// G MACs, 0.156 ms at the bf16 dense peak of 989 TFLOP/s.
//
// The design:
//  - Operands converted once.  The wrapper (ops/upconv_blur.py::
//    pack_weights_bf16) rounds wf to bf16 once a call and packs it in the
//    shared-memory image the wgmma B descriptors read: per (64 output
//    channels, 32 input channels, tap) a K-major no-swizzle tile of 8 x 8
//    core matrices (16 bytes a row: 8 input channels of one output
//    channel), k groups 1024 bytes apart (LBO), n groups 128 (SBO); a
//    chunk's 9 tiles are one bulk copy.  A chunk of x (32 channels of the
//    block's positions and halo) lands as fp32 by one TMA load of a 4D box
//    of the NCHW tensor (its out-of-bounds zero fill is the image edge's
//    halo and the channels past in_c; the box's first column must be 16
//    bytes aligned, so it starts lpad = (w0 - 2) & 3 columns early), or,
//    where w is not a multiple of 4, by 4-byte cp.async.  It is rounded to
//    bf16 once, in one shared-memory pass, into a position-major buffer
//    with the channels contiguous (80-byte rows: ldmatrix's eight rows of
//    a matrix fall in distinct banks).  A separate pre-pass writing x as
//    bf16 would add 0.12 ms of traffic at the shapes above.
//  - wgmma.mma_async m64n64k16, bf16 in, fp32 accumulators.  B, a tap's
//    weight slice, comes from shared memory by descriptor.  A comes from
//    registers: per 16 input channels each warp reads, with 4 ldmatrix.x4,
//    its 16 rows at the 4 distinct shifts (a shift is a row offset, so no
//    descriptor need start off the 8-row core-matrix grid); the 9 taps are
//    9 wgmma, each into its phase's accumulator.  The other order, the JAX
//    kernel's (one GEMM of the unshifted x against all 9 taps, then
//    shift-add the products), needs 9 accumulators a position instead of
//    4 and does not fit the register file at 64 x 64.
//  - The tile fits the registers: a warpgroup holds 64 positions x 64
//    output channels x 4 phases, 128 fp32 accumulators a thread; a block
//    is 2 warpgroups (256 threads, __launch_bounds__(256, 1)) over 128
//    positions of one output-channel block of 64, so x is staged once per
//    64 output channels.  Positions are (image, phase row, phase column):
//    nimg whole images or one image's th x tw input positions plus the
//    one-position phase halo the blur needs, recomputed, as in
//    csrc/upconv_blur.cu; the tile is chosen per layer shape by
//    ops/upconv_blur.py::_plan_bf16 with (th + 2) (tw + 2) nimg <= 128 and
//    the fewest blocks (at 128 x 128, 5 x 16 inputs in 7 x 18 positions:
//    the halo costs 1.6x the useful MACs).  ptxas -v (sm_90a, CUDA 12.8):
//    242 registers, no spills.
//  - Pipeline: 4 weight stages and 2 fp32 x stages in shared memory, each
//    chunk's copies completing on its stage's mbarrier, issued three
//    chunks ahead by one thread; every thread both converts and
//    multiplies (the conversion needs threads, and the registers of 256
//    threads are all the accumulators can have).  The wgmma are
//    asynchronous: a chunk's 18 are issued (A double-buffered, one group
//    in flight), then the next chunk is waited for and converted while
//    they run.  Each input channel is summed inside one block in a fixed
//    order: no atomics, two launches give the same bits.
//  - After the K loop all accumulators go to shared memory (the ring is
//    free; planes padded so that the fragment's channel lanes fall at most
//    2 to a bank), which frees their registers for the blur; then, 32
//    channels a round, the blur's row pass and its column pass on groups
//    of 4 outputs with aligned float4 reads and writes of shared memory,
//    the epilogue (its operands staged in shared memory at the start; no
//    branch: without it they are neutral) and streaming stores, float4
//    where the output row is aligned.
//  - grid = (ceil(O / 64), tiles, ceil(B / nimg)); batches beyond the
//    grid's z limit are launched in slices.
//
// What holds it back (per-block clock64 stamps at (16,256,128,128) -> 128,
// PERF.md): one block a SM, so a block's phases do not overlap: the first
// chunk's wait (~6K cycles), the K loop (~18K, the wgmma at about half the
// tensor peak) and the blur and stores (~17K, at a low issue rate).

#include <cuda.h>  // CUtensorMap; its encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;           // 2 warpgroups
constexpr int kRows = 128;              // positions of a block
constexpr int kN = 64;                  // output channels of a block
constexpr int kKc = 32;                 // input channels of a chunk
constexpr int kXRowBytes = 80;          // a staged position: 32 bf16 + pad
constexpr int kTapBytes = kN * kKc * 2; // a tap's B tile: 4096 bytes
constexpr int kWChunkBytes = 9 * kTapBytes;
constexpr int kWStages = 4;
constexpr int kCC = 32;                 // channels a blur round
constexpr int kLbo = 1024;              // B: k-group stride, bytes
constexpr int kSbo = 128;               // B: n-group stride, bytes
constexpr int kMaxGrid = 65535;
constexpr int kMaxSmem = 232448;

inline int round_up(int n, int m) { return (n + m - 1) / m * m; }

// Sizes derived from a tile (ops/upconv_blur.py::_geometry_bf16 is the
// same), computed on the host and passed as a kernel parameter
struct Geo {
  int nimg, th, tw;
  int ph, pw, plane;  // phase rows, columns and positions of an image
  int xh, xw;         // staged input rows and row pitch: the tw + 3
                      // columns used from a 16-byte aligned start, lpad
                      // = (w0 - 2) & 3 columns earlier (the TMA box's
                      // first column must be aligned), rounded up to 16
                      // bytes
  int xplane;         // staged positions of an image: xh * xw
  int npos;           // staged positions: nimg * xplane
  int m_valid;        // positions of a block: nimg * plane
  int cg;             // groups of 4 output columns: ceil(2 tw / 4)
  int pr, pc, rr, rc; // blur buffers: phase rows and row pitch (column k at
                      // k + 3, so that an output group's 8 inputs are two
                      // aligned float4); row-pass rows and pitch
  int pst;            // phase plane stride: pr * pc, padded so that the
                      // accumulator fragment's 4 channel lanes (2 planes
                      // apart) fall at most 2 to a bank
  int xstage;         // bytes of an fp32 x stage: nimg * 32 * xplane * 4
  int off_xf, off_xb, off_pos, off_bar, off_par, smem;  // layout, bytes
};

inline Geo geometry(int nimg, int th, int tw) {
  Geo g;
  g.nimg = nimg;
  g.th = th;
  g.tw = tw;
  g.ph = th + 2;
  g.pw = tw + 2;
  g.plane = g.ph * g.pw;
  g.xh = th + 3;
  g.xw = round_up(tw + 6, 4);
  g.xplane = g.xh * g.xw;
  g.npos = nimg * g.xplane;
  g.m_valid = nimg * g.plane;
  g.cg = (2 * tw + 3) / 4;
  g.pr = 2 * g.ph;
  g.pc = 4 * g.cg + 8;
  g.rr = 2 * th + 3;
  g.rc = 4 * g.cg;
  g.pst = g.pr * g.pc + ((2 * g.pr * g.pc) % 32 == 0 ? 4 : 0);
  g.xstage = round_up(kKc * g.npos * 4, 1024);
  g.off_xf = kWStages * kWChunkBytes;
  g.off_xb = g.off_xf + 2 * g.xstage;
  g.off_pos = g.off_xb + 2 * g.npos * kXRowBytes;
  const int ring = g.off_pos + 4 * g.npos;
  // the blur: every channel's phase planes, then one round's row pass
  const int epi = 4 * nimg * (kN * g.pst + kCC * g.rr * g.rc);
  // the epilogue's operands: noise [nimg][2 th][4 cg], demod [nimg][64],
  // bias [64], staged at the start, read after the blur; then the ring's
  // mbarriers, which no other buffer may overlap
  g.off_par = round_up(ring > epi ? ring : epi, 16);
  g.off_bar =
      round_up(g.off_par + 4 * (nimg * (2 * th * g.rc + kN) + kN), 8);
  g.smem = g.off_bar + 8 * kWStages;
  return g;
}

struct Taps {
  float v[4];  // the flipped 1-D blur taps with the gain
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// two floats rounded to bf16 (to nearest even) in one register, lo in the
// low half: the lower channel at the lower address
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 4 bytes global -> shared; zeros where !valid
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// waits for the phase of `parity` to complete; a phase that never completes
// is a fault of the kernel, and after some 4 million polls (tens of
// milliseconds at the least, against microseconds for a chunk) it traps,
// so that the launch fails rather than hangs the device
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 22)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// `bytes` global -> shared by the copy engine, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// the tensor map's box at (c0, c1, c2, c3) -> shared, zeros outside the
// tensor, completing on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads and writes across the
// asynchronous wgmma
__device__ __forceinline__ void fence_acc(float (&acc)[4][32]) {
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(acc[p][i])::"memory");
}

// B descriptor of a K-major no-swizzle tile at shared address addr
__device__ __forceinline__ uint64_t bdesc(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>(kLbo >> 4) << 16) |
         (static_cast<uint64_t>(kSbo >> 4) << 32);
}

// d += A (64 x 16, registers) x B (16 x 64, descriptor)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// The A fragments of the 4 shifts (1,1), (1,0), (0,1), (0,0) at the lane's
// ldmatrix row address addr: shift (sy, sx) reads staged position
// (lv + 1 - sy, lw + 1 - sx)
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], uint32_t addr,
                                       int xw) {
  ldmatrix_x4(a[0], addr);
  ldmatrix_x4(a[1], addr + kXRowBytes);
  ldmatrix_x4(a[2], addr + kXRowBytes * xw);
  ldmatrix_x4(a[3], addr + kXRowBytes * (xw + 1));
}

// The 9 taps of 16 input channels, each into its phase (py, px) as index
// 2 py + px; tap (dy, dx) is B tile 3 dy + dx of the chunk at wa
__device__ __forceinline__ void mma_step(float (&acc)[4][32],
                                         const uint32_t (&a)[4][4],
                                         uint32_t wa) {
  fence_acc(acc);
  wgmma_fence();
  wgmma_rs(acc[0], a[0], bdesc(wa + 0 * kTapBytes));  // (0,0) shift (1,1)
  wgmma_rs(acc[1], a[1], bdesc(wa + 1 * kTapBytes));  // (0,1) shift (1,0)
  wgmma_rs(acc[2], a[2], bdesc(wa + 3 * kTapBytes));  // (1,0) shift (0,1)
  wgmma_rs(acc[3], a[3], bdesc(wa + 4 * kTapBytes));  // (1,1) shift (0,0)
  wgmma_rs(acc[0], a[1], bdesc(wa + 2 * kTapBytes));  // (0,2) shift (1,0)
  wgmma_rs(acc[2], a[3], bdesc(wa + 5 * kTapBytes));  // (1,2) shift (0,0)
  wgmma_rs(acc[0], a[2], bdesc(wa + 6 * kTapBytes));  // (2,0) shift (0,1)
  wgmma_rs(acc[1], a[3], bdesc(wa + 7 * kTapBytes));  // (2,1) shift (0,0)
  wgmma_rs(acc[0], a[3], bdesc(wa + 8 * kTapBytes));  // (2,2) shift (0,0)
  wgmma_commit();
  fence_acc(acc);
}

__global__ void __launch_bounds__(kThreads, 1)
upconv_blur_bf16_kernel(const __grid_constant__ CUtensorMap xmap, int tma,
                        const float* __restrict__ x,
                        const uint8_t* __restrict__ wpk,
                        float* __restrict__ y, int batch, int batch0,
                        int in_c, int out_c, int h, int w, int tiles_x,
                        Geo g, Taps taps, const float* __restrict__ demod,
                        const float* __restrict__ noise,
                        long long noise_bstride,
                        const float* __restrict__ bias) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ob = blockIdx.x;
  const int u0 = (blockIdx.y / tiles_x) * g.th;
  const int w0 = (blockIdx.y % tiles_x) * g.tw;
  const int bimg0 = blockIdx.z * g.nimg;
  const size_t hw = static_cast<size_t>(h) * w;
  const int nchunks = (in_c + kKc - 1) / kKc;
  const int npos = g.npos;
  const int xplane = g.xplane;
  const int otw = 2 * g.tw;
  // staged column c is input column w0 - 2 - lpad + c
  const int lpad = (w0 - 2) & 3;

  const uint32_t w_s = smem_u32(smem);
  const uint32_t xf_s = w_s + g.off_xf;
  const uint32_t xb_s = w_s + g.off_xb;
  const uint32_t bar_s = w_s + g.off_bar;
  const float* xf = reinterpret_cast<const float*>(smem + g.off_xf);
  uint8_t* xb = smem + g.off_xb;
  int* pos = reinterpret_cast<int*>(smem + g.off_pos);
  float* par = reinterpret_cast<float*>(smem + g.off_par);
  float* nz_s = par;                                 // [nimg][2 th][rc]
  float* dm_s = nz_s + g.nimg * 2 * g.th * g.rc;     // [nimg][64]
  float* bi_s = dm_s + g.nimg * kN;                  // [64]

  if (tid == 0) {
    for (int i = 0; i < kWStages; ++i) mbar_init(bar_s + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the epilogue's operands, by cp.async: the oldest group, waited for
  // after the K loop.  Without the epilogue the neutral ones (demod 1,
  // noise and bias 0, and below slope and gain 1: exact), so that the
  // column pass does not branch
  if (demod == nullptr) {
    for (int e = tid; e < g.nimg * 2 * g.th * g.rc; e += kThreads)
      nz_s[e] = 0.0f;
    for (int e = tid; e < (g.nimg + 1) * kN; e += kThreads)
      dm_s[e] = e < g.nimg * kN ? 1.0f : 0.0f;
  } else {
    const int ho = 2 * h, wo = 2 * w;
    for (int e = tid; e < g.nimg * 2 * g.th * g.rc; e += kThreads) {
      const int img = e / (2 * g.th * g.rc);
      const int r = (e / g.rc) % (2 * g.th);
      const int cc = e % g.rc;
      const int b = bimg0 + img;
      const int oy = 2 * u0 + r, ox = 2 * w0 + cc;
      const bool v = b < batch && oy < ho && ox < wo && cc < otw;
      const float* src = v ? noise + b * noise_bstride +
                                 static_cast<size_t>(oy) * wo + ox
                           : noise;
      cp_async4(smem_u32(nz_s + e), src, v);
    }
    for (int e = tid; e < (g.nimg + 1) * kN; e += kThreads) {
      const int img = e / kN;
      const int o = ob * kN + e % kN;
      const bool v = o < out_c && (img == g.nimg || bimg0 + img < batch);
      const float* src =
          !v ? bias
             : img == g.nimg
                   ? bias + o
                   : demod + static_cast<size_t>(bimg0 + img) * out_c + o;
      cp_async4(smem_u32(dm_s + e), src, v);
    }
  }
  cp_commit();
  if (!tma) {
    // staged position s -> its offset in a channel plane of the block's
    // first image (the image's channel planes further on), or -1 outside
    // the maps: staged row r, column c is input (u0 - 2 + r, w0 - 2 -
    // lpad + c)
    for (int s = tid; s < npos; s += kThreads) {
      const int img = s / xplane;
      const int r = (s / g.xw) % g.xh;
      const int c = s % g.xw;
      const int iy = u0 - 2 + r;
      const int ix = w0 - 2 - lpad + c;
      const bool inside = bimg0 + img < batch && iy >= 0 && iy < h &&
                          ix >= 0 && ix < w;
      pos[s] = inside ? img * in_c * static_cast<int>(hw) + iy * w + ix
                      : -1;
    }
  }
  __syncthreads();

  const float* xblk = x + static_cast<size_t>(bimg0) * in_c * hw;
  const uint8_t* wblk =
      wpk + static_cast<size_t>(ob) * nchunks * kWChunkBytes;

  // chunk c: its weights into stage c % 4 and its x, fp32 [image][channel]
  // [row][column] (the TMA box's order), into stage c % 2, both completing
  // on barrier c % 4 (x by cp.async where the map cannot be used)
  auto load_chunk = [&](int c) {
    const uint32_t bar = bar_s + 8 * (c & 3);
    const uint32_t xdst = xf_s + (c & 1) * g.xstage;
    if (tid == 0) {
      mbar_expect_tx(bar, kWChunkBytes + (tma ? kKc * npos * 4 : 0));
      bulk_load(w_s + (c & 3) * kWChunkBytes,
                wblk + static_cast<size_t>(c) * kWChunkBytes, kWChunkBytes,
                bar);
      if (tma)
        tma_load_4d(xdst, &xmap, w0 - 2 - lpad, u0 - 2, c * kKc,
                    batch0 + bimg0, bar);
    }
    if (!tma) {
      const int i0 = c * kKc;
      for (int k = warp; k < kKc; k += kThreads / 32) {
        const bool kin = i0 + k < in_c;
        const float* src = xblk + static_cast<size_t>(i0 + k) * hw;
        for (int s = lane; s < npos; s += 32) {
          const int o = pos[s];
          const bool v = kin && o >= 0;
          const int img = s / xplane;
          cp_async4(xdst + 4 * (s + (img * (kKc - 1) + k) * xplane),
                    v ? src + o : x, v);
        }
      }
    }
  };
  auto wait_chunk = [&](int c) {
    mbar_wait(bar_s + 8 * (c & 3), (c >> 2) & 1);
  };
  // chunk c's x -> bf16 [position][channel]; a thread rounds 8 channels of
  // one position and writes them as 16 bytes
  auto convert = [&](int c) {
    const float* xs = xf + (c & 1) * (g.xstage / 4);
    uint8_t* dst = xb + (c & 1) * npos * kXRowBytes;
    const int grp = warp & 3;
    for (int s = (warp >> 2) * 32 + lane; s < npos; s += 64) {
      const int img = g.nimg == 1 ? 0 : s / xplane;
      const float* src = xs + s + (img * (kKc - 1) + 8 * grp) * xplane;
      uint4 v;
      v.x = pack_bf16(src[0], src[xplane]);
      v.y = pack_bf16(src[2 * xplane], src[3 * xplane]);
      v.z = pack_bf16(src[4 * xplane], src[5 * xplane]);
      v.w = pack_bf16(src[6 * xplane], src[7 * xplane]);
      *reinterpret_cast<uint4*>(dst + s * kXRowBytes + 16 * grp) = v;
    }
  };

  // this lane's ldmatrix row: position m = 64 wg + 16 w4 + (lane & 15) of
  // the block, channels 8 (lane >> 4) .. + 7 of a 16-channel step.
  // Position m is (image, phase row lv, phase column lw); shift (1, 1)
  // reads staged (lv, lw + lpad).  Rows past the tile read position 0.
  const int wg = warp >> 2;
  const int w4 = warp & 3;
  int srow = 0;
  {
    const int m = wg * 64 + w4 * 16 + (lane & 15);
    if (m < g.m_valid) {
      const int rem = m % g.plane;
      srow = (m / g.plane) * xplane + (rem / g.pw) * g.xw + rem % g.pw +
             lpad;
    }
  }
  const uint32_t a_lane = xb_s + srow * kXRowBytes + 16 * (lane >> 4);
  const uint32_t xb_stage = npos * kXRowBytes;

  float acc[4][32];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.0f;
  uint32_t a0[4][4], a1[4][4];

  load_chunk(0);
  cp_commit();
  if (nchunks > 1) load_chunk(1);
  cp_commit();
  cp_wait<1>();
  wait_chunk(0);
  __syncthreads();
  convert(0);
  __syncthreads();
  if (nchunks > 2) load_chunk(2);
  cp_commit();

  for (int c = 0; c < nchunks; ++c) {
    const uint32_t xa = a_lane + (c & 1) * xb_stage;
    const uint32_t wa = w_s + (c & 3) * kWChunkBytes;
    wgmma_wait<1>();            // a0's last wgmma group is done
    load_a(a0, xa, g.xw);
    mma_step(acc, a0, wa);
    wgmma_wait<1>();            // a1's, and every group of chunk c - 1
    load_a(a1, xa + 32, g.xw);
    mma_step(acc, a1, wa + 2 * kLbo);
    if (c + 1 < nchunks) {
      cp_wait<1>();             // chunk c + 1 has landed
      wait_chunk(c + 1);
      __syncthreads();
      convert(c + 1);
      __syncthreads();          // its x stage is free, chunk c - 1's too
      if (c + 3 < nchunks) load_chunk(c + 3);
      cp_commit();
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);
  cp_wait<0>();
  __syncthreads();   // the ring is free: it becomes the blur's buffers

  // every channel's phase signals, interleaved: plane ci = ch * nimg +
  // img, local row 2 lv + py is pre-blur row 2 (u0 - 1) + 2 lv + py.  All
  // accumulators go first, which frees their registers for the blur
  float* ps = reinterpret_cast<float*>(smem);   // [kN nimg][pst]
  float* rs = ps + kN * g.nimg * g.pst;         // [kCC nimg][rr][rc]
  const int ho = 2 * h;
  const int wo = 2 * w;
  const int rows = min(2 * g.th, ho - 2 * u0);
  // accumulator i of phase p: position 64 wg + 16 w4 + lane / 4 + 8 ((i
  // >> 1) & 1), channel 8 (i >> 2) + 2 (lane & 3) + (i & 1)
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int m = wg * 64 + w4 * 16 + (lane >> 2) + 8 * hf;
    if (m < g.m_valid) {
      const int img = m / g.plane;
      const int lv = (m % g.plane) / g.pw;
      const int lw = m % g.pw;
      float* dst = ps + img * g.pst + 2 * lv * g.pc + 2 * lw + 3;
#pragma unroll
      for (int nb = 0; nb < kN / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ch = nb * 8 + 2 * (lane & 3) + e;
          const int i = nb * 4 + 2 * hf + e;
          float* d = dst + ch * g.nimg * g.pst;
#pragma unroll
          for (int p = 0; p < 4; ++p)
            d[(p >> 1) * g.pc + (p & 1)] = acc[p][i];
        }
    }
  }
  __syncthreads();
  const float t0 = taps.v[0], t1 = taps.v[1], t2 = taps.v[2],
              t3 = taps.v[3];
  const float slope = demod != nullptr ? 0.2f : 1.0f;
  const float gain = demod != nullptr ? 1.41421356237309515f : 1.0f;
  const int planes = kCC * g.nimg;
  // the row pass's thread layout: a group of 4 columns and a first row
  const int row_step = kThreads / g.cg;
  const int row_threads = row_step * g.cg;
  const int row_grp = tid % g.cg;
  const int row_q0 = tid / g.cg;
  const int row_ci0 = row_q0 / g.rr;
  const int row_lr0 = row_q0 - row_ci0 * g.rr;
  // output rows of the block start 16-byte aligned where w and w0 are even
  const bool vec_out = (w & 1) == 0 && (w0 & 1) == 0;
  const int cols = min(otw, wo - 2 * w0);
  for (int round = 0; round < kN / kCC; ++round) {
    const float* psr = ps + round * planes * g.pst;
    // rows: output column c reads phase columns c + 1 .. c + 4 (stored at
    // + 3).  An item is a group of 4 outputs of a row: two aligned float4
    // reads, one float4 write.  A thread keeps its group and walks the
    // rows of all planes (no division an item), 2 items in step
    if (tid < row_threads) {
      const int nq = planes * g.rr;
      int q = row_q0, ci = row_ci0, lr = row_lr0;
      for (; q < nq; q += 2 * row_step) {
        const int qb = q + row_step;
        int cib = ci, lrb = lr + row_step;
        while (lrb >= g.rr) {
          lrb -= g.rr;
          ++cib;
        }
        const bool okb = qb < nq;
        const float4* sa = reinterpret_cast<const float4*>(
            psr + ci * g.pst + (lr + 1) * g.pc + 4 * row_grp + 4);
        const float4* sb = reinterpret_cast<const float4*>(
            psr + (okb ? cib : ci) * g.pst + ((okb ? lrb : lr) + 1) * g.pc +
            4 * row_grp + 4);
        const float4 a0 = sa[0], a1 = sa[1], b0 = sb[0], b1 = sb[1];
        float4 va, vb;
        va.x = fmaf(t3, a0.w, fmaf(t2, a0.z, fmaf(t1, a0.y, t0 * a0.x)));
        va.y = fmaf(t3, a1.x, fmaf(t2, a0.w, fmaf(t1, a0.z, t0 * a0.y)));
        va.z = fmaf(t3, a1.y, fmaf(t2, a1.x, fmaf(t1, a0.w, t0 * a0.z)));
        va.w = fmaf(t3, a1.z, fmaf(t2, a1.y, fmaf(t1, a1.x, t0 * a0.w)));
        vb.x = fmaf(t3, b0.w, fmaf(t2, b0.z, fmaf(t1, b0.y, t0 * b0.x)));
        vb.y = fmaf(t3, b1.x, fmaf(t2, b0.w, fmaf(t1, b0.z, t0 * b0.y)));
        vb.z = fmaf(t3, b1.y, fmaf(t2, b1.x, fmaf(t1, b0.w, t0 * b0.z)));
        vb.w = fmaf(t3, b1.z, fmaf(t2, b1.y, fmaf(t1, b1.x, t0 * b0.w)));
        *reinterpret_cast<float4*>(rs + (ci * g.rr + lr) * g.rc +
                                   4 * row_grp) = va;
        if (okb) {
          *reinterpret_cast<float4*>(rs + (cib * g.rr + lrb) * g.rc +
                                     4 * row_grp) = vb;
        }
        lr = lrb + row_step;
        ci = cib;
        while (lr >= g.rr) {
          lr -= g.rr;
          ++ci;
        }
      }
    }
    __syncthreads();
    // columns: output row r reads row-pass rows r .. r + 3.  An item is a
    // group of 4 output columns of a plane, slid down with float4 reads;
    // then the epilogue (its operands in shared memory) and streaming
    // writes, float4 where the row is aligned
    const int col_items = planes * g.cg;
    for (int it = tid; it < col_items; it += kThreads) {
      const int ci = it / g.cg;
      const int grp = it - ci * g.cg;
      const int cl = round * kCC + ci / g.nimg;
      const int o = ob * kN + cl;
      const int img = ci % g.nimg;
      const size_t bb = bimg0 + img;
      const int c0 = 4 * grp;
      if (o >= out_c || bb >= static_cast<size_t>(batch) || c0 >= cols)
        continue;
      const int rq = g.rc >> 2;
      const float4* src =
          reinterpret_cast<const float4*>(rs + ci * g.rr * g.rc) + grp;
      const float4* nz =
          reinterpret_cast<const float4*>(nz_s + img * 2 * g.th * g.rc) + grp;
      float* dst = y + ((bb * out_c + o) * ho + 2 * u0) *
                           static_cast<size_t>(wo) + 2 * w0 + c0;
      const float dm = dm_s[img * kN + cl];
      const float bi = bi_s[cl];
      const bool full = vec_out && c0 + 4 <= cols;
      float4 s0 = src[0], s1 = src[rq], s2 = src[2 * rq];
      for (int r = 0; r < rows; ++r) {
        const float4 s3 = src[(r + 3) * rq];
        const float4 n = nz[r * rq];
        float4 v;
        v.x = fmaf(t3, s3.x, fmaf(t2, s2.x, fmaf(t1, s1.x, t0 * s0.x)));
        v.y = fmaf(t3, s3.y, fmaf(t2, s2.y, fmaf(t1, s1.y, t0 * s0.y)));
        v.z = fmaf(t3, s3.z, fmaf(t2, s2.z, fmaf(t1, s1.z, t0 * s0.z)));
        v.w = fmaf(t3, s3.w, fmaf(t2, s2.w, fmaf(t1, s1.w, t0 * s0.w)));
        s0 = s1;
        s1 = s2;
        s2 = s3;
        v.x = fmaf(v.x, dm, n.x) + bi;
        v.y = fmaf(v.y, dm, n.y) + bi;
        v.z = fmaf(v.z, dm, n.z) + bi;
        v.w = fmaf(v.w, dm, n.w) + bi;
        v.x = gain * (v.x >= 0.0f ? v.x : slope * v.x);
        v.y = gain * (v.y >= 0.0f ? v.y : slope * v.y);
        v.z = gain * (v.z >= 0.0f ? v.z : slope * v.z);
        v.w = gain * (v.w >= 0.0f ? v.w : slope * v.w);
        float* d = dst + static_cast<size_t>(r) * wo;
        if (full) {
          __stcs(reinterpret_cast<float4*>(d), v);
        } else {
          if (c0 < cols) __stcs(d, v.x);
          if (c0 + 1 < cols) __stcs(d + 1, v.y);
          if (c0 + 2 < cols) __stcs(d + 2, v.z);
          if (c0 + 3 < cols) __stcs(d + 3, v.w);
        }
      }
    }
    __syncthreads();   // the next round overwrites the row-pass buffer
  }
}

// cuTensorMapEncodeTiled through the runtime's driver entry point: the
// library need not link libcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  static bool looked = false;
  if (!looked) {
    looked = true;
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

}  // namespace

// Launches K1's one-pass bf16 mode on x (batch, in_c, h, w) into y (batch,
// out_c, 2h, 2w).  wpk holds the correlation taps rounded to bf16 and
// packed by ops/upconv_blur.py::pack_weights_bf16 (ceil(out_c / 64) x
// ceil(in_c / 32) chunks of 9 B tiles); taps4 (host memory) the flipped
// 1-D blur taps with the gain.  With demod != nullptr the epilogue runs:
// demod (batch, out_c), noise (batch or 1, 2h, 2w) with the given batch
// stride (0 broadcasts one map), bias (out_c).  The tile (nimg, th, tw)
// comes from ops/upconv_blur.py::_plan_bf16.  x is staged by TMA where w is
// a multiple of 4 and x 16-byte aligned, else by cp.async.  Returns a CUDA
// error code: that of cudaFuncSetAttribute or of the tensor map's encoding
// where they fail, else cudaGetLastError() after the launches; does not
// synchronise.
extern "C" int upconv_blur_bf16_f32(const float* x, const void* wpk,
                                    float* y, int batch, int in_c,
                                    int out_c, int h, int w,
                                    const float* taps4, const float* demod,
                                    const float* noise,
                                    long long noise_bstride,
                                    const float* bias, int nimg, int th,
                                    int tw, cudaStream_t stream) {
  if (batch < 1 || in_c < 1 || out_c < 1 || h < 1 || w < 1 || nimg < 1 ||
      th < 1 || tw < 1 || (nimg > 1 && (th != h || tw != w))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geo g = geometry(nimg, th, tw);
  if (g.m_valid > kRows || g.smem > kMaxSmem ||
      static_cast<long long>(nimg - 1) * in_c * h * w +
              static_cast<long long>(h) * w > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool smem_raised = false;
  if (g.smem > 48 * 1024 && !smem_raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        upconv_blur_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_raised = true;
  }
  // x's tensor map: (w, h, in_c, batch), the box a chunk of a tile
  CUtensorMap xmap = {};
  int tma = 0;
  const EncodeTiled encode = encode_tiled();
  if (encode != nullptr && w % 4 == 0 &&
      reinterpret_cast<uintptr_t>(x) % 16 == 0) {
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(w),
                                static_cast<cuuint64_t>(h),
                                static_cast<cuuint64_t>(in_c),
                                static_cast<cuuint64_t>(batch)};
    const cuuint64_t strides[3] = {
        static_cast<cuuint64_t>(w) * 4, static_cast<cuuint64_t>(h) * w * 4,
        static_cast<cuuint64_t>(in_c) * h * w * 4};
    const cuuint32_t box[4] = {static_cast<cuuint32_t>(g.xw),
                               static_cast<cuuint32_t>(g.xh),
                               static_cast<cuuint32_t>(kKc),
                               static_cast<cuuint32_t>(nimg)};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    const CUresult r = encode(
        &xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(x),
        dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
    tma = 1;
  }
  const int tiles_y = (h + th - 1) / th;
  const int tiles_x = (w + tw - 1) / tw;
  const long long tiles = static_cast<long long>(tiles_y) * tiles_x;
  const int oblocks = (out_c + kN - 1) / kN;
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
    upconv_blur_bf16_kernel<<<grid, kThreads, g.smem, stream>>>(
        xmap, tma, x + b0 * in_plane, static_cast<const uint8_t*>(wpk),
        y + b0 * out_plane, nb, static_cast<int>(b0), in_c, out_c, h, w,
        tiles_x, g, taps, dm, nz, noise_bstride, bias);
  }
  return static_cast<int>(cudaGetLastError());
}

// JPEG decoding on the host: ITU T.81 with Huffman coding and 8-bit samples,
// equal bit for bit to what libjpeg-turbo gives with its default
// decompression settings (PIL's Image.open(...).convert("RGB") of a JPEG).
//
// The port's counterpart of the JAX package's PIL fallback for files that
// are not PNG (its native/__init__.py:168-180).  Host C++ with a
// plain extern "C" interface and no PyTorch or CUDA header; built with the
// host compiler by _native_build.py and called through ctypes, which releases
// the GIL for the call.  Nothing is global: every decode owns its state, so
// any number of threads decode at once.
//
// What it reads:
//   frames   baseline (SOF0), extended sequential (SOF1), progressive (SOF2)
//            with spectral selection, successive approximation and EOB runs;
//   entropy  Huffman tables (DHT), redefined between scans; a scan's tables
//            missing at the first SOS take the standard ones of Annex K.3,
//            as libjpeg does for motion-JPEG frames;
//   tables   8- and 16-bit quantization tables; a component keeps the table
//            it had at its first scan (libjpeg's latch_quant_tables);
//   restarts DRI with RSTn markers;
//   sizes    1..65535 in either dimension, partial MCUs at the edges;
//   colour   one component (grey) or three: YCbCr, or RGB when the JFIF,
//            Adobe-transform, component-ID rule of libjpeg's
//            default_decompress_parms says so;
//   sampling each component at 1x1, 2x1 or 2x2 below the largest factors
//            (4:4:4, 4:2:2, 4:2:0).
// Anything else returns a negative code: arithmetic coding, lossless and
// hierarchical frames, precisions other than 8, component counts other
// than 1 or 3 (CMYK, YCCK), other sampling ratios, a zero dimension (DNL),
// a progressive file whose scans leave a coefficient that libjpeg's block
// smoothing reads unrefined, and a truncated or corrupt stream.
//
// The arithmetic is libjpeg-turbo's, step for step:
//   IDCT      jpeg_idct_islow (jidctint.c: CONST_BITS 13, PASS1_BITS 2) in
//             the 16-bit lanes of its x86 SIMD version, which PIL runs (see
//             idct_islow: equal to jidctint.c wherever values stay in range);
//   upsample  jdsample.c h2v1_fancy_upsample and h2v2_fancy_upsample (biases
//             +1/+2 and +8/+7, edge columns replicated), the rows above the
//             first and below the last replicated as jdmainct.c's context
//             rows do; plain replication when a component is at most two
//             samples wide (jinit_upsampler's condition);
//   colour    jdcolor.c ycc_rgb_convert with 16-bit fixed-point tables.
// Each coefficient is kept for the whole image (H*W*comps*2 bytes after
// subsampling), then transformed and converted once every scan is read.
//
// API:
//   int jpeg_get_info(const uint8_t* buf, long len, int* w, int* h,
//                     int* comps)   0, or a negative code (JpegError);
//   int jpeg_decode(const uint8_t* buf, long len, uint8_t* out)
//       writes (h, w, comps) uint8: comps 1 (grey) or 3 (RGB).

#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>

namespace {

enum JpegError {
  kOk = 0,
  kNotJpeg = -1,
  kTruncated = -2,
  kCorrupt = -3,
  kBadHuffmanTable = -4,
  kBadHuffmanCode = -5,
  kNoQuantTable = -6,
  kArithmetic = -7,
  kLossless = -8,
  kPrecision = -9,
  kComponents = -10,
  kSampling = -11,
  kEmpty = -12,
  kBadScan = -13,
  kSmoothing = -14,
  kNoMemory = -15,
  kRestart = -16,
  kNoFrame = -17,
  kNoHuffmanTable = -18,
};

// Zigzag position -> natural position, with 16 extra entries of 63 so that
// a run in corrupt data that passes 63 lands on a real coefficient (as
// libjpeg's jpeg_natural_order does).
constexpr int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// Annex K.3's tables (libjpeg's jstdhuff.c), counts for lengths 1..16.
constexpr uint8_t kStdDcLumBits[16] = {0, 1, 5, 1, 1, 1, 1, 1,
                                       1, 0, 0, 0, 0, 0, 0, 0};
constexpr uint8_t kStdDcChromBits[16] = {0, 3, 1, 1, 1, 1, 1, 1,
                                         1, 1, 1, 0, 0, 0, 0, 0};
constexpr uint8_t kStdDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
constexpr uint8_t kStdAcLumBits[16] = {0, 2, 1, 3, 3, 2, 4, 3,
                                       5, 5, 4, 4, 0, 0, 1, 0x7d};
constexpr uint8_t kStdAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
constexpr uint8_t kStdAcChromBits[16] = {0, 2, 1, 2, 4, 4, 3, 4,
                                         7, 5, 4, 4, 0, 1, 2, 0x77};
constexpr uint8_t kStdAcChromVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

constexpr int kLookahead = 9;  // libjpeg's HUFF_LOOKAHEAD

struct HuffSpec {  // a DHT table as read
  bool defined = false;
  uint8_t bits[17] = {};  // bits[l]: codes of length l
  uint8_t val[256] = {};
};

struct HuffTable {  // libjpeg's d_derived_tbl
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint16_t look[1 << kLookahead];  // (length << 8) | symbol; 0: longer code
  uint8_t val[256];
};

struct QuantSpec {
  bool defined = false;
  uint16_t q[64] = {};  // natural order
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dw = 0, dh = 0;    // samples after subsampling
  int wib = 0, hib = 0;  // blocks holding them
  int bw = 0, bh = 0;    // blocks kept (whole MCUs)
  bool latched = false;
  int16_t qt[64] = {};   // the table latched at its first scan, natural order
  int coef_bits[64];     // progression status (libjpeg's coef_bits)
  int16_t* coef = nullptr;
  uint8_t* plane = nullptr;  // bw*8 x bh*8 samples after the IDCT
};

// Bits of one entropy-coded segment, MSB first.  At a marker or the end of
// the data it appends zero bits and counts them; taking one of them means
// the data ran out before the scan did.
struct BitReader {
  const uint8_t* data;
  size_t len, pos;
  uint64_t acc = 0;
  int nbits = 0;  // valid bits at the top of acc, padding included
  int pad = 0;    // zero bits appended past the data
  bool hit = false;
  bool overrun = false;

  void fill() {
    while (nbits <= 56) {
      uint32_t c = 0;
      if (hit) {
        pad += 8;
      } else if (pos >= len) {
        hit = true;
        continue;
      } else if (data[pos] != 0xFF) {
        c = data[pos++];
      } else {
        size_t q = pos + 1;
        while (q < len && data[q] == 0xFF) q++;
        if (q < len && data[q] == 0x00) {
          c = 0xFF;  // a stuffed byte
          pos = q + 1;
        } else {
          hit = true;  // a marker: left for the caller at pos
          continue;
        }
      }
      acc |= static_cast<uint64_t>(c) << (56 - nbits);
      nbits += 8;
    }
  }
  void reset() {
    acc = 0;
    nbits = pad = 0;
    hit = false;
  }
  uint32_t peek(int n) {  // 1 <= n <= 32
    if (nbits < n) fill();
    return static_cast<uint32_t>(acc >> (64 - n));
  }
  void skip(int n) {
    acc <<= n;
    nbits -= n;
    if (nbits < pad) overrun = true;
  }
  int bits(int n) {  // 0 <= n <= 16
    if (n == 0) return 0;
    int v = static_cast<int>(peek(n));
    skip(n);
    return v;
  }
  // Huffman symbol (libjpeg's HUFF_DECODE); -1 for a code that is in no
  // table (longer than 16 bits)
  int decode(const HuffTable& t) {
    uint32_t b = peek(16);
    int e = t.look[b >> (16 - kLookahead)];
    if (e) {
      skip(e >> 8);
      return e & 0xFF;
    }
    for (int l = kLookahead + 1; l <= 16; l++) {
      int32_t code = static_cast<int32_t>(b >> (16 - l));
      if (code <= t.maxcode[l]) {
        skip(l);
        return t.val[(code + t.valoffset[l]) & 0xFF];
      }
    }
    return -1;
  }
};

inline int extend(int r, int s) {  // libjpeg's HUFF_EXTEND
  return r < (1 << (s - 1)) ? r - (1 << s) + 1 : r;
}

// libjpeg's jpeg_make_d_derived_tbl, with its checks
int build_huffman(const HuffSpec& s, bool dc, HuffTable* t) {
  if (!s.defined) return kNoHuffmanTable;
  uint8_t size[257];
  uint32_t code[257];
  int p = 0;
  for (int l = 1; l <= 16; l++) {
    int i = s.bits[l];
    if (p + i > 256) return kBadHuffmanTable;
    while (i--) size[p++] = static_cast<uint8_t>(l);
  }
  size[p] = 0;
  const int n = p;
  uint32_t c = 0;
  int si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) code[p++] = c++;
    if (c >= (1u << si)) return kBadHuffmanTable;
    c <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (s.bits[l]) {
      t->valoffset[l] = p - static_cast<int32_t>(code[p]);
      p += s.bits[l];
      t->maxcode[l] = static_cast<int32_t>(code[p - 1]);
    } else {
      t->valoffset[l] = 0;
      t->maxcode[l] = -1;
    }
  }
  t->valoffset[17] = 0;
  t->maxcode[17] = 0xFFFFF;
  std::memset(t->look, 0, sizeof t->look);
  p = 0;
  for (int l = 1; l <= kLookahead; l++) {
    for (int i = 1; i <= s.bits[l]; i++, p++) {
      int look = static_cast<int>(code[p]) << (kLookahead - l);
      for (int k = 1 << (kLookahead - l); k > 0; k--)
        t->look[look++] = static_cast<uint16_t>((l << 8) | s.val[p]);
    }
  }
  if (dc) {
    for (int i = 0; i < n; i++)
      if (s.val[i] > 15) return kBadHuffmanTable;
  }
  std::memcpy(t->val, s.val, sizeof t->val);
  return kOk;
}

void set_standard(HuffSpec* s, const uint8_t* bits, const uint8_t* vals,
                  int n) {
  if (s->defined) return;
  s->defined = true;
  std::memcpy(s->bits + 1, bits, 16);
  std::memset(s->val, 0, sizeof s->val);
  std::memcpy(s->val, vals, n);
}

// ---- IDCT: libjpeg-turbo's SIMD jpeg_idct_islow ------------------------------
//
// jidctint.c's algorithm (CONST_BITS 13, PASS1_BITS 2, columns then rows)
// in the arithmetic of simd/x86_64/jidctint-{sse2,avx2}.asm, which is what
// PIL runs on x86-64: 16-bit lanes, so the dequantized coefficients and
// the sums in0 + in4, in0 - in4, in7 + in3 and in5 + in1 wrap at 16 bits,
// the products and their sums are 32-bit (pmaddwd; the multiplications of
// jidctint.c folded into pairs of constants), each pass's outputs saturate
// at 16 bits and the samples at 0 and 255.  On every block whose values
// stay in range this is jidctint.c's result exactly; on a block that
// overshoots (a corrupt or crafted quantization table) it is still PIL's,
// where jidctint.c's range-limit table would wrap.

inline int16_t wrap16(int32_t x) { return static_cast<int16_t>(x); }
inline int16_t sat16(int32_t x) {
  return static_cast<int16_t>(x < -32768 ? -32768 : x > 32767 ? 32767 : x);
}
inline int32_t add32(int32_t a, int32_t b) {  // paddd: wraps
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}
inline int32_t sub32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}
inline int32_t madd(int16_t a, int32_t ca, int16_t b, int32_t cb) {  // pmaddwd
  return add32(a * ca, b * cb);
}

// One 1-D pass over 8 int16 values: the even and odd parts as the SIMD
// code computes them; returns the 8 int32 sums before the descale.  With
// F(x) = FIX(x) = round(x * 8192): 10703 = F(0.541196100) + F(0.765366865),
// 4433 = F(0.541196100), -10704 = F(0.541196100) - F(1.847759065), 9633 =
// F(1.175875602), -6436 = 9633 - F(1.961570560), 6437 = 9633 -
// F(0.390180644), -7373 = -F(0.899976223), -4927 = F(0.298631336) - 7373,
// 4926 = F(1.501321110) - 7373, -20995 = -F(2.562915447), -4176 =
// F(2.053119869) - 20995, 4177 = F(3.072711026) - 20995.
inline void pass(const int16_t* in, int32_t* out) {
  int32_t tmp3 = madd(in[2], 10703, in[6], 4433);
  int32_t tmp2 = madd(in[2], 4433, in[6], -10704);
  int32_t t0 = static_cast<int32_t>(static_cast<uint32_t>(
      static_cast<int32_t>(wrap16(in[0] + in[4]))) << 13);
  int32_t t1 = static_cast<int32_t>(static_cast<uint32_t>(
      static_cast<int32_t>(wrap16(in[0] - in[4]))) << 13);
  int32_t tmp10 = add32(t0, tmp3), tmp13 = sub32(t0, tmp3);
  int32_t tmp11 = add32(t1, tmp2), tmp12 = sub32(t1, tmp2);
  int16_t z3 = wrap16(in[7] + in[3]), z4 = wrap16(in[5] + in[1]);
  int32_t z3o = madd(z3, -6436, z4, 9633);
  int32_t z4o = madd(z3, 9633, z4, 6437);
  int32_t o0 = add32(madd(in[7], -4927, in[1], -7373), z3o);
  int32_t o3 = add32(madd(in[7], -7373, in[1], 4926), z4o);
  int32_t o1 = add32(madd(in[5], -4176, in[3], -20995), z4o);
  int32_t o2 = add32(madd(in[5], -20995, in[3], 4177), z3o);
  out[0] = add32(tmp10, o3);
  out[7] = sub32(tmp10, o3);
  out[1] = add32(tmp11, o2);
  out[6] = sub32(tmp11, o2);
  out[2] = add32(tmp12, o1);
  out[5] = sub32(tmp12, o1);
  out[3] = add32(tmp13, o0);
  out[4] = sub32(tmp13, o0);
}

void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out,
                size_t stride) {
  int16_t deq[64], ws[64];
  bool ac_zero = true;  // rows 1-7 all zero: every column is its DC alone
  for (int i = 0; i < 64; i++) {
    deq[i] = wrap16(in[i] * q[i]);
    if (i >= 8 && in[i]) ac_zero = false;
  }
  if (ac_zero) {
    for (int c = 0; c < 8; c++) {
      int16_t v = wrap16(deq[c] * 4);
      for (int r = 0; r < 8; r++) ws[8 * r + c] = v;
    }
  } else {
    for (int c = 0; c < 8; c++) {
      int16_t col[8];
      int32_t s[8];
      for (int k = 0; k < 8; k++) col[k] = deq[8 * k + c];
      pass(col, s);
      for (int k = 0; k < 8; k++)
        ws[8 * k + c] = sat16(add32(s[k], 1 << 10) >> 11);
    }
  }
  for (int r = 0; r < 8; r++) {
    int32_t s[8];
    pass(ws + 8 * r, s);
    uint8_t* op = out + r * stride;
    for (int k = 0; k < 8; k++) {
      int v = sat16(add32(s[k], 1 << 17) >> 18);
      v = v < -128 ? -128 : v > 127 ? 127 : v;
      op[k] = static_cast<uint8_t>(v + 128);
    }
  }
}

// ---- upsampling: jdsample.c ------------------------------------------------

void h2v1_fancy(const uint8_t* in, int dw, uint8_t* out) {  // dw > 2
  int x = in[0];
  out[0] = static_cast<uint8_t>(x);
  out[1] = static_cast<uint8_t>((x * 3 + in[1] + 2) >> 2);
  for (int i = 1; i < dw - 1; i++) {
    x = in[i] * 3;
    out[2 * i] = static_cast<uint8_t>((x + in[i - 1] + 1) >> 2);
    out[2 * i + 1] = static_cast<uint8_t>((x + in[i + 1] + 2) >> 2);
  }
  x = in[dw - 1];
  out[2 * dw - 2] = static_cast<uint8_t>((x * 3 + in[dw - 2] + 1) >> 2);
  out[2 * dw - 1] = static_cast<uint8_t>(x);
}

// in0: the nearer input row, in1: the one above (even output rows) or
// below (odd)
void h2v2_fancy(const uint8_t* in0, const uint8_t* in1, int dw,
                uint8_t* out) {  // dw > 2
  int cur = in0[0] * 3 + in1[0];
  int next = in0[1] * 3 + in1[1];
  out[0] = static_cast<uint8_t>((cur * 4 + 8) >> 4);
  out[1] = static_cast<uint8_t>((cur * 3 + next + 7) >> 4);
  int last = cur;
  cur = next;
  for (int i = 2; i < dw; i++) {
    next = in0[i] * 3 + in1[i];
    out[2 * i - 2] = static_cast<uint8_t>((cur * 3 + last + 8) >> 4);
    out[2 * i - 1] = static_cast<uint8_t>((cur * 3 + next + 7) >> 4);
    last = cur;
    cur = next;
  }
  out[2 * dw - 2] = static_cast<uint8_t>((cur * 3 + last + 8) >> 4);
  out[2 * dw - 1] = static_cast<uint8_t>((cur * 4 + 7) >> 4);
}

void replicate2(const uint8_t* in, int dw, uint8_t* out) {
  for (int i = 0; i < dw; i++) out[2 * i] = out[2 * i + 1] = in[i];
}

inline uint8_t clamp255(int x) {
  return static_cast<uint8_t>(x < 0 ? 0 : x > 255 ? 255 : x);
}

// ---- the decoder ------------------------------------------------------------

struct Scan {
  int n = 0;
  int comp[4] = {};  // component indices
  int td[4] = {}, ta[4] = {};
  int ss = 0, se = 63, ah = 0, al = 0;
};

struct Decoder {
  const uint8_t* data;
  size_t len;
  size_t pos = 0;
  HuffSpec dc_spec[4], ac_spec[4];
  QuantSpec qspec[4];
  int restart_interval = 0;
  bool saw_sof = false, progressive = false;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = 0;
  bool rgb = false;  // three components stored as RGB
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  int mcux = 0, mcuy = 0;  // MCUs of an interleaved scan
  Component comp[4];
  int scans = 0;
  bool single_pass = false;

  Decoder(const uint8_t* d, size_t n) : data(d), len(n) {}
  ~Decoder() {
    for (auto& c : comp) {
      std::free(c.coef);
      std::free(c.plane);
    }
  }

  int segment(size_t* start, size_t* n) {
    if (pos + 2 > len) return kTruncated;
    size_t l = (static_cast<size_t>(data[pos]) << 8) | data[pos + 1];
    if (l < 2) return kCorrupt;
    if (pos + l > len) return kTruncated;
    *start = pos + 2;
    *n = l - 2;
    pos += l;
    return kOk;
  }

  // libjpeg's next_marker: bytes that are not a marker are skipped
  int next_marker(size_t* p, int* marker) const {
    size_t i = *p;
    for (;;) {
      while (i < len && data[i] != 0xFF) i++;
      while (i < len && data[i] == 0xFF) i++;
      if (i >= len) return kTruncated;
      int c = data[i++];
      if (c != 0) {
        *marker = c;
        *p = i;
        return kOk;
      }
    }
  }

  int read_sof(int marker) {
    size_t s, n;
    int e = segment(&s, &n);
    if (e) return e;
    if (saw_sof) return kCorrupt;
    saw_sof = true;
    if (n < 6) return kCorrupt;
    const uint8_t* d = data + s;
    if (d[0] != 8) return kPrecision;
    height = (d[1] << 8) | d[2];
    width = (d[3] << 8) | d[4];
    ncomp = d[5];
    if (height == 0 || width == 0 || ncomp == 0) return kEmpty;
    if (n != 6 + 3 * static_cast<size_t>(ncomp)) return kCorrupt;
    if (ncomp != 1 && ncomp != 3) return kComponents;
    progressive = marker == 0xC2;
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.id = d[6 + 3 * i];
      c.h = d[7 + 3 * i] >> 4;
      c.v = d[7 + 3 * i] & 15;
      c.tq = d[8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) return kSampling;
      for (int j = 0; j < i; j++)
        if (comp[j].id == c.id) return kCorrupt;
      if (c.h > hmax) hmax = c.h;
      if (c.v > vmax) vmax = c.v;
    }
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      if (hmax % c.h || vmax % c.v) return kSampling;
      int rh = hmax / c.h, rv = vmax / c.v;
      if (!((rh == 1 && rv == 1) || (rh == 2 && rv == 1) ||
            (rh == 2 && rv == 2)))
        return kSampling;
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.dw = static_cast<int>((static_cast<int64_t>(width) * c.h + hmax - 1) /
                              hmax);
      c.dh = static_cast<int>((static_cast<int64_t>(height) * c.v + vmax - 1) /
                              vmax);
      c.wib = (c.dw + 7) / 8;
      c.hib = (c.dh + 7) / 8;
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      for (int k = 0; k < 64; k++) c.coef_bits[k] = -1;
    }
    return kOk;
  }

  int read_dht() {
    size_t s, n;
    int e = segment(&s, &n);
    if (e) return e;
    const uint8_t* d = data + s;
    size_t i = 0;
    while (i < n) {
      if (n - i < 17) return kBadHuffmanTable;
      int index = d[i];
      int tc = index >> 4, th = index & 15;
      if (tc > 1 || th > 3) return kBadHuffmanTable;
      HuffSpec& h = tc ? ac_spec[th] : dc_spec[th];
      h.bits[0] = 0;
      int count = 0;
      for (int l = 1; l <= 16; l++) count += h.bits[l] = d[i + l];
      i += 17;
      if (count > 256 || static_cast<size_t>(count) > n - i)
        return kBadHuffmanTable;
      std::memset(h.val, 0, sizeof h.val);
      std::memcpy(h.val, d + i, count);
      i += count;
      h.defined = true;
    }
    return kOk;
  }

  int read_dqt() {
    size_t s, n;
    int e = segment(&s, &n);
    if (e) return e;
    const uint8_t* d = data + s;
    size_t i = 0;
    while (i < n) {
      int pq = d[i] >> 4, tq = d[i] & 15;
      i++;
      if (tq > 3) return kCorrupt;
      QuantSpec& q = qspec[tq];
      size_t count = 64;
      size_t left = n - i;
      if (left < (pq ? 128u : 64u)) {  // libjpeg fills a short table with 1s
        for (int k = 0; k < 64; k++) q.q[k] = 1;
        count = pq ? left >> 1 : left;
      }
      for (size_t k = 0; k < count; k++) {
        uint16_t v = pq ? static_cast<uint16_t>((d[i] << 8) | d[i + 1])
                        : d[i];
        i += pq ? 2 : 1;
        q.q[kNatural[k]] = v;
      }
      q.defined = true;
      if (count < 64) break;
    }
    return kOk;
  }

  int read_dri() {
    size_t s, n;
    int e = segment(&s, &n);
    if (e) return e;
    if (n != 2) return kCorrupt;
    restart_interval = (data[s] << 8) | data[s + 1];
    return kOk;
  }

  int read_app(int marker) {
    size_t s, n;
    int e = segment(&s, &n);
    if (e) return e;
    const uint8_t* d = data + s;
    if (marker == 0xE0 && n >= 14 && std::memcmp(d, "JFIF", 5) == 0)
      saw_jfif = true;
    if (marker == 0xEE && n >= 12 && std::memcmp(d, "Adobe", 5) == 0) {
      saw_adobe = true;
      adobe_transform = d[11];
    }
    return kOk;
  }

  // libjpeg's default_decompress_parms for three components
  void choose_colour_space() {
    if (ncomp != 3) return;
    if (saw_jfif)
      rgb = false;
    else if (saw_adobe)
      rgb = adobe_transform == 0;
    else
      rgb = comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B';
  }

  int allocate() {
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      size_t blocks = static_cast<size_t>(c.bw) * c.bh;
      c.coef = static_cast<int16_t*>(std::calloc(blocks, 64 * sizeof(int16_t)));
      if (!c.coef) return kNoMemory;
    }
    return kOk;
  }

  int read_sos(Scan* sc) {
    size_t s, n;
    int e = segment(&s, &n);
    if (e) return e;
    if (!saw_sof) return kNoFrame;
    const uint8_t* d = data + s;
    if (n < 1) return kCorrupt;
    sc->n = d[0];
    if (sc->n < 1 || sc->n > 4 || n != 4 + 2 * static_cast<size_t>(sc->n))
      return kCorrupt;
    for (int i = 0; i < sc->n; i++) {
      int id = d[1 + 2 * i];
      int ci = -1;
      for (int j = 0; j < ncomp; j++)
        if (comp[j].id == id) ci = j;
      if (ci < 0) return kBadScan;
      for (int j = 0; j < i; j++)
        if (sc->comp[j] == ci) return kBadScan;
      sc->comp[i] = ci;
      sc->td[i] = d[2 + 2 * i] >> 4;
      sc->ta[i] = d[2 + 2 * i] & 15;
      if (sc->td[i] > 3 || sc->ta[i] > 3) return kNoHuffmanTable;
    }
    const uint8_t* t = d + 1 + 2 * sc->n;
    sc->ss = t[0];
    sc->se = t[1];
    sc->ah = t[2] >> 4;
    sc->al = t[2] & 15;
    return kOk;
  }

  int decode_scan(const Scan& sc) {
    HuffTable dct[4], act[4];
    const bool dc_band = sc.ss == 0;
    if (progressive) {
      // jdphuff.c start_pass_phuff_decoder: what it refuses ...
      bool bad = false;
      if (dc_band) {
        if (sc.se != 0) bad = true;
      } else {
        if (sc.ss > sc.se || sc.se > 63) bad = true;
        if (sc.n != 1) bad = true;
      }
      if (sc.ah != 0 && sc.al != sc.ah - 1) bad = true;
      if (sc.al > 13) bad = true;
      if (bad) return kBadScan;
      // ... and the progression status it keeps (an odd order is only
      // warned of there)
      for (int i = 0; i < sc.n; i++) {
        Component& c = comp[sc.comp[i]];
        for (int k = sc.ss; k <= sc.se; k++) c.coef_bits[k] = sc.al;
      }
    }
    int blocks = 0;
    for (int i = 0; i < sc.n; i++) {
      const Component& c = comp[sc.comp[i]];
      blocks += sc.n == 1 ? 1 : c.h * c.v;
    }
    if (blocks > 10) return kBadScan;  // libjpeg's D_MAX_BLOCKS_IN_MCU
    for (int i = 0; i < sc.n; i++) {
      Component& c = comp[sc.comp[i]];
      if (!c.latched) {
        if (c.tq > 3 || !qspec[c.tq].defined) return kNoQuantTable;
        for (int k = 0; k < 64; k++)
          c.qt[k] = static_cast<int16_t>(qspec[c.tq].q[k]);
        c.latched = true;
      }
      int e;
      if (!progressive) {
        if ((e = build_huffman(dc_spec[sc.td[i]], true, &dct[i]))) return e;
        if ((e = build_huffman(ac_spec[sc.ta[i]], false, &act[i]))) return e;
      } else if (dc_band) {
        if (sc.ah == 0 &&
            (e = build_huffman(dc_spec[sc.td[i]], true, &dct[i])))
          return e;
      } else if ((e = build_huffman(ac_spec[sc.ta[i]], false, &act[i]))) {
        return e;
      }
    }

    BitReader br{data, len, pos};
    int pred[4] = {0, 0, 0, 0};
    int eobrun = 0;
    int restarts_to_go = restart_interval;
    int next_rst = 0;
    int rows, cols;
    if (sc.n == 1) {
      cols = comp[sc.comp[0]].wib;
      rows = comp[sc.comp[0]].hib;
    } else {
      cols = mcux;
      rows = mcuy;
    }
    for (int my = 0; my < rows; my++) {
      for (int mx = 0; mx < cols; mx++) {
        if (restart_interval) {
          if (restarts_to_go == 0) {
            br.reset();
            size_t p = br.pos;
            int m;
            if (next_marker(&p, &m)) return kTruncated;
            if (m != 0xD0 + next_rst) return kRestart;
            br.pos = p;
            next_rst = (next_rst + 1) & 7;
            pred[0] = pred[1] = pred[2] = pred[3] = 0;
            eobrun = 0;
            restarts_to_go = restart_interval;
          }
          restarts_to_go--;
        }
        for (int i = 0; i < sc.n; i++) {
          Component& c = comp[sc.comp[i]];
          int bh = sc.n == 1 ? 1 : c.v, bwid = sc.n == 1 ? 1 : c.h;
          for (int by = 0; by < bh; by++) {
            for (int bx = 0; bx < bwid; bx++) {
              size_t row = static_cast<size_t>(my) * bh + by;
              size_t col = static_cast<size_t>(mx) * bwid + bx;
              int16_t* blk = c.coef + (row * c.bw + col) * 64;
              int e;
              if (!progressive)
                e = block_sequential(br, dct[i], act[i], &pred[i], blk);
              else if (dc_band)
                e = sc.ah == 0 ? block_dc_first(br, dct[i], &pred[i], sc.al,
                                                blk)
                               : block_dc_refine(br, sc.al, blk);
              else if (sc.ah == 0)
                e = block_ac_first(br, act[i], sc, &eobrun, blk);
              else
                e = block_ac_refine(br, act[i], sc, &eobrun, blk);
              if (e) return e;
            }
          }
        }
        if (br.overrun) {  // the data ended (at EOI: truncated) or a
          size_t p = br.pos;  // marker cut the scan short (corrupt)
          int m;
          return next_marker(&p, &m) || m == 0xD9 ? kTruncated : kCorrupt;
        }
      }
    }
    pos = br.pos;  // the next marker, or data no block took
    return kOk;
  }

  // jdhuff.c decode_mcu_slow, one block
  static int block_sequential(BitReader& br, const HuffTable& dc,
                              const HuffTable& ac, int* pred, int16_t* blk) {
    int s = br.decode(dc);
    if (s < 0) return kBadHuffmanCode;
    int diff = s ? extend(br.bits(s), s) : 0;
    *pred = static_cast<int>(static_cast<uint32_t>(*pred) +
                             static_cast<uint32_t>(diff));
    blk[0] = static_cast<int16_t>(*pred);
    for (int k = 1; k < 64; k++) {
      int rs = br.decode(ac);
      if (rs < 0) return kBadHuffmanCode;
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = static_cast<int16_t>(extend(br.bits(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
    return kOk;
  }

  // jdphuff.c decode_mcu_DC_first, one block
  static int block_dc_first(BitReader& br, const HuffTable& dc, int* pred,
                            int al, int16_t* blk) {
    int s = br.decode(dc);
    if (s < 0) return kBadHuffmanCode;
    int diff = s ? extend(br.bits(s), s) : 0;
    *pred = static_cast<int>(static_cast<uint32_t>(*pred) +
                             static_cast<uint32_t>(diff));
    blk[0] = static_cast<int16_t>(static_cast<uint32_t>(*pred) << al);
    return kOk;
  }

  // decode_mcu_DC_refine
  static int block_dc_refine(BitReader& br, int al, int16_t* blk) {
    if (br.bits(1)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
    return kOk;
  }

  // decode_mcu_AC_first
  static int block_ac_first(BitReader& br, const HuffTable& ac,
                            const Scan& sc, int* eobrun, int16_t* blk) {
    if (*eobrun > 0) {
      (*eobrun)--;
      return kOk;
    }
    for (int k = sc.ss; k <= sc.se; k++) {
      int rs = br.decode(ac);
      if (rs < 0) return kBadHuffmanCode;
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        int v = extend(br.bits(s), s);
        blk[kNatural[k]] =
            static_cast<int16_t>(static_cast<uint32_t>(v) << sc.al);
      } else if (r == 15) {
        k += 15;
      } else {
        *eobrun = 1 << r;
        if (r) *eobrun += br.bits(r);
        (*eobrun)--;
        break;
      }
    }
    return kOk;
  }

  // decode_mcu_AC_refine
  static int block_ac_refine(BitReader& br, const HuffTable& ac,
                             const Scan& sc, int* eobrun, int16_t* blk) {
    const int p1 = 1 << sc.al;
    const int m1 = -p1;
    int k = sc.ss;
    if (*eobrun == 0) {
      for (; k <= sc.se; k++) {
        int rs = br.decode(ac);
        if (rs < 0) return kBadHuffmanCode;
        int r = rs >> 4, s = rs & 15;
        if (s) {
          // a new coefficient's size is 1; libjpeg only warns otherwise
          s = br.bits(1) ? p1 : m1;
        } else if (r != 15) {
          *eobrun = 1 << r;
          if (r) *eobrun += br.bits(r);
          break;
        }
        do {
          int16_t* c = blk + kNatural[k];
          if (*c != 0) {
            if (br.bits(1) && (*c & p1) == 0)
              *c = static_cast<int16_t>(*c >= 0 ? *c + p1 : *c + m1);
          } else if (--r < 0) {
            break;
          }
          k++;
        } while (k <= sc.se);
        if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
    if (*eobrun > 0) {
      for (; k <= sc.se; k++) {
        int16_t* c = blk + kNatural[k];
        if (*c != 0 && br.bits(1) && (*c & p1) == 0)
          *c = static_cast<int16_t>(*c >= 0 ? *c + p1 : *c + m1);
      }
      (*eobrun)--;
    }
    return kOk;
  }

  // Reads the markers and scans.  With header_only, stops at the frame.
  int run(bool header_only) {
    if (len < 3 || data[0] != 0xFF || data[1] != 0xD8) return kNotJpeg;
    pos = 2;
    for (;;) {
      int m;
      if (next_marker(&pos, &m)) return kTruncated;  // no EOI
      int e = kOk;
      switch (m) {
        case 0xC0:
        case 0xC1:
        case 0xC2:
          e = read_sof(m);
          if (!e && header_only) return kOk;
          break;
        case 0xC3:
        case 0xC5:
        case 0xC6:
        case 0xC7:
        case 0xDE:
        case 0xDF:
          return kLossless;
        case 0xC9:
        case 0xCA:
        case 0xCB:
        case 0xCD:
        case 0xCE:
        case 0xCF:
          return kArithmetic;
        case 0xC4:
          e = read_dht();
          break;
        case 0xDB:
          e = read_dqt();
          break;
        case 0xDD:
          e = read_dri();
          break;
        case 0xDA: {
          if (header_only) return kNoFrame;
          Scan sc;
          if ((e = read_sos(&sc))) return e;
          if (scans == 0) {
            // jinit_huff_decoder's std_huff_tables, then the colour
            // space and the buffering libjpeg fixes at its first SOS
            set_standard(&dc_spec[0], kStdDcLumBits, kStdDcVals, 12);
            set_standard(&ac_spec[0], kStdAcLumBits, kStdAcLumVals, 162);
            set_standard(&dc_spec[1], kStdDcChromBits, kStdDcVals, 12);
            set_standard(&ac_spec[1], kStdAcChromBits, kStdAcChromVals, 162);
            choose_colour_space();
            single_pass = !progressive && sc.n == ncomp;
            if ((e = allocate())) return e;
          }
          if ((e = decode_scan(sc))) return e;
          scans++;
          if (single_pass) return kOk;  // libjpeg reads no further
          break;
        }
        case 0xD9:
          return scans ? kOk : kCorrupt;
        case 0xD8:
          return kCorrupt;
        case 0x01:
        case 0xD0:
        case 0xD1:
        case 0xD2:
        case 0xD3:
        case 0xD4:
        case 0xD5:
        case 0xD6:
        case 0xD7:
          break;  // no parameters
        case 0xCC:  // arithmetic conditioning, DNL, APPn, COM: skipped
        case 0xDC:
        case 0xFE:
          e = read_app(m);
          break;
        default:
          if (m >= 0xE0 && m <= 0xEF)
            e = read_app(m);
          else
            return kCorrupt;
      }
      if (e) return e;
    }
  }

  // jdcoefct.c smoothing_ok: libjpeg smooths a progressive image whose
  // first ten coefficients are not all fully refined; that is not ported
  bool smoothing_would_apply() const {
    if (!progressive) return false;
    static constexpr int kQPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (int i = 0; i < ncomp; i++) {
      const Component& c = comp[i];
      if (!c.latched) return false;
      for (int k : kQPos)
        if (c.qt[k] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; k++)
        if (c.coef_bits[k] != 0) useful = true;
    }
    return useful;
  }

  int output(uint8_t* out) {
    if (smoothing_would_apply()) return kSmoothing;
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      size_t stride = static_cast<size_t>(c.bw) * 8;
      c.plane = static_cast<uint8_t*>(std::malloc(stride * c.bh * 8));
      if (!c.plane) return kNoMemory;
      for (int by = 0; by < c.hib; by++)
        for (int bx = 0; bx < c.wib; bx++)
          idct_islow(c.coef + (static_cast<size_t>(by) * c.bw + bx) * 64,
                     c.qt, c.plane + by * 8 * stride + bx * 8, stride);
      std::free(c.coef);
      c.coef = nullptr;
    }
    const size_t w = static_cast<size_t>(width);
    if (ncomp == 1) {
      const Component& c = comp[0];
      const size_t stride = static_cast<size_t>(c.bw) * 8;
      for (int y = 0; y < height; y++)
        std::memcpy(out + y * w, c.plane + y * stride, w);
      return kOk;
    }
    uint8_t* rows = static_cast<uint8_t*>(std::malloc(3 * (w + 2)));
    if (!rows) return kNoMemory;
    // jdcolor.c build_ycc_rgb_table
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    const int64_t one_half = 1 << 15;
    const int64_t fix_1_402 = static_cast<int64_t>(1.40200 * 65536 + 0.5);
    const int64_t fix_1_772 = static_cast<int64_t>(1.77200 * 65536 + 0.5);
    const int64_t fix_0_714 = static_cast<int64_t>(0.71414 * 65536 + 0.5);
    const int64_t fix_0_344 = static_cast<int64_t>(0.34414 * 65536 + 0.5);
    for (int i = 0; i < 256; i++) {
      int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix_1_402 * x + one_half) >> 16);
      cb_b[i] = static_cast<int>((fix_1_772 * x + one_half) >> 16);
      cr_g[i] = -fix_0_714 * x;
      cb_g[i] = -fix_0_344 * x + one_half;
    }
    for (int y = 0; y < height; y++) {
      const uint8_t* ch[3];
      for (int i = 0; i < 3; i++) {
        const Component& c = comp[i];
        const size_t stride = static_cast<size_t>(c.bw) * 8;
        uint8_t* tmp = rows + i * (w + 2);
        if (c.h == hmax && c.v == vmax) {
          ch[i] = c.plane + y * stride;
        } else if (c.v == vmax) {  // 2x1
          const uint8_t* in = c.plane + y * stride;
          if (c.dw > 2)
            h2v1_fancy(in, c.dw, tmp);
          else
            replicate2(in, c.dw, tmp);
          ch[i] = tmp;
        } else {  // 2x2
          int r = y >> 1;
          const uint8_t* in0 = c.plane + r * stride;
          if (c.dw > 2) {
            int r1 = (y & 1) ? (r + 1 < c.dh ? r + 1 : c.dh - 1)
                             : (r > 0 ? r - 1 : 0);
            h2v2_fancy(in0, c.plane + r1 * stride, c.dw, tmp);
          } else {
            replicate2(in0, c.dw, tmp);
          }
          ch[i] = tmp;
        }
      }
      uint8_t* o = out + y * w * 3;
      if (rgb) {
        for (size_t x = 0; x < w; x++) {
          o[3 * x] = ch[0][x];
          o[3 * x + 1] = ch[1][x];
          o[3 * x + 2] = ch[2][x];
        }
      } else {
        for (size_t x = 0; x < w; x++) {
          int yy = ch[0][x], cb = ch[1][x], cr = ch[2][x];
          o[3 * x] = clamp255(yy + cr_r[cr]);
          o[3 * x + 1] =
              clamp255(yy + static_cast<int>((cb_g[cb] + cr_g[cr]) >> 16));
          o[3 * x + 2] = clamp255(yy + cb_b[cb]);
        }
      }
    }
    std::free(rows);
    return kOk;
  }
};

}  // namespace

extern "C" {

int jpeg_get_info(const uint8_t* buf, long len, int* w, int* h, int* comps) {
  if (!buf || len <= 0) return kNotJpeg;
  try {
    Decoder d(buf, static_cast<size_t>(len));
    int e = d.run(true);
    if (e) return e;
    *w = d.width;
    *h = d.height;
    *comps = d.ncomp;
    return kOk;
  } catch (...) {
    return kNoMemory;
  }
}

int jpeg_decode(const uint8_t* buf, long len, uint8_t* out) {
  if (!buf || len <= 0) return kNotJpeg;
  try {
    Decoder* d = new Decoder(buf, static_cast<size_t>(len));
    int e = d->run(false);
    if (!e) e = d->output(out);
    delete d;
    return e;
  } catch (...) {
    return kNoMemory;
  }
}

}  // extern "C"

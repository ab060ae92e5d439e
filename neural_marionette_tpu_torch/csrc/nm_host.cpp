// Host-side data library of the PyTorch/CUDA port: a copy of the JAX
// package's native/nm_host.cpp, built by kernels.py (g++ -O3 -std=c++17
// -shared -fPIC -pthread) into _build/ at first use and bound in
// data/native.py. The loader calls it from its worker threads; ctypes
// releases the interpreter lock around each call.
//
//   * nm_voxelize_batch  — scatter (F, N, 3) point frames into (F, G^3)
//                          binary occupancy grids, one thread per frame
//                          (reference semantics: truncating cast, +1e-5
//                          step fudge, [-1,1]^3 bbox, index clamp — an
//                          out-of-range point lands in the border voxel,
//                          where the card's voxelizer drops it)
//   * nm_normalize_episodic — clip-wide bbox normalization into [-1,1]^3
//                          (utils/dataset_utils.py:9-19)
//   * nm_crop_strided   — strided temporal window gather
//   * nm_gif_lzw        — the LZW code stream of one GIF frame (viz/
//                          image_files.py writes the blocks around it)
//   * nm_png_unfilter   — undo the per-row filters of a PNG (one pass)
//   * nm_tga_unrle      — expand the run-length packets of a TGA image
//   * nm_gif_unlzw      — decode one GIF frame's LZW code stream
//   * nm_tiff_unlzw / nm_packbits — TIFF's LZW (MSB first, early change)
//                          and PackBits strips, as tifffile decodes them
//   * nm_tiff_unlzw_compat — old-style TIFF LZW (LSB first, no early
//                          change), as libtiff's LZWDecodeCompat reads it
//   * nm_hdr_unrle      — the scanlines of a Radiance HDR file, as the
//                          RGBE reader of OpenCV's HdrDecoder reads them
//   * nm_bmp_unrle      — a BI_RLE8 / BI_RLE4 BMP, as Pillow expands it
//   * nm_qoi_decode     — a QOI image's ops, as Pillow's QoiDecoder reads
//                          them
//   * nm_jpeg_info / nm_jpeg_decode — an 8-bit JPEG (baseline, extended
//                          sequential, progressive and lossless; Huffman
//                          or arithmetic coding; 1, 3 or 4 components,
//                          sampling factors 1-4) decoded as libjpeg-turbo
//                          3 does by default: its integer IDCT, block
//                          smoothing, fancy upsampling, colour tables and
//                          colour space guess, so the pixels equal
//                          Pillow's (or, whole, with none of the limits
//                          of Pillow's feed: OpenCV's)
//
// Exposed with C linkage for ctypes. Nothing throws across that boundary:
// the JPEG entry points return an error code and write a message.

#include <algorithm>
#include <atomic>
#include <climits>
#include <cmath>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <string>
#include <thread>
#include <vector>

namespace {

int hardware_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 4 : static_cast<int>(n);
}

// parallel-for over [0, count) with one task per worker chunk
template <typename F>
void parallel_for(int64_t count, F&& fn, int max_threads = 0) {
  int n_threads = std::min<int64_t>(
      count, max_threads > 0 ? max_threads : hardware_threads());
  if (n_threads <= 1) {
    for (int64_t i = 0; i < count; ++i) fn(i);
    return;
  }
  std::atomic<int64_t> next(0);
  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) {
    pool.emplace_back([&]() {
      for (;;) {
        int64_t i = next.fetch_add(1);
        if (i >= count) return;
        fn(i);
      }
    });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

namespace {
// ------------------------------------------------------------------ JPEG
// An 8-bit JPEG decoder that reproduces libjpeg-turbo 3's default output
// (what Pillow, and through it imageio, returns): Huffman (jdhuff.c,
// jdphuff.c, jdlhuff.c, with jstdhuff.c's tables for a sequential frame
// without DHT, and its zero-filled MCUs once the data runs out) and
// arithmetic (jdarith.c) entropy decoding; the integer IDCT
// jpeg_idct_islow (CONST_BITS 13, PASS1_BITS 2) after the block smoothing
// of jdcoefct.c where a progressive file leaves coefficients unrefined;
// lossless prediction (jdpred.c); "fancy" upsampling (jdsample.c: the h2v1
// and h2v2 triangle filters, h1v2) and int_upsample for the other whole
// ratios; the fixed-point YCbCr -> RGB and YCCK -> CMYK tables of jdcolor.c
// (SCALEBITS 16) and the colour space guess of jdapimin.c (JFIF, the Adobe
// APP14 transform, the component IDs). Every read is bounds-checked; a bad
// file throws a Failure inside this namespace, which the C entry points
// turn into an error code and a message.
namespace jpeg {

enum Status { kOk = 0, kCorrupt = 1, kUnsupported = 2, kNoRoom = 3 };

struct Failure {
  int code;
  std::string msg;
};

[[noreturn]] void fail(int code, const char* fmt, ...) {
  char buf[256];
  va_list ap;
  va_start(ap, fmt);
  std::vsnprintf(buf, sizeof buf, fmt, ap);
  va_end(ap);
  throw Failure{code, buf};
}

// zigzag index -> natural (row-major) index, with libjpeg's 16 extra
// entries: a corrupt run past the block's end lands on coefficient 63
constexpr int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kFastBits = 9;

struct HuffTable {
  bool defined = false;
  uint8_t vals[256];
  int32_t maxcode[17];   // largest code of each length, -1 if none
  int32_t valptr[17];    // index into vals of a length's first code, minus
                         // that code
  uint16_t fast[1 << kFastBits];   // (length << 8) | value; 0: longer code
};

// jpeg_make_d_derived_tbl: canonical codes; a table whose codes overflow
// their length (the all-ones code included) is refused
void build_table(HuffTable& t, const uint8_t* counts, const uint8_t* vals,
                 int n) {
  std::memcpy(t.vals, vals, n);
  std::memset(t.fast, 0, sizeof t.fast);
  int code = 0, k = 0;
  for (int l = 1; l <= 16; ++l) {
    const int cnt = counts[l - 1];
    t.valptr[l] = k - code;
    for (int i = 0; i < cnt; ++i, ++code, ++k) {
      if (code >= (1 << l)) fail(kCorrupt, "JPEG: bad Huffman table");
      if (l <= kFastBits) {
        const int shift = kFastBits - l;
        for (int j = 0; j < (1 << shift); ++j)
          t.fast[(code << shift) | j] =
              static_cast<uint16_t>((l << 8) | vals[k]);
      }
    }
    t.maxcode[l] = cnt ? code - 1 : -1;
    if (code >= (1 << l)) fail(kCorrupt, "JPEG: bad Huffman table");
    code <<= 1;
  }
  t.defined = true;
}

// The bits of an entropy-coded segment, MSB first, with 0xFF00 unstuffed
// and 0xFF fill bytes skipped. At a marker or the end of the data it feeds
// zeros, as libjpeg does. A symbol that consumes one of them sets
// insufficient (libjpeg's insufficient_data: the MCU is finished on zeros
// and the segment's later MCUs are left zero), or fails where strict.
struct BitReader {
  const uint8_t* d = nullptr;
  size_t n = 0, pos = 0;
  uint64_t acc = 0;
  int cnt = 0;          // valid bits in acc, from its top
  int pad = 0;          // of which the last pad bits are fed zeros
  bool at_marker = false;
  bool strict = false, insufficient = false;

  void reset(const uint8_t* data, size_t size, size_t p) {
    d = data;
    n = size;
    pos = p;
    acc = 0;
    cnt = pad = 0;
    at_marker = insufficient = false;
  }
  void fill() {
    while (cnt <= 56) {
      int b = 0;
      bool real = false;
      if (!at_marker && pos < n) {
        b = d[pos];
        if (b != 0xFF) {
          ++pos;
          real = true;
        } else {
          size_t q = pos + 1;
          while (q < n && d[q] == 0xFF) ++q;
          if (q < n && d[q] == 0x00) {
            pos = q + 1;          // a stuffed 0xFF data byte
            real = true;
          } else {
            at_marker = true;     // pos stays on the marker's first 0xFF
            b = 0;
          }
        }
      }
      if (!real) pad += 8;
      acc |= static_cast<uint64_t>(b) << (56 - cnt);
      cnt += 8;
    }
  }
  int peek(int k) {
    if (cnt < k) fill();
    return static_cast<int>(acc >> (64 - k));
  }
  void skip(int k) {
    acc <<= k;
    cnt -= k;
    if (pad > cnt) {
      if (strict) fail(kCorrupt, "JPEG: entropy-coded data ends early");
      insufficient = true;
    }
  }
  int get(int k) {
    if (k == 0) return 0;
    const int v = peek(k);
    skip(k);
    return v;
  }
  int decode(const HuffTable& t) {
    const int look = peek(16);
    const int f = t.fast[look >> (16 - kFastBits)];
    if (f) {
      skip(f >> 8);
      return f & 0xFF;
    }
    for (int l = kFastBits + 1; l <= 16; ++l) {
      const int code = look >> (16 - l);
      if (code <= t.maxcode[l]) {
        skip(l);
        return t.vals[t.valptr[l] + code];
      }
    }
    fail(kCorrupt, "JPEG: bad Huffman code");
  }
};

// HUFF_EXTEND: the s-bit magnitude category's value r as a signed number
inline int extend(int r, int s) {
  return r < (1 << (s - 1)) ? r - (1 << s) + 1 : r;
}

// jaricom.c's jpeg_aritab: the QM coder's probability estimation state
// machine of ITU T.81 table D.2, each entry (Qe << 16) | (Next_Index_MPS
// << 8) | (Switch_MPS << 7) | Next_Index_LPS; entry 113 is the fixed
// probability 0.5 of the sign and refinement bits
constexpr uint32_t kAritab[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617,
    0x00e50719, 0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09,
    0x00030d0a, 0x00010d0c, 0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227,
    0x17b91328, 0x1182142a, 0x0cef152b, 0x09a1162d, 0x072f172e, 0x055c1830,
    0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36, 0x01441d38, 0x00f51e39,
    0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320, 0x002c0921,
    0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d,
    0x0861314e, 0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633,
    0x02d43734, 0x025c3835, 0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39,
    0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d, 0x008f203d, 0x5b1241c1, 0x4d044250,
    0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654, 0x23794756, 0x1edf4857,
    0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a, 0x0d514e4b,
    0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f,
    0x44d95b60, 0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df,
    0x4f466165, 0x47e56266, 0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669,
    0x4c0f676a, 0x4639686b, 0x415e6367, 0x56276ae9, 0x50e76b6c, 0x4b85676d,
    0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70, 0x59eb6ff0, 0x5a1d7171};

// jstdhuff.c: the tables of ITU T.81 annex K.3 (DC 0, AC 0, DC 1, AC 1),
// which libjpeg installs in each of those slots that no DHT has filled by
// the first scan (Motion-JPEG frames carry none)
constexpr uint8_t kStdCounts[4][16] = {
    {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
    {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125},
    {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0},
    {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119}};
constexpr uint8_t kStdDc[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
constexpr uint8_t kStdAcLuma[162] = {
    1,   2,   3,   0,   4,   17,  5,   18,  33,  49,  65,  6,   19,  81,
    97,  7,   34,  113, 20,  50,  129, 145, 161, 8,   35,  66,  177, 193,
    21,  82,  209, 240, 36,  51,  98,  114, 130, 9,   10,  22,  23,  24,
    25,  26,  37,  38,  39,  40,  41,  42,  52,  53,  54,  55,  56,  57,
    58,  67,  68,  69,  70,  71,  72,  73,  74,  83,  84,  85,  86,  87,
    88,  89,  90,  99,  100, 101, 102, 103, 104, 105, 106, 115, 116, 117,
    118, 119, 120, 121, 122, 131, 132, 133, 134, 135, 136, 137, 138, 146,
    147, 148, 149, 150, 151, 152, 153, 154, 162, 163, 164, 165, 166, 167,
    168, 169, 170, 178, 179, 180, 181, 182, 183, 184, 185, 186, 194, 195,
    196, 197, 198, 199, 200, 201, 202, 210, 211, 212, 213, 214, 215, 216,
    217, 218, 225, 226, 227, 228, 229, 230, 231, 232, 233, 234, 241, 242,
    243, 244, 245, 246, 247, 248, 249, 250};
constexpr uint8_t kStdAcChroma[162] = {
    0,   1,   2,   3,   17,  4,   5,   33,  49,  6,   18,  65,  81,  7,
    97,  113, 19,  34,  50,  129, 8,   20,  66,  145, 161, 177, 193, 9,
    35,  51,  82,  240, 21,  98,  114, 209, 10,  22,  36,  52,  225, 37,
    241, 23,  24,  25,  26,  38,  39,  40,  41,  42,  53,  54,  55,  56,
    57,  58,  67,  68,  69,  70,  71,  72,  73,  74,  83,  84,  85,  86,
    87,  88,  89,  90,  99,  100, 101, 102, 103, 104, 105, 106, 115, 116,
    117, 118, 119, 120, 121, 122, 130, 131, 132, 133, 134, 135, 136, 137,
    138, 146, 147, 148, 149, 150, 151, 152, 153, 154, 162, 163, 164, 165,
    166, 167, 168, 169, 170, 178, 179, 180, 181, 182, 183, 184, 185, 186,
    194, 195, 196, 197, 198, 199, 200, 201, 202, 210, 211, 212, 213, 214,
    215, 216, 217, 218, 226, 227, 228, 229, 230, 231, 232, 233, 234, 242,
    243, 244, 245, 246, 247, 248, 249, 250};

// Pillow's limit on the pixels of an image (twice its MAX_IMAGE_PIXELS),
// past which it refuses to decode
constexpr int64_t kMaxPixels = 178956970;

// Pillow feeds libjpeg the file in blocks of this many bytes (ImageFile's
// MAXBLOCK), one more block each time libjpeg runs out and suspends.
// libjpeg's arithmetic decoder cannot suspend: a scan whose data runs past
// the blocks fed when it starts fails, and imageio with it.
constexpr size_t kFeed = 65536;

// jdarith.c's QM decoder (ITU T.81 annex D) over one scan's entropy-coded
// data. Bytes are read as its get_byte and arith_decode read them: 0xFF00
// is a 0xFF data byte, fill 0xFF bytes are swallowed, and once a marker is
// met (which ends a segment legally in arithmetic coding) zeros are fed.
// The data ending without a marker is a failure, as it is for libjpeg
// (which cannot suspend in this decoder); so is data past limit, the bytes
// Pillow has handed libjpeg by then (see kFeed).
struct ArithReader {
  const uint8_t* d = nullptr;
  size_t n = 0, pos = 0, limit = 0;
  bool marker = false;     // libjpeg's unread_marker: a marker was met
  int marker_code = 0;
  size_t marker_pos = 0;   // the 0xFF before the marker's code
  int64_t c = 0, a = 0;
  int ct = -16;            // -16: two bytes to read; -1: a decoding error

  void reset(const uint8_t* data, size_t size, size_t p) {
    d = data;
    n = size;
    pos = p;
    marker = false;
    c = a = 0;
    ct = -16;
  }
  void check() const {
    if (pos >= n) fail(kCorrupt, "JPEG: arithmetic-coded data ends early");
    if (pos >= limit)
      fail(kUnsupported, "JPEG: arithmetic-coded data past byte %zu, the "
                         "end of the 64 KiB blocks Pillow hands libjpeg, "
                         "whose arithmetic decoder cannot wait for more "
                         "(imageio refuses the file)", limit);
  }
  int byte() {
    if (marker) return 0;
    check();
    int v = d[pos++];
    if (v != 0xFF) return v;
    do {
      check();
      v = d[pos++];
    } while (v == 0xFF);
    if (v == 0) return 0xFF;
    marker = true;
    marker_code = v;
    marker_pos = pos - 2;
    return 0;
  }
  // arith_decode: one binary decision under the statistics bin st
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        c = (c << 8) | byte();
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;
      }
      a <<= 1;
    }
    const int sv = *st;
    uint32_t qe = kAritab[sv & 0x7F];
    const int nl = qe & 0xFF;
    qe >>= 8;
    const int nm = qe & 0xFF;
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    int bit = sv >> 7;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        bit ^= 1;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        bit ^= 1;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return bit;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dw = 0, dh = 0;     // samples per row and column (downsampled_*)
  int bw = 0, bh = 0;     // blocks per row and column stored
  int dc_table = 0, ac_table = 0;
  int dc_pred = 0;
  bool latched = false;   // quant latched at the component's first scan
  uint16_t quant[64];     // natural order
  int coef_bits[64];      // progressive: Al of the last scan of each
                          // zigzag position, -1 before any
  std::vector<int16_t> coef;   // bw * bh blocks of 64, natural order
  std::vector<uint8_t> plane;  // bw * 8 x bh * 8 samples after the IDCT
  std::vector<int32_t> diff;   // lossless: one scan's sample differences
};

// jpeg_idct_islow of libjpeg-turbo's jidctint.c, dequantizing on the way
// in. The final range limit saturates to [0, 255], as its SIMD versions
// (which Pillow's libjpeg-turbo runs on x86-64) do; the C version's
// wrapping table agrees wherever the result lies in [-512, 511].
void idct_islow(const int16_t* in, const uint16_t* quant, uint8_t* out,
                int stride) {
  constexpr int kConst = 13, kPass1 = 2;
  constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                    F0899 = 7373, F1175 = 9633, F1501 = 12299,
                    F1847 = 15137, F1961 = 16069, F2053 = 16819,
                    F2562 = 20995, F3072 = 25172;
  auto descale = [](int64_t x, int n) {
    return (x + (int64_t(1) << (n - 1))) >> n;
  };
  auto deq = [&](int i) {
    return static_cast<int64_t>(in[i]) *
           static_cast<int64_t>(static_cast<int16_t>(quant[i]));
  };
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    if (!in[8 + c] && !in[16 + c] && !in[24 + c] && !in[32 + c] &&
        !in[40 + c] && !in[48 + c] && !in[56 + c]) {
      const int dc = static_cast<int>(deq(c) * (1 << kPass1));
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dc;
      continue;
    }
    int64_t z2 = deq(16 + c), z3 = deq(48 + c);
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847;
    int64_t tmp3 = z1 + z2 * F0765;
    z2 = deq(c);
    z3 = deq(32 + c);
    int64_t tmp0 = (z2 + z3) * (int64_t(1) << kConst);
    int64_t tmp1 = (z2 - z3) * (int64_t(1) << kConst);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3,
                  tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = deq(56 + c);
    tmp1 = deq(40 + c);
    tmp2 = deq(24 + c);
    tmp3 = deq(8 + c);
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConst - kPass1;
    ws[0 * 8 + c] = static_cast<int>(descale(tmp10 + tmp3, sh));
    ws[7 * 8 + c] = static_cast<int>(descale(tmp10 - tmp3, sh));
    ws[1 * 8 + c] = static_cast<int>(descale(tmp11 + tmp2, sh));
    ws[6 * 8 + c] = static_cast<int>(descale(tmp11 - tmp2, sh));
    ws[2 * 8 + c] = static_cast<int>(descale(tmp12 + tmp1, sh));
    ws[5 * 8 + c] = static_cast<int>(descale(tmp12 - tmp1, sh));
    ws[3 * 8 + c] = static_cast<int>(descale(tmp13 + tmp0, sh));
    ws[4 * 8 + c] = static_cast<int>(descale(tmp13 - tmp0, sh));
  }
  auto limit = [](int64_t x) {
    return static_cast<uint8_t>(std::clamp<int64_t>(x + 128, 0, 255));
  };
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + r * 8;
    uint8_t* o = out + static_cast<int64_t>(r) * stride;
    const int sh = kConst + kPass1 + 3;
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847;
    int64_t tmp3 = z1 + z2 * F0765;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (int64_t(1) << kConst);
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * (int64_t(1) << kConst);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3,
                  tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = limit(descale(tmp10 + tmp3, sh));
    o[7] = limit(descale(tmp10 - tmp3, sh));
    o[1] = limit(descale(tmp11 + tmp2, sh));
    o[6] = limit(descale(tmp11 - tmp2, sh));
    o[2] = limit(descale(tmp12 + tmp1, sh));
    o[5] = limit(descale(tmp12 - tmp1, sh));
    o[3] = limit(descale(tmp13 + tmp0, sh));
    o[4] = limit(descale(tmp13 - tmp0, sh));
  }
}

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t size) : d_(data), n_(size) {
    std::fill(dac_l_, dac_l_ + 16, 0);
    std::fill(dac_u_, dac_u_ + 16, 1);
    std::fill(dac_k_, dac_k_ + 16, 5);
  }

  // The markers up to and including the frame header (SOF).
  void read_header() {
    if (n_ < 2 || d_[0] != 0xFF || d_[1] != 0xD8)
      fail(kCorrupt, "not a JPEG file (no SOI marker)");
    pos_ = 2;
    for (;;) {
      const int m = next_marker();
      if (m < 0) fail(kCorrupt, "JPEG: the data ends before the frame header");
      if (marker(m)) return;
    }
  }

  // Whether libjpeg holds the whole file (OpenCV's source), rather than
  // the blocks Pillow feeds it (see kFeed).
  void set_whole(bool whole) { whole_ = whole; }

  // The rest of the file, then the pixels: (height, width, channels()).
  void decode(uint8_t* out) {
    for (int c = 0; c < ncomp_; ++c) {
      Component& k = comp_[c];
      const size_t blocks = static_cast<size_t>(k.bw) * k.bh;
      if (lossless_) k.plane.assign(blocks * 64, 0);
      else k.coef.assign(blocks * 64, 0);
    }
    for (;;) {
      const int m = next_marker();
      if (m < 0) fail(kCorrupt, "JPEG: the data ends before the EOI marker");
      if (m == 0xD9) break;
      marker(m);   // a second frame header fails there
    }
    if (scans_ == 0) fail(kCorrupt, "JPEG: no scan");
    if (!lossless_) {
      const bool smooth = process_ == 2 && smoothing_ok();
      for (int c = 0; c < ncomp_; ++c) {
        if (smooth) smooth_idct(comp_[c]);
        else inverse_dct(comp_[c]);
      }
    }
    write_pixels(out);
  }

  int width() const { return width_; }
  int height() const { return height_; }
  int channels() const { return ncomp_; }
  // the frame marker's number: 0-3 Huffman (baseline, extended
  // sequential, progressive, lossless), 9-11 arithmetic
  int process() const { return process_ + (arith_ ? 8 : 0); }

 private:
  enum Kind { kSequential, kDcFirst, kDcRefine, kAcFirst, kAcRefine,
              kLossless };

  const uint8_t* d_;
  size_t n_, pos_ = 0;
  int width_ = 0, height_ = 0, ncomp_ = 0, process_ = -1;
  bool arith_ = false, lossless_ = false, whole_ = false;
  int hmax_ = 1, vmax_ = 1, mcusx_ = 0, mcusy_ = 0;
  Component comp_[4];
  uint16_t qt_[4][64];
  bool qt_defined_[4] = {false, false, false, false};
  HuffTable dc_[4], ac_[4];
  uint8_t dac_l_[16], dac_u_[16], dac_k_[16];   // arith_dc_L/U, arith_ac_K
  int restart_interval_ = 0, scans_ = 0;
  bool jfif_ = false, adobe_ = false;
  int adobe_transform_ = -1;
  BitReader br_;
  int eobrun_ = 0;
  // the arithmetic decoder's state (jdarith.c arith_entropy_decoder)
  ArithReader ar_;
  uint8_t dc_stats_[16][64], ac_stats_[16][256], fixed_bin_ = 113;
  int dc_context_[4] = {0, 0, 0, 0};   // per component of the scan

  int byte_at(size_t i) const {
    if (i >= n_) fail(kCorrupt, "JPEG: truncated marker segment");
    return d_[i];
  }
  int be16(size_t i) const { return (byte_at(i) << 8) | byte_at(i + 1); }

  // libjpeg's next_marker: skip to an 0xFF, then its fill bytes; 0xFF00
  // outside a scan is skipped too. -1 at the end of the data.
  int next_marker() {
    for (;;) {
      while (pos_ < n_ && d_[pos_] != 0xFF) ++pos_;
      while (pos_ < n_ && d_[pos_] == 0xFF) ++pos_;
      if (pos_ >= n_) return -1;
      const int m = d_[pos_++];
      if (m != 0) return m;
    }
  }

  // A marker segment's payload [start, start + len); advances past it.
  size_t segment(size_t* len) {
    const int total = be16(pos_);
    if (total < 2) fail(kCorrupt, "JPEG: bad marker segment length");
    if (pos_ + total > n_) fail(kCorrupt, "JPEG: truncated marker segment");
    const size_t start = pos_ + 2;
    *len = total - 2;
    pos_ += total;
    return start;
  }

  // Handles one marker; true for a frame header.
  bool marker(int m) {
    size_t len = 0, p = 0;
    switch (m) {
      case 0xC0: case 0xC1: case 0xC2: case 0xC3:
      case 0xC9: case 0xCA: case 0xCB:
        if (process_ >= 0) fail(kCorrupt, "JPEG: a second frame header");
        p = segment(&len);
        frame(m - 0xC0, p, len);
        return true;
      case 0xC5: case 0xC6: case 0xC7:
        fail(kUnsupported, "JPEG: hierarchical (differential, SOF%d) JPEG "
                           "is not supported", m - 0xC0);
      case 0xCD: case 0xCE: case 0xCF:
        fail(kUnsupported, "JPEG: arithmetic coding in a hierarchical "
                           "(differential, SOF%d) JPEG is not supported",
             m - 0xC0);
      case 0xCC:
        p = segment(&len);
        conditioning(p, len);
        return false;
      case 0xC8:
        fail(kUnsupported, "JPEG: the JPG extension marker (0xC8) is not "
                           "supported");
      case 0xDE: case 0xDF:
        fail(kUnsupported, "JPEG: hierarchical JPEG (DHP/EXP marker) is not "
                           "supported");
      case 0xDC:
        fail(kUnsupported, "JPEG: a DNL marker (height defined after the "
                           "first scan) is not supported");
      case 0xC4:
        p = segment(&len);
        huffman_tables(p, len);
        return false;
      case 0xDB:
        p = segment(&len);
        quant_tables(p, len);
        return false;
      case 0xDD:
        p = segment(&len);
        if (len != 2) fail(kCorrupt, "JPEG: bad DRI segment");
        restart_interval_ = be16(p);
        return false;
      case 0xDA:
        if (process_ < 0) fail(kCorrupt, "JPEG: a scan before the frame");
        p = segment(&len);
        scan(p, len);
        return false;
      case 0xD8:
        fail(kCorrupt, "JPEG: a second SOI marker");
      case 0xD9:
        fail(kCorrupt, "JPEG: EOI before the frame");
      case 0xE0:
        p = segment(&len);
        if (len >= 14 && !std::memcmp(d_ + p, "JFIF\0", 5)) jfif_ = true;
        return false;
      case 0xEE:
        p = segment(&len);
        if (len >= 12 && !std::memcmp(d_ + p, "Adobe", 5)) {
          adobe_ = true;
          adobe_transform_ = d_[p + 11];
        }
        return false;
      case 0x01: case 0xD0: case 0xD1: case 0xD2: case 0xD3: case 0xD4:
      case 0xD5: case 0xD6: case 0xD7:
        return false;     // no payload; a stray RSTn is ignored
      default:
        if ((m >= 0xE1 && m <= 0xEF) || m == 0xFE) {
          segment(&len);  // APPn, COM
          return false;
        }
        fail(kCorrupt, "JPEG: unknown marker 0x%02X", m);
    }
  }

  void quant_tables(size_t p, size_t len) {
    const size_t end = p + len;
    while (p < end) {
      const int pq = d_[p] >> 4, tq = d_[p] & 15;
      if (tq > 3 || pq > 1) fail(kCorrupt, "JPEG: bad DQT segment");
      const size_t need = 1 + 64 * (pq + 1);
      if (p + need > end) fail(kCorrupt, "JPEG: bad DQT segment");
      for (int i = 0; i < 64; ++i)
        qt_[tq][kNatural[i]] = static_cast<uint16_t>(
            pq ? (d_[p + 1 + 2 * i] << 8) | d_[p + 2 + 2 * i]
               : d_[p + 1 + i]);
      qt_defined_[tq] = true;
      p += need;
    }
  }

  void huffman_tables(size_t p, size_t len) {
    const size_t end = p + len;
    while (p < end) {
      if (p + 17 > end) fail(kCorrupt, "JPEG: bad DHT segment");
      const int tc = d_[p] >> 4, th = d_[p] & 15;
      if (tc > 1 || th > 3) fail(kCorrupt, "JPEG: bad DHT segment");
      int count = 0;
      for (int i = 0; i < 16; ++i) count += d_[p + 1 + i];
      if (count > 256 || p + 17 + count > end)
        fail(kCorrupt, "JPEG: bad DHT segment");
      build_table(tc ? ac_[th] : dc_[th], d_ + p + 1, d_ + p + 17, count);
      p += 17 + count;
    }
  }

  // jdmarker.c get_dac: the conditioning of the arithmetic DC (L, U) and
  // AC (Kx) statistics of each table
  void conditioning(size_t p, size_t len) {
    if (len % 2) fail(kCorrupt, "JPEG: bad DAC segment length");
    for (size_t i = 0; i < len; i += 2) {
      const int index = d_[p + i], val = d_[p + i + 1];
      if (index >= 32) fail(kCorrupt, "JPEG: bad DAC table index %d", index);
      if (index >= 16) {
        dac_k_[index - 16] = static_cast<uint8_t>(val);
      } else {
        dac_l_[index] = static_cast<uint8_t>(val & 15);
        dac_u_[index] = static_cast<uint8_t>(val >> 4);
        if (dac_l_[index] > dac_u_[index])
          fail(kCorrupt, "JPEG: bad DAC value 0x%02X", val);
      }
    }
  }

  void frame(int sof, size_t p, size_t len) {
    if (len < 6) fail(kCorrupt, "JPEG: bad frame header");
    const int process = sof & 3;
    const bool arith = sof >= 8;
    const int precision = d_[p];
    height_ = be16(p + 1);
    width_ = be16(p + 3);
    const int nc = d_[p + 5];
    static const char* const kNames[4] = {
        "baseline", "extended sequential", "progressive", "lossless"};
    const char* name = kNames[process];
    if (precision != 8)
      fail(kUnsupported, "JPEG: %d-bit samples (%s, SOF%d); only 8-bit "
                         "JPEG is read", precision, name, sof);
    if (arith && process == 3)
      fail(kUnsupported, "JPEG: arithmetic-coded lossless JPEG (SOF11) is "
                         "not supported (libjpeg-turbo does not read it)");
    if (width_ == 0) fail(kCorrupt, "JPEG: frame width 0");
    if (height_ == 0)
      fail(kUnsupported, "JPEG: a DNL marker (height 0 in the frame "
                         "header) is not supported");
    if (int64_t(width_) * height_ > kMaxPixels)
      fail(kUnsupported, "JPEG: %d x %d pixels, past the limit of %lld",
           width_, height_, static_cast<long long>(kMaxPixels));
    if (nc != 1 && nc != 3 && nc != 4)
      fail(kUnsupported, "JPEG: %d-component JPEG is not supported", nc);
    if (len != 6 + 3 * static_cast<size_t>(nc))
      fail(kCorrupt, "JPEG: bad frame header length");
    for (int c = 0; c < nc; ++c) {
      Component& k = comp_[c];
      k.id = d_[p + 6 + 3 * c];
      k.h = d_[p + 7 + 3 * c] >> 4;
      k.v = d_[p + 7 + 3 * c] & 15;
      k.tq = d_[p + 8 + 3 * c];
      if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4 || k.tq > 3)
        fail(kCorrupt, "JPEG: bad component in the frame header");
      for (int e = 0; e < c; ++e)
        if (comp_[e].id == k.id)
          fail(kCorrupt, "JPEG: two components with ID %d", k.id);
      hmax_ = std::max(hmax_, k.h);
      vmax_ = std::max(vmax_, k.v);
    }
    // jdsample.c: each component's ratio to the largest sampling factors
    // must be whole (jinit_upsampler's JERR_FRACT_SAMPLE_NOTIMPL)
    for (int c = 0; c < nc; ++c)
      if (hmax_ % comp_[c].h || vmax_ % comp_[c].v)
        fail(kUnsupported, "JPEG: sampling factors %dx%d under a largest "
                           "%dx%d need fractional upsampling, which libjpeg "
                           "does not implement", comp_[c].h, comp_[c].v,
             hmax_, vmax_);
    process_ = process;
    arith_ = arith;
    lossless_ = process == 3;
    ncomp_ = nc;
    // a data unit is an 8 x 8 block, or one sample in a lossless file
    const int unit = lossless_ ? 1 : 8;
    mcusx_ = (width_ + unit * hmax_ - 1) / (unit * hmax_);
    mcusy_ = (height_ + unit * vmax_ - 1) / (unit * vmax_);
    int64_t units = 0;
    for (int c = 0; c < nc; ++c) {
      Component& k = comp_[c];
      k.dw = static_cast<int>((int64_t(width_) * k.h + hmax_ - 1) / hmax_);
      k.dh = static_cast<int>((int64_t(height_) * k.v + vmax_ - 1) / vmax_);
      // blocks stored: whole MCUs (a lossless file's samples in blocks of
      // 8 x 8)
      k.bw = lossless_ ? (mcusx_ * k.h + 7) / 8 : mcusx_ * k.h;
      k.bh = lossless_ ? (mcusy_ * k.v + 7) / 8 : mcusy_ * k.v;
      units += int64_t(mcusx_ * k.h) * mcusy_ * k.v;
      std::fill(k.coef_bits, k.coef_bits + 64, -1);
    }
    // every data unit takes at least one bit of Huffman-coded data: a
    // header that claims more is refused before any allocation
    // (arithmetic coding may code a unit in less, and is held to the pixel
    // limit only)
    if (!arith_ && units > 8 * static_cast<int64_t>(n_) + 64)
      fail(kCorrupt, "JPEG: the frame header claims %dx%d pixels, more "
                     "than the file's %zu bytes can code", width_, height_,
           n_);
  }

  // jstdhuff.c std_huff_tables, at the first scan of a sequential
  // Huffman-coded file (jdhuff.c jinit_huff_decoder; the progressive and
  // lossless decoders install none, and libjpeg refuses such a file)
  void standard_tables() {
    if (!dc_[0].defined) build_table(dc_[0], kStdCounts[0], kStdDc, 12);
    if (!ac_[0].defined) build_table(ac_[0], kStdCounts[1], kStdAcLuma, 162);
    if (!dc_[1].defined) build_table(dc_[1], kStdCounts[2], kStdDc, 12);
    if (!ac_[1].defined)
      build_table(ac_[1], kStdCounts[3], kStdAcChroma, 162);
  }

  void scan(size_t p, size_t len) {
    if (len < 1) fail(kCorrupt, "JPEG: bad scan header");
    const int ns = d_[p];
    if (ns < 1 || ns > ncomp_ || len != 4 + 2 * static_cast<size_t>(ns))
      fail(kCorrupt, "JPEG: bad scan header");
    Component* sc[4];
    for (int i = 0; i < ns; ++i) {
      const int id = d_[p + 1 + 2 * i], tables = d_[p + 2 + 2 * i];
      Component* k = nullptr;
      for (int c = 0; c < ncomp_; ++c)
        if (comp_[c].id == id) k = &comp_[c];
      if (k == nullptr) fail(kCorrupt, "JPEG: scan of unknown component %d",
                             id);
      for (int e = 0; e < i; ++e)
        if (sc[e] == k) fail(kCorrupt, "JPEG: a component twice in a scan");
      k->dc_table = tables >> 4;
      k->ac_table = tables & 15;
      if (!arith_ && (k->dc_table > 3 || k->ac_table > 3))
        fail(kCorrupt, "JPEG: bad Huffman table number");
      sc[i] = k;
    }
    const int ss = d_[p + 1 + 2 * ns], se = d_[p + 2 + 2 * ns];
    const int ah = d_[p + 3 + 2 * ns] >> 4, al = d_[p + 3 + 2 * ns] & 15;
    if (ns > 1) {
      int blocks = 0;
      for (int i = 0; i < ns; ++i) blocks += sc[i]->h * sc[i]->v;
      if (blocks > 10) fail(kCorrupt, "JPEG: more than 10 blocks in an MCU");
    }
    Kind kind;
    if (lossless_) {
      // jdlossls.c start_pass: Ss is the predictor, Al the point transform
      if (ss < 1 || ss > 7 || se != 0 || ah != 0 || al >= 8)
        fail(kCorrupt, "JPEG: bad lossless scan (predictor %d, Se %d, Ah "
                       "%d, Al %d)", ss, se, ah, al);
      kind = kLossless;
    } else {
      // jdinput.c latch_quant_tables
      for (int i = 0; i < ns; ++i) {
        Component& k = *sc[i];
        if (k.latched) continue;
        if (!qt_defined_[k.tq])
          fail(kCorrupt, "JPEG: quantization table %d not defined", k.tq);
        std::memcpy(k.quant, qt_[k.tq], sizeof k.quant);
        k.latched = true;
      }
      if (process_ != 2) {
        kind = kSequential;
      } else {
        // jdphuff.c / jdarith.c start_pass's checks
        const bool dc = ss == 0;
        bool bad = dc ? se != 0 : (ss > se || se > 63 || ns != 1);
        if (ah != 0 && al != ah - 1) bad = true;
        if (al > 13) bad = true;
        if (bad) fail(kCorrupt, "JPEG: bad progression (Ss %d, Se %d, Ah "
                                "%d, Al %d)", ss, se, ah, al);
        kind = dc ? (ah == 0 ? kDcFirst : kDcRefine)
                  : (ah == 0 ? kAcFirst : kAcRefine);
        for (int i = 0; i < ns; ++i)
          for (int k = ss; k <= se; ++k) sc[i]->coef_bits[k] = al;
      }
    }
    if (arith_) {
      clear_stats(sc, ns, kind);
      ar_.reset(d_, n_, pos_);
      ar_.limit = whole_ ? SIZE_MAX : (pos_ + kFeed - 1) / kFeed * kFeed;
    } else {
      if (scans_ == 0 && process_ < 2) standard_tables();
      for (int i = 0; i < ns; ++i) {
        const bool need_dc = kind == kSequential || kind == kDcFirst ||
                             kind == kLossless;
        const bool need_ac = kind == kSequential || kind == kAcFirst ||
                             kind == kAcRefine;
        if (need_dc && !dc_[sc[i]->dc_table].defined)
          fail(kCorrupt, "JPEG: Huffman table DC %d not defined",
               sc[i]->dc_table);
        if (need_ac && !ac_[sc[i]->ac_table].defined)
          fail(kCorrupt, "JPEG: Huffman table AC %d not defined",
               sc[i]->ac_table);
      }
      br_.reset(d_, n_, pos_);
      br_.strict = lossless_;
    }
    for (int i = 0; i < ns; ++i) sc[i]->dc_pred = dc_context_[i] = 0;
    eobrun_ = 0;

    // MCUs: one data unit of the component in a single-component scan
    // (over its own units, not the MCU-padded ones), else every
    // component's h x v units
    const int unit = lossless_ ? 1 : 8;
    int per_row, rows;
    if (ns == 1) {
      per_row = (sc[0]->dw + unit - 1) / unit;
      rows = (sc[0]->dh + unit - 1) / unit;
    } else {
      per_row = mcusx_;
      rows = mcusy_;
    }
    // a lossless file restarts on MCU rows only (jddiffct.c)
    if (lossless_ && restart_interval_ && restart_interval_ % per_row)
      fail(kUnsupported, "JPEG: a lossless restart interval of %d MCUs, "
                         "not a whole number of rows of %d MCUs",
           restart_interval_, per_row);
    std::vector<std::vector<char>> first_row;   // lossless: per component,
    if (lossless_) {                            // the row groups restarted
      for (int i = 0; i < ns; ++i) {
        Component& k = *sc[i];
        const int stride = mcusx_ * k.h;
        k.diff.assign(static_cast<size_t>(stride) * mcusy_ * k.v, 0);
        first_row.emplace_back((k.dh + k.v - 1) / k.v + 1, 0);
        first_row[i][0] = 1;
      }
    }
    const int64_t mcus = int64_t(per_row) * rows;
    int restarts_left = restart_interval_, next_rst = 0;
    int16_t* blk[10];
    int32_t* smp[10];
    int owner[10];
    for (int64_t m = 0; m < mcus; ++m) {
      const int my = static_cast<int>(m / per_row),
                mx = static_cast<int>(m % per_row);
      if (restart_interval_ && restarts_left == 0) {
        restart(next_rst, sc, ns, kind);
        next_rst = (next_rst + 1) & 7;
        restarts_left = restart_interval_;
        for (int i = 0; i < ns && lossless_; ++i)
          first_row[i][ns == 1 ? my / sc[i]->v : my] = 1;
      }
      int nb = 0;
      for (int i = 0; i < ns; ++i) {
        Component& k = *sc[i];
        const int bh = ns == 1 ? 1 : k.h, bv = ns == 1 ? 1 : k.v;
        for (int v = 0; v < bv; ++v)
          for (int h = 0; h < bh; ++h, ++nb) {
            const int64_t x = int64_t(mx) * bh + h, y = int64_t(my) * bv + v;
            owner[nb] = i;
            if (lossless_) smp[nb] = &k.diff[y * mcusx_ * k.h + x];
            else blk[nb] = &k.coef[(y * k.bw + x) * 64];
          }
      }
      if (lossless_) {
        for (int b = 0; b < nb; ++b) *smp[b] = lossless_diff(*sc[owner[b]]);
      } else if (arith_) {
        arith_mcu(kind, blk, owner, nb, sc, ss, se, al);
      } else if (!br_.insufficient) {
        for (int b = 0; b < nb; ++b)
          block(kind, *sc[owner[b]], blk[b], ss, se, al);
      }
      if (restart_interval_) --restarts_left;
    }
    if (arith_) pos_ = ar_.marker ? ar_.marker_pos : ar_.pos;
    else pos_ = br_.pos;
    for (int i = 0; i < ns && lossless_; ++i)
      undifference(*sc[i], ss, al, first_row[i]);
    ++scans_;
  }

  // The restart marker RSTn (n = expect) and the entropy decoder's reset
  // (jdhuff.c / jdarith.c process_restart).
  void restart(int expect, Component** sc, int ns, Kind kind) {
    int m;
    if (arith_ && ar_.marker) {
      m = ar_.marker_code;
      pos_ = ar_.pos;
    } else {
      pos_ = arith_ ? ar_.pos : br_.pos;
      m = next_marker();
    }
    if (m != 0xD0 + expect)
      fail(kCorrupt, "JPEG: expected the restart marker RST%d", expect);
    for (int i = 0; i < ns; ++i) sc[i]->dc_pred = dc_context_[i] = 0;
    eobrun_ = 0;
    if (!arith_) {
      br_.reset(d_, n_, pos_);
      return;
    }
    clear_stats(sc, ns, kind);
    const size_t limit = ar_.limit;
    if (pos_ > limit)
      fail(kUnsupported, "JPEG: a restart marker past byte %zu, which "
                         "libjpeg's arithmetic decoder cannot wait for "
                         "(imageio refuses the file)", limit);
    ar_.reset(d_, n_, pos_);
    ar_.limit = limit;
  }

  // jdarith.c start_pass and process_restart: the statistics of the
  // tables the scan codes with start at zero
  void clear_stats(Component** sc, int ns, Kind kind) {
    for (int i = 0; i < ns; ++i) {
      if (kind == kSequential || kind == kDcFirst)
        std::memset(dc_stats_[sc[i]->dc_table], 0, 64);
      if (kind == kSequential || kind == kAcFirst || kind == kAcRefine)
        std::memset(ac_stats_[sc[i]->ac_table], 0, 256);
    }
  }

  int dc_diff(const Component& k) {
    const int s = br_.decode(dc_[k.dc_table]);
    if (s > 15) fail(kCorrupt, "JPEG: bad DC magnitude category");
    return s ? extend(br_.get(s), s) : 0;
  }

  void add_dc(Component& k, int diff) {
    const int64_t v = int64_t(k.dc_pred) + diff;
    if (v > INT_MAX || v < INT_MIN) fail(kCorrupt, "JPEG: bad DC value");
    k.dc_pred = static_cast<int>(v);
  }

  void block(int kind, Component& k, int16_t* b, int ss, int se, int al) {
    switch (kind) {
      case kSequential: {   // jdhuff.c decode_mcu
        add_dc(k, dc_diff(k));
        b[0] = static_cast<int16_t>(k.dc_pred);
        const HuffTable& t = ac_[k.ac_table];
        for (int i = 1; i < 64; ++i) {
          const int rs = br_.decode(t), r = rs >> 4, s = rs & 15;
          if (s) {
            i += r;
            b[kNatural[i]] = static_cast<int16_t>(extend(br_.get(s), s));
          } else {
            if (r != 15) break;
            i += 15;
          }
        }
        return;
      }
      case kDcFirst:        // jdphuff.c decode_mcu_DC_first
        add_dc(k, dc_diff(k));
        b[0] = static_cast<int16_t>(static_cast<uint32_t>(k.dc_pred) << al);
        return;
      case kDcRefine:
        if (br_.get(1)) b[0] = static_cast<int16_t>(b[0] | (1 << al));
        return;
      case kAcFirst: {
        if (eobrun_ > 0) {
          --eobrun_;
          return;
        }
        const HuffTable& t = ac_[k.ac_table];
        for (int i = ss; i <= se; ++i) {
          const int rs = br_.decode(t), r = rs >> 4, s = rs & 15;
          if (s) {
            i += r;
            b[kNatural[i]] = static_cast<int16_t>(
                static_cast<uint32_t>(extend(br_.get(s), s)) << al);
          } else if (r == 15) {
            i += 15;
          } else {
            eobrun_ = (1 << r) + br_.get(r) - 1;
            break;
          }
        }
        return;
      }
      default: {            // decode_mcu_AC_refine
        const int p1 = 1 << al, m1 = -1 * (1 << al);
        const HuffTable& t = ac_[k.ac_table];
        int i = ss;
        auto correct = [&](int16_t& c) {
          if (br_.get(1) && (c & p1) == 0)
            c = static_cast<int16_t>(c >= 0 ? c + p1 : c + m1);
        };
        if (eobrun_ == 0) {
          for (; i <= se; ++i) {
            const int rs = br_.decode(t);
            int r = rs >> 4, s = rs & 15;
            if (s) {
              s = br_.get(1) ? p1 : m1;   // a new coefficient is +-1 << Al
            } else if (r != 15) {
              eobrun_ = (1 << r) + br_.get(r);
              break;
            }
            do {
              int16_t& c = b[kNatural[i]];
              if (c != 0) {
                correct(c);
              } else if (--r < 0) {
                break;
              }
              ++i;
            } while (i <= se);
            if (s) b[kNatural[i]] = static_cast<int16_t>(s);
          }
        }
        if (eobrun_ > 0) {
          for (; i <= se; ++i) {
            int16_t& c = b[kNatural[i]];
            if (c != 0) correct(c);
          }
          --eobrun_;
        }
        return;
      }
    }
  }

  // Figures F.21-F.24: a nonzero value's sign, magnitude category and bits
  // after the decision that it is nonzero. DC and AC differ in where the
  // sign is coded and in the bins of the category (returns false on a
  // magnitude overflow, where libjpeg sets ct = -1).
  bool arith_dc_value(uint8_t* stats, int ci, int tbl, int* value) {
    uint8_t* st = stats + dc_context_[ci];
    if (ar_.decode(st) == 0) {
      dc_context_[ci] = 0;
      *value = 0;
      return true;
    }
    const int sign = ar_.decode(st + 1);
    st += 2 + sign;
    int m = ar_.decode(st);
    if (m != 0) {
      st = stats + 20;
      while (ar_.decode(st)) {
        if ((m <<= 1) == 0x8000) return false;
        st += 1;
      }
    }
    if (m < ((1 << dac_l_[tbl]) >> 1))
      dc_context_[ci] = 0;
    else if (m > ((1 << dac_u_[tbl]) >> 1))
      dc_context_[ci] = 12 + sign * 4;
    else
      dc_context_[ci] = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ar_.decode(st)) v |= m;
    v += 1;
    *value = sign ? -v : v;
    return true;
  }

  // decode_mcu / decode_mcu_AC_first's coefficients Ss..Se of one block
  // (false on a spectral or magnitude overflow)
  bool arith_ac(int16_t* b, int tbl, int ss, int se, int al) {
    uint8_t* stats = ac_stats_[tbl];
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = stats + 3 * (k - 1);
      if (ar_.decode(st)) break;   // EOB
      while (ar_.decode(st + 1) == 0) {
        st += 3;
        if (++k > se) return false;
      }
      const int sign = ar_.decode(&fixed_bin_);
      st += 2;
      int m = ar_.decode(st);
      if (m != 0 && ar_.decode(st)) {
        m <<= 1;
        st = stats + (k <= dac_k_[tbl] ? 189 : 217);
        while (ar_.decode(st)) {
          if ((m <<= 1) == 0x8000) return false;
          st += 1;
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ar_.decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      b[kNatural[k]] = static_cast<int16_t>(static_cast<uint32_t>(v) << al);
    }
    return true;
  }

  // jdarith.c's MCU decoders. A decoding error (ct = -1) leaves the rest of
  // the MCU and every later MCU up to the next restart as they are, except
  // in a DC refinement scan, which never sets it.
  void arith_mcu(int kind, int16_t** blk, const int* owner, int nb,
                 Component** sc, int ss, int se, int al) {
    if (kind == kDcRefine) {
      for (int b = 0; b < nb; ++b)
        if (ar_.decode(&fixed_bin_))
          blk[b][0] = static_cast<int16_t>(blk[b][0] | (1 << al));
      return;
    }
    if (ar_.ct == -1) return;
    if (kind == kAcRefine) {
      if (!arith_ac_refine(blk[0], sc[0]->ac_table, ss, se, al)) ar_.ct = -1;
      return;
    }
    if (kind == kAcFirst) {
      if (!arith_ac(blk[0], sc[0]->ac_table, ss, se, al)) ar_.ct = -1;
      return;
    }
    for (int b = 0; b < nb; ++b) {
      const int ci = owner[b];
      Component& k = *sc[ci];
      int diff;
      if (!arith_dc_value(dc_stats_[k.dc_table], ci, k.dc_table, &diff)) {
        ar_.ct = -1;
        return;
      }
      k.dc_pred = (k.dc_pred + diff) & 0xFFFF;
      if (kind == kDcFirst) {
        blk[b][0] = static_cast<int16_t>(
            static_cast<uint32_t>(k.dc_pred) << al);
        continue;
      }
      blk[b][0] = static_cast<int16_t>(k.dc_pred);
      if (!arith_ac(blk[b], k.ac_table, 1, 63, 0)) {
        ar_.ct = -1;
        return;
      }
    }
  }

  // decode_mcu_AC_refine: one more bit of the coefficients Ss..Se
  bool arith_ac_refine(int16_t* b, int tbl, int ss, int se, int al) {
    uint8_t* stats = ac_stats_[tbl];
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int kex = se;
    for (; kex > 0; --kex)
      if (b[kNatural[kex]]) break;
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = stats + 3 * (k - 1);
      if (k > kex && ar_.decode(st)) break;   // EOB
      for (;;) {
        int16_t& c = b[kNatural[k]];
        if (c) {
          if (ar_.decode(st + 2))
            c = static_cast<int16_t>(c < 0 ? c + m1 : c + p1);
          break;
        }
        if (ar_.decode(st + 1)) {
          c = static_cast<int16_t>(ar_.decode(&fixed_bin_) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se) return false;
      }
    }
    return true;
  }

  // jdlhuff.c: one sample's difference
  int32_t lossless_diff(const Component& k) {
    const int s = br_.decode(dc_[k.dc_table]);
    if (s > 16) fail(kCorrupt, "JPEG: bad lossless difference category");
    if (s == 16) return 32768;
    return s ? extend(br_.get(s), s) : 0;
  }

  // jdpred.c and jdlossls.c: the samples from their differences under the
  // scan's predictor (psv 1-7), the first row of the scan and of each
  // restart interval predicted from the left (its first sample from
  // 2^(P - Pt - 1)), every later row's first sample from above; then the
  // point transform Pt. first[g] marks the row groups (of v rows, one
  // iMCU row) during whose decoding a restart came: the group's first row
  // is predicted as a first row.
  void undifference(Component& k, int psv, int al,
                    const std::vector<char>& first) {
    const int W = k.dw, stride = k.bw * 8, ds = mcusx_ * k.h;
    const int init = 1 << (8 - al - 1);
    std::vector<int> prev(W), cur(W);
    for (int y = 0; y < k.dh; ++y) {
      const int32_t* d = &k.diff[int64_t(y) * ds];
      if (y % k.v == 0 && first[y / k.v]) {
        int ra = (d[0] + init) & 0xFFFF;
        cur[0] = ra;
        for (int x = 1; x < W; ++x) cur[x] = ra = (d[x] + ra) & 0xFFFF;
      } else {
        int rb = prev[0], rc;
        int ra = (d[0] + rb) & 0xFFFF;
        cur[0] = ra;
        for (int x = 1; x < W; ++x) {
          rc = rb;
          rb = prev[x];
          int pred;
          switch (psv) {
            case 1: pred = ra; break;
            case 2: pred = rb; break;
            case 3: pred = rc; break;
            case 4: pred = ra + rb - rc; break;
            case 5: pred = ra + ((rb - rc) >> 1); break;
            case 6: pred = rb + ((ra - rc) >> 1); break;
            default: pred = (ra + rb) >> 1; break;
          }
          cur[x] = ra = (d[x] + pred) & 0xFFFF;
        }
      }
      uint8_t* o = &k.plane[int64_t(y) * stride];
      for (int x = 0; x < W; ++x) o[x] = static_cast<uint8_t>(cur[x] << al);
      prev.swap(cur);
    }
    std::vector<int32_t>().swap(k.diff);
  }

  // jdcoefct.c smoothing_ok: libjpeg smooths the blocks of a progressive
  // file whose scans leave any of the first nine AC coefficients unrefined
  bool smoothing_ok() const {
    static constexpr int kPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (int c = 0; c < ncomp_; ++c) {
      const Component& k = comp_[c];
      if (!k.latched) return false;
      for (int q : kPos)
        if (k.quant[q] == 0) return false;
      if (k.coef_bits[0] < 0) return false;
      for (int i = 1; i < 10; ++i)
        if (k.coef_bits[i] != 0) useful = true;
    }
    return useful;
  }

  void inverse_dct(Component& k) {
    static const uint16_t kZero[64] = {};
    const int stride = k.bw * 8;
    k.plane.assign(static_cast<size_t>(stride) * k.bh * 8, 0);
    const uint16_t* q = k.latched ? k.quant : kZero;
    for (int by = 0; by < k.bh; ++by)
      for (int bx = 0; bx < k.bw; ++bx)
        idct_islow(&k.coef[(int64_t(by) * k.bw + bx) * 64], q,
                   &k.plane[int64_t(by) * 8 * stride + bx * 8], stride);
  }

  // jdcoefct.c decompress_smooth_data (libjpeg-turbo 2.1 and later): each
  // block's coefficients 1-9 that are still zero and not known to be exact
  // are estimated from the DC values of its 5 x 5 neighbourhood, and where
  // no AC coefficient of the component has been coded at all the DC value
  // is smoothed too; then the IDCT. The neighbourhood's rows follow
  // libjpeg's iMCU-row arithmetic, whose last iMCU row counts its rows
  // with that row's own height.
  void smooth_idct(Component& k) {
    const int stride = k.bw * 8;
    k.plane.assign(static_cast<size_t>(stride) * k.bh * 8, 0);
    const int* bits = k.coef_bits;
    bool change_dc = true;
    for (int i = 1; i < 10; ++i)
      if (bits[i] != -1) change_dc = false;
    const int64_t Q00 = k.quant[0], Q01 = k.quant[1], Q10 = k.quant[8],
                  Q20 = k.quant[16], Q11 = k.quant[9], Q02 = k.quant[2],
                  Q03 = k.quant[3], Q12 = k.quant[10], Q21 = k.quant[17],
                  Q30 = k.quant[24];
    const int wib = (k.dw + 7) / 8, hib = (k.dh + 7) / 8;
    const int total = mcusy_, v = k.v;
    const int last_col = wib - 1;
    auto estimate = [](int64_t num, int64_t q, int al) {
      int pred;
      if (num >= 0) {
        pred = static_cast<int>(((q << 7) + num) / (q << 8));
        if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      } else {
        pred = static_cast<int>(((q << 7) - num) / (q << 8));
        if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
        pred = -pred;
      }
      return static_cast<int16_t>(pred);
    };
    int16_t ws[64];
    for (int r = 0; r < total; ++r) {
      int block_rows = v;
      if (r == total - 1) {
        block_rows = hib % v;
        if (block_rows == 0) block_rows = v;
      }
      const int image_rows = block_rows * total;
      for (int br = 0; br < block_rows; ++br) {
        const int ibr = r * block_rows + br, row = r * v + br;
        auto at = [&](int y) { return &k.coef[int64_t(y) * k.bw * 64]; };
        const int16_t* cur = at(row);
        const int16_t* prev = ibr > 0 ? at(row - 1) : cur;
        const int16_t* pprev = ibr > 1 ? at(row - 2) : prev;
        const int16_t* next = ibr < image_rows - 1 ? at(row + 1) : cur;
        const int16_t* nnext = ibr < image_rows - 2 ? at(row + 2) : next;
        int DC01, DC02, DC03, DC04, DC05, DC06, DC07, DC08, DC09, DC10,
            DC11, DC12, DC13, DC14, DC15, DC16, DC17, DC18, DC19, DC20,
            DC21, DC22, DC23, DC24, DC25;
        DC01 = DC02 = DC03 = DC04 = DC05 = pprev[0];
        DC06 = DC07 = DC08 = DC09 = DC10 = prev[0];
        DC11 = DC12 = DC13 = DC14 = DC15 = cur[0];
        DC16 = DC17 = DC18 = DC19 = DC20 = next[0];
        DC21 = DC22 = DC23 = DC24 = DC25 = nnext[0];
        for (int bn = 0; bn <= last_col; ++bn) {
          const int64_t o = int64_t(bn) * 64;
          std::memcpy(ws, cur + o, sizeof ws);
          if (bn == 0 && bn < last_col) {
            DC04 = DC05 = pprev[o + 64];
            DC09 = DC10 = prev[o + 64];
            DC14 = DC15 = cur[o + 64];
            DC19 = DC20 = next[o + 64];
            DC24 = DC25 = nnext[o + 64];
          }
          if (bn + 1 < last_col) {
            DC05 = pprev[o + 128];
            DC10 = prev[o + 128];
            DC15 = cur[o + 128];
            DC20 = next[o + 128];
            DC25 = nnext[o + 128];
          }
          int al;
          if ((al = bits[1]) != 0 && ws[1] == 0) {
            const int64_t num = Q00 * (change_dc ?
                (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 -
                 13 * DC09 + 3 * DC10 - 3 * DC11 + 38 * DC12 - 38 * DC14 +
                 3 * DC15 - 3 * DC16 + 13 * DC17 - 13 * DC19 + 3 * DC20 -
                 DC21 - DC22 + DC24 + DC25) :
                (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15));
            ws[1] = estimate(num, Q01, al);
          }
          if ((al = bits[2]) != 0 && ws[8] == 0) {
            const int64_t num = Q00 * (change_dc ?
                (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 +
                 13 * DC07 + 38 * DC08 + 13 * DC09 - DC10 + DC16 -
                 13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 + DC21 +
                 3 * DC22 + 3 * DC23 + 3 * DC24 + DC25) :
                (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23));
            ws[8] = estimate(num, Q10, al);
          }
          if ((al = bits[3]) != 0 && ws[16] == 0) {
            const int64_t num = Q00 * (change_dc ?
                (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 -
                 14 * DC13 - 5 * DC14 + 2 * DC17 + 7 * DC18 + 2 * DC19 +
                 DC23) :
                (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23));
            ws[16] = estimate(num, Q20, al);
          }
          if ((al = bits[4]) != 0 && ws[9] == 0) {
            const int64_t num = Q00 * (change_dc ?
                (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 +
                 DC21 - DC25) :
                (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 -
                 DC24 + DC04 - DC06 + 10 * DC07 - 10 * DC09));
            ws[9] = estimate(num, Q11, al);
          }
          if ((al = bits[5]) != 0 && ws[2] == 0) {
            const int64_t num = Q00 * (change_dc ?
                (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 -
                 14 * DC13 + 7 * DC14 + DC15 + 2 * DC17 - 5 * DC18 +
                 2 * DC19) :
                (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15));
            ws[2] = estimate(num, Q02, al);
          }
          if (change_dc) {
            if ((al = bits[6]) != 0 && ws[3] == 0)
              ws[3] = estimate(Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 +
                                      DC17 - DC19), Q03, al);
            if ((al = bits[7]) != 0 && ws[10] == 0)
              ws[10] = estimate(Q00 * (DC07 - 3 * DC08 + DC09 - DC17 +
                                       3 * DC18 - DC19), Q12, al);
            if ((al = bits[8]) != 0 && ws[17] == 0)
              ws[17] = estimate(Q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 +
                                       DC17 - DC19), Q21, al);
            if ((al = bits[9]) != 0 && ws[24] == 0)
              ws[24] = estimate(Q00 * (DC07 + 2 * DC08 + DC09 - DC17 -
                                       2 * DC18 - DC19), Q30, al);
            const int64_t num = Q00 *
                (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 -
                 6 * DC06 + 6 * DC07 + 42 * DC08 + 6 * DC09 - 6 * DC10 -
                 8 * DC11 + 42 * DC12 + 152 * DC13 + 42 * DC14 -
                 8 * DC15 - 6 * DC16 + 6 * DC17 + 42 * DC18 + 6 * DC19 -
                 6 * DC20 - 2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 -
                 2 * DC25);
            ws[0] = estimate(num, Q00, 0);
          }
          idct_islow(ws, k.quant,
                     &k.plane[int64_t(row) * 8 * stride + bn * 8], stride);
          DC01 = DC02; DC02 = DC03; DC03 = DC04; DC04 = DC05;
          DC06 = DC07; DC07 = DC08; DC08 = DC09; DC09 = DC10;
          DC11 = DC12; DC12 = DC13; DC13 = DC14; DC14 = DC15;
          DC16 = DC17; DC17 = DC18; DC18 = DC19; DC19 = DC20;
          DC21 = DC22; DC22 = DC23; DC23 = DC24; DC24 = DC25;
        }
      }
    }
  }

  // jdsample.c: the component's samples at full resolution, width_ x
  // height_, row-major. Fancy upsampling (a DCT file's h2v1, h2v2 and h1v2
  // ratios, the first two where dw > 2) is a triangle filter over the dw x
  // dh real samples with the edges replicated; every other whole ratio,
  // and every ratio of a lossless file, replicates (int_upsample).
  std::vector<uint8_t> upsample(const Component& k) const {
    std::vector<uint8_t> out(static_cast<size_t>(width_) * height_);
    const int rh = hmax_ / k.h, rv = vmax_ / k.v, stride = k.bw * 8;
    const int dw = k.dw;
    const bool fancy = !lossless_ && ((rh == 2 && rv <= 2 && dw > 2) ||
                                      (rh == 1 && rv == 2));
    if (!fancy) {
      for (int y = 0; y < height_; ++y) {
        const uint8_t* near = k.plane.data() + int64_t(y / rv) * stride;
        uint8_t* o = &out[int64_t(y) * width_];
        for (int x = 0; x < width_; ++x) o[x] = near[x / rh];
      }
      return out;
    }
    // a row's column sums (3 * nearer + farther row where rv is 2), with
    // the edge columns replicated at 0 and dw + 1; a pair of outputs per
    // column where rh is 2
    std::vector<int> col(dw + 2);
    std::vector<uint8_t> row(2 * static_cast<size_t>(dw));
    for (int y = 0; y < height_; ++y) {
      const int iy = y / rv;
      const uint8_t* near = k.plane.data() + int64_t(iy) * stride;
      const int fy = std::clamp((y & 1) ? iy + 1 : iy - 1, 0, k.dh - 1);
      const uint8_t* far = k.plane.data() + int64_t(fy) * stride;
      uint8_t* o = &out[int64_t(y) * width_];
      if (rv == 2) {
        for (int x = 0; x < dw; ++x) col[x + 1] = 3 * near[x] + far[x];
      } else {
        for (int x = 0; x < dw; ++x) col[x + 1] = near[x];
      }
      col[0] = col[1];
      col[dw + 1] = col[dw];
      if (rh == 1) {                       // h1v2
        const int bias = (y & 1) ? 2 : 1;
        for (int x = 0; x < width_; ++x)
          o[x] = static_cast<uint8_t>((col[x + 1] + bias) >> 2);
        continue;
      }
      // h2v1 fancy: biases 1 and 2 over 4; h2v2 fancy: 8 and 7 over 16
      const int shift = rv == 2 ? 4 : 2;
      const int b0 = rv == 2 ? 8 : 1, b1 = rv == 2 ? 7 : 2;
      for (int j = 0; j < dw; ++j) {
        const int here = 3 * col[j + 1];
        row[2 * j] = static_cast<uint8_t>((here + col[j] + b0) >> shift);
        row[2 * j + 1] =
            static_cast<uint8_t>((here + col[j + 2] + b1) >> shift);
      }
      std::memcpy(o, row.data(), width_);
    }
    return out;
  }

  void write_pixels(uint8_t* out) const {
    std::vector<uint8_t> full[4];
    const uint8_t* src[4];
    int64_t stride[4];
    for (int c = 0; c < ncomp_; ++c) {
      const Component& k = comp_[c];
      if (k.h == hmax_ && k.v == vmax_) {
        src[c] = k.plane.data();
        stride[c] = k.bw * 8;
      } else {
        full[c] = upsample(k);
        src[c] = full[c].data();
        stride[c] = width_;
      }
    }
    if (ncomp_ == 1) {
      for (int y = 0; y < height_; ++y)
        std::memcpy(out + int64_t(y) * width_, src[0] + y * stride[0],
                    width_);
      return;
    }
    // jdapimin.c default_decompress_parms: three components are YCbCr
    // unless an Adobe transform 0, the IDs R, G, B or (without JFIF) a
    // lossless frame say RGB; four are CMYK unless an Adobe marker with a
    // nonzero transform says YCCK
    bool ycc = true;
    if (ncomp_ == 4) ycc = adobe_ && adobe_transform_ != 0;
    else if (!jfif_ && adobe_) ycc = adobe_transform_ != 0;
    else if (!jfif_ && (lossless_ || (comp_[0].id == 82 &&
                                      comp_[1].id == 71 && comp_[2].id == 66)))
      ycc = false;   // libjpeg-turbo 3 takes a lossless file for RGB
    if (ycc && lossless_)
      fail(kUnsupported, "JPEG: a lossless file in %s: libjpeg-turbo "
                         "converts no colour in lossless mode",
           ncomp_ == 4 ? "YCCK" : "YCbCr");
    // jdcolor.c build_ycc_rgb_table
    auto fix = [](double x) {
      return static_cast<int64_t>(x * (1 << 16) + 0.5);
    };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + (1 << 15)) >> 16);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + (1 << 15)) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + (1 << 15);
    }
    auto clamp8 = [](int v) {
      return static_cast<uint8_t>(std::clamp(v, 0, 255));
    };
    const int nc = ncomp_;
    for (int y = 0; y < height_; ++y) {
      const uint8_t* a = src[0] + y * stride[0];
      const uint8_t* b = src[1] + y * stride[1];
      const uint8_t* c = src[2] + y * stride[2];
      uint8_t* o = out + int64_t(y) * width_ * nc;
      if (nc == 4) {
        // CMYK passes through, YCCK is ycck_cmyk_convert; then Pillow's
        // "CMYK;I" unpacking (Adobe's inverted CMYK) inverts each sample
        const uint8_t* kk = src[3] + y * stride[3];
        for (int x = 0; x < width_; ++x, o += 4) {
          if (ycc) {
            const int yy = a[x], cb = b[x], cr = c[x];
            o[0] = clamp8(255 - (yy + cr_r[cr]));
            o[1] = clamp8(255 - (yy + static_cast<int>(
                                          (cb_g[cb] + cr_g[cr]) >> 16)));
            o[2] = clamp8(255 - (yy + cb_b[cb]));
          } else {
            o[0] = a[x];
            o[1] = b[x];
            o[2] = c[x];
          }
          o[3] = kk[x];
          for (int i = 0; i < 4; ++i) o[i] = static_cast<uint8_t>(255 - o[i]);
        }
        continue;
      }
      if (!ycc) {
        for (int x = 0; x < width_; ++x, o += 3) {
          o[0] = a[x];
          o[1] = b[x];
          o[2] = c[x];
        }
        continue;
      }
      for (int x = 0; x < width_; ++x, o += 3) {
        const int yy = a[x], cb = b[x], cr = c[x];
        o[0] = clamp8(yy + cr_r[cr]);
        o[1] = clamp8(yy + static_cast<int>((cb_g[cb] + cr_g[cr]) >> 16));
        o[2] = clamp8(yy + cb_b[cb]);
      }
    }
  }
};

int report(const Failure& f, char* msg, int64_t cap) {
  if (msg != nullptr && cap > 0) {
    std::strncpy(msg, f.msg.c_str(), static_cast<size_t>(cap) - 1);
    msg[cap - 1] = '\0';
  }
  return f.code;
}

template <typename F>
int guarded(char* msg, int64_t cap, F&& fn) {
  try {
    fn();
    return kOk;
  } catch (const Failure& f) {
    return report(f, msg, cap);
  } catch (const std::bad_alloc&) {
    return report(Failure{kNoRoom, "JPEG: out of memory"}, msg, cap);
  } catch (...) {
    return report(Failure{kCorrupt, "JPEG: internal error"}, msg, cap);
  }
}

}  // namespace jpeg

}  // namespace

extern "C" {

// points: (frames, n_points, 3) float32; out: (frames, G*G*G) float32
// (zeroed here).  Reference semantics (utils/dataset_utils.py:21-31) with
// an index clamp as the out-of-range guard.
void nm_voxelize_batch(const float* points, int64_t frames,
                       int64_t n_points, int grid, float* out) {
  const float bmin = -1.0f;
  const float step = 2.0f / static_cast<float>(grid) + 1e-5f;
  const int64_t cells = static_cast<int64_t>(grid) * grid * grid;

  parallel_for(frames, [&](int64_t f) {
    const float* p = points + f * n_points * 3;
    float* g = out + f * cells;
    std::memset(g, 0, cells * sizeof(float));
    for (int64_t n = 0; n < n_points; ++n) {
      int ix = static_cast<int>((p[n * 3 + 0] - bmin) / step);
      int iy = static_cast<int>((p[n * 3 + 1] - bmin) / step);
      int iz = static_cast<int>((p[n * 3 + 2] - bmin) / step);
      ix = std::clamp(ix, 0, grid - 1);
      iy = std::clamp(iy, 0, grid - 1);
      iz = std::clamp(iz, 0, grid - 1);
      g[(static_cast<int64_t>(ix) * grid + iy) * grid + iz] = 1.0f;
    }
  });
}

// seq: (T, N, 3) float32 normalized in place into [-1, 1]^3 by the
// clip-wide bbox; optional joints (T, K, 3) co-normalized.
// Matches utils/dataset_utils.py:9-19 (incl. the 1e-5 denominator guard).
void nm_normalize_episodic(float* seq, int64_t T, int64_t N, float scale,
                           float x_trans, float z_trans, float* joints,
                           int64_t K) {
  float bmin[3] = {INFINITY, INFINITY, INFINITY};
  float bmax[3] = {-INFINITY, -INFINITY, -INFINITY};
  const int64_t total = T * N;
  for (int64_t i = 0; i < total; ++i) {
    for (int d = 0; d < 3; ++d) {
      const float v = seq[i * 3 + d];
      bmin[d] = std::min(bmin[d], v);
      bmax[d] = std::max(bmax[d], v);
    }
  }
  float blen = std::max({bmax[0] - bmin[0], bmax[1] - bmin[1],
                         bmax[2] - bmin[2]});
  const float inv = scale / (blen + 1e-5f);
  const float trans[3] = {x_trans, 0.0f, z_trans};
  parallel_for(T, [&](int64_t t) {
    float* row = seq + t * N * 3;
    for (int64_t n = 0; n < N; ++n)
      for (int d = 0; d < 3; ++d)
        row[n * 3 + d] =
            (row[n * 3 + d] - bmin[d]) * inv * 2.0f - 1.0f + trans[d];
    if (joints != nullptr) {
      float* jrow = joints + t * K * 3;
      for (int64_t k = 0; k < K; ++k)
        for (int d = 0; d < 3; ++d)
          jrow[k * 3 + d] = (jrow[k * 3 + d] - bmin[d]) * inv * 2.0f - 1.0f;
    }
  });
}

// src: (T_in, N, C) -> dst: (T, N, C) strided window
void nm_crop_strided(const float* src, float* dst, int64_t start, int64_t T,
                     int64_t sample_rate, int64_t frame_elems) {
  parallel_for(T, [&](int64_t t) {
    std::memcpy(dst + t * frame_elems,
                src + (start + t * sample_rate) * frame_elems,
                frame_elems * sizeof(float));
  });
}

// GIF's variable-width LZW (GIF89a, appendix F) of n palette indices with
// minimum code size mcs (2..8): a clear code first, a clear code whenever
// the table reaches 4096 entries, then end-of-information. Codes are packed
// LSB first into out (capacity cap bytes). Returns the bytes written, or
// -1 when cap is too small. The string table is a (prefix, byte) -> code
// array stamped with a generation number, so a clear costs nothing.
int64_t nm_gif_lzw(const uint8_t* idx, int64_t n, int mcs, uint8_t* out,
                   int64_t cap) {
  const int clear = 1 << mcs, eoi = clear + 1;
  std::vector<uint32_t> table(4096 * 256, 0);
  uint32_t gen = 1;
  int next_code = clear + 2, code_size = mcs + 1;
  uint64_t acc = 0;
  int bits = 0;
  int64_t len = 0;
  bool overflow = false;
  auto emit = [&](int code) {
    acc |= static_cast<uint64_t>(code) << bits;
    bits += code_size;
    while (bits >= 8) {
      if (len < cap) out[len] = static_cast<uint8_t>(acc & 0xFF);
      else overflow = true;
      ++len;
      acc >>= 8;
      bits -= 8;
    }
  };
  emit(clear);
  if (n == 0) {
    emit(eoi);
  } else {
    int prefix = idx[0];
    for (int64_t i = 1; i < n; ++i) {
      const int c = idx[i];
      const uint32_t key = static_cast<uint32_t>(prefix) * 256 + c;
      const uint32_t e = table[key];
      if ((e >> 12) == gen) {
        prefix = static_cast<int>(e & 0xFFF);
        continue;
      }
      emit(prefix);
      if (next_code < 4096) {
        table[key] = (gen << 12) | static_cast<uint32_t>(next_code);
        // the decoder adds this entry one code later: widen once the code
        // it will add next no longer fits
        if (next_code == (1 << code_size) && code_size < 12) ++code_size;
        ++next_code;
      } else {
        emit(clear);
        ++gen;
        next_code = clear + 2;
        code_size = mcs + 1;
      }
      prefix = c;
    }
    emit(prefix);
    emit(eoi);
  }
  if (bits > 0) {
    if (len < cap) out[len] = static_cast<uint8_t>(acc & 0xFF);
    else overflow = true;
    ++len;
  }
  return overflow ? -1 : len;
}

// rows: h rows of (1 + stride) bytes, each a filter type (0-4: none, sub,
// up, average, Paeth) then the filtered bytes; bpp bytes per pixel. Writes
// the h x stride unfiltered bytes to out. Returns 0, or the 1-based row of
// an unknown filter type.
int64_t nm_png_unfilter(const uint8_t* rows, int64_t h, int64_t stride,
                        int bpp, uint8_t* out) {
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* src = rows + y * (stride + 1);
    const int type = src[0];
    ++src;
    uint8_t* cur = out + y * stride;
    const uint8_t* prev = y > 0 ? out + (y - 1) * stride : nullptr;
    for (int64_t x = 0; x < stride; ++x) {
      const int a = x >= bpp ? cur[x - bpp] : 0;
      const int b = prev != nullptr ? prev[x] : 0;
      const int c = (prev != nullptr && x >= bpp) ? prev[x - bpp] : 0;
      int pred;
      switch (type) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: {
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          break;
        }
        default: return y + 1;
      }
      cur[x] = static_cast<uint8_t>(src[x] + pred);
    }
  }
  return 0;
}

// TGA run-length packets (image types 9-11): n pixels of bpp bytes each
// from src (size bytes) into out. A packet that runs past the n-th pixel
// is cut there. Returns the bytes of src consumed, or -1 when src ends
// before n pixels.
int64_t nm_tga_unrle(const uint8_t* src, int64_t size, int64_t n, int bpp,
                     uint8_t* out) {
  int64_t p = 0, i = 0;
  while (i < n) {
    if (p >= size) return -1;
    const int head = src[p++];
    const int64_t run = std::min<int64_t>((head & 0x7F) + 1, n - i);
    if (head & 0x80) {
      if (p + bpp > size) return -1;
      for (int64_t k = 0; k < run; ++k)
        std::memcpy(out + (i + k) * bpp, src + p, bpp);
      p += bpp;
    } else {
      if (p + run * bpp > size) return -1;
      std::memcpy(out + i * bpp, src + p, run * bpp);
      p += run * bpp;
    }
    i += run;
  }
  return p;
}

// GIF's LZW code stream (sub-blocks already joined) of one frame with
// minimum code size mcs (2..11) into n palette indices. Codes are read LSB
// first; a clear code resets the table; the code size grows when the next
// free code reaches 1 << size, up to 12 bits, and a full table adds nothing
// until the next clear. Stops at end-of-information, at the end of src, or
// once n indices are written. Returns the indices written, or -1 on a code
// that names no entry yet.
int64_t nm_gif_unlzw(const uint8_t* src, int64_t size, int mcs, uint8_t* out,
                     int64_t n) {
  if (mcs < 2 || mcs > 11) return -1;
  const int clear = 1 << mcs, eoi = clear + 1;
  std::vector<uint16_t> prefix(4096);
  std::vector<uint8_t> suffix(4096), first(4096);
  std::vector<uint16_t> length(4096);
  for (int i = 0; i < clear; ++i) {
    prefix[i] = 0xFFFF;
    suffix[i] = first[i] = static_cast<uint8_t>(i);
    length[i] = 1;
  }
  int next = clear + 2, code_size = mcs + 1, prev = -1;
  uint64_t acc = 0;
  int bits = 0;
  int64_t pos = 0, written = 0;
  while (written < n) {
    while (bits < code_size && pos < size) {
      acc |= static_cast<uint64_t>(src[pos++]) << bits;
      bits += 8;
    }
    if (bits < code_size) break;   // the data ends
    const int code = static_cast<int>(acc & ((1u << code_size) - 1));
    acc >>= code_size;
    bits -= code_size;
    if (code == clear) {
      next = clear + 2;
      code_size = mcs + 1;
      prev = -1;
      continue;
    }
    if (code == eoi) break;
    if (prev < 0) {            // the first code after a clear: a literal
      if (code >= clear) return -1;
      out[written++] = static_cast<uint8_t>(code);
      prev = code;
      continue;
    }
    if (code > next || (code == next && next >= 4096)) return -1;
    const int entry = code < next ? code : prev;
    const uint8_t head = first[entry];
    if (next < 4096) {         // add prev + the first byte of this string
      prefix[next] = static_cast<uint16_t>(prev);
      suffix[next] = head;
      first[next] = first[prev];
      length[next] = static_cast<uint16_t>(length[prev] + 1);
      ++next;
      if (next == (1 << code_size) && code_size < 12) ++code_size;
    }
    // write the string of code (now in the table) backwards
    const int len = length[code];
    const int64_t keep = std::min<int64_t>(len, n - written);
    int c = code;
    for (int k = len - 1; k >= 0; --k) {
      if (k < keep) out[written + k] = suffix[c];
      c = prefix[c];
    }
    written += keep;
    prev = code;
  }
  return written;
}

// TIFF's LZW (compression 5) of one strip or tile, as tifffile's
// decode_lzw reads it: codes MSB first, 9 bits after a clear, widening
// one code early (at table sizes 511, 1023, 2047); the stream must start
// with a clear code; it ends at end-of-information or once a code reaches
// the end of src (that code unused). With libtiff set, as libtiff's
// LZWDecode reads it instead: a code that fits in src is used. At most
// cap bytes are written. Returns the bytes written, -1 when the stream
// does not start with a clear code, or -2 - n on a code that names no
// entry, n bytes having been written before it.
int64_t nm_tiff_unlzw(const uint8_t* src, int64_t size, uint8_t* out,
                      int64_t cap, int32_t libtiff) {
  if (size < 4 && !libtiff) return -1;
  const int64_t max_bits = size * 8 + (libtiff ? 1 : 0);
  int64_t bitpos = 0;
  auto read_code = [&](int width) {
    uint32_t v = 0;
    const int64_t start = bitpos >> 3;
    for (int k = 0; k < 4; ++k)
      v = (v << 8) | (start + k < size ? src[start + k] : 0u);
    v <<= (bitpos & 7);
    return static_cast<int>(v >> (32 - width));
  };
  if (size * 8 < 9 || read_code(9) != 256) return -1;
  std::vector<int32_t> prefix(4096, -1);
  std::vector<uint8_t> suffix(4096), first(4096);
  std::vector<int32_t> length(4096, 1);
  for (int i = 0; i < 256; ++i) suffix[i] = first[i] = static_cast<uint8_t>(i);
  int64_t table = 258, written = 0;
  int width = 9, old = 0;
  auto emit = [&](int code) {
    const int len = length[code];
    int c = code;
    for (int k = len - 1; k >= 0; --k) {
      if (written + k < cap) out[written + k] = suffix[c];
      c = prefix[c];
    }
    written = std::min<int64_t>(written + len, cap);
  };
  auto add = [&](int pre, uint8_t last) {
    if (table < 4096) {
      prefix[table] = pre;
      suffix[table] = last;
      first[table] = first[pre];
      length[table] = length[pre] + 1;
    }
    ++table;
  };
  while (written < cap) {
    int code = read_code(width);
    bitpos += width;
    if (code == 257 || bitpos >= max_bits) break;
    if (code == 256) {
      table = 258;
      width = 9;
      code = read_code(width);
      bitpos += width;
      if (code == 257 || (libtiff && bitpos >= max_bits)) break;
      if (code >= 256) return -2 - written;   // a fresh table: bytes only
      emit(code);
    } else {
      if (old >= table || old >= 4096) return -2 - written;
      // libtiff: "Using code not yet in table"; tifffile takes any code
      // past the table for the entry it adds
      if (libtiff && code > table) return -2 - written;
      if (code < table) {
        add(old, first[code]);
        emit(code);
      } else {                         // the entry this code adds
        add(old, first[old]);
        emit(static_cast<int>(table - 1));
      }
    }
    old = code;
    if (table == 511) width = 10;
    else if (table == 1023) width = 11;
    else if (table == 2047) width = 12;
  }
  return written;
}

// Old-style TIFF LZW (compression 5 in files of libtiff before 5.0), as
// libtiff's LZWDecodeCompat reads one strip or tile: codes LSB first, 9
// bits after a clear, widening once the table reaches 512, 1024 and 2048
// entries (no early change); it ends at end-of-information or where the
// data runs out. At most cap bytes are written. Returns the bytes written,
// or -2 - n on a code that names no entry (libtiff's "Corrupted LZW table"
// and "Wrong length of decoded string"), n bytes having been written.
int64_t nm_tiff_unlzw_compat(const uint8_t* src, int64_t size, uint8_t* out,
                             int64_t cap) {
  // libtiff's table holds 1024 entries past the 4096 that 12-bit codes
  // can name (CSIZE); it fills them before it fails
  constexpr int kTable = 4096 + 1024;
  std::vector<int32_t> prefix(kTable, -1);
  std::vector<uint8_t> suffix(kTable), first(kTable);
  std::vector<int32_t> length(kTable, 0);
  for (int i = 0; i < 256; ++i) {
    suffix[i] = first[i] = static_cast<uint8_t>(i);
    length[i] = 1;
  }
  int64_t pos = 0, written = 0, left = size * 8;
  uint64_t bits = 0;
  int nbits_in = 0, width = 9, table = 258, old = -1;
  auto next = [&]() -> int {
    if (left < width) return 257;      // not terminated: end of information
    while (nbits_in < width) {
      bits |= uint64_t(pos < size ? src[pos] : 0) << nbits_in;
      ++pos;
      nbits_in += 8;
    }
    const int code = static_cast<int>(bits & ((1u << width) - 1));
    bits >>= width;
    nbits_in -= width;
    left -= width;
    return code;
  };
  auto emit = [&](int code) {
    const int len = length[code];
    int c = code;
    for (int k = len - 1; k >= 0; --k) {
      if (written + k < cap) out[written + k] = suffix[c];
      c = prefix[c];
    }
    written = std::min<int64_t>(written + len, cap);
  };
  while (written < cap) {
    int code = next();
    if (code == 257) break;
    if (code == 256) {
      do {
        table = 258;
        width = 9;
        std::fill(length.begin() + 258, length.end(), 0);
        code = next();
      } while (code == 256);
      if (code == 257) break;
      if (code > 256) return -2 - written;
      emit(code);
      old = code;
      continue;
    }
    if (old < 0 || table >= kTable) return -2 - written;
    // the entry after old: old's string and the first byte of code's (or,
    // where code is this very entry, of old's)
    prefix[table] = old;
    first[table] = first[old];
    length[table] = length[old] + 1;
    suffix[table] = code < table ? first[code] : first[old];
    if (code > table || length[code] == 0) return -2 - written;
    ++table;
    if (table > (1 << width) - 1 && width < 12) ++width;
    emit(code);
    old = code;
  }
  return written;
}

// The pixels of a Radiance HDR file after its header, as OpenCV's rgbe.cpp
// (RGBE_ReadPixels_RLE) reads width x height of them into out (4 bytes
// each: R, G, B, E): scanlines that start 2, 2 and a width below 32768
// hold four run-length coded channels (a count past 128 repeats the next
// byte count - 128 times, a count up to 128 copies that many bytes); a
// scanline that does not start so is flat, and so is the rest of the
// image; a width below 8 or past 0x7fff is flat throughout. Returns the
// bytes read, or -1 where the data ends early (an "RGBE read error"), -2 on
// a scanline of another width ("wrong scanline width"), -3 on a count of 0
// or one past the scanline ("bad scanline data").
int64_t nm_hdr_unrle(const uint8_t* src, int64_t size, int64_t width,
                     int64_t height, uint8_t* out) {
  int64_t pos = 0;
  auto flat = [&](int64_t from) -> int64_t {
    const int64_t need = (width * height - from) * 4;
    if (size - pos < need) return -1;
    std::memcpy(out + from * 4, src + pos, static_cast<size_t>(need));
    return pos + need;
  };
  if (width < 8 || width > 0x7fff) return flat(0);
  std::vector<uint8_t> line(static_cast<size_t>(4 * width));
  for (int64_t y = 0; y < height; ++y) {
    if (size - pos < 4) return -1;
    const uint8_t* h = src + pos;
    if (h[0] != 2 || h[1] != 2 || (h[2] & 0x80)) return flat(y * width);
    pos += 4;
    if (((int64_t(h[2]) << 8) | h[3]) != width) return -2;
    for (int c = 0; c < 4; ++c) {
      uint8_t* p = line.data() + c * width;
      uint8_t* const end = p + width;
      while (p < end) {
        if (size - pos < 2) return -1;
        int count = src[pos];
        const uint8_t value = src[pos + 1];
        pos += 2;
        if (count > 128) {
          count -= 128;
          if (count > end - p) return -3;
          std::memset(p, value, static_cast<size_t>(count));
          p += count;
        } else {
          if (count == 0 || count > end - p) return -3;
          *p++ = value;
          if (--count > 0) {
            if (size - pos < count) return -1;
            std::memcpy(p, src + pos, static_cast<size_t>(count));
            p += count;
            pos += count;
          }
        }
      }
    }
    uint8_t* o = out + y * width * 4;
    for (int64_t x = 0; x < width; ++x)
      for (int c = 0; c < 4; ++c) o[x * 4 + c] = line[size_t(c * width + x)];
  }
  return pos;
}

// PackBits (TIFF compression 32773), as tifffile's decode_packbits: a
// header n < 128 copies n + 1 bytes, n > 128 repeats the next byte 257 - n
// times, 128 is skipped; a run cut by the end of src is kept as far as it
// goes. At most cap bytes are written. Returns the bytes written.
int64_t nm_packbits(const uint8_t* src, int64_t size, uint8_t* out,
                    int64_t cap) {
  int64_t i = 0, w = 0;
  while (i < size && w < cap) {
    const int n = src[i++];
    if (n < 128) {
      const int64_t take = std::min<int64_t>({n + 1, size - i, cap - w});
      std::memcpy(out + w, src + i, take);
      w += take;
      i += n + 1;
    } else if (n > 128) {
      if (i >= size) break;
      const int64_t take = std::min<int64_t>(257 - n, cap - w);
      std::memset(out + w, src[i], take);
      w += take;
      i += 1;
    }
  }
  return w;
}

// A BI_RLE8 (rle4 = 0) or BI_RLE4 (rle4 = 1) BMP's pixel data src (size
// bytes, starting at byte file_pos of the file) into width x height palette
// indices, as Pillow's BmpRleDecoder expands it: runs clipped to the row,
// end of line padding the row with index 0, a delta skipping with index 0
// (Pillow reads its two offset bytes after two it ignores), an absolute run
// of RLE4 keeping 2 * (n / 2) indices, the stream realigned to an even file
// position after each absolute run. Writes the first width * height
// indices to out; returns how many the stream gave (it may give more), or
// -1 where Pillow fails on a delta that the data cuts short.
int64_t nm_bmp_unrle(const uint8_t* src, int64_t size, int64_t file_pos,
                     int64_t width, int64_t height, int rle4, uint8_t* out) {
  const int64_t total = width * height;
  int64_t len = 0, x = 0, p = 0;
  auto put = [&](uint8_t v, int64_t count) {
    if (count <= 0) return;
    if (len < total) std::memset(out + len, v, std::min(count, total - len));
    len += count;
  };
  while (len < total) {
    if (p + 2 > size) break;
    int64_t count = src[p];
    const uint8_t byte = src[p + 1];
    p += 2;
    if (count) {                       // encoded run
      if (x + count > width) count = std::max<int64_t>(0, width - x);
      if (rle4) {
        for (int64_t k = 0; k < count; ++k)
          put(k % 2 ? byte & 0x0F : byte >> 4, 1);
      } else {
        put(byte, count);
      }
      x += count;
    } else if (byte == 0) {            // end of line
      if (len % width) put(0, width - len % width);
      x = 0;
    } else if (byte == 1) {            // end of bitmap
      break;
    } else if (byte == 2) {            // delta
      if (p + 2 > size) break;
      p += 2;
      if (p + 2 > size) return -1;
      put(0, src[p] + int64_t(src[p + 1]) * width);
      p += 2;
      x = len % width;
    } else {                           // absolute run
      const int64_t want = rle4 ? byte / 2 : byte;
      const int64_t got = std::min(want, std::max<int64_t>(0, size - p));
      for (int64_t k = 0; k < got; ++k) {
        if (rle4) {
          put(src[p + k] >> 4, 1);
          put(src[p + k] & 0x0F, 1);
        } else {
          put(src[p + k], 1);
        }
      }
      p += got;
      if (got < want) break;
      x += byte;
      if ((file_pos + p) % 2) ++p;
    }
  }
  return len;
}

// A QOI image's ops (after its 14-byte header) into n pixels of ch bytes
// (3 or 4), as Pillow's QoiDecoder reads them: the previous pixel starts
// as (0, 0, 0, 255); the index holds the 64 pixels last decoded by an op
// other than a run (an empty slot is (0, 0, 0, 0)); RGB keeps the previous
// alpha; a run repeats the previous pixel and stops at the n-th. Returns 0,
// or -1 when the data ends first.
int64_t nm_qoi_decode(const uint8_t* src, int64_t size, int64_t n, int ch,
                      uint8_t* out) {
  uint8_t index[64][4] = {};
  uint8_t px[4] = {0, 0, 0, 255};
  int64_t p = 0, i = 0;
  auto need = [&](int64_t k) { return p + k <= size; };
  while (i < n) {
    if (!need(1)) return -1;
    const int b = src[p++];
    if (b == 0xFE) {
      if (!need(3)) return -1;
      std::memcpy(px, src + p, 3);
      p += 3;
    } else if (b == 0xFF) {
      if (!need(4)) return -1;
      std::memcpy(px, src + p, 4);
      p += 4;
    } else if ((b >> 6) == 0) {
      std::memcpy(px, index[b & 63], 4);
    } else if ((b >> 6) == 1) {
      px[0] = static_cast<uint8_t>(px[0] + ((b >> 4) & 3) - 2);
      px[1] = static_cast<uint8_t>(px[1] + ((b >> 2) & 3) - 2);
      px[2] = static_cast<uint8_t>(px[2] + (b & 3) - 2);
    } else if ((b >> 6) == 2) {
      if (!need(1)) return -1;
      const int b2 = src[p++];
      const int dg = (b & 63) - 32;
      px[0] = static_cast<uint8_t>(px[0] + dg + ((b2 >> 4) - 8));
      px[1] = static_cast<uint8_t>(px[1] + dg);
      px[2] = static_cast<uint8_t>(px[2] + dg + ((b2 & 15) - 8));
    } else {
      const int64_t run = std::min<int64_t>((b & 63) + 1, n - i);
      for (int64_t k = 0; k < run; ++k, ++i) std::memcpy(out + i * ch, px, ch);
      continue;
    }
    std::memcpy(index[(px[0] * 3 + px[1] * 5 + px[2] * 7 + px[3] * 11) % 64],
                px, 4);
    std::memcpy(out + i * ch, px, ch);
    ++i;
  }
  return 0;
}

// The frame of a JPEG file: info = {width, height, channels (1, 3 or 4),
// process (the SOFn marker's n: 0-3 Huffman baseline, extended
// sequential, progressive, lossless; 9, 10 arithmetic)}. Returns 0,
// or 1 (corrupt) / 2 (unsupported) with a message in msg (msg_cap bytes).
int nm_jpeg_info(const uint8_t* data, int64_t size, int32_t* info, char* msg,
                 int64_t msg_cap) {
  return jpeg::guarded(msg, msg_cap, [&]() {
    jpeg::Decoder dec(data, static_cast<size_t>(size));
    dec.read_header();
    info[0] = dec.width();
    info[1] = dec.height();
    info[2] = dec.channels();
    info[3] = dec.process();
  });
}

// The pixels of a JPEG file into out: height x width x channels bytes
// (cap bytes available). Returns as nm_jpeg_info, or 3 when out is too
// small or memory runs out.
// whole: the arithmetic decoder reads the whole file (OpenCV's libjpeg
// source), not only the blocks Pillow has fed it.
int nm_jpeg_decode(const uint8_t* data, int64_t size, uint8_t* out,
                   int64_t cap, int32_t whole, char* msg, int64_t msg_cap) {
  return jpeg::guarded(msg, msg_cap, [&]() {
    jpeg::Decoder dec(data, static_cast<size_t>(size));
    dec.set_whole(whole != 0);
    dec.read_header();
    if (int64_t(dec.width()) * dec.height() * dec.channels() > cap)
      jpeg::fail(jpeg::kNoRoom, "JPEG: output buffer too small");
    dec.decode(out);
  });
}

int nm_version() { return 6; }

}  // extern "C"

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
//   * nm_jpeg_info / nm_jpeg_decode — a Huffman-coded 8-bit JPEG
//                          (baseline, extended sequential, progressive;
//                          1 or 3 components, sampling factors 1 or 2)
//                          decoded as libjpeg-turbo does by default: its
//                          integer IDCT, fancy upsampling and YCbCr
//                          tables, so the pixels equal Pillow's
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
// A Huffman-coded 8-bit JPEG decoder that reproduces libjpeg-turbo's
// default output (what Pillow, and through it imageio, returns): the
// integer IDCT jpeg_idct_islow (CONST_BITS 13, PASS1_BITS 2), "fancy"
// upsampling (jdsample.c: the h2v1 and h2v2 triangle filters, h1v2), the
// fixed-point YCbCr -> RGB tables of jdcolor.c (SCALEBITS 16) and the
// colour space guess of jdapimin.c (JFIF, the Adobe APP14 transform, the
// component IDs). Every read is bounds-checked; a bad file throws a
// Failure inside this namespace, which the C entry points turn into an
// error code and a message.
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
// zeros, as libjpeg does; a symbol that consumes one of them fails, since a
// well-formed file never needs them.
struct BitReader {
  const uint8_t* d = nullptr;
  size_t n = 0, pos = 0;
  uint64_t acc = 0;
  int cnt = 0;          // valid bits in acc, from its top
  int pad = 0;          // of which the last pad bits are fed zeros
  bool at_marker = false;

  void reset(const uint8_t* data, size_t size, size_t p) {
    d = data;
    n = size;
    pos = p;
    acc = 0;
    cnt = pad = 0;
    at_marker = false;
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
    if (pad > cnt) fail(kCorrupt, "JPEG: entropy-coded data ends early");
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
  Decoder(const uint8_t* data, size_t size) : d_(data), n_(size) {}

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

  // The rest of the file, then the pixels: (height, width, channels()).
  void decode(uint8_t* out) {
    for (int c = 0; c < ncomp_; ++c)
      comp_[c].coef.assign(
          static_cast<size_t>(comp_[c].bw) * comp_[c].bh * 64, 0);
    for (;;) {
      const int m = next_marker();
      if (m < 0) fail(kCorrupt, "JPEG: the data ends before the EOI marker");
      if (m == 0xD9) break;
      marker(m);   // a second frame header fails there
    }
    if (scans_ == 0) fail(kCorrupt, "JPEG: no scan");
    if (process_ == 2 && would_smooth())
      fail(kUnsupported, "JPEG: a progressive file whose scans leave low "
                         "AC coefficients unrefined (libjpeg's block "
                         "smoothing is not reproduced)");
    for (int c = 0; c < ncomp_; ++c) inverse_dct(comp_[c]);
    write_pixels(out);
  }

  int width() const { return width_; }
  int height() const { return height_; }
  int channels() const { return ncomp_; }
  int process() const { return process_; }

 private:
  const uint8_t* d_;
  size_t n_, pos_ = 0;
  int width_ = 0, height_ = 0, ncomp_ = 0, process_ = -1;
  int hmax_ = 1, vmax_ = 1, mcusx_ = 0, mcusy_ = 0;
  Component comp_[3];
  uint16_t qt_[4][64];
  bool qt_defined_[4] = {false, false, false, false};
  HuffTable dc_[4], ac_[4];
  int restart_interval_ = 0, scans_ = 0;
  bool jfif_ = false, adobe_ = false;
  int adobe_transform_ = -1;
  BitReader br_;
  int eobrun_ = 0;

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
      case 0xC0: case 0xC1: case 0xC2:
        if (process_ >= 0) fail(kCorrupt, "JPEG: a second frame header");
        p = segment(&len);
        frame(m - 0xC0, p, len);
        return true;
      case 0xC3:
        fail(kUnsupported, "JPEG: lossless JPEG (SOF3) is not supported");
      case 0xC5: case 0xC6: case 0xC7:
        fail(kUnsupported, "JPEG: hierarchical (differential, SOF%d) JPEG "
                           "is not supported", m - 0xC0);
      case 0xC9: case 0xCA: case 0xCB:
        fail(kUnsupported, "JPEG: arithmetic coding (SOF%d, %s) is not "
                           "supported", m - 0xC0,
             m == 0xC9 ? "sequential" : m == 0xCA ? "progressive"
                                                   : "lossless");
      case 0xCD: case 0xCE: case 0xCF:
        fail(kUnsupported, "JPEG: arithmetic coding in a hierarchical "
                           "(differential, SOF%d) JPEG is not supported",
             m - 0xC0);
      case 0xCC:
        fail(kUnsupported, "JPEG: arithmetic coding (DAC marker) is not "
                           "supported");
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

  void frame(int process, size_t p, size_t len) {
    if (len < 6) fail(kCorrupt, "JPEG: bad frame header");
    const int precision = d_[p];
    height_ = be16(p + 1);
    width_ = be16(p + 3);
    const int nc = d_[p + 5];
    const char* name = process == 0 ? "baseline"
                       : process == 1 ? "extended sequential"
                                      : "progressive";
    if (precision != 8)
      fail(kUnsupported, "JPEG: %d-bit samples (%s, SOF%d); only 8-bit "
                         "JPEG is read", precision, name, process);
    if (width_ == 0) fail(kCorrupt, "JPEG: frame width 0");
    if (height_ == 0)
      fail(kUnsupported, "JPEG: a DNL marker (height 0 in the frame "
                         "header) is not supported");
    if (nc == 4)
      fail(kUnsupported, "JPEG: 4-component (CMYK or YCCK) JPEG is not "
                         "supported");
    if (nc != 1 && nc != 3)
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
    }
    for (int c = 0; c < nc; ++c)
      if (comp_[c].h > 2 || comp_[c].v > 2)
        fail(kUnsupported, "JPEG: sampling factors %dx%d (above 2) are not "
                           "supported", comp_[c].h, comp_[c].v);
    process_ = process;
    ncomp_ = nc;
    for (int c = 0; c < nc; ++c) {
      hmax_ = std::max(hmax_, comp_[c].h);
      vmax_ = std::max(vmax_, comp_[c].v);
    }
    mcusx_ = (width_ + 8 * hmax_ - 1) / (8 * hmax_);
    mcusy_ = (height_ + 8 * vmax_ - 1) / (8 * vmax_);
    int64_t blocks = 0;
    for (int c = 0; c < nc; ++c) {
      Component& k = comp_[c];
      k.dw = static_cast<int>((int64_t(width_) * k.h + hmax_ - 1) / hmax_);
      k.dh = static_cast<int>((int64_t(height_) * k.v + vmax_ - 1) / vmax_);
      if (nc == 1) {
        k.bw = (k.dw + 7) / 8;
        k.bh = (k.dh + 7) / 8;
      } else {
        k.bw = mcusx_ * k.h;
        k.bh = mcusy_ * k.v;
      }
      blocks += int64_t(k.bw) * k.bh;
      std::fill(k.coef_bits, k.coef_bits + 64, -1);
    }
    // every block takes at least one bit of entropy-coded data (two in a
    // sequential file): a header that claims more is refused before any
    // allocation
    if (blocks > 8 * static_cast<int64_t>(n_) + 64)
      fail(kCorrupt, "JPEG: the frame header claims %dx%d pixels, more "
                     "than the file's %zu bytes can code", width_, height_,
           n_);
  }

  void scan(size_t p, size_t len) {
    if (len < 1) fail(kCorrupt, "JPEG: bad scan header");
    const int ns = d_[p];
    if (ns < 1 || ns > ncomp_ || len != 4 + 2 * static_cast<size_t>(ns))
      fail(kCorrupt, "JPEG: bad scan header");
    Component* sc[3];
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
      if (k->dc_table > 3 || k->ac_table > 3)
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
    // jdinput.c latch_quant_tables
    for (int i = 0; i < ns; ++i) {
      Component& k = *sc[i];
      if (k.latched) continue;
      if (!qt_defined_[k.tq])
        fail(kCorrupt, "JPEG: quantization table %d not defined", k.tq);
      std::memcpy(k.quant, qt_[k.tq], sizeof k.quant);
      k.latched = true;
    }
    enum Kind { kSequential, kDcFirst, kDcRefine, kAcFirst, kAcRefine } kind;
    if (process_ != 2) {
      kind = kSequential;
    } else {
      // jdphuff.c start_pass_phuff_decoder's checks
      const bool dc = ss == 0;
      bool bad = dc ? se != 0 : (ss > se || se > 63 || ns != 1);
      if (ah != 0 && al != ah - 1) bad = true;
      if (al > 13) bad = true;
      if (bad) fail(kCorrupt, "JPEG: bad progression (Ss %d, Se %d, Ah %d, "
                              "Al %d)", ss, se, ah, al);
      kind = dc ? (ah == 0 ? kDcFirst : kDcRefine)
                : (ah == 0 ? kAcFirst : kAcRefine);
      for (int i = 0; i < ns; ++i)
        for (int k = ss; k <= se; ++k) sc[i]->coef_bits[k] = al;
    }
    for (int i = 0; i < ns; ++i) {
      const bool need_dc = kind == kSequential || kind == kDcFirst;
      const bool need_ac = kind == kSequential || kind == kAcFirst ||
                           kind == kAcRefine;
      if (need_dc && !dc_[sc[i]->dc_table].defined)
        fail(kCorrupt, "JPEG: Huffman table DC %d not defined",
             sc[i]->dc_table);
      if (need_ac && !ac_[sc[i]->ac_table].defined)
        fail(kCorrupt, "JPEG: Huffman table AC %d not defined",
             sc[i]->ac_table);
    }
    for (int i = 0; i < ns; ++i) sc[i]->dc_pred = 0;
    eobrun_ = 0;
    br_.reset(d_, n_, pos_);

    // MCUs: one block of the component in a single-component scan (over
    // its own blocks, not the MCU-padded ones), else every component's
    // h x v blocks
    int64_t mcus;
    int bx = 0;
    if (ns == 1) {
      bx = (sc[0]->dw + 7) / 8;
      mcus = int64_t(bx) * ((sc[0]->dh + 7) / 8);
    } else {
      mcus = int64_t(mcusx_) * mcusy_;
    }
    int restarts_left = restart_interval_, next_rst = 0;
    for (int64_t m = 0; m < mcus; ++m) {
      if (restart_interval_ && restarts_left == 0) {
        restart(next_rst);
        next_rst = (next_rst + 1) & 7;
        for (int i = 0; i < ns; ++i) sc[i]->dc_pred = 0;
        eobrun_ = 0;
        restarts_left = restart_interval_;
      }
      if (ns == 1) {
        Component& k = *sc[0];
        const int by = static_cast<int>(m / bx), bxx = static_cast<int>(m % bx);
        block(kind, k, &k.coef[(int64_t(by) * k.bw + bxx) * 64], ss, se, al);
      } else {
        const int my = static_cast<int>(m / mcusx_),
                  mx = static_cast<int>(m % mcusx_);
        for (int i = 0; i < ns; ++i) {
          Component& k = *sc[i];
          for (int v = 0; v < k.v; ++v)
            for (int h = 0; h < k.h; ++h)
              block(kind, k,
                    &k.coef[((int64_t(my) * k.v + v) * k.bw + mx * k.h + h) *
                            64],
                    ss, se, al);
        }
      }
      if (restart_interval_) --restarts_left;
    }
    pos_ = br_.pos;
    ++scans_;
  }

  void restart(int expect) {
    pos_ = br_.pos;
    const int m = next_marker();
    if (m != 0xD0 + expect)
      fail(kCorrupt, "JPEG: expected the restart marker RST%d", expect);
    br_.reset(d_, n_, pos_);
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
      case 0: {   // sequential (jdhuff.c decode_mcu)
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
      case 1:     // DC first (jdphuff.c decode_mcu_DC_first)
        add_dc(k, dc_diff(k));
        b[0] = static_cast<int16_t>(static_cast<uint32_t>(k.dc_pred) << al);
        return;
      case 2:     // DC refinement
        if (br_.get(1)) b[0] = static_cast<int16_t>(b[0] | (1 << al));
        return;
      case 3: {   // AC first
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
      default: {  // AC refinement (decode_mcu_AC_refine)
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

  // jdcoefct.c smoothing_ok: libjpeg smooths the blocks of a progressive
  // file whose scans leave any of the first nine AC coefficients unrefined
  bool would_smooth() const {
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

  // jdsample.c: the component's samples at full resolution, width_ x
  // height_, row-major. Fancy upsampling is a triangle filter over the
  // dw x dh real samples with the edges replicated; h2v1 and h2v2 fall
  // back to replication when dw <= 2.
  std::vector<uint8_t> upsample(const Component& k) const {
    std::vector<uint8_t> out(static_cast<size_t>(width_) * height_);
    const int rh = hmax_ / k.h, rv = vmax_ / k.v, stride = k.bw * 8;
    const int dw = k.dw;
    const bool fancy_h = rh == 2 && dw > 2;
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
      if (rh == 2 && !fancy_h) {           // h2v1 / h2v2 replication
        for (int x = 0; x < width_; ++x) o[x] = near[x >> 1];
        continue;
      }
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
    std::vector<uint8_t> full[3];
    const uint8_t* src[3];
    int64_t stride[3];
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
    // jdapimin.c default_decompress_parms for three components
    bool ycc = true;
    if (!jfif_ && adobe_) ycc = adobe_transform_ != 0;
    else if (!jfif_ && comp_[0].id == 82 && comp_[1].id == 71 && comp_[2].id == 66)
      ycc = false;
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
    for (int y = 0; y < height_; ++y) {
      const uint8_t* a = src[0] + y * stride[0];
      const uint8_t* b = src[1] + y * stride[1];
      const uint8_t* c = src[2] + y * stride[2];
      uint8_t* o = out + int64_t(y) * width_ * 3;
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

// The frame of a JPEG file: info = {width, height, channels (1 or 3),
// process (0 baseline, 1 extended sequential, 2 progressive)}. Returns 0,
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
int nm_jpeg_decode(const uint8_t* data, int64_t size, uint8_t* out,
                   int64_t cap, char* msg, int64_t msg_cap) {
  return jpeg::guarded(msg, msg_cap, [&]() {
    jpeg::Decoder dec(data, static_cast<size_t>(size));
    dec.read_header();
    if (int64_t(dec.width()) * dec.height() * dec.channels() > cap)
      jpeg::fail(jpeg::kNoRoom, "JPEG: output buffer too small");
    dec.decode(out);
  });
}

int nm_version() { return 3; }

}  // extern "C"

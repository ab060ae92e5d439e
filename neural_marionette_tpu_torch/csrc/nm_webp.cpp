// WebP decoder of the PyTorch/CUDA port's host library: the texture files
// of apps/retarget that the JAX package reads through imageio and Pillow
// (libwebp's WebPAnimDecoder), decoded to the same pixels. Built by
// kernels.py (g++ -O3 -std=c++17 -shared -fPIC -pthread) into _build/ at
// first use, beside nm_host, and bound in data/native.py.
//
//   * the RIFF container: "VP8 ", "VP8L", and "VP8X" with "ALPH" and an
//     animation's "ANIM"/"ANMF" (its first frame, on a canvas cleared to
//     transparent black, as WebPAnimDecoder composites it);
//   * VP8L (lossless): prefix-code groups with the meta prefix image, the
//     colour cache, LZ77 backward references with the 120-entry distance
//     map, and the four transforms (predictor with its 14 modes,
//     cross-colour, subtract-green, colour indexing with pixel bundling);
//   * VP8 (lossy key frames, RFC 6386): the boolean decoder, segments and
//     quantiser deltas, token partitions and coefficient probabilities, the
//     16x16, 4x4 and chroma intra predictors, the inverse WHT and DCT, the
//     simple and normal loop filters with sharpness and mode/ref deltas;
//     then libwebp's "fancy" chroma upsampling and its 14-bit fixed-point
//     YUV -> RGB;
//   * the alpha plane (ALPH): raw or VP8L-compressed green, under the none,
//     horizontal, vertical and gradient filters.
//
// Every read is bounds-checked. Exposed with C linkage for ctypes; nothing
// throws across that boundary: each entry point returns an error code and
// writes a message.

#include <algorithm>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <string>
#include <vector>

namespace {

enum { kOk = 0, kCorrupt = 1, kUnsupported = 2, kNoRoom = 3 };

struct Failure {
  int code;
  std::string msg;
};

[[noreturn]] void fail(int code, const char* fmt, ...) {
  char buf[240];
  va_list ap;
  va_start(ap, fmt);
  std::vsnprintf(buf, sizeof(buf), fmt, ap);
  va_end(ap);
  throw Failure{code, buf};
}

// Pillow refuses images above twice its MAX_IMAGE_PIXELS
constexpr int64_t kMaxPixels = 178956970;

inline uint32_t le24(const uint8_t* p) { return p[0] | (p[1] << 8) | (p[2] << 16); }
inline uint32_t le32(const uint8_t* p) {
  return le24(p) | (static_cast<uint32_t>(p[3]) << 24);
}

// ------------------------------------------------------------------ VP8L
namespace vp8l {

// LSB-first bit reader. Bits past the end read as 0 and set eos.
struct BitReader {
  const uint8_t* data;
  int64_t size;
  int64_t pos = 0;   // in bits
  bool eos = false;

  BitReader(const uint8_t* d, int64_t n) : data(d), size(n) {}

  uint64_t peek64() const {
    const int64_t byte = pos >> 3;
    uint64_t v = 0;
    if (byte + 8 <= size) {
      std::memcpy(&v, data + byte, 8);
    } else {
      for (int64_t k = 0; k < 8 && byte + k < size; ++k)
        v |= static_cast<uint64_t>(data[byte + k]) << (8 * k);
    }
    return v >> (pos & 7);
  }
  uint32_t peek(int n) const {
    return static_cast<uint32_t>(peek64() & ((uint64_t(1) << n) - 1));
  }
  void skip(int n) {
    pos += n;
    if (pos > size * 8) eos = true;
  }
  uint32_t read(int n) {
    if (n == 0) return 0;
    const uint32_t v = peek(n);
    skip(n);
    return v;
  }
};

constexpr int kRootBits = 8;

// A canonical prefix code, read LSB first: a root table of 2^8 entries and
// second-level tables for longer codes.
struct Code {
  struct Entry {
    uint16_t symbol;
    uint8_t len;      // 0: a second-level table, index in symbol
  };
  int single = -1;    // the symbol of a code with one symbol (0 bits)
  int sub_bits = 0;
  std::vector<Entry> root, sub;

  // false where the lengths make no valid code (none, over-subscribed or
  // incomplete)
  bool build(const int* lengths, int n) {
    int count[16] = {0};
    int nonzero = 0, last = -1;
    for (int s = 0; s < n; ++s) {
      if (lengths[s] < 0 || lengths[s] > 15) return false;
      if (lengths[s]) {
        ++count[lengths[s]];
        ++nonzero;
        last = s;
      }
    }
    if (nonzero == 0) return false;
    if (nonzero == 1) {
      single = last;
      return true;
    }
    int left = 1, max_len = 0;
    for (int len = 1; len <= 15; ++len) {
      left = left * 2 - count[len];
      if (left < 0) return false;
      if (count[len]) max_len = len;
    }
    if (left != 0) return false;
    int next[16];
    int code = 0;
    for (int len = 1; len <= 15; ++len) {
      next[len] = code;
      code = (code + count[len]) << 1;
    }
    sub_bits = std::max(0, max_len - kRootBits);
    root.assign(1 << kRootBits, Entry{0, 0});
    std::vector<int> sub_of(1 << kRootBits, -1);
    for (int s = 0; s < n; ++s) {
      const int len = lengths[s];
      if (!len) continue;
      const int c = next[len]++;
      int rev = 0;
      for (int k = 0; k < len; ++k) rev |= ((c >> (len - 1 - k)) & 1) << k;
      if (len <= kRootBits) {
        for (int i = rev; i < (1 << kRootBits); i += 1 << len)
          root[i] = Entry{static_cast<uint16_t>(s), static_cast<uint8_t>(len)};
      } else {
        const int r = rev & ((1 << kRootBits) - 1);
        if (sub_of[r] < 0) {
          sub_of[r] = static_cast<int>(sub.size() >> sub_bits);
          sub.resize(sub.size() + (size_t(1) << sub_bits), Entry{0, 0});
          root[r] = Entry{static_cast<uint16_t>(sub_of[r]), 0};
        }
        Entry* t = sub.data() + (size_t(sub_of[r]) << sub_bits);
        const int high = rev >> kRootBits, hl = len - kRootBits;
        for (int i = high; i < (1 << sub_bits); i += 1 << hl)
          t[i] = Entry{static_cast<uint16_t>(s), static_cast<uint8_t>(len)};
      }
    }
    return true;
  }

  int read(BitReader& br) const {
    if (single >= 0) return single;
    const uint32_t v = br.peek(15);
    const Entry e = root[v & ((1 << kRootBits) - 1)];
    if (e.len) {
      br.skip(e.len);
      return e.symbol;
    }
    const Entry f = sub[(size_t(e.symbol) << sub_bits) +
                        ((v >> kRootBits) & ((1u << sub_bits) - 1))];
    br.skip(f.len);
    return f.symbol;
  }
};

const int kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6,
                                  7, 8, 9, 10, 11, 12, 13, 14, 15};
const uint8_t kCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a,
    0x38, 0x05, 0x37, 0x39, 0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04,
    0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b, 0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45,
    0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56, 0x5a, 0x23, 0x2d,
    0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e,
    0x78, 0x01, 0x77, 0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e,
    0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b, 0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e,
    0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e, 0x30, 0x73, 0x7d,
    0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70};

struct Transform {
  int type;
  int bits;
  int xsize;        // width of the image it applies to
  std::vector<uint32_t> data;
};

struct Decoder {
  BitReader br;
  int height;       // of the level-0 image: every transform keeps it
  int seen = 0;
  std::vector<Transform> transforms;

  Decoder(const uint8_t* d, int64_t n, int h) : br(d, n), height(h) {}

  void check() {
    if (br.eos) fail(kCorrupt, "VP8L: the data ends before the image");
  }

  void read_code(int alphabet, Code& code) {
    std::vector<int> lengths(alphabet, 0);
    if (br.read(1)) {                       // simple code: 1 or 2 symbols
      const int n = br.read(1) + 1;
      const int first = br.read(br.read(1) ? 8 : 1);
      if (first < alphabet) lengths[first] = 1;
      if (n == 2) {
        const int second = br.read(8);
        if (second < alphabet) lengths[second] = 1;
      }
    } else {
      int cl[19] = {0};
      const int n = br.read(4) + 4;
      for (int i = 0; i < n; ++i) cl[kCodeLengthOrder[i]] = br.read(3);
      Code lc;
      if (!lc.build(cl, 19)) fail(kCorrupt, "VP8L: bad code-length code");
      int max_symbol = alphabet;
      if (br.read(1)) {
        const int nbits = 2 + 2 * br.read(3);
        max_symbol = 2 + br.read(nbits);
        if (max_symbol > alphabet)
          fail(kCorrupt, "VP8L: code lengths past the alphabet");
      }
      int prev = 8, s = 0;
      while (s < alphabet) {
        if (max_symbol-- == 0) break;
        const int c = lc.read(br);
        if (c < 16) {
          lengths[s++] = c;
          if (c) prev = c;
        } else {
          const int extra[3] = {2, 3, 7}, offset[3] = {3, 3, 11};
          const int repeat = br.read(extra[c - 16]) + offset[c - 16];
          if (s + repeat > alphabet)
            fail(kCorrupt, "VP8L: a code-length run past the alphabet");
          const int v = c == 16 ? prev : 0;
          for (int k = 0; k < repeat; ++k) lengths[s++] = v;
        }
      }
    }
    check();
    if (!code.build(lengths.data(), alphabet))
      fail(kCorrupt, "VP8L: a prefix code that is not complete");
  }

  static int subsample(int size, int bits) {
    return (size + (1 << bits) - 1) >> bits;
  }

  int copy_value(int symbol) {   // a length or distance prefix + extra bits
    if (symbol < 4) return symbol + 1;
    const int extra = (symbol - 2) >> 1;
    const int offset = (2 + (symbol & 1)) << extra;
    return offset + static_cast<int>(br.read(extra)) + 1;
  }

  // one entropy-coded image of xsize x ysize ARGB pixels; level0 reads the
  // transforms and may use a meta prefix image
  std::vector<uint32_t> decode_stream(int xsize, int ysize, bool level0) {
    if (int64_t(xsize) * ysize > kMaxPixels)
      fail(kUnsupported, "VP8L: an image of %d x %d pixels", xsize, ysize);
    int width = xsize;
    if (level0) {
      while (br.read(1)) {
        check();
        const int type = br.read(2);
        if (seen & (1 << type)) fail(kCorrupt, "VP8L: a transform twice");
        seen |= 1 << type;
        Transform t{type, 0, width, {}};
        if (type == 0 || type == 1) {
          t.bits = br.read(3) + 2;
          t.data = decode_stream(subsample(width, t.bits),
                                 subsample(height, t.bits), false);
        } else if (type == 3) {
          const int n = br.read(8) + 1;
          t.bits = n > 16 ? 0 : n > 4 ? 1 : n > 2 ? 2 : 3;
          std::vector<uint32_t> pal = decode_stream(n, 1, false);
          t.data.assign(size_t(1) << (8 >> t.bits), 0);
          uint8_t* out = reinterpret_cast<uint8_t*>(t.data.data());
          const uint8_t* in = reinterpret_cast<const uint8_t*>(pal.data());
          for (int i = 0; i < 4 * n; ++i)
            out[i] = static_cast<uint8_t>(in[i] + (i >= 4 ? out[i - 4] : 0));
          width = subsample(width, t.bits);
        }
        transforms.push_back(std::move(t));
      }
    }
    int cache_bits = 0;
    if (br.read(1)) {
      cache_bits = br.read(4);
      if (cache_bits < 1 || cache_bits > 11)
        fail(kCorrupt, "VP8L: colour cache of %d bits", cache_bits);
    }
    int meta_bits = 0, meta_xsize = 0;
    std::vector<uint32_t> meta;
    int groups = 1;
    if (level0 && br.read(1)) {
      meta_bits = br.read(3) + 2;
      meta_xsize = subsample(width, meta_bits);
      meta = decode_stream(meta_xsize, subsample(ysize, meta_bits), false);
      for (uint32_t& m : meta) {
        m = (m >> 8) & 0xFFFF;
        groups = std::max<int>(groups, m + 1);
      }
    }
    check();
    const int alphabets[5] = {256 + 24 + (cache_bits ? 1 << cache_bits : 0),
                              256, 256, 256, 40};
    // the codes of every group are read; those of groups no tile uses are
    // checked and dropped
    std::vector<int> slot(groups, meta.empty() ? 0 : -1);
    int used = meta.empty() ? 1 : 0;
    for (uint32_t& m : meta) {
      if (slot[m] < 0) slot[m] = used++;
      m = slot[m];
    }
    std::vector<Code> codes(size_t(used) * 5);
    for (int g = 0; g < groups; ++g)
      for (int j = 0; j < 5; ++j) {
        Code scratch;
        read_code(alphabets[j], slot[g] < 0 ? scratch : codes[slot[g] * 5 + j]);
      }
    std::vector<uint32_t> cache(cache_bits ? size_t(1) << cache_bits : 0, 0);
    const int64_t total = int64_t(width) * ysize;
    std::vector<uint32_t> px(static_cast<size_t>(total));
    int64_t i = 0, cached = 0;
    auto insert_cache = [&]() {
      if (!cache_bits) {
        cached = i;
        return;
      }
      for (; cached < i; ++cached)
        cache[(0x1e35a7bdu * px[cached]) >> (32 - cache_bits)] = px[cached];
    };
    while (i < total) {
      const int x = static_cast<int>(i % width), y = static_cast<int>(i / width);
      const Code* g = codes.data() +
          (meta.empty() ? 0 : size_t(meta[size_t(y >> meta_bits) * meta_xsize +
                                          (x >> meta_bits)]) * 5);
      const int code = g[0].read(br);
      if (code < 256) {
        const uint32_t r = g[1].read(br), b = g[2].read(br), a = g[3].read(br);
        px[i++] = (a << 24) | (r << 16) | (uint32_t(code) << 8) | b;
      } else if (code < 256 + 24) {
        const int length = copy_value(code - 256);
        const int dsym = g[4].read(br);
        const int dcode = copy_value(dsym);
        int64_t dist;
        if (dcode > 120) {
          dist = dcode - 120;
        } else {
          const int p = kCodeToPlane[dcode - 1];
          dist = int64_t(p >> 4) * width + (8 - (p & 15));
          if (dist < 1) dist = 1;
        }
        if (br.eos) break;
        if (dist > i || length > total - i)
          fail(kCorrupt, "VP8L: a backward reference out of the image");
        for (int k = 0; k < length; ++k, ++i) px[i] = px[i - dist];
      } else {
        insert_cache();
        px[i++] = cache[code - 256 - 24];
      }
      if (br.eos) break;
      insert_cache();
    }
    check();
    if (!level0) return px;
    for (int t = static_cast<int>(transforms.size()) - 1; t >= 0; --t)
      px = inverse(transforms[t], px, ysize);
    return px;
  }

  static uint32_t add(uint32_t a, uint32_t b) {
    return (((a & 0xff00ff00u) + (b & 0xff00ff00u)) & 0xff00ff00u) |
           (((a & 0x00ff00ffu) + (b & 0x00ff00ffu)) & 0x00ff00ffu);
  }
  static uint32_t avg2(uint32_t a, uint32_t b) {
    return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
  }
  static int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }
  static uint32_t select(uint32_t t, uint32_t l, uint32_t tl) {
    int d = 0;
    for (int s = 0; s < 32; s += 8) {
      const int a = (t >> s) & 255, b = (l >> s) & 255, c = (tl >> s) & 255;
      d += std::abs(b - c) - std::abs(a - c);
    }
    return d <= 0 ? t : l;
  }
  static uint32_t add_sub_full(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t out = 0;
    for (int s = 0; s < 32; s += 8)
      out |= uint32_t(clip255(int((a >> s) & 255) + int((b >> s) & 255) -
                              int((c >> s) & 255))) << s;
    return out;
  }
  static uint32_t add_sub_half(uint32_t a, uint32_t b, uint32_t c) {
    const uint32_t ave = avg2(a, b);
    uint32_t out = 0;
    for (int s = 0; s < 32; s += 8) {
      const int x = (ave >> s) & 255, y = (c >> s) & 255;
      out |= uint32_t(clip255(x + (x - y) / 2)) << s;
    }
    return out;
  }
  static uint32_t predict(int mode, uint32_t L, uint32_t T, uint32_t TR,
                          uint32_t TL) {
    switch (mode) {
      case 1: return L;
      case 2: return T;
      case 3: return TR;
      case 4: return TL;
      case 5: return avg2(avg2(L, TR), T);
      case 6: return avg2(L, TL);
      case 7: return avg2(L, T);
      case 8: return avg2(TL, T);
      case 9: return avg2(T, TR);
      case 10: return avg2(avg2(L, TL), avg2(T, TR));
      case 11: return select(T, L, TL);
      case 12: return add_sub_full(L, T, TL);
      case 13: return add_sub_half(L, T, TL);
      default: return 0xff000000u;   // 0, and 14, 15 as libwebp reads them
    }
  }
  static int delta(int8_t pred, int8_t color) { return (int(pred) * color) >> 5; }

  std::vector<uint32_t> inverse(const Transform& t, std::vector<uint32_t>& in,
                                int ysize) {
    const int w = t.xsize;
    if (t.type == 2) {                               // subtract green
      for (uint32_t& p : in) {
        const uint32_t g = (p >> 8) & 255;
        p = add(p, (g << 16) | g);
      }
      return std::move(in);
    }
    if (t.type == 1) {                               // cross colour
      const int tw = subsample(w, t.bits);
      for (int y = 0; y < ysize; ++y)
        for (int x = 0; x < w; ++x) {
          const uint32_t m = t.data[size_t(y >> t.bits) * tw + (x >> t.bits)];
          uint32_t& p = in[size_t(y) * w + x];
          const int8_t g = static_cast<int8_t>(p >> 8);
          int r = (p >> 16) & 255, b = p & 255;
          r = (r + delta(static_cast<int8_t>(m), g)) & 255;
          b = (b + delta(static_cast<int8_t>(m >> 8), g)) & 255;
          b = (b + delta(static_cast<int8_t>(m >> 16), static_cast<int8_t>(r))) & 255;
          p = (p & 0xff00ff00u) | (uint32_t(r) << 16) | uint32_t(b);
        }
      return std::move(in);
    }
    if (t.type == 0) {                               // predictor
      const int tw = subsample(w, t.bits);
      uint32_t* p = in.data();
      for (int y = 0; y < ysize; ++y) {
        uint32_t* row = p + size_t(y) * w;
        const uint32_t* top = row - w;
        for (int x = 0; x < w; ++x) {
          uint32_t pred;
          if (y == 0) pred = x == 0 ? 0xff000000u : row[x - 1];
          else if (x == 0) pred = top[0];
          else {
            const int mode = (t.data[size_t(y >> t.bits) * tw + (x >> t.bits)] >> 8) & 15;
            pred = predict(mode, row[x - 1], top[x], top[x + 1], top[x - 1]);
          }
          row[x] = add(row[x], pred);
        }
      }
      return std::move(in);
    }
    // colour indexing: rows of packed pixels, 1 << bits indices each
    const int bits = t.bits, packed_w = subsample(w, bits);
    std::vector<uint32_t> out(size_t(w) * ysize);
    const int per = 8 >> bits, mask = (1 << per) - 1;
    for (int y = 0; y < ysize; ++y)
      for (int x = 0; x < w; ++x) {
        const uint32_t packed = in[size_t(y) * packed_w + (x >> bits)];
        const int idx = (packed >> (8 + (x & ((1 << bits) - 1)) * per)) & mask;
        out[size_t(y) * w + x] = t.data[idx];
      }
    return out;
  }
};

}  // namespace vp8l

// ------------------------------------------------------------------- VP8
namespace vp8 {

// RFC 6386's tables (coefficient probabilities and their update
// probabilities, [type][band][context][11]; the key-frame 4x4 mode
// probabilities, [above][left][9], in the mode order below; the DC and AC
// dequantization tables)
const uint8_t kCoeffsUpdateProba[1056] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};
const uint8_t kCoeffsProba0[1056] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};
const uint8_t kBModesProba[900] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,
};
const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};
const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};

// 4x4 intra modes (the 16x16 and chroma modes DC, TM, V, H share them)
enum { B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU };
const int kYModesIntra4[18] = {-B_DC, 1, -B_TM, 2, -B_VE, 3, 4, 6, -B_HE, 5,
                               -B_RD, -B_VR, -B_LD, 7, -B_VL, 8, -B_HD,
                               -B_HU};
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11,
                             14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7,
                            0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130,
                         129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

// The boolean decoder of RFC 6386 (section 7). Bytes past the end read as
// 0; eof is set, as libwebp sets it, once a read starts after more than
// 8 * (size - 1) bits have been shifted out.
struct BoolDecoder {
  const uint8_t* p = nullptr;
  const uint8_t* end = nullptr;
  uint32_t value = 0;
  int range = 255, bit_count = 0;
  int64_t shifts = 0, limit = 0;
  bool eof = false;

  void init(const uint8_t* data, int64_t size) {
    p = data;
    end = data + size;
    limit = 8 * size - 8;
    value = (byte() << 8);
    value |= byte();
  }
  uint32_t byte() { return p < end ? *p++ : 0; }
  int get(int prob) {
    if (shifts > limit) eof = true;
    const uint32_t split = 1 + (((range - 1) * prob) >> 8);
    const uint32_t big = split << 8;
    int bit;
    if (value >= big) {
      bit = 1;
      range -= split;
      value -= big;
    } else {
      bit = 0;
      range = split;
    }
    while (range < 128) {
      value <<= 1;
      range <<= 1;
      ++shifts;
      if (++bit_count == 8) {
        bit_count = 0;
        value |= byte();
      }
    }
    return bit;
  }
  int value_bits(int n) {
    int v = 0;
    while (n-- > 0) v |= get(0x80) << n;
    return v;
  }
  int signed_bits(int n) {
    const int v = value_bits(n);
    return get(0x80) ? -v : v;
  }
};

constexpr int BPS = 32;   // stride of the prediction work buffers

inline uint8_t clip8(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }
inline int avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }
inline int avg2(int a, int b) { return (a + b + 1) >> 1; }

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  for (int y = 0; y < size; ++y, dst += BPS)
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + dst[-1] - top[-1]);
}
void fill(uint8_t* dst, int size, int v) {
  for (int y = 0; y < size; ++y) std::memset(dst + y * BPS, v, size);
}
// 16x16 luma (size 16) or 8x8 chroma (size 8), with libwebp's DC variants
// at the picture's top and left edges
void predict_block(uint8_t* dst, int size, int mode, bool top, bool left) {
  const int shift = size == 16 ? 4 : 3;
  if (mode == B_DC) {
    int dc = 0;
    if (top && left) {
      for (int j = 0; j < size; ++j) dc += dst[j - BPS] + dst[-1 + j * BPS];
      fill(dst, size, (dc + size) >> (shift + 1));
    } else if (top || left) {
      for (int j = 0; j < size; ++j)
        dc += top ? dst[j - BPS] : dst[-1 + j * BPS];
      fill(dst, size, (dc + (size >> 1)) >> shift);
    } else {
      fill(dst, size, 0x80);
    }
  } else if (mode == B_TM) {
    true_motion(dst, size);
  } else if (mode == B_VE) {
    for (int y = 0; y < size; ++y) std::memcpy(dst + y * BPS, dst - BPS, size);
  } else {
    for (int y = 0; y < size; ++y) std::memset(dst + y * BPS, dst[y * BPS - 1], size);
  }
}

#define DST(x, y) dst[(x) + (y) * BPS]
void predict4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - BPS;
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS],
            L = dst[-1 + 3 * BPS], X = top[-1];
  const int A = top[0], B = top[1], C = top[2], D = top[3], E = top[4],
            F = top[5], G = top[6], H = top[7];
  switch (mode) {
    case B_DC: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += top[i] + dst[-1 + i * BPS];
      fill(dst, 4, dc >> 3);
      break;
    }
    case B_TM: true_motion(dst, 4); break;
    case B_VE: {
      const int v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D),
                        avg3(C, D, E)};
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) DST(x, y) = v[x];
      break;
    }
    case B_HE: {
      const int v[4] = {avg3(X, I, J), avg3(I, J, K), avg3(J, K, L),
                        avg3(K, L, L)};
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) DST(x, y) = v[y];
      break;
    }
    case B_RD:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case B_LD:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case B_VR:
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case B_VL:
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case B_HD:
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    default:  // B_HU
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) =
          DST(3, 3) = L;
      break;
  }
}
#undef DST

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

// the inverse DCT of a 4x4 block, added to dst
void idct_add(const int16_t* in, uint8_t* dst) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a = in[i] + in[8 + i], b = in[i] - in[8 + i];
    const int c = mul2(in[4 + i]) - mul1(in[12 + i]);
    const int d = mul1(in[4 + i]) + mul2(in[12 + i]);
    tmp[4 * i + 0] = a + d;
    tmp[4 * i + 1] = b + c;
    tmp[4 * i + 2] = b - c;
    tmp[4 * i + 3] = a - d;
  }
  for (int i = 0; i < 4; ++i, dst += BPS) {
    const int dc = tmp[i] + 4;
    const int a = dc + tmp[8 + i], b = dc - tmp[8 + i];
    const int c = mul2(tmp[4 + i]) - mul1(tmp[12 + i]);
    const int d = mul1(tmp[4 + i]) + mul2(tmp[12 + i]);
    dst[0] = clip8(dst[0] + ((a + d) >> 3));
    dst[1] = clip8(dst[1] + ((b + c) >> 3));
    dst[2] = clip8(dst[2] + ((b - c) >> 3));
    dst[3] = clip8(dst[3] + ((a - d) >> 3));
  }
}

// the inverse Walsh-Hadamard transform of the Y2 block into the DC of the
// 16 luma blocks (out[16 * i])
void iwht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i], a3 = in[i] - in[12 + i];
    tmp[i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i, out += 64) {
    const int dc = tmp[4 * i] + 3;
    const int a0 = dc + tmp[4 * i + 3], a1 = tmp[4 * i + 1] + tmp[4 * i + 2];
    const int a2 = tmp[4 * i + 1] - tmp[4 * i + 2], a3 = dc - tmp[4 * i + 3];
    out[0] = static_cast<int16_t>((a0 + a1) >> 3);
    out[16] = static_cast<int16_t>((a3 + a2) >> 3);
    out[32] = static_cast<int16_t>((a0 - a1) >> 3);
    out[48] = static_cast<int16_t>((a3 - a2) >> 3);
  }
}

// ------------------------------------------------------------ loop filter
inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

inline void filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}
inline void filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}
inline void filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7,
            a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}
inline bool hev(const uint8_t* p, int step, int t) {
  return std::abs(p[-2 * step] - p[-step]) > t || std::abs(p[step] - p[0]) > t;
}
inline bool needs(const uint8_t* p, int step, int t) {
  return 4 * std::abs(p[-step] - p[0]) + std::abs(p[-2 * step] - p[step]) <= t;
}
inline bool needs2(const uint8_t* p, int step, int t, int it) {
  if (!needs(p, step, t)) return false;
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step],
            p0 = p[-step], q0 = p[0], q1 = p[step], q2 = p[2 * step],
            q3 = p[3 * step];
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it &&
         std::abs(p1 - p0) <= it && std::abs(q3 - q2) <= it &&
         std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}
// one edge of n pixels: step across the edge, stride along it
void simple_edge(uint8_t* p, int step, int stride, int n, int thresh) {
  const int t = 2 * thresh + 1;
  for (int i = 0; i < n; ++i, p += stride)
    if (needs(p, step, t)) filter2(p, step);
}
void normal_edge(uint8_t* p, int step, int stride, int n, int thresh,
                 int ithresh, int hev_t, bool mb_edge) {
  const int t = 2 * thresh + 1;
  for (int i = 0; i < n; ++i, p += stride) {
    if (!needs2(p, step, t, ithresh)) continue;
    if (hev(p, step, hev_t)) filter2(p, step);
    else if (mb_edge) filter6(p, step);
    else filter4(p, step);
  }
}

struct FilterInfo {
  int limit = 0, ilevel = 0, hev_thresh = 0;
  bool inner = false;
};

struct Image {
  int width = 0, height = 0, mbw = 0, mbh = 0;
  std::vector<uint8_t> y, u, v;   // mbw*16 x mbh*16 and mbw*8 x mbh*8
  int ystride() const { return mbw * 16; }
  int uvstride() const { return mbw * 8; }
};

struct Decoder {
  const uint8_t* data;
  int64_t size;
  Image img;
  BoolDecoder br;
  std::vector<BoolDecoder> parts;
  uint8_t proba[4][8][3][11];
  uint8_t segment_proba[3] = {255, 255, 255};
  bool use_segment = false, update_map = false, absolute_delta = true;
  int quantizer[4] = {0, 0, 0, 0}, filter_strength[4] = {0, 0, 0, 0};
  bool simple = false, use_lf_delta = false;
  int level = 0, sharpness = 0, filter_type = 0;
  int ref_lf_delta[4] = {0, 0, 0, 0}, mode_lf_delta[4] = {0, 0, 0, 0};
  int dq[4][3][2];   // [segment][y1, y2, uv][dc, ac]
  bool use_skip = false;
  int skip_p = 0;
  FilterInfo fstrength[4][2];

  Decoder(const uint8_t* d, int64_t n) : data(d), size(n) {}

  void header() {
    if (size < 10) fail(kCorrupt, "VP8: frame header truncated");
    const uint32_t bits = le24(data);
    const bool key = !(bits & 1);
    const int profile = (bits >> 1) & 7;
    const bool show = (bits >> 4) & 1;
    const uint32_t part0 = bits >> 5;
    if (!key) fail(kUnsupported, "VP8: not a key frame");
    if (profile > 3) fail(kCorrupt, "VP8: profile %d", profile);
    if (!show) fail(kCorrupt, "VP8: frame not displayable");
    if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a)
      fail(kCorrupt, "VP8: bad start code");
    img.width = (data[6] | (data[7] << 8)) & 0x3fff;
    img.height = (data[8] | (data[9] << 8)) & 0x3fff;
    if (!img.width || !img.height) fail(kCorrupt, "VP8: an empty frame");
    img.mbw = (img.width + 15) >> 4;
    img.mbh = (img.height + 15) >> 4;
    if (int64_t(part0) > size - 10) fail(kCorrupt, "VP8: bad partition length");
    br.init(data + 10, part0);
    br.get(0x80);   // colour space
    br.get(0x80);   // clamping type
    use_segment = br.get(0x80);
    if (use_segment) {
      update_map = br.get(0x80);
      if (br.get(0x80)) {
        absolute_delta = br.get(0x80);
        for (int& q : quantizer) q = br.get(0x80) ? br.signed_bits(7) : 0;
        for (int& f : filter_strength) f = br.get(0x80) ? br.signed_bits(6) : 0;
      }
      if (update_map)
        for (uint8_t& p : segment_proba)
          p = br.get(0x80) ? static_cast<uint8_t>(br.value_bits(8)) : 255;
    }
    if (br.eof) fail(kCorrupt, "VP8: cannot parse the segment header");
    simple = br.get(0x80);
    level = br.value_bits(6);
    sharpness = br.value_bits(3);
    use_lf_delta = br.get(0x80);
    if (use_lf_delta && br.get(0x80)) {
      for (int& d : ref_lf_delta)
        if (br.get(0x80)) d = br.signed_bits(6);
      for (int& d : mode_lf_delta)
        if (br.get(0x80)) d = br.signed_bits(6);
    }
    filter_type = level == 0 ? 0 : simple ? 1 : 2;
    if (br.eof) fail(kCorrupt, "VP8: cannot parse the filter header");
    // token partitions: their sizes (3 bytes each but the last) after
    // partition 0; a size past the data is cut to it
    const int nparts = 1 << br.value_bits(2);
    const uint8_t* sizes = data + 10 + part0;
    const uint8_t* end = data + size;
    if (end - sizes < 3 * (nparts - 1))
      fail(kCorrupt, "VP8: cannot parse the partitions");
    const uint8_t* start = sizes + 3 * (nparts - 1);
    int64_t left = end - start;
    parts.resize(nparts);
    for (int p = 0; p < nparts - 1; ++p) {
      int64_t psize = le24(sizes + 3 * p);
      if (psize > left) psize = left;
      parts[p].init(start, psize);
      start += psize;
      left -= psize;
    }
    parts[nparts - 1].init(start, left);
    if (start >= end) fail(kCorrupt, "VP8: cannot parse the partitions");
    const int base_q = br.value_bits(7);
    int dqd[5];
    for (int& d : dqd) d = br.get(0x80) ? br.signed_bits(4) : 0;
    auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
    for (int s = 0; s < 4; ++s) {
      int q = base_q;
      if (use_segment) q = quantizer[s] + (absolute_delta ? 0 : base_q);
      else if (s > 0) q = base_q;
      dq[s][0][0] = kDcTable[clip(q + dqd[0], 127)];
      dq[s][0][1] = kAcTable[clip(q, 127)];
      dq[s][1][0] = kDcTable[clip(q + dqd[1], 127)] * 2;
      dq[s][1][1] = std::max(8, (kAcTable[clip(q + dqd[2], 127)] * 101581) >> 16);
      dq[s][2][0] = kDcTable[clip(q + dqd[3], 117)];
      dq[s][2][1] = kAcTable[clip(q + dqd[4], 127)];
    }
    br.get(0x80);   // refresh entropy probabilities: ignored
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < 11; ++p) {
            const int i = ((t * 8 + b) * 3 + c) * 11 + p;
            proba[t][b][c][p] = br.get(kCoeffsUpdateProba[i])
                                    ? static_cast<uint8_t>(br.value_bits(8))
                                    : kCoeffsProba0[i];
          }
    use_skip = br.get(0x80);
    if (use_skip) skip_p = br.value_bits(8);
    // filter strengths per segment and 4x4 or 16x16 prediction
    for (int s = 0; s < 4; ++s) {
      int base = level;
      if (use_segment) base = filter_strength[s] + (absolute_delta ? 0 : level);
      for (int i4 = 0; i4 < 2; ++i4) {
        FilterInfo& f = fstrength[s][i4];
        int lv = base;
        if (use_lf_delta) {
          lv += ref_lf_delta[0];
          if (i4) lv += mode_lf_delta[0];
        }
        lv = lv < 0 ? 0 : lv > 63 ? 63 : lv;
        if (lv > 0) {
          int il = lv;
          if (sharpness > 0) {
            il >>= sharpness > 4 ? 2 : 1;
            if (il > 9 - sharpness) il = 9 - sharpness;
          }
          if (il < 1) il = 1;
          f.ilevel = il;
          f.limit = 2 * lv + il;
          f.hev_thresh = lv >= 40 ? 2 : lv >= 15 ? 1 : 0;
        } else {
          f.limit = 0;
        }
        f.inner = i4;
      }
    }
  }

  int large_value(BoolDecoder& b, const uint8_t* p) {
    if (!b.get(p[3])) {
      if (!b.get(p[4])) return 2;
      return 3 + b.get(p[5]);
    }
    if (!b.get(p[6])) {
      if (!b.get(p[7])) return 5 + b.get(159);
      int v = 7 + 2 * b.get(165);
      return v + b.get(145);
    }
    const int bit1 = b.get(p[8]);
    const int bit0 = b.get(p[9 + bit1]);
    const int cat = 2 * bit1 + bit0;
    int v = 0;
    for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + b.get(*tab);
    return v + 3 + (8 << cat);
  }

  // the tokens of one block into out (zigzag undone, dequantized);
  // returns the position after the last coefficient read
  int coeffs(BoolDecoder& b, int type, int ctx, const int* q, int n,
             int16_t* out) {
    const uint8_t* p = proba[type][kBands[n]][ctx];
    for (; n < 16; ++n) {
      if (!b.get(p[0])) return n;
      while (!b.get(p[1])) {
        ++n;
        if (n == 16) return 16;
        p = proba[type][kBands[n]][0];
      }
      int v;
      const int nb = kBands[n + 1];
      if (!b.get(p[2])) {
        v = 1;
        p = proba[type][nb][1];
      } else {
        v = large_value(b, p);
        p = proba[type][nb][2];
      }
      const int sv = b.get(0x80) ? -v : v;
      out[kZigzag[n]] = static_cast<int16_t>(sv * q[n > 0]);
    }
    return 16;
  }

  void decode(std::vector<FilterInfo>& finfo) {
    Image& im = img;
    const int ys = im.ystride(), uvs = im.uvstride();
    im.y.assign(size_t(ys) * im.mbh * 16, 0);
    im.u.assign(size_t(uvs) * im.mbh * 8, 0);
    im.v.assign(size_t(uvs) * im.mbh * 8, 0);
    finfo.assign(size_t(im.mbw) * im.mbh, FilterInfo{});
    std::vector<uint8_t> intra_t(size_t(im.mbw) * 4, B_DC);
    std::vector<uint8_t> top_nz(size_t(im.mbw) * 9, 0);
    uint8_t work_y[17 * BPS], work_u[9 * BPS], work_v[9 * BPS];
    int16_t coef[384];
    for (int my = 0; my < im.mbh; ++my) {
      uint8_t intra_l[4] = {B_DC, B_DC, B_DC, B_DC};
      uint8_t left_nz[9] = {0};
      BoolDecoder& tb = parts[my & (parts.size() - 1)];
      struct Mode {
        int segment, skip, i4, ymode, uvmode;
        uint8_t imodes[16];
      };
      std::vector<Mode> modes(im.mbw);
      for (int mx = 0; mx < im.mbw; ++mx) {      // partition 0: the modes
        Mode& m = modes[mx];
        m.segment = update_map ? (!br.get(segment_proba[0])
                                      ? br.get(segment_proba[1])
                                      : br.get(segment_proba[2]) + 2)
                               : 0;
        m.skip = use_skip ? br.get(skip_p) : 0;
        m.i4 = !br.get(145);
        uint8_t* top = intra_t.data() + 4 * mx;
        if (!m.i4) {
          m.ymode = br.get(156) ? (br.get(128) ? B_TM : B_HE)
                                : (br.get(163) ? B_VE : B_DC);
          std::memset(top, m.ymode, 4);
          std::memset(intra_l, m.ymode, 4);
        } else {
          for (int y = 0; y < 4; ++y) {
            int ymode = intra_l[y];
            for (int x = 0; x < 4; ++x) {
              const uint8_t* prob = kBModesProba + (top[x] * 10 + ymode) * 9;
              int i = kYModesIntra4[br.get(prob[0])];
              while (i > 0) i = kYModesIntra4[2 * i + br.get(prob[i])];
              ymode = -i;
              top[x] = static_cast<uint8_t>(ymode);
              m.imodes[y * 4 + x] = static_cast<uint8_t>(ymode);
            }
            intra_l[y] = static_cast<uint8_t>(ymode);
          }
        }
        m.uvmode = !br.get(142) ? B_DC : !br.get(114) ? B_VE
                                          : br.get(183) ? B_TM : B_HE;
      }
      if (br.eof) fail(kCorrupt, "VP8: premature end of partition 0");
      for (int mx = 0; mx < im.mbw; ++mx) {      // the residuals
        Mode& m = modes[mx];
        uint8_t* tnz = top_nz.data() + 9 * mx;
        const int (*q)[2] = dq[m.segment];
        std::memset(coef, 0, sizeof(coef));
        bool any = false;   // libwebp's non-zero flags: nz > 1 or a DC
        if (m.skip) {
          std::memset(tnz, 0, 8);
          std::memset(left_nz, 0, 8);
          if (!m.i4) tnz[8] = left_nz[8] = 0;
        } else {
          int first = 0, type = 3;
          if (!m.i4) {
            int16_t dc[16] = {0};
            const int nz = coeffs(tb, 1, tnz[8] + left_nz[8], q[1], 0, dc);
            tnz[8] = left_nz[8] = nz > 0;
            iwht(dc, coef);
            first = 1;
            type = 0;
          }
          for (int y = 0; y < 4; ++y)
            for (int x = 0; x < 4; ++x) {
              int16_t* blk = coef + 16 * (4 * y + x);
              const int nz = coeffs(tb, type, tnz[x] + left_nz[y], q[0],
                                    first, blk);
              tnz[x] = left_nz[y] = nz > first;
              any = any || nz > 1 || blk[0] != 0;
            }
          for (int c = 0; c < 2; ++c)
            for (int y = 0; y < 2; ++y)
              for (int x = 0; x < 2; ++x) {
                int16_t* blk = coef + 256 + 64 * c + 16 * (2 * y + x);
                const int nz = coeffs(tb, 2, tnz[4 + 2 * c + x] +
                                          left_nz[4 + 2 * c + y], q[2], 0, blk);
                tnz[4 + 2 * c + x] = left_nz[4 + 2 * c + y] = nz > 0;
                any = any || nz > 1 || blk[0] != 0;
              }
        }
        if (tb.eof) fail(kCorrupt, "VP8: premature end of the token data");
        if (filter_type) {
          FilterInfo f = fstrength[m.segment][m.i4];
          f.inner = f.inner || any;
          finfo[size_t(my) * im.mbw + mx] = f;
        }
        reconstruct(mx, my, m.i4, m.ymode, m.imodes, m.uvmode, coef, work_y,
                    work_u, work_v);
      }
    }
    if (filter_type) loop_filter(finfo);
  }

  // prediction of one macroblock from its unfiltered neighbours (libwebp's
  // edge values: 127 above the picture, 129 left of it), plus residuals
  void reconstruct(int mx, int my, bool i4, int ymode, const uint8_t* imodes,
                   int uvmode, const int16_t* coef, uint8_t* wy, uint8_t* wu,
                   uint8_t* wv) {
    Image& im = img;
    const int ys = im.ystride(), uvs = im.uvstride();
    uint8_t* y_dst = wy + BPS + 1;      // row -1 and column -1 precede it
    uint8_t* u_dst = wu + BPS + 1;
    uint8_t* v_dst = wv + BPS + 1;
    auto Y = [&](int r, int c) { return im.y[size_t(r) * ys + c]; };
    // above row, with the corner and 4 pixels to the right
    for (int c = -1; c < 20; ++c) {
      int v;
      if (my == 0) v = 127;
      else if (c == -1) v = mx == 0 ? 129 : Y(my * 16 - 1, mx * 16 - 1);
      else if (c < 16) v = Y(my * 16 - 1, mx * 16 + c);
      else if (mx < im.mbw - 1) v = Y(my * 16 - 1, mx * 16 + c);
      else v = Y(my * 16 - 1, mx * 16 + 15);
      y_dst[c - BPS] = static_cast<uint8_t>(v);
    }
    for (int r = 0; r < 16; ++r)
      y_dst[r * BPS - 1] = mx == 0 ? 129 : Y(my * 16 + r, mx * 16 - 1);
    for (int r = 3; r < 16; r += 4)
      std::memcpy(y_dst + r * BPS + 16, y_dst - BPS + 16, 4);
    for (int ch = 0; ch < 2; ++ch) {
      uint8_t* d = ch ? v_dst : u_dst;
      const std::vector<uint8_t>& plane = ch ? im.v : im.u;
      for (int c = -1; c < 8; ++c) {
        int v;
        if (my == 0) v = 127;
        else if (c == -1) v = mx == 0 ? 129 : plane[size_t(my * 8 - 1) * uvs + mx * 8 - 1];
        else v = plane[size_t(my * 8 - 1) * uvs + mx * 8 + c];
        d[c - BPS] = static_cast<uint8_t>(v);
      }
      for (int r = 0; r < 8; ++r)
        d[r * BPS - 1] = mx == 0 ? 129 : plane[size_t(my * 8 + r) * uvs + mx * 8 - 1];
    }
    if (i4) {
      for (int n = 0; n < 16; ++n) {
        uint8_t* dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
        predict4(dst, imodes[n]);
        idct_add(coef + 16 * n, dst);
      }
    } else {
      predict_block(y_dst, 16, ymode, my > 0, mx > 0);
      for (int n = 0; n < 16; ++n)
        idct_add(coef + 16 * n, y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
    }
    predict_block(u_dst, 8, uvmode, my > 0, mx > 0);
    predict_block(v_dst, 8, uvmode, my > 0, mx > 0);
    for (int n = 0; n < 4; ++n) {
      const int off = (n & 1) * 4 + (n >> 1) * 4 * BPS;
      idct_add(coef + 256 + 16 * n, u_dst + off);
      idct_add(coef + 320 + 16 * n, v_dst + off);
    }
    for (int r = 0; r < 16; ++r)
      std::memcpy(&im.y[size_t(my * 16 + r) * ys + mx * 16], y_dst + r * BPS, 16);
    for (int r = 0; r < 8; ++r) {
      std::memcpy(&im.u[size_t(my * 8 + r) * uvs + mx * 8], u_dst + r * BPS, 8);
      std::memcpy(&im.v[size_t(my * 8 + r) * uvs + mx * 8], v_dst + r * BPS, 8);
    }
  }

  void loop_filter(const std::vector<FilterInfo>& finfo) {
    Image& im = img;
    const int ys = im.ystride(), uvs = im.uvstride();
    for (int my = 0; my < im.mbh; ++my)
      for (int mx = 0; mx < im.mbw; ++mx) {
        const FilterInfo& f = finfo[size_t(my) * im.mbw + mx];
        if (f.limit == 0) continue;
        uint8_t* y = &im.y[size_t(my) * 16 * ys + mx * 16];
        const int lim = f.limit;
        if (filter_type == 1) {
          if (mx > 0) simple_edge(y, 1, ys, 16, lim + 4);
          if (f.inner)
            for (int k = 4; k < 16; k += 4) simple_edge(y + k, 1, ys, 16, lim);
          if (my > 0) simple_edge(y, ys, 1, 16, lim + 4);
          if (f.inner)
            for (int k = 4; k < 16; k += 4) simple_edge(y + k * ys, ys, 1, 16, lim);
          continue;
        }
        uint8_t* u = &im.u[size_t(my) * 8 * uvs + mx * 8];
        uint8_t* v = &im.v[size_t(my) * 8 * uvs + mx * 8];
        const int il = f.ilevel, ht = f.hev_thresh;
        if (mx > 0) {
          normal_edge(y, 1, ys, 16, lim + 4, il, ht, true);
          normal_edge(u, 1, uvs, 8, lim + 4, il, ht, true);
          normal_edge(v, 1, uvs, 8, lim + 4, il, ht, true);
        }
        if (f.inner) {
          for (int k = 4; k < 16; k += 4) normal_edge(y + k, 1, ys, 16, lim, il, ht, false);
          normal_edge(u + 4, 1, uvs, 8, lim, il, ht, false);
          normal_edge(v + 4, 1, uvs, 8, lim, il, ht, false);
        }
        if (my > 0) {
          normal_edge(y, ys, 1, 16, lim + 4, il, ht, true);
          normal_edge(u, uvs, 1, 8, lim + 4, il, ht, true);
          normal_edge(v, uvs, 1, 8, lim + 4, il, ht, true);
        }
        if (f.inner) {
          for (int k = 4; k < 16; k += 4)
            normal_edge(y + k * ys, ys, 1, 16, lim, il, ht, false);
          normal_edge(u + 4 * uvs, uvs, 1, 8, lim, il, ht, false);
          normal_edge(v + 4 * uvs, uvs, 1, 8, lim, il, ht, false);
        }
      }
  }
};

// libwebp's 14-bit fixed-point BT.601 YUV -> RGB
inline int mult_hi(int v, int c) { return (v * c) >> 8; }
inline uint8_t yuv_clip(int v) {
  return (v & ~16383) == 0 ? v >> 6 : v < 0 ? 0 : 255;
}
inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
  rgb[0] = yuv_clip(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  rgb[1] = yuv_clip(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  rgb[2] = yuv_clip(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

// one output row of libwebp's fancy upsampler: luma row yrow, chroma rows
// near (weight 3) and far (weight 1), each channel (9 near + 3 far
// + 3 near + 1 far) / 16 by its bilinear steps
void upsample_row(const uint8_t* yrow, const uint8_t* nu, const uint8_t* nv,
                  const uint8_t* fu, const uint8_t* fv, int len, uint8_t* dst,
                  int channels) {
  auto load = [](int a, int b) { return uint32_t(a) | (uint32_t(b) << 16); };
  uint32_t tl = load(nu[0], nv[0]), l = load(fu[0], fv[0]);
  {
    const uint32_t uv0 = (3 * tl + l + 0x00020002u) >> 2;
    yuv_to_rgb(yrow[0], uv0 & 0xff, uv0 >> 16, dst);
  }
  const int pairs = (len - 1) >> 1;
  for (int x = 1; x <= pairs; ++x) {
    const uint32_t t = load(nu[x], nv[x]), uv = load(fu[x], fv[x]);
    const uint32_t avg = tl + t + l + uv + 0x00080008u;
    const uint32_t diag_12 = (avg + 2 * (t + l)) >> 3;
    const uint32_t diag_03 = (avg + 2 * (tl + uv)) >> 3;
    const uint32_t uv0 = (diag_12 + tl) >> 1, uv1 = (diag_03 + t) >> 1;
    yuv_to_rgb(yrow[2 * x - 1], uv0 & 0xff, (uv0 >> 16) & 0xff,
               dst + (2 * x - 1) * channels);
    yuv_to_rgb(yrow[2 * x], uv1 & 0xff, (uv1 >> 16) & 0xff,
               dst + 2 * x * channels);
    tl = t;
    l = uv;
  }
  if (!(len & 1)) {
    const uint32_t uv0 = (3 * tl + l + 0x00020002u) >> 2;
    yuv_to_rgb(yrow[len - 1], uv0 & 0xff, uv0 >> 16, dst + (len - 1) * channels);
  }
}

// the picture as RGB(A) rows (stride channels * width); alpha untouched
void to_rgb(const Image& im, uint8_t* out, int64_t stride, int channels) {
  const int W = im.width, H = im.height, uvh = (H + 1) / 2;
  const int ys = im.ystride(), uvs = im.uvstride();
  for (int r = 0; r < H; ++r) {
    int near, far;
    if (r == 0) {
      near = far = 0;
    } else if (r & 1) {
      const int k = (r + 1) >> 1;
      near = k - 1;
      far = k < uvh ? k : k - 1;
    } else {
      near = r >> 1;
      far = near - 1;
    }
    upsample_row(&im.y[size_t(r) * ys], &im.u[size_t(near) * uvs],
                 &im.v[size_t(near) * uvs], &im.u[size_t(far) * uvs],
                 &im.v[size_t(far) * uvs], W, out + r * stride, channels);
  }
}

}  // namespace vp8

// ------------------------------------------------------------ container
struct Chunk {
  uint32_t tag;
  const uint8_t* data;
  int64_t size;
};

constexpr uint32_t fourcc(const char* s) {
  return uint32_t(uint8_t(s[0])) | (uint32_t(uint8_t(s[1])) << 8) |
         (uint32_t(uint8_t(s[2])) << 16) | (uint32_t(uint8_t(s[3])) << 24);
}

// the chunks of [p, end): each a tag, a size and its payload (padded to an
// even size; the pad of the last may be missing)
std::vector<Chunk> chunks(const uint8_t* p, const uint8_t* end) {
  std::vector<Chunk> out;
  while (end - p >= 8) {
    const uint32_t n = le32(p + 4);
    if (int64_t(n) > end - p - 8) fail(kCorrupt, "WebP: a chunk runs past the file");
    out.push_back(Chunk{le32(p), p + 8, n});
    p += 8 + n + (n & 1);
    if (p > end) p = end;
  }
  return out;
}

// the alpha plane of an ALPH chunk for a width x height picture
std::vector<uint8_t> decode_alpha(const Chunk& c, int width, int height) {
  if (c.size < 1) fail(kCorrupt, "WebP: empty ALPH chunk");
  const int method = c.data[0] & 3, filter = (c.data[0] >> 2) & 3,
            pre = (c.data[0] >> 4) & 3, reserved = c.data[0] >> 6;
  if (method > 1 || pre > 1 || reserved)
    fail(kCorrupt, "WebP: bad ALPH header %#x", c.data[0]);
  const int64_t n = int64_t(width) * height;
  std::vector<uint8_t> a(static_cast<size_t>(n));
  if (method == 0) {
    if (c.size - 1 < n) fail(kCorrupt, "WebP: raw alpha truncated");
    std::memcpy(a.data(), c.data + 1, static_cast<size_t>(n));
  } else {
    vp8l::Decoder d(c.data + 1, c.size - 1, height);
    std::vector<uint32_t> px = d.decode_stream(width, height, true);
    for (int64_t i = 0; i < n; ++i) a[i] = static_cast<uint8_t>(px[i] >> 8);
  }
  // unfilter, row by row, from the rows already unfiltered
  for (int y = 0; y < height && filter; ++y) {
    uint8_t* row = a.data() + int64_t(y) * width;
    const uint8_t* prev = y ? row - width : nullptr;
    if (filter == 1 || !prev) {
      uint8_t pred = prev ? prev[0] : 0;
      for (int x = 0; x < width; ++x) pred = row[x] = uint8_t(row[x] + pred);
    } else if (filter == 2) {
      for (int x = 0; x < width; ++x) row[x] = uint8_t(row[x] + prev[x]);
    } else {
      int top = prev[0], top_left = top, left = top;
      for (int x = 0; x < width; ++x) {
        top = prev[x];
        const int g = left + top - top_left;
        left = uint8_t(row[x] + (g < 0 ? 0 : g > 255 ? 255 : g));
        top_left = top;
        row[x] = uint8_t(left);
      }
    }
  }
  return a;
}

struct Frame {
  const Chunk* alpha = nullptr;
  const Chunk* image = nullptr;   // VP8 or VP8L
  int x = 0, y = 0;               // on the canvas
};

struct File {
  int width = 0, height = 0;      // the canvas
  bool has_alpha = false, lossless = false, animated = false;
  std::vector<Chunk> top, inner;
  Frame frame;

  void open(const uint8_t* data, int64_t size) {
    if (size < 12 || std::memcmp(data, "RIFF", 4) || std::memcmp(data + 8, "WEBP", 4))
      fail(kCorrupt, "WebP: not a RIFF WEBP file");
    const int64_t riff = le32(data + 4);
    if (riff < 12) fail(kCorrupt, "WebP: RIFF size %lld", (long long)riff);
    if (riff + 8 > size) fail(kCorrupt, "WebP: the file is truncated");
    top = chunks(data + 12, data + 8 + riff);
    if (top.empty()) fail(kCorrupt, "WebP: no chunks");
    const uint32_t first = top[0].tag;
    if (first == fourcc("VP8 ") || first == fourcc("VP8L")) {
      frame.image = &top[0];
      image_size(top[0], &width, &height);
      has_alpha = lossless && (top[0].data[4] & 0x10);
      return;
    }
    if (first != fourcc("VP8X") || top[0].size < 10)
      fail(kCorrupt, "WebP: the first chunk is neither VP8, VP8L nor VP8X");
    const uint8_t flags = top[0].data[0];
    width = static_cast<int>(le24(top[0].data + 4)) + 1;
    height = static_cast<int>(le24(top[0].data + 7)) + 1;
    if (int64_t(width) * height > kMaxPixels)
      fail(kUnsupported, "WebP: a canvas of %d x %d pixels", width, height);
    has_alpha = flags & 0x10;
    animated = flags & 0x02;
    if (animated) {
      const Chunk* anmf = nullptr;
      for (const Chunk& c : top)
        if (c.tag == fourcc("ANMF")) {
          anmf = &c;
          break;
        }
      if (!anmf || anmf->size < 16) fail(kCorrupt, "WebP: an animation without frames");
      frame.x = 2 * static_cast<int>(le24(anmf->data));
      frame.y = 2 * static_cast<int>(le24(anmf->data + 3));
      inner = chunks(anmf->data + 16, anmf->data + anmf->size);
      pick(inner);
      int w, h;
      image_size(*frame.image, &w, &h);
      if (w != static_cast<int>(le24(anmf->data + 6)) + 1 ||
          h != static_cast<int>(le24(anmf->data + 9)) + 1 ||
          frame.x + w > width || frame.y + h > height)
        fail(kCorrupt, "WebP: the first frame does not fit the canvas");
      return;
    }
    pick(top);
    int w, h;
    image_size(*frame.image, &w, &h);
    if (w != width || h != height)
      fail(kCorrupt, "WebP: the image and its canvas differ in size");
    // WebPGetFeatures: a VP8L image says itself; an ALPH chunk adds alpha
    if (lossless) has_alpha = frame.image->data[4] & 0x10;
    if (frame.alpha) has_alpha = true;
  }

  void pick(const std::vector<Chunk>& list) {
    for (const Chunk& c : list) {
      if (c.tag == fourcc("ALPH") && !frame.alpha && !frame.image) frame.alpha = &c;
      if ((c.tag == fourcc("VP8 ") || c.tag == fourcc("VP8L")) && !frame.image)
        frame.image = &c;
    }
    if (!frame.image) fail(kCorrupt, "WebP: no image data");
  }

  void image_size(const Chunk& c, int* w, int* h) {
    if (c.tag == fourcc("VP8L")) {
      lossless = true;
      if (c.size < 5 || c.data[0] != 0x2f || (c.data[4] >> 5))
        fail(kCorrupt, "WebP: bad VP8L header");
      const uint32_t bits = le32(c.data + 1);
      *w = static_cast<int>(bits & 0x3fff) + 1;
      *h = static_cast<int>((bits >> 14) & 0x3fff) + 1;
    } else {
      lossless = false;
      if (c.size < 10) fail(kCorrupt, "WebP: VP8 frame header truncated");
      const uint8_t* d = c.data;
      if (d[0] & 1) fail(kUnsupported, "WebP: a VP8 frame that is not a key frame");
      if (d[3] != 0x9d || d[4] != 0x01 || d[5] != 0x2a)
        fail(kCorrupt, "WebP: bad VP8 start code");
      *w = (d[6] | (d[7] << 8)) & 0x3fff;
      *h = (d[8] | (d[9] << 8)) & 0x3fff;
      if (!*w || !*h) fail(kCorrupt, "WebP: an empty VP8 frame");
    }
  }

  // the canvas as RGB or RGBA rows
  void decode(uint8_t* out) {
    const int ch = has_alpha ? 4 : 3;
    const int64_t stride = int64_t(width) * ch;
    int w, h;
    image_size(*frame.image, &w, &h);
    std::vector<uint8_t> rgba(size_t(w) * h * 4);
    if (lossless) {
      vp8l::Decoder d(frame.image->data + 5, frame.image->size - 5, h);
      std::vector<uint32_t> px = d.decode_stream(w, h, true);
      for (size_t i = 0; i < px.size(); ++i) {
        rgba[4 * i] = uint8_t(px[i] >> 16);
        rgba[4 * i + 1] = uint8_t(px[i] >> 8);
        rgba[4 * i + 2] = uint8_t(px[i]);
        rgba[4 * i + 3] = uint8_t(px[i] >> 24);
      }
    } else {
      if (int64_t(w) * h > kMaxPixels)
        fail(kUnsupported, "WebP: an image of %d x %d pixels", w, h);
      vp8::Decoder d(frame.image->data, frame.image->size);
      d.header();
      std::vector<vp8::FilterInfo> finfo;
      d.decode(finfo);
      vp8::to_rgb(d.img, rgba.data(), int64_t(w) * 4, 4);
      std::vector<uint8_t> alpha;
      if (frame.alpha) alpha = decode_alpha(*frame.alpha, w, h);
      for (int64_t i = 0; i < int64_t(w) * h; ++i)
        rgba[4 * i + 3] = alpha.empty() ? 255 : alpha[i];
    }
    // the first frame on a canvas cleared to transparent black
    std::memset(out, 0, static_cast<size_t>(stride * height));
    for (int r = 0; r < h; ++r)
      for (int c = 0; c < w; ++c)
        std::memcpy(out + (frame.y + r) * stride + int64_t(frame.x + c) * ch,
                    &rgba[(size_t(r) * w + c) * 4], ch);
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
    return report(Failure{kNoRoom, "WebP: out of memory"}, msg, cap);
  } catch (...) {
    return report(Failure{kCorrupt, "WebP: internal error"}, msg, cap);
  }
}

}  // namespace

extern "C" {

// The facts of a WebP file: info = {width, height, channels (3, or 4 with
// alpha, as Pillow reads it), kind (0 lossy, 1 lossless), animated}.
// Returns 0, or 1 (corrupt) / 2 (unsupported) with a message in msg.
int nm_webp_info(const uint8_t* data, int64_t size, int32_t* info, char* msg,
                 int64_t msg_cap) {
  return guarded(msg, msg_cap, [&]() {
    File f;
    f.open(data, size);
    info[0] = f.width;
    info[1] = f.height;
    info[2] = f.has_alpha ? 4 : 3;
    info[3] = f.lossless ? 1 : 0;
    info[4] = f.animated ? 1 : 0;
  });
}

// The pixels of a WebP file (its first frame on its canvas) into out:
// height x width x channels bytes (cap available). Returns as
// nm_webp_info, or 3 when out is too small or memory runs out.
int nm_webp_decode(const uint8_t* data, int64_t size, uint8_t* out,
                   int64_t cap, char* msg, int64_t msg_cap) {
  return guarded(msg, msg_cap, [&]() {
    File f;
    f.open(data, size);
    if (int64_t(f.width) * f.height * (f.has_alpha ? 4 : 3) > cap)
      fail(kNoRoom, "WebP: output buffer too small");
    f.decode(out);
  });
}

}  // extern "C"

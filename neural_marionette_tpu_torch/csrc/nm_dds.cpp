// Block-compressed texture decoder of the PyTorch/CUDA port: the BC1-BC7
// blocks of a DDS file (viz/image_files.py reads its header), decoded as
// Pillow's libImaging/BcnDecode.c decodes them for imageio, so that the
// pixels equal imageio's. Built by kernels.py (g++ -O3 -std=c++17 -shared
// -fPIC -pthread) into _build/ at first use and bound in data/native.py.
//
//   * nm_bcn_decode — width x height pixels from the row-major 4 x 4
//                     blocks (8 bytes each for BC1 and BC4, else 16):
//       BC1 RGBA (four colours, or three and transparent black where
//           c0 <= c1); BC2 RGBA (4-bit alpha); BC3 RGBA (interpolated
//           alpha); BC4 grey; BC5 RG, unsigned (blue 0) or signed (each
//           channel offset by 128, blue 128); BC6H RGB, unsigned or
//           signed, interpolated without rounding, its half floats clamped
//           to [0, 1] and scaled by 255 with truncation;
//           BC7 RGBA, every mode (mode 8, a first byte of 0, is black
//           with alpha 255).
//
// Every block is valid data, so the only failure is data that ends before
// the last block. Exposed with C linkage for ctypes.

#include <cstdint>
#include <cstring>

namespace {

// BC7 (and BC6H) partitions of ITU/Khronos BPTC: per pixel the subset,
// one bit (2 subsets) or two (3 subsets) from the LSB up
constexpr uint16_t kPartition2[64] = {
    0xcccc, 0x8888, 0xeeee, 0xecc8, 0xc880, 0xfeec, 0xfec8, 0xec80,
    0xc800, 0xffec, 0xfe80, 0xe800, 0xffe8, 0xff00, 0xfff0, 0xf000,
    0xf710, 0x008e, 0x7100, 0x08ce, 0x008c, 0x7310, 0x3100, 0x8cce,
    0x088c, 0x3110, 0x6666, 0x366c, 0x17e8, 0x0ff0, 0x718e, 0x399c,
    0xaaaa, 0xf0f0, 0x5a5a, 0x33cc, 0x3c3c, 0x55aa, 0x9696, 0xa55a,
    0x73ce, 0x13c8, 0x324c, 0x3bdc, 0x6996, 0xc33c, 0x9966, 0x0660,
    0x0272, 0x04e4, 0x4e40, 0x2720, 0xc936, 0x936c, 0x39c6, 0x639c,
    0x9336, 0x9cc6, 0x817e, 0xe718, 0xccf0, 0x0fcc, 0x7744, 0xee22,
};
constexpr uint32_t kPartition3[64] = {
    0xaa685050, 0x6a5a5040, 0x5a5a4200, 0x5450a0a8, 0xa5a50000, 0xa0a05050,
    0x5555a0a0, 0x5a5a5050, 0xaa550000, 0xaa555500, 0xaaaa5500, 0x90909090,
    0x94949494, 0xa4a4a4a4, 0xa9a59450, 0x2a0a4250, 0xa5945040, 0x0a425054,
    0xa5a5a500, 0x55a0a0a0, 0xa8a85454, 0x6a6a4040, 0xa4a45000, 0x1a1a0500,
    0x0050a4a4, 0xaaa59090, 0x14696914, 0x69691400, 0xa08585a0, 0xaa821414,
    0x50a4a450, 0x6a5a0200, 0xa9a58000, 0x5090a0a8, 0xa8a09050, 0x24242424,
    0x00aa5500, 0x24924924, 0x24499224, 0x50a50a50, 0x500aa550, 0xaaaa4444,
    0x66660000, 0xa5a0a5a0, 0x50a050a0, 0x69286928, 0x44aaaa44, 0x66666600,
    0xaa444444, 0x54a854a8, 0x95809580, 0x96969600, 0xa85454a8, 0x80959580,
    0xaa141414, 0x96960000, 0xaaaa1414, 0xa05050a0, 0xa0a5a5a0, 0x96000000,
    0x40804080, 0xa9a8a9a8, 0xaaaaaa44, 0x2a4a5254,
};
// the anchor pixel of the second subset (2 subsets), of the second and
// third (3 subsets), whose index drops its top bit
constexpr uint8_t kAnchor2[64] = {
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 2, 8, 2, 2, 8, 8, 15, 2, 8, 2, 2, 8, 8, 2, 2,
    15, 15, 6, 8, 2, 8, 15, 15, 2, 8, 2, 2, 2, 15, 15, 6,
    6, 2, 6, 8, 15, 15, 2, 2, 15, 15, 15, 15, 15, 2, 2, 15,
};
constexpr uint8_t kAnchor3a[64] = {
    3, 3, 15, 15, 8, 3, 15, 15, 8, 8, 6, 6, 6, 5, 3, 3,
    3, 3, 8, 15, 3, 3, 6, 10, 5, 8, 8, 6, 8, 5, 15, 15,
    8, 15, 3, 5, 6, 10, 8, 15, 15, 3, 15, 5, 15, 15, 15, 15,
    3, 15, 5, 5, 5, 8, 5, 10, 5, 10, 8, 13, 15, 12, 3, 3,
};
constexpr uint8_t kAnchor3b[64] = {
    15, 8, 8, 3, 15, 15, 3, 8, 15, 15, 15, 15, 15, 15, 15, 8,
    15, 8, 15, 3, 15, 8, 15, 8, 3, 15, 6, 10, 15, 15, 10, 8,
    15, 3, 15, 10, 10, 8, 9, 10, 6, 15, 8, 15, 3, 6, 6, 8,
    15, 3, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3, 15, 15, 8,
};
// BC6H's header layout per mode (the endpoint bits that follow the mode
// bits, in stream order): each entry is endpoint value << 4 | bit, the
// values being (w, x, y, z) x (r, g, b)
constexpr uint8_t kBc6Header[14][75] = {
    {116, 132, 180, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22,
     23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52,
     164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 176, 160, 161, 162, 163,
     80, 81, 82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178,
     144, 145, 146, 147, 148, 179},
    {117, 164, 165, 0, 1, 2, 3, 4, 5, 6, 176, 177, 132, 16, 17, 18, 19, 20,
     21, 22, 133, 178, 116, 32, 33, 34, 35, 36, 37, 38, 179, 181, 180, 48,
     49, 50, 51, 52, 53, 112, 113, 114, 115, 64, 65, 66, 67, 68, 69, 160,
     161, 162, 163, 80, 81, 82, 83, 84, 85, 128, 129, 130, 131, 96, 97, 98,
     99, 100, 101, 144, 145, 146, 147, 148, 149},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25,
     32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 10, 112,
     113, 114, 115, 64, 65, 66, 67, 26, 176, 160, 161, 162, 163, 80, 81, 82,
     83, 42, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145,
     146, 147, 148, 179, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25,
     32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 10, 164, 112,
     113, 114, 115, 64, 65, 66, 67, 68, 26, 160, 161, 162, 163, 80, 81, 82,
     83, 42, 177, 128, 129, 130, 131, 96, 97, 98, 99, 176, 178, 144, 145,
     146, 147, 116, 179, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25,
     32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 10, 132, 112,
     113, 114, 115, 64, 65, 66, 67, 26, 176, 160, 161, 162, 163, 80, 81, 82,
     83, 84, 42, 128, 129, 130, 131, 96, 97, 98, 99, 177, 178, 144, 145, 146,
     147, 180, 179, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 132, 16, 17, 18, 19, 20, 21, 22, 23, 24, 116,
     32, 33, 34, 35, 36, 37, 38, 39, 40, 180, 48, 49, 50, 51, 52, 164, 112,
     113, 114, 115, 64, 65, 66, 67, 68, 176, 160, 161, 162, 163, 80, 81, 82,
     83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145,
     146, 147, 148, 179, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 164, 132, 16, 17, 18, 19, 20, 21, 22, 23, 178,
     116, 32, 33, 34, 35, 36, 37, 38, 39, 179, 180, 48, 49, 50, 51, 52, 53,
     112, 113, 114, 115, 64, 65, 66, 67, 68, 176, 160, 161, 162, 163, 80, 81,
     82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 101, 144, 145,
     146, 147, 148, 149, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 176, 132, 16, 17, 18, 19, 20, 21, 22, 23, 117,
     116, 32, 33, 34, 35, 36, 37, 38, 39, 165, 180, 48, 49, 50, 51, 52, 164,
     112, 113, 114, 115, 64, 65, 66, 67, 68, 69, 160, 161, 162, 163, 80, 81,
     82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145,
     146, 147, 148, 179, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 177, 132, 16, 17, 18, 19, 20, 21, 22, 23, 133,
     116, 32, 33, 34, 35, 36, 37, 38, 39, 181, 180, 48, 49, 50, 51, 52, 164,
     112, 113, 114, 115, 64, 65, 66, 67, 68, 176, 160, 161, 162, 163, 80, 81,
     82, 83, 84, 85, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145,
     146, 147, 148, 179, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 164, 176, 177, 132, 16, 17, 18, 19, 20, 21, 117, 133,
     178, 116, 32, 33, 34, 35, 36, 37, 165, 179, 181, 180, 48, 49, 50, 51,
     52, 53, 112, 113, 114, 115, 64, 65, 66, 67, 68, 69, 160, 161, 162, 163,
     80, 81, 82, 83, 84, 85, 128, 129, 130, 131, 96, 97, 98, 99, 100, 101,
     144, 145, 146, 147, 148, 149, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25,
     32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 53, 54, 55,
     56, 57, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 80, 81, 82, 83, 84, 85,
     86, 87, 88, 89, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25,
     32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 53, 54, 55,
     56, 10, 64, 65, 66, 67, 68, 69, 70, 71, 72, 26, 80, 81, 82, 83, 84, 85,
     86, 87, 88, 42, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25,
     32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 53, 54, 55,
     11, 10, 64, 65, 66, 67, 68, 69, 70, 71, 27, 26, 80, 81, 82, 83, 84, 85,
     86, 87, 43, 42, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25,
     32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 15, 14, 13, 12,
     11, 10, 64, 65, 66, 67, 31, 30, 29, 28, 27, 26, 80, 81, 82, 83, 47, 46,
     45, 44, 43, 42, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
};

// BC7's interpolation weights for 2-, 3- and 4-bit indices
constexpr uint8_t kWeights2[4] = {0, 21, 43, 64};
constexpr uint8_t kWeights3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
constexpr uint8_t kWeights4[16] = {0,  4,  9,  13, 17, 21, 26, 30,
                                   34, 38, 43, 47, 51, 55, 60, 64};

const uint8_t* weights(int bits) {
  return bits == 2 ? kWeights2 : bits == 3 ? kWeights3 : kWeights4;
}

int subset(int ns, int partition, int i) {
  if (ns == 2) return 1 & (kPartition2[partition] >> i);
  if (ns == 3) return 3 & (kPartition3[partition] >> (2 * i));
  return 0;
}

// bits [bit, bit + count) of a 16-byte block, LSB first (count <= 8)
int get_bits(const uint8_t* src, int bit, int count) {
  if (count == 0) return 0;
  const int by = bit >> 3, sh = bit & 7;
  int x = src[by];
  if (sh + count > 8) x |= src[by + 1] << 8;
  return (x >> sh) & ((1 << count) - 1);
}

struct Rgba {
  uint8_t r, g, b, a;
};

Rgba decode_565(int x) {
  int r = (x & 0xf800) >> 8, g = (x & 0x7e0) >> 3, b = (x & 0x1f) << 3;
  return Rgba{static_cast<uint8_t>(r | r >> 5),
              static_cast<uint8_t>(g | g >> 6),
              static_cast<uint8_t>(b | b >> 5), 255};
}

// BC1's colours; BC2 and BC3 always take the four-colour mode
void bc1_color(Rgba* out, const uint8_t* s, bool four) {
  const int c0 = s[0] | s[1] << 8, c1 = s[2] | s[3] << 8;
  const uint32_t lut = s[4] | s[5] << 8 | s[6] << 16 |
                       static_cast<uint32_t>(s[7]) << 24;
  Rgba p[4];
  p[0] = decode_565(c0);
  p[1] = decode_565(c1);
  const int r0 = p[0].r, g0 = p[0].g, b0 = p[0].b;
  const int r1 = p[1].r, g1 = p[1].g, b1 = p[1].b;
  if (c0 > c1 || four) {
    p[2] = Rgba{static_cast<uint8_t>((2 * r0 + r1) / 3),
                static_cast<uint8_t>((2 * g0 + g1) / 3),
                static_cast<uint8_t>((2 * b0 + b1) / 3), 255};
    p[3] = Rgba{static_cast<uint8_t>((r0 + 2 * r1) / 3),
                static_cast<uint8_t>((g0 + 2 * g1) / 3),
                static_cast<uint8_t>((b0 + 2 * b1) / 3), 255};
  } else {
    p[2] = Rgba{static_cast<uint8_t>((r0 + r1) / 2),
                static_cast<uint8_t>((g0 + g1) / 2),
                static_cast<uint8_t>((b0 + b1) / 2), 255};
    p[3] = Rgba{0, 0, 0, 0};
  }
  for (int n = 0; n < 16; ++n) out[n] = p[3 & (lut >> (2 * n))];
}

// BC3's alpha, BC4's grey and each of BC5's channels: 8 levels from two
// endpoints (signed: each offset by 128), 3-bit indices
void bc3_channel(uint8_t* out, int stride, const uint8_t* s, bool sign) {
  int a0 = s[0], a1 = s[1];
  if (sign) {
    a0 = static_cast<int8_t>(s[0]) + 128;
    a1 = static_cast<int8_t>(s[1]) + 128;
  }
  uint8_t a[8];
  a[0] = static_cast<uint8_t>(a0);
  a[1] = static_cast<uint8_t>(a1);
  if (a0 > a1) {
    for (int i = 1; i < 7; ++i)
      a[i + 1] = static_cast<uint8_t>(((7 - i) * a0 + i * a1) / 7);
  } else {
    for (int i = 1; i < 5; ++i)
      a[i + 1] = static_cast<uint8_t>(((5 - i) * a0 + i * a1) / 5);
    a[6] = 0;
    a[7] = 255;
  }
  const uint32_t lut1 = s[2] | s[3] << 8 | s[4] << 16;
  const uint32_t lut2 = s[5] | s[6] << 8 | s[7] << 16;
  for (int n = 0; n < 8; ++n) out[stride * n] = a[7 & (lut1 >> (3 * n))];
  for (int n = 0; n < 8; ++n)
    out[stride * (8 + n)] = a[7 & (lut2 >> (3 * n))];
}

uint8_t expand(int v, int bits) {
  const uint8_t x = static_cast<uint8_t>(v << (8 - bits));
  return static_cast<uint8_t>(x | (x >> bits));
}

// BC7 modes: subsets, partition bits, rotation bits, index selection bits,
// colour bits, alpha bits, p-bits per endpoint, p-bits per subset, index
// bits, second index bits
struct Bc7Mode {
  uint8_t ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2;
};
constexpr Bc7Mode kBc7Modes[8] = {
    {3, 4, 0, 0, 4, 0, 1, 0, 3, 0}, {2, 6, 0, 0, 6, 0, 0, 1, 3, 0},
    {3, 6, 0, 0, 5, 0, 0, 0, 2, 0}, {2, 6, 0, 0, 7, 0, 1, 0, 2, 0},
    {1, 0, 2, 1, 5, 6, 0, 0, 2, 3}, {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},
    {1, 0, 0, 0, 7, 7, 1, 0, 4, 0}, {2, 6, 0, 0, 5, 5, 1, 0, 2, 0}};

void bc7_lerp(Rgba* dst, const Rgba* e, int s0, int s1) {
  const int t0 = 64 - s0, t1 = 64 - s1;
  dst->r = static_cast<uint8_t>((t0 * e[0].r + s0 * e[1].r + 32) >> 6);
  dst->g = static_cast<uint8_t>((t0 * e[0].g + s0 * e[1].g + 32) >> 6);
  dst->b = static_cast<uint8_t>((t0 * e[0].b + s0 * e[1].b + 32) >> 6);
  dst->a = static_cast<uint8_t>((t1 * e[0].a + s1 * e[1].a + 32) >> 6);
}

void bc7_block(Rgba* col, const uint8_t* src) {
  if (src[0] == 0) {                 // mode 8 (reserved)
    for (int i = 0; i < 16; ++i) col[i] = Rgba{0, 0, 0, 255};
    return;
  }
  int mode = 0;
  while (!(src[0] & (1 << mode))) ++mode;
  int bit = mode + 1;
  const Bc7Mode& m = kBc7Modes[mode];
  int cb = m.cb, ab = m.ab;
  const uint8_t* cw = weights(m.ib);
  const uint8_t* aw = weights(ab && m.ib2 ? m.ib2 : m.ib);
  const int partition = get_bits(src, bit, m.pb);
  bit += m.pb;
  const int rotation = get_bits(src, bit, m.rb);
  bit += m.rb;
  const int index_sel = get_bits(src, bit, m.isb);
  bit += m.isb;
  const int numep = m.ns * 2;
  int ep[6][4];
  for (int c = 0; c < 3; ++c)
    for (int i = 0; i < numep; ++i, bit += cb)
      ep[i][c] = get_bits(src, bit, cb);
  for (int i = 0; i < numep; ++i) {
    ep[i][3] = ab ? get_bits(src, bit, ab) : 255;
    bit += ab;
  }
  if (m.epb || m.spb) {
    ++cb;
    if (ab) ++ab;
    for (int i = 0; i < numep; ++i) {
      const int pbit = m.epb ? get_bits(src, bit + i, 1)
                             : get_bits(src, bit + i / 2, 1);
      for (int c = 0; c < 3 + (ab ? 1 : 0); ++c)
        ep[i][c] = ep[i][c] << 1 | pbit;
    }
    bit += m.epb ? numep : numep / 2;
  }
  Rgba e[6];
  for (int i = 0; i < numep; ++i) {
    e[i].r = expand(ep[i][0], cb);
    e[i].g = expand(ep[i][1], cb);
    e[i].b = expand(ep[i][2], cb);
    e[i].a = ab ? expand(ep[i][3], ab) : static_cast<uint8_t>(ep[i][3]);
  }
  int cibit = bit, aibit = bit + 16 * m.ib - m.ns;
  for (int i = 0; i < 16; ++i) {
    const int s = subset(m.ns, partition, i) * 2;
    int ib = m.ib;
    if (i == 0 || (m.ns == 2 && i == kAnchor2[partition]) ||
        (m.ns == 3 && (i == kAnchor3a[partition] || i == kAnchor3b[partition])))
      --ib;
    const int i0 = get_bits(src, cibit, ib);
    cibit += ib;
    if (ab && m.ib2) {
      const int ib2 = i == 0 ? m.ib2 - 1 : m.ib2;
      const int i1 = get_bits(src, aibit, ib2);
      aibit += ib2;
      if (index_sel) bc7_lerp(&col[i], &e[s], aw[i1], cw[i0]);
      else bc7_lerp(&col[i], &e[s], cw[i0], aw[i1]);
    } else {
      bc7_lerp(&col[i], &e[s], cw[i0], cw[i0]);
    }
    uint8_t t;
    if (rotation == 1) { t = col[i].r; col[i].r = col[i].a; col[i].a = t; }
    if (rotation == 2) { t = col[i].g; col[i].g = col[i].a; col[i].a = t; }
    if (rotation == 3) { t = col[i].b; col[i].b = col[i].a; col[i].a = t; }
  }
}

// BC6H modes: subsets, transformed (delta) endpoints, partition bits,
// endpoint bits, delta bits of red, green, blue
struct Bc6Mode {
  int8_t ns, tr, pb, epb, rb, gb, bb;
};
constexpr Bc6Mode kBc6Modes[14] = {
    {2, 1, 5, 10, 5, 5, 5}, {2, 1, 5, 7, 6, 6, 6},  {2, 1, 5, 11, 5, 4, 4},
    {2, 1, 5, 11, 4, 5, 4}, {2, 1, 5, 11, 4, 4, 5}, {2, 1, 5, 9, 5, 5, 5},
    {2, 1, 5, 8, 6, 5, 5},  {2, 1, 5, 8, 5, 6, 5},  {2, 1, 5, 8, 5, 5, 6},
    {2, 0, 5, 6, 6, 6, 6},  {1, 0, 0, 10, 10, 10, 10},
    {1, 1, 0, 11, 9, 9, 9}, {1, 1, 0, 12, 8, 8, 8}, {1, 1, 0, 16, 4, 4, 4}};

int sign_extend(int v, int bits) {
  return (v & (1 << (bits - 1))) ? v - (1 << bits) : v;
}

int unquantize(int v, int bits, bool sign) {
  if (!sign) {
    if (bits >= 15) return v;
    if (v == 0) return 0;
    if (v == (1 << bits) - 1) return 0xffff;
    return ((v << 16) + 0x8000) >> bits;
  }
  if (bits >= 16) return v;
  bool neg = v < 0;
  int x = neg ? -v : v;
  if (x != 0) {
    if (x >= (1 << (bits - 1)) - 1) x = 0x7fff;
    else x = ((x << 15) + 0x4000) >> (bits - 1);
  }
  return neg ? -x : x;
}

// a half float's value (rygorous's half_to_float)
float half_to_float(uint16_t h) {
  union { uint32_t u; float f; } o, m;
  m.u = 0x77800000;
  o.u = static_cast<uint32_t>(h & 0x7fff) << 13;
  o.f *= m.f;
  m.u = 0x47800000;
  if (o.f >= m.f) o.u |= 255u << 23;
  o.u |= static_cast<uint32_t>(h & 0x8000) << 16;
  return o.f;
}

uint8_t bc6_channel(int v, bool sign) {
  int h;
  if (!sign) h = (v * 31) / 64;
  else if (v < 0) h = 0x8000 | ((-v) * 31) / 32;
  else h = (v * 31) / 32;
  const float f = half_to_float(static_cast<uint16_t>(h));
  if (f < 0.0f) return 0;
  if (f > 1.0f) return 255;
  return static_cast<uint8_t>(f * 255.0f);
}

void bc6_block(Rgba* col, const uint8_t* src, bool sign) {
  int mode = src[0] & 0x1f, bit = 5, header = 75, ib = 3;
  if ((mode & 3) < 2) {
    mode &= 3;
    bit = 2;
  } else if ((mode & 3) == 2) {
    mode = 2 + (mode >> 2);
    header = 72;
  } else {
    mode = 10 + (mode >> 2);
    header = 60;
    ib = 4;
  }
  if (mode >= 14) {                  // a reserved mode: black
    for (int i = 0; i < 16; ++i) col[i] = Rgba{0, 0, 0, 255};
    return;
  }
  const Bc6Mode& m = kBc6Modes[mode];
  int ep[12] = {0};
  for (int i = 0; i < header; ++i) {
    const int slot = kBc6Header[mode][i];
    ep[slot >> 4] |= get_bits(src, bit + i, 1) << (slot & 15);
  }
  bit += header;
  const int partition = get_bits(src, bit, m.pb);
  bit += m.pb;
  const int numep = m.ns == 2 ? 12 : 6;
  const int mask = (1 << m.epb) - 1;
  const int delta[3] = {m.rb, m.gb, m.bb};
  int e[12];
  for (int i = 0; i < numep; ++i) e[i] = ep[i];
  if (sign)
    for (int c = 0; c < 3; ++c) e[c] = sign_extend(ep[c], m.epb);
  if (sign || m.tr)
    for (int i = 3; i < numep; ++i) e[i] = sign_extend(ep[i], delta[i % 3]);
  if (m.tr)
    for (int i = 3; i < numep; ++i) e[i] = (e[i] + e[i % 3]) & mask;
  // Pillow reads a signed endpoint as a 16-bit integer: a transformed
  // endpoint keeps its masked bits (no sign extension) except at 16 bits
  for (int i = 0; i < numep && sign; ++i) e[i] = static_cast<int16_t>(e[i]);
  for (int i = 0; i < numep; ++i) e[i] = unquantize(e[i], m.epb, sign);
  const uint8_t* cw = weights(ib);
  for (int i = 0; i < 16; ++i) {
    const int s = subset(m.ns, partition, i) * 6;
    int bits = ib;
    if (i == 0 || (m.ns == 2 && i == kAnchor2[partition])) --bits;
    const int w = cw[get_bits(src, bit, bits)];
    bit += bits;
    int v[3];
    for (int c = 0; c < 3; ++c)
      v[c] = (e[s + c] * (64 - w) + e[s + 3 + c] * w) >> 6;   // no rounding
    col[i] = Rgba{bc6_channel(v[0], sign), bc6_channel(v[1], sign),
                  bc6_channel(v[2], sign), 255};
  }
}

}  // namespace

extern "C" {

// The pixels of a BCn texture: format 1-7 (BC1 ... BC7), sign (BC5 and
// BC6H) 0 or 1; src holds the ceil(width / 4) x ceil(height / 4) blocks
// row by row. out: height x width x channels bytes, channels 4 (BC1, BC2,
// BC3, BC7), 1 (BC4) or 3 (BC5, BC6H). Returns 0, -1 when src is too short
// or -2 for an unknown format.
int nm_bcn_decode(const uint8_t* src, int64_t size, int format, int sign,
                  int64_t width, int64_t height, uint8_t* out) {
  if (format < 1 || format > 7) return -2;
  const int64_t bw = (width + 3) / 4, bh = (height + 3) / 4;
  const int block = (format == 1 || format == 4) ? 8 : 16;
  if (size < bw * bh * block) return -1;
  const int ch = format == 4 ? 1 : (format == 5 || format == 6) ? 3 : 4;
  Rgba col[16];
  uint8_t grey[16];
  for (int64_t by = 0; by < bh; ++by) {
    for (int64_t bx = 0; bx < bw; ++bx) {
      const uint8_t* s = src + (by * bw + bx) * block;
      std::memset(col, 0, sizeof col);
      switch (format) {
        case 1: bc1_color(col, s, false); break;
        case 2:
          bc1_color(col, s + 8, true);
          for (int n = 0; n < 16; ++n) {
            const int av = 0xf & (s[n >> 1] >> ((n & 1) * 4));
            col[n].a = static_cast<uint8_t>(av << 4 | av);
          }
          break;
        case 3:
          bc1_color(col, s + 8, true);
          bc3_channel(&col[0].a, 4, s, false);
          break;
        case 4: bc3_channel(grey, 1, s, false); break;
        case 5:
          bc3_channel(&col[0].r, 4, s, sign);
          bc3_channel(&col[0].g, 4, s + 8, sign);
          for (int n = 0; n < 16 && sign; ++n) col[n].b = 128;
          break;
        case 6: bc6_block(col, s, sign); break;
        default: bc7_block(col, s); break;
      }
      for (int j = 0; j < 4; ++j) {
        const int64_t y = by * 4 + j;
        if (y >= height) break;
        for (int i = 0; i < 4; ++i) {
          const int64_t x = bx * 4 + i;
          if (x >= width) break;
          uint8_t* o = out + (y * width + x) * ch;
          if (ch == 1) {
            o[0] = grey[j * 4 + i];
          } else {
            std::memcpy(o, &col[j * 4 + i], ch);
          }
        }
      }
    }
  }
  return 0;
}

}  // extern "C"

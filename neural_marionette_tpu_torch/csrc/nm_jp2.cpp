// JPEG 2000 decoder of the PyTorch/CUDA port's host library: the .jp2 and
// .j2k texture files of apps/retarget that the JAX package reads through
// imageio and Pillow (OpenJPEG 2.5's tile-by-tile decoding, then Pillow's
// Jpeg2KDecode.c unpackers), decoded to the same samples. Built by
// kernels.py (g++ -O3 -std=c++17 -shared -fPIC -pthread) into _build/ at
// first use, beside nm_host, and bound in data/native.py. The JP2 boxes are
// read in viz/jpeg2000.py, which hands this library the codestream.
//
//   * the codestream's markers: SIZ, COD/COC, QCD/QCC, RGN, POC, SOT/SOD,
//     EOC, SOP and EPH where Scod sets them; COM, TLM, PLM, PLT, CRG and
//     unknown segments are skipped; PPM/PPT, HTJ2K (its CAP marker and
//     code-block style) and Part 2's MCT/MCC/MCO/CBD are refused by name;
//   * tier 2: packet headers with their tag trees, zero-length packets,
//     Lblock and pass counts, codeword segments per code-block style, in
//     the five progression orders with POC, quality layers and precincts,
//     tile-parts joined per tile;
//   * tier 1: the MQ decoder and the significance, refinement and cleanup
//     passes (with the cleanup's run mode) under every code-block style of
//     Part 1 (the arithmetic bypass's raw passes, context reset,
//     termination on each pass, vertically causal contexts, predictable
//     termination, segmentation symbols), OpenJPEG's mid-point
//     reconstruction and its undoing of a region of interest's shift;
//   * dequantisation (reversible, scalar derived and expounded), the integer
//     5/3 and float 9/7 inverse wavelets at 0-32 levels with OpenJPEG's
//     constants and order of operations, RCT and ICT, the DC shift;
//   * Pillow's unpacking of each tile into its mode (L, P, PA, I;16, LA,
//     RGB, RGBA, CMYK), with its sYCC conversion (libImaging's fixed-point
//     tables); or (nm_jp2_components) every whole component's samples as
//     opj_decode leaves them, for OpenCV's reading in viz/opencv_read.py.
//
// Every read is bounds-checked. Exposed with C linkage for ctypes; nothing
// throws across that boundary: each entry point returns an error code and
// writes a message.

#pragma GCC optimize("fp-contract=off")   // OpenJPEG's float order, no FMA

#include <algorithm>
#include <cmath>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <string>
#include <vector>

namespace {

enum { kOk = 0, kCorrupt = 1, kUnsupported = 2, kNoRoom = 3 };
// code-block styles (Table A.19)
enum { kLazy = 1, kReset = 2, kTermAll = 4, kVsc = 8, kPterm = 16,
       kSegSym = 32 };

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
  throw Failure{code, std::string("JPEG 2000: ") + buf};
}

// Pillow refuses images above twice its MAX_IMAGE_PIXELS; no tile-component
// or code-block grid of a file it reads is larger
constexpr int64_t kMaxPixels = 178956970;
constexpr int kMaxRes = 33;      // 32 decomposition levels
constexpr int kMaxBands = 97;    // 3 * 32 + 1
constexpr int64_t kMaxCodeBlocks = int64_t(1) << 24;

int64_t ceildiv(int64_t a, int64_t b) { return (a + b - 1) / b; }
// ceil(a / 2^b) and floor(a / 2^b), a of either sign
int64_t ceildivpow2(int64_t a, int b) {
  return (a + (int64_t(1) << b) - 1) >> b;
}
int64_t floordivpow2(int64_t a, int b) { return a >> b; }
int floorlog2(uint32_t v) {
  int l = 0;
  while (v > 1) {
    v >>= 1;
    ++l;
  }
  return l;
}

// ------------------------------------------------------------ byte reader
struct Reader {
  const uint8_t* p;
  int64_t n;
  int64_t pos = 0;
  Reader(const uint8_t* d, int64_t size) : p(d), n(size) {}
  void need(int64_t k) const {
    if (k < 0 || pos + k > n)
      fail(kCorrupt, "the codestream ends inside a marker segment");
  }
  uint32_t u8() {
    need(1);
    return p[pos++];
  }
  uint32_t u16() {
    need(2);
    uint32_t v = (uint32_t(p[pos]) << 8) | p[pos + 1];
    pos += 2;
    return v;
  }
  uint32_t u32() {
    uint32_t hi = u16();
    return (hi << 16) | u16();
  }
};

// ----------------------------------------------------------- parameters
struct Siz {
  int64_t X1, Y1, X0, Y0, TW, TH, TX0, TY0;
  int C;
  int prec[4], sgnd[4], dx[4], dy[4];
  int64_t ntx, nty;
};

struct CompParams {          // COD/COC and QCD/QCC of one component
  int numres = 1;
  int cblkw = 6, cblkh = 6;  // exponents
  int cblksty = 0;           // kLazy | kReset | kTermAll | ... below
  int roishift = 0;          // RGN's shift of the region of interest
  int qmfbid = 1;            // 1: reversible 5/3, 0: irreversible 9/7
  int prc_custom = 0;
  uint8_t prcw[kMaxRes], prch[kMaxRes];
  int qntsty = 0, numgbits = 2;
  int expn[kMaxBands], mant[kMaxBands];
  CompParams() {
    std::fill(prcw, prcw + kMaxRes, 15);
    std::fill(prch, prch + kMaxRes, 15);
    std::fill(expn, expn + kMaxBands, 0);
    std::fill(mant, mant + kMaxBands, 0);
  }
};

struct Poc {
  int resno0, compno0, layno1, resno1, compno1, prg;
};

struct Params {              // a tile's coding parameters (or the defaults)
  int csty = 0;              // bit 1: SOP, bit 2: EPH
  int prg = 0, numlayers = 1, mct = 0;
  std::vector<CompParams> comps;
  std::vector<Poc> pocs;
};

const char* marker_name(uint32_t m) {
  switch (m) {
    case 0xFF60: return "a PPM marker (packed packet headers)";
    case 0xFF61: return "a PPT marker (packed packet headers)";
    case 0xFF50: return "a CAP marker (HTJ2K, Part 15)";
    case 0xFF74: return "an MCT marker (Part 2)";
    case 0xFF75: return "an MCC marker (Part 2)";
    case 0xFF77: return "an MCO marker (Part 2)";
    case 0xFF78: return "a CBD marker (Part 2)";
    default: return nullptr;
  }
}

void read_spcod(Reader& r, CompParams& c, int prc_custom) {
  int nl = int(r.u8());
  if (nl + 1 > kMaxRes)
    fail(kCorrupt, "%d decomposition levels (at most 32)", nl);
  c.numres = nl + 1;
  c.cblkw = int(r.u8()) + 2;
  c.cblkh = int(r.u8()) + 2;
  if (c.cblkw > 10 || c.cblkh > 10 || c.cblkw + c.cblkh > 12)
    fail(kCorrupt, "a code-block of 2^%d x 2^%d", c.cblkw, c.cblkh);
  c.cblksty = int(r.u8());
  if (c.cblksty & ~0x3F)
    fail(kUnsupported, "code-block style 0x%02x (HTJ2K, Part 15) is not "
         "read", c.cblksty);
  c.qmfbid = int(r.u8());
  if (c.qmfbid > 1)
    fail(kCorrupt, "wavelet transform %d (0 or 1)", c.qmfbid);
  c.prc_custom = prc_custom;
  for (int i = 0; i < c.numres; ++i) {
    if (prc_custom) {
      uint32_t v = r.u8();
      c.prcw[i] = uint8_t(v & 15);
      c.prch[i] = uint8_t(v >> 4);
      if (i > 0 && (c.prcw[i] == 0 || c.prch[i] == 0))
        fail(kCorrupt, "a precinct size of 2^0 past resolution 0");
    } else {
      c.prcw[i] = c.prch[i] = 15;
    }
  }
}

void read_sqcd(Reader& r, CompParams& c, int64_t end) {
  uint32_t s = r.u8();
  c.qntsty = int(s & 31);
  c.numgbits = int(s >> 5);
  if (c.qntsty > 2)
    fail(kCorrupt, "quantization style %d", c.qntsty);
  int64_t left = end - r.pos;
  if (c.qntsty == 1) {
    if (left != 2) fail(kCorrupt, "a scalar derived QCD/QCC of %lld bytes",
                        static_cast<long long>(left));
    uint32_t v = r.u16();
    c.expn[0] = int(v >> 11);
    c.mant[0] = int(v & 0x7ff);
    for (int b = 1; b < kMaxBands; ++b) {
      int e = c.expn[0] - (b - 1) / 3;
      c.expn[b] = e > 0 ? e : 0;
      c.mant[b] = c.mant[0];
    }
    return;
  }
  int64_t nb = c.qntsty == 0 ? left : left / 2;
  if (c.qntsty == 2 && left % 2)
    fail(kCorrupt, "a QCD/QCC segment of odd length");
  for (int64_t b = 0; b < nb; ++b) {
    if (c.qntsty == 0) {
      uint32_t v = r.u8();
      if (b < kMaxBands) {
        c.expn[b] = int(v >> 3);
        c.mant[b] = 0;
      }
    } else {
      uint32_t v = r.u16();
      if (b < kMaxBands) {
        c.expn[b] = int(v >> 11);
        c.mant[b] = int(v & 0x7ff);
      }
    }
  }
}

int comp_index(Reader& r, const Siz& siz) {
  uint32_t c = siz.C < 257 ? r.u8() : r.u16();
  if (int64_t(c) >= siz.C)
    fail(kCorrupt, "a marker names component %u of %d", c, siz.C);
  return int(c);
}

// One marker segment of a main or tile-part header (not SIZ, SOT, SOD),
// ending at end.
void read_segment(uint32_t m, Reader& r, int64_t end, const Siz& siz,
                  Params& p, bool& has_cod, bool& has_qcd) {
  if (const char* what = marker_name(m))
    fail(kUnsupported, "%s is not read", what);
  switch (m) {
    case 0xFF52: {   // COD
      int scod = int(r.u8());
      p.csty = scod;
      p.prg = int(r.u8());
      if (p.prg > 4) fail(kCorrupt, "progression order %d", p.prg);
      p.numlayers = int(r.u16());
      if (p.numlayers == 0) fail(kCorrupt, "a COD with no quality layer");
      p.mct = int(r.u8());
      if (p.mct > 1) fail(kCorrupt, "multiple component transform %d",
                          p.mct);
      CompParams c0 = p.comps[0];
      read_spcod(r, c0, scod & 1);
      for (auto& c : p.comps) {   // the coding style of every component
        c.numres = c0.numres;
        c.cblkw = c0.cblkw;
        c.cblkh = c0.cblkh;
        c.cblksty = c0.cblksty;
        c.qmfbid = c0.qmfbid;
        c.prc_custom = c0.prc_custom;
        std::copy(c0.prcw, c0.prcw + kMaxRes, c.prcw);
        std::copy(c0.prch, c0.prch + kMaxRes, c.prch);
      }
      has_cod = true;
      break;
    }
    case 0xFF53: {   // COC
      int ci = comp_index(r, siz);
      int scoc = int(r.u8());
      read_spcod(r, p.comps[ci], scoc & 1);
      break;
    }
    case 0xFF5C: {   // QCD
      CompParams c0 = p.comps[0];
      read_sqcd(r, c0, end);
      for (auto& c : p.comps) {
        c.qntsty = c0.qntsty;
        c.numgbits = c0.numgbits;
        std::copy(c0.expn, c0.expn + kMaxBands, c.expn);
        std::copy(c0.mant, c0.mant + kMaxBands, c.mant);
      }
      has_qcd = true;
      break;
    }
    case 0xFF5D: {   // QCC
      int ci = comp_index(r, siz);
      read_sqcd(r, p.comps[ci], end);
      break;
    }
    case 0xFF5E: {   // RGN: Srgn (implicit, 0), then the shift
      int ci = comp_index(r, siz);
      r.u8();
      p.comps[ci].roishift = int(r.u8());
      break;
    }
    case 0xFF5F: {   // POC
      int csize = siz.C < 257 ? 1 : 2;
      int64_t entry = 5 + 2 * csize;
      int64_t left = end - r.pos;
      if (left <= 0 || left % entry)
        fail(kCorrupt, "a POC segment of %lld bytes",
             static_cast<long long>(left));
      for (int64_t k = 0; k < left / entry; ++k) {
        Poc q;
        q.resno0 = int(r.u8());
        q.compno0 = int(csize == 1 ? r.u8() : r.u16());
        q.layno1 = std::min(int(r.u16()), p.numlayers);
        q.resno1 = std::min(int(r.u8()), kMaxRes);
        int ce = int(csize == 1 ? r.u8() : r.u16());
        if (ce == 0) ce = csize == 1 ? 256 : 16384;
        q.compno1 = std::min(ce, siz.C);
        q.prg = int(r.u8());
        if (q.prg > 4) fail(kCorrupt, "progression order %d in POC", q.prg);
        if (q.resno0 >= q.resno1 || q.compno0 >= q.compno1)
          fail(kCorrupt, "an empty POC progression");
        p.pocs.push_back(q);
      }
      break;
    }
    default:         // COM, TLM, PLM, PLT, CRG, CPF and the unknown: skipped
      break;
  }
  if (r.pos > end) fail(kCorrupt, "marker 0x%04X runs past its length", m);
  r.pos = end;
}

// -------------------------------------------------------------- codestream
struct TileData {
  std::vector<uint8_t> bytes;   // the tile-parts' packet data, joined
  Params params;
  bool seen = false;
  int parts = 0;
};

struct Codestream {
  Siz siz{};
  Params defaults;
  std::vector<TileData> tiles;
  std::vector<int64_t> order;   // tiles in the order of their first part

  void read_siz(Reader& r) {
    if (r.u16() != 0xFF4F) fail(kCorrupt, "no SOC marker");
    if (r.u16() != 0xFF51) fail(kCorrupt, "no SIZ marker after SOC");
    int64_t len = r.u16();
    int64_t start = r.pos;
    r.u16();   // Rsiz
    siz.X1 = r.u32();
    siz.Y1 = r.u32();
    siz.X0 = r.u32();
    siz.Y0 = r.u32();
    siz.TW = r.u32();
    siz.TH = r.u32();
    siz.TX0 = r.u32();
    siz.TY0 = r.u32();
    int64_t C = r.u16();
    if (C < 1 || C > 16384) fail(kCorrupt, "%lld components",
                                 static_cast<long long>(C));
    if (C > 4)
      fail(kUnsupported, "%lld components; Pillow reads at most 4",
           static_cast<long long>(C));
    if (len != 38 + 3 * C) fail(kCorrupt, "a SIZ segment of %lld bytes",
                                static_cast<long long>(len));
    siz.C = int(C);
    for (int c = 0; c < siz.C; ++c) {
      uint32_t s = r.u8();
      siz.prec[c] = int(s & 0x7f) + 1;
      siz.sgnd[c] = int(s >> 7);
      siz.dx[c] = int(r.u8());
      siz.dy[c] = int(r.u8());
      if (siz.dx[c] == 0 || siz.dy[c] == 0)
        fail(kCorrupt, "a component sub-sampled by 0");
      if (siz.prec[c] > 31)
        fail(kUnsupported, "%d-bit samples (OpenJPEG reads up to 31)",
             siz.prec[c]);
    }
    r.pos = start + len - 2;
    if (siz.X1 <= siz.X0 || siz.Y1 <= siz.Y0 || siz.TW == 0 || siz.TH == 0
        || siz.TX0 > siz.X0 || siz.TY0 > siz.Y0 || siz.TX0 + siz.TW <= siz.X0
        || siz.TY0 + siz.TH <= siz.Y0)
      fail(kCorrupt, "the SIZ geometry is not valid");
    if ((siz.X1 - siz.X0) * (siz.Y1 - siz.Y0) > 2 * kMaxPixels)
      fail(kUnsupported, "an image of %lld x %lld samples",
           static_cast<long long>(siz.X1 - siz.X0),
           static_cast<long long>(siz.Y1 - siz.Y0));
    siz.ntx = ceildiv(siz.X1 - siz.TX0, siz.TW);
    siz.nty = ceildiv(siz.Y1 - siz.TY0, siz.TH);
    if (siz.ntx * siz.nty > 65535)
      fail(kCorrupt, "%lld x %lld tiles (at most 65535)",
           static_cast<long long>(siz.ntx), static_cast<long long>(siz.nty));
    defaults.comps.assign(siz.C, CompParams());
  }

  void read(const uint8_t* data, int64_t size, bool headers_only) {
    Reader r(data, size);
    read_siz(r);
    bool has_cod = false, has_qcd = false;
    for (;;) {   // main header
      uint32_t m = r.u16();
      if (m == 0xFF90) break;
      if (m == 0xFFD9) fail(kCorrupt, "the codestream has no tile");
      if ((m >> 8) != 0xFF || m < 0xFF30)
        fail(kCorrupt, "0x%04X where a marker should be", m);
      int64_t len = r.u16();
      if (len < 2) fail(kCorrupt, "a marker segment of length %lld",
                        static_cast<long long>(len));
      int64_t end = r.pos + len - 2;
      r.need(len - 2);
      read_segment(m, r, end, siz, defaults, has_cod, has_qcd);
    }
    if (!has_cod) fail(kCorrupt, "no COD marker in the main header");
    if (!has_qcd) fail(kCorrupt, "no QCD marker in the main header");
    if (headers_only) return;
    tiles.assign(size_t(siz.ntx * siz.nty), TileData());
    r.pos -= 2;
    for (;;) {   // tile-parts, then EOC (past which nothing is read)
      int64_t sot = r.pos;
      if (r.pos + 2 > size)
        fail(kCorrupt, "the codestream ends without an EOC marker");
      uint32_t m = r.u16();
      if (m == 0xFFD9) break;
      if (m != 0xFF90)
        fail(kCorrupt, "0x%04X where a tile-part or EOC should be", m);
      if (r.u16() != 10) fail(kCorrupt, "an SOT segment of bad length");
      int64_t isot = r.u16();
      int64_t psot = r.u32();
      r.u8();   // TPsot
      r.u8();   // TNsot
      if (isot >= int64_t(tiles.size()))
        fail(kCorrupt, "tile-part of tile %lld of %lld",
             static_cast<long long>(isot),
             static_cast<long long>(tiles.size()));
      if (psot != 0 && psot < 14)
        fail(kCorrupt, "a tile-part length of %lld",
             static_cast<long long>(psot));
      TileData& t = tiles[size_t(isot)];
      if (!t.seen) {
        t.seen = true;
        t.params = defaults;
        order.push_back(isot);
      }
      bool first_part = t.parts++ == 0;
      bool tile_cod = false, tile_qcd = false;
      for (;;) {   // tile-part header
        uint32_t tm = r.u16();
        if (tm == 0xFF93) break;
        if ((tm >> 8) != 0xFF || tm < 0xFF30)
          fail(kCorrupt, "0x%04X where a marker should be", tm);
        int64_t len = r.u16();
        if (len < 2) fail(kCorrupt, "a marker segment of length %lld",
                          static_cast<long long>(len));
        int64_t end = r.pos + len - 2;
        r.need(len - 2);
        if (!first_part && (tm == 0xFF52 || tm == 0xFF53 || tm == 0xFF5C
                            || tm == 0xFF5D))
          fail(kCorrupt, "a coding marker past a tile's first tile-part");
        read_segment(tm, r, end, siz, t.params, tile_cod, tile_qcd);
      }
      int64_t data_len;
      if (psot == 0) {
        data_len = size - r.pos - 2;
        if (data_len < 0) data_len = 0;
      } else {
        data_len = sot + psot - r.pos;
        if (data_len < 0) fail(kCorrupt, "a tile-part header longer than "
                                         "the tile-part");
      }
      if (r.pos + data_len > size)
        fail(kCorrupt, "tile-part %d of tile %lld runs past the end of the "
             "codestream (%lld of %lld bytes)", t.parts - 1,
             static_cast<long long>(isot),
             static_cast<long long>(size - r.pos),
             static_cast<long long>(data_len));
      t.bytes.insert(t.bytes.end(), data + r.pos, data + r.pos + data_len);
      r.pos += data_len;
    }
  }
};

// ----------------------------------------------------------- tier 2 bits
struct Bio {   // packet header bits, with the bit stuffed after each 0xFF
  const uint8_t* p;
  int64_t start, pos, end;
  uint32_t buf = 0;
  int ct = 0;
  Bio(const uint8_t* d, int64_t s, int64_t e) : p(d), start(s), pos(s),
                                                end(e) {}
  void bytein() {
    buf = (buf << 8) & 0xffff;
    ct = buf == 0xff00 ? 7 : 8;
    if (pos < end) buf |= p[pos++];
  }
  uint32_t bit() {
    if (ct == 0) bytein();
    --ct;
    return (buf >> ct) & 1;
  }
  uint32_t read(int n) {
    uint32_t v = 0;
    for (int i = n - 1; i >= 0; --i) v |= bit() << i;
    return v;
  }
  void inalign() {
    if ((buf & 0xff) == 0xff) bytein();
    ct = 0;
  }
  int64_t numbytes() const { return pos - start; }
};

struct TagTree {
  std::vector<int32_t> value, low;
  std::vector<int64_t> parent;
  void create(int w, int h) {
    std::vector<int> lw, lh;
    int64_t n = 0;
    int cw = w, ch = h;
    do {
      lw.push_back(cw);
      lh.push_back(ch);
      n += int64_t(cw) * ch;
      if (int64_t(cw) * ch <= 1) break;
      cw = (cw + 1) / 2;
      ch = (ch + 1) / 2;
    } while (true);
    value.assign(size_t(n), 999);
    low.assign(size_t(n), 0);
    parent.assign(size_t(n), -1);
    int64_t base = 0;
    for (size_t l = 0; l + 1 < lw.size(); ++l) {
      int64_t next = base + int64_t(lw[l]) * lh[l];
      for (int j = 0; j < lh[l]; ++j)
        for (int i = 0; i < lw[l]; ++i)
          parent[size_t(base + int64_t(j) * lw[l] + i)] =
              next + int64_t(j / 2) * lw[l + 1] + i / 2;
      base = next;
    }
  }
  // 1 where the leaf's value is below threshold, reading bits as needed
  int decode(Bio& bio, int64_t leaf, int32_t threshold) {
    int64_t stk[40];
    int depth = 0;
    int64_t node = leaf;
    while (parent[size_t(node)] >= 0) {
      stk[depth++] = node;
      node = parent[size_t(node)];
    }
    int32_t lo = 0;
    for (;;) {
      if (lo > low[size_t(node)]) low[size_t(node)] = lo;
      else lo = low[size_t(node)];
      while (lo < threshold && lo < value[size_t(node)]) {
        if (bio.bit()) value[size_t(node)] = lo;
        else ++lo;
      }
      low[size_t(node)] = lo;
      if (depth == 0) break;
      node = stk[--depth];
    }
    return value[size_t(node)] < threshold ? 1 : 0;
  }
};

struct Segment {
  int numpasses = 0, maxpasses = 109, len = 0;
  int newpasses = 0;
  uint32_t newlen = 0;
};

// a code-block's next codeword segment (OpenJPEG's opj_t2_init_seg): one
// pass each under termination on every pass; under the bypass, the first
// ten passes, then two raw passes and one MQ pass in turn; else all
void add_segment(std::vector<Segment>& segs, size_t index, int cblksty) {
  if (segs.size() <= index) segs.resize(index + 1);
  Segment sg;
  if (cblksty & kTermAll) sg.maxpasses = 1;
  else if (cblksty & kLazy)
    sg.maxpasses = index == 0 ? 10
                   : (segs[index - 1].maxpasses == 1
                      || segs[index - 1].maxpasses == 10) ? 2 : 1;
  segs[index] = sg;
}

struct CodeBlock {
  int64_t x0, y0, x1, y1;
  int32_t numbps = 0;
  int numlenbits = 0;
  int numnewpasses = 0;
  int numsegs = 0;
  std::vector<Segment> segs;
  std::vector<uint8_t> data;
};

struct Precinct {
  int64_t x0, y0, x1, y1;
  int cw = 0, ch = 0;
  std::vector<CodeBlock> cblks;
  TagTree incl, imsb;
};

struct Band {
  int bandno;   // 0 LL, 1 HL, 2 LH, 3 HH
  int64_t x0, y0, x1, y1;
  int numbps;
  float stepsize;
  std::vector<Precinct> prcs;
  bool empty() const { return x1 - x0 == 0 || y1 - y0 == 0; }
};

struct Resolution {
  int64_t x0, y0, x1, y1;
  int pdx, pdy;
  int64_t pw, ph;
  int numbands;
  Band bands[3];
};

struct TileComp {
  int64_t x0, y0, x1, y1;
  int numres;
  std::vector<Resolution> res;
  std::vector<int32_t> idata;   // the reversible path
  std::vector<float> fdata;     // the irreversible path
  int64_t width() const { return x1 - x0; }
  int64_t height() const { return y1 - y0; }
};

// ---------------------------------------------------------------- MQ coder
struct QeState {
  uint16_t qe;
  uint8_t nmps, nlps, sw;
};
constexpr QeState kQe[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},
    {0x0AC1, 4, 12, 0},  {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0},
    {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},
    {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0},
    {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0}, {0x3001, 21, 19, 0},
    {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0},
    {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0}, {0x08A1, 33, 30, 0},
    {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0},
    {0x0085, 40, 37, 0}, {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0},
    {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0}};

enum { kCtxZc = 0, kCtxSc = 9, kCtxMag = 14, kCtxAgg = 17, kCtxUni = 18,
       kNumCtx = 19 };

struct MQ {
  const uint8_t* d = nullptr;
  int64_t len = 0, bp = 0;
  uint32_t a = 0, c = 0;
  int ct = 0;
  uint8_t st[kNumCtx], mps[kNumCtx];

  // past the segment the decoder reads 0xFF 0xFF, a marker: ones
  uint32_t byte(int64_t i) const { return i < len ? d[i] : 0xFF; }
  void reset_states() {
    std::fill(st, st + kNumCtx, 0);
    std::fill(mps, mps + kNumCtx, 0);
    st[kCtxUni] = 46;
    st[kCtxAgg] = 3;
    st[kCtxZc] = 4;
  }
  void init(const uint8_t* data, int64_t n) {
    d = data;
    len = n;
    bp = 0;
    c = byte(0) << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }
  void bytein() {
    if (byte(bp) == 0xFF) {
      if (byte(bp + 1) > 0x8F) {
        c += 0xFF00;
        ct = 8;
      } else {
        ++bp;
        c += byte(bp) << 9;
        ct = 7;
      }
    } else {
      ++bp;
      c += byte(bp) << 8;
      ct = 8;
    }
  }
  // the bypass's raw bits (opj_mqc_raw_decode): bp is the next byte
  void raw_init(const uint8_t* data, int64_t n) {
    d = data;
    len = n;
    bp = 0;
    c = 0;
    ct = 0;
  }
  int raw_decode() {
    if (ct == 0) {
      if (c == 0xFF) {
        if (byte(bp) > 0x8F) {
          c = 0xFF;
          ct = 8;
        } else {
          c = byte(bp++);
          ct = 7;
        }
      } else {
        c = byte(bp++);
        ct = 8;
      }
    }
    --ct;
    return int((c >> ct) & 1);
  }
  void renorm() {
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      --ct;
    } while (a < 0x8000);
  }
  int decode(int cx) {
    const QeState& s = kQe[st[cx]];
    const uint32_t qe = s.qe;
    int bit;
    a -= qe;
    if ((c >> 16) < qe) {          // LPS exchange
      if (a < qe) {
        bit = mps[cx];
        st[cx] = s.nmps;
      } else {
        bit = 1 - mps[cx];
        if (s.sw) mps[cx] ^= 1;
        st[cx] = s.nlps;
      }
      a = qe;
      renorm();
    } else {
      c -= qe << 16;
      if ((a & 0x8000) == 0) {     // MPS exchange
        if (a < qe) {
          bit = 1 - mps[cx];
          if (s.sw) mps[cx] ^= 1;
          st[cx] = s.nlps;
        } else {
          bit = mps[cx];
          st[cx] = s.nmps;
        }
        renorm();
      } else {
        bit = mps[cx];
      }
    }
    return bit;
  }
};

// ------------------------------------------------------------------ tier 1
// the zero-coding context (Table D.1) of the significant neighbours' counts
// h (0-2), v (0-2) and d (0-4), per band orientation (0 LL, 1 HL, 2 LH, 3
// HH), indexed by h | v << 2 | d << 4
struct ZcTable {
  uint8_t ctx[4][128];
  ZcTable() {
    for (int o = 0; o < 4; ++o)
      for (int i = 0; i < 128; ++i) {
        int hh = i & 3, vv = (i >> 2) & 3, dd = i >> 4, n;
        if (o == 3) {
          const int hv = hh + vv;
          n = dd == 0 ? (hv == 0 ? 0 : hv == 1 ? 1 : 2)
              : dd == 1 ? (hv == 0 ? 3 : hv == 1 ? 4 : 5)
              : dd == 2 ? (hv == 0 ? 6 : 7) : 8;
        } else {
          if (o == 1) std::swap(hh, vv);   // HL: vertical neighbours first
          n = hh == 0 ? (vv == 0 ? (dd == 0 ? 0 : dd == 1 ? 1 : 2)
                         : vv == 1 ? 3 : 4)
              : hh == 1 ? (vv == 0 ? (dd == 0 ? 5 : 6) : 7) : 8;
        }
        ctx[o][i] = uint8_t(n);
      }
  }
};
const ZcTable kZc;

struct T1 {
  // per coefficient: its state, and how many of its horizontal, vertical
  // and diagonal neighbours are significant
  enum : uint16_t { SIG = 1, NEG = 2, VISIT = 4, REFINED = 8, H1 = 1 << 4,
                    V1 = 1 << 6, D1 = 1 << 8, NBRS = 0x7F << 4 };
  int w = 0, h = 0, orient = 0;
  bool vsc = false, raw = false;  // vertically causal; a bypass segment
  int64_t stride = 0;
  std::vector<int32_t> data;    // w x h
  std::vector<uint16_t> flags;  // (w + 2) x (h + 2), a border of zeros
  MQ mq;

  uint16_t* F(int i, int j) { return &flags[size_t(j + 1) * stride + i + 1]; }
  int32_t& D(int i, int j) { return data[size_t(j) * w + i]; }

  int contrib(const uint16_t* f) {
    return (*f & SIG) ? ((*f & NEG) ? -1 : 1) : 0;
  }
  // decode the sign of a newly significant coefficient and record it;
  // under the vertically causal style a stripe's last row sees nothing of
  // the stripe below
  void make_significant(int i, int j, int32_t oneplushalf) {
    uint16_t* f = F(i, j);
    int neg;
    if (raw) {
      neg = mq.raw_decode();
    } else {
      const int south = vsc && (j & 3) == 3 ? 0 : contrib(f + stride);
      const int hc = std::clamp(contrib(f - 1) + contrib(f + 1), -1, 1);
      const int vc = std::clamp(contrib(f - stride) + south, -1, 1);
      // Table D.3, rows hc = -1, 0, 1, columns vc = -1, 0, 1
      static const uint8_t ctx[3][3] = {{13, 12, 11}, {10, 9, 10},
                                        {11, 12, 13}};
      neg = mq.decode(ctx[hc + 1][vc + 1]) ^ xr_of(hc, vc);
    }
    D(i, j) = neg ? -oneplushalf : oneplushalf;
    *f |= uint16_t(SIG | (neg ? NEG : 0));
    f[-1] += H1;
    f[1] += H1;
    f[stride] += V1;
    f[stride - 1] += D1;
    f[stride + 1] += D1;
    if (!vsc || (j & 3) != 0) {
      f[-stride] += V1;
      f[-stride - 1] += D1;
      f[-stride + 1] += D1;
    }
  }
  static int xr_of(int hc, int vc) {
    // Table D.3: the sign is flipped where the prediction is negative
    if (hc == 1) return 0;
    if (hc == 0) return vc == -1 ? 1 : 0;
    return 1;
  }
  int zc_ctx(uint16_t f) const { return kZc.ctx[orient][(f & NBRS) >> 4]; }

  void sigpass(int bp) {
    const int32_t one = int32_t(1) << bp, oneplushalf = one | (one >> 1);
    for (int k = 0; k < h; k += 4)
      for (int i = 0; i < w; ++i)
        for (int j = k; j < k + 4 && j < h; ++j) {
          uint16_t* f = F(i, j);
          if ((*f & (SIG | VISIT)) || !(*f & NBRS)) continue;
          if (raw ? mq.raw_decode() : mq.decode(kCtxZc + zc_ctx(*f)))
            make_significant(i, j, oneplushalf);
          *f |= VISIT;
        }
  }
  void refpass(int bp) {
    const int32_t poshalf = (int32_t(1) << bp) >> 1;
    for (int k = 0; k < h; k += 4)
      for (int i = 0; i < w; ++i)
        for (int j = k; j < k + 4 && j < h; ++j) {
          uint16_t* f = F(i, j);
          if ((*f & (SIG | VISIT)) != SIG) continue;
          const int cx = (*f & REFINED) ? kCtxMag + 2
                         : (*f & NBRS) ? kCtxMag + 1 : kCtxMag;
          const int v = raw ? mq.raw_decode() : mq.decode(cx);
          int32_t& x = D(i, j);
          x += (v ^ (x < 0)) ? poshalf : -poshalf;
          *f |= REFINED;
        }
  }
  void clean_step(int i, int j, int32_t oneplushalf) {
    const uint16_t f = *F(i, j);
    if (f & (SIG | VISIT)) return;
    if (mq.decode(kCtxZc + zc_ctx(f))) make_significant(i, j, oneplushalf);
  }
  void clnpass(int bp) {
    const int32_t one = int32_t(1) << bp, oneplushalf = one | (one >> 1);
    int k = 0;
    for (; k + 4 <= h; k += 4) {
      for (int i = 0; i < w; ++i) {
        // run mode: the column's four coefficients and all their
        // neighbours insignificant, none visited
        bool run = true;
        for (int j = k; j < k + 4; ++j)
          if (*F(i, j) & (SIG | VISIT | REFINED | NBRS)) run = false;
        if (run) {
          if (!mq.decode(kCtxAgg)) continue;
          int r = mq.decode(kCtxUni) << 1;
          r |= mq.decode(kCtxUni);
          make_significant(i, k + r, oneplushalf);
          for (int j = k + r + 1; j < k + 4; ++j)
            clean_step(i, j, oneplushalf);
        } else {
          for (int j = k; j < k + 4; ++j) clean_step(i, j, oneplushalf);
        }
        for (int j = k; j < k + 4; ++j) *F(i, j) &= uint16_t(~VISIT);
      }
    }
    if (k < h)
      for (int i = 0; i < w; ++i)
        for (int j = k; j < h; ++j) {
          clean_step(i, j, oneplushalf);
          *F(i, j) &= uint16_t(~VISIT);
        }
  }
  void reset_contexts() { mq.reset_states(); }

  // decode a code-block's passes, as OpenJPEG's opj_t1_decode_cblk does,
  // then undo the region of interest's shift
  void decode(const CodeBlock& cb, int bandno, int cblksty, int roishift) {
    w = int(cb.x1 - cb.x0);
    h = int(cb.y1 - cb.y0);
    stride = w + 2;
    orient = bandno;
    vsc = cblksty & kVsc;
    data.assign(size_t(w) * h, 0);
    flags.assign(size_t(w + 2) * (h + 2), 0);
    mq.reset_states();
    int32_t bpno_plus_one = int32_t(uint32_t(roishift) + uint32_t(cb.numbps));
    if (bpno_plus_one >= 31)
      fail(kCorrupt, "a code-block of %d bit planes (OpenJPEG reads up to "
           "30)", bpno_plus_one);
    int passtype = 2;
    int64_t offset = 0;
    for (int s = 0; s < cb.numsegs; ++s) {
      const Segment& seg = cb.segs[size_t(s)];
      if (offset + seg.len > int64_t(cb.data.size()))
        fail(kCorrupt, "a code-block segment past its data");
      // the bypass: raw significance and refinement passes past the
      // first four bit planes
      raw = (cblksty & kLazy) && passtype < 2
            && bpno_plus_one <= cb.numbps - 4;
      if (raw) mq.raw_init(cb.data.data() + offset, seg.len);
      else mq.init(cb.data.data() + offset, seg.len);
      offset += seg.len;
      for (int pass = 0; pass < seg.numpasses && bpno_plus_one >= 1;
           ++pass) {
        if (passtype == 0) sigpass(bpno_plus_one);
        else if (passtype == 1) refpass(bpno_plus_one);
        else clnpass(bpno_plus_one);
        if (passtype == 2 && (cblksty & kSegSym))
          for (int k = 0; k < 4; ++k) mq.decode(kCtxUni);
        if ((cblksty & kReset) && !raw) reset_contexts();
        if (++passtype == 3) {
          passtype = 0;
          --bpno_plus_one;
        }
      }
    }
    raw = false;
    if (roishift >= 31) {
      std::fill(data.begin(), data.end(), 0);
    } else if (roishift > 0) {
      const int32_t thresh = int32_t(1) << roishift;
      for (int32_t& v : data) {
        int32_t mag = v < 0 ? -v : v;
        if (mag >= thresh) {
          mag >>= roishift;
          v = v < 0 ? -mag : mag;
        }
      }
    }
  }
};

// ------------------------------------------------------------ inverse DWT
inline int64_t mirror(int64_t i, int64_t n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return i;
}

// The lifting steps of m lines at once: t holds sample p of line k at
// t[p * m + k], in coordinate order (the low samples at the positions of
// parity cas), n samples a line, n >= 2, mirrored at both ends. Every
// sample sees the operations of OpenJPEG's one-line code, in its order.
void lift53(int64_t* t, int64_t n, int64_t m, int cas) {
  for (int64_t p = cas; p < n; p += 2) {
    int64_t* __restrict x = t + p * m;
    const int64_t* __restrict l = t + mirror(p - 1, n) * m;
    const int64_t* __restrict r = t + mirror(p + 1, n) * m;
    for (int64_t k = 0; k < m; ++k) x[k] -= (l[k] + r[k] + 2) >> 2;
  }
  for (int64_t p = 1 - cas; p < n; p += 2) {
    int64_t* __restrict x = t + p * m;
    const int64_t* __restrict l = t + mirror(p - 1, n) * m;
    const int64_t* __restrict r = t + mirror(p + 1, n) * m;
    for (int64_t k = 0; k < m; ++k) x[k] += (l[k] + r[k]) >> 1;
  }
}

constexpr float kAlpha = -1.586134342f, kBeta = -0.052980118f,
                kGamma = 0.882911075f, kDelta = 0.443506852f,
                kK = 1.230174105f, kTwoInvK = 1.625732422f;

void lift97(float* t, int64_t n, int64_t m, int cas) {
  for (int64_t p = 0; p < n; ++p) {
    const float scale = (p & 1) == cas ? kK : kTwoInvK;
    for (int64_t k = 0; k < m; ++k) t[p * m + k] = t[p * m + k] * scale;
  }
  const float steps[4] = {-kDelta, -kGamma, -kBeta, -kAlpha};
  for (int s = 0; s < 4; ++s) {
    const float c = steps[s];
    for (int64_t p = (s & 1) ? 1 - cas : cas; p < n; p += 2) {
      float* __restrict x = t + p * m;
      const float* __restrict l = t + mirror(p - 1, n) * m;
      const float* __restrict r = t + mirror(p + 1, n) * m;
      for (int64_t k = 0; k < m; ++k) x[k] = x[k] + (l[k] + r[k]) * c;
    }
  }
}

constexpr int64_t kLanes = 32;   // lines lifted together

// The inverse DWT of a tile-component in place (OpenJPEG's
// opj_dwt_decode_tile and opj_dwt_decode_tile_97): per resolution, its rows
// then its columns, each held as sn low samples then dn high ones. A line
// of one sample is left as it is, but for 5/3 at an odd coordinate, where
// it is halved.
template <typename T, typename V, typename Lift>
void idwt(TileComp& tc, T* a, Lift lift) {
  const int64_t W = tc.width();
  std::vector<V> t;
  auto lines = [&](T* x, int64_t along, int64_t across, int64_t m,
                   int64_t sn, int64_t n, int cas) {
    // m lines of n samples from x: sample i of line k at x[i*along+k*across]
    if (n == 1) {
      if (std::is_integral<T>::value && cas)
        for (int64_t k = 0; k < m; ++k) x[k * across] /= 2;
      return;
    }
    if (n == 0) return;
    t.resize(size_t(n * m));
    for (int64_t i = 0; i < n; ++i) {
      const int64_t p = i < sn ? cas + 2 * i : 1 - cas + 2 * (i - sn);
      for (int64_t k = 0; k < m; ++k)
        t[size_t(p * m + k)] = V(x[i * along + k * across]);
    }
    lift(t.data(), n, m, cas);
    for (int64_t p = 0; p < n; ++p)
      for (int64_t k = 0; k < m; ++k)
        x[p * along + k * across] = std::is_integral<T>::value
            ? T(uint32_t(uint64_t(t[size_t(p * m + k)])))
            : T(t[size_t(p * m + k)]);
  };
  for (int r = 1; r < tc.numres; ++r) {
    const Resolution& prev = tc.res[size_t(r - 1)];
    const Resolution& cur = tc.res[size_t(r)];
    const int64_t rw = cur.x1 - cur.x0, rh = cur.y1 - cur.y0;
    const int64_t hsn = prev.x1 - prev.x0, vsn = prev.y1 - prev.y0;
    for (int64_t j = 0; j < rh; j += kLanes)
      lines(a + j * W, 1, W, std::min(kLanes, rh - j), hsn, rw,
            int(cur.x0 & 1));
    for (int64_t i = 0; i < rw; i += kLanes)
      lines(a + i, W, 1, std::min(kLanes, rw - i), vsn, rh, int(cur.y0 & 1));
  }
}

// --------------------------------------------------------------- the tiles
struct Decoder {
  Codestream cs;
  // OpenJPEG's per-tile output: each component's samples after the DC shift
  std::vector<std::vector<int32_t>> out;
  std::vector<int64_t> ow, oh;
  int64_t tx0, ty0, tx1, ty1;

  void build(const Params& p, int64_t tileno, std::vector<TileComp>& tcs) {
    const Siz& s = cs.siz;
    const int64_t tp = tileno % s.ntx, tq = tileno / s.ntx;
    tx0 = std::max(s.TX0 + tp * s.TW, s.X0);
    ty0 = std::max(s.TY0 + tq * s.TH, s.Y0);
    tx1 = std::min(s.TX0 + (tp + 1) * s.TW, s.X1);
    ty1 = std::min(s.TY0 + (tq + 1) * s.TH, s.Y1);
    int64_t total_cblks = 0;
    tcs.assign(size_t(s.C), TileComp());
    for (int c = 0; c < s.C; ++c) {
      const CompParams& cp = p.comps[size_t(c)];
      TileComp& tc = tcs[size_t(c)];
      tc.x0 = ceildiv(tx0, s.dx[c]);
      tc.y0 = ceildiv(ty0, s.dy[c]);
      tc.x1 = ceildiv(tx1, s.dx[c]);
      tc.y1 = ceildiv(ty1, s.dy[c]);
      tc.numres = cp.numres;
      tc.res.assign(size_t(cp.numres), Resolution());
      for (int r = 0; r < cp.numres; ++r) {
        Resolution& res = tc.res[size_t(r)];
        const int level = cp.numres - 1 - r;
        res.x0 = ceildivpow2(tc.x0, level);
        res.y0 = ceildivpow2(tc.y0, level);
        res.x1 = ceildivpow2(tc.x1, level);
        res.y1 = ceildivpow2(tc.y1, level);
        res.pdx = cp.prcw[r];
        res.pdy = cp.prch[r];
        const int64_t px0 = floordivpow2(res.x0, res.pdx) << res.pdx;
        const int64_t py0 = floordivpow2(res.y0, res.pdy) << res.pdy;
        const int64_t px1 = ceildivpow2(res.x1, res.pdx) << res.pdx;
        const int64_t py1 = ceildivpow2(res.y1, res.pdy) << res.pdy;
        res.pw = res.x0 == res.x1 ? 0 : (px1 - px0) >> res.pdx;
        res.ph = res.y0 == res.y1 ? 0 : (py1 - py0) >> res.pdy;
        if (res.pw * res.ph > kMaxCodeBlocks)
          fail(kUnsupported, "%lld precincts in a resolution",
               static_cast<long long>(res.pw * res.ph));
        int64_t cbgx0, cbgy0;
        int cbgw, cbgh;
        if (r == 0) {
          cbgx0 = px0;
          cbgy0 = py0;
          cbgw = res.pdx;
          cbgh = res.pdy;
          res.numbands = 1;
        } else {
          cbgx0 = ceildivpow2(px0, 1);
          cbgy0 = ceildivpow2(py0, 1);
          cbgw = res.pdx - 1;
          cbgh = res.pdy - 1;
          res.numbands = 3;
        }
        const int cbw = std::min(cp.cblkw, cbgw), cbh = std::min(cp.cblkh,
                                                                 cbgh);
        for (int b = 0; b < res.numbands; ++b) {
          Band& band = res.bands[b];
          if (r == 0) {
            band.bandno = 0;
            band.x0 = ceildivpow2(tc.x0, level);
            band.y0 = ceildivpow2(tc.y0, level);
            band.x1 = ceildivpow2(tc.x1, level);
            band.y1 = ceildivpow2(tc.y1, level);
          } else {
            band.bandno = b + 1;
            const int64_t xob = band.bandno & 1, yob = band.bandno >> 1;
            band.x0 = ceildivpow2(tc.x0 - (xob << level), level + 1);
            band.y0 = ceildivpow2(tc.y0 - (yob << level), level + 1);
            band.x1 = ceildivpow2(tc.x1 - (xob << level), level + 1);
            band.y1 = ceildivpow2(tc.y1 - (yob << level), level + 1);
          }
          const int bi = r == 0 ? 0 : 3 * (r - 1) + b + 1;
          const int gain = cp.qmfbid == 0 ? 0 : band.bandno == 0 ? 0
                           : band.bandno == 3 ? 2 : 1;
          band.stepsize = float((1.0 + cp.mant[bi] / 2048.0)
                                * std::pow(2.0, double(s.prec[c] + gain
                                                       - cp.expn[bi])));
          band.numbps = cp.expn[bi] + cp.numgbits - 1;
          band.prcs.assign(size_t(res.pw * res.ph), Precinct());
          for (int64_t pn = 0; pn < res.pw * res.ph; ++pn) {
            Precinct& prc = band.prcs[size_t(pn)];
            const int64_t gx0 = cbgx0 + (pn % res.pw) * (int64_t(1) << cbgw);
            const int64_t gy0 = cbgy0 + (pn / res.pw) * (int64_t(1) << cbgh);
            prc.x0 = std::max(gx0, band.x0);
            prc.y0 = std::max(gy0, band.y0);
            prc.x1 = std::min(gx0 + (int64_t(1) << cbgw), band.x1);
            prc.y1 = std::min(gy0 + (int64_t(1) << cbgh), band.y1);
            const int64_t bx0 = floordivpow2(prc.x0, cbw) << cbw;
            const int64_t by0 = floordivpow2(prc.y0, cbh) << cbh;
            const int64_t bx1 = ceildivpow2(prc.x1, cbw) << cbw;
            const int64_t by1 = ceildivpow2(prc.y1, cbh) << cbh;
            const int64_t cw = std::max<int64_t>(0, (bx1 - bx0) >> cbw);
            const int64_t ch = std::max<int64_t>(0, (by1 - by0) >> cbh);
            total_cblks += cw * ch;
            if (total_cblks > kMaxCodeBlocks)
              fail(kUnsupported, "more than %lld code-blocks in a tile",
                   static_cast<long long>(kMaxCodeBlocks));
            prc.cw = int(cw);
            prc.ch = int(ch);
            prc.cblks.assign(size_t(cw * ch), CodeBlock());
            for (int64_t k = 0; k < cw * ch; ++k) {
              CodeBlock& cb = prc.cblks[size_t(k)];
              const int64_t x = bx0 + (k % cw) * (int64_t(1) << cbw);
              const int64_t y = by0 + (k / cw) * (int64_t(1) << cbh);
              cb.x0 = std::max(x, prc.x0);
              cb.y0 = std::max(y, prc.y0);
              cb.x1 = std::min(x + (int64_t(1) << cbw), prc.x1);
              cb.y1 = std::min(y + (int64_t(1) << cbh), prc.y1);
            }
            if (cw * ch > 0) {
              prc.incl.create(int(cw), int(ch));
              prc.imsb.create(int(cw), int(ch));
            }
          }
        }
      }
    }
  }

  // one packet's header and data, from bytes[pos]; returns the new pos
  int64_t packet(const Params& p, std::vector<TileComp>& tcs,
                 const std::vector<uint8_t>& bytes, int64_t pos, int layno,
                 int resno, int compno, int64_t precno) {
    const int64_t end = int64_t(bytes.size());
    const uint8_t* d = bytes.data();
    Resolution& res = tcs[size_t(compno)].res[size_t(resno)];
    if ((p.csty & 2) && end - pos >= 6 && d[pos] == 0xFF && d[pos + 1] == 0x91)
      pos += 6;   // SOP
    Bio bio(d, pos, end);
    auto eph = [&](int64_t at) {
      if ((p.csty & 4) && end - at >= 2 && d[at] == 0xFF && d[at + 1] == 0x92)
        at += 2;
      return at;
    };
    if (!bio.bit()) {   // an empty packet
      bio.inalign();
      return eph(pos + bio.numbytes());
    }
    for (int b = 0; b < res.numbands; ++b) {
      Band& band = res.bands[b];
      if (band.empty()) continue;
      Precinct& prc = band.prcs[size_t(precno)];
      for (int64_t k = 0; k < int64_t(prc.cblks.size()); ++k) {
        CodeBlock& cb = prc.cblks[size_t(k)];
        int included;
        if (!cb.numsegs) included = prc.incl.decode(bio, k, layno + 1);
        else included = int(bio.bit());
        if (!included) {
          cb.numnewpasses = 0;
          continue;
        }
        if (!cb.numsegs) {
          int32_t i = 0;
          while (!prc.imsb.decode(bio, k, i)) ++i;
          cb.numbps = int32_t(uint32_t(band.numbps) + 1u - uint32_t(i));
          cb.numlenbits = 3;
        }
        // the number of passes (Table B.4)
        int n;
        if (!bio.bit()) n = 1;
        else if (!bio.bit()) n = 2;
        else if ((n = int(bio.read(2))) != 3) n += 3;
        else if ((n = int(bio.read(5))) != 31) n += 6;
        else n = 37 + int(bio.read(7));
        cb.numnewpasses = n;
        while (bio.bit()) ++cb.numlenbits;
        if (cb.numlenbits > 64) fail(kCorrupt, "a code-block's Lblock "
                                               "past 64");
        const int sty = p.comps[size_t(compno)].cblksty;
        int segno;
        if (!cb.numsegs) {
          segno = 0;
          cb.segs.clear();
          add_segment(cb.segs, 0, sty);
        } else {
          segno = cb.numsegs - 1;
          if (cb.segs[size_t(segno)].numpasses
              == cb.segs[size_t(segno)].maxpasses)
            add_segment(cb.segs, size_t(++segno), sty);
        }
        int left = n;
        do {
          Segment& sg = cb.segs[size_t(segno)];
          sg.newpasses = std::min(sg.maxpasses - sg.numpasses, left);
          const int bits = cb.numlenbits + floorlog2(uint32_t(sg.newpasses));
          if (bits > 32)
            fail(kCorrupt, "a code-block length of %d bits", bits);
          sg.newlen = bio.read(bits);
          left -= sg.newpasses;
          if (left > 0) add_segment(cb.segs, size_t(++segno), sty);
        } while (left > 0);
      }
    }
    bio.inalign();
    pos = eph(pos + bio.numbytes());
    // the packet's data
    for (int b = 0; b < res.numbands; ++b) {
      Band& band = res.bands[b];
      if (band.empty()) continue;
      Precinct& prc = band.prcs[size_t(precno)];
      for (CodeBlock& cb : prc.cblks) {
        if (!cb.numnewpasses) continue;
        int segno;
        if (!cb.numsegs) {
          segno = 0;
          cb.numsegs = 1;
        } else {
          segno = cb.numsegs - 1;
          if (cb.segs[size_t(segno)].numpasses
              == cb.segs[size_t(segno)].maxpasses) {
            ++segno;
            ++cb.numsegs;
          }
        }
        do {
          Segment& sg = cb.segs[size_t(segno)];
          if (int64_t(sg.newlen) > end - pos)
            fail(kCorrupt, "a code-block's data (%u bytes) runs past its "
                 "tile (%lld left)", sg.newlen,
                 static_cast<long long>(end - pos));
          if (int64_t(sg.len) + sg.newlen > (int64_t(1) << 30))
            fail(kCorrupt, "a code-block past 1 GiB");
          cb.data.insert(cb.data.end(), d + pos, d + pos + sg.newlen);
          pos += sg.newlen;
          sg.len += int(sg.newlen);
          sg.numpasses += sg.newpasses;
          cb.numnewpasses -= sg.newpasses;
          if (cb.numnewpasses > 0) {
            ++segno;
            ++cb.numsegs;
          }
        } while (cb.numnewpasses > 0);
      }
    }
    return pos;
  }

  // the packets of a tile in the order of its progressions (B.12)
  void tier2(const Params& p, std::vector<TileComp>& tcs,
             const std::vector<uint8_t>& bytes) {
    const Siz& s = cs.siz;
    int maxres = 0;
    int64_t maxprec = 0;
    for (auto& tc : tcs) {
      maxres = std::max(maxres, tc.numres);
      for (auto& r : tc.res) maxprec = std::max(maxprec, r.pw * r.ph);
    }
    const int64_t step_c = maxprec, step_r = s.C * step_c,
                  step_l = maxres * step_r;
    const int64_t ninclude = p.numlayers * step_l;
    if (ninclude > (int64_t(1) << 26))
      fail(kUnsupported, "%lld packets in a tile",
           static_cast<long long>(ninclude));
    std::vector<uint8_t> include(size_t(ninclude), 0);
    int64_t pos = 0;
    auto visit = [&](int l, int r, int c, int64_t k) {
      int64_t idx = l * step_l + r * step_r + c * step_c + k;
      if (idx < 0 || idx >= ninclude || include[size_t(idx)]) return;
      include[size_t(idx)] = 1;
      pos = packet(p, tcs, bytes, pos, l, r, c, k);
    };
    std::vector<Poc> pocs = p.pocs;
    if (pocs.empty())
      pocs.push_back(Poc{0, 0, p.numlayers, maxres, s.C, p.prg});
    for (const Poc& q : pocs) {
      const int l1 = std::min(q.layno1, p.numlayers);
      const int c1 = std::min(q.compno1, s.C);
      const int r1 = q.resno1;
      auto lrc = [&](int l, int r, int c) {
        const TileComp& tc = tcs[size_t(c)];
        if (r >= tc.numres) return;
        const Resolution& res = tc.res[size_t(r)];
        for (int64_t k = 0; k < res.pw * res.ph; ++k) visit(l, r, c, k);
      };
      if (q.prg == 0) {          // LRCP
        for (int l = 0; l < l1; ++l)
          for (int r = q.resno0; r < r1; ++r)
            for (int c = q.compno0; c < c1; ++c) lrc(l, r, c);
      } else if (q.prg == 1) {   // RLCP
        for (int r = q.resno0; r < r1; ++r)
          for (int l = 0; l < l1; ++l)
            for (int c = q.compno0; c < c1; ++c) lrc(l, r, c);
      } else {
        position_orders(q, l1, r1, c1, tcs, visit);
      }
    }
  }

  // RPCL, PCRL and CPRL: the precincts by their position on the grid
  template <typename Visit>
  void position_orders(const Poc& q, int l1, int r1, int c1,
                       std::vector<TileComp>& tcs, Visit& visit) {
    const Siz& s = cs.siz;
    auto steps = [&](int c0, int c1_, uint64_t& dx, uint64_t& dy) {
      dx = dy = 0;
      for (int c = c0; c < c1_; ++c) {
        const TileComp& tc = tcs[size_t(c)];
        for (int r = 0; r < tc.numres; ++r) {
          const Resolution& res = tc.res[size_t(r)];
          const int ex = res.pdx + tc.numres - 1 - r;
          const int ey = res.pdy + tc.numres - 1 - r;
          if (ex < 32) {
            uint64_t v = uint64_t(s.dx[c]) << ex;
            if (v <= 0xFFFFFFFFull) dx = dx ? std::min(dx, v) : v;
          }
          if (ey < 32) {
            uint64_t v = uint64_t(s.dy[c]) << ey;
            if (v <= 0xFFFFFFFFull) dy = dy ? std::min(dy, v) : v;
          }
        }
      }
    };
    // the precinct of (x, y) at (c, r), or -1 where none starts there
    auto precinct_at = [&](uint64_t x, uint64_t y, int c, int r) -> int64_t {
      const TileComp& tc = tcs[size_t(c)];
      if (r >= tc.numres) return -1;
      const Resolution& res = tc.res[size_t(r)];
      const int levelno = tc.numres - 1 - r;
      const uint64_t cdx = uint64_t(s.dx[c]) << levelno;
      const uint64_t cdy = uint64_t(s.dy[c]) << levelno;
      if (levelno >= 32 || cdx > 0x7FFFFFFF || cdy > 0x7FFFFFFF) return -1;
      const uint64_t trx0 = ceildiv(tx0, int64_t(cdx));
      const uint64_t try0 = ceildiv(ty0, int64_t(cdy));
      const uint64_t trx1 = ceildiv(tx1, int64_t(cdx));
      const uint64_t try1 = ceildiv(ty1, int64_t(cdy));
      const int rpx = res.pdx + levelno, rpy = res.pdy + levelno;
      if (rpx >= 31 || rpy >= 31) return -1;
      if (!((y % (uint64_t(s.dy[c]) << rpy) == 0)
            || (y == uint64_t(ty0) && ((try0 << levelno) % (1ull << rpy)))))
        return -1;
      if (!((x % (uint64_t(s.dx[c]) << rpx) == 0)
            || (x == uint64_t(tx0) && ((trx0 << levelno) % (1ull << rpx)))))
        return -1;
      if (res.pw == 0 || res.ph == 0) return -1;
      if (trx0 == trx1 || try0 == try1) return -1;
      const uint64_t prci = (ceildiv(int64_t(x), int64_t(cdx)) >> res.pdx)
                            - (trx0 >> res.pdx);
      const uint64_t prcj = (ceildiv(int64_t(y), int64_t(cdy)) >> res.pdy)
                            - (try0 >> res.pdy);
      return int64_t(prci + prcj * uint64_t(res.pw));
    };
    auto layers = [&](int r, int c, int64_t k) {
      if (k < 0) return;
      for (int l = 0; l < l1; ++l) visit(l, r, c, k);
    };
    const uint64_t X0 = uint64_t(tx0), X1 = uint64_t(tx1),
                   Y0 = uint64_t(ty0), Y1 = uint64_t(ty1);
    uint64_t dx, dy;
    if (q.prg == 2 || q.prg == 3) {
      steps(0, s.C, dx, dy);
      if (dx == 0 || dy == 0) return;
      if (q.prg == 2) {          // RPCL
        for (int r = q.resno0; r < r1; ++r)
          for (uint64_t y = Y0; y < Y1; y += dy - (y % dy))
            for (uint64_t x = X0; x < X1; x += dx - (x % dx))
              for (int c = q.compno0; c < c1; ++c)
                layers(r, c, precinct_at(x, y, c, r));
      } else {                   // PCRL
        for (uint64_t y = Y0; y < Y1; y += dy - (y % dy))
          for (uint64_t x = X0; x < X1; x += dx - (x % dx))
            for (int c = q.compno0; c < c1; ++c)
              for (int r = q.resno0;
                   r < std::min(r1, tcs[size_t(c)].numres); ++r)
                layers(r, c, precinct_at(x, y, c, r));
      }
    } else {                     // CPRL
      for (int c = q.compno0; c < c1; ++c) {
        steps(c, c + 1, dx, dy);
        if (dx == 0 || dy == 0) return;
        for (uint64_t y = Y0; y < Y1; y += dy - (y % dy))
          for (uint64_t x = X0; x < X1; x += dx - (x % dx))
            for (int r = q.resno0; r < std::min(r1, tcs[size_t(c)].numres);
                 ++r)
              layers(r, c, precinct_at(x, y, c, r));
      }
    }
  }

  void decode_tile(int64_t tileno) {
    TileData& td = cs.tiles[size_t(tileno)];
    const Params& p = td.params;
    const Siz& s = cs.siz;
    std::vector<TileComp> tcs;
    build(p, tileno, tcs);
    tier2(p, tcs, td.bytes);
    // tier 1 and dequantisation, into each tile-component's array
    T1 t1;
    for (int c = 0; c < s.C; ++c) {
      TileComp& tc = tcs[size_t(c)];
      const CompParams& cp = p.comps[size_t(c)];
      const int64_t W = tc.width(), H = tc.height();
      if (W * H > 2 * kMaxPixels)
        fail(kUnsupported, "a tile of %lld samples",
             static_cast<long long>(W * H));
      if (cp.qmfbid == 1) tc.idata.assign(size_t(W * H), 0);
      else tc.fdata.assign(size_t(W * H), 0.0f);
      for (int r = 0; r < tc.numres; ++r) {
        Resolution& res = tc.res[size_t(r)];
        for (int b = 0; b < res.numbands; ++b) {
          Band& band = res.bands[b];
          if (band.empty()) continue;
          int64_t offx = 0, offy = 0;
          if (band.bandno & 1) {
            const Resolution& pr = tc.res[size_t(r - 1)];
            offx = pr.x1 - pr.x0;
          }
          if (band.bandno & 2) {
            const Resolution& pr = tc.res[size_t(r - 1)];
            offy = pr.y1 - pr.y0;
          }
          const float step = 0.5f * band.stepsize;
          for (Precinct& prc : band.prcs)
            for (CodeBlock& cb : prc.cblks) {
              if (!cb.numsegs || cb.x1 <= cb.x0 || cb.y1 <= cb.y0) {
                std::vector<uint8_t>().swap(cb.data);
                continue;
              }
              t1.decode(cb, band.bandno, cp.cblksty, cp.roishift);
              std::vector<uint8_t>().swap(cb.data);
              const int64_t x = cb.x0 - band.x0 + offx,
                            y = cb.y0 - band.y0 + offy;
              for (int j = 0; j < t1.h; ++j) {
                const int32_t* src = &t1.data[size_t(j) * t1.w];
                const int64_t row = (y + j) * W + x;
                if (cp.qmfbid == 1) {
                  for (int i = 0; i < t1.w; ++i)
                    tc.idata[size_t(row + i)] = src[i] / 2;
                } else {
                  for (int i = 0; i < t1.w; ++i)
                    tc.fdata[size_t(row + i)] = float(src[i]) * step;
                }
              }
            }
        }
      }
      if (cp.qmfbid == 1) idwt<int32_t, int64_t>(tc, tc.idata.data(), lift53);
      else idwt<float, float>(tc, tc.fdata.data(), lift97);
    }
    // the multiple component transform of the first three components
    if (p.mct && s.C >= 3) {
      for (int c = 1; c < 3; ++c)
        if (tcs[size_t(c)].numres != tcs[0].numres
            || tcs[size_t(c)].width() != tcs[0].width()
            || tcs[size_t(c)].height() != tcs[0].height())
          fail(kCorrupt, "a component transform over components of "
               "different sizes");
      const int64_t n = tcs[0].width() * tcs[0].height();
      const bool rev = p.comps[0].qmfbid == 1;
      for (int c = 1; c < 3; ++c)
        if ((p.comps[size_t(c)].qmfbid == 1) != rev)
          fail(kUnsupported, "a component transform over components of "
               "both wavelets");
      if (rev) {
        int32_t *c0 = tcs[0].idata.data(), *c1 = tcs[1].idata.data(),
                *c2 = tcs[2].idata.data();
        for (int64_t i = 0; i < n; ++i) {
          const int64_t y = c0[i], u = c1[i], v = c2[i];
          const int64_t g = y - ((u + v) >> 2);
          c0[i] = int32_t(uint32_t(uint64_t(v + g)));
          c1[i] = int32_t(uint32_t(uint64_t(g)));
          c2[i] = int32_t(uint32_t(uint64_t(u + g)));
        }
      } else {
        float *c0 = tcs[0].fdata.data(), *c1 = tcs[1].fdata.data(),
              *c2 = tcs[2].fdata.data();
        for (int64_t i = 0; i < n; ++i) {
          const float y = c0[i], u = c1[i], v = c2[i];
          c0[i] = y + (v * 1.402f);
          c1[i] = y - (u * 0.34413f) - (v * 0.71414f);
          c2[i] = y + (u * 1.772f);
        }
      }
    }
    // DC level shift and clamp to the component's range
    out.assign(size_t(s.C), std::vector<int32_t>());
    ow.assign(size_t(s.C), 0);
    oh.assign(size_t(s.C), 0);
    for (int c = 0; c < s.C; ++c) {
      TileComp& tc = tcs[size_t(c)];
      const int prec = s.prec[c];
      const int64_t lo = s.sgnd[c] ? -(int64_t(1) << (prec - 1)) : 0;
      const int64_t hi = s.sgnd[c] ? (int64_t(1) << (prec - 1)) - 1
                                   : (int64_t(1) << prec) - 1;
      const int64_t shift = s.sgnd[c] ? 0 : int64_t(1) << (prec - 1);
      const int64_t n = tc.width() * tc.height();
      ow[size_t(c)] = tc.width();
      oh[size_t(c)] = tc.height();
      std::vector<int32_t>& o = out[size_t(c)];
      o.resize(size_t(n));
      if (p.comps[size_t(c)].qmfbid == 1) {
        for (int64_t i = 0; i < n; ++i)
          o[size_t(i)] = int32_t(std::clamp(int64_t(tc.idata[size_t(i)])
                                            + shift, lo, hi));
      } else {
        for (int64_t i = 0; i < n; ++i) {
          const float v = tc.fdata[size_t(i)];
          int64_t iv;
          if (v > float(INT32_MAX)) iv = hi;
          else if (v < float(INT32_MIN) || std::isnan(v)) iv = lo;
          else iv = std::clamp(int64_t(std::nearbyint(v)) + shift, lo, hi);
          o[size_t(i)] = int32_t(iv);
        }
      }
      std::vector<int32_t>().swap(tc.idata);
      std::vector<float>().swap(tc.fdata);
    }
  }
};

// ----------------------------------------------------- Pillow's unpackers
// libImaging's ConvertYCbCr.h: the fixed-point YCbCr -> RGB tables (SCALE 6)
constexpr int16_t kRCr[256] = {
    -11484, -11394, -11305, -11215, -11125, -11036, -10946, -10856, -10766,
    -10677, -10587, -10497, -10407, -10318, -10228, -10138, -10049, -9959,
    -9869, -9779, -9690, -9600, -9510, -9420, -9331, -9241, -9151, -9062,
    -8972, -8882, -8792, -8703, -8613, -8523, -8433, -8344, -8254, -8164,
    -8075, -7985, -7895, -7805, -7716, -7626, -7536, -7446, -7357, -7267,
    -7177, -7088, -6998, -6908, -6818, -6729, -6639, -6549, -6459, -6370,
    -6280, -6190, -6101, -6011, -5921, -5831, -5742, -5652, -5562, -5472,
    -5383, -5293, -5203, -5113, -5024, -4934, -4844, -4755, -4665, -4575,
    -4485, -4396, -4306, -4216, -4126, -4037, -3947, -3857, -3768, -3678,
    -3588, -3498, -3409, -3319, -3229, -3139, -3050, -2960, -2870, -2781,
    -2691, -2601, -2511, -2422, -2332, -2242, -2152, -2063, -1973, -1883,
    -1794, -1704, -1614, -1524, -1435, -1345, -1255, -1165, -1076, -986, -896,
    -807, -717, -627, -537, -448, -358, -268, -178, -89, 0, 90, 179, 269, 359,
    449, 538, 628, 718, 808, 897, 987, 1077, 1166, 1256, 1346, 1436, 1525,
    1615, 1705, 1795, 1884, 1974, 2064, 2153, 2243, 2333, 2423, 2512, 2602,
    2692, 2782, 2871, 2961, 3051, 3140, 3230, 3320, 3410, 3499, 3589, 3679,
    3769, 3858, 3948, 4038, 4127, 4217, 4307, 4397, 4486, 4576, 4666, 4756,
    4845, 4935, 5025, 5114, 5204, 5294, 5384, 5473, 5563, 5653, 5743, 5832,
    5922, 6012, 6102, 6191, 6281, 6371, 6460, 6550, 6640, 6730, 6819, 6909,
    6999, 7089, 7178, 7268, 7358, 7447, 7537, 7627, 7717, 7806, 7896, 7986,
    8076, 8165, 8255, 8345, 8434, 8524, 8614, 8704, 8793, 8883, 8973, 9063,
    9152, 9242, 9332, 9421, 9511, 9601, 9691, 9780, 9870, 9960, 10050, 10139,
    10229, 10319, 10408, 10498, 10588, 10678, 10767, 10857, 10947, 11037,
    11126, 11216, 11306, 11395};
constexpr int16_t kGCb[256] = {
    2819, 2797, 2775, 2753, 2731, 2709, 2687, 2665, 2643, 2621, 2599, 2577,
    2555, 2533, 2511, 2489, 2467, 2445, 2423, 2401, 2379, 2357, 2335, 2313,
    2291, 2269, 2247, 2225, 2202, 2180, 2158, 2136, 2114, 2092, 2070, 2048,
    2026, 2004, 1982, 1960, 1938, 1916, 1894, 1872, 1850, 1828, 1806, 1784,
    1762, 1740, 1718, 1696, 1674, 1652, 1630, 1608, 1586, 1564, 1542, 1520,
    1498, 1476, 1454, 1432, 1410, 1388, 1366, 1344, 1321, 1299, 1277, 1255,
    1233, 1211, 1189, 1167, 1145, 1123, 1101, 1079, 1057, 1035, 1013, 991, 969,
    947, 925, 903, 881, 859, 837, 815, 793, 771, 749, 727, 705, 683, 661, 639,
    617, 595, 573, 551, 529, 507, 485, 463, 440, 418, 396, 374, 352, 330, 308,
    286, 264, 242, 220, 198, 176, 154, 132, 110, 88, 66, 44, 22, 0, -21, -43,
    -65, -87, -109, -131, -153, -175, -197, -219, -241, -263, -285, -307, -329,
    -351, -373, -395, -417, -439, -462, -484, -506, -528, -550, -572, -594,
    -616, -638, -660, -682, -704, -726, -748, -770, -792, -814, -836, -858,
    -880, -902, -924, -946, -968, -990, -1012, -1034, -1056, -1078, -1100,
    -1122, -1144, -1166, -1188, -1210, -1232, -1254, -1276, -1298, -1320,
    -1343, -1365, -1387, -1409, -1431, -1453, -1475, -1497, -1519, -1541,
    -1563, -1585, -1607, -1629, -1651, -1673, -1695, -1717, -1739, -1761,
    -1783, -1805, -1827, -1849, -1871, -1893, -1915, -1937, -1959, -1981,
    -2003, -2025, -2047, -2069, -2091, -2113, -2135, -2157, -2179, -2201,
    -2224, -2246, -2268, -2290, -2312, -2334, -2356, -2378, -2400, -2422,
    -2444, -2466, -2488, -2510, -2532, -2554, -2576, -2598, -2620, -2642,
    -2664, -2686, -2708, -2730, -2752, -2774, -2796};
constexpr int16_t kGCr[256] = {
    5850, 5805, 5759, 5713, 5667, 5622, 5576, 5530, 5485, 5439, 5393, 5347,
    5302, 5256, 5210, 5165, 5119, 5073, 5028, 4982, 4936, 4890, 4845, 4799,
    4753, 4708, 4662, 4616, 4570, 4525, 4479, 4433, 4388, 4342, 4296, 4251,
    4205, 4159, 4113, 4068, 4022, 3976, 3931, 3885, 3839, 3794, 3748, 3702,
    3656, 3611, 3565, 3519, 3474, 3428, 3382, 3336, 3291, 3245, 3199, 3154,
    3108, 3062, 3017, 2971, 2925, 2879, 2834, 2788, 2742, 2697, 2651, 2605,
    2559, 2514, 2468, 2422, 2377, 2331, 2285, 2240, 2194, 2148, 2102, 2057,
    2011, 1965, 1920, 1874, 1828, 1782, 1737, 1691, 1645, 1600, 1554, 1508,
    1463, 1417, 1371, 1325, 1280, 1234, 1188, 1143, 1097, 1051, 1006, 960, 914,
    868, 823, 777, 731, 686, 640, 594, 548, 503, 457, 411, 366, 320, 274, 229,
    183, 137, 91, 46, 0, -45, -90, -136, -182, -228, -273, -319, -365, -410,
    -456, -502, -547, -593, -639, -685, -730, -776, -822, -867, -913, -959,
    -1005, -1050, -1096, -1142, -1187, -1233, -1279, -1324, -1370, -1416,
    -1462, -1507, -1553, -1599, -1644, -1690, -1736, -1781, -1827, -1873,
    -1919, -1964, -2010, -2056, -2101, -2147, -2193, -2239, -2284, -2330,
    -2376, -2421, -2467, -2513, -2558, -2604, -2650, -2696, -2741, -2787,
    -2833, -2878, -2924, -2970, -3016, -3061, -3107, -3153, -3198, -3244,
    -3290, -3335, -3381, -3427, -3473, -3518, -3564, -3610, -3655, -3701,
    -3747, -3793, -3838, -3884, -3930, -3975, -4021, -4067, -4112, -4158,
    -4204, -4250, -4295, -4341, -4387, -4432, -4478, -4524, -4569, -4615,
    -4661, -4707, -4752, -4798, -4844, -4889, -4935, -4981, -5027, -5072,
    -5118, -5164, -5209, -5255, -5301, -5346, -5392, -5438, -5484, -5529,
    -5575, -5621, -5666, -5712, -5758, -5804};
constexpr int16_t kBCb[256] = {
    -14515, -14402, -14288, -14175, -14062, -13948, -13835, -13721, -13608,
    -13495, -13381, -13268, -13154, -13041, -12928, -12814, -12701, -12587,
    -12474, -12360, -12247, -12134, -12020, -11907, -11793, -11680, -11567,
    -11453, -11340, -11226, -11113, -11000, -10886, -10773, -10659, -10546,
    -10433, -10319, -10206, -10092, -9979, -9865, -9752, -9639, -9525, -9412,
    -9298, -9185, -9072, -8958, -8845, -8731, -8618, -8505, -8391, -8278,
    -8164, -8051, -7938, -7824, -7711, -7597, -7484, -7371, -7257, -7144,
    -7030, -6917, -6803, -6690, -6577, -6463, -6350, -6236, -6123, -6010,
    -5896, -5783, -5669, -5556, -5443, -5329, -5216, -5102, -4989, -4876,
    -4762, -4649, -4535, -4422, -4309, -4195, -4082, -3968, -3855, -3741,
    -3628, -3515, -3401, -3288, -3174, -3061, -2948, -2834, -2721, -2607,
    -2494, -2381, -2267, -2154, -2040, -1927, -1814, -1700, -1587, -1473,
    -1360, -1246, -1133, -1020, -906, -793, -679, -566, -453, -339, -226, -112,
    0, 113, 227, 340, 454, 567, 680, 794, 907, 1021, 1134, 1247, 1361, 1474,
    1588, 1701, 1815, 1928, 2041, 2155, 2268, 2382, 2495, 2608, 2722, 2835,
    2949, 3062, 3175, 3289, 3402, 3516, 3629, 3742, 3856, 3969, 4083, 4196,
    4310, 4423, 4536, 4650, 4763, 4877, 4990, 5103, 5217, 5330, 5444, 5557,
    5670, 5784, 5897, 6011, 6124, 6237, 6351, 6464, 6578, 6691, 6804, 6918,
    7031, 7145, 7258, 7372, 7485, 7598, 7712, 7825, 7939, 8052, 8165, 8279,
    8392, 8506, 8619, 8732, 8846, 8959, 9073, 9186, 9299, 9413, 9526, 9640,
    9753, 9866, 9980, 10093, 10207, 10320, 10434, 10547, 10660, 10774, 10887,
    11001, 11114, 11227, 11341, 11454, 11568, 11681, 11794, 11908, 12021,
    12135, 12248, 12361, 12475, 12588, 12702, 12815, 12929, 13042, 13155,
    13269, 13382, 13496, 13609, 13722, 13836, 13949, 14063, 14176, 14289,
    14403};

enum Mode { kL = 0, kP, kPA, kI16, kLA, kRGB, kRGBA, kCMYK };
enum Space { kUnspecified = 0, kSRGB, kGray, kSYCC, kEYCC, kCMYKSpace };
enum Unpack { kGrayL, kGrayI, kGrayRGB, kGrayALA, kSRGBRGB, kSYCCRGB,
              kSRGBARGBA, kSYCCARGBA, kNone };

struct UnpackRow {
  int mode, space, comps, subsampling, unpack;
};
constexpr UnpackRow kUnpackers[] = {
    {kL, kGray, 1, 0, kGrayL},        {kP, kSRGB, 1, 0, kGrayL},
    {kPA, kSRGB, 2, 0, kGrayALA},     {kI16, kGray, 1, 0, kGrayI},
    {kLA, kGray, 2, 0, kGrayALA},     {kRGB, kGray, 1, 0, kGrayRGB},
    {kRGB, kGray, 2, 0, kGrayRGB},    {kRGB, kSRGB, 3, 1, kSRGBRGB},
    {kRGB, kSYCC, 3, 1, kSYCCRGB},    {kRGB, kSRGB, 4, 1, kSRGBRGB},
    {kRGB, kSYCC, 4, 1, kSYCCRGB},    {kRGBA, kGray, 1, 0, kGrayRGB},
    {kRGBA, kGray, 2, 0, kGrayALA},   {kRGBA, kSRGB, 3, 1, kSRGBRGB},
    {kRGBA, kSYCC, 3, 1, kSYCCRGB},   {kRGBA, kSRGB, 4, 1, kSRGBARGBA},
    {kRGBA, kSYCC, 4, 1, kSYCCARGBA}, {kCMYK, kCMYKSpace, 4, 1, kSRGBARGBA}};

int mode_bands(int mode) {
  static const int bands[] = {1, 1, 2, 1, 2, 3, 4, 4};
  return bands[mode];
}
int mode_bytes(int mode) { return mode == kI16 ? 2 : 1; }


// one component's packing (Jpeg2KDecode.c): the sample's bytes in OpenJPEG's
// buffer, the offset that undoes the sign and rounds, and the shift to the
// mode's depth
struct Packing {
  int shift, csiz;
  uint32_t offset;
  Packing(int prec, int sgnd, int depth) {
    shift = depth - prec;
    int off = sgnd ? 1 << (prec - 1) : 0;
    csiz = (prec + 7) >> 3;
    if (csiz == 3) csiz = 4;
    if (shift < 0) off += 1 << (-shift - 1);
    offset = uint32_t(off);
  }
  uint32_t apply(uint32_t word) const {
    const uint32_t x = offset + word;
    return shift < 0 ? x >> -shift : x << shift;
  }
};

uint32_t read_word(const std::vector<uint8_t>& buf, int64_t off, int csiz) {
  if (off < 0 || off + csiz > int64_t(buf.size())) return 0;
  uint32_t v = 0;
  for (int k = 0; k < csiz; ++k)
    v |= uint32_t(buf[size_t(off + k)]) << (8 * k);
  return v;
}

void ycbcr_to_rgb(uint8_t* px) {
  const int y = px[0], cb = px[1], cr = px[2];
  const int r = y + (kRCr[cr] >> 6);
  const int g = y + ((kGCb[cb] + kGCr[cr]) >> 6);
  const int b = y + (kBCb[cb] >> 6);
  px[0] = uint8_t(r <= 0 ? 0 : r >= 255 ? 255 : r);
  px[1] = uint8_t(g <= 0 ? 0 : g >= 255 ? 255 : g);
  px[2] = uint8_t(b <= 0 ? 0 : b >= 255 ? 255 : b);
}

struct Image {
  Decoder dec;
  int unpack = kNone;
  int mode = kL;

  void choose(int mode_, int space) {
    const Siz& s = dec.cs.siz;
    mode = mode_;
    // OpenJPEG takes a codestream whose first component is whole and whose
    // second or third is sub-sampled for sYCC; Pillow reads any other
    // unspecified one as grey (1-2 components) or sRGB
    const bool sub12 = (s.C > 1 && (s.dx[1] != 1 || s.dy[1] != 1))
                       || (s.C > 2 && (s.dx[2] != 1 || s.dy[2] != 1));
    if (space == kUnspecified && s.dx[0] == 1 && s.dy[0] == 1 && sub12)
      space = kSYCC;
    if (space == kUnspecified)
      space = s.C <= 2 ? kGray : kSRGB;
    for (const UnpackRow& u : kUnpackers)
      if (u.mode == mode && u.space == space && u.comps == s.C
          && (u.subsampling || (s.dx[0] == 1 && s.dy[0] == 1))) {
        unpack = u.unpack;
        return;
      }
    static const char* modes[] = {"L", "P", "PA", "I;16", "LA", "RGB",
                                  "RGBA", "CMYK"};
    static const char* spaces[] = {"unspecified", "sRGB", "grey", "sYCC",
                                   "e-sYCC", "CMYK"};
    fail(kCorrupt, "Pillow reads no %d-component %s image as mode %s", s.C,
         spaces[space], modes[mode]);
  }

  // Pillow's unpacking of the decoded tile into out (H x W x bands)
  void place(uint8_t* out, int64_t W, int64_t H) {
    const Siz& s = dec.cs.siz;
    const int64_t x0 = dec.tx0 - s.X0, y0 = dec.ty0 - s.Y0;
    const int64_t w = dec.tx1 - dec.tx0, h = dec.ty1 - dec.ty0;
    if (x0 < 0 || y0 < 0 || w <= 0 || h <= 0 || x0 + w > W || y0 + h > H)
      fail(kCorrupt, "a tile outside Pillow's %lld x %lld image",
           static_cast<long long>(W), static_cast<long long>(H));
    const int bands = mode_bands(mode), depth = mode == kI16 ? 16 : 8;
    const int ncomp = unpack == kGrayL || unpack == kGrayI
                      || unpack == kGrayRGB ? 1
                      : unpack == kGrayALA ? 2
                      : unpack == kSRGBRGB || unpack == kSYCCRGB ? 3 : 4;
    const bool sub = unpack >= kSRGBRGB;
    std::vector<Packing> pk;
    std::vector<int64_t> base(static_cast<size_t>(ncomp), 0);
    std::vector<int64_t> cdx(size_t(ncomp), 1), cdy(size_t(ncomp), 1);
    int64_t cptr = 0;
    for (int n = 0; n < ncomp; ++n) {
      pk.emplace_back(s.prec[n], s.sgnd[n], depth);
      base[size_t(n)] = cptr;
      if (sub) {
        cdx[size_t(n)] = s.dx[n];
        cdy[size_t(n)] = s.dy[n];
      }
      cptr += pk[size_t(n)].csiz * (w / cdx[size_t(n)]) * (h / cdy[size_t(n)]);
    }
    // Where no component is sub-sampled, Pillow reads OpenJPEG's samples
    // where they are; else its indices (w // dx per row, each component
    // after the last one's w // dx x h // dy) are taken in OpenJPEG's
    // buffer, each component's samples in turn, csiz bytes each
    bool whole = true;
    for (int c = 0; c < s.C; ++c)
      whole = whole && s.dx[c] == 1 && s.dy[c] == 1;
    std::vector<uint8_t> buf;
    if (!whole) {
      int64_t tile_bytes = 0, data_size = 0;
      for (int c = 0; c < s.C; ++c) {
        const int64_t k = Packing(s.prec[c], s.sgnd[c], 8).csiz;
        tile_bytes += w * h * k;
        data_size += dec.ow[size_t(c)] * dec.oh[size_t(c)] * k;
      }
      buf.assign(size_t(std::max(tile_bytes, data_size)), 0);
      int64_t at = 0;
      for (int c = 0; c < s.C; ++c) {
        const int k = Packing(s.prec[c], s.sgnd[c], 8).csiz;
        for (int32_t v : dec.out[size_t(c)]) {
          const uint32_t u = uint32_t(v);
          for (int b = 0; b < k; ++b)
            buf[size_t(at++)] = uint8_t(u >> (8 * b));
        }
      }
    }
    auto word = [&](int n, int64_t y, int64_t x) -> uint32_t {
      const int k = pk[size_t(n)].csiz;
      if (whole)
        return uint32_t(dec.out[size_t(n)][size_t(y * w + x)])
               & (k == 4 ? 0xFFFFFFFFu : (1u << (8 * k)) - 1);
      const int64_t cw = w / cdx[size_t(n)];
      return read_word(buf, base[size_t(n)] + k * ((y / cdy[size_t(n)]) * cw
                                                   + x / cdx[size_t(n)]), k);
    };
    uint8_t px[4];
    for (int64_t y = 0; y < h; ++y)
      for (int64_t x = 0; x < w; ++x) {
        uint32_t v[4] = {0, 0, 0, 0};
        for (int n = 0; n < ncomp; ++n)
          v[n] = pk[size_t(n)].apply(word(n, y, x));
        uint8_t* o = out + ((y0 + y) * W + x0 + x) * bands * mode_bytes(mode);
        if (unpack == kGrayI) {
          const uint16_t u = uint16_t(v[0]);
          std::memcpy(o, &u, 2);
          continue;
        }
        switch (unpack) {
          case kGrayL: px[0] = uint8_t(v[0]); break;
          case kGrayRGB:
            px[0] = px[1] = px[2] = uint8_t(v[0]);
            px[3] = 0xFF;
            break;
          case kGrayALA:
            px[0] = px[1] = px[2] = uint8_t(v[0]);
            px[3] = uint8_t(v[1]);
            break;
          case kSRGBRGB: case kSYCCRGB:
            for (int n = 0; n < 3; ++n) px[n] = uint8_t(v[n]);
            px[3] = 0xFF;
            break;
          default:
            for (int n = 0; n < 4; ++n) px[n] = uint8_t(v[n]);
        }
        if (unpack == kSYCCRGB || unpack == kSYCCARGBA) ycbcr_to_rgb(px);
        if (bands == 1) o[0] = px[0];
        else if (bands == 2) {
          o[0] = px[0];
          o[1] = px[3];
        } else {
          std::memcpy(o, px, size_t(bands));
        }
      }
  }

  void decode(const uint8_t* data, int64_t size, int mode_, int space,
              int64_t W, int64_t H, uint8_t* out, int64_t cap) {
    if (mode_ < 0 || mode_ > kCMYK || space < 0 || space > kCMYKSpace)
      fail(kCorrupt, "mode %d, colour space %d", mode_, space);
    if (W <= 0 || H <= 0 || W * H > 2 * kMaxPixels)
      fail(kUnsupported, "an image of %lld x %lld pixels",
           static_cast<long long>(W), static_cast<long long>(H));
    if (W * H * mode_bands(mode_) * mode_bytes(mode_) > cap)
      fail(kNoRoom, "output buffer too small");
    dec.cs.read(data, size, false);
    const Siz& s = dec.cs.siz;
    if (s.X1 - s.X0 != W || s.Y1 - s.Y0 != H)
      fail(kCorrupt, "the header's %lld x %lld pixels are not the "
           "codestream's %lld x %lld", static_cast<long long>(W),
           static_cast<long long>(H), static_cast<long long>(s.X1 - s.X0),
           static_cast<long long>(s.Y1 - s.Y0));
    choose(mode_, space);
    std::memset(out, 0, size_t(W * H * mode_bands(mode) * mode_bytes(mode)));
    for (int64_t t : dec.cs.order) {
      dec.decode_tile(t);
      place(out, W, H);
      std::vector<uint8_t>().swap(dec.cs.tiles[size_t(t)].bytes);
    }
  }
};

// Every component's samples as OpenJPEG's opj_decode leaves them (before
// the JP2 box transforms), into out: C x H x W int32 for a codestream
// whose components are all whole (XRsiz = YRsiz = 1), cap values
// available.
void decode_components(const uint8_t* data, int64_t size, int32_t* out,
                       int64_t cap) {
  Decoder dec;
  dec.cs.read(data, size, false);
  const Siz& s = dec.cs.siz;
  const int64_t W = s.X1 - s.X0, H = s.Y1 - s.Y0;
  for (int c = 0; c < s.C; ++c)
    if (s.dx[c] != 1 || s.dy[c] != 1)
      fail(kUnsupported, "JPEG 2000: component %d is sub-sampled", c);
  if (W <= 0 || H <= 0 || W * H > 2 * kMaxPixels)
    fail(kUnsupported, "an image of %lld x %lld pixels",
         static_cast<long long>(W), static_cast<long long>(H));
  if (W * H * s.C > cap) fail(kNoRoom, "output buffer too small");
  std::memset(out, 0, size_t(W * H * s.C) * sizeof(int32_t));
  for (int64_t t : dec.cs.order) {
    dec.decode_tile(t);
    const int64_t x0 = dec.tx0 - s.X0, y0 = dec.ty0 - s.Y0;
    const int64_t w = dec.tx1 - dec.tx0, h = dec.ty1 - dec.ty0;
    for (int c = 0; c < s.C; ++c)
      for (int64_t y = 0; y < h; ++y)
        std::memcpy(out + (c * H + y0 + y) * W + x0,
                    dec.out[size_t(c)].data() + y * w,
                    size_t(w) * sizeof(int32_t));
    std::vector<uint8_t>().swap(dec.cs.tiles[size_t(t)].bytes);
  }
}

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
    return report(Failure{kNoRoom, "JPEG 2000: out of memory"}, msg, cap);
  } catch (...) {
    return report(Failure{kCorrupt, "JPEG 2000: internal error"}, msg, cap);
  }
}

}  // namespace

extern "C" {

// The main header of a codestream: info = {X1, Y1, X0, Y0 (the image area
// on the reference grid), components, then per component (4 slots): bits,
// signed, XRsiz, YRsiz}. Returns 0, or 1 (corrupt) / 2 (unsupported) with a
// message in msg.
int nm_jp2_info(const uint8_t* data, int64_t size, int32_t* info, char* msg,
                int64_t msg_cap) {
  return guarded(msg, msg_cap, [&]() {
    Codestream cs;
    cs.read(data, size, true);
    const Siz& s = cs.siz;
    const int64_t head[5] = {s.X1, s.Y1, s.X0, s.Y0, s.C};
    for (int k = 0; k < 5; ++k) info[k] = int32_t(std::min<int64_t>(
        head[k], INT32_MAX));
    for (int c = 0; c < 4; ++c) {
      info[5 + 4 * c] = c < s.C ? s.prec[c] : 0;
      info[6 + 4 * c] = c < s.C ? s.sgnd[c] : 0;
      info[7 + 4 * c] = c < s.C ? s.dx[c] : 0;
      info[8 + 4 * c] = c < s.C ? s.dy[c] : 0;
    }
  });
}

// The samples of a codestream as Pillow unpacks them into an image of mode
// (0 L, 1 P, 2 PA, 3 I;16, 4 LA, 5 RGB, 6 RGBA, 7 CMYK) and size width x
// height, the codestream's colour space being space (0 unspecified, 1 sRGB,
// 2 grey, 3 sYCC, 4 e-sYCC, 5 CMYK; OpenJPEG's guess where unspecified):
// out holds height x width x bands samples (bands 1, 1, 1, 1, 2, 3, 4, 4; P
// and PA the palette indices and alpha; uint16 for I;16), cap bytes
// available. Returns as nm_jp2_info, or
// 3 when out is too small or memory runs out.
int nm_jp2_decode(const uint8_t* data, int64_t size, int32_t mode,
                  int32_t space, int32_t width, int32_t height, uint8_t* out,
                  int64_t cap, char* msg, int64_t msg_cap) {
  return guarded(msg, msg_cap, [&]() {
    Image img;
    img.decode(data, size, mode, space, width, height, out, cap);
  });
}

// The samples of a codestream whose components are all whole, as OpenJPEG
// decodes them: out holds components x height x width int32 (cap values
// available). Returns as nm_jp2_decode.
int nm_jp2_components(const uint8_t* data, int64_t size, int32_t* out,
                      int64_t cap, char* msg, int64_t msg_cap) {
  return guarded(msg, msg_cap, [&]() {
    decode_components(data, size, out, cap);
  });
}

}  // extern "C"

// TIFF codecs of the PyTorch/CUDA port that OpenCV's libtiff (4.7.1)
// decodes and tifffile does not: CCITT fax (tif_fax3.c) and SGI LogLuv
// (tif_luv.c), as TIFFReadRGBAStrip / TIFFReadRGBATile drive them for
// viz/opencv_read.py. Built by kernels.py (g++ -O3 -std=c++17 -shared
// -fPIC -pthread) into _build/ at first use and bound in data/native.py.
//
//   * nm_fax_decode    — the strips or tiles of one CCITT image, in the
//                        order OpenCV reads them, into packed 1-bit rows
//                        (1 = black in fax terms): compression 2
//                        (modified Huffman, rows byte-aligned), 3 (T.4,
//                        1-D, or 2-D under Group3Options bit 0), 4 (T.6)
//                        and 32771 (modified Huffman, rows word-aligned)
//   * nm_sgilog_decode — the strips or tiles of one SGILog image into the
//                        8-bit samples TIFFRGBAImageBegin asks for
//                        (SGILOGDATAFMT_8BIT): LogL16 as grey, LogLuv32
//                        (compression 34676) and LogLuv24 (34677) as RGB
//
// Both follow libtiff where the data is bad, since OpenCV reads on past a
// codec's error: the fax decoder keeps its state machine, its run arrays
// (which outlive a strip) and its recovery (a short, long or undecodable
// row is cleaned up and filled, a premature end fills the row decoded so
// far and ends the strip, a run array that would overflow ends the strip
// before the row is filled); the SGILog decoder ends a strip at the first
// row that runs out of data. What a strip does not reach stays zero, as
// libtiff's freshly cleared strip buffer does. Exposed with C linkage for
// ctypes; nothing throws across that boundary.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ------------------------------------------------------------------ fax
// the states of tif_fax3.h's lookup tables
enum : uint8_t {
  S_Null, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW, S_TermB,
  S_MakeUpW, S_MakeUpB, S_MakeUp, S_EOL
};

struct TabEnt {
  uint8_t State, Width;
  uint32_t Param;
};

// T.4's code words, most significant (first) bit first: the terminating
// codes of runs 0-63, the make-up codes of 64-1728, the extended make-up
// codes of 1792-2560 that both colours share
const char* const kWhiteTerm[64] = {
    "00110101", "000111", "0111", "1000", "1011", "1100", "1110", "1111",
    "10011", "10100", "00111", "01000", "001000", "000011", "110100",
    "110101", "101010", "101011", "0100111", "0001100", "0001000",
    "0010111", "0000011", "0000100", "0101000", "0101011", "0010011",
    "0100100", "0011000", "00000010", "00000011", "00011010", "00011011",
    "00010010", "00010011", "00010100", "00010101", "00010110", "00010111",
    "00101000", "00101001", "00101010", "00101011", "00101100", "00101101",
    "00000100", "00000101", "00001010", "00001011", "01010010", "01010011",
    "01010100", "01010101", "00100100", "00100101", "01011000", "01011001",
    "01011010", "01011011", "01001010", "01001011", "00110010", "00110011",
    "00110100"};
const char* const kWhiteMakeUp[27] = {
    "11011", "10010", "010111", "0110111", "00110110", "00110111",
    "01100100", "01100101", "01101000", "01100111", "011001100", "011001101",
    "011010010", "011010011", "011010100", "011010101", "011010110",
    "011010111", "011011000", "011011001", "011011010", "011011011",
    "010011000", "010011001", "010011010", "011000", "010011011"};
const char* const kBlackTerm[64] = {
    "0000110111", "010", "11", "10", "011", "0011", "0010", "00011",
    "000101", "000100", "0000100", "0000101", "0000111", "00000100",
    "00000111", "000011000", "0000010111", "0000011000", "0000001000",
    "00001100111", "00001101000", "00001101100", "00000110111",
    "00000101000", "00000010111", "00000011000", "000011001010",
    "000011001011", "000011001100", "000011001101", "000001101000",
    "000001101001", "000001101010", "000001101011", "000011010010",
    "000011010011", "000011010100", "000011010101", "000011010110",
    "000011010111", "000001101100", "000001101101", "000011011010",
    "000011011011", "000001010100", "000001010101", "000001010110",
    "000001010111", "000001100100", "000001100101", "000001010010",
    "000001010011", "000000100100", "000000110111", "000000111000",
    "000000100111", "000000101000", "000001011000", "000001011001",
    "000000101011", "000000101100", "000001011010", "000001100110",
    "000001100111"};
const char* const kBlackMakeUp[27] = {
    "0000001111", "000011001000", "000011001001", "000001011011",
    "000000110011", "000000110100", "000000110101", "0000001101100",
    "0000001101101", "0000001001010", "0000001001011", "0000001001100",
    "0000001001101", "0000001110010", "0000001110011", "0000001110100",
    "0000001110101", "0000001110110", "0000001110111", "0000001010010",
    "0000001010011", "0000001010100", "0000001010101", "0000001011010",
    "0000001011011", "0000001100100", "0000001100101"};
const char* const kExtMakeUp[13] = {
    "00000001000", "00000001100", "00000001101", "000000010010",
    "000000010011", "000000010100", "000000010101", "000000010110",
    "000000010111", "000000011100", "000000011101", "000000011110",
    "000000011111"};

// mkg3states' FillTable: every index of a (1 << size)-entry table whose
// low bits (the first bits read, the decoder reading least significant
// bit first) are the code
void fill_code(TabEnt* t, int size, const char* code, uint8_t state,
               uint32_t param) {
  int width = static_cast<int>(std::strlen(code)), value = 0;
  for (int i = 0; i < width; ++i)
    if (code[i] == '1') value |= 1 << i;
  for (int idx = value; idx < (1 << size); idx += 1 << width)
    t[idx] = TabEnt{state, static_cast<uint8_t>(width), param};
}

struct FaxTables {
  TabEnt main[1 << 7], white[1 << 12], black[1 << 13];
  FaxTables() {
    std::memset(this, 0, sizeof(*this));
    // tif_fax3sm.c's main table: the 2-D modes, the uncompressed-mode
    // extension and the first 7 zeros of an EOL
    fill_code(main, 7, "0001", S_Pass, 0);
    fill_code(main, 7, "001", S_Horiz, 0);
    fill_code(main, 7, "1", S_V0, 0);
    fill_code(main, 7, "011", S_VR, 1);
    fill_code(main, 7, "000011", S_VR, 2);
    fill_code(main, 7, "0000011", S_VR, 3);
    fill_code(main, 7, "010", S_VL, 1);
    fill_code(main, 7, "000010", S_VL, 2);
    fill_code(main, 7, "0000010", S_VL, 3);
    fill_code(main, 7, "0000001", S_Ext, 0);
    fill_code(main, 7, "0000000", S_EOL, 0);
    for (int c = 0; c < 2; ++c) {
      TabEnt* t = c ? black : white;
      int size = c ? 13 : 12;
      for (int i = 0; i < 27; ++i)
        fill_code(t, size, c ? kBlackMakeUp[i] : kWhiteMakeUp[i],
                  c ? S_MakeUpB : S_MakeUpW, 64u * (i + 1));
      for (int i = 0; i < 13; ++i)
        fill_code(t, size, kExtMakeUp[i], S_MakeUp, 1792u + 64u * i);
      for (int i = 0; i < 64; ++i)
        fill_code(t, size, c ? kBlackTerm[i] : kWhiteTerm[i],
                  c ? S_TermB : S_TermW, i);
      // an EOL is recognised by its first 11 zeros; the rest (among them
      // 1-D uncompressed mode's 000000001111) is S_Null, of width 0
      fill_code(t, size, "00000000000", S_EOL, 0);
    }
  }
};

const FaxTables& fax_tables() {
  static const FaxTables t;
  return t;
}

// libtiff's bit reversal table (TIFFBitRevTable) and the identity
struct BitTables {
  uint8_t rev[256], same[256];
  BitTables() {
    for (int i = 0; i < 256; ++i) {
      int r = 0;
      for (int b = 0; b < 8; ++b)
        if (i & (1 << b)) r |= 0x80 >> b;
      rev[i] = static_cast<uint8_t>(r);
      same[i] = static_cast<uint8_t>(i);
    }
  }
};

const BitTables& bit_tables() {
  static const BitTables t;
  return t;
}

// int arithmetic as the decoder's C computes it (two's complement, wrapping
// where a corrupt stream takes it past the range), without undefined
// behaviour
inline int wrap(int64_t v) {
  return static_cast<int>(static_cast<uint32_t>(static_cast<uint64_t>(v)));
}

// _TIFFFax3fillruns: white runs clear bits, black runs set them; a run
// that goes past the row is cut there (and so stored, the array being the
// next row's reference)
void fill_runs(uint8_t* buf, uint32_t* runs, uint32_t* erun,
               uint32_t lastx) {
  if ((erun - runs) & 1) *erun++ = 0;
  uint32_t x = 0;
  for (; runs < erun; runs += 2) {
    for (int k = 0; k < 2; ++k) {
      uint32_t run = runs[k];
      if (x + run > lastx || run > lastx) run = runs[k] = lastx - x;
      if (run) {
        uint32_t end = x + run;
        for (uint32_t p = x; p < end;) {
          uint32_t bx = p & 7;
          uint32_t n = 8 - bx < end - p ? 8 - bx : end - p;
          uint8_t mask = static_cast<uint8_t>(((0xff00u >> n) & 0xffu) >> bx);
          if (k)
            buf[p >> 3] |= mask;
          else
            buf[p >> 3] &= static_cast<uint8_t>(~mask);
          p += n;
        }
        x += runs[k];
      }
    }
  }
}

enum { kCompRLE = 2, kCompG3 = 3, kCompG4 = 4, kCompRLEW = 32771 };
// how a row's decoding ended (the label tif_fax3.h jumps to)
enum Expand { kRowDone, kRowEOF, kOverflow };

// One image's decoder: Fax3SetupState's run arrays (they keep their values
// from strip to strip) and, per strip, Fax3PreDecode's reset and the state
// the decoding macros cache in locals.
struct FaxDecoder {
  const TabEnt* main_tab;
  const TabEnt* white_tab;
  const TabEnt* black_tab;
  int compression;
  bool two_d;            // Group3Options bit 0 under compression 3
  uint32_t rowpixels;
  int64_t rowbytes;
  uint32_t nruns;
  std::vector<uint32_t> runs;
  uint32_t* curruns;
  uint32_t* refruns;
  const uint8_t* base;   // the file: RLEW's word alignment counts from
                         // its start, as libtiff's memory-mapped read of a
                         // file (OpenCV opening a path) counts it
  const uint8_t* bitmap;
  bool noeol;            // Group 3 rows are taken to have no EOL (FAXMODE_
                         // NOEOL, set once for the rest of the image)

  // decoding state (CACHE_STATE's locals)
  uint32_t BitAcc;
  int BitsAvail, EOLcnt, a0, lastx, RunLength, b1;
  const uint8_t *strip, *cp, *ep;
  uint32_t *pa, *thisrun, *pb;
  const TabEnt* te;

  bool need8(int n) {
    if (BitsAvail < n) {
      if (cp >= ep) {
        if (BitsAvail == 0) return false;
        BitsAvail = n;  // pad with zeros
      } else {
        BitAcc |= static_cast<uint32_t>(bitmap[*cp++]) << BitsAvail;
        BitsAvail += 8;
      }
    }
    return true;
  }
  bool need16(int n) {
    if (BitsAvail < n) {
      if (cp >= ep) {
        if (BitsAvail == 0) return false;
        BitsAvail = n;
      } else {
        BitAcc |= static_cast<uint32_t>(bitmap[*cp++]) << BitsAvail;
        if ((BitsAvail += 8) < n) {
          if (cp >= ep) {
            BitsAvail = n;
          } else {
            BitAcc |= static_cast<uint32_t>(bitmap[*cp++]) << BitsAvail;
            BitsAvail += 8;
          }
        }
      }
    }
    return true;
  }
  uint32_t get(int n) const { return BitAcc & ((1u << n) - 1); }
  void clr(int n) {
    BitsAvail -= n;
    BitAcc >>= n;
  }
  bool lookup8(int wid, const TabEnt* tab) {
    if (!need8(wid)) return false;
    te = tab + get(wid);
    clr(te->Width);
    return true;
  }
  bool lookup16(int wid, const TabEnt* tab) {
    if (!need16(wid)) return false;
    te = tab + get(wid);
    clr(te->Width);
    return true;
  }
  // SETVALUE; false where the run array is full
  bool setvalue(uint32_t x) {
    if (pa >= thisrun + nruns) return false;
    *pa++ = static_cast<uint32_t>(RunLength) + x;
    a0 = wrap(static_cast<int64_t>(a0) + x);
    RunLength = 0;
    return true;
  }
  void makeup() {
    a0 = wrap(static_cast<int64_t>(a0) + te->Param);
    RunLength = wrap(static_cast<int64_t>(RunLength) + te->Param);
  }
  // CLEANUP_RUNS: a row that ends short is padded with the colour it
  // needs, one that ends long is cut back
  bool cleanup() {
    if (RunLength && !setvalue(0)) return false;
    if (a0 != lastx) {
      // libtiff: "Premature EOL" or "Line length mismatch"
      while (a0 > lastx && pa > thisrun) a0 = wrap(int64_t{a0} - *--pa);
      if (a0 < lastx) {
        if (a0 < 0) a0 = 0;
        if ((pa - thisrun) & 1)
          if (!setvalue(0)) return false;
        if (!setvalue(static_cast<uint32_t>(lastx - a0))) return false;
      } else if (a0 > lastx) {
        if (!setvalue(static_cast<uint32_t>(lastx))) return false;
        if (!setvalue(0)) return false;
      }
    }
    return true;
  }
  // SYNC_EOL: skip to the end of the next EOL. Where the data ends first,
  // libtiff decides the image has no EOLs ("Try to decode (read) fax
  // Group 3 data without EOL"): from then on no row looks for one, and
  // this row is decoded again from the start of the strip.
  void sync_eol() {
    if (noeol) return;
    if (EOLcnt == 0) {
      for (;;) {
        if (!need16(11)) goto noEOLFound;
        if (get(11) == 0) break;
        clr(1);
      }
    }
    for (;;) {
      if (!need8(8)) goto noEOLFound;
      if (get(8)) break;
      clr(8);
    }
    while (get(1) == 0) clr(1);
    clr(1);
    EOLcnt = 0;
    return;
  noEOLFound:
    noeol = true;
    BitsAvail = 0;
    BitAcc = 0;
    cp = strip;
  }
  // EXPAND1D
  Expand expand1d() {
    for (;;) {
      for (;;) {
        if (!lookup16(12, white_tab)) goto eof1d;
        switch (te->State) {
          case S_EOL:
            EOLcnt = 1;
            goto done1d;
          case S_TermW:
            if (!setvalue(te->Param)) return kOverflow;
            goto doneWhite1d;
          case S_MakeUpW:
          case S_MakeUp:
            makeup();
            break;
          default:
            // libtiff: "Bad code word"
            goto done1d;
        }
      }
    doneWhite1d:
      if (a0 >= lastx) goto done1d;
      for (;;) {
        if (!lookup16(13, black_tab)) goto eof1d;
        switch (te->State) {
          case S_EOL:
            EOLcnt = 1;
            goto done1d;
          case S_TermB:
            if (!setvalue(te->Param)) return kOverflow;
            goto doneBlack1d;
          case S_MakeUpB:
          case S_MakeUp:
            makeup();
            break;
          default:
            goto done1d;
        }
      }
    doneBlack1d:
      if (a0 >= lastx) goto done1d;
      if (*(pa - 1) == 0 && *(pa - 2) == 0) pa -= 2;
    }
  eof1d:
    return cleanup() ? kRowEOF : kOverflow;
  done1d:
    return cleanup() ? kRowDone : kOverflow;
  }
  // CHECK_b1: b1 to the first change of the reference line past a0
  bool check_b1() {
    if (pa != thisrun)
      while (b1 <= a0 && b1 < lastx) {
        if (pb + 1 >= refruns + nruns) return false;
        b1 = wrap(int64_t{b1} + pb[0] + pb[1]);
        pb += 2;
      }
    return true;
  }
  // one colour's run of the horizontal mode
  enum Run { kRunDone, kRunEOF, kRunBad, kRunFull };
  Run horiz_run(bool black) {
    for (;;) {
      if (!(black ? lookup16(13, black_tab) : lookup16(12, white_tab)))
        return kRunEOF;
      uint8_t s = te->State;
      if (s == (black ? S_TermB : S_TermW))
        return setvalue(te->Param) ? kRunDone : kRunFull;
      if (s != (black ? S_MakeUpB : S_MakeUpW) && s != S_MakeUp)
        return kRunBad;
      makeup();
    }
  }
  // EXPAND2D
  Expand expand2d() {
    while (a0 < lastx) {
      if (pa >= thisrun + nruns) return kOverflow;
      if (!lookup8(7, main_tab)) goto eof2d;
      switch (te->State) {
        case S_Pass:
          if (!check_b1()) return kOverflow;
          if (pb + 1 >= refruns + nruns) return kOverflow;
          b1 = wrap(int64_t{b1} + *pb++);
          RunLength = wrap(int64_t{RunLength} + b1 - a0);
          a0 = b1;
          b1 = wrap(int64_t{b1} + *pb++);
          break;
        case S_Horiz: {
          bool black_first = (pa - thisrun) & 1;
          for (int k = 0; k < 2; ++k) {
            Run r = horiz_run((k == 0) == black_first);
            if (r == kRunEOF) goto eof2d;
            if (r == kRunFull) return kOverflow;
            if (r == kRunBad) goto eol2d;  // libtiff: "Bad code word"
          }
          if (!check_b1()) return kOverflow;
          break;
        }
        case S_V0:
          if (!check_b1()) return kOverflow;
          if (!setvalue(static_cast<uint32_t>(wrap(int64_t{b1} - a0))))
            return kOverflow;
          if (pb >= refruns + nruns) return kOverflow;
          b1 = wrap(int64_t{b1} + *pb++);
          break;
        case S_VR:
          if (!check_b1()) return kOverflow;
          if (!setvalue(static_cast<uint32_t>(
                  wrap(int64_t{b1} - a0 + te->Param))))
            return kOverflow;
          if (pb >= refruns + nruns) return kOverflow;
          b1 = wrap(int64_t{b1} + *pb++);
          break;
        case S_VL:
          if (!check_b1()) return kOverflow;
          if (b1 < wrap(int64_t{a0} + te->Param))
            goto eol2d;  // libtiff: "Bad code word"
          if (!setvalue(static_cast<uint32_t>(
                  wrap(int64_t{b1} - a0 - te->Param))))
            return kOverflow;
          if (pb <= runs.data())  // libtiff would read before its array
            return kOverflow;
          b1 = wrap(int64_t{b1} - *--pb);
          break;
        case S_Ext:
          *pa++ = static_cast<uint32_t>(lastx - a0);
          // libtiff: "Uncompressed data (not supported)"
          goto eol2d;
        case S_EOL:
          *pa++ = static_cast<uint32_t>(lastx - a0);
          if (!need8(4)) goto eof2d;
          // libtiff warns where the EOL's last 4 bits are not 0001
          clr(4);
          EOLcnt = 1;
          goto eol2d;
        default:
          goto eol2d;
      }
    }
    if (RunLength) {
      if (wrap(int64_t{RunLength} + a0) < lastx) {
        // expect a final V0
        if (!need8(1)) goto eof2d;
        if (!get(1)) goto eol2d;  // libtiff: "Bad code word"
        clr(1);
      }
      if (!setvalue(0)) return kOverflow;
    }
  eol2d:
    return cleanup() ? kRowDone : kOverflow;
  eof2d:
    return cleanup() ? kRowEOF : kOverflow;
  }

  // Fax3PreDecode
  void start_strip(const uint8_t* data, int64_t count) {
    BitAcc = 0;
    BitsAvail = 0;
    EOLcnt = 0;
    curruns = runs.data();
    if (refruns) {
      refruns = runs.data() + nruns;
      refruns[0] = rowpixels;
      refruns[1] = 0;
    }
    strip = cp = data;
    ep = data + count;
    lastx = static_cast<int>(rowpixels);
  }

  // Fax3Decode1D, Fax3Decode2D, Fax4Decode or Fax3DecodeRLE over one
  // strip's rows
  void decode(uint8_t* buf, int64_t rows) {
    for (int64_t row = 0; row < rows; ++row, buf += rowbytes) {
      a0 = 0;
      RunLength = 0;
      pa = thisrun = curruns;
      Expand e;
      if (compression == kCompG4) {
        pb = refruns;
        b1 = static_cast<int>(*pb++);
        e = expand2d();
        if (e == kOverflow) return;
        if (e == kRowEOF || EOLcnt) {
          // EOFG4: the EOFB (or whatever is there) is skipped, the row
          // filled, the strip ended
          fill_runs(buf, thisrun, pa, rowpixels);
          return;
        }
        fill_runs(buf, thisrun, pa, rowpixels);
        if (!setvalue(0)) return;  // imaginary change for reference
        uint32_t* t = curruns;
        curruns = refruns;
        refruns = t;
        continue;
      }
      if (compression == kCompRLE || compression == kCompRLEW) {
        e = expand1d();
        if (e == kOverflow) return;
        fill_runs(buf, thisrun, pa, rowpixels);
        if (e == kRowEOF) return;
        if (compression == kCompRLE) {
          clr(BitsAvail - (BitsAvail & ~7));
        } else {
          clr(BitsAvail - (BitsAvail & ~15));
          if (BitsAvail == 0 && ((cp - base) & 1)) cp++;
        }
        continue;
      }
      // Group 3: every row starts after an EOL
      sync_eol();
      bool is1d = true;
      if (two_d) {
        if (!need8(1)) {
          if (!cleanup()) return;
          fill_runs(buf, thisrun, pa, rowpixels);
          return;
        }
        is1d = get(1);
        clr(1);
        pb = refruns;
        b1 = static_cast<int>(*pb++);
      }
      e = is1d ? expand1d() : expand2d();
      if (e == kOverflow) return;
      fill_runs(buf, thisrun, pa, rowpixels);
      if (e == kRowEOF) return;
      if (two_d) {
        if (pa < thisrun + nruns) setvalue(0);
        uint32_t* t = curruns;
        curruns = refruns;
        refruns = t;
      }
    }
  }
};

// ---------------------------------------------------------------- SGILog
constexpr double kLn2 = 0.69314718055994530942;  // M_LN2
constexpr double kUVScale = 410.;
constexpr double kUNeu = 0.210526316, kVNeu = 0.473684211;
constexpr float kUvSqSiz = 0.003500f, kUvVStart = 0.016940f;
constexpr int kUvNDivs = 16289, kUvNVs = 163;

// libtiff's uvcode.h: per row of the (u', v') grid of LogLuv24, its first
// u' and the counts of cells in it and before it
struct UvRow {
  float ustart;
  short nus, ncum;
};
// UV_NVS 163 rows, UV_NDIVS 16289 codes, derived by
// tests/torch_textures/derive_uv_rows.py
constexpr UvRow kUvRow[kUvNVs] = {
    {0.247663f, 4, 0}, {0.243779f, 6, 4}, {0.241684f, 7, 10},
    {0.237874f, 9, 17}, {0.235906f, 10, 26}, {0.232153f, 12, 36},
    {0.228352f, 14, 48}, {0.226259f, 15, 62}, {0.222371f, 17, 77},
    {0.220410f, 18, 94}, {0.214710f, 21, 112}, {0.212714f, 22, 133},
    {0.210721f, 23, 155}, {0.204976f, 26, 178}, {0.202986f, 27, 204},
    {0.199245f, 29, 231}, {0.195525f, 31, 260}, {0.193560f, 32, 291},
    {0.189878f, 34, 323}, {0.186216f, 36, 357}, {0.186216f, 36, 393},
    {0.182592f, 38, 429}, {0.179003f, 40, 467}, {0.175466f, 42, 507},
    {0.172001f, 44, 549}, {0.172001f, 44, 593}, {0.168612f, 46, 637},
    {0.168612f, 46, 683}, {0.163575f, 49, 729}, {0.158642f, 52, 778},
    {0.158642f, 52, 830}, {0.158642f, 52, 882}, {0.153815f, 55, 934},
    {0.153815f, 55, 989}, {0.149097f, 58, 1044}, {0.149097f, 58, 1102},
    {0.142746f, 62, 1160}, {0.142746f, 62, 1222}, {0.142746f, 62, 1284},
    {0.138270f, 65, 1346}, {0.138270f, 65, 1411}, {0.138270f, 65, 1476},
    {0.132166f, 69, 1541}, {0.132166f, 69, 1610}, {0.126204f, 73, 1679},
    {0.126204f, 73, 1752}, {0.126204f, 73, 1825}, {0.120381f, 77, 1898},
    {0.120381f, 77, 1975}, {0.120381f, 77, 2052}, {0.120381f, 77, 2129},
    {0.112962f, 82, 2206}, {0.112962f, 82, 2288}, {0.112962f, 82, 2370},
    {0.107450f, 86, 2452}, {0.107450f, 86, 2538}, {0.107450f, 86, 2624},
    {0.107450f, 86, 2710}, {0.100343f, 91, 2796}, {0.100343f, 91, 2887},
    {0.100343f, 91, 2978}, {0.095126f, 95, 3069}, {0.095126f, 95, 3164},
    {0.095126f, 95, 3259}, {0.095126f, 95, 3354}, {0.088276f, 100, 3449},
    {0.088276f, 100, 3549}, {0.088276f, 100, 3649}, {0.088276f, 100, 3749},
    {0.081523f, 105, 3849}, {0.081523f, 105, 3954}, {0.081523f, 105, 4059},
    {0.081523f, 105, 4164}, {0.074861f, 110, 4269}, {0.074861f, 110, 4379},
    {0.074861f, 110, 4489}, {0.074861f, 110, 4599}, {0.068290f, 115, 4709},
    {0.068290f, 115, 4824}, {0.068290f, 115, 4939}, {0.068290f, 115, 5054},
    {0.063573f, 119, 5169}, {0.063573f, 119, 5288}, {0.063573f, 119, 5407},
    {0.063573f, 119, 5526}, {0.057219f, 124, 5645}, {0.057219f, 124, 5769},
    {0.057219f, 124, 5893}, {0.057219f, 124, 6017}, {0.050985f, 129, 6141},
    {0.050985f, 129, 6270}, {0.050985f, 129, 6399}, {0.050985f, 129, 6528},
    {0.050985f, 129, 6657}, {0.044859f, 134, 6786}, {0.044859f, 134, 6920},
    {0.044859f, 134, 7054}, {0.044859f, 134, 7188}, {0.040571f, 138, 7322},
    {0.040571f, 138, 7460}, {0.040571f, 138, 7598}, {0.040571f, 138, 7736},
    {0.036339f, 142, 7874}, {0.036339f, 142, 8016}, {0.036339f, 142, 8158},
    {0.036339f, 142, 8300}, {0.032139f, 146, 8442}, {0.032139f, 146, 8588},
    {0.032139f, 146, 8734}, {0.032139f, 146, 8880}, {0.027947f, 150, 9026},
    {0.027947f, 150, 9176}, {0.027947f, 150, 9326}, {0.023739f, 154, 9476},
    {0.023739f, 154, 9630}, {0.023739f, 154, 9784}, {0.023739f, 154, 9938},
    {0.019504f, 158, 10092}, {0.019504f, 158, 10250}, {0.019504f, 158, 10408},
    {0.016976f, 161, 10566}, {0.016976f, 161, 10727}, {0.016976f, 161, 10888},
    {0.016976f, 161, 11049}, {0.012639f, 165, 11210}, {0.012639f, 165, 11375},
    {0.012639f, 165, 11540}, {0.009991f, 168, 11705}, {0.009991f, 168, 11873},
    {0.009991f, 168, 12041}, {0.009016f, 170, 12209}, {0.009016f, 170, 12379},
    {0.009016f, 170, 12549}, {0.006217f, 173, 12719}, {0.006217f, 173, 12892},
    {0.005097f, 175, 13065}, {0.005097f, 175, 13240}, {0.005097f, 175, 13415},
    {0.003909f, 177, 13590}, {0.003909f, 177, 13767}, {0.002340f, 177, 13944},
    {0.002389f, 170, 14121}, {0.001068f, 164, 14291}, {0.001653f, 157, 14455},
    {0.000717f, 150, 14612}, {0.001614f, 143, 14762}, {0.000270f, 136, 14905},
    {0.000484f, 129, 15041}, {0.001103f, 123, 15170}, {0.001242f, 115, 15293},
    {0.001188f, 109, 15408}, {0.001011f, 103, 15517}, {0.000709f, 97, 15620},
    {0.000301f, 89, 15717}, {0.002416f, 82, 15806}, {0.003251f, 76, 15888},
    {0.003246f, 69, 15964}, {0.004141f, 62, 16033}, {0.005963f, 55, 16095},
    {0.008839f, 47, 16150}, {0.010490f, 40, 16197}, {0.016994f, 31, 16237},
    {0.023659f, 21, 16268},
};

double logl16_to_y(int p16) {
  int Le = p16 & 0x7fff;
  if (!Le) return 0.;
  double Y = std::exp(kLn2 / 256. * (Le + .5) - kLn2 * 64.);
  return !(p16 & 0x8000) ? Y : -Y;
}

double logl10_to_y(int p10) {
  if (p10 == 0) return 0.;
  return std::exp(kLn2 / 64. * (p10 + .5) - kLn2 * 12.);
}

int uv_decode(double* up, double* vp, int c) {
  if (c < 0 || c >= kUvNDivs) return -1;
  int lower = 0, upper = kUvNVs, ui, vi;
  while (upper - lower > 1) {
    vi = (lower + upper) >> 1;
    ui = c - kUvRow[vi].ncum;
    if (ui > 0) {
      lower = vi;
    } else if (ui < 0) {
      upper = vi;
    } else {
      lower = vi;
      break;
    }
  }
  vi = lower;
  ui = c - kUvRow[vi].ncum;
  *up = kUvRow[vi].ustart + (ui + .5) * kUvSqSiz;
  *vp = kUvVStart + (vi + .5) * kUvSqSiz;
  return 0;
}

void uv_to_xyz(double L, double u, double v, float* XYZ) {
  double s = 1. / (6. * u - 16. * v + 12.);
  double x = 9. * u * s, y = 4. * v * s;
  XYZ[0] = static_cast<float>(x / y * L);
  XYZ[1] = static_cast<float>(L);
  XYZ[2] = static_cast<float>((1. - x - y) / y * L);
}

void logluv32_to_xyz(uint32_t p, float* XYZ) {
  double L = logl16_to_y(static_cast<int32_t>(p) >> 16);
  if (L <= 0.) {
    XYZ[0] = XYZ[1] = XYZ[2] = 0.f;
    return;
  }
  uv_to_xyz(L, 1. / kUVScale * ((p >> 8 & 0xff) + .5),
            1. / kUVScale * ((p & 0xff) + .5), XYZ);
}

void logluv24_to_xyz(uint32_t p, float* XYZ) {
  double L = logl10_to_y(p >> 14 & 0x3ff), u, v;
  if (L <= 0.) {
    XYZ[0] = XYZ[1] = XYZ[2] = 0.f;
    return;
  }
  if (uv_decode(&u, &v, static_cast<int>(p & 0x3fff)) < 0) {
    u = kUNeu;
    v = kVNeu;
  }
  uv_to_xyz(L, u, v, XYZ);
}

inline uint8_t gamma2(double c) {
  if (c <= 0.) return 0;
  if (c >= 1.) return 255;
  return static_cast<uint8_t>(static_cast<int>(256. * std::sqrt(c)));
}

// XYZtoRGB24: CCIR-709 primaries, gamma 2
void xyz_to_rgb24(const float* xyz, uint8_t* rgb) {
  double r = 2.690 * xyz[0] + -1.276 * xyz[1] + -0.414 * xyz[2];
  double g = -1.022 * xyz[0] + 1.978 * xyz[1] + 0.044 * xyz[2];
  double b = 0.061 * xyz[0] + -0.224 * xyz[1] + 1.163 * xyz[2];
  rgb[0] = gamma2(r);
  rgb[1] = gamma2(g);
  rgb[2] = gamma2(b);
}

// LogL16Decode / LogLuvDecode32: the run-length coded byte planes of one
// row, the most significant first. False where the data runs out.
template <typename T>
bool decode_planes(const uint8_t*& bp, int64_t& cc, T* tp, int64_t npixels,
                   int first_shift) {
  std::memset(tp, 0, npixels * sizeof(T));
  for (int shft = first_shift; shft >= 0; shft -= 8) {
    int64_t i = 0;
    while (i < npixels && cc > 0) {
      if (*bp >= 128) {  // run
        if (cc < 2) break;
        int rc = *bp++ + (2 - 128);
        T b = static_cast<T>(static_cast<uint32_t>(*bp++) << shft);
        cc -= 2;
        while (rc-- && i < npixels) tp[i++] |= b;
      } else {  // literal bytes
        int rc = *bp++;
        while (--cc && rc-- && i < npixels)
          tp[i++] |= static_cast<T>(static_cast<uint32_t>(*bp++) << shft);
      }
    }
    if (i != npixels) return false;
  }
  return true;
}

}  // namespace

extern "C" {

// The CCITT strips or tiles of one image, in the order OpenCV reads them:
// block i is the bytes [offsets[i], offsets[i] + counts[i]) of the file
// (``data``, ``size`` bytes) and has rows[i] rows of ``rowpixels`` pixels,
// each ``rowbytes`` bytes in ``out`` (the blocks one after the other; the
// caller clears it). ``options`` is Group3Options (bit 0: 2-D coding);
// ``fillorder`` 2 reads each byte least significant bit first. Returns 0,
// or -1 where a block lies outside the file or the width overflows
// libtiff's arrays.
int nm_fax_decode(const uint8_t* data, int64_t size, const int64_t* offsets,
                  const int64_t* counts, const int64_t* rows, int32_t nblocks,
                  int32_t rowpixels, int64_t rowbytes, int32_t compression,
                  uint32_t options, int32_t fillorder, uint8_t* out) {
  if (rowpixels <= 0 || rowbytes < (int64_t{rowpixels} + 7) / 8) return -1;
  const FaxTables& tabs = fax_tables();
  FaxDecoder d{};
  d.main_tab = tabs.main;
  d.white_tab = tabs.white;
  d.black_tab = tabs.black;
  d.compression = compression;
  d.two_d = compression == kCompG3 && (options & 1);
  bool ref_line = d.two_d || compression == kCompG4;
  d.rowpixels = static_cast<uint32_t>(rowpixels);
  d.rowbytes = rowbytes;
  // Fax3SetupState: TIFFroundup_32(rowpixels + 1, 32), doubled where a
  // reference line is kept; both halves zeroed once
  uint64_t nruns = ((uint64_t{d.rowpixels} + 1 + 31) / 32) * 32;
  if (ref_line) nruns *= 2;
  if (nruns * 2 > (uint64_t{1} << 31)) return -1;
  d.nruns = static_cast<uint32_t>(nruns);
  d.runs.assign(nruns * 2, 0);
  d.refruns = ref_line ? d.runs.data() + nruns : nullptr;
  d.base = data;
  d.bitmap = fillorder == 2 ? bit_tables().same : bit_tables().rev;
  for (int32_t i = 0; i < nblocks; ++i) {
    if (offsets[i] < 0 || counts[i] < 0 || offsets[i] > size ||
        counts[i] > size - offsets[i])
      return -1;
  }
  for (int32_t i = 0; i < nblocks; ++i) {
    d.start_strip(data + offsets[i], counts[i]);
    d.decode(out, rows[i]);
    out += rows[i] * rowbytes;
  }
  return 0;
}

// The SGILog strips or tiles of one image (blocks as for nm_fax_decode,
// each row ``width`` pixels), as 8-bit samples: ``kind`` 0 LogL16 (one
// byte a pixel, L16toGry), 1 LogLuv32 and 2 LogLuv24 (three, Luv32toRGB
// and Luv24toRGB). ``fillorder`` 2 reverses the bits of each byte first,
// as TIFFFillStrip does for a codec that does not. A block ends at the
// first row its data cannot complete (the caller clears ``out``). Returns
// 0, or -1 where a block lies outside the file.
int nm_sgilog_decode(const uint8_t* data, int64_t size, const int64_t* offsets,
                     const int64_t* counts, const int64_t* rows,
                     int32_t nblocks, int64_t width, int32_t kind,
                     int32_t fillorder, uint8_t* out) {
  const int channels = kind == 0 ? 1 : 3;
  for (int32_t i = 0; i < nblocks; ++i) {
    if (offsets[i] < 0 || counts[i] < 0 || offsets[i] > size ||
        counts[i] > size - offsets[i])
      return -1;
  }
  const uint8_t* rev = bit_tables().rev;
  std::vector<uint8_t> flipped;
  std::vector<int16_t> l16(width);
  std::vector<uint32_t> luv(width);
  for (int32_t i = 0; i < nblocks; ++i) {
    const uint8_t* bp = data + offsets[i];
    int64_t cc = counts[i];
    if (fillorder == 2) {
      flipped.resize(cc);
      for (int64_t k = 0; k < cc; ++k) flipped[k] = rev[bp[k]];
      bp = flipped.data();
    }
    int64_t row = 0;
    for (; row < rows[i]; ++row) {
      uint8_t* op = out + row * width * channels;
      if (kind == 0) {
        if (!decode_planes(bp, cc, l16.data(), width, 8)) break;
        for (int64_t k = 0; k < width; ++k)
          op[k] = gamma2(logl16_to_y(l16[k]));
      } else if (kind == 1) {
        if (!decode_planes(bp, cc, luv.data(), width, 24)) break;
        for (int64_t k = 0; k < width; ++k) {
          float xyz[3];
          logluv32_to_xyz(luv[k], xyz);
          xyz_to_rgb24(xyz, op + 3 * k);
        }
      } else {
        if (cc < 3 * width) break;  // Not enough data: the row is not put
        for (int64_t k = 0; k < width; ++k, bp += 3) {
          float xyz[3];
          logluv24_to_xyz(uint32_t{bp[0]} << 16 | uint32_t{bp[1]} << 8 |
                              bp[2],
                          xyz);
          xyz_to_rgb24(xyz, op + 3 * k);
        }
        cc -= 3 * width;
      }
    }
    out += rows[i] * width * channels;
  }
  return 0;
}

}  // extern "C"

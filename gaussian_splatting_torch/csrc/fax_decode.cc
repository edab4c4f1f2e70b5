// CCITT fax decoding of TIFF strips and tiles, as libtiff 4.7's tif_fax3.c
// decodes them for PIL: host C++, built with the host compiler by
// utils/cuda_build.py at first use and loaded with ctypes (utils/fax.py).
// Nothing falls back to another decoder: if this cannot be built, the read
// raises naming the file.
//
// - Modified Huffman (compression 2, Fax3DecodeRLE): each row 1-D coded,
//   no EOLs, the next row from the next byte; 32771 (CCITTRLEW) from the
//   next 16-bit word.
// - Group 3 (compression 3): each row after an EOL; 1-D rows
//   (Fax3Decode1D), or with T4Options bit 0 a tag bit after each EOL
//   choosing 1-D or 2-D (Fax3Decode2D). Fill bits before an EOL are
//   skipped as libtiff skips them (T4Options bit 2 changes nothing).
//   Uncompressed mode (bit 1) is not decoded: its extension code ends
//   the row, as libtiff's "Uncompressed data (not supported)" does.
// - Group 4 (compression 4, Fax4Decode): 2-D rows against the row above
//   (white above the first); an EOL (EOFB) or the end of the data ends the
//   strip early, which is an error only if no row was decoded.
//
// The code tables are T.4's, looked up as libtiff's generated tables are:
// 12 (white), 13 (black) or 7 (mode) bits least significant first, a code
// that fits no entry consuming no bits. A bad code word ends its row (the
// rest white) and decoding goes on, as libtiff's does (it logs "Bad code
// word"); data that ends mid-row fails the strip (Group 3, MH), except where
// the bits left are padded with zeros, as libtiff pads them. Output rows are
// packed bits, 1 for black, the first pixel in the high bit.
//
// Interface (plain C; returns 0, or 1 with the message in gs_fax_error):
//   gs_fax_runs(width, mode): the entries of the run array an image needs
//   gs_fax_decode(in, n, mode, width, rows, out, row_bytes, runs, rows_done):
//     `runs` kept by the caller for every strip of an image, zeroed first
//   mode: 0 MH, 1 MH word-aligned (32771), 2 Group 3 1-D, 3 Group 3 2-D, 4 Group 4

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

thread_local std::string g_error;

enum State { S_Null = 0, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW, S_TermB, S_MakeUpW, S_MakeUpB,
             S_MakeUp, S_EOL };

struct TabEnt {
  uint8_t state, width;
  uint32_t param;
};

struct Code {
  const char* bits;
  int param;
};

const Code kTermW[] = {
    {"00110101", 0},  {"000111", 1},   {"0111", 2},     {"1000", 3},     {"1011", 4},     {"1100", 5},
    {"1110", 6},      {"1111", 7},     {"10011", 8},    {"10100", 9},    {"00111", 10},   {"01000", 11},
    {"001000", 12},   {"000011", 13},  {"110100", 14},  {"110101", 15},  {"101010", 16},  {"101011", 17},
    {"0100111", 18},  {"0001100", 19}, {"0001000", 20}, {"0010111", 21}, {"0000011", 22}, {"0000100", 23},
    {"0101000", 24},  {"0101011", 25}, {"0010011", 26}, {"0100100", 27}, {"0011000", 28}, {"00000010", 29},
    {"00000011", 30}, {"00011010", 31}, {"00011011", 32}, {"00010010", 33}, {"00010011", 34}, {"00010100", 35},
    {"00010101", 36}, {"00010110", 37}, {"00010111", 38}, {"00101000", 39}, {"00101001", 40}, {"00101010", 41},
    {"00101011", 42}, {"00101100", 43}, {"00101101", 44}, {"00000100", 45}, {"00000101", 46}, {"00001010", 47},
    {"00001011", 48}, {"01010010", 49}, {"01010011", 50}, {"01010100", 51}, {"01010101", 52}, {"00100100", 53},
    {"00100101", 54}, {"01011000", 55}, {"01011001", 56}, {"01011010", 57}, {"01011011", 58}, {"01001010", 59},
    {"01001011", 60}, {"00110010", 61}, {"00110011", 62}, {"00110100", 63}};
const Code kMakeUpW[] = {
    {"11011", 64},       {"10010", 128},      {"010111", 192},     {"0110111", 256},    {"00110110", 320},
    {"00110111", 384},   {"01100100", 448},   {"01100101", 512},   {"01101000", 576},   {"01100111", 640},
    {"011001100", 704},  {"011001101", 768},  {"011010010", 832},  {"011010011", 896},  {"011010100", 960},
    {"011010101", 1024}, {"011010110", 1088}, {"011010111", 1152}, {"011011000", 1216}, {"011011001", 1280},
    {"011011010", 1344}, {"011011011", 1408}, {"010011000", 1472}, {"010011001", 1536}, {"010011010", 1600},
    {"011000", 1664},    {"010011011", 1728}};
const Code kTermB[] = {
    {"0000110111", 0},   {"010", 1},          {"11", 2},           {"10", 3},           {"011", 4},
    {"0011", 5},         {"0010", 6},         {"00011", 7},        {"000101", 8},       {"000100", 9},
    {"0000100", 10},     {"0000101", 11},     {"0000111", 12},     {"00000100", 13},    {"00000111", 14},
    {"000011000", 15},   {"0000010111", 16},  {"0000011000", 17},  {"0000001000", 18},  {"00001100111", 19},
    {"00001101000", 20}, {"00001101100", 21}, {"00000110111", 22}, {"00000101000", 23}, {"00000010111", 24},
    {"00000011000", 25}, {"000011001010", 26}, {"000011001011", 27}, {"000011001100", 28}, {"000011001101", 29},
    {"000001101000", 30}, {"000001101001", 31}, {"000001101010", 32}, {"000001101011", 33}, {"000011010010", 34},
    {"000011010011", 35}, {"000011010100", 36}, {"000011010101", 37}, {"000011010110", 38}, {"000011010111", 39},
    {"000001101100", 40}, {"000001101101", 41}, {"000011011010", 42}, {"000011011011", 43}, {"000001010100", 44},
    {"000001010101", 45}, {"000001010110", 46}, {"000001010111", 47}, {"000001100100", 48}, {"000001100101", 49},
    {"000001010010", 50}, {"000001010011", 51}, {"000000100100", 52}, {"000000110111", 53}, {"000000111000", 54},
    {"000000100111", 55}, {"000000101000", 56}, {"000001011000", 57}, {"000001011001", 58}, {"000000101011", 59},
    {"000000101100", 60}, {"000001011010", 61}, {"000001100110", 62}, {"000001100111", 63}};
const Code kMakeUpB[] = {
    {"0000001111", 64},     {"000011001000", 128},  {"000011001001", 192},  {"000001011011", 256},
    {"000000110011", 320},  {"000000110100", 384},  {"000000110101", 448},  {"0000001101100", 512},
    {"0000001101101", 576}, {"0000001001010", 640}, {"0000001001011", 704}, {"0000001001100", 768},
    {"0000001001101", 832}, {"0000001110010", 896}, {"0000001110011", 960}, {"0000001110100", 1024},
    {"0000001110101", 1088}, {"0000001110110", 1152}, {"0000001110111", 1216}, {"0000001010010", 1280},
    {"0000001010011", 1344}, {"0000001010100", 1408}, {"0000001010101", 1472}, {"0000001011010", 1536},
    {"0000001011011", 1600}, {"0000001100100", 1664}, {"0000001100101", 1728}};
const Code kMakeUp[] = {  // extended make-up codes, both colours
    {"00000001000", 1792},  {"00000001100", 1856},  {"00000001101", 1920},  {"000000010010", 1984},
    {"000000010011", 2048}, {"000000010100", 2112}, {"000000010101", 2176}, {"000000010110", 2240},
    {"000000010111", 2304}, {"000000011100", 2368}, {"000000011101", 2432}, {"000000011110", 2496},
    {"000000011111", 2560}};

struct Tables {
  std::vector<TabEnt> main, white, black;
  Tables() : main(1 << 7), white(1 << 12), black(1 << 13) {
    auto fill = [](std::vector<TabEnt>& t, int wid, const char* bits, int state, uint32_t param) {
      int len = static_cast<int>(std::strlen(bits)), rev = 0;
      for (int i = 0; i < len; ++i) rev |= (bits[i] - '0') << i;  // first bit read is the lowest
      for (int k = 0; k < (1 << (wid - len)); ++k)
        t[rev | (k << len)] = TabEnt{static_cast<uint8_t>(state), static_cast<uint8_t>(len), param};
    };
    for (const Code& c : kTermW) fill(white, 12, c.bits, S_TermW, c.param);
    for (const Code& c : kMakeUpW) fill(white, 12, c.bits, S_MakeUpW, c.param);
    for (const Code& c : kMakeUp) fill(white, 12, c.bits, S_MakeUp, c.param);
    fill(white, 12, "00000000000", S_EOL, 0);  // libtiff's EOL entry: eleven zeros
    for (const Code& c : kTermB) fill(black, 13, c.bits, S_TermB, c.param);
    for (const Code& c : kMakeUpB) fill(black, 13, c.bits, S_MakeUpB, c.param);
    for (const Code& c : kMakeUp) fill(black, 13, c.bits, S_MakeUp, c.param);
    fill(black, 13, "00000000000", S_EOL, 0);
    fill(main, 7, "0001", S_Pass, 0);
    fill(main, 7, "001", S_Horiz, 0);
    fill(main, 7, "1", S_V0, 0);
    fill(main, 7, "011", S_VR, 1);
    fill(main, 7, "000011", S_VR, 2);
    fill(main, 7, "0000011", S_VR, 3);
    fill(main, 7, "010", S_VL, 1);
    fill(main, 7, "000010", S_VL, 2);
    fill(main, 7, "0000010", S_VL, 3);
    fill(main, 7, "0000001", S_Ext, 0);
    fill(main, 7, "0000000", S_EOL, 0);
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

uint8_t reverse(uint8_t b) {
  b = static_cast<uint8_t>((b & 0xF0) >> 4 | (b & 0x0F) << 4);
  b = static_cast<uint8_t>((b & 0xCC) >> 2 | (b & 0x33) << 2);
  return static_cast<uint8_t>((b & 0xAA) >> 1 | (b & 0x55) << 1);
}

// _TIFFFax3fillruns: white runs clear bits, black runs set them, each run
// cut at lastx.
void fill_runs(uint8_t* buf, uint32_t* runs, uint32_t* erun, uint32_t lastx) {
  if ((erun - runs) & 1) *erun++ = 0;
  uint32_t x = 0;
  for (; runs < erun; runs += 2) {
    for (int colour = 0; colour < 2; ++colour) {
      uint32_t run = runs[colour];
      if (x + run > lastx || run > lastx) run = runs[colour] = lastx - x;
      for (uint32_t i = x; i < x + run; ++i) {
        uint8_t bit = static_cast<uint8_t>(0x80 >> (i & 7));
        if (colour)
          buf[i >> 3] |= bit;
        else
          buf[i >> 3] &= static_cast<uint8_t>(~bit);
      }
      x += run;
    }
  }
}

struct Decoder {
  const uint8_t* cp;
  const uint8_t* ep;
  const uint8_t* start;
  uint32_t acc = 0;
  int avail = 0;
  const Tables& t = tables();

  bool end() const { return cp >= ep; }
  // NeedBits8 / NeedBits16: false where no bit is left (libtiff's eoflab)
  bool need(int n) {
    if (avail >= n) return true;
    if (end()) {
      if (avail == 0) return false;
      avail = n;  // pad with zeros
      return true;
    }
    acc |= static_cast<uint32_t>(reverse(*cp++)) << avail;
    avail += 8;
    if (avail < n) {
      if (end()) {
        avail = n;
      } else {
        acc |= static_cast<uint32_t>(reverse(*cp++)) << avail;
        avail += 8;
      }
    }
    return true;
  }
  uint32_t get(int n) const { return acc & ((1u << n) - 1); }
  void clr(int n) {
    avail -= n;
    acc >>= n;
  }
};

// Fax3SetupState's run arrays: two of this many entries, which libtiff
// allocates once for an image and reuses, stale entries and all, for
// every strip (2-D decoding reads past the reference row's last change)
uint32_t nruns_of(int width, int mode) {
  uint32_t nruns = (static_cast<uint32_t>(width) + 1 + 31) / 32 * 32;
  return mode >= 3 ? 2 * nruns : nruns;
}

}  // namespace

extern "C" {

const char* gs_fax_error() { return g_error.c_str(); }

long long gs_fax_runs(int width, int mode) { return 2 * static_cast<long long>(nruns_of(width, mode)); }

int gs_fax_decode(const uint8_t* in, long long n, int mode, int width, int rows, uint8_t* out, long long row_bytes,
                  uint32_t* runs, int* rows_done) {
  Decoder d{in, in + n, in};
  const uint32_t lastx = static_cast<uint32_t>(width);
  const uint32_t nruns = nruns_of(width, mode);
  uint32_t* curruns = runs;
  uint32_t* refruns = runs + nruns;
  refruns[0] = lastx;
  refruns[1] = 0;
  int EOLcnt = 0, line = 0;
  *rows_done = 0;
  auto failed = [&](const std::string& msg) {
    g_error = msg + " at row " + std::to_string(line);
    *rows_done = line;
    return 1;
  };
  for (; line < rows; ++line) {
    uint8_t* buf = out + static_cast<long long>(line) * row_bytes;
    int64_t a0 = 0, RunLength = 0;
    uint32_t* thisrun = curruns;
    uint32_t* pa = thisrun;
    uint32_t* pb = refruns;
    int64_t b1 = 0;
    bool overflow = false;
    const TabEnt* e = nullptr;
    auto setvalue = [&](int64_t x) {
      if (pa >= thisrun + nruns) {
        overflow = true;
        return;
      }
      *pa++ = static_cast<uint32_t>(RunLength + x);
      a0 += x;
      RunLength = 0;
    };
    auto cleanup = [&]() {
      if (RunLength) setvalue(0);
      if (a0 != static_cast<int64_t>(lastx)) {
        while (a0 > static_cast<int64_t>(lastx) && pa > thisrun) a0 -= *--pa;
        if (a0 < static_cast<int64_t>(lastx)) {
          if (a0 < 0) a0 = 0;
          if ((pa - thisrun) & 1) setvalue(0);
          setvalue(static_cast<int64_t>(lastx) - a0);
        } else if (a0 > static_cast<int64_t>(lastx)) {
          setvalue(lastx);
          setvalue(0);
        }
      }
    };
    // 0: row done, 1: premature end of data (runs cleaned), 2: a run
    // array overflow (libtiff returns an error)
    auto lookup = [&](const std::vector<TabEnt>& tab, int wid) {
      if (!d.need(wid)) return false;
      e = &tab[d.get(wid)];
      d.clr(e->width);
      return true;
    };
    auto expand1d = [&]() -> int {
      for (;;) {
        for (;;) {  // white
          if (!lookup(d.t.white, 12)) goto eof;
          if (e->state == S_EOL) {
            EOLcnt = 1;
            goto done;
          } else if (e->state == S_TermW) {
            setvalue(e->param);
            break;
          } else if (e->state == S_MakeUpW || e->state == S_MakeUp) {
            a0 += e->param;
            RunLength += e->param;
          } else {
            goto done;  // bad code word: libtiff logs it and ends the row
          }
        }
        if (overflow) return 2;
        if (a0 >= static_cast<int64_t>(lastx)) goto done;
        for (;;) {  // black
          if (!lookup(d.t.black, 13)) goto eof;
          if (e->state == S_EOL) {
            EOLcnt = 1;
            goto done;
          } else if (e->state == S_TermB) {
            setvalue(e->param);
            break;
          } else if (e->state == S_MakeUpB || e->state == S_MakeUp) {
            a0 += e->param;
            RunLength += e->param;
          } else {
            goto done;
          }
        }
        if (overflow) return 2;
        if (a0 >= static_cast<int64_t>(lastx)) goto done;
        if (*(pa - 1) == 0 && *(pa - 2) == 0) pa -= 2;
      }
    eof:
      cleanup();
      return overflow ? 2 : 1;
    done:
      cleanup();
      return overflow ? 2 : 0;
    };
    auto check_b1 = [&]() {
      if (pa != thisrun)
        while (b1 <= a0 && b1 < static_cast<int64_t>(lastx)) {
          if (pb + 1 >= refruns + nruns) return false;
          b1 += pb[0] + pb[1];
          pb += 2;
        }
      return true;
    };
    // EXPAND2D; 3: the row ended at an EOL or extension (EOLcnt set by EOL)
    auto expand2d = [&]() -> int {
      while (a0 < static_cast<int64_t>(lastx)) {
        if (pa >= thisrun + nruns) return 2;
        if (!lookup(d.t.main, 7)) goto eof;
        switch (e->state) {
          case S_Pass:
            if (!check_b1()) return 2;
            if (pb + 1 >= refruns + nruns) return 2;
            b1 += *pb++;
            RunLength += b1 - a0;
            a0 = b1;
            b1 += *pb++;
            break;
          case S_Horiz: {
            bool black_first = (pa - thisrun) & 1;
            for (int k = 0; k < 2; ++k) {
              bool black = black_first != (k == 1);
              for (;;) {
                if (!lookup(black ? d.t.black : d.t.white, black ? 13 : 12)) goto eof;
                if (e->state == (black ? S_TermB : S_TermW)) {
                  setvalue(e->param);
                  if (overflow) return 2;
                  break;
                } else if (e->state == (black ? S_MakeUpB : S_MakeUpW) || e->state == S_MakeUp) {
                  a0 += e->param;
                  RunLength += e->param;
                } else {
                  goto eol;  // bad code word
                }
              }
            }
            if (!check_b1()) return 2;
            break;
          }
          case S_V0:
            if (!check_b1()) return 2;
            setvalue(b1 - a0);
            if (overflow || pb >= refruns + nruns) return 2;
            b1 += *pb++;
            break;
          case S_VR:
            if (!check_b1()) return 2;
            setvalue(b1 - a0 + e->param);
            if (overflow || pb >= refruns + nruns) return 2;
            b1 += *pb++;
            break;
          case S_VL:
            if (!check_b1()) return 2;
            if (b1 < a0 + static_cast<int64_t>(e->param)) goto eol;  // bad code word
            setvalue(b1 - a0 - e->param);
            if (overflow) return 2;
            b1 -= *--pb;
            break;
          case S_Ext:
            *pa++ = static_cast<uint32_t>(lastx - a0);
            goto eol;  // uncompressed mode: not supported
          case S_EOL:
            *pa++ = static_cast<uint32_t>(lastx - a0);
            if (!d.need(4)) goto eof;
            d.clr(4);
            EOLcnt = 1;
            goto eol;
          default:
            goto eol;  // bad code word
        }
      }
      if (RunLength) {
        if (RunLength + a0 < static_cast<int64_t>(lastx)) {
          if (!d.need(1)) goto eof;
          if (!d.get(1)) goto eol;  // expected a final V0
          d.clr(1);
        }
        setvalue(0);
        if (overflow) return 2;
      }
    eol:
      cleanup();
      return overflow ? 2 : 0;
    eof:
      cleanup();
      return overflow ? 2 : 1;
    };
    // SYNC_EOL: find the EOL before the row (11 zeros, then zeros up to a 1)
    auto sync_eol = [&]() {
      if (EOLcnt == 0) {
        for (;;) {
          if (!d.need(11)) return false;
          if (d.get(11) == 0) break;
          d.clr(1);
        }
      }
      for (;;) {
        if (!d.need(8)) return false;
        if (d.get(8)) break;
        d.clr(8);
      }
      while (d.get(1) == 0) d.clr(1);
      d.clr(1);
      EOLcnt = 0;
      return true;
    };
    int rc;
    if (mode <= 1) {  // Fax3DecodeRLE
      rc = expand1d();
      if (rc == 2) return failed("a run array overflow (libtiff: buffer overflow)");
      fill_runs(buf, thisrun, pa, lastx);
      if (rc == 1) return failed("premature end of the fax data (libtiff fails the strip)");
      if (mode == 0) {
        d.clr(d.avail & 7);
      } else {
        d.clr(d.avail & 15);
        if (d.avail == 0 && ((d.cp - d.start) & 1)) ++d.cp;
      }
    } else if (mode == 2) {  // Fax3Decode1D
      if (!sync_eol()) {
        cleanup();
        fill_runs(buf, thisrun, pa, lastx);
        return failed("premature end of the fax data before an EOL (libtiff fails the strip)");
      }
      rc = expand1d();
      if (rc == 2) return failed("a run array overflow (libtiff: buffer overflow)");
      fill_runs(buf, thisrun, pa, lastx);
      if (rc == 1) return failed("premature end of the fax data (libtiff fails the strip)");
    } else if (mode == 3) {  // Fax3Decode2D
      bool ok = sync_eol() && d.need(1);
      if (!ok) {
        cleanup();
        fill_runs(buf, thisrun, pa, lastx);
        return failed("premature end of the fax data before an EOL (libtiff fails the strip)");
      }
      bool is1d = d.get(1);
      d.clr(1);
      b1 = *pb++;
      rc = is1d ? expand1d() : expand2d();
      if (rc == 2) return failed("a run array overflow (libtiff: buffer overflow)");
      fill_runs(buf, thisrun, pa, lastx);
      if (rc == 1) return failed("premature end of the fax data (libtiff fails the strip)");
      if (pa < thisrun + nruns) setvalue(0);  // imaginary change for reference
      std::swap(curruns, refruns);
    } else {  // Fax4Decode
      b1 = *pb++;
      rc = expand2d();
      if (rc == 2) return failed("a run array overflow (libtiff: buffer overflow)");
      if (rc == 1 || EOLcnt) {  // EOFB or the data's end: the strip ends here
        fill_runs(buf, thisrun, pa, lastx);
        *rows_done = line + 1;  // this row as far as it was decoded; the rest untouched
        if (line == 0) {
          g_error = "Group 4 data that ends before its first row (libtiff fails the strip)";
          return 1;
        }
        return 0;
      }
      fill_runs(buf, thisrun, pa, lastx);
      setvalue(0);
      if (overflow) return failed("a run array overflow (libtiff: buffer overflow)");
      std::swap(curruns, refruns);
    }
  }
  *rows_done = rows;
  return 0;
}

}  // extern "C"

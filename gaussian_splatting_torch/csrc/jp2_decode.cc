// JPEG 2000 decoding for the dataset readers (Part 1, HTJ2K (Part 15) and
// the Part 2 markers OpenJPEG reads):
// host C++, built with the host compiler by utils/cuda_build.py at first
// use and loaded with ctypes (utils/jp2.py parses the JP2 boxes and calls
// it).
//
// The rule is the pixels PIL gives: PIL hands the file to OpenJPEG 2.5,
// which decodes it tile by tile (opj_read_tile_header and
// opj_decode_tile_data, so no JP2 colour box is applied), and unpacks
// each tile with its own j2ku_* routines. This decoder follows that path:
//
//   - the codestream: SIZ (any Rsiz, 1 to 31 bits a sample), CAP and CPF
//     (HTJ2K's: read and ignored, as OpenJPEG does), COD, COC, QCD, QCC,
//     RGN, POC (a tile's entries added to the main header's, as
//     opj_j2k_read_poc does), PPM, PPT (merged as opj_j2k_merge_ppm / _ppt
//     do), COM, TLM, PLM, PLT, CRG (skipped), Part 2's MCT, MCC, MCO and CBD
//     as OpenJPEG 2.5 reads them (`read_mct` and on: what they change is
//     the DC level shift and, by CBD, each component's precision and sign),
//     unknown main-header markers, the other Part 2 markers among them
//     (opj_j2k_read_unk: skipped two bytes at a time to the next known
//     marker), SOT with tile-parts, SOD, EOC, with
//     OpenJPEG's checks in strict mode (a tile-part running past the file,
//     or a stream without EOC, fails, as PIL does); tiles decoded in the
//     order their last tile-part completes them;
//   - tier 2: the five progression orders as opj_pi_next_* walk them, under
//     a POC list too (its include array: each packet read once, a packet no
//     entry names never), precincts, packet headers in the packet or packed
//     in PPM / PPT (bit stuffing after 0xFF, the inclusion and zero-bit-plane
//     tag trees, coding passes, Lblock, a length per segment as
//     opj_t2_init_seg bounds segments for each code-block style), SOP
//     (skipped where present) and EPH (required where signalled), every
//     layer;
//   - tier 1: the MQ decoder with OpenJPEG's 0xFF handling and its 0xFFFF
//     sentinel after each segment, its raw decoder for BYPASS, the
//     significance, refinement and clean-up passes with every code-block
//     style (BYPASS, RESET, TERMALL, VSC, PTERM, SEGSYM), magnitudes kept
//     with one extra bit and the 1/2 reconstruction point, the RGN maxshift
//     counted in the bit-planes and scaled down after;
//   - HT code-blocks (JPEG 2000 Part 15, ITU-T T.814: code-block style
//     0x40): their passes in the packet header as OpenJPEG 2.5 reads them
//     (the first to the cleanup segment, the rest to the next), and
//     OpenJPEG's HT decoder (`ht_decode`): the cleanup pass (MEL, the
//     CxtVLC tables of ht_vlc_tables.h, UVLC, MagSgn), SigProp and MagRef,
//     its checks and its reading of damaged segments; ROI on HT blocks
//     fails, as there;
//   - dequantisation (the reversible path's value / 2, the irreversible
//     path's float value times 0.5 * stepsize, OpenJPEG's stepsize with no
//     band gain), the inverse 5/3 in integers and 9/7 in float with
//     OpenJPEG's constants, its 2/K high-pass scale and its step order, the
//     RCT or ICT (OpenJPEG never applies a Part 2 decorrelation matrix:
//     its COD allows no MCT above 1), the DC level shift (1 << (prec - 1),
//     or what an MCO sets) with lrintf and the clamp;
//   - the inverse transforms up to the highest resolution a packet was read
//     for (OpenJPEG's resno_decoded), opj_tcd_update_tile_data's packing (1,
//     2 or 4 bytes a sample, 17 to 31 bits taking 4, each component at its
//     own size) into PIL's buffer, zeroed for each tile, and PIL's
//     unpackers for its modes L, P, PA, I;16, LA, RGB, RGBA and CMYK:
//     subsampled components by PIL's strides (w / dx, h / dy), sYCC
//     guessed where the colour space is unspecified and component 1 or 2
//     is subsampled, samples above 8 (or 16) bits rounded and shifted down
//     as PIL does.
//
// Where PIL fails on a file this fails too; it refuses nothing else.
//
// Floating-point contraction is off for this file: OpenJPEG's 9/7 and ICT
// arithmetic rounds every multiply and add on its own.
//
// Interface (plain C; returns 0, or 1 with gs_jp2_error's message for the
// calling thread):
//   gs_jp2_decode(cs, size, mode, colour_space, width, height, ihdr_w, ihdr_h, out)
//   gs_jp2_segments(cs, size, out, capacity)   code-block data ranges (for tests)

#if defined(__clang__)
#pragma clang fp contract(off)
#elif defined(__GNUC__)
#pragma GCC optimize("fp-contract=off")
#endif

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

thread_local std::string g_error;

struct Error {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw Error{msg}; }

std::string fmt(const char* f, long long a = 0, long long b = 0, long long c = 0) {
  char buf[256];
  snprintf(buf, sizeof buf, f, a, b, c);
  return buf;
}

inline uint32_t be16(const uint8_t* p) { return uint32_t(p[0]) << 8 | p[1]; }
inline uint32_t be32(const uint8_t* p) { return be16(p) << 16 | be16(p + 2); }
inline int64_t ceildiv(int64_t a, int64_t b) { return (a + b - 1) / b; }
inline int64_t ceildivpow2(int64_t a, int b) { return (a + (int64_t(1) << b) - 1) >> b; }
inline int64_t floordivpow2(int64_t a, int b) { return a >> b; }

// OpenJPEG's modes of PIL (utils/jp2.py passes the index) and colour spaces
enum Mode { M_L, M_P, M_PA, M_I16, M_LA, M_RGB, M_RGBA, M_CMYK };
enum Space { CS_UNKNOWN = -1, CS_UNSPECIFIED = 0, CS_SRGB, CS_GRAY, CS_SYCC, CS_EYCC, CS_CMYK };
// code-block styles (SPcod): Part 1's six, and HT code-blocks (Part 15)
enum CblkStyle { BYPASS = 1, RESET = 2, TERMALL = 4, VSC = 8, PTERM = 16, SEGSYM = 32, HT = 64 };

enum Marker : uint32_t {
  SOC = 0xff4f, CAP = 0xff50, SIZ = 0xff51, COD = 0xff52, COC = 0xff53, TLM = 0xff55, PLM = 0xff57,
  PLT = 0xff58, CPF = 0xff59, QCD = 0xff5c, QCC = 0xff5d, RGN = 0xff5e, POC = 0xff5f, PPM = 0xff60,
  PPT = 0xff61, CRG = 0xff63, COM = 0xff64, SOT = 0xff90, SOP = 0xff91, EPH = 0xff92, SOD = 0xff93,
  EOC = 0xffd9, MCT = 0xff74, MCC = 0xff75, MCO = 0xff77, CBD = 0xff78,
};

// ---- headers ----

struct StepSize {
  int expn = 0, mant = 0;
};

struct Tccp {
  int csty = 0, numres = 0, cblkw = 0, cblkh = 0, cblksty = 0, qmfbid = 0, roishift = 0;
  int prcw[33] = {}, prch[33] = {};
  int qntsty = 0, numgbits = 0;
  StepSize steps[97];
  int32_t dc_shift = 0;  // m_dc_level_shift: 1 << (prec - 1) for an unsigned component at SIZ, or an MCO's
};

struct Poc {
  int rs, cs, lye, re, ce, prg;
};

// PPM or PPT segments by their Z index
struct Packed {
  std::vector<std::vector<uint8_t>> segs;
  std::vector<char> set;
  void add(const uint8_t* p, int64_t len, const char* what) {
    int z = p[0];
    if (int(set.size()) <= z) segs.resize(z + 1), set.resize(z + 1, 0);
    if (set[z]) fail(fmt(what, z));
    set[z] = 1;
    segs[z].assign(p + 1, p + len);
  }
};

// Part 2's multiple component transform records as OpenJPEG keeps them
// (opj_mct_data_t, opj_simple_mcc_decorrelation_data_t): an MCT's array
// (empty where OpenJPEG holds none), an MCC's arrays by their place in the
// MCT list (-1: none).
struct MctRecord {
  int index = 0, element = 0;  // Imct's low byte; element type 0 int16, 1 int32, 2 float32, 3 float64
  std::vector<uint8_t> data;
};

struct MccRecord {
  int index = 0, nb_comps = 0, deco = -1, offset = -1;
};

struct Tcp {
  int csty = 0, prg = 0, numlayers = 0, mct = 0;
  std::vector<Tccp> tccps;
  std::vector<MctRecord> mcts;
  std::vector<MccRecord> mccs;
  bool poc = false;
  std::vector<Poc> pocs;
  Packed ppt;
  bool has_ppt = false;
  std::vector<uint8_t> data;
  std::vector<std::pair<int64_t, int64_t>> parts;  // (codestream offset, length) of each tile-part's data
  int part = -1, nb_parts = 0;
  bool has_data = false;
};

struct Comp {
  int dx, dy, prec, sgnd;
};

struct Codestream {
  int64_t x0, y0, x1, y1, tdx, tdy, tx0, ty0;
  int tw, th;
  std::vector<Comp> comps;
  Tcp deflt;
  std::vector<Tcp> tiles;
  std::vector<int> order;  // tiles in decoding order
  std::vector<char> completed;  // tiles whose last tile-part (by TNsot) was read
  bool has_ppm = false;
  Packed ppm;
  std::vector<uint8_t> ppm_data;  // the packet headers of every tile-part, in order
};

void read_siz(Codestream& cs, const uint8_t* s, int64_t len, int64_t ihdr_w, int64_t ihdr_h) {
  if (len < 36) fail("Error with SIZ marker size");
  int64_t rem = len - 36;
  if (rem / 3 > 16384 || rem % 3) fail("Error with SIZ marker size");
  cs.x1 = be32(s + 2), cs.y1 = be32(s + 6), cs.x0 = be32(s + 10), cs.y0 = be32(s + 14);
  cs.tdx = be32(s + 18), cs.tdy = be32(s + 22), cs.tx0 = be32(s + 26), cs.ty0 = be32(s + 30);
  int64_t n = be16(s + 34);
  if (n > 16384) fail("Error with SIZ marker: number of component is illegal");
  if (n != rem / 3) fail("Error with SIZ marker: number of component is not compatible with the remaining parameters");
  if (cs.x0 >= cs.x1 || cs.y0 >= cs.y1) fail("Error with SIZ marker: negative or zero image size");
  if (cs.tdx == 0 || cs.tdy == 0) fail("Error with SIZ marker: invalid tile size");
  int64_t tx1 = std::min<int64_t>(cs.tx0 + cs.tdx, 0xffffffffLL), ty1 = std::min<int64_t>(cs.ty0 + cs.tdy, 0xffffffffLL);
  if (cs.tx0 > cs.x0 || cs.ty0 > cs.y0 || tx1 <= cs.x0 || ty1 <= cs.y0) fail("Error with SIZ marker: illegal tile offset");
  if (ihdr_w > 0 && ihdr_h > 0 && (ihdr_w != cs.x1 - cs.x0 || ihdr_h != cs.y1 - cs.y0))
    fail(fmt("Error with SIZ marker: IHDR w(%lld) h(%lld) vs. SIZ", ihdr_w, ihdr_h));
  for (int64_t i = 0; i < n; i++) {
    const uint8_t* c = s + 36 + 3 * i;
    Comp comp{c[1], c[2], (c[0] & 0x7f) + 1, c[0] >> 7};
    if (comp.dx < 1 || comp.dy < 1) fail(fmt("Invalid values for comp = %lld : dx=%lld dy=%lld", i, comp.dx, comp.dy));
    if (comp.prec > 31) fail(fmt("Invalid values for comp = %lld : prec=%lld", i, comp.prec));
    cs.comps.push_back(comp);
  }
  int64_t tw = ceildiv(cs.x1 - cs.tx0, cs.tdx), th = ceildiv(cs.y1 - cs.ty0, cs.tdy);
  if (tw == 0 || th == 0 || tw > 65535 / th) fail("Invalid number of tiles");
  cs.tw = int(tw), cs.th = int(th);
  cs.deflt.tccps.assign(size_t(n), Tccp());
  for (int64_t i = 0; i < n; i++)  // "set up default dc level shift"
    if (!cs.comps[i].sgnd) cs.deflt.tccps[i].dc_shift = int32_t(1u << (cs.comps[i].prec - 1));
}

// SPcod / SPcoc into one component's parameters; returns the bytes read
int read_spcod(Tccp& t, const uint8_t* p, int64_t len) {
  if (len < 5) fail("Error reading SPCod SPCoc element");
  t.numres = p[0] + 1;
  if (t.numres > 33) fail("Invalid value for numresolutions");
  t.cblkw = p[1] + 2, t.cblkh = p[2] + 2;
  if (t.cblkw > 10 || t.cblkh > 10 || t.cblkw + t.cblkh > 12)
    fail("Error reading SPCod SPCoc element, Invalid cblkw/cblkh combination");
  t.cblksty = p[3];
  if (t.cblksty & 0x80) fail("Error reading SPCod SPCoc element. Unsupported Mixed HT code-block style found");
  t.qmfbid = p[4];
  if (t.qmfbid > 1) fail("Error reading SPCod SPCoc element, Invalid transformation found");
  if (t.csty & 1) {
    if (len - 5 < t.numres) fail("Error reading SPCod SPCoc element");
    for (int i = 0; i < t.numres; i++) {
      int v = p[5 + i];
      if (i != 0 && ((v & 0xf) == 0 || (v >> 4) == 0)) fail("Invalid precinct size");
      t.prcw[i] = v & 0xf, t.prch[i] = v >> 4;
    }
    return 5 + t.numres;
  }
  for (int i = 0; i < t.numres; i++) t.prcw[i] = t.prch[i] = 15;
  return 5;
}

int read_sqcd(Tccp& t, const uint8_t* p, int64_t len) {
  if (len < 1) fail("Error reading SQcd or SQcc element");
  t.qntsty = p[0] & 0x1f, t.numgbits = p[0] >> 5;
  int64_t rest = len - 1, nb;
  if (t.qntsty == 1) nb = 1;
  else nb = t.qntsty == 0 ? rest : rest / 2;
  if (t.qntsty == 0) {
    for (int64_t b = 0; b < nb; b++)
      if (b < 97) t.steps[b] = {p[1 + b] >> 3, 0};
    rest -= nb;
  } else {
    if (rest < 2 * nb) fail("Error reading SQcd or SQcc element");
    for (int64_t b = 0; b < nb; b++) {
      uint32_t v = be16(p + 1 + 2 * b);
      if (b < 97) t.steps[b] = {int(v >> 11), int(v & 0x7ff)};
    }
    rest -= 2 * nb;
  }
  if (t.qntsty == 1)
    for (int b = 1; b < 97; b++)
      t.steps[b] = {std::max(0, t.steps[0].expn - (b - 1) / 3), t.steps[0].mant};
  return int(len - rest);
}

// One COD / COC / QCD / QCC segment into `tcp` (the main header's or a tile's);
// `coc_set` / `qcc_set` mark components a COC / QCC of this header set, which a
// COD / QCD of the same header leaves alone.
void read_coding(uint32_t m, Tcp& tcp, const uint8_t* p, int64_t len, size_t ncomp, std::vector<char>& coc_set,
                 std::vector<char>& qcc_set) {
  if (m == COD) {
    if (len < 5) fail("Error reading COD marker");
    tcp.csty = p[0];
    if (tcp.csty & ~7) fail("Unknown Scod value in COD marker");
    tcp.prg = p[1];
    if (tcp.prg > 4) tcp.prg = -1;  // OpenJPEG's OPJ_PROG_UNKNOWN: a tile decoded without a POC fails
    tcp.numlayers = int(be16(p + 2));
    if (tcp.numlayers < 1) fail("Invalid number of layers in COD marker");
    tcp.mct = p[4];
    if (tcp.mct > 1) fail("Invalid multiple component transformation");
    Tccp t;
    t.csty = tcp.csty & 1;
    if (read_spcod(t, p + 5, len - 5) != len - 5) fail("Error reading COD marker");
    for (size_t c = 0; c < ncomp; c++) {
      if (coc_set[c]) continue;
      Tccp& d = tcp.tccps[c];
      d.csty = t.csty, d.numres = t.numres, d.cblkw = t.cblkw, d.cblkh = t.cblkh, d.cblksty = t.cblksty;
      d.qmfbid = t.qmfbid;
      std::copy(t.prcw, t.prcw + 33, d.prcw), std::copy(t.prch, t.prch + 33, d.prch);
    }
  } else if (m == COC || m == QCC) {
    int room = ncomp <= 256 ? 1 : 2;
    if (len < room + 1) fail("Error reading COC or QCC marker");
    size_t c = room == 1 ? p[0] : be16(p);
    if (c >= ncomp) fail("Error reading COC or QCC marker (bad number of components)");
    Tccp& d = tcp.tccps[c];
    if (m == COC) {
      d.csty = p[room];
      if (read_spcod(d, p + room + 1, len - room - 1) != len - room - 1) fail("Error reading COC marker");
      coc_set[c] = 1;
    } else {
      if (read_sqcd(d, p + room, len - room) != len - room) fail("Error reading QCC marker");
      qcc_set[c] = 1;
    }
  } else {  // QCD
    Tccp t;
    if (read_sqcd(t, p, len) != len) fail("Error reading QCD marker");
    for (size_t c = 0; c < ncomp; c++) {
      if (qcc_set[c]) continue;
      Tccp& d = tcp.tccps[c];
      d.qntsty = t.qntsty, d.numgbits = t.numgbits;
      std::copy(t.steps, t.steps + 97, d.steps);
    }
  }
}

void read_rgn(Tcp& tcp, const uint8_t* p, int64_t len, size_t ncomp) {  // opj_j2k_read_rgn (Srgn is not read)
  int room = ncomp <= 256 ? 1 : 2;
  if (len != 2 + room) fail("Error reading RGN marker");
  size_t c = room == 1 ? p[0] : be16(p);
  if (c >= ncomp) fail(fmt("bad component number in RGN (%lld when there are only %lld)", c, ncomp));
  tcp.tccps[c].roishift = p[room + 1];
}

void read_poc(Tcp& tcp, const uint8_t* p, int64_t len, size_t ncomp) {  // opj_j2k_read_poc
  int room = ncomp <= 256 ? 1 : 2, chunk = 5 + 2 * room;
  int64_t nb = len / chunk;
  if (nb <= 0 || len % chunk) fail("Error reading POC marker");
  size_t old = tcp.poc ? tcp.pocs.size() : 0;
  if (int64_t(old) + nb >= 32) fail(fmt("Too many POCs %lld", int64_t(old) + nb));
  tcp.poc = true;
  tcp.pocs.resize(old);
  for (int64_t i = 0; i < nb; i++, p += chunk) {
    Poc e;
    e.rs = p[0];
    e.cs = int(room == 1 ? p[1] : be16(p + 1));
    e.lye = std::min(int(be16(p + 1 + room)), tcp.numlayers);  // the layers known when it is read
    e.re = p[3 + room];
    e.ce = std::min(int(room == 1 ? p[4 + room] : be16(p + 4 + room)), int(ncomp));
    e.prg = p[4 + 2 * room];
    tcp.pocs.push_back(e);
  }
}

// ---- Part 2: MCT, MCC, MCO, CBD, as OpenJPEG 2.5 reads them ----
//
// OpenJPEG reads one transform stage of one collection of array
// decorrelation (no shuffled components), and what it keeps of it is the
// offset array, which becomes the components' DC level shift; a record it
// cannot take is passed over with a warning (the `return`s below), a
// malformed one fails the file (the `fail`s).

// opj_j2k_read_mct
void read_mct(Tcp& tcp, const uint8_t* p, int64_t len) {
  if (len < 2) fail("Error reading MCT marker");
  if (be16(p) != 0) return;  // Zmct: "Cannot take in charge mct data within multiple MCT records"
  if (len <= 6) fail("Error reading MCT marker");
  uint32_t imct = be16(p + 2);
  int index = int(imct & 0xff);
  size_t k = 0;
  while (k < tcp.mcts.size() && tcp.mcts[k].index != index) k++;
  if (k == tcp.mcts.size()) tcp.mcts.emplace_back();
  MctRecord& rec = tcp.mcts[k];
  rec.data.clear();
  rec.index = index, rec.element = int((imct >> 10) & 3);
  if (be16(p + 4) != 0) return;  // Ymct: "Cannot take in charge multiple MCT markers" (the record keeps no data)
  rec.data.assign(p + 6, p + len);
}

int find_mct(const Tcp& tcp, int index) {
  for (size_t k = 0; k < tcp.mcts.size(); k++)
    if (tcp.mcts[k].index == index) return int(k);
  fail("Error reading MCC marker");
}

// opj_j2k_read_mcc: a new record counts once it is read to its end; one
// read again is changed in place as far as the read goes
void read_mcc(Tcp& tcp, const uint8_t* p, int64_t len) {
  if (len < 2) fail("Error reading MCC marker");
  if (be16(p) != 0) return;  // Zmcc: "Cannot take in charge multiple data spanning"
  if (len < 7) fail("Error reading MCC marker");
  int index = p[2];
  size_t k = 0;
  while (k < tcp.mccs.size() && tcp.mccs[k].index != index) k++;
  MccRecord fresh;
  MccRecord& rec = k < tcp.mccs.size() ? tcp.mccs[k] : fresh;
  rec.index = index;
  if (be16(p + 3) != 0) return;  // Ymcc
  uint32_t collections = be16(p + 5);
  if (collections > 1) return;  // "Cannot take in charge multiple collections"
  const uint8_t* q = p + 7;
  int64_t size = len - 7;
  auto read = [&](int bytes) {
    uint32_t v = bytes == 1 ? q[0] : be16(q);
    q += bytes;
    return v;
  };
  for (uint32_t i = 0; i < collections; i++) {
    if (size < 3) fail("Error reading MCC marker");
    if (*q++ != 1) return;  // Xmcc: "Cannot take in charge collections other than array decorrelation"
    uint32_t n = be16(q);
    q += 2, size -= 3;
    int bytes = 1 + int(n >> 15);
    rec.nb_comps = int(n & 0x7fff);
    if (size < int64_t(bytes) * rec.nb_comps + 2) fail("Error reading MCC marker");
    size -= int64_t(bytes) * rec.nb_comps + 2;
    for (int j = 0; j < rec.nb_comps; j++)
      if (read(bytes) != uint32_t(j)) return;  // "Cannot take in charge collections with indix shuffle"
    n = be16(q);
    q += 2;
    bytes = 1 + int(n >> 15);
    if (int(n & 0x7fff) != rec.nb_comps) return;  // "... without same number of indixes"
    if (size < int64_t(bytes) * rec.nb_comps + 3) fail("Error reading MCC marker");
    size -= int64_t(bytes) * rec.nb_comps + 3;
    for (int j = 0; j < rec.nb_comps; j++)
      if (read(bytes) != uint32_t(j)) return;
    uint32_t t = uint32_t(q[0]) << 16 | be16(q + 1);  // Tmcc: reversibility, offset and decorrelation records
    q += 3;
    rec.deco = rec.offset = -1;
    if (t & 0xff) rec.deco = find_mct(tcp, int(t & 0xff));
    if ((t >> 8) & 0xff) rec.offset = find_mct(tcp, int((t >> 8) & 0xff));
  }
  if (size != 0) fail("Error reading MCC marker");
  if (&rec == &fresh) tcp.mccs.push_back(fresh);
}

// An element of an MCT array as int32, as OpenJPEG's j2k_mct_read_functions_to_int32 convert it on x86-64:
// int16 is read unsigned, int32 wraps, floats truncate (outside int32, and NaN, give INT32_MIN)
int32_t mct_element(const uint8_t* p, int element) {
  double v;
  if (element == 0) return int32_t(be16(p));
  if (element == 1) return int32_t(be32(p));
  if (element == 2) {
    uint32_t bits = be32(p);
    float f;
    memcpy(&f, &bits, 4);
    v = f;
  } else {
    uint64_t bits = uint64_t(be32(p)) << 32 | be32(p + 4);
    memcpy(&v, &bits, 8);
  }
  return v > -2147483649.0 && v < 2147483648.0 ? int32_t(v) : INT32_MIN;
}

// opj_j2k_add_mct: the MCC named by an MCO stage. OpenJPEG's search looks
// at the first record only (its loop never moves on), so only that one is
// ever applied; its offset array becomes the DC level shift.
void add_mct(Tcp& tcp, int index, size_t ncomp) {
  static const size_t element_size[4] = {2, 4, 4, 8};
  if (tcp.mccs.empty() || tcp.mccs[0].index != index) return;  // "element discarded"
  const MccRecord& rec = tcp.mccs[0];
  if (size_t(rec.nb_comps) != ncomp) return;
  if (rec.deco >= 0) {  // read into a matrix that only an MCT of 2 in COD would use, which OpenJPEG refuses
    const MctRecord& d = tcp.mcts[rec.deco];
    if (d.data.size() != element_size[d.element] * ncomp * ncomp)
      fail("Error reading MCO marker (decorrelation array)");
  }
  if (rec.offset >= 0) {
    const MctRecord& o = tcp.mcts[rec.offset];
    if (o.data.size() != element_size[o.element] * ncomp) fail("Error reading MCO marker (offset array)");
    for (size_t c = 0; c < ncomp; c++)
      tcp.tccps[c].dc_shift = mct_element(&o.data[c * element_size[o.element]], o.element);
  }
}

// opj_j2k_read_mco: a stage (Nmco 0 or 1) zeroes every component's DC level shift first
void read_mco(Tcp& tcp, const uint8_t* p, int64_t len, size_t ncomp) {
  if (len < 1) fail("Error reading MCO marker");
  int stages = p[0];
  if (stages > 1) return;  // "Cannot take in charge multiple transformation stages."
  if (len != stages + 1) fail("Error reading MCO marker");
  for (Tccp& t : tcp.tccps) t.dc_shift = 0;
  for (int i = 0; i < stages; i++) add_mct(tcp, p[1 + i], ncomp);
}

// opj_j2k_read_cbd: each component's precision and sign, which the clamp,
// the 9/7 step sizes, the packing and PIL's unpackers take from here on
// (the DC level shift stays the one SIZ set)
void read_cbd(Codestream& cs, const uint8_t* p, int64_t len) {
  size_t n = cs.comps.size();
  if (len != int64_t(n) + 2 || be16(p) != n) fail("Error reading CBD marker");
  for (size_t c = 0; c < n; c++) {
    cs.comps[c].sgnd = p[2 + c] >> 7, cs.comps[c].prec = (p[2 + c] & 0x7f) + 1;
    if (cs.comps[c].prec > 31) fail(fmt("Invalid values for comp = %lld : prec=%lld (CBD)", c, cs.comps[c].prec));
  }
}

// opj_j2k_merge_ppm: the Nppm / Ippm pairs of the PPM segments in Zppm
// order, an Ippm running on into the next segment, into one stream.
void merge_ppm(Codestream& cs) {
  int64_t remaining = 0;
  for (size_t z = 0; z < cs.ppm.segs.size(); z++) {
    if (!cs.ppm.set[z]) continue;
    const std::vector<uint8_t>& seg = cs.ppm.segs[z];
    int64_t size = int64_t(seg.size()), take = std::min(remaining, size), at = take;
    cs.ppm_data.insert(cs.ppm_data.end(), seg.begin(), seg.begin() + take);
    remaining -= take;
    while (at < size) {
      if (size - at < 4) fail("Not enough bytes to read Nppm");
      int64_t nppm = be32(&seg[at]);
      at += 4;
      take = std::min(nppm, size - at);
      cs.ppm_data.insert(cs.ppm_data.end(), seg.begin() + at, seg.begin() + at + take);
      at += take, remaining = nppm - take;
    }
  }
  if (remaining) fail("Corrupted PPM markers");
  if (cs.ppm_data.empty()) fail("Not enough memory to read PPM marker");  // opj_malloc(0) gives NULL
}

bool known_marker(uint32_t m) {  // OpenJPEG's marker table (j2k_memory_marker_handler_tab)
  switch (m) {
    case SOT: case COD: case COC: case RGN: case QCD: case QCC: case POC: case SIZ: case TLM: case PLM:
    case PLT: case PPM: case PPT: case SOP: case CRG: case COM: case CAP: case CPF:
    case MCT: case MCC: case MCO: case CBD:
      return true;
    default:
      return false;
  }
}

[[noreturn]] void misplaced(uint32_t m, bool main) {
  fail(fmt("Marker is not compliant with its position (0x%04llx in the ", m) + (main ? "main header)" : "tile-part header)"));
}

Codestream parse(const uint8_t* d, int64_t n, int64_t ihdr_w, int64_t ihdr_h) {
  Codestream cs;
  if (n < 4 || be16(d) != SOC) fail("Expected a SOC marker");
  if (be16(d + 2) != SIZ) fail("The first marker after SOC must be SIZ");
  int64_t pos = 2;
  bool has_cod = false, has_qcd = false, has_siz = false;
  std::vector<char> coc_set, qcc_set;
  for (;;) {  // main header
    if (pos + 2 > n) fail("Stream too short");
    uint32_t m = be16(d + pos);
    if (m < 0xff00) fail(fmt("We expected read a marker ID (0xff--) instead of %.4llx", m));
    if (m == SOT) break;
    if (!known_marker(m)) {  // opj_j2k_read_unk: on to the next known marker, two bytes at a time
      for (;;) {
        pos += 2;
        if (pos + 2 > n) fail("Stream too short");
        uint32_t next = be16(d + pos);
        if (next >= 0xff00 && known_marker(next)) break;
      }
      continue;
    }
    if (m == SOP || m == PLT || m == PPT || (m == SIZ && has_siz)) misplaced(m, true);
    if (pos + 4 > n) fail("Stream too short");
    int64_t len = be16(d + pos + 2);
    if (len < 2) fail("Inconsistent marker size");
    if (pos + 2 + len > n) fail("Stream too short");
    const uint8_t* p = d + pos + 4;
    if (m == SIZ) {
      if (has_siz) fail("Marker is not compliant with its position (a second SIZ)");
      read_siz(cs, p, len - 2, ihdr_w, ihdr_h);
      has_siz = true;
      coc_set.assign(cs.comps.size(), 0), qcc_set.assign(cs.comps.size(), 0);
    } else if (m == COD || m == COC || m == QCD || m == QCC) {
      read_coding(m, cs.deflt, p, len - 2, cs.comps.size(), coc_set, qcc_set);
      has_cod |= m == COD, has_qcd |= m == QCD;
    } else if (m == RGN) {
      read_rgn(cs.deflt, p, len - 2, cs.comps.size());
    } else if (m == POC) {
      read_poc(cs.deflt, p, len - 2, cs.comps.size());
    } else if (m == PPM) {
      if (len - 2 < 2) fail("Error reading PPM marker");
      cs.has_ppm = true;
      cs.ppm.add(p, len - 2, "Zppm %lld already read");
    } else if (m == MCT) {
      read_mct(cs.deflt, p, len - 2);
    } else if (m == MCC) {
      read_mcc(cs.deflt, p, len - 2);
    } else if (m == MCO) {
      read_mco(cs.deflt, p, len - 2, cs.comps.size());
    } else if (m == CBD) {
      read_cbd(cs, p, len - 2);
    }
    pos += 2 + len;
  }
  if (!has_cod) fail("required COD marker not found in main header");
  if (!has_qcd) fail("required QCD marker not found in main header");
  if (cs.has_ppm) merge_ppm(cs);
  cs.tiles.assign(size_t(cs.tw) * cs.th, Tcp());
  cs.completed.assign(cs.tiles.size(), 0);
  std::vector<char> first_seen(cs.tiles.size(), 0);
  bool last_part = false, ended = false;
  for (;;) {  // tile-parts
    if (pos + 2 > n) fail("Stream too short");
    uint32_t m = be16(d + pos);
    if (m == EOC) break;
    if (m != SOT) fail("Stream too short, expected SOT");
    if (last_part) break;
    if (pos + 2 == n) {  // nothing after the marker: OpenJPEG stops reading there (J2K_STATE_NEOC)
      ended = true;
      break;
    }
    int64_t sot = pos;
    if (pos + 4 > n || be16(d + pos + 2) != 10 || pos + 12 > n) fail("Error reading SOT marker");
    uint32_t isot = be16(d + pos + 4), psot = be32(d + pos + 6);
    int tpsot = d[pos + 10], tnsot = d[pos + 11];
    if (isot >= cs.tiles.size()) fail(fmt("Tile index %lld > number of tiles", isot));
    Tcp& tcp = cs.tiles[isot];
    if (!first_seen[isot]) {
      tcp = cs.deflt;
      first_seen[isot] = 1;
    }
    if (tcp.part + 1 != tpsot) fail(fmt("Invalid tile part index for tile number %lld. Got %lld, expected %lld", isot, tpsot, tcp.part + 1));
    tcp.part = tpsot;
    if (psot != 0 && psot < 14) fail(fmt("Psot value is not correct regards to the JPEG2000 norm: %lld", psot));
    if (psot == 0) last_part = true;
    if (tcp.nb_parts && tpsot >= tcp.nb_parts) fail("In SOT marker, TPSot is not valid regards to the previous number of tile-part");
    if (tnsot) {
      if (tpsot >= tnsot) fail("In SOT marker, TPSot is not valid regards to the current number of tile-part (header)");
      tcp.nb_parts = tnsot;
    }
    pos += 12;
    std::vector<char> coc_here(cs.comps.size(), 0), qcc_here(cs.comps.size(), 0);
    for (;;) {  // tile-part header
      if (pos + 2 > n) fail("Stream too short");
      m = be16(d + pos);
      if (m == SOD) break;
      if (pos + 2 == n) {  // as after SOT
        ended = true;
        break;
      }
      if (m < 0xff00) fail(fmt("We expected read a marker ID (0xff--) instead of %.4llx", m));
      if (pos + 4 > n) fail("Stream too short");
      int64_t len = be16(d + pos + 2);
      if (len < 2) fail("Inconsistent marker size");
      if (pos + 2 + len > n) fail("Stream too short");
      const uint8_t* p = d + pos + 4;
      if (m == COD || m == COC || m == QCD || m == QCC) {
        read_coding(m, tcp, p, len - 2, cs.comps.size(), coc_here, qcc_here);
      } else if (m == RGN) {
        read_rgn(tcp, p, len - 2, cs.comps.size());
      } else if (m == POC) {
        read_poc(tcp, p, len - 2, cs.comps.size());
      } else if (m == PPT) {
        if (len - 2 < 2) fail("Error reading PPT marker");
        if (cs.has_ppm)
          fail("Error reading PPT marker: packet header have been previously found in the main header (PPM marker).");
        tcp.has_ppt = true;
        tcp.ppt.add(p, len - 2, "Zppt %lld already read");
      } else if (m == MCT) {
        read_mct(tcp, p, len - 2);
      } else if (m == MCC) {
        read_mcc(tcp, p, len - 2);
      } else if (m == MCO) {
        read_mco(tcp, p, len - 2, cs.comps.size());
      } else if (m != COM && m != PLT) {
        misplaced(m, false);  // OpenJPEG reads no unknown marker (nor CAP, CPF, CBD) in a tile-part header
      }
      pos += 2 + len;
    }
    if (ended) {  // the tile this SOT completes is decoded after the stream ends
      if (tcp.nb_parts && tpsot + 1 == tcp.nb_parts)
        fail(fmt("Stream too short: tile %lld is decoded after the stream ends", isot));
      break;
    }
    pos += 2;
    int64_t size = psot ? int64_t(psot) - (pos - sot) : n - pos - 2;
    if (size < 0 || size > n - pos) fail("Tile part length size inconsistent with stream length");
    if (size > 0) {
      tcp.parts.push_back({pos, size});
      tcp.data.insert(tcp.data.end(), d + pos, d + pos + size);
      tcp.has_data = true;
    }
    pos += size;
    if (tcp.nb_parts && tpsot + 1 == tcp.nb_parts && !cs.completed[isot]) {  // the tile is complete: decoded now
      cs.order.push_back(int(isot));
      cs.completed[isot] = 1;
    }
    if (last_part) break;  // the two bytes left may be anything (OpenJPEG: "Stream does not end with EOC")
  }
  for (size_t k = 0; k < cs.tiles.size(); k++) {  // then the tiles no tile-part count completed, in index order
    if (cs.completed[k]) continue;
    if (ended && cs.tiles[k].has_data) fail(fmt("Stream too short: tile %lld is decoded after the stream ends", k));
    cs.order.push_back(int(k));
  }
  return cs;
}

// ---- tier 2 ----

struct Bio {
  const uint8_t *start, *end, *bp;
  uint32_t buf = 0;
  int ct = 0;
  Bio(const uint8_t* p, int64_t len) : start(p), end(p + len), bp(p) {}
  void bytein() {
    buf = (buf << 8) & 0xffff;
    ct = buf == 0xff00 ? 7 : 8;
    if (bp < end) buf |= *bp++;
  }
  uint32_t bit() {
    if (ct == 0) bytein();
    ct--;
    return (buf >> ct) & 1;
  }
  uint32_t read(int n) {
    uint32_t v = 0;
    for (int i = n - 1; i >= 0; i--) v |= bit() << i;
    return v;
  }
  void inalign() {
    if ((buf & 0xff) == 0xff) bytein();
    ct = 0;
  }
  int64_t numbytes() const { return bp - start; }
};

struct TagTree {
  std::vector<int> parent;
  std::vector<int32_t> value, low;
  void init(int w, int h) {
    parent.clear();
    std::vector<int> lw{w}, lh{h}, first{0};
    int total = 0;
    for (;;) {
      int nodes = lw.back() * lh.back();
      total += nodes;
      if (nodes <= 1) break;
      lw.push_back((lw.back() + 1) / 2), lh.push_back((lh.back() + 1) / 2), first.push_back(total);
    }
    parent.assign(total, -1);
    for (size_t l = 0; l + 1 < lw.size(); l++)
      for (int j = 0; j < lh[l]; j++)
        for (int i = 0; i < lw[l]; i++) parent[first[l] + j * lw[l] + i] = first[l + 1] + (j / 2) * lw[l + 1] + i / 2;
    value.assign(total, 999), low.assign(total, 0);
  }
  void reset() {
    std::fill(value.begin(), value.end(), 999);
    std::fill(low.begin(), low.end(), 0);
  }
  bool decode(Bio& bio, int leaf, int32_t threshold) {
    int stk[32], depth = 0, node = leaf;
    while (parent[node] >= 0) stk[depth++] = node, node = parent[node];
    int32_t lo = 0;
    for (;;) {
      if (lo > low[node]) low[node] = lo;
      else lo = low[node];
      while (lo < threshold && lo < value[node]) {
        if (bio.bit()) value[node] = lo;
        else ++lo;
      }
      low[node] = lo;
      if (depth == 0) break;
      node = stk[--depth];
    }
    return value[node] < threshold;
  }
};

struct Seg {
  int64_t len = 0;
  uint32_t numpasses = 0, maxpasses = 109, newlen = 0, numnewpasses = 0;
};

struct Cblk {
  int64_t x0, y0, x1, y1;
  int32_t numbps = 0, mb = 0;  // mb: the band's bit-planes when the block was first included (HT's Mb)
  uint32_t numlenbits = 0, numnewpasses = 0, numsegs = 0, numchunks = 0;  // numchunks: empty ones too
  int64_t first_chunk = 0;  // where the first chunk starts in the tile's data
  std::vector<Seg> segs;
  std::vector<uint8_t> data;
  std::vector<std::pair<int64_t, int64_t>> chunks;  // (offset in the tile's data, length), the non-empty ones
};

struct Precinct {
  int64_t x0, y0, x1, y1;
  int cw = 0, ch = 0;
  std::vector<Cblk> cblks;
  TagTree incl, imsb;
};

struct Band {
  int bandno = 0;
  int64_t x0, y0, x1, y1;
  int32_t numbps = 0;
  float stepsize = 0;
  std::vector<Precinct> precs;
  bool empty() const { return x1 - x0 == 0 || y1 - y0 == 0; }
};

struct Res {
  int64_t x0, y0, x1, y1, cbgx0 = 0, cbgy0 = 0;
  int pw = 0, ph = 0, pdx = 0, pdy = 0, numbands = 0, cbgw = 0, cbgh = 0;
  Band bands[3];
};

union Sample {
  int32_t i;
  float f;
};

struct TileComp {
  int64_t x0, y0, x1, y1;
  int numres = 0;
  std::vector<Res> res;
  std::vector<Sample> data;
};

// opj_t2_init_seg: a segment's most passes by the code-block style (with
// BYPASS 10, then 2 and 1 by turns; with TERMALL 1)
void init_seg(Cblk& cb, uint32_t index, int cblksty, bool first) {
  if (cb.segs.size() < index + 1) cb.segs.resize(index + 1);
  uint32_t before = index ? cb.segs[index - 1].maxpasses : 0;
  Seg& seg = cb.segs[index];
  seg = Seg();
  if (cblksty & 4) seg.maxpasses = 1;
  else if (cblksty & 1) seg.maxpasses = first ? 10 : (before == 1 || before == 10) ? 2 : 1;
}

uint32_t num_passes(Bio& bio) {
  if (!bio.read(1)) return 1;
  if (!bio.read(1)) return 2;
  uint32_t n = bio.read(2);
  if (n != 3) return 3 + n;
  n = bio.read(5);
  if (n != 31) return 6 + n;
  return 37 + bio.read(7);
}

int floorlog2(uint32_t a) {
  int l = 0;
  while (a > 1) a >>= 1, ++l;
  return l;
}

// Packet headers packed in PPM or PPT segments, and where the next one starts
struct Headers {
  const uint8_t* data;
  int64_t size, pos = 0;
};

// One packet (opj_t2_read_packet_header, opj_t2_read_packet_data in strict
// mode); returns the bytes it spans in the tile's data. Its header is read
// from `packed` where the headers are packed, else from the data.
int64_t read_packet(Res& res, int precno, int layno, const uint8_t* src, int64_t max_len, int64_t src_off,
                    int compno, int resno, int csty, int cblksty, Headers* packed) {
  if (layno == 0) {
    for (int b = 0; b < res.numbands; b++) {
      Band& band = res.bands[b];
      if (band.empty()) continue;
      if (precno >= int(band.precs.size())) fail("Invalid precinct");
      Precinct& pr = band.precs[precno];
      pr.incl.reset(), pr.imsb.reset();
      for (Cblk& cb : pr.cblks) cb.numsegs = 0;
    }
  }
  int64_t pos = 0;
  // SOP: skipped where it stands (OpenJPEG warns where it does not)
  if ((csty & 2) && max_len >= 6 && src[0] == 0xff && src[1] == 0x91) pos += 6;
  const uint8_t* hdr = packed ? packed->data + packed->pos : src + pos;
  int64_t hdr_room = packed ? packed->size - packed->pos : max_len - pos;
  Bio bio(hdr, hdr_room);
  bool present = bio.read(1) != 0;
  if (present) {
    for (int b = 0; b < res.numbands; b++) {
      Band& band = res.bands[b];
      if (band.empty()) continue;
      Precinct& pr = band.precs[precno];
      for (int k = 0; k < int(pr.cblks.size()); k++) {
        Cblk& cb = pr.cblks[k];
        bool included = cb.numsegs == 0 ? pr.incl.decode(bio, k, layno + 1) : bio.read(1) != 0;
        if (!included) {
          cb.numnewpasses = 0;
          continue;
        }
        if (cb.numsegs == 0) {
          int32_t i = 0;
          while (!pr.imsb.decode(bio, k, i)) ++i;
          cb.mb = band.numbps;
          cb.numbps = int32_t(uint32_t(band.numbps) + 1u - uint32_t(i));
          cb.numlenbits = 3;
        }
        cb.numnewpasses = num_passes(bio);
        uint32_t increment = 0;
        while (bio.read(1)) ++increment;
        cb.numlenbits += increment;
        uint32_t segno = 0;
        if (cb.numsegs == 0) {
          init_seg(cb, 0, cblksty, true);
        } else {
          segno = cb.numsegs - 1;
          if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) init_seg(cb, ++segno, cblksty, false);
        }
        int64_t left = cb.numnewpasses;
        do {
          Seg& seg = cb.segs[segno];
          if (cblksty & HT)  // the cleanup segment takes one pass, the next segment the rest
            seg.numnewpasses = segno == 0 ? 1 : uint32_t(left);
          else
            seg.numnewpasses = uint32_t(std::min<int64_t>(int64_t(seg.maxpasses) - seg.numpasses, left));
          uint32_t bits = cb.numlenbits + floorlog2(seg.numnewpasses);
          if (bits > 32) fail(fmt("Invalid bit number %lld in opj_t2_read_packet_header()", bits));
          seg.newlen = bio.read(int(bits));
          left -= seg.numnewpasses;
          if (left > 0) init_seg(cb, ++segno, cblksty, false);
        } while (left > 0);
      }
    }
  }
  bio.inalign();
  int64_t hdr_len = bio.numbytes();
  if (csty & 4) {  // EPH: strict mode fails where it is missing
    if (hdr_room - hdr_len < 2) fail("Not enough space for expected EPH marker");
    if (hdr[hdr_len] != 0xff || hdr[hdr_len + 1] != 0x92) fail("Expected EPH marker");
    hdr_len += 2;
  }
  if (packed) packed->pos += hdr_len;
  else pos += hdr_len;
  if (!present) return pos;
  for (int b = 0; b < res.numbands; b++) {  // the packet body
    Band& band = res.bands[b];
    if (band.empty()) continue;
    Precinct& pr = band.precs[precno];
    for (int k = 0; k < int(pr.cblks.size()); k++) {
      Cblk& cb = pr.cblks[k];
      if (!cb.numnewpasses) continue;
      uint32_t s;
      if (!cb.numsegs) {
        s = 0, cb.numsegs = 1;
      } else {
        s = cb.numsegs - 1;
        if (cb.segs[s].numpasses == cb.segs[s].maxpasses) ++s, ++cb.numsegs;
      }
      do {
        Seg& seg = cb.segs[s];
        if (pos + int64_t(seg.newlen) > max_len)
          fail(fmt("read: segment too long (%lld) with max (%lld) for codeblock %lld", seg.newlen, max_len, k) +
               fmt(" (p=%lld, b=%lld, r=%lld", precno, b, resno) + fmt(", c=%lld)", compno));
        cb.data.insert(cb.data.end(), src + pos, src + pos + seg.newlen);
        if (seg.newlen) cb.chunks.push_back({src_off + pos, seg.newlen});
        if (cb.numchunks++ == 0) cb.first_chunk = src_off + pos;
        pos += seg.newlen;
        seg.len += seg.newlen;
        seg.numpasses += seg.numnewpasses;
        cb.numnewpasses -= seg.numnewpasses;
        if (cb.numnewpasses > 0) ++s, ++cb.numsegs;
      } while (cb.numnewpasses > 0);
    }
  }
  return pos;
}

// The tile's geometry (opj_tcd_init_tile, decoding)
void init_tile(const Codestream& cs, const Tcp& tcp, int tileno, std::vector<TileComp>& comps, int64_t t[4]) {
  int p = tileno % cs.tw, q = tileno / cs.tw;
  t[0] = std::max<int64_t>(cs.tx0 + p * cs.tdx, cs.x0), t[1] = std::max<int64_t>(cs.ty0 + q * cs.tdy, cs.y0);
  t[2] = std::min<int64_t>(cs.tx0 + (p + 1) * cs.tdx, cs.x1), t[3] = std::min<int64_t>(cs.ty0 + (q + 1) * cs.tdy, cs.y1);
  comps.assign(cs.comps.size(), TileComp());
  for (size_t c = 0; c < cs.comps.size(); c++) {
    const Tccp& tccp = tcp.tccps[c];
    TileComp& tc = comps[c];
    tc.x0 = ceildiv(t[0], cs.comps[c].dx), tc.y0 = ceildiv(t[1], cs.comps[c].dy);
    tc.x1 = ceildiv(t[2], cs.comps[c].dx), tc.y1 = ceildiv(t[3], cs.comps[c].dy);
    tc.numres = tccp.numres;
    tc.res.assign(tc.numres, Res());
    int step = 0;
    for (int r = 0; r < tc.numres; r++) {
      Res& res = tc.res[r];
      int level = tc.numres - 1 - r;
      res.x0 = ceildivpow2(tc.x0, level), res.y0 = ceildivpow2(tc.y0, level);
      res.x1 = ceildivpow2(tc.x1, level), res.y1 = ceildivpow2(tc.y1, level);
      int pdx = res.pdx = tccp.prcw[r], pdy = res.pdy = tccp.prch[r];
      int64_t px0 = floordivpow2(res.x0, pdx) << pdx, py0 = floordivpow2(res.y0, pdy) << pdy;
      int64_t px1 = ceildivpow2(res.x1, pdx) << pdx, py1 = ceildivpow2(res.y1, pdy) << pdy;
      res.pw = res.x0 == res.x1 ? 0 : int((px1 - px0) >> pdx);
      res.ph = res.y0 == res.y1 ? 0 : int((py1 - py0) >> pdy);
      int64_t cbgx0, cbgy0;
      int cbgw, cbgh;
      if (r == 0) {
        cbgx0 = px0, cbgy0 = py0, cbgw = pdx, cbgh = pdy, res.numbands = 1;
      } else {
        cbgx0 = ceildivpow2(px0, 1), cbgy0 = ceildivpow2(py0, 1), cbgw = pdx - 1, cbgh = pdy - 1, res.numbands = 3;
      }
      res.cbgx0 = cbgx0, res.cbgy0 = cbgy0, res.cbgw = cbgw, res.cbgh = cbgh;
      int cbw = std::min(tccp.cblkw, cbgw), cbh = std::min(tccp.cblkh, cbgh);
      for (int b = 0; b < res.numbands; b++, step++) {
        Band& band = res.bands[b];
        if (r == 0) {
          band.bandno = 0;
          band.x0 = ceildivpow2(tc.x0, level), band.y0 = ceildivpow2(tc.y0, level);
          band.x1 = ceildivpow2(tc.x1, level), band.y1 = ceildivpow2(tc.y1, level);
        } else {
          band.bandno = b + 1;
          int64_t xb = band.bandno & 1, yb = band.bandno >> 1;
          band.x0 = ceildivpow2(tc.x0 - (xb << level), level + 1), band.y0 = ceildivpow2(tc.y0 - (yb << level), level + 1);
          band.x1 = ceildivpow2(tc.x1 - (xb << level), level + 1), band.y1 = ceildivpow2(tc.y1 - (yb << level), level + 1);
        }
        const StepSize& ss = tccp.steps[std::min(step, 96)];
        int gain = tccp.qmfbid == 0 ? 0 : band.bandno == 0 ? 0 : band.bandno == 3 ? 2 : 1;
        int rb = cs.comps[c].prec + gain;
        band.stepsize = float((1.0 + ss.mant / 2048.0) * pow(2.0, double(rb - ss.expn)));
        band.numbps = ss.expn + tccp.numgbits - 1;
        if (band.empty()) continue;  // OpenJPEG keeps no precincts of an empty band
        int64_t nprec = int64_t(res.pw) * res.ph;
        if (nprec > (1 << 24)) fail("Size of tile data exceeds system limits");
        band.precs.assign(size_t(nprec), Precinct());
        for (int64_t k = 0; k < nprec; k++) {
          Precinct& pr = band.precs[k];
          int64_t gx0 = cbgx0 + (k % res.pw) * (int64_t(1) << cbgw), gy0 = cbgy0 + (k / res.pw) * (int64_t(1) << cbgh);
          pr.x0 = std::max(gx0, band.x0), pr.y0 = std::max(gy0, band.y0);
          pr.x1 = std::min(gx0 + (int64_t(1) << cbgw), band.x1), pr.y1 = std::min(gy0 + (int64_t(1) << cbgh), band.y1);
          int64_t bx0 = floordivpow2(pr.x0, cbw) << cbw, by0 = floordivpow2(pr.y0, cbh) << cbh;
          int64_t bx1 = ceildivpow2(pr.x1, cbw) << cbw, by1 = ceildivpow2(pr.y1, cbh) << cbh;
          pr.cw = int(std::max<int64_t>(0, (bx1 - bx0) >> cbw)), pr.ch = int(std::max<int64_t>(0, (by1 - by0) >> cbh));
          pr.cblks.assign(size_t(pr.cw) * pr.ch, Cblk());
          for (int j = 0; j < pr.cw * pr.ch; j++) {
            Cblk& cb = pr.cblks[j];
            int64_t x = bx0 + int64_t(j % pr.cw << cbw), y = by0 + int64_t(j / pr.cw << cbh);
            cb.x0 = std::max(x, pr.x0), cb.y0 = std::max(y, pr.y0);
            cb.x1 = std::min(x + (int64_t(1) << cbw), pr.x1), cb.y1 = std::min(y + (int64_t(1) << cbh), pr.y1);
          }
          if (pr.cw > 0 && pr.ch > 0) pr.incl.init(pr.cw, pr.ch), pr.imsb.init(pr.cw, pr.ch);
        }
      }
    }
  }
}

// opj_tcd_is_subband_area_of_interest with the whole image for the window
// (PIL sets none): whether precinct `p` of band `b` of resolution `r` (its
// bounds clipped to the band as opj_tcd_init_tile clips them, an empty
// band's too) meets the tile-component, widened by the filter's margin.
bool area_of_interest(const TileComp& tc, int r, const Band& band, int p, int qmfbid) {
  const Res& res = tc.res[r];
  int64_t gx0 = res.cbgx0 + (p % res.pw) * (int64_t(1) << res.cbgw);
  int64_t gy0 = res.cbgy0 + (p / res.pw) * (int64_t(1) << res.cbgh);
  uint64_t px0 = uint64_t(std::max(gx0, band.x0)), py0 = uint64_t(std::max(gy0, band.y0));
  uint64_t px1 = uint64_t(std::min(gx0 + (int64_t(1) << res.cbgw), band.x1));
  uint64_t py1 = uint64_t(std::min(gy0 + (int64_t(1) << res.cbgh), band.y1));
  uint64_t margin = qmfbid == 1 ? 2 : 3;
  int nb = r == 0 ? tc.numres - 1 : tc.numres - r;
  auto map = [&](int64_t v, int b) -> uint64_t {
    if (nb == 0) return uint64_t(v);
    uint64_t off = (uint64_t(1) << (nb - 1)) * uint64_t(b);
    return uint64_t(v) <= off ? 0 : uint64_t(ceildivpow2(int64_t(uint64_t(v) - off), nb));
  };
  int xb = band.bandno & 1, yb = band.bandno >> 1;
  uint64_t tbx0 = map(tc.x0, xb), tby0 = map(tc.y0, yb), tbx1 = map(tc.x1, xb) + margin, tby1 = map(tc.y1, yb) + margin;
  tbx0 = tbx0 < margin ? 0 : tbx0 - margin, tby0 = tby0 < margin ? 0 : tby0 - margin;
  return px0 < tbx1 && py0 < tby1 && px1 > tbx0 && py1 > tby0;
}

// The packets of one tile in its progression order (opj_pi_next_lrcp,
// _rlcp, _rpcl, _pcrl, _cprl), or in the order of its POC entries (each
// over layers 0 to LYE, OpenJPEG's include array reading a packet once);
// `resno_decoded` keeps the highest resolution read of each component, as
// opj_t2_decode_packets keeps it: a packet none of whose precincts is in
// the area of interest is skipped (its header read; it holds no
// code-block), and a component whose first packet in a POC entry is
// skipped while nothing was read of it takes its top resolution.
void tier2(const Codestream& cs, const Tcp& tcp, std::vector<TileComp>& comps, const int64_t t[4],
           const uint8_t* data, int64_t len, int64_t data_off, Headers* packed, std::vector<int>& resno_decoded) {
  int ncomp = int(comps.size()), maxres = 0;
  int64_t maxprec = 0;
  for (TileComp& tc : comps) {
    maxres = std::max(maxres, tc.numres);
    for (Res& r : tc.res) maxprec = std::max(maxprec, int64_t(r.pw) * r.ph);
  }
  int64_t step_c = maxprec, step_r = step_c * ncomp, step_l = step_r * maxres;
  if (step_l * (tcp.numlayers + 1) > (int64_t(1) << 31)) fail("Size of tile data exceeds system limits");
  std::vector<uint8_t> include(size_t(step_l * tcp.numlayers), 0);
  int64_t pos = 0;
  std::vector<char> first_pass_failed(ncomp);
  auto packet = [&](int l, int r, int c, int p) {
    size_t index = size_t(l * step_l + r * step_r + c * step_c + p);
    if (include[index]) return;
    include[index] = 1;
    Res& res = comps[c].res[r];
    bool skipped = true;
    for (int b = 0; b < res.numbands && skipped; b++)
      skipped = !area_of_interest(comps[c], r, res.bands[b], p, tcp.tccps[c].qmfbid);
    pos += read_packet(res, p, l, data + pos, len - pos, data_off + pos, c, r, tcp.csty, tcp.tccps[c].cblksty, packed);
    if (!skipped) first_pass_failed[c] = 0, resno_decoded[c] = std::max(resno_decoded[c], r);
    if (first_pass_failed[c] && resno_decoded[c] == 0) resno_decoded[c] = comps[c].numres - 1;
  };
  auto position = [&](int c, int r, uint64_t x, uint64_t y, int l_all) {
    // one precinct of (component, resolution) at reference-grid (x, y), if it starts there
    const TileComp& tc = comps[c];
    if (r >= tc.numres) return;
    const Res& res = tc.res[r];
    const uint32_t cdx = uint32_t(cs.comps[c].dx), cdy = uint32_t(cs.comps[c].dy);
    uint32_t level = uint32_t(tc.numres - 1 - r);  // at most 32, the precinct exponents 15: 64-bit tests
    uint64_t dx = uint64_t(cdx) << level, dy = uint64_t(cdy) << level;
    uint64_t trx0 = ceildiv(t[0], dx), try0 = ceildiv(t[1], dy), trx1 = ceildiv(t[2], dx), try1 = ceildiv(t[3], dy);
    uint32_t rpx = uint32_t(res.pdx) + level, rpy = uint32_t(res.pdy) + level;
    if (!(y % (uint64_t(cdy) << rpy) == 0 || (y == uint64_t(t[1]) && ((try0 << level) % (uint64_t(1) << rpy)))))
      return;
    if (!(x % (uint64_t(cdx) << rpx) == 0 || (x == uint64_t(t[0]) && ((trx0 << level) % (uint64_t(1) << rpx)))))
      return;
    if (res.pw == 0 || res.ph == 0 || trx0 == trx1 || try0 == try1) return;
    uint64_t prci = (ceildiv(x, dx) >> res.pdx) - (trx0 >> res.pdx);
    uint64_t prcj = (ceildiv(y, dy) >> res.pdy) - (try0 >> res.pdy);
    int precno = int(prci + prcj * res.pw);
    if (precno >= res.pw * res.ph) fail("Invalid access to pi->include");
    for (int l = 0; l < l_all; l++) packet(l, r, c, precno);
  };
  auto steps = [&](int c0, int c1) {  // the smallest precinct step on the grid over components [c0, c1)
    uint64_t sx = 0, sy = 0;
    for (int c = c0; c < c1; c++) {
      const TileComp& tc = comps[c];
      const uint32_t cdx = uint32_t(cs.comps[c].dx), cdy = uint32_t(cs.comps[c].dy);
      for (int r = 0; r < tc.numres; r++) {
        int level = tc.numres - 1 - r;
        const Res& res = tc.res[r];
        if (res.pdx + level < 32 && cdx <= UINT32_MAX / (1u << (res.pdx + level))) {
          uint64_t d = uint64_t(cdx) << (res.pdx + level);
          sx = sx ? std::min(sx, d) : d;
        }
        if (res.pdy + level < 32 && cdy <= UINT32_MAX / (1u << (res.pdy + level))) {
          uint64_t d = uint64_t(cdy) << (res.pdy + level);
          sy = sy ? std::min(sy, d) : d;
        }
      }
    }
    return std::make_pair(sx, sy);
  };
  std::vector<Poc> entries;  // opj_pi_update_decode_poc / _not_poc
  if (tcp.poc) {
    for (Poc e : tcp.pocs) {
      e.lye = std::min(e.lye, tcp.numlayers);
      entries.push_back(e);
    }
  } else {
    if (tcp.prg < 0) fail("Unknown progression order in COD marker");
    entries.push_back({0, 0, tcp.numlayers, maxres, ncomp, tcp.prg});
  }
  uint64_t tx0 = t[0], ty0 = t[1], tx1 = t[2], ty1 = t[3];
  for (const Poc& e : entries) {
    int L = e.lye, r0 = e.rs, r1 = e.re, c0 = e.cs, c1 = e.ce;
    std::fill(first_pass_failed.begin(), first_pass_failed.end(), 1);
    if (c0 >= ncomp || e.prg > 4) continue;  // opj_pi_next_*: no packet
    switch (e.prg) {
      case 0:  // LRCP
        for (int l = 0; l < L; l++)
          for (int r = r0; r < r1; r++)
            for (int c = c0; c < c1; c++)
              if (r < comps[c].numres)
                for (int p = 0; p < comps[c].res[r].pw * comps[c].res[r].ph; p++) packet(l, r, c, p);
        break;
      case 1:  // RLCP
        for (int r = r0; r < r1; r++)
          for (int l = 0; l < L; l++)
            for (int c = c0; c < c1; c++)
              if (r < comps[c].numres)
                for (int p = 0; p < comps[c].res[r].pw * comps[c].res[r].ph; p++) packet(l, r, c, p);
        break;
      case 2: {  // RPCL
        auto [sx, sy] = steps(0, ncomp);
        if (!sx || !sy) break;
        for (int r = r0; r < r1; r++)
          for (uint64_t y = ty0; y < ty1; y += sy - y % sy)
            for (uint64_t x = tx0; x < tx1; x += sx - x % sx)
              for (int c = c0; c < c1; c++) position(c, r, x, y, L);
        break;
      }
      case 3: {  // PCRL
        auto [sx, sy] = steps(0, ncomp);
        if (!sx || !sy) break;
        for (uint64_t y = ty0; y < ty1; y += sy - y % sy)
          for (uint64_t x = tx0; x < tx1; x += sx - x % sx)
            for (int c = c0; c < c1; c++)
              for (int r = r0; r < std::min(r1, comps[c].numres); r++) position(c, r, x, y, L);
        break;
      }
      default: {  // CPRL
        for (int c = c0; c < c1; c++) {
          auto [sx, sy] = steps(c, c + 1);
          if (!sx || !sy) break;
          for (uint64_t y = ty0; y < ty1; y += sy - y % sy)
            for (uint64_t x = tx0; x < tx1; x += sx - x % sx)
              for (int r = r0; r < std::min(r1, comps[c].numres); r++) position(c, r, x, y, L);
        }
      }
    }
  }
}

// ---- tier 1 ----

struct MqState {
  uint16_t qe;
  uint8_t nmps, nlps, sw;
};

const MqState MQ_TABLE[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},   {0x0ac1, 4, 12, 0},  {0x0521, 5, 29, 0},
    {0x0221, 38, 33, 0}, {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},  {0x3801, 10, 14, 0},
    {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0}, {0x1c01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0}, {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0},
    {0x3001, 21, 19, 0}, {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0}, {0x1c01, 25, 22, 0},
    {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0}, {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0ac1, 31, 28, 0}, {0x09c1, 32, 29, 0}, {0x08a1, 33, 30, 0}, {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0},
    {0x02a1, 36, 33, 0}, {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0}, {0x0085, 40, 37, 0},
    {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0}, {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0},
};

enum { CTX_SC = 9, CTX_MAG = 14, CTX_AGG = 17, CTX_UNI = 18, NCTX = 19 };

// The MQ decoder as OpenJPEG's opj_mqc_* macros run it, and its raw
// (bypass) decoder on the same registers, as OpenJPEG's opj_mqc_t holds them;
// each segment is followed by 0xFF 0xFF, which stops the byte input.
struct Mq {
  const uint8_t* bp;
  uint32_t a = 0, c = 0;
  int ct = 0;
  uint8_t state[NCTX], mps[NCTX];
  void reset_states() {
    memset(state, 0, sizeof state), memset(mps, 0, sizeof mps);
    state[CTX_UNI] = 46, state[CTX_AGG] = 3, state[0] = 4;
  }
  void bytein() {
    if (*bp == 0xff) {
      if (bp[1] > 0x8f) {
        c += 0xff00, ct = 8;
      } else {
        bp++, c += uint32_t(*bp) << 9, ct = 7;
      }
    } else {
      bp++, c += uint32_t(*bp) << 8, ct = 8;
    }
  }
  void init(const uint8_t* p, int64_t len) {
    bp = p;
    c = len == 0 ? 0xffu << 16 : uint32_t(*bp) << 16;
    bytein();
    c <<= 7, ct -= 7, a = 0x8000;
  }
  void raw_init(const uint8_t* p) { bp = p, c = 0, ct = 0; }
  int raw() {  // opj_mqc_raw_decode: 7 bits in the byte after 0xFF; 0xFF 0x90.. repeats the 0xFF
    if (ct == 0) {
      if (c == 0xff) {
        if (*bp > 0x8f) {
          c = 0xff, ct = 8;
        } else {
          c = *bp++, ct = 7;
        }
      } else {
        c = *bp++, ct = 8;
      }
    }
    ct--;
    return int(c >> ct) & 1;
  }
  void renorm() {
    do {
      if (ct == 0) bytein();
      a <<= 1, c <<= 1, ct--;
    } while (a < 0x8000);
  }
  int decode(int cx) {
    const MqState& s = MQ_TABLE[state[cx]];
    int d;
    a -= s.qe;
    if ((c >> 16) < s.qe) {
      if (a < s.qe) {
        d = mps[cx], state[cx] = s.nmps;
      } else {
        d = !mps[cx];
        if (s.sw) mps[cx] = uint8_t(!mps[cx]);
        state[cx] = s.nlps;
      }
      a = s.qe;
      renorm();
    } else {
      c -= uint32_t(s.qe) << 16;
      if ((a & 0x8000) == 0) {
        if (a < s.qe) {
          d = !mps[cx];
          if (s.sw) mps[cx] = uint8_t(!mps[cx]);
          state[cx] = s.nlps;
        } else {
          d = mps[cx], state[cx] = s.nmps;
        }
        renorm();
      } else {
        d = mps[cx];
      }
    }
    return d;
  }
};

// per-sample flags: the 8 neighbours' significance, the 4 direct
// neighbours' signs, the sample's own state
enum : uint32_t {
  NB_NW = 1u << 0, NB_N = 1u << 1, NB_NE = 1u << 2, NB_W = 1u << 3, NB_E = 1u << 4, NB_SW = 1u << 5,
  NB_S = 1u << 6, NB_SE = 1u << 7, NEG_N = 1u << 8, NEG_W = 1u << 9, NEG_E = 1u << 10, NEG_S = 1u << 11,
  SIG = 1u << 12, VISIT = 1u << 13, REFINED = 1u << 14, NB_ALL = 0xff,
};

struct Luts {
  uint8_t zc[4][256];
  uint8_t sc[256];  // context | xor bit << 7, indexed by the direct neighbours' significance and sign bits
  Luts() {
    for (int o = 0; o < 4; o++)
      for (int f = 0; f < 256; f++) {
        int h = !!(f & NB_W) + !!(f & NB_E), v = !!(f & NB_N) + !!(f & NB_S);
        int dg = !!(f & NB_NW) + !!(f & NB_NE) + !!(f & NB_SW) + !!(f & NB_SE);
        int n;
        if (o == 3) {
          int hv = h + v;
          if (dg >= 3) n = 8;
          else if (dg == 2) n = hv >= 1 ? 7 : 6;
          else if (dg == 1) n = hv >= 2 ? 5 : hv == 1 ? 4 : 3;
          else n = hv >= 2 ? 2 : hv;
        } else {
          if (o == 1) std::swap(h, v);  // HL (horizontally high-pass): vertical neighbours lead
          if (h == 2) n = 8;
          else if (h == 1) n = v >= 1 ? 7 : dg >= 1 ? 6 : 5;
          else n = v == 2 ? 4 : v == 1 ? 3 : dg >= 2 ? 2 : dg;
        }
        zc[o][f] = uint8_t(n);
      }
    for (int f = 0; f < 256; f++) {  // bits: sig N, W, E, S; neg N, W, E, S
      auto contrib = [&](int sigbit, int negbit) { return (f >> sigbit & 1) ? ((f >> negbit & 1) ? -1 : 1) : 0; };
      int h = contrib(1, 5) + contrib(2, 6), v = contrib(0, 4) + contrib(3, 7);
      h = std::max(-1, std::min(1, h)), v = std::max(-1, std::min(1, v));
      int ctx, x = 0;
      if (h == 0 && v == 0) ctx = 9;
      else if (h == 0) ctx = 10, x = v < 0;
      else ctx = (h * v > 0 ? 13 : h * v < 0 ? 11 : 12), x = h < 0;
      sc[f] = uint8_t(ctx | x << 7);
    }
  }
};

const Luts LUTS;

inline int sc_index(uint32_t f) {
  return int(!!(f & NB_N)) | int(!!(f & NB_W)) << 1 | int(!!(f & NB_E)) << 2 | int(!!(f & NB_S)) << 3 |
         int(!!(f & NEG_N)) << 4 | int(!!(f & NEG_W)) << 5 | int(!!(f & NEG_E)) << 6 | int(!!(f & NEG_S)) << 7;
}

struct T1 {
  int w, h, stride;
  bool vsc = false;
  std::vector<uint32_t> flags;
  std::vector<int32_t> data;
  const uint8_t* zc;
  Mq mq;

  // y: the sample's row; with VSC a stripe's first row leaves the row above
  // unaware of it (opj_t1_update_flags)
  void set_sig(int i, int y, int neg) {
    uint32_t* f = &flags[i];
    const uint32_t n = neg ? ~0u : 0u;
    f[0] |= SIG;
    if (!(vsc && y % 4 == 0)) f[-stride - 1] |= NB_SE, f[-stride] |= NB_S | (NEG_S & n), f[-stride + 1] |= NB_SW;
    f[-1] |= NB_E | (NEG_E & n), f[1] |= NB_W | (NEG_W & n);
    f[stride - 1] |= NB_NE, f[stride] |= NB_N | (NEG_N & n), f[stride + 1] |= NB_NW;
  }
  int sign(uint32_t f) {
    uint8_t s = LUTS.sc[sc_index(f)];
    return mq.decode(s & 0x7f) ^ (s >> 7);
  }
  void become_sig(int i, int d, int y, int32_t oneplushalf) {
    int neg = sign(flags[i]);
    data[d] = neg ? -oneplushalf : oneplushalf;
    set_sig(i, y, neg);
  }
  template <class F>
  void scan(F f) {
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; x++)
        for (int y = k; y < std::min(k + 4, h); y++) f((y + 1) * stride + x + 1, y * w + x, y);
  }
  template <bool RAW>
  void sigpass(int bp) {
    int32_t one = 1 << bp, oph = one | (one >> 1);
    scan([&](int i, int d, int y) {
      uint32_t f = flags[i];
      if (!(f & (SIG | VISIT)) && (f & NB_ALL)) {
        if (RAW) {
          if (mq.raw()) {
            int neg = mq.raw();
            data[d] = neg ? -oph : oph;
            set_sig(i, y, neg);
          }
        } else if (mq.decode(zc[f & NB_ALL])) {
          become_sig(i, d, y, oph);
        }
        flags[i] |= VISIT;
      }
    });
  }
  template <bool RAW>
  void refpass(int bp) {
    int32_t poshalf = (1 << bp) >> 1;
    scan([&](int i, int d, int) {
      uint32_t f = flags[i];
      if ((f & (SIG | VISIT)) == SIG) {
        int v = RAW ? mq.raw() : mq.decode((f & REFINED) ? CTX_MAG + 2 : (f & NB_ALL) ? CTX_MAG + 1 : CTX_MAG);
        data[d] += (v ^ (data[d] < 0)) ? poshalf : -poshalf;
        flags[i] |= REFINED;
      }
    });
  }
  void clnpass(int bp, bool segsym) {
    int32_t one = 1 << bp, oph = one | (one >> 1);
    auto step = [&](int i, int d, int y) {
      uint32_t f = flags[i];
      if (!(f & (SIG | VISIT)) && mq.decode(zc[f & NB_ALL])) become_sig(i, d, y, oph);
    };
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; x++) {
        int i0 = (k + 1) * stride + x + 1, d0 = k * w + x, y0 = 0;
        if (k + 3 < h) {
          const uint32_t mask = SIG | VISIT | NB_ALL;
          if (!(flags[i0] & mask) && !(flags[i0 + stride] & mask) && !(flags[i0 + 2 * stride] & mask) &&
              !(flags[i0 + 3 * stride] & mask)) {
            if (!mq.decode(CTX_AGG)) continue;
            int run = mq.decode(CTX_UNI) << 1;
            run |= mq.decode(CTX_UNI);
            become_sig(i0 + run * stride, d0 + run * w, k + run, oph);
            y0 = run + 1;
          }
        }
        for (int y = y0; y < 4 && k + y < h; y++) step(i0 + y * stride, d0 + y * w, k + y);
      }
    for (uint32_t& f : flags) f &= ~VISIT;
    if (segsym)  // the segmentation symbol: OpenJPEG decodes it and does not check it
      for (int k = 0; k < 4; k++) mq.decode(CTX_UNI);
  }
  // opj_t1_decode_cblk: the ROI shift counted in the bit-planes; BYPASS
  // decides each segment's coder at its first pass
  void decode(const Cblk& cb, int orient, int cblksty, int roishift) {
    w = int(cb.x1 - cb.x0), h = int(cb.y1 - cb.y0), stride = w + 2;
    vsc = (cblksty & VSC) != 0;
    flags.assign(size_t(stride) * (h + 2), 0);
    data.assign(size_t(w) * h, 0);
    zc = LUTS.zc[orient];
    int32_t bp = int32_t(uint32_t(roishift) + uint32_t(cb.numbps));
    if (bp >= 31) fail(fmt("opj_t1_decode_cblk(): unsupported bpno_plus_one = %lld >= 31", bp));
    mq.reset_states();
    int passtype = 2;
    int64_t at = 0;
    std::vector<uint8_t> seg_data;
    for (uint32_t s = 0; s < cb.numsegs; s++) {
      const Seg& seg = cb.segs[s];
      seg_data.assign(cb.data.begin() + at, cb.data.begin() + at + seg.len);
      seg_data.push_back(0xff), seg_data.push_back(0xff);
      at += seg.len;
      bool raw = (cblksty & BYPASS) && passtype < 2 && int64_t(bp) <= int64_t(cb.numbps) - 4;
      if (raw) mq.raw_init(seg_data.data());
      else mq.init(seg_data.data(), seg.len);
      for (uint32_t p = 0; p < seg.numpasses && bp >= 1; p++) {
        if (passtype == 0) raw ? sigpass<true>(bp) : sigpass<false>(bp);
        else if (passtype == 1) raw ? refpass<true>(bp) : refpass<false>(bp);
        else clnpass(bp, (cblksty & SEGSYM) != 0);
        if ((cblksty & RESET) && !raw) mq.reset_states();
        if (++passtype == 3) passtype = 0, bp--;
      }
    }
    if (roishift) {  // opj_t1_clbl_decode_processor: magnitudes at or above 1 << roishift scaled down
      for (int32_t& v : data) {
        if (roishift >= 31) {
          v = 0;
        } else {
          int32_t mag = v < 0 ? -v : v;
          if (mag >= (int32_t(1) << roishift)) mag >>= roishift, v = v < 0 ? -mag : mag;
        }
      }
    }
  }
};

// ---- the HT block decoder (ITU-T T.814), as OpenJPEG 2.5's ht_dec.c ----
//
// The cleanup segment holds MagSgn (read forward from its start), then MEL
// (forward) and VLC (backward from its end) in its last Scup bytes; the
// refinement segment SigProp (forward) and MagRef (backward). Each reader
// takes bytes as OpenJPEG's does (4 at a time after its first 1 to 4,
// which depend on the address modulo 4: `align` is the data's), with its
// bit-unstuffing rule; the sample values are sign | magnitude << 1 | the
// 1/2 point, converted to two's complement at the end.

inline uint32_t le32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;  // the hosts this runs on are little-endian, as OpenJPEG's read_le_uint32 assumes
}

struct Mel {  // dec_mel_t: MEL bits most significant first, runs queued 7 bits each
  const uint8_t* data;
  uint64_t tmp = 0, runs = 0;
  int bits = 0, size = 0, k = 0, num_runs = 0;
  bool unstuff = false;
  // false where OpenJPEG's mel_init fails (0xFF then a byte above 0x8F in its first reads)
  bool init(const uint8_t* buf, int lcup, int scup, int align) {
    data = buf + lcup - scup, size = scup - 1;
    int num = 4 - ((align + lcup - scup) & 3);
    for (int i = 0; i < num; i++) {
      if (unstuff && data[0] > 0x8f) return false;
      uint64_t d = size > 0 ? *data : 0xff;
      if (size == 1) d |= 0xf;
      data += size-- > 0;
      int d_bits = 8 - unstuff;
      tmp = (tmp << d_bits) | d;
      bits += d_bits;
      unstuff = (d & 0xff) == 0xff;
    }
    tmp <<= (64 - bits);
    return true;
  }
  void read() {
    if (bits > 32) return;
    uint32_t val = 0xffffffffu;
    if (size > 4) {
      val = le32(data), data += 4, size -= 4;
    } else if (size > 0) {
      int i = 0;
      while (size > 1) {
        uint32_t v = *data++, m = ~(0xffu << i);
        val = (val & m) | (v << i);
        --size, i += 8;
      }
      uint32_t v = *data++ | 0xfu, m = ~(0xffu << i);
      val = (val & m) | (v << i);
      --size;
    }
    int nbits = 32 - unstuff;
    uint32_t t = val & 0xff;
    bool u = (val & 0xff) == 0xff;
    nbits -= u;
    t <<= 8 - u;
    t |= (val >> 8) & 0xff;
    u = ((val >> 8) & 0xff) == 0xff;
    nbits -= u;
    t <<= 8 - u;
    t |= (val >> 16) & 0xff;
    u = ((val >> 16) & 0xff) == 0xff;
    nbits -= u;
    t <<= 8 - u;
    t |= (val >> 24) & 0xff;
    unstuff = ((val >> 24) & 0xff) == 0xff;
    tmp |= uint64_t(t) << (64 - nbits - bits);
    bits += nbits;
  }
  void decode() {
    static const int exps[13] = {0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5};
    if (bits < 6) read();
    while (bits >= 6 && num_runs < 8) {
      int eval = exps[k], run;
      if (tmp & (uint64_t(1) << 63)) {  // a one: 2^eval zero events, not ended
        run = ((1 << eval) - 1) << 1;
        k = std::min(k + 1, 12);
        tmp <<= 1, bits -= 1;
      } else {  // a zero, then eval bits: that many zero events and a one
        run = (int(tmp >> (63 - eval)) & ((1 << eval) - 1)) << 1 | 1;
        k = std::max(k - 1, 0);
        tmp <<= eval + 1, bits -= eval + 1;
      }
      int at = num_runs * 7;
      runs &= ~(uint64_t(0x3f) << at);
      runs |= uint64_t(run) << at;
      num_runs++;
    }
  }
  int get_run() {
    if (num_runs == 0) decode();
    int t = int(runs & 0x7f);
    runs >>= 7, num_runs--;
    return t;
  }
};

struct Rev {  // rev_struct_t: VLC and MagRef, bits least significant first from the end
  const uint8_t* data;
  uint64_t tmp = 0;
  uint32_t bits = 0;
  int size = 0;
  bool unstuff = false;
  static uint32_t take(uint32_t val, bool& unstuff, uint32_t& nbits) {  // the 4 bytes of `val`, high byte first
    uint32_t t = val >> 24;
    nbits = 8u - ((unstuff && ((val >> 24) & 0x7f) == 0x7f) ? 1u : 0u);
    bool u = (val >> 24) > 0x8f;
    t |= ((val >> 16) & 0xff) << nbits;
    nbits += 8u - ((u && ((val >> 16) & 0x7f) == 0x7f) ? 1u : 0u);
    u = ((val >> 16) & 0xff) > 0x8f;
    t |= ((val >> 8) & 0xff) << nbits;
    nbits += 8u - ((u && ((val >> 8) & 0x7f) == 0x7f) ? 1u : 0u);
    u = ((val >> 8) & 0xff) > 0x8f;
    t |= (val & 0xff) << nbits;
    nbits += 8u - ((u && (val & 0x7f) == 0x7f) ? 1u : 0u);
    unstuff = (val & 0xff) > 0x8f;
    return t;
  }
  void read() {
    if (bits > 32) return;
    uint32_t val = 0;
    if (size > 3) {
      val = le32(data - 3), data -= 4, size -= 4;
    } else if (size > 0) {
      int i = 24;
      while (size > 0) {
        uint32_t v = *data--;
        val |= v << i;
        --size, i -= 8;
      }
    }
    uint32_t nbits;
    uint32_t t = take(val, unstuff, nbits);
    tmp |= uint64_t(t) << bits;
    bits += nbits;
  }
  void init_vlc(const uint8_t* buf, int lcup, int scup, int align) {  // rev_init
    data = buf + lcup - 2, size = scup - 2;
    uint32_t d = *data--;
    tmp = d >> 4;
    bits = 4 - ((tmp & 7) == 7);
    unstuff = (d | 0xf) > 0x8f;
    int num = 1 + ((align + lcup - 3) & 3), tnum = std::min(num, size);
    for (int i = 0; i < tnum; i++) {
      uint64_t b = *data--;
      uint32_t d_bits = 8u - ((unstuff && (b & 0x7f) == 0x7f) ? 1u : 0u);
      tmp |= b << bits;
      bits += d_bits;
      unstuff = b > 0x8f;
    }
    size -= tnum;
    read();
  }
  void init_mrp(const uint8_t* buf, int lcup, int len2, int align) {  // rev_init_mrp
    data = buf + lcup + len2 - 1, size = len2, unstuff = true;
    int num = 1 + ((align + lcup + len2 - 1) & 3);
    for (int i = 0; i < num; i++) {
      uint64_t b = (size-- > 0) ? *data-- : 0;
      uint32_t d_bits = 8u - ((unstuff && (b & 0x7f) == 0x7f) ? 1u : 0u);
      tmp |= b << bits;
      bits += d_bits;
      unstuff = b > 0x8f;
    }
    read();
  }
  uint32_t fetch() {
    if (bits < 32) {
      read();
      if (bits < 32) read();
    }
    return uint32_t(tmp);
  }
  uint32_t advance(uint32_t n) {
    tmp >>= n, bits -= n;
    return uint32_t(tmp);
  }
};

struct Frwd {  // frwd_struct_t: MagSgn and SigProp, bits least significant first; X past the end
  const uint8_t* data;
  uint64_t tmp = 0;
  uint32_t bits = 0, x = 0;
  int size = 0;
  bool unstuff = false;
  void init(const uint8_t* d, int n, uint32_t fill, int align) {
    data = d, size = n, x = fill;
    int num = 4 - (align & 3);
    for (int i = 0; i < num; i++) {
      uint64_t b = size-- > 0 ? *data++ : x;
      tmp |= b << bits;
      bits += 8u - (unstuff ? 1u : 0u);
      unstuff = (b & 0xff) == 0xff;
    }
    read();
  }
  void read() {
    uint32_t val = 0;
    if (size > 3) {
      val = le32(data), data += 4, size -= 4;
    } else if (size > 0) {
      int i = 0;
      val = x ? 0xffffffffu : 0;
      while (size > 0) {
        uint32_t v = *data++, m = ~(0xffu << i);
        val = (val & m) | (v << i);
        --size, i += 8;
      }
    } else {
      val = x ? 0xffffffffu : 0;
    }
    uint32_t nbits = 8u - (unstuff ? 1u : 0u), t = val & 0xff;
    bool u = (val & 0xff) == 0xff;
    t |= ((val >> 8) & 0xff) << nbits;
    nbits += 8u - (u ? 1u : 0u);
    u = ((val >> 8) & 0xff) == 0xff;
    t |= ((val >> 16) & 0xff) << nbits;
    nbits += 8u - (u ? 1u : 0u);
    u = ((val >> 16) & 0xff) == 0xff;
    t |= ((val >> 24) & 0xff) << nbits;
    nbits += 8u - (u ? 1u : 0u);
    unstuff = ((val >> 24) & 0xff) == 0xff;
    tmp |= uint64_t(t) << bits;
    bits += nbits;
  }
  uint32_t fetch() {
    if (bits < 32) {
      read();
      if (bits < 32) read();
    }
    return uint32_t(tmp);
  }
  void advance(uint32_t n) { tmp >>= n, bits -= n; }
};

// decode_init_uvlc / decode_noninit_uvlc: u + kappa (1) of the quad pair
// by its u_off bits (`mode`; 4: both, with a MEL one in the first line
// pair); returns the bits used.
uint32_t decode_uvlc(uint32_t vlc, uint32_t mode, uint32_t* u, bool initial) {
  // prefix length | suffix length << 2 | prefix value << 5, by the 3 bits xx1, x10, 100, 000
  static const uint8_t dec[8] = {3 | 5 << 2 | 5 << 5, 1 | 1 << 5, 2 | 2 << 5, 1 | 1 << 5,
                                 3 | 1 << 2 | 3 << 5, 1 | 1 << 5, 2 | 2 << 5, 1 | 1 << 5};
  uint32_t used = 0;
  if (mode == 0) {
    u[0] = u[1] = 1;
  } else if (mode <= 2) {
    uint32_t d = dec[vlc & 7];
    vlc >>= d & 3, used += d & 3;
    uint32_t sl = (d >> 2) & 7;
    used += sl;
    d = (d >> 5) + (vlc & ((1u << sl) - 1));
    u[0] = mode == 1 ? d + 1 : 1;
    u[1] = mode == 1 ? 1 : d + 1;
  } else if (mode == 3 && initial && (dec[vlc & 7] & 3) > 2) {  // u_q0 above 2: u_q1 in one bit
    uint32_t d1 = dec[vlc & 7];
    vlc >>= d1 & 3, used += d1 & 3;
    u[1] = (vlc & 1) + 1 + 1;
    ++used, vlc >>= 1;
    uint32_t sl = (d1 >> 2) & 7;
    used += sl;
    u[0] = (d1 >> 5) + (vlc & ((1u << sl) - 1)) + 1;
  } else if (mode >= 3) {
    uint32_t d1 = dec[vlc & 7];
    vlc >>= d1 & 3, used += d1 & 3;
    uint32_t d2 = dec[vlc & 7];
    vlc >>= d2 & 3, used += d2 & 3;
    uint32_t sl = (d1 >> 2) & 7;
    used += sl;
    uint32_t add = mode == 4 ? 3 : 1;
    u[0] = (d1 >> 5) + (vlc & ((1u << sl) - 1)) + add;
    vlc >>= sl;
    sl = (d2 >> 2) & 7;
    used += sl;
    u[1] = (d2 >> 5) + (vlc & ((1u << sl) - 1)) + add;
  }
  return used;
}

#include "ht_vlc_tables.h"

// opj_t1_ht_decode_cblk: one HT code-block into `out` (w x h, two's
// complement, the 1/2 point in bit 0 as tier 1 leaves it). `data` holds its
// chunks back to back, `align` the address modulo 4 OpenJPEG reads them at.
void ht_decode(const Cblk& cb, int cblksty, int roishift, int w, int h, const uint8_t* data, int align,
               std::vector<int32_t>& out) {
  if (roishift != 0) fail("We do not support ROI in decoding HT codeblocks");
  out.assign(size_t(w) * h, 0);
  if (cb.mb == 0) return;
  uint32_t zero_bplanes = (uint32_t(cb.mb) + 1) - uint32_t(cb.numbps);
  int64_t cblk_len = int64_t(cb.data.size());
  if (cb.numchunks == 0) return;
  uint32_t num_passes = cb.numsegs > 0 ? cb.segs[0].numpasses : 0;
  num_passes += cb.numsegs > 1 ? cb.segs[1].numpasses : 0;
  int64_t lengths1 = num_passes > 0 ? cb.segs[0].len : 0;
  int64_t lengths2 = num_passes > 1 ? cb.segs[1].len : 0;
  if (num_passes > 1 && lengths2 == 0) num_passes = 1;  // OpenJPEG warns
  if (num_passes > 3)
    fail(fmt("We do not support more than 3 coding passes in an HT codeblock; This codeblocks has %lld passes.",
             num_passes));
  if (cb.mb > 30) fail(fmt("32 bits are not enough to decode this codeblock (%lld bit-planes)", cb.mb));
  if (zero_bplanes > uint32_t(cb.mb))
    fail(fmt("Malformed HT codeblock. There are %lld zero bitplanes in %lld bitplanes.", zero_bplanes, cb.mb));
  if (zero_bplanes == uint32_t(cb.mb) && num_passes > 1) num_passes = 1;  // OpenJPEG warns
  const uint32_t p = uint32_t(cb.numbps), zero_bplanes_p1 = zero_bplanes + 1;
  if (lengths1 < 2 || lengths1 > cblk_len || lengths1 + lengths2 > cblk_len)
    fail("Malformed HT codeblock. Invalid codeblock length values.");
  const int lcup = int(lengths1);
  const int scup = (int(data[lcup - 1]) << 4) + (data[lcup - 2] & 0xf);
  if (scup < 2 || scup > lcup || scup > 4079)
    fail("Malformed HT codeblock. One of the following condition is not met: 2 <= Scup <= min(Lcup, 4079)");
  Mel mel;
  if (!mel.init(data, lcup, scup, align)) fail("Malformed HT codeblock. Incorrect MEL segment sequence.");
  Rev vlc, magref;
  vlc.init_vlc(data, lcup, scup, align);
  Frwd magsgn, sigprop;
  magsgn.init(data, lcup - scup, 0xff, align);
  if (num_passes > 1) sigprop.init(data + lengths1, int(lengths2), 0, align + int(lengths1));
  if (num_passes > 2) magref.init_mrp(data, int(lengths1), int(lengths2), align);

  const bool stripe_causal = (cblksty & VSC) != 0;
  const int stride = w;
  uint32_t* decoded = reinterpret_cast<uint32_t*>(out.data());
  // sigma1, sigma2, mbr1, mbr2 (132 words each: 4 rows x 8 columns a word) and the line state
  std::vector<uint32_t> flags(4 * 132 + 528 / 4, 0);
  uint32_t *sigma1 = flags.data(), *sigma2 = sigma1 + 132, *mbr1 = sigma2 + 132, *mbr2 = mbr1 + 132;
  uint8_t* line_state = reinterpret_cast<uint8_t*>(mbr2 + 132);
  uint32_t* sip = sigma1;
  uint32_t sip_shift = 0;

  // one significant sample: its MagSgn bits, the sample, and its exponent (for the line state)
  auto sample = [&](uint32_t qinf, int n, uint32_t big_u, uint32_t* at) -> uint32_t {
    uint32_t ms_val = magsgn.fetch();
    uint32_t m_n = big_u - ((qinf >> (12 + n)) & 1);
    magsgn.advance(m_n);
    uint32_t val = ms_val << 31;
    uint32_t v_n = ms_val & ((1u << m_n) - 1);
    v_n |= ((qinf >> (8 + n)) & 1) << m_n;
    v_n |= 1;
    *at = val | ((v_n + 2) << (p - 1));
    return v_n;
  };
  auto magnitudes = [&](const uint32_t* qinf, const uint32_t* big_u, uint32_t locs, uint8_t*& lsp, uint32_t*& sp) {
    for (int q = 0; q < 2; q++) {
      for (int col = 0; col < 2; col++) {
        int n = 2 * col;
        if (qinf[q] & (0x10u << n)) sample(qinf[q], n, big_u[q], sp);
        else if (locs & (1u << (4 * q + n))) sp[0] = 0;
        if (qinf[q] & (0x20u << n)) {
          uint32_t v_n = sample(qinf[q], n + 1, big_u[q], sp + stride);
          uint32_t e = 32 - uint32_t(__builtin_clz(v_n));
          if (col == 0) {  // max(E^NW, E^N) | sigma
            uint32_t t = lsp[0] & 0x7f;
            lsp[0] = uint8_t(0x80 | (t > e ? t : e));
          } else {
            lsp[0] = uint8_t(0x80 | e);
          }
        } else if (locs & (2u << (4 * q + n))) {
          sp[stride] = 0;
        }
        if (col == 0) ++lsp;
        ++sp;
      }
    }
  };
  auto check_locs = [&](const uint32_t* qinf, uint32_t locs) {
    if ((((qinf[0] & 0xf0) >> 4) | (qinf[1] & 0xf0)) & ~locs)
      fail("Malformed HT codeblock. VLC code produces significant samples outside the codeblock area.");
  };

  // the first line pair
  uint8_t* lsp = line_state;
  lsp[0] = 0;
  int run = mel.get_run();
  uint32_t qinf[2] = {0, 0}, c_q = 0;
  uint32_t* sp = decoded;
  for (int x = 0; x < w; x += 4) {
    uint32_t big_u[2];
    uint32_t vlc_val = vlc.fetch();
    qinf[0] = HT_VLC_TABLE0[(c_q << 7) | (vlc_val & 0x7f)];
    if (c_q == 0) {
      run -= 2;
      qinf[0] = run == -1 ? qinf[0] : 0;
      if (run < 0) run = mel.get_run();
    }
    c_q = ((qinf[0] & 0x10) >> 4) | ((qinf[0] & 0xe0) >> 5);
    vlc_val = vlc.advance(qinf[0] & 7);
    *sip |= (((qinf[0] & 0x30) >> 4) | ((qinf[0] & 0xc0) >> 2)) << sip_shift;
    qinf[1] = 0;
    if (x + 2 < w) {
      qinf[1] = HT_VLC_TABLE0[(c_q << 7) | (vlc_val & 0x7f)];
      if (c_q == 0) {
        run -= 2;
        qinf[1] = run == -1 ? qinf[1] : 0;
        if (run < 0) run = mel.get_run();
      }
      c_q = ((qinf[1] & 0x10) >> 4) | ((qinf[1] & 0xe0) >> 5);
      vlc_val = vlc.advance(qinf[1] & 7);
    }
    *sip |= ((qinf[1] & 0x30) | ((qinf[1] & 0xc0) << 2)) << (4 + sip_shift);
    sip += x & 7 ? 1 : 0;
    sip_shift ^= 0x10;
    uint32_t mode = ((qinf[0] & 8) >> 3) | ((qinf[1] & 8) >> 2);
    if (mode == 3) {
      run -= 2;
      mode += run == -1 ? 1 : 0;
      if (run < 0) run = mel.get_run();
    }
    uint32_t used = decode_uvlc(vlc_val, mode, big_u, true);
    if (big_u[0] > zero_bplanes_p1 || big_u[1] > zero_bplanes_p1)
      fail("Malformed HT codeblock. Decoding this codeblock is stopped. U_q is larger than zero bitplanes + 1");
    vlc.advance(used);
    uint32_t locs = 0xff;
    if (x + 4 > w) locs >>= (x + 4 - w) << 1;
    locs = h > 1 ? locs : (locs & 0x55);
    check_locs(qinf, locs);
    magnitudes(qinf, big_u, locs, lsp, sp);
  }

  // the other line pairs, and SigProp / MagRef a stripe behind
  auto magref_stripe = [&](const uint32_t* cur_sig, uint32_t* dpp) {
    const uint32_t half = 1u << (p - 2);
    for (int i = 0; i < w; i += 8) {
      uint32_t cwd = magref.fetch(), sig = *cur_sig++;
      uint32_t* dp = dpp + i;
      if (sig)
        for (int j = 0; j < 8; ++j, dp++)
          for (int r = 0; r < 4; r++)
            if (sig & (1u << (4 * j + r))) {
              uint32_t sym = cwd & 1;
              dp[r * stride] ^= (1 - sym) << (p - 1);
              dp[r * stride] |= half;
              cwd >>= 1;
            }
      magref.advance(uint32_t(__builtin_popcount(sig)));
    }
  };
  auto stripe_mbr = [&](const uint32_t* sig, uint32_t* mbr) {  // a stripe's candidates from its own significance
    uint32_t prev = 0;
    for (int i = 0; i < w; i += 8, mbr++, sig++) {
      mbr[0] = sig[0] | prev >> 28 | sig[0] << 4 | sig[0] >> 4 | sig[1] << 28;
      prev = sig[0];
      uint32_t t = mbr[0], z = mbr[0];
      z |= (t & 0x77777777) << 1;
      z |= (t & 0xeeeeeeee) >> 1;
      mbr[0] = z & ~sig[0];
    }
  };
  // SigProp of the stripe whose first row is `y0` (rows past the block masked by `pattern`)
  auto sigprop_stripe = [&](int y0, bool from_next, uint32_t pattern) {
    uint32_t *cur_sig = y0 & 4 ? sigma2 : sigma1, *cur_mbr = y0 & 4 ? mbr2 : mbr1;
    uint32_t *nxt_sig = y0 & 4 ? sigma1 : sigma2, *nxt_mbr = y0 & 4 ? mbr1 : mbr2;
    if (from_next) {
      uint32_t prev = 0;
      for (int i = 0, g = 0; i < w; i += 8, g++) {
        uint32_t t = nxt_sig[g] | prev >> 28 | nxt_sig[g] << 4 | nxt_sig[g] >> 4 | nxt_sig[g + 1] << 28;
        prev = nxt_sig[g];
        if (!stripe_causal) cur_mbr[g] |= (t & 0x11111111u) << 3;
        cur_mbr[g] &= ~cur_sig[g];
      }
    }
    const uint32_t val = 3u << (p - 2);
    for (int i = 0, g = 0; i < w; i += 8, g++) {
      uint32_t mbr = cur_mbr[g] & pattern, new_sig = 0;
      if (mbr) {
        for (int n = 0; n < 8; n += 4) {
          uint32_t cwd = sigprop.fetch(), cnt = 0;
          uint32_t* dp = decoded + y0 * stride + i + n;
          uint32_t inv_sig = ~cur_sig[g] & pattern;
          int end = n + 4 + i < w ? n + 4 : w - i;
          for (int j = n; j < end; ++j)
            for (int r = 0; r < 4; r++) {
              uint32_t mask = 1u << (4 * j + r);
              if (!(mbr & mask)) continue;
              if (cwd & 1) {
                static const uint32_t spread[4] = {0x32, 0x74, 0xe8, 0xc0};
                new_sig |= mask;
                mbr |= (spread[r] << (j * 4)) & inv_sig;
              }
              cwd >>= 1, ++cnt;
            }
          if (new_sig & (0xffffu << (4 * n)))
            for (int j = n; j < end; ++j, ++dp)
              for (int r = 0; r < 4; r++)
                if (new_sig & (1u << (4 * j + r))) {
                  dp[r * stride] |= ((cwd & 1) << 31) | val;
                  cwd >>= 1, ++cnt;
                }
          sigprop.advance(cnt);
          if (n == 4) {
            uint32_t t = new_sig >> 28;
            t |= ((t & 0xe) >> 1) | ((t & 7) << 1);
            cur_mbr[g + 1] |= t & ~cur_sig[g + 1];
          }
        }
      }
      new_sig |= cur_sig[g];
      uint32_t ux = (new_sig & 0x88888888) >> 3, tx = ux | (ux << 4) | (ux >> 4);
      if (i > 0) nxt_mbr[g - 1] |= (ux << 28) & ~nxt_sig[g - 1];
      nxt_mbr[g] |= tx & ~nxt_sig[g];
      nxt_mbr[g + 1] |= (ux >> 28) & ~nxt_sig[g + 1];
    }
  };

  for (int y = 2; y < h;) {
    sip_shift ^= 0x2;
    sip_shift &= 0xffffffefu;
    sip = y & 4 ? sigma2 : sigma1;
    lsp = line_state;
    uint8_t ls0 = lsp[0];
    lsp[0] = 0;
    sp = decoded + y * stride;
    c_q = 0;
    for (int x = 0; x < w; x += 4) {
      uint32_t big_u[2];
      c_q |= ls0 >> 7;
      c_q |= (lsp[1] >> 5) & 4;
      uint32_t vlc_val = vlc.fetch();
      qinf[0] = HT_VLC_TABLE1[(c_q << 7) | (vlc_val & 0x7f)];
      if (c_q == 0) {
        run -= 2;
        qinf[0] = run == -1 ? qinf[0] : 0;
        if (run < 0) run = mel.get_run();
      }
      c_q = ((qinf[0] & 0x40) >> 5) | ((qinf[0] & 0x80) >> 6);
      vlc_val = vlc.advance(qinf[0] & 7);
      *sip |= (((qinf[0] & 0x30) >> 4) | ((qinf[0] & 0xc0) >> 2)) << sip_shift;
      qinf[1] = 0;
      if (x + 2 < w) {
        c_q |= lsp[1] >> 7;
        c_q |= (lsp[2] >> 5) & 4;
        qinf[1] = HT_VLC_TABLE1[(c_q << 7) | (vlc_val & 0x7f)];
        if (c_q == 0) {
          run -= 2;
          qinf[1] = run == -1 ? qinf[1] : 0;
          if (run < 0) run = mel.get_run();
        }
        c_q = ((qinf[1] & 0x40) >> 5) | ((qinf[1] & 0x80) >> 6);
        vlc_val = vlc.advance(qinf[1] & 7);
      }
      *sip |= ((qinf[1] & 0x30) | ((qinf[1] & 0xc0) << 2)) << (4 + sip_shift);
      sip += x & 7 ? 1 : 0;
      sip_shift ^= 0x10;
      uint32_t mode = ((qinf[0] & 8) >> 3) | ((qinf[1] & 8) >> 2);
      uint32_t used = decode_uvlc(vlc_val, mode, big_u, false);
      vlc.advance(used);
      if ((qinf[0] & 0xf0) & ((qinf[0] & 0xf0) - 1)) {  // gamma: kappa from the line above
        uint32_t e = std::max<uint32_t>(ls0 & 0x7f, lsp[1] & 0x7f);
        big_u[0] += e > 2 ? e - 2 : 0;
      }
      if ((qinf[1] & 0xf0) & ((qinf[1] & 0xf0) - 1)) {
        uint32_t e = std::max<uint32_t>(lsp[1] & 0x7f, lsp[2] & 0x7f);
        big_u[1] += e > 2 ? e - 2 : 0;
      }
      if (big_u[0] > zero_bplanes_p1 || big_u[1] > zero_bplanes_p1)
        fail("Malformed HT codeblock. Decoding this codeblock is stopped. U_q is larger than bitplanes + 1");
      ls0 = lsp[2];
      lsp[1] = lsp[2] = 0;
      uint32_t locs = 0xff;
      if (x + 4 > w) locs >>= (x + 4 - w) << 1;
      locs = y + 2 <= h ? locs : (locs & 0x55);
      check_locs(qinf, locs);
      magnitudes(qinf, big_u, locs, lsp, sp);
    }
    y += 2;
    if (num_passes > 1 && (y & 3) == 0) {
      if (num_passes > 2) magref_stripe(y & 4 ? sigma1 : sigma2, decoded + (y - 4) * stride);
      if (y >= 4) stripe_mbr(y & 4 ? sigma1 : sigma2, y & 4 ? mbr1 : mbr2);
      if (y >= 8) {
        sigprop_stripe(y - 8, true, 0xffffffffu);
        uint32_t* cur_sig = y & 4 ? sigma2 : sigma1;
        memset(cur_sig, 0, size_t((((uint32_t(w) + 7u) >> 3) + 1u) << 2));
      }
    }
  }
  if (num_passes > 1) {  // the stripes the loop left
    if (num_passes > 2 && ((h & 3) == 1 || (h & 3) == 2))
      magref_stripe(h & 4 ? sigma2 : sigma1, decoded + (h & 0xfffffc) * stride);
    if ((h & 3) == 1 || (h & 3) == 2) stripe_mbr(h & 4 ? sigma2 : sigma1, h & 4 ? mbr2 : mbr1);
    int st = h - (h > 6 ? ((h + 1) & 3) + 3 : h);
    for (int y = st; y < h; y += 4) {
      uint32_t pattern = h - y == 3 ? 0x77777777u : h - y == 2 ? 0x33333333u : h - y == 1 ? 0x11111111u : 0xffffffffu;
      sigprop_stripe(y, h - y > 4, pattern);
    }
  }
  for (int32_t& v : out) {  // sign | magnitude to two's complement
    int32_t mag = int32_t(uint32_t(v) & 0x7fffffffu);
    v = (uint32_t(v) & 0x80000000u) ? -mag : mag;
  }
}

// ---- wavelets, colour, output ----

// The 1-D inverse transforms run on `width` lines at once: sample p of
// line w is x[p * width + w], the samples interleaved (low-pass at the
// positions of parity `cas`, OpenJPEG's h.cas / v.cas). Each sample takes
// the same operations in the same order as OpenJPEG's one-line code;
// the lines only share the loops.

// the rows of a sample's two neighbours, mirrored at the ends (len >= 2)
inline int before(int p) { return p > 0 ? p - 1 : p + 1; }
inline int after(int p, int len) { return p + 1 < len ? p + 1 : p - 1; }

// The 5/3 is OpenJPEG's one-pass lifting (opj_idwt53_h_cas0 / _cas1 on rows,
// opj_idwt3_v_cas0 / _cas1 on columns, and their SSE2 forms on each whole
// group of 8 columns), its int32 sums wrapping. The forms differ only
// where a sum can wrap, at the ends, where a sample has one neighbour: a
// low-pass sample there takes (d + 1) >> 1, but (d + d + 2) >> 2 in the
// first `simd` lines (the SSE2 columns; OpenJPEG's two-sample cas 1 line
// is scalar everywhere), and a high-pass one d + s in every form.
void idwt53(int32_t* x, int len, int width, int cas, int simd) {
  if (len == 1) {
    if (cas)
      for (int w = 0; w < width; w++) x[w] /= 2;
    return;
  }
  if (cas && len == 2) simd = 0;
  auto wrap = [](uint32_t v) { return int32_t(v); };
  for (int p = cas; p < len; p += 2) {
    int32_t* c = x + p * width;
    const int32_t *l = x + before(p) * width, *r = x + after(p, len) * width;
    if (l == r) {
      for (int w = 0; w < width; w++)
        c[w] = w < simd ? wrap(uint32_t(c[w]) - uint32_t(wrap(2u * uint32_t(l[w]) + 2u) >> 2))
                        : wrap(uint32_t(c[w]) - uint32_t(wrap(uint32_t(l[w]) + 1u) >> 1));
    } else {
      for (int w = 0; w < width; w++)
        c[w] = wrap(uint32_t(c[w]) - uint32_t(wrap(uint32_t(l[w]) + uint32_t(r[w]) + 2u) >> 2));
    }
  }
  for (int p = 1 - cas; p < len; p += 2) {
    int32_t* c = x + p * width;
    const int32_t *l = x + before(p) * width, *r = x + after(p, len) * width;
    if (l == r) {
      for (int w = 0; w < width; w++) c[w] = wrap(uint32_t(c[w]) + uint32_t(l[w]));
    } else {
      for (int w = 0; w < width; w++)
        c[w] = wrap(uint32_t(c[w]) + uint32_t(wrap(uint32_t(l[w]) + uint32_t(r[w])) >> 1));
    }
  }
}

const float K97 = 1.230174105f, TWO_INV_K97 = 1.625732422f;
const float LIFT97[4] = {-0.443506852f, -0.882911075f, 0.052980118f, 1.586134342f};

void idwt97(float* x, int len, int width, int cas) {
  int sn = cas ? len / 2 : (len + 1) / 2, dn = len - sn;
  if (cas == 0 ? !(dn > 0 || sn > 1) : !(sn > 0 || dn > 1)) return;
  for (int p = 0; p < len; p++) {
    const float k = (p % 2 == cas) ? K97 : TWO_INV_K97;
    for (int w = 0; w < width; w++) x[p * width + w] = x[p * width + w] * k;
  }
  for (int s = 0; s < 4; s++) {
    const float k = LIFT97[s];
    for (int p = (s % 2 == 0) ? cas : 1 - cas; p < len; p += 2) {
      float* c = x + p * width;
      const float *l = x + before(p) * width, *r = x + after(p, len) * width;
      for (int w = 0; w < width; w++) c[w] = c[w] + (l[w] + r[w]) * k;
    }
  }
}

// The inverse DWT of a tile-component up to resolution `top`: each level's
// rows, eight at a time, then its columns, all at once.
void idwt(TileComp& tc, int qmfbid, int top) {
  const int64_t stride = tc.x1 - tc.x0;
  const int group = 8;
  std::vector<Sample> tmp;
  auto lines = [&](int len, int width, int cas, int simd) {
    static_assert(sizeof(Sample) == 4, "a sample is one int32 or float");
    if (qmfbid == 1) idwt53(&tmp[0].i, len, width, cas, simd);
    else idwt97(&tmp[0].f, len, width, cas);
  };
  for (int r = 1; r <= top; r++) {
    const Res &lo = tc.res[r - 1], &res = tc.res[r];
    const int rw = int(res.x1 - res.x0), rh = int(res.y1 - res.y0);
    const int snx = int(lo.x1 - lo.x0), sny = int(lo.y1 - lo.y0);
    const int casx = int(res.x0 % 2), casy = int(res.y0 % 2);
    // where sample k of the tile's line (low-pass first) goes in the interleaved line
    auto slot = [](int k, int sn, int cas) { return k < sn ? 2 * k + cas : 2 * (k - sn) + 1 - cas; };
    tmp.resize(size_t(rw) * group);
    for (int j = 0; j < rh; j += group) {
      const int n = std::min(group, rh - j);
      for (int g = 0; g < n; g++)
        for (int k = 0; k < rw; k++) tmp[size_t(slot(k, snx, casx)) * n + g] = tc.data[(j + g) * stride + k];
      lines(rw, n, casx, 0);
      for (int g = 0; g < n; g++)
        for (int k = 0; k < rw; k++) tc.data[(j + g) * stride + k] = tmp[size_t(k) * n + g];
    }
    tmp.resize(size_t(rh) * rw);
    for (int k = 0; k < rh; k++)
      std::copy_n(&tc.data[k * stride], rw, &tmp[size_t(slot(k, sny, casy)) * rw]);
    lines(rh, rw, casy, rw - rw % 8);  // the columns OpenJPEG's SSE2 form takes, 8 at a time
    for (int k = 0; k < rh; k++) std::copy_n(&tmp[size_t(k) * rw], rw, &tc.data[k * stride]);
  }
}

inline uint32_t shifted(uint32_t x, int n) { return n < 0 ? x >> -n : x << n; }

// PIL's ImagingConvertYCbCr2RGB (its fixed-point tables, 6 fraction
// bits): R = Y + R_Cr[Cr], B = Y + B_Cb[Cb] (each table shifted right by 6
// already), G = Y + ((G_Cb[Cb] + G_Cr[Cr]) >> 6), each clamped to 0..255.
// The G tables are one pair of integer tables giving PIL's G for every
// (Cb, Cr), found from PIL's conversion of all 65536 pairs.
const int16_t YCC_R_CR[256] = {
    -180, -179, -177, -176, -174, -173, -172, -170, -169, -167, -166, -165, -163, -162, -160, -159,
    -158, -156, -155, -153, -152, -150, -149, -148, -146, -145, -143, -142, -141, -139, -138, -136,
    -135, -134, -132, -131, -129, -128, -127, -125, -124, -122, -121, -120, -118, -117, -115, -114,
    -113, -111, -110, -108, -107, -106, -104, -103, -101, -100, -99, -97, -96, -94, -93, -92,
    -90, -89, -87, -86, -85, -83, -82, -80, -79, -78, -76, -75, -73, -72, -71, -69,
    -68, -66, -65, -64, -62, -61, -59, -58, -57, -55, -54, -52, -51, -50, -48, -47,
    -45, -44, -43, -41, -40, -38, -37, -36, -34, -33, -31, -30, -29, -27, -26, -24,
    -23, -22, -20, -19, -17, -16, -14, -13, -12, -10, -9, -7, -6, -5, -3, -2,
    0, 1, 2, 4, 5, 7, 8, 9, 11, 12, 14, 15, 16, 18, 19, 21,
    22, 23, 25, 26, 28, 29, 30, 32, 33, 35, 36, 37, 39, 40, 42, 43,
    44, 46, 47, 49, 50, 51, 53, 54, 56, 57, 58, 60, 61, 63, 64, 65,
    67, 68, 70, 71, 72, 74, 75, 77, 78, 79, 81, 82, 84, 85, 86, 88,
    89, 91, 92, 93, 95, 96, 98, 99, 100, 102, 103, 105, 106, 107, 109, 110,
    112, 113, 114, 116, 117, 119, 120, 121, 123, 124, 126, 127, 128, 130, 131, 133,
    134, 136, 137, 138, 140, 141, 143, 144, 145, 147, 148, 150, 151, 152, 154, 155,
    157, 158, 159, 161, 162, 164, 165, 166, 168, 169, 171, 172, 173, 175, 176, 178,
};
const int16_t YCC_B_CB[256] = {
    -227, -226, -224, -222, -220, -218, -217, -215, -213, -211, -210, -208, -206, -204, -202, -201,
    -199, -197, -195, -194, -192, -190, -188, -187, -185, -183, -181, -179, -178, -176, -174, -172,
    -171, -169, -167, -165, -164, -162, -160, -158, -156, -155, -153, -151, -149, -148, -146, -144,
    -142, -140, -139, -137, -135, -133, -132, -130, -128, -126, -125, -123, -121, -119, -117, -116,
    -114, -112, -110, -109, -107, -105, -103, -101, -100, -98, -96, -94, -93, -91, -89, -87,
    -86, -84, -82, -80, -78, -77, -75, -73, -71, -70, -68, -66, -64, -62, -61, -59,
    -57, -55, -54, -52, -50, -48, -47, -45, -43, -41, -39, -38, -36, -34, -32, -31,
    -29, -27, -25, -24, -22, -20, -18, -16, -15, -13, -11, -9, -8, -6, -4, -2,
    0, 1, 3, 5, 7, 8, 10, 12, 14, 15, 17, 19, 21, 23, 24, 26,
    28, 30, 31, 33, 35, 37, 38, 40, 42, 44, 46, 47, 49, 51, 53, 54,
    56, 58, 60, 62, 63, 65, 67, 69, 70, 72, 74, 76, 77, 79, 81, 83,
    85, 86, 88, 90, 92, 93, 95, 97, 99, 101, 102, 104, 106, 108, 109, 111,
    113, 115, 116, 118, 120, 122, 124, 125, 127, 129, 131, 132, 134, 136, 138, 139,
    141, 143, 145, 147, 148, 150, 152, 154, 155, 157, 159, 161, 163, 164, 166, 168,
    170, 171, 173, 175, 177, 178, 180, 182, 184, 186, 187, 189, 191, 193, 194, 196,
    198, 200, 202, 203, 205, 207, 209, 210, 212, 214, 216, 217, 219, 221, 223, 225,
};
const int16_t YCC_G_CB[256] = {
    2817, 2807, 2761, 2753, 2707, 2697, 2687, 2643, 2633, 2621, 2579, 2567, 2557, 2514, 2501, 2493,
    2448, 2437, 2428, 2382, 2373, 2362, 2318, 2308, 2297, 2254, 2242, 2233, 2187, 2177, 2168, 2121,
    2113, 2102, 2057, 2048, 2003, 1993, 1982, 1939, 1928, 1917, 1875, 1862, 1853, 1809, 1797, 1789,
    1743, 1733, 1723, 1678, 1669, 1657, 1614, 1603, 1593, 1549, 1537, 1529, 1483, 1473, 1464, 1417,
    1409, 1398, 1353, 1344, 1299, 1289, 1277, 1235, 1223, 1213, 1170, 1157, 1149, 1104, 1093, 1084,
    1038, 1029, 1018, 974, 964, 953, 910, 898, 889, 844, 833, 825, 778, 769, 759, 713,
    705, 659, 649, 639, 595, 585, 573, 531, 519, 509, 466, 453, 445, 399, 389, 379,
    334, 325, 313, 270, 259, 249, 205, 193, 185, 139, 129, 120, 73, 65, 54, 9,
    0, -45, -55, -65, -109, -119, -131, -173, -185, -195, -238, -251, -259, -304, -315, -324,
    -370, -379, -390, -434, -444, -455, -499, -511, -519, -565, -575, -584, -631, -639, -650, -695,
    -704, -749, -759, -770, -813, -824, -835, -877, -890, -899, -943, -955, -963, -1009, -1019, -1029,
    -1074, -1083, -1095, -1138, -1149, -1159, -1203, -1215, -1223, -1269, -1279, -1288, -1335, -1343, -1389, -1399,
    -1409, -1453, -1463, -1475, -1517, -1529, -1539, -1582, -1595, -1603, -1648, -1659, -1668, -1714, -1723, -1734,
    -1778, -1788, -1799, -1842, -1854, -1863, -1908, -1919, -1927, -1974, -1983, -1993, -2039, -2047, -2093, -2103,
    -2113, -2157, -2167, -2179, -2221, -2234, -2243, -2287, -2299, -2307, -2353, -2363, -2373, -2418, -2427, -2439,
    -2482, -2493, -2503, -2547, -2559, -2567, -2613, -2623, -2632, -2679, -2687, -2698, -2743, -2752, -2797, -2807,
};
const int16_t YCC_G_CR[256] = {
    5869, 5815, 5759, 5703, 5682, 5627, 5571, 5549, 5495, 5439, 5383, 5362, 5307, 5251, 5229, 5175,
    5119, 5063, 5043, 4987, 4931, 4909, 4855, 4799, 4743, 4723, 4667, 4611, 4589, 4535, 4479, 4423,
    4403, 4347, 4291, 4270, 4215, 4159, 4103, 4083, 4027, 3971, 3950, 3895, 3839, 3784, 3763, 3707,
    3651, 3630, 3575, 3519, 3464, 3443, 3387, 3331, 3310, 3255, 3199, 3144, 3123, 3067, 3012, 2990,
    2935, 2879, 2824, 2803, 2747, 2692, 2670, 2615, 2559, 2504, 2483, 2427, 2372, 2350, 2295, 2240,
    2184, 2163, 2107, 2052, 2030, 1975, 1920, 1864, 1843, 1787, 1732, 1710, 1655, 1600, 1544, 1523,
    1468, 1412, 1390, 1335, 1280, 1224, 1203, 1148, 1092, 1070, 1016, 960, 904, 883, 828, 772,
    750, 696, 640, 584, 563, 508, 452, 430, 376, 320, 264, 244, 188, 132, 110, 56,
    0, -55, -75, -131, -187, -209, -263, -319, -375, -395, -451, -507, -528, -583, -639, -695,
    -715, -771, -827, -848, -903, -959, -1015, -1035, -1091, -1147, -1168, -1223, -1279, -1334, -1355, -1411,
    -1467, -1488, -1543, -1599, -1654, -1675, -1731, -1786, -1808, -1863, -1919, -1974, -1995, -2051, -2106, -2128,
    -2183, -2239, -2294, -2315, -2371, -2426, -2448, -2503, -2558, -2614, -2635, -2691, -2746, -2768, -2823, -2878,
    -2934, -2955, -3011, -3066, -3088, -3143, -3198, -3254, -3275, -3330, -3386, -3408, -3463, -3518, -3574, -3595,
    -3650, -3706, -3728, -3783, -3838, -3894, -3915, -3970, -4026, -4048, -4102, -4158, -4214, -4235, -4290, -4346,
    -4368, -4422, -4478, -4534, -4554, -4610, -4666, -4688, -4742, -4798, -4854, -4874, -4930, -4986, -5008, -5062,
    -5118, -5174, -5194, -5250, -5306, -5327, -5382, -5438, -5494, -5514, -5570, -5626, -5647, -5702, -5758, -5780,
};

void ycbcr_to_rgb(uint8_t* px) {
  int y = px[0], cb = px[1], cr = px[2];
  int r = y + YCC_R_CR[cr], g = y + ((YCC_G_CB[cb] + YCC_G_CR[cr]) >> 6), b = y + YCC_B_CB[cb];
  px[0] = uint8_t(r <= 0 ? 0 : r >= 255 ? 255 : r);
  px[1] = uint8_t(g <= 0 ? 0 : g >= 255 ? 255 : g);
  px[2] = uint8_t(b <= 0 ? 0 : b >= 255 ? 255 : b);
}

struct Output {
  int kind, width, height, bpp;  // kind: PIL's unpacker (`unpacker`)
  uint8_t* px;
};

// PIL's choice of unpacker (Jpeg2KDecode.c's j2k_unpackers): 0 gray_l,
// 1 gray_i, 2 gray_rgb, 3 graya_la, 4 srgb_rgb, 5 sycc_rgb, 6 srgba_rgba,
// 7 sycca_rgba; only 4 to 7 read subsampled components. Where the colour
// space is unspecified, PIL takes 1 or 2 components for grey, and 3 or 4
// for sYCC where component 0 is full size and 1 or 2 subsampled, else sRGB.
int unpacker(int mode, int space, const std::vector<Comp>& comps) {
  static const int table[][4] = {  // mode, colour space, components, unpacker
      {M_L, CS_GRAY, 1, 0},     {M_P, CS_SRGB, 1, 0},     {M_PA, CS_SRGB, 2, 3},    {M_I16, CS_GRAY, 1, 1},
      {M_LA, CS_GRAY, 2, 3},    {M_RGB, CS_GRAY, 1, 2},   {M_RGB, CS_GRAY, 2, 2},   {M_RGB, CS_SRGB, 3, 4},
      {M_RGB, CS_SYCC, 3, 5},   {M_RGB, CS_SRGB, 4, 4},   {M_RGB, CS_SYCC, 4, 5},   {M_RGBA, CS_GRAY, 1, 2},
      {M_RGBA, CS_GRAY, 2, 3},  {M_RGBA, CS_SRGB, 3, 4},  {M_RGBA, CS_SYCC, 3, 5},  {M_RGBA, CS_SRGB, 4, 6},
      {M_RGBA, CS_GRAY, 4, 6},  {M_RGBA, CS_SYCC, 4, 7},  {M_CMYK, CS_CMYK, 4, 6},
  };
  int ncomp = int(comps.size());
  if (ncomp < 1 || ncomp > 4 || space == CS_UNKNOWN) fail("broken data stream (components or colour space)");
  auto sub = [&](int c) { return comps[c].dx != 1 || comps[c].dy != 1; };
  bool subsampled = false;
  for (int c = 0; c < ncomp; c++) subsampled |= sub(c);
  if (space == CS_UNSPECIFIED)
    space = ncomp <= 2 ? CS_GRAY : !sub(0) && (sub(1) || sub(2)) ? CS_SYCC : CS_SRGB;
  for (const auto& t : table)
    if (t[0] == mode && t[1] == space && t[2] == ncomp && (t[3] >= 4 || !subsampled)) return t[3];
  fail("broken data stream (no unpacker for the mode, colour space and components)");
}

// PIL's tile buffer: opj_tcd_update_tile_data packs each component at the
// resolution decoded (1, 2 or 4 bytes a sample), the rest zero; PIL's
// unpacker then reads it with its own strides (w / dx, h / dy).
void unpack_tile(const Codestream& cs, const std::vector<TileComp>& comps, const std::vector<int>& resno_decoded,
                 const int64_t t[4], const Output& out, std::vector<uint8_t>& buf) {
  int64_t x0 = t[0] - cs.x0, y0 = t[1] - cs.y0, w = t[2] - t[0], h = t[3] - t[1];
  if (t[0] >= t[2] || t[1] >= t[3] || t[0] < cs.x0 || t[1] < cs.y0 || t[2] - cs.x0 > out.width ||
      t[3] - cs.y0 > out.height)
    fail("broken data stream (tile outside the image)");
  size_t n = comps.size();  // at most 4 (unpacker): the per-component values live in local arrays, which the
  int csiz[4], shift[4], offset[4];  // stores to the image cannot alias
  int64_t total = 0;
  int target = out.kind == 1 ? 16 : 8;
  for (size_t c = 0; c < n; c++) {
    const Comp& comp = cs.comps[c];
    csiz[c] = (comp.prec + 7) >> 3;
    if (csiz[c] == 3) csiz[c] = 4;
    total += csiz[c] * w * h;
    shift[c] = target - comp.prec;
    offset[c] = comp.sgnd ? 1 << (comp.prec - 1) : 0;
    if (shift[c] < 0) offset[c] += 1 << (-shift[c] - 1);
  }
  buf.assign(size_t(total), 0);
  int64_t at = 0;
  for (size_t c = 0; c < n; c++) {  // opj_tcd_update_tile_data
    const TileComp& tc = comps[c];
    const Res& res = tc.res[resno_decoded[c]];
    int64_t rw = res.x1 - res.x0, rh = res.y1 - res.y0, from = tc.x1 - tc.x0;
    if (at + csiz[c] * rw * rh > total) fail("broken data stream (tile data)");
    uint8_t* q = &buf[at];
    for (int64_t y = 0; y < rh; y++) {  // the low bytes, as the host's int8 / int16 / int32 stores
      const Sample* src = &tc.data[y * from];
      if (csiz[c] == 1) {
        for (int64_t x = 0; x < rw; x++) *q++ = uint8_t(src[x].i);
      } else if (csiz[c] == 2) {
        for (int64_t x = 0; x < rw; x++, q += 2) {
          uint16_t v = uint16_t(src[x].i);
          memcpy(q, &v, 2);
        }
      } else {
        memcpy(q, src, size_t(4 * rw));
        q += 4 * rw;
      }
    }
    at += csiz[c] * rw * rh;
  }
  // where PIL reads component c of pixel (x, y): start[c] + row (y / dy * its stride) + csiz (x / dx);
  // the unpackers that read no subsampled components take dx = dy = 1
  bool sub = out.kind >= 4;
  int64_t start[4] = {}, stride[4], dx[4], dy[4], row[4];
  const uint8_t* b = buf.data();
  for (size_t c = 0; c < n; c++) {
    dx[c] = sub ? cs.comps[c].dx : 1, dy[c] = sub ? cs.comps[c].dy : 1;
    stride[c] = csiz[c] * (w / dx[c]);
    if (c + 1 < n) start[c + 1] = start[c] + stride[c] * (h / dy[c]);
  }
  auto word = [&](size_t c, int64_t x) {  // the sample PIL reads for column x, shifted
    const uint8_t* q = b + row[c] + csiz[c] * (dx[c] == 1 ? x : x / dx[c]);
    uint32_t v;
    if (csiz[c] == 1) {
      v = *q;
    } else if (csiz[c] == 2) {
      uint16_t u;
      memcpy(&u, q, 2);
      v = u;
    } else {
      memcpy(&v, q, 4);
    }
    return shifted(uint32_t(offset[c]) + v, shift[c]);
  };
  int planes = out.kind == 4 || out.kind == 5 ? 3 : out.kind >= 6 ? 4 : out.kind == 3 ? 2 : 1;
  for (int64_t y = 0; y < h; y++) {
    for (int c = 0; c < planes; c++) row[c] = start[c] + stride[c] * (y / dy[c]);
    uint8_t* p = out.px + ((y0 + y) * out.width + x0) * out.bpp;
    for (int64_t x = 0; x < w; x++, p += out.bpp) {
      switch (out.kind) {
        case 0: p[0] = uint8_t(word(0, x)); break;
        case 1: {
          uint16_t v = uint16_t(word(0, x));
          memcpy(p, &v, 2);
          break;
        }
        case 2: p[0] = p[1] = p[2] = uint8_t(word(0, x)), p[3] = 0xff; break;
        case 3: p[0] = p[1] = p[2] = uint8_t(word(0, x)), p[3] = uint8_t(word(1, x)); break;
        default:
          for (int c = 0; c < planes; c++) p[c] = uint8_t(word(c, x));
          if (planes == 3) p[3] = 0xff;
          if (out.kind == 5 || out.kind == 7) ycbcr_to_rgb(p);
      }
    }
  }
}

// Decodes one tile into its components' samples (after the DC shift and
// clamp); `ranges` collects its code-blocks' data ranges when not null.
// `resno_decoded`: each component's highest resolution read in the tile
// (0 where none is).
void decode_tile(const Codestream& cs, const Tcp& tcp, int tileno, std::vector<TileComp>& comps, int64_t t[4],
                 Headers* packed, std::vector<int>& resno_decoded, std::vector<std::pair<int64_t, int64_t>>* ranges) {
  init_tile(cs, tcp, tileno, comps, t);
  resno_decoded.assign(comps.size(), 0);
  tier2(cs, tcp, comps, t, tcp.data.data(), int64_t(tcp.data.size()), 0, packed, resno_decoded);
  T1 t1;
  std::vector<int32_t> ht_data;
  for (size_t c = 0; c < comps.size(); c++) {
    TileComp& tc = comps[c];
    const Tccp& tccp = tcp.tccps[c];
    int64_t stride = tc.x1 - tc.x0;
    tc.data.assign(size_t(stride * (tc.y1 - tc.y0)), Sample{0});
    for (int r = 0; r < tc.numres; r++) {
      const Res& res = tc.res[r];
      for (int b = 0; b < res.numbands; b++) {
        const Band& band = res.bands[b];
        if (band.empty()) continue;
        const float step = 0.5f * band.stepsize;
        for (const Precinct& pr : band.precs)
          for (const Cblk& cb : pr.cblks) {
            if (ranges)
              for (auto [off, len] : cb.chunks) ranges->push_back({off, len});
            if (cb.x1 <= cb.x0 || cb.y1 <= cb.y0) continue;
            const int w = int(cb.x1 - cb.x0), h = int(cb.y1 - cb.y0);
            const int32_t* values;
            if (tccp.cblksty & HT) {  // one chunk is read in place in the tile's data, several from a copy
              int align = cb.numchunks > 1 ? 0 : int(cb.first_chunk & 3);
              ht_decode(cb, tccp.cblksty, tccp.roishift, w, h, cb.data.data(), align, ht_data);
              values = ht_data.data();
            } else {
              t1.decode(cb, band.bandno, tccp.cblksty, tccp.roishift);
              values = t1.data.data();
            }
            int64_t x = cb.x0 - band.x0, y = cb.y0 - band.y0;
            if (band.bandno & 1) x += tc.res[r - 1].x1 - tc.res[r - 1].x0;
            if (band.bandno & 2) y += tc.res[r - 1].y1 - tc.res[r - 1].y0;
            for (int j = 0; j < h; j++)
              for (int i = 0; i < w; i++) {
                Sample& s = tc.data[(y + j) * stride + x + i];
                int32_t v = values[j * w + i];
                if (tccp.qmfbid == 1) s.i = v / 2;
                else s.f = float(v) * step;
              }
          }
      }
    }
    idwt(tc, tccp.qmfbid, resno_decoded[c]);
  }
  if (tcp.mct && comps.size() >= 3) {  // opj_tcd_mct_decode
    const Res& r0 = comps[0].res[comps[0].numres - 1];
    int64_t samples = (r0.x1 - r0.x0) * (r0.y1 - r0.y0);
    for (int c = 1; c < 3; c++) {
      const Res& rc = comps[c].res[std::min(comps[0].numres, comps[c].numres) - 1];
      if (comps[c].numres != comps[0].numres || resno_decoded[c] != resno_decoded[0] ||
          (rc.x1 - rc.x0) * (rc.y1 - rc.y0) != samples)
        fail("Tiles don't all have the same dimension. Skip the MCT step.");
    }
    Sample *c0 = comps[0].data.data(), *c1 = comps[1].data.data(), *c2 = comps[2].data.data();
    if (tcp.tccps[0].qmfbid == 1) {
      for (int64_t i = 0; i < samples; i++) {
        uint32_t y = c0[i].i, u = c1[i].i, v = c2[i].i;  // int32 sums, wrapping as opj_mct_decode's SSE2 lanes
        uint32_t g = y - uint32_t(int32_t(u + v) >> 2);
        c0[i].i = int32_t(v + g), c1[i].i = int32_t(g), c2[i].i = int32_t(u + g);
      }
    } else {
      for (int64_t i = 0; i < samples; i++) {
        float y = c0[i].f, u = c1[i].f, v = c2[i].f;
        c0[i].f = y + v * 1.402f;
        c1[i].f = y - u * 0.34413f - v * 0.71414f;
        c2[i].f = y + u * 1.772f;
      }
    }
  }
  for (size_t c = 0; c < comps.size(); c++) {  // DC level shift and clamp (opj_tcd_dc_level_shift_decode)
    const Comp& comp = cs.comps[c];
    const Res& res = comps[c].res[resno_decoded[c]];
    int64_t rw = res.x1 - res.x0, rh = res.y1 - res.y0, stride = comps[c].x1 - comps[c].x0;
    int32_t lo = comp.sgnd ? -(1 << (comp.prec - 1)) : 0;
    int32_t hi = comp.sgnd ? (1 << (comp.prec - 1)) - 1 : int32_t((1u << comp.prec) - 1);
    int32_t shift = tcp.tccps[c].dc_shift;
    for (int64_t y = 0; y < rh; y++)
      for (int64_t x = 0; x < rw; x++) {
        Sample& s = comps[c].data[y * stride + x];
        if (tcp.tccps[c].qmfbid == 1) {  // the sum in int32, wrapping as OpenJPEG's does; the 9/7's in int64
          s.i = std::min(hi, std::max(lo, int32_t(uint32_t(s.i) + uint32_t(shift))));
        } else {
          float v = s.f;
          if (std::isnan(v)) s.i = lo;
          else if (v > float(INT32_MAX)) s.i = hi;
          else if (v < float(INT32_MIN)) s.i = lo;
          else s.i = int32_t(std::min<int64_t>(hi, std::max<int64_t>(lo, int64_t(lrintf(v)) + shift)));
        }
      }
  }
}

// Every tile with data in decoding order (PPM headers run on from tile to
// tile), handed to `done(tileno, comps, t)`.
template <class F>
void decode_tiles(Codestream& cs, std::vector<std::pair<int64_t, int64_t>>* ranges, F done) {
  std::vector<TileComp> comps;
  std::vector<int> resno_decoded;
  Headers ppm{cs.ppm_data.data(), int64_t(cs.ppm_data.size())};
  for (int k : cs.order) {
    Tcp& tcp = cs.tiles[k];
    if (!tcp.has_data) {
      if (cs.completed[k]) fail(fmt("tile %lld is complete but holds no data (opj_j2k_decode_tile fails)", k));
      continue;
    }
    std::vector<uint8_t> ppt_data;  // opj_j2k_merge_ppt: the PPT segments in Zppt order
    for (size_t z = 0; z < tcp.ppt.segs.size(); z++)
      if (tcp.ppt.set[z]) ppt_data.insert(ppt_data.end(), tcp.ppt.segs[z].begin(), tcp.ppt.segs[z].end());
    Headers ppt{ppt_data.data(), int64_t(ppt_data.size())};
    Headers* packed = cs.has_ppm ? &ppm : tcp.has_ppt ? &ppt : nullptr;
    int64_t t[4];
    decode_tile(cs, tcp, k, comps, t, packed, resno_decoded, ranges);
    done(k, comps, resno_decoded, t);
  }
}

}  // namespace

extern "C" {

const char* gs_jp2_error() { return g_error.c_str(); }

// Decodes the codestream `cs` (a raw .j2k file, or a JP2's codestream box
// to the end of the file) as PIL reads it in `mode` (Mode) with OpenJPEG's
// colour space `space` (Space), into `out`: PIL's image memory of
// `width` x `height` pixels (1 byte a pixel for L and P, 2 for I;16, 4
// otherwise), zero-filled by the caller. `ihdr_w` / `ihdr_h`: the JP2
// header's size, which OpenJPEG requires the codestream to match (0: none).
int gs_jp2_decode(const uint8_t* cs_data, long long size, int mode, int space, int width, int height,
                  long long ihdr_w, long long ihdr_h, uint8_t* out) {
  try {
    Codestream cs = parse(cs_data, size, ihdr_w, ihdr_h);
    Output o{unpacker(mode, space, cs.comps), width, height,
             mode == M_L || mode == M_P ? 1 : mode == M_I16 ? 2 : 4, out};
    std::vector<uint8_t> buf;
    decode_tiles(cs, nullptr, [&](int, const std::vector<TileComp>& comps, const std::vector<int>& resno_decoded,
                                  const int64_t* t) { unpack_tile(cs, comps, resno_decoded, t, o, buf); });
    return 0;
  } catch (const Error& e) {
    g_error = e.msg;
  } catch (const std::bad_alloc&) {
    g_error = "out of memory";
  }
  return 1;
}

// The code-block data ranges of a codestream (offset from its start,
// length), into out[2 * i], out[2 * i + 1]; returns how many there are
// (those past `capacity` are counted, not written), or -1 with
// gs_jp2_error's message.
long long gs_jp2_segments(const uint8_t* cs_data, long long size, long long* out, long long capacity) {
  try {
    Codestream cs = parse(cs_data, size, 0, 0);
    std::vector<std::pair<int64_t, int64_t>> ranges;
    size_t first = 0;
    decode_tiles(cs, &ranges, [&](int k, const std::vector<TileComp>&, const std::vector<int>&, const int64_t*) {
      for (size_t i = first; i < ranges.size(); i++) {  // offsets in the tile's data -> in the codestream
        int64_t off = ranges[i].first, base = 0;
        for (auto [at, len] : cs.tiles[k].parts) {
          if (off < base + len) {
            ranges[i].first = at + off - base;
            break;
          }
          base += len;
        }
      }
      first = ranges.size();
    });
    for (size_t i = 0; i < ranges.size() && int64_t(i) < capacity; i++)
      out[2 * i] = ranges[i].first, out[2 * i + 1] = ranges[i].second;
    return (long long)ranges.size();
  } catch (const Error& e) {
    g_error = e.msg;
  } catch (const std::bad_alloc&) {
    g_error = "out of memory";
  }
  return -1;
}

}  // extern "C"

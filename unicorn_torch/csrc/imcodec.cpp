// Host image codec of the port's data path: a JPEG decoder, the PNG
// unfilter and colour conversions, and cv2.fillPoly's polygon fill, with a
// plain C interface (bound by unicorn_torch/data/image_io.py with ctypes).
//
// The output is what cv2.imread gives on an OpenCV built with libjpeg-turbo
// and libpng, bit for bit:
//   JPEG  Huffman-coded 8-bit baseline / extended / progressive, 1 or 3
//         components, integral sampling ratios, restart intervals; libjpeg's
//         integer "islow" IDCT (jidctint.c), its fancy upsampling (h2v1,
//         h2v2, h1v2 triangle filters with libjpeg-turbo's rounding biases;
//         other factors, and widths of 2 samples or less, replicated) and
//         its fixed-point YCbCr -> BGR tables (jdcolor.c). A grayscale read
//         of a colour file is the Y plane (libjpeg's JCS_GRAYSCALE).
//   PNG   the five filters, bit depths 1-16, every colour type; for colour
//         reads alpha is dropped, a palette expanded, 16 bits keep the high
//         byte; grayscale reads of colour data use libpng's rgb_to_gray with
//         OpenCV's coefficients (0.299, 0.587) in 1/32768, without gamma
//         (image_io.py refuses colour PNGs that declare one for them).
//   EXIF  the orientation tag of the first APP1 segment (JPEG) or of the
//         eXIf chunk (PNG), applied as cv2.imread applies it.
// Anything outside that set is refused with a message: nothing is guessed.
#include <stdint.h>
#include <string.h>

#include <algorithm>
#include <climits>
#include <cstdio>
#include <vector>

namespace {

enum Status { OK = 0, NOT_IMPLEMENTED = 1, INVALID = 2 };

struct Err {
  char* buf;
  int len;
  int fail(int code, const char* msg) {
    if (buf && len > 0) snprintf(buf, (size_t)len, "%s", msg);
    return code;
  }
};

// ------------------------------------------------------------------ EXIF
// The orientation of a TIFF block (OpenCV's ExifReader: the byte order,
// the 0x2A mark, IFD0's entries; tag 0x0112 of type SHORT). 1 when absent.
int tiff_orientation(const uint8_t* d, int64_t n) {
  if (n < 8 || d[0] != d[1] || (d[0] != 'I' && d[0] != 'M')) return 1;
  const bool le = d[0] == 'I';
  auto u16 = [&](int64_t o) -> int64_t {
    if (o < 0 || o + 2 > n) return -1;
    return le ? (d[o] | (d[o + 1] << 8)) : ((d[o] << 8) | d[o + 1]);
  };
  auto u32 = [&](int64_t o) -> int64_t {
    if (o < 0 || o + 4 > n) return -1;
    return le ? ((int64_t)d[o] | ((int64_t)d[o + 1] << 8) |
                 ((int64_t)d[o + 2] << 16) | ((int64_t)d[o + 3] << 24))
              : (((int64_t)d[o] << 24) | ((int64_t)d[o + 1] << 16) |
                 ((int64_t)d[o + 2] << 8) | (int64_t)d[o + 3]);
  };
  if (u16(2) != 0x2A) return 1;
  int64_t off = u32(4);
  int64_t count = u16(off);
  if (off < 0 || count < 0) return 1;
  for (int64_t e = 0; e < count; e++) {
    int64_t o = off + 2 + 12 * e;
    int64_t tag = u16(o);
    if (tag < 0) return 1;
    if (tag == 0x0112) {
      if (u16(o + 2) != 3) return 1;
      int64_t v = u16(o + 8);
      return v < 0 ? 1 : (int)v;
    }
  }
  return 1;
}

// Source pixel of output pixel (r, c) under an EXIF orientation; the
// output of 5-8 is the transpose's shape.
inline void orient_src(int o, int H, int W, int r, int c, int* sr, int* sc) {
  switch (o) {
    case 2: *sr = r; *sc = W - 1 - c; break;
    case 3: *sr = H - 1 - r; *sc = W - 1 - c; break;
    case 4: *sr = H - 1 - r; *sc = c; break;
    case 5: *sr = c; *sc = r; break;
    case 6: *sr = H - 1 - c; *sc = r; break;
    case 7: *sr = H - 1 - c; *sc = W - 1 - r; break;
    case 8: *sr = c; *sc = W - 1 - r; break;
    default: *sr = r; *sc = c;
  }
}

void apply_orientation(int o, const uint8_t* src, int H, int W, int C,
                       uint8_t* dst) {
  const bool t = o >= 5 && o <= 8;
  const int oh = t ? W : H, ow = t ? H : W;
  for (int r = 0; r < oh; r++) {
    uint8_t* d = dst + (int64_t)r * ow * C;
    for (int c = 0; c < ow; c++) {
      int sr, sc;
      orient_src(o, H, W, r, c, &sr, &sc);
      const uint8_t* s = src + ((int64_t)sr * W + sc) * C;
      for (int k = 0; k < C; k++) d[c * C + k] = s[k];
    }
  }
}

// ------------------------------------------------------------------ JPEG
const int kZigzag[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // extra entries guard against corrupt runs (as libjpeg's table does)
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huff {
  bool defined = false;
  uint16_t fast[512];   // 9-bit lookahead: (length << 8) | value, 0 = slow
  int32_t maxcode[18];
  int32_t valoff[17];   // index of the first value of each length - mincode
  uint8_t vals[256];
  void build(const uint8_t* bits, const uint8_t* v, int nv) {
    memset(fast, 0, sizeof(fast));
    memcpy(vals, v, (size_t)nv);
    int code = 0, k = 0;
    for (int l = 1; l <= 16; l++) {
      valoff[l] = k - code;
      if (bits[l - 1]) {
        for (int i = 0; i < bits[l - 1]; i++, k++, code++) {
          if (l <= 9) {
            int shift = 9 - l;
            for (int j = 0; j < (1 << shift); j++)
              fast[(code << shift) | j] = (uint16_t)((l << 8) | v[k]);
          }
        }
        maxcode[l] = code - 1;
      } else {
        maxcode[l] = -1;
      }
      code <<= 1;
    }
    maxcode[17] = INT_MAX;
    defined = true;
  }
};

struct Bits {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;
  int n = 0;
  bool marker = false;  // stopped at a marker: zeros are fed from here
  void fill() {
    while (n <= 56) {
      uint64_t b = 0;
      if (!marker && p < end) {
        b = *p;
        if (b == 0xFF) {
          uint8_t nx = p + 1 < end ? p[1] : 0xD9;
          if (nx == 0x00) {
            p += 2;
          } else {
            marker = true;
            b = 0;
          }
        } else {
          p++;
        }
      }
      acc |= b << (56 - n);
      n += 8;
    }
  }
  inline uint32_t peek(int k) {
    if (n < k) fill();
    return (uint32_t)(acc >> (64 - k));
  }
  inline void skip(int k) {
    acc <<= k;
    n -= k;
  }
  inline int get(int k) {
    if (k == 0) return 0;
    uint32_t v = peek(k);
    skip(k);
    return (int)v;
  }
  inline int bit() { return get(1); }
  // restart: drop the buffered bits and move past the next RSTn marker
  void restart() {
    acc = 0;
    n = 0;
    if (!marker) {
      while (p + 1 < end && !(p[0] == 0xFF && p[1] != 0 && p[1] != 0xFF)) p++;
    }
    if (p + 1 < end && p[0] == 0xFF && p[1] >= 0xD0 && p[1] <= 0xD7) p += 2;
    marker = false;
  }
};

inline int decode_huff(Bits& b, const Huff& h) {
  uint32_t look = b.peek(16);
  int e = h.fast[look >> 7];
  if (e) {
    b.skip(e >> 8);
    return e & 0xFF;
  }
  for (int l = 10; l <= 16; l++) {
    int32_t c = (int32_t)(look >> (16 - l));
    if (c <= h.maxcode[l]) {
      b.skip(l);
      return h.vals[(h.valoff[l] + c) & 0xFF];
    }
  }
  b.skip(16);  // corrupt data: libjpeg warns and yields 0
  return 0;
}

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v + (int)((~0u) << s) + 1 : v;
}

struct Comp {
  int id, h, v, tq;
  int bw, bh;          // blocks allocated (whole MCUs)
  int dw, dh;          // downsampled width / height in samples
  int dc_tbl, ac_tbl;
  int pred;
  bool latched = false;
  uint16_t q[64];      // the quantisation table, latched at first use
  std::vector<int16_t> coef;
  std::vector<uint8_t> plane;  // (bh * 8) x (bw * 8) samples after the IDCT
};

// jdcolor.c's build_ycc_rgb_table (built once, thread-safe static init)
struct YccTables {
  int cr_r[256], cb_b[256], cr_g[256], cb_g[256];
  YccTables() {
    const int SB = 16;
    const int64_t half = (int64_t)1 << (SB - 1);
    auto FIX = [](double x) { return (int64_t)(x * (1 << 16) + 0.5); };
    for (int i = 0, x = -128; i < 256; i++, x++) {
      cr_r[i] = (int)((FIX(1.40200) * x + half) >> SB);
      cb_b[i] = (int)((FIX(1.77200) * x + half) >> SB);
      cr_g[i] = (int)(-FIX(0.71414) * x);
      cb_g[i] = (int)(-FIX(0.34414) * x + half);
    }
  }
};

struct Jpeg {
  const uint8_t* buf;
  int64_t n;
  Err err;
  uint16_t qt[4][64];
  bool qdef[4] = {false, false, false, false};
  Huff dc[4], ac[4];
  int W = 0, H = 0, nc = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  bool progressive = false, sof = false, adobe = false, jfif = false;
  int adobe_transform = -1;
  int ri = 0;
  int orientation = 1;
  bool exif_seen = false;
  Comp comp[3];
  int eobrun = 0;

  int u16(int64_t o) const { return (buf[o] << 8) | buf[o + 1]; }

  int parse_sof(int64_t o, int len, int marker) {
    if (sof) return err.fail(INVALID, "more than one frame header");
    switch (marker) {
      case 0xC0: case 0xC1: break;
      case 0xC2: progressive = true; break;
      case 0xC3:
        return err.fail(NOT_IMPLEMENTED, "lossless JPEG (SOF3)");
      case 0xC5: case 0xC6: case 0xC7:
        return err.fail(NOT_IMPLEMENTED, "hierarchical JPEG (SOF5-7)");
      default:
        return err.fail(NOT_IMPLEMENTED, "arithmetic-coded JPEG (SOF9-15)");
    }
    if (len < 8) return err.fail(INVALID, "short frame header");
    int prec = buf[o];
    if (prec != 8) {
      char m[96];
      snprintf(m, sizeof(m), "%d-bit JPEG samples (only 8-bit)", prec);
      return err.fail(NOT_IMPLEMENTED, m);
    }
    H = u16(o + 1);
    W = u16(o + 3);
    nc = buf[o + 5];
    if (nc == 4)
      return err.fail(NOT_IMPLEMENTED, "4-component (CMYK / YCCK) JPEG");
    if (nc != 1 && nc != 3) {
      char m[96];
      snprintf(m, sizeof(m), "%d-component JPEG", nc);
      return err.fail(NOT_IMPLEMENTED, m);
    }
    if (W == 0 || H == 0)
      return err.fail(INVALID, "JPEG of zero width or height");
    if ((int64_t)W * H > (int64_t)1 << 30)  // OpenCV's CV_IO_MAX_IMAGE_PIXELS
      return err.fail(INVALID, "JPEG of more than 2**30 pixels");
    if (len < 6 + 3 * nc) return err.fail(INVALID, "short frame header");
    for (int i = 0; i < nc; i++) {
      Comp& c = comp[i];
      c.id = buf[o + 6 + 3 * i];
      c.h = buf[o + 7 + 3 * i] >> 4;
      c.v = buf[o + 7 + 3 * i] & 15;
      c.tq = buf[o + 8 + 3 * i] & 3;
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4)
        return err.fail(INVALID, "JPEG sampling factor outside 1-4");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    for (int i = 0; i < nc; i++)
      if (hmax % comp[i].h || vmax % comp[i].v)
        return err.fail(NOT_IMPLEMENTED,
                        "JPEG with fractional sampling ratios");
    mcux = (W + 8 * hmax - 1) / (8 * hmax);
    mcuy = (H + 8 * vmax - 1) / (8 * vmax);
    sof = true;
    return OK;
  }

  // Headers up to the frame header (and the EXIF block before it).
  int header() {
    if (n < 4 || buf[0] != 0xFF || buf[1] != 0xD8)
      return err.fail(INVALID, "not a JPEG (no SOI marker)");
    int64_t o = 2;
    while (o + 4 <= n) {
      if (buf[o] != 0xFF) { o++; continue; }
      int m = buf[o + 1];
      if (m == 0xFF) { o++; continue; }
      if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) { o += 2; continue; }
      if (m == 0xD9 || m == 0xDA) break;
      int len = u16(o + 2);
      if (len < 2 || o + 2 + len > n) return err.fail(INVALID, "truncated JPEG header");
      int64_t d = o + 4;
      if (m == 0xE1 && !exif_seen) {
        exif_seen = true;  // OpenCV reads the first APP1 only
        if (len - 2 > 6) orientation = tiff_orientation(buf + d + 6, len - 2 - 6);
      } else if (m == 0xE0 && len >= 7 && !memcmp(buf + d, "JFIF\0", 5)) {
        jfif = true;
      } else if (m == 0xEE && len >= 14 && !memcmp(buf + d, "Adobe", 5)) {
        adobe = true;
        adobe_transform = buf[d + 11];
      } else if ((m >= 0xC0 && m <= 0xCF) && m != 0xC4 && m != 0xC8 && m != 0xCC) {
        int r = parse_sof(d, len - 2, m);
        if (r) return r;
        return OK;
      }
      o += 2 + len;
    }
    return err.fail(INVALID, "no JPEG frame header");
  }

  // 0 = YCbCr, 1 = RGB (libjpeg's default_decompress_parms for 3 components)
  int colour_transform() const {
    if (nc != 3) return 0;
    if (jfif) return 0;
    if (adobe) return adobe_transform == 0 ? 1 : 0;
    if (comp[0].id == 1 && comp[1].id == 2 && comp[2].id == 3) return 0;
    if (comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66) return 1;
    return 0;
  }

  int parse_dqt(int64_t o, int len) {
    int64_t end = o + len;
    while (o < end) {
      int pq = buf[o] >> 4, tq = buf[o] & 3;
      o++;
      if (o + (pq ? 128 : 64) > end) return err.fail(INVALID, "short DQT");
      for (int k = 0; k < 64; k++) {
        qt[tq][kZigzag[k]] = pq ? (uint16_t)u16(o + 2 * k) : buf[o + k];
      }
      qdef[tq] = true;
      o += pq ? 128 : 64;
    }
    return OK;
  }

  int parse_dht(int64_t o, int len) {
    int64_t end = o + len;
    while (o < end) {
      if (o + 17 > end) return err.fail(INVALID, "short DHT");
      int tc = buf[o] >> 4, th = buf[o] & 3;
      const uint8_t* bits = buf + o + 1;
      int total = 0;
      for (int i = 0; i < 16; i++) total += bits[i];
      if (total > 256 || o + 17 + total > end) return err.fail(INVALID, "bad DHT");
      if (!tc)  // a DC symbol is a bit count (jpeg_make_d_derived_tbl's check)
        for (int i = 0; i < total; i++)
          if (buf[o + 17 + i] > 15) return err.fail(INVALID, "bad DC Huffman table");
      (tc ? ac[th] : dc[th]).build(bits, buf + o + 17, total);
      o += 17 + total;
    }
    return OK;
  }

  void allocate() {
    for (int i = 0; i < nc; i++) {
      Comp& c = comp[i];
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dw = (int)(((int64_t)W * c.h + hmax - 1) / hmax);
      c.dh = (int)(((int64_t)H * c.v + vmax - 1) / vmax);
      c.coef.assign((size_t)c.bw * c.bh * 64, 0);
    }
  }

  inline void decode_block_baseline(Bits& b, Comp& c, int16_t* blk) {
    const Huff& hd = dc[c.dc_tbl];
    const Huff& ha = ac[c.ac_tbl];
    int s = decode_huff(b, hd);
    int diff = s ? extend(b.get(s), s) : 0;
    c.pred = (int)((unsigned)c.pred + (unsigned)diff);
    blk[0] = (int16_t)c.pred;
    for (int k = 1; k < 64; k++) {
      int rs = decode_huff(b, ha);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[kZigzag[k]] = (int16_t)extend(b.get(s), s);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  inline void dc_first(Bits& b, Comp& c, int16_t* blk, int al) {
    int s = decode_huff(b, dc[c.dc_tbl]);
    int diff = s ? extend(b.get(s), s) : 0;
    c.pred = (int)((unsigned)c.pred + (unsigned)diff);
    blk[0] = (int16_t)((unsigned)c.pred << al);
  }

  inline void dc_refine(Bits& b, int16_t* blk, int al) {
    if (b.bit()) blk[0] |= (int16_t)(1 << al);
  }

  inline void ac_first(Bits& b, Comp& c, int16_t* blk, int ss, int se, int al) {
    if (eobrun > 0) { eobrun--; return; }
    const Huff& ha = ac[c.ac_tbl];
    for (int k = ss; k <= se; k++) {
      int rs = decode_huff(b, ha);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[kZigzag[k]] = (int16_t)((unsigned)extend(b.get(s), s) << al);
      } else {
        if (r == 15) {
          k += 15;
        } else {
          eobrun = 1 << r;
          if (r) eobrun += b.get(r);
          eobrun--;
          break;
        }
      }
    }
  }

  inline void ac_refine(Bits& b, Comp& c, int16_t* blk, int ss, int se, int al) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int k = ss;
    if (eobrun == 0) {
      const Huff& ha = ac[c.ac_tbl];
      for (; k <= se; k++) {
        int rs = decode_huff(b, ha);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = b.bit() ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += b.get(r);
          break;
        }
        do {
          int16_t* t = blk + kZigzag[k];
          if (*t != 0) {
            if (b.bit()) {
              if ((*t & p1) == 0) *t = (int16_t)(*t >= 0 ? *t + p1 : *t + m1);
            }
          } else {
            if (--r < 0) break;
          }
          k++;
        } while (k <= se);
        if (s) blk[kZigzag[k]] = (int16_t)s;
      }
    }
    if (eobrun > 0) {
      for (; k <= se; k++) {
        int16_t* t = blk + kZigzag[k];
        if (*t != 0) {
          if (b.bit()) {
            if ((*t & p1) == 0) *t = (int16_t)(*t >= 0 ? *t + p1 : *t + m1);
          }
        }
      }
      eobrun--;
    }
  }

  // One scan: returns the offset just past its entropy-coded data.
  int scan(int64_t o, int len, int64_t* next) {
    int ns = buf[o];
    if (ns < 1 || ns > nc || len < 1 + 2 * ns + 3)
      return err.fail(INVALID, "bad scan header");
    Comp* sc[3];
    for (int i = 0; i < ns; i++) {
      int cid = buf[o + 1 + 2 * i], t = buf[o + 2 + 2 * i];
      Comp* c = nullptr;
      for (int j = 0; j < nc; j++)
        if (comp[j].id == cid) c = &comp[j];
      if (!c) return err.fail(INVALID, "scan names an unknown component");
      c->dc_tbl = t >> 4 & 3;
      c->ac_tbl = t & 3;
      if (!c->latched) {
        if (!qdef[c->tq]) return err.fail(INVALID, "missing quantisation table");
        memcpy(c->q, qt[c->tq], sizeof(c->q));
        c->latched = true;
      }
      c->pred = 0;
      sc[i] = c;
    }
    int ss = buf[o + 1 + 2 * ns], se = buf[o + 2 + 2 * ns];
    int ah = buf[o + 3 + 2 * ns] >> 4, al = buf[o + 3 + 2 * ns] & 15;
    if (!progressive) { ss = 0; se = 63; ah = al = 0; }
    if (se > 63 || ss > se || (progressive && ss == 0 && se != 0) ||
        (progressive && ss > 0 && ns != 1))
      return err.fail(INVALID, "bad progressive scan parameters");
    for (int i = 0; i < ns; i++) {
      if (ss == 0 && !dc[sc[i]->dc_tbl].defined && ah == 0)
        return err.fail(INVALID, "missing DC Huffman table");
      if (se > 0 && !ac[sc[i]->ac_tbl].defined && !(progressive && ss == 0))
        return err.fail(INVALID, "missing AC Huffman table");
    }
    eobrun = 0;
    Bits b;
    b.p = buf + o + len;
    b.end = buf + n;
    auto block = [&](Comp& c, int by, int bx) {
      int16_t* blk = c.coef.data() + ((size_t)by * c.bw + bx) * 64;
      if (!progressive) decode_block_baseline(b, c, blk);
      else if (ss == 0) {
        if (ah == 0) dc_first(b, c, blk, al);
        else dc_refine(b, blk, al);
      } else if (ah == 0) ac_first(b, c, blk, ss, se, al);
      else ac_refine(b, c, blk, ss, se, al);
    };
    int64_t mcus_done = 0;
    auto after_mcu = [&](int64_t total) {
      mcus_done++;
      if (ri && mcus_done % ri == 0 && mcus_done < total) {
        b.restart();
        for (int i = 0; i < ns; i++) sc[i]->pred = 0;
        eobrun = 0;
      }
    };
    if (ns == 1) {
      Comp& c = *sc[0];
      int nbx = (c.dw + 7) / 8, nby = (c.dh + 7) / 8;
      int64_t total = (int64_t)nbx * nby;
      for (int by = 0; by < nby; by++)
        for (int bx = 0; bx < nbx; bx++) {
          block(c, by, bx);
          after_mcu(total);
        }
    } else {
      int64_t total = (int64_t)mcux * mcuy;
      for (int my = 0; my < mcuy; my++)
        for (int mx = 0; mx < mcux; mx++) {
          for (int i = 0; i < ns; i++) {
            Comp& c = *sc[i];
            for (int v = 0; v < c.v; v++)
              for (int h = 0; h < c.h; h++)
                block(c, my * c.v + v, mx * c.h + h);
          }
          after_mcu(total);
        }
    }
    // the next marker after the entropy-coded data
    const uint8_t* p = b.p;
    while (p + 1 < buf + n && !(p[0] == 0xFF && p[1] != 0 &&
                                 !(p[1] >= 0xD0 && p[1] <= 0xD7) && p[1] != 0xFF))
      p++;
    *next = p - buf;
    return OK;
  }

  int decode_coefficients() {
    int64_t o = 2;
    bool allocated = false;
    while (o + 2 <= n) {
      if (buf[o] != 0xFF) { o++; continue; }
      int m = buf[o + 1];
      if (m == 0xFF) { o++; continue; }
      if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) { o += 2; continue; }
      if (m == 0xD9) break;
      if (o + 4 > n) break;
      int len = u16(o + 2);
      if (len < 2 || o + 2 + len > n) return err.fail(INVALID, "truncated JPEG segment");
      int64_t d = o + 4;
      int r = OK;
      if (m == 0xDB) r = parse_dqt(d, len - 2);
      else if (m == 0xC4) r = parse_dht(d, len - 2);
      else if (m == 0xCC) r = err.fail(NOT_IMPLEMENTED, "arithmetic-coded JPEG (DAC)");
      else if (m == 0xDD) { if (len < 4) return err.fail(INVALID, "short DRI"); ri = u16(d); }
      else if (m == 0xDA) {
        if (!sof) return err.fail(INVALID, "scan before the frame header");
        if (!allocated) { allocate(); allocated = true; }
        int64_t next;
        r = scan(d, len - 2, &next);
        if (r) return r;
        o = next;
        continue;
      }
      if (r) return r;
      o += 2 + len;
    }
    if (!allocated) return err.fail(INVALID, "JPEG without a scan");
    return OK;
  }

  // ---- jidctint.c's jpeg_idct_islow
  static inline uint8_t range_limit(int x) {
    // IDCT_range_limit[x & RANGE_MASK]: x + 128 clamped, wrapping as
    // libjpeg's table does past +-512
    int i = x & 1023;
    if (i < 128) return (uint8_t)(i + 128);
    if (i < 512) return 255;
    if (i < 896) return 0;
    return (uint8_t)(i - 896);
  }

  static void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                         int stride) {
    const int CB = 13, P1 = 2;
    const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                  F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                  F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;
    int ws[64];
    for (int col = 0; col < 8; col++) {
      const int16_t* ip = in + col;
      const uint16_t* qp = q + col;
      int* wp = ws + col;
      if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 &&
          ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
        int dc = (int)ip[0] * qp[0] * (1 << P1);
        for (int r = 0; r < 8; r++) wp[8 * r] = dc;
        continue;
      }
      int64_t z2 = (int64_t)ip[16] * qp[16], z3 = (int64_t)ip[48] * qp[48];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * (-F1847);
      int64_t tmp3 = z1 + z2 * F0765;
      z2 = (int64_t)ip[0] * qp[0];
      z3 = (int64_t)ip[32] * qp[32];
      int64_t tmp0 = (z2 + z3) * (1 << CB);
      int64_t tmp1 = (z2 - z3) * (1 << CB);
      int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3;
      int64_t t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
      tmp0 = (int64_t)ip[56] * qp[56];
      tmp1 = (int64_t)ip[40] * qp[40];
      tmp2 = (int64_t)ip[24] * qp[24];
      tmp3 = (int64_t)ip[8] * qp[8];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298; tmp1 *= F2053; tmp2 *= F3072; tmp3 *= F1501;
      z1 *= -F0899; z2 *= -F2562; z3 *= -F1961; z4 *= -F0390;
      z3 += z5; z4 += z5;
      tmp0 += z1 + z3; tmp1 += z2 + z4; tmp2 += z2 + z3; tmp3 += z1 + z4;
      const int sh = CB - P1;
      const int64_t rnd = (int64_t)1 << (sh - 1);
      wp[0] = (int)((t10 + tmp3 + rnd) >> sh);
      wp[56] = (int)((t10 - tmp3 + rnd) >> sh);
      wp[8] = (int)((t11 + tmp2 + rnd) >> sh);
      wp[48] = (int)((t11 - tmp2 + rnd) >> sh);
      wp[16] = (int)((t12 + tmp1 + rnd) >> sh);
      wp[40] = (int)((t12 - tmp1 + rnd) >> sh);
      wp[24] = (int)((t13 + tmp0 + rnd) >> sh);
      wp[32] = (int)((t13 - tmp0 + rnd) >> sh);
    }
    for (int row = 0; row < 8; row++) {
      const int* wp = ws + 8 * row;
      uint8_t* op = out + (int64_t)row * stride;
      if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 &&
          wp[5] == 0 && wp[6] == 0 && wp[7] == 0) {
        uint8_t v = range_limit((int)(((int64_t)wp[0] + (1 << (P1 + 2))) >> (P1 + 3)));
        for (int c = 0; c < 8; c++) op[c] = v;
        continue;
      }
      int64_t z2 = wp[2], z3 = wp[6];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * (-F1847);
      int64_t tmp3 = z1 + z2 * F0765;
      int64_t tmp0 = ((int64_t)wp[0] + wp[4]) * (1 << CB);
      int64_t tmp1 = ((int64_t)wp[0] - wp[4]) * (1 << CB);
      int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3;
      int64_t t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
      tmp0 = wp[7]; tmp1 = wp[5]; tmp2 = wp[3]; tmp3 = wp[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298; tmp1 *= F2053; tmp2 *= F3072; tmp3 *= F1501;
      z1 *= -F0899; z2 *= -F2562; z3 *= -F1961; z4 *= -F0390;
      z3 += z5; z4 += z5;
      tmp0 += z1 + z3; tmp1 += z2 + z4; tmp2 += z2 + z3; tmp3 += z1 + z4;
      const int sh = CB + P1 + 3;
      const int64_t rnd = (int64_t)1 << (sh - 1);
      op[0] = range_limit((int)((t10 + tmp3 + rnd) >> sh));
      op[7] = range_limit((int)((t10 - tmp3 + rnd) >> sh));
      op[1] = range_limit((int)((t11 + tmp2 + rnd) >> sh));
      op[6] = range_limit((int)((t11 - tmp2 + rnd) >> sh));
      op[2] = range_limit((int)((t12 + tmp1 + rnd) >> sh));
      op[5] = range_limit((int)((t12 - tmp1 + rnd) >> sh));
      op[3] = range_limit((int)((t13 + tmp0 + rnd) >> sh));
      op[4] = range_limit((int)((t13 - tmp0 + rnd) >> sh));
    }
  }

  void idct_all(int ncomp) {
    for (int i = 0; i < ncomp; i++) {
      Comp& c = comp[i];
      // only the blocks that hold real samples are transformed
      int nbx = std::min(c.bw, (c.dw + 7) / 8), nby = std::min(c.bh, (c.dh + 7) / 8);
      int stride = c.bw * 8;
      c.plane.assign((size_t)stride * c.bh * 8, 0);
      for (int by = 0; by < nby; by++)
        for (int bx = 0; bx < nbx; bx++)
          idct_islow(c.coef.data() + ((size_t)by * c.bw + bx) * 64, c.q,
                     c.plane.data() + (size_t)by * 8 * stride + bx * 8, stride);
      std::vector<int16_t>().swap(c.coef);
    }
  }

  // ---- jdsample.c: one output row (W samples, at least) of a component
  void upsample_row(const Comp& c, int y, uint8_t* dst) const {
    const int stride = c.bw * 8;
    const int he = hmax / c.h, ve = vmax / c.v;
    const uint8_t* pl = c.plane.data();
    const int dw = c.dw;
    if (he == 1 && ve == 1) {
      memcpy(dst, pl + (size_t)y * stride, (size_t)W);
      return;
    }
    const bool fancy_h2 = he == 2 && dw > 2;
    if (he == 2 && ve == 2 && fancy_h2) {  // h2v2_fancy_upsample
      int i = y >> 1;
      int nb = (y & 1) ? std::min(i + 1, c.dh - 1) : std::max(i - 1, 0);
      const uint8_t* r0 = pl + (size_t)i * stride;
      const uint8_t* r1 = pl + (size_t)nb * stride;
      int last = r0[0] * 3 + r1[0];
      int cur = last;
      int nxt = r0[1] * 3 + r1[1];
      uint8_t* o = dst;
      *o++ = (uint8_t)((cur * 4 + 8) >> 4);
      *o++ = (uint8_t)((cur * 3 + nxt + 7) >> 4);
      last = cur;
      cur = nxt;
      for (int x = 2; x < dw; x++) {
        nxt = r0[x] * 3 + r1[x];
        *o++ = (uint8_t)((cur * 3 + last + 8) >> 4);
        *o++ = (uint8_t)((cur * 3 + nxt + 7) >> 4);
        last = cur;
        cur = nxt;
      }
      *o++ = (uint8_t)((cur * 3 + last + 8) >> 4);
      *o++ = (uint8_t)((cur * 4 + 7) >> 4);
      return;
    }
    if (he == 2 && ve == 1 && fancy_h2) {  // h2v1_fancy_upsample
      const uint8_t* r = pl + (size_t)y * stride;
      uint8_t* o = dst;
      int v = r[0];
      *o++ = (uint8_t)v;
      *o++ = (uint8_t)((v * 3 + r[1] + 2) >> 2);
      for (int x = 1; x < dw - 1; x++) {
        v = r[x] * 3;
        *o++ = (uint8_t)((v + r[x - 1] + 1) >> 2);
        *o++ = (uint8_t)((v + r[x + 1] + 2) >> 2);
      }
      v = r[dw - 1];
      *o++ = (uint8_t)((v * 3 + r[dw - 2] + 1) >> 2);
      *o++ = (uint8_t)v;
      return;
    }
    if (he == 1 && ve == 2) {  // h1v2_fancy_upsample
      int i = y >> 1;
      int nb = (y & 1) ? std::min(i + 1, c.dh - 1) : std::max(i - 1, 0);
      int bias = (y & 1) ? 2 : 1;
      const uint8_t* r0 = pl + (size_t)i * stride;
      const uint8_t* r1 = pl + (size_t)nb * stride;
      for (int x = 0; x < dw; x++)
        dst[x] = (uint8_t)((r0[x] * 3 + r1[x] + bias) >> 2);
      return;
    }
    // replicated (h2v1 / h2v2 at widths of 2 samples or less)
    const uint8_t* r = pl + (size_t)(y / ve) * stride;
    for (int x = 0; x < W; x++) dst[x] = r[x / he];
  }

  // ---- jdcolor.c
  void convert(int gray, uint8_t* out) const {
    std::vector<uint8_t> rows((size_t)3 * (2 * (size_t)(mcux * hmax * 8) + 16));
    const size_t rs = rows.size() / 3;
    uint8_t* r0 = rows.data();
    uint8_t* r1 = r0 + rs;
    uint8_t* r2 = r1 + rs;
    const int transform = colour_transform();
    static const YccTables tab;
    const int *cr_r = tab.cr_r, *cb_b = tab.cb_b, *cr_g = tab.cr_g, *cb_g = tab.cb_g;
    auto clamp = [](int v) -> uint8_t { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); };
    for (int y = 0; y < H; y++) {
      if (nc == 1) {
        upsample_row(comp[0], y, r0);
        if (gray) {
          memcpy(out + (size_t)y * W, r0, (size_t)W);
        } else {
          uint8_t* o = out + (size_t)y * W * 3;
          for (int x = 0; x < W; x++) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = r0[x];
        }
        continue;
      }
      upsample_row(comp[0], y, r0);
      if (gray && transform == 0) {
        memcpy(out + (size_t)y * W, r0, (size_t)W);
        continue;
      }
      upsample_row(comp[1], y, r1);
      upsample_row(comp[2], y, r2);
      if (gray) {  // rgb_gray_convert
        const int64_t FY[3] = {19595, 38470, 7471};  // FIX(0.299 / 0.587 / 0.114)
        uint8_t* o = out + (size_t)y * W;
        for (int x = 0; x < W; x++)
          o[x] = (uint8_t)((FY[0] * r0[x] + FY[1] * r1[x] + FY[2] * r2[x] +
                            ((int64_t)1 << 15)) >> 16);
        continue;
      }
      uint8_t* o = out + (size_t)y * W * 3;
      if (transform == 1) {
        for (int x = 0; x < W; x++) {
          o[3 * x] = r2[x];
          o[3 * x + 1] = r1[x];
          o[3 * x + 2] = r0[x];
        }
        continue;
      }
      for (int x = 0; x < W; x++) {
        int Y = r0[x], cb = r1[x], cr = r2[x];
        o[3 * x + 2] = clamp(Y + cr_r[cr]);
        o[3 * x + 1] = clamp(Y + ((cb_g[cb] + cr_g[cr]) >> 16));
        o[3 * x] = clamp(Y + cb_b[cb]);
      }
    }
  }
};

// ------------------------------------------------------------------ PNG
inline int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = p > a ? p - a : a - p, pb = p > b ? p - b : b - p, pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// ---------------------------------------------------------- fillPoly
const int XY_SHIFT = 16;
const int64_t XY_ONE = (int64_t)1 << XY_SHIFT;

struct PolyEdge {
  int y0, y1;
  int64_t x, dx;
  PolyEdge* next;
};

bool clip_line(int64_t w, int64_t h, int64_t& x1, int64_t& y1, int64_t& x2,
               int64_t& y2) {
  if (w <= 0 || h <= 0) return false;
  int64_t right = w - 1, bottom = h - 1;
  int c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8;
  int c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8;
  if ((c1 & c2) == 0 && (c1 | c2) != 0) {
    int64_t a;
    if (c1 & 12) {
      a = c1 < 8 ? 0 : bottom;
      x1 += (int64_t)((double)(a - y1) * (x2 - x1) / (y2 - y1));
      y1 = a;
      c1 = (x1 < 0) + (x1 > right) * 2;
    }
    if (c2 & 12) {
      a = c2 < 8 ? 0 : bottom;
      x2 += (int64_t)((double)(a - y2) * (x2 - x1) / (y2 - y1));
      y2 = a;
      c2 = (x2 < 0) + (x2 > right) * 2;
    }
    if ((c1 & c2) == 0 && (c1 | c2) != 0) {
      if (c1) {
        a = c1 == 1 ? 0 : right;
        y1 += (int64_t)((double)(a - x1) * (y2 - y1) / (x2 - x1));
        x1 = a;
        c1 = 0;
      }
      if (c2) {
        a = c2 == 1 ? 0 : right;
        y2 += (int64_t)((double)(a - x2) * (y2 - y1) / (x2 - x1));
        x2 = a;
        c2 = 0;
      }
    }
  }
  return (c1 | c2) == 0;
}

// cv::Line with an 8-connected LineIterator, left to right
void draw_line(uint8_t* img, int h, int w, int64_t x1, int64_t y1, int64_t x2,
               int64_t y2, uint8_t value) {
  if ((uint64_t)x1 >= (uint64_t)w || (uint64_t)x2 >= (uint64_t)w ||
      (uint64_t)y1 >= (uint64_t)h || (uint64_t)y2 >= (uint64_t)h) {
    if (!clip_line(w, h, x1, y1, x2, y2)) return;
  }
  int64_t dx = x2 - x1, dy = y2 - y1;
  int64_t sx = 1, sy = 1;
  int64_t px = x1, py = y1;
  if (dx < 0) {  // left to right
    dx = -dx;
    dy = -dy;
    px = x2;
    py = y2;
  }
  if (dy < 0) {
    dy = -dy;
    sy = -1;
  }
  bool vert = dy > dx;
  if (vert) std::swap(dx, dy);
  int64_t err = dx - (dy + dy);
  int64_t plus = dx + dx, minus = -(dy + dy);
  int64_t count = dx + 1;
  for (int64_t i = 0; i < count; i++) {
    img[py * w + px] = value;
    bool m = err < 0;
    err += minus + (m ? plus : 0);
    if (vert) {
      py += sy;
      if (m) px += sx;
    } else {
      px += sx;
      if (m) py += sy;
    }
  }
}

}  // namespace

extern "C" {

int imc_tiff_orientation(const uint8_t* d, int64_t n) {
  return tiff_orientation(d, n);
}

// Header of a JPEG: the decoded image's height and width (after the EXIF
// orientation) and the number of components. Returns 0, 1 (not
// implemented) or 2 (invalid), with a message in err.
int imc_jpeg_header(const uint8_t* buf, int64_t n, int* h, int* w, int* nc,
                    char* err, int errlen) {
  Jpeg j;
  j.buf = buf;
  j.n = n;
  j.err = Err{err, errlen};
  int r = j.header();
  if (r) return r;
  const bool t = j.orientation >= 5 && j.orientation <= 8;
  *h = t ? j.W : j.H;
  *w = t ? j.H : j.W;
  *nc = j.nc;
  return OK;
}

// Decode into out: (h, w, 3) BGR, or (h, w) for gray != 0, with the shape
// imc_jpeg_header gave.
int imc_jpeg_decode(const uint8_t* buf, int64_t n, int gray, uint8_t* out,
                    char* err, int errlen) {
  Jpeg j;
  j.buf = buf;
  j.n = n;
  j.err = Err{err, errlen};
  int r = j.header();
  if (r) return r;
  r = j.decode_coefficients();
  if (r) return r;
  const bool y_only = gray && j.colour_transform() == 0;
  j.idct_all(y_only ? 1 : j.nc);
  const int C = gray ? 1 : 3;
  if (j.orientation >= 2 && j.orientation <= 8) {
    std::vector<uint8_t> tmp((size_t)j.W * j.H * C);
    j.convert(gray, tmp.data());
    apply_orientation(j.orientation, tmp.data(), j.H, j.W, C, out);
  } else {
    j.convert(gray, out);
  }
  return OK;
}

// PNG after inflate: `raw` holds h rows of (filter byte + stride bytes) and
// is unfiltered in place. mode 0: (h, w, 3) BGR; 1: (h, w) gray; 2: the
// first channel of the stored samples (palette indices, gray, or red), as
// PIL gives it; 3: every stored 8-bit sample, (h, w, channels).
// `orientation` is applied to modes 0 and 1 (cv2.imread's).
int imc_png_decode(uint8_t* raw, int64_t rawlen, int w, int h, int depth,
                   int ctype, const uint8_t* plte, int npal, int mode,
                   int orientation, uint8_t* out, char* err, int errlen) {
  Err e{err, errlen};
  int ch;
  switch (ctype) {
    case 0: ch = 1; break;
    case 2: ch = 3; break;
    case 3: ch = 1; break;
    case 4: ch = 2; break;
    case 6: ch = 4; break;
    default: return e.fail(INVALID, "bad PNG colour type");
  }
  const int64_t bits = (int64_t)w * ch * depth;
  const int64_t stride = (bits + 7) / 8;
  const int bpp = std::max<int>(1, ch * depth / 8);
  if (rawlen < (stride + 1) * h) return e.fail(INVALID, "truncated PNG image data");
  // unfilter
  for (int y = 0; y < h; y++) {
    uint8_t* row = raw + y * (stride + 1);
    const uint8_t* prev = y ? raw + (y - 1) * (stride + 1) + 1 : nullptr;
    int f = row[0];
    uint8_t* r = row + 1;
    switch (f) {
      case 0: break;
      case 1:
        for (int64_t i = bpp; i < stride; i++) r[i] = (uint8_t)(r[i] + r[i - bpp]);
        break;
      case 2:
        if (prev) for (int64_t i = 0; i < stride; i++) r[i] = (uint8_t)(r[i] + prev[i]);
        break;
      case 3:
        for (int64_t i = 0; i < stride; i++) {
          int a = i >= bpp ? r[i - bpp] : 0, b = prev ? prev[i] : 0;
          r[i] = (uint8_t)(r[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < stride; i++) {
          int a = i >= bpp ? r[i - bpp] : 0, b = prev ? prev[i] : 0;
          int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          r[i] = (uint8_t)(r[i] + paeth(a, b, c));
        }
        break;
      default:
        return e.fail(INVALID, "bad PNG filter type");
    }
  }
  if (mode == 3) {
    // the stored 8-bit samples as they are (image_io.read_png; the caller
    // checks the depth): no palette, conversion or orientation
    for (int y = 0; y < h; y++)
      memcpy(out + (size_t)y * w * ch, raw + y * (stride + 1) + 1, (size_t)w * ch);
    return OK;
  }
  uint8_t pal[768];
  memset(pal, 0, sizeof(pal));
  memcpy(pal, plte, (size_t)std::min(npal, 256) * 3);
  const int C = mode == 0 ? 3 : 1;
  const bool oriented = mode != 2 && orientation >= 2 && orientation <= 8;
  std::vector<uint8_t> tmp;
  uint8_t* dst = out;
  if (oriented) {
    tmp.resize((size_t)w * h * C);
    dst = tmp.data();
  }
  // sample k of a row at `depth` bits, as an unsigned integer
  auto sample = [&](const uint8_t* r, int64_t k) -> int {
    switch (depth) {
      case 8: return r[k];
      case 16: return (r[2 * k] << 8) | r[2 * k + 1];
      default: {
        int64_t bit = k * depth;
        int sh = 8 - depth - (int)(bit & 7);
        return (r[bit >> 3] >> sh) & ((1 << depth) - 1);
      }
    }
  };
  // an 8-bit gray value of a gray sample (libpng's expand, or strip_16)
  auto gray8 = [&](int v) -> int {
    switch (depth) {
      case 1: return v ? 255 : 0;
      case 2: return v * 0x55;
      case 4: return v * 0x11;
      case 16: return v >> 8;
      default: return v;
    }
  };
  const uint32_t rc = 9797, gc = 19234, bc = 32768 - 9797 - 19234;
  for (int y = 0; y < h; y++) {
    const uint8_t* r = raw + y * (stride + 1) + 1;
    uint8_t* o = dst + (size_t)y * w * C;
    for (int x = 0; x < w; x++) {
      if (mode == 2) {
        int v = sample(r, (int64_t)x * ch);
        o[x] = (uint8_t)(ctype == 3 ? v : gray8(v));
        continue;
      }
      int R, G, B;
      if (ctype == 0 || ctype == 4) {
        int v = gray8(sample(r, (int64_t)x * ch));
        if (mode == 1) { o[x] = (uint8_t)v; continue; }
        R = G = B = v;
      } else if (ctype == 3) {
        int i = sample(r, x);
        R = pal[3 * i]; G = pal[3 * i + 1]; B = pal[3 * i + 2];
      } else if (depth == 16) {
        int r16 = sample(r, (int64_t)x * ch), g16 = sample(r, (int64_t)x * ch + 1),
            b16 = sample(r, (int64_t)x * ch + 2);
        if (mode == 1) {
          // libpng's 16-bit path always takes the rounded weighted sum
          uint32_t g = (rc * r16 + gc * g16 + bc * b16 + 16384) >> 15;
          o[x] = (uint8_t)(g >> 8);
          continue;
        }
        R = r16 >> 8; G = g16 >> 8; B = b16 >> 8;
      } else {
        R = sample(r, (int64_t)x * ch);
        G = sample(r, (int64_t)x * ch + 1);
        B = sample(r, (int64_t)x * ch + 2);
      }
      if (mode == 1) {
        o[x] = (uint8_t)((R == G && R == B) ? R : (rc * R + gc * G + bc * B) >> 15);
      } else {
        o[3 * x] = (uint8_t)B;
        o[3 * x + 1] = (uint8_t)G;
        o[3 * x + 2] = (uint8_t)R;
      }
    }
  }
  if (oriented) apply_orientation(orientation, tmp.data(), h, w, C, out);
  return OK;
}

// cv2.fillPoly(img, contours, value) on an (h, w) uint8 image with LINE_8
// and shift 0: the outline of every contour drawn with the 8-connected line
// iterator, then the even-odd fill of the collected edges.
void imc_fill_poly(uint8_t* img, int h, int w, const int32_t* pts,
                   const int32_t* npts, int ncontours, int value) {
  const uint8_t color = (uint8_t)value;
  std::vector<PolyEdge> edges;
  const int32_t* v = pts;
  for (int ci = 0; ci < ncontours; ci++) {
    int count = npts[ci];
    if (count <= 0) continue;
    int64_t p0x = (int64_t)v[2 * (count - 1)] * XY_ONE, p0y = v[2 * (count - 1) + 1];
    for (int i = 0; i < count; i++) {
      int64_t p1x = (int64_t)v[2 * i] * XY_ONE, p1y = v[2 * i + 1];
      int64_t t0x = (p0x + (XY_ONE >> 1)) >> XY_SHIFT, t0y = p0y;
      int64_t t1x = (p1x + (XY_ONE >> 1)) >> XY_SHIFT, t1y = p1y;
      draw_line(img, h, w, t0x, t0y, t1x, t1y, color);
      int64_t c0x = p0x, c0y = p0y, c1x = p1x, c1y = p1y;
      if ((uint64_t)t0x >= (uint64_t)w || (uint64_t)t1x >= (uint64_t)w ||
          (uint64_t)t0y >= (uint64_t)h || (uint64_t)t1y >= (uint64_t)h) {
        // the edge runs between the clipped ends (its x always, its y
        // where the clipped segment is not horizontal)
        clip_line(w, h, t0x, t0y, t1x, t1y);
        if (t0y != t1y) {
          c0y = t0y;
          c1y = t1y;
        }
        c0x = t0x * XY_ONE;
        c1x = t1x * XY_ONE;
      }
      if (p0y != p1y) {
        PolyEdge e;
        e.dx = (c1x - c0x) / (c1y - c0y);
        if (p0y < p1y) {
          e.y0 = (int)p0y;
          e.y1 = (int)p1y;
          e.x = c0x + (p0y - c0y) * e.dx;
        } else {
          e.y0 = (int)p1y;
          e.y1 = (int)p0y;
          e.x = c1x + (p1y - c1y) * e.dx;
        }
        e.next = nullptr;
        edges.push_back(e);
      }
      p0x = p1x;
      p0y = p1y;
    }
    v += 2 * count;
  }
  // FillEdgeCollection
  int total = (int)edges.size();
  if (total < 2) return;
  int y_max = INT_MIN, y_min = INT_MAX;
  int64_t x_max = INT64_MIN, x_min = INT64_MAX;
  for (auto& e1 : edges) {
    int64_t x1 = e1.x + (int64_t)(e1.y1 - e1.y0) * e1.dx;
    y_min = std::min(y_min, e1.y0);
    y_max = std::max(y_max, e1.y1);
    x_min = std::min(x_min, e1.x);
    x_max = std::max(x_max, e1.x);
    x_min = std::min(x_min, x1);
    x_max = std::max(x_max, x1);
  }
  if (y_max < 0 || y_min >= h || x_max < 0 || x_min >= (int64_t)w * XY_ONE) return;
  std::sort(edges.begin(), edges.end(), [](const PolyEdge& a, const PolyEdge& b) {
    if (a.y0 != b.y0) return a.y0 < b.y0;
    if (a.x != b.x) return a.x < b.x;
    return a.dx < b.dx;
  });
  PolyEdge tmp;
  tmp.y0 = INT_MAX;
  tmp.y1 = 0;
  tmp.x = 0;
  tmp.dx = 0;
  tmp.next = nullptr;
  edges.push_back(tmp);
  int i = 0;
  PolyEdge* e = &edges[i];
  y_max = std::min(y_max, h);
  for (int y = e->y0; y < y_max; y++) {
    PolyEdge *last, *prelast, *keep_prelast;
    int draw = 0;
    int clipline = y < 0;
    prelast = &tmp;
    last = tmp.next;
    while (last || e->y0 == y) {
      if (last && last->y1 == y) {
        prelast->next = last->next;
        last = last->next;
        continue;
      }
      keep_prelast = prelast;
      if (last && (e->y0 > y || last->x < e->x)) {
        prelast = last;
        last = last->next;
      } else if (i < total) {
        prelast->next = e;
        e->next = last;
        prelast = e;
        e = &edges[++i];
      } else {
        break;
      }
      if (draw) {
        if (!clipline) {
          uint8_t* row = img + (size_t)y * w;
          int64_t x1, x2;
          // the pixels whose x lies between the two edges: from the left
          // edge rounded up to the right edge rounded down
          if (keep_prelast->x > prelast->x) {
            x1 = (prelast->x + XY_ONE - 1) >> XY_SHIFT;
            x2 = keep_prelast->x >> XY_SHIFT;
          } else {
            x1 = (keep_prelast->x + XY_ONE - 1) >> XY_SHIFT;
            x2 = prelast->x >> XY_SHIFT;
          }
          if (x1 < w && x2 >= 0) {
            if (x1 < 0) x1 = 0;
            if (x2 >= w) x2 = w - 1;
            for (int64_t x = x1; x <= x2; x++) row[x] = color;
          }
        }
        keep_prelast->x += keep_prelast->dx;
        prelast->x += prelast->dx;
      }
      draw ^= 1;
    }
    // bubble sort of the active edges by x
    keep_prelast = nullptr;
    do {
      prelast = &tmp;
      last = tmp.next;
      PolyEdge* last_exchange = nullptr;
      while (last != keep_prelast && last->next != nullptr) {
        PolyEdge* te = last->next;
        if (last->x > te->x) {
          prelast->next = te;
          last->next = te->next;
          te->next = last;
          prelast = te;
          last_exchange = prelast;
        } else {
          prelast = last;
          last = te;
        }
      }
      if (last_exchange == nullptr) break;
      keep_prelast = last_exchange;
    } while (keep_prelast != tmp.next && keep_prelast != &tmp);
  }
}

}  // extern "C"

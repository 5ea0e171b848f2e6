// Huffman entropy decoding of one JPEG scan on the host: the algorithm of
// `utils/jpeg.py:entropy_decode_plain` (libjpeg's jdhuff.c / jdphuff.c),
// coefficient for coefficient.  Built with g++ by utils/host_build.py and
// called through ctypes by utils/jpeg.py:entropy_decode.
//
// The caller parses the markers and hands over one scan: its entropy-coded
// segment (byte stuffing and RSTn markers still in it), the scan's
// parameters, each scan component's allocated block grid and sampling
// factors, its Huffman tables (a flag, bits[1..16], up to 256 symbols) and
// its coefficient array ((ph, pw, 64) int32, natural order), updated in
// place.  Returns 0, or 1 with a message in `err` on malformed data.  Every
// loop is bounded by the MCU count or by the segment's length.

#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct Error {
  const char* what;
};

// libjpeg's derived table: codes by length, and a 9-bit lookahead
struct Huff {
  int32_t mincode[17], maxcode[18], valptr[17];
  uint8_t values[256];
  int16_t look_len[512];  // 0: longer than 9 bits
  uint8_t look_val[512];

  void build(const uint8_t* t) {
    const uint8_t* bits = t + 1;
    memcpy(values, t + 17, 256);
    int code = 0, p = 0;
    for (int l = 1; l <= 16; ++l) {
      maxcode[l] = -1;
      int n = bits[l - 1];
      if (n) {
        valptr[l] = p;
        mincode[l] = code;
        code += n;
        p += n;
        maxcode[l] = code - 1;
      }
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    memset(look_len, 0, sizeof(look_len));
    p = 0;
    code = 0;
    for (int l = 1; l <= 9; ++l) {
      for (int i = 0; i < bits[l - 1]; ++i, ++p, ++code) {
        int lo = code << (9 - l), hi = (code + 1) << (9 - l);
        for (int k = lo; k < hi; ++k) {
          look_len[k] = int16_t(l);
          look_val[k] = values[p];
        }
      }
      code <<= 1;
    }
  }
};

// MSB-first bits of one restart interval; past a marker or the segment's
// end it reads zeros, as libjpeg does, but consuming them is an error
struct Bits {
  const uint8_t* d;
  int64_t n, pos;
  uint64_t buf;
  int have;
  int64_t zeros;  // zero bits appended past the data

  void fill() {
    while (have <= 56) {
      int byte = 0;
      if (pos < n && d[pos] != 0xFF) {
        byte = d[pos++];
      } else if (pos + 1 < n && d[pos] == 0xFF && d[pos + 1] == 0x00) {
        byte = 0xFF;
        pos += 2;
      } else {
        zeros += 8;  // a marker or the end: no more data
      }
      buf |= uint64_t(byte) << (56 - have);
      have += 8;
    }
  }
  void consumed(int k) {
    buf <<= k;
    have -= k;
    if (zeros > have) throw Error{"entropy-coded data ends early"};
  }
  int get(int k) {
    if (k == 0) return 0;
    fill();
    int v = int(buf >> (64 - k));
    consumed(k);
    return v;
  }
  int huff(const Huff& h) {
    fill();
    int peek = int(buf >> 55);
    if (h.look_len[peek]) {
      int l = h.look_len[peek];
      consumed(l);
      return h.look_val[peek];
    }
    int l = 10;
    int code = int(buf >> (64 - l));
    while (l <= 16 && code > h.maxcode[l]) {
      ++l;
      code = int(buf >> (64 - l));
    }
    if (l > 16) throw Error{"bad Huffman code"};
    consumed(l);
    return h.values[h.valptr[l] + code - h.mincode[l]];
  }
  // at a restart: drop the buffered bits and pass the marker RSTk
  void restart(int k) {
    buf = 0;
    have = 0;
    zeros = 0;
    // pass bytes the interval's last code left (stuffed 0xFF 0x00 too)
    // and the fill before the marker
    while (pos < n && !(d[pos] == 0xFF && pos + 1 < n && d[pos + 1] != 0x00)) pos += d[pos] == 0xFF ? 2 : 1;
    while (pos < n && d[pos] == 0xFF) ++pos;
    if (pos >= n || d[pos] != 0xD0 + (k & 7)) throw Error{"restart marker missing or out of order"};
    ++pos;
  }
};

inline int extend(int r, int s) { return (s && r < (1 << (s - 1))) ? r - (1 << s) + 1 : r; }
inline int32_t wrap16(int64_t x) { return int32_t(int16_t(uint16_t(x & 0xFFFF))); }

struct ScanComp {
  int pw, ph, h, v;
  int32_t* coef;
  Huff dc, ac;
};

void ac_refine(Bits& br, const Huff& tbl, int32_t* blk, int ss, int se, int al, int& eobrun) {
  const int p1 = 1 << al, m1 = -(1 << al);
  auto correct = [&](int pos) {
    if (br.get(1) && (blk[pos] & p1) == 0) blk[pos] = wrap16(int64_t(blk[pos]) + (blk[pos] >= 0 ? p1 : m1));
  };
  int k = ss;
  if (eobrun == 0) {
    while (k <= se) {
      int rs = br.huff(tbl);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        if (s != 1) throw Error{"bad refinement symbol"};
        s = br.get(1) ? p1 : m1;
      } else if (r != 15) {
        eobrun = (1 << r) + br.get(r);
        break;
      }
      while (k <= se) {
        int pos = kZigzag[k];
        if (blk[pos] != 0) {
          correct(pos);
        } else if (--r < 0) {
          break;
        }
        ++k;
      }
      if (s) {
        if (k > 63) throw Error{"coefficient index past 63"};
        blk[kZigzag[k]] = s;
      }
      ++k;
    }
  }
  if (eobrun > 0) {
    for (; k <= se; ++k)
      if (blk[kZigzag[k]] != 0) correct(kZigzag[k]);
    --eobrun;
  }
}

void decode(const uint8_t* seg, int64_t len, int progressive, int ss, int se, int ah, int al,
            int restart, int n, ScanComp* comps, int mx, int my) {
  // the blocks of one MCU: (scan component, block row, block column)
  int lay_c[10], lay_y[10], lay_x[10], nb = 0;
  if (n == 1) {
    lay_c[0] = lay_y[0] = lay_x[0] = 0;
    nb = 1;
  } else {
    for (int i = 0; i < n; ++i)
      for (int by = 0; by < comps[i].v; ++by)
        for (int bx = 0; bx < comps[i].h; ++bx) {
          if (nb == 10) throw Error{"more than 10 blocks an MCU"};
          lay_c[nb] = i;
          lay_y[nb] = by;
          lay_x[nb] = bx;
          ++nb;
        }
  }
  Bits br{seg, len, 0, 0, 0, 0};
  int64_t pred[4] = {0, 0, 0, 0};
  int eobrun = 0, left = restart, next_rst = 0;
  const int64_t total = int64_t(mx) * my;
  for (int64_t mcu = 0; mcu < total; ++mcu) {
    if (restart) {
      if (left == 0) {
        br.restart(next_rst++);
        pred[0] = pred[1] = pred[2] = pred[3] = 0;
        eobrun = 0;
        left = restart;
      }
      --left;
    }
    const int64_t my_ = mcu / mx, mx_ = mcu % mx;
    for (int b = 0; b < nb; ++b) {
      ScanComp& c = comps[lay_c[b]];
      int64_t row = n == 1 ? my_ : my_ * c.v + lay_y[b];
      int64_t col = n == 1 ? mx_ : mx_ * c.h + lay_x[b];
      int32_t* blk = c.coef + (row * c.pw + col) * 64;
      int64_t& p = pred[lay_c[b]];
      if (!progressive) {
        int s = br.huff(c.dc);
        p += extend(br.get(s), s);
        blk[0] = wrap16(p);
        for (int k = 1; k < 64;) {
          int rs = br.huff(c.ac);
          int r = rs >> 4;
          s = rs & 15;
          if (s) {
            k += r;
            if (k > 63) throw Error{"coefficient index past 63"};
            blk[kZigzag[k]] = extend(br.get(s), s);
            ++k;
          } else if (r == 15) {
            k += 16;
          } else {
            break;
          }
        }
      } else if (ss == 0 && ah == 0) {  // DC first
        int s = br.huff(c.dc);
        p += extend(br.get(s), s);
        blk[0] = wrap16(p * (int64_t(1) << al));
      } else if (ss == 0) {  // DC refine
        if (br.get(1)) blk[0] = wrap16(blk[0] | (1 << al));
      } else if (ah == 0) {  // AC first
        if (eobrun) {
          --eobrun;
          continue;
        }
        for (int k = ss; k <= se; ++k) {
          int rs = br.huff(c.ac);
          int r = rs >> 4, s = rs & 15;
          if (s) {
            k += r;
            if (k > 63) throw Error{"coefficient index past 63"};
            blk[kZigzag[k]] = wrap16(int64_t(extend(br.get(s), s)) * (int64_t(1) << al));
          } else if (r == 15) {
            k += 15;
          } else {
            eobrun = (1 << r) + br.get(r) - 1;
            break;
          }
        }
      } else {  // AC refine
        ac_refine(br, c.ac, blk, ss, se, al, eobrun);
      }
    }
  }
}

}  // namespace

extern "C" int lprt_jpeg_decode_scan(const uint8_t* seg, int64_t len, int progressive, int ss,
                                     int se, int ah, int al, int restart, int n,
                                     const int32_t* info, const uint8_t* tables, int mx, int my,
                                     int32_t** coefs, char* err, int err_len) {
  static const int kTable = 17 + 256;
  try {
    if (n < 1 || n > 4) throw Error{"bad component count in scan"};
    ScanComp comps[4];
    for (int i = 0; i < n; ++i) {
      ScanComp& c = comps[i];
      c.pw = info[4 * i];
      c.ph = info[4 * i + 1];
      c.h = info[4 * i + 2];
      c.v = info[4 * i + 3];
      c.coef = coefs[i];
      const uint8_t* t = tables + i * 2 * kTable;
      if (t[0]) c.dc.build(t);
      if (t[kTable]) c.ac.build(t + kTable);
    }
    decode(seg, len, progressive, ss, se, ah, al, restart, n, comps, mx, my);
  } catch (const Error& e) {
    snprintf(err, size_t(err_len), "%s", e.what);
    return 1;
  }
  return 0;
}

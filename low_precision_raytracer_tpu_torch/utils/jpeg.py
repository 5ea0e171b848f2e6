"""JPEG decoding with numpy and a small C++ entropy decoder.

The JAX package decodes a texture or an LDR panorama with PIL's
`Image.open(...).convert("RGBA")` (`low_precision_raytracer_tpu/models/
gltf.py:386-391`, `utils/image.py:22-27`), that is libjpeg-turbo in its
default mode: the ISLOW integer IDCT, fancy upsampling, no merged
upsampler.  Every step of that mode is integer arithmetic, and
`decode_jpeg` repeats it step for step, so it gives the same bytes:

1. `parse`: the markers (SOI, APPn, DQT, SOF0/1/2, DHT, SOS, DRI, RSTn,
   COM, EOI) -> a `JPEGFrame`: the components with their factors and the
   quantisation table each latched at its first scan (as libjpeg latches
   them), and the scans with the Huffman tables and restart interval
   current at each.  A scan's entropy-coded segment is found by the first
   marker after it that is not RSTn.
2. Entropy decoding -> quantised coefficients, (blocks_y, blocks_x, 64)
   int32 a component in natural order, the blocks padded to whole MCUs:
   sequential scans and the four progressive kinds (DC first and refine,
   AC first with end-of-band runs, AC refine with its correction bits),
   restart markers resetting the predictors and the run.
   `entropy_decode_plain` is the reference in Python; the loader runs the
   same algorithm in C++ (`csrc/jpeg_entropy.cpp`, `entropy_decode`),
   built with `g++` at first use (`utils/host_build.py`).
3. `reconstruct`, vectorised over all blocks of a component: dequantise
   (the table as libjpeg's 16-bit multipliers), `jidctint.c`'s two passes
   (CONST_BITS 13, PASS1_BITS 2, descale with rounding; each pass one
   matrix product, exact in float64, `IDCT_MATRIX`), the
   output saturated to 0..255 as libjpeg-turbo's SIMD IDCT does it (the C
   code's RANGE_MASK wrap differs only on outputs beyond [-512, 511],
   which no encoder's file reaches; ROADMAP queue 3), fancy upsampling
   (`jdsample.c`: h2v1, h1v2, h2v2 with their biases, edges replicated
   as libjpeg's context rows replicate them, box replication where it
   picks it), the YCbCr -> RGB tables of `jdcolor.c` (SCALEBITS 16), the
   crop and alpha 255.

Colour: one component is grey (PIL's "L", replicated); three are YCbCr,
or RGB under an Adobe APP14 `transform = 0` without a JFIF APP0 or with
the component ids 'R', 'G', 'B', as libjpeg decides.  Other APPn and COM
segments are skipped; EXIF orientation is not applied (PIL's `convert`
does not apply it).

Forms PIL decodes that this module refuses raise NotImplementedError
naming ROADMAP queue 1 item 15: four components (CMYK / YCCK), arithmetic
coding (SOF9-11, SOF13-15, DAC), 12-bit samples, lossless (SOF3) and
hierarchical (SOF5-7, DHP, EXP) files, DNL, a progressive file whose
scans leave part of a component's spectrum unsent (libjpeg block-smooths
it), and dequantised values that overflow the 16-bit lanes of
libjpeg-turbo's SIMD IDCT (16-bit DQT tables far above an encoder's,
where PIL's bytes leave the C code's; `_check_simd_lanes`).  A malformed file raises `JPEGError`; every loop is bounded by the
data.
"""

from __future__ import annotations

import re
import struct
from dataclasses import dataclass, field

import numpy as np

SOI = b"\xff\xd8"
REFUSED = "ROADMAP queue 1 item 15"
# PIL refuses an image above twice its `Image.MAX_IMAGE_PIXELS` (a
# decompression bomb); so does this decoder, before it allocates
MAX_PIXELS = 2 * 89478485

# natural (row-major) index of each zigzag position
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int32)

# the standard Huffman tables (ITU T.81 K.3) libjpeg-turbo installs in the
# empty slots 0 and 1 (Motion-JPEG frames carry no DHT): (bits[1..16], values)
_STD_DC = (
    ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), bytes(range(12))),
    ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), bytes(range(12))),
)
_STD_AC = (
    ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d), bytes.fromhex(
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
        "2433627282090a161718191a25262728292a3435363738393a43444546474849"
        "4a535455565758595a636465666768696a737475767778797a83848586878889"
        "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
        "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
        "f9fa")),
    ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77), bytes.fromhex(
        "000102031104052131061241510761711322328108144291a1b1c109233352f0"
        "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
        "494a535455565758595a636465666768696a737475767778797a828384858687"
        "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
        "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
        "f9fa")),
)

# the end of a scan's entropy-coded segment: a marker that is not RSTn
# (0xFF 0x00 is a stuffed data byte; 0xFF runs are fill)
_SEGMENT_END = re.compile(rb"\xff+[^\x00\xd0-\xd7\xff]")
_RST = re.compile(rb"\xff+[\xd0-\xd7]")


class JPEGError(ValueError):
    """A malformed JPEG (the glTF loader reports it as a GLTFError)."""


def _refuse(what: str):
    raise NotImplementedError(f"JPEG {what} is not decoded ({REFUSED})")


@dataclass
class HuffTable:
    """A DHT table: code counts by length 1..16 and the symbols."""
    bits: tuple
    values: bytes

    def derived(self, is_dc: bool):
        """-> (mincode, maxcode, valptr) by length 1..16 (index 0 unused),
        as libjpeg's `jpeg_make_d_derived_tbl` checks and builds them."""
        if is_dc and any(v > 15 for v in self.values):
            raise JPEGError("a DC Huffman table holds a symbol above 15")
        mincode, maxcode, valptr = [0] * 17, [-1] * 18, [0] * 17
        code, p = 0, 0
        for length in range(1, 17):
            n = self.bits[length - 1]
            if n:
                valptr[length], mincode[length] = p, code
                code += n
                p += n
                maxcode[length] = code - 1
            # the next code must still fit: no code is all ones
            if code >= (1 << length):
                raise JPEGError("a Huffman table's codes overflow their lengths")
            code <<= 1
        return mincode, maxcode, valptr


@dataclass
class Component:
    cid: int
    h: int
    v: int
    tq: int
    dw: int = 0  # samples wide and high (libjpeg's downsampled size)
    dh: int = 0
    bw: int = 0  # blocks wide and high with data (non-interleaved scans)
    bh: int = 0
    pw: int = 0  # blocks wide and high allocated (whole MCUs)
    ph: int = 0
    qt: np.ndarray | None = None  # (64,) natural order, latched at first scan


@dataclass
class Scan:
    comps: list          # component indices
    dc: list             # HuffTable a component (None where unused)
    ac: list
    ss: int
    se: int
    ah: int
    al: int
    restart: int         # MCUs an interval, 0 for none
    data: bytes          # the entropy-coded segment (stuffed, with RSTn)


@dataclass
class JPEGFrame:
    width: int
    height: int
    progressive: bool
    comps: list
    color: str           # "grey", "ycc" or "rgb"
    max_h: int = 1
    max_v: int = 1
    mcus_x: int = 0
    mcus_y: int = 0
    scans: list = field(default_factory=list)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# markers


def parse(data: bytes) -> JPEGFrame:
    """The markers of a JPEG file -> JPEGFrame (scans in file order)."""
    data = bytes(data)
    if data[:2] != SOI:
        raise JPEGError("not a JPEG (no SOI)")
    pos, n = 2, len(data)
    qt = [None] * 4
    dc = [HuffTable(*_STD_DC[0]), HuffTable(*_STD_DC[1]), None, None]
    ac = [HuffTable(*_STD_AC[0]), HuffTable(*_STD_AC[1]), None, None]
    restart, frame, jfif, adobe = 0, None, False, None
    while True:
        # next marker: skip stray bytes and 0xFF fill as libjpeg does
        ff = data.find(b"\xff", pos)
        if ff < 0:
            raise JPEGError("truncated: no EOI")
        pos = ff
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            raise JPEGError("truncated: no EOI")
        m = data[pos]
        pos += 1
        if m == 0xD9:  # EOI
            break
        if m == 0x00 or 0xD0 <= m <= 0xD7 or m == 0x01:
            continue  # a stuffed zero, RSTn or TEM outside a scan: libjpeg skips them
        if m == 0xD8:
            raise JPEGError("a second SOI")
        if pos + 2 > n:
            raise JPEGError("truncated segment length")
        (length,) = struct.unpack_from(">H", data, pos)
        if length < 2 or pos + length > n:
            raise JPEGError(f"truncated segment of marker 0x{m:02x}")
        seg = data[pos + 2:pos + length]
        pos += length
        if m in (0xC0, 0xC1, 0xC2):
            if frame is not None:
                raise JPEGError("two SOF markers")
            frame = _sof(seg, m == 0xC2)
        elif m in (0xC3, 0xC5, 0xC6, 0xC7):
            _refuse("lossless or hierarchical coding (SOF3, SOF5-7)")
        elif m in (0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF, 0xCC):
            _refuse("arithmetic coding (SOF9-11, SOF13-15, DAC)")
        elif m in (0xDE, 0xDF):
            _refuse("hierarchical coding (DHP, EXP)")
        elif m == 0xDC:
            _refuse("with a DNL marker")
        elif m == 0xC4:
            _dht(seg, dc, ac)
        elif m == 0xDB:
            _dqt(seg, qt)
        elif m == 0xDD:
            if len(seg) != 2:
                raise JPEGError("bad DRI length")
            (restart,) = struct.unpack(">H", seg)
        elif m == 0xDA:
            if frame is None:
                raise JPEGError("SOS before SOF")
            end = _SEGMENT_END.search(data, pos)
            if end is None:
                raise JPEGError("truncated scan: no marker after it")
            frame.scans.append(_sos(seg, frame, qt, dc, ac, restart, data[pos:end.start()]))
            pos = end.start()
        elif m == 0xE0:
            jfif = jfif or (len(seg) >= 14 and seg[:5] == b"JFIF\x00")
        elif m == 0xEE:
            if len(seg) >= 12 and seg[:5] == b"Adobe":
                adobe = seg[11]
        elif 0xE1 <= m <= 0xEF or m == 0xFE:
            pass  # other APPn, COM
        else:
            raise JPEGError(f"unknown marker 0x{m:02x}")
    if frame is None or not frame.scans:
        raise JPEGError("no frame or no scan")
    if len(frame.comps) == 3:
        ids = tuple(c.cid for c in frame.comps)
        rgb = (not jfif) and (adobe == 0 if adobe is not None else ids == (82, 71, 66))
        frame.color = "rgb" if rgb else "ycc"
    return frame


def _sof(seg: bytes, progressive: bool) -> JPEGFrame:
    if len(seg) < 6:
        raise JPEGError("short SOF")
    p, height, width, nc = struct.unpack_from(">BHHB", seg)
    if p == 12:
        _refuse("with 12-bit samples")
    if p != 8:
        raise JPEGError(f"sample precision {p}")
    if height == 0:
        _refuse("with a DNL marker (height 0 in SOF)")
    if width == 0:
        raise JPEGError("width 0")
    if width * height > MAX_PIXELS:
        raise JPEGError(f"{width} x {height} pixels: above PIL's decompression-bomb limit")
    if nc == 4:
        _refuse("with four components (CMYK / YCCK)")
    if nc not in (1, 3):
        raise JPEGError(f"{nc} components")
    if len(seg) != 6 + 3 * nc:
        raise JPEGError("bad SOF length")
    comps = []
    for i in range(nc):
        cid, hv, tq = seg[6 + 3 * i:9 + 3 * i]
        h, v = hv >> 4, hv & 15
        if not (1 <= h <= 4 and 1 <= v <= 4) or tq > 3:
            raise JPEGError("bad sampling factors or table index")
        if any(c.cid == cid for c in comps):
            raise JPEGError("duplicate component id")
        comps.append(Component(cid, h, v, tq))
    f = JPEGFrame(width, height, progressive, comps, "grey" if nc == 1 else "ycc")
    f.max_h = max(c.h for c in comps)
    f.max_v = max(c.v for c in comps)
    f.mcus_x = _ceil_div(width, 8 * f.max_h)
    f.mcus_y = _ceil_div(height, 8 * f.max_v)
    for c in comps:
        c.dw = _ceil_div(width * c.h, f.max_h)
        c.dh = _ceil_div(height * c.v, f.max_v)
        c.bw = _ceil_div(width * c.h, f.max_h * 8)
        c.bh = _ceil_div(height * c.v, f.max_v * 8)
        c.pw, c.ph = f.mcus_x * c.h, f.mcus_y * c.v
    return f


def _dht(seg: bytes, dc: list, ac: list) -> None:
    i = 0
    while i < len(seg):
        if i + 17 > len(seg):
            raise JPEGError("short DHT")
        tc, th = seg[i] >> 4, seg[i] & 15
        bits = tuple(seg[i + 1:i + 17])
        count = sum(bits)
        if tc > 1 or th > 3 or count > 256 or i + 17 + count > len(seg):
            raise JPEGError("bad DHT")
        (dc if tc == 0 else ac)[th] = HuffTable(bits, seg[i + 17:i + 17 + count])
        i += 17 + count


def _dqt(seg: bytes, qt: list) -> None:
    i = 0
    while i < len(seg):
        pq, tq = seg[i] >> 4, seg[i] & 15
        size = 64 * (pq + 1)
        if pq > 1 or tq > 3 or i + 1 + size > len(seg):
            raise JPEGError("bad DQT")
        vals = np.frombuffer(seg[i + 1:i + 1 + size], ">u2" if pq else np.uint8)
        table = np.zeros(64, np.int32)
        table[ZIGZAG] = vals
        qt[tq] = table
        i += 1 + size


def _sos(seg, frame: JPEGFrame, qt, dc, ac, restart, body) -> Scan:
    if not seg:
        raise JPEGError("short SOS")
    ns = seg[0]
    if not 1 <= ns <= 4 or len(seg) != 4 + 2 * ns:
        raise JPEGError("bad SOS length")
    comps, slots = [], []
    for i in range(ns):
        cid, t = seg[1 + 2 * i], seg[2 + 2 * i]
        idx = [k for k, c in enumerate(frame.comps) if c.cid == cid]
        if not idx or idx[0] in comps:
            raise JPEGError("SOS names an unknown or repeated component")
        comps.append(idx[0])
        slots.append((t >> 4, t & 15))
    ss, se, a = seg[1 + 2 * ns:4 + 2 * ns]
    ah, al = a >> 4, a & 15
    if ns > 1 and sum(frame.comps[k].h * frame.comps[k].v for k in comps) > 10:
        raise JPEGError("more than 10 blocks an MCU")
    if frame.progressive:
        bad = (se != 0) if ss == 0 else (ss > se or se > 63 or ns != 1)
        if bad or (ah and al != ah - 1) or al > 13:
            raise JPEGError("bad progression parameters")
    elif ss != 0 or se != 63 or ah or al:
        raise JPEGError("a sequential scan with progressive parameters")
    # the tables a scan reads: DC in a sequential or DC-first scan, AC
    # wherever the band holds AC coefficients (refinement included)
    need_dc, need_ac = ss == 0 and ah == 0, se > 0
    table = lambda defined, k: defined[k] if k < 4 else None
    out_dc = [table(dc, td) if need_dc else None for td, _ in slots]
    out_ac = [table(ac, ta) if need_ac else None for _, ta in slots]
    if (need_dc and None in out_dc) or (need_ac and None in out_ac):
        raise JPEGError("a scan names an undefined Huffman table")
    for k in comps:  # libjpeg latches a component's table at its first scan
        c = frame.comps[k]
        if c.qt is None:
            if qt[c.tq] is None:
                raise JPEGError(f"no quantisation table {c.tq}")
            c.qt = qt[c.tq].copy()
    return Scan(comps, out_dc, out_ac, ss, se, ah, al, restart, body)


# ---------------------------------------------------------------------------
# entropy decoding: shared bookkeeping


def new_coefficients(frame: JPEGFrame) -> list:
    """Zeroed (ph, pw, 64) int32 coefficient arrays, one a component."""
    return [np.zeros((c.ph, c.pw, 64), np.int32) for c in frame.comps]


def scan_blocks(frame: JPEGFrame, scan: Scan):
    """-> (MCUs across, MCUs down, [(component, by, bx) a block of an MCU,
    relative]): an interleaved scan's MCUs, or one block an MCU over the
    component's blocks with data."""
    if len(scan.comps) == 1:
        c = frame.comps[scan.comps[0]]
        return c.bw, c.bh, [(0, 0, 0)]
    layout = [(i, by, bx) for i, k in enumerate(scan.comps)
              for by in range(frame.comps[k].v) for bx in range(frame.comps[k].h)]
    return frame.mcus_x, frame.mcus_y, layout


def intervals(scan: Scan, n_mcus: int) -> list:
    """The scan's segment cut at its RSTn markers -> [unstuffed bytes] a
    restart interval, the markers checked to count 0..7 in turn."""
    if scan.restart == 0:
        return [scan.data.replace(b"\xff\x00", b"\xff")]
    want = _ceil_div(n_mcus, scan.restart)
    parts, pos, k = [], 0, 0
    for m in _RST.finditer(scan.data):
        if m.group()[-1] != 0xD0 + k % 8:
            raise JPEGError("restart markers out of order")
        parts.append(scan.data[pos:m.start()])
        pos, k = m.end(), k + 1
    parts.append(scan.data[pos:])
    if len(parts) < want:
        raise JPEGError("fewer restart intervals than the scan needs")
    return [p.replace(b"\xff\x00", b"\xff") for p in parts[:want]]


def _wrap16(x: int) -> int:
    """A JCOEF (16-bit) store."""
    return ((x + 32768) & 0xFFFF) - 32768


# ---------------------------------------------------------------------------
# the plain entropy decoder (the reference of csrc/jpeg_entropy.cpp)


class _Bits:
    """An MSB-first bit reader over one restart interval's bytes."""

    def __init__(self, buf: bytes):
        self.s = "".join(f"{b:08b}" for b in buf)
        self.p = 0

    def get(self, n: int) -> int:
        if n == 0:
            return 0
        if self.p + n > len(self.s):
            raise JPEGError("entropy-coded data ends early")
        v = int(self.s[self.p:self.p + n], 2)
        self.p += n
        return v

    def huff(self, tbl) -> int:
        mincode, maxcode, valptr, values = tbl
        code = 0
        for length in range(1, 17):
            code = (code << 1) | self.get(1)
            if code <= maxcode[length]:
                return values[valptr[length] + code - mincode[length]]
        raise JPEGError("bad Huffman code")


def _extend(r: int, s: int) -> int:
    return r - (1 << s) + 1 if s and r < (1 << (s - 1)) else r


def entropy_decode_plain(frame: JPEGFrame) -> list:
    """Every scan of `frame` in Python -> the coefficient arrays
    (`new_coefficients`).  The reference the C++ decoder is held against;
    too slow for the loader."""
    coefs = new_coefficients(frame)
    for scan in frame.scans:
        _decode_scan_plain(frame, scan, coefs)
    check_complete(frame)
    return coefs


def _decode_scan_plain(frame, scan, coefs):
    mx, my, layout = scan_blocks(frame, scan)
    single = len(scan.comps) == 1
    dct = [None if t is None else (*t.derived(True), t.values) for t in scan.dc]
    act = [None if t is None else (*t.derived(False), t.values) for t in scan.ac]
    parts = intervals(scan, mx * my)
    per = scan.restart or mx * my
    ss, se, ah, al = scan.ss, scan.se, scan.ah, scan.al
    for part, bits in enumerate(parts):
        br = _Bits(bits)
        pred = [0] * len(scan.comps)
        eobrun = 0
        for mcu in range(part * per, min((part + 1) * per, mx * my)):
            my_, mx_ = divmod(mcu, mx)
            for i, by, bx in layout:
                comp = frame.comps[scan.comps[i]]
                if single:
                    blk = coefs[scan.comps[i]][my_, mx_]
                else:
                    blk = coefs[scan.comps[i]][my_ * comp.v + by, mx_ * comp.h + bx]
                if not frame.progressive:
                    s = br.huff(dct[i])
                    pred[i] += _extend(br.get(s), s)
                    blk[0] = _wrap16(pred[i])
                    k = 1
                    while k < 64:
                        rs = br.huff(act[i])
                        r, s = rs >> 4, rs & 15
                        if s:
                            k += r
                            if k > 63:
                                raise JPEGError("coefficient index past 63")
                            blk[ZIGZAG[k]] = _extend(br.get(s), s)
                            k += 1
                        elif r == 15:
                            k += 16
                        else:
                            break
                elif ss == 0 and ah == 0:  # DC first
                    s = br.huff(dct[i])
                    pred[i] += _extend(br.get(s), s)
                    blk[0] = _wrap16(pred[i] << al)
                elif ss == 0:  # DC refine
                    if br.get(1):
                        blk[0] = _wrap16(int(blk[0]) | (1 << al))
                elif ah == 0:  # AC first
                    if eobrun:
                        eobrun -= 1
                        continue
                    k = ss
                    while k <= se:
                        rs = br.huff(act[i])
                        r, s = rs >> 4, rs & 15
                        if s:
                            k += r
                            if k > 63:
                                raise JPEGError("coefficient index past 63")
                            blk[ZIGZAG[k]] = _wrap16(_extend(br.get(s), s) << al)
                        elif r == 15:
                            k += 15
                        else:
                            eobrun = (1 << r) + br.get(r) - 1
                            break
                        k += 1
                else:  # AC refine
                    eobrun = _ac_refine_plain(br, act[i], blk, ss, se, al, eobrun)


def _ac_refine_plain(br, tbl, blk, ss, se, al, eobrun):
    """One block of an AC refinement scan (libjpeg's decode_mcu_AC_refine)
    -> the end-of-band run left."""
    p1, m1 = 1 << al, -1 << al

    def correct(pos):
        if br.get(1) and (int(blk[pos]) & p1) == 0:
            blk[pos] = _wrap16(int(blk[pos]) + (p1 if blk[pos] >= 0 else m1))

    k = ss
    if eobrun == 0:
        while k <= se:
            rs = br.huff(tbl)
            r, s = rs >> 4, rs & 15
            if s:
                if s != 1:
                    raise JPEGError("bad refinement symbol")
                s = p1 if br.get(1) else m1
            elif r != 15:
                eobrun = (1 << r) + br.get(r)
                break
            # skip r zero coefficients, correcting the non-zero ones passed
            while k <= se:
                pos = ZIGZAG[k]
                if blk[pos] != 0:
                    correct(pos)
                else:
                    r -= 1
                    if r < 0:
                        break
                k += 1
            if s:
                if k > 63:
                    raise JPEGError("coefficient index past 63")
                blk[ZIGZAG[k]] = s
            k += 1
    if eobrun > 0:
        while k <= se:
            pos = ZIGZAG[k]
            if blk[pos] != 0:
                correct(pos)
            k += 1
        eobrun -= 1
    return eobrun


def check_complete(frame: JPEGFrame) -> None:
    """Refuse a progressive file whose scans leave a coefficient of a
    component unsent or unrefined (libjpeg would block-smooth it); a
    sequential file must send every component."""
    for k, comp in enumerate(frame.comps):
        bits = np.full(64, -1)
        for scan in frame.scans:
            if k in scan.comps:
                if frame.progressive:
                    bits[scan.ss:scan.se + 1] = scan.al
                else:
                    bits[:] = 0
        if (bits < 0).all() and not frame.progressive:
            raise JPEGError("a component no scan sends")
        if (bits != 0).any():
            _refuse("whose progressive scans leave part of a component's spectrum "
                    "unsent (libjpeg block-smooths it)")


# ---------------------------------------------------------------------------
# the C++ entropy decoder


def entropy_decode(frame: JPEGFrame) -> list:
    """Every scan of `frame` in C++ (`csrc/jpeg_entropy.cpp`) -> the
    coefficient arrays, equal to `entropy_decode_plain`'s."""
    import ctypes

    lib = _library()
    coefs = new_coefficients(frame)
    err = ctypes.create_string_buffer(256)
    for scan in frame.scans:
        mx, my, _layout = scan_blocks(frame, scan)
        n = len(scan.comps)
        info = np.zeros((n, 4), np.int32)
        tables = np.zeros((n, 2, 17 + 256), np.uint8)
        for i, k in enumerate(scan.comps):
            c = frame.comps[k]
            info[i] = (c.pw, c.ph, c.h, c.v)
            for j, t in enumerate((scan.dc[i], scan.ac[i])):
                if t is not None:
                    t.derived(j == 0)  # libjpeg's checks, in one place
                    tables[i, j, 0] = 1
                    tables[i, j, 1:17] = t.bits
                    tables[i, j, 17:17 + len(t.values)] = np.frombuffer(t.values, np.uint8)
        ptrs = (ctypes.c_void_p * n)(*[coefs[k].ctypes.data for k in scan.comps])
        rc = lib.lprt_jpeg_decode_scan(
            scan.data, len(scan.data), int(frame.progressive), scan.ss, scan.se, scan.ah,
            scan.al, scan.restart, n, info, tables, mx, my, ptrs, err, len(err))
        if rc:
            raise JPEGError(err.value.decode())
    check_complete(frame)
    return coefs


_lib = None


def _library():
    global _lib
    if _lib is None:
        import ctypes

        from low_precision_raytracer_tpu_torch.utils.host_build import build_host_library

        lib = ctypes.CDLL(str(build_host_library("jpeg_entropy")))
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        c_int = ctypes.c_int32
        lib.lprt_jpeg_decode_scan.restype = c_int
        lib.lprt_jpeg_decode_scan.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, c_int, c_int, c_int, c_int, c_int, c_int, c_int,
            i32p, u8p, c_int, c_int, ctypes.c_void_p, ctypes.c_char_p, c_int]
        _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# reconstruction


def _butterfly(x):
    """`jidctint.c`'s 1-D butterfly on x[0..7], before its descale: integer
    multiplies and adds only, so a linear map with integer coefficients."""
    z1 = (x[2] + x[6]) * 4433                 # FIX_0_541196100
    tmp2 = z1 + x[6] * -15137                 # FIX_1_847759065
    tmp3 = z1 + x[2] * 6270                   # FIX_0_765366865
    tmp0 = (x[0] + x[4]) * 8192               # << CONST_BITS
    tmp1 = (x[0] - x[4]) * 8192
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * 9633                     # FIX_1_175875602
    t0 = t0 * 2446                            # FIX_0_298631336
    t1 = t1 * 16819                           # FIX_2_053119869
    t2 = t2 * 25172                           # FIX_3_072711026
    t3 = t3 * 12299                           # FIX_1_501321110
    z1 = z1 * -7373                           # FIX_0_899976223
    z2 = z2 * -20995                          # FIX_2_562915447
    z3 = z3 * -16069 + z5                     # FIX_1_961570560
    z4 = z4 * -3196 + z5                      # FIX_0_390180644
    t0 = t0 + (z1 + z3)
    t1 = t1 + (z2 + z4)
    t2 = t2 + (z2 + z3)
    t3 = t3 + (z1 + z4)
    return (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)


# the butterfly as its 8 x 8 integer matrix (outputs x inputs); entries
# below 2^17, so on inputs below 2^31 (a 16-bit coefficient times a 16-bit
# multiplier, or the int workspace) every product and sum of a row stays
# an integer below 2^53, which float64 holds exactly: the matrix product
# in float64 is the C code's integer arithmetic
IDCT_MATRIX = np.array([_butterfly(list(e)) for e in np.eye(8, dtype=np.int64)],
                       np.int64).T


def _descale(v: np.ndarray, shift: int) -> np.ndarray:
    """libjpeg's DESCALE: (v + 2^(shift-1)) >> shift, exact on float64
    integers below 2^53."""
    return np.floor((v + float(1 << (shift - 1))) * (1.0 / (1 << shift)))


def _check_simd_lanes(x: np.ndarray, axis: int) -> None:
    """Refuses where libjpeg-turbo's SIMD IDCT, which PIL runs, would
    leave a 16-bit lane on a pass's inputs `x` (float64 integers, the 8
    inputs of a 1-D IDCT along `axis`): it keeps them, and the sums of
    pairs its butterflies take first (in0 +- in4, in3 + in7, in1 + in5),
    in 16 bits, where the C code keeps ints.  Only DQT tables far above an
    encoder's reach it (16x a quality-100 table on noise): there PIL's
    bytes depart from the C code's by up to 255."""
    t = lambda i: np.take(x, i, axis=axis)  # noqa: E731
    for v in (x, t(0) + t(4), t(0) - t(4), t(3) + t(7), t(1) + t(5)):
        if v.size and (v.min() < -32768 or v.max() > 32767):
            _refuse("whose dequantised coefficients overflow the 16-bit lanes of "
                    "libjpeg-turbo's SIMD IDCT")


def idct_islow(coefs: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """(..., 64) natural-order coefficients and their table -> (..., 8, 8)
    uint8 samples, libjpeg's `jpeg_idct_islow` and range limit."""
    lead = coefs.shape[:-1]
    # libjpeg keeps the table as 16-bit multipliers and a coefficient as
    # a 16-bit JCOEF
    q = qt.astype(np.int16).astype(np.float64).reshape(8, 8)
    c = coefs.reshape(-1, 8, 8).astype(np.int16).astype(np.float64) * q  # (block, v, u)
    _check_simd_lanes(c, 1)
    a = IDCT_MATRIX.astype(np.float64)
    n = c.shape[0]
    # pass 1: columns (down the vertical frequencies), kept as int
    ws = _descale(a @ c.transpose(1, 0, 2).reshape(8, n * 8), 11)  # (y, block * u)
    ws = ws.astype(np.int64).astype(np.int32).astype(np.float64)
    # pass 2: rows, descaled by CONST_BITS + PASS1_BITS + 3
    ws = ws.reshape(8, n, 8).transpose(1, 0, 2).reshape(n * 8, 8)  # (block * y, u)
    _check_simd_lanes(ws, 1)
    out = _descale(ws @ a.T, 18).reshape(*lead, 8, 8)  # (block, y, x)
    # + CENTERJSAMPLE, saturated as libjpeg-turbo's SIMD IDCT packs it (the
    # C code's range_limit[x & RANGE_MASK] gives the same for x in
    # [-512, 511] and wraps beyond, where PIL on x86 saturates)
    return np.clip(out + 128, 0, 255).astype(np.uint8)


def _plane(comp: Component, coefs: np.ndarray) -> np.ndarray:
    """A component's samples, (dh, dw) int32 (the upsampling and colour
    sums stay below 2^23)."""
    px = idct_islow(coefs, comp.qt)  # (ph, pw, 8, 8)
    ph, pw = px.shape[:2]
    px = px.transpose(0, 2, 1, 3).reshape(ph * 8, pw * 8)
    return px[:comp.dh, :comp.dw].astype(np.int32)


def _shift(p: np.ndarray, axis: int, step: int) -> np.ndarray:
    """p's neighbour `step` (+1 / -1) along `axis`, the edge replicated."""
    n = p.shape[axis]
    idx = np.clip(np.arange(n) + step, 0, n - 1)
    return np.take(p, idx, axis=axis)


def _interleave(a: np.ndarray, b: np.ndarray, axis: int) -> np.ndarray:
    out = np.stack([a, b], axis=axis + 1)
    shape = list(a.shape)
    shape[axis] *= 2
    return out.reshape(shape)


def upsample(frame: JPEGFrame, comp: Component, p: np.ndarray) -> np.ndarray:
    """A component's (dh, dw) samples -> (height, width), by the method
    libjpeg's `jinit_upsampler` picks (fancy upsampling on)."""
    fh, fv = frame.max_h, frame.max_v
    if fh % comp.h or fv % comp.v:
        raise JPEGError("sampling factors that are not integral ratios")
    ex, ey = fh // comp.h, fv // comp.v
    if (ex, ey) == (2, 1) and comp.dw > 2:  # h2v1_fancy_upsample
        c3 = 3 * p
        p = _interleave((c3 + _shift(p, 1, -1) + 1) >> 2, (c3 + _shift(p, 1, 1) + 2) >> 2, 1)
    elif (ex, ey) == (1, 2):  # h1v2_fancy_upsample
        c3 = 3 * p
        p = _interleave((c3 + _shift(p, 0, -1) + 1) >> 2, (c3 + _shift(p, 0, 1) + 2) >> 2, 0)
    elif (ex, ey) == (2, 2) and comp.dw > 2:  # h2v2_fancy_upsample
        c3 = 3 * p
        # column sums of the nearer row (x3) and the further one, for the
        # output row above (far = the row above) and below
        rows = _interleave(c3 + _shift(p, 0, -1), c3 + _shift(p, 0, 1), 0)
        r3 = 3 * rows
        p = _interleave((r3 + _shift(rows, 1, -1) + 8) >> 4,
                        (r3 + _shift(rows, 1, 1) + 7) >> 4, 1)
    elif (ex, ey) != (1, 1):  # int_upsample, h2v1_upsample, h2v2_upsample
        p = np.repeat(np.repeat(p, ey, axis=0), ex, axis=1)
    return p[:frame.height, :frame.width]


# jdcolor.c's tables: FIX(x) = x * 2^16 rounded, ONE_HALF = 2^15
_X = np.arange(256, dtype=np.int32) - 128
_CR_R = (91881 * _X + 32768) >> 16             # FIX(1.40200)
_CB_B = (116130 * _X + 32768) >> 16            # FIX(1.77200)
_CR_G = -46802 * _X                            # FIX(0.71414)
_CB_G = -22554 * _X + 32768                    # FIX(0.34414), + ONE_HALF


def to_rgba(frame: JPEGFrame, planes: list) -> np.ndarray:
    """Full-size component planes -> (height, width, 4) uint8 RGBA."""
    out = np.empty((frame.height, frame.width, 4), np.uint8)
    out[..., 3] = 255
    if frame.color == "grey":
        out[..., :3] = planes[0][..., None]
    elif frame.color == "rgb":
        for k in range(3):
            out[..., k] = planes[k]
    else:
        y, cb, cr = planes
        out[..., 0] = np.clip(y + _CR_R[cr], 0, 255)
        out[..., 1] = np.clip(y + ((_CB_G[cb] + _CR_G[cr]) >> 16), 0, 255)
        out[..., 2] = np.clip(y + _CB_B[cb], 0, 255)
    return out


def reconstruct(frame: JPEGFrame, coefs: list) -> np.ndarray:
    """Coefficient arrays -> (height, width, 4) uint8 RGBA."""
    planes = [upsample(frame, c, _plane(c, x)) for c, x in zip(frame.comps, coefs)]
    return to_rgba(frame, planes)


def decode_jpeg(data: bytes) -> np.ndarray:
    """A JPEG file's bytes -> (H, W, 4) uint8 RGBA, equal to PIL's
    `Image.open(...).convert("RGBA")`."""
    frame = parse(data)
    return reconstruct(frame, entropy_decode(frame))

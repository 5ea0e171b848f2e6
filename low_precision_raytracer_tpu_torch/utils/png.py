"""PNG decoding and encoding with `zlib` and numpy.

The JAX package's glTF loader decodes a texture with PIL's
`Image.open(...).convert("RGBA")` (`low_precision_raytracer_tpu/models/
gltf.py:388-391`).  `decode_png` gives the same (H, W, 4) uint8 array for
every PNG: colour types 0, 2, 3, 4 and 6 at each of their bit depths,
PLTE and tRNS, the five row filters, Adam7 interlace, several IDAT chunks,
with every chunk's CRC checked.  Where PIL's conversion is lossy it is
copied as it is:

- 16-bit samples keep their high byte, except 16-bit grey (PIL's "I;16"),
  which clips to 255;
- 2- and 4-bit grey scale to 0..255, and a grey tRNS value is compared with
  the scaled sample (so a 2- or 4-bit grey key above 0 rarely matches);
- a 16-bit RGB tRNS key is compared with the high bytes.

Paeth and Average rows depend on the pixel to their left, so a row cannot
be undone in one vector step.  `_unfilter` walks the anti-diagonals
r + j = d of the (row, pixel) grid instead: every cell of one diagonal
depends only on the two before it, so an image takes rows + pixels - 1
numpy steps, each row's filter selected per element.

`encode_png` writes such files (any filter per row, Adam7 or not) for the
textured scene tool and the tests.  `decode_image` sends a JPEG to
`utils/jpeg.py:decode_jpeg`.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from low_precision_raytracer_tpu_torch.utils.jpeg import decode_jpeg

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# samples per pixel by colour type
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))


class PNGError(ValueError):
    """A malformed PNG (the glTF loader reports it as a GLTFError)."""


def decode_image(data: bytes) -> np.ndarray:
    """An image file's bytes (PNG or JPEG) -> (H, W, 4) uint8 RGBA."""
    if data[:8] == SIGNATURE:
        return decode_png(data)
    if data[:3] == b"\xff\xd8\xff":
        return decode_jpeg(data)
    raise PNGError("not a PNG or JPEG image")


def _chunks(data: bytes):
    off = 8
    while off < len(data):
        if off + 12 > len(data):
            raise PNGError("truncated chunk")
        n, kind = struct.unpack_from(">I4s", data, off)
        body = data[off + 8:off + 8 + n]
        if len(body) != n or off + 12 + n > len(data):
            raise PNGError(f"truncated {kind!r} chunk")
        (crc,) = struct.unpack_from(">I", data, off + 8 + n)
        if zlib.crc32(kind + body) != crc:
            raise PNGError(f"CRC mismatch in {kind!r} chunk")
        yield kind, body
        off += 12 + n
        if kind == b"IEND":
            return
    raise PNGError("no IEND chunk")


def _passes(w: int, h: int, interlace: int):
    """-> [(x0, y0, dx, dy, pass width, pass height)] of the non-empty passes."""
    if not interlace:
        return [(0, 0, 1, 1, w, h)]
    out = []
    for x0, y0, dx, dy in _ADAM7:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw > 0 and ph > 0:
            out.append((x0, y0, dx, dy, pw, ph))
    return out


def _paeth(a, b, c):
    """The Paeth predictor on int16 arrays."""
    pa = np.abs(b - c)
    pb = np.abs(a - c)
    pc = np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(ftype: np.ndarray, filt: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the row filters.  ftype (rows,) uint8; filt (rows, row_bytes)
    uint8, row_bytes a multiple of bpp.  -> (rows, row_bytes) uint8."""
    rows, row_bytes = filt.shape
    if not ftype.any():
        return filt.copy()
    npix = row_bytes // bpp
    f = filt.reshape(rows, npix, bpp)
    # skewed layout: cell (r, j) lives at sk[r + j + 2, r + 1], so diagonal
    # d is a contiguous row of sk; its left neighbours (r, j - 1) lie on
    # diagonal d - 1 at the same r, its upper ones (r - 1, j) there at r - 1,
    # and its upper-left ones on diagonal d - 2 at r - 1.  Two leading zero
    # diagonals and a zero column r = -1 stand in for the image's border.
    ndiag = rows + npix - 1
    r_of = np.repeat(np.arange(rows), npix)
    d_of = r_of + np.tile(np.arange(npix), rows)
    fs = np.zeros((ndiag, rows, bpp), np.int16)
    fs[d_of, r_of] = f.reshape(-1, bpp)
    sk = np.zeros((ndiag + 2, rows + 1, bpp), np.int16)
    t = ftype.astype(np.int16)[:, None]
    for d in range(ndiag):
        lo, hi = max(0, d - npix + 1), min(rows - 1, d) + 1
        a = sk[d + 1, lo + 1:hi + 1]
        b = sk[d + 1, lo:hi]
        c = sk[d, lo:hi]
        tr = t[lo:hi]
        pred = np.where(tr == 1, a, np.where(tr == 2, b, np.where(
            tr == 3, (a + b) >> 1, np.where(tr == 4, _paeth(a, b, c), 0))))
        sk[d + 2, lo + 1:hi + 1] = (fs[d, lo:hi] + pred) & 0xFF
    return sk[d_of + 2, r_of + 1].astype(np.uint8).reshape(rows, row_bytes)


def _samples(rec: np.ndarray, pw: int, channels: int, depth: int) -> np.ndarray:
    """Unfiltered scanlines -> (ph, pw, channels) samples (uint8 or uint16)."""
    ph = rec.shape[0]
    if depth == 8:
        return rec.reshape(ph, pw, channels)
    if depth == 16:
        return rec.reshape(ph, pw * channels, 2).view(">u2")[..., 0].astype(np.uint16).reshape(
            ph, pw, channels)
    per = 8 // depth
    shifts = (8 - depth * (np.arange(per) + 1)).astype(np.uint8)
    vals = (rec[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(ph, -1)[:, :pw].reshape(ph, pw, 1)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 4) uint8, equal to PIL's `convert("RGBA")`."""
    if data[:8] != SIGNATURE:
        raise PNGError("not a PNG image")
    header = palette = trns = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            if len(body) != 13:
                raise PNGError("bad IHDR length")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            if len(body) % 3 or not body:
                raise PNGError("bad PLTE length")
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise PNGError("no IHDR chunk")
    w, h, depth, ctype, comp, filt_method, interlace = header
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype]:
        raise PNGError(f"colour type {ctype} at bit depth {depth}")
    if w == 0 or h == 0 or comp or filt_method or interlace > 1:
        raise PNGError(f"unsupported IHDR {header}")
    if ctype == 3 and palette is None:
        raise PNGError("palette image without PLTE")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise PNGError(f"bad IDAT stream: {e}") from e

    channels = _CHANNELS[ctype]
    bpp = max(1, channels * depth // 8)
    img = np.zeros((h, w, channels), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy, pw, ph in _passes(w, h, interlace):
        row_bytes = -(-pw * channels * depth // 8)
        n = ph * (row_bytes + 1)
        if pos + n > len(raw):
            raise PNGError("IDAT data too short")
        lines = np.frombuffer(raw, np.uint8, count=n, offset=pos).reshape(ph, row_bytes + 1)
        pos += n
        if lines[:, 0].max() > 4:
            raise PNGError("unknown row filter")
        rec = _unfilter(lines[:, 0], lines[:, 1:], bpp)
        img[y0::dy, x0::dx] = _samples(rec, pw, channels, depth)
    return _to_rgba(img, ctype, depth, palette, trns)


def _to_rgba(img, ctype, depth, palette, trns):
    """Samples -> RGBA uint8 as PIL's `convert("RGBA")` makes them."""
    h, w, _c = img.shape
    alpha = np.full((h, w), 255, np.uint8)
    if ctype == 3:
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(palette)] = palette[:256]
        pal_a = np.full(256, 255, np.uint8)
        if trns is not None:
            t = np.frombuffer(trns, np.uint8)[:256]
            pal_a[:len(t)] = t
        idx = img[..., 0]
        return np.concatenate([pal[idx], pal_a[idx][..., None]], axis=2)
    if ctype == 0:
        g = img[..., 0]
        if depth == 16:
            grey = np.minimum(g, 255).astype(np.uint8)
        else:
            grey = (g.astype(np.uint16) * (255 // ((1 << depth) - 1))).astype(np.uint8)
        if trns is not None and len(trns) >= 2:
            (key,) = struct.unpack_from(">H", trns)
            if depth == 1:
                key = 255 if key else 0
            alpha[grey == key] = 0
        rgb = np.repeat(grey[..., None], 3, axis=2)
    elif ctype == 2:
        rgb = (img >> 8).astype(np.uint8) if depth == 16 else img
        if trns is not None and len(trns) >= 6:
            key = np.array(struct.unpack_from(">HHH", trns), np.int64)
            alpha[(rgb.astype(np.int64) == key).all(axis=2)] = 0
    else:  # 4 and 6: grey or colour with alpha
        s = (img >> 8).astype(np.uint8) if depth == 16 else img
        rgb = np.repeat(s[..., :1], 3, axis=2) if ctype == 4 else s[..., :3]
        alpha = s[..., -1]
    return np.ascontiguousarray(np.concatenate([rgb, alpha[..., None]], axis=2), np.uint8)


def _filter_rows(lines: np.ndarray, ftypes: np.ndarray, bpp: int) -> np.ndarray:
    """Raw scanlines (rows, row_bytes) uint8 -> filtered rows with their
    filter byte in front."""
    x = lines.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    preds = (np.zeros_like(x), a, b, (a + b) >> 1, _paeth(a, b, c))
    t = ftypes[:, None]
    pred = np.choose(np.broadcast_to(t, x.shape), preds)
    out = ((x - pred) & 0xFF).astype(np.uint8)
    return np.concatenate([ftypes.astype(np.uint8)[:, None], out], axis=1)


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """(ph, pw, channels) samples -> (ph, row_bytes) uint8 scanlines."""
    ph, pw, ch = samples.shape
    if depth == 8:
        return samples.astype(np.uint8).reshape(ph, pw * ch)
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(ph, pw * ch * 2)
    per = 8 // depth
    v = samples.reshape(ph, pw).astype(np.uint8)
    v = np.pad(v, ((0, 0), (0, (-pw) % per))).reshape(ph, -1, per)
    shifts = (8 - depth * (np.arange(per) + 1)).astype(np.uint8)
    return np.bitwise_or.reduce(v << shifts, axis=2).astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body))


def encode_png(samples, color_type: int = 6, bit_depth: int = 8, *, palette=None,
               trns: bytes | None = None, filters=0, interlace: bool = False,
               idat_chunks: int = 1, level: int = 6) -> bytes:
    """(H, W, channels) integer samples -> PNG bytes.  `filters`: a filter
    type (0-4) for every row, or a sequence cycled over the scanlines of
    each pass; `palette`: (n, 3) uint8 for colour type 3; `trns`: the raw
    tRNS chunk; `idat_chunks`: the compressed stream split over that many
    IDAT chunks."""
    s = np.asarray(samples)
    if s.ndim == 2:
        s = s[..., None]
    h, w, ch = s.shape
    if ch != _CHANNELS[color_type] or bit_depth not in _DEPTHS[color_type]:
        raise ValueError(f"{ch} channels at colour type {color_type}, bit depth {bit_depth}")
    bpp = max(1, ch * bit_depth // 8)
    cycle = np.atleast_1d(np.asarray(filters, np.int64))
    stream = []
    for x0, y0, dx, dy, pw, ph in _passes(w, h, interlace):
        lines = _pack(s[y0::dy, x0::dx], bit_depth)
        ft = cycle[np.arange(ph) % len(cycle)]
        stream.append(_filter_rows(lines, ft, bpp).tobytes())
    z = zlib.compress(b"".join(stream), level)
    step = -(-len(z) // idat_chunks)
    out = [SIGNATURE, _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, bit_depth, color_type,
                                                  0, 0, int(interlace)))]
    if palette is not None:
        out.append(_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()))
    if trns is not None:
        out.append(_chunk(b"tRNS", trns))
    out += [_chunk(b"IDAT", z[i:i + step]) for i in range(0, len(z), step)]
    out.append(_chunk(b"IEND", b""))
    return b"".join(out)

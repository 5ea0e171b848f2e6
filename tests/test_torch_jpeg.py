"""PyTorch port, the JPEG decoder (`utils/jpeg.py`, `csrc/jpeg_entropy.cpp`):
bit-equal to PIL's `Image.open(...).convert("RGBA")`, which the JAX package
uploads (libjpeg-turbo: ISLOW IDCT, fancy upsampling).

- PIL encodes at test time grey / 4:4:4 / 4:2:2 / 4:2:0, baseline and
  progressive, with and without optimised tables, without restart markers
  and with one every 1 and every 5 blocks, at qualities 5 / 50 / 95 / 100
  and sizes 1x1, 7x9, 37x53, 64x48, 17x130 (960 cases): the port's decode
  equals PIL's, and the C++ entropy decoder's coefficients equal the
  Python one's (`entropy_decode_plain`), coefficient for coefficient.
- More forms against PIL: 4:1:1, an RGB file (`keep_rgb`), comments and
  EXIF (skipped APPn), bytes libjpeg skips between markers, 16-bit DQT tables (at the encoder's values and at
  4x and 8x them, where the IDCT's output leaves 0..255 and saturates;
  at 9x-16x each file equal to PIL or refused);
  and files this test writes itself (`_encode_baseline`, a small baseline
  encoder with the standard Huffman tables) with sampling factors PIL
  does not write (h1v2, 3 and 4, chroma above luma, mixed), restart
  intervals, and the colour-space rules (JFIF, Adobe transform, 'RGB'
  component ids).
- The committed assets (`tests/assets/make_jpeg_assets.py`): PIL's bytes
  hash to `jpeg_expected.json`, and so do the port's.
- `BoxTexturedJpeg.glb` (its base colour a 1024^2 progressive JPEG) loads
  with the texture equal to the JAX loader's, and its 64 x 64 frames reach
  >= 35 dB against the JAX `Renderer` (the textured-box cell's camera,
  moved by the Cornell offset); the LDR panorama loads through
  `load_hdr_equirect` bit for bit with the JAX package's, and
  `cli.py render cornell --skybox <it>` writes the Renderer's frame.
- Each refused form raises NotImplementedError naming ROADMAP queue 1
  item 15, from the decoder and through the loader (among them 16-bit DQT
  tables 16x and 32x an encoder's, where PIL's SIMD IDCT overflows its
  16-bit lanes); truncated and corrupt
  files raise JPEGError (GLTFError through the loader), each within a few
  seconds, and byte-flipped files either decode or raise, never hang; a
  failing compiler raises (no Python fallback)."""

import torch_threads  # noqa: F401  (caps the CPU threads per test process)
import hashlib
import io
import itertools
import json
import time

import numpy as np
import pytest
from PIL import Image

from gltf_writer import GLBBuilder
from low_precision_raytracer_tpu.models import hierarchy as jh
from low_precision_raytracer_tpu.models.gltf import load_gltf as jax_load
from low_precision_raytracer_tpu.render.renderer import Renderer as JaxRenderer
from low_precision_raytracer_tpu.utils.image import load_hdr_equirect as jax_equirect
from low_precision_raytracer_tpu_torch.config import RenderConfig
from low_precision_raytracer_tpu_torch.models import hierarchy as th
from low_precision_raytracer_tpu_torch.models.gltf import GLTFError, load_gltf
from low_precision_raytracer_tpu_torch.render.renderer import Renderer
from low_precision_raytracer_tpu_torch.utils import jpeg as J
from low_precision_raytracer_tpu_torch.utils.image import load_hdr_equirect, load_image_rgba_u8
from low_precision_raytracer_tpu_torch.utils.png import decode_image
from test_torch_texture import CAMERA_OFFSET, jax_pallas_cfg, rig_box, run_frames

ASSETS = "tests/assets/"
ITEM_15 = r"ROADMAP queue 1 item 15\)"
# a malformed file fails within this many seconds (the decoder's loops
# are bounded by the data)
FAIL_WITHIN_S = 5.0


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"), np.uint8)


def _image(w: int, h: int, channels: int, seed: int) -> np.ndarray:
    """A smooth pattern with noise (uint8; (h, w) for one channel)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 128 + 90 * np.sin(xx / 5.0 + seed) * np.cos(yy / 7.0)
    arr = base[..., None] + rng.normal(0, 25, (h, w, channels)) + np.array([0, 40, -40][:channels])
    arr = np.clip(arr, 0, 255).astype(np.uint8)
    return arr[..., 0] if channels == 1 else arr


def _save(im: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, "JPEG", **kw)
    return buf.getvalue()


def _encode(arr: np.ndarray, **kw) -> bytes:
    return _save(Image.fromarray(arr), **kw)


def _check(data: bytes) -> None:
    """The port's decode equals PIL's, and the C++ coefficients equal the
    plain decoder's."""
    want = _pil(data)
    got = J.decode_jpeg(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    diff = np.abs(got.astype(int) - want)
    assert not diff.any(), f"{int((diff > 0).sum())} bytes differ, max {diff.max()}"
    plain = J.entropy_decode_plain(J.parse(data))
    native = J.entropy_decode(J.parse(data))
    for k, (a, b) in enumerate(zip(plain, native)):
        np.testing.assert_array_equal(a, b, err_msg=f"component {k}")


FORMS = {"grey": None, "444": 0, "422": 1, "420": 2}
MATRIX = list(itertools.product(FORMS, ("base", "prog"), ("std", "opt"), (0, 1, 5),
                                (5, 50, 95, 100), ((1, 1), (7, 9), (37, 53), (64, 48), (17, 130))))


@pytest.mark.parametrize("form,mode,tables,rst,quality,size", MATRIX, ids=[
    f"{f}-{m}-{t}-rst{r}-q{q}-{w}x{h}" for f, m, t, r, q, (w, h) in MATRIX])
def test_decode_matches_pil(form, mode, tables, rst, quality, size):
    w, h = size
    kw = dict(quality=quality, progressive=mode == "prog", optimize=tables == "opt")
    if FORMS[form] is not None:
        kw["subsampling"] = FORMS[form]
    if rst:
        kw["restart_marker_blocks"] = rst
    _check(_encode(_image(w, h, 1 if form == "grey" else 3, hash(size) % 97 + quality), **kw))


def _scale_dqt(data: bytes, scale: int) -> bytes:
    """`data` with every DQT table rewritten in 16-bit entries, each entry
    times `scale` (the entropy data unchanged)."""
    out, pos = bytearray(data[:2]), 2
    while True:
        m = data[pos + 1]
        n = int.from_bytes(data[pos + 2:pos + 4], "big")
        seg = data[pos + 4:pos + 2 + n]
        if m == 0xDB:
            new, i = bytearray(), 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                vals = np.frombuffer(seg[i + 1:i + 1 + 64 * (pq + 1)], ">u2" if pq else np.uint8)
                new += bytes([0x10 | tq]) + (vals.astype(np.int64) * scale).astype(">u2").tobytes()
                i += 1 + 64 * (pq + 1)
            out += b"\xff\xdb" + (len(new) + 2).to_bytes(2, "big") + new
        else:
            out += data[pos:pos + 2 + n]
        pos += 2 + n
        if m == 0xDA:
            return bytes(out + data[pos:])


def _rotated() -> Image.Exif:
    """EXIF saying 'rotate 90 degrees': PIL's convert does not apply it."""
    exif = Image.Exif()
    exif[0x0112] = 6
    return exif


# noise at quality 100, 4:4:4: its 16-bit DQT tables scaled drive the IDCT
# past the sample range (4x, 8x) and past the SIMD IDCT's 16-bit lanes (16x)
_NOISY_Q100 = _encode(np.clip(128 + np.random.default_rng(0).normal(0, 90, (64, 64, 3)), 0,
                              255).astype(np.uint8), quality=100, subsampling=0)


def _more_forms():
    rgb = _image(45, 29, 3, 11)
    cases = {
        "411-base": _encode(rgb, quality=70, subsampling="4:1:1"),
        "411-prog": _encode(rgb, quality=70, subsampling="4:1:1", progressive=True),
        "keep-rgb": _encode(rgb, quality=80, keep_rgb=True),
        "keep-rgb-prog": _encode(rgb, quality=80, keep_rgb=True, progressive=True),
        "comment-exif": _encode(rgb, quality=60, comment=b"a comment", exif=_rotated()),
        "restart-rows": _encode(rgb, quality=60, restart_marker_rows=1, progressive=True),
    }
    # bytes libjpeg skips between markers: a stray RSTn, a stuffed zero, fill
    plain = _encode(rgb, quality=60)
    for name, extra in (("stray-rst", b"\xff\xd3"), ("stray-ff00", b"\xff\x00"),
                        ("fill-bytes", b"\xff\xff\xff")):
        cases[name] = plain[:2] + extra + plain[2:]
    for scale in (1, 4, 8):
        cases[f"dqt16-x{scale}"] = _scale_dqt(_NOISY_Q100, scale)
    return cases


MORE = _more_forms()


@pytest.mark.parametrize("name", sorted(MORE))
def test_more_forms_match_pil(name):
    _check(MORE[name])


@pytest.mark.parametrize("scale", [4, 8])
def test_dqt16_scaled_leaves_the_sample_range(scale):
    """The 4x and 8x tables drive the IDCT's output past [-512, 511] (before
    + 128), where libjpeg's C range limit would wrap and its SIMD IDCT,
    which PIL runs here, saturates: the equality above holds the
    saturation."""
    frame = J.parse(MORE[f"dqt16-x{scale}"])
    a, out = J.IDCT_MATRIX.astype(np.float64), []
    for comp, c in zip(frame.comps, J.entropy_decode(frame)):
        x = (c.astype(np.float64) * comp.qt).reshape(-1, 8, 8)  # (block, v, u)
        ws = J._descale(np.einsum("yv,bvu->byu", a, x), 11)
        out.append(J._descale(np.einsum("xu,byu->byx", a, ws), 18))
    out = np.concatenate([o.ravel() for o in out])
    assert out.max() > 511 or out.min() < -512


@pytest.mark.parametrize("scale", [9, 10, 11, 12, 16])
def test_dqt16_scaled_decodes_or_refuses(scale):
    """Between the scales PIL decodes as the C code does (8x) and the
    scales where its SIMD IDCT's 16-bit lanes overflow (16x), the port
    decodes a file bit for bit with PIL or refuses it naming item 15,
    on the quality-100 noise and on a smoother image at quality 90."""
    smooth = _encode(_image(48, 40, 3, scale), quality=90, subsampling=0)
    for data in (_scale_dqt(_NOISY_Q100, scale), _scale_dqt(smooth, scale)):
        try:
            out = J.decode_jpeg(data)
        except NotImplementedError as e:
            assert "16-bit lanes" in str(e) and "item 15" in str(e)
            continue
        np.testing.assert_array_equal(out, np.asarray(Image.open(io.BytesIO(data)).convert("RGBA")))


# ---------------------------------------------------------------------------
# a small baseline encoder for the forms PIL does not write

_STD = {(0, 0): J._STD_DC[0], (0, 1): J._STD_DC[1], (1, 0): J._STD_AC[0], (1, 1): J._STD_AC[1]}
_QT = np.clip(np.rint(np.array(
    [16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
     14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
     18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
     49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99]) * 0.6), 1, 255)
_DCT = np.array([[np.sqrt((1 if u == 0 else 2) / 8) * np.cos((2 * x + 1) * u * np.pi / 16)
                  for x in range(8)] for u in range(8)])


def _codes(bits, values):
    """Canonical Huffman codes: symbol -> (code, length)."""
    out, code, p = {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            out[values[p]] = (code, length)
            code, p = code + 1, p + 1
        code <<= 1
    return out


class _Writer:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value, length):
        for i in range(length - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc, self.n = 0, 0

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _category(v):
    return 0 if v == 0 else int(abs(v)).bit_length()


def _bits_of(v, s):
    return v if v >= 0 else v + (1 << s) - 1


def _encode_baseline(planes, factors, restart=0, ids=(1, 2, 3), jfif=True, adobe=None):
    """A baseline JPEG of full-size uint8 planes, each sampled to its
    component's (h, v) factors by picking samples, DCT in float64,
    quantised by one table, coded with the standard Huffman tables
    (luminance for the first component)."""
    H, W = planes[0].shape
    mh, mv = max(f[0] for f in factors), max(f[1] for f in factors)
    mx, my = -(-W // (8 * mh)), -(-H // (8 * mv))
    blocks = []
    for plane, (h, v) in zip(planes, factors):
        dw, dh = -(-W * h // mh), -(-H * v // mv)
        rows = np.minimum(np.arange(dh) * mv // v, H - 1)
        cols = np.minimum(np.arange(dw) * mh // h, W - 1)
        p = plane[np.ix_(rows, cols)].astype(np.float64) - 128
        p = np.pad(p, ((0, my * v * 8 - dh), (0, mx * h * 8 - dw)), mode="edge")
        b = p.reshape(my * v, 8, mx * h, 8).transpose(0, 2, 1, 3)
        coef = np.einsum("ux,abxy,vy->abuv", _DCT, b, _DCT).reshape(my * v, mx * h, 64)
        blocks.append(np.rint(coef / _QT).astype(np.int64))
    if len(planes) == 1:  # one component: one block an MCU, its own blocks
        mcus = [[(0, b)] for b in blocks[0][:-(-H // 8), :-(-W // 8)].reshape(-1, 64)]
    else:
        mcus = [[(k, blocks[k][y * v + by, x * h + bx])
                 for k, (h, v) in enumerate(factors) for by in range(v) for bx in range(h)]
                for y in range(my) for x in range(mx)]
    codes = {k: _codes(*t) for k, t in _STD.items()}
    w, pred, rst = _Writer(), [0] * len(planes), 0
    data = bytearray()
    for m, mcu in enumerate(mcus):
        if restart and m and m % restart == 0:
            w.flush()
            data += w.out + bytes([0xFF, 0xD0 + rst % 8])
            w, pred, rst = _Writer(), [0] * len(planes), rst + 1
        for k, block in mcu:
            dc_codes, ac_codes = codes[(0, min(k, 1))], codes[(1, min(k, 1))]
            zz = block[J.ZIGZAG]
            diff, pred[k] = int(zz[0]) - pred[k], int(zz[0])
            s = _category(diff)
            w.put(*dc_codes[s])
            w.put(_bits_of(diff, s), s)
            run = 0
            last = max([i for i in range(1, 64) if zz[i]] or [0])
            for i in range(1, last + 1):
                if zz[i] == 0:
                    run += 1
                    continue
                while run > 15:
                    w.put(*ac_codes[0xF0])
                    run -= 16
                s = _category(int(zz[i]))
                w.put(*ac_codes[(run << 4) | s])
                w.put(_bits_of(int(zz[i]), s), s)
                run = 0
            if last < 63:
                w.put(*ac_codes[0x00])
    w.flush()
    data += w.out

    def seg(marker, body):
        return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body

    out = bytearray(b"\xff\xd8")
    if jfif:
        out += seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe is not None:
        out += seg(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([adobe]))
    out += seg(0xDB, bytes([0]) + _QT.astype(np.uint8)[J.ZIGZAG].tobytes())
    sof = bytes([8]) + H.to_bytes(2, "big") + W.to_bytes(2, "big") + bytes([len(planes)])
    for cid, (h, v) in zip(ids, factors):
        sof += bytes([cid, (h << 4) | v, 0])
    out += seg(0xC0, sof)
    for (tc, th), (bits, values) in _STD.items():
        out += seg(0xC4, bytes([(tc << 4) | th, *bits]) + bytes(values))
    if restart:
        out += seg(0xDD, restart.to_bytes(2, "big"))
    sos = bytes([len(planes)])
    for k, cid in enumerate(ids[:len(planes)]):
        sos += bytes([cid, (min(k, 1) << 4) | min(k, 1)])
    out += seg(0xDA, sos + bytes([0, 63, 0])) + data + b"\xff\xd9"
    return bytes(out)


FACTORS = {
    "440": ((1, 2), (1, 1), (1, 1)),          # h1v2 fancy
    "422": ((2, 1), (1, 1), (1, 1)),          # h2v1 fancy
    "420": ((2, 2), (1, 1), (1, 1)),          # h2v2 fancy
    "411": ((4, 1), (1, 1), (1, 1)),          # int_upsample 4 x 1
    "1x4": ((1, 4), (1, 1), (1, 1)),          # int_upsample 1 x 4
    "3x2": ((3, 2), (1, 1), (1, 1)),          # int_upsample 3 x 2
    "3x1": ((3, 1), (1, 1), (1, 1)),
    "42": ((4, 2), (1, 1), (1, 1)),           # int_upsample 4 x 2 (10 blocks)
    "41-21-21": ((4, 1), (2, 1), (2, 1)),     # h2v1 from (2, 1) components
    "14-12-11": ((1, 4), (1, 2), (1, 1)),     # h1v2 and int 1 x 4 in one file
    "22-21-12": ((2, 2), (2, 1), (1, 2)),     # h1v2 and h2v1 in one file
    "11-22-22": ((1, 1), (2, 2), (2, 2)),     # luma upsampled, chroma full
    "grey22": ((2, 2),),                      # one component: factors moot
}
SIZES = ((37, 53), (4, 11), (5, 6), (1, 1), (130, 17))
OWN = list(itertools.product(FACTORS, SIZES, (0, 3)))


@pytest.mark.parametrize("factors,size,restart", OWN, ids=[
    f"{f}-{w}x{h}-rst{r}" for f, (w, h), r in OWN])
def test_sampling_factors_match_pil(factors, size, restart):
    w, h = size
    fs = FACTORS[factors]
    rgb = _image(w, h, 3, w * 7 + h)
    planes = [rgb[..., k] for k in range(len(fs))]
    _check(_encode_baseline(planes, fs, restart=restart))


COLOR = {  # (component ids, JFIF APP0, Adobe transform) -> libjpeg's choice
    "jfif-ycc": ((1, 2, 3), True, None),
    "rgb-ids": ((82, 71, 66), False, None),
    "rgb-ids-under-jfif": ((82, 71, 66), True, None),
    "adobe-0": ((1, 2, 3), False, 0),
    "adobe-1": ((1, 2, 3), False, 1),
    "adobe-2": ((1, 2, 3), False, 2),
    "jfif-and-adobe-0": ((1, 2, 3), True, 0),
    "other-ids": ((7, 8, 9), False, None),
}


@pytest.mark.parametrize("name", sorted(COLOR))
def test_colour_space_rules_match_pil(name):
    ids, jfif, adobe = COLOR[name]
    rgb = _image(19, 13, 3, 5)
    _check(_encode_baseline([rgb[..., k] for k in range(3)], ((1, 1),) * 3, ids=ids,
                            jfif=jfif, adobe=adobe))


# ---------------------------------------------------------------------------
# committed assets, the loader, the panorama

EXPECTED = json.load(open(ASSETS + "jpeg_expected.json"))


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_assets_match_their_hashes(name):
    """PIL here gives the recorded bytes (the card, which has no PIL, is
    held to them), and so does the port."""
    with open(ASSETS + name, "rb") as fh:
        data = fh.read()
    want = EXPECTED[name]
    for rgba in (_pil(data), decode_image(data), load_image_rgba_u8(ASSETS + name)):
        assert list(rgba.shape) == want["shape"]
        assert hashlib.sha256(rgba.tobytes()).hexdigest() == want["sha256"]


def test_jpeg_glb_frames_match_jax():
    """BoxTexturedJpeg.glb: the 1024^2 base colour equal to the JAX
    loader's, and 64 x 64 bf16 frames of the cube (the camera moved by the
    Cornell offset) >= 35 dB against the JAX Renderer."""
    path = ASSETS + "BoxTexturedJpeg.glb"
    port, ref = load_gltf(path), jax_load(path)
    assert len(port.textures) == len(ref.textures) == 1
    np.testing.assert_array_equal(port.textures[0], np.asarray(ref.textures[0]))
    assert port.textures[0].shape == (1024, 1024, 4)
    n = 64
    jr = JaxRenderer(rig_box(jax_load(path), jh, CAMERA_OFFSET),
                     jax_pallas_cfg(width=n, height=n, precision="bf16"))
    tr = Renderer(rig_box(load_gltf(path), th, CAMERA_OFFSET),
                  RenderConfig(width=n, height=n, precision="bf16"), device="cpu")
    aux_t, _aux_j = run_frames(jr, tr, [0.0] * 2)
    assert aux_t["valid"].float().mean() > 0.2


def test_jpeg_panorama_matches_jax():
    path = ASSETS + "jpeg_sky_2048x1024_rst420.jpg"
    got, want = load_hdr_equirect(path), np.asarray(jax_equirect(path))
    assert got.dtype == want.dtype and got.shape == want.shape == (1024, 2048, 3)
    assert got.tobytes() == want.tobytes()


# ---------------------------------------------------------------------------
# refused and malformed files

_RGB = _image(16, 16, 3, 1)
_BASE = _encode(_RGB, quality=75)
_PROG = _encode(_RGB, quality=75, progressive=True)


def _sof_at(data):
    return data.index(b"\xff\xc0") if b"\xff\xc0" in data else data.index(b"\xff\xc2")


def _patch(data, at, new):
    return data[:at] + new + data[at + len(new):]


def _before_eoi(data, extra):
    e = data.rindex(b"\xff\xd9")
    return data[:e] + extra + data[e:]


def _scan_starts(data):
    out, i = [], data.find(b"\xff\xda")
    while i >= 0:
        out.append(i)
        i = data.find(b"\xff\xda", i + 2)
    return out


REFUSED = {
    "cmyk": lambda: _save(Image.new("CMYK", (16, 16), (10, 20, 30, 40)), quality=80),
    "sof9-arithmetic": lambda: _patch(_BASE, _sof_at(_BASE) + 1, b"\xc9"),
    "sof10-arithmetic-progressive": lambda: _patch(_PROG, _sof_at(_PROG) + 1, b"\xca"),
    "dac": lambda: _BASE[:2] + b"\xff\xcc\x00\x04\x00\x10" + _BASE[2:],
    "12-bit": lambda: _patch(_BASE, _sof_at(_BASE) + 4, bytes([12])),
    "sof3-lossless": lambda: _patch(_BASE, _sof_at(_BASE) + 1, b"\xc3"),
    "sof5-hierarchical": lambda: _patch(_BASE, _sof_at(_BASE) + 1, b"\xc5"),
    "dhp": lambda: _BASE[:2] + b"\xff\xde\x00\x02" + _BASE[2:],
    "dnl-height-0": lambda: _patch(_BASE, _sof_at(_BASE) + 5, b"\x00\x00"),
    "dnl-marker": lambda: _before_eoi(_BASE, b"\xff\xdc\x00\x04\x00\x10"),
    "progressive-dc-only": lambda: _PROG[:_scan_starts(_PROG)[1]] + b"\xff\xd9",
    "progressive-last-scan-dropped": lambda: _PROG[:_scan_starts(_PROG)[-1]] + b"\xff\xd9",
    "dqt16-x16-simd-overflow": lambda: _scale_dqt(_NOISY_Q100, 16),
    "dqt16-x32-simd-overflow": lambda: _scale_dqt(_NOISY_Q100, 32),
}


def _glb(data, tmp_path):
    b = GLBBuilder()
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    bv = b.add_buffer_view(data)
    b.images.append({"bufferView": bv, "mimeType": "image/jpeg"})
    b.textures.append({"source": 0})
    mat = b.add_material(base_color_texture=0)
    mid = b.add_mesh(pos, [0, 1, 2], normals=np.tile([0, 0, 1], (3, 1)).astype(np.float32),
                     uv0=pos[:, :2], material=mat)
    b.add_node(mesh=mid)
    path = str(tmp_path / "img.glb")
    b.write_glb(path)
    return path


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_forms_name_item_15(name, tmp_path):
    data = REFUSED[name]()
    with pytest.raises(NotImplementedError, match=ITEM_15):
        J.decode_jpeg(data)
    with pytest.raises(NotImplementedError, match=ITEM_15):
        load_gltf(_glb(data, tmp_path))


def _swap_rst(data):
    a = data.index(b"\xff\xd0")
    b = data.index(b"\xff\xd1")
    return _patch(_patch(data, a, b"\xff\xd1"), b, b"\xff\xd0")


_RST = _encode(_image(64, 48, 3, 2), quality=75, restart_marker_blocks=1)
_SOS = _BASE.index(b"\xff\xda")
MALFORMED = {
    "no-soi": lambda: b"\xff\xd9" + _BASE[2:],
    "cut-in-header": lambda: _BASE[:_SOS - 20],
    "cut-after-sos": lambda: _BASE[:_SOS + 14],
    "cut-mid-scan": lambda: _BASE[:(_SOS + len(_BASE)) // 2],
    "cut-before-eoi": lambda: _BASE[:-2],
    "cut-progressive": lambda: _PROG[:len(_PROG) * 2 // 3],
    "scan-data-ends-early": lambda: _BASE[:_SOS + 14] + _BASE[_SOS + 14:_SOS + 40] + b"\xff\xd9",
    "rst-out-of-order": lambda: _swap_rst(_RST),
    "rst-missing": lambda: _RST.replace(b"\xff\xd3", b"", 1),
    "zero-width": lambda: _patch(_BASE, _sof_at(_BASE) + 7, b"\x00\x00"),
    "two-components": lambda: _patch(_BASE, _sof_at(_BASE) + 9, b"\x02"),
    "bad-factors": lambda: _patch(_BASE, _sof_at(_BASE) + 11, b"\x50"),
    "huffman-overfull": lambda: _patch(_BASE, _BASE.index(b"\xff\xc4") + 5, b"\x03"),
    "unknown-component-in-sos": lambda: _patch(_BASE, _SOS + 5, b"\x09"),
    "no-quant-table": lambda: _patch(_BASE, _sof_at(_BASE) + 12, b"\x03"),
    "bad-segment-length": lambda: _patch(_BASE, 4, b"\xff\xff"),
    "reserved-marker": lambda: _BASE[:2] + b"\xff\x02\x00\x02" + _BASE[2:],
    "decompression-bomb": lambda: _patch(_BASE, _sof_at(_BASE) + 5, b"\xff\xff\xff\xff"),
    "mcu-over-10-blocks": lambda: _encode_baseline(
        [_RGB[..., k] for k in range(3)], ((4, 2), (2, 1), (2, 1))),
}


@pytest.mark.parametrize("name", sorted(MALFORMED))
def test_malformed_raises_jpegerror(name, tmp_path):
    data = MALFORMED[name]()
    t0 = time.perf_counter()
    with pytest.raises(J.JPEGError):
        J.decode_jpeg(data)
    with pytest.raises(J.JPEGError):
        f = J.parse(data)
        J.reconstruct(f, J.entropy_decode_plain(f))
    with pytest.raises(GLTFError):
        load_gltf(_glb(data, tmp_path))
    assert time.perf_counter() - t0 < FAIL_WITHIN_S


@pytest.mark.parametrize("source", ["base", "prog", "rst"])
def test_flipped_bytes_decode_or_raise(source):
    """50 files, each with 2 random bytes changed anywhere and 2 in the
    entropy-coded data: each decodes or raises JPEGError /
    NotImplementedError, within the limit (the C++ decoder never reads or
    writes out of bounds: its loops and stores are bounded by the data)."""
    data = {"base": _BASE, "prog": _PROG, "rst": _RST}[source]
    rng = np.random.default_rng(len(source))
    scan = data.index(b"\xff\xda") + 16
    for _ in range(50):
        bad = bytearray(data)
        for at in (*rng.integers(2, len(data) - 2, 2), *rng.integers(scan, len(data) - 2, 2)):
            bad[at] = int(rng.integers(0, 256))
        t0 = time.perf_counter()
        try:
            out = J.decode_jpeg(bytes(bad))
            assert out.dtype == np.uint8 and out.ndim == 3 and out.shape[2] == 4
        except (J.JPEGError, NotImplementedError):
            pass
        assert time.perf_counter() - t0 < FAIL_WITHIN_S


def test_cli_render_with_jpeg_skybox(tmp_path):
    """`cli.py render cornell --skybox <panorama>.jpg` writes the frame the
    Renderer gives the scene with that panorama as its sky."""
    from low_precision_raytracer_tpu_torch import cli
    from low_precision_raytracer_tpu_torch.models.procedural import cornell_box_scene
    from low_precision_raytracer_tpu_torch.models.scene import Skybox
    from low_precision_raytracer_tpu_torch.utils.image import to_uint8
    from low_precision_raytracer_tpu_torch.utils.png import decode_png

    sky, out = ASSETS + "jpeg_sky_2048x1024_rst420.jpg", tmp_path / "c.png"
    assert cli.main(["render", "cornell", "--width", "16", "--height", "16", "--frames", "1",
                     "--skybox", sky, "--device", "cpu", "--out", str(out)]) == 0
    scene = cornell_box_scene()
    scene.skybox = Skybox(data=load_hdr_equirect(sky), exposure=1.0)
    img, _aux = Renderer(scene, RenderConfig(width=16, height=16), device="cpu").render()
    np.testing.assert_array_equal(decode_png(out.read_bytes())[..., :3], to_uint8(img)[::-1])


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """A compiler that fails raises with its output; the Python entropy
    decoder never stands in for the C++ one."""
    from low_precision_raytracer_tpu_torch.utils import host_build

    monkeypatch.setattr(J, "_lib", None)
    monkeypatch.setattr(host_build, "BUILD", tmp_path)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="jpeg_entropy.cpp"):
        J.decode_jpeg(_BASE)

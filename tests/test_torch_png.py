"""PyTorch port, the PNG decoder (`utils/png.py`): bit-equal to PIL's
`Image.open(...).convert("RGBA")`, which the JAX loader uploads, on images
the test writes in every colour type and bit depth, each row filter alone
and all five cycled, with and without Adam7 interlace and tRNS, over
several IDAT chunks (`encode_png` forces each filter, which the test reads
back from the stream; PIL decodes the files independently); on images PIL writes itself and on the repo's
BoxTexturedCheck.png.  Also: a broken CRC, a cut stream and an unknown
filter raise PNGError (a ValueError, which the loader reports as
GLTFError), and a JPEG decodes through `decode_image` and the loader."""

import torch_threads  # noqa: F401  (caps the CPU threads per test process)
import io
import time
import zlib

import numpy as np
import pytest
from PIL import Image

from gltf_writer import GLBBuilder
from low_precision_raytracer_tpu_torch.models.gltf import GLTFError, load_gltf
from low_precision_raytracer_tpu_torch.utils.png import (
    PNGError,
    _chunk,
    decode_image,
    decode_png,
    encode_png,
)

# (colour type, bit depth) of every PNG kind
KINDS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4),
         (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
FILTERS = [0, 1, 2, 3, 4, (0, 1, 2, 3, 4), (4, 3, 2, 1, 0, 4)]


def _pil_rgba(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"), np.uint8)


def _row_filters(data: bytes, h: int, row_bytes: int) -> list:
    """The filter byte of each scanline of a non-interlaced PNG, read
    straight from its IDAT stream."""
    off, idat = 8, b""
    while off < len(data):
        n, kind = int.from_bytes(data[off:off + 4], "big"), data[off + 4:off + 8]
        if kind == b"IDAT":
            idat += data[off + 8:off + 8 + n]
        off += 12 + n
    raw = zlib.decompress(idat)
    return [raw[r * (row_bytes + 1)] for r in range(h)]


def _image(ct, depth, h, w, rng):
    """Random samples of one kind, with its palette and a tRNS chunk that
    hits some pixels."""
    top = 1 << depth
    if ct == 3:
        n_pal = min(top, 11)
        s = rng.integers(0, n_pal, (h, w, 1))
        pal = rng.integers(0, 256, (n_pal, 3), dtype=np.uint8)
        return s, pal, bytes(rng.integers(0, 256, max(1, n_pal - 3), dtype=np.uint8))
    s = rng.integers(0, top, (h, w, CHANNELS[ct]))
    if ct == 0:  # the key: a sample value that occurs (PIL compares it with the scaled grey)
        return s, None, int(s[0, 0, 0]).to_bytes(2, "big")
    if ct == 2:
        return s, None, b"".join(int(v).to_bytes(2, "big") for v in s[0, 0])
    return s, None, None


@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("kind", KINDS, ids=[f"ct{c}-{d}bit" for c, d in KINDS])
def test_decoder_matches_pil(kind, interlace):
    """Every filter choice, three sizes (1 x 1, odd, wider than tall), tRNS
    off and on, the stream split over three IDAT chunks."""
    ct, depth = kind
    rng = np.random.default_rng(ct * 100 + depth)
    for h, w in ((1, 1), (13, 11), (5, 37)):
        s, pal, trns = _image(ct, depth, h, w, rng)
        for filters in FILTERS:
            for t in (None, trns) if trns else (None,):
                data = encode_png(s, ct, depth, palette=pal, trns=t, filters=filters,
                                  interlace=interlace, idat_chunks=3)
                ref = _pil_rgba(data)
                got = decode_png(data)
                assert got.dtype == np.uint8 and got.shape == ref.shape == (h, w, 4)
                assert np.array_equal(got, ref), (h, w, filters, t is not None)
                if not interlace:  # each scanline carries the filter asked for
                    cycle = list(np.atleast_1d(filters))
                    row_bytes = -(-w * CHANNELS[ct] * depth // 8)
                    assert _row_filters(data, h, row_bytes) == \
                        [cycle[r % len(cycle)] for r in range(h)]


def test_sixteen_bit_quirks():
    """PIL keeps the high byte of 16-bit colour, clips 16-bit grey to 255,
    and compares a 16-bit RGB tRNS key with the high bytes; the decoder
    copies all three."""
    grey = np.array([[[0], [200], [255], [256], [65535]]], np.uint16)
    got = decode_png(encode_png(grey, 0, 16))
    assert got[0, :, 0].tolist() == [0, 200, 255, 255, 255]
    rgb = np.array([[[0x1234, 0xABCD, 0x00FF], [0x0012, 0x00AB, 0x0000]]], np.uint16)
    data = encode_png(rgb, 2, 16, trns=bytes.fromhex("001200ab0000"))
    got = decode_png(data)
    assert got[0, 0].tolist() == [0x12, 0xAB, 0x00, 0]  # high bytes hit the key
    assert got[0, 1].tolist() == [0, 0, 0, 255]
    assert np.array_equal(got, _pil_rgba(data))


@pytest.mark.parametrize("mode", ["RGBA", "RGB", "L", "LA", "P", "1", "I;16"])
def test_pil_written_images(mode):
    """Images PIL writes with its own filter choice, read back by both."""
    rng = np.random.default_rng(len(mode))
    rgba = rng.integers(0, 256, (40, 57, 4), dtype=np.uint8)
    rgba[:20, :20] = [10, 200, 30, 255]  # flat areas for the filter heuristics
    img = Image.fromarray(rgba, "RGBA")
    img = img.convert(mode) if mode != "I;16" else Image.fromarray(
        rng.integers(0, 600, (40, 57)).astype(np.uint16))
    assert img.mode == mode
    for optimize in (False, True):
        buf = io.BytesIO()
        img.save(buf, format="PNG", optimize=optimize)
        data = buf.getvalue()
        assert np.array_equal(decode_png(data), _pil_rgba(data)), optimize


def test_repo_texture_and_decode_time():
    """The Khronos checker, and a 1024^2 RGBA image with all five filters
    cycled: bit-equal, and decoded in a few seconds at most."""
    data = open("tests/assets/BoxTexturedCheck.png", "rb").read()
    assert np.array_equal(decode_image(data), _pil_rgba(data))
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (1024, 1024, 4), dtype=np.uint8)
    data = encode_png(img, 6, 8, filters=(0, 1, 2, 3, 4))
    t0 = time.perf_counter()
    got = decode_png(data)
    seconds = time.perf_counter() - t0
    assert np.array_equal(got, img) and np.array_equal(got, _pil_rgba(data))
    assert seconds < 10, seconds


def _corrupt(kind):
    data = bytearray(encode_png(np.full((4, 4, 4), 7, np.uint8), 6, 8, filters=2))
    if kind == "crc":
        data[-13] ^= 1  # inside the IDAT chunk
    elif kind == "truncated":
        del data[-20:]
    elif kind == "short-stream":
        z = zlib.compress(b"\x00" * 5)
        data = bytearray(data[:33] + _chunk(b"IDAT", z) + _chunk(b"IEND", b""))
    elif kind == "filter":
        z = zlib.compress(bytes([7] + [0] * 16) * 4)
        data = bytearray(data[:33] + _chunk(b"IDAT", z) + _chunk(b"IEND", b""))
    elif kind == "depth":
        data = bytearray(encode_png(np.zeros((2, 2, 3), np.uint8), 2, 8))
        data[24] = 4  # RGB at 4 bits
        data[29:33] = zlib.crc32(bytes(data[12:29])).to_bytes(4, "big")
    elif kind == "signature":
        data[1] = ord("Q")
    return bytes(data)


@pytest.mark.parametrize("kind", ["crc", "truncated", "short-stream", "filter", "depth",
                                  "signature"])
def test_bad_png_raises(kind, tmp_path):
    """A bad PNG raises PNGError from the decoder and GLTFError from the
    loader."""
    data = _corrupt(kind)
    with pytest.raises(PNGError):
        decode_image(data)
    path = _glb_with_image(data, tmp_path)
    with pytest.raises(GLTFError):
        load_gltf(path)


def _glb_with_image(data: bytes, tmp_path, mime="image/png"):
    b = GLBBuilder()
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    bv = b.add_buffer_view(data)
    b.images.append({"bufferView": bv, "mimeType": mime})
    b.textures.append({"source": 0})
    mat = b.add_material(base_color_texture=0)
    mid = b.add_mesh(pos, [0, 1, 2], normals=np.tile([0, 0, 1], (3, 1)).astype(np.float32),
                     uv0=pos[:, :2], material=mat)
    b.add_node(mesh=mid)
    path = str(tmp_path / "img.glb")
    b.write_glb(path)
    return path


def test_jpeg_waits(tmp_path):
    """A JPEG, which the port once refused (ROADMAP queue 1 item 14, done),
    now decodes: through `decode_image` and through the loader, equal to
    PIL's `convert("RGBA")` (`tests/test_torch_jpeg.py` holds the decoder
    on every form)."""
    buf = io.BytesIO()
    rgb = np.random.default_rng(0).integers(0, 256, (8, 8, 3), dtype=np.uint8)
    Image.fromarray(rgb).save(buf, format="JPEG")
    data = buf.getvalue()
    np.testing.assert_array_equal(decode_image(data), _pil_rgba(data))
    path = _glb_with_image(data, tmp_path, "image/jpeg")
    scene = load_gltf(path)
    np.testing.assert_array_equal(scene.textures[0], _pil_rgba(data))

"""Image IO and quality measures (port of
`low_precision_raytracer_tpu/utils/image.py`).  Internal convention:
(H, W, 3) float arrays or tensors with row 0 at the image BOTTOM
(normalized_y = -1, see ops/camera.py); files are flipped on write so PNGs
look upright.  numpy and `zlib` only: `save_png` writes through
`utils/png.py:encode_png` and `load_image_rgba_u8` reads through its
decoder (the JAX package uses PIL, which the card's machine lacks); the
Radiance RGBE decoder is the JAX package's, copied.  `psnr` and `ssim`
take arrays or CPU tensors, in float64."""

from __future__ import annotations

import numpy as np

from low_precision_raytracer_tpu_torch.utils.png import decode_image, encode_png


def to_uint8(img) -> np.ndarray:
    """[0, 1] floats (an array, or a tensor on any device) -> uint8,
    rounded half up and clipped (NaN -> 0)."""
    if hasattr(img, "detach"):
        img = img.detach().float().cpu().numpy()
    img = np.asarray(img, np.float32)
    return np.nan_to_num(np.clip(img * 255.0 + 0.5, 0, 255)).astype(np.uint8)


def save_png(path: str, img) -> None:
    """Write an (H, W, 3) image as an 8-bit RGB PNG, flipped upright."""
    arr = to_uint8(img)[::-1]  # flip: row 0 is bottom internally
    with open(path, "wb") as fh:
        fh.write(encode_png(np.ascontiguousarray(arr), color_type=2))


def load_image_rgba_u8(path: str, flip: bool = False) -> np.ndarray:
    """An image file -> (H, W, 4) uint8 RGBA (PNG; a JPEG raises
    NotImplementedError, ROADMAP queue 1 item 14)."""
    with open(path, "rb") as fh:
        arr = decode_image(fh.read())
    return arr[::-1] if flip else arr


def load_radiance_hdr(path: str) -> np.ndarray:
    """Native Radiance RGBE (.hdr) decoder -> (H, W, 3) f32 radiance, rows
    top-down as stored (`-Y h +X w`).  Handles both the flat 4-byte-RGBE
    stream and the adaptive-RLE scanline format, plus old-style
    repeat-previous-pixel runs — the same coverage as the reference's
    stb_image `stbi_loadf` path (`rt/rtrt/loader.cu` skybox load).  A
    pure-python/NumPy decoder is required here: generic image libraries
    route .hdr through LDR codecs and clamp to uint8, destroying the
    dynamic range IBL exists for.

    Corrupt/truncated files raise ValueError naming the file — decoder
    internals (index/broadcast errors on short reads) never escape raw."""
    try:
        return _load_radiance_hdr_checked(path)
    except (ValueError, IndexError, OverflowError) as e:
        if str(e).startswith(path):  # already a typed decoder error
            raise
        raise ValueError(
            f"{path}: corrupt Radiance RGBE file ({type(e).__name__}: {e})"
        ) from e


def _load_radiance_hdr_checked(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError(f"{path}: not a Radiance RGBE file")
    # header: lines until the first empty line; then the resolution line
    pos = 0
    fmt_ok = False
    while True:
        nl = data.index(b"\n", pos)
        line = data[pos:nl]
        pos = nl + 1
        if line.startswith(b"FORMAT="):
            fmt_ok = line.strip() == b"FORMAT=32-bit_rle_rgbe"
        if line == b"":
            break
    if not fmt_ok:
        raise ValueError(f"{path}: unsupported FORMAT (want 32-bit_rle_rgbe)")
    nl = data.index(b"\n", pos)
    res = data[pos:nl].split()
    pos = nl + 1
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"{path}: unsupported orientation {res!r}")
    h, w = int(res[1]), int(res[3])
    if h <= 0 or w <= 0 or h * w > (1 << 28):
        raise ValueError(f"{path}: implausible resolution {w}x{h}")

    buf = np.frombuffer(data, np.uint8, offset=pos)
    rgbe = np.empty((h, w, 4), np.uint8)
    i = 0
    for y in range(h):
        if w < 8 or w > 0x7FFF or buf[i] != 2 or buf[i + 1] != 2 or buf[i + 2] & 0x80:
            # flat / old-RLE scanline: 4-byte pixels; [1,1,1,n] repeats the
            # PREVIOUS pixel n << (8*consecutive_count) times.  Radiance's
            # oldreadcolrs copies scan[-1], i.e. with rows decoded into one
            # contiguous buffer a run at x == 0 repeats the previous ROW's
            # last pixel; a run before any pixel exists is corrupt.
            x = 0
            shift = 0
            while x < w:
                px = buf[i : i + 4]
                i += 4
                if px[0] == 1 and px[1] == 1 and px[2] == 1 and (x > 0 or y > 0):
                    n = int(px[3]) << shift
                    if x + n > w:
                        raise ValueError(
                            f"{path}: old-RLE run overruns row {y} "
                            f"(x={x} + n={n} > width={w})"
                        )
                    prev = rgbe[y, x - 1] if x > 0 else rgbe[y - 1, w - 1]
                    rgbe[y, x : x + n] = prev
                    x += n
                    shift += 8
                else:
                    if px[0] == 1 and px[1] == 1 and px[2] == 1:
                        raise ValueError(
                            f"{path}: old-RLE run before any decoded pixel"
                        )
                    rgbe[y, x] = px
                    x += 1
                    shift = 0
            continue
        if (int(buf[i + 2]) << 8 | int(buf[i + 3])) != w:
            raise ValueError(f"{path}: RLE scanline width mismatch at row {y}")
        i += 4
        # adaptive RLE: 4 component planes, runs (code > 128: repeat
        # code-128 copies of the next byte) and literals (code bytes follow)
        for c in range(4):
            x = 0
            while x < w:
                code = int(buf[i])
                i += 1
                if code > 128:
                    n = code - 128
                    rgbe[y, x : x + n, c] = buf[i]
                    i += 1
                else:
                    n = code
                    rgbe[y, x : x + n, c] = buf[i : i + n]
                    i += n
                x += n
            if x != w:  # a run crossed the row boundary: corrupt stream
                raise ValueError(
                    f"{path}: RLE run overruns row {y} component {c}"
                )
    # decode: rgb = mantissa * 2^(e-136); e == 0 -> black (stb semantics)
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


def load_hdr_equirect(path: str) -> np.ndarray:
    """Load an HDR panorama: the Radiance RGBE decode for .hdr files (full
    dynamic range), an sRGB->linear LDR image for anything else."""
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"#?":
        return load_radiance_hdr(path)
    arr = load_image_rgba_u8(path).astype(np.float32) / 255.0
    return arr[..., :3] ** 2.2


def psnr(a, b, peak=1.0) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / mse))


def ssim(a, b) -> float:
    """Global (single-window) SSIM over the luma channel — a coarse but
    dependency-free structural similarity for parity tests."""
    a = np.asarray(a, np.float64).mean(axis=-1)
    b = np.asarray(b, np.float64).mean(axis=-1)
    c1, c2 = 0.01**2, 0.03**2
    mu_a, mu_b = a.mean(), b.mean()
    va, vb = a.var(), b.var()
    cov = ((a - mu_a) * (b - mu_b)).mean()
    return float(
        ((2 * mu_a * mu_b + c1) * (2 * cov + c2))
        / ((mu_a**2 + mu_b**2 + c1) * (va + vb + c2))
    )

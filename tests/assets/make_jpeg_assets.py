"""Write the JPEG test assets of the PyTorch port (PIL encodes them; its
`convert("RGBA")` bytes are the bar the port's decoder is held to):

- `jpeg_texture_1024_prog420.jpg`: a 1024 x 1024 base-colour texture, a
  smooth red / cream checker with mild noise, progressive 4:2:0, quality 85;
- `jpeg_sky_2048x1024_rst420.jpg`: an LDR equirectangular panorama, the
  procedural sky (`models/procedural.py:procedural_sky`) tonemapped to 8
  bits, baseline 4:2:0 with a restart marker every 16 MCUs, quality 90;
- small forms: `jpeg_grey_37x53.jpg` (one component, baseline),
  `jpeg_444_64x48_prog.jpg` (4:4:4 progressive, optimised tables),
  `jpeg_422_17x130_rst.jpg` (4:2:2, restart every block),
  `jpeg_420_7x9_prog.jpg` (4:2:0 progressive, partial MCUs);
- `BoxTexturedJpeg.glb`: BoxTextured.gltf's cube with the 1024^2 texture
  embedded as its base colour (`image/jpeg` in a bufferView);
- `jpeg_expected.json`: each JPEG's (height, width, 4) shape and the
  SHA-256 of PIL's `convert("RGBA")` bytes, which a machine without PIL
  (the card's) holds the port against.

Run from the repo root: `python tests/assets/make_jpeg_assets.py`
(PIL needed; the output is committed)."""

import hashlib
import io
import json
import os
import struct
import sys

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

TEXTURE = "jpeg_texture_1024_prog420.jpg"
SKY = "jpeg_sky_2048x1024_rst420.jpg"
GLB = "BoxTexturedJpeg.glb"
EXPECTED = "jpeg_expected.json"


def checker(size: int, seed: int = 0) -> np.ndarray:
    """A smooth 8 x 8 checker, red and cream, with mild noise (uint8 RGB)."""
    rng = np.random.default_rng(seed)
    t = (np.arange(size) + 0.5) / size * 8 * np.pi
    s = np.sin(t)[:, None] * np.sin(t)[None, :]
    w = 0.5 + 0.5 * np.tanh(6.0 * s)[..., None]
    red, cream = np.array([200.0, 40.0, 30.0]), np.array([235.0, 225.0, 200.0])
    img = w * red + (1 - w) * cream + rng.normal(0.0, 2.0, (size, size, 3))
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def sky_ldr(height: int, width: int) -> np.ndarray:
    """The procedural sky, Reinhard-tonemapped and gamma 2.2, uint8 RGB,
    row 0 at the top (as a panorama file stores it)."""
    from low_precision_raytracer_tpu_torch.models.procedural import procedural_sky

    hdr = np.asarray(procedural_sky(height, width), np.float64)
    ldr = (hdr / (1.0 + hdr)) ** (1 / 2.2)
    return np.clip(np.rint(ldr * 255), 0, 255).astype(np.uint8)


def small(width: int, height: int, grey: bool, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width]
    base = 128 + 90 * np.sin(xx / 5.0 + seed) * np.cos(yy / 7.0)
    ch = 1 if grey else 3
    arr = base[..., None] + rng.normal(0, 25, (height, width, ch)) + np.array([0, 40, -40][:ch])
    arr = np.clip(arr, 0, 255).astype(np.uint8)
    return arr[..., 0] if grey else arr


def encode(arr: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", **kw)
    return buf.getvalue()


def write_glb(jpeg: bytes) -> bytes:
    """BoxTextured.gltf with its buffer and the JPEG in one GLB."""
    with open(os.path.join(HERE, "BoxTextured.gltf")) as fh:
        gltf = json.load(fh)
    with open(os.path.join(HERE, "BoxTextured0.bin"), "rb") as fh:
        geometry = fh.read()
    pad = (-len(geometry)) % 4
    binary = geometry + b"\0" * pad + jpeg
    binary += b"\0" * ((-len(binary)) % 4)
    gltf["buffers"] = [{"byteLength": len(binary)}]
    gltf["bufferViews"].append({"buffer": 0, "byteOffset": len(geometry) + pad,
                                "byteLength": len(jpeg)})
    gltf["images"] = [{"bufferView": len(gltf["bufferViews"]) - 1, "mimeType": "image/jpeg"}]
    text = json.dumps(gltf, separators=(",", ":")).encode()
    text += b" " * ((-len(text)) % 4)
    chunks = (struct.pack("<II", len(text), 0x4E4F534A) + text
              + struct.pack("<II", len(binary), 0x004E4942) + binary)
    return struct.pack("<III", 0x46546C67, 2, 12 + len(chunks)) + chunks


def main() -> None:
    files = {
        TEXTURE: encode(checker(1024), quality=85, progressive=True, subsampling=2),
        SKY: encode(sky_ldr(1024, 2048), quality=90, subsampling=2,
                    restart_marker_blocks=16),
        "jpeg_grey_37x53.jpg": encode(small(37, 53, True, 1), quality=75),
        "jpeg_444_64x48_prog.jpg": encode(small(64, 48, False, 2), quality=95, subsampling=0,
                                          progressive=True, optimize=True),
        "jpeg_422_17x130_rst.jpg": encode(small(17, 130, False, 3), quality=50, subsampling=1,
                                          restart_marker_blocks=1),
        "jpeg_420_7x9_prog.jpg": encode(small(7, 9, False, 4), quality=100, subsampling=2,
                                        progressive=True),
    }
    expected = {}
    for name, data in files.items():
        with open(os.path.join(HERE, name), "wb") as fh:
            fh.write(data)
        rgba = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
        expected[name] = dict(shape=list(rgba.shape),
                              sha256=hashlib.sha256(rgba.tobytes()).hexdigest())
    with open(os.path.join(HERE, GLB), "wb") as fh:
        fh.write(write_glb(files[TEXTURE]))
    with open(os.path.join(HERE, EXPECTED), "w") as fh:
        json.dump(expected, fh, indent=1, sort_keys=True)
        fh.write("\n")
    total = sum(len(d) for d in files.values()) + os.path.getsize(os.path.join(HERE, GLB))
    print(f"wrote {len(files)} JPEGs and {GLB}: {total / 1024:.1f} KiB")


if __name__ == "__main__":
    main()

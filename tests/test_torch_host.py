"""PyTorch port, the host layer: the controllers (`gui/controller.py`, a
copy), checkpoint / resume (`render/checkpoint.py`, including a file the
JAX package wrote), the pixel picker (`utils/debug.py`), the stage names
and sync (`utils/timing.py`), the generator (`utils/rng.py`) and the image
IO (`utils/image.py`: `to_uint8`, `save_png` through the port's PNG
encoder, `load_image_rgba_u8`, the Radiance RGBE decoder), each against
its JAX counterpart (tests/test_aux.py :21-46, :119, :194-300).

Bars: controllers, HDR decodes, image bytes and stage names equal to the
JAX package's; a resumed port run bit for bit equal to an unbroken one; a
JAX checkpoint's next frame >= 35 dB against the JAX Renderer's."""

import torch_threads  # noqa: F401  (caps the CPU threads per test process)
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from low_precision_raytracer_tpu.config import RenderConfig as JaxConfig
from low_precision_raytracer_tpu.config import SVGFConfig as JaxSVGF
from low_precision_raytracer_tpu.gui import controller as jctl
from low_precision_raytracer_tpu.models.procedural import cornell_box_scene as jax_cornell
from low_precision_raytracer_tpu.render.checkpoint import save_checkpoint as jax_save
from low_precision_raytracer_tpu.render.renderer import Renderer as JaxRenderer
from low_precision_raytracer_tpu.utils import image as jimage
from low_precision_raytracer_tpu.utils.debug import pick_pixel as jax_pick_pixel
from low_precision_raytracer_tpu_torch.config import RenderConfig
from low_precision_raytracer_tpu_torch.gui.controller import HoldRotateController, MoveController
from low_precision_raytracer_tpu_torch.models.procedural import cornell_box_scene
from low_precision_raytracer_tpu_torch.render.checkpoint import load_checkpoint, save_checkpoint
from low_precision_raytracer_tpu_torch.render.renderer import Renderer
from low_precision_raytracer_tpu_torch.utils import image as timage
from low_precision_raytracer_tpu_torch.utils.png import decode_png
from test_aux import _rgbe_encode, _write_hdr_flat, _write_hdr_rle
from test_torch_render_e2e import _jax_uniforms, _psnr


# ---- controllers ---------------------------------------------------------


def _move_trace(cls):
    c = cls(initial_speed=1.0, acceleration=10.0, max_speed=5.0, max_position=100.0)
    out = []
    for i in range(50):
        c.receive_event(0.1, i % 17 < 12, i % 17 >= 14)
        out.append((c.accumulated_pos, c._speed))
    c.receive_event(0.1, False, False)
    out.append((c._speed, c.pop_value(), c.get_value()))
    return out


def test_move_controller_accelerates_and_clamps():
    c = MoveController(initial_speed=1.0, acceleration=10.0, max_speed=5.0, max_position=100.0)
    for _ in range(50):
        c.receive_event(0.1, True, False)
    assert c.accumulated_pos > 0
    assert abs(c._speed) <= 5.0 + 1e-9
    c.receive_event(0.1, False, False)  # releasing resets speed
    assert c._speed == 0.0
    v = c.pop_value()
    assert v > 0 and c.get_value() == 0.0
    assert _move_trace(MoveController) == _move_trace(jctl.MoveController)


def test_rotate_controller_drag_and_clamp():
    def trace(cls):
        c = cls()
        out = []
        for ev in (((0, 0), True, 0.0), ((100, 5000), True, 0.0), ((100, 5000), False, 100.0),
                   ((7000, 3), True, -3.0), ((-9000, 3), True, 0.0)):
            c.receive_event(*ev)
            out.append(c.get_xyz())
        c.clear()
        return out + [c.get_xyz()]

    c = HoldRotateController()
    c.receive_event((0, 0), right_down=True)
    c.receive_event((100, 5000), right_down=True)
    assert c.acc_x != 0 and c.acc_y == c.y_max  # pitch clamped
    c.receive_event((100, 5000), right_down=False, wheel=100.0)
    assert c.acc_z == c.z_max  # fov clamped
    c.clear()
    assert c.acc_x == 0 and abs(c.acc_z - math.pi * 0.3) < 1e-9
    assert trace(HoldRotateController) == trace(jctl.HoldRotateController)


# ---- checkpoint / resume -------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    """Save after 2 frames (bf16 TAA history under state_f32=False, TAA at
    0.3), load into a fresh Renderer with another seed: frames 3-4 equal an
    unbroken run's bit for bit (the state and the generator restored)."""
    from low_precision_raytracer_tpu_torch.config import SVGFConfig

    cfg = RenderConfig(width=16, height=16, precision="bf16", taa_mix_weight=0.3,
                       svgf=SVGFConfig(state_f32=False))
    a = Renderer(cornell_box_scene(), cfg, device="cpu")
    for _ in range(2):
        a.render()
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, a.state, a.generator, a.frame_index)
    b = Renderer(cornell_box_scene(), cfg, device="cpu", seed=7)
    state, gen, fi = load_checkpoint(path, device="cpu")
    assert fi == 2 and state.taa_history.dtype == torch.bfloat16
    assert state.last_l2w.shape == a.state.last_l2w.shape
    b.state, b.generator, b.frame_index = state, gen, fi
    for _ in range(2):
        ia, _ = a.render()
        ib, _ = b.render()
        assert torch.equal(ia, ib)
        assert torch.equal(a.state.svgf_colored.color_history, b.state.svgf_colored.color_history)
    assert b.frame_index == 4


def test_checkpoint_from_jax_package(tmp_path):
    """A checkpoint the JAX package saved after 3 frames (32 x 32 bf16),
    loaded by the port: its 12 fields carried across (the key left aside);
    the port's next frame, fed the JAX draws, against the JAX Renderer's."""
    n = 32
    jr = JaxRenderer(jax_cornell(), JaxConfig(width=n, height=n, precision="bf16",
                                              traversal_impl="dense_pallas",
                                              svgf=JaxSVGF(wavelet_impl="pallas")))
    for _ in range(3):
        jr.render()
    path = str(tmp_path / "jax_ck.npz")
    jax_save(path, jr.state, jr.key, jr.frame_index)
    tr = Renderer(cornell_box_scene(), RenderConfig(width=n, height=n, precision="bf16"),
                  device="cpu")
    state, gen, fi = load_checkpoint(path, device="cpu")
    assert gen is None and fi == 3
    np.testing.assert_array_equal(state.svgf_frame_count.numpy(),
                                  np.asarray(jr.state.svgf_frame_count))
    np.testing.assert_array_equal(state.svgf_white.miu2.numpy(),
                                  np.asarray(jr.state.svgf_white.miu2))
    tr.state, tr.frame_index = state, fi
    _key, us = _jax_uniforms(jr.key, tr.cfg)
    img_j, _ = jr.render()
    img_t, _ = tr.render(uniforms=us)
    p = _psnr(img_t.numpy(), np.asarray(img_j))
    assert p >= 35.0, f"PSNR {p:.2f} dB"
    # and the same frame from a fresh state is not what was compared
    fresh = Renderer(cornell_box_scene(), RenderConfig(width=n, height=n, precision="bf16"),
                     device="cpu")
    assert not torch.equal(fresh.render(uniforms=us)[0], img_t)


def test_checkpoint_generator_device_mismatch_raises(tmp_path):
    """A generator's state resumes only on its device type (a CUDA
    generator's state is its seed and offset, a CPU one's the whole
    Mersenne twister)."""
    r = Renderer(cornell_box_scene(), RenderConfig(width=8, height=8), device="cpu")
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, r.state, r.generator, 0)
    z = dict(np.load(path))
    z["__generator_device__"] = np.asarray("cuda")
    np.savez(path, **z)
    with pytest.raises(ValueError, match="generator"):
        load_checkpoint(path, device="cpu")


# ---- pixel picker, stage names, sync, generator --------------------------


def test_pick_pixel_skips_non_pixel_arrays(capsys):
    from low_precision_raytracer_tpu_torch.utils.debug import debug_pixel, pick_pixel

    H, W = 6, 8
    aux = {
        "albedo": torch.arange(H * W * 3, dtype=torch.float32).reshape(H, W, 3),
        "depth": torch.arange(H * W, dtype=torch.float32).reshape(H, W),
        "w2c": torch.eye(4),
        "n_rays": torch.tensor(7),
    }
    rec = pick_pixel(aux, x=2, y=1, height=H, width=W)
    assert set(rec) == {"albedo", "depth"}
    ref = jax_pick_pixel({k: jnp.asarray(v.numpy()) for k, v in aux.items()}, 2, 1, H, W)
    for k in rec:
        np.testing.assert_array_equal(rec[k], np.asarray(ref[k]))
    debug_pixel("depth", aux["depth"], x=2, y=1)
    assert capsys.readouterr().out.strip() == "depth @(2,1) = 10.0"


def test_stage_names_sync_and_generator():
    from low_precision_raytracer_tpu.render.profile import _TIMED_ITERS as jax_iters
    from low_precision_raytracer_tpu_torch.render.profile import _TIMED_ITERS
    from low_precision_raytracer_tpu_torch.utils.rng import render_generator
    from low_precision_raytracer_tpu_torch.utils.timing import STAGE_NAMES, sync

    import low_precision_raytracer_tpu.utils.timing as jtiming

    assert STAGE_NAMES == jtiming.STAGE_NAMES and _TIMED_ITERS == jax_iters
    assert sync("cpu") is None
    a = torch.rand(5, generator=render_generator(3, "cpu"))
    b = torch.rand(5, generator=render_generator(3, "cpu"))
    assert torch.equal(a, b)
    r = Renderer(cornell_box_scene(), RenderConfig(width=8, height=8), device="cpu", seed=3)
    assert torch.equal(r.generator.get_state(), render_generator(3, "cpu").get_state())


# ---- image IO ------------------------------------------------------------


def test_save_png_roundtrip(tmp_path):
    """save_png writes an upright 8-bit RGB PNG of to_uint8(img): decoded
    by the port's decoder and by PIL, equal to the JAX package's file."""
    from PIL import Image

    rng = np.random.default_rng(4)
    img = rng.random((13, 21, 3), dtype=np.float32) * 1.2 - 0.1
    img[2, 3] = np.nan
    u8 = timage.to_uint8(torch.from_numpy(img))
    fin = np.isfinite(img).all(-1)
    np.testing.assert_array_equal(u8[fin], jimage.to_uint8(img)[fin])
    assert (u8[~fin] == 0).all()
    p = tmp_path / "port.png"
    timage.save_png(str(p), torch.from_numpy(img))
    rgba = decode_png(p.read_bytes())
    np.testing.assert_array_equal(rgba[..., :3], u8[::-1])
    assert (rgba[..., 3] == 255).all()
    np.testing.assert_array_equal(np.asarray(Image.open(p).convert("RGB")), u8[::-1])
    img[2, 3] = 0.0
    q = tmp_path / "jax.png"
    jimage.save_png(str(q), img)
    timage.save_png(str(p), img)
    np.testing.assert_array_equal(np.asarray(Image.open(p)), np.asarray(Image.open(q)))


def test_load_image_rgba_u8_matches():
    from pathlib import Path

    path = str(Path(__file__).resolve().parent / "assets" / "BoxTexturedCheck.png")
    for flip in (False, True):
        np.testing.assert_array_equal(timage.load_image_rgba_u8(path, flip=flip),
                                      jimage.load_image_rgba_u8(path, flip=flip))


def _hdr_both(path):
    port = timage.load_radiance_hdr(str(path))
    np.testing.assert_array_equal(port, jimage.load_radiance_hdr(str(path)))
    assert port.dtype == np.float32
    return port


def test_radiance_hdr_flat_and_rle(tmp_path):
    rng = np.random.default_rng(11)
    rgb = (rng.random((4, 9, 3)) * 100.0).astype(np.float32)
    rgb[0, 0] = [0.0, 0.0, 0.0]
    rgb[1, 2] = [1000.0, 0.25, 2.0]  # the HDR range survives
    p = tmp_path / "flat.hdr"
    _write_hdr_flat(p, rgb)
    dec = _hdr_both(p)
    lsb = rgb.max(axis=-1, keepdims=True) / 128.0
    assert np.all(np.abs(dec - rgb) <= lsb * 1.01 + 1e-6) and dec[1, 2, 0] > 255.0
    rgb = (rng.random((3, 33, 3)) * 4.0).astype(np.float32)
    rgb[1, 5:20] = [2.0, 1.0, 0.5]  # a constant stretch: run packets
    p = tmp_path / "rle.hdr"
    _write_hdr_rle(p, rgb)
    dec = _hdr_both(p)
    lsb = rgb.max(axis=-1, keepdims=True) / 128.0
    assert np.all(np.abs(dec - rgb) <= lsb * 1.01 + 1e-6)


def test_radiance_hdr_old_rle(tmp_path):
    """Old-style runs: [1,1,1,n] repeats the previous pixel; at x == 0 the
    previous row's last; a run before any pixel, or past the row, raises."""
    w = 6
    hdr = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
    p = tmp_path / "old.hdr"
    p.write_bytes(hdr + f"-Y 1 +X {w}\n".encode() + _rgbe_encode([3.0, 2.0, 1.0])
                  + bytes([1, 1, 1, w - 1]))
    np.testing.assert_allclose(_hdr_both(p), np.tile([[3.0, 2.0, 1.0]], (1, w, 1)), rtol=0.01)
    w = 5
    row0 = b"".join(_rgbe_encode([float(i + 1), 0.5, 0.25]) for i in range(w))
    row1 = bytes([1, 1, 1, 3]) + _rgbe_encode([9.0, 1.0, 1.0]) * 2
    p = tmp_path / "rowrun.hdr"
    p.write_bytes(hdr + f"-Y 2 +X {w}\n".encode() + row0 + row1)
    dec = _hdr_both(p)
    np.testing.assert_allclose(dec[1, :3], np.tile([[5.0, 0.5, 0.25]], (3, 1)), rtol=0.02)
    for name, body in (("lead", bytes([1, 1, 1, 2]) + row0[4:]),
                       ("over", row0[:4] + bytes([1, 1, 1, 200]))):
        p = tmp_path / f"{name}.hdr"
        p.write_bytes(hdr + f"-Y 1 +X {w}\n".encode() + body)
        with pytest.raises(ValueError):
            timage.load_radiance_hdr(str(p))


def test_load_hdr_equirect_dispatch(tmp_path):
    rgb = np.full((2, 8, 3), 2.5, np.float32)
    p = tmp_path / "sky.hdr"
    _write_hdr_flat(p, rgb)
    np.testing.assert_array_equal(timage.load_hdr_equirect(str(p)),
                                  jimage.load_hdr_equirect(str(p)))
    q = tmp_path / "sky.png"
    timage.save_png(str(q), np.random.default_rng(2).random((4, 8, 3), dtype=np.float32))
    np.testing.assert_allclose(timage.load_hdr_equirect(str(q)),
                               jimage.load_hdr_equirect(str(q)), rtol=1e-6)


def test_radiance_hdr_corrupt_files_raise_valueerror(tmp_path):
    """Corrupt or truncated files raise ValueError naming the file."""
    hdr = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
    cases = [
        b"",
        hdr,  # no resolution line
        hdr + b"-Y 4 +X 4\n" + b"\x01\x02",  # truncated pixel data
        hdr + b"-Y 99999 +X 99999\n" + b"\x00" * 64,  # implausible dims
        hdr + b"-Y 2 +X 8\n" + b"\x02\x02\x00\x08" + b"\xff\x09" * 2,  # bad run
        b"#?RADIANCE\nFORMAT=32-bit_rle_xyze\n\n-Y 1 +X 1\n\x00\x00\x00\x00",
    ]
    for i, data in enumerate(cases):
        p = tmp_path / f"bad{i}.hdr"
        p.write_bytes(data)
        with pytest.raises(ValueError) as ei:
            timage.load_radiance_hdr(str(p))
        assert str(p) in str(ei.value)

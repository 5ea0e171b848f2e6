"""PyTorch port, the command line (`cli.py`) on the CPU (`--device cpu`):
`render` at 32 x 32 writes the PNG of the Renderer's last frame as uint8
(and `--profile` prints the 12 stage lines); `info` prints the JAX
package's JSON on a builtin scene and on tests/assets glTF files (one
with no camera, rigged by `_build_scene`); `parity` prints its JSON keys;
`bench` raises naming ROADMAP queue 1 item 13; the module runs as
`python -m low_precision_raytracer_tpu_torch.cli` with no JAX import; a
render asked of a missing card raises."""

import torch_threads  # noqa: F401  (caps the CPU threads per test process)
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from low_precision_raytracer_tpu import cli as jax_cli
from low_precision_raytracer_tpu_torch import cli
from low_precision_raytracer_tpu_torch.config import RenderConfig
from low_precision_raytracer_tpu_torch.models.procedural import cornell_box_scene
from low_precision_raytracer_tpu_torch.render.renderer import Renderer
from low_precision_raytracer_tpu_torch.utils.image import to_uint8
from low_precision_raytracer_tpu_torch.utils.png import decode_png
from low_precision_raytracer_tpu_torch.utils.timing import STAGE_NAMES

ROOT = Path(__file__).resolve().parent.parent
ASSETS = ROOT / "tests" / "assets"


def test_render_png_equals_renderer_frame(tmp_path, capsys):
    out = tmp_path / "c.png"
    assert cli.main(["render", "cornell", "--width", "32", "--height", "32", "--precision",
                     "bf16", "--frames", "3", "--profile", "--device", "cpu",
                     "--out", str(out)]) == 0
    err = capsys.readouterr().err
    stages = [line.split(":")[0].strip() for line in err.splitlines() if line.endswith(" ms")]
    assert stages == [s for s in STAGE_NAMES if s != "TAA"] + ["TOTAL (staged)"]
    r = Renderer(cornell_box_scene(), RenderConfig(width=32, height=32, precision="bf16"),
                 device="cpu")
    for f in range(3):
        img, _aux = r.render(time=f / 30)
    rgba = decode_png(out.read_bytes())
    np.testing.assert_array_equal(rgba[..., :3], to_uint8(img)[::-1])


def _info(mod, scene, capsys):
    assert mod.main(["info", scene]) == 0
    return json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("scene", ["cornell", "sponza", "BoxTextured.gltf", "Box.gltf"])
def test_info_matches_jax(scene, capsys):
    if scene.endswith(".gltf"):
        scene = str(ASSETS / scene)
    assert _info(cli, scene, capsys) == _info(jax_cli, scene, capsys)


def test_build_scene_rigs_like_jax():
    """A glTF file without camera or light gets the JAX CLI's default
    camera and headlight."""
    path = str(ASSETS / "Box.gltf")
    a, b = cli._build_scene(path), jax_cli._build_scene(path)
    np.testing.assert_array_equal(a.active_camera.translation, b.active_camera.translation)
    la = [n for n in a.root.walk() if n.name == "default-headlight"]
    lb = [n for n in b.root.walk() if n.name == "default-headlight"]
    assert len(la) == len(lb) == 1
    np.testing.assert_array_equal(la[0].translation, lb[0].translation)
    np.testing.assert_array_equal(la[0].intensity, lb[0].intensity)


def test_parity_prints_json(capsys):
    assert cli.main(["parity", "cornell", "--width", "16", "--height", "16", "--frames", "1",
                     "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert set(out) == {"precision", "psnr_db", "ssim", "fp32_fallback_rate", "frames"}
    assert out["precision"] == "bf16" and out["psnr_db"] > 20
    assert 0 < out["fp32_fallback_rate"] < 1


def test_bench_raises_naming_item_13():
    with pytest.raises(NotImplementedError, match=r"ROADMAP queue 1 item 13\)"):
        cli.main(["bench"])


def test_render_without_cuda_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["render", "cornell", "--width", "8", "--height", "8",
                  "--out", str(tmp_path / "x.png")])


def test_module_entry_point_imports_no_jax():
    code = ("import sys, runpy\n"
            "sys.argv = ['lprt-torch', 'info', 'triangle']\n"
            "try:\n"
            "    runpy.run_module('low_precision_raytracer_tpu_torch.cli', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "       or m.startswith('low_precision_raytracer_tpu.')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout)["triangles"] == 1

"""PyTorch port, the interactive explorer (`gui/viewer.py`): the seven
cases of tests/test_viewer.py on device="cpu" (event handling, the camera
rig, the one-frame pipeline, the settings panel, runtime open and the
message console, the HTTP frame loop), and the rows it serves equal to the
port's `Renderer` frame packed to uint8 on the same draws."""

import torch_threads  # noqa: F401  (caps the CPU threads per test process)
import json
import threading
import urllib.request

import numpy as np

from low_precision_raytracer_tpu_torch.config import DemoSettings, RenderConfig
from low_precision_raytracer_tpu_torch.gui.viewer import SceneExplorer, serve
from low_precision_raytracer_tpu_torch.models.procedural import cornell_box_scene


def _small_cfg():
    return RenderConfig(width=32, height=32, precision="fp32", gi_on=False,
                        taa_on=False, demo=DemoSettings(svgf=False))


def test_explorer_camera_motion():
    ex = SceneExplorer(cornell_box_scene(), _small_cfg(), device="cpu")
    pos0 = ex.rig.translation.copy()
    img0 = ex.render_frame()
    assert img0.shape == (32, 32, 3) and img0.dtype == np.uint8
    # the first call returns its own frame: the Renderer's, packed
    from low_precision_raytracer_tpu_torch.render.renderer import Renderer

    ref, _aux = Renderer(cornell_box_scene(), _small_cfg(), device="cpu").render()
    np.testing.assert_array_equal(img0, SceneExplorer._to_u8(ref).numpy())
    # hold W for a second of frames: rig moves forward (-z of yaw frame)
    for _ in range(10):
        ex.handle_events(0.1, {"w"})
    assert ex.rig.translation[2] < pos0[2]
    # right-drag look: camera rotation changes
    rot0 = ex.camera.rotation.copy()
    ex.handle_events(0.016, set(), mouse=(10, 10), right_down=True)
    ex.handle_events(0.016, set(), mouse=(60, 30), right_down=True)
    assert not np.allclose(ex.camera.rotation, rot0)
    # wheel changes FOV
    fov0 = ex.camera.fov_y
    ex.handle_events(0.016, set(), wheel=3.0)
    assert ex.camera.fov_y != fov0
    ex.render_frame()  # pipelined: this call returns frame N-1's bytes
    img1 = ex.render_frame()
    assert not np.array_equal(img0, img1)  # the view actually changed


def test_explorer_w_tracks_view_at_any_yaw():
    """W must move the rig along the CAMERA's view direction, not its
    mirror: world step = R_y(-yaw) @ step, the same rotation the camera
    node carries (regression: the R_y(+yaw) form moved backward at
    yaw = 90 deg)."""
    from low_precision_raytracer_tpu_torch.math.hostmath import quaternion_to_matrix

    ex = SceneExplorer(cornell_box_scene(), _small_cfg(), device="cpu")
    # drag right 900 px (x_sensitivity 0.001/px -> yaw ~ 0.9 rad)
    ex.handle_events(0.016, set(), mouse=(0, 0), right_down=True)
    ex.handle_events(0.016, set(), mouse=(900, 0), right_down=True)
    rot = np.asarray(quaternion_to_matrix(ex.camera.rotation))[:3, :3]
    view = rot @ np.array([0.0, 0.0, -1.0])  # -z-forward camera
    assert abs(view[0]) > 0.3, "yaw did not accumulate; test setup broken"
    pos0 = ex.rig.translation.copy()
    for _ in range(10):
        ex.handle_events(0.1, {"w"})
    move = ex.rig.translation - pos0
    cos = float(move @ view) / (np.linalg.norm(move) * np.linalg.norm(view))
    assert cos > 0.99, f"W moved {move} but the view direction is {view}"


def test_explorer_http_loop():
    ex = SceneExplorer(cornell_box_scene(), _small_cfg(), device="cpu")
    srv = serve(ex, port=0)  # ephemeral port
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        page = urllib.request.urlopen(base + "/", timeout=30).read()
        assert b"lprt explorer" in page
        body = json.dumps({"keys": ["w"], "mouse": [5, 5], "right": False,
                           "wheel": 0}).encode()
        req = urllib.request.Request(base + "/frame", data=body, method="POST")
        resp = urllib.request.urlopen(req, timeout=120)
        data = resp.read()
        # raw RGB rows (H * W * 3 uint8) — the canvas-blit frame transport
        cfg = ex.cfg
        assert len(data) == cfg.height * cfg.width * 3
        stats = json.loads(resp.headers["x-stats"])
        assert stats["frame"] == 1 and stats["ms"] > 0
    finally:
        srv.shutdown()


def test_explorer_inspect_panel():
    """apply_settings flips pipeline toggles / weights like the reference's
    Inspect panel (`rt/gui/imgui_window.cu:502-590`); settings() reflects
    them and the frame actually changes."""
    ex = SceneExplorer(cornell_box_scene(), _small_cfg(), device="cpu")
    s0 = ex.settings()
    assert s0["gi_on"] is False and s0["svgf"] is False
    img0 = ex.render_frame()
    ex.apply_settings({"add_direct_out": False, "taa_w": 0.5})
    s1 = ex.settings()
    assert s1["add_direct_out"] is False and s1["taa_w"] == 0.5
    ex.render_frame()  # pipelined: flush the pre-toggle in-flight frame
    img1 = ex.render_frame()
    assert not np.array_equal(img0, img1)  # direct term removed
    # unknown keys are ignored, partial updates keep the rest
    ex.apply_settings({"nonsense": 1})
    assert ex.settings()["add_direct_out"] is False


def test_explorer_runtime_open_and_console():
    """Runtime model/skybox open + the capped message console (reference
    `rt/gui/imgui_window.cu:741-770`): a bad path lands in the console
    instead of crashing; a good builtin name re-rigs the scene live."""
    ex = SceneExplorer(cornell_box_scene(), _small_cfg(), device="cpu")
    ex.render_frame()
    # bad model path -> console message, explorer still renders
    ex.apply_settings({"open_model": "/no/such/file.glb"})
    assert any("failed" in m for m in ex.messages)
    img = ex.render_frame()
    assert img.shape == (32, 32, 3)
    # good builtin name -> scene swapped, camera re-rigged
    n0 = len(ex.messages)
    ex.apply_settings({"open_model": "triangle"})
    assert len(ex.messages) == n0 + 1 and "loaded model" in ex.messages[-1]
    assert ex.rig.name == "free-cam-rig"
    img2 = ex.render_frame()
    img2 = ex.render_frame()  # flush the pipeline
    assert img2.shape == (32, 32, 3)
    # bad skybox path -> console, not crash
    ex.apply_settings({"open_skybox": "/no/such/sky.hdr"})
    assert "skybox" in ex.messages[-1] and "failed" in ex.messages[-1]
    # console is capped at 100 like the reference (`:766`)
    for i in range(150):
        ex.log(f"m{i}")
    assert len(ex.messages) == 100


def test_explorer_render_exception_goes_to_console():
    """A per-frame exception must surface in the in-app console (black
    frame returned), not escape to the terminal."""
    ex = SceneExplorer(cornell_box_scene(), _small_cfg(), device="cpu")
    srv = serve(ex, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"

        def boom(*a, **k):
            raise RuntimeError("injected failure")

        ex.render_frame = boom
        body = json.dumps({"keys": []}).encode()
        req = urllib.request.Request(base + "/frame", data=body, method="POST")
        resp = urllib.request.urlopen(req, timeout=120)
        data = resp.read()
        assert len(data) == 32 * 32 * 3  # black fallback frame
        stats = json.loads(resp.headers["x-stats"])
        assert any("render failed" in m for m in stats["messages"])
    finally:
        srv.shutdown()


def test_explorer_http_settings_roundtrip():
    ex = SceneExplorer(cornell_box_scene(), _small_cfg(), device="cpu")
    srv = serve(ex, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        body = json.dumps({"keys": [], "settings": {"add_gi_white": False}}).encode()
        req = urllib.request.Request(base + "/frame", data=body, method="POST")
        resp = urllib.request.urlopen(req, timeout=120)
        stats = json.loads(resp.headers["x-stats"])
        assert stats["settings"]["add_gi_white"] is False
    finally:
        srv.shutdown()

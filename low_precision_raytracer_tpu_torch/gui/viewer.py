"""Interactive scene explorer (port of `low_precision_raytracer_tpu/gui/viewer.py`):
a stdlib HTTP server streams rendered frames to a browser canvas and feeds
key and mouse events back into the controllers (`gui/controller.py`).

Per frame: handle_events -> the Renderer (flatten at the animation time,
render) -> a uint8 pack on the device.  The free camera is rigged as in
the JAX package: an inserted parent carries the explorer's translation,
the camera node the look rotation.  The JAX package pipelines frames by
async dispatch; here frame N's uint8 rows are copied into pinned host
memory with a `non_blocking` copy behind a CUDA event, and the call
returns frame N-1's rows, whose copy finished while frame N rendered.

Usage: `python -m low_precision_raytracer_tpu_torch.cli view cornell
--width 512 --height 512`, then open the printed URL.  WASD + E/C move,
hold the right mouse button to look, the wheel zooms the field of view.
"""

from __future__ import annotations

import dataclasses
import json
import math
import threading
import time

import numpy as np
import torch

from low_precision_raytracer_tpu_torch.gui.controller import (
    HoldRotateController,
    MoveController,
)


class SceneExplorer:
    """Headless per-frame explorer loop; the web layer only delivers
    events and displays the returned frames.  Runs on CUDA unless `device`
    says otherwise (`config.resolve_device`)."""

    def __init__(self, host_scene, cfg, device=None):
        from low_precision_raytracer_tpu_torch.config import resolve_device

        self.cfg = cfg
        self.device = resolve_device(device)
        # message console: exceptions land in a capped list (100) instead
        # of ending the session
        self.messages: list[str] = []
        self.frame_count = 0
        self.last_frame_ms = 0.0
        self._setup(host_scene)

    def _setup(self, host_scene) -> None:
        """(Re-)rig a scene: free camera + controllers + renderer; at
        construction and on a runtime model open."""
        from low_precision_raytracer_tpu_torch.models.hierarchy import CameraObject
        from low_precision_raytracer_tpu_torch.render.renderer import Renderer

        self.host = host_scene
        if host_scene.active_camera is None:
            cam = CameraObject(name="free-cam", fov_y=np.pi / 3)
            host_scene.root.add(cam)
            host_scene.active_camera = cam
        self.camera = host_scene.active_camera
        # free camera: the inserted parent holds the translation, the
        # camera the look
        self.rig = self.camera.insert_parent()
        self.rig.name = "free-cam-rig"

        self.move_x = MoveController(max_speed=6.0)
        self.move_y = MoveController(max_speed=6.0)
        self.move_z = MoveController(max_speed=6.0)
        self.look = HoldRotateController()
        # seed the field-of-view controller from the scene camera
        self.look.acc_z = float(self.camera.fov_y)

        self.renderer = Renderer(host_scene, self.cfg, device=self.device)
        self.play_animation = host_scene.animated
        self._t0 = time.monotonic()
        self._pending = None  # (host rows, copy event) of the last frame
        self._pinned = []  # two pinned host buffers, alternating

    # ---- message console -------------------------------------------------
    def log(self, msg: str) -> None:
        self.messages.append(str(msg))
        del self.messages[:-100]

    # ---- runtime open ------------------------------------------------------
    def open_model(self, path: str) -> None:
        """Load a glTF/GLB (or builtin scene name) in the live session and
        re-rig the cameras; errors go to the console, not the terminal."""
        from low_precision_raytracer_tpu_torch.cli import _build_scene

        try:
            host = _build_scene(path)
        except SystemExit as e:  # _build_scene raises SystemExit on bad scenes
            self.log(f"open '{path}' failed: {e}")
            return
        except Exception as e:  # noqa: BLE001
            self.log(f"open '{path}' failed: {e!r}")
            return
        self._setup(host)
        self.log(f"loaded model: {path}")

    def open_skybox(self, path: str, exposure: float = 1.0) -> None:
        """Load an equirectangular .hdr as the scene's skybox in the live
        session."""
        from low_precision_raytracer_tpu_torch.models.scene import Skybox
        from low_precision_raytracer_tpu_torch.render.renderer import Renderer
        from low_precision_raytracer_tpu_torch.utils.image import load_hdr_equirect

        try:
            data = load_hdr_equirect(path)
        except Exception as e:  # noqa: BLE001
            self.log(f"skybox '{path}' failed: {e!r}")
            return
        self.host.skybox = Skybox(data=data, exposure=float(exposure))
        # the scene arrays change shape: a new renderer (the state resets)
        self.renderer = Renderer(self.host, self.cfg, device=self.device)
        self._pending = None
        self.log(f"loaded skybox: {path}")

    def handle_events(self, dt: float, keys: set[str], mouse=(0.0, 0.0),
                      right_down: bool = False, wheel: float = 0.0) -> None:
        """Integrate one frame of input."""
        self.move_x.receive_event(dt, "d" in keys, "a" in keys)
        self.move_y.receive_event(dt, "e" in keys, "c" in keys)
        self.move_z.receive_event(dt, "s" in keys, "w" in keys)
        self.look.receive_event(mouse, right_down, wheel)

        yaw, pitch, fov = self.look.get_xyz()
        # look rotation on the camera node: yaw about +y then pitch about +x
        # (quaternions xyzw, the hierarchy's convention)
        cy, sy = math.cos(-yaw / 2), math.sin(-yaw / 2)
        cp, sp = math.cos(-pitch / 2), math.sin(-pitch / 2)
        q_yaw = np.array([0, sy, 0, cy], np.float32)
        q_pitch = np.array([sp, 0, 0, cp], np.float32)
        self.camera.rotation = _quat_mul(q_yaw, q_pitch)
        self.camera.fov_y = float(fov)

        # translate the rig along the camera's yaw frame: world step =
        # R_y(-yaw) @ step, the rotation the camera node carries, so W
        # follows the view direction at every yaw
        step = np.array(
            [self.move_x.pop_value(), self.move_y.pop_value(), self.move_z.pop_value()],
            np.float32,
        )
        cos_y, sin_y = math.cos(yaw), math.sin(yaw)
        world = np.array(
            [
                cos_y * step[0] - sin_y * step[2],
                step[1],
                sin_y * step[0] + cos_y * step[2],
            ],
            np.float32,
        )
        self.rig.translation = self.rig.translation + world

    @staticmethod
    def _to_u8(img):
        """uint8 pack on the device (3 bytes a pixel to copy instead of
        12): NaN -> 0 first, then clip and scale (truncating)."""
        c = torch.nan_to_num(img.float())
        return (torch.clamp(c, 0.0, 1.0) * 255.0).to(torch.uint8)

    def _host_buffer(self, shape):
        """The pinned buffer for this frame's copy (two alternate, so the
        one the previous frame's copy fills is never reused under it)."""
        if not self._pinned or tuple(self._pinned[0].shape) != tuple(shape):
            self._pinned = [torch.empty(shape, dtype=torch.uint8, pin_memory=True)
                            for _ in range(2)]
        self._pinned.reverse()
        return self._pinned[0]

    def render_frame(self) -> np.ndarray:
        """-> (H, W, 3) uint8 rows of the previous frame (of this one on the
        first call and after a renderer change).

        One-frame pipeline: frame N renders and packs on the device, and
        its rows start copying into pinned host memory (non_blocking,
        behind a CUDA event); the call then waits only for frame N-1's
        copy, which ran while frame N was queued.  On the CPU every step
        finishes in order and the rows are frame N-1's all the same."""
        t = time.monotonic() - self._t0 if self.play_animation else 0.0
        t0 = time.perf_counter()
        img, _aux = self.renderer.render(time=t)
        u8 = self._to_u8(img)
        if u8.is_cuda:
            host = self._host_buffer(u8.shape)
            host.copy_(u8, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host, event = u8, None
        prev, self._pending = self._pending, (host, event)
        rows, ready = prev if prev is not None else self._pending
        if ready is not None:
            ready.synchronize()
        arr = rows.numpy().copy()  # the pinned buffer is reused two frames on
        self.last_frame_ms = (time.perf_counter() - t0) * 1e3
        self.frame_count += 1
        return arr

    def stats(self) -> dict:
        return {
            "frame": self.frame_count,
            "ms": round(self.last_frame_ms, 1),
            "fps": round(1000.0 / self.last_frame_ms, 2) if self.last_frame_ms else 0.0,
            "impl": self.renderer.cfg.traversal_impl,
            "precision": self.cfg.precision,
        }

    # inspect-panel toggles of pipeline stages / displayed terms (the SVGF
    # and TAA mix weights are read by name in apply_settings)
    _BOOL_KEYS = (
        "gi_on", "taa_on", "svgf", "add_direct_out", "add_gi_colored",
        "add_gi_white", "demodulate",
    )

    def settings(self) -> dict:
        cfg = self.renderer.cfg
        return {
            "gi_on": cfg.gi_on,
            "taa_on": cfg.taa_on,
            "svgf": cfg.demo.svgf,
            "add_direct_out": cfg.demo.add_direct_out,
            "add_gi_colored": cfg.demo.add_gi_colored,
            "add_gi_white": cfg.demo.add_gi_white,
            "demodulate": cfg.demo.demodulate,
            "svgf_color_w": cfg.svgf.color_mix_weight,
            "svgf_moments_w": cfg.svgf.moments_mix_weight,
            "taa_w": cfg.taa_mix_weight,
            "play_animation": self.play_animation,
        }

    def apply_settings(self, upd: dict) -> None:
        """Apply a (partial) settings dict from the page."""
        if upd.get("open_model"):
            self.open_model(str(upd["open_model"]).strip())
        if upd.get("open_skybox"):
            self.open_skybox(str(upd["open_skybox"]).strip())
        cfg = self.renderer.cfg
        demo_kw, cfg_kw, svgf_kw = {}, {}, {}
        for k in self._BOOL_KEYS:
            if k not in upd:
                continue
            v = bool(upd[k])
            if k in ("gi_on", "taa_on"):
                cfg_kw[k] = v
            else:
                demo_kw[k] = v
        if "svgf_color_w" in upd:
            svgf_kw["color_mix_weight"] = float(upd["svgf_color_w"])
        if "svgf_moments_w" in upd:
            svgf_kw["moments_mix_weight"] = float(upd["svgf_moments_w"])
        if "taa_w" in upd:
            cfg_kw["taa_mix_weight"] = float(upd["taa_w"])
        if "play_animation" in upd:
            self.play_animation = bool(upd["play_animation"])
        if demo_kw:
            cfg_kw["demo"] = dataclasses.replace(cfg.demo, **demo_kw)
        if svgf_kw:
            cfg_kw["svgf"] = dataclasses.replace(cfg.svgf, **svgf_kw)
        if cfg_kw:
            new = dataclasses.replace(cfg, **cfg_kw)
            self.renderer.cfg = new
            self.cfg = new


def _quat_mul(a, b):
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        np.float32,
    )


_PAGE = """<!doctype html>
<html><head><title>lprt explorer</title><style>
body { background:#111; color:#ccc; font-family:monospace; margin:12px }
canvas { image-rendering:pixelated; border:1px solid #333; outline:none }
#panel { margin-top:8px } #panel label { margin-right:12px; user-select:none }
#panel input[type=range] { vertical-align:middle; width:90px }
.note { color:#777; font-size:11px }
</style></head><body>
<div>lprt explorer — WASD+E/C move, hold RIGHT mouse to look, wheel = FOV</div>
<canvas id=v width=%W% height=%H% tabindex=0></canvas>
<div id=s></div>
<div id=panel>
<label><input type=checkbox data-k=gi_on> GI</label>
<label><input type=checkbox data-k=svgf> SVGF</label>
<label><input type=checkbox data-k=taa_on> TAA</label>
<label><input type=checkbox data-k=add_direct_out> direct</label>
<label><input type=checkbox data-k=add_gi_colored> GI-colored</label>
<label><input type=checkbox data-k=add_gi_white> GI-white</label>
<label><input type=checkbox data-k=demodulate> demodulate</label>
<label><input type=checkbox data-k=play_animation> animate</label>
<br>
<label>svgf color w <input type=range data-k=svgf_color_w min=0 max=1 step=0.05></label>
<label>moments w <input type=range data-k=svgf_moments_w min=0 max=1 step=0.05></label>
<label>taa w <input type=range data-k=taa_w min=0 max=1 step=0.05></label>
<br>
<label>model <input type=text id=mpath size=36
  placeholder=".glb/.gltf path or cornell|sponza|..."></label>
<button id=mopen>Open model</button>
<label>skybox <input type=text id=spath size=28 placeholder=".hdr path"></label>
<button id=sopen>Open skybox</button>
</div>
<div id=msgs style="margin-top:6px;color:#da8;max-height:120px;overflow-y:auto"></div>
<script>
const keys = new Set(); let right=false, wheel=0, mx=0, my=0, upd=null;
const img = document.getElementById('v');
img.oncontextmenu = e => e.preventDefault();
addEventListener('keydown', e => keys.add(e.key.toLowerCase()));
addEventListener('keyup',   e => keys.delete(e.key.toLowerCase()));
// a key released while the tab is unfocused never sends keyup here —
// drop all held keys on blur so the camera can't drift forever
addEventListener('blur', () => { keys.clear(); right = false; });
img.onmousedown = e => { if (e.button === 2) right = true; };
addEventListener('mouseup', e => { if (e.button === 2) right = false; });
img.onmousemove = e => { mx = e.offsetX; my = e.offsetY; };
img.onwheel = e => { wheel += Math.sign(e.deltaY); e.preventDefault(); };
let synced = false;
for (const el of document.querySelectorAll('#panel input[data-k]')) {
  el.onchange = () => {
    upd = upd || {};
    upd[el.dataset.k] = el.type === 'checkbox' ? el.checked : parseFloat(el.value);
  };
}
document.getElementById('mopen').onclick = () => {
  upd = upd || {}; upd.open_model = document.getElementById('mpath').value;
};
document.getElementById('sopen').onclick = () => {
  upd = upd || {}; upd.open_skybox = document.getElementById('spath').value;
};
function syncPanel(settings) {
  if (synced) return; synced = true;
  for (const el of document.querySelectorAll('#panel input')) {
    const v = settings[el.dataset.k];
    if (v === undefined) continue;
    if (el.type === 'checkbox') el.checked = v; else el.value = v;
  }
}
// frames arrive as RAW RGB rows (PNG encode measured 26-40 ms/frame at
// 512x512 on the single host core — it dominated the loop; raw is ~free
// on localhost) and blit through one reused ImageData
const ctx = img.getContext('2d');
const idat = ctx.createImageData(%W%, %H%);
idat.data.fill(255);
async function loop() {
  const inp = {keys: [...keys], mouse: [mx, my], right, wheel};
  if (upd) { inp.settings = upd; upd = null; }
  wheel = 0;
  const r = await fetch('/frame', {method:'POST', body: JSON.stringify(inp)});
  const stats = JSON.parse(r.headers.get('x-stats'));
  syncPanel(stats.settings || {});
  const {settings, messages, ...rest} = stats;
  document.getElementById('s').textContent = JSON.stringify(rest);
  if (messages && messages.length)
    document.getElementById('msgs').innerHTML =
      messages.map(m => '&gt; ' + m.replace(/</g, '&lt;')).join('<br>');
  const rgb = new Uint8Array(await r.arrayBuffer());
  const px = idat.data;
  for (let i = 0, j = 0; i < rgb.length; i += 3, j += 4) {
    px[j] = rgb[i]; px[j+1] = rgb[i+1]; px[j+2] = rgb[i+2];
  }
  ctx.putImageData(idat, 0, 0);
  requestAnimationFrame(loop);
}
loop();
</script></body></html>"""


def serve(explorer: SceneExplorer, host: str = "127.0.0.1", port: int = 8008):
    """The HTTP loop of one renderer: one frame per POST /frame, GET / the
    page.  Returns the server; the caller runs `serve_forever` (and
    `shutdown`).  Every frame runs on one persistent worker thread
    (ThreadingHTTPServer spawns a thread per request), so the renderer and
    its pipelined copies see one thread and one CUDA stream."""
    from concurrent.futures import ThreadPoolExecutor
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    lock = threading.Lock()
    worker = ThreadPoolExecutor(max_workers=1)
    last_t = [time.monotonic()]
    page = (
        _PAGE.replace("%W%", str(explorer.cfg.width))
        .replace("%H%", str(explorer.cfg.height))
        .encode()
    )

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            self.send_response(200)
            self.send_header("content-type", "text/html")
            self.end_headers()
            self.wfile.write(page)

        def do_POST(self):
            n = int(self.headers.get("content-length", 0))
            inp = json.loads(self.rfile.read(n) or b"{}")
            def step():
                now = time.monotonic()
                dt = min(now - last_t[0], 0.25)
                last_t[0] = now
                try:
                    if inp.get("settings"):
                        explorer.apply_settings(inp["settings"])
                    explorer.handle_events(
                        dt,
                        set(inp.get("keys", [])),
                        tuple(inp.get("mouse") or (0, 0)),
                        bool(inp.get("right", False)),
                        float(inp.get("wheel", 0.0)),
                    )
                    frame = explorer.render_frame()
                except Exception as e:  # noqa: BLE001 — console, not crash
                    explorer.log(f"render failed: {e!r}")
                    frame = np.zeros(
                        (explorer.cfg.height, explorer.cfg.width, 3), np.uint8
                    )
                stats = explorer.stats()
                stats["settings"] = explorer.settings()
                stats["messages"] = list(explorer.messages)
                return frame, stats

            with lock:  # one renderer, serialized
                frame, stats = worker.submit(step).result()
            # raw RGB rows, not PNG (an encode costs more than the frame);
            # the page blits them via canvas putImageData
            body = np.ascontiguousarray(frame).tobytes()
            self.send_response(200)
            self.send_header("content-type", "application/octet-stream")
            self.send_header("x-stats", json.dumps(stats))
            self.send_header("content-length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    srv = ThreadingHTTPServer((host, port), Handler)
    print(f"lprt explorer: http://{host}:{srv.server_address[1]}/  (ctrl-c to stop)")
    return srv

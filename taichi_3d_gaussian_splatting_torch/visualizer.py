"""Interactive scene viewer on the port: a self-contained web page (stdlib
http.server) whose frames are rendered by `rasterize(rgb_only=True)` on the
card and streamed as PNG.

- loads and merges several scene parquets, one `point_object_id` each;
- keys 0-9 select an object, ` selects the camera; with an object
  selected, the motion keys move that object (by moving its camera pose
  the opposite way: the rasterizer takes one pose per object);
- W/A/S/D/Q/E translate, the arrow keys (or I/J/K/L) and a mouse drag on
  the view rotate;
- H hides the selected object and P shows it again (through the invalid
  mask); [ and ] shrink and grow it (the rasterizer's per-object edit
  transform); R resets every pose.

    python -m taichi_3d_gaussian_splatting_torch.visualizer \\
        --parquet_path a.parquet b.parquet --port 8000 [--device cpu]

then open http://<host>:8000/.
"""

from __future__ import annotations

import argparse
import io
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from .camera import CameraInfo
from .ops import transforms as T
from .ops.rasterizer import RasterizerConfig, rasterize
from .render import merge_scenes

PAGE = """<!DOCTYPE html>
<html><head><title>3D Gaussian Splatting viewer</title>
<style>body{background:#111;color:#ccc;font-family:monospace;text-align:center}
img{image-rendering:pixelated;border:1px solid #444;margin-top:8px}</style>
</head><body>
<div>W/A/S/D/Q/E move &middot; arrows/drag rotate &middot; 0-9 select object
 &middot; ` camera &middot; H hide &middot; P show &middot; [ ] scale
 &middot; R reset</div>
<div id="status"></div>
<img id="view" width="{W}" height="{H}"/>
<script>
let busy = false;
async function refresh() {
  if (busy) return; busy = true;
  const img = document.getElementById('view');
  img.src = '/frame.png?t=' + Date.now();
  await new Promise(r => { img.onload = r; img.onerror = r; });
  busy = false;
}
document.addEventListener('keydown', async (e) => {
  const resp = await fetch('/key?k=' + encodeURIComponent(e.key));
  document.getElementById('status').textContent = await resp.text();
  refresh();
});
const view = document.getElementById('view');
let dragging = false, lastX = 0, lastY = 0, pending = false;
view.addEventListener('mousedown', (e) => {
  dragging = true; lastX = e.clientX; lastY = e.clientY;
  e.preventDefault();
});
document.addEventListener('mouseup', () => { dragging = false; });
document.addEventListener('mousemove', async (e) => {
  if (!dragging || pending) return;
  const dx = e.clientX - lastX, dy = e.clientY - lastY;
  if (dx === 0 && dy === 0) return;
  lastX = e.clientX; lastY = e.clientY; pending = true;
  const resp = await fetch('/drag?dx=' + dx + '&dy=' + dy);
  document.getElementById('status').textContent = await resp.text();
  pending = false;
  refresh();
});
refresh();
</script></body></html>
"""

MOVE_STEP = 0.1
ROTATE_STEP = 0.05
DRAG_ANGLE = 0.005   # radians per pixel of mouse drag


class VisualizerState:
    """The merged scene, the per-object poses, scales and visibility, and
    the render of a frame."""

    def __init__(self, parquet_paths, width, height, focal, device="cuda"):
        self.device = torch.device(device)
        self.scene, self.num_objects = merge_scenes(parquet_paths,
                                                    self.device)
        self.hidden = [False] * self.num_objects
        w = width - width % 16
        h = height - height % 16
        intr = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]],
                        np.float32)
        self.cam = CameraInfo(camera_intrinsics=intr, camera_height=h,
                              camera_width=w)
        self.raster_cfg = RasterizerConfig(rgb_only=True)
        self.reset()
        self.selected = None  # None = the camera
        self.lock = threading.Lock()

    def reset(self):
        self.qs = np.tile(np.array([0.0, 0.0, 0.0, 1.0], np.float32),
                          (self.num_objects, 1))
        self.ts = np.zeros((self.num_objects, 3), np.float32)
        self.scales = np.ones((self.num_objects, 3), np.float32)

    def _targets(self):
        if self.selected is None:
            return list(range(self.num_objects)), 1.0
        # moving an object = moving its camera pose the opposite way
        return [self.selected], -1.0

    def handle_key(self, key: str) -> str:
        moves = {"w": (0, 0, MOVE_STEP), "s": (0, 0, -MOVE_STEP),
                 "a": (-MOVE_STEP, 0, 0), "d": (MOVE_STEP, 0, 0),
                 "q": (0, -MOVE_STEP, 0), "e": (0, MOVE_STEP, 0)}
        rots = {"ArrowLeft": (0, -ROTATE_STEP), "ArrowRight": (0, ROTATE_STEP),
                "ArrowUp": (-ROTATE_STEP, 0), "ArrowDown": (ROTATE_STEP, 0),
                "j": (0, -ROTATE_STEP), "l": (0, ROTATE_STEP),
                "i": (-ROTATE_STEP, 0), "k": (ROTATE_STEP, 0)}
        with self.lock:
            if key == "`":
                self.selected = None
                return "controlling camera"
            if key.isdigit():
                idx = int(key)
                if idx < self.num_objects:
                    self.selected = idx
                    return f"controlling object {idx}"
                return f"no object {idx}"
            if key == "r":
                self.reset()
                return "reset"
            if key in ("h", "p") and self.selected is not None:
                self.hidden[self.selected] = key == "h"
                return (("hidden" if key == "h" else "shown")
                        + f" object {self.selected}")
            if key in ("[", "]") and self.selected is not None:
                self.scales[self.selected] *= 1.1 if key == "]" else 1.0 / 1.1
                return (f"object {self.selected} scale "
                        f"{self.scales[self.selected][0]:.2f}")
            targets, sign = self._targets()
            if key in moves:
                delta = torch.tensor(moves[key], dtype=torch.float32) * sign
                for i in targets:
                    # translate in the current camera frame
                    self.ts[i] += T.quaternion_rotate(
                        torch.as_tensor(self.qs[i])[None],
                        delta[None])[0].numpy()
                return f"move {key}"
            if key in rots:
                self._apply_rotation(*rots[key], targets, sign)
                return f"rotate {key}"
        return f"ignored {key}"

    def _apply_rotation(self, rx: float, ry: float, targets, sign: float):
        """A small rotation (pitch rx, yaw ry) of each target's camera
        pose; the caller holds the lock."""
        half = np.array([rx / 2, ry / 2, 0.0])
        dq = np.array([half[0], half[1], 0.0,
                       np.sqrt(max(0.0, 1 - half @ half))], np.float32)
        if sign < 0:
            dq *= np.array([-1, -1, -1, 1], np.float32)
        for i in targets:
            q = T.quaternion_multiply(torch.as_tensor(self.qs[i])[None],
                                      torch.as_tensor(dq)[None])[0].numpy()
            self.qs[i] = q / np.linalg.norm(q)

    def handle_drag(self, dx: float, dy: float) -> str:
        """Mouse-drag rotation: dragging right yaws right and dragging down
        pitches down, as the arrow keys do."""
        rx = float(np.clip(dy * DRAG_ANGLE, -0.3, 0.3))
        ry = float(np.clip(dx * DRAG_ANGLE, -0.3, 0.3))
        with self.lock:
            targets, sign = self._targets()
            self._apply_rotation(rx, ry, targets, sign)
        who = ("camera" if self.selected is None
               else f"object {self.selected}")
        return f"drag rotate {who}"

    def frame(self) -> torch.Tensor:
        """The current view, clipped to [0, 1], (H, W, 3) on the device."""
        dev = self.device
        with self.lock:
            invalid = self.scene.point_invalid_mask.clone()
            for i, hidden in enumerate(self.hidden):
                if hidden:
                    invalid[self.scene.point_object_id == i] = 1
            qs = torch.as_tensor(self.qs, device=dev)
            ts = torch.as_tensor(self.ts, device=dev)
            scales = torch.as_tensor(self.scales, device=dev)
        identity_q = torch.tensor([[0.0, 0.0, 0.0, 1.0]],
                                  device=dev).expand(self.num_objects, 4)
        edit = (identity_q, scales,
                torch.zeros((self.num_objects, 3), device=dev))
        with torch.no_grad():
            result = rasterize(self.scene.point_cloud,
                               self.scene.point_cloud_features, invalid,
                               self.scene.point_object_id, qs, ts, self.cam,
                               self.raster_cfg, object_edit=edit)
        return torch.clamp(result.image, 0.0, 1.0)

    def frame_png(self) -> bytes:
        import PIL.Image
        img = self.frame().cpu().numpy()
        buf = io.BytesIO()
        PIL.Image.fromarray((img * 255).astype(np.uint8)).save(buf, "PNG")
        return buf.getvalue()


def make_handler(state: VisualizerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _send(self, body: bytes, content_type: str):
            self.send_response(200)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            query = parse_qs(url.query)
            if url.path == "/frame.png":
                self._send(state.frame_png(), "image/png")
            elif url.path == "/key":
                self._send(state.handle_key(query.get("k", [""])[0]).encode(),
                           "text/plain")
            elif url.path == "/drag":
                try:
                    dx = float(query.get("dx", ["0"])[0])
                    dy = float(query.get("dy", ["0"])[0])
                except ValueError:
                    dx = dy = 0.0
                self._send(state.handle_drag(dx, dy).encode(), "text/plain")
            else:
                self._send(PAGE.replace("{W}", str(state.cam.camera_width))
                           .replace("{H}", str(state.cam.camera_height))
                           .encode(), "text/html")

    return Handler


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--parquet_path", type=str, nargs="+", required=True)
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--width", type=int, default=976)
    parser.add_argument("--height", type=int, default=544)
    parser.add_argument("--focal", type=float, default=581.743)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    state = VisualizerState(args.parquet_path, args.width, args.height,
                            args.focal, args.device)
    server = ThreadingHTTPServer(("0.0.0.0", args.port), make_handler(state))
    print(f"viewer at http://0.0.0.0:{args.port}/", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()

"""Interactive live viewer over HTTP, the Pangolin window for headless rigs
(port of ``orbslam2_tpu.utils.http_viewer``).

ORB-SLAM2's Viewer/MapDrawer/FrameDrawer open an interactive Pangolin GL
window: rotate/zoom the map, follow the camera, see live point/keyframe
counts. A GPU server is headless, so this is a browser page: a stdlib HTTP
server runs on a daemon thread, snapshots the map and serves

  /            an HTML canvas page: pan (drag), zoom (wheel), follow-camera
               toggle, per-layer visibility, live status bar
  /state.json  the current map snapshot (points, keyframes, trajectory,
               tracking state), also a machine-readable monitoring endpoint

The port's map lives in host arrays (``map/state.py``; the device holds
only its keyframe mirror), so a snapshot is one host copy of the rows it
serves, taken without locks (drawer-copy semantics) and rebuilt at most
every ``interval`` seconds. No third-party dependency; the drawing is
client-side.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>orbslam2_tpu_torch live map</title>
<style>
 body { margin:0; background:#111; color:#ddd; font:13px monospace; }
 #bar { padding:6px 10px; background:#1b1b1b; display:flex; gap:16px;
        align-items:center; flex-wrap:wrap; }
 #bar label { user-select:none; cursor:pointer; }
 #status { color:#8c8; }
 canvas { display:block; }
</style></head><body>
<div id="bar">
 <b>orbslam2_tpu_torch</b>
 <span id="status">connecting…</span>
 <label><input type="checkbox" id="pts" checked> points</label>
 <label><input type="checkbox" id="kfs" checked> keyframes</label>
 <label><input type="checkbox" id="traj" checked> trajectory</label>
 <label><input type="checkbox" id="follow"> follow camera (f)</label>
 <span>drag = pan &nbsp; wheel = zoom &nbsp; r = reset</span>
</div>
<canvas id="c"></canvas>
<script>
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let st = null, scale = 60, cx = 0, cz = 0, drag = null;
function resize() { cv.width = innerWidth; cv.height = innerHeight - 40; }
addEventListener('resize', () => { resize(); draw(); }); resize();
function sx(x) { return cv.width/2 + (x - cx) * scale; }
function sz(z) { return cv.height/2 - (z - cz) * scale; }
function draw() {
  ctx.fillStyle = '#111'; ctx.fillRect(0, 0, cv.width, cv.height);
  if (!st) return;
  if (document.getElementById('follow').checked && st.camera) {
    cx = st.camera[0]; cz = st.camera[2];
  }
  if (document.getElementById('pts').checked && st.points) {
    ctx.fillStyle = '#888';
    for (const p of st.points) ctx.fillRect(sx(p[0]), sz(p[2]), 1.5, 1.5);
  }
  if (document.getElementById('traj').checked && st.trajectory &&
      st.trajectory.length > 1) {
    ctx.strokeStyle = '#4c4'; ctx.lineWidth = 1; ctx.beginPath();
    ctx.moveTo(sx(st.trajectory[0][0]), sz(st.trajectory[0][2]));
    for (const p of st.trajectory) ctx.lineTo(sx(p[0]), sz(p[2]));
    ctx.stroke();
  }
  if (document.getElementById('kfs').checked && st.keyframes) {
    ctx.fillStyle = '#48f';
    for (const k of st.keyframes) ctx.fillRect(sx(k[0])-2, sz(k[2])-2, 4, 4);
  }
  if (st.camera) {
    ctx.fillStyle = '#f44';
    ctx.beginPath();
    ctx.arc(sx(st.camera[0]), sz(st.camera[2]), 5, 0, 7); ctx.fill();
  }
}
cv.onmousedown = e => drag = [e.clientX, e.clientY];
addEventListener('mouseup', () => drag = null);
addEventListener('mousemove', e => {
  if (!drag) return;
  cx -= (e.clientX - drag[0]) / scale; cz += (e.clientY - drag[1]) / scale;
  drag = [e.clientX, e.clientY]; draw();
});
cv.onwheel = e => {
  e.preventDefault();
  scale *= e.deltaY < 0 ? 1.15 : 1/1.15; draw();
};
addEventListener('keydown', e => {
  if (e.key === 'f') { const f = document.getElementById('follow');
                       f.checked = !f.checked; draw(); }
  if (e.key === 'r') { scale = 60; cx = cz = 0; draw(); }
});
for (const id of ['pts','kfs','traj','follow'])
  document.getElementById(id).onchange = draw;
async function poll() {
  try {
    st = await (await fetch('state.json')).json();
    document.getElementById('status').textContent =
      `${st.tracking_state}  kf=${st.n_keyframes} mp=${st.n_map_points}` +
      `  frame=${st.n_frames}`;
    draw();
  } catch (err) {
    document.getElementById('status').textContent = 'disconnected';
  }
  setTimeout(poll, 500);
}
poll();
</script></body></html>
"""


def build_state(slam, max_points: int = 20000) -> dict:
    """Lock-free map snapshot as plain JSON-able python (drawer-copy
    semantics: reads may race a writer, single frames of staleness are
    fine for a viewer)."""
    m = slam.map
    state = {
        "tracking_state": str(getattr(slam, "tracking_state", "")).split(".")[-1],
        "n_keyframes": 0,
        "n_map_points": 0,
        "n_frames": len(getattr(slam.tracker, "trajectory", []) or []),
        "points": [],
        "keyframes": [],
        "trajectory": [],
        "camera": None,
        "ts": time.time(),
    }
    mps = m.valid_map_points()
    state["n_map_points"] = int(len(mps))
    if len(mps) > max_points:  # uniform stride keeps spatial coverage
        mps = mps[:: int(np.ceil(len(mps) / max_points))]
    if len(mps):
        state["points"] = np.round(m.mp_pos[mps], 3).tolist()
    kfs = m.valid_keyframes()
    state["n_keyframes"] = int(len(kfs))
    if len(kfs):
        state["keyframes"] = [
            np.round(m.keyframe_center(int(k)), 3).tolist() for k in kfs
        ]
    traj = getattr(slam.tracker, "trajectory", None)
    if traj:
        poses = traj
        if len(poses) > max_points:  # same stride bound as points
            stride = int(np.ceil(len(poses) / max_points))
            # always keep the latest pose so the camera marker is current
            poses = list(poses[::stride]) + [poses[-1]]
        Ts = np.stack([T for _, _, T in poses])  # (n,4,4) world->cam
        # camera center c = -R^T t (cheaper than inverting the 4x4)
        centers = -np.einsum("nij,ni->nj", Ts[:, :3, :3], Ts[:, :3, 3])
        state["trajectory"] = np.round(centers, 3).tolist()
        state["camera"] = state["trajectory"][-1]
    return state


class HttpViewer:
    """Serve the interactive map page from a daemon thread.

    `port=0` binds an ephemeral port (read `.port` after construction).
    State snapshots are rebuilt at most every `interval` seconds regardless
    of client count, bounding the cost on the SLAM threads.
    """

    def __init__(self, slam, port: int = 0, host: str = "127.0.0.1",
                 interval: float = 0.5):
        self.slam = slam
        self.interval = interval
        self._cache: tuple[float, bytes] = (0.0, b"{}")
        self._lock = threading.Lock()
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # keep the SLAM console clean
                pass

            def do_GET(self):
                path = self.path.split("?", 1)[0]  # tolerate cache-busting queries
                if path in ("/", "/index.html"):
                    body, ctype = _PAGE.encode(), "text/html; charset=utf-8"
                elif path == "/state.json":
                    body, ctype = viewer._state_bytes(), "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True, name="http-viewer"
        )
        self._thread.start()

    def _state_bytes(self) -> bytes:
        with self._lock:
            t, body = self._cache
            if time.time() - t < self.interval:
                return body
            try:
                body = json.dumps(build_state(self.slam)).encode()
            except Exception as e:  # map mid-mutation: serve the stale copy
                if t == 0.0:
                    body = json.dumps({"error": str(e)}).encode()
            self._cache = (time.time(), body)
            return body

    def stop(self):
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5.0)

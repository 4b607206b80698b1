"""Live interactive viewer: orbit-camera web UI over the render path (the
port's copy of nersemble_tpu/viewer/server.py; frames go out as PNG through
utils/png.py).

Replaces the reference's nerfstudio web viewer (``--vis viewer``,
reference scripts/train/train_nersemble.py:56 via nerfstudio's
websocket/three.js viewer) with a dependency-free equivalent: a stdlib
HTTP server serves a single-page UI (mouse-orbit camera, time slider,
channel selector, resolution picker) and a ``/render`` endpoint.

Threading model: the device stays on ONE thread. HTTP handler threads only
enqueue ``_Request`` objects and block on an Event; the owning thread
(the trainer between steps, or the standalone CLI loop in
scripts/view_nersemble.py) calls :meth:`ViewerServer.service` which pops
a request, renders through the provided callback, encodes, and wakes the
handler. Handler threads never touch a tensor. During training this gives
the same between-iterations service cadence as the reference trainer's
viewer lock plumbing
(reference nerfstudio/engine/nersemble_trainer.py:23-113).

Over several ranks (``serve_over_ranks``) rank 0 alone runs the server: it
takes the pending requests without blocking (or waits up to a timeout, the
view CLI) and shares their parameters with every rank over the mesh's host
group (one small host message when there is none); every rank renders each
request in turn, its share of each chunk (engine/renderer.py), and rank 0
encodes the frame and replies. A render that fails on one rank may leave
the others waiting in one of its collectives, so a failed render is never
answered and served past: rank 0 answers its requests with a 500 and the
failing rank raises, which ends the run (the launcher stops the ranks).

The orbit parameterization matches the render CLI's circular trajectory
(scripts/render/render_nersemble.py:64-72 absorbed as
data/cameras.py::circle_around_axis): cameras look at ``center``
(default (0, -1, 0), the head), at ``distance`` (default 0.3), poses are
OpenCV convention then converted with the same diag(1,-1,-1,1) * scale
chain the render CLI uses.
"""

import json
import math
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from nersemble_tpu_torch.utils import png


def orbit_pose(azimuth: float, elevation: float, distance: float,
               center=(0.0, -1.0, 0.0), axis=(0.0, 1.0, 0.0),
               up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """OpenCV cam-to-world pose on an orbit sphere, looking at ``center``.

    ``azimuth`` sweeps the circle_around_axis trajectory (azimuth=i/n*2pi
    at elevation 0 reproduces its pose i exactly); ``elevation`` lifts the
    camera along ``axis``. Angles in radians.
    """
    axis = np.asarray(axis, np.float64)
    axis /= np.linalg.norm(axis)
    up = np.asarray(up, np.float64)
    center = np.asarray(center, np.float64)
    u = np.cross(up, axis)
    if np.linalg.norm(u) < 1e-6:
        u = np.cross(np.array([1.0, 0.0, 0.0]), axis)
    u /= np.linalg.norm(u)
    v = np.cross(axis, u)
    el = float(np.clip(elevation, -1.45, 1.45))  # keep off the poles
    radial = np.cos(el) * (np.cos(azimuth) * u + np.sin(azimuth) * v)
    position = center + distance * (radial + np.sin(el) * axis)
    forward = center - position
    forward /= np.linalg.norm(forward)
    right = np.cross(forward, up)
    if np.linalg.norm(right) < 1e-6:  # looking along up: fall back to u
        right = u.copy()
    right /= np.linalg.norm(right)
    down = np.cross(forward, right)
    pose = np.eye(4)
    pose[:3, 0] = right
    pose[:3, 1] = down
    pose[:3, 2] = forward
    pose[:3, 3] = position
    return pose


def encode_image(image: np.ndarray):
    """uint8 [H, W, 3] -> (PNG bytes, content_type)."""
    return png.encode(np.ascontiguousarray(image)), "image/png"


_DEFAULTS = dict(az=0.0, el=0.0, dist=0.3, t=0.0, channel="rgb", width=256)


class _Request:
    def __init__(self, params: Dict):
        self.params = params
        self.event = threading.Event()
        self.payload = b""
        self.content_type = "text/plain"
        self.status = 500


class ViewerServer:
    """HTTP front half of the viewer. ``state`` feeds the UI (run name,
    n_timesteps, step, channels, default distance). The owner thread must
    call :meth:`service` regularly with the render callback:
    ``render_fn(params) -> np.uint8 [H, W, 3]`` where params carries the
    float keys az/el/dist/t (t in [0, 1]) plus channel and width."""

    def __init__(self, state: Dict, host: str = "127.0.0.1", port: int = 7007):
        self.state = dict(state)
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence per-request stderr spam
                pass

            def do_GET(self):
                parsed = urlparse(self.path)
                if parsed.path in ("/", "/index.html"):
                    page = _PAGE.replace("__STATE__",
                                         json.dumps(server.state))
                    body = page.encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/html; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if parsed.path == "/render":
                    q = parse_qs(parsed.query)
                    params = dict(_DEFAULTS)
                    # validate query params instead of letting a malformed
                    # or non-finite value raise inside do_GET (dropped
                    # connection) or flow unclamped into viewer_render
                    try:
                        for key in ("az", "el", "dist", "t"):
                            if key in q:
                                value = float(q[key][0])
                                if not math.isfinite(value):
                                    raise ValueError(f"{key} not finite")
                                params[key] = value
                        if "width" in q:
                            params["width"] = max(16, min(4096,
                                                          int(q["width"][0])))
                    except (ValueError, TypeError) as exc:
                        self.send_error(400, f"bad query param: {exc}")
                        return
                    params["t"] = min(max(params["t"], 0.0), 1.0)
                    params["dist"] = min(max(params["dist"], 1e-3), 1e6)
                    if "channel" in q:
                        params["channel"] = q["channel"][0]
                    req = _Request(params)
                    server._queue.put(req)
                    if not req.event.wait(timeout=300.0):
                        self.send_error(504, "render timed out")
                        return
                    self.send_response(req.status)
                    self.send_header("Content-Type", req.content_type)
                    self.send_header("Content-Length", str(len(req.payload)))
                    self.send_header("Cache-Control", "no-store")
                    self.end_headers()
                    self.wfile.write(req.payload)
                    return
                self.send_error(404)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self.host = host
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/"

    def pending(self) -> int:
        """Requests queued and not yet taken (approximate, as
        ``queue.Queue.qsize``)."""
        return self._queue.qsize()

    def take(self, timeout: float = 0.0) -> Optional[_Request]:
        """The next pending request, waiting up to ``timeout`` seconds (0:
        only one already waiting); None if there is none."""
        try:
            return self._queue.get(timeout=timeout) if timeout \
                else self._queue.get_nowait()
        except queue.Empty:
            return None

    def reply(self, req: _Request, image) -> None:
        """Answer ``req`` with the rendered frame as a PNG (an encoding
        error: a 500)."""
        try:
            image = np.asarray(image)
            if image.dtype != np.uint8:
                image = (np.clip(image, 0.0, 1.0) * 255).astype(np.uint8)
            req.payload, req.content_type = encode_image(image)
            req.status = 200
        except Exception as exc:
            self.fail(req, exc)
        finally:
            req.event.set()

    def fail(self, req: _Request, exc: BaseException) -> None:
        """Answer ``req`` with a 500 naming ``exc``."""
        req.payload = f"render failed: {exc!r}".encode()
        req.content_type = "text/plain"
        req.status = 500
        req.event.set()

    def service(self, render_fn: Callable[[Dict], np.ndarray],
                timeout: float = 0.0) -> bool:
        """Serve at most one pending render request on the CALLING thread.
        Returns True if a request was served. ``timeout`` 0 = non-blocking
        poll (the trainer's between-steps cadence)."""
        req = self.take(timeout)
        if req is None:
            return False
        try:
            image = render_fn(req.params)
        except Exception as exc:  # surface errors to the browser, keep serving
            self.fail(req, exc)
            return True
        self.reply(req, image)
        return True

    def update_state(self, **kw) -> None:
        """Refresh UI-visible state (e.g. the current training step)."""
        self.state.update(kw)

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self._thread.join(timeout=5.0)


_STOP = "stop"  # rank 0's last message to the other ranks (serve_over_ranks)


def serve_over_ranks(server: Optional[ViewerServer], mesh,
                     render_fn: Callable[[Dict], np.ndarray], timeout: float = 0.0,
                     stop: bool = False) -> Optional[int]:
    """One round of the viewer over the ranks of ``mesh``, every rank
    calling: rank 0 (which holds ``server``; the others pass None) takes its
    pending requests (waiting up to ``timeout`` seconds for the first) and
    shares their parameters (``mesh.share_items``); every rank renders each
    with ``render_fn`` in turn and rank 0 replies. Returns the requests
    served, or None once rank 0 has sent the stop message (``stop`` on rank
    0: the view CLI's exit). A render that raises on a rank ends the run:
    rank 0 answers the round's unanswered requests with a 500, and the
    failing rank raises."""
    chief = mesh.rank == 0
    requests: List[_Request] = []
    items = None
    if chief:
        if stop:
            items = [_STOP]
        else:
            req = server.take(timeout)
            while req is not None:
                requests.append(req)
                req = server.take()
            items = [req.params for req in requests]
    items = mesh.share_items(items)
    if items == [_STOP]:
        return None
    for i, params in enumerate(items):
        try:
            image = render_fn(params)
        except Exception as exc:
            for req in requests[i:]:
                server.fail(req, exc)
            raise RuntimeError(
                f"viewer render failed on rank {mesh.rank} of {mesh.size}: {exc!r}; "
                "over several ranks a failed render ends the run (the other "
                "ranks may wait in one of its collectives)") from exc
        if chief:
            server.reply(requests[i], image)
    return len(items)


_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>nersemble viewer</title>
<style>
 body{margin:0;background:#111;color:#ddd;font:13px system-ui,sans-serif;
      display:flex;flex-direction:column;height:100vh}
 #bar{padding:6px 10px;background:#1b1b1b;display:flex;gap:14px;
      align-items:center;flex-wrap:wrap}
 #view{flex:1;display:flex;align-items:center;justify-content:center;
       overflow:hidden;cursor:grab}
 img{max-width:100%;max-height:100%;image-rendering:auto;user-select:none;
     -webkit-user-drag:none}
 select,input{background:#222;color:#ddd;border:1px solid #444}
 .lab{opacity:.7}
</style></head><body>
<div id="bar">
 <b id="title"></b>
 <span><span class="lab">channel</span>
  <select id="channel"><option>rgb</option><option>depth</option>
   <option>deformation</option></select></span>
 <span><span class="lab">time</span>
  <input id="time" type="range" min="0" max="1" step="0.01" value="0"
         style="width:120px"></span>
 <span><span class="lab">width</span>
  <select id="width"><option>128</option><option selected>256</option>
   <option>512</option><option>1024</option></select></span>
 <span id="status" class="lab">drag to orbit, wheel to zoom</span>
</div>
<div id="view"><img id="img" alt=""></div>
<script>
const S = __STATE__;
document.getElementById('title').textContent =
  (S.run_name || 'nersemble') + ' @ step ' + (S.step ?? '?');
if ((S.n_timesteps || 1) <= 1)
  document.getElementById('time').disabled = true;
let az = 0, el = 0, dist = S.distance || 0.3, dirty = true, busy = false;
const img = document.getElementById('img'),
      view = document.getElementById('view'),
      status = document.getElementById('status');
function mark(){ dirty = true; }
['channel','time','width'].forEach(id =>
  document.getElementById(id).addEventListener('input', mark));
let drag = null;
view.addEventListener('pointerdown', e => {
  drag = [e.clientX, e.clientY]; view.setPointerCapture(e.pointerId);});
view.addEventListener('pointermove', e => {
  if (!drag) return;
  az += (e.clientX - drag[0]) * 0.008;
  el = Math.min(1.4, Math.max(-1.4, el + (e.clientY - drag[1]) * 0.008));
  drag = [e.clientX, e.clientY]; mark();});
view.addEventListener('pointerup', () => drag = null);
view.addEventListener('wheel', e => {
  e.preventDefault();
  dist = Math.min(3, Math.max(0.05, dist * Math.exp(e.deltaY * 0.001)));
  mark();}, {passive: false});
async function loop(){
  if (dirty && !busy){
    dirty = false; busy = true;
    const p = new URLSearchParams({az, el, dist,
      t: document.getElementById('time').value,
      channel: document.getElementById('channel').value,
      width: document.getElementById('width').value});
    const t0 = performance.now();
    try {
      const r = await fetch('/render?' + p);
      if (r.ok){
        const blob = await r.blob();
        const old = img.src; img.src = URL.createObjectURL(blob);
        if (old) URL.revokeObjectURL(old);
        status.textContent = Math.round(performance.now() - t0) + ' ms';
      } else {
        status.textContent = 'error: ' + (await r.text()).slice(0, 120);
      }
    } catch (e){ status.textContent = 'fetch failed'; }
    busy = false;
  }
  requestAnimationFrame(loop);
}
mark(); loop();
</script></body></html>
"""

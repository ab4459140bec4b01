"""Interactive browser viewer: the SDL2 window replacement.

The JAX package's runtime/viewer.py, over the port's loop. The reference
opens an SDL2 window, pumps keyboard/mouse events at 30 Hz, and paints each
assembled frame onto the window surface (shared/screen/screen.go:16-53,
shared/input/input.go:18-106, master/main.go:163-177). Accelerator hosts
are headless, so the window becomes a tiny stdlib HTTP server:

  GET  /            the viewer page (canvas + key/mouse capture)
  GET  /stream      multipart/x-mixed-replace PNG stream (live frames)
  GET  /frame.png   latest frame as one PNG
  POST /input       JSON {"kind": "key_down"|"key_up"|"mouse", ...} events
  GET  /stats       frame statistics so far (JSON)

It plugs into runtime/loop.run_loop unchanged: `viewer.display` is the
display sink, `viewer.events()` the event source — the browser plays the
role of SDL's event queue, with the same WASD/Space/LShift/Esc bindings and
mouse-delta yaw/pitch semantics (runtime/controller.py). No third-party
dependencies; PNG frames come from runtime/framebuffer.png_bytes.
"""

from __future__ import annotations

import collections
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from distributed_raytracer_tpu_torch.runtime.framebuffer import png_bytes

_PAGE = """<!doctype html>
<html><head><title>distributed_raytracer_tpu_torch</title><style>
 body { background: #111; color: #ddd; font-family: monospace; margin: 1em; }
 img { image-rendering: pixelated; outline: 1px solid #444; }
</style></head>
<body>
<div>WASD move &middot; Space/Shift up/down &middot; drag to look &middot;
Esc quits the loop</div>
<img id="v" src="/stream" tabindex="0">
<div id="s"></div>
<script>
const keymap = {"w":"w","a":"a","s":"s","d":"d"," ":"space",
                "Shift":"lshift","Escape":"esc"};
function post(ev) {
  fetch("/input", {method:"POST", body: JSON.stringify(ev)});
}
window.addEventListener("keydown", e => {
  const k = keymap[e.key]; if (k && !e.repeat) post({kind:"key_down", key:k});
});
window.addEventListener("keyup", e => {
  const k = keymap[e.key]; if (k) post({kind:"key_up", key:k});
});
let dragging = false;
const img = document.getElementById("v");
img.addEventListener("mousedown", () => dragging = true);
window.addEventListener("mouseup", () => dragging = false);
window.addEventListener("mousemove", e => {
  if (dragging) post({kind:"mouse", dx:e.movementX, dy:e.movementY});
});
setInterval(async () => {
  const r = await fetch("/stats");
  document.getElementById("s").textContent = await r.text();
}, 1000);
</script></body></html>
"""


class ViewerServer:
    """Shared state + HTTP plumbing for one interactive session.

    Thread model: run_loop runs on the caller's thread (it owns the device);
    the HTTP server runs daemon threads that only touch the latest-frame
    buffer and the event queue under `_lock`.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 max_fps: float = 30.0):
        self._lock = threading.Lock()
        self._frame_png = None          # encoded latest frame
        self._frame_seq = 0
        self._frame_event = threading.Condition(self._lock)
        self._queue = collections.deque()
        self._running = True
        self._stats = {}
        self.max_fps = max_fps

        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/" or self.path.startswith("/index"):
                    self._send(200, "text/html", _PAGE.encode())
                elif self.path.startswith("/frame.png"):
                    png = viewer.latest_png()
                    if png is None:
                        self._send(404, "text/plain", b"no frame yet")
                    else:
                        self._send(200, "image/png", png)
                elif self.path.startswith("/stats"):
                    self._send(200, "application/json",
                               json.dumps(viewer.stats_dict()).encode())
                elif self.path.startswith("/stream"):
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=frame")
                    self.end_headers()
                    last = -1
                    try:
                        while viewer._running:
                            png, last = viewer.wait_frame(last, timeout=1.0)
                            if png is None:
                                continue
                            self.wfile.write(
                                b"--frame\r\nContent-Type: image/png\r\n"
                                + f"Content-Length: {len(png)}\r\n\r\n".encode()
                                + png + b"\r\n")
                    except (BrokenPipeError, ConnectionResetError):
                        pass
                else:
                    self._send(404, "text/plain", b"not found")

            def do_POST(self):
                if self.path.startswith("/input"):
                    n = int(self.headers.get("Content-Length", 0))
                    try:
                        ev = json.loads(self.rfile.read(n) or b"{}")
                    except ValueError:
                        self._send(400, "text/plain", b"bad json")
                        return
                    viewer.push_event(ev)
                    self._send(200, "text/plain", b"ok")
                else:
                    self._send(404, "text/plain", b"not found")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    # -- addresses ---------------------------------------------------------

    @property
    def address(self):
        return self._httpd.server_address

    @property
    def url(self) -> str:
        host, port = self.address[:2]
        return f"http://{host}:{port}/"

    # -- frame side (display sink for run_loop) -----------------------------

    def display(self, frame_index: int, img: np.ndarray) -> None:
        png = png_bytes(img, level=1)   # latency over ratio for live frames
        with self._lock:
            self._frame_png = png
            self._frame_seq += 1
            self._frame_event.notify_all()

    def latest_png(self):
        with self._lock:
            return self._frame_png

    def wait_frame(self, seen_seq: int, timeout: float = 1.0):
        """Block until a frame newer than seen_seq exists (or timeout)."""
        deadline = time.monotonic() + timeout
        with self._lock:
            while (self._frame_seq <= seen_seq or self._frame_png is None):
                left = deadline - time.monotonic()
                if left <= 0 or not self._running:
                    return None, seen_seq
                self._frame_event.wait(left)
            return self._frame_png, self._frame_seq

    def set_stats(self, **kv) -> None:
        with self._lock:
            self._stats.update(kv)

    def stats_dict(self) -> dict:
        with self._lock:
            d = dict(self._stats)
        d["frames"] = self._frame_seq
        return d

    # -- input side (event source for run_loop) ------------------------------

    def push_event(self, ev: dict) -> None:
        kind = ev.get("kind")
        if kind in ("key_down", "key_up"):
            tup = (kind, str(ev.get("key", "")))
        elif kind == "mouse":
            tup = ("mouse", float(ev.get("dx", 0)), float(ev.get("dy", 0)))
        else:
            return
        with self._lock:
            self._queue.append(tup)

    def drain_events(self) -> list:
        with self._lock:
            evs = list(self._queue)
            self._queue.clear()
        return evs

    def events(self):
        """Infinite per-tick event-list generator for run_loop (pace with
        realtime=True). Ends when stop() is called; Esc ends the loop via
        the controller before that."""
        while self._running:
            yield self.drain_events()

    def stop(self) -> None:
        with self._lock:
            self._running = False
            self._frame_event.notify_all()
        self._httpd.shutdown()
        self._httpd.server_close()


def with_scenes(events, states):
    """Each tick's events with ("scene", the next of `states`) appended:
    the scene moves one state a tick (runtime/loop.py)."""
    for tick, state in zip(events, states):
        yield list(tick) + [("scene", state)]


def serve(scene_arrays, camera, render_fn, width: int, height: int,
          host: str = "127.0.0.1", port: int = 8000, cfg=None,
          on_ready=None, scenes=None):
    """Serve an interactive render session until Esc (blocking).

    The exact analog of the master's main loop: 30 Hz input ticks, frames
    only on input change, pipelined dispatch, FPS statistics at exit
    (master/main.go:240-325). `scenes`, when given, is an iterable of
    scene states, one carried by each tick (`with_scenes`): the scene's
    mutable state the master sends with every work order
    (master/main.go:260-266), so every tick makes a frame."""
    from distributed_raytracer_tpu_torch.runtime.loop import run_loop
    from distributed_raytracer_tpu_torch.utils.config import DEFAULT_CONFIG

    viewer = ViewerServer(host=host, port=port)
    if on_ready is not None:
        on_ready(viewer)
    try:
        events = viewer.events()
        if scenes is not None:
            events = with_scenes(events, scenes)
        cam, stats, dropped = run_loop(
            scene_arrays, camera, render_fn, width, height,
            events=events, display=viewer.display,
            cfg=cfg or DEFAULT_CONFIG, realtime=True)
        viewer.set_stats(dropped=dropped)
        return cam, stats, dropped
    finally:
        viewer.stop()

"""Live training viewer — stdlib-only web GUI.

Capability-equivalent of the reference's viser GUI
(/root/reference/mlx_nerf/entrypoints/__viser_image_learning.py:59-124:
themed page, Learning checkbox, iteration slider, live GT/prediction
images), rebuilt without the viser dependency (not available on headless
hosts): a background-thread `http.server` serves an HTML page that
polls PNG frames and scalar state, plus a pause/resume toggle the train
loop reads.

Usage:
    viewer = LiveViewer(port=8008)
    viewer.update("gt", gt_image)         # float [H,W,3] in [0,1]
    viewer.update("pred", pred_image)
    viewer.set_state(step=i, loss=loss)
    if viewer.learning_enabled: ...       # GUI checkbox state
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Tuple

import numpy as np

from nerf_meets_mlx_tpu.utils.video import encode_png, to_u8_rgb

_PAGE = """<!doctype html>
<html><head><title>nerf_meets_mlx_tpu</title><style>
body { font-family: monospace; background: #1b1b1f; color: #eee; margin: 2em; }
h2 { color: rgb(255,133,133); }  /* PJ_PINK (this_project.py:11) */
img { image-rendering: pixelated; width: 320px; border: 1px solid #444; margin-right: 1em; }
#state { margin: 1em 0; white-space: pre; }
button { background: rgb(255,133,133); border: none; padding: .5em 1em; cursor: pointer; }
</style></head><body>
<h2>nerf_meets_mlx_tpu — live training</h2>
<div><img id="gt" alt="gt"><img id="pred" alt="pred"></div>
<div id="state"></div>
<button onclick="fetch('/toggle',{method:'POST'})">pause / resume</button>
<script>
setInterval(() => {
  const t = Date.now();
  for (const n of ['gt', 'pred'])
    document.getElementById(n).src = '/frame/' + n + '.png?t=' + t;
  fetch('/state').then(r => r.json()).then(s => {
    document.getElementById('state').textContent = JSON.stringify(s, null, 1);
  });
}, 500);
</script></body></html>"""


class LiveViewer:
    def __init__(self, port: int = 8008, host: str = "0.0.0.0"):
        self._frames: Dict[str, Tuple[bytes, str]] = {}  # name -> (body, mime)
        self._state: Dict = {}
        self._lock = threading.Lock()
        self._learning = threading.Event()
        self._learning.set()
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence request logs
                pass

            def _send(self, code: int, ctype: str, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/":
                    self._send(200, "text/html", _PAGE.encode())
                elif path.startswith("/frame/"):
                    name = path[len("/frame/") :].removesuffix(".png")
                    with viewer._lock:
                        entry = viewer._frames.get(name)
                    if entry is None:
                        self._send(404, "text/plain", b"no frame")
                    else:
                        data, mime = entry
                        self._send(200, mime, data)
                elif path == "/state":
                    with viewer._lock:
                        body = json.dumps(
                            {**viewer._state, "learning": viewer.learning_enabled}
                        ).encode()
                    self._send(200, "application/json", body)
                else:
                    self._send(404, "text/plain", b"not found")

            def do_POST(self):
                if self.path == "/toggle":
                    if viewer._learning.is_set():
                        viewer._learning.clear()
                    else:
                        viewer._learning.set()
                    self._send(200, "application/json", b'{"ok": true}')
                else:
                    self._send(404, "text/plain", b"not found")

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()

    @property
    def learning_enabled(self) -> bool:
        return self._learning.is_set()

    def wait_if_paused(self, timeout: float = 0.25):
        """Block (politely) while the GUI has learning paused."""
        while not self._learning.is_set():
            self._learning.wait(timeout)

    def update(self, name: str, img: np.ndarray):
        # prefer the native JPEG encoder (native/video_writer.cpp) — ~10x
        # faster than the stdlib-zlib PNG path on full frames; PNG fallback
        # keeps the viewer dependency-free when the toolchain is absent
        arr = to_u8_rgb(img)
        entry = None
        try:
            from nerf_meets_mlx_tpu.utils import native_video

            jpg = native_video.encode_jpeg(arr, quality=90)
            if jpg is not None:
                entry = (jpg, "image/jpeg")
        except Exception:
            entry = None
        if entry is None:
            entry = (encode_png(arr), "image/png")
        with self._lock:
            self._frames[name] = entry

    def set_state(self, **kv):
        with self._lock:
            self._state.update(
                {k: (float(v) if hasattr(v, "item") else v) for k, v in kv.items()}
            )

    def close(self):
        self._server.shutdown()
        self._server.server_close()

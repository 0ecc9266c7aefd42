"""Live status endpoint: the headless analog of the reference's live GUI.

Reference surface: Pangolin panels polling CalibrationStats every 30 ms
(vicalib-engine.cc:108, 388-432; vicalib-task.cc:154-225).  Batch and
streaming runs already render the full HTML report (report.py); this serves
it — plus a machine-readable stats JSON — over a localhost HTTP port so a
browser (or a script) can watch a run converge live:

    python -m vicalib_tpu_torch.cli ... -stream_chunk 16 -status_port 8080 \
        -report_file report.html
    # browser: http://localhost:8080/        (report, auto-refreshing)
    #          http://localhost:8080/stats.json

Pure stdlib (http.server in a daemon thread); publishing a stats snapshot
is a lock-guarded pointer swap, so the engine's solve path never blocks on
a slow client.  The server thread only ever sees host data (the stats
dataclass with floats and numpy arrays, SVG text): it never touches a
device tensor or the CUDA context.

Routes are matched exactly: ``/stats.json``, ``/scene.svg`` and ``/``;
any other path answers 404.
"""
from __future__ import annotations

import json
import logging
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import urlsplit

import numpy as np

log = logging.getLogger("vicalib_tpu_torch.status")


def _stats_dict(stats) -> dict:
    """CalibrationStats -> JSON-serializable dict."""
    if stats is None:
        return {"status": "starting"}
    d = {
        "status": stats.status.name.lower(),
        "num_frames_processed": [int(n) for n in
                                 stats.num_frames_processed],
        "reprojection_error": [float(r) for r in
                               (stats.reprojection_error or [])],
        "total_mse": (float(stats.total_mse)
                      if stats.total_mse is not None else None),
        "num_iterations": int(stats.num_iterations or 0),
        "time_offset": (float(stats.ts) if stats.ts is not None else None),
    }
    if stats.cam_intrinsics:
        d["cam_intrinsics"] = [np.asarray(p).tolist()
                               for p in stats.cam_intrinsics]
    return d


class StatusServer:
    """Serves the latest stats snapshot and the HTML report."""

    def __init__(self, port: int, report_path: str = None,
                 host: str = "127.0.0.1"):
        self._lock = threading.Lock()
        self._stats = None
        self._scene = None
        self.report_path = report_path
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):   # route to our logger
                log.debug("status: " + fmt, *args)

            def do_GET(self):
                path = urlsplit(self.path).path
                if path == "/stats.json":
                    with server._lock:
                        body = json.dumps(_stats_dict(server._stats))
                    self._send(200, "application/json", body.encode())
                elif path == "/scene.svg":
                    with server._lock:
                        svg = server._scene
                    if svg is None:
                        self._send(404, "text/plain", b"no scene yet")
                    else:
                        self._send(200, "image/svg+xml", svg.encode())
                elif path == "/":
                    self._send(200, "text/html; charset=utf-8",
                               server._report_html())
                else:
                    self._send(404, "text/plain", b"not found")

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                # while a run is live, have browsers re-pull periodically
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]   # resolved (port 0 ok)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="vicalib-status", daemon=True)

    def _report_html(self) -> bytes:
        if self.report_path and os.path.exists(self.report_path):
            with open(self.report_path, "rb") as f:
                html = f.read()
            # inject a refresh so the browser tracks per-chunk rewrites
            return html.replace(
                b"<head>", b'<head><meta http-equiv="refresh" content="2">',
                1)
        with self._lock:
            d = _stats_dict(self._stats)
            have_scene = self._scene is not None
        scene = ('<img src="/scene.svg" style="max-width:100%">'
                 if have_scene else "")
        return (
            "<html><head><meta http-equiv='refresh' content='1'></head>"
            "<body><h2>vicalib_tpu_torch: calibration running</h2><pre>"
            + json.dumps(d, indent=1) + "</pre>" + scene
            + "<p>(full report appears here once -report_file is "
            "written)</p></body></html>").encode()

    def start(self):
        self._thread.start()
        log.info("live status at http://127.0.0.1:%d/ (stats.json for "
                 "machine readers)", self.port)
        return self

    def publish(self, stats):
        with self._lock:
            self._stats = stats

    def publish_scene(self, svg: str):
        """Latest 3-D scene (viz.scene_svg string) for GET /scene.svg —
        the live analog of the reference's Pangolin 3-D view."""
        with self._lock:
            self._scene = svg

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()

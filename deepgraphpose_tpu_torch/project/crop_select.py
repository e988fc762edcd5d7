"""Crop-parameter selection without a display
(ref: utils/select_crop_parameters.py — a wx window with a drag-rectangle
whose ``show(config, image)`` returns ``[x1, x2, y1, y2]``; consumed by
``extract_frames(crop=True)``, ref: frame_extraction.py:149-168).

The port's own copy of ``deepgraphpose_tpu/project/crop_select.py``: host
code (numpy, OpenCV), no model and no device.

Same contract, three headless resolution paths in order:

1. ``$DGP_CROP`` = ``"x1,x2,y1,y2"`` — scripted/CI runs;
2. an interactive terminal prompt when stdin is a TTY;
3. a one-shot browser UI (drag a rectangle on the frame, Save) when
   ``interactive='browser'`` is requested explicitly;
4. otherwise the full frame, with a note — extraction proceeds uncropped,
   matching a user clicking Save without dragging in the reference GUI.
"""

from __future__ import annotations

import json
import os
import sys
import threading
from pathlib import Path

import numpy as np

_PAGE = """<!doctype html><html><head><title>select crop</title><style>
body{font-family:sans-serif;margin:16px} #wrap{position:relative;
display:inline-block} #box{position:absolute;border:2px solid #e33;
background:rgba(230,50,50,.15);pointer-events:none}
</style></head><body>
<h3>Drag a rectangle, then Save (full frame if none)</h3>
<div id="wrap"><img id="im" src="/frame.png"><div id="box" hidden></div>
</div><br><button id="save">Save crop</button> <span id="msg"></span>
<script>
let s=null,cur=null;const im=document.getElementById('im'),
box=document.getElementById('box');
im.ondragstart=()=>false;
im.addEventListener('mousedown',e=>{const r=im.getBoundingClientRect();
s=[e.clientX-r.left,e.clientY-r.top];});
document.addEventListener('mousemove',e=>{if(!s)return;
const r=im.getBoundingClientRect();const x=e.clientX-r.left,
y=e.clientY-r.top;cur=[Math.min(s[0],x),Math.min(s[1],y),
Math.max(s[0],x),Math.max(s[1],y)];box.hidden=false;
box.style.left=cur[0]+'px';box.style.top=cur[1]+'px';
box.style.width=(cur[2]-cur[0])+'px';box.style.height=(cur[3]-cur[1])+'px';});
document.addEventListener('mouseup',()=>{s=null;});
document.getElementById('save').onclick=async()=>{
const sc=im.naturalWidth/im.width;
const body=cur?{x1:cur[0]*sc,y1:cur[1]*sc,x2:cur[2]*sc,y2:cur[3]*sc}:{};
await fetch('/api/crop',{method:'POST',body:JSON.stringify(body)});
document.getElementById('msg').textContent='saved — you can close this tab';
};
</script></body></html>"""


def _browser_select(image: np.ndarray, port: int = 0,
                    timeout: float | None = None) -> list | None:
    """Serve one frame, return [x1, x2, y1, y2] when the user saves."""
    import cv2
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    ok, png = cv2.imencode(".png", np.asarray(image)[:, :, ::-1])
    if not ok:
        raise ValueError("could not encode frame")
    png = png.tobytes()
    result: dict = {}
    done = threading.Event()
    h, w = image.shape[:2]

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code, body, ctype="text/plain"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                self._send(200, _PAGE.encode(), "text/html")
            elif self.path.startswith("/frame.png"):
                self._send(200, png, "image/png")
            else:
                self._send(404, b"not found")

        def do_POST(self):
            if self.path.startswith("/api/crop"):
                n = int(self.headers.get("Content-Length", 0))
                msg = json.loads(self.rfile.read(n) or b"{}")
                if msg:
                    result["coords"] = [
                        int(max(0, msg["x1"])), int(min(w, msg["x2"])),
                        int(max(0, msg["y1"])), int(min(h, msg["y2"]))]
                else:
                    result["coords"] = [0, w, 0, h]
                self._send(200, b"ok")
                done.set()
            else:
                self._send(404, b"not found")

    httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    print(f"crop-selection UI at http://127.0.0.1:"
          f"{httpd.server_address[1]}/ — drag a rectangle and Save",
          flush=True)
    got = done.wait(timeout)
    httpd.shutdown()
    httpd.server_close()  # free the port for the next call
    return result.get("coords") if got else None


def show(config, image, interactive: str | None = None, port: int = 0,
         timeout: float | None = None) -> list:
    """Reference-shaped ``select_crop_parameters.show(config, image)``
    -> ``[x1, x2, y1, y2]`` ints (the order frame_extraction.py:164-166
    consumes). ``config`` is accepted for signature parity (the reference
    only uses it for the window title)."""
    del config
    image = np.asarray(image)
    h, w = image.shape[:2]

    env = os.environ.get("DGP_CROP")
    if env:
        parts = [int(float(v)) for v in env.split(",")]
        if len(parts) != 4:
            raise ValueError(f"DGP_CROP must be 'x1,x2,y1,y2', got {env!r}")
        return parts

    if interactive == "browser":
        coords = _browser_select(image, port=port, timeout=timeout)
        if coords is not None:
            return coords
        print("no crop submitted before timeout; using the full frame")
        return [0, w, 0, h]

    if sys.stdin.isatty():
        while True:
            raw = input(f"crop x1,x2,y1,y2 for a {w}x{h} frame "
                        f"(empty = full frame): ").strip()
            if not raw:
                return [0, w, 0, h]
            try:
                parts = [int(float(v)) for v in raw.split(",")]
            except ValueError:
                parts = []
            if len(parts) == 4:
                x1, x2, y1, y2 = parts
                # clamp to the frame and reject empty boxes (the reference
                # GUI's drag rectangle cannot leave the image)
                x1, x2 = sorted(min(max(v, 0), w) for v in (x1, x2))
                y1, y2 = sorted(min(max(v, 0), h) for v in (y1, y2))
                if x2 > x1 and y2 > y1:
                    return [x1, x2, y1, y2]
            print("need 4 comma-separated ints inside the frame; try again",
                  flush=True)

    print(f"select_crop_parameters: non-interactive session and no "
          f"$DGP_CROP — using the full {w}x{h} frame")
    return [0, w, 0, h]

"""Browser-based frame labeling — the headless replacement for the wx GUIs.

The port's own copy of ``deepgraphpose_tpu/project/label_server.py``: host
code (numpy, OpenCV), no model and no device.

The reference ships wxPython toolboxes for labeling and refinement
(ref: deeplabcut/gui/labeling_toolbox.py, multiple_individuals_labeling_
toolbox.py, refinement.py) that cannot run on a display-less host. This
module serves the same workflow over HTTP from the Python standard library
(no new dependencies): a canvas UI that walks the frames under
``labeled-data/<video>/``, records one (x, y) per bodypart per frame
(right-click clears = NaN/hidden, exactly the reference's "marker not
visible" convention), and writes the standard ``CollectedData_<scorer>``
CSV that every downstream step (create_training_dataset, check_labels,
refinement merges) already consumes.

Refine mode preloads existing machine/human labels so the same UI covers
the reference's refinement toolbox: predictions appear as draggable-in-
spirit markers (click re-places, right-click deletes), then "save"
overwrites the CSV.

Usage:
    python -m deepgraphpose_tpu_torch.cli label-frames <config.yaml> \
        [--port 8000]
or programmatically::

    srv = LabelServer("/path/to/project")
    srv.start()            # serves on 127.0.0.1:<port>, returns immediately
    ...
    srv.stop()
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>dgp label</title><style>
body{font-family:sans-serif;margin:12px;background:#1c1c22;color:#ddd}
#wrap{display:flex;gap:16px}
canvas{border:1px solid #555;cursor:crosshair;max-width:80vw}
button{margin:2px}.bp{display:block;margin:2px;padding:4px 8px;
border:1px solid #666;background:#2a2a33;color:#ddd;cursor:pointer}
.bp.sel{background:#3b6ea5}.done{color:#7c7}
#msg{margin-top:8px;color:#9a9}
</style></head><body>
<h3 id="title">loading…</h3>
<div id="wrap"><div>
<canvas id="cv"></canvas><br>
<button onclick="step(-1)">&#8592; prev</button>
<button onclick="step(1)">next &#8594;</button>
<button onclick="save()">save CSV</button>
<span id="msg"></span></div>
<div id="bps"></div></div>
<script>
let S=null, fi=0, bi=0, img=new Image();
const cv=document.getElementById('cv'), cx=cv.getContext('2d');
async function load(){S=await (await fetch('api/state')).json(); render();}
function key(){return S.frames[fi];}
function render(){
  document.getElementById('title').textContent=
    `${key()}  (${fi+1}/${S.frames.length})`;
  img.onload=()=>{cv.width=img.width; cv.height=img.height; draw();};
  img.src='frame/'+key()+'?'+Date.now();
  const bd=document.getElementById('bps'); bd.innerHTML='';
  S.bodyparts.forEach((b,j)=>{
    const el=document.createElement('button');
    el.className='bp'+(j===bi?' sel':'');
    const xy=S.labels[key()][j];
    el.textContent=b+(xy&&xy[0]!==null?' \\u2713':'');
    if(xy&&xy[0]!==null) el.classList.add('done');
    el.onclick=()=>{bi=j; render();};
    bd.appendChild(el);});
}
function draw(){
  cx.drawImage(img,0,0);
  S.labels[key()].forEach((xy,j)=>{ if(!xy||xy[0]===null) return;
    cx.strokeStyle=`hsl(${j*360/S.bodyparts.length},90%,60%)`;
    cx.lineWidth=2; cx.beginPath(); cx.arc(xy[0],xy[1],5,0,7); cx.stroke();
    cx.fillStyle=cx.strokeStyle;
    cx.fillText(S.bodyparts[j],xy[0]+7,xy[1]-7);});
}
async function setlabel(x,y){
  S.labels[key()][bi]=x===null?[null,null]:[x,y];
  await fetch('api/label',{method:'POST',body:JSON.stringify(
    {image:key(),joint:bi,x:x,y:y})});
  if(x!==null && bi<S.bodyparts.length-1) bi++;
  render();
}
cv.addEventListener('click',e=>{const r=cv.getBoundingClientRect();
  setlabel((e.clientX-r.left)*cv.width/r.width,
           (e.clientY-r.top)*cv.height/r.height);});
cv.addEventListener('contextmenu',e=>{e.preventDefault();setlabel(null,0);});
function step(d){fi=Math.min(Math.max(fi+d,0),S.frames.length-1);render();}
async function save(){const r=await fetch('api/save',{method:'POST'});
  document.getElementById('msg').textContent=await r.text();}
document.addEventListener('keydown',e=>{
  if(e.key==='ArrowRight')step(1); if(e.key==='ArrowLeft')step(-1);});
load();
</script></body></html>"""


class _State:
    """Labels for every frame under labeled-data/<video>/ (one video dir)."""

    def __init__(self, project_path: Path, video: str, scorer: str,
                 bodyparts: list):
        from deepgraphpose_tpu_torch.data import project as project_io

        self.project_path = project_path
        self.video = video
        self.scorer = scorer
        self.bodyparts = list(bodyparts)
        self.vdir = project_path / "labeled-data" / video
        self.frames = sorted(p.name for p in self.vdir.glob("*.png"))
        nj = len(self.bodyparts)
        # rel path -> (nj, 2) with NaN for unset
        self.labels = {f: np.full((nj, 2), np.nan) for f in self.frames}
        # preload existing human labels, then machine labels (refine mode)
        for csv_name in (f"CollectedData_{scorer}.csv",
                         f"machinelabels-iter0.csv"):
            path = self.vdir / csv_name
            if not path.exists():
                continue
            try:
                existing = project_io.read_collected_data_csv(path)
            except Exception:
                continue
            for p, c in zip(existing.image_paths, existing.coords_xy):
                name = Path(p).name
                if name in self.labels and np.isnan(self.labels[name]).all():
                    self.labels[name] = np.array(c, np.float64)[:nj]

    def to_json(self) -> dict:
        def row(a):
            return [[None, None] if np.isnan(a[j, 0]) else
                    [float(a[j, 0]), float(a[j, 1])]
                    for j in range(a.shape[0])]

        return {"video": self.video, "scorer": self.scorer,
                "bodyparts": self.bodyparts, "frames": self.frames,
                "labels": {f: row(self.labels[f]) for f in self.frames}}

    def set_label(self, image: str, joint: int, x, y) -> None:
        arr = self.labels[image]
        if x is None:
            arr[joint] = np.nan
        else:
            arr[joint] = (float(x), float(y))

    def save(self) -> Path:
        from deepgraphpose_tpu_torch.data.project import (Labels,
                                                          write_collected_data)

        keep = [f for f in self.frames
                if np.isfinite(self.labels[f]).any()]
        labels = Labels(
            scorer=self.scorer, bodyparts=self.bodyparts,
            image_paths=[f"labeled-data/{self.video}/{f}" for f in keep],
            coords_xy=np.stack([self.labels[f] for f in keep])
            if keep else np.zeros((0, len(self.bodyparts), 2)))
        out = self.vdir / f"CollectedData_{self.scorer}.csv"
        # .csv + .h5 twin, like the reference's SaveData
        # (ref: gui/labeling_toolbox.py)
        write_collected_data(out, labels)
        return out


class LabelServer:
    """Threaded HTTP server wrapping one video's labeling session."""

    def __init__(self, project_path: str | Path, video: str | None = None,
                 port: int = 0, host: str = "127.0.0.1",
                 scorer: str | None = None,
                 bodyparts: list | None = None):
        """``scorer``/``bodyparts`` override the config values — used by the
        multi-individual workflow (project/multi_individual.py) to run one
        session per individual into a session-scoped CollectedData file."""
        from deepgraphpose_tpu_torch.core.config import ProjectConfig

        project_path = Path(project_path)
        proj = ProjectConfig.from_yaml(project_path / "config.yaml")
        if video is None:
            vids = sorted(d.name for d in
                          (project_path / "labeled-data").glob("*")
                          if d.is_dir() and not d.name.endswith("_labeled"))
            if not vids:
                raise FileNotFoundError(
                    f"no labeled-data video dirs under {project_path}")
            video = vids[0]
        # an explicit empty bodyparts override is honored (a multi-animal
        # individual can have zero parts); only None falls back to config
        self.state = _State(project_path, video, scorer or proj.scorer,
                            list(proj.bodyparts if bodyparts is None
                                 else bodyparts))
        state = self.state

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, body: bytes, ctype="text/plain"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    self._send(200, _PAGE.encode(), "text/html")
                elif self.path.startswith("/api/state"):
                    self._send(200, json.dumps(state.to_json()).encode(),
                               "application/json")
                elif self.path.startswith("/frame/"):
                    name = Path(self.path.split("?")[0]).name
                    fp = state.vdir / name
                    if fp.exists() and fp.suffix == ".png":
                        self._send(200, fp.read_bytes(), "image/png")
                    else:
                        self._send(404, b"not found")
                else:
                    self._send(404, b"not found")

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n) if n else b"{}"
                if self.path.startswith("/api/label"):
                    msg = json.loads(body)
                    state.set_label(msg["image"], int(msg["joint"]),
                                    msg.get("x"), msg.get("y"))
                    self._send(200, b"ok")
                elif self.path.startswith("/api/save"):
                    out = state.save()
                    self._send(200, f"saved {out}".encode())
                else:
                    self._send(404, b"not found")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = None

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}/"

    def start(self) -> "LabelServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        print(f"labeling UI at {self.url} (video "
              f"{self.state.video}; ctrl-c to stop)", flush=True)
        self._httpd.serve_forever()

    def stop(self) -> None:
        self._httpd.shutdown()
        if self._thread:
            self._thread.join(timeout=5)
        self._httpd.server_close()

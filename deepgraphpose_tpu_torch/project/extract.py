"""Frame extraction for labeling (ref: deeplabcut/generate_training_dataset/
frame_extraction.py + utils/frameselectiontools.py).

The port's own copy of ``deepgraphpose_tpu/project/extract.py``: host code
(numpy, OpenCV), no model and no device.

Two selection algorithms, matching the reference's semantics:

* ``uniform``  — temporally uniform sampling in the configured
  [start, stop] fraction of the video (ref: frameselectiontools.py:45-69).
* ``kmeans``   — MiniBatchKMeans over downsampled (resizewidth px wide,
  grayscale by default) frames stepped by ``step``; one frame nearest each
  cluster center (ref: frameselectiontools.py:139-247).

Frames are written as ``labeled-data/<video>/img<NNN...>.png`` with the
zero-padding width derived from the frame count, exactly the layout the
labeling and training-set tooling expects.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from deepgraphpose_tpu_torch.core.config import ProjectConfig


def _read_stepped_frames(video_path: Path, start: float, stop: float,
                         step: int, resizewidth: int):
    """(indices, (n, h', w') grayscale f32 array) for the kmeans features."""
    import cv2

    cap = cv2.VideoCapture(str(video_path))
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    lo, hi = int(n * start), max(int(n * stop), int(n * start) + 1)
    idxs, frames = [], []
    ratio = None
    for i in range(lo, min(hi, n), step):
        cap.set(cv2.CAP_PROP_POS_FRAMES, i)
        ok, frame = cap.read()
        if not ok:
            continue
        if ratio is None:
            ratio = resizewidth / frame.shape[1]
        small = cv2.resize(frame, (0, 0), fx=ratio, fy=ratio)
        gray = cv2.cvtColor(small, cv2.COLOR_BGR2GRAY)
        idxs.append(i)
        frames.append(gray.astype(np.float32) / 255.0)
    cap.release()
    return np.asarray(idxs), (np.stack(frames) if frames else
                              np.zeros((0, 1, 1), np.float32))


def select_frames_uniform(n_frames: int, numframes2pick: int, start: float,
                          stop: float, rng=None) -> np.ndarray:
    """Uniformly spaced frame indices in [start, stop) fraction of video."""
    lo, hi = int(n_frames * start), max(int(n_frames * stop), 1)
    if hi - lo <= numframes2pick:
        return np.arange(lo, hi)
    return np.unique(np.linspace(lo, hi - 1, numframes2pick).astype(int))


def select_frames_kmeans(video_path: Path, numframes2pick: int,
                         start: float, stop: float, step: int = 25,
                         resizewidth: int = 30, seed: int = 42) -> np.ndarray:
    """Visually diverse frames by clustering downsampled frames."""
    from sklearn.cluster import MiniBatchKMeans

    idxs, frames = _read_stepped_frames(video_path, start, stop, step,
                                        resizewidth)
    if len(idxs) <= numframes2pick:
        return idxs
    flat = frames.reshape(len(idxs), -1)
    km = MiniBatchKMeans(n_clusters=numframes2pick, tol=1e-3,
                         batch_size=max(100, numframes2pick),
                         max_iter=50, n_init=3, random_state=seed)
    assign = km.fit_predict(flat)
    picked = []
    for c in range(numframes2pick):
        members = np.flatnonzero(assign == c)
        if members.size == 0:
            continue
        d = np.linalg.norm(flat[members] - km.cluster_centers_[c], axis=1)
        picked.append(int(idxs[members[np.argmin(d)]]))
    return np.unique(picked)


_MANUAL_PAGE = """<!doctype html><html><head><title>grab frames</title><style>
body{font-family:sans-serif;margin:16px;background:#1c1c22;color:#ddd}
img{border:1px solid #555;max-width:80vw}
input[type=range]{width:60vw}button{margin:2px}
#grabbed{color:#9a9}#msg{color:#7c7}
</style></head><body>
<h3 id="title">loading…</h3>
<img id="im" src=""><br>
<input id="sl" type="range" min="0" value="0"><br>
<button onclick="step(-1)">&#8592; prev</button>
<button onclick="step(1)">next &#8594;</button>
<button onclick="grab()">Grab Frame</button>
<button onclick="fin()">Done</button> <span id="msg"></span><br>
<div id="grabbed"></div>
<script>
let n=0,fi=0,got=new Set();
const im=document.getElementById('im'),sl=document.getElementById('sl');
async function init(){const s=await (await fetch('api/state')).json();
n=s.n_frames;sl.max=n-1;s.grabbed.forEach(i=>got.add(i));render();}
function render(){
 document.getElementById('title').textContent=`frame ${fi} / ${n-1}`;
 sl.value=fi; im.src='frame/'+fi+'.png';
 document.getElementById('grabbed').textContent=
   'grabbed: '+Array.from(got).sort((a,b)=>a-b).join(', ');}
function step(d){fi=Math.min(Math.max(fi+d,0),n-1);render();}
sl.oninput=()=>{fi=parseInt(sl.value);render();};
async function grab(){await fetch('api/grab',{method:'POST',
 body:JSON.stringify({index:fi})});got.add(fi);render();}
async function fin(){await fetch('api/done',{method:'POST'});
 document.getElementById('msg').textContent='done — you can close this tab';}
document.addEventListener('keydown',e=>{
 if(e.key==='ArrowRight')step(1);if(e.key==='ArrowLeft')step(-1);
 if(e.key===' '){e.preventDefault();grab();}});
init();
</script></body></html>"""


def manual_select(video_path: Path, port: int = 0,
                  timeout: float | None = None) -> np.ndarray:
    """Scrub-and-grab frame selection — the headless counterpart of the
    reference's wx frame_extraction_toolbox (ref: frame_extraction_toolbox.py
    slider + grabFrame, frame_extraction.py:42-60 mode='manual').

    Resolution order (same pattern as project/crop_select.py):

    1. ``$DGP_MANUAL_FRAMES`` = ``"3,17,42"`` — scripted/CI runs;
    2. a browser UI (slider scrubber over the video, Grab Frame, Done);
       on timeout, whatever was grabbed so far is returned.
    """
    import os
    import threading

    import cv2

    cap = cv2.VideoCapture(str(video_path))
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))

    env = os.environ.get("DGP_MANUAL_FRAMES")
    if env:
        cap.release()
        wanted = np.unique([int(float(v)) for v in env.split(",")
                            if v.strip()])
        picked = wanted[(wanted >= 0) & (wanted < n)]
        if len(picked) < len(wanted):
            print(f"DGP_MANUAL_FRAMES: dropping "
                  f"{sorted(set(wanted) - set(picked))} outside "
                  f"[0, {n}) of {video_path.name}")
        return picked

    import json
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    lock = threading.Lock()  # VideoCapture is not thread-safe
    grabbed: set[int] = set()
    done = threading.Event()

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
                self._send(200, _MANUAL_PAGE.encode(), "text/html")
            elif self.path.startswith("/api/state"):
                self._send(200, json.dumps(
                    {"n_frames": n, "grabbed": sorted(grabbed)}).encode(),
                    "application/json")
            elif self.path.startswith("/frame/"):
                try:
                    idx = int(Path(self.path).stem)
                except ValueError:
                    return self._send(404, b"bad index")
                with lock:
                    cap.set(cv2.CAP_PROP_POS_FRAMES,
                            min(max(idx, 0), max(n - 1, 0)))
                    ok, frame = cap.read()
                if not ok:
                    return self._send(404, b"no frame")
                ok, png = cv2.imencode(".png", frame)
                self._send(200, png.tobytes(), "image/png")
            else:
                self._send(404, b"not found")

        def do_POST(self):
            m = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(m) if m else b"{}"
            if self.path.startswith("/api/grab"):
                idx = int(json.loads(body)["index"])
                if 0 <= idx < n:
                    grabbed.add(idx)
                self._send(200, b"ok")
            elif self.path.startswith("/api/done"):
                self._send(200, b"ok")
                done.set()
            else:
                self._send(404, b"not found")

    httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    print(f"manual frame-grab UI at http://127.0.0.1:"
          f"{httpd.server_address[1]}/ — scrub, Grab Frame, Done "
          f"({video_path.name}, {n} frames)", flush=True)
    if not done.wait(timeout):
        print("manual selection timed out; keeping frames grabbed so far")
    httpd.shutdown()
    httpd.server_close()  # free the port for the next video
    with lock:  # an in-flight /frame handler may still hold the capture
        cap.release()
    return np.asarray(sorted(grabbed), int)


def extract_frames(config: str | Path, mode: str = "automatic",
                   algo: str = "kmeans", crop: bool = False,
                   userfeedback: bool = False, videos: list | None = None,
                   seed: int = 42, port: int = 0,
                   timeout: float | None = None) -> dict[str, np.ndarray]:
    """Extract frames for every video in the project's video_sets.

    Returns {video path: selected frame indices}. ``mode='automatic'``
    picks frames by ``algo``; ``mode='manual'`` runs the scrub-and-grab
    selection per video (``manual_select`` — $DGP_MANUAL_FRAMES or the
    browser UI; ref: frame_extraction.py:42-60 -> the wx toolbox).
    """
    import cv2

    del userfeedback  # headless: never prompt
    if mode not in ("automatic", "manual"):
        raise ValueError(f"mode must be 'automatic' or 'manual', not {mode!r}")

    config = Path(config)
    proj = ProjectConfig.from_yaml(config)
    project_path = Path(proj.project_path or config.parent)
    out: dict[str, np.ndarray] = {}

    vids = videos if videos is not None else list(proj.video_sets)
    for vid in vids:
        vpath = Path(vid)
        if not vpath.is_absolute():
            vpath = project_path / vpath
        if not vpath.exists():
            print(f"warning: {vpath} missing; skipping")
            continue
        cap = cv2.VideoCapture(str(vpath))
        n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        cap.release()
        if mode == "manual":
            picked = manual_select(vpath, port=port, timeout=timeout)
        elif algo == "uniform":
            picked = select_frames_uniform(n, proj.numframes2pick,
                                           proj.start, proj.stop)
        elif algo == "kmeans":
            picked = select_frames_kmeans(vpath, proj.numframes2pick,
                                          proj.start, proj.stop, seed=seed)
        else:
            raise ValueError(f"unknown algo {algo!r} (uniform|kmeans)")

        crop_box = None
        if crop:
            spec = (proj.video_sets.get(vid) or {}).get("crop")
            if spec:
                x0, x1, y0, y1 = [int(v) for v in str(spec).split(",")]
                crop_box = (x0, x1, y0, y1)
            else:
                # reference behavior: crop=True with no stored crop pops the
                # selection GUI and writes coords back to config.yaml
                # (ref: frame_extraction.py:149-168); headless resolution
                # order in project/crop_select.py ($DGP_CROP / tty / full)
                from deepgraphpose_tpu_torch.project import crop_select

                cap = cv2.VideoCapture(str(vpath))
                cap.set(cv2.CAP_PROP_POS_FRAMES,
                        int(proj.start * max(n - 1, 0)))
                ok, frame0 = cap.read()
                cap.release()
                if ok:
                    coords = crop_select.show(config, frame0[:, :, ::-1])
                    crop_box = tuple(int(v) for v in coords)
                    import yaml

                    raw = yaml.safe_load(config.read_text())
                    sets = raw.setdefault("video_sets", {})
                    # a YAML-null entry ("video:" with no mapping) reads
                    # back as None — replace, don't setdefault
                    if not isinstance(sets.get(vid), dict):
                        sets[vid] = {}
                    raw["video_sets"][vid]["crop"] = ", ".join(
                        str(v) for v in crop_box)
                    config.write_text(yaml.safe_dump(raw, sort_keys=False))

        dest = project_path / "labeled-data" / vpath.stem
        dest.mkdir(parents=True, exist_ok=True)
        pad = max(int(np.ceil(np.log10(max(n, 1)))), 1)
        cap = cv2.VideoCapture(str(vpath))
        for i in picked:
            cap.set(cv2.CAP_PROP_POS_FRAMES, int(i))
            ok, frame = cap.read()
            if not ok:
                continue
            if crop_box:
                x0, x1, y0, y1 = crop_box
                frame = frame[y0:y1, x0:x1]
            cv2.imwrite(str(dest / f"img{int(i):0{pad}d}.png"), frame)
        cap.release()
        out[str(vpath)] = picked
        print(f"extracted {len(picked)} frames from {vpath.name} -> {dest}")
    return out

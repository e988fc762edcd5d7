"""Video reading on OpenCV (RGB uint8 frames).

The port's own copy of ``deepgraphpose_tpu/data/video.py:30-186``:

* :class:`VideoReader`: sequential and random access;
* :class:`FrameCache`: the training frames decoded once into an in-memory
  JPEG cache, so the train loop never seeks the container again;
* :func:`motion_energy`: mean |frame_t - frame_{t-1}| per frame in one
  streaming pass (ref: dataset.py:29-43);
* :func:`write_video` (RGB frames to a file through ``cv2.VideoWriter``)
  and the transcodes :func:`shorten_video`, :func:`downsample_video`,
  :func:`crop_video` (``deepgraphpose_tpu/data/video.py:187-252``).

``cv2`` is imported where a reader opens or a frame is coded, so the module
imports on a host without OpenCV. ``FrameCache.get_batch`` decodes a batch
of cached frames with the native libjpeg decoder (``native/``, threaded)
where it builds, and frame by frame with OpenCV otherwise or where a frame
is not cached.
"""

from __future__ import annotations

import threading
from pathlib import Path

import numpy as np


class VideoReader:
    """Sequential/random video frame reader (RGB uint8 output)."""

    def __init__(self, path: str | Path):
        import cv2

        self._cv2 = cv2
        self.path = str(path)
        self._cap = cv2.VideoCapture(self.path)
        if not self._cap.isOpened():
            raise FileNotFoundError(f"cannot open video {path}")
        self.fps = float(self._cap.get(cv2.CAP_PROP_FPS)) or 30.0
        self.n_frames = int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self.width = int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        self._pos = 0
        self._lock = threading.Lock()

    @property
    def duration(self) -> float:
        return self.n_frames / self.fps if self.fps else 0.0

    def read_frame(self, index: int) -> np.ndarray:
        """Random-access read of one frame (RGB)."""
        cv2 = self._cv2
        with self._lock:
            if index != self._pos:
                self._cap.set(cv2.CAP_PROP_POS_FRAMES, index)
            ok, frame = self._cap.read()
            if not ok:
                raise IndexError(f"frame {index} not readable in {self.path}")
            self._pos = index + 1
        return cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)

    def read_frames(self, indices) -> np.ndarray:
        """Batch random-access read; sorts internally to minimize seeks."""
        indices = np.asarray(indices)
        order = np.argsort(indices)
        out = [None] * len(indices)
        for k in order:
            out[k] = self.read_frame(int(indices[k]))
        return np.stack(out)

    def iter_frames(self, start: int = 0, stop: int | None = None):
        """Sequential iteration (fast path, no seeks)."""
        cv2 = self._cv2
        with self._lock:
            if start != self._pos:
                self._cap.set(cv2.CAP_PROP_POS_FRAMES, start)
                self._pos = start
            i = start
            while stop is None or i < stop:
                ok, frame = self._cap.read()
                if not ok:
                    break
                self._pos = i + 1
                yield i, cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                i += 1

    def close(self):
        self._cap.release()


def iter_frame_batches(reader: VideoReader, batch_size: int,
                       n_frames: int | None = None):
    """Yield (start_index, (b<=batch_size, H, W, 3) uint8) chunks.

    Containers often over-report the frame count; the trailing partial
    buffer is flushed even when the decoder stops early, so callers size
    outputs by what was yielded.
    """
    n = min(reader.n_frames, n_frames) if n_frames else reader.n_frames
    buf, start = [], 0
    for _, frame in reader.iter_frames(0, n):
        buf.append(frame)
        if len(buf) == batch_size:
            yield start, np.stack(buf)
            start += len(buf)
            buf = []
    if buf:
        yield start, np.stack(buf)


class FrameCache:
    """Decode-once JPEG cache for a fixed frame subset."""

    def __init__(self, reader: VideoReader, indices, quality: int = 95):
        import cv2

        self.reader = reader
        self._jpegs: dict[int, bytes] = {}
        self._shape = None
        want = sorted(set(int(i) for i in indices))
        want_set = set(want)
        self.nbytes = 0
        if not want:
            return
        # one sequential pass over [min, max]
        enc = [int(cv2.IMWRITE_JPEG_QUALITY), quality]
        for i, frame in reader.iter_frames(want[0], want[-1] + 1):
            if i in want_set:
                ok, buf = cv2.imencode(".jpg", frame[..., ::-1], enc)
                if ok:
                    self._jpegs[i] = buf.tobytes()
                    if self._shape is None:
                        self._shape = frame.shape
        self.nbytes = sum(len(b) for b in self._jpegs.values())

    def __contains__(self, index: int) -> bool:
        return int(index) in self._jpegs

    def get(self, index: int) -> np.ndarray:
        import cv2

        buf = self._jpegs.get(int(index))
        if buf is None:
            return self.reader.read_frame(int(index))
        img = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)

    def get_batch(self, indices) -> np.ndarray:
        """Batch fetch; uses the native multithreaded JPEG decoder
        (``native/``) when every index is cached, else OpenCV a frame."""
        idxs = [int(i) for i in indices]
        if self._shape is not None and all(i in self._jpegs for i in idxs):
            from deepgraphpose_tpu_torch import native

            h, w = self._shape[:2]
            out = native.decode_jpeg_batch(
                [self._jpegs[i] for i in idxs], h, w)
            if out is not None:
                return out
        return np.stack([self.get(i) for i in idxs])


def motion_energy(path: str | Path, resize_to: int | None = 256) -> np.ndarray:
    """Per-frame mean |frame diff| in one streaming pass.

    ref: dataset.py:29-43 (calculate_motion_energy). Downscaling before the
    diff changes only the ranking granularity; ``resize_to=None`` keeps the
    full frames.
    """
    import cv2

    reader = VideoReader(path)
    me = np.zeros(max(reader.n_frames, 1), dtype=np.float64)
    prev = None
    last = 0
    for i, frame in reader.iter_frames():
        if resize_to is not None and max(frame.shape[:2]) > resize_to:
            s = resize_to / max(frame.shape[:2])
            frame = cv2.resize(frame, (max(1, int(frame.shape[1] * s)),
                                       max(1, int(frame.shape[0] * s))))
        f = frame.astype(np.float32)
        if prev is not None:
            if i >= len(me):
                me = np.resize(me, i + 1)
            me[i] = float(np.mean(np.abs(f - prev)))
        prev = f
        last = i
    reader.close()
    return me[:last + 1]


def _transcode(src: str | Path, dst: str | Path, frame_fn,
               start_s: float = 0.0, stop_s: float | None = None) -> Path:
    reader = VideoReader(src)
    try:
        start = int(start_s * reader.fps)
        stop = int(stop_s * reader.fps) if stop_s is not None else None
        first = frame_fn(reader.read_frame(start))
        write_video(dst,
                    (frame_fn(f) for _, f in reader.iter_frames(start, stop)),
                    reader.fps, (first.shape[1], first.shape[0]))
    finally:
        reader.close()
    return Path(dst)


def shorten_video(vname: str | Path, start_s: float = 1.0,
                  stop_s: float = 60.0, outsuffix: str = "short",
                  outpath: str | Path | None = None) -> Path:
    """Clip [start_s, stop_s) to a new file
    (ref: auxfun_videos.py:27-70 ShortenVideo, ffmpeg there)."""
    vname = Path(vname)
    out = Path(outpath or vname.parent) / f"{vname.stem}{outsuffix}.mp4"
    return _transcode(vname, out, lambda f: f, start_s, stop_s)


def downsample_video(vname: str | Path, width: int = -1, height: int = 200,
                     outsuffix: str = "downsampled",
                     outpath: str | Path | None = None) -> Path:
    """Spatially downsample, preserving aspect when one dim is -1
    (ref: auxfun_videos.py:72-115 DownSampleVideo)."""
    import cv2

    vname = Path(vname)
    out = Path(outpath or vname.parent) / f"{vname.stem}{outsuffix}.mp4"

    def fn(frame):
        h, w = frame.shape[:2]
        tw = width if width > 0 else int(round(w * height / h))
        th = height if height > 0 else int(round(h * width / w))
        return cv2.resize(frame, (tw, th))

    return _transcode(vname, out, fn)


def crop_video(vname: str | Path, x0: int, x1: int, y0: int, y1: int,
               outsuffix: str = "cropped",
               outpath: str | Path | None = None) -> Path:
    """Spatial crop to [y0:y1, x0:x1] (ref: auxfun_videos CropVideo role)."""
    vname = Path(vname)
    out = Path(outpath or vname.parent) / f"{vname.stem}{outsuffix}.mp4"
    return _transcode(vname, out, lambda f: f[y0:y1, x0:x1])


def write_video(path: str | Path, frames_iter, fps: float,
                frame_size_wh: tuple[int, int], fourcc: str = "mp4v") -> int:
    """Write RGB frames to a video file; returns the frame count."""
    import cv2

    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), fps,
                         frame_size_wh)
    n = 0
    try:
        for frame in frames_iter:
            wr.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
            n += 1
    finally:
        wr.release()
    return n

"""Video reading on OpenCV (RGB uint8 frames).

The port's own copy of ``deepgraphpose_tpu/data/video.py:30-110``. ``cv2``
is imported when a reader opens, so the module imports on a host without
OpenCV.
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

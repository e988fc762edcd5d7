"""Dense optical flow for the temporal clique (host side, OpenCV).

The port's own copy of ``deepgraphpose_tpu/data/flow.py``. ref:
src/deepgraphpose/models/fitdgp_util.py:454-467 (learn_wt): Farneback flow
between consecutive batch frames, |flow_x| + |flow_y| per pixel. The clique
consumes it on the device through summed-area tables (ops/cliques.py).
``cv2`` is imported where the flow is computed.
"""

from __future__ import annotations

import numpy as np


def flow_magnitude(frame0: np.ndarray, frame1: np.ndarray) -> np.ndarray:
    """|fx| + |fy| Farneback flow between two RGB uint8 frames."""
    import cv2

    g0 = cv2.cvtColor(frame0, cv2.COLOR_RGB2GRAY)
    g1 = cv2.cvtColor(frame1, cv2.COLOR_RGB2GRAY)
    flow = cv2.calcOpticalFlowFarneback(
        g0, g1, None, pyr_scale=0.5, levels=3, winsize=15, iterations=3,
        poly_n=5, poly_sigma=1.2, flags=0)
    return np.abs(flow[..., 0]) + np.abs(flow[..., 1])


def flow_magnitude_sequence(frames: np.ndarray) -> np.ndarray:
    """(T, H, W, 3) uint8 -> (T-1, H, W) float32 flow magnitudes."""
    t = frames.shape[0]
    if t < 2:
        return np.zeros((0, frames.shape[1], frames.shape[2]), np.float32)
    out = np.empty((t - 1, frames.shape[1], frames.shape[2]), np.float32)
    for i in range(t - 1):
        out[i] = flow_magnitude(frames[i], frames[i + 1])
    return out

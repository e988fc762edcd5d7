"""Trajectory post-processing filters.

Counterpart of ``deepgraphpose_tpu/evaluation/filtering.py`` (ref:
deeplabcut/post_processing/filtering.py:26-160 filterpredictions: 'median'
via scipy.signal.medfilt, 'arima' via statsmodels SARIMAX). statsmodels is
absent, so the state-space option is a constant-velocity Kalman smoother
(RTS) with the measurement noise inflated where the likelihood is below
pcutoff; 'arima' and 'spline' run it, as in the JAX package. Host numpy.

Output contract per video: ``<vname><scorer>filtered.h5`` (+ .csv), the
layout of the unfiltered file (ref: auxiliaryfunctions.py:380-396
CheckifPostProcessing).
"""


from __future__ import annotations

from pathlib import Path

import numpy as np


def median_filter(x: np.ndarray, windowlength: int = 5) -> np.ndarray:
    """Per-column odd-window median filter (ref: filtering.py:120-121)."""
    from scipy import signal

    if windowlength % 2 == 0:
        windowlength += 1
    out = np.asarray(x, np.float64).copy()
    for j in range(out.shape[1]):
        out[:, j] = signal.medfilt(out[:, j], kernel_size=windowlength)
    return out


def kalman_smooth(xy: np.ndarray, likelihood: np.ndarray,
                  pcutoff: float = 0.4, process_std: float = 1.0,
                  meas_std: float = 2.0, uncertain_scale: float = 100.0
                  ) -> np.ndarray:
    """Constant-velocity Kalman + RTS smoother over one joint's (T, 2) track.

    Low-likelihood measurements get their noise scaled by
    ``uncertain_scale`` so the dynamics carry the trajectory through them
    (reference analog: SARIMAX treats sub-pcutoff samples as missing,
    ref: outlier_frames.py:209-227).
    """
    T = xy.shape[0]
    # state: [x, y, vx, vy]
    F = np.eye(4)
    F[0, 2] = F[1, 3] = 1.0
    Q = np.diag([0.25, 0.25, 1.0, 1.0]) * process_std ** 2
    H = np.zeros((2, 4))
    H[0, 0] = H[1, 1] = 1.0

    x_f = np.zeros((T, 4))
    P_f = np.zeros((T, 4, 4))
    x_p = np.zeros((T, 4))
    P_p = np.zeros((T, 4, 4))

    first = np.flatnonzero(np.isfinite(xy[:, 0]))
    x0 = xy[first[0]] if first.size else np.zeros(2)
    state = np.array([x0[0], x0[1], 0.0, 0.0])
    P = np.eye(4) * 100.0
    for t in range(T):
        if t > 0:
            state = F @ state
            P = F @ P @ F.T + Q
        x_p[t], P_p[t] = state, P
        z = xy[t]
        if np.all(np.isfinite(z)):
            r = meas_std ** 2
            if likelihood is not None and likelihood[t] < pcutoff:
                r *= uncertain_scale
            S = H @ P @ H.T + np.eye(2) * r
            K = P @ H.T @ np.linalg.inv(S)
            state = state + K @ (z - H @ state)
            P = (np.eye(4) - K @ H) @ P
        x_f[t], P_f[t] = state, P

    # RTS backward pass
    xs = x_f.copy()
    Ps = P_f.copy()
    for t in range(T - 2, -1, -1):
        C = P_f[t] @ F.T @ np.linalg.inv(P_p[t + 1])
        xs[t] = x_f[t] + C @ (xs[t + 1] - x_p[t + 1])
        Ps[t] = P_f[t] + C @ (Ps[t + 1] - P_p[t + 1]) @ C.T
    return xs[:, :2]


def filter_pose_arrays(labels: dict, filtertype: str = "median",
                       windowlength: int = 5, pcutoff: float = 0.4) -> dict:
    """Filter an {'x','y','likelihoods'} dict of (T, nj) arrays."""
    x, y = np.asarray(labels["x"], np.float64), np.asarray(labels["y"],
                                                           np.float64)
    lik = np.asarray(labels["likelihoods"], np.float64)
    if filtertype == "median":
        return {"x": median_filter(x, windowlength),
                "y": median_filter(y, windowlength), "likelihoods": lik}
    if filtertype in ("kalman", "arima", "spline"):
        xo, yo = x.copy(), y.copy()
        for j in range(x.shape[1]):
            sm = kalman_smooth(np.stack([x[:, j], y[:, j]], -1), lik[:, j],
                               pcutoff)
            xo[:, j], yo[:, j] = sm[:, 0], sm[:, 1]
        return {"x": xo, "y": yo, "likelihoods": lik}
    raise ValueError(f"unknown filtertype {filtertype!r} (median|kalman)")


def filterpredictions(config: str | Path, videos: list, shuffle: int = 1,
                      trainingsetindex: int = 0, filtertype: str = "median",
                      windowlength: int = 5, save_as_csv: bool = True,
                      destfolder: str | Path | None = None,
                      scorer: str | None = None) -> list[Path]:
    """Filter analyze_videos outputs; writes <vname><scorer>filtered.h5."""
    from deepgraphpose_tpu_torch.core.config import ProjectConfig
    from deepgraphpose_tpu_torch.infer.export import (export_pose_like_dlc,
                                                      read_pose_table)

    config = Path(config)
    proj = ProjectConfig.from_yaml(config)
    written = []
    for video in videos:
        video = Path(video)
        folder = Path(destfolder) if destfolder else video.parent
        if scorer is not None:
            candidates = [folder / f"{video.stem}{scorer}.h5"]
        else:
            candidates = sorted(folder.glob(f"{video.stem}DLC_*.h5")) + \
                sorted(folder.glob(f"{video.stem}DeepCut_*.h5"))
            candidates = [c for c in candidates
                          if not c.stem.endswith("filtered")]
        if not candidates or not candidates[-1].exists():
            print(f"no analysis found for {video.stem} in {folder}; run "
                  "analyze_videos first")
            continue
        src = candidates[-1]
        sc, bodyparts, labels, _ = read_pose_table(src)
        filt = filter_pose_arrays(labels, filtertype, windowlength,
                                  proj.pcutoff)
        dst = folder / (src.stem + "filtered.h5")
        export_pose_like_dlc(filt, sc, bodyparts,
                             str(dst.with_suffix("")))
        if not save_as_csv:
            dst.with_suffix(".csv").unlink(missing_ok=True)
        written.append(dst)
        print(f"filtered {src.name} -> {dst.name} ({filtertype})")
    return written

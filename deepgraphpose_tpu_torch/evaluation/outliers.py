"""Outlier-frame extraction for the active-learning refinement loop.

Counterpart of ``deepgraphpose_tpu/evaluation/outliers.py`` (ref:
deeplabcut/refine_training_dataset/outlier_frames.py:24-196
extract_outlier_frames). Three criteria over an analyzed video's
trajectories:

* 'uncertain': any bodypart likelihood < p_bound (ref: :147);
* 'jump': any bodypart moves more than epsilon px between consecutive
  frames (ref: :150-155);
* 'fitting': the mean deviation from a state-space fit exceeds epsilon px;
  the reference fits SARIMAX per coordinate (:209-243), here the
  constant-velocity Kalman smoother of ``evaluation.filtering`` does.

The picked frames are written as PNGs into labeled-data/<video>/ beside a
``machinelabels-iter<N>.h5/.csv`` of the machine predictions. Host numpy
and OpenCV.
"""


from __future__ import annotations

from pathlib import Path

import numpy as np

from deepgraphpose_tpu_torch.core.config import ProjectConfig
from deepgraphpose_tpu_torch.evaluation.filtering import kalman_smooth


def outlier_frame_indices(labels: dict, algorithm: str = "jump",
                          epsilon: float = 20.0, p_bound: float = 0.01,
                          pcutoff: float = 0.4) -> np.ndarray:
    """Frame indices flagged by the chosen criterion.

    ``labels``: {'x','y','likelihoods'} of (T, nj) arrays.
    """
    x = np.asarray(labels["x"], np.float64)
    y = np.asarray(labels["y"], np.float64)
    lik = np.asarray(labels["likelihoods"], np.float64)
    if algorithm == "uncertain":
        return np.flatnonzero((lik < p_bound).any(axis=1))
    if algorithm == "jump":
        dx = np.diff(x, axis=0)
        dy = np.diff(y, axis=0)
        jump = (dx ** 2 + dy ** 2) > epsilon ** 2
        return np.flatnonzero(jump.any(axis=1)) + 1
    if algorithm == "fitting":
        dev = np.zeros_like(x)
        for j in range(x.shape[1]):
            sm = kalman_smooth(np.stack([x[:, j], y[:, j]], -1),
                               lik[:, j], pcutoff)
            dev[:, j] = np.hypot(x[:, j] - sm[:, 0], y[:, j] - sm[:, 1])
        return np.flatnonzero(dev.mean(axis=1) > epsilon)
    raise ValueError(
        f"unknown algorithm {algorithm!r} (uncertain|jump|fitting)")


def extract_outlier_frames(config: str | Path, videos: list,
                           shuffle: int = 1, trainingsetindex: int = 0,
                           outlieralgorithm: str = "jump",
                           epsilon: float = 20.0, p_bound: float = 0.01,
                           extractionalgorithm: str = "uniform",
                           numframes2pick: int | None = None,
                           scorer: str | None = None,
                           destfolder: str | Path | None = None,
                           seed: int = 42) -> dict[str, np.ndarray]:
    """Flag outliers in analyzed videos + extract a subsample for labeling.

    Returns {video: extracted frame indices}. Requires analyze_videos to
    have produced <vname><scorer>.h5 next to each video (or in destfolder).
    """
    import cv2

    from deepgraphpose_tpu_torch.infer.export import (read_pose_table,
                                                      write_pose_h5)

    config = Path(config)
    proj = ProjectConfig.from_yaml(config)
    project_path = Path(proj.project_path or config.parent)
    n_pick = numframes2pick or proj.numframes2pick
    out: dict[str, np.ndarray] = {}

    for video in videos:
        video = Path(video)
        folder = Path(destfolder) if destfolder else video.parent
        if scorer is not None:
            candidates = [folder / f"{video.stem}{scorer}.h5"]
        else:
            candidates = [c for c in
                          sorted(folder.glob(f"{video.stem}DLC_*.h5"))
                          if not c.stem.endswith("filtered")]
        if not candidates or not candidates[-1].exists():
            print(f"no analysis for {video.stem}; run analyze_videos first")
            continue
        sc, bps, labels, _ = read_pose_table(candidates[-1])
        flagged = outlier_frame_indices(labels, outlieralgorithm, epsilon,
                                        p_bound, proj.pcutoff)
        print(f"{video.stem}: {len(flagged)} outlier frames "
              f"({outlieralgorithm})")
        if flagged.size == 0:
            out[str(video)] = flagged
            continue

        if len(flagged) > n_pick:
            if extractionalgorithm == "uniform":
                picked = flagged[np.unique(
                    np.linspace(0, len(flagged) - 1, n_pick).astype(int))]
            else:  # kmeans over the flagged frames' trajectories
                from sklearn.cluster import MiniBatchKMeans

                feats = np.concatenate(
                    [labels["x"][flagged], labels["y"][flagged]], axis=1)
                feats = np.nan_to_num(feats)
                km = MiniBatchKMeans(n_clusters=n_pick, n_init=3,
                                     random_state=seed).fit(feats)
                picked = []
                for ci in range(n_pick):
                    members = np.flatnonzero(km.labels_ == ci)
                    if members.size:
                        picked.append(int(flagged[members[0]]))
                picked = np.unique(picked)
        else:
            picked = flagged

        dest = project_path / "labeled-data" / video.stem
        dest.mkdir(parents=True, exist_ok=True)
        cap = cv2.VideoCapture(str(video))
        n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        pad = max(int(np.ceil(np.log10(max(n, 1)))), 1)
        image_paths = []
        for i in picked:
            cap.set(cv2.CAP_PROP_POS_FRAMES, int(i))
            ok, frame = cap.read()
            if not ok:
                continue
            name = f"img{int(i):0{pad}d}.png"
            cv2.imwrite(str(dest / name), frame)
            image_paths.append(f"labeled-data/{video.stem}/{name}")

        # machine predictions for the picked frames, for refinement
        picked_labels = {
            "x": labels["x"][picked], "y": labels["y"][picked],
            "likelihoods": labels["likelihoods"][picked]}
        mfile = dest / f"machinelabels-iter{proj.iteration}.h5"
        write_pose_h5(mfile, sc, bps, picked_labels, index=image_paths)
        with open(mfile.with_suffix(".csv"), "w") as f:
            f.write("scorer," + ",".join([sc] * 3 * len(bps)) + "\n")
            f.write("bodyparts," + ",".join(
                [bp for bp in bps for _ in range(3)]) + "\n")
            f.write("coords," + ",".join(["x", "y", "likelihood"]
                                         * len(bps)) + "\n")
            for ip, xi, yi, li in zip(image_paths, picked_labels["x"],
                                      picked_labels["y"],
                                      picked_labels["likelihoods"]):
                row = np.empty(3 * len(bps))
                row[0::3], row[1::3], row[2::3] = xi, yi, li
                f.write(ip + "," + ",".join(repr(float(v))
                                            for v in row) + "\n")
        print(f"extracted {len(picked)} frames -> {dest}")
        out[str(video)] = np.asarray(picked)
    return out

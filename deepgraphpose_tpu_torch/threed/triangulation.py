"""Stereo triangulation of tracked keypoints.

The port's own copy of ``deepgraphpose_tpu/threed/triangulation.py``: host
code (numpy, OpenCV), no model and no device.

ref: deeplabcut/pose_estimation_3d/triangulation.py:24-292 (triangulate) and
294-361 (undistort_points): undistort each camera's 2-D trajectories, then
linear (DLT/SVD) triangulation per frame x joint, masking points whose
likelihood in either view falls below pcutoff.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from deepgraphpose_tpu_torch.threed.calibration import CameraSystem


def undistort_points(pts_xy: np.ndarray, K: np.ndarray, dist: np.ndarray,
                     P: np.ndarray | None = None) -> np.ndarray:
    """Undistort (..., 2) pixel points; reprojects through P (or K) so the
    output stays in pixel coordinates (ref: triangulation.py:294-361)."""
    import cv2

    shape = pts_xy.shape
    pts = np.ascontiguousarray(pts_xy.reshape(-1, 1, 2), np.float64)
    finite = np.isfinite(pts).all(axis=(1, 2))
    out = np.full_like(pts, np.nan)
    if finite.any():
        # cv2.undistortPoints accepts 3x4 P directly; never truncate it
        # (dropping the translation column would silently shift the points)
        und = cv2.undistortPoints(pts[finite], K, dist,
                                  P=P if P is not None else K)
        out[finite] = und
    return out.reshape(shape)


def triangulate_points(P1: np.ndarray, P2: np.ndarray, pts1: np.ndarray,
                       pts2: np.ndarray) -> np.ndarray:
    """DLT triangulation: (..., 2) pixel points in two views -> (..., 3).

    NaN inputs produce NaN outputs. Uses cv2.triangulatePoints (SVD DLT)
    over the finite subset.
    """
    import cv2

    shape = pts1.shape[:-1]
    a = pts1.reshape(-1, 2).T.astype(np.float64)   # (2, n)
    b = pts2.reshape(-1, 2).T.astype(np.float64)
    finite = np.isfinite(a).all(axis=0) & np.isfinite(b).all(axis=0)
    out = np.full((a.shape[1], 3), np.nan)
    if finite.any():
        X = cv2.triangulatePoints(P1, P2, a[:, finite], b[:, finite])
        out[finite] = (X[:3] / X[3]).T
    return out.reshape(*shape, 3)


def triangulate(config3d: str | Path, h5_cam1: str | Path,
                h5_cam2: str | Path, pcutoff: float | None = None,
                destfolder: str | Path | None = None,
                output_name: str | None = None) -> dict:
    """Triangulate two analyzed videos' trajectory tables into 3-D.

    Reads the package's pose .h5 files (infer.export layout), returns
    {'xyz': (T, nj, 3), 'bodyparts': [...]} and writes
    ``<output_name>_3d.h5`` (+ .csv) when destfolder is given or derivable.
    """
    import yaml

    from deepgraphpose_tpu_torch.infer.export import read_pose_table

    config3d = Path(config3d)
    with open(config3d) as f:
        cfg = yaml.safe_load(f)
    root = Path(cfg.get("project_path", config3d.parent))
    if pcutoff is None:
        pcutoff = float(cfg.get("pcutoff", 0.4))
    names = cfg["camera_names"]
    system = CameraSystem.load(root / "camera_matrix" /
                               "stereo_params.pickle")

    _, bps1, lab1, _ = read_pose_table(h5_cam1)
    _, bps2, lab2, _ = read_pose_table(h5_cam2)
    if bps1 != bps2:
        raise ValueError(f"bodyparts differ between views: {bps1} vs {bps2}")
    T = min(lab1["x"].shape[0], lab2["x"].shape[0])

    def pts(lab):
        return np.stack([lab["x"][:T], lab["y"][:T]], axis=-1)

    p1 = pts(lab1).astype(np.float64)
    p2 = pts(lab2).astype(np.float64)
    mask = ((lab1["likelihoods"][:T] < pcutoff)
            | (lab2["likelihoods"][:T] < pcutoff))
    p1[mask] = np.nan
    p2[mask] = np.nan

    n1, n2 = names[0], names[1]
    u1 = undistort_points(p1, system.K[n1], system.dist[n1], system.K[n1])
    # view-2 points go to view-2 pixel coords (P2 already contains K2)
    u2 = undistort_points(p2, system.K[n2], system.dist[n2], system.K[n2])
    xyz = triangulate_points(system.P[n1], system.P[n2], u1, u2)

    result = {"xyz": xyz, "bodyparts": bps1,
              "likelihood_mask": ~mask}
    out_dir = Path(destfolder) if destfolder else Path(h5_cam1).parent
    out_dir.mkdir(parents=True, exist_ok=True)
    stem = output_name or (Path(h5_cam1).stem + "_"
                           + cfg.get("scorername_3d", "DGP_3D"))
    _write_xyz(out_dir / f"{stem}_3d", bps1, xyz)
    return result


def _write_xyz(path_stem: Path, bodyparts: list, xyz: np.ndarray) -> None:
    """CSV + h5 of (T, nj, 3), MultiIndex-style header (scorer row elided)."""
    import h5py

    T, nj, _ = xyz.shape
    with open(str(path_stem) + ".csv", "w") as f:
        f.write("bodyparts," + ",".join(
            bp for bp in bodyparts for _ in range(3)) + "\n")
        f.write("coords," + ",".join(["x", "y", "z"] * nj) + "\n")
        for i in range(T):
            f.write(str(i) + "," + ",".join(
                repr(float(v)) for v in xyz[i].reshape(-1)) + "\n")
    with h5py.File(str(path_stem) + ".h5", "w") as f:
        g = f.create_group("df_with_missing_3d")
        g.create_dataset("xyz", data=xyz)
        g.create_dataset("bodyparts", data=np.array(bodyparts, dtype="S"))

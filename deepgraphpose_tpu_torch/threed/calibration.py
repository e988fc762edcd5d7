"""Stereo camera calibration from checkerboard images.

The port's own copy of ``deepgraphpose_tpu/threed/calibration.py``: host
code (numpy, OpenCV), no model and no device.

ref: deeplabcut/pose_estimation_3d/camera_calibration.py:27-181
(calibrate_cameras): per-camera intrinsics via cv2.calibrateCamera, then
stereo extrinsics + rectification via cv2.stereoCalibrate /
cv2.stereoRectify, persisted per camera pair. The detection step is
separated from the solve (calibrate_stereo) so the geometry is unit-testable
with synthetic projections.
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np


@dataclass
class CameraSystem:
    """Calibrated stereo pair (all arrays are numpy float64)."""

    camera_names: list
    K: dict = field(default_factory=dict)          # name -> (3, 3) intrinsics
    dist: dict = field(default_factory=dict)       # name -> (1, k) distortion
    R: np.ndarray | None = None                    # cam1 -> cam2 rotation
    T: np.ndarray | None = None                    # cam1 -> cam2 translation
    P: dict = field(default_factory=dict)          # name -> (3, 4) projection
    image_size: tuple | None = None
    rms: float = 0.0

    def save(self, path: str | Path) -> None:
        with open(path, "wb") as f:
            pickle.dump(self, f)

    @classmethod
    def load(cls, path: str | Path) -> "CameraSystem":
        with open(path, "rb") as f:
            return pickle.load(f)


def checkerboard_object_points(cbrow: int, cbcol: int,
                               square_size: float = 1.0) -> np.ndarray:
    """(cbrow*cbcol, 3) planar grid in checkerboard coordinates."""
    objp = np.zeros((cbrow * cbcol, 3), np.float32)
    objp[:, :2] = np.mgrid[0:cbcol, 0:cbrow].T.reshape(-1, 2) * square_size
    return objp


def detect_checkerboard(image, cbrow: int = 8, cbcol: int = 6):
    """Sub-pixel checkerboard corners or None
    (ref: camera_calibration.py:77-96)."""
    import cv2

    gray = image if image.ndim == 2 else cv2.cvtColor(image,
                                                      cv2.COLOR_BGR2GRAY)
    ok, corners = cv2.findChessboardCorners(
        gray, (cbcol, cbrow),
        cv2.CALIB_CB_ADAPTIVE_THRESH + cv2.CALIB_CB_NORMALIZE_IMAGE)
    if not ok:
        return None
    criteria = (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 30,
                0.001)
    return cv2.cornerSubPix(gray, corners, (11, 11), (-1, -1), criteria)


def calibrate_stereo(objpoints: list, imgpoints1: list, imgpoints2: list,
                     image_size: tuple, camera_names: list | None = None
                     ) -> CameraSystem:
    """Intrinsics per camera + stereo extrinsics + projection matrices.

    Args are per-view lists: objpoints[i] (n, 3) board points, imgpoints*[i]
    (n, 1, 2) detected corners in each camera. image_size is (w, h).
    """
    import cv2

    names = camera_names or ["camera-1", "camera-2"]
    objpoints = [np.asarray(o, np.float32) for o in objpoints]
    imgpoints1 = [np.asarray(p, np.float32) for p in imgpoints1]
    imgpoints2 = [np.asarray(p, np.float32) for p in imgpoints2]

    _, K1, d1, _, _ = cv2.calibrateCamera(objpoints, imgpoints1, image_size,
                                          None, None)
    _, K2, d2, _, _ = cv2.calibrateCamera(objpoints, imgpoints2, image_size,
                                          None, None)
    rms, K1, d1, K2, d2, R, T, _, _ = cv2.stereoCalibrate(
        objpoints, imgpoints1, imgpoints2, K1, d1, K2, d2, image_size,
        flags=cv2.CALIB_FIX_INTRINSIC)

    # projection matrices in cam1's frame (ref: triangulation undistorts to
    # normalized coords first, then uses P1 = [I|0], P2 = [R|T]; keeping K
    # in P lets triangulate_points consume raw pixel coords too)
    P1 = K1 @ np.hstack([np.eye(3), np.zeros((3, 1))])
    P2 = K2 @ np.hstack([R, T.reshape(3, 1)])
    return CameraSystem(camera_names=list(names),
                        K={names[0]: K1, names[1]: K2},
                        dist={names[0]: d1, names[1]: d2},
                        R=R, T=T, P={names[0]: P1, names[1]: P2},
                        image_size=tuple(image_size), rms=float(rms))


def calibrate_cameras(config3d: str | Path, cbrow: int = 8, cbcol: int = 6,
                      calibrate: bool = True, square_size: float = 1.0
                      ) -> CameraSystem | None:
    """Calibrate from ``calibration_images/<camera>-*.jpg|png`` pairs under
    the 3-D project (ref: camera_calibration.py:27-181). Writes
    ``camera_matrix/stereo_params.pickle``."""
    import cv2
    import yaml

    config3d = Path(config3d)
    with open(config3d) as f:
        cfg = yaml.safe_load(f)
    root = Path(cfg.get("project_path", config3d.parent))
    names = cfg["camera_names"]
    img_dir = root / "calibration_images"

    per_cam: dict[str, dict[str, np.ndarray]] = {n: {} for n in names}
    size = None
    for n in names:
        for p in sorted(list(img_dir.glob(f"{n}-*.jpg"))
                        + list(img_dir.glob(f"{n}-*.png"))):
            img = cv2.imread(str(p))
            if img is None:
                continue
            size = (img.shape[1], img.shape[0])
            corners = detect_checkerboard(img, cbrow, cbcol)
            if corners is None:
                print(f"no checkerboard in {p.name}")
                continue
            # pair key = image id after the '<camera-name>-' prefix
            key = p.stem[len(n) + 1:]
            per_cam[n][key] = corners
    common = sorted(set.intersection(*[set(per_cam[n]) for n in names]))
    if not common:
        print("no image pairs with detected checkerboards")
        return None
    print(f"calibrating from {len(common)} image pairs")
    if not calibrate:
        return None

    objp = checkerboard_object_points(cbrow, cbcol, square_size)
    system = calibrate_stereo(
        [objp] * len(common),
        [per_cam[names[0]][k] for k in common],
        [per_cam[names[1]][k] for k in common], size, names)
    out_dir = root / "camera_matrix"
    out_dir.mkdir(exist_ok=True)
    system.save(out_dir / "stereo_params.pickle")
    print(f"stereo calibration RMS {system.rms:.4f} px -> "
          f"{out_dir / 'stereo_params.pickle'}")
    return system


def create_new_project_3d(project: str, experimenter: str,
                          working_directory: str | None = None,
                          num_cameras: int = 2,
                          date: str | None = None) -> str:
    """3-D project skeleton + config (ref: create_project/new_3d.py)."""
    from datetime import datetime

    import yaml

    dt = (datetime.strptime(date, "%Y-%m-%d") if date
          else datetime.today())
    iso = dt.strftime("%Y-%m-%d")
    wd = Path(working_directory or ".").resolve()
    root = wd / f"{project}-{experimenter}-{iso}-3d"
    if root.exists():
        print(f'Project "{root}" already exists!')
        return str(root / "config.yaml")
    for sub in ("calibration_images", "camera_matrix", "corners",
                "undistortion"):
        (root / sub).mkdir(parents=True)
    names = [f"camera-{i + 1}" for i in range(num_cameras)]
    cfg = dict(
        Task=project, scorer=experimenter, date=iso,
        project_path=str(root), camera_names=names,
        camera_pairs=[[names[0], names[1]]] if num_cameras >= 2 else [],
        pcutoff=0.4, scorername_3d="DGP_3D",
        skeleton=[], skeleton_color="black",
        config_file_camera1="", config_file_camera2="",
        shuffle_camera1=1, shuffle_camera2=1,
    )
    with open(root / "config.yaml", "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    print(f'Generated 3-D project "{root}"')
    return str(root / "config.yaml")

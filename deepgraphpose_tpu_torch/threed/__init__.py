"""Stereo 3-D pose estimation.

The port's own copy of ``deepgraphpose_tpu/threed/__init__.py``: host code
(numpy, OpenCV), no model and no device.

Capability parity with the reference's pose_estimation_3d package
(ref: deeplabcut/pose_estimation_3d/{camera_calibration,triangulation,
plotting3D}.py): checkerboard stereo calibration, point undistortion, DLT
triangulation of two cameras' trajectories, and 3-D trajectory export.
All host-side (OpenCV + numpy): geometry, not device compute.
"""

from deepgraphpose_tpu_torch.threed.calibration import (CameraSystem,
                                                        calibrate_cameras,
                                                        calibrate_stereo,
                                                        create_new_project_3d,
                                                        detect_checkerboard)
from deepgraphpose_tpu_torch.threed.triangulation import (triangulate,
                                                          triangulate_points,
                                                          undistort_points)

__all__ = [
    "CameraSystem", "calibrate_cameras", "calibrate_stereo",
    "create_new_project_3d", "detect_checkerboard", "triangulate",
    "triangulate_points", "undistort_points",
]

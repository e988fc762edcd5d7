"""The port's 3-D layer (``deepgraphpose_tpu_torch/threed/``) against the
JAX package's, on the CPU.

The cases mirror ``tests/test_threed.py``: the same synthetic stereo
pair, board views and trajectories go through both packages, whose
results agree within 1e-9 relative (both are OpenCV and numpy in
float64), and the port meets the reference test's own bounds. OpenCV
runs on one thread here: its threaded calibration sums in a varying
order, and two calls of either package on the same corners then part by
more than the 1e-9 these cases hold (one thread repeats exactly). The
checkerboard views for ``calibrate_cameras`` are rendered by
``chip_smoke.checkerboard_views``, which the card's workflow phase also
calibrates from.
"""

from pathlib import Path

import numpy as np
import pytest
import yaml

from deepgraphpose_tpu import threed as jax_threed
from deepgraphpose_tpu.infer import export as jax_export
from deepgraphpose_tpu.threed import calibration as jax_cal
from deepgraphpose_tpu.threed import plotting3d as jax_plot
from deepgraphpose_tpu_torch import threed
from deepgraphpose_tpu_torch.infer import export
from deepgraphpose_tpu_torch.threed import calibration as cal
from deepgraphpose_tpu_torch.threed import plotting3d as plot
from test_torch_project import assert_same_tree, assert_same_value

cv2 = pytest.importorskip("cv2")

REL = 1e-9                 # port against JAX: float64 geometry


@pytest.fixture(autouse=True, scope="module")
def one_opencv_thread():
    n = cv2.getNumThreads()
    cv2.setNumThreads(1)
    yield
    cv2.setNumThreads(n)


def close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    finite = np.isfinite(want)
    scale = max(np.abs(want[finite]).max(initial=0.0), 1e-300)
    assert np.abs(got[finite] - want[finite]).max(initial=0.0) \
        <= rel * scale


def _make_cameras():
    """The reference test's two pinhole cameras looking at the origin."""
    K1 = np.array([[800.0, 0, 320], [0, 800, 240], [0, 0, 1]])
    K2 = np.array([[820.0, 0, 330], [0, 820, 235], [0, 0, 1]])
    R, _ = cv2.Rodrigues(np.array([0.0, 0.35, 0.0]))
    T = np.array([[-3.0], [0.1], [0.4]])
    P1 = K1 @ np.hstack([np.eye(3), np.zeros((3, 1))])
    P2 = K2 @ np.hstack([R, T])
    return K1, K2, R, T, P1, P2


def _project(P, X):
    x = (P @ np.hstack([X, np.ones((len(X), 1))]).T).T
    return x[:, :2] / x[:, 2:3]


def test_triangulate_points_matches(rng):
    _, _, _, _, P1, P2 = _make_cameras()
    X = rng.uniform([-1, -1, 8], [1, 1, 12], (40, 3))
    x1, x2 = _project(P1, X), _project(P2, X)
    x1[2] = np.nan
    got = threed.triangulate_points(P1, P2, x1, x2)
    close(got, jax_threed.triangulate_points(P1, P2, x1, x2))
    assert np.isnan(got[2]).all()
    keep = np.arange(40) != 2
    np.testing.assert_allclose(got[keep], X[keep], atol=1e-6)
    # leading batch shapes are kept
    close(threed.triangulate_points(P1, P2, x1.reshape(8, 5, 2),
                                    x2.reshape(8, 5, 2)),
          got.reshape(8, 5, 3))


def test_undistort_points_matches():
    K1 = _make_cameras()[0]
    pts = np.array([[100.0, 200.0], [320.0, 240.0], [np.nan, 5.0],
                    [600.0, 20.0]])
    for dist in (np.zeros(5), np.array([-0.2, 0.05, 1e-3, -2e-3, 0.0])):
        got = threed.undistort_points(pts, K1, dist, K1)
        close(got, jax_threed.undistort_points(pts, K1, dist, K1))
        assert np.isnan(got[2]).all()
    np.testing.assert_allclose(
        threed.undistort_points(pts, K1, np.zeros(5), K1)[:2], pts[:2],
        atol=1e-6)


def test_calibrate_stereo_matches(rng):
    """Board corners projected through known cameras: the port's solve
    equals JAX's and recovers the geometry (the reference test's bounds:
    RMS < 1 px, fresh points within 0.5 of the truth)."""
    K1, K2, R, T, P1, P2 = _make_cameras()
    objp = cal.checkerboard_object_points(6, 8, square_size=0.5)
    np.testing.assert_array_equal(
        objp, jax_cal.checkerboard_object_points(6, 8, square_size=0.5))
    objpoints, img1, img2 = [], [], []
    for i in range(12):
        Rb, _ = cv2.Rodrigues(np.array([0.2, -0.1, 0.05]) * (i % 5 - 2))
        tb = np.array([-1.0 + 0.15 * i, -0.8 + 0.1 * i, 9.0 + 0.2 * i])
        Xw = objp @ Rb.T + tb
        objpoints.append(objp)
        img1.append(_project(P1, Xw).reshape(-1, 1, 2).astype(np.float32))
        img2.append(_project(P2, Xw).reshape(-1, 1, 2).astype(np.float32))
    got = threed.calibrate_stereo(objpoints, img1, img2, (640, 480))
    want = jax_threed.calibrate_stereo(objpoints, img1, img2, (640, 480))
    assert got.camera_names == want.camera_names
    assert got.image_size == want.image_size
    close(got.rms, want.rms)
    for name in got.camera_names:
        for field in ("K", "dist", "P"):
            close(getattr(got, field)[name], getattr(want, field)[name])
    close(got.R, want.R)
    close(got.T, want.T)
    assert got.rms < 1.0
    X = rng.uniform([-1, -1, 8], [1, 1, 12], (20, 3))
    xyz = threed.triangulate_points(got.P["camera-1"], got.P["camera-2"],
                                    _project(P1, X), _project(P2, X))
    assert np.abs(xyz - X).max() < 0.5


def test_calibrate_cameras_from_rendered_views(tmp_path, rng):
    """``create_new_project_3d`` and ``calibrate_cameras`` of both packages
    on checkerboard images rendered with OpenCV for two camera poses (the
    card's workflow phase renders the same views): equal projects, equal
    stereo parameters, and the relative pose recovered within the
    reference test's bounds."""
    import chip_smoke

    systems, roots = {}, {}
    for pkg, mod in (("jax", jax_threed), ("port", threed)):
        cfg3d = Path(mod.create_new_project_3d(
            "Tri", "bob", str(tmp_path / pkg), date="2026-08-16"))
        roots[pkg] = cfg3d.parent
        truth = chip_smoke.checkerboard_views(
            cfg3d.parent / "calibration_images")
        systems[pkg] = mod.calibrate_cameras(cfg3d, square_size=0.5)
        # the same project again: returned as it is
        assert Path(mod.create_new_project_3d(
            "Tri", "bob", str(tmp_path / pkg), date="2026-08-16")) == cfg3d
    assert_same_tree(roots["jax"], roots["port"],
                     skip=("camera_matrix/stereo_params.pickle",))
    got, want = systems["port"], systems["jax"]
    close(got.R, want.R)
    close(got.T, want.T)
    for name in got.camera_names:
        close(got.K[name], want.K[name])
        close(got.P[name], want.P[name])
    back = cal.CameraSystem.load(
        roots["port"] / "camera_matrix" / "stereo_params.pickle")
    close(back.P["camera-2"], got.P["camera-2"])
    err = chip_smoke.calibration_errors(got, truth, rng)
    assert err["rms_px"] < 1.0 and err["triangulated_max"] < 0.5, err
    # no board pairs: None, in both
    for pkg, mod in (("jax", jax_threed), ("port", threed)):
        for p in (roots[pkg] / "calibration_images").glob("camera-2-*"):
            p.unlink()
        assert mod.calibrate_cameras(roots[pkg] / "config.yaml") is None


def test_triangulate_flow_matches(tmp_path):
    """A known camera system and two views' pose tables through each
    package's ``triangulate``: equal results and files, the points
    recovered, the masked point NaN."""
    pytest.importorskip("h5py")
    K1, K2, R, T, P1, P2 = _make_cameras()
    Tn, nj = 25, 3
    t = np.arange(Tn)
    X = np.stack([np.stack([np.sin(t / 5 + j), np.cos(t / 7 + j),
                            10 + 0.5 * np.sin(t / 3 + j)], -1)
                  for j in range(nj)], axis=1)
    bps = [f"bp{j}" for j in range(nj)]
    lik = np.full((Tn, nj), 0.99)
    lik[5, 1] = 0.01
    results = {}
    for pkg, mod, ex in (("jax", jax_threed, jax_export),
                         ("port", threed, export)):
        cfg3d = mod.create_new_project_3d("Tri", "bob", str(tmp_path / pkg),
                                          date="2026-08-16")
        root = Path(cfg3d).parent
        mod.CameraSystem(
            camera_names=["camera-1", "camera-2"],
            K={"camera-1": K1, "camera-2": K2},
            dist={"camera-1": np.zeros(5), "camera-2": np.zeros(5)},
            R=R, T=T, P={"camera-1": P1, "camera-2": P2},
            image_size=(640, 480)).save(
                root / "camera_matrix" / "stereo_params.pickle")
        for cam, P in (("cam1", P1), ("cam2", P2)):
            xy = _project(P, X.reshape(-1, 3)).reshape(Tn, nj, 2)
            ex.write_pose_h5(root / f"vid_{cam}.h5", "s", bps,
                             {"x": xy[..., 0], "y": xy[..., 1],
                              "likelihoods": lik})
        results[pkg] = mod.triangulate(cfg3d, root / "vid_cam1.h5",
                                       root / "vid_cam2.h5")
        results[pkg + "_dest"] = mod.triangulate(
            cfg3d, root / "vid_cam1.h5", root / "vid_cam2.h5",
            destfolder=root / "out", output_name="named", pcutoff=0.001)
    for key in ("port", "port_dest"):
        got, want = results[key], results[key.replace("port", "jax")]
        assert got["bodyparts"] == want["bodyparts"] == bps
        close(got["xyz"], want["xyz"])
        np.testing.assert_array_equal(got["likelihood_mask"],
                                      want["likelihood_mask"])
    xyz = results["port"]["xyz"]
    assert xyz.shape == (Tn, nj, 3) and np.isnan(xyz[5, 1]).all()
    finite = np.isfinite(xyz[..., 0])
    np.testing.assert_allclose(xyz[finite], X[finite], atol=1e-5)
    assert np.isfinite(results["port_dest"]["xyz"]).all()
    assert_same_tree(tmp_path / "jax", tmp_path / "port",
                     skip=("Tri-bob-2026-08-16-3d/camera_matrix/"
                           "stereo_params.pickle",))
    root = tmp_path / "port" / "Tri-bob-2026-08-16-3d"
    assert (root / "vid_cam1_DGP_3D_3d.csv").exists()
    assert (root / "out" / "named_3d.h5").exists()


def test_plotting3d_matches(tmp_path, rng):
    pytest.importorskip("matplotlib")
    T, nj = 6, 3
    xyz = rng.standard_normal((T, nj, 3)) + [0, 0, 10]
    xyz[2, 1] = np.nan
    bps = ["bp0", "bp1", "bp2"]
    cfg3d = tmp_path / "config.yaml"
    cfg3d.write_text(yaml.safe_dump({"skeleton": [["bp0", "bp1"]],
                                     "skeleton_color": "black"}))
    outs = {}
    for pkg, mod in (("jax", jax_plot), ("port", plot)):
        fig = mod.plot_trajectories_3d(xyz, bps, tmp_path / f"{pkg}.png")
        vid = mod.create_labeled_video_3d(cfg3d, xyz, bps,
                                          tmp_path / f"{pkg}.mp4",
                                          trailpoints=3)
        outs[pkg] = (fig.read_bytes(), vid.stat().st_size)
        with pytest.raises(ValueError, match="finite"):
            mod.create_labeled_video_3d(cfg3d, np.full_like(xyz, np.nan),
                                        bps, tmp_path / "none.mp4")
    assert outs["port"][1] > 0
    # the same figure and the same number of encoded bytes
    assert_same_value(outs["port"], outs["jax"])
    from deepgraphpose_tpu_torch.data.video import VideoReader

    reader = VideoReader(tmp_path / "port.mp4")
    assert reader.n_frames == T
    reader.close()

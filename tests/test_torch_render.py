"""The port's rendering (``infer/video_writer.py``, ``infer/plotting.py``,
``evaluation/maps.py``, ``evaluate_network(plotting=True)``) and video
utilities (``data/video.py``) against the JAX package's, on the CPU.

Both packages read the project of ``tests/test_torch_analyze.py`` (the
synthetic project, 40 frames of 64x80, 6 labeled PNGs, 3 joints, with one
JAX random-init ResNet-50 snapshot). What each compares:

* drawn from the same inputs (labels, targets, trajectories): the videos'
  decoded frames and the PNGs' pixels are equal;
* drawn from each package's inference (``plot_dgp``, the scoremap grids,
  the labeled evaluation images): the numbers are held as the inference
  paths are (x / y within 1e-3 px, likelihood and sigmoid maps within
  1e-4, mu within 1e-3 cells), the files written are the same, and the
  images agree but for the few pixels where a marker rounds to another
  place (at most 0.1% of the labeled video's pixels, a mean difference
  below 0.5 of 255 in the figures).
"""

import shutil
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepgraphpose_tpu.data import video as jax_video
from deepgraphpose_tpu.evaluation import maps as jax_maps
from deepgraphpose_tpu.evaluation import metrics as jax_metrics
from deepgraphpose_tpu.infer import plotting as jax_plotting
from deepgraphpose_tpu.infer import video_writer as jax_writer
from deepgraphpose_tpu_torch.data import video
from deepgraphpose_tpu_torch.evaluation import maps, metrics
from deepgraphpose_tpu_torch.infer import export, plotting, video_writer
from deepgraphpose_tpu_torch.ops.kernels import softargmax_kernel
from test_torch_analyze import SNAPSHOT, project_with_snapshot

XY_TOL, LIK_TOL, MU_TOL = 1e-3, 1e-4, 1e-3
FIGURE_MEAN_DIFF = 0.5
VIDEO_PIXELS_MOVED = 1e-3


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two torch threads while this file runs (see test_torch_analyze)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    return project_with_snapshot(tmp_path_factory.mktemp("render") / "p")


def frames_of(path) -> np.ndarray:
    reader = video.VideoReader(path)
    out = np.stack([f for _, f in reader.iter_frames()])
    reader.close()
    return out


def pixels(path) -> np.ndarray:
    img = cv2.imread(str(path))
    assert img is not None, path
    return img.astype(np.int16)


def random_labels(t: int, nj: int, hw, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    labels = {"x": rng.uniform(0, hw[1], (t, nj)),
              "y": rng.uniform(0, hw[0], (t, nj)),
              "likelihoods": rng.uniform(0, 1, (t, nj))}
    labels["x"][3, 1] = np.nan
    return labels


@pytest.mark.parametrize("n", [1, 2, 3, 5, 12, 256])
def test_colormap_colors_match_jax(n):
    """"jet" from the port's own table (no matplotlib) and any other name
    through matplotlib: the JAX package's colors."""
    for name in ("jet", "viridis"):
        assert (video_writer.colormap_colors(n, name)
                == jax_writer.colormap_colors(n, name))


def test_annotated_and_comparison_movies_match_jax(project, tmp_path):
    root, _ = project
    src = root / "videos" / "synthvid.avi"
    a = random_labels(40, 3, (64, 80), 0)
    b = random_labels(40, 3, (64, 80), 1)
    for name, port_fn, jax_fn, args in (
            ("annotated", video_writer.create_annotated_movie,
             jax_writer.create_annotated_movie, (a,)),
            ("comparison", video_writer.create_comparison_movie,
             jax_writer.create_comparison_movie, (a, b))):
        got = port_fn(src, tmp_path / f"{name}_port.mp4", *args,
                      max_frames=30)
        want = jax_fn(src, tmp_path / f"{name}_jax.mp4", *args,
                      max_frames=30)
        got, want = frames_of(got), frames_of(want)
        assert got.shape == want.shape
        assert got.shape[0] == 30
        assert got.shape[2] == (160 if name == "comparison" else 80)
        np.testing.assert_array_equal(got, want)


def test_video_utils_roundtrip(tmp_path):
    """tests/test_parity_extras.py::test_video_utils_roundtrip's cases, and
    each output's frames equal the JAX package's."""
    src = tmp_path / "v.avi"
    wr = cv2.VideoWriter(str(src), cv2.VideoWriter_fourcc(*"MJPG"), 10.0,
                         (64, 48))
    for i in range(30):
        wr.write(np.full((48, 64, 3), i * 8, np.uint8))
    wr.release()
    for name, kw in (("shorten", dict(start_s=1.0, stop_s=2.0)),
                     ("downsample", dict(height=24)),
                     ("crop", dict(x0=8, x1=40, y0=4, y1=28))):
        port_fn = getattr(video, f"{name}_video")
        jax_fn = getattr(jax_video, f"{name}_video")
        got = port_fn(src, **kw, outpath=_mkdir(tmp_path / "port"))
        want = jax_fn(src, **kw, outpath=_mkdir(tmp_path / "jax"))
        assert got.name == want.name
        r = video.VideoReader(got)
        if name == "shorten":
            assert 8 <= r.n_frames <= 12
        elif name == "downsample":
            assert r.height == 24 and r.width == 32
        else:
            assert (r.width, r.height) == (32, 24)
        r.close()
        np.testing.assert_array_equal(frames_of(got), frames_of(want))


def _mkdir(path: Path) -> Path:
    path.mkdir(parents=True, exist_ok=True)
    return path


def test_plot_trajectories_matches_jax(project, tmp_path):
    """tests/test_postprocessing.py:128's case: the figure of an analysis
    H5 next to the video, the same file and pixels as the JAX package's
    (each package's figure moved aside before the other's is drawn)."""
    root, _ = project
    vid = root / "videos_dgp" / "synthvid.avi"
    scorer = "DLC_resnet50_SynthJan1shuffle1_7"
    stem = str(vid.parent / f"{vid.stem}{scorer}")
    export.export_pose_like_dlc(random_labels(30, 3, (64, 80), 2), scorer,
                                ["bp0", "bp1", "bp2"], stem)
    outs = {}
    for pkg, fn in (("port", plotting.plot_trajectories),
                    ("jax", jax_plotting.plot_trajectories)):
        (out,) = fn(str(root / "config.yaml"), [vid], scorer=scorer)
        assert out == root / "plot-poses" / "synthvid" / (
            "synthvid_trajectories.png")
        outs[pkg] = shutil.move(out, tmp_path / f"{pkg}.png")
    for suffix in (".csv", ".h5"):
        Path(stem + suffix).unlink()
    np.testing.assert_array_equal(pixels(outs["port"]), pixels(outs["jax"]))


def test_check_labels_matches_jax(project, tmp_path):
    root, _ = project
    written = {}
    for pkg, fn in (("port", plotting.check_labels),
                    ("jax", jax_plotting.check_labels)):
        paths = fn(root / "config.yaml")
        written[pkg] = [p.relative_to(root) for p in paths]
        shutil.move(root / "labeled-data" / "synthvid_labeled",
                    tmp_path / pkg)
    assert written["port"] == written["jax"] and len(written["port"]) == 6
    for rel in written["port"]:
        np.testing.assert_array_equal(pixels(tmp_path / "port" / rel.name),
                                      pixels(tmp_path / "jax" / rel.name))


def test_plot_dgp_matches_jax(project, tmp_path):
    """plot_dgp: estimate_pose's CSV as the inference paths hold it, then
    the labeled video, frame for frame."""
    root, snap = project
    vid = root / "videos" / "synthvid.avi"
    config = root / "config.yaml"
    got = video_writer.plot_dgp(vid, tmp_path / "port", config, snap,
                                device="cpu")
    want = jax_writer.plot_dgp(vid, tmp_path / "jax", config, snap)
    assert got.name == want.name == "synthvid_labeled.mp4"
    pose = export.load_pose_from_dlc(str(tmp_path / "port" / "synthvid.csv"))
    jax_pose = export.load_pose_from_dlc(str(tmp_path / "jax" /
                                             "synthvid.csv"))
    for key, tol in (("x", XY_TOL), ("y", XY_TOL), ("likelihoods", LIK_TOL)):
        np.testing.assert_allclose(pose[key], jax_pose[key], rtol=0, atol=tol)
    got, want = frames_of(got), frames_of(want)
    assert got.shape == want.shape == (40, 64, 80, 3)
    moved = np.any(got != want, axis=-1).mean()
    assert moved <= VIDEO_PIXELS_MOVED, moved


def test_plot_dgp_int8(project, tmp_path):
    """plot_dgp(quantize=True) reaches estimate_pose's int8 model (the GEMM
    ops' plain versions here) and writes every frame."""
    root, snap = project
    vid = root / "videos" / "synthvid.avi"
    out = video_writer.plot_dgp(vid, tmp_path, root / "config.yaml", snap,
                                save_str="_int8", quantize=True,
                                device="cpu")
    assert out.name == "synthvid_int8_labeled.mp4"
    assert frames_of(out).shape == (40, 64, 80, 3)


def jax_scoremaps(root: Path, snap: Path) -> dict:
    """The JAX package's sigmoid maps and soft-argmax of each labeled frame
    (its extract_save_all_maps' computation)."""
    from deepgraphpose_tpu.core import checkpoint as jax_ckpt
    from deepgraphpose_tpu.models.pose_model import init_model
    from deepgraphpose_tpu.ops.softargmax import softargmax_2d
    from deepgraphpose_tpu.train.fit import resolve_project

    _, cfg, _ = resolve_project(root, 1)
    model, variables = init_model(cfg, jax.random.PRNGKey(0), (64, 80))
    variables, _ = jax_ckpt.load_snapshot(snap, variables)
    out = {}
    for ip in sorted((root / "labeled-data" / "synthvid").glob("*.png")):
        img = cv2.cvtColor(cv2.imread(str(ip)), cv2.COLOR_BGR2RGB)
        pred = model.apply(variables, jnp.asarray(img[None], jnp.float32))[
            "part_pred"]
        mu, _ = softargmax_2d(pred, gamma=cfg.gamma, gauss_len=cfg.gauss_len)
        out[ip.name] = (np.asarray(jax.nn.sigmoid(pred))[0],
                        np.asarray(mu)[0])
    return out


def test_extract_save_all_maps_matches_jax(project, tmp_path):
    root, snap = project
    config = root / "config.yaml"
    want = jax_scoremaps(root, snap)
    before = softargmax_kernel.launches
    got = list(maps.labeled_scoremaps(config, snapshot=SNAPSHOT,
                                      device="cpu"))
    assert softargmax_kernel.launches == before   # plain decode on the CPU
    assert [ip.name for ip, *_ in got] == sorted(want)
    for ip, img, scmap, mu in got:
        w_scmap, w_mu = want[ip.name]
        assert img.shape == (64, 80, 3)
        np.testing.assert_allclose(scmap, w_scmap, rtol=0, atol=LIK_TOL)
        np.testing.assert_allclose(mu, w_mu, rtol=0, atol=MU_TOL)

    out = maps.extract_save_all_maps(config, indices=[0, 1],
                                     dest_folder=tmp_path / "port",
                                     snapshot=SNAPSHOT, device="cpu")
    jax_out = jax_maps.extract_save_all_maps(config, indices=[0, 1],
                                             dest_folder=tmp_path / "jax",
                                             snapshot=SNAPSHOT)
    assert [p.name for p in out] == [p.name for p in jax_out]
    assert len(out) == 2 and out[0].name.endswith("_scmap.png")
    for a, b in zip(out, jax_out):
        diff = np.abs(pixels(a) - pixels(b))
        assert diff.mean() <= FIGURE_MEAN_DIFF, (a.name, diff.mean())


def test_display_dataset_matches_jax(project, tmp_path):
    root, _ = project
    config = root / "config.yaml"
    out = maps.display_dataset(config, indices=[0, 1, 5],
                               dest_folder=tmp_path / "port")
    jax_out = jax_maps.display_dataset(config, indices=[0, 1, 5],
                                       dest_folder=tmp_path / "jax")
    assert [p.name for p in out] == [p.name for p in jax_out]
    assert len(out) == 3 and all(p.name.endswith("_targets.png")
                                 for p in out)
    for a, b in zip(out, jax_out):
        np.testing.assert_array_equal(pixels(a), pixels(b))


def test_evaluate_network_plotting_matches_jax(project, tmp_path):
    """tests/test_parity_extras.py:171-192's case against the JAX
    package's images."""
    root, _ = project
    folders = {}
    for pkg in ("port", "jax"):
        work = tmp_path / pkg
        shutil.copytree(root, work)
        kw = dict(shuffle=1, snapshots=SNAPSHOT, plotting=True)
        if pkg == "port":
            results = metrics.evaluate_network(work / "config.yaml",
                                               device="cpu", **kw)
        else:
            results = jax_metrics.evaluate_network(work / "config.yaml", **kw)
        folders[pkg] = (work / "evaluation-results" / "iteration-0"
                        / f"LabeledImages_{SNAPSHOT}")
        names = sorted(p.name for p in folders[pkg].glob("*.png"))
        assert len(names) == len(results[0]["image_paths"]) == 6
        n_train = int(np.sum(results[0]["is_train"]))
        assert sum(n.startswith("Training-") for n in names) == n_train
    names = sorted(p.name for p in folders["port"].glob("*.png"))
    assert names == sorted(p.name for p in folders["jax"].glob("*.png"))
    for name in names:
        diff = np.abs(pixels(folders["port"] / name)
                      - pixels(folders["jax"] / name))
        assert diff.mean() <= FIGURE_MEAN_DIFF, (name, diff.mean())

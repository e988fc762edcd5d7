"""The port's evaluation (``evaluation/metrics.py``) and post-processing
(``evaluation/{filtering,outliers,skeleton}.py``) against the JAX
package's, on the CPU.

``evaluate_dgp`` and ``evaluate_network`` run on the project of
``tests/test_torch_analyze.py`` (the synthetic project with one JAX
random-init ResNet-50 snapshot that both packages read). Tolerances:

* float32 (``decode="dgp"`` through the soft-argmax, ``decode="dlc"``
  through the argmax + locref, ``scale``, ``comparisonbodyparts``):
  predicted x / y within 1e-3 px, likelihood within 1e-4 (as
  tests/test_torch_infer.py holds float32 inference), the summary errors
  within 1e-3 px, the bodypart columns and the split equal;
* ``quantize`` (True and "residual"): each site's act_scale within 1e-5
  relative of JAX's, and with JAX's int8 state in both, x / y within
  1e-2 px and likelihood within 1e-3 (tests/test_torch_quant.py's bounds);
* the CombinedEvaluation-results.csv rows: the same columns, the errors
  (written with 3 decimals) within 2e-3 px.

The post-processing is numpy on both sides, held to 1e-12 (the cases of
tests/test_postprocessing.py:26-126 and test_parity_extras.py's skeleton
cases); outlier indices, the files' tables and the PNGs written are equal.
"""

import shutil
from pathlib import Path

import h5py
import jax
import numpy as np
import pytest
import torch
import yaml

from deepgraphpose_tpu.evaluation import filtering as jax_filtering
from deepgraphpose_tpu.evaluation import metrics as jax_metrics
from deepgraphpose_tpu.evaluation import outliers as jax_outliers
from deepgraphpose_tpu.evaluation import skeleton as jax_skeleton
from deepgraphpose_tpu.infer import export as jax_export
from deepgraphpose_tpu_torch.evaluation import (filtering, metrics, outliers,
                                                skeleton)
from deepgraphpose_tpu_torch.infer import export
from test_torch_analyze import SNAPSHOT, project_with_snapshot

XY_TOL, LIK_TOL = 1e-3, 1e-4
EXACT = 1e-12


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two torch threads while this file runs (see test_torch_analyze)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    return project_with_snapshot(tmp_path_factory.mktemp("evaluate") / "p")


def both_evaluate(project, **kw) -> tuple[dict, dict]:
    root, snap = project
    want = jax_metrics.evaluate_dgp(root / "config.yaml", snap, **kw)
    got = metrics.evaluate_dgp(root / "config.yaml", snap, device="cpu",
                               **kw)
    return got, want


def assert_evaluation_close(got, want, xy_tol=XY_TOL, lik_tol=LIK_TOL):
    assert got["pred_xy"].shape == want["pred_xy"].shape
    np.testing.assert_allclose(got["pred_xy"], want["pred_xy"], rtol=0,
                               atol=xy_tol)
    np.testing.assert_allclose(got["likelihood"], want["likelihood"],
                               rtol=0, atol=lik_tol)
    np.testing.assert_array_equal(got["true_xy"], want["true_xy"])
    np.testing.assert_array_equal(got["is_train"], want["is_train"])
    assert got["image_paths"] == want["image_paths"]
    assert got["bodypart_columns"] == want["bodypart_columns"]
    np.testing.assert_allclose(got["rmse"], want["rmse"], rtol=0,
                               atol=xy_tol)
    for key in ("train_error", "test_error", "train_error_pcutoff"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=xy_tol)


@pytest.mark.parametrize("kw", [
    dict(), dict(decode="dlc"), dict(scale=0.5),
    dict(comparisonbodyparts=["bp1"]),
    dict(decode="dlc", comparisonbodyparts=["bp0", "bp2"], pcutoff=0.5),
], ids=["dgp", "dlc", "scale", "bodyparts", "dlc_bodyparts_pcutoff"])
def test_evaluate_dgp_matches_jax(project, kw):
    got, want = both_evaluate(project, **kw)
    assert_evaluation_close(got, want)
    assert np.isfinite(got["pred_xy"]).all()
    if kw.get("scale"):
        # mapped back to label pixels: 64x80 frames, not the 32x40 seen
        assert got["pred_xy"][..., 0].max() > 40
    if "comparisonbodyparts" in kw:
        cols = got["bodypart_columns"]
        assert cols == [int(b[2]) for b in kw["comparisonbodyparts"]]
        expect = np.nanmean(got["rmse"][:, cols][got["is_train"]])
        assert got["train_error"] == pytest.approx(expect, rel=1e-12)


def test_evaluate_dgp_rejects_unknown_bodyparts(project):
    root, snap = project
    with pytest.raises(ValueError, match="unknown bodyparts"):
        metrics.evaluate_dgp(root / "config.yaml", snap, device="cpu",
                             comparisonbodyparts=["nosuch"])


@pytest.mark.parametrize("mode", [True, "residual"])
def test_evaluate_dgp_quantized_matches_jax(project, monkeypatch, mode):
    """The int8 model calibrated on the labeled images: the port's
    act_scales against JAX's, then the evaluation with JAX's int8 state
    carried in (each package on its own scales parts by whole px on these
    random weights; tests/test_torch_quant.py)."""
    from deepgraphpose_tpu.models import quant as jax_quant
    from deepgraphpose_tpu_torch.core.checkpoint import quant_state_from_flax
    from deepgraphpose_tpu_torch.models import quant

    made = {}
    original = {"jax": jax_quant.quantize_model, "port": quant.quantize_model}

    def recorder(key):
        def wrapped(*args, **kw):
            made[key] = original[key](*args, **kw)
            made[key + "_calib"] = np.asarray(args[2])
            return made[key]
        return wrapped

    monkeypatch.setattr(jax_quant, "quantize_model", recorder("jax"))
    monkeypatch.setattr(quant, "quantize_model", recorder("port"))
    _, want = both_evaluate(project, quantize=mode)
    np.testing.assert_array_equal(made["port_calib"], made["jax_calib"])
    assert made["port"].residual_int8 == (mode == "residual")
    qvars = jax.tree_util.tree_map(np.asarray, made["jax"][1])
    for site, q in made["port"].sites.items():
        scale = float(qvars["act_scale"][site])
        assert abs(q.act_scale - scale) <= 1e-5 * scale, site

    def with_jax_state(cfg, model, calib, dtype, residual_int8):
        qmodel = quant.QuantizedPoseModel(cfg, dtype=dtype,
                                          residual_int8=residual_int8)
        qmodel.load_state_dict(quant_state_from_flax(qvars), strict=True)
        return qmodel.eval()

    monkeypatch.setattr(quant, "quantize_model", with_jax_state)
    root, snap = project
    got = metrics.evaluate_dgp(root / "config.yaml", snap, device="cpu",
                               quantize=mode)
    assert_evaluation_close(got, want, xy_tol=1e-2, lik_tol=1e-3)


def test_evaluation_entries_split_from_the_training_set(project):
    """The three sources of the labeled set, equal to JAX's: the
    labeled-data CSVs (all train), the .mat alone (all train), and the
    full table beside the .mat split by the Documentation pickle's
    indices; evaluate_dgp then reports a test error."""
    from deepgraphpose_tpu.core.config import PoseConfig as JaxPoseConfig
    from deepgraphpose_tpu.core.config import ProjectConfig as JaxProject
    from deepgraphpose_tpu_torch.core.paths import resolve_project
    from deepgraphpose_tpu_torch.data import project as project_io

    root, snap = project
    proj, cfg, train_dir = resolve_project(root)
    jproj = JaxProject.from_yaml(root / "config.yaml")
    jcfg = JaxPoseConfig.from_yaml(train_dir / "pose_cfg.yaml")

    def entries_equal():
        got = metrics.load_evaluation_entries(root, proj, cfg)
        want = jax_metrics.load_evaluation_entries(root, jproj, jcfg)
        assert len(got) == len(want) == 6
        for (p, c, tr), (wp, wc, wtr) in zip(got, want):
            assert p == wp and tr == wtr
            np.testing.assert_array_equal(c, wc)
        return got

    assert all(tr for _, _, tr in entries_equal())
    mat = root / cfg.dataset
    mat.parent.mkdir(parents=True)
    try:
        labels = project_io.read_labels(root / "labeled-data" / "synthvid",
                                        "synth")
        joints = [np.array([[j, *xy] for j, xy in enumerate(c)])
                  for c in labels.coords_xy]
        project_io.write_training_mat(
            mat, labels.image_paths, np.tile([3, 64, 80], (6, 1)), joints)
        assert all(tr for _, _, tr in entries_equal())
        shutil.copy(root / "labeled-data" / "synthvid"
                    / "CollectedData_synth.csv", mat.parent)
        project_io.write_documentation_pickle(
            root / cfg.metadataset, [], [0, 1, 2, 4, 5], [3], 0.95)
        assert [tr for _, _, tr in entries_equal()] == [True] * 3 + [
            False] + [True] * 2
        got, want = both_evaluate(project)
        assert_evaluation_close(got, want)
        assert np.isfinite(got["test_error"])
    finally:
        shutil.rmtree(mat.parent)


def test_evaluate_network_rows_and_rescale(project):
    """The combined CSV: JAX's row, then the port's, appended to one file;
    then rescale=True at pose_cfg's global_scale (0.75 here), errors in
    the original pixels, with a bodypart subset."""
    root, snap = project
    cfg = root / "config.yaml"
    csv_path = (root / "evaluation-results" / "iteration-0"
                / "CombinedEvaluation-results.csv")
    pose_cfg = snap.parent / "pose_cfg.yaml"
    orig = pose_cfg.read_text()
    try:
        for kw in (dict(), dict(rescale=True,
                                comparisonbodyparts=["bp0", "bp2"])):
            if kw:
                raw = yaml.safe_load(orig)
                raw["global_scale"] = 0.75
                pose_cfg.write_text(yaml.safe_dump(raw, sort_keys=False))
            want = jax_metrics.evaluate_network(cfg, **kw)
            got = metrics.evaluate_network(cfg, device="cpu", **kw)
            assert len(got) == len(want) == 1
            assert got[0]["snapshot"] == want[0]["snapshot"] == snap.stem
            assert_evaluation_close(got[0], want[0])
            rows = [r.split(",") for r in
                    csv_path.read_text().strip().splitlines()]
            assert rows[0] == ["snapshot", "shuffle", "train_fraction",
                               "train_error_px", "test_error_px",
                               "train_error_pcutoff_px", "pcutoff"]
            jrow, prow = rows[-2], rows[-1]
            assert prow[:3] == jrow[:3] == [snap.stem, "1", "0.95"]
            assert prow[4] == jrow[4] == "nan" and prow[6] == jrow[6]
            for k in (3, 5):
                assert abs(float(prow[k]) - float(jrow[k])) <= 2e-3
        assert got[0]["bodypart_columns"] == [0, 2]
        assert got[0]["pred_xy"][..., 0].max() <= 80
        assert len(rows) == 1 + 4
    finally:
        pose_cfg.write_text(orig)


def test_evaluate_network_passes_its_options(project, monkeypatch):
    """snapshots as one name or a list (a row each, in order), and
    quantize, comparisonbodyparts, rescale (as global_scale) and device
    handed to evaluate_dgp, as the JAX package hands them."""
    root, snap = project
    calls = {"port": [], "jax": []}

    def fake(key):
        def evaluate_dgp(config, snapshot, **kw):
            calls[key].append((Path(snapshot).name, kw))
            return {"train_error": 1.0, "test_error": float("nan"),
                    "train_error_pcutoff": 2.0}
        return evaluate_dgp

    monkeypatch.setattr(metrics, "evaluate_dgp", fake("port"))
    monkeypatch.setattr(jax_metrics, "evaluate_dgp", fake("jax"))
    for snapshots in ("snapshot-a", ["snapshot-a", "snapshot-b"]):
        kw = dict(snapshots=snapshots, quantize="residual", rescale=True,
                  comparisonbodyparts=["bp1"], pcutoff=0.3)
        got = metrics.evaluate_network(root / "config.yaml", device="cpu",
                                       **kw)
        want = jax_metrics.evaluate_network(root / "config.yaml", **kw)
        assert [r["snapshot"] for r in got] == [r["snapshot"] for r in want]
    for (name, kw), (jname, jkw) in zip(calls["port"], calls["jax"],
                                        strict=True):
        assert name == jname and str(kw.pop("device")) == "cpu"
        assert kw == jkw and kw["scale"] == 0.8
    assert [c[0] for c in calls["port"]] == [
        "snapshot-a.ckpt", "snapshot-a.ckpt", "snapshot-b.ckpt"]


def test_evaluate_network_plotting_waits_for_rendering(project, tmp_path):
    """plotting=True, which waited for the rendering slice, writes the
    labeled evaluation images: one a frame, named as the JAX package
    names them (Training- / Test- by the split)."""
    root, _ = project
    work = tmp_path / "p"
    shutil.copytree(root, work)
    results = metrics.evaluate_network(work / "config.yaml", plotting=True,
                                       snapshots=SNAPSHOT, device="cpu")
    folder = (work / "evaluation-results" / "iteration-0"
              / f"LabeledImages_{SNAPSHOT}")
    names = sorted(p.name for p in folder.glob("*.png"))
    want = sorted(f"{'Training' if t else 'Test'}-{Path(p).parts[-2]}-"
                  f"{Path(p).name}" for p, t in zip(
                      results[0]["image_paths"], results[0]["is_train"]))
    assert names == want and len(names) == 6
    assert all((folder / n).stat().st_size > 1000 for n in names)


def test_distances_bodyparts_and_csv_equal_jax(project, tmp_path, rng):
    from deepgraphpose_tpu_torch.core.config import ProjectConfig

    pred, true = rng.uniform(0, 50, (2, 7, 3, 2))
    true[2, 1] = np.nan
    lik = rng.uniform(0, 1, (7, 3))
    for got, want in zip(metrics.pairwise_distances(pred, true, lik, 0.4),
                         jax_metrics.pairwise_distances(pred, true, lik,
                                                        0.4)):
        np.testing.assert_array_equal(got, want)
    proj = ProjectConfig.from_yaml(project[0] / "config.yaml")
    for sel in ("all", None, ["all"], "bp2", ["bp2", "bp0"]):
        assert (metrics.intersect_bodyparts(proj, sel)
                == jax_metrics.intersect_bodyparts(proj, sel))
    out = {"rmse": metrics.pairwise_distances(pred, true)[0],
           "is_train": np.array([True] * 5 + [False] * 2)}
    metrics.write_evaluation_csv(out, tmp_path / "p.csv", ["a", "b", "c"])
    jax_metrics.write_evaluation_csv(out, tmp_path / "j.csv", ["a", "b", "c"])
    assert ((tmp_path / "p.csv").read_bytes()
            == (tmp_path / "j.csv").read_bytes())


# --------------------------------------------------------------------------
# filtering, outliers, skeleton: numpy on both sides
# --------------------------------------------------------------------------

def _synthetic_labels(T=60, nj=2, noise=0.5, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(T)
    x = 40 + 10 * np.sin(t[:, None] / 7 + np.arange(nj))
    y = 30 + 8 * np.cos(t[:, None] / 9 + np.arange(nj))
    return {"x": x + rng.normal(0, noise, x.shape),
            "y": y + rng.normal(0, noise, y.shape),
            "likelihoods": np.full((T, nj), 0.95)}, x, y


def _same(got, want):
    if isinstance(got, dict):
        assert set(got) == set(want)
        for k in got:
            _same(got[k], want[k])
        return
    np.testing.assert_allclose(got, want, rtol=0, atol=EXACT)


def test_median_filter_removes_spike():
    x = np.zeros((21, 1))
    x[10] = 50.0
    out = filtering.median_filter(x, windowlength=5)
    assert out[10, 0] == 0.0
    for wl in (4, 5, 9):
        _same(filtering.median_filter(x, wl),
              jax_filtering.median_filter(x, wl))


def test_kalman_smooth_tracks_and_denoises():
    labels, x_true, _ = _synthetic_labels(noise=1.5)
    xy = np.stack([labels["x"][:, 0], labels["y"][:, 0]], -1)
    sm = filtering.kalman_smooth(xy, labels["likelihoods"][:, 0])
    _same(sm, jax_filtering.kalman_smooth(xy, labels["likelihoods"][:, 0]))
    raw_err = np.abs(labels["x"][:, 0] - x_true[:, 0]).mean()
    assert np.abs(sm[5:, 0] - x_true[5:, 0]).mean() < raw_err


def test_kalman_smooth_bridges_uncertain_gap():
    labels, x_true, _ = _synthetic_labels(noise=0.2)
    lik = labels["likelihoods"][:, 0].copy()
    labels["x"][25:30, 0] += 200.0
    lik[25:30] = 0.01
    xy = np.stack([labels["x"][:, 0], labels["y"][:, 0]], -1)
    sm = filtering.kalman_smooth(xy, lik, pcutoff=0.4)
    _same(sm, jax_filtering.kalman_smooth(xy, lik, pcutoff=0.4))
    assert np.abs(sm[25:30, 0] - x_true[25:30, 0]).max() < 20.0


def test_filter_pose_arrays_modes():
    labels, _, _ = _synthetic_labels()
    for ft in ("median", "kalman", "arima", "spline"):
        out = filtering.filter_pose_arrays(labels, filtertype=ft)
        _same(out, jax_filtering.filter_pose_arrays(labels, filtertype=ft))
        assert np.isfinite(out["x"]).all()
    _same(filtering.filter_pose_arrays(labels, "arima"),
          filtering.filter_pose_arrays(labels, "kalman"))
    for mod in (filtering, jax_filtering):
        with pytest.raises(ValueError):
            mod.filter_pose_arrays(labels, filtertype="nope")


def test_outlier_indices_jump_uncertain_fitting():
    labels, _, _ = _synthetic_labels(noise=0.1)
    labels["x"][17, 0] += 100.0
    labels["likelihoods"][40, 1] = 0.001
    for algo, kw in (("jump", dict(epsilon=20)),
                     ("uncertain", dict(p_bound=0.01)),
                     ("fitting", dict(epsilon=10))):
        got = outliers.outlier_frame_indices(labels, algo, **kw)
        np.testing.assert_array_equal(
            got, jax_outliers.outlier_frame_indices(labels, algo, **kw))
        assert {"jump": 17, "uncertain": 40, "fitting": 17}[algo] in got
    for mod in (outliers, jax_outliers):
        with pytest.raises(ValueError):
            mod.outlier_frame_indices(labels, "nope")


def _tree(folder: Path) -> dict:
    return {p.relative_to(folder).as_posix(): p.read_bytes()
            for p in sorted(folder.rglob("*")) if p.is_file()}


def test_filterpredictions_and_outlier_extraction(project, tmp_path):
    """Each package filters and extracts from its own copy of one analysis
    H5 beside its own copy of the video (a video stem of its own, so the
    extracted PNGs land in labeled-data/<stem>/): equal filtered tables and
    CSV bytes, equal indices, PNG and machine-label bytes equal."""
    root, _ = project
    labels, _, _ = _synthetic_labels(T=30, nj=3)
    labels["x"][12] += 150.0
    scorer = "DLC_resnet50_SynthJan1shuffle1_5"
    picked, dirs = {}, {}
    for pkg, ft, ol, ex in (("jax", jax_filtering, jax_outliers, jax_export),
                            ("port", filtering, outliers, export)):
        folder = tmp_path / pkg
        folder.mkdir()
        video = folder / f"outvid_{pkg}.avi"
        shutil.copy(root / "videos" / "synthvid.avi", video)
        ex.write_pose_h5(folder / f"{video.stem}{scorer}.h5", scorer,
                         ["bp0", "bp1", "bp2"], labels)
        out = ft.filterpredictions(str(root / "config.yaml"), [video],
                                   filtertype="median", windowlength=5,
                                   scorer=scorer)
        assert out == [folder / f"{video.stem}{scorer}filtered.h5"]
        dirs[pkg] = (out[0], root / "labeled-data" / video.stem)
        picked[pkg] = ol.extract_outlier_frames(
            str(root / "config.yaml"), [video], outlieralgorithm="jump",
            epsilon=30, numframes2pick=4, scorer=scorer)[str(video)]
    np.testing.assert_array_equal(picked["port"], picked["jax"])
    assert len(picked["port"]) >= 1
    (pf, pdir), (jf, jdir) = dirs["port"], dirs["jax"]
    got, want = export.read_pose_table(pf), jax_export.read_pose_table(jf)
    assert got[:2] == want[:2] and got[3] == want[3]
    _same(got[2], want[2])
    assert abs(got[2]["x"][12, 0] - labels["x"][12, 0]) > 100
    assert (pf.with_suffix(".csv").read_bytes()
            == jf.with_suffix(".csv").read_bytes())
    # the same frames and machine labels, up to the video's own name
    gtree, wtree = _tree(pdir), _tree(jdir)
    assert set(gtree) == set(wtree)
    for name in gtree:
        if name.endswith(".png"):
            assert gtree[name] == wtree[name], name
    g = export.read_pose_table(pdir / "machinelabels-iter0.h5")
    w = jax_export.read_pose_table(jdir / "machinelabels-iter0.h5")
    _same(g[2], w[2])
    assert [i.replace("outvid_port", "outvid_jax") for i in g[3]] == w[3]
    shutil.rmtree(pdir)
    shutil.rmtree(jdir)


def test_filterpredictions_without_analysis_and_csv_off(project, tmp_path):
    root, _ = project
    video = tmp_path / "none.avi"
    assert filtering.filterpredictions(root / "config.yaml", [video]) == []
    labels, _, _ = _synthetic_labels(T=20, nj=3)
    export.write_pose_h5(tmp_path / "noneDLC_x.h5", "DLC_x",
                         ["bp0", "bp1", "bp2"], labels)
    out = filtering.filterpredictions(root / "config.yaml", [video],
                                      filtertype="kalman",
                                      save_as_csv=False)
    assert out == [tmp_path / "noneDLC_xfiltered.h5"]
    assert not (tmp_path / "noneDLC_xfiltered.csv").exists()


def test_bone_statistics_geometry():
    labels = {
        "x": np.array([[0.0, 3.0], [0.0, 0.0]]),
        "y": np.array([[0.0, 4.0], [0.0, 2.0]]),
        "likelihoods": np.array([[0.9, 0.5], [0.8, 0.7]]),
    }
    bones = skeleton.bone_statistics(labels, ["a", "b"], [["a", "b"]])
    _same(bones, jax_skeleton.bone_statistics(labels, ["a", "b"],
                                              [["a", "b"]]))
    st = bones["a_b"]
    np.testing.assert_allclose(st["length"], [5.0, 2.0])
    np.testing.assert_allclose(st["orientation_deg"],
                               [np.degrees(np.arctan2(4, 3)), 90.0])
    np.testing.assert_allclose(st["likelihood"], [0.5, 0.7])
    assert skeleton.bone_statistics(labels, ["a", "b"], [["a", "c"]]) == {}


def test_analyzeskeleton_flow(project, tmp_path):
    root, _ = project
    T, nj = 20, 3
    rng = np.random.default_rng(0)
    labels = {"x": rng.uniform(0, 50, (T, nj)),
              "y": rng.uniform(0, 50, (T, nj)),
              "likelihoods": np.full((T, nj), 0.9)}
    scorer = "DLC_resnet50_SynthJan1shuffle1_9"
    out = {}
    for pkg, mod in (("jax", jax_skeleton), ("port", skeleton)):
        folder = tmp_path / pkg
        folder.mkdir()
        video = folder / "synthvid.avi"
        export.write_pose_h5(folder / f"{video.stem}{scorer}.h5", scorer,
                             ["bp0", "bp1", "bp2"], labels)
        out[pkg] = mod.analyzeskeleton(str(root / "config.yaml"), [video])
    assert [p.name for p in out["port"]] == [p.name for p in out["jax"]]
    dst = out["port"][0]
    assert (dst.with_suffix(".csv").read_bytes()
            == out["jax"][0].with_suffix(".csv").read_bytes())
    with h5py.File(dst) as f, h5py.File(out["jax"][0]) as g:
        assert set(f) == set(g) == {"bp0_bp1"}
        for k in g["bp0_bp1"]:
            np.testing.assert_array_equal(f["bp0_bp1"][k][()],
                                          g["bp0_bp1"][k][()])
        want = np.hypot(labels["x"][:, 1] - labels["x"][:, 0],
                        labels["y"][:, 1] - labels["y"][:, 0])
        np.testing.assert_allclose(f["bp0_bp1"]["length"][()], want)

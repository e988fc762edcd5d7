"""The port's ``analyze_videos`` and ``analyze_time_lapse_frames`` against
the JAX package's, on the CPU.

Both packages read one synthetic project (``make_synthetic_project``:
40 frames of 64x80, 6 labeled PNGs, 3 joints) with one JAX random-init
ResNet-50 snapshot saved as ``snapshot-step2-final--0``, as
``tests/test_parity_extras.py``'s fixture builds it, except that the
part_pred head is scaled by 0.1 (as ``tests/test_torch_infer.py`` does)
so the logits are O(1) and the likelihoods spread instead of saturating,
and the locref head by 0.05, so the DLC decode's offsets are a few px as a
trained head's are (its targets are offsets over locref_stdev = 7.28),
not the hundreds of px of the random init.
Each package writes into its own destination folder. Tolerances are those
of the same paths in ``tests/test_torch_infer.py`` and
``tests/test_torch_quant.py``:

* float32 paths (full frame, ``cropping``, ``scale``, ``dynamic``,
  ``num_outputs``, time-lapse): x / y within 1e-3 px, likelihood within
  1e-4 (float32 on the CPU, sums in another order);
* ``preset="fast"`` (scale 0.75 + residual int8): the act_scales within
  1e-5 relative, and with JAX's int8 state in both, x / y within 1e-2 px
  and likelihood within 1e-3 (the bounds of tests/test_torch_quant.py);
* the scorer string, the files written, the metadata pickle's keys and
  every metadata value but the clock readings: equal.
"""

import pickle
import shutil
from pathlib import Path

import h5py
import jax
import numpy as np
import pytest
import torch

from deepgraphpose_tpu.core import checkpoint as jax_ckpt
from deepgraphpose_tpu.infer import analyze as jax_analyze
from deepgraphpose_tpu.infer import export as jax_export
from deepgraphpose_tpu.models.pose_model import init_model as jax_init_model
from deepgraphpose_tpu.train.fit import resolve_project as jax_resolve
from deepgraphpose_tpu.utils.synthetic import make_synthetic_project
from deepgraphpose_tpu_torch.infer import analyze, export

XY_TOL, LIK_TOL = 1e-3, 1e-4
SNAPSHOT = "snapshot-step2-final--0"
CLOCK_KEYS = ("start", "stop", "run_duration")


def project_with_snapshot(root) -> tuple[Path, Path]:
    """The synthetic project under ``root`` with a JAX random-init
    ResNet-50 (part_pred head scaled by 0.1, locref by 0.05) saved as the
    step-2 final snapshot. Returns (project root, snapshot path)."""
    root, _, _ = make_synthetic_project(root)
    _, cfg, train_dir = jax_resolve(root, 1)
    _, variables = jax_init_model(cfg, jax.random.PRNGKey(0), (64, 80))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    for name, factor in (("part_pred", 0.1), ("locref_pred", 0.05)):
        head = variables["params"][name]["block4"]
        head["kernel"] = head["kernel"] * np.float32(factor)
        head["bias"] = head["bias"] * np.float32(factor)
    snap = jax_ckpt.save_snapshot(train_dir, 2, "final--0", variables)
    return Path(root), snap


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two torch threads while this file runs: the suite runs six files at
    once, and each torch process would otherwise start a thread a core."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    return project_with_snapshot(tmp_path_factory.mktemp("analyze") / "p")


@pytest.fixture(scope="module")
def video(project):
    return project[0] / "videos" / "synthvid.avi"


def both(project, tmp_path, videos, **kw):
    """analyze_videos of each package into tmp_path/{jax,port}: returns
    (scorer, {package: destination})."""
    cfg = project[0] / "config.yaml"
    dest = {"jax": tmp_path / "jax", "port": tmp_path / "port"}
    scorer = jax_analyze.analyze_videos(cfg, videos, destfolder=dest["jax"],
                                        **kw)
    assert analyze.analyze_videos(cfg, videos, destfolder=dest["port"],
                                  device="cpu", **kw) == scorer
    return scorer, dest


def tables(dest: dict, stem: str) -> dict:
    """{package: (scorer, bodyparts, labels, index)} from the H5 files,
    after checking the CSV holds the H5's values."""
    out = {}
    for pkg, folder in dest.items():
        out[pkg] = export.read_pose_table(folder / f"{stem}.h5")
        csv = export.load_pose_from_dlc(str(folder / f"{stem}.csv"))
        for key in ("x", "y", "likelihoods"):
            np.testing.assert_array_equal(csv[key], out[pkg][2][key])
    assert out["jax"][0] == out["port"][0]
    assert out["jax"][1] == out["port"][1]
    assert out["jax"][3] == out["port"][3]
    return out


def assert_close(got: dict, want: dict, xy_tol=XY_TOL, lik_tol=LIK_TOL):
    assert got["x"].shape == want["x"].shape
    for key in ("x", "y"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=xy_tol)
    np.testing.assert_allclose(got["likelihoods"], want["likelihoods"],
                               rtol=0, atol=lik_tol)


def metadata(folder: Path, stem: str) -> dict:
    with open(folder / f"{stem}includingmetadata.pickle", "rb") as f:
        return pickle.load(f)["data"]


def test_scorer_name_and_snapshot_resolution(project):
    from deepgraphpose_tpu.core.config import PoseConfig as JaxPoseConfig
    from deepgraphpose_tpu.core.config import ProjectConfig as JaxProject
    from deepgraphpose_tpu_torch.core.config import PoseConfig, ProjectConfig

    root, snap = project
    train_dir = snap.parent
    jp, pp = (JaxProject.from_yaml(root / "config.yaml"),
              ProjectConfig.from_yaml(root / "config.yaml"))
    for net in ("resnet_50", "resnet_101", "mobilenet_v2_0.35"):
        assert (analyze.get_scorer_name(pp, PoseConfig(net_type=net), 1, 7)
                == jax_analyze.get_scorer_name(
                    jp, JaxPoseConfig(net_type=net), 1, 7))
    got = analyze._resolve_snapshot(train_dir, pp, None)
    assert got == jax_analyze._resolve_snapshot(train_dir, jp, None)
    assert got == (snap, "0")
    assert (analyze._resolve_snapshot(train_dir, pp, SNAPSHOT)
            == jax_analyze._resolve_snapshot(train_dir, jp, SNAPSHOT))
    with pytest.raises(FileNotFoundError):
        analyze._resolve_snapshot(train_dir, pp, "snapshot-step2-missing")


def test_analyze_videos_full_frame_matches_jax(project, video, tmp_path):
    """The default path: the trajectories, the H5 and CSV layout, and the
    metadata pickle."""
    scorer, dest = both(project, tmp_path, [video], max_frames=16,
                        batchsize=8)
    assert scorer == "DLC_resnet50_SynthJan1shuffle1_0"
    stem = f"{video.stem}{scorer}"
    t = tables(dest, stem)
    assert_close(t["port"][2], t["jax"][2])
    assert t["port"][2]["x"].shape == (16, 3)
    want, got = metadata(dest["jax"], stem), metadata(dest["port"], stem)
    assert set(got) == set(want)
    for key in set(want) - set(CLOCK_KEYS) - {"DLC-model-config file"}:
        assert got[key] == want[key], key
    assert (set(got["DLC-model-config file"])
            == set(want["DLC-model-config file"]))


@pytest.mark.parametrize("kw", [
    dict(cropping=(8, 72, 4, 52)),
    dict(scale=0.75),
    dict(dynamic=(True, 0.5, 10)),
], ids=["cropping", "scale", "dynamic"])
def test_analyze_videos_modes_match_jax(project, video, tmp_path, kw):
    """Static crop (coordinates back in full-frame pixels), the resize
    lever and the tracked crop, within the float32 tolerances."""
    scorer, dest = both(project, tmp_path, [video], max_frames=24,
                        batchsize=8, **kw)
    stem = f"{video.stem}{scorer}"
    t = tables(dest, stem)
    assert_close(t["port"][2], t["jax"][2])
    assert np.isfinite(t["port"][2]["x"]).all()
    assert (metadata(dest["port"], stem)["cropping_parameters"]
            == metadata(dest["jax"], stem)["cropping_parameters"])


def test_analyze_videos_fast_preset_matches_jax(project, video, tmp_path,
                                                monkeypatch):
    """preset='fast' is scale 0.75 + the residual int8 carry, calibrated on
    the video's first 16 frames after the resize. Held in two parts:

    * calibration: the port's int8 sites take JAX's act_scale within 1e-5
      relative (as tests/test_torch_quant.py holds ``quantize_model``);
    * inference: with JAX's int8 state carried in
      (``quant_state_from_flax``), the port's trajectories are within
      1e-2 px and the likelihoods within 1e-3 (the bounds of
      test_estimate_pose_with_jax_int8_state_matches_jax).

    Each package on its own scales is not held to a px bound here: the
    int8 model of these random weights moves by whole pixels when its
    scales move by 1e-6 (tests/test_torch_quant.py), and at this size the
    two own-scale runs part by up to 2.08 px (``-s`` prints it).
    An unknown preset raises in both, before any work."""
    from deepgraphpose_tpu.models import quant as jax_quant
    from deepgraphpose_tpu_torch.core.checkpoint import quant_state_from_flax
    from deepgraphpose_tpu_torch.models import quant

    cfg = project[0] / "config.yaml"
    for fn, extra in ((jax_analyze.analyze_videos, {}),
                      (analyze.analyze_videos, {"device": "cpu"})):
        with pytest.raises(ValueError, match="preset"):
            fn(cfg, [video], destfolder=tmp_path, preset="turbo", **extra)

    made = {}

    def recording(module, key):
        original = module.quantize_model

        def wrapped(*args, **kw):
            made[key] = out = original(*args, **kw)
            made[key + "_kw"] = kw
            return out
        monkeypatch.setattr(module, "quantize_model", wrapped)

    recording(jax_quant, "jax")
    recording(quant, "port")
    kw = dict(max_frames=16, batchsize=8, preset="fast")
    scorer, dest = both(project, tmp_path / "own", [video], **kw)
    assert made["jax_kw"]["residual_int8"] and made["port_kw"]["residual_int8"]
    qvars = jax.tree_util.tree_map(np.asarray, made["jax"][1])
    assert set(made["port"].sites) == set(qvars["act_scale"])
    for site, q in made["port"].sites.items():
        want = float(qvars["act_scale"][site])
        assert abs(q.act_scale - want) <= 1e-5 * want, site
    own = tables(dest, f"{video.stem}{scorer}")
    assert np.isfinite(own["port"][2]["x"]).all()
    assert own["port"][2]["x"].max() <= 80 and own["port"][2]["y"].max() <= 64
    print("own scales, port against JAX: %.2f px" % max(
        np.abs(own["port"][2][k] - own["jax"][2][k]).max()
        for k in ("x", "y")))

    def with_jax_state(cfg_, model, calib, dtype, residual_int8):
        qmodel = quant.QuantizedPoseModel(cfg_, dtype=dtype,
                                          residual_int8=residual_int8)
        qmodel.load_state_dict(quant_state_from_flax(qvars), strict=True)
        return qmodel.eval()

    monkeypatch.setattr(quant, "quantize_model", with_jax_state)
    analyze.analyze_videos(cfg, [video], destfolder=tmp_path / "same",
                           device="cpu", **kw)
    got = export.read_pose_table(
        tmp_path / "same" / f"{video.stem}{scorer}.h5")[2]
    want = tables(dest, f"{video.stem}{scorer}")["jax"][2]
    assert_close(got, want, xy_tol=1e-2, lik_tol=1e-3)


def test_analyze_videos_num_outputs_matches_jax(project, video, tmp_path):
    """num_outputs=2: the top-k decode, suffixed columns, the H5's
    num_outputs attribute; the first peak equals the port's argmax
    decode."""
    scorer, dest = both(project, tmp_path, [video], max_frames=16,
                        batchsize=8, num_outputs=2)
    stem = f"{video.stem}{scorer}"
    data, attrs = {}, {}
    for pkg, folder in dest.items():
        with h5py.File(folder / f"{stem}.h5") as f:
            g = f["df_with_missing"]
            data[pkg] = g["data"][()]
            attrs[pkg] = dict(g.attrs)
            assert [c.decode() for c in g["coords"][()]][:6] == [
                "x", "y", "likelihood", "x2", "y2", "likelihood2"]
        lines = (folder / f"{stem}.csv").read_text().splitlines()
        assert len(lines) == 3 + 16
    assert attrs["port"] == attrs["jax"] and attrs["port"]["num_outputs"] == 2
    assert data["port"].shape == (16, 3 * 2 * 3)
    got = data["port"].reshape(16, 3, 2, 3)
    want = data["jax"].reshape(16, 3, 2, 3)
    np.testing.assert_allclose(got[..., :2], want[..., :2], rtol=0,
                               atol=XY_TOL)
    np.testing.assert_allclose(got[..., 2], want[..., 2], rtol=0,
                               atol=LIK_TOL)
    assert (np.diff(got[..., 2], axis=2) <= 0).all()


def test_analyze_videos_directory_videotype_skip_and_csv(project, video,
                                                         tmp_path):
    """A directory input filtered by videotype; skip-if-analyzed, under
    the scorer name and the legacy one; save_as_csv=False keeps only the
    H5 (and the metadata pickle)."""
    vdir = tmp_path / "videos"
    vdir.mkdir()
    shutil.copy(video, vdir / "a.avi")
    shutil.copy(video, vdir / "b.mp4")
    (vdir / "notes.txt").write_text("not a video")
    scorer, dest = both(project, tmp_path, [vdir], videotype="avi",
                        max_frames=8, batchsize=8, save_as_csv=False)
    listing = {pkg: sorted(p.name for p in d.iterdir())
               for pkg, d in dest.items()}
    assert listing["port"] == listing["jax"] == [
        f"a{scorer}.h5", f"a{scorer}includingmetadata.pickle"]

    # skip-if-analyzed: nothing is rewritten, with or without videotype
    h5 = dest["port"] / f"a{scorer}.h5"
    before = h5.stat().st_mtime_ns
    analyze.analyze_videos(project[0] / "config.yaml", [vdir / "a.avi"],
                           destfolder=dest["port"], max_frames=8,
                           batchsize=8, device="cpu")
    assert h5.stat().st_mtime_ns == before
    assert not (dest["port"] / f"a{scorer}.csv").exists()
    legacy = scorer.replace("DLC_", "DeepCut_")
    for pkg, fn, extra in (("jax", jax_analyze.analyze_videos, {}),
                           ("port", analyze.analyze_videos,
                            {"device": "cpu"})):
        shutil.copy(dest[pkg] / f"a{scorer}.h5",
                    dest[pkg] / f"b{legacy}.h5")
        fn(project[0] / "config.yaml", [vdir / "b.mp4"],
           destfolder=dest[pkg], max_frames=8, batchsize=8, **extra)
        assert not (dest[pkg] / f"b{scorer}.h5").exists()
    # the H5 tables of the analyzed video agree
    t = tables_h5_only(dest, f"a{scorer}")
    assert_close(t["port"], t["jax"])


def tables_h5_only(dest: dict, stem: str) -> dict:
    return {pkg: export.read_pose_table(folder / f"{stem}.h5")[2]
            for pkg, folder in dest.items()}


def test_analyze_time_lapse_frames_matches_jax(project, tmp_path):
    """A directory of the project's labeled PNGs, batched with a padded
    tail (6 frames, batch 4); the output beside the frames, CSV and H5."""
    root = project[0]
    dirs = {}
    for pkg in ("jax", "port"):
        dirs[pkg] = tmp_path / pkg / "frames"
        shutil.copytree(root / "labeled-data" / "synthvid", dirs[pkg])
    scorer = jax_analyze.analyze_time_lapse_frames(
        root / "config.yaml", dirs["jax"], frametype=".png", batchsize=4)
    assert analyze.analyze_time_lapse_frames(
        root / "config.yaml", dirs["port"], frametype=".png", batchsize=4,
        device="cpu") == scorer
    got = {pkg: export.read_pose_table(d / f"frames{scorer}.h5")
           for pkg, d in dirs.items()}
    assert got["port"][0] == got["jax"][0] == scorer
    assert got["port"][2]["x"].shape == (6, 3)
    assert_close(got["port"][2], got["jax"][2])
    back = jax_export.load_pose_from_dlc(
        str(dirs["port"] / f"frames{scorer}.csv"))
    np.testing.assert_array_equal(back["x"], got["port"][2]["x"])
    with pytest.raises(FileNotFoundError):
        analyze.analyze_time_lapse_frames(root / "config.yaml", tmp_path,
                                          frametype=".png", device="cpu")


def test_entry_points_need_the_card_by_default(project, video, tmp_path,
                                               monkeypatch):
    """device=None means the card; without one every new entry point
    raises before it reads a frame."""
    from deepgraphpose_tpu_torch.evaluation import metrics

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root, snap = project
    cfg = root / "config.yaml"
    calls = [
        lambda: analyze.analyze_videos(cfg, [video], destfolder=tmp_path),
        lambda: analyze.analyze_videos(cfg, [video], destfolder=tmp_path,
                                       num_outputs=2),
        lambda: analyze.analyze_time_lapse_frames(
            cfg, root / "labeled-data" / "synthvid"),
        lambda: metrics.evaluate_dgp(cfg, snap),
        lambda: metrics.evaluate_dgp(cfg, snap, decode="dlc"),
        lambda: metrics.evaluate_network(cfg),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert not list(tmp_path.iterdir())

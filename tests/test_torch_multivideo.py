"""Multi-video DGP training (BASELINE config 4: a videos_dgp set with
per-video hidden-frame sampling) in the port, against the JAX package on
its own two-video project (``tests/test_multivideo.py``'s fixture).

* ``MultiDataset`` over the two videos: the per-video sampling ratios,
  the labeled and hidden frames, equal to the JAX package's;
* the batch schedule mixes the videos, and equals the JAX package's;
* fit_dgp over both videos from one JAX-written warm start
  (``resnet_tiny``, no augmentation: the two packages draw it from
  different generators) in four runs against the JAX package's same run:
  one frame pool a video; wt > 0 with the flow made from each gathered
  window (``device_flow=True``); rotating segments over a patched pool
  budget; and ``windows_per_device=2``, whose groups never mix videos.
  Bounds: every logged loss within 1e-4 relative
  (``tests/test_torch_fit.py``), the final parameters ``rtol=1e-4,
  atol=1e-5`` (the JAX package's bound for its fit runs,
  ``tests/test_fit_dp.py:237-243``): the root conv of these weights is
  scaled down 100 times, so its updates are large against its values and
  the two packages' float32 sums part on it by 1e-6 absolute. Each run
  takes four schedule windows (four updates, or two of two windows): run
  longer, the float32 trajectories of these random weights part past
  1e-4, as the JAX package's own run parts from itself under a 1e-7
  nudge of its warm start (ten spill updates: the port's eighth loss
  1.6% from the JAX package's, the JAX package's 1.2% from its nudged
  twin's; ``tests/test_torch_fit.py::
  test_free_running_chain_parts_as_jax_does`` holds the same on one
  video).
"""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from deepgraphpose_tpu.core import checkpoint as jax_ckpt
from deepgraphpose_tpu.core.config import PoseConfig as JaxPoseConfig
from deepgraphpose_tpu.data import batcher as jax_batcher
from deepgraphpose_tpu.models.pose_model import PoseModel as JaxPoseModel
from deepgraphpose_tpu.train import device_data as jax_dd
from deepgraphpose_tpu.train import fit as jax_fit
from deepgraphpose_tpu.utils.synthetic import make_synthetic_project
from deepgraphpose_tpu_torch.core import paths
from deepgraphpose_tpu_torch.data import batcher
from deepgraphpose_tpu_torch.train import device_data as dd
from deepgraphpose_tpu_torch.train import fit
from test_torch_fit import (LOSS_RTOL, assert_losses_close,  # noqa: F401
                            final_params, logged_losses, project_copy,
                            tiny_blocks, two_threads, work)
from test_torch_fit_dp import (PARAM_ATOL, PARAM_RTOL,
                               assert_allclose_states)
from test_torch_train import random_variables

WARM = "snapshot-step9-warm"
HW = (64, 80)
# 64x80 frames (15360 bytes): the two videos' pools (about 1.2 MB) spill
# under 400 KB, and a 200 KB segment holds a video's labeled frames (6 or
# 4) and a window's other frames
BUDGET = 400_000


@pytest.fixture(scope="module")
def two_video_project(tmp_path_factory):
    """``tests/test_multivideo.py``'s project: two videos, both labeled
    and in videos_dgp/; here on resnet_tiny with a JAX-written warm start
    WARM."""
    import cv2

    from deepgraphpose_tpu.data import project as project_io

    root = tmp_path_factory.mktemp("mvproj") / "p"
    make_synthetic_project(root, n_frames=40, n_labeled=6, hw=HW)
    rng = np.random.default_rng(7)
    h, w, n2, nj = *HW, 36, 3
    t = np.arange(n2)
    cx = w / 2 + (w / 3) * np.cos(2 * np.pi * t[:, None] / 17
                                  + np.arange(nj))
    cy = h / 2 + (h / 3) * np.sin(2 * np.pi * t[:, None] / 13
                                  + np.arange(nj) * 2)
    vpath = root / "videos" / "secondvid.avi"
    wr = cv2.VideoWriter(str(vpath), cv2.VideoWriter_fourcc(*"MJPG"), 20.0,
                         (w, h))
    for f in range(n2):
        frame = rng.integers(0, 40, (h, w, 3), dtype=np.uint8)
        for j in range(nj):
            cv2.circle(frame, (int(cx[f, j]), int(cy[f, j])), 4,
                       (240, 240, 240), -1)
        wr.write(frame)
    wr.release()
    shutil.copy(vpath, root / "videos_dgp" / "secondvid.avi")
    lab_idx = np.array([3, 12, 21, 30])
    (root / "labeled-data" / "secondvid").mkdir()
    project_io.write_collected_data_csv(
        root / "labeled-data/secondvid/CollectedData_synth.csv",
        project_io.Labels(
            scorer="synth", bodyparts=[f"bp{i}" for i in range(nj)],
            image_paths=[f"labeled-data/secondvid/img{i:03d}.png"
                         for i in lab_idx],
            coords_xy=np.stack([cx[lab_idx], cy[lab_idx]], axis=-1)))
    cfg_path = root / "config.yaml"
    proj = yaml.safe_load(cfg_path.read_text())
    proj["video_sets"]["videos/secondvid.avi"] = {"crop": f"0, {w}, 0, {h}"}
    cfg_path.write_text(yaml.safe_dump(proj, sort_keys=False))

    _, cfg, train_dir = paths.resolve_project(root)
    cfg.net_type = "resnet_tiny"
    cfg.to_yaml(train_dir / "pose_cfg.yaml")
    with tiny_blocks():
        variables = random_variables(
            JaxPoseModel(JaxPoseConfig(net_type="resnet_tiny",
                                       num_joints=nj)), HW, seed=3)
    jax_ckpt.save_snapshot(train_dir, 9, "warm", variables)
    yield root
    shutil.rmtree(root.parent, ignore_errors=True)


def datasets(package, root: Path, cache: Path):
    proj, cfg, _ = package.resolve_project(root, 1)
    videos = package.dgp_video_sets(proj, root)
    mds = (batcher if package is fit else jax_batcher).MultiDataset(
        proj, cfg, videos, ns=1, n_max_frames=30, cache_dir=cache)
    return videos, mds


def test_multidataset_two_videos(two_video_project, tmp_path):
    videos, mds = datasets(fit, two_video_project, tmp_path / "port")
    jvideos, jmds = datasets(jax_fit, two_video_project, tmp_path / "jax")
    assert videos == jvideos and len(videos) == 2
    assert len(mds.datasets) == 2
    # per-video sampling ratios proportional to labeled-frame counts
    # (ref: dataset.py:867-871): synthvid has 6 labels, secondvid 4
    n_labels = {"synthvid": 6, "secondvid": 4}
    want = np.array([n_labels[Path(v).stem] for v in videos]) / 10
    np.testing.assert_allclose(mds.batch_ratios, want, atol=1e-6)
    np.testing.assert_array_equal(mds.batch_ratios, jmds.batch_ratios)
    assert mds.n_visible_frames_total == jmds.n_visible_frames_total == 10
    assert mds.n_hidden_frames_total == jmds.n_hidden_frames_total
    for d, jd in zip(mds.datasets, jmds.datasets):
        assert len(d.hidden_frames) > 0
        for key in ("visible_frames", "hidden_frames", "chunk"):
            np.testing.assert_array_equal(getattr(d, key), getattr(jd, key))
        np.testing.assert_array_equal(d.labels_rc, jd.labels_rc)


def test_schedule_mixes_videos():
    vis = [np.array([5, 20]), np.array([8, 30])]
    hid = [np.arange(0, 40, 3), np.arange(1, 36, 3)]
    chunks = [np.sort(np.concatenate([v, h])) for v, h in zip(vis, hid)]
    kw = dict(batch_size=4, n_times_all_frames=4, maxiters=100, seed=0)
    sched = batcher.generate_batch_schedule(vis, hid, chunks, **kw)
    want = jax_batcher.generate_batch_schedule(vis, hid, chunks, **kw)
    assert {ds for ds, _ in sched} == {0, 1}
    assert [(ds, f.tolist()) for ds, f in sched] == \
        [(ds, f.tolist()) for ds, f in want]


RUNS = {
    "pooled": dict(),
    "device_flow": dict(wt=1.0, device_flow=True),
    "spill": dict(),
    "windows": dict(windows_per_device=2),
}


@pytest.mark.parametrize("run", list(RUNS))
def test_fit_dgp_two_videos(two_video_project, work, monkeypatch, capsys,
                            run):
    kw = dict(snapshot=WARM, batch_size=3, maxiters=4, displayiters=1,
              saveiters=100, nepoch=2, n_max_frames=16, aug=False,
              **RUNS[run])
    if run == "spill":
        monkeypatch.setattr(dd, "DEFAULT_POOL_BUDGET_BYTES", BUDGET)
        monkeypatch.setattr(jax_dd, "DEFAULT_POOL_BUDGET_BYTES", BUDGET)
    roots = {name: project_copy(two_video_project, work / name)
             for name in ("jax", "port")}
    with tiny_blocks():
        jax_fit.fit_dgp(dlcpath=roots["jax"], **kw)
        capsys.readouterr()
        if run == "windows":
            mixed = []
            group_schedule = fit._group_schedule_dp

            def spy(schedule, n_dp, rng):
                groups = group_schedule(schedule, n_dp, rng)
                of = {0: set(), 1: set()}
                for ds, f in schedule:
                    of[ds].add(tuple(f.tolist()))
                mixed.extend(ds for ds, grp in groups for f in grp
                             if tuple(f.tolist()) not in of[ds])
                assert {ds for ds, _ in groups} == {0, 1}
                return groups

            monkeypatch.setattr(fit, "_group_schedule_dp", spy)
        final = fit.fit_dgp(dlcpath=roots["port"], device="cpu", **kw)
    out = capsys.readouterr().out
    line = next(x for x in out.splitlines() if "frame pools" in x)
    assert ("segment-rotating" in line) == (run == "spill")
    assert ("LK flow" in line) == (run == "device_flow")
    if run == "windows":
        assert "2 windows/update" in line and mixed == []
    assert final.exists()
    got, want = logged_losses(roots["port"]), logged_losses(roots["jax"])
    assert got and np.isfinite([v for _, v in got]).all()
    assert_losses_close(got, want, LOSS_RTOL)
    assert_allclose_states(final_params(roots["port"], 2),
                           final_params(roots["jax"], 2), PARAM_RTOL,
                           PARAM_ATOL)

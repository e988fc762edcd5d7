"""The slice end to end: the port's full-video inference against the JAX
package on the synthetic project's video (64x80, 20 frames, batch 8).

The JAX ``init_model("resnet_50")`` weights are carried into the port
through ``state_dict_from_flax``; the part_pred head is scaled by 0.1 in
both so the logits are O(1) and the likelihoods spread instead of
saturating at 1. Tolerances: x/y 1e-3 px and likelihood 1e-4 (float32 on
the CPU, sums in another order); ``cropped`` exactly.
"""

import h5py
import jax
import numpy as np
import pytest
import torch

from deepgraphpose_tpu.core.config import PoseConfig as JaxPoseConfig
from deepgraphpose_tpu.infer import dynamic as jax_dynamic
from deepgraphpose_tpu.infer import export as jax_export
from deepgraphpose_tpu.infer import predict as jax_predict
from deepgraphpose_tpu.models.pose_model import init_model as jax_init_model
from deepgraphpose_tpu_torch.core.checkpoint import state_dict_from_flax
from deepgraphpose_tpu_torch.core.config import PoseConfig
from deepgraphpose_tpu_torch.data.video import VideoReader
from deepgraphpose_tpu_torch.infer import dynamic, export, predict
from deepgraphpose_tpu_torch.models.pose_model import PoseModel

NAMES = ["a", "b", "c"]


@pytest.fixture(scope="module")
def models():
    jcfg = JaxPoseConfig(num_joints=3, all_joints_names=NAMES)
    jmodel, jvars = jax_init_model(jcfg, jax.random.PRNGKey(0), (64, 80))
    jvars = jax.tree_util.tree_map(np.asarray, jvars)
    head = jvars["params"]["part_pred"]["block4"]
    head["kernel"] = head["kernel"] * np.float32(0.1)
    head["bias"] = head["bias"] * np.float32(0.1)
    cfg = PoseConfig(num_joints=3, all_joints_names=NAMES)
    model = PoseModel(cfg)
    model.load_state_dict(state_dict_from_flax(jvars), strict=True)
    return jcfg, jmodel, jvars, cfg, model.eval()


@pytest.fixture(scope="module")
def video(synthetic_project):
    return synthetic_project[0] + "/videos/synthvid.avi"


def test_estimate_pose_matches_jax(models, video, tmp_path):
    jcfg, jmodel, jvars, cfg, model = models
    want = jax_predict.estimate_pose(
        None, tmp_path / "snap.ckpt", video, tmp_path / "jax", pose_cfg=jcfg,
        model=jmodel, variables=jvars, batch_size=8, max_frames=20)
    got = predict.estimate_pose(
        None, tmp_path / "snap.ckpt", video, tmp_path / "port", pose_cfg=cfg,
        model=model, batch_size=8, max_frames=20, device="cpu")
    assert got["x"].shape == (20, 3)
    for key in ("x", "y"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["likelihoods"], want["likelihoods"],
                               rtol=0, atol=1e-4)
    assert 0.05 < got["likelihoods"].min() and got["likelihoods"].max() < 1

    # the port's files read back through the JAX package's readers
    back = jax_export.load_pose_from_dlc(str(tmp_path / "port/synthvid.csv"))
    back_h5 = jax_export.load_pose_h5(str(tmp_path / "port/synthvid.h5"))
    for key in ("x", "y", "likelihoods"):
        np.testing.assert_array_equal(back[key], got[key])
        np.testing.assert_array_equal(back_h5[key], got[key])

    # skip-if-CSV: no model, no snapshot, no video decode, same values
    again = predict.estimate_pose(
        None, tmp_path / "missing.ckpt", video, tmp_path / "port",
        pose_cfg=cfg, batch_size=8, max_frames=20, device="cpu")
    for key in ("x", "y", "likelihoods"):
        np.testing.assert_array_equal(again[key], got[key])


def test_export_is_byte_compatible(tmp_path, rng):
    labels = {"x": rng.uniform(0, 100, (6, 3)),
              "y": rng.uniform(0, 100, (6, 3)),
              "likelihoods": rng.uniform(0, 1, (6, 3))}
    jax_export.export_pose_like_dlc(labels, "scorer", NAMES,
                                    str(tmp_path / "jax"))
    export.export_pose_like_dlc(labels, "scorer", NAMES,
                                str(tmp_path / "port"))
    assert ((tmp_path / "jax.csv").read_bytes()
            == (tmp_path / "port.csv").read_bytes())
    with h5py.File(tmp_path / "jax.h5") as a, h5py.File(tmp_path / "port.h5") as b:
        ga, gb = a["df_with_missing"], b["df_with_missing"]
        assert set(ga) == set(gb) and dict(ga.attrs) == dict(gb.attrs)
        for name in ga:
            assert ga[name].dtype == gb[name].dtype
            np.testing.assert_array_equal(ga[name][()], gb[name][()])
    back = export.load_pose_h5(str(tmp_path / "jax.h5"))
    np.testing.assert_array_equal(back["y"], labels["y"])


def test_scale_crop_compose_matches_jax(models, video, tmp_path):
    """crop applies after the resize (box in resized pixels); coordinates
    come back in original-video pixels."""
    jcfg, jmodel, jvars, cfg, model = models
    kw = dict(save_pose=False, scale=0.75, crop=(12, 8, 44, 40),
              batch_size=4, max_frames=4)
    want = jax_predict.estimate_pose(None, tmp_path / "s.ckpt", video,
                                     tmp_path, pose_cfg=jcfg, model=jmodel,
                                     variables=jvars, **kw)
    got = predict.estimate_pose(None, tmp_path / "s.ckpt", video, tmp_path,
                                pose_cfg=cfg, model=model, device="cpu", **kw)
    for key in ("x", "y"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["likelihoods"], want["likelihoods"],
                               rtol=0, atol=1e-4)


def test_estimate_pose_dynamic_matches_jax(models, video):
    """Tracked crop: the same mu / likelihoods and exactly the same
    ``cropped`` flags, with both cropped and lost (re-run) frames."""
    jcfg, jmodel, jvars, cfg, model = models
    reader = VideoReader(video)
    frames = np.stack([f for _, f in reader.iter_frames(0, 20)])
    reader.close()
    kw = dict(crop_hw=(48, 64), chunk=8, detection_threshold=0.8)
    want = jax_dynamic.estimate_pose_dynamic(jmodel, jcfg, jvars, frames,
                                             **kw)
    got = dynamic.estimate_pose_dynamic(model, cfg, frames, device="cpu",
                                        **kw)
    np.testing.assert_array_equal(got["cropped"], want["cropped"])
    assert got["cropped"].any() and not got["cropped"].all()
    np.testing.assert_allclose(got["mu"], want["mu"], rtol=0,
                               atol=1e-3 / cfg.stride)
    np.testing.assert_allclose(got["likelihoods"], want["likelihoods"],
                               rtol=0, atol=1e-4)


def test_estimate_pose_dynamic_video_matches_jax(models, synthetic_project,
                                                 video, tmp_path):
    """The video entry point from a project and a JAX snapshot on disk:
    resolve_project, load_snapshot + the weights bridge, streamed
    tracking, DLC export."""
    _, _, jvars, _, _ = models
    from deepgraphpose_tpu.core.checkpoint import save_snapshot

    snap = save_snapshot(tmp_path, 0, "final--0", jvars)
    proj_cfg = synthetic_project[0] + "/config.yaml"
    kw = dict(crop_hw=(48, 64), batch_size=8, max_frames=20,
              detection_threshold=0.8)
    want = jax_dynamic.estimate_pose_dynamic_video(
        proj_cfg, snap, video, tmp_path / "jax", **kw)
    got = dynamic.estimate_pose_dynamic_video(
        proj_cfg, snap, video, tmp_path / "port", device="cpu", **kw)
    np.testing.assert_array_equal(got["cropped"], want["cropped"])
    assert got["cropped"].any() and not got["cropped"].all()
    for key in ("x", "y"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["likelihoods"], want["likelihoods"],
                               rtol=0, atol=1e-4)
    back = jax_export.load_pose_from_dlc(str(tmp_path / "port/synthvid.csv"))
    np.testing.assert_array_equal(back["x"], got["x"])


def test_crop_origin_matches_jax_rounding():
    """float32 center, int32 truncation, then clip (dynamic.py:57-58)."""
    import jax.numpy as jnp

    for center in [(0.0, 0.0), (31.99, 40.5), (-7.3, 1e4), (47.9999, 24.0),
                   (23.5, 200.25)]:
        c = jnp.asarray(center, jnp.float32)
        want = (int(jnp.clip((c[0] - 48 // 2).astype(jnp.int32), 0, 64 - 48)),
                int(jnp.clip((c[1] - 32 // 2).astype(jnp.int32), 0, 80 - 32)))
        assert dynamic.crop_origin(center, (64, 80), (48, 32)) == want


def test_entry_points_need_the_card_by_default(models, video, tmp_path,
                                               monkeypatch):
    """device=None means the card; without one the call raises instead of
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, _, cfg, model = models
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        predict.estimate_pose(None, tmp_path / "s.ckpt", video, tmp_path,
                              pose_cfg=cfg, model=model, max_frames=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dynamic.estimate_pose_dynamic(model, cfg,
                                      np.zeros((2, 64, 80, 3), np.uint8))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        predict.estimate_pose(None, tmp_path / "s.ckpt", video, tmp_path,
                              pose_cfg=cfg, model=model, quantize=True,
                              max_frames=2)

"""The port held directly against the TF1 graph: a raw-``tf.nn``
reconstruction of slim ``resnet_v1_50`` + the DGP prediction layers +
``argmax_2d_from_cm`` (``tests/tf_reference_net.py``), fed the weights the
port's ``export_tf_arrays`` writes, beside the port's CPU forward and
``estimate_pose``.

``tests/test_tf_parity.py``'s cases and bounds, for the port: backbone
features, part_pred and locref logits within 1e-4 of the largest value
(rtol 1e-4), the soft-argmax within 1e-3 cells and its smoothed maps
within 1e-5, at 64x64, 100x100 (slim's VALID pool and conv2d_same give 12
cells where plain SAME arithmetic gives 14) and 75x100; the backbone at
output stride 8 (two dilated blocks); and the whole ``estimate_pose``
(video decode, crop, likelihood neighbourhood, pixel conversion) within
0.25 px and 1e-2 likelihood of a frame-at-a-time replay of the
reference's eval loop, with and without the crop.
"""

import numpy as np
import pytest
import torch

from deepgraphpose_tpu_torch.core.config import PoseConfig
from deepgraphpose_tpu_torch.data.video import VideoReader
from deepgraphpose_tpu_torch.infer.predict import estimate_pose
from deepgraphpose_tpu_torch.models.pose_model import init_model, \
    scoremap_size
from deepgraphpose_tpu_torch.models.tf_import import export_tf_arrays
from deepgraphpose_tpu_torch.ops.softargmax import softargmax_2d

tf = pytest.importorskip("tensorflow")

from tf_reference_net import (reference_forward,  # noqa: E402
                              slim_resnet_features)

NJ = 3


def _config(**kw) -> PoseConfig:
    return PoseConfig(num_joints=NJ, net_type="resnet_50",
                      all_joints_names=[f"bp{i}" for i in range(NJ)], **kw)


def _randomized_model(cfg: PoseConfig, seed: int = 0):
    """A seeded port model with its batch-norm affine and statistics and
    its head biases perturbed (as tests/test_tf_parity.py perturbs its
    flax tree), so the parity is not trivial."""
    model = init_model(cfg, torch.Generator().manual_seed(seed),
                       device="cpu")
    rng = np.random.default_rng(seed)
    state = {}
    for key, value in model.state_dict().items():
        leaf, shape = key.rsplit(".", 1)[-1], tuple(value.shape)
        if leaf == "scale":
            value = value * torch.from_numpy(
                rng.uniform(0.8, 1.2, shape).astype(np.float32))
        elif leaf in ("bias", "mean"):
            value = value + torch.from_numpy(
                rng.normal(0, 0.1, shape).astype(np.float32))
        elif leaf == "var":
            value = torch.from_numpy(
                rng.uniform(0.8, 1.2, shape).astype(np.float32))
        state[key] = value
    model.load_state_dict(state)
    return model


@torch.no_grad()
def _port_forward(model, images):
    out = model(torch.from_numpy(images),
                heads=("features", "part_pred", "locref"))
    return {k: v.float().numpy() for k, v in out.items()}


@pytest.mark.parametrize("hw", [(64, 64), (100, 100), (75, 100)])
def test_forward_parity_vs_tf_reconstruction(hw):
    cfg = _config()
    model = _randomized_model(cfg)
    arrays = export_tf_arrays(model.state_dict(), "resnet_50")
    rng = np.random.default_rng(1)
    images = rng.integers(0, 255, (2, *hw, 3)).astype(np.float32)

    port = _port_forward(model, images)
    ref = reference_forward(arrays, images, NJ, gamma=1.0, gauss_len=2.0)

    assert port["features"].shape == ref["features"].shape
    assert port["part_pred"].shape == ref["part_pred"].shape
    assert port["part_pred"].shape[1:3] == scoremap_size(cfg, hw)
    for key in ("features", "part_pred", "locref"):
        scale = np.abs(ref[key]).max()
        np.testing.assert_allclose(port[key], ref[key], atol=1e-4 * scale,
                                   rtol=1e-4, err_msg=key)

    mu, smoothed = softargmax_2d(torch.from_numpy(port["part_pred"]),
                                 gamma=1.0, gauss_len=2.0)
    np.testing.assert_allclose(mu.numpy(), ref["mu"], atol=1e-3)
    np.testing.assert_allclose(smoothed.numpy(), ref["smoothed"], atol=1e-5)


def test_scoremap_dims_divergent_size():
    cfg = _config()
    assert scoremap_size(cfg, (100, 100)) == (12, 12)
    assert scoremap_size(cfg, (64, 64)) == (8, 8)
    assert scoremap_size(cfg, (747, 832)) == (94, 104)


def test_backbone_parity_atrous_output_stride_8():
    model = _randomized_model(_config(output_stride=8), seed=2)
    arrays = export_tf_arrays(model.state_dict(), "resnet_50")
    images = np.random.default_rng(3).integers(
        0, 255, (1, 64, 64, 3)).astype(np.float32)
    feats = _port_forward(model, images)["features"]
    feats_t = slim_resnet_features(arrays, images, "resnet_50",
                                   output_stride=8)
    assert feats_t.shape == feats.shape == (1, 8, 8, 2048)
    scale = np.abs(feats_t).max()
    np.testing.assert_allclose(feats, feats_t, atol=1e-4 * scale, rtol=1e-4)


def _reference_estimate_pose(arrays, cfg, frames_u8, crop=None):
    """The reference's estimate_pose frame loop (ref: eval.py:306-372) on
    the TF reconstruction: a forward a frame, the 2x2 neighbourhood
    likelihood, mu * stride + stride / 2 in pixels."""
    xs, ys, liks = [], [], []
    for frame in frames_u8:
        if crop is not None:
            x0, y0, x1, y1 = crop
            frame = frame[y0:y1, x0:x1]
        out = reference_forward(arrays, frame[None].astype(np.float32),
                                cfg.num_joints, gamma=cfg.gamma,
                                gauss_len=cfg.gauss_len)
        mu = np.asarray(out["mu"])[0]
        part = np.asarray(out["part_pred"])[0]
        lik = np.zeros(cfg.num_joints)
        for j in range(cfg.num_joints):
            sig = 1.0 / (1.0 + np.exp(-part[:, :, j]))
            f = np.floor(mu[j]).astype(int)
            c = np.ceil(mu[j]).astype(int) + 1
            win = sig[f[0]:c[0], f[1]:c[1]]
            r_, c_ = np.unravel_index(np.argmax(win), win.shape)
            lik[j] = sig[f[0] + r_, f[1] + c_]
        xs.append(mu[:, 1] * cfg.stride + 0.5 * cfg.stride)
        ys.append(mu[:, 0] * cfg.stride + 0.5 * cfg.stride)
        liks.append(lik)
    return np.asarray(xs), np.asarray(ys), np.asarray(liks)


def test_estimate_pose_pipeline_parity_vs_tf(tmp_path):
    import cv2

    hw = (96, 128)
    cfg = _config(compute_dtype="float32")
    model = _randomized_model(cfg, seed=3)
    arrays = export_tf_arrays(model.state_dict(), "resnet_50")

    rng = np.random.default_rng(0)
    vid = tmp_path / "clip.avi"
    wr = cv2.VideoWriter(str(vid), cv2.VideoWriter_fourcc(*"MJPG"), 10.0,
                         (hw[1], hw[0]))
    for i in range(5):
        f = rng.integers(0, 40, (*hw, 3)).astype(np.uint8)
        r0, c0 = 20 + 8 * i, 30 + 10 * i
        f[r0:r0 + 12, c0:c0 + 12] = 230
        wr.write(f[:, :, ::-1])
    wr.release()
    reader = VideoReader(vid)
    decoded = np.stack([reader.read_frame(i) for i in range(5)])
    reader.close()

    for crop in (None, (16, 8, 112, 88)):
        ours = estimate_pose(None, "snapshot-step2-final--0", vid,
                             tmp_path / "out", save_pose=False, crop=crop,
                             pose_cfg=cfg, model=model,
                             compute_dtype="float32", device="cpu")
        xr, yr, lik = _reference_estimate_pose(arrays, cfg, decoded,
                                               crop=crop)
        # the reference leaves a cropped run's coordinates in crop space
        # (eval.py:317-322 against 352-356); the port returns full-frame
        # pixels: compare in crop space
        x0, y0 = (crop[0], crop[1]) if crop else (0, 0)
        dx = np.abs(np.asarray(ours["x"]) - x0 - xr).max()
        dy = np.abs(np.asarray(ours["y"]) - y0 - yr).max()
        dl = np.abs(np.asarray(ours["likelihoods"]) - lik).max()
        assert dx < 0.25 and dy < 0.25, (crop, dx, dy)
        assert dl < 1e-2, (crop, dl)

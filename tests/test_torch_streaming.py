"""The port's time-sharded streaming inference (``parallel/streaming.py``)
against the JAX package's on the CPU.

The JAX side shards time over the suite's 8 virtual CPU devices
(``tests/conftest.py``); the port runs a data group of world 1 (the
two-rank run is held in ``tests/test_torch_fit_dp.py``). Cases and bounds
are ``tests/test_streaming.py``'s:

* the smoother against ``ewma_reference`` and against the JAX smoother,
  ``rtol=atol=1e-5``; a constant track is its fixed point (1e-6); a
  track streamed in two halves with the carry threaded equals the whole
  (1e-5);
* ``make_time_sharded_infer_fn`` on the one-unit-per-block ResNet at
  32x32 against the JAX package's on 8 devices and its unsharded infer:
  mu and likelihood 1e-4, the displacement 1e-3, 0 at frame 0;
* ``estimate_pose_multichip`` on the synthetic project's video against
  the JAX package's (the same snapshot, ``smooth=True``): x/y 1e-3 px,
  likelihood and displacement 1e-4 (``tests/test_torch_infer.py``'s
  bounds for the full-video path), the CSV/H5 written; with
  ``quantize=True`` finite and of the right shape (as the JAX test
  holds it), and within 1e-4 px of the port's own ``estimate_pose``
  (``quantize=True``, calibrated on the same 8 frames, one batch a
  super-batch).
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepgraphpose_tpu.core import checkpoint as jax_ckpt
from deepgraphpose_tpu.core.config import PoseConfig as JaxPoseConfig
from deepgraphpose_tpu.models import resnet as jax_resnet
from deepgraphpose_tpu.models.pose_model import PoseModel as JaxPoseModel
from deepgraphpose_tpu.parallel import mesh as jax_mesh
from deepgraphpose_tpu.parallel import streaming as jax_streaming
from deepgraphpose_tpu_torch.core import checkpoint as ckpt
from deepgraphpose_tpu_torch.core import paths
from deepgraphpose_tpu_torch.core.config import PoseConfig
from deepgraphpose_tpu_torch.infer import predict
from deepgraphpose_tpu_torch.models import resnet as torch_resnet
from deepgraphpose_tpu_torch.models.pose_model import PoseModel
from deepgraphpose_tpu_torch.parallel import mesh, streaming
from test_torch_train import random_variables

SMOOTH_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two torch threads while this file runs, as tests/test_torch_fit.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    return jax_mesh.make_mesh(8)


@pytest.fixture
def group():
    return mesh.make_mesh(1, "cpu")


@pytest.fixture
def tiny_resnet(monkeypatch):
    """A ResNet-v1 with one unit per block, registered in both packages."""
    monkeypatch.setitem(jax_resnet.BLOCK_UNITS, "resnet_tiny", (1, 1, 1, 1))
    monkeypatch.setitem(torch_resnet.BLOCK_UNITS, "resnet_tiny", (1, 1, 1, 1))
    return "resnet_tiny"


def track(rng, t, nj, offset):
    mu = rng.standard_normal((t, nj, 2)) * 10 + offset
    lik = rng.uniform(0, 1, (t, nj))
    lik[0] = 0.9  # confident start
    return mu, lik


def test_ewma_reference_is_the_jax_packages(rng):
    mu, lik = track(rng, 40, 3, 50)
    np.testing.assert_array_equal(
        streaming.ewma_reference(mu, lik, 0.6, 0.4),
        jax_streaming.ewma_reference(mu, lik, 0.6, 0.4))


def test_smoother_matches_sequential_reference_and_jax(mesh8, group, rng):
    mu, lik = track(rng, 64, 4, 50)
    got = streaming.make_time_sharded_smoother(group, alpha=0.6,
                                               pcutoff=0.4)(mu, lik)
    want = streaming.ewma_reference(mu, lik, alpha=0.6, pcutoff=0.4)
    np.testing.assert_allclose(got.numpy(), want, rtol=SMOOTH_TOL,
                               atol=SMOOTH_TOL)
    jax_got = jax_streaming.make_time_sharded_smoother(
        mesh8, alpha=0.6, pcutoff=0.4)(jnp.asarray(mu), jnp.asarray(lik))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_got),
                               rtol=SMOOTH_TOL, atol=SMOOTH_TOL)


def test_smoother_constant_track_is_fixed_point(group):
    t, nj = 32, 2
    mu = np.tile(np.array([[3.0, 7.0], [1.0, 2.0]])[None], (t, 1, 1))
    lik = np.full((t, nj), 0.99)
    got = streaming.make_time_sharded_smoother(group)(mu, lik)
    np.testing.assert_allclose(got.numpy(), mu, rtol=1e-6)


def test_smoother_carry_across_super_batches(group, rng):
    """A track streamed through the smoother in two halves with the carry
    threaded equals the whole track smoothed at once."""
    mu, lik = track(rng, 64, 3, 40)
    smooth = streaming.make_time_sharded_smoother(group, alpha=0.6,
                                                  pcutoff=0.4)
    whole = smooth(mu, lik)
    first = smooth(mu[:32], lik[:32])
    second = smooth(mu[32:], lik[32:], first[31], torch.ones(1))
    streamed = torch.cat([first, second]).numpy()
    np.testing.assert_allclose(streamed, whole.numpy(), rtol=SMOOTH_TOL,
                               atol=SMOOTH_TOL)
    np.testing.assert_allclose(whole.numpy(), streaming.ewma_reference(
        mu, lik, 0.6, 0.4), rtol=SMOOTH_TOL, atol=SMOOTH_TOL)


def test_time_sharded_infer_matches_jax(mesh8, group, tiny_resnet, rng):
    from deepgraphpose_tpu.infer.predict import make_infer_fn

    nj, hw = 3, (32, 32)
    kw = dict(net_type=tiny_resnet, num_joints=nj,
              all_joints_names=[f"bp{i}" for i in range(nj)])
    jm = JaxPoseModel(JaxPoseConfig(**kw))
    variables = random_variables(jm, hw)
    frames = rng.integers(0, 255, (16, *hw, 3), dtype=np.uint8)

    mu_s, lik_s, disp_s = jax_streaming.make_time_sharded_infer_fn(
        jm, JaxPoseConfig(**kw), mesh8)(variables, jnp.asarray(frames))
    mu_u, _ = make_infer_fn(jm, JaxPoseConfig(**kw))(variables,
                                                     jnp.asarray(frames))
    model = PoseModel(PoseConfig(**kw))
    model.load_state_dict(ckpt.state_dict_from_flax(variables), strict=True)
    mu, lik, disp = streaming.make_time_sharded_infer_fn(
        model.eval(), PoseConfig(**kw), group)(frames)
    for got, want in ((mu, mu_s), (lik, lik_s), (mu, mu_u)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)
    np.testing.assert_allclose(disp.numpy(), np.asarray(disp_s), rtol=1e-3,
                               atol=1e-3)
    want = np.zeros((16, nj))
    want[1:] = np.linalg.norm(mu.numpy()[1:] - mu.numpy()[:-1], axis=-1)
    np.testing.assert_allclose(disp.numpy(), want, rtol=1e-6, atol=1e-6)
    assert disp[0].max() == 0.0


@pytest.fixture
def tiny_project(synthetic_project, tiny_resnet, tmp_path):
    """A copy of the synthetic project on resnet_tiny with a JAX-written
    snapshot of seeded variables."""
    root = tmp_path / "proj"
    shutil.copytree(synthetic_project[0], root)
    _, cfg, train_dir = paths.resolve_project(root)
    cfg.net_type = tiny_resnet
    cfg.to_yaml(train_dir / "pose_cfg.yaml")
    jm = JaxPoseModel(JaxPoseConfig(net_type=tiny_resnet,
                                    num_joints=cfg.num_joints))
    snap = jax_ckpt.save_snapshot(train_dir, 2, "mc--0",
                                  random_variables(jm, (64, 80)))
    yield root, snap
    shutil.rmtree(root, ignore_errors=True)


def test_estimate_pose_multichip_matches_jax(mesh8, group, tiny_project,
                                             tmp_path):
    root, snap = tiny_project
    video = root / "videos" / "synthvid.avi"
    want = jax_streaming.estimate_pose_multichip(
        root / "config.yaml", snap, video, tmp_path / "jax", mesh=mesh8,
        frames_per_device=2, max_frames=20, smooth=True,
        compute_dtype=jnp.float32)
    got = streaming.estimate_pose_multichip(
        root / "config.yaml", snap, video, tmp_path / "port", mesh=group,
        frames_per_device=16, max_frames=20, smooth=True,
        compute_dtype=torch.float32)
    assert got["x"].shape == got["displacement"].shape == (20, 3)
    assert got["displacement"][0].max() == 0.0
    for key, atol in (("x", 1e-3), ("y", 1e-3), ("likelihoods", 1e-4),
                      ("displacement", 1e-4)):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=atol,
                                   err_msg=key)
    assert (tmp_path / "port" / "synthvid.csv").exists()
    assert (tmp_path / "port" / "synthvid.h5").exists()


def test_estimate_pose_multichip_int8(group, tiny_project, tmp_path):
    """The int8 model splits over time as the float one does; it equals
    the port's estimate_pose with the same int8 model on the same
    batches."""
    root, snap = tiny_project
    video = root / "videos" / "synthvid.avi"
    got = streaming.estimate_pose_multichip(
        root / "config.yaml", snap, video, tmp_path, mesh=group,
        frames_per_device=8, max_frames=16, compute_dtype=torch.float32,
        quantize=True, save_pose=False)
    assert got["x"].shape == (16, 3) and np.isfinite(got["x"]).all()
    want = predict.estimate_pose(
        root / "config.yaml", snap, video, tmp_path, save_pose=False,
        batch_size=8, max_frames=16, compute_dtype=torch.float32,
        quantize=True, calib_frames=8, device="cpu")
    for key in ("x", "y"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-4,
                                   err_msg=key)


"""The port's data-parallel layer (``parallel/mesh.py``,
``parallel/train_dp.py``) against the JAX package's, on the CPU.

The JAX side runs its DP steps on the suite's 8 virtual CPU devices
(``tests/conftest.py``); the port runs the same G windows in a data group
of world 1, where no collective runs and each update is the gradient of
the mean over the G windows (every rank's share of that mean is held by
the two-rank test in ``tests/test_torch_fit_dp.py``). Both get the same
seeded flax variables (mobilenet_v2_0.35 at 32x32, the reference tests'
model) and the same windows. Bounds are the reference tests':

* ``make_dp_infer_fn``: mu and likelihood within 1e-4
  (``tests/test_parallel.py:55-58``);
* the host-fed DP step against JAX's: loss within 1e-5 relative, every
  parameter within ``rtol=1e-4, atol=1e-5``
  (``tests/test_fit_dp.py:237-243``);
* the pooled DP step against the host-fed one, augmentation off: loss
  within 1e-6 relative, parameters ``rtol=1e-5, atol=1e-6``
  (``tests/test_parallel.py:174-177``); and against JAX's pooled step to
  the JAX tolerances above;
* the pooled step with the reference augmentation: finite, and it moves
  the parameters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepgraphpose_tpu.core.config import PoseConfig as JaxPoseConfig
from deepgraphpose_tpu.models.pose_model import PoseModel as JaxPoseModel
from deepgraphpose_tpu.ops.dgp_objective import DGPLossParams as JaxParams
from deepgraphpose_tpu.parallel import mesh as jax_mesh
from deepgraphpose_tpu.parallel import train_dp as jax_train_dp
from deepgraphpose_tpu.train import steps as jax_steps
from deepgraphpose_tpu_torch.core import checkpoint as ckpt
from deepgraphpose_tpu_torch.core.config import PoseConfig
from deepgraphpose_tpu_torch.models.pose_model import PoseModel
from deepgraphpose_tpu_torch.ops.augment_device import DeviceAugmentConfig
from deepgraphpose_tpu_torch.ops.dgp_objective import DGPLossParams
from deepgraphpose_tpu_torch.parallel import mesh, train_dp
from deepgraphpose_tpu_torch.train import device_data as dd
from deepgraphpose_tpu_torch.train import steps
from test_torch_mobilenet import random_variables

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs the virtual multi-device CPU mesh")

NET = "mobilenet_v2_0.35"
HW = (32, 32)
NJ, T, G = 3, 3, 4
LR = 0.005
LOSS_REL, PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two torch threads while this file runs, as tests/test_torch_fit.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def loss_params(wt: float = 0.0) -> dict:
    """``tests/test_parallel.py``'s objective constants."""
    return dict(
        nj=NJ, stride=8.0, gamma=1.0, gauss_len=1.0, lengthscale=1.0,
        pos_dist_thresh=9, locref_stdev=7.2801, locref_loss_weight=0.05,
        locref_huber_loss=True, wn_visible=5.0, wn_hidden=3.0, wt=wt,
        wt_max=0.0, gm2=0, gm3=0, n_visible_frames_total=8.0,
        n_hidden_frames_total=16.0, S0=np.array([[1.0, -1.0, 0.0]]),
        ws=np.array([2.0], np.float32), ws_max=np.array([60.0], np.float32))


def windows(seed: int = 0, g: int = G, wt: float = 0.0):
    """A frame pool of 10, rows (g, T) into it, and the windows' batch."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 255, (10, *HW, 3), dtype=np.uint8)
    rows = rng.integers(0, 10, (g, T)).astype(np.int32)
    vis = np.zeros((g, T * NJ), np.float32)
    vis[:, :NJ] = 1.0
    batch = dict(
        targets=rng.uniform(0, 3, (g, T, NJ, 2)).astype(np.float32),
        visible_mask=vis, hidden_mask=1.0 - vis,
        frame_mask=np.ones((g, T), np.float32),
        wt_batch=np.full((g, T - 1), wt, np.float32),
        pair_mask=np.ones((g, T - 1), np.float32),
        flow=rng.uniform(0.0, 2.0, (g, T - 1, *HW)).astype(np.float32))
    return pool, rows, batch


@pytest.fixture(scope="module")
def variables():
    jm = JaxPoseModel(JaxPoseConfig(net_type=NET, num_joints=NJ))
    return random_variables(jm, HW, seed=5)


def port_model(variables, dtype=torch.float32):
    model = PoseModel(PoseConfig(net_type=NET, num_joints=NJ), dtype=dtype)
    model.load_state_dict(ckpt.state_dict_from_flax(variables), strict=True)
    return model.eval()


def port_state(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def assert_params_allclose(got: dict, want, rtol: float, atol: float):
    """``want``: flax variables (numpy)."""
    want = ckpt.state_dict_from_flax(jax.tree.map(np.asarray, want))
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key].double().numpy(),
                                   value.double().numpy(), rtol=rtol,
                                   atol=atol, err_msg=key)


def jax_dp_step(variables, kind: str, *inputs, aug_cfg=None,
                dtype=jnp.float32, bn_train=False, wt=0.0):
    """One JAX DP step on a mesh of len(inputs' leading axis) devices;
    returns (numpy variables, loss terms)."""
    jm = JaxPoseModel(JaxPoseConfig(net_type=NET, num_joints=NJ),
                      dtype=dtype)
    tx = jax_steps.make_optimizer(LR, clip_norm=10.0)
    v = jax.tree.map(lambda a: jnp.asarray(a, dtype), variables)
    o = tx.init(v["params"])
    g = inputs[-2 if kind == "plain" else -3].shape[0]
    m = jax_mesh.make_mesh(g)
    lp = JaxParams(**loss_params(wt))
    with m:
        v, o = jax_mesh.replicate(v, m), jax_mesh.replicate(o, m)
        if kind == "plain":
            images, batch = inputs
            step = jax_train_dp.make_dp_dgp_train_step(jm, lp, tx, m)
            v2, _, out = step(v, o, jax_mesh.shard_leading_axis(images, m),
                              jax_mesh.shard_leading_axis(batch, m))
        else:
            pool, rows, batch, keys = inputs
            step = jax_train_dp.make_dp_pooled_dgp_train_step(
                jm, lp, tx, m, aug_cfg, bn_train=bn_train)
            v2, _, out = step(
                v, o, jax_mesh.replicate(pool, m),
                jax_mesh.shard_leading_axis(rows, m),
                jax_mesh.shard_leading_axis(
                    {k: np.asarray(x, dtype) for k, x in batch.items()}, m),
                jax_mesh.shard_leading_axis(keys, m))
    return (jax.tree.map(lambda a: np.asarray(a, np.float64), v2),
            {k: float(x) for k, x in out.items()})


def port_dp_step(variables, kind: str, *inputs, aug_cfg=None,
                 dtype=torch.float32, bn_train=False, wt=0.0):
    """The port's step in a data group of world 1; returns (state dict,
    loss terms)."""
    model = port_model(variables, dtype)
    opt = steps.make_optimizer(model.parameters(), LR, clip_norm=10.0)
    group = mesh.make_mesh(1, "cpu")
    params = DGPLossParams(**loss_params(wt))
    if kind == "plain":
        images, batch = inputs
        step = train_dp.make_dp_dgp_train_step(model, params, opt, group)
        out = step(torch.from_numpy(images.astype(np.float32)),
                   {k: torch.from_numpy(v).to(dtype)
                    for k, v in batch.items()})
    else:
        pool, rows, batch = inputs
        step = train_dp.make_dp_pooled_dgp_train_step(
            model, params, opt, group, aug_cfg, bn_train=bn_train)
        out = step(torch.from_numpy(pool), torch.from_numpy(rows),
                   {k: torch.from_numpy(v).to(dtype)
                    for k, v in batch.items()},
                   dd.window_generators(3, rows.shape[0], "cpu"))
    return port_state(model), {k: v.item() for k, v in out.items()}


def keys(g: int = G):
    return np.asarray(jax.random.split(jax.random.PRNGKey(3), g))


@pytest.mark.parametrize("shape,multiple,axis", [
    ((5, 2), 4, 0), ((8, 3), 4, 0), ((3, 7), 4, 1), ((1,), 3, 0)])
def test_pad_to_multiple_matches_jax(shape, multiple, axis):
    arr = np.arange(int(np.prod(shape))).reshape(shape)
    got, n = mesh.pad_to_multiple(arr, multiple, axis)
    want, n_want = jax_mesh.pad_to_multiple(arr, multiple, axis)
    assert n == n_want
    np.testing.assert_array_equal(got, want)


def test_data_group_of_one():
    """A world of 1 holds everything and runs no collective: each helper
    is the identity; shards split a leading axis in rank order; a group
    larger than the process group raises."""
    group = mesh.make_mesh(device="cpu")
    assert (group.rank, group.world, group.device.type) == (0, 1, "cpu")
    x = torch.arange(12.0).reshape(4, 3)
    assert torch.equal(group.all_gather(x), x)
    assert torch.equal(group.all_sum(x), x)
    y = x.clone()
    group.all_reduce_mean_([y])
    assert torch.equal(y, x)
    tree = {"a": np.arange(6).reshape(3, 2), "b": [np.zeros((3, 1))]}
    sharded = mesh.shard_leading_axis(tree, group)
    assert torch.equal(sharded["a"], torch.arange(6).reshape(3, 2))
    assert torch.equal(mesh.replicate(tree, group)["b"][0],
                       torch.zeros(3, 1, dtype=torch.float64))
    assert [mesh.DataGroup(r, 4).shard(8) for r in range(4)] == [
        slice(0, 2), slice(2, 4), slice(4, 6), slice(6, 8)]
    with pytest.raises(ValueError, match="does not split"):
        mesh.DataGroup(1, 4).shard(6)
    with pytest.raises(ValueError, match="process group"):
        mesh.make_mesh(2, "cpu")


def test_dp_infer_matches_jax(variables):
    from deepgraphpose_tpu.infer.predict import make_infer_fn

    images = np.random.default_rng(0).integers(0, 255, (8, *HW, 3),
                                               dtype=np.uint8)
    jm = JaxPoseModel(JaxPoseConfig(net_type=NET, num_joints=NJ))
    jcfg = JaxPoseConfig(net_type=NET, num_joints=NJ)
    m = jax_mesh.make_mesh(4)
    with m:
        mu_j, lik_j = jax_train_dp.make_dp_infer_fn(jm, jcfg, m)(
            jax_mesh.replicate(variables, m),
            jax_mesh.shard_leading_axis(images, m))
    mu_1, _ = make_infer_fn(jm, jcfg)(variables, jnp.asarray(images))
    group = mesh.make_mesh(1, "cpu")
    mu, lik = train_dp.make_dp_infer_fn(
        port_model(variables), PoseConfig(net_type=NET, num_joints=NJ),
        group)(torch.from_numpy(images))
    for got, want in ((mu, mu_j), (lik, lik_j), (mu, mu_1)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


def test_dp_train_step_matches_jax(variables):
    """The host-fed DP step over G = 4 windows: the gradient of the mean
    over the windows, one clipped SGD update."""
    pool, rows, batch = windows()
    images = pool[rows]
    want_vars, want = jax_dp_step(variables, "plain", images, batch)
    got_state, got = port_dp_step(variables, "plain", images, batch)
    assert set(got) == set(want) and np.isfinite(list(got.values())).all()
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=LOSS_REL), key
    assert_params_allclose(got_state, want_vars, PARAM_RTOL, PARAM_ATOL)


def test_dp_pooled_step_matches_dp_step_and_jax(variables):
    """Augmentation off, the temporal clique on (wt > 0, given flow): the
    pooled step gathers what the host-fed step is handed."""
    pool, rows, batch = windows(seed=1, wt=0.5)
    plain_state, plain = port_dp_step(variables, "plain", pool[rows], batch,
                                      wt=0.5)
    pooled_state, pooled = port_dp_step(variables, "pooled", pool, rows,
                                        batch, wt=0.5)
    assert pooled["total_loss"] == pytest.approx(plain["total_loss"],
                                                 rel=1e-6)
    for key, value in plain_state.items():
        np.testing.assert_allclose(pooled_state[key].numpy(), value.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    want_vars, want = jax_dp_step(variables, "pooled", pool, rows, batch,
                                  keys(), wt=0.5)
    assert pooled["total_loss"] == pytest.approx(want["total_loss"],
                                                 rel=LOSS_REL)
    assert_params_allclose(pooled_state, want_vars, PARAM_RTOL, PARAM_ATOL)


def test_dp_pooled_step_with_aug_is_finite(variables):
    pool, rows, batch = windows(seed=2)
    before = port_state(port_model(variables))
    state, out = port_dp_step(variables, "pooled", pool, rows, batch,
                              aug_cfg=DeviceAugmentConfig.reference())
    assert np.isfinite(out["total_loss"])
    assert any(not torch.equal(state[k], v) for k, v in before.items()
               if not k.endswith("mean_pixel"))


def test_window_draws_follow_the_slot_not_the_rank():
    """A window slot's generator is the same whether a rank holds slots
    0-1 or one rank holds 0-3; different slots draw differently."""
    whole = dd.window_generators(7, 4, "cpu")
    part = dd.window_generators(7, 2, "cpu", first=2)
    draws = [torch.rand(5, generator=g) for g in whole]
    assert torch.equal(torch.rand(5, generator=part[0]), draws[2])
    assert torch.equal(torch.rand(5, generator=part[1]), draws[3])
    assert not torch.equal(draws[0], draws[1])

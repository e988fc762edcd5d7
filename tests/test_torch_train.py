"""The port's train steps against the JAX package's, one step at a time.

Both packages start from the same random flax variables (bridged to the
port by ``state_dict_from_flax``) and take one step on the same batch, in
float32 on the CPU, with a ResNet of one unit per block (the
``resnet_tiny`` registration of tests/test_torch_models.py). After the
step:

* every parameter and batch-norm buffer agrees within 1e-5 (absolute);
* every tensor's update agrees within 1e-4 of that tensor's largest
  update. A parameter's update is read from the optimizer's trace
  (``-lr * trace`` is what both optax and torch add): after-minus-before in
  float32 is rounded to the spacing of the parameter's own values, 6e-8
  for the batch-norm scales near 1, which is up to 1e-4 of their update
  in the BN-train mode. A buffer's update is after-minus-before.

The DGP step with batch-norm in train mode is held against the JAX step
run with 64-bit types enabled: there the JAX package's own float32
gradient can stray from its float64 one by more than 1e-4 in the last
block (a few values a channel). The test asserts that the port's float32
trace is within 1e-4 of the float64 one, and no farther from it than the
JAX package's float32 trace.

Then the whole host-fed slice: synthetic project -> MultiDataset ->
generate_batch_schedule -> assemble_batch -> three step-2 updates in both
packages, the per-step losses compared.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepgraphpose_tpu.core.config import PoseConfig as JaxPoseConfig
from deepgraphpose_tpu.models import resnet as jax_resnet
from deepgraphpose_tpu.models.pose_model import PoseModel as JaxPoseModel
from deepgraphpose_tpu.ops.dgp_objective import DGPLossParams as JaxParams
from deepgraphpose_tpu.train import steps as jax_steps
from deepgraphpose_tpu_torch.core.checkpoint import state_dict_from_flax
from deepgraphpose_tpu_torch.core.config import PoseConfig
from deepgraphpose_tpu_torch.models import resnet as torch_resnet
from deepgraphpose_tpu_torch.models.pose_model import PoseModel, scoremap_size
from deepgraphpose_tpu_torch.ops.dgp_objective import DGPLossParams
from deepgraphpose_tpu_torch.train import steps as torch_steps

PARAM_ATOL = 1e-5
UPDATE_RTOL = 1e-4
IN_HW = (64, 80)


@pytest.fixture
def tiny_resnet(monkeypatch):
    """A ResNet-v1 with one unit per block, registered in both packages."""
    monkeypatch.setitem(jax_resnet.BLOCK_UNITS, "resnet_tiny", (1, 1, 1, 1))
    monkeypatch.setitem(torch_resnet.BLOCK_UNITS, "resnet_tiny", (1, 1, 1, 1))
    return "resnet_tiny"


def random_variables(model, hw, seed=0):
    """numpy flax variables: LeCun-scaled kernels (the root conv / 100, so
    0-255 pixels give O(1) activations), BN scale and var in [0.5, 1.5],
    the rest N(0, 0.1)."""
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, *hw, 3))))
    rng = np.random.default_rng(seed)
    out = {}
    for path, s in flax.traverse_util.flatten_dict(shapes).items():
        name = path[-1]
        if name == "kernel":
            v = rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
            if path[-2] == "conv1" and path[-3].startswith("ResNetV1"):
                v = v / 100.0
        elif name in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, s.shape)
        else:
            v = rng.standard_normal(s.shape) * 0.1
        out[path] = v.astype(np.float32)
    return flax.traverse_util.unflatten_dict(out)


def port_model(cfg_kw, variables):
    model = PoseModel(PoseConfig(**cfg_kw))
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return model


def jax_trace(opt_state):
    """The params-shaped momentum trace inside an optax chain's state."""
    found = [s for s in jax.tree.leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.TraceState))
        if isinstance(s, optax.TraceState)]
    assert len(found) == 1
    return found[0].trace


def assert_step_matches(model, optimizer, before, new_vars, opt_state):
    """Parameters and buffers after one step, and every tensor's update,
    against the JAX step's."""
    want = state_dict_from_flax(jax.tree.map(np.asarray, new_vars))
    got = model.state_dict()
    assert set(got) == set(want)
    for key, value in want.items():
        assert (got[key] - value).abs().max().item() <= PARAM_ATOL, key
    trace = state_dict_from_flax(
        {"params": jax.tree.map(np.asarray, jax_trace(opt_state))})
    params = dict(model.named_parameters())
    assert set(trace) == set(params)
    for key, p in params.items():
        upd, want_upd = optimizer.state[p]["momentum_buffer"], trace[key]
        scale = want_upd.abs().max().item()
        assert (upd - want_upd).abs().max().item() <= UPDATE_RTOL * scale, key
    for key, _ in model.named_buffers():
        if key in want and not key.endswith("mean_pixel"):
            want_upd = want[key] - before[key]
            scale = want_upd.abs().max().item()
            err = ((got[key] - before[key]) - want_upd).abs().max().item()
            assert err <= UPDATE_RTOL * scale, key


def test_piecewise_lr_matches_optax():
    multi_step = [[0.005, 3], [0.02, 7], [0.002, 9]]
    got = torch_steps.piecewise_lr(multi_step)
    want = jax_steps.piecewise_lr(multi_step)
    for count in range(12):
        assert got(count) == pytest.approx(float(want(count)), rel=1e-7)


def test_optimizer_matches_optax():
    """Five updates of the clip + SGD-momentum chain, the clip triggered
    on the first three, with a schedule that changes the rate between
    updates (optax evaluates it at the count of updates done before)."""
    rng = np.random.default_rng(4)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) * g for s in shapes]
             for g in (20.0, 8.0, 5.0, 0.5, 0.1)]
    sched = [[0.1, 2], [0.05, 4], [0.01, 100]]
    tx = jax_steps.make_optimizer(jax_steps.piecewise_lr(sched),
                                  clip_norm=4.0)
    state = tx.init(params)
    tensors = [torch.tensor(p, requires_grad=True) for p in params]
    opt = torch_steps.make_optimizer(tensors, torch_steps.piecewise_lr(sched),
                                     clip_norm=4.0)
    clipped = 0
    for g in grads:
        clipped += np.sqrt(sum(np.sum(x.astype(np.float64) ** 2)
                               for x in g)) >= 4.0
        updates, state = tx.update([jnp.asarray(x) for x in g], state,
                                   params)
        params = optax.apply_updates(params, updates)
        for t, x in zip(tensors, g):
            t.grad = torch.from_numpy(x.copy())
        opt.step()
        for t, p in zip(tensors, params):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(p),
                                       rtol=0, atol=1e-6)
    assert clipped == 3 and opt.count == 5
    with pytest.raises(ValueError):
        opt.step(lambda: 0.0)


@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
def test_batch_norm_train_mode_matches_flax(in_dtype):
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((3, 5, 7, 8)) * 2 + 0.5).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bias = rng.standard_normal(8).astype(np.float32) * 0.1
    mean = rng.standard_normal(8).astype(np.float32)
    var = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    dtype = getattr(jnp, in_dtype)
    bn = jax_resnet.FrozenBatchNorm(dtype=dtype)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean, "var": var}}

    def f(v, xx):
        y, upd = bn.apply(v, xx.astype(dtype), train=True,
                          mutable=["batch_stats"])
        return jnp.sum(jnp.sin(y.astype(jnp.float32))), (y, upd)

    (_, (y_want, upd)), grads = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(variables, jnp.asarray(x))

    mod = torch_resnet.FrozenBatchNorm(8)
    with torch.no_grad():
        for name, value in (("scale", scale), ("bias", bias),
                            ("mean", mean), ("var", var)):
            getattr(mod, name).copy_(torch.from_numpy(value))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().requires_grad_(
        True)
    y = mod(xt.to(getattr(torch, in_dtype)), train=True)
    torch.sin(y.float()).sum().backward()
    tol = 1e-5 if in_dtype == "float32" else 2e-2
    np.testing.assert_allclose(
        y.detach().float().permute(0, 2, 3, 1).numpy(),
        np.asarray(y_want.astype(jnp.float32)), rtol=tol, atol=tol)
    for name in ("mean", "var"):
        np.testing.assert_allclose(getattr(mod, name).numpy(),
                                   np.asarray(upd["batch_stats"][name]),
                                   rtol=1e-6, atol=1e-7)
    if in_dtype == "float32":
        for name in ("scale", "bias"):
            np.testing.assert_allclose(
                getattr(mod, name).grad.numpy(),
                np.asarray(grads[0]["params"][name]), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(grads[1]), rtol=1e-4, atol=1e-6)
    # inference mode leaves the stats alone
    before = mod.mean.clone()
    mod(xt.detach())
    assert torch.equal(mod.mean, before)


@pytest.mark.parametrize("bn_train", [False, True])
def test_dlc_step_matches_jax(tiny_resnet, bn_train):
    kw = dict(net_type=tiny_resnet, num_joints=3, intermediate_supervision=True)
    jm = JaxPoseModel(JaxPoseConfig(**kw))
    variables = random_variables(jm, IN_HW)
    rng = np.random.default_rng(1)
    images = rng.integers(0, 256, (2, *IN_HW, 3)).astype(np.uint8)
    coords = rng.uniform(4, 60, (2, 3, 2)).astype(np.float32)
    coords[1, 0] = np.nan                       # an unlabeled joint
    present = ~np.isnan(coords[..., 0])
    sched = [[0.05, 1], [0.02, 10]]

    tx = jax_steps.make_optimizer(jax_steps.piecewise_lr(sched))
    jvars = jax.tree.map(jnp.asarray, variables)
    state = tx.init(jvars["params"])
    step = jax_steps.make_dlc_train_step(jm, JaxPoseConfig(**kw), tx,
                                         bn_train=bn_train)
    new_vars, state, want = step(jvars, state, jnp.asarray(images),
                                 jnp.asarray(coords), jnp.asarray(present), 0)

    model = port_model(kw, variables)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = torch_steps.make_optimizer(model.parameters(),
                                     torch_steps.piecewise_lr(sched))
    got = torch_steps.make_dlc_train_step(model, PoseConfig(**kw), opt,
                                          bn_train=bn_train)(
        torch.from_numpy(images), torch.from_numpy(coords),
        torch.from_numpy(present))
    assert set(got) == set(want) == {"part_loss", "part_loss_interm",
                                     "locref_loss", "total_loss"}
    for key, value in got.items():
        assert value.dim() == 0 and not value.requires_grad
        assert value.item() == pytest.approx(float(want[key]), rel=1e-5)
    assert_step_matches(model, opt, before, new_vars, state)


def dgp_batch(t_, nj, hw, seed=1):
    """A step-2 batch: 4 real frames and a padded one, frames 0 and 2
    labeled (one NaN joint), flow for the temporal clique."""
    rng = np.random.default_rng(seed)
    h, w = hw
    targets = rng.uniform(1, min(h, w) - 2, (t_, nj, 2)).astype(np.float32)
    visible = np.zeros((t_, nj), bool)
    visible[0] = True
    visible[2] = True
    visible[0, 2] = False
    vis = visible.reshape(-1).astype(np.float32)
    return {
        "targets": np.where(visible[..., None], targets, 0.0).astype(
            np.float32),
        "visible_mask": vis,
        "hidden_mask": np.concatenate([1.0 - vis[:-nj],
                                       np.zeros(nj, np.float32)]),
        "frame_mask": np.array([1, 1, 1, 1, 0], np.float32),
        "wt_batch": np.full(t_ - 1, 1.3, np.float32),
        "pair_mask": np.array([1, 1, 1, 0], np.float32),
        "flow": rng.uniform(0.1, 2.0, (t_ - 1, *IN_HW)).astype(np.float32),
    }


def dgp_params(nj, **kw):
    return dict(
        nj=nj, stride=8.0, gamma=1.0, gauss_len=1.0, lengthscale=1.0,
        pos_dist_thresh=17.0, locref_stdev=7.2801, locref_loss_weight=0.05,
        locref_huber_loss=True, wn_visible=5.0, wn_hidden=3.0, wt=1.3,
        wt_max=0.5, gm2=1, gm3=3, n_visible_frames_total=11.0,
        n_hidden_frames_total=29.0,
        S0=np.array([[1.0, -1.0, 0.0], [0.0, 1.0, -1.0]], np.float32),
        ws=np.array([0.4, 0.9], np.float32),
        ws_max=np.array([30.0, 22.0], np.float32), **kw)


def jax_dgp_step(kw, variables, images, batch, params, visible_only,
                 bn_train, dtype):
    """One JAX DGP step in ``dtype`` (float64 under ``jax.enable_x64``)."""
    jm = JaxPoseModel(JaxPoseConfig(**kw), dtype=dtype)
    tx = jax_steps.make_optimizer(0.05, clip_norm=10.0)
    jvars = jax.tree.map(lambda a: jnp.asarray(a, dtype), variables)
    state = tx.init(jvars["params"])
    step = jax_steps.make_dgp_train_step(jm, JaxParams(**params), tx,
                                         visible_only=visible_only,
                                         bn_train=bn_train)
    new_vars, state, out = step(
        jvars, state, jnp.asarray(images),
        {k: jnp.asarray(v, dtype) for k, v in batch.items()})
    return (jax.tree.map(lambda a: np.asarray(a, np.float32), new_vars),
            jax.tree.map(lambda a: np.asarray(a, np.float32), state),
            {k: float(v) for k, v in out.items()})


def worst_trace_error(trace, reference) -> float:
    """Largest per-tensor error of a trace, relative to the tensor's
    largest reference value."""
    return max((trace[k] - v).abs().max().item() / v.abs().max().item()
               for k, v in reference.items())


@pytest.mark.parametrize("bn_train", [False, True])
@pytest.mark.parametrize("visible_only", [False, True])
def test_dgp_step_matches_jax(tiny_resnet, visible_only, bn_train):
    kw = dict(net_type=tiny_resnet, num_joints=3)
    jm = JaxPoseModel(JaxPoseConfig(**kw))
    variables = random_variables(jm, IN_HW)
    images = np.random.default_rng(2).integers(
        0, 256, (5, *IN_HW, 3)).astype(np.uint8)
    images[4] = images[3]                       # padding repeats the last
    batch = dgp_batch(5, 3, scoremap_size(PoseConfig(**kw), IN_HW))
    params = dgp_params(3)
    args = (kw, variables, images, batch, params, visible_only, bn_train)
    if bn_train:
        with jax.enable_x64(True):
            new_vars, state, want = jax_dgp_step(*args, jnp.float64)
    else:
        new_vars, state, want = jax_dgp_step(*args, jnp.float32)

    model = port_model(kw, variables)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = torch_steps.make_optimizer(model.parameters(), 0.05, clip_norm=10.0)
    got = torch_steps.make_dgp_train_step(
        model, DGPLossParams(**params), opt, visible_only=visible_only,
        bn_train=bn_train)(torch.from_numpy(images),
                           {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(got) == set(want)
    for key, value in got.items():
        assert value.item() == pytest.approx(want[key], rel=1e-5), key
    assert_step_matches(model, opt, before, new_vars, state)
    if bn_train:    # the JAX package's float32 step, against its float64
        _, state32, _ = jax_dgp_step(*args, jnp.float32)
        reference = state_dict_from_flax({"params": jax_trace(state)})
        ours = {k: opt.state[p]["momentum_buffer"]
                for k, p in model.named_parameters()}
        theirs = state_dict_from_flax({"params": jax_trace(state32)})
        assert worst_trace_error(ours, reference) <= min(
            UPDATE_RTOL, worst_trace_error(theirs, reference))


def test_host_fed_slice_matches_jax(tiny_resnet, tmp_path):
    """Synthetic project -> MultiDataset -> schedule -> assemble_batch ->
    three step-2 updates (limb clique, wt > 0 with Farneback flow) in both
    packages from the same variables; the objective's parameters are
    ``fit_dgp``'s and the port's ``loss_params``, equal field by field, and
    the losses of each step agree."""
    from deepgraphpose_tpu.core.config import read_config as jax_read
    from deepgraphpose_tpu.data import batcher as jax_batcher
    from deepgraphpose_tpu.train.fit import _make_loss_params
    from deepgraphpose_tpu.utils.synthetic import make_synthetic_project
    from deepgraphpose_tpu_torch.core.config import read_config
    from deepgraphpose_tpu_torch.data import batcher
    from deepgraphpose_tpu_torch.ops.dgp_objective import loss_params

    root, _, _ = make_synthetic_project(tmp_path / "proj", n_frames=40,
                                        n_labeled=6, hw=IN_HW, nj=3)
    video = f"{root}/videos/synthvid.avi"
    kw = dict(net_type=tiny_resnet, num_joints=3, ws=1000.0, ws_max=1.2,
              wt=1.0, wt_max=0.0, wn_visible=5.0, wn_hidden=3.0, gm2=0,
              gm3=0, gamma=1.0, gauss_len=1.0, lengthscale=1.0,
              batch_size=4)
    batch_size, pad_to = 4, 5
    sides = {}
    for name, read, cfg_cls, mod in (
            ("jax", jax_read, JaxPoseConfig, jax_batcher),
            ("torch", read_config, PoseConfig, batcher)):
        proj, cfg = read(f"{root}/config.yaml"), cfg_cls(**kw)
        mds = mod.MultiDataset(proj, cfg, [video], ns=3, n_max_frames=30,
                               cache_dir=tmp_path / name)
        S0 = proj.skeleton_incidence()
        if name == "jax":
            params = _make_loss_params(mds, cfg, S0)
        else:
            params = loss_params(cfg, S0, [d.labels_rc for d in mds.datasets],
                                 mds.n_visible_frames_total,
                                 mds.n_hidden_frames_total)
        d = mds.datasets[0]
        schedule = mod.generate_batch_schedule(
            [d.visible_frames], [d.hidden_frames], [d.chunk], batch_size,
            10, 3, seed=0)
        batches = []
        for _, frames in schedule:
            vis = np.intersect1d(frames, d.visible_frames)
            hid = np.setdiff1d(frames, vis)
            batches.append(mod.assemble_batch(d, vis, hid, pad_to=pad_to,
                                              wt=cfg.wt, compute_flow=True))
        sides[name] = (params, batches)
    assert len(sides["torch"][1]) == 3
    for field, want in vars(sides["jax"][0]).items():
        np.testing.assert_array_equal(getattr(sides["torch"][0], field),
                                      want, err_msg=field)
    assert sides["torch"][0].n_limbs > 0
    assert any(b.visible_mask.any() for b in sides["torch"][1])
    assert any(b.pair_mask.any() for b in sides["torch"][1])

    jm = JaxPoseModel(JaxPoseConfig(net_type=tiny_resnet, num_joints=3))
    variables = random_variables(jm, IN_HW)
    tx = jax_steps.make_optimizer(0.005, clip_norm=10.0)
    jvars = jax.tree.map(jnp.asarray, variables)
    state = tx.init(jvars["params"])
    jstep = jax_steps.make_dgp_train_step(jm, sides["jax"][0], tx)
    model = port_model(dict(net_type=tiny_resnet, num_joints=3), variables)
    opt = torch_steps.make_optimizer(model.parameters(), 0.005,
                                     clip_norm=10.0)
    tstep = torch_steps.make_dgp_train_step(model, sides["torch"][0], opt)
    for jb, tb in zip(sides["jax"][1], sides["torch"][1]):
        np.testing.assert_array_equal(tb.images, jb.images)
        jvars, state, want = jstep(jvars, state, jnp.asarray(jb.images),
                                   jb.as_jnp())
        got = tstep(torch.from_numpy(tb.images), tb.as_torch(device="cpu"))
        assert "ws_loss" in got and "wt_loss" in got
        for key, value in got.items():
            assert value.item() == pytest.approx(float(want[key]),
                                                 rel=1e-5, abs=1e-9), key
    want_params = state_dict_from_flax(jax.tree.map(np.asarray, jvars))
    for key, value in model.state_dict().items():
        assert (value - want_params[key]).abs().max().item() <= PARAM_ATOL

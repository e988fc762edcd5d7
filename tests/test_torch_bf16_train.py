"""bfloat16 mixed-precision training in the port against the JAX package.

The JAX package trains in bfloat16 as flax does (``compute_dtype``):
float32 parameters, each cast to bfloat16 at its conv, batch-norm's
inverse and shift in float32, heads and losses in float32. The port's
``PoseModel(dtype=torch.bfloat16, param_dtype=torch.float32)`` is that
model; ``param_dtype`` defaults to ``dtype``, so bfloat16 inference keeps
its bfloat16 weights. On the CPU, with the one-unit-per-block ResNet
(``resnet_tiny``) and MobileNetV2:

* a cast-at-compute model computes exactly what a bfloat16-weight model
  with the same (rounded) weights computes;
* the bf16 DGP step held to ``tests/test_train.py:201-245``: parameters
  stay float32, they move, and the loss is within 5% of float32's;
* the port's bf16 step against JAX's on the same variables and batch:
  every loss term within 1e-2 relative of JAX's bf16 one (measured at
  most 4.3e-4; bf16 moves the terms from their float32 values by up to
  1.9e-2 on ResNet-50), and each tensor's update no farther from JAX's
  bf16 update than JAX's bf16 update is from its float32 one (measured
  6.3% against 16.2% of the tensor's largest update): both frameworks
  round the activations of differently ordered convolutions to bf16;
* ``fit_dgp(compute_dtype="bfloat16")`` and ``fit_dlc`` train the
  synthetic project from the frame pools and the host feed, with float32
  snapshots that the JAX package loads.

The step-0 update with trainable batch-norm, the one ``fit_dlc`` takes
from a seeded init, is held in bf16 as the card trains it: batch 1, a
rate of 0.02, host-fed (``make_dlc_train_step``), from the labeled pool
(``make_pooled_dlc_train_step``) and as a dispatch of two updates
(``make_pooled_dlc_scan_step``), on both backbones, and from the pool with
the card recipe's augmentation (scale jitter 0.5-1.25) on fixed draws.
JAX's reference is its bf16 step run op by op (``jax.disable_jit``): each
op rounds to bf16 as the port's eager ops do, and the port's forward then
equals it bit for bit nearly everywhere. The
jitted step is no reference here: XLA fuses the batch-norm's
multiply-add and the ReLUs and rounds once, and with batch statistics of
one frame that moves the bf16 step about as far as bf16 itself does (the
jitted and the op-by-op step part past the bound below on 14 of
resnet_tiny's 55 traces and 109 of mobilenet_v2_0.35's 160). Bounds:

* every loss term within 1e-2 relative of JAX's bf16 one;
* every parameter's momentum trace, and every batch-norm's updated moving
  mean and variance, no farther from JAX's bf16 value than that is from
  JAX's float32 one, with a floor of 1e-6 of the tensor's largest float32
  value;
* MobileNetV2's ``project_bn.bias`` has an exact gradient of zero in this
  mode (a per-channel shift that the next train-mode batch-norm removes):
  its float32 traces are zero to 1e-6 of the model's largest trace in
  both packages, and its bf16 traces are rounding noise, held to at most
  twice the size of JAX's.

The dispatch of two updates runs at a rate of 0: any update that moves the
float32 weights flips the bf16 rounding of some of them, and from there
two bf16 steps part as far as bf16 and float32 do (at a rate of 1e-4 the
second update's terms already part by 2.7%, in JAX's jitted step too). At
0 both updates start from the same weights, and the dispatch's carry of
the momentum trace and the moving statistics across its updates is held.
"""

import dataclasses
import types

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepgraphpose_tpu.core import checkpoint as jax_ckpt
from deepgraphpose_tpu.core.config import PoseConfig as JaxPoseConfig
from deepgraphpose_tpu.models.pose_model import PoseModel as JaxPoseModel
from deepgraphpose_tpu.ops import augment_device as jax_aug
from deepgraphpose_tpu.ops.dgp_objective import DGPLossParams as JaxParams
from deepgraphpose_tpu.train import device_data as jax_dd
from deepgraphpose_tpu.train import steps as jax_steps
from deepgraphpose_tpu_torch.core import checkpoint as ckpt
from deepgraphpose_tpu_torch.core.config import PoseConfig
from deepgraphpose_tpu_torch.models.pose_model import (PoseModel, init_model,
                                                       scoremap_size)
from deepgraphpose_tpu_torch.ops import augment_device as aug
from deepgraphpose_tpu_torch.ops.dgp_objective import DGPLossParams
from deepgraphpose_tpu_torch.train import device_data as dd
from deepgraphpose_tpu_torch.train import fit
from deepgraphpose_tpu_torch.train import steps as torch_steps
from test_torch_augment_device import jax_draws, port_cfg
from test_torch_fit import (WARM, base_project, logged_losses,  # noqa: F401
                            project_copy, tiny_resnet, train_dir, two_threads,
                            work)
from test_torch_train import (IN_HW, dgp_batch, dgp_params, jax_trace,
                              random_variables)

BF16 = torch.bfloat16


def small_cfg(net_type):
    return dict(net_type=net_type, num_joints=3)


@pytest.mark.parametrize("net_type", ["resnet_tiny", "mobilenet_v2_0.35"])
def test_cast_at_compute_is_bf16_weights(tiny_resnet, net_type):
    """Float32 weights cast at each conv give, bit for bit, the heads of
    the bfloat16-weight model, which the inference paths keep."""
    cfg = PoseConfig(**small_cfg(net_type))
    mixed = init_model(cfg, torch.Generator().manual_seed(3), BF16, "cpu",
                       param_dtype=torch.float32)
    plain = PoseModel(cfg, dtype=BF16).eval()
    plain.load_state_dict(mixed.state_dict())
    assert all(p.dtype == torch.float32 for p in mixed.parameters())
    convs = [m.weight for m in plain.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    assert convs and all(w.dtype == BF16 for w in convs)
    images = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, *IN_HW, 3)).astype(np.uint8))
    with torch.no_grad():
        a, b = mixed(images), plain(images)
    for key in a:
        assert a[key].dtype == torch.float32
        assert torch.equal(a[key], b[key]), key


def _port_step(kw, variables, images, batch, params, dtype):
    model = PoseModel(PoseConfig(**kw), dtype=dtype,
                      param_dtype=torch.float32)
    model.load_state_dict(ckpt.state_dict_from_flax(variables), strict=True)
    model.eval()
    before = [p.detach().clone() for p in model.parameters()]
    opt = torch_steps.make_optimizer(model.parameters(), 0.05, clip_norm=10.0)
    got = torch_steps.make_dgp_train_step(
        model, DGPLossParams(**params), opt)(
        torch.from_numpy(images),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    return model, opt, before, got


def _jax_step(kw, variables, images, batch, params, dtype):
    """The JAX package's mixed-precision step: a ``dtype`` model over
    float32 variables."""
    jm = JaxPoseModel(JaxPoseConfig(**kw), dtype=dtype)
    tx = jax_steps.make_optimizer(0.05, clip_norm=10.0)
    jvars = jax.tree.map(jnp.asarray, variables)
    state = tx.init(jvars["params"])
    step = jax_steps.make_dgp_train_step(jm, JaxParams(**params), tx)
    _, state, out = step(jvars, state, jnp.asarray(images),
                         {k: jnp.asarray(v) for k, v in batch.items()})
    trace = ckpt.state_dict_from_flax(
        {"params": jax.tree.map(np.asarray, jax_trace(state))})
    return {k: float(v) for k, v in out.items()}, trace


def _inputs(kw):
    variables = random_variables(JaxPoseModel(JaxPoseConfig(**kw)), IN_HW)
    images = np.random.default_rng(2).integers(
        0, 256, (5, *IN_HW, 3)).astype(np.uint8)
    images[4] = images[3]
    batch = dgp_batch(5, 3, scoremap_size(PoseConfig(**kw), IN_HW))
    return variables, images, batch, dgp_params(3)


@pytest.mark.parametrize("net_type", ["resnet_tiny", "mobilenet_v2_0.35"])
def test_bf16_step_keeps_float32_parameters(tiny_resnet, net_type):
    """tests/test_train.py:201-245 on the port: finite losses, the
    parameters move and stay float32, and the bf16 loss is within 5% of
    the float32 one on the same batch."""
    kw = small_cfg(net_type)
    variables, images, batch, params = _inputs(kw)
    losses = {}
    for dtype in (torch.float32, BF16):
        model, _, before, got = _port_step(kw, variables, images, batch,
                                           params, dtype)
        after = list(model.parameters())
        assert np.isfinite(got["total_loss"].item())
        assert all(p.dtype == torch.float32 for p in after)
        assert any(not torch.equal(a, b) for a, b in zip(after, before))
        assert all(v.dtype == torch.float32 for v in model.state_dict(
            ).values() if v.is_floating_point())
        losses[dtype] = got["total_loss"].item()
    assert losses[BF16] == pytest.approx(losses[torch.float32], rel=0.05)


def test_bf16_step_matches_jax_bf16(tiny_resnet):
    kw = small_cfg(tiny_resnet)
    variables, images, batch, params = _inputs(kw)
    want, trace = _jax_step(kw, variables, images, batch, params,
                            jnp.bfloat16)
    _, trace32 = _jax_step(kw, variables, images, batch, params,
                           jnp.float32)
    model, opt, _, got = _port_step(kw, variables, images, batch, params,
                                    BF16)
    assert set(got) == set(want)
    for key, value in got.items():
        assert value.dtype == torch.float32
        assert value.item() == pytest.approx(want[key], rel=1e-2), key
    for key, p in model.named_parameters():
        scale = trace32[key].abs().max().item()
        ours = (opt.state[p]["momentum_buffer"] - trace[key]).abs().max()
        own = (trace[key] - trace32[key]).abs().max()
        assert ours.item() <= max(own.item(), 1e-6 * scale), key


@pytest.mark.parametrize("device_data", [True, False])
def test_fit_dgp_bfloat16_trains_and_jax_loads_it(tiny_resnet, base_project,
                                                  work, capsys, device_data):
    """fit_dgp in bf16 from the JAX-written warm start, from the frame
    pool (on-device augmentation) and from the host feed: finite losses
    within 5% of the float32 run's first ones, float32 snapshots that the
    JAX package loads and runs, its parameters moved."""
    kw = dict(snapshot=WARM, batch_size=3, maxiters=3, displayiters=1,
              nepoch=1, device_data=device_data, device="cpu")
    roots = {}
    for dtype in ("float32", "bfloat16"):
        roots[dtype] = project_copy(base_project, work / dtype)
        fit.fit_dgp(dlcpath=roots[dtype], compute_dtype=dtype, **kw)
    if device_data:
        assert "on-device augmentation" in capsys.readouterr().out
    got, want = logged_losses(roots["bfloat16"]), logged_losses(
        roots["float32"])
    assert len(got) == len(want) == 3
    assert np.isfinite([v for _, v in got]).all()
    assert got[0][1] == pytest.approx(want[0][1], rel=0.05)
    path = train_dir(roots["bfloat16"]) / "snapshot-step2-final--0.ckpt"
    variables = jax_ckpt.load_snapshot(path)[0]
    leaves = jax.tree_util.tree_leaves(variables)
    assert all(np.asarray(v).dtype == np.float32 for v in leaves)
    warm = ckpt.state_dict_from_flax(ckpt.load_snapshot(
        train_dir(roots["bfloat16"]) / f"{WARM}.ckpt")[0])
    final = ckpt.state_dict_from_flax(variables)
    assert any(not torch.equal(final[k], warm[k]) for k in warm)
    heads = JaxPoseModel(JaxPoseConfig(**small_cfg(tiny_resnet)),
                         dtype=jnp.bfloat16).apply(
        variables, jnp.zeros((1, 48, 64, 3), jnp.float32))
    assert np.isfinite(np.asarray(heads["part_pred"])).all()


def test_fit_dlc_bfloat16(tiny_resnet, base_project, work):
    root = project_copy(base_project, work / "p")
    fit.fit_dlc(snapshot=WARM, dlcpath=root, maxiters=3, displayiters=1,
                compute_dtype=torch.bfloat16, device="cpu")
    assert np.isfinite([v for _, v in logged_losses(root)]).all()
    variables = jax_ckpt.load_snapshot(
        train_dir(root) / "snapshot-step0-final--0.ckpt")[0]
    assert all(np.asarray(v).dtype == np.float32
               for v in jax.tree_util.tree_leaves(variables))


def test_training_rejects_other_compute_types(tiny_resnet, base_project,
                                              work):
    root = project_copy(base_project, work / "p")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fit.fit_dlc(snapshot=WARM, dlcpath=root, maxiters=1,
                    compute_dtype=torch.float16, device="cpu")


# --- step 0 with trainable batch-norm, in bf16 as the card trains it -------

BN_LR = 0.02                # the card recipe's rate (chip_smoke.py)
LOSS_RTOL = 1e-2
NOISE_ONLY = ".project_bn.bias"     # MobileNetV2: a zero exact gradient
JITTER = (0.5, 1.25)        # the card recipe's scale jitter
# the augmented canvases: a source position of up to 160 px rounds to
# 1.5e-5 px in float32, and an edge spans 255 a px (measured: 1.05e-3 at
# scale 0.5, past tests/test_torch_augment_device.py's 1e-3 on one pixel)
AUG_IMAGE_ATOL = 4e-3
# pool rows: one a host-fed or pooled update, two a dispatch
ROWS = {"host": [0], "pooled": [2], "scan": [[2], [0]]}


def _bn_inputs(kw):
    """Seeded flax variables and a labeled pool of three canvases: coords
    within the canvas, one absent joint."""
    variables = random_variables(JaxPoseModel(JaxPoseConfig(**kw)), IN_HW)
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (3, *IN_HW, 3)).astype(np.uint8)
    coords = rng.uniform(4, 60, (3, kw["num_joints"], 2)).astype(np.float32)
    present = np.ones((3, kw["num_joints"]), np.float32)
    present[1, 0], coords[1, 0] = 0.0, 0.0
    content = np.tile(np.array([IN_HW[1], IN_HW[0]], np.float32), (3, 1))
    return variables, (images, coords, present, content)


def _jax_bn_step(kind, kw, variables, pool, dtype, lr, aug_cfg=None,
                 key=None):
    """The JAX package's step-0 update(s) with trainable batch-norm:
    (loss terms, the momentum trace and the variables after it, both as
    port state dicts)."""
    cfg = JaxPoseConfig(**kw)
    jm = JaxPoseModel(cfg, dtype=dtype)
    tx = jax_steps.make_optimizer(lr)
    jvars = jax.tree.map(jnp.asarray, variables)
    state = tx.init(jvars["params"])
    pool = [jnp.asarray(a) for a in pool]
    rows = jnp.asarray(ROWS[kind], jnp.int32)
    key = jax.random.PRNGKey(0) if key is None else key
    if kind == "host":
        images, coords, present, _ = (a[rows] for a in pool)
        step = jax_steps.make_dlc_train_step(jm, cfg, tx, bn_train=True)
        out = step(jvars, state, images, coords, present > 0, 0)
    elif kind == "pooled":
        step = jax_dd.make_pooled_dlc_train_step(jm, cfg, tx, aug_cfg,
                                                 bn_train=True)
        out = step(jvars, state, *pool, rows, key, 0)
    else:
        step = jax_dd.make_pooled_dlc_scan_step(jm, cfg, tx, aug_cfg,
                                                bn_train=True)
        out = step(jvars, state, *pool, rows, jax.random.split(key, 2))
    new_vars, state, losses = jax.tree.map(np.asarray, out)
    trace = ckpt.state_dict_from_flax({"params": jax_trace(state)})
    return losses, trace, ckpt.state_dict_from_flax(new_vars)


def _port_bn_step(kind, kw, variables, pool, dtype, lr, aug_cfg=None):
    """The port's counterpart of :func:`_jax_bn_step`."""
    cfg = PoseConfig(**kw)
    model = PoseModel(cfg, dtype=dtype, param_dtype=torch.float32)
    model.load_state_dict(ckpt.state_dict_from_flax(variables), strict=True)
    model.eval()
    opt = torch_steps.make_optimizer(model.parameters(), lr)
    images, coords, present, content = (torch.from_numpy(a) for a in pool)
    rows = torch.tensor(ROWS[kind])
    if kind == "host":
        step = torch_steps.make_dlc_train_step(model, cfg, opt, bn_train=True)
        out = step(images[rows], coords[rows], present[rows] > 0)
    else:
        table = types.SimpleNamespace(images=images, coords=coords,
                                      present=present, content_wh=content)
        make = (dd.make_pooled_dlc_train_step if kind == "pooled"
                else dd.make_pooled_dlc_scan_step)
        out = make(model, cfg, opt, aug_cfg, bn_train=True)(
            table, rows, torch.Generator().manual_seed(0))
    trace = {k: opt.state[p]["momentum_buffer"]
             for k, p in model.named_parameters()}
    return ({k: v.numpy() for k, v in out.items()}, trace,
            model.state_dict())


def _held(ours, want, want32) -> bool:
    """No farther from JAX's bf16 value than that is from JAX's float32
    one, with a floor of 1e-6 of the tensor's largest float32 value."""
    scale = want32.abs().max().item()
    return ((ours - want).abs().max().item()
            <= max((want - want32).abs().max().item(), 1e-6 * scale))


def assert_bn_step_holds(got, want, want32, traces: bool = True):
    """``got`` (the port's bf16 step), ``want`` (JAX's op-by-op bf16 step)
    and ``want32`` (JAX's float32 step) as :func:`_jax_bn_step` returns
    them: the module docstring's bounds (the traces only with
    ``traces``)."""
    (losses, trace, stats), (jlosses, jtrace, jstats) = got, want
    trace32, stats32 = want32[1], want32[2]
    assert set(losses) == set(jlosses)
    for key, value in losses.items():
        np.testing.assert_allclose(value, jlosses[key], rtol=LOSS_RTOL,
                                   err_msg=key)
    assert set(trace) == set(jtrace)
    largest = max(v.abs().max().item() for v in trace32.values())
    apart = []
    for key, value in trace.items() if traces else ():
        if key.endswith(NOISE_ONLY):
            assert trace32[key].abs().max().item() <= 1e-6 * largest, key
            noise = (jtrace[key] - trace32[key]).abs().max().item()
            if (value - trace32[key]).abs().max().item() > 2 * noise:
                apart.append(key)
        elif not _held(value, jtrace[key], trace32[key]):
            apart.append(key)
    moving = [k for k in jstats if k.endswith((".mean", ".var"))]
    assert moving
    apart += [k for k in moving if not _held(stats[k], jstats[k],
                                             stats32[k])]
    assert not apart, apart


def _bn_case(kind, kw, lr, aug_cfg=None, key=None, port_aug=None):
    variables, pool = _bn_inputs(kw)
    with jax.disable_jit():
        want = _jax_bn_step(kind, kw, variables, pool, jnp.bfloat16, lr,
                            aug_cfg, key)
    want32 = _jax_bn_step(kind, kw, variables, pool, jnp.float32, lr,
                          aug_cfg, key)
    got = _port_bn_step(kind, kw, variables, pool, BF16, lr, port_aug)
    return got, want, want32


@pytest.mark.parametrize("net_type", ["resnet_tiny", "mobilenet_v2_0.35"])
@pytest.mark.parametrize("kind", ["host", "pooled", "scan"])
def test_bf16_bn_train_step_matches_jax_bf16(tiny_resnet, net_type, kind):
    """The step-0 update with trainable batch-norm in bf16, batch 1:
    host-fed, from the pool and as a dispatch of two updates (at a rate of
    0, see the module docstring), against JAX's op-by-op bf16 step."""
    kw = small_cfg(net_type)
    got, want, want32 = _bn_case(kind, kw, 0.0 if kind == "scan" else BN_LR)
    if kind == "scan":
        assert all(v.shape == (2,) for v in got[0].values())
    assert_bn_step_holds(got, want, want32)


def test_bf16_pooled_augmented_step_matches_jax_bf16(tiny_resnet,
                                                     monkeypatch):
    """The pooled bf16 update with the card recipe's augmentation, on
    JAX's draws: the canvas reaches the model as JAX's augment makes it
    (float32, within AUG_IMAGE_ATOL on the 0-255 scale), the backbone gets
    it mean-subtracted in bf16 in both packages (within a bf16 step), and
    the loss terms and moving statistics hold as above. The traces are
    not held: canvases 1e-3 apart round to bf16 apart in places, and from
    there the two bf16 steps part (6 of the 55 traces past the bound)."""
    kw = small_cfg(tiny_resnet)
    jcfg = dataclasses.replace(
        jax_aug.DeviceAugmentConfig.reference(scale_jitter=JITTER),
        fast_warp=False)
    key = jax.random.PRNGKey(7)
    seen = {"jax": [], "torch": []}

    def draws_of_jax(generator, images, coords, present, cfg, gate=None,
                     content_wh=None):
        b, h, w, _ = images.shape
        return aug.apply_augment(images, coords, present, cfg,
                                 jax_draws(key, jcfg, b, (h, w)), gate=gate,
                                 content_wh=content_wh)

    def record_jax(next_fun, args, kwargs, context):
        name = type(context.module).__name__
        if name in ("PoseModel", "ResNetV1") and context.method_name == (
                "__call__"):
            seen["jax"].append((name, np.asarray(args[0], np.float32),
                                args[0].dtype))
        return next_fun(*args, **kwargs)

    def record_port(module, args):
        seen["torch"].append((type(module).__name__,
                              args[0].detach().float().numpy(),
                              args[0].dtype))

    monkeypatch.setattr(dd, "augment_batch", draws_of_jax)
    monkeypatch.setattr(PoseModel, "forward", _recorded(PoseModel.forward,
                                                        record_port))
    variables, pool = _bn_inputs(kw)
    with jax.disable_jit(), nn.intercept_methods(record_jax):
        want = _jax_bn_step("pooled", kw, variables, pool, jnp.bfloat16,
                            BN_LR, jcfg, key)
    want32 = _jax_bn_step("pooled", kw, variables, pool, jnp.float32,
                          BN_LR, jcfg, key)
    got = _port_bn_step("pooled", kw, variables, pool, BF16, BN_LR,
                        port_cfg(jcfg))
    (_, jimages, jdtype), (_, jx, jxdtype) = seen["jax"][:2]
    (_, images, dtype), (_, x, xdtype) = seen["torch"]
    assert jdtype == jnp.float32 and dtype == torch.float32
    assert not np.array_equal(images, pool[0][ROWS["pooled"]])
    np.testing.assert_allclose(images, jimages, rtol=0, atol=AUG_IMAGE_ATOL)
    assert jxdtype == jnp.bfloat16 and xdtype == BF16
    np.testing.assert_allclose(x.transpose(0, 2, 3, 1), jx, rtol=2 ** -7,
                               atol=AUG_IMAGE_ATOL)
    assert_bn_step_holds(got, want, want32, traces=False)


def _recorded(forward, record):
    """``PoseModel.forward`` that records what reaches the model and its
    backbone."""
    def wrapped(self, images, *args, **kwargs):
        record(self, (images,))
        handle = self.backbone.register_forward_pre_hook(record)
        try:
            return forward(self, images, *args, **kwargs)
        finally:
            handle.remove()
    return wrapped


def parting_table() -> list:
    """The readings behind the module docstring, for each step and
    backbone: how far the port's bf16 step (``port``) and JAX's jitted
    bf16 step (``jit``) are from JAX's op-by-op bf16 step, the loss terms'
    largest relative distance and the count of traces past the bound
    (and how many of them are MobileNetV2's noise-only biases), and the
    median over the traces of JAX's bf16 distance from its
    float32 trace, over the tensor's largest float32 value. The dispatch
    is read at rates 0 and 1e-4."""
    from test_torch_fit import tiny_blocks

    rows = []
    cases = [(k, BN_LR) for k in ("host", "pooled")] + [
        ("scan", 0.0), ("scan", 1e-4)]
    with tiny_blocks():
        for net_type in ("resnet_tiny", "mobilenet_v2_0.35"):
            kw = small_cfg(net_type)
            variables, pool = _bn_inputs(kw)
            for kind, lr in cases:
                with jax.disable_jit():
                    want = _jax_bn_step(kind, kw, variables, pool,
                                        jnp.bfloat16, lr)
                jit = _jax_bn_step(kind, kw, variables, pool, jnp.bfloat16,
                                   lr)
                want32 = _jax_bn_step(kind, kw, variables, pool,
                                      jnp.float32, lr)
                got = _port_bn_step(kind, kw, variables, pool, BF16, lr)
                row = {"net": net_type, "step": kind, "lr": lr}
                for name, side in (("port", got), ("jit", jit)):
                    row[f"{name}_loss_rel"] = max(
                        float(np.max(np.abs(side[0][k] - want[0][k])
                                     / np.abs(want[0][k])))
                        for k in want[0])
                    apart = [k for k in want[1] if not _held(
                        side[1][k], want[1][k], want32[1][k])]
                    row[f"{name}_traces_apart"] = len(apart)
                    row[f"{name}_noise_only_apart"] = sum(
                        k.endswith(NOISE_ONLY) for k in apart)
                row["traces"] = len(want[1])
                row["bf16_vs_f32_median"] = float(np.median([
                    (want[1][k] - want32[1][k]).abs().max().item()
                    / want32[1][k].abs().max().item() for k in want[1]]))
                rows.append(row)
    return rows


if __name__ == "__main__":
    # python tests/test_torch_bf16_train.py (JAX_PLATFORMS=cpu)
    import json

    torch.set_num_threads(2)
    for row in parting_table():
        print(json.dumps(row), flush=True)

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
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepgraphpose_tpu.core import checkpoint as jax_ckpt
from deepgraphpose_tpu.core.config import PoseConfig as JaxPoseConfig
from deepgraphpose_tpu.models.pose_model import PoseModel as JaxPoseModel
from deepgraphpose_tpu.ops.dgp_objective import DGPLossParams as JaxParams
from deepgraphpose_tpu.train import steps as jax_steps
from deepgraphpose_tpu_torch.core import checkpoint as ckpt
from deepgraphpose_tpu_torch.core.config import PoseConfig
from deepgraphpose_tpu_torch.models.pose_model import (PoseModel, init_model,
                                                       scoremap_size)
from deepgraphpose_tpu_torch.ops.dgp_objective import DGPLossParams
from deepgraphpose_tpu_torch.train import fit
from deepgraphpose_tpu_torch.train import steps as torch_steps
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

"""The port's MobileNetV2 (``models/mobilenet.py``) against the JAX package's.

Both packages get the same random flax variables (numpy, seeded; the stem
kernel divided by 100 so 0-255 pixels give O(1) activations and the relu6s
do not saturate; batch-norm statistics randomized so the BN mapping is
exercised) and the same uint8 frames, on the CPU:

* the float forward at every width, output_stride 16 and 8, at an even
  (64x80) and an odd (65x81) input: TF SAME pads a stride-2 conv over an
  even side one more below / right than above / left, over an odd side
  alike. Bound: 1e-4 of the largest logit, the ResNet parity tests' bound
  (float32; the two frameworks sum the convolutions in other orders);
* the weights bridge bit for bit, under the backbone scope
  ``MobileNetV2_0``, and a snapshot the port writes, loaded and run by the
  JAX package;
* the TF name map, equal to the JAX package's on every mobilenet_v2_1.0
  leaf, and a TF-named array set made from JAX variables imported back
  bit for bit;
* one DGP step (step 2's objective) with frozen batch-norm in float32,
  as ``tests/test_torch_train.py`` holds the ResNet step, and with
  trainable batch-norm in float64 against the JAX step in float64;
* ``estimate_pose`` on the synthetic project's video;
* the three fit entry points with a MobileNetV2 ``pose_cfg`` and no
  warm start: the seeded init with trainable batch-norm, snapshots the
  JAX package loads.
"""

import shutil

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepgraphpose_tpu.core import checkpoint as jax_ckpt
from deepgraphpose_tpu.core.config import PoseConfig as JaxPoseConfig
from deepgraphpose_tpu.infer import predict as jax_predict
from deepgraphpose_tpu.models import mobilenet as jax_mnet
from deepgraphpose_tpu.models import tf_import as jax_tf_import
from deepgraphpose_tpu.models.pose_model import PoseModel as JaxPoseModel
from deepgraphpose_tpu.models.pose_model import init_model as jax_init_model
from deepgraphpose_tpu.utils.synthetic import make_synthetic_project
from deepgraphpose_tpu_torch.core import checkpoint as ckpt
from deepgraphpose_tpu_torch.core import paths
from deepgraphpose_tpu_torch.core.config import PoseConfig
from deepgraphpose_tpu_torch.infer import predict
from deepgraphpose_tpu_torch.models import mobilenet as torch_mnet
from deepgraphpose_tpu_torch.models import tf_import
from deepgraphpose_tpu_torch.models.pose_model import PoseModel, scoremap_size
from deepgraphpose_tpu_torch.ops.dgp_objective import DGPLossParams
from deepgraphpose_tpu_torch.train import fit
from deepgraphpose_tpu_torch.train import steps as torch_steps
from test_torch_train import (assert_step_matches, dgp_batch, dgp_params,
                              jax_dgp_step, jax_trace)

LOGIT_RTOL = 1e-4          # of the largest logit, float32
WIDTHS = sorted(torch_mnet.WIDTHS)
SIZES = [(64, 80), (65, 81)]
STEP_NET = "mobilenet_v2_0.35"


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two torch threads while this file runs, as tests/test_torch_fit.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def random_variables(model, hw, seed=0, stem_scale=0.01):
    """numpy flax variables of a JAX PoseModel: LeCun-scaled kernels (the
    stem's times ``stem_scale``), BN scale and var in [0.5, 1.5], the rest
    N(0, 0.1)."""
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, *hw, 3))))
    rng = np.random.default_rng(seed)
    out = {}
    for path, s in flax.traverse_util.flatten_dict(shapes).items():
        name = path[-1]
        if name == "kernel":
            v = rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
            if path[-2] == "conv_stem":
                v = v * stem_scale
        elif name in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, s.shape)
        else:
            v = rng.standard_normal(s.shape) * 0.1
        out[path] = v.astype(np.float32)
    return flax.traverse_util.unflatten_dict(out)


def port_model(kw, variables, **model_kw):
    model = PoseModel(PoseConfig(**kw), **model_kw)
    model.load_state_dict(ckpt.state_dict_from_flax(variables), strict=True)
    return model.eval()


def frames(n, hw, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (n, *hw, 3)).astype(
        np.uint8)


@pytest.mark.parametrize("k,stride,rate", [(3, 1, 1), (3, 2, 1), (3, 1, 2),
                                           (3, 1, 4), (1, 1, 1), (1, 2, 1)])
@pytest.mark.parametrize("size", [747, 832, 374, 416, 64, 65, 9, 10, 1])
def test_same_pads_are_tf_same(k, stride, rate, size):
    keff = rate * (k - 1) + 1
    want = jax.lax.padtype_to_pads((size,), (keff,), (stride,), "SAME")[0]
    assert torch_mnet.same_pads(k, stride, rate, size) == tuple(want)


def test_stride_two_pads_at_the_reference_frame():
    """At 747x832 the stem pads H by (1, 1) and W by (0, 1)."""
    assert torch_mnet.same_pads(3, 2, 1, 747) == (1, 1)
    assert torch_mnet.same_pads(3, 2, 1, 832) == (0, 1)


def test_plan_and_widths_are_the_jax_packages():
    assert torch_mnet.WIDTHS == jax_mnet.WIDTHS
    for width in torch_mnet.WIDTHS.values():
        for output_stride in (8, 16, 32):
            assert (torch_mnet.unit_plan(width, output_stride)
                    == jax_mnet.unit_plan(width, output_stride))
        for ch in (16, 24, 32, 96, 320, 1280):
            assert torch_mnet._depth(ch, width) == jax_mnet._depth(ch, width)


@pytest.mark.parametrize("hw", SIZES, ids=["even", "odd"])
@pytest.mark.parametrize("output_stride", [16, 8])
@pytest.mark.parametrize("net_type", WIDTHS)
def test_forward_matches_jax(net_type, output_stride, hw):
    kw = dict(net_type=net_type, num_joints=3, output_stride=output_stride,
              location_refinement=True, intermediate_supervision=True)
    jm = JaxPoseModel(JaxPoseConfig(**kw))
    variables = random_variables(jm, hw)
    images = frames(2, hw)
    want = jm.apply(variables, jnp.asarray(images, jnp.float32))
    model = port_model(kw, variables)
    with torch.no_grad():
        got = model(torch.from_numpy(images))
    # no intermediate head on MobileNetV2, in either package
    assert set(got) == set(want) == {"part_pred", "locref"}
    assert model.backbone.out_depth == torch_mnet.head_depth(
        torch_mnet.WIDTHS[net_type])
    for key, value in got.items():
        w = np.asarray(want[key])
        assert value.dtype == torch.float32 and value.is_contiguous()
        assert value.shape == w.shape
        scale = np.abs(w).max()
        assert scale > 0.1       # the logits are not saturated or dead
        assert np.abs(value.numpy() - w).max() <= LOGIT_RTOL * scale, key
    assert tuple(got["part_pred"].shape[1:3]) == scoremap_size(
        PoseConfig(**kw), hw)


def test_weights_bridge_round_trips_with_the_mobilenet_scope(tmp_path):
    kw = dict(net_type="mobilenet_v2_1.0", num_joints=3)
    jm = JaxPoseModel(JaxPoseConfig(**kw))
    variables = random_variables(jm, SIZES[0])
    model = port_model(kw, variables)
    back = ckpt.flax_from_state_dict(model.state_dict())
    assert set(back["params"]) == {"MobileNetV2_0", "part_pred", "locref_pred"}
    flat_back = flax.traverse_util.flatten_dict(back)
    flat_want = flax.traverse_util.flatten_dict(variables)
    assert set(flat_back) == set(flat_want)
    for path, value in flat_want.items():
        assert flat_back[path].dtype == np.float32
        np.testing.assert_array_equal(flat_back[path], value,
                                      err_msg=str(path))
    dw = model.backbone.block1_unit0.depthwise.weight
    assert dw.shape == (96, 1, 3, 3)

    # a snapshot the port writes: the JAX package loads and runs it
    path = ckpt.save_snapshot(tmp_path, 0, "final--0", model)
    loaded = jax_ckpt.load_snapshot(path)[0]
    images = frames(2, SIZES[0], seed=4)
    want = jm.apply(loaded, jnp.asarray(images, jnp.float32))["part_pred"]
    with torch.no_grad():
        got = model(torch.from_numpy(images))["part_pred"].numpy()
    scale = np.abs(np.asarray(want)).max()
    assert np.abs(got - np.asarray(want)).max() <= LOGIT_RTOL * scale


def test_tf_name_map_is_the_jax_packages():
    net = "mobilenet_v2_1.0"
    jm = JaxPoseModel(JaxPoseConfig(net_type=net, num_joints=3))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 64, 64, 3))))
    n = 0
    for path, s in jax_tf_import._iter_paths(shapes):
        want = jax_tf_import.tf_name_for_path(path, net)
        got = tf_import.tf_name_for_path(path, net)
        assert (got is None) == (want is None), path
        if got is not None:
            assert got[0] == want[0], path
            arr = np.arange(np.prod(s.shape), dtype=np.float32).reshape(
                s.shape)
            np.testing.assert_array_equal(got[1](arr), want[1](arr))
            n += 1
    # 52 convs and BNs of 4 leaves each (stem, 17 units, head; block 0's
    # unit has no expand), and the two heads' kernels and biases
    assert n == 52 + 52 * 4 + 4
    assert tf_import.backbone_tf_scope(net) == "MobilenetV2"
    assert tf_import.backbone_tf_scope("resnet_50") == "resnet"


def _to_tf(path, leaf, net):
    """A flax leaf as the TF checkpoint holds it (the inverse of the
    import's transform)."""
    name, _ = jax_tf_import.tf_name_for_path(path, net)
    if path[-2] == "depthwise":
        return name, jax_tf_import._depthwise_from_tf(leaf)   # self-inverse
    if path[1] in tf_import._HEAD_SCOPES and path[-1] == "kernel":
        return name, jax_tf_import._deconv_to_tf(leaf)
    return name, leaf


def test_tf_arrays_import_round_trip():
    """TF-named arrays made from JAX variables import into a fresh port
    model as exactly those variables, and as the JAX importer takes them."""
    net = "mobilenet_v2_0.5"
    kw = dict(net_type=net, num_joints=3, location_refinement=True)
    jm = JaxPoseModel(JaxPoseConfig(**kw))
    variables = random_variables(jm, SIZES[0], seed=2)
    arrays = dict(_to_tf(p, v, net)
                  for p, v in jax_tf_import._iter_paths(variables))
    fresh = PoseModel(PoseConfig(**kw)).state_dict()
    scopes = (tf_import.backbone_tf_scope(net), "pose")
    state, report = tf_import.import_tf_arrays(fresh, arrays, net,
                                               scopes=scopes)
    assert not report["missing"] and not report["skipped"]
    assert len(report["imported"]) == len(arrays)
    want = ckpt.state_dict_from_flax(variables)
    assert set(state) == set(want)
    for key, value in want.items():
        assert torch.equal(state[key], value), key
    jax_vars, _ = jax_tf_import.import_tf_arrays(
        random_variables(jm, SIZES[0], seed=3), arrays, net, scopes=scopes)
    for key, value in ckpt.state_dict_from_flax(jax_vars).items():
        assert torch.equal(state[key], value), key


def _step(kw, variables, images, batch, params, bn_train, dtype):
    """One port DGP step in ``dtype`` -> (model, optimizer, state before,
    loss terms)."""
    model = PoseModel(PoseConfig(**kw), dtype=dtype)
    model.load_state_dict(ckpt.state_dict_from_flax(variables), strict=True)
    model.eval()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = torch_steps.make_optimizer(model.parameters(), 0.05, clip_norm=10.0)
    got = torch_steps.make_dgp_train_step(
        model, DGPLossParams(**params), opt, visible_only=False,
        bn_train=bn_train)(torch.from_numpy(images),
                           {k: torch.from_numpy(v).to(dtype)
                            for k, v in batch.items()})
    return model, opt, before, got


def _step_inputs(stem_scale=0.01):
    hw = SIZES[0]          # dgp_batch's flow is test_torch_train's 64x80
    kw = dict(net_type=STEP_NET, num_joints=3)
    variables = random_variables(JaxPoseModel(JaxPoseConfig(**kw)), hw,
                                 seed=5, stem_scale=stem_scale)
    images = frames(5, hw, seed=2)
    images[4] = images[3]                       # padding repeats the last
    batch = dgp_batch(5, 3, scoremap_size(PoseConfig(**kw), hw))
    return kw, variables, images, batch, dgp_params(3)


def test_dgp_step_matches_jax():
    """One DGP step of mobilenet_v2_0.35 with frozen batch-norm, float32
    in both, held as tests/test_torch_train.py holds the ResNet step:
    loss terms within 1e-5 relative, parameters and buffers within 1e-5,
    each tensor's update within 1e-4 of its largest."""
    kw, variables, images, batch, params = _step_inputs()
    new_vars, state, want = jax_dgp_step(kw, variables, images, batch,
                                         params, False, False, jnp.float32)
    model, opt, before, got = _step(kw, variables, images, batch, params,
                                    False, torch.float32)
    assert set(got) == set(want)
    for key, value in got.items():
        assert value.item() == pytest.approx(want[key], rel=1e-5), key
    assert_step_matches(model, opt, before, new_vars, state)


def test_dgp_step_with_trainable_batch_norm_matches_jax():
    """The same step with batch-norm on batch statistics, held in float64
    against the JAX step in float64 (``jax.enable_x64``); the heads and
    the objective stay float32 in both packages.

    Not in float32: relu6 has a kink at 0 and batch-normalized values sit
    near it, so a float32 rounding moves a value across it and its
    gradient from 0 to whole (measured: one value of block4_unit0's
    depthwise_bn output is -1.2e-7 in float64 and +3.2e-6 in the port's
    float32, which makes that gradient 29% off), while the loss terms
    agree within 1e-5 (checked here). The stem keeps its LeCun scale:
    batch-norm normalizes its output in this mode, and a stem kernel
    scaled down 100 times gets a gradient 100 times larger (the function
    is invariant to the kernel's scale), which the update then turns
    into large relative changes of that small kernel.

    Bounds: parameters and buffers within 1e-5 of each tensor's largest
    value, each tensor's update within 1e-4 of its largest update. Every
    project_bn bias has a gradient of 0 in exact arithmetic (each consumer
    of the unit's output normalizes a constant shift away), so its update
    is rounding noise: below 1e-6 of the step's largest in both
    packages."""
    kw, variables, images, batch, params = _step_inputs(stem_scale=1.0)
    args = (kw, variables, images, batch, params, False, True)
    with jax.enable_x64(True):
        new_vars, state, want = jax_dgp_step(*args, jnp.float64)
    _, _, want32 = jax_dgp_step(*args, jnp.float32)
    model, opt, before, got = _step(kw, variables, images, batch, params,
                                    True, torch.float64)
    _, _, _, got32 = _step(kw, variables, images, batch, params, True,
                           torch.float32)
    for key in want:
        assert got[key].item() == pytest.approx(want[key], rel=1e-5), key
        assert got32[key].item() == pytest.approx(want32[key], rel=1e-5), key
    ref = ckpt.state_dict_from_flax(new_vars)
    ours = model.state_dict()
    assert set(ours) == set(ref)
    for key, value in ref.items():
        err = (ours[key].float() - value).abs().max().item()
        assert err <= 1e-5 * value.abs().max().item(), key
    trace = ckpt.state_dict_from_flax({"params": jax_trace(state)})
    noise = 1e-6 * max(v.abs().max().item() for v in trace.values())
    zero = [k for k in trace if k.endswith("project_bn.bias")]
    assert len(zero) == 17
    for key, p in model.named_parameters():
        upd = opt.state[p]["momentum_buffer"].float()
        scale = trace[key].abs().max().item()
        if key in zero:
            assert max(scale, upd.abs().max().item()) <= noise, key
        else:
            assert (upd - trace[key]).abs().max().item() <= 1e-4 * scale, key


def test_estimate_pose_matches_jax(synthetic_project, tmp_path):
    """The JAX package's own init of mobilenet_v2_1.0 (part_pred scaled by
    0.1 so the logits are O(1)) in both: x / y within 1e-3 px and the
    likelihood within 1e-4, as tests/test_torch_infer.py holds ResNet-50."""
    video = synthetic_project[0] + "/videos/synthvid.avi"
    jcfg = JaxPoseConfig(num_joints=3, net_type="mobilenet_v2_1.0")
    jmodel, jvars = jax_init_model(jcfg, jax.random.PRNGKey(0), (64, 80))
    jvars = jax.tree_util.tree_map(np.asarray, jvars)
    head = jvars["params"]["part_pred"]["block4"]
    head["kernel"] = head["kernel"] * np.float32(0.1)
    head["bias"] = head["bias"] * np.float32(0.1)
    kw = dict(batch_size=8, max_frames=20, save_pose=False)
    want = jax_predict.estimate_pose(
        None, tmp_path / "snap.ckpt", video, tmp_path, pose_cfg=jcfg,
        model=jmodel, variables=jvars, **kw)
    cfg = PoseConfig(num_joints=3, net_type="mobilenet_v2_1.0")
    got = predict.estimate_pose(
        None, tmp_path / "snap.ckpt", video, tmp_path, pose_cfg=cfg,
        model=port_model(dict(num_joints=3, net_type="mobilenet_v2_1.0"),
                         jvars), device="cpu", **kw)
    assert got["x"].shape == (20, 3)
    for key in ("x", "y"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["likelihoods"], want["likelihoods"],
                               rtol=0, atol=1e-4)


def test_fit_entry_points_train_mobilenet(tmp_path, capsys):
    """fit_dlc -> fit_dgp_labeledonly -> fit_dgp on a MobileNetV2 project
    with no pretrained file: each starts from the seeded init (step 0) or
    the step before, trains its batch-norm statistics (the auto-on of a
    cold start), logs finite losses and writes float32 snapshots of
    ``MobileNetV2_0`` that the JAX package loads and runs."""
    root, _, _ = make_synthetic_project(tmp_path / "p", hw=(48, 64))
    _, cfg, train_dir = paths.resolve_project(root)
    cfg.net_type = STEP_NET
    cfg.to_yaml(train_dir / "pose_cfg.yaml")
    try:
        fit.fit_dlc(dlcpath=root, maxiters=3, displayiters=1, device="cpu")
        out = capsys.readouterr().out
        assert "fit_dlc: trainable batch-norm enabled" in out, out
        fit.fit_dgp_labeledonly(dlcpath=root, maxiters=2, displayiters=1,
                                nepoch=1, device="cpu")
        final = fit.fit_dgp(dlcpath=root, batch_size=3, maxiters=2,
                            displayiters=1, nepoch=1, device="cpu")
        init = PoseModel(PoseConfig(net_type=STEP_NET, num_joints=3)).state_dict()
        jcfg = JaxPoseConfig(net_type=STEP_NET, num_joints=3)
        for step in range(3):
            path = train_dir / f"snapshot-step{step}-final--0.ckpt"
            variables = jax_ckpt.load_snapshot(path)[0]
            assert set(variables["params"]) >= {"MobileNetV2_0", "part_pred"}
            stats = ckpt.state_dict_from_flax(variables)
            key = "backbone.stem_bn.mean"
            assert not torch.equal(stats[key], init[key])   # BN trained
            leaves = jax.tree_util.tree_leaves(variables)
            assert all(np.asarray(v).dtype == np.float32 for v in leaves)
            heads = JaxPoseModel(jcfg).apply(
                variables, jnp.zeros((1, 48, 64, 3), jnp.float32))
            assert np.isfinite(np.asarray(heads["part_pred"])).all()
        assert final == train_dir / "snapshot-step2-final--0.ckpt"
        rows = (train_dir / "learning_stats.csv").read_text().split()[1:]
        assert rows and np.isfinite([float(r.split(",")[1])
                                     for r in rows]).all()
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.mark.parametrize("quantize", [False, True])
def test_estimate_pose_dynamic_video_matches_jax(synthetic_project, tmp_path,
                                                 quantize):
    """The tracked crop from a MobileNetV2 project and a JAX snapshot on
    disk (the JAX package's init of mobilenet_v2_1.0, part_pred scaled by
    0.1): float32 within 1e-3 px and likelihood 1e-4, the same
    ``cropped`` flags; int8 (each package calibrating on the first 8
    frames) within tests/test_torch_quant.py's px bounds, 2 px max and
    0.5 px mean."""
    from deepgraphpose_tpu.infer import dynamic as jax_dynamic
    from deepgraphpose_tpu_torch.infer import dynamic

    root = tmp_path / "proj"
    shutil.copytree(synthetic_project[0], root)
    _, cfg, train_dir = paths.resolve_project(root)
    cfg.net_type = "mobilenet_v2_1.0"
    cfg.to_yaml(train_dir / "pose_cfg.yaml")
    jcfg = JaxPoseConfig(num_joints=3, net_type="mobilenet_v2_1.0")
    _, jvars = jax_init_model(jcfg, jax.random.PRNGKey(0), (64, 80))
    jvars = jax.tree_util.tree_map(np.asarray, jvars)
    head = jvars["params"]["part_pred"]["block4"]
    head["kernel"] = head["kernel"] * np.float32(0.1)
    head["bias"] = head["bias"] * np.float32(0.1)
    snap = jax_ckpt.save_snapshot(tmp_path, 0, "final--0", jvars)
    video = str(root / "videos" / "synthvid.avi")
    kw = dict(crop_hw=(48, 64), batch_size=8, max_frames=24,
              detection_threshold=0.5, save_pose=False, quantize=quantize)
    want = jax_dynamic.estimate_pose_dynamic_video(
        root / "config.yaml", snap, video, tmp_path, **kw)
    got = dynamic.estimate_pose_dynamic_video(
        root / "config.yaml", snap, video, tmp_path, device="cpu", **kw)
    np.testing.assert_array_equal(got["cropped"], want["cropped"])
    assert got["cropped"].any()
    err = np.stack([np.abs(got[k] - want[k]) for k in ("x", "y")])
    if quantize:
        assert err.max() <= 2.0 and err.mean() <= 0.5
    else:
        assert err.max() <= 1e-3
        np.testing.assert_allclose(got["likelihoods"], want["likelihoods"],
                                   rtol=0, atol=1e-4)


def test_tf_warm_start_imports_every_backbone_variable(tmp_path, capsys):
    """fit's ImageNet warm start from a MobileNetV2 TF checkpoint (written
    here by the JAX package's ``write_tf_checkpoint``): the port restores
    under ``MobilenetV2`` and imports every backbone variable, moving
    stats included, and reports ``warmed`` (so fit keeps batch-norm
    frozen). The heads keep their init: an ImageNet file has none."""
    net = STEP_NET
    jm = JaxPoseModel(JaxPoseConfig(net_type=net, num_joints=3))
    variables = random_variables(jm, SIZES[0], seed=9)
    prefix = jax_tf_import.write_tf_checkpoint(
        variables, str(tmp_path / "mobilenet_v2_0.35_224.ckpt"),
        net_type=net)
    cfg = PoseConfig(net_type=net, num_joints=3, init_weights=prefix)
    model = fit._init_model(cfg, 0, None, "cpu")
    heads_before = {k: v.clone() for k, v in model.state_dict().items()
                    if not k.startswith("backbone.")}
    model, warmed = fit._warm_start(model, cfg, tmp_path, None)
    assert warmed
    want = ckpt.state_dict_from_flax(variables)
    state = model.state_dict()
    backbone = [k for k in state if k.startswith("backbone.")]
    assert backbone and all(torch.equal(state[k], want[k]) for k in backbone)
    assert all(torch.equal(state[k], v) for k, v in heads_before.items())
    line = capsys.readouterr().out
    assert f"imported ImageNet init {prefix}" in line
    assert f"({len(backbone)} vars)" in line

"""PyTorch port's ResNet trunk + heads against the JAX PoseModel.

Both packages get the same random variables (numpy, seeded; batch-norm
statistics randomized so the BN mapping is exercised) and the same uint8
frames. The input (33, 47) is odd and one where the ResNet scoremap
formula and ceil(h / output_stride) * 2 disagree in height. Tolerance
1e-4 absolute/relative: float32 on the CPU, the two frameworks sum the
convolutions in different orders.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepgraphpose_tpu.core.config import PoseConfig as JaxPoseConfig
from deepgraphpose_tpu.models import resnet as jax_resnet
from deepgraphpose_tpu.models.pose_model import PoseModel as JaxPoseModel
from deepgraphpose_tpu.models.pose_model import \
    scoremap_size as jax_scoremap_size
from deepgraphpose_tpu_torch.core.checkpoint import state_dict_from_flax
from deepgraphpose_tpu_torch.core.config import PoseConfig
from deepgraphpose_tpu_torch.models import resnet as torch_resnet
from deepgraphpose_tpu_torch.models.heads import PredictionHead
from deepgraphpose_tpu_torch.models.pose_model import PoseModel, scoremap_size

IN_HW = (33, 47)


def random_variables(shapes, seed=0):
    """numpy variables for an eval_shape tree; root conv scaled so the
    0-255 input gives O(1) activations."""
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


@pytest.fixture
def tiny_resnet(monkeypatch):
    """A ResNet-v1 with one unit per block, registered in both packages."""
    monkeypatch.setitem(jax_resnet.BLOCK_UNITS, "resnet_tiny", (1, 1, 1, 1))
    monkeypatch.setitem(torch_resnet.BLOCK_UNITS, "resnet_tiny", (1, 1, 1, 1))
    return "resnet_tiny"


@pytest.mark.parametrize("output_stride", [16, 8])
def test_pose_model_matches_jax(tiny_resnet, output_stride):
    kw = dict(net_type=tiny_resnet, num_joints=3, output_stride=output_stride,
              intermediate_supervision=True, location_refinement=True)
    jm = JaxPoseModel(JaxPoseConfig(**kw))
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, *IN_HW, 3))))
    variables = random_variables(shapes)
    images = np.random.default_rng(1).integers(
        0, 256, (2, *IN_HW, 3)).astype(np.uint8)
    want = jm.apply(variables, jnp.asarray(images, jnp.float32))

    model = PoseModel(PoseConfig(**kw)).eval()
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(images))
    assert set(got) == {"part_pred", "locref", "part_pred_interm"}
    for key, value in got.items():
        assert value.dtype == torch.float32 and value.is_contiguous()
        np.testing.assert_allclose(value.numpy(), np.asarray(want[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)
    assert tuple(got["part_pred"].shape[1:3]) == scoremap_size(
        PoseConfig(**kw), IN_HW)

    with torch.no_grad():
        only = model(torch.from_numpy(images), heads=("part_pred",))
    assert set(only) == {"part_pred"}
    torch.testing.assert_close(only["part_pred"], got["part_pred"])


@pytest.mark.parametrize("net_type", ["resnet_101", "resnet_152"])
def test_deep_resnets_match_jax(net_type):
    """The deeper trunks of ``BLOCK_UNITS`` (block3 of 23 and 36 units,
    block2 of 8 for ResNet-152) through the weights bridge, one frame at
    the odd input: every head within 1e-4 of its largest logit."""
    kw = dict(net_type=net_type, num_joints=3, intermediate_supervision=True)
    jm = JaxPoseModel(JaxPoseConfig(**kw))
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, *IN_HW, 3))))
    variables = random_variables(shapes, seed=4)
    images = np.random.default_rng(5).integers(
        0, 256, (1, *IN_HW, 3)).astype(np.uint8)
    want = jm.apply(variables, jnp.asarray(images, jnp.float32))

    model = PoseModel(PoseConfig(**kw)).eval()
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    assert len(model.backbone.unit_names) == sum(
        torch_resnet.BLOCK_UNITS[net_type])
    with torch.no_grad():
        got = model(torch.from_numpy(images))
    assert set(got) == set(want)
    for key, value in got.items():
        ref = np.asarray(want[key])
        err = np.abs(value.numpy() - ref).max()
        assert err <= 1e-4 * np.abs(ref).max(), (key, err)


@pytest.mark.parametrize("output_stride", [16, 8])
@pytest.mark.parametrize("hw", [IN_HW, (64, 80), (747, 832)])
def test_scoremap_size_matches_jax(output_stride, hw):
    cfg = PoseConfig(num_joints=2, output_stride=output_stride)
    want = jax_scoremap_size(JaxPoseConfig(num_joints=2,
                                           output_stride=output_stride), hw)
    assert scoremap_size(cfg, hw) == want
    if hw == IN_HW:
        # the input is chosen where the naive formula is wrong
        s, d = output_stride, cfg.deconvolutionstride
        assert want[0] != -(-hw[0] // s) * d


@pytest.mark.parametrize("stride", [1, 2])
def test_prediction_head_matches_flax_conv_transpose(stride):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 7, 4)).astype(np.float32)
    head = flax.linen.ConvTranspose(3, (3, 3), strides=(stride, stride),
                                    padding="SAME")
    variables = {"params": {
        "kernel": rng.standard_normal((3, 3, 4, 3)).astype(np.float32),
        "bias": rng.standard_normal(3).astype(np.float32)}}
    want = np.asarray(head.apply(variables, jnp.asarray(x)))

    ours = PredictionHead(4, 3, stride).eval()
    sd = state_dict_from_flax({"params": {
        "part_pred": {"block4": variables["params"]}, "ResNetV1_0": {}}})
    ours.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    with torch.no_grad():
        got = ours(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-5)


def test_unit_plan_matches_jax():
    for units in [(3, 4, 6, 3), (3, 4, 23, 3)]:
        for output_stride in (8, 16, 32):
            assert (torch_resnet.unit_plan(units, output_stride)
                    == jax_resnet.unit_plan(units, output_stride))
    for k, rate in [(1, 1), (3, 1), (3, 2), (7, 1)]:
        assert (torch_resnet.same_pad_for_stride(k, rate)
                == jax_resnet.same_pad_for_stride(k, rate))


def test_frozen_batch_norm_bf16_rounds_like_jax():
    """inv and shift are computed in float32, then cast to the input dtype."""
    rng = np.random.default_rng(3)
    feats = 8
    p = {k: rng.uniform(0.5, 1.5, feats).astype(np.float32)
         for k in ("scale", "bias", "mean", "var")}
    x = rng.standard_normal((2, 3, 4, feats)).astype(np.float32)
    jbn = jax_resnet.FrozenBatchNorm(dtype=jnp.bfloat16)
    want = jbn.apply({"params": {"scale": p["scale"], "bias": p["bias"]},
                      "batch_stats": {"mean": p["mean"], "var": p["var"]}},
                     jnp.asarray(x, jnp.bfloat16))
    bn = torch_resnet.FrozenBatchNorm(feats)
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in p.items()})
    with torch.no_grad():
        got = bn(torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.permute(0, 2, 3, 1).float().numpy(),
        np.asarray(want.astype(jnp.float32)), rtol=1e-2, atol=1e-2)

"""The port reads the JAX package's msgpack snapshots.

A ResNet-50 PoseModel snapshot with all three heads is written by the JAX
``save_snapshot`` and loaded by the port's ``load_snapshot`` +
``state_dict_from_flax`` into ``PoseModel.load_state_dict(strict=True)``:
every leaf is consumed and every value arrives in the right layout.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepgraphpose_tpu.core.checkpoint import save_snapshot
from deepgraphpose_tpu.core.config import PoseConfig as JaxPoseConfig
from deepgraphpose_tpu.models.pose_model import PoseModel as JaxPoseModel
from deepgraphpose_tpu_torch.core.checkpoint import (load_snapshot,
                                                     state_dict_from_flax)
from deepgraphpose_tpu_torch.core.config import PoseConfig
from deepgraphpose_tpu_torch.models.pose_model import PoseModel

KW = dict(net_type="resnet_50", num_joints=4, intermediate_supervision=True,
          location_refinement=True)


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    jm = JaxPoseModel(JaxPoseConfig(**KW))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 64, 64, 3))))
    rng = np.random.default_rng(0)
    flat = {k: rng.standard_normal(s.shape).astype(np.float32)
            for k, s in flax.traverse_util.flatten_dict(shapes).items()}
    variables = flax.traverse_util.unflatten_dict(flat)
    path = save_snapshot(tmp_path_factory.mktemp("snap"), 0, "final--0",
                         variables, opt_state={"count": np.int32(7)})
    return path, flat


def test_snapshot_loads_every_leaf(snapshot):
    path, flat = snapshot
    variables, opt_state = load_snapshot(path)
    assert int(opt_state["count"]) == 7
    sd = state_dict_from_flax(variables)
    assert len(sd) == len(flat)

    model = PoseModel(PoseConfig(**KW))
    result = model.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    assert len(model.state_dict()) == len(flat)


def test_snapshot_layouts(snapshot):
    path, flat = snapshot
    sd = state_dict_from_flax(load_snapshot(path)[0])
    bb = ("params", "ResNetV1_0")
    conv = flat[bb + ("block2_unit1", "conv2", "kernel")]      # (kh,kw,i,o)
    np.testing.assert_array_equal(
        sd["backbone.block2_unit1.conv2.weight"].numpy(),
        conv.transpose(3, 2, 0, 1))
    deconv = flat[("params", "part_pred", "block4", "kernel")]
    np.testing.assert_array_equal(
        sd["part_pred.block4.weight"].numpy(),
        deconv.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])
    np.testing.assert_array_equal(
        sd["backbone.bn1.var"].numpy(),
        flat[("batch_stats", "ResNetV1_0", "bn1", "var")])
    np.testing.assert_array_equal(
        sd["intermediate_supervision.block4.bias"].numpy(),
        flat[("params", "intermediate_supervision", "block4", "bias")])


def test_bfloat16_leaves_widen_to_float32(tmp_path):
    """Snapshots written from bfloat16 arrays load as the same values."""
    leaf = jnp.asarray([1.5, -2.25, 3e-3], jnp.bfloat16)
    path = save_snapshot(tmp_path, 0, 1, {"params": {"w": leaf}})
    variables, _ = load_snapshot(path)
    np.testing.assert_array_equal(variables["params"]["w"],
                                  np.asarray(leaf.astype(jnp.float32)))
    assert torch.from_numpy(variables["params"]["w"]).dtype == torch.float32

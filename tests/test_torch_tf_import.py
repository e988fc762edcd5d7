"""The port's TF export direction against the JAX package's
(``deepgraphpose_tpu/models/tf_import.py:268-313``).

* ``export_tf_arrays`` on a port state_dict gives the JAX package's
  ``export_tf_arrays`` on the same weights (carried across with
  ``flax_from_state_dict``): the same names, the same float32 arrays, bit
  for bit; it is the exact inverse of the port's ``import_tf_arrays``
  (ResNet-50 and a MobileNetV2 width).
* A ``write_tf_checkpoint`` prefix loads exactly in both packages'
  ``import_tf_checkpoint`` and holds the variables the JAX package's
  writer writes for the same weights.
* Without TensorFlow the writer raises ImportError; ``download_weights``
  raises, as the JAX package's does.
"""

import sys

import numpy as np
import pytest
import torch

from deepgraphpose_tpu.models import tf_import as jax_tf_import
from deepgraphpose_tpu_torch.core.checkpoint import flax_from_state_dict
from deepgraphpose_tpu_torch.core.config import PoseConfig
from deepgraphpose_tpu_torch.models import pretrained, tf_import
from deepgraphpose_tpu_torch.models.pose_model import PoseModel

tf = pytest.importorskip("tensorflow")


def random_state(net_type: str, seed: int = 0) -> dict:
    """Every tensor of a port model's state drawn from N(0, 1)."""
    model = PoseModel(PoseConfig(net_type=net_type, num_joints=3))
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(
        rng.standard_normal(tuple(v.shape)).astype(np.float32))
        for k, v in model.state_dict().items()}


def assert_same_arrays(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == np.float32, name
        assert np.array_equal(got[name], want[name]), name


@pytest.mark.parametrize("net_type", ["resnet_50", "mobilenet_v2_0.35"])
def test_export_equals_jax_and_inverts_import(net_type):
    state = random_state(net_type)
    arrays = tf_import.export_tf_arrays(state, net_type)
    assert_same_arrays(arrays, jax_tf_import.export_tf_arrays(
        flax_from_state_dict(state), net_type))
    scope = "MobilenetV2/" if net_type.startswith("mobilenet") else \
        "resnet_v1_50/"
    assert any(n.startswith(scope) for n in arrays)
    assert "pose/part_pred/block4/weights" in arrays

    zero = {k: torch.zeros_like(v) for k, v in state.items()}
    back, report = tf_import.import_tf_arrays(zero, arrays, net_type)
    assert report["missing"] == [] and report["skipped"] == []
    assert sorted(back) == sorted(state)
    for key, value in state.items():
        assert torch.equal(back[key], value), key
    assert_same_arrays(tf_import.export_tf_arrays(back, net_type), arrays)


def test_write_tf_checkpoint_loads_in_both_packages(tmp_path):
    net_type = "resnet_50"
    state = random_state(net_type, seed=1)
    prefix = tf_import.write_tf_checkpoint(
        state, str(tmp_path / "port" / "snapshot-step2-final--0"), net_type)
    assert prefix.endswith("snapshot-step2-final--0")
    zero = {k: torch.zeros_like(v) for k, v in state.items()}
    back, report = tf_import.import_tf_checkpoint(zero, prefix, net_type)
    assert report["missing"] == []
    for key, value in state.items():
        assert torch.equal(back[key], value), key

    variables = flax_from_state_dict(state)
    jback, jreport = jax_tf_import.import_tf_checkpoint(
        flax_from_state_dict(zero), prefix, net_type)
    assert jreport["missing"] == []
    assert_same_arrays(
        dict(jax_tf_import._iter_paths(jback)),
        dict(jax_tf_import._iter_paths(variables)))

    jprefix = jax_tf_import.write_tf_checkpoint(
        variables, str(tmp_path / "jax" / "snapshot-step2-final--0"),
        net_type)
    assert_same_arrays(tf_import.load_tf_checkpoint_arrays(prefix),
                       tf_import.load_tf_checkpoint_arrays(jprefix))


def test_writer_needs_tensorflow_and_nothing_downloads(monkeypatch,
                                                       tmp_path):
    state = random_state("mobilenet_v2_0.35")
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    with pytest.raises(ImportError, match="requires tensorflow"):
        tf_import.write_tf_checkpoint(state, str(tmp_path / "x"),
                                      "mobilenet_v2_0.35")
    assert tf_import.export_tf_arrays(state, "mobilenet_v2_0.35")
    with pytest.raises(RuntimeError, match="deepgraphpose_tpu_torch"):
        pretrained.download_weights("resnet_50", tmp_path / "w.ckpt")

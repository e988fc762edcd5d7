"""The port's Orbax snapshots against the JAX package's
(``deepgraphpose_tpu/core/checkpoint.py::save_snapshot_orbax`` and
``load_snapshot_orbax``, which run orbax itself).

For each of the three optimizer layouts the fit loops use (as in
``tests/test_torch_snapshots.py``), with the optimizer state:

* a directory the port writes restores in the JAX package, every leaf
  equal to the JAX tree it came from;
* a directory the JAX package writes loads into a port model and
  ``ClippedSGD``: weights, momentum buffers and update count exact;
* port -> port is exact, and the port reads both directories to the same
  trees, empty optimizer states included.

Without tensorstore both functions raise ImportError
(``tests/test_config.py::test_orbax_snapshot_roundtrip`` is the JAX
package's own round trip).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepgraphpose_tpu.core import checkpoint as jax_ckpt
from deepgraphpose_tpu.core.config import PoseConfig as JaxPoseConfig
from deepgraphpose_tpu.models.pose_model import PoseModel as JaxPoseModel
from deepgraphpose_tpu_torch.core import checkpoint as ckpt
from deepgraphpose_tpu_torch.core.config import PoseConfig
from deepgraphpose_tpu_torch.models.pose_model import PoseModel
from deepgraphpose_tpu_torch.train import steps
from test_torch_snapshots import (  # noqa: F401 (fixtures)
    HW, KW, OPTIMIZERS, tiny_resnet, trace_of, two_threads, work)
from test_torch_train import random_variables

pytest.importorskip("tensorstore")
pytest.importorskip("orbax.checkpoint")


def jax_state(name: str):
    """A JAX tree and optimizer state after two updates, and the chain."""
    make_tx = OPTIMIZERS[name][0]
    jm = JaxPoseModel(JaxPoseConfig(**KW))
    variables = random_variables(jm, HW, seed=1)
    tx = make_tx()
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = tx.init(params)
    rng = np.random.default_rng(2)
    for s in (0.05, 0.01):
        g = jax.tree.map(lambda a: jnp.asarray(
            rng.standard_normal(a.shape).astype(np.float32) * s), params)
        updates, state = tx.update(g, state, params)
        params = optax.apply_updates(params, updates)
    return {"params": params, "batch_stats": variables["batch_stats"]}, \
        state, tx


def port_pair(name: str):
    _, port_lr, clip = OPTIMIZERS[name]
    model = PoseModel(PoseConfig(**KW))
    return model, steps.make_optimizer(model.parameters(), port_lr(),
                                       clip_norm=clip)


def assert_same_tree(a, b):
    assert isinstance(a, dict) == isinstance(b, dict), (a, b)
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            assert_same_tree(a[k], b[k])
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_orbax_snapshots_cross_load(tiny_resnet, work, name):
    jvars, state, tx = jax_state(name)
    # the JAX package's orbax writer -> the port
    jpath = jax_ckpt.save_snapshot_orbax(work / "jax", 2, 1, jvars, state)
    model, opt = port_pair(name)
    j_vars, j_opt = ckpt.load_snapshot_orbax(jpath, model, opt)
    assert_same_tree(j_vars, jax.tree.map(np.asarray, jvars))
    want = ckpt.state_dict_from_flax(jax.tree.map(np.asarray, jvars))
    for key, value in model.state_dict().items():
        assert torch.equal(value, want[key]), key
    trace = ckpt.state_dict_from_flax(
        {"params": jax.tree.map(np.asarray, trace_of(state))})
    for key, p in model.named_parameters():
        assert torch.equal(opt.state[p]["momentum_buffer"], trace[key]), key
    assert opt.count == (2 if name != "float_lr" else 0)

    # the port's writer -> the JAX package's orbax restore
    ppath = ckpt.save_snapshot_orbax(work / "torch", 2, 1, model, opt)
    assert ppath.name == jpath.name == "snapshot-step2-1.orbax"
    template = {"params": jax.tree.map(jnp.zeros_like, jvars["params"]),
                "batch_stats": jax.tree.map(jnp.zeros_like,
                                            jvars["batch_stats"])}
    back_vars, back_state = jax_ckpt.load_snapshot_orbax(
        ppath, template, tx.init(template["params"]))
    for a, b in zip(jax.tree.leaves((jvars, state)),
                    jax.tree.leaves((back_vars, back_state))):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.shape(a) == np.shape(b)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # port -> port, and both directories read to the same trees
    model2, opt2 = port_pair(name)
    p_vars, p_opt = ckpt.load_snapshot_orbax(ppath, model2, opt2)
    assert_same_tree(p_vars, j_vars)
    assert_same_tree(p_opt, j_opt)
    for (key, a), b in zip(model.state_dict().items(),
                           model2.state_dict().values()):
        assert torch.equal(a, b), key
    for p, q in zip(model.parameters(), model2.parameters()):
        assert torch.equal(opt.state[p]["momentum_buffer"],
                           opt2.state[q]["momentum_buffer"])
    assert opt2.count == opt.count


def test_orbax_snapshot_without_optimizer_replaces_directory(tiny_resnet,
                                                             work):
    model, _ = port_pair("float_lr")
    first = ckpt.save_snapshot_orbax(work, 0, "final--0", model, debug="_x")
    assert first.name == "snapshot-step0_x-final--0.orbax"
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    again = ckpt.save_snapshot_orbax(work, 0, "final--0", model, debug="_x")
    variables, opt_state = ckpt.load_snapshot_orbax(again)
    assert again == first and opt_state is None
    assert_same_tree(variables, ckpt.flax_from_state_dict(model.state_dict()))
    jax_vars, jax_opt = jax_ckpt.load_snapshot_orbax(again)
    assert jax_opt is None
    assert_same_tree(jax.tree.map(np.asarray, jax_vars), variables)


def test_orbax_needs_tensorstore(monkeypatch, work):
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    model = torch.nn.Linear(2, 2)
    with pytest.raises(ImportError, match="tensorstore"):
        ckpt.save_snapshot_orbax(work, 0, 1, model)
    with pytest.raises(ImportError, match="tensorstore"):
        ckpt.load_snapshot_orbax(work / "snapshot-step0-1.orbax")

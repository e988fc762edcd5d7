"""The port's snapshot writer, TF import and project files against the JAX
package's.

* Snapshots with their optimizer state cross-load both ways, for the three
  optimizer layouts the fit loops use (a float rate with the clip, the
  piecewise schedule of fit_dlc, the cosine decay of ``lr_decay``): a JAX
  snapshot loads into a port model and ``ClippedSGD``, the port writes
  the same bytes back, the JAX package loads the port's file onto its
  templates, and one more update from the restored state agrees.
* Pruning keeps ``max_to_keep`` snapshots and ``final--0`` sorts last; a
  fit interrupted mid-step resumes from its newest snapshot
  (tests/test_train.py:248-292 for the port).
* A TF checkpoint written by the JAX package imports into the port with
  the forward of the JAX package's import.
* ``ScalarEventWriter`` files, the training ``.mat``, the Documentation
  pickle and the synthetic project are the JAX package's, byte for byte
  or read back by the other package.
* ``cosine_decay_schedule`` is optax's; the demo twin's ``--test`` ends
  with the three final snapshots and a pose CSV.
"""

import json
import shutil
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from deepgraphpose_tpu.core import checkpoint as jax_ckpt
from deepgraphpose_tpu.core.config import PoseConfig as JaxPoseConfig
from deepgraphpose_tpu.data import project as jax_project
from deepgraphpose_tpu.models import resnet as jax_resnet
from deepgraphpose_tpu.models import tf_import as jax_tf_import
from deepgraphpose_tpu.models.pose_model import PoseModel as JaxPoseModel
from deepgraphpose_tpu.train import steps as jax_steps
from deepgraphpose_tpu.utils import events as jax_events
from deepgraphpose_tpu.utils.synthetic import \
    make_synthetic_project as jax_synthetic_project
from deepgraphpose_tpu_torch.core import checkpoint as ckpt
from deepgraphpose_tpu_torch.core import paths
from deepgraphpose_tpu_torch.core.config import PoseConfig
from deepgraphpose_tpu_torch.data import project
from deepgraphpose_tpu_torch.data.video import VideoReader
from deepgraphpose_tpu_torch.models import pretrained, tf_import
from deepgraphpose_tpu_torch.models import resnet as torch_resnet
from deepgraphpose_tpu_torch.models.pose_model import PoseModel
from deepgraphpose_tpu_torch.train import steps
from deepgraphpose_tpu_torch.utils import events
from deepgraphpose_tpu_torch.utils.synthetic import make_synthetic_project
from test_torch_train import random_variables

HW = (48, 64)
KW = dict(net_type="resnet_tiny", num_joints=3)


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two torch threads while this file runs: the suite runs six files at
    once, and each torch process would otherwise start a thread a core."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny_resnet(monkeypatch):
    monkeypatch.setitem(jax_resnet.BLOCK_UNITS, "resnet_tiny", (1, 1, 1, 1))
    monkeypatch.setitem(torch_resnet.BLOCK_UNITS, "resnet_tiny", (1, 1, 1, 1))
    return "resnet_tiny"


@pytest.fixture
def work(tmp_path):
    """A scratch directory, removed after the test (snapshots of this
    network are 32-65 MB)."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def trace_of(opt_state):
    found = [s for s in jax.tree.leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.TraceState))
        if isinstance(s, optax.TraceState)]
    return found[0].trace


OPTIMIZERS = {
    # name: (optax chain, port learning rate, clip)
    "float_lr": (lambda: jax_steps.make_optimizer(0.005, clip_norm=10.0),
                 lambda: 0.005, 10.0),
    "piecewise": (lambda: jax_steps.make_optimizer(jax_steps.piecewise_lr(
        [[0.005, 2], [0.02, 100]])), lambda: steps.piecewise_lr(
        [[0.005, 2], [0.02, 100]]), None),
    "cosine": (lambda: jax_steps.make_optimizer(optax.cosine_decay_schedule(
        0.005, decay_steps=4, alpha=0.05), clip_norm=10.0),
        lambda: steps.cosine_decay_schedule(0.005, 4, alpha=0.05), 10.0),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_snapshots_cross_load_with_optimizer_state(tiny_resnet, work, name):
    make_tx, port_lr, clip = OPTIMIZERS[name]
    jm = JaxPoseModel(JaxPoseConfig(**KW))
    variables = random_variables(jm, HW, seed=1)
    tx = make_tx()
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = tx.init(params)
    rng = np.random.default_rng(2)
    grads = [jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape).astype(np.float32) * s), params)
        for s in (0.05, 0.01, 0.02)]
    for g in grads[:2]:
        updates, state = tx.update(g, state, params)
        params = optax.apply_updates(params, updates)
    jvars = {"params": params, "batch_stats": variables["batch_stats"]}
    jpath = jax_ckpt.save_snapshot(work / "jax", 2, 1, jvars, state)

    # JAX -> port: weights, momentum buffers, update count
    model = PoseModel(PoseConfig(**KW))
    opt = steps.make_optimizer(model.parameters(), port_lr(), clip_norm=clip)
    ckpt.load_snapshot(jpath, model, opt)
    trace = ckpt.state_dict_from_flax(
        {"params": jax.tree.map(np.asarray, trace_of(state))})
    for key, p in model.named_parameters():
        assert torch.equal(opt.state[p]["momentum_buffer"], trace[key]), key
    assert opt.count == (2 if name != "float_lr" else 0)

    # port -> the same bytes, which the JAX package loads onto its templates
    ppath = ckpt.save_snapshot(work / "torch", 2, 1, model, opt)
    assert ppath.name == jpath.name == "snapshot-step2-1.ckpt"
    assert ppath.read_bytes() == jpath.read_bytes()
    template = {"params": jax.tree.map(jnp.zeros_like, params),
                "batch_stats": jax.tree.map(jnp.zeros_like,
                                            variables["batch_stats"])}
    back_vars, back_state = jax_ckpt.load_snapshot(
        ppath, template, tx.init(template["params"]))
    for a, b in zip(jax.tree.leaves((jvars, state)),
                    jax.tree.leaves((back_vars, back_state))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    restored = jax_ckpt.restore_backbone_and_heads(template, ppath)
    for a, b in zip(jax.tree.leaves(jvars), jax.tree.leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # one more update from the restored state agrees
    updates, state = tx.update(grads[2], state, params)
    params = optax.apply_updates(params, updates)
    g_port = ckpt.state_dict_from_flax(
        {"params": jax.tree.map(np.asarray, grads[2])})
    for key, p in model.named_parameters():
        p.grad = g_port[key].clone()
    opt.step()
    want = ckpt.state_dict_from_flax(
        {"params": jax.tree.map(np.asarray, params)})
    for key, p in model.named_parameters():
        err = (p.detach() - want[key]).abs().max().item()
        assert err <= 1e-6 * want[key].abs().max().item() + 1e-9, key


def test_msgpack_writer_chunks_large_leaves_as_flax(monkeypatch):
    from flax import serialization

    tree = {"b": {"x": np.arange(10, dtype=np.float32)},
            "a": np.ones((3, 2), np.int32), "c": {}}
    assert ckpt.msgpack_serialize(tree) == serialization.msgpack_serialize(
        tree)
    monkeypatch.setattr(ckpt, "MAX_CHUNK_BYTES", 12)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 12)
    assert ckpt.msgpack_serialize(tree) == serialization.msgpack_serialize(
        tree)


class TinyHead(nn.Module):
    """A model whose state is one deconvolution head (small snapshots)."""

    def __init__(self):
        super().__init__()
        self.part_pred = nn.Module()
        self.part_pred.block4 = nn.ConvTranspose2d(2, 2, 3)


def test_prune_keeps_max_to_keep_and_final_sorts_last(work):
    model = TinyHead()
    opt = steps.make_optimizer(model.parameters(), 0.1, clip_norm=1.0)
    for it in (1, 2, 3, 10, 7):
        ckpt.save_snapshot(work, 1, it, model, opt, max_to_keep=3)
    ckpt.save_snapshot(work, 1, "final--0", model)
    names = sorted(p.name for p in work.glob("snapshot-step1-*"))
    assert names == ["snapshot-step1-10.ckpt", "snapshot-step1-3.ckpt",
                     "snapshot-step1-7.ckpt",
                     "snapshot-step1-final--0.ckpt"]
    assert ckpt.snapshot_exists(work, 1) and not ckpt.snapshot_exists(work, 2)
    assert ckpt.latest_snapshot(work, 1).name == "snapshot-step1-final--0.ckpt"
    assert ckpt.latest_intermediate_snapshot(work, 1) == (
        work / "snapshot-step1-10.ckpt", 10)
    for step in (0, 2):
        ckpt.save_snapshot(work, step, 5, model)
    ckpt.save_snapshot(work, 0, "final--0", model)
    assert ckpt.latest_snapshot(work).name == "snapshot-step2-5.ckpt"
    # the JAX package reads the same order off the same directory
    assert jax_ckpt.latest_snapshot(work) == ckpt.latest_snapshot(work)
    for step in (0, 1, 2):
        assert (jax_ckpt.latest_snapshot(work, step)
                == ckpt.latest_snapshot(work, step))
        assert (jax_ckpt.latest_intermediate_snapshot(work, step)
                == ckpt.latest_intermediate_snapshot(work, step))


def tiny_project(root: Path) -> Path:
    proj, _, _ = make_synthetic_project(root, hw=HW)
    _, cfg, train_dir = paths.resolve_project(proj)
    cfg.net_type = "resnet_tiny"
    cfg.to_yaml(train_dir / "pose_cfg.yaml")
    return Path(proj)


def test_mid_step_resume(tiny_resnet, work):
    """Interrupted training resumes from the latest intermediate snapshot
    with its optimizer state (ref test: tests/test_train.py:248-292)."""
    from deepgraphpose_tpu_torch.train.fit import fit_dgp

    proj = tiny_project(work / "proj")
    train_dir = paths.resolve_project(proj)[2]
    kw = dict(dlcpath=proj, batch_size=2, maxiters=4, displayiters=1,
              saveiters=2, nepoch=1, n_max_frames=10, aug=False,
              device="cpu")
    fit_dgp(**kw)
    (train_dir / "snapshot-step2-final--0.ckpt").unlink()
    for f in train_dir.glob("snapshot-step2-*.ckpt"):
        m = f.stem.rsplit("-", 1)[-1]
        if m.isdigit() and int(m) > 2:
            f.unlink()
    snap, last_it = ckpt.latest_intermediate_snapshot(train_dir, 2)
    assert last_it == 2
    saved_trace = ckpt.load_snapshot(snap)[1]

    out = fit_dgp(**kw)
    assert out is not None and out.exists()
    lines = [json.loads(line) for line in
             (train_dir / "steps.jsonl").read_text().splitlines()]
    assert any(line["iteration"] > last_it for line in lines)
    # the resumed run started from the snapshot's optimizer state
    model = PoseModel(PoseConfig(**KW))
    opt = steps.make_optimizer(model.parameters(), 0.005, clip_norm=10.0)
    ckpt.load_snapshot(snap, model, opt)
    assert ckpt.msgpack_serialize(ckpt.opt_state_tree(opt, model)) == \
        ckpt.msgpack_serialize(saved_trace)


def test_tf_name_map_is_the_jax_packages(tiny_resnet):
    jm = JaxPoseModel(JaxPoseConfig(net_type="resnet_50", num_joints=3,
                                    intermediate_supervision=True))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 64, 64, 3))))
    n = 0
    for path, _ in jax_tf_import._iter_paths(shapes):
        want = jax_tf_import.tf_name_for_path(path, "resnet_50")
        got = tf_import.tf_name_for_path(path, "resnet_50")
        assert (got is None) == (want is None), path
        if got is not None:
            assert got[0] == want[0]
            n += 1
    assert n == 271      # every ResNet-50 weight, BN leaf and head


def test_tf_checkpoint_imports_like_jax(tiny_resnet, work):
    pytest.importorskip("tensorflow")
    from deepgraphpose_tpu_torch.train import fit

    jm = JaxPoseModel(JaxPoseConfig(**KW))
    variables = random_variables(jm, HW, seed=5)
    prefix = jax_tf_import.write_tf_checkpoint(
        variables, str(work / "snapshot-step0-final--0"), "resnet_tiny")
    fresh = random_variables(jm, HW, seed=6)
    want_vars, want_report = jax_tf_import.import_tf_checkpoint(
        fresh, prefix, net_type="resnet_tiny", scopes=("resnet", "pose"))
    model = PoseModel(PoseConfig(**KW))
    model.load_state_dict(ckpt.state_dict_from_flax(fresh))
    state, report = tf_import.import_tf_checkpoint(
        model.state_dict(), prefix, net_type="resnet_tiny",
        scopes=("resnet", "pose"))
    assert sorted(report["imported"]) == sorted(want_report["imported"])
    assert not report["missing"]
    model.load_state_dict(state)
    images = np.random.default_rng(7).integers(0, 256, (2, *HW, 3),
                                               dtype=np.uint8)
    want = jm.apply(jax.tree.map(jnp.asarray, want_vars), jnp.asarray(images))
    got = model(torch.from_numpy(images))
    for key in ("part_pred", "locref"):
        w = np.asarray(want[key])
        np.testing.assert_allclose(got[key].detach().numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
    # fit's warm start reads a TF1 snapshot prefix in the train directory
    warm = PoseModel(PoseConfig(**KW))
    _, warmed = fit._warm_start(warm, PoseConfig(**KW), work,
                                "snapshot-step0-final--0")
    assert warmed
    for key, value in warm.state_dict().items():
        assert torch.equal(value, state[key]), key


def test_scalar_event_files_are_byte_equal(work, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    files = []
    for mod, sub in ((jax_events, "jax"), (events, "torch")):
        with mod.ScalarEventWriter(work / sub) as w:
            w.add_scalars(0, {"loss/total": 3.5, "loss/visible": 1.25})
            w.add_scalar("loss/total", 2.5, step=10)
            w.add_scalars(2 ** 40, {"loss/ws_loss": -1e-3})
            files.append(w.path)
    assert files[0].read_bytes() == files[1].read_bytes()
    assert files[0].name.split(".")[3] == files[1].name.split(".")[3]


def test_training_set_files_cross_read(work):
    image_paths = ["labeled-data/v/img001.png", "labeled-data/v/img017.png"]
    sizes = np.array([[3, 48, 64], [3, 48, 64]])
    joints = [np.array([[0, 10.5, 20.0], [2, 30.0, 5.25]]),
              np.array([[1, 1.0, 2.0]])]
    for writer, reader in ((jax_project, project), (project, jax_project)):
        mat = work / f"{writer.__name__}.mat"
        doc = work / f"{writer.__name__}.pickle"
        writer.write_training_mat(mat, image_paths, sizes, joints)
        writer.write_documentation_pickle(doc, [{"a": 1}], [1, 0], [], 0.9)
        ts = reader.read_training_set(mat, doc)
        assert ts.image_paths == image_paths
        np.testing.assert_array_equal(ts.sizes, sizes)
        for got, want in zip(ts.joints, joints):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(ts.train_indices, [1, 0])
        assert ts.test_indices.size == 0 and ts.train_fraction == 0.9
        np.testing.assert_array_equal(
            ts.coords_for(3),
            jax_project.read_training_set(mat, doc).coords_for(3))
    # no Documentation pickle: every item trains
    ts = project.read_training_set(work / "deepgraphpose_tpu.data.project.mat")
    np.testing.assert_array_equal(ts.train_indices, [0, 1])


def test_tolerant_unpickler_stubs_missing_classes(work, monkeypatch):
    """A Documentation pickle naming a class this host cannot import (the
    reference's ruamel.yaml scalars) reads in both packages."""
    import pickle
    import sys
    import types

    mod = types.ModuleType("absent_yaml_scalars")

    class ScalarFloat(dict):
        pass

    ScalarFloat.__module__ = mod.__name__
    ScalarFloat.__qualname__ = "ScalarFloat"
    mod.ScalarFloat = ScalarFloat
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    path = work / "doc.pickle"
    path.write_bytes(pickle.dumps([[ScalarFloat(x=1.5)], [1, 2], [3], 0.8]))
    monkeypatch.delitem(sys.modules, mod.__name__)
    got = project.read_documentation_pickle(path)
    want = jax_project.read_documentation_pickle(path)
    assert got[0][0] == want[0][0] == {"x": 1.5}
    assert type(got[0][0]).__name__ == "ScalarFloat"
    np.testing.assert_array_equal(got[1], want[1])
    assert got[3] == want[3] == 0.8


def test_cosine_decay_schedule_matches_optax():
    want = optax.cosine_decay_schedule(0.005, decay_steps=13, alpha=0.05)
    got = steps.cosine_decay_schedule(0.005, 13, alpha=0.05)
    for count in range(20):
        assert got(count) == pytest.approx(float(want(count)), rel=1e-6)
    with pytest.raises(ValueError):
        steps.cosine_decay_schedule(0.005, 0)


def test_synthetic_project_files_are_the_jax_packages(work):
    jax_synthetic_project(work / "jax", n_frames=12, n_labeled=3, hw=HW)
    make_synthetic_project(work / "torch", n_frames=12, n_labeled=3, hw=HW)
    want = sorted(p.relative_to(work / "jax")
                  for p in (work / "jax").rglob("*") if p.is_file())
    got = sorted(p.relative_to(work / "torch")
                 for p in (work / "torch").rglob("*") if p.is_file())
    assert got == want and len(want) >= 8
    for rel in want:
        a, b = (work / "jax" / rel).read_bytes(), (work / "torch" / rel
                                                   ).read_bytes()
        if rel.name == "config.yaml":       # holds its own project_path
            a = a.replace(str(work / "jax").encode(), b"ROOT")
            b = b.replace(str(work / "torch").encode(), b"ROOT")
        if rel.name == "pose_cfg.yaml":
            a = a.replace(str(work / "jax").encode(), b"ROOT")
            b = b.replace(str(work / "torch").encode(), b"ROOT")
        assert a == b, rel


def test_pretrained_lookup_is_local(work, monkeypatch, capsys):
    monkeypatch.setenv("DGP_PRETRAINED_DIR", str(work))
    assert pretrained.find_pretrained("resnet_50") is None
    prefix, n = pretrained.check_for_weights("resnet_50")
    assert n == 1 and prefix.endswith("resnet_v1_50.ckpt")
    assert "no local resnet_50 ImageNet checkpoint" in capsys.readouterr().out
    (work / "resnet_v1_50.ckpt.index").write_bytes(b"")
    assert pretrained.find_pretrained("resnet_50") == work / "resnet_v1_50.ckpt"
    assert pretrained.check_for_weights("resnet_50") == (
        str(work / "resnet_v1_50.ckpt"), 1)
    assert pretrained.check_for_weights("vgg", num_shuffles=3)[1] == -1
    with pytest.raises(RuntimeError, match="no network egress"):
        pretrained.download_weights("resnet_50", work / "resnet_v1_50.ckpt")


def test_demo_test_mode_ends_with_three_finals_and_a_pose_csv(tiny_resnet,
                                                              work):
    from deepgraphpose_tpu_torch import demo

    proj = tiny_project(work / "proj")
    assert demo.main(["--dlcpath", str(proj), "--test", "--batch_size", "3",
                      "--device", "cpu"]) == 0
    train_dir = paths.resolve_project(proj)[2]
    for step in (0, 1, 2):
        assert (train_dir / f"snapshot-step{step}-final--0.ckpt").exists()
    csv = proj / "videos_pred" / "synthvid.csv"
    rows = csv.read_text().splitlines()
    assert rows[0].startswith("scorer,") and len(rows) == 3 + 40
    values = np.array([r.split(",")[1:] for r in rows[3:]], np.float64)
    assert np.isfinite(values).all()
    # step 3 is plot_dgp: the labeled video beside the CSV
    reader = VideoReader(proj / "videos_pred" / "synthvid_labeled.mp4")
    assert reader.n_frames == 40
    reader.close()

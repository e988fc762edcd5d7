"""The port's head-only training (``train/headonly.py``) and the features
tap (``PoseModel(heads=("features", ...))``) against the JAX package's,
on the CPU.

* The features tap: the heads module applied to the tapped features
  equals the full model's heads exactly (the same ops on the same
  tensors, ``tests/test_headonly.py:35-54``), and the features are the
  JAX package's ``return_features`` within 1e-4 of their largest value
  (float32 convolutions summed in another order).
* ``fit_dlc_heads`` from one step-0 snapshot that JAX's ``fit_dlc`` wrote
  (mobilenet_v2_0.35 at 48x64, 60 updates at lr 0.005, as
  tests/test_headonly.py runs it): the backbone stays bit-identical, the
  heads move, the loss falls, the displayed losses follow JAX's within
  1e-4 relative (the same index draws from ``default_rng(seed)``; the
  features differ from JAX's by float32 rounding, and 60 SGD updates of
  the convex head problem keep that small), the trained heads are JAX's
  within 1e-4 of each tensor's largest value, and the snapshot written
  loads in the JAX package and predicts there.
"""

import re
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from deepgraphpose_tpu.core import checkpoint as jax_ckpt
from deepgraphpose_tpu.models.pose_model import init_model as jax_init_model
from deepgraphpose_tpu.train import headonly as jax_headonly
from deepgraphpose_tpu.train.fit import fit_dlc as jax_fit_dlc
from deepgraphpose_tpu.train.fit import resolve_project as jax_resolve
from deepgraphpose_tpu.utils.synthetic import make_synthetic_project
from deepgraphpose_tpu_torch.core import checkpoint as ckpt
from deepgraphpose_tpu_torch.core.config import PoseConfig
from deepgraphpose_tpu_torch.models.pose_model import PoseModel
from deepgraphpose_tpu_torch.train import headonly

LOSS_RTOL = 1e-4
PARAM_TOL = 1e-4
FEATURE_TOL = 1e-4
LOSS_LINE = r"\[fit_dlc_heads\] iter (\d+)/\d+ loss ([\d.]+)"


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two torch threads while this file runs (the suite runs six files at
    once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def port_model(cfg, variables) -> PoseModel:
    model = PoseModel(cfg)
    model.load_state_dict(ckpt.state_dict_from_flax(variables))
    return model.to(memory_format=torch.channels_last).eval()


def test_features_tap_matches_heads_module():
    cfg = PoseConfig(num_joints=3, net_type="mobilenet_v2_0.35")
    model, variables = jax_init_model(cfg, jax.random.PRNGKey(0), (32, 32))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    imgs = np.random.default_rng(0).integers(0, 255, (2, 32, 32, 3),
                                             dtype=np.uint8)
    port = port_model(cfg, variables)
    with torch.no_grad():
        full = port(torch.from_numpy(imgs),
                    heads=("features", "part_pred", "locref"))
        heads = headonly.HeadsModule(cfg, full["features"].shape[-1])
        heads.load_state_dict(headonly.head_state(port))
        got = heads(full["features"])
    assert set(got) == {"part_pred", "locref"}
    for key in got:
        assert torch.equal(got[key], full[key]), key
    want = model.apply(variables, jnp.asarray(imgs),
                       return_features=True)["features"]
    want = np.asarray(want)
    assert full["features"].shape == want.shape
    err = np.abs(full["features"].numpy() - want).max()
    assert err <= FEATURE_TOL * np.abs(want).max(), err


def test_features_tap_is_an_extra_output():
    cfg = PoseConfig(num_joints=3, net_type="mobilenet_v2_0.35")
    model = PoseModel(cfg).eval()
    with torch.no_grad():
        out = model(torch.zeros(1, 32, 32, 3), heads=("features",))
    assert list(out) == ["features"] and out["features"].shape == (
        1, 2, 2, 1280)
    with pytest.raises(ValueError, match="unknown heads"):
        model(torch.zeros(1, 32, 32, 3), heads=("nosuch",))


@pytest.fixture(scope="module")
def jax_step0(tmp_path_factory):
    """tests/test_headonly.py's project: synthetic, 12 frames of 48x64, 4
    labeled, mobilenet_v2_0.35, multi_step 0.002; JAX's fit_dlc step-0
    final snapshot in it."""
    root = tmp_path_factory.mktemp("headonly") / "proj"
    make_synthetic_project(str(root), n_frames=12, n_labeled=4, hw=(48, 64))
    cfg_path = Path(root, "dlc-models/iteration-0/"
                    "SynthJan1-trainset95shuffle1", "train", "pose_cfg.yaml")
    raw = yaml.safe_load(cfg_path.read_text())
    raw["net_type"] = "mobilenet_v2_0.35"
    raw["multi_step"] = [[0.002, 100000]]
    cfg_path.write_text(yaml.safe_dump(raw))
    jax_fit_dlc(dlcpath=str(root), maxiters=2, displayiters=1, saveiters=100,
                bn_train=False, jitter=False)
    return root


def losses(out: str) -> list:
    return [(int(i), float(v)) for i, v in re.findall(LOSS_LINE, out)]


def leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def test_fit_dlc_heads_matches_jax(jax_step0, tmp_path, capsys):
    roots = {}
    for pkg in ("jax", "port"):
        roots[pkg] = tmp_path / pkg
        shutil.copytree(jax_step0, roots[pkg])
    kw = dict(maxiters=60, displayiters=10, lr=0.005, debug="_heads")
    capsys.readouterr()
    jax_snap = jax_headonly.fit_dlc_heads(dlcpath=str(roots["jax"]), **kw)
    jax_out = capsys.readouterr().out
    snap = headonly.fit_dlc_heads(dlcpath=roots["port"], device="cpu", **kw)
    out = capsys.readouterr().out
    assert "training heads only" in out
    assert snap.exists() and snap.name == jax_snap.name == (
        "snapshot-step0_heads-final--0.ckpt")

    got, want = losses(out), losses(jax_out)
    assert [i for i, _ in got] == [i for i, _ in want] == list(range(0, 60,
                                                                     10))
    print("losses port", got, "jax", want)
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=LOSS_RTOL)
    assert got[-1][1] < got[0][1]

    _, _, train_dir = jax_resolve(str(roots["port"]), 1)
    before, _ = jax_ckpt.load_snapshot(
        Path(train_dir) / "snapshot-step0-final--0.ckpt", None, None)
    # the port's snapshot, read by the JAX package
    after, _ = jax_ckpt.load_snapshot(snap, None, None)
    jax_after, _ = jax_ckpt.load_snapshot(jax_snap, None, None)
    for coll in ("params", "batch_stats"):
        for (path, a), (path_b, b) in zip(leaves(after[coll]),
                                          leaves(before[coll]), strict=True):
            assert path == path_b
            if path[0] not in headonly.HEAD_KEYS:
                np.testing.assert_array_equal(a, b)   # backbone untouched
    moved = [not np.array_equal(a, b) for (p, a), (_, b) in zip(
        leaves(after["params"]), leaves(before["params"]))
        if p[0] in headonly.HEAD_KEYS]
    assert moved and all(moved)
    for (path, a), (_, b) in zip(leaves(after["params"]),
                                 leaves(jax_after["params"]), strict=True):
        if path[0] in headonly.HEAD_KEYS:
            err = np.abs(a - b).max()
            assert err <= PARAM_TOL * np.abs(b).max(), (path, err)

    # the JAX package predicts with the port's snapshot
    _, cfg, _ = jax_resolve(str(roots["port"]), 1)
    model, _ = jax_init_model(cfg, jax.random.PRNGKey(0), (48, 64))
    heads = model.apply(after, jnp.zeros((1, 48, 64, 3)))
    assert np.isfinite(np.asarray(heads["part_pred"])).all()


def test_fit_dlc_heads_reinit_and_saves(jax_step0, tmp_path):
    """``reinit_heads`` starts from fresh heads (the loss starts elsewhere)
    and ``saveiters`` writes the intermediate snapshots as the JAX package
    names them."""
    root = tmp_path / "p"
    shutil.copytree(jax_step0, root)
    snap = headonly.fit_dlc_heads(dlcpath=root, maxiters=5, displayiters=0,
                                  saveiters=2, lr=0.005, reinit_heads=True,
                                  device="cpu")
    names = sorted(p.name for p in snap.parent.glob("snapshot-step0_heads*"))
    assert names == ["snapshot-step0_heads-2.ckpt",
                     "snapshot-step0_heads-4.ckpt",
                     "snapshot-step0_heads-final--0.ckpt"]
    variables, _ = ckpt.load_snapshot(snap)
    base, _ = ckpt.load_snapshot(snap.parent / "snapshot-step0-final--0.ckpt")
    for key in headonly.HEAD_KEYS:
        a = variables["params"][key]["block4"]["kernel"]
        b = base["params"][key]["block4"]["kernel"]
        assert not np.allclose(a, b, atol=1e-3)

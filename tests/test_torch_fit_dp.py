"""Data parallelism and the multi-window group steps through the port's
fit API (``train/fit.py`` ``data_parallel=`` / ``windows_per_device=`` ->
``parallel/train_dp.py``, ``train/device_data.py``), against the JAX
package on the CPU, and over two ranks.

* The helpers (``_group_schedule_dp``, ``iter_group_scan_runs``,
  ``resolve_scan_iters``) equal the JAX package's; ``data_parallel``
  larger than the process group raises.
* The group step (G windows, world 1) against the JAX package's DP
  pooled step on the suite's virtual CPU devices. With trainable
  batch-norm each window is normalized by its own statistics and the
  moving stats are the mean of the windows' updates; that case runs in
  float64 on both sides (a float32 trainable-BN step of a random network
  is chaotic, ROADMAP queue 3). Bounds: loss 1e-5 relative, parameters
  and buffers ``rtol=1e-4, atol=1e-5`` (``tests/test_fit_dp.py:237-243``).
* in one process, where the reference warns and trains one window an
  update (the host feed, rotating segments), so does the port;
* G identical windows with trainable batch-norm and the device flow
  reproduce the single-window pooled step; aug with the device flow
  raises; the step-0 DP step equals the single-device step on the global
  batch and the JAX package's DP step.
* fit_dgp(windows_per_device=2) against the JAX package's, augmentation
  off (the two packages draw augmentation from different generators),
  from one JAX-written warm start: every logged loss within 1e-4
  relative, the final parameters ``rtol=1e-4, atol=1e-5``; with
  ``scan_iters=3`` (the composed group superstep) the port's run equals
  its eager twin within 1e-6 of each tensor's largest value.
* One two-rank gloo test over CPU processes (a free port, a
  ``communicate`` timeout): the DGP DP step (per-window trainable BN,
  device flow, float64) and the step-0 DP step (global-batch BN, the
  global batch's augmentation, float64) over 2 ranks x 1 window against
  the world-1 group on the whole batch (loss 1e-5 relative, parameters
  and buffers 1e-5 of each tensor's largest value); fit_dgp
  (data_parallel=2, augmentation on) against fit_dgp(windows_per_device=2)
  from the same seed (the port's own layout invariance, ``rtol=1e-4,
  atol=1e-5``); fit_dgp over a patched pool budget (rotating segments)
  and fit_dlc without the labeled pool raise ``ValueError`` on both ranks
  and write nothing; and estimate_pose_multichip over 2 ranks against world 1
  (each rank decoding only its span of the video; displacement and
  smoothed track within 1e-6, relative and absolute:
  each process sums its convolutions on its own thread count, so mu may
  part by a float32 rounding).

The reference's own layout test
(``tests/test_fit_dp.py::test_fit_dgp_windows_per_device_layout_invariant``)
fails since the seed (ROADMAP queue 3); it is not ported.
"""

import os
import shutil
import socket
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepgraphpose_tpu.core import checkpoint as jax_ckpt
from deepgraphpose_tpu.core.config import PoseConfig as JaxPoseConfig
from deepgraphpose_tpu.models.pose_model import PoseModel as JaxPoseModel
from deepgraphpose_tpu.parallel import mesh as jax_mesh
from deepgraphpose_tpu.parallel import train_dp as jax_train_dp
from deepgraphpose_tpu.train import device_data as jax_dd
from deepgraphpose_tpu.train import fit as jax_fit
from deepgraphpose_tpu.train import steps as jax_steps
from deepgraphpose_tpu.utils.synthetic import make_synthetic_project
from deepgraphpose_tpu_torch.core import checkpoint as ckpt
from deepgraphpose_tpu_torch.core import paths
from deepgraphpose_tpu_torch.core.config import PoseConfig
from deepgraphpose_tpu_torch.ops.dgp_objective import DGPLossParams
from deepgraphpose_tpu_torch.parallel import mesh, train_dp
from deepgraphpose_tpu_torch.train import device_data as dd
from deepgraphpose_tpu_torch.train import fit, steps
from test_torch_mobilenet import random_variables
from test_torch_parallel import (HW, LR, NET, NJ, T, jax_dp_step,
                                 loss_params, port_model, port_state,
                                 windows)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs the virtual multi-device CPU mesh")

REPO = Path(__file__).resolve().parent.parent
WARM = "snapshot-step9-warm"
LOSS_REL, PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-4, 1e-5
FIT_LOSS_REL = 1e-4
SAME_PROCESS_REL = 1e-5    # two ranks against world 1, of each largest
STREAM_TOL = 1e-6         # relative and absolute: float32 mu, one rounding apart


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two torch threads while this file runs, as tests/test_torch_fit.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dp_project(tmp_path_factory):
    """The reference's DP project (30 frames, 4 labeled, 48x64,
    mobilenet_v2_0.35) with a JAX-written warm start WARM."""
    root = tmp_path_factory.mktemp("dpproj") / "p"
    make_synthetic_project(root, n_frames=30, n_labeled=4, hw=(48, 64))
    _, cfg, train_dir = paths.resolve_project(root)
    cfg.net_type = NET
    cfg.multi_step = [[0.002, 100000]]
    cfg.to_yaml(train_dir / "pose_cfg.yaml")
    jm = JaxPoseModel(JaxPoseConfig(net_type=NET, num_joints=3))
    jax_ckpt.save_snapshot(train_dir, 9, "warm",
                           random_variables(jm, (48, 64), seed=3))
    yield root
    shutil.rmtree(root.parent, ignore_errors=True)


def project_copy(base: Path, dest: Path) -> Path:
    shutil.copytree(base, dest)
    return dest


def train_dir(root: Path) -> Path:
    return paths.resolve_project(root)[2]


def final_state(root: Path, step: int = 2, debug: str = "") -> dict:
    path = train_dir(root) / f"snapshot-step{step}{debug}-final--0.ckpt"
    return ckpt.state_dict_from_flax(ckpt.load_snapshot(path)[0])


def logged_losses(root: Path) -> list:
    rows = (train_dir(root) / "learning_stats.csv").read_text().split()[1:]
    return [[int(r.split(",")[0]), float(r.split(",")[1])] for r in rows]


def assert_allclose_states(got: dict, want: dict, rtol: float, atol: float):
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key].double().numpy(),
                                   value.double().numpy(), rtol=rtol,
                                   atol=atol, err_msg=key)


def assert_within_largest(got: dict, want: dict, rel: float):
    assert set(got) == set(want)
    for key, value in want.items():
        scale = value.abs().max().item()
        assert (got[key] - value).abs().max().item() <= rel * scale, key


def test_group_schedule_dp_covers_and_pads():
    schedule = ([(0, np.array([i, i + 1])) for i in range(5)]
                + [(1, np.array([i])) for i in range(3)])
    groups = fit._group_schedule_dp(schedule, 4, np.random.default_rng(0))
    want = jax_fit._group_schedule_dp(schedule, 4, np.random.default_rng(0))
    assert all(len(grp) == 4 for _, grp in groups)
    # 5 windows of video 0 -> 2 groups; 3 of video 1 -> 1 group
    assert sorted(ds for ds, _ in groups) == [0, 0, 1]
    seen0 = {tuple(w) for ds, grp in groups if ds == 0 for w in grp}
    assert seen0 == {tuple(w) for ds, w in schedule if ds == 0}
    assert [(ds, [w.tolist() for w in grp]) for ds, grp in groups] == \
        [(ds, [w.tolist() for w in grp]) for ds, grp in want]


def test_scan_helpers_match_jax():
    for args in [(None, True, 0), (0, True, 0), (1, True, 0), (5, True, 0),
                 (5, False, 0), (5, True, 1), (5, True, 2)]:
        want = jax_dd.resolve_scan_iters(*args)
        assert dd.resolve_scan_iters(*args) == (0 if args[0] is None
                                                else want), args
    rng = np.random.default_rng(4)
    group_ds = rng.integers(0, 2, 23).tolist()
    for save_every, stride, k in [(None, 2, 4), (5, 2, 4), (3, 3, 5),
                                  (7, 4, 2)]:
        for start in (0, 3):
            assert list(dd.iter_group_scan_runs(
                group_ds, start, save_every, stride, k)) == list(
                jax_dd.iter_group_scan_runs(group_ds, start, save_every,
                                            stride, k))


def test_data_parallel_beyond_the_world_raises(dp_project, tmp_path):
    assert fit._resolve_data_parallel(False) == 0
    assert fit._resolve_data_parallel(True) == 0     # a world of 1
    assert fit._resolve_data_parallel(1) == 0
    with pytest.raises(ValueError, match="exceeds the 1 ranks"):
        fit._resolve_data_parallel(2)
    root = project_copy(dp_project, tmp_path / "p")
    with pytest.raises(ValueError, match="exceeds"):
        fit.fit_dgp(snapshot=WARM, dlcpath=root, batch_size=3, maxiters=2,
                    nepoch=1, data_parallel=4, device="cpu")


@pytest.mark.parametrize("feed", ["host", "spill"])
def test_group_updates_fall_back_as_the_reference(dp_project, tmp_path,
                                                  monkeypatch, capsys, feed):
    """windows_per_device needs the resident frame pools: on the host feed
    and over rotating segments fit_dgp warns and trains one window an
    update, as the JAX package does (``deepgraphpose_tpu/train/fit.py:
    856-866``)."""
    root = project_copy(dp_project, tmp_path / "p")
    kw = dict(device_data=False)
    if feed == "spill":
        monkeypatch.setattr(dd, "DEFAULT_POOL_BUDGET_BYTES", 200_000)
        kw = {}
    fit.fit_dgp(snapshot=WARM, dlcpath=root, batch_size=3, maxiters=3,
                displayiters=1, nepoch=1, windows_per_device=2,
                device="cpu", **kw)
    out = capsys.readouterr().out
    want = ("does not support segment-rotating pools" if feed == "spill"
            else "requires the device-data frame pools")
    assert want in out and "training single-device" in out
    assert "windows/update" not in out
    assert [it for it, _ in logged_losses(root)] == [0, 1, 2]


def test_dp_pooled_step_bn_train_device_flow_matches_single():
    """G identical windows through the group step (trainable BN, device
    flow, float64) reproduce the single-window pooled step: same
    parameters, same moving stats (the mean of G equal updates)."""
    jm = JaxPoseModel(JaxPoseConfig(net_type=NET, num_joints=NJ))
    variables = random_variables(jm, HW, seed=5, stem_scale=1.0)
    pool, rows, batch = windows(seed=3, g=1, wt=0.5)
    params = DGPLossParams(**loss_params(0.5))
    results = []
    for g in (1, 4):
        model = port_model(variables, torch.float64)
        opt = steps.make_optimizer(model.parameters(), LR, clip_norm=10.0)
        tb = {k: torch.from_numpy(np.repeat(v, g, 0)).double()
              for k, v in batch.items()}
        if g == 1:
            step = dd.make_pooled_dgp_train_step(
                model, params, opt, None, bn_train=True, device_flow=True)
            out = step(torch.from_numpy(pool), torch.from_numpy(rows[0]),
                       {k: v[0] for k, v in tb.items()}, None)
        else:
            step = train_dp.make_dp_pooled_dgp_train_step(
                model, params, opt, mesh.make_mesh(1, "cpu"), None,
                bn_train=True, device_flow=True)
            out = step(torch.from_numpy(pool),
                       torch.from_numpy(np.repeat(rows, g, 0)), tb,
                       [None] * g)
        results.append((out["total_loss"].item(), port_state(model)))
    assert results[1][0] == pytest.approx(results[0][0], rel=LOSS_REL)
    assert_allclose_states(results[1][1], results[0][1], PARAM_RTOL,
                           PARAM_ATOL)
    init = port_state(port_model(variables, torch.float64))
    assert any(not torch.equal(results[0][1][k], init[k])
               for k in init if k.endswith(".mean"))


def test_group_step_with_trainable_batch_norm_matches_jax():
    """Trap of the vmap: two distinct windows, each normalized by its own
    statistics; the moving stats are the mean of each window's update.
    float64 on both sides (JAX under ``jax.enable_x64``)."""
    jm = JaxPoseModel(JaxPoseConfig(net_type=NET, num_joints=NJ))
    variables = random_variables(jm, HW, seed=5, stem_scale=1.0)
    pool, rows, batch = windows(seed=4, g=2, wt=0.5)
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(3), 2))
    with jax.enable_x64(True):
        want_vars, want = jax_dp_step(variables, "pooled", pool, rows,
                                      batch, keys, dtype=jnp.float64,
                                      bn_train=True, wt=0.5)
    from test_torch_parallel import port_dp_step

    got_state, got = port_dp_step(variables, "pooled", pool, rows, batch,
                                  dtype=torch.float64, bn_train=True, wt=0.5)
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=LOSS_REL), key
    want_state = ckpt.state_dict_from_flax(jax.tree.map(np.asarray,
                                                        want_vars))
    assert_allclose_states(got_state, want_state, PARAM_RTOL, PARAM_ATOL)


def window_by_window_heads(model, images, n, bn_train):
    """The group update's heads as n trunk calls of one window each, every
    call from the same moving stats, which then become the mean of the
    windows' updated stats (the JAX package's vmap, written out)."""
    t = images.shape[0] // n
    stats = dd.bn_buffers(model) if bn_train else []
    with torch.no_grad():
        before = [b.clone() for b in stats]
        total = [torch.zeros_like(b) for b in stats]
    out = []
    for g in range(n):
        out.append(model(images[g * t:(g + 1) * t], train=bn_train))
        with torch.no_grad():
            for b, v, acc in zip(stats, before, total):
                acc.add_(b)
                b.copy_(v)
    with torch.no_grad():
        for b, acc in zip(stats, total):
            b.copy_(acc / n)
    return out


def test_window_by_window_trunk_matches_one_call(monkeypatch):
    """The group update runs its windows through the trunk in one call,
    each normalized by its own statistics (``BatchStats(windows=G)``); in
    float64 it gives the update of one trunk call a window: loss terms and
    parameters within 1e-9 of each tensor's largest value, and the moving
    stats (the mean of each window's update; float32 buffers, as in the
    flax module) within two float32 roundings, 2.4e-7."""
    from test_torch_parallel import port_dp_step

    jm = JaxPoseModel(JaxPoseConfig(net_type=NET, num_joints=NJ))
    variables = random_variables(jm, HW, seed=5, stem_scale=1.0)
    pool, rows, batch = windows(seed=8, g=2, wt=0.5)
    args = (variables, "pooled", pool, rows, batch)
    kw = dict(dtype=torch.float64, bn_train=True, wt=0.5)
    one_state, one = port_dp_step(*args, **kw)
    monkeypatch.setattr(dd, "window_heads", window_by_window_heads)
    each_state, each = port_dp_step(*args, **kw)
    for key, value in one.items():
        assert each[key] == pytest.approx(value, rel=1e-9), key
    stats = {k for k in one_state if k.endswith((".mean", ".var"))}
    assert_within_largest({k: v for k, v in each_state.items()
                           if k not in stats},
                          {k: v for k, v in one_state.items()
                           if k not in stats}, 1e-9)
    assert_within_largest({k: each_state[k] for k in stats},
                          {k: one_state[k] for k in stats}, 2.4e-7)
    init = port_state(port_model(variables, torch.float64))
    assert all(not torch.equal(one_state[k], init[k])
               for k in init if k.endswith(".var"))


def test_dp_pooled_step_rejects_aug_with_device_flow():
    from deepgraphpose_tpu_torch.ops.augment_device import \
        DeviceAugmentConfig

    model = port_model(random_variables(
        JaxPoseModel(JaxPoseConfig(net_type=NET, num_joints=NJ)), HW))
    opt = steps.make_optimizer(model.parameters(), LR)
    with pytest.raises(ValueError, match="aug_cfg must be None"):
        train_dp.make_dp_pooled_dgp_train_step(
            model, DGPLossParams(**loss_params()), opt,
            mesh.make_mesh(1, "cpu"), DeviceAugmentConfig.reference(),
            device_flow=True)


def dlc_inputs(seed: int = 0, n: int = 10, gbs: int = 8):
    rng = np.random.default_rng(seed)
    return dict(
        images=rng.integers(0, 255, (n, *HW, 3), dtype=np.uint8),
        coords=rng.uniform(0, 31, (n, NJ, 2)).astype(np.float32),
        present=np.ones((n, NJ), np.float32),
        content_wh=np.tile(np.array([32.0, 32.0], np.float32), (n, 1)),
        idxs=rng.integers(0, n, (gbs,)).astype(np.int64))


def port_dlc_step(variables, inputs, group, dtype=torch.float32,
                  bn_train=False, aug_cfg=None, seed=11):
    """The port's step-0 step on ``inputs`` (DP when ``group`` is given);
    returns (state dict, loss terms)."""
    model = port_model(variables, dtype)
    opt = steps.make_optimizer(model.parameters(), LR)
    cfg = PoseConfig(net_type=NET, num_joints=NJ, pos_dist_thresh=9)
    pool = types.SimpleNamespace(**{k: torch.from_numpy(inputs[k]) for k in
                                    ("images", "coords", "present",
                                     "content_wh")})
    if group is None:
        step = dd.make_pooled_dlc_train_step(model, cfg, opt, aug_cfg,
                                             bn_train=bn_train)
    else:
        step = train_dp.make_dp_pooled_dlc_train_step(
            model, cfg, opt, group, aug_cfg, bn_train=bn_train)
    out = step(pool, torch.from_numpy(inputs["idxs"]),
               torch.Generator().manual_seed(seed))
    return port_state(model), {k: v.item() for k, v in out.items()}


def test_dp_pooled_dlc_step_matches_single_and_jax():
    """The step-0 DP step over a global batch of 8 (world 1) equals the
    single-device pooled step on it, and the JAX package's DP step with
    the batch sharded over 4 devices."""
    jm = JaxPoseModel(JaxPoseConfig(net_type=NET, num_joints=NJ))
    variables = random_variables(jm, HW, seed=5)
    inputs = dlc_inputs()
    single_state, single = port_dlc_step(variables, inputs, None)
    dp_state, dp = port_dlc_step(variables, inputs, mesh.make_mesh(1, "cpu"))
    assert dp == single
    assert_within_largest(dp_state, single_state, 0.0)

    jcfg = JaxPoseConfig(net_type=NET, num_joints=NJ, pos_dist_thresh=9)
    tx = jax_steps.make_optimizer(LR)
    m = jax_mesh.make_mesh(4)
    step = jax_train_dp.make_dp_pooled_dlc_train_step(jm, jcfg, tx, m, None)
    with m:
        v2, _, out = step(
            jax_mesh.replicate(variables, m),
            jax_mesh.replicate(tx.init(variables["params"]), m),
            *(jax_mesh.replicate(inputs[k], m) for k in
              ("images", "coords", "present", "content_wh")),
            jax_mesh.shard_leading_axis(inputs["idxs"].astype(np.int32), m),
            jax_mesh.replicate(np.asarray(jax.random.PRNGKey(11)), m), 0)
    for key, value in out.items():
        assert dp[key] == pytest.approx(float(value), rel=LOSS_REL), key
    assert_allclose_states(dp_state, ckpt.state_dict_from_flax(
        jax.tree.map(np.asarray, v2)), PARAM_RTOL, PARAM_ATOL)


GROUP_FIT = dict(snapshot=WARM, batch_size=3, maxiters=8, displayiters=1,
                 saveiters=100, ns=2, n_max_frames=20, nepoch=1, aug=False,
                 windows_per_device=2)


def test_fit_dgp_windows_per_device_matches_jax(dp_project, tmp_path,
                                                capsys):
    roots = {name: project_copy(dp_project, tmp_path / name)
             for name in ("jax", "port", "scan")}
    jax_fit.fit_dgp(dlcpath=roots["jax"], **GROUP_FIT)
    fit.fit_dgp(dlcpath=roots["port"], device="cpu", **GROUP_FIT)
    assert "data-parallel x1 devices x 2 windows = 2 windows/update" in \
        capsys.readouterr().out
    fit.fit_dgp(dlcpath=roots["scan"], device="cpu", scan_iters=3,
                **GROUP_FIT)
    assert "scan superstep K=3" in capsys.readouterr().out
    got, want = logged_losses(roots["port"]), logged_losses(roots["jax"])
    assert [it for it, _ in got] == [it for it, _ in want] == [0, 2, 4]
    for (it, g), (_, w) in zip(got, want):
        assert g == pytest.approx(w, rel=FIT_LOSS_REL), it
    port = final_state(roots["port"])
    assert_allclose_states(port, final_state(roots["jax"]), PARAM_RTOL,
                           PARAM_ATOL)
    assert_within_largest(final_state(roots["scan"]), port, 1e-6)
    assert logged_losses(roots["scan"]) == got


WORKER = r"""
import sys, types
import numpy as np
import torch
torch.set_num_threads(1)

rank, port, work = int(sys.argv[1]), sys.argv[2], sys.argv[3]
from deepgraphpose_tpu_torch.core.config import PoseConfig
from deepgraphpose_tpu_torch.models.pose_model import PoseModel
from deepgraphpose_tpu_torch.ops.augment_device import DeviceAugmentConfig
from deepgraphpose_tpu_torch.ops.dgp_objective import DGPLossParams
from deepgraphpose_tpu_torch.parallel import distributed, mesh, train_dp
from deepgraphpose_tpu_torch.parallel.streaming import \
    estimate_pose_multichip
from deepgraphpose_tpu_torch.train import device_data as dd
from deepgraphpose_tpu_torch.train import fit, steps

distributed.initialize(f"127.0.0.1:{port}", 2, rank, device="cpu")
group = mesh.make_mesh(device="cpu")
assert (group.rank, group.world) == (rank, 2)
case = torch.load(f"{work}/case.pt", weights_only=False)
out = {}

# the multi-process helpers (tests/test_multihost.py's first case)
full = np.arange(16 * 3, dtype=np.float32).reshape(16, 3) + 1.0
sl = distributed.local_slice(16)
part = distributed.global_batch(group, {"x": full[sl]})["x"]
w = distributed.replicate_from_host0(
    group, {"w": np.full(3, 3.5 + rank, np.float32)})["w"]
out["multihost"] = dict(
    multiprocess=distributed.is_multiprocess(), slice=(sl.start, sl.stop),
    col_sum=group.all_sum(part.sum(0)).tolist(), w=w.tolist(),
    gathered=group.all_gather(part).tolist())


def model64():
    m = PoseModel(PoseConfig(**case["cfg"]), dtype=torch.float64)
    m.load_state_dict(case["state"])
    return m.eval()


# the DGP DP step: this rank's window of two
m = model64()
opt = steps.make_optimizer(m.parameters(), case["lr"], clip_norm=10.0)
step = train_dp.make_dp_pooled_dgp_train_step(
    m, DGPLossParams(**case["params"]), opt, group, None, bn_train=True,
    device_flow=True)
sl = group.shard(2)
terms = step(case["pool"], case["rows"][sl],
             {k: v[sl] for k, v in case["batch"].items()}, [None])
out["dgp"] = ({k: v.item() for k, v in terms.items()},
              {k: v.clone() for k, v in m.state_dict().items()})

# the step-0 DP step: global-batch BN and augmentation
m = model64()
opt = steps.make_optimizer(m.parameters(), case["lr"])
step = train_dp.make_dp_pooled_dlc_train_step(
    m, PoseConfig(**case["cfg"]), opt, group,
    DeviceAugmentConfig.reference(), bn_train=True)
terms = step(types.SimpleNamespace(**case["dlc_pool"]), case["idxs"],
             torch.Generator().manual_seed(11))
out["dlc"] = ({k: v.item() for k, v in terms.items()},
              {k: v.clone() for k, v in m.state_dict().items()})

# fit_dgp over the two ranks, augmentation on
final = fit.fit_dgp(dlcpath=f"{work}/fit", device="cpu", data_parallel=2,
                    **case["fit"])
out["fit"] = str(final)

# without the resident pools the ranks raise: none trains the run alone
dd.DEFAULT_POOL_BUDGET_BYTES = 200_000
out["no_pool"] = []
for fn, kw in ((fit.fit_dgp, case["fit"]),
               (fit.fit_dlc, dict(maxiters=2, device_data=False))):
    try:
        fn(dlcpath=f"{work}/fit_spill", device="cpu", data_parallel=2, **kw)
    except ValueError as e:
        out["no_pool"].append(str(e))

# time-sharded inference over the two ranks, recording the frames decoded
from deepgraphpose_tpu_torch.data.video import VideoReader

iter_frames, decoded = VideoReader.iter_frames, []


def recorded(self, start=0, stop=None):
    for i, frame in iter_frames(self, start, stop):
        decoded.append(i)
        yield i, frame


VideoReader.iter_frames = recorded
out["stream"] = estimate_pose_multichip(
    *case["stream"], mesh=group, frames_per_device=4, max_frames=20,
    smooth=True, compute_dtype=torch.float32, save_pose=False)
out["decoded"] = decoded
torch.save(out, f"{work}/rank{rank}.pt")
print(f"RANK{rank} OK")
"""


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_ranks_match_one(dp_project, tmp_path):
    """The collective path over two gloo ranks on the CPU against world 1,
    and the port's own layout invariance (2 ranks x 1 window against
    1 x 2 windows, augmentation on)."""
    from deepgraphpose_tpu_torch.parallel.streaming import \
        estimate_pose_multichip

    jm = JaxPoseModel(JaxPoseConfig(net_type=NET, num_joints=NJ))
    variables = random_variables(jm, HW, seed=5, stem_scale=1.0)
    pool, rows, batch = windows(seed=6, g=2, wt=0.5)
    dlc = dlc_inputs(seed=7, gbs=4)
    fit_kw = {k: v for k, v in GROUP_FIT.items()
              if k != "windows_per_device"}
    fit_kw.update(aug=True, maxiters=6)
    for name in ("fit", "fit_one", "fit_spill"):
        project_copy(dp_project, tmp_path / name)
    _, cfg, train = paths.resolve_project(dp_project)
    snap = train / f"{WARM}.ckpt"
    stream = (str(dp_project / "config.yaml"), str(snap),
              str(dp_project / "videos" / "synthvid.avi"), str(tmp_path))
    torch.save({
        "cfg": dict(net_type=NET, num_joints=NJ, pos_dist_thresh=9),
        "state": port_model(variables, torch.float64).state_dict(),
        "lr": LR, "params": loss_params(0.5),
        "pool": torch.from_numpy(pool), "rows": torch.from_numpy(rows),
        "batch": {k: torch.from_numpy(v).double() for k, v in batch.items()},
        "dlc_pool": {k: torch.from_numpy(dlc[k]) for k in
                     ("images", "coords", "present", "content_wh")},
        "idxs": torch.from_numpy(dlc["idxs"]), "fit": fit_kw,
        "stream": stream}, tmp_path / "case.pt")

    port = free_port()
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(rank),
                               str(port), str(tmp_path)], env=env,
                              cwd=str(tmp_path), text=True,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for rank in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"RANK{rank} OK" in log, log[-3000:]
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    full = np.arange(16 * 3, dtype=np.float32).reshape(16, 3) + 1.0
    for r, got in enumerate(ranks):
        got = got["multihost"]
        assert got["multiprocess"] and got["slice"] == (8 * r, 8 * r + 8)
        np.testing.assert_array_equal(got["col_sum"], full.sum(0))
        assert got["w"] == [3.5] * 3
        np.testing.assert_array_equal(got["gathered"], full)

    # world 1 on the whole batch, in this process
    params = DGPLossParams(**loss_params(0.5))
    model = port_model(variables, torch.float64)
    opt = steps.make_optimizer(model.parameters(), LR, clip_norm=10.0)
    terms = train_dp.make_dp_pooled_dgp_train_step(
        model, params, opt, mesh.make_mesh(1, "cpu"), None, bn_train=True,
        device_flow=True)(torch.from_numpy(pool), torch.from_numpy(rows),
                          {k: torch.from_numpy(v).double()
                           for k, v in batch.items()}, [None, None])
    from deepgraphpose_tpu_torch.ops.augment_device import \
        DeviceAugmentConfig

    dlc_state, dlc_terms = port_dlc_step(
        variables, dlc, None, torch.float64, bn_train=True,
        aug_cfg=DeviceAugmentConfig.reference())
    want = {"dgp": ({k: v.item() for k, v in terms.items()},
                    port_state(model)),
            "dlc": (dlc_terms, dlc_state)}
    for name, (want_terms, want_state) in want.items():
        for r in ranks:
            got_terms, got_state = r[name]
            for key, value in want_terms.items():
                assert got_terms[key] == pytest.approx(
                    value, rel=SAME_PROCESS_REL), (name, key)
            assert_within_largest(got_state, want_state, SAME_PROCESS_REL)

    for r in ranks:
        assert len(r["no_pool"]) == 2, r["no_pool"]
        assert "over 2 ranks does not support segment-rotating pools" in \
            r["no_pool"][0]
        assert "over 2 ranks needs the device-data pool" in r["no_pool"][1]
    assert sorted(p.name for p in train_dir(tmp_path / "fit_spill").iterdir()
                  ) == sorted(p.name for p in train_dir(dp_project).iterdir())

    fit.fit_dgp(dlcpath=tmp_path / "fit_one", device="cpu",
                windows_per_device=2, **fit_kw)
    assert ranks[0]["fit"] == ranks[1]["fit"] == str(
        train_dir(tmp_path / "fit") / "snapshot-step2-final--0.ckpt")
    assert_allclose_states(final_state(tmp_path / "fit"),
                           final_state(tmp_path / "fit_one"), PARAM_RTOL,
                           PARAM_ATOL)
    got, want = (logged_losses(tmp_path / n) for n in ("fit", "fit_one"))
    assert [it for it, _ in got] == [it for it, _ in want]
    for (it, g), (_, w) in zip(got, want):
        assert g == pytest.approx(w, rel=FIT_LOSS_REL), it

    one = estimate_pose_multichip(*stream, mesh=mesh.make_mesh(1, "cpu"),
                                  frames_per_device=4, max_frames=20,
                                  smooth=True, compute_dtype=torch.float32,
                                  save_pose=False)
    for r, got in enumerate(ranks):      # each rank decoded its own span
        assert got["decoded"] == list(range(12 * r, min(12 * r + 12, 20)))
    for r in ranks:
        for key in ("x", "y", "displacement", "likelihoods"):
            np.testing.assert_allclose(r["stream"][key], one[key],
                                       rtol=STREAM_TOL, atol=STREAM_TOL,
                                       err_msg=key)

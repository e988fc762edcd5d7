"""The port's superstep (``train/device_data.py``: K pooled updates a
dispatch, the JAX package's ``lax.scan`` superstep) and the device-flow
pooled update, on the CPU.

* ``iter_scan_chunks`` and ``iter_scan_runs`` equal the JAX package's on
  random schedules, resume starts and snapshot intervals.
* ``fit_dlc``, ``fit_dgp_labeledonly`` and ``fit_dgp`` with
  ``scan_iters=K`` train as with ``scan_iters=0`` (parameters within 1e-6
  of each tensor's largest value; on the CPU a superstep runs the same
  eager update K times, so the reading is 0), with the snapshot of a
  boundary inside a chunk written, also with the augmentation's draws and
  trainable batch-norm.
* A pooled update with the flow made on the device (wt > 0), from the
  same warm start as the JAX package's, within the chain bounds of
  ``tests/test_torch_fit.py`` (losses 1e-4 relative, parameters 1e-4 of
  each tensor's largest value).
"""

import numpy as np
import pytest
import torch

from deepgraphpose_tpu.train import device_data as jax_dd
from deepgraphpose_tpu.train import fit as jax_fit
from deepgraphpose_tpu_torch.train import device_data as dd
from deepgraphpose_tpu_torch.train import fit
from test_torch_fit import (LOSS_RTOL, PARAM_RTOL, WARM,  # noqa: F401
                            assert_losses_close, assert_params_close,
                            base_project, final_params, logged_losses,
                            project_copy, tiny_resnet, train_dir,
                            two_threads, work)

SCAN_RTOL = 1e-6


@pytest.mark.parametrize("seed", range(6))
def test_iter_scan_chunks_equal_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        stop = int(rng.integers(1, 60))
        start = int(rng.integers(0, stop))
        save_every = [None, 0, int(rng.integers(1, 12))][seed % 3]
        k = int(rng.integers(2, 9))
        assert list(dd.iter_scan_chunks(start, stop, save_every, k)) == \
            list(jax_dd.iter_scan_chunks(start, stop, save_every, k))


@pytest.mark.parametrize("seed", range(6))
def test_iter_scan_runs_equal_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        ds = np.repeat(rng.integers(0, 3, 8), rng.integers(1, 6, 8))
        schedule = [(int(i), None) for i in ds]
        start = int(rng.integers(0, len(schedule)))
        save_every = [None, int(rng.integers(1, 10))][seed % 2]
        k = int(rng.integers(2, 9))
        got = list(dd.iter_scan_runs(schedule, start, save_every, k))
        assert got == list(jax_dd.iter_scan_runs(schedule, start,
                                                 save_every, k))
        for ds_i, a, b in got:
            assert all(schedule[i][0] == ds_i for i in range(a, b))
            for it in range(a, b - 1):       # boundaries end their chunk
                assert not (save_every and it > 0 and it % save_every == 0)


@pytest.mark.parametrize("scan_iters,k", [(None, 0), (0, 0), (1, 0),
                                          (7, 7), ("3", 3)])
def test_resolve_scan_iters(scan_iters, k):
    assert dd.resolve_scan_iters(scan_iters) == k


def test_superstep_on_the_cpu_stacks_the_updates():
    """K eager updates in order, their terms stacked to (K,)."""

    class Counter:
        count = 0

    seen = []

    def update(inputs):
        seen.append(inputs["x"].clone())
        return {"a": inputs["x"].sum(), "b": inputs["x"].max()}

    step = dd.Superstep(Counter(), draws=False)
    x = torch.arange(12.0).reshape(3, 4)
    out = step(update, {"x": x}, None, ())
    assert list(out) == ["a", "b"]
    torch.testing.assert_close(out["a"], x.sum(1))
    torch.testing.assert_close(out["b"], x.amax(1))
    assert [s.tolist() for s in seen] == x.tolist()


def run_twice(base_project, work, entry, kw, k: int):
    """``entry`` on two copies of the project, scan_iters 0 and k; returns
    the two roots."""
    roots = []
    for scan in (0, k):
        root = project_copy(base_project, work / f"scan{scan}")
        getattr(fit, entry)(dlcpath=root, scan_iters=scan, device="cpu",
                            **kw)
        roots.append(root)
    return roots


@pytest.mark.parametrize("kw", [
    dict(jitter=True, bn_train=False),
    dict(jitter=True, aug=True, bn_train=True),
], ids=["jitter", "aug_bn_train"])
def test_fit_dlc_superstep_matches_per_update(tiny_resnet, base_project,
                                              work, capsys, kw):
    plain, scan = run_twice(base_project, work, "fit_dlc",
                            dict(snapshot=WARM, maxiters=7, displayiters=1,
                                 saveiters=3, **kw), 3)
    assert "scan superstep K=3" in capsys.readouterr().out
    assert_params_close(final_params(scan, 0), final_params(plain, 0),
                        SCAN_RTOL)
    assert_losses_close(logged_losses(scan), logged_losses(plain), SCAN_RTOL)
    for it in (3, 6):        # the boundaries: 3 ends a chunk of 3 updates
        assert (train_dir(scan) / f"snapshot-step0-{it}.ckpt").exists()


@pytest.mark.parametrize("kw", [
    dict(aug=False, bn_train=False),
    dict(aug=True, bn_train=True),
], ids=["plain", "aug_bn_train"])
def test_fit_dgp_superstep_matches_per_update(tiny_resnet, base_project,
                                              work, kw):
    """saveiters 6 at batch 3: a snapshot every 2 updates, so the chunks
    of 3 split at 2; the boundary snapshot is written from the state after
    its chunk."""
    plain, scan = run_twice(base_project, work, "fit_dgp",
                            dict(snapshot=WARM, batch_size=3, maxiters=5,
                                 displayiters=1, saveiters=6, nepoch=1,
                                 **kw), 3)
    assert_params_close(final_params(scan, 2), final_params(plain, 2),
                        SCAN_RTOL)
    assert_losses_close(logged_losses(scan), logged_losses(plain), SCAN_RTOL)
    assert (train_dir(scan) / "snapshot-step2-2.ckpt").exists()
    mid = [fit.ckpt_lib.state_dict_from_flax(fit.ckpt_lib.load_snapshot(
        train_dir(r) / "snapshot-step2-2.ckpt")[0]) for r in (scan, plain)]
    assert_params_close(*mid, SCAN_RTOL)


def test_fit_dgp_labeledonly_superstep_matches_per_update(
        tiny_resnet, base_project, work):
    plain, scan = run_twice(base_project, work, "fit_dgp_labeledonly",
                            dict(snapshot=WARM, maxiters=5, displayiters=1,
                                 nepoch=1), 2)
    assert_params_close(final_params(scan, 1), final_params(plain, 1),
                        SCAN_RTOL)
    assert_losses_close(logged_losses(scan), logged_losses(plain), SCAN_RTOL)


@pytest.mark.parametrize("scan_iters", [0, 2])
def test_device_flow_update_matches_jax(tiny_resnet, base_project, work,
                                        capsys, scan_iters):
    """fit_dgp(wt=1, device_flow=True) trains from the frame pool, with
    the flow made from each gathered window, as the JAX package's does
    from the same warm start (no augmentation: wt > 0 turns it off)."""
    kw = dict(snapshot=WARM, batch_size=3, maxiters=3, displayiters=1,
              nepoch=1, wt=1.0, device_flow=True)
    roots = {name: project_copy(base_project, work / name)
             for name in ("jax", "port")}
    jax_fit.fit_dgp(dlcpath=roots["jax"], **kw)
    capsys.readouterr()
    fit.fit_dgp(dlcpath=roots["port"], scan_iters=scan_iters, device="cpu",
                **kw)
    line = next(x for x in capsys.readouterr().out.splitlines()
                if "frame pools" in x)
    assert "device-resident frame pools" in line and "LK flow" in line
    assert_params_close(final_params(roots["port"], 2),
                        final_params(roots["jax"], 2), PARAM_RTOL)
    got, want = logged_losses(roots["port"]), logged_losses(roots["jax"])
    assert len(got) == 3
    assert_losses_close(got, want, LOSS_RTOL)


def test_device_flow_refuses_augmentation():
    with pytest.raises(ValueError, match="device_flow"):
        dd.make_pooled_dgp_train_step(
            torch.nn.Linear(1, 1), None, None,
            dd.DeviceAugmentConfig.reference(), device_flow=True)


def test_superstep_needs_the_pools(tiny_resnet, base_project, work, capsys):
    """On the host feed (wt > 0 without the device flow) scan_iters is
    ignored with a warning, as the JAX package ignores it there."""
    root = project_copy(base_project, work / "p")
    fit.fit_dgp(snapshot=WARM, dlcpath=root, batch_size=3, maxiters=2,
                displayiters=1, nepoch=1, wt=1.0, scan_iters=4, device="cpu")
    assert "runs on the device-resident pools only" in \
        capsys.readouterr().out
    assert np.isfinite([v for _, v in logged_losses(root)]).all()

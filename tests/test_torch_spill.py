"""The port's segment-rotating frame pools (the spill tier of
``train/device_data.py``) against the JAX package's, on the CPU.

* The JAX package's own cases (``tests/test_spill.py``): a segment gather
  reproduces the host frames, a window wider than a segment is refused, the
  runs visit every schedule position once, a producer error surfaces.
* The plan is numpy in both packages (greedy packing, then
  ``default_rng(seed + 3)``'s permutation of the runs), so on one project,
  schedule and budget the port's segments, window segments, rows, runs and
  segment arrays equal JAX's exactly.
* ``fit_dgp`` over a budget patched down spills into at least 2 segments,
  with and without the device flow, and without augmentation trains as the
  JAX package's spill run does (losses 1e-4 relative, parameters 1e-4 of
  each tensor's largest value).
"""

import numpy as np
import pytest

from deepgraphpose_tpu.data.batcher import MultiDataset as JaxMultiDataset
from deepgraphpose_tpu.data.batcher import \
    generate_batch_schedule as jax_schedule
from deepgraphpose_tpu.train import device_data as jax_dd
from deepgraphpose_tpu.train import fit as jax_fit
from deepgraphpose_tpu_torch.core import paths
from deepgraphpose_tpu_torch.data.batcher import MultiDataset
from deepgraphpose_tpu_torch.train import device_data as dd
from deepgraphpose_tpu_torch.train import fit
from test_torch_fit import (LOSS_RTOL, PARAM_RTOL, WARM,  # noqa: F401
                            assert_losses_close, assert_params_close,
                            base_project, final_params, logged_losses,
                            project_copy, tiny_resnet, two_threads, work)

# 48x64 frames (9216 bytes): a 200 KB budget spills the project's pools
# (about 700 KB) while a 100 KB segment holds the 6 labeled frames and a
# window's other 4 frames
BUDGET = 200_000


def datasets(root, package_mds):
    proj, cfg, _ = paths.resolve_project(root)
    return package_mds(proj, cfg, fit.dgp_video_sets(proj, root), ns=2,
                       n_max_frames=10).datasets


def windows_of(d, step: int = 2):
    frames = np.unique(np.concatenate(
        [d.visible_frames, d.hidden_frames, d.chunk]))
    return [frames[i:i + 3] for i in range(0, len(frames) - 2, step)]


def test_segmented_pool_partition_and_gather(base_project):
    """Every window's frames resolve inside its segment, and the segment
    gather reproduces the host frames exactly."""
    d = datasets(base_project, MultiDataset)[0]
    windows = windows_of(d)
    frame_bytes = d.nx_in * d.ny_in * 3
    capacity = (len(np.unique(d.visible_frames)) + 3) * frame_bytes
    pool = dd.SegmentedFramePool(d, windows, capacity)
    assert pool.n_segments > 1
    assert len(pool.window_segment) == len(windows)
    for w, frames in enumerate(windows):
        k = pool.window_segment[w]
        seg = pool.host_segment(k)
        np.testing.assert_array_equal(seg[pool.rows(frames, k)],
                                      d.get_frames(frames))
    # every segment array has one shape
    assert len({pool.host_segment(k).shape
                for k in range(pool.n_segments)}) == 1
    assert pool.nbytes == pool.host_segment(0).nbytes
    assert pool.rows([-1], 0)[0] == 0      # padding maps to row 0


def test_segmented_pool_rejects_impossible_window(base_project):
    d = datasets(base_project, MultiDataset)[0]
    with pytest.raises(ValueError, match="segment budget"):
        dd.SegmentedFramePool(d, [np.asarray(d.hidden_frames)[:4]],
                              d.nx_in * d.ny_in * 3)


def test_plan_spill_runs_covers_schedule(base_project):
    """The runs visit every schedule position once, each inside its run's
    (dataset, segment)."""
    d = datasets(base_project, MultiDataset)[0]
    schedule = [(0, w) for w in windows_of(d, step=1)]
    cap = (len(np.unique(d.visible_frames)) + 4) * d.nx_in * d.ny_in * 3
    pools, runs = dd.plan_spill_runs(schedule, [d], cap,
                                     np.random.default_rng(0))
    seen = []
    for ds_i, k, positions in runs:
        assert ds_i == 0 and 0 <= k < pools[0].n_segments
        for pos in positions:
            assert pools[0].window_segment[pos] == k
        seen.extend(positions)
    assert sorted(seen) == list(range(len(schedule)))


@pytest.mark.parametrize("seed,extra", [(0, 3), (1, 4), (5, 7)])
def test_spill_plan_equals_jax(base_project, seed, extra):
    """fit_dgp's schedule and budget rule on both packages' datasets: the
    segments, window segments, rows, runs and segment arrays are equal."""
    port_ds = datasets(base_project, MultiDataset)
    jax_ds = datasets(base_project, JaxMultiDataset)
    d = port_ds[0]
    args = ([x.visible_frames for x in port_ds],
            [x.hidden_frames for x in port_ds], [x.chunk for x in port_ds],
            3, 2, 60)
    schedule = fit.generate_batch_schedule(*args, seed=seed)
    want_schedule = jax_schedule(*args, seed=seed)
    assert [(i, list(f)) for i, f in schedule] == \
        [(i, list(f)) for i, f in want_schedule]
    cap = (len(np.unique(d.visible_frames)) + extra) * d.nx_in * d.ny_in * 3
    pools, runs = dd.plan_spill_runs(schedule, port_ds, cap,
                                     np.random.default_rng(seed + 3))
    want_pools, want_runs = jax_dd.plan_spill_runs(
        want_schedule, jax_ds, cap, np.random.default_rng(seed + 3))
    assert [(i, k, list(p)) for i, k, p in runs] == \
        [(i, k, list(p)) for i, k, p in want_runs]
    got, want = pools[0], want_pools[0]
    assert got.n_segments == want.n_segments > 1
    assert got.window_segment == want.window_segment
    assert got.capacity == want.capacity and got.nbytes == want.nbytes
    for a, b in zip(got.segments, want.segments):
        np.testing.assert_array_equal(a, b)
    for ds_i, k, positions in runs:
        for pos in positions:
            np.testing.assert_array_equal(
                got.rows(schedule[pos][1], k), want.rows(schedule[pos][1], k))
        np.testing.assert_array_equal(got.host_segment(k),
                                      want.host_segment(k))


def test_iter_spill_segments_yields_the_runs_in_order(base_project):
    d = datasets(base_project, MultiDataset)[0]
    schedule = [(0, w) for w in windows_of(d, step=1)]
    cap = (len(np.unique(d.visible_frames)) + 4) * d.nx_in * d.ny_in * 3
    pools, runs = dd.plan_spill_runs(schedule, [d], cap,
                                     np.random.default_rng(2))
    got = list(dd.iter_spill_segments(pools, runs, "cpu"))
    assert [(i, k, p) for i, k, p, _ in got] == runs
    for _, k, _, segment in got:
        np.testing.assert_array_equal(segment.numpy(),
                                      pools[0].host_segment(k))


def test_iter_spill_segments_propagates_producer_errors():
    """A producer failure (a corrupt frame, an out-of-memory copy) raises
    on the consumer instead of stranding it on the queue."""

    class BoomPool:
        def host_segment(self, k):
            raise RuntimeError("decode exploded")

    with pytest.raises(RuntimeError, match="decode exploded"):
        for _ in dd.iter_spill_segments([BoomPool()], [(0, 0, [0, 1])],
                                        "cpu"):
            pass


@pytest.mark.parametrize("device_flow", [False, True])
def test_fit_dgp_trains_from_rotating_segments(tiny_resnet, base_project,
                                               work, monkeypatch, capsys,
                                               device_flow):
    """Over the budget, fit_dgp rotates segments (not the host feed),
    with the reference augmentation on the card, or with wt > 0 and the
    flow made from each gathered window."""
    monkeypatch.setattr(dd, "DEFAULT_POOL_BUDGET_BYTES", BUDGET)
    root = project_copy(base_project, work / "p")
    kw = dict(wt=1.0, device_flow=True) if device_flow else {}
    snap = fit.fit_dgp(snapshot=WARM, dlcpath=root, batch_size=3,
                       maxiters=6, displayiters=1, nepoch=1, device="cpu",
                       **kw)
    out = capsys.readouterr().out
    line = next(x for x in out.splitlines() if "segment-rotating" in x)
    assert int(line.split(" over ")[1].split()[0]) >= 2
    assert ("on-device LK flow" in line) == device_flow
    assert ("on-device augmentation" in line) != device_flow
    assert snap.exists()
    losses = [v for _, v in logged_losses(root)]
    assert len(losses) == 6 and np.isfinite(losses).all()


def test_fit_dgp_spill_matches_jax(tiny_resnet, base_project, work,
                                   monkeypatch):
    """The spill run without augmentation (no random draw): the JAX
    package's run order and segments, so its losses and weights."""
    monkeypatch.setattr(dd, "DEFAULT_POOL_BUDGET_BYTES", BUDGET)
    monkeypatch.setattr(jax_dd, "DEFAULT_POOL_BUDGET_BYTES", BUDGET)
    kw = dict(snapshot=WARM, batch_size=3, maxiters=6, displayiters=1,
              nepoch=1, aug=False)
    roots = {name: project_copy(base_project, work / name)
             for name in ("jax", "port")}
    jax_fit.fit_dgp(dlcpath=roots["jax"], **kw)
    fit.fit_dgp(dlcpath=roots["port"], device="cpu", **kw)
    assert_params_close(final_params(roots["port"], 2),
                        final_params(roots["jax"], 2), PARAM_RTOL)
    assert_losses_close(logged_losses(roots["port"]),
                        logged_losses(roots["jax"]), LOSS_RTOL)

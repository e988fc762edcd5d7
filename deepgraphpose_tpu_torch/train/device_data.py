"""Device-resident training-data pools and the pooled train steps.

The port's own copy of ``deepgraphpose_tpu/train/device_data.py``. The training
sets are small enough to live in device memory outright (a labeled set of
canvases; a DGP video's frame pool, capped at ``n_max_frames``), so:

* the whole labeled image set (step 0) / per-video frame pool (steps 1-2)
  is copied to the card ONCE as uint8;
* every iteration sends only row indices and the small label tensors;
* the batch is gathered on the card inside the train step and augmented
  there (``ops/augment_device.py``), and with wt > 0 its temporal clique
  reads a Lucas-Kanade flow made there too (``ops/flow_device.py``), so
  neither is host work on the critical path.

Frame pools over the budget rotate through device memory in segments
(:class:`SegmentedFramePool`, :func:`plan_spill_runs`,
:func:`iter_spill_segments`: the next segment is copied on a side stream
while the current one trains). The JAX package's ``lax.scan`` superstep, K
updates a dispatch, is :class:`Superstep` here: on the card each update
replays a CUDA graph of the pooled update, captured once per pool tensor
and window shape. The multi-window group update (G windows an update,
gradients of the mean over windows; ``parallel/train_dp.py`` runs it over
ranks) composes with it: :func:`make_pooled_dgp_group_scan_step`.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from deepgraphpose_tpu_torch.core.config import PoseConfig
from deepgraphpose_tpu_torch.models.resnet import BatchStats, FrozenBatchNorm
from deepgraphpose_tpu_torch.data.prefetch import host_to_device
from deepgraphpose_tpu_torch.ops.augment_device import (DeviceAugmentConfig,
                                                        augment_batch)
from deepgraphpose_tpu_torch.ops.dgp_objective import DGPLossParams, dgp_loss
from deepgraphpose_tpu_torch.ops.flow_device import flow_magnitude_device
from deepgraphpose_tpu_torch.ops.kernels import add_launches, launch_counts
from deepgraphpose_tpu_torch.parallel.mesh import DataGroup
from deepgraphpose_tpu_torch.train.steps import (_device, _update,
                                                 dlc_supervised_loss)

# frame pools larger than this rotate through segments (a labeled set stays
# on the host): the JAX package's budget (16 GB v5e), kept so that both
# packages choose the same path for one project
DEFAULT_POOL_BUDGET_BYTES = 6 * 1024**3


def pool_fits(n: int, h: int, w: int,
              budget: int = DEFAULT_POOL_BUDGET_BYTES) -> bool:
    return n * h * w * 3 <= budget


class LabeledImagePool:
    """Step-0 labeled set on the card: canvases, coords, presence, content
    dims.

    Canvases come from ``_TrainLabeledImages._place`` at ``global_scale``
    with no jitter (one shared placement implementation: the per-sample
    scale jitter and any further augmentation happen on the card per
    batch).
    """

    def __init__(self, data, cfg: PoseConfig, device):
        """``data``: a train.fit._TrainLabeledImages instance."""
        ch, cw = data.canvas_hw
        n = len(data)
        nj = cfg.num_joints
        images = np.zeros((n, ch, cw, 3), np.uint8)
        coords = np.zeros((n, nj, 2), np.float32)
        present = np.zeros((n, nj), np.float32)
        content = np.zeros((n, 2), np.float32)
        s = cfg.global_scale
        for i, (img, c) in enumerate(data._get(j) for j in range(n)):
            canvas, cc = data._place(img, c, s, None)
            images[i] = canvas
            present[i] = (~np.isnan(cc[:, 0])).astype(np.float32)
            coords[i] = np.nan_to_num(cc)
            content[i] = (min(max(int(round(img.shape[1] * s)), 1), cw),
                          min(max(int(round(img.shape[0] * s)), 1), ch))

        self.n = n
        self.canvas_hw = data.canvas_hw
        self.images = host_to_device(images, device)
        self.coords = host_to_device(coords, device)
        self.present = host_to_device(present, device)
        self.content_wh = host_to_device(content, device)

    @property
    def nbytes(self) -> int:
        return self.images.numel() * self.images.element_size()


class FramePool:
    """Steps-1/2 per-video frame pool on the card.

    Holds every frame the precomputed schedule can touch (the video's
    ``chunk``: visible + hidden + window frames, ref: dataset.py:373-424)
    and maps frame numbers to pool rows.
    """

    def __init__(self, ds, device):
        frames = np.unique(np.concatenate([
            np.asarray(ds.visible_frames, np.int64),
            np.asarray(ds.hidden_frames, np.int64),
            np.asarray(ds.chunk, np.int64)]))
        self.frames = frames
        self._row = {int(f): i for i, f in enumerate(frames)}
        imgs = ds.get_frames(frames)
        self.images = host_to_device(np.ascontiguousarray(imgs), device)
        self.hw = imgs.shape[1:3]

    def rows(self, frame_numbers) -> np.ndarray:
        """Pool rows for frame numbers; padding (-1) maps to row 0 (masked
        out by frame_mask downstream)."""
        return np.array([self._row.get(int(f), 0) for f in frame_numbers],
                        np.int32)

    @property
    def nbytes(self) -> int:
        return self.images.numel() * self.images.element_size()


class SegmentedFramePool:
    """The spill tier between "the pool fits on the card" and the host feed.

    When a video's frame universe exceeds the budget, the precomputed
    window schedule is greedily packed into time segments: every labeled
    (visible) frame stays pinned in the device array, and the other frames
    of consecutive windows accumulate into a segment until its frame union
    would pass ``capacity_frames``. One copy to the card then serves every
    window of the segment, so each frame crosses once per schedule pass,
    not once per overlapping window (ref hot-loop cost:
    dataset.py:811-821).

    All segment arrays share one shape ``(n_pinned + capacity, H, W, 3)``
    (short segments pad with row 0), so the pooled step sees one shape.
    """

    def __init__(self, ds, windows, capacity_bytes: int):
        """``windows``: the schedule's frame arrays for this video, in
        visit order. ``capacity_bytes``: device bytes of ONE resident
        segment array (pinned block included)."""
        self.ds = ds
        pinned = np.unique(np.asarray(ds.visible_frames, np.int64))
        self._pinned_row = {int(f): i for i, f in enumerate(pinned)}
        self.pinned = pinned
        self._pinned_block = None  # decoded once, reused by every segment
        frame_bytes = int(ds.nx_in) * int(ds.ny_in) * 3
        cap = capacity_bytes // max(frame_bytes, 1) - len(pinned)

        needed = []
        for frames in windows:
            needed.append(sorted({int(f) for f in np.asarray(frames).ravel()
                                  if int(f) >= 0
                                  and int(f) not in self._pinned_row}))
        widest = max((len(n) for n in needed), default=0)
        if cap < widest:
            raise ValueError(
                f"SegmentedFramePool: one window needs {widest} non-pinned "
                f"frames but the segment budget holds only {cap}")

        self.segments: list[np.ndarray] = []  # sorted frame numbers
        self.window_segment: list[int] = []
        cur: set[int] = set()
        for need in needed:
            if cur and len(cur | set(need)) > cap:
                self.segments.append(np.array(sorted(cur), np.int64))
                cur = set()
            cur |= set(need)
            self.window_segment.append(len(self.segments))
        self.segments.append(np.array(sorted(cur), np.int64))

        self.capacity = max((len(s) for s in self.segments), default=1)
        self._local = [{int(f): i for i, f in enumerate(seg)}
                       for seg in self.segments]
        self.hw = (int(ds.nx_in), int(ds.ny_in))

    @property
    def n_segments(self) -> int:
        return len(self.segments)

    @property
    def nbytes(self) -> int:
        """Device bytes of ONE resident segment array."""
        h, w = self.hw
        return (len(self.pinned) + self.capacity) * h * w * 3

    def host_segment(self, k: int) -> np.ndarray:
        """Segment ``k``'s host array: the pinned block, then the
        segment's frames, padded to the shared shape."""
        h, w = self.hw
        n = len(self.pinned) + self.capacity
        out = np.zeros((n, h, w, 3), np.uint8)
        if len(self.pinned):
            if self._pinned_block is None:
                self._pinned_block = self.ds.get_frames(self.pinned)
            out[:len(self.pinned)] = self._pinned_block
        seg = self.segments[k]
        if len(seg):
            out[len(self.pinned):len(self.pinned) + len(seg)] = \
                self.ds.get_frames(seg)
        return out

    def rows(self, frame_numbers, k: int) -> np.ndarray:
        """Rows into segment ``k``'s array; padding (-1) and unknown frames
        map to row 0 (masked by frame_mask downstream)."""
        local = self._local[k]
        p = len(self.pinned)
        return np.array(
            [self._pinned_row[int(f)] if int(f) in self._pinned_row
             else p + local.get(int(f), -p)
             for f in frame_numbers], np.int32)


def plan_spill_runs(schedule, datasets, capacity_bytes: int, rng):
    """Regroup a window schedule for segment-rotating training.

    Returns ``(pools, runs)``: a :class:`SegmentedFramePool` a dataset
    (None where the dataset has no windows) and the runs
    ``(ds_i, seg_idx, [schedule positions])``. Windows keep their relative
    order inside a run (with a single run this is the plain pooled visit
    order); the run order is ``rng``'s permutation, so videos and segments
    interleave across the pass.
    """
    per_ds: dict[int, list[int]] = {}
    for pos, (ds_i, _frames) in enumerate(schedule):
        per_ds.setdefault(int(ds_i), []).append(pos)
    pools: list = [None] * len(datasets)
    runs = []
    for ds_i, positions in per_ds.items():
        pool = SegmentedFramePool(
            datasets[ds_i], [schedule[p][1] for p in positions],
            capacity_bytes)
        pools[ds_i] = pool
        by_seg: dict[int, list[int]] = {}
        for w, pos in enumerate(positions):
            by_seg.setdefault(pool.window_segment[w], []).append(pos)
        runs.extend((ds_i, k, ps) for k, ps in sorted(by_seg.items()))
    if len(runs) > 1:
        order = rng.permutation(len(runs))
        runs = [runs[int(i)] for i in order]
    return pools, runs


def iter_spill_segments(pools, runs, device):
    """Yield ``(ds_i, seg_idx, positions, segment)`` a run, ``segment`` the
    run's frames on ``device``. A background thread assembles the next
    segment on the host and, to the card, copies it from pinned memory on a
    side stream while the current one trains; the consumer's stream waits
    for the copy's event, and the tensor is recorded on that stream so the
    allocator does not hand its memory out while the consumer still reads
    it. A producer error is raised on the consumer."""
    device = torch.device(device)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    q: queue.Queue = queue.Queue(maxsize=1)

    def producer():
        try:
            for ds_i, k, positions in runs:
                host = torch.from_numpy(pools[ds_i].host_segment(k))
                done = None
                if stream is None:
                    segment = host.to(device)
                else:
                    with torch.cuda.stream(stream):
                        segment = host.pin_memory().to(device,
                                                       non_blocking=True)
                        done = torch.cuda.Event()
                        done.record(stream)
                q.put((ds_i, k, positions, segment, done))
            q.put(None)
        except BaseException as e:  # noqa: BLE001 - raised on the consumer
            q.put(e)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    while True:
        item = q.get()
        if item is None:
            break
        if isinstance(item, BaseException):
            raise item
        ds_i, k, positions, segment, done = item
        if done is not None:
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(done)
            segment.record_stream(consumer)
        yield ds_i, k, positions, segment
    thread.join()


def resolve_scan_iters(scan_iters, use_pool: bool = True,
                       n_dp: int = 0) -> int:
    """A fit API ``scan_iters`` argument as a chunk length K (0 = off).

    ``None`` is auto: the JAX package scans 20 updates a dispatch on a TPU
    only, and the port runs on no TPU, so auto is off. The superstep needs
    the device-resident pools and one device: over ranks (``n_dp > 1``)
    each update waits on its collective anyway."""
    if not use_pool or n_dp > 1 or scan_iters is None:
        return 0
    k = int(scan_iters)
    return k if k > 1 else 0


def iter_scan_chunks(start: int, stop: int, save_every: int | None, k: int):
    """Yield half-open iteration ranges ``[a, b)`` of at most ``k`` updates
    such that a snapshot boundary (``it % save_every == 0``, ``it > 0``) is
    always the LAST iteration of its chunk: the trainer writes that
    snapshot from the state after the chunk. ``save_every`` falsy disables
    boundary splitting."""
    it = start
    while it < stop:
        end = it + k
        if save_every:
            b = ((max(it, 1) + save_every - 1) // save_every) * save_every
            end = min(end, b + 1)
        end = min(end, stop)
        yield it, end
        it = end


def iter_scan_runs(schedule, start: int, save_every: int | None, k: int):
    """Yield ``(ds_i, a, b)`` chunks of the DGP schedule for the superstep:
    at most ``k`` consecutive iterations, all from one dataset (one frame
    pool a dispatch), with snapshot boundaries chunk-final as in
    :func:`iter_scan_chunks`."""
    it, n = start, len(schedule)
    while it < n:
        ds_i = schedule[it][0]
        end = min(it + k, n)
        if save_every:
            b = ((max(it, 1) + save_every - 1) // save_every) * save_every
            end = min(end, b + 1)
        r = it
        while r < end and schedule[r][0] == ds_i:
            r += 1
        yield ds_i, it, r
        it = r


class _Graph:
    """One pooled update captured in a CUDA graph: its static inputs, the
    stacked loss terms it writes, and the kernel launches it holds."""

    def __init__(self, graph, inputs: dict, names: list,
                 terms: torch.Tensor, launches: dict):
        self.graph, self.inputs = graph, inputs
        self.names, self.terms, self.launches = names, terms, launches


class Superstep:
    """K pooled updates a dispatch: the JAX package's ``lax.scan``
    superstep (reference ``make_pooled_*_scan_step``).

    ``superstep(update, staged, generator, fixed)`` runs ``update(inputs)``
    for ``inputs = {name: staged[name][j]}``, j < K, and returns every loss
    term stacked to (K,). The K windows' inputs come staged on the device
    in one copy each, and the loss terms come back in one tensor, so the
    host reads them once a dispatch.

    On the CPU (the tests) the updates run eagerly. On the card each update
    replays a CUDA graph of ``update``, captured once for each ``fixed``
    (the pool tensors the update reads) and input shape: the first update
    of a shape runs eagerly on a side stream (the warm-up capture needs:
    the decode kernel's library and constants, the momentum traces, the
    libraries' handles), the second captures the graph, and every update
    from then on copies its inputs into the graph's static buffers (on the
    device), writes its rate into the optimizer's ``neg_lr`` and replays.
    The generator that draws the augmentation (or each of a list, one a
    window of a group update) is registered with the graph, so a replay
    draws what the eager update would draw from the generator's state. A replay launches the captured kernels without
    their wrappers, so each replay adds the capture's launches to the
    kernels' counts. A capture that fails raises; nothing falls back to
    eager updates.
    """

    def __init__(self, optimizer, draws: bool):
        """``draws``: whether ``update`` draws from the generator."""
        self.optimizer = optimizer
        self.draws = draws
        self.graphs: dict = {}
        self._side = None

    def __call__(self, update, staged: dict, generator,
                 fixed: tuple) -> dict:
        k = next(iter(staged.values())).shape[0]
        dev = next(iter(staged.values())).device
        outs = []
        if dev.type != "cuda":
            for j in range(k):
                out = update({n: v[j] for n, v in staged.items()})
                outs.append(torch.stack(list(out.values())))
            return dict(zip(out, torch.stack(outs, 1)))
        key = (tuple(t.data_ptr() for t in fixed),
               tuple((n, v.shape[1:], v.dtype) for n, v in staged.items()))
        for j in range(k):
            inputs = {n: v[j] for n, v in staged.items()}
            entry = self.graphs.get(key)
            if entry is None:           # the warm-up: the names of the terms
                self.graphs[key], terms = self._warm_up(update, inputs, dev)
                outs.append(terms)
                continue
            if not isinstance(entry, _Graph):
                entry = self.graphs[key] = self._capture(update, inputs,
                                                         generator, entry)
            for n, v in inputs.items():
                entry.inputs[n].copy_(v)
            self.optimizer.write_rate()
            entry.graph.replay()
            self.optimizer.count += 1
            add_launches(entry.launches)
            outs.append(entry.terms.clone())
        entry = self.graphs[key]
        names = entry.names if isinstance(entry, _Graph) else entry
        return dict(zip(names, torch.stack(outs, 1)))

    def _warm_up(self, update, inputs: dict, dev):
        """One update, eagerly, on a side stream."""
        if self._side is None:
            self._side = torch.cuda.Stream(dev)
        main = torch.cuda.current_stream(dev)
        self._side.wait_stream(main)
        with torch.cuda.stream(self._side):
            out = update(inputs)
            terms = torch.stack(list(out.values()))
        main.wait_stream(self._side)
        return list(out), terms

    def _capture(self, update, inputs: dict, generator, names) -> _Graph:
        static = {n: v.clone() for n, v in inputs.items()}
        graph = torch.cuda.CUDAGraph()
        if self.draws:
            if not hasattr(graph, "register_generator_state"):
                raise RuntimeError(
                    "scan_iters > 1 with on-device augmentation needs "
                    "torch.cuda.CUDAGraph.register_generator_state "
                    f"(torch {torch.__version__} has none)")
            for g in (generator if isinstance(generator, (list, tuple))
                      else [generator]):
                graph.register_generator_state(g)
        before = launch_counts()
        try:
            with self.optimizer.capturing(), torch.cuda.graph(graph):
                out = update(static)
                terms = torch.stack([out[n] for n in names])
        except Exception as e:
            raise RuntimeError(
                "scan_iters > 1: capturing the pooled update in a CUDA "
                f"graph failed ({e}); train with scan_iters=0") from e
        after = launch_counts()
        launches = {n: after[n] - before[n] for n in after}
        add_launches(launches, -1)      # a capture launches nothing
        return _Graph(graph, static, names, terms, launches)


def augment_dgp_window(generator: torch.Generator, images: torch.Tensor,
                       batch: dict, aug_cfg: DeviceAugmentConfig,
                       stride: float, nj: int):
    """On-device augmentation of one DGP window (visible frames only,
    matching ref: fitdgp.py:779): rewrites images and targets. Visibility
    masks are untouched: like the host Augmenter (and the reference's
    imgaug path), a joint displaced off-canvas stays a visible marker with
    an off-scoremap target, so the pooled and host paths train on the same
    distribution."""
    b = images.shape[0]
    vis_m = batch["visible_mask"].reshape(b, nj)
    frame_gate = (torch.amax(vis_m, dim=1) > 0).to(torch.float32)
    rc = batch["targets"]
    xy = torch.stack([rc[..., 1] * stride + stride / 2.0,
                      rc[..., 0] * stride + stride / 2.0], -1)
    images, xy, _ = augment_batch(generator, images, xy, vis_m, aug_cfg,
                                  gate=frame_gate)
    rc_new = torch.stack([(xy[..., 1] - stride / 2.0) / stride,
                          (xy[..., 0] - stride / 2.0) / stride], -1)
    targets = torch.where(frame_gate[:, None, None] > 0, rc_new, rc)
    return images, dict(batch, targets=targets)


def make_pooled_dlc_train_step(model, cfg: PoseConfig, optimizer,
                               aug_cfg: DeviceAugmentConfig | None,
                               bn_train: bool = False):
    """Step-0 train step that gathers and augments its batch from a
    :class:`LabeledImagePool`:

    ``step(pool, idxs, generator)`` -> loss dict (0-d tensors), updating
    ``model`` and ``optimizer`` in place. ``idxs`` are the batch's pool
    rows on the card; ``generator`` (on the card) draws the augmentation.
    Without augmentation the model gets the pool's uint8 canvases, after it
    float32 in [0, 255]; it takes both.
    """

    def step(pool: LabeledImagePool, idxs: torch.Tensor,
             generator: torch.Generator) -> dict:
        images = pool.images.index_select(0, idxs)
        coords = pool.coords.index_select(0, idxs)
        present = pool.present.index_select(0, idxs)
        if aug_cfg is not None:
            images, coords, present = augment_batch(
                generator, images, coords, present, aug_cfg,
                content_wh=pool.content_wh.index_select(0, idxs))
        heads = model(images, train=bn_train)
        out = dlc_supervised_loss(heads, coords, present, cfg)
        _update(optimizer, out["total_loss"])
        return {k: v.detach() for k, v in out.items()}

    return step


def make_pooled_dlc_scan_step(model, cfg: PoseConfig, optimizer,
                              aug_cfg: DeviceAugmentConfig | None,
                              bn_train: bool = False):
    """K pooled step-0 updates a dispatch (reference
    ``make_pooled_dlc_scan_step``): ``step(pool, idxs_stack (K, bs),
    generator)`` -> every loss term stacked to (K,). Each update is
    :func:`make_pooled_dlc_train_step`'s; see :class:`Superstep`."""
    update = make_pooled_dlc_train_step(model, cfg, optimizer, aug_cfg,
                                        bn_train)
    superstep = Superstep(optimizer, draws=aug_cfg is not None)

    def step(pool: LabeledImagePool, idxs_stack: torch.Tensor,
             generator: torch.Generator) -> dict:
        return superstep(
            lambda inputs: update(pool, inputs["idxs"], generator),
            {"idxs": idxs_stack}, generator,
            (pool.images, pool.coords, pool.present, pool.content_wh))

    return step


def make_pooled_dgp_train_step(model, params_obj: DGPLossParams, optimizer,
                               aug_cfg: DeviceAugmentConfig | None,
                               visible_only: bool = False,
                               bn_train: bool = False,
                               device_flow: bool = False):
    """DGP train step that gathers its window from a :class:`FramePool`:

    ``step(pool_images, rows, batch, generator)`` -> loss dict, updating
    ``model`` and ``optimizer`` in place. ``rows`` are the window's pool
    rows on the card; ``batch`` is ``DGPBatch.as_torch()``'s dict of the
    window's labels and masks (its images are not used); see
    :func:`augment_dgp_window` for the augmentation. On the card the
    objective decodes on the CUDA kernel, as in ``train/steps.py``.

    ``device_flow=True`` computes the temporal clique's flow magnitudes
    from the gathered window (``ops/flow_device.py``), so wt > 0 trains
    without the host's Farneback flow. It needs ``aug_cfg=None``: frames
    augmented one by one would lose the temporal coherence the flow
    measures (the reference turns augmentation off when wt > 0,
    fitdgp.py:777-779).
    """
    if device_flow and aug_cfg is not None:
        raise ValueError("make_pooled_dgp_train_step: aug_cfg must be None "
                         "when device_flow=True (flow needs unaugmented, "
                         "temporally coherent frames)")
    key = "total_loss_visible" if visible_only else "total_loss"
    params_obj = params_obj.to(_device(model))
    stride, nj = params_obj.stride, params_obj.nj

    def step(pool_images: torch.Tensor, rows: torch.Tensor, batch: dict,
             generator: torch.Generator) -> dict:
        images = pool_images.index_select(0, rows)
        if aug_cfg is not None:
            images, batch = augment_dgp_window(generator, images, batch,
                                               aug_cfg, stride, nj)
        if device_flow:
            batch = dict(batch, flow=flow_magnitude_device(images))
        heads = model(images, train=bn_train)
        out = dgp_loss(heads["part_pred"], heads["locref"], batch, params_obj)
        _update(optimizer, out[key])
        return {k: v.detach() for k, v in out.items()}

    return step


def make_pooled_dgp_scan_step(model, params_obj: DGPLossParams, optimizer,
                              aug_cfg: DeviceAugmentConfig | None,
                              visible_only: bool = False,
                              bn_train: bool = False,
                              device_flow: bool = False):
    """K pooled DGP updates a dispatch (reference
    ``make_pooled_dgp_scan_step``): ``step(pool_images, rows_stack (K, B),
    batch_stack, generator)`` -> every loss term stacked to (K,), where
    ``batch_stack`` holds every ``DGPBatch.as_torch()`` tensor with a
    leading K axis. Each update is :func:`make_pooled_dgp_train_step`'s;
    see :class:`Superstep`."""
    update = make_pooled_dgp_train_step(model, params_obj, optimizer,
                                        aug_cfg, visible_only, bn_train,
                                        device_flow)
    superstep = Superstep(optimizer, draws=aug_cfg is not None)

    def step(pool_images: torch.Tensor, rows_stack: torch.Tensor,
             batch_stack: dict, generator: torch.Generator) -> dict:
        def one(inputs: dict) -> dict:
            batch = {k: v for k, v in inputs.items() if k != "rows"}
            return update(pool_images, inputs["rows"], batch, generator)

        return superstep(one, dict(batch_stack, rows=rows_stack), generator,
                         (pool_images,))

    return step


# ---------------------------------------------------------------------------
# the multi-window group update: G windows an update
# ---------------------------------------------------------------------------

def window_generators(seed: int, n: int, device,
                      first: int = 0) -> list[torch.Generator]:
    """The augmentation generators of a group's window slots ``first`` ..
    ``first + n - 1``, on ``device``. Slot j's generator is seeded from
    ``(seed, j)`` whichever rank holds the slot, and draws once an update
    for that slot's window, so the layout (ranks x windows a rank) does
    not change any window's draws (the JAX package gives each window of a
    group its own key)."""
    return [torch.Generator(device).manual_seed(
        int(np.random.SeedSequence((seed, j)).generate_state(1)[0]))
        for j in range(first, first + n)]


def bn_buffers(model: torch.nn.Module) -> list[torch.Tensor]:
    """The batch-norm moving stats of ``model``, in module order."""
    return [b for m in model.modules() if isinstance(m, FrozenBatchNorm)
            for b in (m.mean, m.var)]


def window_heads(model, images: torch.Tensor, n: int,
                 bn_train: bool) -> list[dict]:
    """Each of ``n`` windows' heads (``images`` holds them one after
    another on N), in train mode with ``bn_train``. The windows go through
    the trunk in one call, each normalized by its own statistics with
    ``bn_train`` (``BatchStats``)."""
    t = images.shape[0] // n
    train = BatchStats(windows=n) if (bn_train and n > 1) else bn_train
    heads = model(images, train=train)
    return [{k: v[g * t:(g + 1) * t] for k, v in heads.items()}
            for g in range(n)]


def group_update(model, params_obj: DGPLossParams, optimizer,
                 group: DataGroup, images: torch.Tensor, batches: list,
                 key: str, bn_train: bool) -> dict:
    """One update over this rank's windows: ``images`` holds the
    ``len(batches)`` windows one after another on N, ``batches`` each
    window's ``DGPBatch`` tensors. The loss is the mean over the windows
    of each window's DGP loss, its gradient averaged over the group's
    ranks (every rank holds as many windows, so that is the gradient of
    the global mean), then every rank applies the same update.

    The windows' heads come from :func:`window_heads`. One
    ``all_reduce`` a dtype carries the gradients, the moving stats (with
    ``bn_train``: their average over the ranks) and the loss terms; a
    world of 1 runs none. Returns the loss terms, each the mean over the
    group's windows."""
    n = len(batches)
    heads = window_heads(model, images, n, bn_train)
    outs = [dgp_loss(h["part_pred"], h["locref"], b, params_obj)
            for h, b in zip(heads, batches)]
    names = list(outs[0])
    per_window = torch.stack([torch.stack([o[k] for k in names])
                              for o in outs])
    terms = per_window.mean(0)
    optimizer.zero_grad(set_to_none=True)
    terms[names.index(key)].backward()
    terms = terms.detach().clone()
    if group.world > 1:
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        group.all_reduce_mean_(grads + (bn_buffers(model) if bn_train
                                        else []) + [terms])
    optimizer.step()
    return dict(zip(names, terms))


def _make_dgp_group_pool_body(model, params_obj: DGPLossParams, optimizer,
                              aug_cfg: DeviceAugmentConfig | None,
                              visible_only: bool, bn_train: bool,
                              device_flow: bool,
                              group: DataGroup | None = None):
    """One G-window pooled DGP update: ``body(pool_images, rows (G, T),
    batch (every DGPBatch tensor G-leading), generators (G))`` -> the loss
    terms averaged over the windows, updating ``model`` and ``optimizer``
    in place. Each window is gathered, augmented from its own generator
    and given its flow on its own (the JAX package ``vmap``s them), then
    :func:`group_update`. ``group`` (default: a world of 1) holds the
    ranks the group's windows are spread over; ``rows`` and ``batch`` are
    then this rank's windows."""
    if device_flow and aug_cfg is not None:
        raise ValueError("group pool body: aug_cfg must be None when "
                         "device_flow=True (flow needs unaugmented, "
                         "temporally coherent frames)")
    key = "total_loss_visible" if visible_only else "total_loss"
    dev = _device(model)
    params_obj = params_obj.to(dev)
    stride, nj = params_obj.stride, params_obj.nj
    group = group or DataGroup(0, 1, dev)

    def body(pool_images: torch.Tensor, rows: torch.Tensor, batch: dict,
             generators) -> dict:
        images, batches = [], []
        for g in range(rows.shape[0]):
            im = pool_images.index_select(0, rows[g])
            b = {k: v[g] for k, v in batch.items()}
            if aug_cfg is not None:
                im, b = augment_dgp_window(generators[g], im, b, aug_cfg,
                                           stride, nj)
            if device_flow:
                b = dict(b, flow=flow_magnitude_device(im))
            images.append(im)
            batches.append(b)
        return group_update(model, params_obj, optimizer, group,
                            torch.cat(images), batches, key, bn_train)

    return body


def make_pooled_dgp_group_scan_step(model, params_obj: DGPLossParams,
                                    optimizer,
                                    aug_cfg: DeviceAugmentConfig | None,
                                    visible_only: bool = False,
                                    bn_train: bool = False,
                                    device_flow: bool = False):
    """K pooled G-window updates a dispatch (reference
    ``make_pooled_dgp_group_scan_step``): the multi-window group update
    and the superstep composed, on one device.

    ``step(pool_images, rows_stack (K, G, T), batch_stack (every DGPBatch
    tensor with leading (K, G)), generators (G))`` -> every loss term
    stacked to (K,), each entry averaged over its G windows. Each update
    is :func:`_make_dgp_group_pool_body`'s; see :class:`Superstep`."""
    body = _make_dgp_group_pool_body(model, params_obj, optimizer, aug_cfg,
                                     visible_only, bn_train, device_flow)
    superstep = Superstep(optimizer, draws=aug_cfg is not None)

    def step(pool_images: torch.Tensor, rows_stack: torch.Tensor,
             batch_stack: dict, generators) -> dict:
        def one(inputs: dict) -> dict:
            batch = {k: v for k, v in inputs.items() if k != "rows"}
            return body(pool_images, inputs["rows"], batch, generators)

        return superstep(one, dict(batch_stack, rows=rows_stack),
                         list(generators), (pool_images,))

    return step


def iter_group_scan_runs(group_ds, start: int, save_every: int | None,
                         group_stride: int, k: int):
    """Yield ``(ds_i, a, b)`` chunks over GROUP indices for the composed
    superstep: at most ``k`` consecutive groups, all from one dataset (one
    frame pool a dispatch). ``group_stride`` is the schedule positions one
    group consumes (G); a group gi is snapshot-final when iteration
    ``gi * group_stride`` crosses a ``save_every`` boundary (the trainer
    saves with ``stride=G``), and such groups end their chunk so that the
    snapshot is written from the state after them."""
    it, n = start, len(group_ds)
    while it < n:
        ds_i = group_ds[it]
        end = min(it + k, n)
        r = it
        while r < end and group_ds[r] == ds_i:
            r += 1
            gi = r - 1
            if (save_every and gi > 0
                    and (gi * group_stride) % save_every < group_stride):
                break
        yield ds_i, it, r
        it = r

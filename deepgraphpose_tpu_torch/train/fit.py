"""Training entry points: fit_dlc (step 0), fit_dgp_labeledonly (step 1),
fit_dgp (step 2), in PyTorch.

The port's own copy of ``deepgraphpose_tpu/train/fit.py``. The
orchestration contract is the reference's (ref:
src/deepgraphpose/models/fitdgp.py:53-254, 257-546, 549-845) as the JAX
package keeps it: the same step indices, snapshot naming, skip-if-final,
optimizer settings, DGP hyperparameter defaults, batch schedules and host
random stream, and snapshots in the JAX package's msgpack format (each
package resumes from the other's). Each entry point runs on the card
(``device=None``) or raises without one; tests pass ``device="cpu"``.

Three feeds, chosen as the JAX package chooses them:

* the device-resident pools (``train/device_data.py``): the labeled set or
  the DGP frame pool is copied to the card once, each iteration sends row
  indices, and augmentation runs on the card, drawn from a
  ``torch.Generator`` there seeded ``seed + 1`` (step 0) or ``seed + 2``
  (DGP), as the reference's keys are; with wt > 0 and ``device_flow`` the
  temporal clique's flow is made there too (``ops/flow_device.py``);
* DGP frame pools over the budget rotate through the card in segments
  (the spill tier), planned from ``default_rng(seed + 3)`` as the JAX
  package plans them;
* the host feed: batches assembled and augmented on the host by a
  background producer that owns the numpy ``rng`` (so the batches equal
  the JAX loop's for one seed), copied through pinned memory.

On the pools, ``scan_iters=K`` runs K updates a dispatch (the JAX
package's ``lax.scan`` superstep; on the card each update replays a CUDA
graph, ``device_data.Superstep``), with the loss terms read once a
dispatch. Otherwise losses are read (a sync) only at display intervals.
``compute_dtype="bfloat16"`` trains in mixed precision as the JAX
package does: float32 weights, optimizer state and snapshots, bfloat16
convolutions (each weight cast at its conv), float32 heads and losses.
Every backbone trains: the ResNets and the four MobileNetV2 widths.

``data_parallel`` trains over the ranks of a ``torch.distributed``
process group, one process a device (``parallel/distributed.py``): every
rank calls the entry point with the same arguments, builds the same
schedule from the same seed, and takes its slice of each global batch
(``parallel/train_dp.py``); rank 0 alone writes snapshots and logs.
``windows_per_device`` batches that many DGP windows a rank into each
update, on one card too, where it composes with ``scan_iters``.
"""

from __future__ import annotations

import csv
import time
from pathlib import Path

import numpy as np
import torch

from deepgraphpose_tpu_torch.core import checkpoint as ckpt_lib
from deepgraphpose_tpu_torch.core import paths as paths_lib
from deepgraphpose_tpu_torch.core.config import PoseConfig, ProjectConfig
from deepgraphpose_tpu_torch.core.device import resolve_device, resolve_dtype
from deepgraphpose_tpu_torch.core.paths import resolve_project  # noqa: F401
from deepgraphpose_tpu_torch.data import project as project_io
from deepgraphpose_tpu_torch.data.augment import Augmenter
from deepgraphpose_tpu_torch.data.batcher import (MultiDataset, assemble_batch,
                                                  generate_batch_schedule)
from deepgraphpose_tpu_torch.data.prefetch import (DevicePrefetcher,
                                                   host_to_device)
from deepgraphpose_tpu_torch.models.pose_model import PoseModel, init_model
from deepgraphpose_tpu_torch.ops.dgp_objective import (  # noqa: F401
    DGPLossParams, compute_spatial_bounds, loss_params)
from deepgraphpose_tpu_torch.train import device_data as dd
from deepgraphpose_tpu_torch.train import steps as steps_lib
from deepgraphpose_tpu_torch.utils import profiling


# ---------------------------------------------------------------------------
# shared plumbing
# ---------------------------------------------------------------------------

def _group_schedule_dp(schedule, n_dp: int, rng) -> list:
    """Group same-video windows into global steps of ``n_dp`` windows.

    Windows within one global step must share a frame pool (one video), so
    the schedule is partitioned per video and chunked; each video's tail
    group wrap-pads from its own head to keep shapes static. Global steps
    are then shuffled to restore the cross-video interleave the
    partitioning destroys (ref schedule semantics: fitdgp_util.py
    gen_batch's ratio-interleaved windows).
    """
    by_ds: dict[int, list] = {}
    for ds_i, frames in schedule:
        by_ds.setdefault(int(ds_i), []).append(frames)
    groups = []
    for ds_i, wins in by_ds.items():
        for j in range(0, len(wins), n_dp):
            grp = list(wins[j:j + n_dp])
            k = 0
            while len(grp) < n_dp:
                grp.append(wins[k % len(wins)])
                k += 1
            groups.append((ds_i, grp))
    return [groups[i] for i in rng.permutation(len(groups))]


def _resolve_data_parallel(data_parallel) -> int:
    """Rank count for ``data_parallel`` (0 = single-device path): True is
    the process group's world (1 without a group), an int that many,
    which may not pass the world."""
    if not data_parallel:
        return 0
    import torch.distributed as dist

    live = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if live else 1
    n = world if data_parallel is True else int(data_parallel)
    if n > world:
        raise ValueError(f"data_parallel={n} exceeds the {world} ranks of "
                         "the process group (one process a device: "
                         "parallel.distributed.initialize)")
    return n if n > 1 else 0


def _replicate_state(model, optimizer, group) -> None:
    """Rank 0's weights, buffers and momentum traces on every rank (after
    any resume, as the JAX package replicates its variables)."""
    from deepgraphpose_tpu_torch.parallel import mesh as mesh_lib

    mesh_lib.replicate(model, group)
    group.broadcast_([optimizer.state[p]["momentum_buffer"]
                      for p in model.parameters()
                      if optimizer.state.get(p, {}).get("momentum_buffer")
                      is not None])


def _init_model(cfg: PoseConfig, seed: int, compute_dtype,
                device) -> PoseModel:
    """A seeded PoseModel on ``device``: float32 weights, computing in
    ``compute_dtype`` (default: the config's)."""
    dtype = resolve_dtype(compute_dtype if compute_dtype is not None
                          else cfg.compute_dtype)
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"training computes in float32 or bfloat16, "
                         f"not {dtype}")
    return init_model(cfg, torch.Generator().manual_seed(seed), dtype,
                      device, param_dtype=torch.float32)


def dgp_video_sets(proj: ProjectConfig, dlcpath: str | Path) -> list[str]:
    """videos_dgp/ contents, else the project's video_sets
    (ref: fitdgp.py:594-604)."""
    vids = paths_lib.list_videos(paths_lib.videos_dgp_dir(dlcpath))
    if vids:
        return vids
    out = []
    for v in proj.video_sets:
        p = Path(v)
        if not p.is_absolute():
            p = Path(dlcpath) / p
        out.append(str(p))
    return out


def _log_stats(train_dir: Path, rows: list, header: list) -> None:
    path = train_dir / "learning_stats.csv"
    new = not path.exists()
    with open(path, "a", newline="") as f:
        wr = csv.writer(f)
        if new:
            wr.writerow(header)
        wr.writerows(rows)


def _make_tb_writer(train_dir, tb_log: bool):
    """Opt-in TensorBoard scalar writer under <train_dir>/log
    (ref: train.py:131-133, fitdgp.py:128-130 TF summaries)."""
    if not tb_log:
        return None
    from deepgraphpose_tpu_torch.utils.events import ScalarEventWriter

    return ScalarEventWriter(Path(train_dir) / "log")


def _tf_ckpt_exists(prefix: Path) -> bool:
    """True if ``prefix`` names a TF checkpoint (prefix + .index file)."""
    return Path(str(prefix) + ".index").exists()


def _warm_start(model: PoseModel, cfg: PoseConfig, train_dir: Path,
                snapshot: str | None, allow_init_weights: bool = True
                ) -> tuple[PoseModel, bool]:
    """Restore backbone+heads into ``model`` from (in order of preference):

    1. a msgpack snapshot ``<train_dir>/<snapshot>.ckpt`` (either package's),
    2. a TF1 snapshot ``<train_dir>/<snapshot>`` (prefix with .index) — the
       reference's ``--dlcsnapshot`` hand-off (ref: fitdgp.py:132-149),
    3. ``cfg.init_weights`` as a TF checkpoint (slim ImageNet
       ``resnet_v1_50.ckpt``; backbone scope only, ref: fitdgp.py:119-127).

    Returns ``(model, warmed)``: ``warmed=False`` means random init, which
    callers use to auto-enable trainable batch-norm.
    """
    if snapshot:
        snap_path = Path(train_dir) / f"{snapshot}{ckpt_lib.CKPT_SUFFIX}"
        if snap_path.exists():
            return ckpt_lib.restore_backbone_and_heads(model, snap_path), True
        tf_prefix = Path(train_dir) / snapshot
        if _tf_ckpt_exists(tf_prefix):
            _import_tf(model, cfg, tf_prefix, (_tf_scope(cfg), "pose"),
                       "TF1 snapshot")
            return model, True
    if allow_init_weights and cfg.init_weights:
        init_prefix = Path(cfg.init_weights)
        if not init_prefix.is_absolute() and cfg.project_path:
            init_prefix = Path(cfg.project_path) / init_prefix
        if _tf_ckpt_exists(init_prefix):
            _import_tf(model, cfg, init_prefix, (_tf_scope(cfg),),
                       "ImageNet init")
            return model, True
    if snapshot:
        print(f"warning: warm-start snapshot {snapshot} not found under "
              f"{train_dir}; training from random init")
    return model, False


def _tf_scope(cfg: PoseConfig) -> str:
    from deepgraphpose_tpu_torch.models import tf_import

    return tf_import.backbone_tf_scope(cfg.net_type)


def _import_tf(model: PoseModel, cfg: PoseConfig, prefix: Path,
               scopes: tuple, what: str) -> None:
    from deepgraphpose_tpu_torch.models import tf_import

    state, report = tf_import.import_tf_checkpoint(
        model.state_dict(), str(prefix), net_type=cfg.net_type, scopes=scopes)
    model.load_state_dict(state)
    print(f"imported {what} {prefix} ({len(report['imported'])} vars)")


# host-RAM budget for the eagerly decoded labeled-image set; above it the
# set is decoded per batch through a small LRU
HOST_IMAGE_BUDGET_BYTES = 2_000_000_000


class _TrainLabeledImages:
    """Labeled-frame image set for step 0, on a fixed canvas.

    The reference's random scale jitter produces a different tensor shape
    every iteration (pose_defaultdataset.py:136-266); here the canvas is
    static and the reference's scale distribution is reproduced inside it:
    each sample is resized by ``uniform(scale_jitter_lo, scale_jitter_up) *
    global_scale`` (ref: pose_defaultdataset.py:132-135 get_scale) and,
    when the scaled image overflows the canvas, a random window of canvas
    size is cropped (scale-then-crop, as the reference's CropImage,
    pose_dataset.py:40-53); joints falling outside are marked absent.

    Sets whose decoded size exceeds ``budget_bytes`` are not held in host
    RAM: only paths/coords/shapes are retained and ``batch`` decodes
    through an LRU of ``lru_images`` recent frames.
    """

    def __init__(self, proj: ProjectConfig, cfg: PoseConfig,
                 dlcpath: str | Path, jitter: bool = True,
                 budget_bytes: int = HOST_IMAGE_BUDGET_BYTES,
                 lru_images: int = 256):
        import cv2

        self.cfg = cfg
        self.jitter = jitter
        dlcpath = Path(dlcpath)
        # raw (unscaled) images; scaling happens per batch
        self.items: list[tuple[np.ndarray, np.ndarray]] = []

        mat_path = dlcpath / cfg.dataset if cfg.dataset else None
        entries: list[tuple[Path, np.ndarray]] = []
        if mat_path and mat_path.exists():
            ts = project_io.read_training_set(
                mat_path, dlcpath / cfg.metadataset if cfg.metadataset else None)
            coords = ts.coords_for(cfg.num_joints)
            for p, c in zip(ts.image_paths, coords):
                entries.append((dlcpath / p, c))
        else:
            # fall back to CollectedData CSVs
            for vdir in sorted((dlcpath / "labeled-data").glob("*")):
                try:
                    labels = project_io.read_labels(vdir, proj.scorer)
                except FileNotFoundError:
                    continue
                for p, c in zip(labels.image_paths, labels.coords_xy):
                    ip = dlcpath / p
                    if ip.exists():
                        entries.append((ip, c))
        if not entries:
            raise FileNotFoundError(f"no labeled images under {dlcpath}")

        self.lazy = False
        self._paths: list[Path] = []
        self._coords: list[np.ndarray] = []
        shapes: list[tuple[int, int]] = []
        nbytes = 0
        for ip, c in entries:
            img = cv2.imread(str(ip))
            if img is None:
                continue
            shapes.append(img.shape[:2])
            self._paths.append(ip)
            self._coords.append(np.asarray(c, np.float64))
            nbytes += img.nbytes
            if not self.lazy:
                if nbytes > budget_bytes:
                    # over budget: drop what was decoded, keep metadata (the
                    # canvas needs every shape either way)
                    self.lazy = True
                    self.items.clear()
                else:
                    self.items.append((
                        cv2.cvtColor(img, cv2.COLOR_BGR2RGB),
                        self._coords[-1]))
        if not shapes:
            raise FileNotFoundError(f"no decodable labeled images under "
                                    f"{dlcpath}")
        if self.lazy:
            import functools

            @functools.lru_cache(maxsize=lru_images)
            def _decode(i: int) -> np.ndarray:
                img = cv2.imread(str(self._paths[i]))
                return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)

            self._decode = _decode
            print(f"fit_dlc: labeled set ({nbytes / 1e9:.1f} GB decoded) "
                  f"exceeds the host budget; decoding per batch "
                  f"(LRU {lru_images})")

        scale = cfg.global_scale
        hmax = max(h for h, _ in shapes)
        wmax = max(w for _, w in shapes)
        s = int(cfg.stride)
        self.canvas_hw = (-(-int(round(hmax * scale)) // s) * s,
                          -(-int(round(wmax * scale)) // s) * s)

    def __len__(self):
        return len(self._paths)

    def _get(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        if self.lazy:
            return self._decode(int(i)), self._coords[i]
        return self.items[i]

    def _place(self, img: np.ndarray, c: np.ndarray, scale: float,
               rng: np.random.Generator | None):
        """Resize by ``scale``; random-crop to the canvas if it overflows."""
        import cv2

        ch, cw = self.canvas_hw
        if scale != 1.0:
            img = cv2.resize(img, (max(int(round(img.shape[1] * scale)), 1),
                                   max(int(round(img.shape[0] * scale)), 1)))
        c = c * scale
        h, w = img.shape[:2]
        if h > ch or w > cw:
            r0 = int(rng.integers(0, h - ch + 1)) if (rng is not None
                                                      and h > ch) else 0
            c0 = int(rng.integers(0, w - cw + 1)) if (rng is not None
                                                      and w > cw) else 0
            img = img[r0:r0 + ch, c0:c0 + cw]
            c = c - np.array([c0, r0], np.float64)  # coords are (x, y)
        # uint8 canvas: the model subtracts the mean on the device, and a
        # uint8 copy is 4x smaller than f32
        canvas = np.zeros((ch, cw, 3), np.uint8)
        canvas[:img.shape[0], :img.shape[1]] = img
        # joints cropped out of the canvas become absent (NaN)
        oob = ((c[:, 0] < 0) | (c[:, 0] > img.shape[1] - 1) |
               (c[:, 1] < 0) | (c[:, 1] > img.shape[0] - 1))
        c = c.copy()
        c[oob] = np.nan
        return canvas, c.astype(np.float32)

    def batch(self, idxs, rng: np.random.Generator | None = None
              ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        imgs_l, coords_l = [], []
        for i in idxs:
            img, c = self._get(i)
            if self.jitter and rng is not None:
                scale = float(rng.uniform(self.cfg.scale_jitter_lo,
                                          self.cfg.scale_jitter_up)
                              ) * self.cfg.global_scale
            else:
                scale = self.cfg.global_scale
            canvas, cc = self._place(img, c, scale, rng)
            imgs_l.append(canvas)
            coords_l.append(cc)
        imgs = np.stack(imgs_l)
        coords = np.stack(coords_l)
        present = ~np.isnan(coords[..., 0])
        return imgs, np.nan_to_num(coords), present


def _index_stream(n_items: int, bs: int, deterministic: bool,
                  rng: np.random.Generator):
    """Yield per-iteration sample indices for step 0.

    'deterministic' walks the labeled set in fixed cyclic order (ref:
    pose_dataset_deterministic.py); otherwise indices are drawn uniformly
    at random (ref: pose_defaultdataset.py shuffled sampling). The rng is
    consumed every iteration in the random mode so a mid-step resume
    replays the same stream.
    """
    it = 0
    while True:
        if deterministic:
            yield (it * bs + np.arange(bs)) % n_items
        else:
            yield rng.integers(0, n_items, size=bs)
        it += 1


class _Log:
    """Display, TensorBoard, learning_stats and snapshot bookkeeping of one
    fit run. Losses become floats (a sync with the card) only at display
    intervals."""

    def __init__(self, name: str, train_dir: Path, step: int, n_iters: int,
                 displayiters: int, save_every: int, loss_key: str,
                 max_to_keep: int, tb_log: bool, debug: str = "",
                 group=None):
        self.name, self.train_dir, self.step = name, Path(train_dir), step
        self.n_iters, self.displayiters = n_iters, displayiters
        self.save_every, self.loss_key = save_every, loss_key
        self.max_to_keep, self.debug = max_to_keep, debug
        # over ranks, rank 0 alone writes
        self.group = group
        self.root = group is None or group.is_root
        self.stats: list = []
        self.t0 = time.time()
        self.timer = profiling.StepTimer(
            self.train_dir / "steps.jsonl" if self.root else None)
        self.tb = _make_tb_writer(train_dir, tb_log and self.root)

    def __call__(self, it: int, out: dict, model, optimizer,
                 stride: int = 1) -> None:
        """``stride``: the schedule positions the update consumed (G for a
        G-window update); an interval fires where its boundary falls in
        [it, it + stride)."""
        if self.displayiters and it % self.displayiters < stride:
            # float() waits for the card: the interval's wall time is then
            # attributed across its steps
            terms = {k: float(v) for k, v in out.items()}
            loss = terms[self.loss_key]
            self.timer.interval(it, self.displayiters, loss=loss)
            if self.tb is not None:
                self.tb.add_scalars(it, {f"loss/{k}": v
                                         for k, v in terms.items()})
            if self.root:
                print(f"[{self.name}] iter {it}/{self.n_iters} loss "
                      f"{loss:.4f} ({time.time() - self.t0:.1f}s)",
                      flush=True)
            self.stats.append([it, loss])
        if (self.root and self.save_every and it > 0
                and it % self.save_every < stride):
            ckpt_lib.save_snapshot(self.train_dir, self.step, it, model,
                                   optimizer, self.max_to_keep, self.debug)

    def finish(self, last_it: int, model, optimizer) -> Path:
        """Close the logs; write the last iteration's snapshot and the
        final one; return the final snapshot's path (over ranks, once
        rank 0 has written it)."""
        self.timer.close()
        if self.tb is not None:
            self.tb.close()
        final = self.train_dir / (paths_lib.final_snapshot_name(
            self.step, self.debug) + ckpt_lib.CKPT_SUFFIX)
        if self.root:
            ckpt_lib.save_snapshot(self.train_dir, self.step, last_it, model,
                                   optimizer, self.max_to_keep, self.debug)
            final = ckpt_lib.save_snapshot(self.train_dir, self.step,
                                           "final--0", model,
                                           debug=self.debug)
            if self.stats:
                _log_stats(self.train_dir, self.stats, ["iteration", "loss"])
        if self.group is not None:
            self.group.barrier()
        return final


def _log_chunk(log: "_Log", iterations, outs: dict, model,
               optimizer, stride: int = 1) -> None:
    """Hand a superstep's updates to ``log``: its loss terms, stacked to
    (K,), are read from the card once (one copy, one sync)."""
    names = list(outs)
    terms = torch.stack([outs[n] for n in names]).cpu()
    for j, it in enumerate(iterations):
        log(it, {n: terms[i, j] for i, n in enumerate(names)}, model,
            optimizer, stride)


def _resume(train_dir: Path, step: int, debug: str, resume: bool, model,
            optimizer, name: str) -> int:
    """Load the newest intermediate snapshot (weights and optimizer state)
    and return the iteration to start at (0 without one). The reference
    can only skip-if-final (SURVEY §5)."""
    inter = (ckpt_lib.latest_intermediate_snapshot(train_dir, step, debug)
             if resume else None)
    if inter is None:
        return 0
    snap_path, snap_it = inter
    ckpt_lib.load_snapshot(snap_path, model, optimizer)
    print(f"resuming {name} from {snap_path.name} (iteration {snap_it + 1})")
    return snap_it + 1


# ---------------------------------------------------------------------------
# step 0: DLC warm-start
# ---------------------------------------------------------------------------

def fit_dlc(snapshot: str | None = None, dlcpath: str | Path = ".",
            shuffle: int = 1, step: int = 0, saveiters: int = 1000,
            displayiters: int = 100, maxiters: int = 200000,
            trainingsetindex: int = 0, seed: int = 0,
            compute_dtype=None, resume: bool = True,
            tb_log: bool = False, jitter: bool = True,
            bn_train: bool | None = None,
            device_data: bool | None = None,
            aug: bool = False,
            data_parallel: bool | int = False,
            scan_iters: int | None = None, device=None) -> Path | None:
    """Vanilla supervised training on labeled frames (ref: fitdgp.py:53-254).

    ``tb_log=True`` writes TensorBoard scalar event files with the per-term
    losses under ``<train_dir>/log/`` (ref: train.py:131-133 TF summaries).
    ``jitter`` applies the reference's per-sample scale jitter
    (scale_jitter_lo/up x global_scale) within the static canvas.
    ``bn_train`` trains batch-norm on batch statistics (None = auto: on
    when no warm start was found; frozen random-init BN collapses to
    predicting the dataset mean). ``device_data`` keeps the whole labeled
    set on the card and gathers/augments batches there (None = auto when
    it fits; train/device_data.py): per-iteration copies drop to the index
    vector. ``aug=True`` additionally runs the full reference augmentation
    on the card (an extension for from-scratch runs; on the host feed it
    falls back to jitter only, as the JAX package does). ``scan_iters=K``
    (K > 1) runs K updates of the pool a dispatch (on the card each one a
    CUDA graph's replay; ``None`` = 0, off); the host feed ignores it.
    ``data_parallel`` trains over the process group's ranks (True = all,
    int = that many, which must be the world): each of ``maxiters``
    updates consumes a global batch of ``batch_size x ranks`` images, each
    rank its slice, with the loss and (with ``bn_train``) the batch-norm
    statistics of the global batch (``parallel/train_dp.py``); it needs
    the device-data pool (``ValueError`` without it) and runs one update
    a dispatch. ``device``: the
    card by default; raises without one unless it names the CPU."""
    n_dp = _resolve_data_parallel(data_parallel)
    device = resolve_device(device)
    proj, cfg, train_dir = resolve_project(dlcpath, shuffle, trainingsetindex)
    if ckpt_lib.snapshot_exists(train_dir, step):
        print(f"snapshot-step{step}-final--0 exists; skipping fit_dlc")
        return ckpt_lib.latest_snapshot(train_dir, step)

    # pose_cfg dataset_type dispatch (ref: dataset/factory.py:19-44): the
    # 'deterministic' loader walks the set in order with no jitter; the
    # others sample at random with scale jitter
    deterministic = cfg.dataset_type == "deterministic"
    if deterministic:
        jitter = False
        aug = False  # the deterministic loader is reproducible by contract

    data = _TrainLabeledImages(proj, cfg, dlcpath, jitter=jitter)
    rng = np.random.default_rng(seed)
    bs = max(int(cfg.batch_size), 1)

    model = _init_model(cfg, seed, compute_dtype, device)
    model, warmed = _warm_start(model, cfg, Path(train_dir), snapshot)
    if bn_train is None:
        bn_train = not warmed
    if bn_train:
        print("fit_dlc: trainable batch-norm enabled (from-scratch mode)")
    optimizer = steps_lib.make_optimizer(model.parameters(),
                                         steps_lib.piecewise_lr(cfg.multi_step))

    use_pool = device_data
    if use_pool is None:
        use_pool = dd.pool_fits(len(data), *data.canvas_hw)
    elif use_pool and not dd.pool_fits(len(data), *data.canvas_hw):
        print("warning: fit_dlc(device_data=True) labeled-image pool "
              "exceeds the device budget; falling back to host batches")
        use_pool = False
    if n_dp > 1 and not use_pool:
        raise ValueError(f"fit_dlc(data_parallel={data_parallel}) over "
                         f"{n_dp} ranks needs the device-data pool (it "
                         "exceeds the device budget or device_data=False)")
    group = None
    if n_dp > 1:
        from deepgraphpose_tpu_torch.parallel import mesh as mesh_lib

        group = mesh_lib.make_mesh(n_dp, device)
    if use_pool:
        pool = dd.LabeledImagePool(data, cfg, device)
        if aug:
            aug_cfg = dd.DeviceAugmentConfig.reference(
                scale_jitter=((cfg.scale_jitter_lo, cfg.scale_jitter_up)
                              if jitter else (1.0, 1.0)))
        elif jitter:
            aug_cfg = dd.DeviceAugmentConfig.jitter_only(
                cfg.scale_jitter_lo, cfg.scale_jitter_up)
        else:
            aug_cfg = None
        if group is not None:
            from deepgraphpose_tpu_torch.parallel.train_dp import \
                make_dp_pooled_dlc_train_step

            pooled_step = make_dp_pooled_dlc_train_step(
                model, cfg, optimizer, group, aug_cfg, bn_train=bn_train)
        else:
            pooled_step = dd.make_pooled_dlc_train_step(
                model, cfg, optimizer, aug_cfg, bn_train=bn_train)
        scan_k = dd.resolve_scan_iters(scan_iters, True, n_dp)
        print(f"fit_dlc: device-resident pool of {len(data)} images "
              f"({pool.nbytes / 1e6:.0f} MB in device memory)"
              + (", full on-device augmentation" if aug else "")
              + (f", scan superstep K={scan_k}" if scan_k else "")
              + (f", data-parallel x{n_dp} (global batch {bs * n_dp})"
                 if n_dp > 1 else ""))
    else:
        if aug:
            print("warning: fit_dlc(aug=True) needs the device-data pool; "
                  "falling back to jitter-only host batches")
        _no_superstep(scan_iters, "fit_dlc")
        train_step = steps_lib.make_dlc_train_step(model, cfg, optimizer,
                                                   bn_train=bn_train)

    start_it = _resume(train_dir, step, "", resume, model, optimizer,
                       "fit_dlc")
    if group is not None:
        _replicate_state(model, optimizer, group)
    log = _Log("fit_dlc", train_dir, step, maxiters, displayiters, saveiters,
               "total_loss", cfg.max_to_keep, tb_log, group=group)

    if use_pool:
        # over ranks every rank draws the same global batch and
        # augmentation, and takes its slice
        generator = torch.Generator(device).manual_seed(seed + 1)
        stream = _index_stream(len(data), bs * max(n_dp, 1), deterministic,
                               rng)
        if scan_k:
            scan_step = dd.make_pooled_dlc_scan_step(
                model, cfg, optimizer, aug_cfg, bn_train=bn_train)
            for _ in range(start_it):  # resume: replay the index stream
                next(stream)
            for a, b in dd.iter_scan_chunks(start_it, maxiters, saveiters,
                                            scan_k):
                idxs = np.stack([next(stream) for _ in range(b - a)])
                outs = scan_step(pool, host_to_device(idxs.astype(np.int64),
                                                      device), generator)
                _log_chunk(log, range(a, b), outs, model, optimizer)
        else:
            for it in range(maxiters):
                idxs = next(stream)
                if it < start_it:
                    continue
                out = pooled_step(pool, host_to_device(idxs.astype(np.int64),
                                                       device), generator)
                log(it, out, model, optimizer)
    else:
        def producer():
            stream = _index_stream(len(data), bs, deterministic, rng)
            for it in range(maxiters):
                idxs = next(stream)
                if it >= start_it:
                    yield (it, *data.batch(idxs,
                                           rng=None if deterministic else rng))

        def transfer(item):
            it, imgs, coords, present = item
            return (it, host_to_device(imgs, device),
                    host_to_device(coords, device),
                    host_to_device(present, device))

        pf = DevicePrefetcher(producer(), transfer, depth=2)
        try:
            for it, imgs, coords, present in pf:
                log(it, train_step(imgs, coords, present), model, optimizer)
        finally:
            pf.close()
    return log.finish(maxiters - 1, model, optimizer)


# ---------------------------------------------------------------------------
# steps 1 & 2: DGP
# ---------------------------------------------------------------------------

def _no_superstep(scan_iters, name: str) -> None:
    if dd.resolve_scan_iters(scan_iters):
        print(f"warning: {name}(scan_iters={scan_iters}) runs on the "
              "device-resident pools only; one update a dispatch")


def _dgp_cfg_overrides(cfg: PoseConfig, step: int, batch_size: int,
                       wt: float, gm2: int, gm3: int, nepoch: int,
                       aug: bool, lr: float | None = None) -> PoseConfig:
    """DGP hyperparameters injected in code by the reference.

    step 1 (ref: fitdgp.py:343-359): clique terms off, visible-only loss.
    step 2 (ref: fitdgp.py:637-654): ws=1000, wn_v=5, wn_h=3, etc.
    ``lr=None`` keeps the reference's hard-coded 0.005 (fitdgp.py:353, 650).
    """
    lr = 0.005 if lr is None else lr
    if step == 1:
        return cfg.replace(ws=0.0, ws_max=1.2, wt=0.0, wt_max=0.0,
                           wn_visible=1.0, wn_hidden=0.0, gamma=1.0,
                           gauss_len=1.0, lengthscale=1.0, batch_size=1,
                           lr=lr, gm2=0, gm3=0, aug=aug,
                           n_times_all_frames=nepoch)
    return cfg.replace(ws=1000.0, ws_max=1.2, wt=wt, wt_max=0.0,
                       wn_visible=5.0, wn_hidden=3.0, gamma=1.0,
                       gauss_len=1.0, lengthscale=1.0, batch_size=batch_size,
                       lr=lr, gm2=gm2, gm3=gm3, aug=aug,
                       n_times_all_frames=nepoch)


def fit_dgp_labeledonly(snapshot: str = "snapshot-step0-final--0",
                        dlcpath: str | Path = ".", shuffle: int = 1,
                        step: int = 1, saveiters: int = 1000,
                        displayiters: int = 5, maxiters: int = 50000,
                        ns: int = 10, n_max_frames: int = 2000,
                        nepoch: int = 100, aug: bool = True, seed: int = 0,
                        trainingsetindex: int = 0, compute_dtype=None,
                        resume: bool = True, debug: str = "",
                        tb_log: bool = False,
                        bn_train: bool | None = None,
                        device_data: bool | None = None,
                        lr: float | None = None,
                        lr_decay: bool = False,
                        data_parallel: bool | int = False,
                        windows_per_device: int = 1,
                        scan_iters: int | None = None,
                        device=None) -> Path | None:
    """Step 1: DGP objective, visible-frame losses only
    (ref: fitdgp.py:257-546 — one visible frame per iteration)."""
    return _fit_dgp_impl(
        snapshot=snapshot, dlcpath=dlcpath, shuffle=shuffle, step=step,
        saveiters=saveiters, displayiters=displayiters, maxiters=maxiters,
        batch_size=1, ns=ns, n_max_frames=n_max_frames, gm2=0, gm3=0,
        nepoch=nepoch, wt=0.0, aug=aug, visible_only=True, seed=seed,
        trainingsetindex=trainingsetindex, compute_dtype=compute_dtype,
        resume=resume, debug=debug, tb_log=tb_log, bn_train=bn_train,
        device_data=device_data, lr=lr, lr_decay=lr_decay,
        data_parallel=data_parallel, windows_per_device=windows_per_device,
        scan_iters=scan_iters, device=device)


def fit_dgp(snapshot: str = "snapshot-step1-final--0",
            dlcpath: str | Path = ".", batch_size: int = 10,
            shuffle: int = 1, step: int = 2, saveiters: int = 1000,
            displayiters: int = 5, maxiters: int = 200000, ns: int = 10,
            n_max_frames: int = 2000, gm2: int = 0, gm3: int = 0,
            nepoch: int = 100, wt: float = 0.0, aug: bool = True,
            seed: int = 0, trainingsetindex: int = 0, compute_dtype=None,
            resume: bool = True, debug: str = "",
            tb_log: bool = False,
            bn_train: bool | None = None,
            device_data: bool | None = None,
            lr: float | None = None,
            device_flow: bool = False,
            lr_decay: bool = False,
            data_parallel: bool | int = False,
            windows_per_device: int = 1,
            scan_iters: int | None = None, device=None) -> Path | None:
    """Step 2: full semi-supervised DGP (ref: fitdgp.py:549-845).

    ``device_data``: keep the per-video frame pools on the card and
    gather/augment windows there (None = auto when wt == 0 or the flow is
    made on the card; pools over ``DEFAULT_POOL_BUDGET_BYTES`` rotate
    through the card in segments). ``device_flow``: with wt > 0, make the
    temporal clique's flow on the card (``ops/flow_device.py``, pyramidal
    Lucas-Kanade) instead of the host's Farneback, so wt > 0 trains from
    the pools (without augmentation, as the reference trains wt > 0).
    ``lr_decay=True`` anneals the rate with a cosine schedule over the
    step's update count (floor 5% of lr). ``scan_iters=K`` (K > 1) runs K
    updates of the resident pools a dispatch (on the card each one a CUDA
    graph's replay; ``None`` = 0, off). ``data_parallel`` (True = the
    process group's ranks, int = that many) spreads a global batch of
    ranks x ``windows_per_device`` DGP windows over the ranks in each
    update: each rank takes the mean loss over its windows, the gradients
    and (with ``bn_train``) the moving stats are averaged over the ranks
    (``parallel/train_dp.py``). ``windows_per_device`` batches that many
    schedule windows a rank into each update, one card included (the
    gradient of the mean over the windows, each window normalized by its
    own statistics with ``bn_train``); on one card it composes with
    ``scan_iters``. Both need the device-data frame pools: without them
    one process warns and trains one window an update, and ranks of a
    process group raise ``ValueError``. ``device``: the card by
    default."""
    return _fit_dgp_impl(
        snapshot=snapshot, dlcpath=dlcpath, shuffle=shuffle, step=step,
        saveiters=saveiters, displayiters=displayiters, maxiters=maxiters,
        batch_size=batch_size, ns=ns, n_max_frames=n_max_frames, gm2=gm2,
        gm3=gm3, nepoch=nepoch, wt=wt, aug=aug, visible_only=False,
        seed=seed, trainingsetindex=trainingsetindex,
        compute_dtype=compute_dtype, resume=resume, debug=debug,
        tb_log=tb_log, bn_train=bn_train, device_data=device_data, lr=lr,
        device_flow=device_flow, lr_decay=lr_decay,
        data_parallel=data_parallel, windows_per_device=windows_per_device,
        scan_iters=scan_iters, device=device)


def _fit_dgp_impl(snapshot, dlcpath, shuffle, step, saveiters, displayiters,
                  maxiters, batch_size, ns, n_max_frames, gm2, gm3, nepoch,
                  wt, aug, visible_only, seed, trainingsetindex,
                  compute_dtype, resume, debug, tb_log=False,
                  bn_train=None, device_data=None, lr=None,
                  device_flow=False, lr_decay=False,
                  data_parallel=False, windows_per_device=1,
                  scan_iters=None, device=None) -> Path | None:
    n_dp = _resolve_data_parallel(data_parallel)
    device = resolve_device(device)
    proj, cfg, train_dir = resolve_project(dlcpath, shuffle, trainingsetindex)
    name = "fit_dgp_labeledonly" if visible_only else "fit_dgp"
    if ckpt_lib.snapshot_exists(train_dir, step, debug):
        print(f"snapshot-step{step}{debug}-final--0 exists; skipping")
        return ckpt_lib.latest_snapshot(train_dir, step, debug)

    cfg = _dgp_cfg_overrides(cfg, step if not visible_only else 1,
                             batch_size, wt, gm2, gm3, nepoch, aug, lr=lr)
    S0 = proj.skeleton_incidence()
    video_sets = dgp_video_sets(proj, dlcpath)
    mds = MultiDataset(proj, cfg, video_sets, ns=ns,
                       n_max_frames=n_max_frames,
                       cache_dir=Path(dlcpath) / "motion_energy_cache")
    params = loss_params(cfg, S0, [d.labels_rc for d in mds.datasets],
                         mds.n_visible_frames_total,
                         mds.n_hidden_frames_total)

    rng = np.random.default_rng(seed)
    pad_to = max(batch_size + 1, 2)

    # schedule first (ref: gen_batch for step 2; random visible frames for
    # step 1) so the lr-decay horizon below matches the true iteration count
    if visible_only:
        n_sched = min(maxiters,
                      max(1, mds.n_visible_frames_total) * nepoch)
        schedule = []
        ds_choices = rng.choice(
            len(mds.datasets), size=n_sched,
            p=mds.batch_ratios if mds.batch_ratios.sum() > 0 else None)
        for ds_i in ds_choices:
            d = mds.datasets[int(ds_i)]
            if len(d.visible_frames) == 0:
                continue
            f = d.visible_frames[rng.integers(len(d.visible_frames))]
            schedule.append((int(ds_i), np.array([f])))
    else:
        schedule = generate_batch_schedule(
            [d.visible_frames for d in mds.datasets],
            [d.hidden_frames for d in mds.datasets],
            [d.chunk for d in mds.datasets],
            batch_size, nepoch, maxiters, seed=seed)
    n_iters = len(schedule)
    save_every = max(1, int(saveiters / max(batch_size, 1)))

    model = _init_model(cfg, seed, compute_dtype, device)
    model, warmed = _warm_start(model, cfg, Path(train_dir), snapshot,
                                allow_init_weights=False)
    if bn_train is None:
        bn_train = not warmed
    if bn_train:
        print(f"step {step}: trainable batch-norm enabled "
              "(from-scratch mode)")

    augmenter = Augmenter(apply_prob=0.8) if (aug and wt == 0) else None

    # device-resident frame pools: gather windows on the card, send only
    # indices. With wt != 0 the flow must then be made on the card too
    # (device_flow); augmentation runs on the card. Pools over the budget
    # rotate through the card in segments instead of dropping to the host
    # feed (ref hot-loop cost: dataset.py:811-821)
    use_pool = device_data
    use_spill = False
    flow_on_device = device_flow and wt != 0
    budget = dd.DEFAULT_POOL_BUDGET_BYTES
    est = sum((len(d.chunk) + len(d.visible_frames)
               + len(d.hidden_frames)) * d.nx_in * d.ny_in * 3
              for d in mds.datasets)
    if use_pool is None:
        pool_ok = wt == 0 or flow_on_device
        use_pool = pool_ok and est <= budget
        use_spill = pool_ok and not use_pool
    elif use_pool and wt != 0 and not flow_on_device:
        print("warning: device_data with wt != 0 needs device_flow=True "
              "(host-side Farneback otherwise); falling back to host "
              "batches")
        use_pool = False
    elif use_pool and est > budget:
        print(f"device_data=True frame pools ({est / 1e9:.1f} GB) exceed "
              "the device budget; using rotating segments")
        use_pool = False
        use_spill = True
    spill_plan = None
    if use_spill:
        try:
            spill_plan = dd.plan_spill_runs(schedule, mds.datasets,
                                            budget // 2,
                                            np.random.default_rng(seed + 3))
        except ValueError as e:
            print(f"warning: {e}; falling back to host batches")
            use_spill = False
    wpd = max(int(windows_per_device), 1)
    if wpd > 1 and n_dp == 0:
        n_dp = 1  # multi-window updates on one device: a group of 1
    dp_G = n_dp * wpd  # windows an optimizer update (the global batch)
    if dp_G > 1 and not use_pool:
        why = ("does not support segment-rotating pools" if use_spill
               else "requires the device-data frame pools")
        if n_dp > 1:
            # every rank would train the whole run alone and write alike
            raise ValueError(f"fit_dgp(data_parallel={data_parallel}) over "
                             f"{n_dp} ranks {why}")
        print(f"warning: fit_dgp(windows_per_device={wpd}) {why}; "
              "training single-device")
        n_dp = dp_G = 0
    elif dp_G <= 1:
        n_dp = dp_G = 0
    group = None
    if dp_G > 1:
        from deepgraphpose_tpu_torch.parallel import mesh as mesh_lib

        group = mesh_lib.make_mesh(n_dp, device)

    # lr_decay anneals the step's rate with a cosine schedule over its
    # update count (floor 5% of lr), G windows an update counting once;
    # the reference holds its hard-coded 0.005 flat (fitdgp.py:353, 650)
    n_updates = -(-n_iters // dp_G) if dp_G > 1 else n_iters
    if lr_decay:
        lr_or_sched = steps_lib.cosine_decay_schedule(
            cfg.lr, decay_steps=max(n_updates, 1), alpha=0.05)
    else:
        lr_or_sched = cfg.lr
    optimizer = steps_lib.make_optimizer(model.parameters(), lr_or_sched,
                                         momentum=0.9, clip_norm=10.0)

    # mid-step resume: continue from the latest intermediate snapshot
    # (weights AND optimizer state)
    start_it = _resume(train_dir, step, debug, resume, model, optimizer,
                       f"step {step}")
    if group is not None:
        _replicate_state(model, optimizer, group)

    scan_k = dd.resolve_scan_iters(scan_iters, use_pool, n_dp)
    if use_pool or use_spill:
        aug_cfg_dev = (dd.DeviceAugmentConfig.reference()
                       if augmenter is not None else None)
        kw = dict(visible_only=visible_only, bn_train=bn_train,
                  device_flow=flow_on_device)
        if dp_G > 1 and scan_k:
            pooled_step = dd.make_pooled_dgp_group_scan_step(
                model, params, optimizer, aug_cfg_dev, **kw)
        elif dp_G > 1:
            from deepgraphpose_tpu_torch.parallel.train_dp import \
                make_dp_pooled_dgp_train_step

            pooled_step = make_dp_pooled_dgp_train_step(
                model, params, optimizer, group, aug_cfg_dev, **kw)
        else:
            factory = (dd.make_pooled_dgp_scan_step if scan_k
                       else dd.make_pooled_dgp_train_step)
            pooled_step = factory(model, params, optimizer, aug_cfg_dev,
                                  **kw)
        extras = ((", on-device augmentation" if aug_cfg_dev else "")
                  + (", on-device LK flow" if flow_on_device else "")
                  + (f", data-parallel x{n_dp} devices x {wpd} windows "
                     f"= {dp_G} windows/update" if dp_G > 1 else "")
                  + (f", scan superstep K={scan_k}" if scan_k else ""))
    if use_pool:
        pools = [dd.FramePool(d, device) for d in mds.datasets]
        total_mb = sum(p.nbytes for p in pools) / 1e6
        print(f"step {step}: device-resident frame pools "
              f"({total_mb:.0f} MB in device memory)" + extras)
    elif use_spill:
        spill_pools, spill_runs = spill_plan
        live = [p for p in spill_pools if p is not None]
        print(f"step {step}: segment-rotating frame pools "
              f"({est / 1e9:.1f} GB over "
              f"{sum(p.n_segments for p in live)} segments, <= 2 x "
              f"{max(p.nbytes for p in live) / 1e6:.0f} MB resident)"
              + extras)
    else:
        _no_superstep(scan_iters, name)
        train_step = steps_lib.make_dgp_train_step(
            model, params, optimizer, visible_only=visible_only,
            bn_train=bn_train)

    def split_window(ds_i, frames):
        """(vis, hid) frame numbers with the visible-frame anchor rule
        (ref: fitdgp.py:755-758)."""
        d = mds.datasets[ds_i]
        vis_set = set(int(f) for f in d.visible_frames)
        vis = np.array([f for f in frames if int(f) in vis_set], np.int64)
        hid = np.array([f for f in frames if int(f) not in vis_set],
                       np.int64)
        if vis.size == 0 and len(d.visible_frames) > 0:
            vis = np.array([d.visible_frames[
                rng.integers(len(d.visible_frames))]])
        return vis, hid

    log = _Log(name, train_dir, step, n_iters, displayiters, save_every,
               "total_loss_visible" if visible_only else "total_loss",
               cfg.max_to_keep, tb_log, debug, group=group)

    def window_inputs(ds_i, windows, slots):
        """The pool rows (G', T) and stacked DGPBatch arrays of the windows
        at ``slots``; every window passes the anchor rule, so the host
        stream stays the same on every rank."""
        rows, batches = [], []
        for j, frames in enumerate(windows):
            vis, hid = split_window(ds_i, frames)
            if j in slots:
                b = assemble_batch(mds.datasets[ds_i], vis, hid,
                                   pad_to=pad_to, wt=cfg.wt,
                                   with_images=False)
                rows.append(pools[ds_i].rows(b.frames))
                batches.append(b.as_np())
        return np.stack(rows), {k: np.stack([x[k] for x in batches])
                                for k in batches[0]}

    generator = torch.Generator(device).manual_seed(seed + 2)
    if dp_G > 1:
        # G windows an update: each window slot draws from its own
        # generator, so the layout does not change the draws
        groups = _group_schedule_dp(schedule, dp_G, rng)
        mine = group.shard(dp_G)
        slots = range(mine.start, mine.stop)
        generators = dd.window_generators(seed + 2, len(slots), device,
                                          first=mine.start)
        start_gi = -(-start_it // dp_G)  # resume at the first whole group
        if scan_k:
            for ds_i, a, b in dd.iter_group_scan_runs(
                    [g[0] for g in groups], start_gi, save_every, dp_G,
                    scan_k):
                inputs = [window_inputs(ds_i, groups[gi][1], slots)
                          for gi in range(a, b)]
                batch = {k: host_to_device(np.stack([x[1][k]
                                                     for x in inputs]),
                                           device) for k in inputs[0][1]}
                outs = pooled_step(pools[ds_i].images,
                                   host_to_device(np.stack(
                                       [x[0] for x in inputs]), device),
                                   batch, generators)
                _log_chunk(log, [gi * dp_G for gi in range(a, b)], outs,
                           model, optimizer, dp_G)
        else:
            for gi in range(start_gi, len(groups)):
                ds_i, windows = groups[gi]
                rows, batch = window_inputs(ds_i, windows, slots)
                out = pooled_step(pools[ds_i].images,
                                  host_to_device(rows, device),
                                  {k: host_to_device(v, device)
                                   for k, v in batch.items()}, generators)
                log(gi * dp_G, out, model, optimizer, dp_G)
    elif scan_k:
        for ds_i, a, b in dd.iter_scan_runs(schedule, start_it, save_every,
                                            scan_k):
            rows, batches = [], []
            for it in range(a, b):
                vis, hid = split_window(ds_i, schedule[it][1])
                bb = assemble_batch(mds.datasets[ds_i], vis, hid,
                                    pad_to=pad_to, wt=cfg.wt,
                                    with_images=False)
                rows.append(pools[ds_i].rows(bb.frames))
                batches.append(bb.as_np())
            batch = {k: host_to_device(np.stack([x[k] for x in batches]),
                                       device) for k in batches[0]}
            outs = pooled_step(pools[ds_i].images,
                               host_to_device(np.stack(rows), device), batch,
                               generator)
            _log_chunk(log, range(a, b), outs, model, optimizer)
    elif use_pool:
        for it, (ds_i, frames) in enumerate(schedule):
            if it < start_it:
                continue
            vis, hid = split_window(ds_i, frames)
            b = assemble_batch(mds.datasets[ds_i], vis, hid, pad_to=pad_to,
                               wt=cfg.wt, with_images=False)
            rows = host_to_device(pools[ds_i].rows(b.frames), device)
            out = pooled_step(pools[ds_i].images, rows,
                              b.as_torch(device=device), generator)
            log(it, out, model, optimizer)
    elif use_spill:
        # ``it`` counts updates in the runs' order, as the JAX package's
        # spill loop does
        it = 0
        for ds_i, k, positions, segment in dd.iter_spill_segments(
                spill_pools, spill_runs, device):
            for pos in positions:
                if it >= start_it:
                    vis, hid = split_window(ds_i, schedule[pos][1])
                    b = assemble_batch(mds.datasets[ds_i], vis, hid,
                                       pad_to=pad_to, wt=cfg.wt,
                                       with_images=False)
                    rows = host_to_device(
                        spill_pools[ds_i].rows(b.frames, k), device)
                    out = pooled_step(segment, rows,
                                      b.as_torch(device=device), generator)
                    log(it, out, model, optimizer)
                it += 1
    else:
        def producer():
            for it, (ds_i, frames) in enumerate(schedule):
                if it < start_it:
                    continue
                vis, hid = split_window(ds_i, frames)
                batch = assemble_batch(mds.datasets[ds_i], vis, hid,
                                       pad_to=pad_to, wt=cfg.wt,
                                       compute_flow=cfg.wt > 0,
                                       augmenter=augmenter, rng=rng)
                yield it, batch

        # when wt == 0 the flow input is identically zero: make it once per
        # frame shape on the card and reuse it every iteration (full-res
        # (B-1, H, W) f32 is ~25 MB an iteration at the reference's batch)
        zero_flow: dict = {}

        def transfer(item):
            it, b = item
            flow = None
            if cfg.wt == 0:
                if b.flow.shape not in zero_flow:
                    zero_flow[b.flow.shape] = torch.zeros(b.flow.shape,
                                                          device=device)
                flow = zero_flow[b.flow.shape]
            return (it, host_to_device(b.images, device),
                    b.as_torch(flow=flow, device=device))

        pf = DevicePrefetcher(producer(), transfer, depth=2)
        try:
            for it, images, batch in pf:
                log(it, train_step(images, batch), model, optimizer)
        finally:
            pf.close()
    return log.finish(max(n_iters - 1, 0), model, optimizer)

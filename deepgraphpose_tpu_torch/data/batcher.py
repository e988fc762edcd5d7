"""Per-video datasets and the multi-video batcher (the port's own copy).

Mirrors the capability of the reference's Dataset / MultiDataset
(ref: src/deepgraphpose/dataset.py:305-821, 824-1036), as
``deepgraphpose_tpu/data/batcher.py`` does:

* Frames for the selected training set are decoded ONCE into an in-memory
  JPEG cache (the reference seeks the container per frame per iteration —
  SURVEY §3.2 hot-loop cost (b)).
* Batches are **fixed-size padded** tensors with masks, so every iteration
  has the same shapes (the reference feeds dynamic-length index lists).
* Scoremap dims come from a closed-form formula rather than a throwaway
  forward pass (ref: dataset.py:348-371 _compute_pred_dims).

Coordinate convention: labels are stored both as pixel (x, y) and as
scoremap (row, col) = ((y - stride/2)/stride, (x - stride/2)/stride)
(ref: dataset.py:651-652).
"""

from __future__ import annotations

import random as py_random
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from deepgraphpose_tpu_torch.core.config import PoseConfig, ProjectConfig
from deepgraphpose_tpu_torch.core import paths as paths_lib
from deepgraphpose_tpu_torch.core.device import resolve_device
from deepgraphpose_tpu_torch.data import project as project_io
from deepgraphpose_tpu_torch.data.hidden import (hidden_frames_for_video,
                                                 neighboring_window)
from deepgraphpose_tpu_torch.data.prefetch import host_to_device
from deepgraphpose_tpu_torch.data.video import FrameCache, VideoReader
from deepgraphpose_tpu_torch.models.pose_model import scoremap_size


def xy_to_scoremap(coords_xy: np.ndarray, stride: float) -> np.ndarray:
    """(x, y) pixel -> (row, col) scoremap space (ref: dataset.py:651-652)."""
    rc = np.empty_like(coords_xy)
    rc[..., 0] = (coords_xy[..., 1] - stride / 2.0) / stride
    rc[..., 1] = (coords_xy[..., 0] - stride / 2.0) / stride
    return rc


def scoremap_to_xy(coords_rc: np.ndarray, stride: float) -> np.ndarray:
    xy = np.empty_like(coords_rc)
    xy[..., 0] = coords_rc[..., 1] * stride + stride / 2.0
    xy[..., 1] = coords_rc[..., 0] * stride + stride / 2.0
    return xy


class VideoDataset:
    """One video: frames, labels, hidden-frame selection, frame cache."""

    def __init__(self, video_path: str | Path, cfg: PoseConfig,
                 labels: project_io.Labels | None, train_frame_indices,
                 ns: int = 10, n_max_frames: int = 2000,
                 cache_dir: str | Path | None = None,
                 jpeg_cache: bool = True):
        self.video_path = Path(video_path)
        self.video_name = self.video_path.stem
        self.cfg = cfg
        self.nj = cfg.num_joints
        self.ns = ns

        self.reader = VideoReader(video_path)
        self.n_frames = self.reader.n_frames
        self.nx_in, self.ny_in = self.reader.height, self.reader.width
        self.nx_out, self.ny_out = scoremap_size(cfg, (self.nx_in, self.ny_in))

        # visible (labeled, in-train-split) frames + their coords
        if labels is not None:
            frame_idx = labels.frame_indices
            train_set = set(int(i) for i in np.asarray(train_frame_indices))
            keep = [k for k, fi in enumerate(frame_idx)
                    if int(fi) in train_set and fi < self.n_frames]
            self.visible_frames = frame_idx[keep].astype(np.int64)
            order = np.argsort(self.visible_frames)
            self.visible_frames = self.visible_frames[order]
            coords = labels.coords_xy[keep][order]
        else:
            self.visible_frames = np.empty(0, dtype=np.int64)
            coords = np.zeros((0, self.nj, 2))
        self.labels_xy = coords                       # (nv, nj, 2) pixel x,y
        self.labels_rc = xy_to_scoremap(coords, cfg.stride)

        # hidden frame selection by motion energy
        if self.n_frames > len(self.visible_frames):
            self.hidden_frames = hidden_frames_for_video(
                video_path, self.visible_frames, self.n_frames, ns,
                n_max_frames, cache_dir=cache_dir)
        else:
            self.hidden_frames = np.empty(0, dtype=np.int64)

        # chunk: visible + hidden + windows, with adaptive window size
        # (ref: dataset.py:688-697 create_batches_from_resnet_output)
        anchors = np.concatenate([self.visible_frames, self.hidden_frames])
        if anchors.size:
            ns_new = int(min(ns, np.ceil(n_max_frames / len(anchors) / 2)))
            self.chunk = neighboring_window(anchors, ns_new, self.n_frames)
        else:
            self.chunk = np.empty(0, dtype=np.int64)

        self._label_by_frame = {int(f): i for i, f in
                                enumerate(self.visible_frames)}
        self.global_offset = 0

        self.cache = None
        if jpeg_cache and self.chunk.size:
            self.cache = FrameCache(self.reader, self.chunk)

    # -- frame access --------------------------------------------------
    def get_frames(self, indices) -> np.ndarray:
        if self.cache is not None:
            return self.cache.get_batch(indices)
        return self.reader.read_frames(indices)

    def labels_rc_for_frames(self, frames) -> tuple[np.ndarray, np.ndarray]:
        """(coords_rc, is_visible) for the given frame numbers.

        coords are NaN for non-visible frames; is_visible marks frames that
        carry labels (NaN joints inside a visible frame stay NaN and become
        hidden markers downstream, ref: fitdgp_util.py:77-101).
        """
        t = len(frames)
        rc = np.full((t, self.nj, 2), np.nan, dtype=np.float32)
        vis = np.zeros(t, dtype=bool)
        for k, f in enumerate(frames):
            i = self._label_by_frame.get(int(f))
            if i is not None:
                rc[k] = self.labels_rc[i]
                vis[k] = True
        return rc, vis


@dataclass
class DGPBatch:
    """Fixed-size padded batch for the DGP objective (all numpy)."""

    images: np.ndarray        # (B, H_in, W_in, 3) uint8
    targets: np.ndarray       # (B, nj, 2) scoremap (row, col); NaN -> 0
    visible_mask: np.ndarray  # (B*nj,)
    hidden_mask: np.ndarray   # (B*nj,)
    frame_mask: np.ndarray    # (B,)
    wt_batch: np.ndarray      # (B-1,)
    pair_mask: np.ndarray     # (B-1,)
    flow: np.ndarray          # (B-1, H_in, W_in) float32
    frames: np.ndarray        # (B,) source frame numbers (-1 for padding)
    dataset_index: int = 0

    def as_np(self) -> dict:
        """Host-side dict with the keys and dtypes of :meth:`as_torch`."""
        return dict(
            targets=np.nan_to_num(self.targets),
            visible_mask=self.visible_mask,
            hidden_mask=self.hidden_mask,
            frame_mask=self.frame_mask,
            wt_batch=self.wt_batch,
            pair_mask=self.pair_mask,
            flow=self.flow,
        )

    def as_torch(self, flow=None, device=None) -> dict:
        """Tensor dict for the DGP step, on ``device`` (default: the card).

        To the card each array goes through pinned memory with a
        non-blocking copy (``data/prefetch.py``). ``flow`` substitutes a
        flow tensor already on the device: a trainer reuses one zeros
        buffer when wt == 0, so the full-res (B-1, H, W) zeros are not
        copied every iteration.
        """
        dev = resolve_device(device)
        arrays = self.as_np()
        if flow is not None:
            del arrays["flow"]
        d = {k: host_to_device(v, dev) for k, v in arrays.items()}
        if flow is not None:
            d["flow"] = flow
        return d


def assemble_batch(ds: VideoDataset, vis_idx, hid_idx, pad_to: int,
                   wt: float = 0.0, compute_flow: bool = False,
                   augmenter=None, rng=None,
                   with_images: bool = True) -> DGPBatch:
    """Build a fixed-size batch from visible+hidden frame indices.

    Mirrors the reference's per-iteration assembly (ref: fitdgp.py:751-815)
    with padding to ``pad_to`` frames (repeat-last, masked out).

    ``with_images=False`` skips frame decode and augmentation and returns a
    1x1 image placeholder, for a trainer that keeps the frames on the device
    and assembles only the small label/mask tensors on the host.
    """
    frames = np.sort(np.concatenate([np.asarray(vis_idx, np.int64),
                                     np.asarray(hid_idx, np.int64)]))
    t_real = len(frames)
    if t_real == 0:
        raise ValueError("empty batch")
    if t_real > pad_to:
        raise ValueError(f"batch of {t_real} frames exceeds pad_to={pad_to}")

    # images stay uint8 end-to-end: the model subtracts the mean pixel on
    # the device, and a uint8 copy to the card is 4x smaller than f32
    if with_images:
        images = ds.get_frames(frames)
    else:
        images = np.zeros((t_real, 1, 1, 3), np.uint8)
        augmenter = None
    rc, frame_visible = ds.labels_rc_for_frames(frames)
    vis_set = set(int(i) for i in np.asarray(vis_idx))
    frame_visible = np.array([int(f) in vis_set for f in frames]) & frame_visible

    if augmenter is not None and frame_visible.any():
        images, rc = augmenter(images.astype(np.float32), rc, frame_visible,
                               ds.cfg, rng=rng)
        images = np.clip(images, 0, 255).astype(np.uint8)

    nj = ds.nj
    # marker masks: visible = labeled frame & not NaN; hidden = everything else
    not_nan = ~np.isnan(rc[..., 0])
    visible_m = (frame_visible[:, None] & not_nan)
    hidden_m = ~visible_m

    # pad to static shape
    pad = pad_to - t_real
    if pad:
        images = np.concatenate([images, np.repeat(images[-1:], pad, 0)])
        rc = np.concatenate([rc, np.zeros((pad, nj, 2), rc.dtype)])
        visible_m = np.concatenate([visible_m, np.zeros((pad, nj), bool)])
        hidden_m = np.concatenate([hidden_m, np.zeros((pad, nj), bool)])
    frame_mask = np.zeros(pad_to, np.float32)
    frame_mask[:t_real] = 1.0

    pair_mask = np.zeros(pad_to - 1, np.float32)
    d = np.diff(frames)
    pair_mask[:t_real - 1] = (d == 1).astype(np.float32)
    wt_batch = np.full(pad_to - 1, wt, np.float32)

    if compute_flow and wt > 0:
        from deepgraphpose_tpu_torch.data.flow import flow_magnitude_sequence

        flow = flow_magnitude_sequence(images[:t_real])
        if pad:
            flow = np.concatenate(
                [flow, np.zeros((pad, *flow.shape[1:]), flow.dtype)])
    else:
        flow = np.zeros((pad_to - 1, images.shape[1], images.shape[2]),
                        np.float32)

    frames_out = np.concatenate(
        [frames, -np.ones(pad, np.int64)]) if pad else frames
    return DGPBatch(
        images=images,
        targets=rc.astype(np.float32),
        visible_mask=visible_m.reshape(-1).astype(np.float32),
        hidden_mask=hidden_m.reshape(-1).astype(np.float32),
        frame_mask=frame_mask,
        wt_batch=wt_batch,
        pair_mask=pair_mask,
        flow=flow[:pad_to - 1] if flow.shape[0] >= pad_to - 1 else np.concatenate(
            [flow, np.zeros((pad_to - 1 - flow.shape[0], *flow.shape[1:]),
                            flow.dtype)]),
        frames=frames_out,
    )


def generate_batch_schedule(visible_per_ds, hidden_per_ds, chunk_per_ds,
                            batch_size: int, n_times_all_frames: int,
                            maxiters: int, seed: int | None = None) -> list:
    """Precomputed schedule of contiguous windows over selected frames.

    ref: fitdgp_util.py:146-202 (gen_batch) — per video, sample windows of
    ``batch_size`` consecutive entries of the sorted selected-frame array,
    then shuffle across videos. Each entry: (dataset_idx, frame_numbers).
    """
    rng = np.random.default_rng(seed)
    n_frames_total = sum(len(c) for c in chunk_per_ds)
    n_datasets = len(chunk_per_ds)
    nepoch = min(int(n_frames_total * n_times_all_frames / max(batch_size, 1)),
                 maxiters)

    schedule = []
    for i in range(n_datasets):
        index_all = np.unique(np.concatenate([
            np.asarray(visible_per_ds[i], np.int64),
            np.asarray(chunk_per_ds[i], np.int64),
            np.asarray(hidden_per_ds[i], np.int64)]))
        if index_all.size == 0:
            continue
        n_i = max(1, int(nepoch / max(n_frames_total, 1) * len(index_all)))
        bs = batch_size
        if len(index_all) < bs:
            starts = rng.integers(0, len(index_all), size=n_i)
            bs = 1
        else:
            starts = rng.integers(0, len(index_all) - bs, size=n_i)
        for s in starts:
            schedule.append((i, index_all[s:s + bs].copy()))
    py_random.Random(seed).shuffle(schedule)
    return schedule


class MultiDataset:
    """Multi-video container (ref: dataset.py:824-1036)."""

    def __init__(self, project_cfg: ProjectConfig, pose_cfg: PoseConfig,
                 video_sets: list, ns: int = 10, n_max_frames: int = 2000,
                 cache_dir: str | Path | None = None, jpeg_cache: bool = True):
        self.project_cfg = project_cfg
        self.pose_cfg = pose_cfg
        self.nj = pose_cfg.num_joints
        self.datasets: list[VideoDataset] = []

        project_path = Path(project_cfg.project_path)
        for video in video_sets:
            video = Path(video)
            if not video.is_absolute():
                video = project_path / video
            labeled_dir = paths_lib.labeled_data_dir(project_path, video.stem)
            labels = None
            train_idx: np.ndarray = np.empty(0, np.int64)
            if labeled_dir.exists():
                try:
                    labels = project_io.read_labels(labeled_dir,
                                                    project_cfg.scorer)
                    train_idx = labels.frame_indices
                except FileNotFoundError:
                    labels = None
            self.datasets.append(VideoDataset(
                video, pose_cfg, labels, train_idx, ns=ns,
                n_max_frames=n_max_frames, cache_dir=cache_dir,
                jpeg_cache=jpeg_cache))

        counts = np.array([len(d.visible_frames) for d in self.datasets],
                          np.float64)
        self.batch_ratios = counts / max(counts.sum(), 1)

        self.n_visible_frames_total = int(
            sum(len(d.visible_frames) for d in self.datasets))
        self.n_hidden_frames_selected = int(
            sum(len(d.hidden_frames) for d in self.datasets))
        offset = 0
        for d in self.datasets:
            d.global_offset = offset
            offset += len(d.chunk)
        self.n_frames_total = offset  # visible + hidden + windows

    @property
    def n_hidden_frames_total(self) -> int:
        """Population hidden count used in the loss: chunk minus visible
        (ref: fitdgp.py:871-872 uses n_frames_total - n_visible_total)."""
        return self.n_frames_total - self.n_visible_frames_total

    def restrict_train_split(self, video_name: str, train_frame_numbers):
        """Re-filter a video's visible frames to the official train split
        (from the training .mat), keeping label bookkeeping consistent."""
        for d in self.datasets:
            if d.video_name == video_name:
                keep = np.isin(d.visible_frames, np.asarray(train_frame_numbers))
                d.visible_frames = d.visible_frames[keep]
                d.labels_xy = d.labels_xy[keep]
                d.labels_rc = d.labels_rc[keep]
                d._label_by_frame = {
                    int(f): i for i, f in enumerate(d.visible_frames)}

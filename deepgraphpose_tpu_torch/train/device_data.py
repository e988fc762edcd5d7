"""Device-resident training-data pools and the pooled train steps.

The port's own copy of ``deepgraphpose_tpu/train/device_data.py:41-206,
372-522``. The training sets are small enough to live in device memory
outright (a labeled set of canvases; a DGP video's frame pool, capped at
``n_max_frames``), so:

* the whole labeled image set (step 0) / per-video frame pool (steps 1-2)
  is copied to the card ONCE as uint8;
* every iteration sends only row indices and the small label tensors;
* the batch is gathered on the card inside the train step and augmented
  there (``ops/augment_device.py``), so augmentation stops being host
  work on the critical path.

Pools larger than the budget, the spill tier between them and the host
feed (``SegmentedFramePool``), the ``lax.scan`` superstep and the
multi-window group steps wait for ROADMAP item 12b; the fit loops raise
for them. The temporal clique's host-side flow (wt > 0) keeps the host
feed (ref: fitdgp_util.py:454-467).
"""

from __future__ import annotations

import numpy as np
import torch

from deepgraphpose_tpu_torch.core.config import PoseConfig
from deepgraphpose_tpu_torch.data.prefetch import host_to_device
from deepgraphpose_tpu_torch.ops.augment_device import (DeviceAugmentConfig,
                                                        augment_batch)
from deepgraphpose_tpu_torch.ops.dgp_objective import DGPLossParams, dgp_loss
from deepgraphpose_tpu_torch.train.steps import (_device, _update,
                                                 dlc_supervised_loss)

# pools larger than this stay off the card: the JAX package's budget (16 GB
# v5e), kept so that both packages choose the same path for one project
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


def resolve_scan_iters(scan_iters) -> int:
    """A fit API ``scan_iters`` argument as a chunk length K (0 = off).

    ``None`` is auto: the JAX package scans 20 updates a dispatch on a TPU
    only, and the port runs on no TPU, so auto is off."""
    if scan_iters is None:
        return 0
    k = int(scan_iters)
    return k if k > 1 else 0


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


def make_pooled_dgp_train_step(model, params_obj: DGPLossParams, optimizer,
                               aug_cfg: DeviceAugmentConfig | None,
                               visible_only: bool = False,
                               bn_train: bool = False):
    """DGP train step that gathers its window from a :class:`FramePool`:

    ``step(pool_images, rows, batch, generator)`` -> loss dict, updating
    ``model`` and ``optimizer`` in place. ``rows`` are the window's pool
    rows on the card; ``batch`` is ``DGPBatch.as_torch()``'s dict of the
    window's labels and masks (its images are not used); see
    :func:`augment_dgp_window` for the augmentation. On the card the
    objective decodes on the CUDA kernel, as in ``train/steps.py``.
    """
    key = "total_loss_visible" if visible_only else "total_loss"
    params_obj = params_obj.to(_device(model))
    stride, nj = params_obj.stride, params_obj.nj

    def step(pool_images: torch.Tensor, rows: torch.Tensor, batch: dict,
             generator: torch.Generator) -> dict:
        images = pool_images.index_select(0, rows)
        if aug_cfg is not None:
            images, batch = augment_dgp_window(generator, images, batch,
                                               aug_cfg, stride, nj)
        heads = model(images, train=bn_train)
        out = dgp_loss(heads["part_pred"], heads["locref"], batch, params_obj)
        _update(optimizer, out[key])
        return {k: v.detach() for k, v in out.items()}

    return step

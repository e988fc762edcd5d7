"""Data-parallel DGP training over a data group, in PyTorch.

The port's own copy of ``deepgraphpose_tpu/parallel/train_dp.py``. The
unit of data parallelism is one DGP window (a contiguous batch of frames
of one video). A global batch of G windows gives each of the group's
ranks G / world of them; each rank evaluates the masked DGP objective on
its windows (temporal pairs never cross a window, so training needs no
halo) and takes the mean; the gradients are averaged over the ranks in
one ``all_reduce`` a dtype, and every rank applies the same
``ClippedSGD`` update. As every rank holds as many windows, that is the
gradient of the global mean, as XLA computes it from the JAX package's
``NamedSharding``. The steps are plain functions, not DDP: the superstep's
CUDA-graph capture and the explicit generators need the update to stay
one.

Each step updates the model and the optimizer in place and returns the
loss terms, the global batch's, on every rank.
"""

from __future__ import annotations

import torch

from deepgraphpose_tpu_torch.core.config import PoseConfig
from deepgraphpose_tpu_torch.models.resnet import BatchStats
from deepgraphpose_tpu_torch.ops.augment_device import (DeviceAugmentConfig,
                                                        augment_batch)
from deepgraphpose_tpu_torch.ops.dgp_objective import (  # noqa: F401
    DGPLossParams, dgp_loss)
from deepgraphpose_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS, DataGroup)
from deepgraphpose_tpu_torch.train import device_data as dd
from deepgraphpose_tpu_torch.train.steps import _device, dlc_supervised_loss


def make_dp_dgp_train_step(model, params_obj: DGPLossParams, optimizer,
                           group: DataGroup, visible_only: bool = False):
    """The host-fed DP step: ``step(images (Gl, T, H, W, 3), batch (every
    DGPBatch tensor Gl-leading))`` -> the loss terms, ``Gl`` this rank's
    windows of the global batch."""
    key = "total_loss_visible" if visible_only else "total_loss"
    dev = _device(model)
    params_obj = params_obj.to(dev)

    def step(images: torch.Tensor, batch: dict) -> dict:
        images = images.to(dev, non_blocking=True)
        batch = {k: v.to(dev, non_blocking=True) for k, v in batch.items()}
        batches = [{k: v[g] for k, v in batch.items()}
                   for g in range(images.shape[0])]
        return dd.group_update(model, params_obj, optimizer, group,
                               images.flatten(0, 1), batches, key, False)

    return step


def make_dp_pooled_dgp_train_step(model, params_obj: DGPLossParams,
                                  optimizer, group: DataGroup,
                                  aug_cfg: DeviceAugmentConfig | None = None,
                                  visible_only: bool = False,
                                  bn_train: bool = False,
                                  device_flow: bool = False):
    """The DP step over a frame pool that every rank holds whole: the
    per-step traffic is each window's rows and the small label tensors.

    ``step(pool_images, rows (Gl, T), batch (Gl-leading), generators
    (Gl))`` -> the loss terms; ``generators`` are this rank's window
    slots' (``device_data.window_generators``), so the draws do not depend
    on the layout. ``bn_train=True`` normalizes each window by its own
    statistics and the moving stats become the mean over all G windows of
    each one's update; ``device_flow=True`` makes each window's temporal
    clique flow on the device, and then ``aug_cfg`` must be None, as in the
    single-device step (ref gate: fitdgp.py:777-779)."""
    if device_flow and aug_cfg is not None:
        raise ValueError("make_dp_pooled_dgp_train_step: aug_cfg must be "
                         "None when device_flow=True (flow needs "
                         "unaugmented, temporally coherent frames)")
    return dd._make_dgp_group_pool_body(model, params_obj, optimizer,
                                        aug_cfg, visible_only, bn_train,
                                        device_flow, group)


def make_dp_pooled_dlc_train_step(model, cfg: PoseConfig, optimizer,
                                  group: DataGroup,
                                  aug_cfg: DeviceAugmentConfig | None = None,
                                  bn_train: bool = False):
    """The DP step-0 step over a labeled-image pool that every rank holds
    whole: the same objective as one device with the global batch.

    ``step(pool, idxs (G * bs,), generator)`` -> the loss terms. Each rank
    takes its contiguous slice of ``idxs``. ``generator`` has the same
    state on every rank: each augments the global batch, as the JAX
    package's one key over the global batch does, and keeps its slice
    (the augmentation's resampling is a matrix product whose rounding
    follows its batch, so a slice augmented alone would part from one
    device's batch). The loss's sums and counts and, with ``bn_train``,
    the batch-norm statistics are the global batch's (a differentiable sum
    over the ranks), so every rank's moving stats take the same update."""
    all_sum = group.all_sum if group.world > 1 else None
    train = (BatchStats(all_sum=all_sum, world=group.world)
             if bn_train else False)

    def step(pool: dd.LabeledImagePool, idxs: torch.Tensor,
             generator: torch.Generator) -> dict:
        sl = group.shard(idxs.shape[0])
        if aug_cfg is not None:
            images, coords, present = augment_batch(
                generator, pool.images.index_select(0, idxs),
                pool.coords.index_select(0, idxs),
                pool.present.index_select(0, idxs), aug_cfg,
                content_wh=pool.content_wh.index_select(0, idxs))
            images, coords, present = images[sl], coords[sl], present[sl]
        else:
            local = idxs[sl]
            images = pool.images.index_select(0, local)
            coords = pool.coords.index_select(0, local)
            present = pool.present.index_select(0, local)
        heads = model(images, train=train)
        out = dlc_supervised_loss(heads, coords, present, cfg,
                                  all_sum=all_sum)
        optimizer.zero_grad(set_to_none=True)
        out["total_loss"].backward()
        group.all_reduce_mean_([p.grad for p in model.parameters()
                                if p.grad is not None])
        optimizer.step()
        return {k: v.detach() for k, v in out.items()}

    return step


def make_dp_infer_fn(model, cfg: PoseConfig, group: DataGroup):
    """Batched inference with the frames spread over the ranks:
    ``fn(frames (T, H, W, 3) uint8)`` -> (mu (T, nj, 2), likelihood
    (T, nj)) on every rank. Each rank decodes its contiguous slice (the
    decode couples no frames) and the slices are gathered back."""
    from deepgraphpose_tpu_torch.infer.predict import infer_forward

    def fn(frames: torch.Tensor):
        mu, lik = infer_forward(model, cfg,
                                frames[group.shard(frames.shape[0])]
                                .to(group.device))
        both = group.all_gather(torch.cat([mu, lik[..., None]], -1))
        return both[..., :2], both[..., 2]

    return fn

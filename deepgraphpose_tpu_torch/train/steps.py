"""Train-step factories, in PyTorch.

The port's own copy of ``deepgraphpose_tpu/train/steps.py``. A step runs
the forward, the objective (target rasterization included), the backward
and the optimizer update on the model's device, and updates the model's
parameters, its batch-norm buffers and the optimizer's state in place (the
JAX package donates those buffers to its jitted step instead). It returns
the loss dict as 0-d tensors and never reads them itself, so no step waits
for the card.

Optimizer: the optax chain of the reference, global-norm clip first, then
SGD with momentum 0.9 (ref: train.py:94-113 get_optimizer,
fitdgp.py:709-713). The reference defines slim L2 regularizers but never
adds them to the optimized loss (pose_net.py:194), so there is no weight
decay.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable

import torch

from deepgraphpose_tpu_torch.core.config import PoseConfig
from deepgraphpose_tpu_torch.ops import losses as losses_ops
from deepgraphpose_tpu_torch.ops import targets as targets_ops
from deepgraphpose_tpu_torch.ops.dgp_objective import DGPLossParams, dgp_loss


class ClippedSGD(torch.optim.SGD):
    """``optax.chain(clip_by_global_norm(clip_norm), sgd(lr, momentum))``.

    * The clip is optax's: every gradient becomes ``g / norm * clip_norm``
      when the global norm reaches ``clip_norm`` (``clip_grad_norm_``
      would add 1e-6 to the norm). It is decided on the device, so it never
      waits for the card.
    * The momentum trace is ``trace = g + momentum * trace`` from a zero
      trace, and the update ``p + (-lr) * trace``, as ``optax.sgd`` and
      ``optax.apply_updates`` compute them (rounded once, as XLA fuses
      them).
    * A callable ``lr`` is a schedule of ``count``, the number of updates
      done before this one (optax's count).
    * The rate is a device scalar, ``neg_lr`` (-lr, in the parameters'
      dtype), written before each update (``write_rate``), so an update
      captured in a CUDA graph reads the rate of each replay
      (``train/device_data.py``). Inside :meth:`capturing` a step records
      only the device work; the caller writes each replay's rate and
      advances ``count``.
    """

    def __init__(self, params, lr: float | Callable, momentum: float = 0.9,
                 clip_norm: float | None = None):
        self.schedule = lr if callable(lr) else None
        super().__init__(params, lr=self.schedule(0) if self.schedule
                         else lr, momentum=momentum)
        self.clip_norm = clip_norm
        self.count = 0
        self.neg_lr = None
        self._written = None
        self._capturing = False

    def rate(self) -> float:
        """The rate of the next update."""
        return (self.schedule(self.count) if self.schedule is not None
                else self.param_groups[0]["lr"])

    @torch.no_grad()
    def write_rate(self) -> None:
        """Write the next update's rate into ``neg_lr`` (a fill on the
        device, made only when the rate changes)."""
        rate = self.rate()
        if self.neg_lr is None:
            p = self.param_groups[0]["params"][0]
            self.neg_lr = torch.zeros((), dtype=p.dtype, device=p.device)
        if rate != self._written:
            self.neg_lr.fill_(-rate)
            self._written = rate
        for group in self.param_groups:
            group["lr"] = rate

    @contextlib.contextmanager
    def capturing(self):
        """While a CUDA graph captures an update."""
        self._capturing = True
        try:
            yield
        finally:
            self._capturing = False

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("ClippedSGD takes no closure")
        if not self._capturing:
            self.write_rate()
        params = [p for group in self.param_groups for p in group["params"]
                  if p.grad is not None]
        grads = [p.grad for p in params]
        if self.clip_norm is not None:
            norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
            keep = norm < self.clip_norm
            for g in grads:
                g.copy_(torch.where(keep, g, g / norm * self.clip_norm))
        traces = []
        for p in params:
            state = self.state[p]
            if state.get("momentum_buffer") is None:
                state["momentum_buffer"] = torch.zeros_like(p)
            traces.append(state["momentum_buffer"])
        torch._foreach_mul_(traces, self.param_groups[0]["momentum"])
        torch._foreach_add_(traces, grads)
        # one rounding, p + (-lr) * trace, as XLA fuses optax's update
        torch._foreach_addcmul_(params, traces, [self.neg_lr] * len(params))
        if not self._capturing:
            self.count += 1


def make_optimizer(params, lr: float | Callable, momentum: float = 0.9,
                   clip_norm: float | None = None) -> ClippedSGD:
    """The reference's optimizer over ``params`` (a torch optimizer binds
    its parameters where the optax transform is applied to them)."""
    return ClippedSGD(params, lr, momentum, clip_norm)


def piecewise_lr(multi_step: list) -> Callable[[int], float]:
    """DLC multi_step schedule: [[lr, until_iter], ...]
    (ref: train.py:34-44 LearningRate). The rate of the first entry whose
    bound exceeds ``count``, else the last rate."""
    rates = [float(lr) for lr, _ in multi_step]
    bounds = [int(until) for _, until in multi_step]

    def schedule(count: int) -> float:
        for rate, bound in zip(rates, bounds):
            if count < bound:
                return rate
        return rates[-1]

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Callable[[int], float]:
    """optax's ``cosine_decay_schedule``: ``init_value`` times
    ``(1 - alpha) * 0.5 * (1 + cos(pi * min(count, decay_steps) /
    decay_steps)) + alpha``; fit_dgp's ``lr_decay`` (fit.py:879-886)."""
    if decay_steps <= 0:
        raise ValueError(f"decay_steps must be positive, got {decay_steps}")

    def schedule(count: int) -> float:
        frac = min(count, decay_steps) / decay_steps
        cosine = 0.5 * (1.0 + math.cos(math.pi * frac))
        return init_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def dlc_supervised_loss(heads: dict, coords_xy: torch.Tensor,
                        present: torch.Tensor, cfg: PoseConfig,
                        scale: torch.Tensor | float = 1.0,
                        all_sum=None) -> dict:
    """Plain DLC loss: scoremap sigmoid CE + locref Huber.

    ref: pose_net.py:165-196 (train). Targets are rasterized on the device
    from pixel coords (already in input-image space, i.e. post
    global_scale). ``all_sum`` (a data group's differentiable sum over its
    ranks) makes each term the global batch's, as one device with the
    whole batch computes it (``parallel/train_dp.py``).
    """
    pred = heads["part_pred"]
    t, h, w, nj = pred.shape
    scmap, locref_map, locref_mask = targets_ops.dlc_scoremap_targets(
        coords_xy, present, h, w, cfg.stride, cfg.pos_dist_thresh,
        cfg.locref_stdev, scale=scale)
    out = {}
    out["part_loss"] = losses_ops.sigmoid_cross_entropy(scmap, pred,
                                                        all_sum=all_sum)
    total = out["part_loss"]
    if cfg.intermediate_supervision and "part_pred_interm" in heads:
        out["part_loss_interm"] = losses_ops.sigmoid_cross_entropy(
            scmap, heads["part_pred_interm"], all_sum=all_sum)
        total = total + out["part_loss_interm"]
    if cfg.location_refinement:
        if cfg.locref_huber_loss:
            out["locref_loss"] = cfg.locref_loss_weight * losses_ops.huber_loss(
                locref_map, heads["locref"], locref_mask, all_sum=all_sum)
        else:
            out["locref_loss"] = cfg.locref_loss_weight * losses_ops.mse_loss(
                locref_map, heads["locref"], locref_mask, all_sum=all_sum)
        total = total + out["locref_loss"]
    out["total_loss"] = total
    return out


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _update(optimizer: torch.optim.Optimizer, loss: torch.Tensor) -> None:
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()


def make_dlc_train_step(model, cfg: PoseConfig, optimizer: ClippedSGD,
                        bn_train: bool = False):
    """Supervised (step-0) train step: ``step(images, coords_xy, present)``
    -> loss dict, updating ``model`` and ``optimizer`` in place.

    images: (T, H, W, 3) uint8 or float; coords_xy: (T, nj, 2) pixel
    (x, y), NaN where absent; present: (T, nj). Inputs move to the model's
    device. ``bn_train=True`` normalizes by batch statistics and updates
    the moving stats each step, the from-scratch mode (the reference always
    trains with frozen BN from an ImageNet warm start, ref: pose_net.py:52).
    """
    dev = _device(model)

    def step(images, coords_xy, present) -> dict:
        images = images.to(dev, non_blocking=True)
        heads = model(images, train=bn_train)
        out = dlc_supervised_loss(heads, coords_xy.to(dev, non_blocking=True),
                                  present.to(dev, non_blocking=True), cfg)
        _update(optimizer, out["total_loss"])
        return {k: v.detach() for k, v in out.items()}

    return step


def make_dgp_train_step(model, params_obj: DGPLossParams,
                        optimizer: ClippedSGD, visible_only: bool = False,
                        bn_train: bool = False):
    """DGP train step over a fixed-shape masked batch:
    ``step(images, batch)`` -> loss dict, updating ``model`` and
    ``optimizer`` in place.

    ``batch`` is ``DGPBatch.as_torch()``'s dict. visible_only=True
    optimizes ``total_loss_visible`` (step 1 semantics, ref:
    fitdgp.py:416); False optimizes the full objective (step 2).
    ``bn_train`` as in :func:`make_dlc_train_step`. On the card the
    objective's decode is the CUDA kernel (``ops/dgp_objective.py``).
    """
    key = "total_loss_visible" if visible_only else "total_loss"
    dev = _device(model)
    params_obj = params_obj.to(dev)

    def step(images, batch: dict) -> dict:
        images = images.to(dev, non_blocking=True)
        batch = {k: v.to(dev, non_blocking=True) for k, v in batch.items()}
        heads = model(images, train=bn_train)
        out = dgp_loss(heads["part_pred"], heads["locref"], batch, params_obj)
        _update(optimizer, out[key])
        return {k: v.detach() for k, v in out.items()}

    return step

"""Head-only training from precomputed backbone features.

The port's own copy of ``deepgraphpose_tpu/train/headonly.py``, the
working redesign of the reference's legacy ``preprocess/`` pipeline (dump
ResNet outputs for the labeled set, then fit the prediction layer on them;
ref: preprocess/get_morig_resnet_outputs.py,
preprocess/get_morig_prediction_layer.py). The frozen backbone forwards
once over the labeled pool, the features stay on the card, and every
update touches only the deconvolutional heads.

Because features are cached, augmentation and scale jitter are off by
construction, as in the reference pipeline (which dumped features of the
un-augmented labeled images).
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch
from torch import nn

from deepgraphpose_tpu_torch.core import checkpoint as ckpt_lib
from deepgraphpose_tpu_torch.core.config import PoseConfig
from deepgraphpose_tpu_torch.core.device import resolve_device
from deepgraphpose_tpu_torch.models.heads import PredictionHead
from deepgraphpose_tpu_torch.models.pose_model import (  # noqa: F401
    _nhwc_f32, init_model)
from deepgraphpose_tpu_torch.train import steps as steps_lib
from deepgraphpose_tpu_torch.train.steps import (  # noqa: F401
    dlc_supervised_loss)

# the PoseModel attributes (and snapshot subtrees) head-only training fits
HEAD_KEYS = ("part_pred", "locref_pred")


class HeadsModule(nn.Module):
    """The PoseModel heads alone, under the same attribute names, so their
    state drops straight back into the full model's.

    forward: NHWC backbone features -> {"part_pred"[, "locref"]} float32
    NHWC logits, the computation of ``PoseModel.forward``.
    """

    def __init__(self, cfg: PoseConfig, in_features: int,
                 dtype=torch.float32):
        super().__init__()
        nj, ds = cfg.num_joints, cfg.deconvolutionstride
        self.part_pred = PredictionHead(in_features, nj, ds, dtype)
        self.head_keys = ["part_pred"]
        if cfg.location_refinement:
            self.locref_pred = PredictionHead(in_features, 2 * nj, ds, dtype)
            self.head_keys.append("locref")

    def forward(self, features: torch.Tensor) -> dict:
        x = features.permute(0, 3, 1, 2)
        out = {"part_pred": _nhwc_f32(self.part_pred(x))}
        if "locref" in self.head_keys:
            out["locref"] = _nhwc_f32(self.locref_pred(x))
        return out


def head_state(model: nn.Module) -> dict:
    """The head tensors of ``model``'s state, under their full names."""
    return {k: v for k, v in model.state_dict().items()
            if k.split(".", 1)[0] in HEAD_KEYS}


@torch.no_grad()
def precompute_features(model, images: torch.Tensor,
                        chunk: int = 16) -> torch.Tensor:
    """Backbone features of an (N, H, W, 3) pool on the model's device, one
    forward of ``chunk`` images at a time (ref feature dump:
    preprocess/get_morig_resnet_outputs.py): (N, h', w', C) NHWC in the
    model's compute dtype."""
    outs = [model(images[i:i + chunk], heads=("features",))["features"]
            for i in range(0, images.shape[0], chunk)]
    return torch.cat(outs)


def fit_dlc_heads(dlcpath: str | Path = ".", shuffle: int = 1,
                  snapshot: str | None = None, maxiters: int = 5000,
                  displayiters: int = 500, saveiters: int = 0,
                  trainingsetindex: int = 0, seed: int = 0,
                  lr: float | None = None,
                  reinit_heads: bool = False,
                  debug: str = "_heads", device=None) -> Path:
    """Train ONLY the prediction heads on cached backbone features.

    Loads a warm start as ``fit_dlc`` does (``snapshot``, or the newest
    step-0 snapshot), forwards the labeled set through the frozen backbone
    once (float32, frozen batch-norm), then runs head-only supervised
    updates: SGD with momentum 0.9 at ``lr`` (default: the config's
    ``multi_step`` schedule), ``cfg.batch_size`` images a step drawn by
    ``np.random.default_rng(seed)``. The merged model (untouched backbone,
    trained heads) is saved as a step-0 snapshot with the suffix ``debug``
    (default ``"_heads"``: the bare step-0 names would overwrite the
    snapshots steps 1-2 and the evaluation read; pass ``debug=""`` to do
    that on purpose), in the JAX package's format.

    ``reinit_heads=True`` re-initialises the heads first (the reference
    pipeline's use: fit a fresh prediction layer on dumped features).
    ``device``: the card by default; raises without one unless it names the
    CPU.
    """
    from deepgraphpose_tpu_torch.models.pose_model import init_model
    from deepgraphpose_tpu_torch.train import device_data as dd
    from deepgraphpose_tpu_torch.train.fit import (_TrainLabeledImages,
                                                   _warm_start,
                                                   resolve_project)

    device = resolve_device(device)
    proj, cfg, train_dir = resolve_project(dlcpath, shuffle,
                                           trainingsetindex)
    data = _TrainLabeledImages(proj, cfg, dlcpath, jitter=False)
    model = init_model(cfg, torch.Generator().manual_seed(seed),
                       device=device)
    if snapshot is None:
        latest = ckpt_lib.latest_snapshot(train_dir, 0)
        if latest is not None:
            snapshot = latest.name[:-len(ckpt_lib.CKPT_SUFFIX)]
    model, warmed = _warm_start(model, cfg, Path(train_dir), snapshot)
    if not warmed:
        print("warning: fit_dlc_heads without a trained backbone — "
              "features of a random-init frozen backbone are weak; "
              "train or import a snapshot first")
    if reinit_heads:
        fresh = init_model(cfg, torch.Generator().manual_seed(seed + 1),
                           device=device)
        model.load_state_dict(head_state(fresh), strict=False)

    pool = dd.LabeledImagePool(data, cfg, device)
    t0 = time.time()
    feats = precompute_features(model, pool.images)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"fit_dlc_heads: cached {tuple(feats.shape)} backbone features "
          f"({feats.numel() * feats.element_size() / 1e6:.0f} MB in device "
          f"memory, {time.time() - t0:.1f}s); training heads only")

    heads = HeadsModule(cfg, feats.shape[-1]).to(device)
    heads.load_state_dict(head_state(model))
    optimizer = steps_lib.make_optimizer(
        heads.parameters(),
        lr if lr is not None else steps_lib.piecewise_lr(cfg.multi_step))

    def merged() -> nn.Module:
        model.load_state_dict(heads.state_dict(), strict=False)
        return model

    bs = max(int(cfg.batch_size), 1)
    rng = np.random.default_rng(seed)
    n = pool.n
    t0 = time.time()
    for it in range(maxiters):
        idxs = torch.from_numpy(rng.integers(0, n, size=bs)).to(device)
        out = steps_lib.dlc_supervised_loss(heads(feats[idxs]),
                                            pool.coords[idxs],
                                            pool.present[idxs], cfg)
        optimizer.zero_grad(set_to_none=True)
        out["total_loss"].backward()
        optimizer.step()
        if displayiters and it % displayiters == 0:
            print(f"[fit_dlc_heads] iter {it}/{maxiters} loss "
                  f"{float(out['total_loss'].detach()):.4f} "
                  f"({time.time() - t0:.1f}s)", flush=True)
        if saveiters and it > 0 and it % saveiters == 0:
            ckpt_lib.save_snapshot(train_dir, 0, it, merged(), None,
                                   cfg.max_to_keep, debug)
    return ckpt_lib.save_snapshot(train_dir, 0, "final--0", merged(), None,
                                  cfg.max_to_keep, debug)

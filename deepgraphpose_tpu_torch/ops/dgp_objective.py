"""The DeepGraphPose objective, in PyTorch.

The port's own copy of ``deepgraphpose_tpu/ops/dgp_objective.py``, the
semantics of the reference graph builder ``dgp_loss``
(ref: src/deepgraphpose/models/fitdgp.py:848-1144):

* every tensor has a static shape, and markers are selected with {0,1}
  masks instead of the reference's gathered index lists;
* Gaussian targets, locref targets and masks are rasterized on the device
  (ops/targets.py);
* optical-flow box means use summed-area tables (ops/cliques.py);
* the soft-argmax decode is ``softargmax_2d_cuda``: on a CUDA tensor the
  hand-written kernel (``csrc/softargmax.cu``) computes mu, and its backward
  recomputes through the plain version, as the reference's Pallas custom
  VJP does; on the CPU it is the plain version.

Gradients follow the reference's paths: the label-or-mu ``where``, the
Gaussian targets built from mu and the clique coordinates all carry
gradient into mu; nothing is detached.

Marker convention: a batch holds T frames x nj joints = N = T*nj markers,
flattened row-major (frame-major, ref: fitdgp_util.py:104-143). A marker is
*visible* iff its frame is labeled and its coordinate is not NaN; NaN markers
of labeled frames are treated as hidden (ref: fitdgp_util.py:77-101).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from deepgraphpose_tpu_torch.ops import (  # noqa: F401
    cliques, losses, softargmax, targets as targets_ops)
from deepgraphpose_tpu_torch.ops.kernels.softargmax_kernel import (
    softargmax_2d_cuda)


@dataclasses.dataclass(frozen=True)
class DGPLossParams:
    """Static hyperparameters + dataset-level constants for the objective.

    The population counts are dataset-level constants
    (ref: fitdgp.py:869-872, 1027-1035).
    """

    nj: int
    stride: float
    gamma: float
    gauss_len: float
    lengthscale: float
    pos_dist_thresh: float
    locref_stdev: float
    locref_loss_weight: float
    locref_huber_loss: bool
    wn_visible: float
    wn_hidden: float
    wt: float
    wt_max: float
    gm2: int
    gm3: int
    n_visible_frames_total: float
    n_hidden_frames_total: float
    S0: Any = None          # (nl, nj) incidence matrix, numpy or tensor
    ws: Any = None          # (nl,) per-limb weights
    ws_max: Any = None      # (nl,) per-limb hinge bounds

    @property
    def n_limbs(self) -> int:
        return 0 if self.S0 is None else len(self.S0)

    def to(self, device, dtype=torch.float32) -> "DGPLossParams":
        """A copy whose limb constants are tensors on ``device``, so that
        a step copies nothing from the host."""
        def put(x):
            return None if x is None else torch.as_tensor(
                x, dtype=dtype, device=device)

        return dataclasses.replace(self, S0=put(self.S0), ws=put(self.ws),
                                   ws_max=put(self.ws_max))


def compute_spatial_bounds(labels_list: list[np.ndarray], S0: np.ndarray,
                           stride: float, ws: float, ws_max_mult: float
                           ) -> tuple[np.ndarray, np.ndarray]:
    """Per-limb clique weights and hinge bounds from the labeled data.

    Reproduces the reference's exact bookkeeping (including its quirk of
    adding stride/2 to limb *differences* before taking max/mean), ref:
    fitdgp.py:874-892.

    labels_list: per-video (n_i, nj, 2) labeled coords in scoremap space.
    Returns (ws_vec, ws_max_vec), each (n_limbs,).
    """
    nl, nj = S0.shape
    if nl == 0:
        return np.zeros((0,), np.float32), np.zeros((0,), np.float32)
    joint_loc_full = np.empty((0, nj, 2))
    for j in labels_list:
        if len(j) > 0:
            joint_loc_full = np.vstack((j, joint_loc_full))
    if len(joint_loc_full) == 0:
        return (np.full((nl,), ws, np.float32),
                np.full((nl,), 1e6, np.float32))

    flat = np.copy(joint_loc_full).swapaxes(1, 2).reshape(-1, nj)
    flat[np.isnan(flat)] = 1e10
    limb = flat @ S0.T
    limb[np.abs(limb) > 1e5] = 0
    limb = limb.reshape(joint_loc_full.shape[0], 2, -1)
    limb = np.sqrt(np.sum(np.square(limb), axis=1))  # (n, nl)
    limb = limb.T * stride + stride / 2.0            # (nl, n)
    ws_max_vec = np.max(np.nan_to_num(limb), axis=1) * ws_max_mult
    mean_len = np.true_divide(limb.sum(1), np.maximum((limb != 0).sum(1), 1))
    ws_vec = 1.0 / (np.nan_to_num(mean_len) + 1e-20) * ws
    return ws_vec.astype(np.float32), ws_max_vec.astype(np.float32)


def loss_params(cfg, S0: np.ndarray, labels_list: list[np.ndarray],
                n_visible: int, n_hidden: int) -> DGPLossParams:
    """The objective's parameters for one DGP step, as ``fit_dgp`` builds
    them (ref: deepgraphpose_tpu/train/fit.py::_make_loss_params).

    cfg: the step's PoseConfig (after the step's overrides). S0: the
    (nl, nj) limb matrix, dropped when ``cfg.ws`` is 0. labels_list:
    per-video (n_i, nj, 2) labeled coords in scoremap space. n_visible,
    n_hidden: the dataset's labeled and unlabeled frame counts.
    """
    ws, ws_max = compute_spatial_bounds(labels_list, S0, cfg.stride, cfg.ws,
                                        cfg.ws_max)
    return DGPLossParams(
        nj=cfg.num_joints, stride=cfg.stride, gamma=cfg.gamma,
        gauss_len=cfg.gauss_len, lengthscale=cfg.lengthscale,
        pos_dist_thresh=cfg.pos_dist_thresh, locref_stdev=cfg.locref_stdev,
        locref_loss_weight=cfg.locref_loss_weight,
        locref_huber_loss=cfg.locref_huber_loss, wn_visible=cfg.wn_visible,
        wn_hidden=cfg.wn_hidden, wt=cfg.wt, wt_max=cfg.wt_max, gm2=cfg.gm2,
        gm3=cfg.gm3, n_visible_frames_total=float(max(n_visible, 1)),
        n_hidden_frames_total=float(n_hidden),
        S0=(S0 if cfg.ws > 0 and S0.shape[0] > 0
            else np.zeros((0, cfg.num_joints))),
        ws=ws, ws_max=ws_max)


def _masked_weighted_ce(ce: torch.Tensor, weights: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """sum(ce * w * m) / count((w * m) != 0) over (N, H, W) maps.

    Mirrors TF's SUM_BY_NONZERO_WEIGHTS on a gathered subset with per-marker
    weights (ref: fitdgp.py:1026-1031 gm3==3 branch).
    """
    n, h, w = ce.shape
    wm = weights * mask
    total = torch.sum(ce * wm[:, None, None])
    count = torch.sum((wm != 0).to(ce.dtype)) * h * w
    return torch.where(count > 0, total / torch.clamp_min(count, 1.0),
                       torch.zeros_like(total))


def _confidence_logits(pred_m: torch.Tensor):
    """(max sigmoid a marker (N,), logit of sigmoid scaled by it)
    (ref: fitdgp.py:994-1010)."""
    sig = torch.sigmoid(pred_m)
    pgm = torch.amax(sig, dim=(1, 2))
    scaled = sig * pgm[:, None, None]
    return pgm, -torch.log(1.0 - scaled + 1e-20) + torch.log(scaled + 1e-20)


def dgp_loss(
    pred: torch.Tensor,
    locref_pred: torch.Tensor,
    batch: dict,
    p: DGPLossParams,
) -> dict:
    """Compute all DGP losses for one batch.

    Args:
      pred: (T, H, W, nj) part-prediction logits, contiguous.
      locref_pred: (T, H, W, 2*nj) location-refinement outputs.
      batch: dict with
        targets:       (T, nj, 2) label coords, scoremap (row, col), NaN->0.
        visible_mask:  (T*nj,) {0,1} visible markers.
        hidden_mask:   (T*nj,) {0,1} hidden markers.
        frame_mask:    (T,)    {0,1} real (non-padded) frames.
        wt_batch:      (T-1,)  temporal weights (wt per pair).
        pair_mask:     (T-1,)  {0,1} true temporal neighbors.
        flow:          (T-1, H_in, W_in) flow magnitude (zeros if wt == 0).
      p: DGPLossParams, its limb constants as float32 tensors on pred's
        device (``DGPLossParams.to``, which ``make_dgp_train_step`` applies).

    Returns a dict of 0-d tensors: per-term losses, 'total_loss' and
    'total_loss_visible'.
    """
    t, h, w, nj = pred.shape
    dtype = pred.dtype
    n = t * nj

    targets = torch.nan_to_num(batch["targets"].to(dtype))          # (T,nj,2)
    visible_mask = batch["visible_mask"].to(dtype)                  # (N,)
    hidden_mask = batch["hidden_mask"].to(dtype)
    frame_mask = batch["frame_mask"].to(dtype)

    # --- soft-argmax decode (ref: fitdgp.py:949) ---
    mu = softargmax_2d_cuda(pred, gamma=p.gamma, gauss_len=p.gauss_len)
    mu_flat = mu.reshape(n, 2)
    targets_flat = targets.reshape(n, 2)

    # --- combine: label coords where visible, predicted mu elsewhere
    # (ref: combine_all_marker, fitdgp_util.py:232-272) ---
    combined = torch.where(visible_mask[:, None] > 0, targets_flat, mu_flat)

    # --- Gaussian target maps, peak-normalized (ref: fitdgp.py:964-976) ---
    gauss = targets_ops.gaussian_target_maps(combined, h, w, p.lengthscale)

    # marker-major logits (ref reshapes (T,H,W,nj)->(N,H,W), fitdgp.py:983-987)
    pred_m = pred.permute(0, 3, 1, 2).reshape(n, h, w)

    n_vis_b = torch.sum(visible_mask)
    n_hid_b = torch.sum(hidden_mask)
    # if no visible markers in batch, use the hidden count (ref: fitdgp.py:981)
    n_vis_b_safe = torch.where(n_vis_b > 0, n_vis_b, n_hid_b)
    zero = torch.zeros_like(n_vis_b)

    out: dict = {}

    ce = losses.sigmoid_cross_entropy_elements(gauss, pred_m)
    out["visible_loss_pred"] = losses.masked_mean_per_map(ce, visible_mask)

    # --- hidden CE with optional confidence scaling (ref: fitdgp.py:994-1039)
    gauss_h = gauss
    pred_h_for_ce = pred_m
    pgm = None
    if p.gm2 in (1, 2):
        pgm, pred_h_for_ce = _confidence_logits(pred_m)
        if p.gm2 == 1:
            gauss_h = gauss * pgm[:, None, None]
    elif p.gm2 != 0:
        raise NotImplementedError(f"gm2={p.gm2}")

    pop_scale = 0.0
    if p.n_hidden_frames_total > 0:
        pop_scale = (p.n_visible_frames_total / p.n_hidden_frames_total)
    batch_scale = torch.where(
        n_vis_b_safe > 0, n_hid_b / torch.clamp_min(n_vis_b_safe, 1.0), zero)
    hidden_scale = pop_scale * batch_scale * (p.wn_hidden / p.wn_visible)

    if p.gm3 == 3:
        if pgm is None:
            pgm, pred_h_for_ce = _confidence_logits(pred_m)
        ce_h = losses.sigmoid_cross_entropy_elements(gauss_h, pred_h_for_ce)
        out["hidden_loss_pred"] = _masked_weighted_ce(
            ce_h, 1.0 - pgm, hidden_mask) * hidden_scale
    elif p.gm3 == 0:
        # gm3==0 uses the *raw* logits even when gm2 scaled the targets
        # (ref: fitdgp.py:1032-1035).
        ce_h = losses.sigmoid_cross_entropy_elements(gauss_h, pred_m)
        out["hidden_loss_pred"] = losses.masked_mean_per_map(
            ce_h, hidden_mask) * hidden_scale
    else:
        raise NotImplementedError(f"gm3={p.gm3}")

    total = out["visible_loss_pred"] + out["hidden_loss_pred"]

    # --- locref Huber on visible markers (ref: fitdgp.py:1041-1055) ---
    _, locref_map, locref_mask = targets_ops.locref_targets_from_scoremap_coords(
        targets, visible_mask.reshape(t, nj), h, w,
        p.stride, p.pos_dist_thresh, p.locref_stdev)

    def to_marker_major(x):     # (T,H,W,2nj) -> (N,H,W,2)
        return x.reshape(t, h, w, nj, 2).permute(0, 3, 1, 2, 4).reshape(
            n, h, w, 2)

    lr_pred = to_marker_major(locref_pred)
    lr_map = to_marker_major(locref_map)
    lr_mask = to_marker_major(locref_mask) * visible_mask[:, None, None, None]
    if p.locref_huber_loss:
        out["visible_loss_locref"] = p.locref_loss_weight * losses.huber_loss(
            lr_map, lr_pred, lr_mask)
    else:
        out["visible_loss_locref"] = p.locref_loss_weight * losses.mse_loss(
            lr_map, lr_pred, lr_mask)
    total = total + out["visible_loss_locref"]

    # --- cliques on combined coords in pixel space (ref: fitdgp.py:1062-1124)
    n_total = p.n_visible_frames_total + p.n_hidden_frames_total
    clique_scale = torch.where(
        n_vis_b_safe > 0,
        p.n_visible_frames_total / torch.clamp_min(n_vis_b_safe, 1.0)
        / max(n_total, 1.0) / p.wn_visible, zero)

    combined_px = combined.reshape(t, nj, 2) * p.stride + 0.5 * p.stride
    if p.n_limbs > 0:
        ws_loss = cliques.spatial_clique_loss(
            combined_px, p.S0, p.ws, p.ws_max, frame_mask, (h, w))
        out["ws_loss"] = ws_loss * clique_scale
        total = total + out["ws_loss"]

    if p.wt > 0:
        wt_loss = cliques.temporal_clique_loss(
            combined_px, batch["flow"].to(dtype), batch["wt_batch"].to(dtype),
            p.wt_max, batch["pair_mask"].to(dtype), (h, w))
        out["wt_loss"] = wt_loss * clique_scale
        total = total + out["wt_loss"]

    out["total_loss"] = total
    out["total_loss_visible"] = (out["visible_loss_pred"]
                                 + out["visible_loss_locref"])
    return out

"""Spatial (skeleton) and temporal (smoothness) clique potentials, in PyTorch.

The port's own copy of ``deepgraphpose_tpu/ops/cliques.py``. ref:
src/deepgraphpose/models/fitdgp.py:1062-1076 (spatial), 1079-1124
(temporal with optical-flow gating).

* All shapes are static; padded frames drop out of the sums through masks.
* The reference gates the temporal clique by the mean optical-flow
  magnitude inside a box around each joint pair, with
  ``tf.image.crop_and_resize``. Here the box mean comes from a summed-area
  table (two cumsums) with a bilinear four-corner lookup: O(HW) once per
  frame pair, then O(1) per box.
* ``torch.minimum``/``torch.maximum`` keep JAX's gradient at ties (half to
  each side): the padded frames repeat the last real one, so their joints
  tie with it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def spatial_clique_loss(
    coords_px: torch.Tensor,
    S0: torch.Tensor,
    ws: torch.Tensor,
    ws_max: torch.Tensor,
    frame_mask: torch.Tensor,
    scoremap_hw: tuple[int, int],
) -> torch.Tensor:
    """Hinged limb-length penalty.

    Args:
      coords_px: (T, nj, 2) marker (row, col) pixel coords (already
        ``* stride + stride/2``).
      S0: (nl, nj) limb incidence matrix (+1/-1).
      ws: (nl,) per-limb weights (cfg.ws / mean limb length,
        ref fitdgp.py:888-892).
      ws_max: (nl,) per-limb hinge bounds (max observed length * cfg.ws_max).
      frame_mask: (T,) {0,1}: zero for padded frames.
      scoremap_hw: (H, W) of the scoremap, used as a normalizer.

    Returns the *unscaled* clique sum; the caller applies the population
    re-weighting (ref: fitdgp.py:1073-1075).
    """
    limb_vec = torch.einsum("lj,tjc->tlc", S0, coords_px)     # (T, nl, 2)
    dist = torch.sqrt(torch.sum(torch.square(limb_vec), dim=-1) + 1e-12)
    hinged = F.relu(dist - ws_max[None, :]) + ws_max[None, :]
    hinged = hinged * frame_mask[:, None]
    h, w = scoremap_hw
    return torch.sum(hinged * ws[None, :]) / float(h) / float(w)


def _summed_area_table(field: torch.Tensor) -> torch.Tensor:
    """(P, H, W) -> (P, H+1, W+1) integral image with zero first row/col."""
    sat = torch.cumsum(torch.cumsum(field, dim=1), dim=2)
    return F.pad(sat, (1, 0, 1, 0))


def _sat_lookup(sat: torch.Tensor, r: torch.Tensor,
                c: torch.Tensor) -> torch.Tensor:
    """Bilinear lookup of the integral image at fractional (r, c).

    sat: (P, H+1, W+1); r, c: (P, K) coordinates in [0, H] x [0, W].
    """
    p, hp1, wp1 = sat.shape
    r0 = torch.clamp(torch.floor(r), 0, hp1 - 2).to(torch.int64)
    c0 = torch.clamp(torch.floor(c), 0, wp1 - 2).to(torch.int64)
    zero, one = r.new_full((), 0.0), r.new_full((), 1.0)
    fr = torch.minimum(torch.maximum(r - r0, zero), one)    # jnp.clip
    fc = torch.minimum(torch.maximum(c - c0, zero), one)
    pid = torch.arange(p, device=r.device)[:, None].expand_as(r0)

    def take(dr, dc):
        return sat[pid, r0 + dr, c0 + dc]

    v00, v01 = take(0, 0), take(0, 1)
    v10, v11 = take(1, 0), take(1, 1)
    top = v00 * (1 - fc) + v01 * fc
    bot = v10 * (1 - fc) + v11 * fc
    return top * (1 - fr) + bot * fr


def box_mean_flow(flow: torch.Tensor, r_min: torch.Tensor,
                  c_min: torch.Tensor, r_max: torch.Tensor,
                  c_max: torch.Tensor) -> torch.Tensor:
    """Mean of ``flow`` over boxes [r_min, r_max] x [c_min, c_max].

    flow: (P, H, W) per frame-pair flow magnitude.
    box coords: (P, K) fractional pixel coordinates.
    """
    sat = _summed_area_table(flow)
    a = _sat_lookup(sat, r_min, c_min)
    b = _sat_lookup(sat, r_min, c_max)
    c_ = _sat_lookup(sat, r_max, c_min)
    d = _sat_lookup(sat, r_max, c_max)
    area = torch.maximum((r_max - r_min) * (c_max - c_min),
                         r_min.new_full((), 1e-6))
    return (d - b - c_ + a) / area


def temporal_clique_loss(
    coords_px: torch.Tensor,
    flow: torch.Tensor,
    wt_batch: torch.Tensor,
    wt_max: float,
    pair_mask: torch.Tensor,
    scoremap_hw: tuple[int, int],
    window: float = 10.0,
) -> torch.Tensor:
    """Flow-gated temporal smoothness penalty (ref: fitdgp.py:1079-1124).

    Args:
      coords_px: (T, nj, 2) marker (row, col) pixel coords.
      flow: (T-1, H_in, W_in) dense flow magnitude between frames t, t+1.
      wt_batch: (T-1,) temporal clique weights (wt * wt_batch_mask).
      wt_max: hinge bound for per-joint displacement.
      pair_mask: (T-1,) {0,1}: 1 when frames t, t+1 are true temporal
        neighbors in the same video (ref wt_batch_mask, dataset.py:733-735).
      scoremap_hw: (H, W) of the scoremap (normalizer).
      window: box padding around the joint pair, pixels (ref window=10).
    """
    h_in, w_in = flow.shape[1], flow.shape[2]
    p0 = coords_px[:-1]  # (T-1, nj, 2)
    p1 = coords_px[1:]
    time_dif = torch.sqrt(torch.sum(torch.square(p0 - p1), dim=-1) + 1e-12)
    zero = coords_px.new_full((), 0.0)

    r_min = torch.maximum(torch.minimum(p0[..., 0], p1[..., 0]) - window, zero)
    r_max = torch.minimum(torch.maximum(p0[..., 0], p1[..., 0]) + window,
                          coords_px.new_full((), float(h_in)))
    c_min = torch.maximum(torch.minimum(p0[..., 1], p1[..., 1]) - window, zero)
    c_max = torch.minimum(torch.maximum(p0[..., 1], p1[..., 1]) + window,
                          coords_px.new_full((), float(w_in)))

    mean_flow = box_mean_flow(flow, r_min, c_min, r_max, c_max)  # (T-1, nj)

    one = coords_px.new_full((), 1.0)
    inv = torch.minimum(1.0 / (mean_flow + 1e-10), one)
    inv = torch.minimum(inv ** 3, one)  # ref: exp(3 * log(inv)) clipped at 1
    h, w = scoremap_hw
    gate = inv * (wt_batch * pair_mask)[:, None] / float(h) / float(w)

    hinged = (F.relu(time_dif - wt_max) + wt_max) * gate
    return torch.sqrt(torch.sum(torch.square(hinged)) + 1e-20)  # TF.norm(_, 2)

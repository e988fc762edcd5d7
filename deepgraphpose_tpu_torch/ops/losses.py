"""Loss primitives with TF1-parity reduction semantics, in PyTorch.

The port's own copy of ``deepgraphpose_tpu/ops/losses.py``. The reference
relies on ``tf.losses.sigmoid_cross_entropy`` /
``tf.losses.compute_weighted_loss`` with the default SUM_BY_NONZERO_WEIGHTS
reduction (sum(w * l) / count(w != 0)); the same normalizers give
step-for-step training parity (ref: pose_net.py:165-196,
nnet/losses.py:16-45, fitdgp.py:1025-1055).

Marker subsets are {0,1} masks over static shapes, not gathers. The
gradients at ties follow JAX's: ``torch.maximum`` (not ``clamp``) gives
half to each side, and |x| has slope +1 at 0 (``torch.abs`` has 0).
"""

from __future__ import annotations

import torch


def sigmoid_cross_entropy_elements(labels: torch.Tensor,
                                   logits: torch.Tensor) -> torch.Tensor:
    """Elementwise sigmoid CE, stable form: max(x,0) - x*z + log1p(exp(-|x|))."""
    abs_x = torch.where(logits >= 0, logits, -logits)
    return (torch.maximum(logits, torch.zeros_like(logits)) - logits * labels
            + torch.log1p(torch.exp(-abs_x)))


def sigmoid_cross_entropy(labels: torch.Tensor, logits: torch.Tensor,
                          weights=1.0, all_sum=None) -> torch.Tensor:
    """TF-semantics sigmoid CE: sum(w * ce) / count(broadcast w != 0).

    With scalar weight 1.0 this is the plain mean (ref: pose_net.py:176-179).
    ``all_sum``: see :func:`weighted_loss`.
    """
    return weighted_loss(sigmoid_cross_entropy_elements(labels, logits),
                         weights, all_sum)


def huber_elements(labels: torch.Tensor, predictions: torch.Tensor,
                   k: float = 1.0) -> torch.Tensor:
    """Huber: 0.5 x^2 if |x| < k else k|x| - 0.5 k^2 (ref: losses.py:16-45)."""
    diff = predictions - labels
    abs_diff = torch.abs(diff)
    return torch.where(abs_diff < k, 0.5 * diff * diff,
                       k * abs_diff - 0.5 * k * k)


def huber_loss(labels: torch.Tensor, predictions: torch.Tensor,
               weights=1.0, k: float = 1.0, all_sum=None) -> torch.Tensor:
    return weighted_loss(huber_elements(labels, predictions, k), weights,
                         all_sum)


def mse_loss(labels: torch.Tensor, predictions: torch.Tensor,
             weights=1.0, all_sum=None) -> torch.Tensor:
    return weighted_loss(torch.square(predictions - labels), weights,
                         all_sum)


def weighted_loss(losses: torch.Tensor, weights,
                  all_sum=None) -> torch.Tensor:
    """TF compute_weighted_loss, reduction=SUM_BY_NONZERO_WEIGHTS.

    ``weights`` broadcasts against ``losses``; the denominator counts the
    number of *broadcast* elements with nonzero weight. ``all_sum`` (a
    data group's differentiable sum over its ranks) reduces over a global
    batch: the sum and the count are the ranks' totals.
    """
    # a number becomes a device scalar by a fill, not a copy from the host
    # (which would wait for the card and break a CUDA graph's capture)
    weights = (weights.to(losses.device, losses.dtype)
               if isinstance(weights, torch.Tensor)
               else losses.new_full((), weights))
    w = torch.broadcast_to(weights, losses.shape)
    num_present = torch.sum((w != 0).to(losses.dtype))
    total = torch.sum(losses * w)
    if all_sum is not None:
        num_present, total = all_sum(num_present), all_sum(total)
    return torch.where(num_present > 0,
                       total / torch.clamp_min(num_present, 1.0),
                       torch.zeros_like(total))


def masked_mean_per_map(values: torch.Tensor,
                        marker_mask: torch.Tensor) -> torch.Tensor:
    """Mean of per-marker maps over the selected markers.

    values: (N, H, W) per-marker elementwise losses.
    marker_mask: (N,) {0,1} selection.

    Equals TF's mean over a gathered (K, H, W) subset: sum over selected
    elements / (K * H * W).
    """
    n, h, w = values.shape
    m = marker_mask.to(values.dtype)
    total = torch.sum(values * m[:, None, None])
    count = torch.sum(m) * h * w
    return torch.where(count > 0, total / torch.clamp_min(count, 1.0),
                       torch.zeros_like(total))

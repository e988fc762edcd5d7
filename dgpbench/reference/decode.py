"""The soft-argmax decode and the likelihood read, in plain PyTorch, and
the comparison that judges the program's poses by the reference's maps.

The decode as DeepGraphPose's ``eval.py`` and ``fitdgp_util.py`` define
it: softmax of ``gamma`` x logits over the map, a separable Gaussian of
sigma ``gauss_len`` and radius ``int(gauss_len)`` with zero padding,
renormalised, then the expected (row, col); the likelihood is the largest
sigmoid of the logits over the 2x2 cells at ``floor(mu)``, clipped to the
map.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _smooth(probs: torch.Tensor, sigma: float) -> torch.Tensor:
    radius = int(sigma)
    if radius <= 0:
        return probs
    d = torch.arange(-radius, radius + 1, dtype=probs.dtype,
                     device=probs.device)
    k = torch.exp(-0.5 * torch.square(d / sigma))
    k = k / k.sum()
    t, h, w, c = probs.shape
    x = probs.permute(0, 3, 1, 2).reshape(t * c, 1, h, w)
    x = F.conv2d(x, k.view(1, 1, -1, 1), padding=(radius, 0))
    x = F.conv2d(x, k.view(1, 1, 1, -1), padding=(0, radius))
    return x.reshape(t, c, h, w).permute(0, 2, 3, 1)


def soft_argmax(logits: torch.Tensor, gamma: float,
                gauss_len: float) -> torch.Tensor:
    """(B, H, W, C) logits -> mu (B, C, 2), (row, col) in map cells."""
    t, h, w, c = logits.shape
    probs = torch.softmax((logits * gamma).reshape(t, h * w, c), dim=1)
    probs = _smooth(probs.reshape(t, h, w, c), gauss_len)
    probs = probs / probs.sum(dim=(1, 2), keepdim=True)
    rows = torch.arange(h, dtype=probs.dtype, device=probs.device)
    cols = torch.arange(w, dtype=probs.dtype, device=probs.device)
    return torch.stack([torch.einsum("thwc,h->tc", probs, rows),
                        torch.einsum("thwc,w->tc", probs, cols)], dim=-1)


def likelihood_at(logits: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """Largest sigmoid of ``logits`` (B, H, W, C) over the 2x2 cells at
    ``clip(floor(mu))`` and the next row and column, each clipped."""
    b, h, w, c = logits.shape
    r0 = torch.floor(mu[..., 0]).to(torch.int64).clamp(0, h - 1)
    c0 = torch.floor(mu[..., 1]).to(torch.int64).clamp(0, w - 1)
    flat = logits.reshape(b, h * w, c)
    best = None
    for dr in (0, 1):
        for dc in (0, 1):
            idx = ((r0 + dr).clamp(0, h - 1) * w
                   + (c0 + dc).clamp(0, w - 1))
            v = torch.gather(flat, 1, idx[:, None, :])[:, 0, :]
            best = v if best is None else torch.maximum(best, v)
    return torch.sigmoid(best)


def judge(ref_logits: torch.Tensor, ref_mu: torch.Tensor, which: torch.Tensor,
          mu: torch.Tensor, lik: torch.Tensor) -> dict:
    """Errors of the program's answers ``mu`` (N, C, 2) and ``lik`` (N, C)
    for the frames ``which`` (N,) of the reference's block, each the worst
    over the joints (N,): ``mu_err``, the distance in map cells from the
    reference's mu, and ``lik_err``, the gap from the likelihood that the
    reference's maps give at the program's own mu."""
    mu_err = torch.linalg.vector_norm(mu - ref_mu[which], dim=-1)
    lik_err = (lik - likelihood_at(ref_logits[which], mu)).abs()
    return {"mu_err": mu_err.amax(dim=1), "lik_err": lik_err.amax(dim=1)}

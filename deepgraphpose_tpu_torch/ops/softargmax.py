"""2-D soft-argmax over confidence maps: the plain PyTorch versions.

Semantics mirror the reference (softmax with temperature gamma over H*W ->
separable-Gaussian smoothing with zero padding -> renormalize ->
expectation over the (row, col) grid), ref:
src/deepgraphpose/models/fitdgp_util.py:281-315 (gaussian kernel),
342-402 (argmax_2d_from_cm), and eval.py:331-343 (2x2 likelihood).

These run on the CPU, serve as the backward of the CUDA decode kernel, and
are what ``chip_smoke.py`` holds the kernel against on the card. The kernel
itself is ``ops/kernels/softargmax_kernel.py``. Coordinates are (row, col)
in scoremap cells; pixels are ``coord * stride + stride / 2``
(ref: eval.py:352-353).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel_1d(sigma: float, truncate: float = 1.0,
                       dtype=torch.float32, device=None) -> torch.Tensor:
    """Normalized 1-D Gaussian taps, radius = int(sigma * truncate)
    (ref: fitdgp_util.py:281-287)."""
    radius = int(sigma * truncate)
    x = torch.arange(-radius, radius + 1, dtype=dtype, device=device)
    k = torch.exp(-0.5 * torch.square(x / sigma))
    return k / torch.sum(k)


def gaussian_smooth_2d(maps: torch.Tensor, sigma: float,
                       truncate: float = 1.0) -> torch.Tensor:
    """Depthwise separable Gaussian blur with zero padding; maps (T, H, W, C).

    The pad equals the kernel radius so the output keeps the input shape;
    radius 0 is the identity (ref: fitdgp_util.py:289-315).
    """
    radius = int(sigma * truncate)
    if radius <= 0:
        return maps
    k = gaussian_kernel_1d(sigma, truncate, maps.dtype, maps.device)
    t, h, w, c = maps.shape
    x = maps.permute(0, 3, 1, 2).reshape(t * c, 1, h, w)
    x = F.conv2d(x, k.view(1, 1, -1, 1), padding=(radius, 0))
    x = F.conv2d(x, k.view(1, 1, 1, -1), padding=(0, radius))
    return x.reshape(t, c, h, w).permute(0, 2, 3, 1)


def softargmax_2d(scoremaps: torch.Tensor, gamma: float = 1.0,
                  gauss_len: float = 2.0, threshold: float | None = None,
                  truncate: float = 1.0):
    """Soft-argmax keypoint decoding.

    Args:
      scoremaps: (T, H, W, C) raw logits from the part-prediction head.
      gamma: softmax temperature multiplier.
      gauss_len: sigma of the smoothing Gaussian.
      threshold: optional relative threshold; probability mass below
        ``threshold * max`` is zeroed and the map renormalized
        (ref: fitdgp_util.py:380-393).
      truncate: smoothing radius is ``int(gauss_len * truncate)``.

    Returns:
      mu: (T, C, 2) expected (row, col) coordinates in scoremap cells.
      probs: (T, H, W, C) smoothed, renormalized probability maps.
    """
    t, h, w, c = scoremaps.shape
    logits = (scoremaps * gamma).reshape(t, h * w, c)
    probs = torch.softmax(logits, dim=1).reshape(t, h, w, c)

    probs = gaussian_smooth_2d(probs, gauss_len, truncate)
    probs = probs / torch.sum(probs, dim=(1, 2), keepdim=True)

    if threshold is not None:
        peak = torch.amax(probs, dim=(1, 2), keepdim=True)
        probs = torch.where(probs < peak * threshold,
                            torch.zeros_like(probs), probs)
        probs = probs / torch.sum(probs, dim=(1, 2), keepdim=True)

    rows = torch.arange(h, dtype=probs.dtype, device=probs.device)
    cols = torch.arange(w, dtype=probs.dtype, device=probs.device)
    mu_r = torch.einsum("thwc,h->tc", probs, rows)
    mu_c = torch.einsum("thwc,w->tc", probs, cols)
    return torch.stack([mu_r, mu_c], dim=-1), probs


def max_sigmoid_2x2(scoremaps: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """Likelihood: max sigmoid(logit) over the 2x2 cells at
    ``clip(floor(mu))`` and ``+1``, each clipped to the map
    (ref: eval.py:331-343; deepgraphpose_tpu infer/predict.py:51-64)."""
    b, h, w, nj = scoremaps.shape
    r0 = torch.floor(mu[..., 0]).to(torch.int64).clamp(0, h - 1)
    c0 = torch.floor(mu[..., 1]).to(torch.int64).clamp(0, w - 1)
    flat = scoremaps.reshape(b, h * w, nj)

    def at(dr, dc):
        r = (r0 + dr).clamp(0, h - 1)
        c = (c0 + dc).clamp(0, w - 1)
        return torch.gather(flat, 1, (r * w + c)[:, None, :])[:, 0, :]

    best = torch.maximum(torch.maximum(at(0, 0), at(0, 1)),
                         torch.maximum(at(1, 0), at(1, 1)))
    return torch.sigmoid(best)


def softargmax_likelihood(scoremaps: torch.Tensor, gamma: float,
                          gauss_len: float, truncate: float = 1.0):
    """Plain version of the CUDA decode kernel: (mu (B, C, 2), lik (B, C))."""
    mu, _ = softargmax_2d(scoremaps, gamma=gamma, gauss_len=gauss_len,
                          truncate=truncate)
    return mu, max_sigmoid_2x2(scoremaps, mu)


def smoothing_weights(h: int, w: int, gauss_len: float,
                      truncate: float = 1.0) -> np.ndarray:
    """The decode kernel's weight vectors, concatenated [A, Ar, B, Bc].

    Smoothing is linear and the renormalization divides it out, so with
    normalized taps k_d (radius r) and e = exp(gamma * x - max):

      A(i)  = sum_{|d|<=r, 0<=i+d<H} k_d,   Ar(i) = same sum of k_d * (i+d),
      B(j), Bc(j) likewise over W,
      mu_row = sum e*Ar*B / sum e*A*B,      mu_col = sum e*A*Bc / sum e*A*B.

    Built in float64, returned as float32 of length 2H + 2W.
    """
    radius = int(gauss_len * truncate)
    if radius > 0:
        d = np.arange(-radius, radius + 1, dtype=np.float64)
        k = np.exp(-0.5 * np.square(d / gauss_len))
        k = k / k.sum()
    else:
        d, k = np.zeros(1), np.ones(1)

    def vectors(n):
        pos = np.arange(n, dtype=np.float64)[:, None] + d[None, :]
        inside = (pos >= 0) & (pos < n)
        kk = np.where(inside, k[None, :], 0.0)
        return kk.sum(1), (kk * pos).sum(1)

    a, ar = vectors(h)
    b, bc = vectors(w)
    return np.concatenate([a, ar, b, bc]).astype(np.float32)


def coords_to_pixels(mu: torch.Tensor, stride: float) -> torch.Tensor:
    """Scoremap-space (row, col) -> pixel-space (row, col)
    (ref: eval.py:352-353, mu * stride + stride / 2)."""
    return mu * stride + 0.5 * stride


def pixels_to_xy(mu_px: torch.Tensor) -> torch.Tensor:
    """(row, col) -> (x, y) export convention (ref: eval.py:352-353)."""
    return mu_px.flip(-1)

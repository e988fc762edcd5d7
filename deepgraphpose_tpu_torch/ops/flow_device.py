"""Dense optical flow on the device for the temporal clique, in PyTorch.

The port's own copy of ``deepgraphpose_tpu/ops/flow_device.py``: a
coarse-to-fine pyramidal Lucas-Kanade estimator that stands in for the
host's Farneback pass (ref: src/deepgraphpose/models/fitdgp_util.py:454-467
learn_wt; host counterpart ``data/flow.py``), so the wt > 0 temporal clique
trains from the frame pools on the card without a host round trip an
update.

The clique reads |fx| + |fy| averaged over boxes around joint pairs
(``ops/cliques.py`` summed-area tables), so a smooth magnitude field is
what matters, not per-pixel exactness:

* the flow is solved on a half-resolution pyramid (levels H/8 -> H/4 ->
  H/2) and the magnitude is upsampled to full resolution;
* window sums are separable box filters made of cumulative sums;
* the warps between levels are bilinear gathers on the pyramid levels
  only.

Every function is plain tensor work with no host sync, so the pooled DGP
update that calls it can be captured in a CUDA graph
(``train/device_data.py``). The bilinear resizes use
``jax.image.resize``'s weight matrices (``ops/augment_device.py``): at
747x832 the pyramid's steps 186 -> 373 and 373x416 -> 747x832 are not
exact 2x scales.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deepgraphpose_tpu_torch.ops.augment_device import upsample_weights

_GRAY = (0.299, 0.587, 0.114)  # cv2 RGB2GRAY weights (host-path parity)


def _box(x: torch.Tensor, k: int) -> torch.Tensor:
    """Separable (2k+1)-box mean over the last two axes of (T, H, W), with
    edge padding, by cumulative sums."""
    w = 2 * k + 1
    h_in, w_in = x.shape[-2], x.shape[-1]
    xp = F.pad(x, (k, k, k, k), mode="replicate")
    c = F.pad(torch.cumsum(xp, dim=-2), (0, 0, 1, 0))
    x = c[..., w:w + h_in, :] - c[..., :h_in, :]
    c = F.pad(torch.cumsum(x, dim=-1), (1, 0))
    x = c[..., w:w + w_in] - c[..., :w_in]
    return x / (w * w)


def _down2(x: torch.Tensor) -> torch.Tensor:
    """2x average-pool (..., H, W) -> (..., H // 2, W // 2)."""
    h2, w2 = x.shape[-2] // 2, x.shape[-1] // 2
    x = x[..., :h2 * 2, :w2 * 2]
    return x.reshape(*x.shape[:-2], h2, 2, w2, 2).mean(dim=(-3, -1))


def _warp(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor
          ) -> torch.Tensor:
    """Bilinear warp of img (B, H, W) by the flow (u, v), coordinates
    clamped to the image; runs on the pyramid levels only."""
    b, h, w = img.shape
    ys = torch.arange(h, dtype=img.dtype, device=img.device)[:, None]
    xs = torch.arange(w, dtype=img.dtype, device=img.device)[None, :]
    sx = torch.clamp(xs + u, 0.0, w - 1.0)
    sy = torch.clamp(ys + v, 0.0, h - 1.0)
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = sx - x0
    fy = sy - y0
    x0i = torch.clamp(x0.to(torch.int64), 0, w - 1)
    y0i = torch.clamp(y0.to(torch.int64), 0, h - 1)
    x1i = torch.clamp(x0i + 1, 0, w - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    flat = img.reshape(b, h * w)

    def take(yi, xi):
        return torch.gather(flat, 1, (yi * w + xi).reshape(b, -1)
                            ).reshape(b, h, w)

    return ((1 - fy) * ((1 - fx) * take(y0i, x0i) + fx * take(y0i, x1i))
            + fy * ((1 - fx) * take(y1i, x0i) + fx * take(y1i, x1i)))


def _grad_central(g: torch.Tensor, axis: int) -> torch.Tensor:
    """Central difference along ``axis`` (-1 or -2) with the edge
    replicated (no wrap-around at the borders)."""
    n = g.shape[axis]
    fwd = torch.cat([g.narrow(axis, 1, n - 1), g.narrow(axis, n - 1, 1)],
                    axis)
    bwd = torch.cat([g.narrow(axis, 0, 1), g.narrow(axis, 0, n - 1)], axis)
    return (fwd - bwd) * 0.5


def _lk_refine(g0: torch.Tensor, g1w: torch.Tensor, u: torch.Tensor,
               v: torch.Tensor, win: int, eps: float):
    """One Lucas-Kanade increment on top of (u, v) (g1w pre-warped)."""
    ix = _grad_central(g0, -1)
    iy = _grad_central(g0, -2)
    it = g1w - g0
    sxx = _box(ix * ix, win) + eps
    syy = _box(iy * iy, win) + eps
    sxy = _box(ix * iy, win)
    sxt = _box(ix * it, win)
    syt = _box(iy * it, win)
    det = sxx * syy - sxy * sxy
    det = torch.where(torch.abs(det) < 1e-6, 1e-6, det)
    du = (-syy * sxt + sxy * syt) / det
    dv = (sxy * sxt - sxx * syt) / det
    # the increments are clamped: the linearization holds for small motion
    lim = float(win)
    return u + torch.clamp(du, -lim, lim), v + torch.clamp(dv, -lim, lim)


def _resize(x: torch.Tensor, hw: tuple) -> torch.Tensor:
    """``jax.image.resize(x, (T, *hw), "bilinear")`` of (T, h, w) for
    ``hw`` no smaller than (h, w), one weight matrix an axis."""
    h, w = x.shape[-2:]
    if hw[0] != h:
        x = torch.matmul(upsample_weights(h, hw[0], x.device).to(x.dtype).T,
                         x)
    if hw[1] != w:
        x = torch.matmul(x, upsample_weights(w, hw[1], x.device).to(x.dtype))
    return x


def flow_magnitude_device(frames: torch.Tensor, levels: int = 3,
                          win: int = 7, iters: int = 2,
                          eps: float = 1e-3) -> torch.Tensor:
    """(T, H, W, 3) uint8/float RGB -> (T-1, H, W) float32 |fx| + |fy|.

    Same contract as ``data/flow.py::flow_magnitude_sequence`` (ref:
    fitdgp_util.py:454-467), computed on the frames' device, in full-res
    pixels. Takes no gradient (the flow gates the clique; it is made from
    input frames, not from parameters). Floating-point frames keep their
    dtype: a float64 run is the tests' reference for the float32 one.
    """
    with torch.no_grad(), torch.profiler.record_function(
            "flow_magnitude_device"):
        if not frames.is_floating_point():
            frames = frames.to(torch.float32)
        t = frames.shape[0]
        if t < 2:
            return frames.new_zeros((0, frames.shape[1], frames.shape[2]))
        gray = (frames[..., 0] * _GRAY[0] + frames[..., 1] * _GRAY[1]
                + frames[..., 2] * _GRAY[2])
        g0, g1 = gray[:-1], gray[1:]

        # pyramid from half resolution down
        p0, p1 = [_down2(g0)], [_down2(g1)]
        for _ in range(levels - 1):
            p0.append(_down2(p0[-1]))
            p1.append(_down2(p1[-1]))

        u = torch.zeros_like(p0[-1])
        v = torch.zeros_like(p0[-1])
        for lvl in range(levels - 1, -1, -1):
            a0, a1 = p0[lvl], p1[lvl]
            if u.shape != a0.shape:
                u = 2.0 * _resize(u, a0.shape[-2:])
                v = 2.0 * _resize(v, a0.shape[-2:])
            for _ in range(iters):
                u, v = _lk_refine(a0, _warp(a1, u, v), u, v, win, eps)

        # solved at half resolution: scale the units, upsample to full
        return 2.0 * _resize(torch.abs(u) + torch.abs(v), g0.shape[-2:])

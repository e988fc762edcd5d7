"""Keypoint-aware augmentation on the device, in PyTorch.

The port's own copy of ``deepgraphpose_tpu/ops/augment_device.py``. When
the training frames live on the card (``train/device_data.py`` pools), the
augmentation runs there too, so no full-resolution frame crosses to the
host and back each iteration:

* one inverse-affine bilinear gather implements scale jitter / random
  crop / horizontal flip / rotation / crop-and-pad, with an optional
  elastic displacement field folded into the same gather;
* photometric ops (motion blur, coarse dropout, additive gaussian noise)
  follow as elementwise and 3x3 stencil work;
* keypoints move by the forward affine; joints leaving the canvas are
  marked absent.

Per-op application gates are Bernoulli draws blended into the parameters
(identity when off), so every sample of a batch runs the same ops.

The random draws are split from their use: :func:`draw_augment` makes
every random value the JAX version draws, in its shapes, from a
``torch.Generator`` on the batch's device, and :func:`apply_augment`
applies given draws. jax.random and torch streams differ, so the parity
tests feed both packages the same draws. :func:`augment_batch` is the two
in a row.

Capability parity with the reference's imgaug pipeline (ref:
src/deepgraphpose/models/fitdgp_util.py:412-451) and its deviations are
the JAX module's; see its docstring. The JAX module's multi-pass
``fast_warp`` works around slow per-pixel gathers on the TPU; here the
one-shot gather always runs (``DeviceAugmentConfig.fast_warp`` is kept so
that configs read the same).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class DeviceAugmentConfig:
    """Static augmentation parameters (the JAX package's fields)."""

    apply_prob: float = 0.8
    # geometric
    scale_jitter: tuple = (1.0, 1.0)   # (lo, up) relative to the canvas
    flip: bool = True
    rotate_deg: float = 10.0
    crop_pad_percent: tuple = (-0.3, 0.1)
    crop_pad_prob: float = 0.4
    elastic_alpha: float = 10.0
    elastic_cell: int = 12             # displacement-field grid spacing (px)
    # photometric
    motion_blur: bool = True
    dropout_frac: tuple = (0.0, 0.02)
    dropout_cell: int = 16             # static dropout grid spacing (px)
    noise_scale: float = 0.01 * 255.0
    # the JAX package's TPU warp switch; the one-shot gather runs either way
    fast_warp: bool = True

    @classmethod
    def reference(cls, scale_jitter: tuple = (1.0, 1.0)):
        """The reference's step-2 pipeline settings (build_aug)."""
        return cls(scale_jitter=scale_jitter)

    @classmethod
    def jitter_only(cls, lo: float, up: float):
        """Step-0 default-loader semantics: scale jitter, nothing else
        (ref: pose_defaultdataset.py:132-135; no imgaug in fit_dlc)."""
        return cls(apply_prob=0.0, scale_jitter=(lo, up), flip=False,
                   rotate_deg=0.0, crop_pad_prob=0.0, elastic_alpha=0.0,
                   motion_blur=False, dropout_frac=(0.0, 0.0),
                   noise_scale=0.0)


def _elastic_grid(cfg: DeviceAugmentConfig, hw: tuple) -> tuple[int, int]:
    h, w = hw
    return (max(2, -(-h // cfg.elastic_cell) + 1),
            max(2, -(-w // cfg.elastic_cell) + 1))


def draw_augment(generator: torch.Generator, cfg: DeviceAugmentConfig,
                 b: int, hw: tuple) -> dict:
    """Every random value the JAX ``augment_batch`` draws for a batch of
    ``b`` frames of ``hw``, in its shapes, as float32 tensors on
    ``generator``'s device. Ranges are the JAX draws' ``minval``/``maxval``;
    keys without a range are uniform in [0, 1)."""
    h, w = hw
    dev = generator.device

    def uniform(shape, lo=0.0, hi=1.0):
        u = torch.rand(shape, generator=generator, device=dev)
        return lo + (hi - lo) * u

    lo, up = cfg.scale_jitter
    d = {"scale": uniform((b,), lo, up), "crop_u": uniform((b, 2)),
         "rot_ang": uniform((b,), -cfg.rotate_deg, cfg.rotate_deg),
         "rot_u": uniform((b,)),
         "cp_pct": uniform((b,), *cfg.crop_pad_percent),
         "cp_u": uniform((b,))}
    if cfg.flip:
        d["flip_u"] = uniform((b,))
    if cfg.elastic_alpha > 0:
        gh, gw = _elastic_grid(cfg, hw)
        d["el_coarse"] = uniform((b, gh, gw, 2), -1.0, 1.0)
        d["el_alpha"] = uniform((b,), 0.0, cfg.elastic_alpha)
        d["el_u"] = uniform((b,))
    if cfg.motion_blur:
        d["mb_ang"] = uniform((b,), -90.0, 90.0)
        d["mb_u"] = uniform((b,))
    if cfg.dropout_frac[1] > 0:
        d["do_frac"] = uniform((b, 1, 1), *cfg.dropout_frac)
        d["do_u"] = uniform((b,))
        d["do_keep_u"] = uniform((b, -(-h // cfg.dropout_cell),
                                  -(-w // cfg.dropout_cell)))
    if cfg.noise_scale > 0:
        d["no_scale"] = uniform((b,), 0.0, cfg.noise_scale)
        d["no_u"] = uniform((b,))
        d["no_n"] = torch.randn((b, h, w, 1), generator=generator, device=dev)
    return d


def _cos_sin(th: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """cos and sin of per-sample angles, in float64 and rounded once to
    float32: the card's and the CPU's float32 cos and sin differ by an ulp
    for some angles, and an ulp of the rotation moves the far pixels of a
    747x832 warp by 5e-5 px, a 0-255 pixel by up to 1e-2."""
    th = th.double()
    return torch.cos(th).float(), torch.sin(th).float()


def _affine_params(draws: dict, cfg: DeviceAugmentConfig, hw: tuple,
                   content_wh: torch.Tensor, gate: torch.Tensor):
    """Per-sample forward affine  p_out = A @ p + t  (pixel x, y coords).

    Composition (host order, data/augment.py augment_one): scale jitter with
    top-left placement / random crop, then flip and rotation about the
    canvas center, then crop-and-pad as a center scale.
    """
    h, w = hw
    on = gate > 0
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0

    # scale jitter; when the scaled content overflows the canvas, a random
    # window is cropped (translation in [W - s*w_c, 0])
    s = torch.where(on, draws["scale"], 1.0)
    over = torch.clamp(torch.stack([w - s * content_wh[:, 0],
                                    h - s * content_wh[:, 1]], -1), max=0.0)
    t_crop = draws["crop_u"] * over

    if cfg.flip:
        do_flip = draws["flip_u"] < cfg.apply_prob * 0.5
        fx = torch.where(do_flip & on, -1.0, 1.0)
    else:
        fx = torch.ones_like(s)

    do_rot = draws["rot_u"] < cfg.apply_prob
    ang = torch.where(do_rot & on, draws["rot_ang"], 0.0)
    th = torch.deg2rad(ang)
    c, sn = _cos_sin(th)

    # crop-and-pad: center scale by 1/(1+pct), keep_size
    do_cp = draws["cp_u"] < cfg.crop_pad_prob
    sc = torch.where(do_cp & on, 1.0 / (1.0 + draws["cp_pct"]), 1.0)

    # A = sc * Rot @ Flip * s; t composes the crop and the two centers:
    #   p2 = R F (s p + t_crop - ctr) + ctr ; p3 = sc (p2 - ctr) + ctr
    a11 = sc * c * fx * s
    a12 = sc * (-sn) * s
    a21 = sc * sn * fx * s
    a22 = sc * c * s
    A = torch.stack([torch.stack([a11, a12], -1),
                     torch.stack([a21, a22], -1)], -2)        # (b, 2, 2)
    # the centers as Python floats: a constant tensor would be a copy from
    # the host on every call
    vx, vy = t_crop[:, 0] - cx, t_crop[:, 1] - cy
    t = torch.stack([sc * (c * fx * vx - sn * vy) + cx,
                     sc * (sn * fx * vx + c * vy) + cy], -1)
    return A, t


def _inverse_affine(A: torch.Tensor) -> torch.Tensor:
    det = A[:, 0, 0] * A[:, 1, 1] - A[:, 0, 1] * A[:, 1, 0]
    det = torch.where(torch.abs(det) < 1e-8, 1e-8, det)
    return torch.stack([
        torch.stack([A[:, 1, 1], -A[:, 0, 1]], -1),
        torch.stack([-A[:, 1, 0], A[:, 0, 0]], -1)], -2) / det[:, None, None]


def _bilinear_gather(images: torch.Tensor, xs: torch.Tensor,
                     ys: torch.Tensor) -> torch.Tensor:
    """Sample images (B, H, W, C) at float coords xs/ys (B, H, W); out of
    the image -> 0. Four flattened gathers."""
    b, h, w, ch = images.shape
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    wx = (xs - x0)[..., None]
    wy = (ys - y0)[..., None]
    valid = ((xs >= 0) & (xs <= w - 1) & (ys >= 0) & (ys <= h - 1))

    x0i = torch.clamp(x0.to(torch.int64), 0, w - 1)
    y0i = torch.clamp(y0.to(torch.int64), 0, h - 1)
    x1i = torch.clamp(x0i + 1, 0, w - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    flat = images.reshape(b, h * w, ch)

    def take(yi, xi):
        idx = (yi * w + xi).reshape(b, h * w, 1).expand(b, h * w, ch)
        return torch.gather(flat, 1, idx).reshape(b, h, w, ch)

    out = ((1 - wy) * ((1 - wx) * take(y0i, x0i) + wx * take(y0i, x1i))
           + wy * ((1 - wx) * take(y1i, x0i) + wx * take(y1i, x1i)))
    return out * valid[..., None]


def upsample_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_in, n_out) bilinear weights with half-pixel centers, normalized
    per output sample: ``jax.image.resize``'s weight matrix for an
    upsampling (``jax/_src/image/scale.py::compute_weight_mat``)."""
    inv_scale = 1.0 / (n_out / n_in)
    sample = ((torch.arange(n_out, dtype=torch.float32, device=device) + 0.5)
              * inv_scale - 0.5)
    x = torch.abs(sample[None, :] - torch.arange(
        n_in, dtype=torch.float32, device=device)[:, None])
    wts = torch.clamp(1.0 - x, min=0.0)
    total = torch.sum(wts, dim=0, keepdim=True)
    wts = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                      wts / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], wts, 0.0)


def _elastic_field(draws: dict, cfg: DeviceAugmentConfig, hw: tuple,
                   gate: torch.Tensor) -> torch.Tensor:
    """Smooth per-sample displacement field (B, H, W, 2), zero when gated
    off: the coarse draws upsampled bilinearly by ``jax.image.resize``'s
    weights (``F.interpolate`` computes the same field with other
    rounding, enough to move a 0-255 edge past 1e-3 at ``elastic_alpha``
    10)."""
    coarse = draws["el_coarse"]
    wh = upsample_weights(coarse.shape[1], hw[0], coarse.device)
    ww = upsample_weights(coarse.shape[2], hw[1], coarse.device)
    field = torch.einsum("bixc,iy->byxc",
                         torch.einsum("bijc,jx->bixc", coarse, ww), wh)
    on = (draws["el_u"] < cfg.apply_prob) & (gate > 0)
    alpha = torch.where(on, draws["el_alpha"], 0.0)
    return field * alpha[:, None, None, None]


_OFFSETS = [(oy, ox) for oy in (-1, 0, 1) for ox in (-1, 0, 1)]


def _motion_blur(draws: dict, cfg: DeviceAugmentConfig, images: torch.Tensor,
                 gate: torch.Tensor) -> torch.Tensor:
    """3x3 directional blur with a random angle, as 9 shifted adds."""
    th = torch.deg2rad(draws["mb_ang"])
    dx, dy = _cos_sin(th)
    # weight of cell offset o: on the line through the center along (dx, dy)
    perp = torch.stack([torch.abs(oy * dx - ox * dy)
                        for oy, ox in _OFFSETS], -1)              # (b, 9)
    wgt = torch.clamp(1.0 - perp, min=0.0)
    wgt = wgt / torch.sum(wgt, dim=1, keepdim=True)
    ident = (torch.arange(9, device=images.device) == 4).to(images.dtype)
    on = (draws["mb_u"] < cfg.apply_prob) & (gate > 0)
    wgt = torch.where(on[:, None], wgt, ident[None, :])
    padded = F.pad(images, (0, 0, 1, 1, 1, 1))
    h, w = images.shape[1:3]
    out = torch.zeros_like(images)
    for i, (oy, ox) in enumerate(_OFFSETS):
        out = out + (wgt[:, i, None, None, None]
                     * padded[:, 1 + oy:h + 1 + oy, 1 + ox:w + 1 + ox, :])
    return out


def _coarse_dropout(draws: dict, cfg: DeviceAugmentConfig,
                    images: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    h, w = images.shape[1:3]
    on = (draws["do_u"] < cfg.apply_prob) & (gate > 0)
    frac = torch.where(on[:, None, None], draws["do_frac"], 0.0)
    keep = (draws["do_keep_u"] >= frac).to(images.dtype)
    cell = cfg.dropout_cell
    mask = keep.repeat_interleave(cell, 1).repeat_interleave(cell, 2)
    return images * mask[:, :h, :w, None]


def _noise(draws: dict, cfg: DeviceAugmentConfig, images: torch.Tensor,
           gate: torch.Tensor) -> torch.Tensor:
    on = (draws["no_u"] < cfg.apply_prob) & (gate > 0)
    scale = torch.where(on, draws["no_scale"], 0.0)
    return torch.clamp(images + scale[:, None, None, None] * draws["no_n"],
                       0.0, 255.0)


def apply_augment(images: torch.Tensor, coords_xy: torch.Tensor,
                  present: torch.Tensor, cfg: DeviceAugmentConfig,
                  draws: dict, gate: torch.Tensor | None = None,
                  content_wh: torch.Tensor | None = None):
    """Augment a batch with given draws (:func:`draw_augment`'s keys).

    Args:
      images: (B, H, W, 3) uint8 or float32, [0, 255].
      coords_xy: (B, nj, 2) pixel (x, y) keypoints.
      present: (B, nj) bool/float visibility.
      cfg: DeviceAugmentConfig.
      draws: the random values, on the images' device.
      gate: optional (B,) {0, 1}: samples with gate 0 pass through
        untouched (e.g. hidden frames: the reference augments visible
        frames only, ref: fitdgp.py:779).
      content_wh: optional (B, 2) content (w, h) per canvas for the random
        crop bound; defaults to the full canvas.

    Returns (images_f32, coords_xy, present_f32).
    """
    b, h, w, _ = images.shape
    dev = images.device
    images = images.to(torch.float32)
    gate = (torch.ones(b, device=dev) if gate is None
            else gate.to(torch.float32))
    if content_wh is None:
        content_wh = torch.stack([torch.full((b,), float(w), device=dev),
                                  torch.full((b,), float(h), device=dev)], -1)
    A, t = _affine_params(draws, cfg, (h, w), content_wh, gate)

    # one-shot per-pixel gather: src = A^-1 @ (dst - t) (+ elastic)
    ainv = _inverse_affine(A)
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    rel_x = xs[None] - t[:, 0, None, None]
    rel_y = ys[None] - t[:, 1, None, None]
    src_x = (ainv[:, 0, 0, None, None] * rel_x
             + ainv[:, 0, 1, None, None] * rel_y)
    src_y = (ainv[:, 1, 0, None, None] * rel_x
             + ainv[:, 1, 1, None, None] * rel_y)
    if cfg.elastic_alpha > 0:
        elastic = _elastic_field(draws, cfg, (h, w), gate)
        src_x = src_x + elastic[..., 0]
        src_y = src_y + elastic[..., 1]
    out = _bilinear_gather(images, src_x, src_y)

    if cfg.motion_blur:
        out = _motion_blur(draws, cfg, out, gate)
    if cfg.dropout_frac[1] > 0:
        out = _coarse_dropout(draws, cfg, out, gate)
    if cfg.noise_scale > 0:
        out = _noise(draws, cfg, out, gate)

    # keypoints: forward affine; out of the canvas -> absent
    x = coords_xy[..., 0].to(torch.float32)
    y = coords_xy[..., 1].to(torch.float32)
    kp = torch.stack([A[:, 0, 0, None] * x + A[:, 0, 1, None] * y,
                      A[:, 1, 0, None] * x + A[:, 1, 1, None] * y], -1)
    kp = kp + t[:, None, :]
    inb = ((kp[..., 0] >= 0) & (kp[..., 0] <= w - 1)
           & (kp[..., 1] >= 0) & (kp[..., 1] <= h - 1))
    present = present.to(torch.float32) * inb.to(torch.float32)
    return out, kp, present


def augment_batch(generator: torch.Generator, images: torch.Tensor,
                  coords_xy: torch.Tensor, present: torch.Tensor,
                  cfg: DeviceAugmentConfig, gate: torch.Tensor | None = None,
                  content_wh: torch.Tensor | None = None):
    """Draw (:func:`draw_augment`) and apply (:func:`apply_augment`) in one
    call; ``generator`` lies on the images' device."""
    b, h, w, _ = images.shape
    draws = draw_augment(generator, cfg, b, (h, w))
    return apply_augment(images, coords_xy, present, cfg, draws, gate=gate,
                         content_wh=content_wh)

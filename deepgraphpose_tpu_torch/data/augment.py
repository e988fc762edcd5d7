"""Keypoint-aware image augmentation (host-side, numpy/OpenCV).

Capability parity with the reference's imgaug pipeline (ref:
src/deepgraphpose/models/fitdgp_util.py:412-436 build_aug / 439-451
data_aug): horizontal flip, +/-10 deg rotation, motion blur, coarse dropout,
elastic transformation, additive gaussian noise, crop-and-pad — each applied
with a per-image probability; keypoints are transformed in *pixel* space and
mapped back to scoremap coordinates by the caller's convention
(pixels = rc * stride + stride/2).

This is the port's own copy of ``deepgraphpose_tpu/data/augment.py``: the
same ops, drawn in the same order from a numpy ``Generator``, so one seed
gives the same batch in both packages. The ops are written directly on
cv2/numpy (no imgaug); ``cv2`` is imported where an op uses it. Geometric
ops (flip / rotate / crop-pad) move the keypoints; photometric ops (blur /
noise / dropout) do not. Elastic transformation uses a smoothed random
displacement field applied to the image only: with the reference's sigma=5,
alpha<=10 the mean keypoint displacement is sub-pixel, as imgaug warps
keypoints negligibly at these settings.
"""

from __future__ import annotations

import numpy as np


class Augmenter:
    """Stateless-per-call augmentation pipeline."""

    def __init__(self, apply_prob: float = 0.8,
                 rotate_deg: float = 10.0,
                 motion_blur_k: int = 3,
                 dropout_frac: tuple = (0.0, 0.02),
                 dropout_size: tuple = (0.01, 0.05),
                 elastic_alpha: tuple = (0.0, 10.0),
                 elastic_sigma: float = 5.0,
                 noise_scale: float = 0.01 * 255,
                 crop_pad_percent: tuple = (-0.3, 0.1),
                 crop_pad_prob: float = 0.4):
        self.apply_prob = apply_prob
        self.rotate_deg = rotate_deg
        self.motion_blur_k = motion_blur_k
        self.dropout_frac = dropout_frac
        self.dropout_size = dropout_size
        self.elastic_alpha = elastic_alpha
        self.elastic_sigma = elastic_sigma
        self.noise_scale = noise_scale
        self.crop_pad_percent = crop_pad_percent
        self.crop_pad_prob = crop_pad_prob

    # -- individual ops (image HxWx3 float32 [0,255], kps (nj,2) pixel x,y) --

    @staticmethod
    def _flip(img, kps):
        img = img[:, ::-1].copy()
        kps = kps.copy()
        kps[:, 0] = (img.shape[1] - 1) - kps[:, 0]
        return img, kps

    @staticmethod
    def _rotate(img, kps, deg):
        import cv2

        h, w = img.shape[:2]
        m = cv2.getRotationMatrix2D((w / 2.0, h / 2.0), deg, 1.0)
        img = cv2.warpAffine(img, m, (w, h), flags=cv2.INTER_LINEAR,
                             borderMode=cv2.BORDER_CONSTANT)
        ones = np.ones((len(kps), 1))
        kps = np.hstack([kps, ones]) @ m.T
        return img, kps

    def _motion_blur(self, img, rng):
        import cv2

        k = self.motion_blur_k
        kernel = np.zeros((k, k), np.float32)
        angle = rng.uniform(-90, 90)
        c = (k - 1) / 2.0
        dx, dy = np.cos(np.deg2rad(angle)), np.sin(np.deg2rad(angle))
        for t in np.linspace(-c, c, 2 * k):
            x, y = int(round(c + t * dx)), int(round(c + t * dy))
            if 0 <= x < k and 0 <= y < k:
                kernel[y, x] = 1
        kernel /= max(kernel.sum(), 1)
        return cv2.filter2D(img, -1, kernel)

    def _coarse_dropout(self, img, rng):
        h, w = img.shape[:2]
        frac = rng.uniform(*self.dropout_frac)
        size = rng.uniform(*self.dropout_size)
        cell = max(2, int(min(h, w) * size))
        n = int(frac * (h * w) / (cell * cell))
        out = img.copy()
        for _ in range(n):
            y = rng.integers(0, max(h - cell, 1))
            x = rng.integers(0, max(w - cell, 1))
            out[y:y + cell, x:x + cell] = 0
        return out

    def _elastic(self, img, rng):
        import cv2

        h, w = img.shape[:2]
        alpha = rng.uniform(*self.elastic_alpha)
        sigma = self.elastic_sigma
        k = int(sigma * 3) | 1
        dx = cv2.GaussianBlur(
            rng.uniform(-1, 1, (h, w)).astype(np.float32), (k, k), sigma) * alpha
        dy = cv2.GaussianBlur(
            rng.uniform(-1, 1, (h, w)).astype(np.float32), (k, k), sigma) * alpha
        xx, yy = np.meshgrid(np.arange(w, dtype=np.float32),
                             np.arange(h, dtype=np.float32))
        return cv2.remap(img, xx + dx, yy + dy, cv2.INTER_LINEAR,
                         borderMode=cv2.BORDER_REFLECT)

    def _noise(self, img, rng):
        scale = rng.uniform(0, self.noise_scale)
        per_channel = rng.random() < 0.5
        shape = img.shape if per_channel else img.shape[:2] + (1,)
        return np.clip(img + rng.normal(0, scale, shape), 0, 255).astype(img.dtype)

    def _crop_pad(self, img, kps, rng):
        import cv2

        h, w = img.shape[:2]
        pct = rng.uniform(*self.crop_pad_percent)
        if abs(pct) < 1e-6:
            return img, kps
        if pct < 0:   # crop inward then resize back (keep_size=True)
            dy, dx = int(-pct * h / 2), int(-pct * w / 2)
            crop = img[dy:h - dy, dx:w - dx]
            sy, sx = h / max(crop.shape[0], 1), w / max(crop.shape[1], 1)
            img = cv2.resize(crop, (w, h))
            kps = (kps - [dx, dy]) * [sx, sy]
        else:         # pad outward then resize back
            dy, dx = int(pct * h / 2), int(pct * w / 2)
            padded = cv2.copyMakeBorder(img, dy, dy, dx, dx,
                                        cv2.BORDER_CONSTANT, value=0)
            sy = h / padded.shape[0]
            sx = w / padded.shape[1]
            img = cv2.resize(padded, (w, h))
            kps = (kps + [dx, dy]) * [sx, sy]
        return img, kps

    # -- pipeline -------------------------------------------------------

    def augment_one(self, img: np.ndarray, kps_xy: np.ndarray, rng):
        """img float32 HxWx3 [0..255]; kps (nj,2) pixel (x,y), NaN allowed."""
        nan = np.isnan(kps_xy[:, 0])
        kps = np.nan_to_num(kps_xy)
        if rng.random() < self.apply_prob and rng.random() < 0.5:
            img, kps = self._flip(img, kps)
        if rng.random() < self.apply_prob:
            img, kps = self._rotate(img, kps, rng.uniform(-self.rotate_deg,
                                                          self.rotate_deg))
        if rng.random() < self.apply_prob:
            img = self._motion_blur(img, rng)
        if rng.random() < self.apply_prob:
            img = self._coarse_dropout(img, rng)
        if rng.random() < self.apply_prob:
            img = self._elastic(img, rng)
        if rng.random() < self.apply_prob:
            img = self._noise(img, rng)
        if rng.random() < self.crop_pad_prob:
            img, kps = self._crop_pad(img, kps, rng)
        kps = kps.astype(np.float32)
        kps[nan] = np.nan
        return img, kps

    def __call__(self, images: np.ndarray, coords_rc: np.ndarray,
                 frame_visible: np.ndarray, cfg, rng=None):
        """Batch entry point matching data/batcher.assemble_batch.

        images: (T,H,W,3) float32; coords_rc: (T,nj,2) scoremap (row,col);
        only visible frames are augmented (ref: fitdgp.py:779).
        """
        if rng is None:
            rng = np.random.default_rng()
        stride = cfg.stride
        out_imgs = images.copy()
        out_rc = coords_rc.copy()
        for t in np.where(frame_visible)[0]:
            # rc -> pixel (x, y)
            kps = np.stack([coords_rc[t, :, 1] * stride + stride / 2,
                            coords_rc[t, :, 0] * stride + stride / 2], -1)
            img, kps = self.augment_one(images[t], kps, rng)
            out_imgs[t] = img
            out_rc[t, :, 0] = (kps[:, 1] - stride / 2) / stride
            out_rc[t, :, 1] = (kps[:, 0] - stride / 2) / stride
        return out_imgs, out_rc

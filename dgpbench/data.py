"""Inputs and weights of a run, made on the device from ``--seed``.

The same seed gives the same frames and the same weights, which both the
program and the reference are handed. Weights are one draw of normals for
the whole model, scaled per tensor so that activations stay of order one
through the depth (He-normal convs, batch norms near identity, residual
branches closed at 0.3) and the score maps have logits of a few units.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from dgpbench.reference import families, models

PIXEL_STD = 60.0        # about the frames' spread around the mean pixel
HEAD_GAIN = 1.5         # about the score maps' logit spread
BLOBS = 6               # bright or dark spots a frame
CHUNK = 32              # frames made per device call


def sub_seed(seed: int, what: str) -> int:
    """A 63-bit seed of its own for each use of ``seed``."""
    digest = hashlib.sha256(f"{int(seed)}/{what}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def make_frames(seed: int, n: int, hw, device) -> np.ndarray:
    """``n`` uint8 RGB frames (n, H, W, 3): a smooth texture around mid
    grey, blobs of various sizes, and sensor noise."""
    h, w = hw
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "frames"))
    out = np.empty((n, h, w, 3), np.uint8)
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    for i in range(0, n, CHUNK):
        c = min(CHUNK, n - i)
        low = torch.randn((c, 3, 12, 14), generator=gen, device=device)
        img = 128.0 + 50.0 * F.interpolate(low, size=(h, w), mode="bilinear",
                                           align_corners=False)
        u = torch.rand((c, BLOBS, 6), generator=gen, device=device)
        for b in range(BLOBS):
            cy, cx = u[:, b, 0] * h, u[:, b, 1] * w
            sigma = 0.01 * (h + w) + 0.05 * (h + w) * u[:, b, 2]
            amp = 200.0 * (u[:, b, 3:6] - 0.5)
            d2 = ((yy[None] - cy[:, None, None]) ** 2
                  + (xx[None] - cx[:, None, None]) ** 2)
            spot = torch.exp(-d2 / (2.0 * sigma[:, None, None] ** 2))
            img += amp[:, :, None, None] * spot[:, None]
        img += 4.0 * torch.randn(img.shape, generator=gen, device=device)
        frames = img.clamp_(0.0, 255.0).round_().to(torch.uint8)
        out[i:i + c] = frames.permute(0, 2, 3, 1).cpu().numpy()
    return out


def shared_init(role: str, z: torch.Tensor, shape) -> torch.Tensor | None:
    """The scaling of the standard normals ``z`` of a weight of a role
    that every family uses, or None for a role of a family's own."""
    if role in ("conv", "root", "linear"):
        fan_in = shape[1] * shape[2] * shape[3]
        gain = {"conv": 2.0, "linear": 1.0, "root": 1.0 / PIXEL_STD ** 2}[role]
        return z * math.sqrt(gain / fan_in)
    if role == "head":
        # a transposed conv of stride 2: about (k / 2)^2 taps an output
        return z * (HEAD_GAIN / math.sqrt(shape[0] * (shape[2] / 2) ** 2))
    if role == "head_bias":
        return 0.1 * z
    kind, _, part = role.partition(".")
    if kind not in ("bn", "bn_residual"):
        return None
    if part == "scale":
        return (0.3 if kind == "bn_residual" else 1.0) * (1.0 + 0.1 * z)
    if part == "var":
        return torch.exp(0.2 * z)
    return 0.1 * z


@torch.no_grad()
def make_weights(cfg: dict, seed: int, device) -> dict:
    """{state-dict name: float32 tensor on ``device``} for the model of
    ``cfg``, from one draw of normals. A role outside the shared ones is
    scaled by the family's ``init``."""
    specs = models.param_specs(cfg)
    family = families.find(cfg)
    total = sum(math.prod(shape) for _, shape, _ in specs)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed,
                                                              "weights"))
    flat = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for name, shape, role in specs:
        n = math.prod(shape)
        z = flat[off:off + n].view(shape)
        off += n
        t = shared_init(role, z, shape)
        if t is None and hasattr(family, "init"):
            t = family.init(role, z, shape)
        if t is None:
            raise ValueError(f"{name}: role {role!r} is not shared and "
                             f"family {cfg['family']!r} has no init for it")
        out[name] = t
    return out

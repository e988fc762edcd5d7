"""The pose models in plain PyTorch, from a flat dict of weights.

The weights are named and shaped as the program's ``PoseModel`` state
dict (conv weights OIHW, transposed-conv weights (in, out, k, k), frozen
batch norm as scale, bias, moving mean and variance), so that the one set
of seeded tensors loads into the program and feeds this reference.

:func:`forward` runs NCHW float32 convolutions through ``conv``, which a
control may replace by a lower-precision one; TF32 must be off
(:func:`exact_float32`).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from dgpbench.reference import arch, families

BN_EPS = 1e-5


@contextlib.contextmanager
def exact_float32():
    """float32 convolutions and products in full float32 (no TF32)."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32, cudnn.benchmark
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    cudnn.benchmark = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32, cudnn.benchmark = saved


def param_specs(cfg: dict) -> list[tuple]:
    """(name, shape, role) of every weight, in the program's state-dict
    names: the backbone's as its family declares them
    (``families/<family>.py``), then the heads'. Roles: ``conv`` (a conv
    whose input is an activation), ``root`` (the first conv, on raw
    pixels), ``linear`` (a conv whose output adds into a residual stream
    without an activation), ``bn``, ``bn_residual`` (a batch norm that
    closes a residual branch), ``head``, ``head_bias``, and any role of a
    family's own, which its ``init`` scales."""
    specs: list[tuple] = []

    def conv(name, cout, cin, k, role="conv"):
        specs.append((f"backbone.{name}.weight", (cout, cin, k, k), role))

    def bn(name, c, role="bn"):
        for part in ("scale", "bias", "mean", "var"):
            specs.append((f"backbone.{name}.{part}", (c,), f"{role}.{part}"))

    feat = families.find(cfg).specs(cfg, conv, bn)
    nj, k = cfg["num_joints"], 3
    heads = [("part_pred", nj)]
    if cfg["location_refinement"]:
        heads.append(("locref_pred", 2 * nj))
    for name, cout in heads:
        specs.append((f"{name}.block4.weight", (feat, cout, k, k), "head"))
        specs.append((f"{name}.block4.bias", (cout,), "head_bias"))
    return specs


def frozen_bn(w: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    """Frozen batch norm ``name`` of NCHW ``x``."""
    inv = w[f"{name}.scale"] / torch.sqrt(w[f"{name}.var"] + BN_EPS)
    shift = w[f"{name}.bias"] - w[f"{name}.mean"] * inv
    return x * inv[:, None, None] + shift[:, None, None]


def plain_conv(x, weight, stride=1, padding=0, dilation=1, groups=1):
    return F.conv2d(x, weight, None, stride, padding, dilation, groups)


def same_conv(conv, x, weight, stride=1, rate=1, groups=1):
    """``conv`` with TF SAME padding (the odd pixel, if any, padded at
    the high end)."""
    k = weight.shape[-1]
    (top, bottom), (left, right) = (arch.same_pads(k, stride, rate, n)
                                    for n in x.shape[-2:])
    if top != bottom or left != right:
        x = F.pad(x, (left, right, top, bottom))
        top = left = 0
    return conv(x, weight, stride, (top, left), rate, groups)


def relu6(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(0.0, 6.0)


def backbone(cfg: dict, w: dict, x: torch.Tensor, conv=plain_conv):
    """NCHW float32 input (mean pixel subtracted) -> NCHW features, by the
    configuration's family (``families/<family>.py``)."""
    return families.find(cfg).backbone(cfg, w, x, conv)


def head(w: dict, name: str, x: torch.Tensor, stride: int,
         conv_transpose=F.conv_transpose2d) -> torch.Tensor:
    """DeepLabCut's prediction layer: a 3x3 transposed conv of ``stride``
    with TF SAME padding (the first ``stride * H`` rows and columns of the
    unpadded result for k = 3, stride 2), NCHW in, NHWC float32 out."""
    weight, bias = w[f"{name}.block4.weight"], w[f"{name}.block4.bias"]
    k = weight.shape[-1]
    pad_a = k - 1 if stride > k - 1 else math.ceil((k + stride - 2) / 2)
    a = k - 1 - pad_a
    h, wd = x.shape[-2:]
    y = conv_transpose(x, weight, bias, stride)
    return y[..., a:a + h * stride, a:a + wd * stride].permute(0, 2, 3, 1)


def mean_pixel(cfg: dict, device) -> torch.Tensor:
    return torch.tensor(cfg["mean_pixel"], dtype=torch.float32,
                        device=device)


def forward(cfg: dict, w: dict, images_u8: torch.Tensor, conv=plain_conv,
            conv_transpose=F.conv_transpose2d) -> torch.Tensor:
    """uint8 frames (B, H, W, 3) -> score-map logits (B, H', W', joints),
    float32."""
    x = (images_u8.to(torch.float32) - mean_pixel(cfg, images_u8.device))
    x = x.permute(0, 3, 1, 2).contiguous()
    return head(w, "part_pred", backbone(cfg, w, x, conv),
                cfg["deconvolution_stride"], conv_transpose).contiguous()

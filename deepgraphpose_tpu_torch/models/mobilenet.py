"""MobileNetV2 backbones (width 1.0 / 0.75 / 0.5 / 0.35), in PyTorch.

The port's own copy of ``deepgraphpose_tpu/models/mobilenet.py`` (ref:
deeplabcut/pose_estimation_tensorflow/nnet/pose_net_mobilenet.py:31-200,
mobilenet_v2.py): inverted-residual units with frozen BN and relu6,
output_stride control by dilation, and the feature tap after the final
1x1 conv (1280 channels, scaled by the width with a 1280 floor as in TF
slim).

Padding is flax's ``"SAME"``, which is TF SAME: for a stride-2 conv over
an even side it pads one more on the high side than on the low one (at
747x832 the stride-2 convs pad H by (1, 1) and W by (0, 1)).
``nn.Conv2d(padding=...)`` pads both sides alike, so :class:`SameConv2d`
pads explicitly where the two sides differ (:func:`same_pads`).

Layout and precision as ``models/resnet.py``: NCHW tensors in
``channels_last`` memory, weights in ``param_dtype`` cast to the compute
dtype at each conv, batch-norm in float32. As there, inference on the card
runs each batch-norm with its relu6, or with the unit's residual add, as
one launch of ``csrc/bn_act.cu`` (``models/resnet.py::bn_act``), bitwise
equal to the plain chain that every other call runs.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from deepgraphpose_tpu_torch.models.resnet import (Conv2d, FrozenBatchNorm,
                                                   bn_act)
# relu6 is the chain's activation (models/quant.py applies it as mnet.relu6)
from deepgraphpose_tpu_torch.ops.kernels.bn_act_kernel import relu6  # noqa

# (expansion, out_channels, num_units, first_stride)
_V2_SPEC = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)

WIDTHS = {
    "mobilenet_v2_1.0": 1.0,
    "mobilenet_v2_0.75": 0.75,
    "mobilenet_v2_0.5": 0.5,
    "mobilenet_v2_0.35": 0.35,
}


def _depth(channels: int, multiplier: float, divisor: int = 8) -> int:
    """TF slim make_divisible."""
    v = max(divisor, int(channels * multiplier + divisor / 2) // divisor * divisor)
    if v < 0.9 * channels * multiplier:
        v += divisor
    return v


def unit_plan(width: float, output_stride: int):
    """Resolved per-unit plan: (name, expansion, out_ch, stride, rate).

    The stride/atrous policy in one place, so the float module and the
    int8 walk (models/quant.py) share one structure definition.
    """
    plan = []
    current_stride = 2  # after the stride-2 stem
    rate = 1
    for b, (exp, out_c, n_units, first_stride) in enumerate(_V2_SPEC):
        out_ch = _depth(out_c, width)
        for u in range(n_units):
            stride = first_stride if u == 0 else 1
            if stride != 1 and current_stride >= output_stride:
                unit_stride, unit_rate = 1, rate
                rate *= stride
            else:
                unit_stride, unit_rate = stride, rate
            plan.append((f"block{b}_unit{u}", exp, out_ch, unit_stride,
                         unit_rate))
            current_stride *= unit_stride
    return plan


def stem_depth(width: float) -> int:
    return _depth(32, width)


def head_depth(width: float) -> int:
    """The final 1x1's channels: TF slim keeps at least 1280."""
    return _depth(1280, max(width, 1.0))


def same_pads(k: int, stride: int, rate: int, size: int) -> tuple[int, int]:
    """TF SAME zero pad (low, high) of one side of length ``size``: the
    output keeps ceil(size / stride) and the high side takes the odd one."""
    keff = rate * (k - 1) + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + keff - size, 0)
    return total // 2, total - total // 2


DEPTHWISE_RANGE = "depthwise_conv"  # the profiler range of a depthwise conv


class SameConv2d(Conv2d):
    """A :class:`~models.resnet.Conv2d` with TF SAME padding, worked out
    from the input's size at each call. A depthwise conv (``groups`` > 1)
    runs inside the profiler range ``DEPTHWISE_RANGE``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 rate: int = 1, groups: int = 1, dtype=torch.float32):
        super().__init__(cin, cout, k, stride=stride, padding=0,
                         dilation=rate, groups=groups, bias=False,
                         dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s, r = self.kernel_size[0], self.stride[0], self.dilation[0]
        (top, bottom), (left, right) = (same_pads(k, s, r, n)
                                        for n in x.shape[-2:])
        w = self.weight.to(x.dtype)
        with _depthwise_range(self.groups > 1):
            if top == bottom and left == right:
                return F.conv2d(x, w, None, s, (top, left), r, self.groups)
            return F.conv2d(F.pad(x, (left, right, top, bottom)), w, None, s,
                            0, r, self.groups)


def _depthwise_range(on: bool):
    return (torch.profiler.record_function(DEPTHWISE_RANGE) if on
            else contextlib.nullcontext())


class InvertedResidual(nn.Module):
    """expand 1x1 -> depthwise 3x3 (stride, dilation) -> project 1x1, each
    followed by frozen BN, relu6 after the first two; the skip where the
    stride is 1 and the width is kept."""

    def __init__(self, in_ch: int, expansion: int, out_ch: int, stride: int,
                 rate: int, dtype=torch.float32):
        super().__init__()
        mid = in_ch * expansion
        self.has_expand = expansion != 1
        self.residual = stride == 1 and in_ch == out_ch
        if self.has_expand:
            self.expand = SameConv2d(in_ch, mid, 1, dtype=dtype)
            self.expand_bn = FrozenBatchNorm(mid)
        self.depthwise = SameConv2d(mid, mid, 3, stride, rate, groups=mid,
                                    dtype=dtype)
        self.depthwise_bn = FrozenBatchNorm(mid)
        self.project = SameConv2d(mid, out_ch, 1, dtype=dtype)
        self.project_bn = FrozenBatchNorm(out_ch)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = x
        if self.has_expand:
            y = bn_act(self.expand_bn, self.expand(y), train, "relu6")
        y = bn_act(self.depthwise_bn, self.depthwise(y), train, "relu6")
        return bn_act(self.project_bn, self.project(y), train,
                      residual=x if self.residual else None)


class MobileNetV2(nn.Module):
    """MobileNetV2 trunk: forward(x NCHW, train) -> (features,
    end_points), ``end_points["blockN"]`` the output of block N and
    ``end_points["head"]`` the features; ``out_depth`` their channels."""

    def __init__(self, width: float = 1.0, output_stride: int = 16,
                 dtype=torch.float32, param_dtype=None):
        super().__init__()
        self.dtype = dtype
        pdtype = dtype if param_dtype is None else param_dtype
        ch = stem_depth(width)
        self.conv_stem = SameConv2d(3, ch, 3, 2, dtype=pdtype)
        self.stem_bn = FrozenBatchNorm(ch)
        self.unit_names = []
        for name, exp, out_ch, stride, rate in unit_plan(width,
                                                         output_stride):
            self.add_module(name, InvertedResidual(ch, exp, out_ch, stride,
                                                   rate, dtype=pdtype))
            self.unit_names.append(name)
            ch = out_ch
        self.out_depth = head_depth(width)
        self.conv_head = SameConv2d(ch, self.out_depth, 1, dtype=pdtype)
        self.head_bn = FrozenBatchNorm(self.out_depth)

    def forward(self, x: torch.Tensor, train: bool = False):
        x = x.to(self.dtype)
        x = bn_act(self.stem_bn, self.conv_stem(x), train, "relu6")
        end_points = {}
        for name in self.unit_names:
            x = getattr(self, name)(x, train)
            end_points[name.split("_")[0]] = x
        x = bn_act(self.head_bn, self.conv_head(x), train, "relu6")
        end_points["head"] = x
        return x, end_points


def make_backbone(net_type: str, output_stride: int = 16,
                  dtype=torch.float32, param_dtype=None) -> MobileNetV2:
    if net_type not in WIDTHS:
        raise ValueError(f"unknown mobilenet variant {net_type!r}; "
                         f"available: {sorted(WIDTHS)}")
    return MobileNetV2(width=WIDTHS[net_type], output_stride=output_stride,
                       dtype=dtype, param_dtype=param_dtype)

"""Deconvolutional prediction heads.

ref: deeplabcut/pose_estimation_tensorflow/nnet/pose_net.py:18-26
(prediction_layer: 3x3 conv2d_transpose, stride = deconvolutionstride,
'SAME' padding, no activation).

flax ``nn.ConvTranspose(padding="SAME")`` with kernel W (kh, kw, in, out)
is a stride-dilated correlation with W, padded (pad_a, pad_b) by
``lax.conv_transpose``'s SAME rule. ``conv_transpose2d(x, W.permute(2, 3,
0, 1).flip(-2, -1), stride=s, padding=0)`` computes the same sums padded
by k - 1 on each side, so the flax output is its window starting at
``k - 1 - pad_a`` of length ``s * H``: the first ``2H`` rows for k=3, s=2.
The flip lives in the weights (core/checkpoint.py); the crop lives here.
The weights are cast to the input's (compute) dtype, as in
``models/resnet.py::Conv2d``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

KERNEL = 3


def _same_crop_start(k: int, s: int) -> int:
    # lax.conv_transpose SAME padding: pad_len = k + s - 2,
    # pad_a = k - 1 if s > k - 1 else ceil(pad_len / 2)
    pad_a = k - 1 if s > k - 1 else math.ceil((k + s - 2) / 2)
    return k - 1 - pad_a


class PredictionHead(nn.Module):
    """3x3 transposed conv, stride 2 by default; logits output (NCHW)."""

    def __init__(self, in_features: int, num_outputs: int, stride: int = 2,
                 dtype=torch.float32):
        super().__init__()
        self.stride = stride
        self.start = _same_crop_start(KERNEL, stride)
        self.block4 = nn.ConvTranspose2d(in_features, num_outputs, KERNEL,
                                         stride=stride, padding=0, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        a, s = self.start, self.stride
        conv = self.block4
        y = F.conv_transpose2d(x, conv.weight.to(x.dtype),
                               conv.bias.to(x.dtype), stride=conv.stride)
        return y[..., a:a + h * s, a:a + w * s]

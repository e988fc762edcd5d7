"""ResNet-v1 backbones (50 / 101 / 152) with frozen batch-norm, in PyTorch.

Behavioral spec (ref: deeplabcut/pose_estimation_tensorflow/nnet/
pose_net.py:36-53): slim ``resnet_v1_{50,101,152}`` with
``global_pool=False, output_stride=16, is_training=False``. Strides live on
the *last* unit of each block; once the accumulated stride reaches
``output_stride`` the remaining units switch to dilated (atrous) convs.

Padding follows slim exactly, as in ``deepgraphpose_tpu.models.resnet``:
stride-1 convs are TF 'SAME' and strided convs are slim ``conv2d_same``
(explicit symmetric pad of ``keff - 1``, then VALID). For the odd kernels
used here both reduce to a symmetric pad of ``rate * (k - 1) / 2``, which
``nn.Conv2d(padding=...)`` expresses directly. The root max-pool is VALID.

Layout: modules take NCHW tensors; the port keeps them in
``torch.channels_last`` memory so cuDNN runs NHWC convolutions.

Inference on the card runs each conv's frozen batch-norm, with what
follows it (the ReLU; in a unit's tail the shortcut's batch-norm, the
residual add and the ReLU), as one launch of ``csrc/bn_act.cu``
(:func:`bn_act`). Its output is bitwise the plain chain of PyTorch ops,
which every other call runs: training, autograd, the CPU, float64, and
layouts the kernel does not take (``bn_act_kernel.takes``).

Precision follows flax's split of ``param_dtype`` and ``dtype``: conv
weights live in ``param_dtype`` and are cast to the compute dtype (the
input's) at each conv, so float32 weights train under bfloat16 compute;
``param_dtype`` defaults to ``dtype`` (bfloat16 inference keeps bfloat16
weights, and no cast runs). Batch-norm parameters and statistics stay
float32.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from deepgraphpose_tpu_torch.ops.kernels import bn_act_kernel
from deepgraphpose_tpu_torch.utils import profiling

BLOCK_UNITS = {
    "resnet_50": (3, 4, 6, 3),
    "resnet_101": (3, 4, 23, 3),
    "resnet_152": (3, 8, 36, 3),
}


def same_pad_for_stride(kernel: int, rate: int = 1) -> tuple[int, int]:
    """slim ``conv2d_same`` explicit padding for strided convs: the
    effective kernel minus one, split symmetrically (low side first)."""
    keff = kernel + (kernel - 1) * (rate - 1)
    total = keff - 1
    return (total // 2, total - total // 2)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that casts its weight (and bias) to the input's dtype,
    flax's compute dtype; a no-op where the two agree."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


def _conv(cin: int, cout: int, k: int, stride: int = 1, rate: int = 1,
          dtype=torch.float32) -> Conv2d:
    lo, hi = same_pad_for_stride(k, rate)
    if lo != hi:
        raise ValueError(f"asymmetric pad for kernel {k}, rate {rate}")
    return Conv2d(cin, cout, k, stride=stride, padding=lo, dilation=rate,
                  bias=False, dtype=dtype)


class BatchStats:
    """How a batch-norm in train mode takes its statistics; pass it where
    ``train=True`` goes (``model(images, train=BatchStats(...))``).

    * ``windows > 1``: the batch is that many equal windows, one after
      another on N, and each is normalized by its own statistics; the
      moving stats become the mean over the windows of each window's
      updated stats. This is the JAX package's ``vmap`` over DGP windows
      (``deepgraphpose_tpu/train/device_data.py:614-619``).
    * ``all_sum``: the batch is this rank's equal slice of a global batch
      over ``world`` ranks, normalized by the global batch's statistics
      (XLA's collective in the JAX package's data-parallel step 0).
      ``all_sum`` sums a tensor over the ranks, with autograd through the
      sum; the mean comes first and then the squared deviations, so the
      variance is the biased one of the whole global batch.

    ``BatchStats()`` is ``train=True``.
    """

    def __init__(self, windows: int = 1, all_sum=None, world: int = 1):
        if windows > 1 and all_sum is not None:
            raise ValueError("BatchStats: per-window statistics are local; "
                             "pass windows or all_sum, not both")
        self.windows, self.all_sum, self.world = int(windows), all_sum, world

    def __bool__(self) -> bool:
        return True


class FrozenBatchNorm(nn.Module):
    """Batch-norm as the flax module: inference by default, batch stats
    with ``train=True``.

    ``scale``/``bias`` are parameters that the optimizer trains, and
    ``mean``/``var`` buffers, named as in the flax module. In inference
    (the reference's only mode, ref: pose_net.py:52) it is a per-channel
    affine transform by the moving stats. ``train=True`` normalizes by the
    batch mean and the biased batch variance (over N, H, W, in float32, or
    float64 for float64 input) and updates the moving stats as
    ``0.99 * stat + 0.01 * batch_stat`` (flax momentum 0.99), the
    from-scratch mode of ``deepgraphpose_tpu/models/resnet.py:52-89``;
    ``train`` may also be a :class:`BatchStats` (per-window or global-batch
    statistics).

    ``forward`` is the plain chain of PyTorch ops. Inference on the card
    goes through :func:`bn_act` instead: one kernel launch for the
    batch-norm and what follows it, bitwise equal to this chain. An
    inference call of ``forward`` (no ``train``, no autograd: on the CPU,
    in float64) counts ``dgp.bn.plain`` (``utils/profiling.py``).
    """

    momentum = 0.99

    def __init__(self, features: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def _batch_stats(self, x: torch.Tensor, stats: BatchStats):
        """(mean, var) to normalize by, each (C,) or (windows, C); updates
        the moving stats."""
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        m = self.momentum
        if stats.windows > 1:
            xw = xf.unflatten(0, (stats.windows, -1))
            use_mean = xw.mean(dim=(1, 3, 4))
            use_var = xw.var(dim=(1, 3, 4), unbiased=False)
            with torch.no_grad():
                self.mean.copy_((m * self.mean + (1.0 - m) * use_mean)
                                .mean(0))
                self.var.copy_((m * self.var + (1.0 - m) * use_var).mean(0))
            return use_mean, use_var
        if stats.all_sum is not None:
            count = xf.shape[0] * xf.shape[2] * xf.shape[3] * stats.world
            use_mean = stats.all_sum(xf.sum(dim=(0, 2, 3))) / count
            dev = xf - use_mean[:, None, None]
            use_var = stats.all_sum(dev.square().sum(dim=(0, 2, 3))) / count
        else:
            use_mean = xf.mean(dim=(0, 2, 3))
            use_var = xf.var(dim=(0, 2, 3), unbiased=False)
        with torch.no_grad():
            self.mean.copy_(m * self.mean + (1.0 - m) * use_mean)
            self.var.copy_(m * self.var + (1.0 - m) * use_var)
        return use_mean, use_var

    def _affine(self, use_mean, use_var):
        # inv in float32, then x * inv + (bias - mean * inv) in x's dtype
        # (ref: deepgraphpose_tpu models/resnet.py:93-94)
        inv = self.scale / torch.sqrt(use_var + self.epsilon)
        return inv, self.bias - use_mean * inv

    def frozen_affine(self, dtype: torch.dtype):
        """The moving stats' (inv, shift) in ``dtype``, as ``forward``
        applies them in inference."""
        inv, shift = self._affine(self.mean, self.var)
        return inv.to(dtype), shift.to(dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            stats = train if isinstance(train, BatchStats) else BatchStats()
            use_mean, use_var = self._batch_stats(x, stats)
        else:
            use_mean, use_var = self.mean, self.var
            if not torch.is_grad_enabled():
                profiling.count("dgp.bn.plain")
        inv, shift = self._affine(use_mean, use_var)
        if inv.dim() == 2:              # per window: (windows, C)
            xw = x.unflatten(0, (inv.shape[0], -1))
            y = (xw * inv.to(x.dtype)[:, None, :, None, None]
                 + shift.to(x.dtype)[:, None, :, None, None])
            return y.flatten(0, 1)
        return x * inv.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


def _fuses(x: torch.Tensor, train, residual) -> bool:
    """Whether :func:`bn_act` takes the kernel: inference (no ``train``, no
    autograd) on a CUDA bfloat16 or float32 tensor, with a residual of the
    same shape, type and device, laid out as the kernel reads them
    (``bn_act_kernel.takes``: channels_last, whole 16-byte vectors)."""
    return (not train and not torch.is_grad_enabled() and x.is_cuda
            and x.dtype in bn_act_kernel.DTYPES
            and (residual is None or (residual.shape == x.shape
                                      and residual.dtype == x.dtype
                                      and residual.device == x.device))
            and bn_act_kernel.takes(x, residual))


def bn_act(bn: FrozenBatchNorm, x: torch.Tensor, train=False,
           act: str = "none", residual: torch.Tensor | None = None,
           residual_bn: FrozenBatchNorm | None = None) -> torch.Tensor:
    """``act(r + bn(x, train))`` with ``r`` the ``residual``, passed
    through ``residual_bn`` first where one is given (no residual: just
    ``act(bn(x, train))``); ``act`` is ``"none"``, ``"relu"`` or
    ``"relu6"``.

    In inference on the card (see :func:`_fuses`) this is one launch of
    the kernel ``csrc/bn_act.cu``, which gives the plain chain's bits, and
    counts the batch-norms it served as ``dgp.bn.fused``. Every other call
    runs the plain chain of PyTorch ops.
    """
    if _fuses(x, train, residual):
        inv, shift = bn.frozen_affine(x.dtype)
        inv_r = shift_r = None
        if residual_bn is not None:
            inv_r, shift_r = residual_bn.frozen_affine(x.dtype)
        profiling.count("dgp.bn.fused", 1 if residual_bn is None else 2)
        return bn_act_kernel.frozen_bn_act(x, inv, shift, residual, inv_r,
                                           shift_r, act)
    y = bn(x, train)
    if residual is not None:
        if residual_bn is not None:
            residual = residual_bn(residual, train)
        y = residual + y
    return bn_act_kernel.ACTIVATIONS[act](y)


class BottleneckV1(nn.Module):
    """slim resnet_v1 bottleneck unit: 1x1 -> 3x3(stride/rate) -> 1x1 + skip."""

    def __init__(self, in_depth: int, depth: int, depth_bottleneck: int,
                 stride: int = 1, rate: int = 1, dtype=torch.float32):
        super().__init__()
        self.stride = stride
        self.project = in_depth != depth
        if self.project:
            self.shortcut_conv = _conv(in_depth, depth, 1, stride, dtype=dtype)
            self.shortcut_bn = FrozenBatchNorm(depth)
        self.conv1 = _conv(in_depth, depth_bottleneck, 1, dtype=dtype)
        self.bn1 = FrozenBatchNorm(depth_bottleneck)
        self.conv2 = _conv(depth_bottleneck, depth_bottleneck, 3, stride, rate,
                           dtype=dtype)
        self.bn2 = FrozenBatchNorm(depth_bottleneck)
        self.conv3 = _conv(depth_bottleneck, depth, 1, dtype=dtype)
        self.bn3 = FrozenBatchNorm(depth)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """relu(shortcut + bn3(conv3(...))), the shortcut's batch-norm and
        the tail in one :func:`bn_act`."""
        if self.project:
            shortcut = self.shortcut_conv(x)
        elif self.stride != 1:
            # slim subsample(): 1x1 max-pool with stride
            shortcut = x[:, :, ::self.stride, ::self.stride]
        else:
            shortcut = x
        y = bn_act(self.bn1, self.conv1(x), train, "relu")
        y = bn_act(self.bn2, self.conv2(y), train, "relu")
        return bn_act(self.bn3, self.conv3(y), train, "relu", shortcut,
                      self.shortcut_bn if self.project else None)


def unit_plan(units: Sequence[int], output_stride: int):
    """Resolved per-unit plan: (name, depth, depth_bottleneck, stride, rate).

    slim v1 stride/atrous policy: stride 2 on the *last* unit of blocks 1-3
    (block4 stride 1), switching to dilated convs once the accumulated
    stride reaches ``output_stride`` (ref: tf.contrib.slim
    resnet_utils.stack_blocks_dense).
    """
    depths = (256, 512, 1024, 2048)
    bottlenecks = (64, 128, 256, 512)
    plan = []
    current_stride = 4
    rate = 1
    for b, (n_units, depth, db) in enumerate(
            zip(units, depths, bottlenecks)):
        block_stride = 2 if b < 3 else 1
        for u in range(n_units):
            unit_stride = block_stride if u == n_units - 1 else 1
            if unit_stride != 1 and current_stride >= output_stride:
                # switch to atrous: keep resolution, grow the rate
                effective_stride = 1
                unit_rate = rate
                rate = rate * unit_stride
            else:
                effective_stride = unit_stride
                unit_rate = rate
            plan.append((f"block{b + 1}_unit{u + 1}", depth, db,
                         effective_stride, unit_rate))
            current_stride *= effective_stride
    return plan


class ResNetV1(nn.Module):
    """ResNet-v1 trunk with output_stride control (no global pool / fc).

    forward(x NCHW, train) -> (features, end_points) with
    ``end_points["blockN"]`` the output of block N; ``train`` puts every
    batch-norm in its train mode.
    """

    def __init__(self, units: Sequence[int] = (3, 4, 6, 3),
                 output_stride: int = 16, dtype=torch.float32,
                 param_dtype=None):
        super().__init__()
        self.dtype = dtype
        pdtype = dtype if param_dtype is None else param_dtype
        self.conv1 = _conv(3, 64, 7, 2, dtype=pdtype)
        self.bn1 = FrozenBatchNorm(64)
        self.unit_names = []
        in_depth = 64
        for name, depth, db, stride, rate in unit_plan(units, output_stride):
            self.add_module(name, BottleneckV1(in_depth, depth, db, stride,
                                               rate, dtype=pdtype))
            self.unit_names.append(name)
            in_depth = depth
        self.out_depth = in_depth

    def forward(self, x: torch.Tensor, train: bool = False):
        x = x.to(self.dtype)
        # slim root: conv2d_same(64, 7, stride=2) -> pad (3,3) + VALID,
        # then a VALID 3x3/2 max-pool
        x = bn_act(self.bn1, self.conv1(x), train, "relu")
        x = F.max_pool2d(x, 3, 2)
        end_points = {}
        for name in self.unit_names:
            x = getattr(self, name)(x, train)
            end_points[name.split("_")[0]] = x
        return x, end_points


def make_backbone(net_type: str, output_stride: int = 16,
                  dtype=torch.float32, param_dtype=None) -> ResNetV1:
    if net_type not in BLOCK_UNITS:
        raise ValueError(f"unknown resnet variant {net_type!r}; "
                         f"available: {sorted(BLOCK_UNITS)}")
    return ResNetV1(units=BLOCK_UNITS[net_type], output_stride=output_stride,
                    dtype=dtype, param_dtype=param_dtype)

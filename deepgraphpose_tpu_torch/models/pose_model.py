"""PoseModel: backbone + scoremap / locref heads, in PyTorch.

ref: deeplabcut/pose_estimation_tensorflow/nnet/pose_net.py:28-196 (PoseNet).
Input preprocessing matches the reference: subtract the ImageNet mean pixel
in float32, then cast to the compute dtype (ref: pose_net.py:38-41).

The public layout is the JAX package's: images go in as (T, H, W, 3) and
heads come out as (T, H', W', C) float32, contiguous. Inside, the NHWC
input viewed as NCHW is already ``channels_last``, so cuDNN runs NHWC
convolutions without a transpose.

``dtype`` is the compute dtype and ``param_dtype`` the weights' (default:
``dtype``), flax's split: ``PoseModel(cfg, torch.bfloat16,
param_dtype=torch.float32)`` is the mixed-precision training model.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from deepgraphpose_tpu_torch.core.config import PoseConfig
from deepgraphpose_tpu_torch.core.device import resolve_device, resolve_dtype
from deepgraphpose_tpu_torch.models import mobilenet as mobilenet_lib
from deepgraphpose_tpu_torch.models.resnet import make_backbone
from deepgraphpose_tpu_torch.models.heads import PredictionHead


def _nhwc_f32(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1).to(torch.float32).contiguous()


class PoseModel(nn.Module):
    """Part-prediction and locref logits from RGB frames.

    Output spatial size follows :func:`scoremap_size` (total stride 8 with
    the defaults).
    """

    def __init__(self, cfg: PoseConfig, dtype=torch.float32,
                 param_dtype=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = resolve_dtype(dtype)
        self.param_dtype = (self.dtype if param_dtype is None
                            else resolve_dtype(param_dtype))
        self.register_buffer(
            "mean_pixel", torch.tensor(cfg.mean_pixel, dtype=torch.float32),
            persistent=False)
        mobile = cfg.net_type.startswith("mobilenet")
        build = mobilenet_lib.make_backbone if mobile else make_backbone
        self.backbone = build(cfg.net_type, cfg.output_stride, self.dtype,
                              self.param_dtype)
        feat = self.backbone.out_depth
        nj, ds, pdtype = (cfg.num_joints, cfg.deconvolutionstride,
                          self.param_dtype)
        self.part_pred = PredictionHead(feat, nj, ds, pdtype)
        self.head_keys = ["part_pred"]
        if cfg.location_refinement:
            self.locref_pred = PredictionHead(feat, 2 * nj, ds, pdtype)
            self.head_keys.append("locref")
        if cfg.intermediate_supervision and not mobile:
            # supervise the block-3 tap (ref: pose_net.py:69-78); the JAX
            # package has none for MobileNetV2
            self.intermediate_supervision = PredictionHead(1024, nj, ds,
                                                           pdtype)
            self.head_keys.append("part_pred_interm")

    def forward(self, images: torch.Tensor, heads=None,
                train: bool = False) -> dict:
        """images: (T, H, W, 3) RGB in [0, 255], any real or uint8 dtype.

        ``heads`` names the outputs to compute (default: all configured).
        Inference asks for ``("part_pred",)`` only, so the locref head is
        never run there. ``"features"`` among them adds the backbone's
        output, NHWC in the compute dtype: the tap of head-only training
        (``train/headonly.py``; the JAX package's ``return_features``).
        ``train=True`` runs batch-norm on batch statistics
        and updates its moving stats (``FrozenBatchNorm``); the default is
        inference.
        """
        want = self.head_keys if heads is None else list(heads)
        unknown = set(want) - set(self.head_keys) - {"features"}
        if unknown:
            raise ValueError(f"unknown heads {sorted(unknown)}; "
                             f"configured: {self.head_keys}")
        x = (images.to(torch.float32) - self.mean_pixel).to(self.dtype)
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        features, end_points = self.backbone(x, train)
        out = {}
        if "features" in want:
            out["features"] = features.permute(0, 2, 3, 1)
        if "part_pred" in want:
            out["part_pred"] = _nhwc_f32(self.part_pred(features))
        if "locref" in want:
            out["locref"] = _nhwc_f32(self.locref_pred(features))
        if "part_pred_interm" in want:
            out["part_pred_interm"] = _nhwc_f32(
                self.intermediate_supervision(end_points["block3"]))
        return out


def scoremap_size(cfg: PoseConfig, in_hw: tuple[int, int]) -> tuple[int, int]:
    """Predicted scoremap dims for an input size.

    ResNets follow the slim spatial recurrence: conv2d_same root
    (out = ceil(h/2)), VALID 3x3/2 max-pool (out = (h-3)//2 + 1), then one
    ceil-halving per strided block until output_stride. MobileNetV2 is
    SAME-padded throughout, so it reduces to ceil(h/output_stride).
    """
    s = cfg.output_stride
    d = cfg.deconvolutionstride
    if cfg.net_type.startswith("mobilenet"):
        return (math.ceil(in_hw[0] / s) * d, math.ceil(in_hw[1] / s) * d)

    def one_side(h: int) -> int:
        h = (h + 1) // 2            # root 7x7/2, explicit pad (3,3)
        h = (h - 3) // 2 + 1        # pool1 3x3/2 VALID
        stride = 4
        while stride < s:           # strided last units (conv2d_same 3x3/2)
            h = (h + 1) // 2
            stride *= 2
        return h * d

    return (one_side(in_hw[0]), one_side(in_hw[1]))


@torch.no_grad()
def _init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """LeCun-normal conv kernels (std sqrt(1/fan_in), as flax's default),
    zero biases, identity batch-norm. Drawn on the CPU from ``generator``."""
    for mod in model.modules():
        if isinstance(mod, nn.ConvTranspose2d):
            cin, _, kh, kw = mod.weight.shape
            fan_in = cin * kh * kw
        elif isinstance(mod, nn.Conv2d):
            _, cin, kh, kw = mod.weight.shape
            fan_in = cin * kh * kw
        else:
            continue
        w = torch.randn(mod.weight.shape, generator=generator)
        mod.weight.copy_(w / math.sqrt(fan_in))
        if mod.bias is not None:
            mod.bias.zero_()


def init_model(cfg: PoseConfig, generator: torch.Generator | None = None,
               dtype=torch.float32, device=None,
               param_dtype=None) -> PoseModel:
    """A randomly initialized PoseModel on ``device`` (default: the card),
    in eval mode and ``channels_last`` memory. ``generator`` is a CPU
    ``torch.Generator``; None seeds one with 0."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = PoseModel(cfg, dtype=dtype, param_dtype=param_dtype)
    _init_weights(model, generator)
    return model.to(resolve_device(device),
                    memory_format=torch.channels_last).eval()

"""Post-training int8 quantization of the pose forward pass (inference).

Counterpart of ``deepgraphpose_tpu/models/quant.py``, with the same
scheme, site names and arithmetic:

* frozen batch-norm folds into each conv exactly: ``W' = W * inv[oc]``,
  ``b = beta - mean * inv`` with ``inv = gamma / sqrt(var + eps)``;
* weights: per-output-channel symmetric int8, ``sw[oc] = max|W'[..,oc]|/127``;
* activations: per-conv-input per-tensor symmetric int8, the scale
  calibrated as the max |x| over calibration frames;
* each conv runs int8 x int8 -> int32 on the tensor cores, with one fused
  f32 epilogue ``y = acc * (sx * sw[oc]) + b`` (+ ReLU). Zero padding and
  max-pools are exact in the quantized domain (zero point 0);
* inside each bottleneck the conv1 -> conv2 -> conv3 chain carries int8:
  the epilogue requantizes with the next conv's input scale. Block
  boundaries carry ``carry_dtype``, or int8 with ``residual_int8``;
* the deconv heads stay in the model dtype;
* MobileNetV2 (every width): the stem, expand, project and head convs
  quantize, with ReLU6 in the epilogue and TF SAME padding; the depthwise
  3x3s stay float32 (folded BN, a cuDNN grouped conv, then bias and
  ReLU6), and no chain carries int8.

Every conv runs on the hand-written CUDA GEMM ``csrc/int8_gemm.cu``
(``ops/kernels/int8_gemm_kernel.py``) on a CUDA tensor, and on its plain
version on the CPU. A 1x1 stride-1 conv quantizes a wide input as the
kernel loads it; the residual adds, ReLUs, max-pools, depthwise convs and
the other quantizations of wide carries are PyTorch ops, as the JAX
package left them to XLA. Activations walk as NHWC tensors; a conv's
weight is a 2-D (k*k*Cin, Cout) int8 matrix, so ``channels_last`` never
restrides it.

The result has ``PoseModel``'s call: ``qmodel(images_u8, heads=...)``
returns the same dict of NHWC float32 heads, so ``infer_forward``,
``make_crop_infer_fn`` and ``DynamicTracker`` take it unchanged.

Usage::

    qmodel = quantize_model(cfg, model, calib_images)   # model: PoseModel
    mu, lik = make_infer_fn(qmodel, cfg)(images_u8)
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deepgraphpose_tpu_torch.core.checkpoint import HEAD_NAMES
from deepgraphpose_tpu_torch.core.config import PoseConfig
from deepgraphpose_tpu_torch.core.device import resolve_dtype
from deepgraphpose_tpu_torch.models import mobilenet as mnet
from deepgraphpose_tpu_torch.models.heads import PredictionHead
from deepgraphpose_tpu_torch.models.pose_model import _nhwc_f32
from deepgraphpose_tpu_torch.models.resnet import (BLOCK_UNITS,
                                                   same_pad_for_stride,
                                                   unit_plan)
from deepgraphpose_tpu_torch.ops.int8_gemm import RELU6, side_pads
from deepgraphpose_tpu_torch.ops.int8_gemm import quantize_to as _quantize_to
from deepgraphpose_tpu_torch.ops.kernels import int8_gemm_kernel as kernels

_BN_EPS = 1e-5  # FrozenBatchNorm.epsilon
CALIB_BATCH = 8  # calibration frames per float32 forward


def _check_backbone(net_type: str) -> None:
    if net_type not in BLOCK_UNITS and net_type not in mnet.WIDTHS:
        raise NotImplementedError(
            f"int8 quantization supports the ResNet and MobileNetV2 "
            f"backbones {sorted(BLOCK_UNITS) + sorted(mnet.WIDTHS)}, "
            f"not {net_type}")


def _mobile(net_type: str) -> bool:
    return net_type in mnet.WIDTHS


def supports_residual_int8(net_type: str) -> bool:
    """Whether the int8 residual-stream carry exists for this backbone
    (the ResNets; MobileNetV2's inverted-residual carries stay float)."""
    return net_type in BLOCK_UNITS


def _check_residual_int8(net_type: str, residual_int8: bool) -> None:
    if residual_int8 and not supports_residual_int8(net_type):
        raise NotImplementedError(
            "residual_int8 is a ResNet residual-stream mode; "
            f"{net_type} has no int8 carry lowering — use int8_carry")


def _fold(conv: nn.Conv2d, bn) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold frozen BN into the preceding conv: (W' HWIO float32, bias)."""
    kernel = conv.weight.detach().to(torch.float32).permute(2, 3, 1, 0)
    inv = bn.scale.detach().float() / torch.sqrt(bn.var.float() + _BN_EPS)
    return ((kernel * inv).contiguous(),
            bn.bias.detach().float() - bn.mean.float() * inv)


def folded_backbone_weights(model) -> dict:
    """{site: (W_folded float32 HWIO, bias float32)} for every backbone
    conv of a ``PoseModel``, under the JAX package's site names (the
    MobileNetV2 depthwise sites' kernels are (3, 3, 1, C))."""
    _check_backbone(model.cfg.net_type)
    bb = model.backbone
    if _mobile(model.cfg.net_type):
        out = {"conv_stem": _fold(bb.conv_stem, bb.stem_bn),
               "conv_head": _fold(bb.conv_head, bb.head_bn)}
        for name in bb.unit_names:
            unit = getattr(bb, name)
            for conv in ("expand", "depthwise", "project"):
                if hasattr(unit, conv):
                    out[f"{name}/{conv}"] = _fold(getattr(unit, conv),
                                                  getattr(unit, f"{conv}_bn"))
        return out
    out = {"conv1": _fold(bb.conv1, bb.bn1)}
    for name in bb.unit_names:
        unit = getattr(bb, name)
        for conv, bn in (("conv1", "bn1"), ("conv2", "bn2"),
                         ("conv3", "bn3"), ("shortcut_conv", "shortcut_bn")):
            if hasattr(unit, conv):
                out[f"{name}/{conv}"] = _fold(getattr(unit, conv),
                                              getattr(unit, bn))
    return out


def _pad_for(k: int, stride: int, rate: int) -> int:
    """slim: stride-1 convs are TF 'SAME', strided convs conv2d_same. For
    the odd kernels of the ResNets both are one symmetric pad per side."""
    if stride == 1:
        total = rate * (k - 1)
        lo, hi = total // 2, total - total // 2
    else:
        lo, hi = same_pad_for_stride(k, rate)
    if lo != hi:
        raise ValueError(f"asymmetric pad for kernel {k}, stride {stride}, "
                         f"rate {rate}")
    return lo


def _same_pad(k: int, stride: int, rate: int, x):
    """TF SAME pads ((top, bottom), (left, right)) of NHWC ``x``."""
    return tuple(mnet.same_pads(k, stride, rate, n) for n in x.shape[1:3])


def _float_conv(x, w, stride: int, rate: int, pad,
                groups: int = 1) -> torch.Tensor:
    """NHWC x, HWIO w -> NHWC (a contiguous NHWC tensor viewed as NCHW is
    channels_last, so the conv runs NHWC). ``pad`` as ``conv_int8``'s."""
    (top, bottom), (left, right) = side_pads(pad)
    x = x.permute(0, 3, 1, 2)
    if top != bottom or left != right:
        x = F.pad(x, (left, right, top, bottom))
        top = left = 0
    y = F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride,
                 padding=(top, left), dilation=rate, groups=groups)
    return y.permute(0, 2, 3, 1)


def _depthwise(x, w, b, stride: int, rate: int) -> torch.Tensor:
    """A float depthwise site: the grouped conv of NHWC ``x`` with the
    folded HWIO ``w`` (3, 3, 1, C), TF SAME padding, + ``b``, ReLU6."""
    y = _float_conv(x, w, stride, rate, _same_pad(3, stride, rate, x),
                    groups=w.shape[-1])
    return mnet.relu6(y + b)


def _walk_mobilenet(cfg: PoseConfig, x, conv_fn, dw_fn):
    """MobileNetV2 topology over models/mobilenet.py::unit_plan.

    ``conv_fn(site, x, stride, rate, relu)`` serves the dense (stem, 1x1)
    convs, the quantized bulk; ``dw_fn(site, x, stride, rate)`` the
    depthwise 3x3s, which stay float (one multiply-add per pixel and
    channel: no GEMM to gain).
    """
    x = conv_fn("conv_stem", x, 2, 1, relu=True)
    end_points = {}
    for name, exp, _, stride, rate in mnet.unit_plan(
            mnet.WIDTHS[cfg.net_type], cfg.output_stride):
        y = x
        if exp != 1:
            y = conv_fn(f"{name}/expand", y, 1, 1, relu=True)
        y = dw_fn(f"{name}/depthwise", y, stride, rate)
        y = conv_fn(f"{name}/project", y, 1, 1, relu=False)
        x = x + y if (stride == 1 and x.shape[-1] == y.shape[-1]) else y
        end_points[name.split("_")[0]] = x
    x = conv_fn("conv_head", x, 1, 1, relu=True)
    end_points["head"] = x
    return x, end_points


def _max_pool_nhwc(x, k: int, stride: int) -> torch.Tensor:
    return F.max_pool2d(x.permute(0, 3, 1, 2), k, stride).permute(0, 2, 3, 1)


def _walk_backbone(cfg: PoseConfig, units, x, conv_fn, block_out=None,
                   deq=None):
    """Shared backbone topology over NHWC tensors;
    ``conv_fn(site, x, stride, rate, relu)``.

    Consumes models/resnet.py::unit_plan, so the quantized forward and the
    float module share one structure definition. ``block_out(unit_name,
    x)`` post-processes each unit's wide (post-add, post-relu) output, and
    ``deq(unit_name, x)`` widens a possibly-int8 residual input for the
    identity / subsampling shortcuts; both default to identity.
    """
    block_out = block_out or (lambda name, x: x)
    deq = deq or (lambda name, x: x)
    x = conv_fn("conv1", x, 2, 1, relu=True)
    x = _max_pool_nhwc(x, 3, 2)  # slim VALID 3x3/2 root max-pool
    end_points = {}
    for name, depth, db, stride, rate in unit_plan(units, cfg.output_stride):
        if x.shape[-1] != depth:
            shortcut = conv_fn(f"{name}/shortcut_conv", x, stride, 1,
                               relu=False)
        elif stride != 1:  # slim subsample(): 1x1 max-pool with stride
            shortcut = deq(name, x)[:, ::stride, ::stride]
        else:
            shortcut = deq(name, x)
        y = conv_fn(f"{name}/conv1", x, 1, 1, relu=True)
        y = conv_fn(f"{name}/conv2", y, stride, rate, relu=True)
        y = conv_fn(f"{name}/conv3", y, 1, 1, relu=False)
        x = (shortcut + y).relu_()
        end_points[name.split("_")[0]] = x
        x = block_out(name, x)
    return x, end_points


def _chain_consumer(site: str) -> str | None:
    """The next conv in a bottleneck's linear chain, or None at a graph
    branch point."""
    if site.endswith("/conv1"):
        return site[:-1] + "2"
    if site.endswith("/conv2"):
        return site[:-1] + "3"
    return None


def site_shapes(net_type: str, output_stride: int = 16) -> dict:
    """{site: (k, Cin, Cout)} for every quantized conv, in walk order."""
    _check_backbone(net_type)
    if _mobile(net_type):
        width = mnet.WIDTHS[net_type]
        ch = mnet.stem_depth(width)
        shapes = {"conv_stem": (3, 3, ch)}
        for name, exp, out_ch, _, _ in mnet.unit_plan(width, output_stride):
            if exp != 1:
                shapes[f"{name}/expand"] = (1, ch, ch * exp)
            shapes[f"{name}/project"] = (1, ch * exp, out_ch)
            ch = out_ch
        shapes["conv_head"] = (1, ch, mnet.head_depth(width))
        return shapes
    shapes = {"conv1": (7, 3, 64)}
    in_depth = 64
    for name, depth, db, _, _ in unit_plan(BLOCK_UNITS[net_type],
                                           output_stride):
        if in_depth != depth:
            shapes[f"{name}/shortcut_conv"] = (1, in_depth, depth)
        shapes[f"{name}/conv1"] = (1, in_depth, db)
        shapes[f"{name}/conv2"] = (3, db, db)
        shapes[f"{name}/conv3"] = (1, db, depth)
        in_depth = depth
    return shapes


def depthwise_sites(net_type: str, output_stride: int = 16) -> dict:
    """{site: channels} of MobileNetV2's float depthwise convs (none for a
    ResNet)."""
    if not _mobile(net_type):
        return {}
    width = mnet.WIDTHS[net_type]
    ch, out = mnet.stem_depth(width), {}
    for name, exp, out_ch, _, _ in mnet.unit_plan(width, output_stride):
        out[f"{name}/depthwise"] = ch * exp
        ch = out_ch
    return out


class QuantConv(nn.Module):
    """One int8 conv site: the (k*k*Cin, Cout) int8 weight (the HWIO
    kernel flattened), per-channel ``oscale`` and ``bias``, and the
    calibrated input scale ``act_scale``, a Python float kept as the
    module's extra state (the kernel takes it by value: no device read).

    ``qw_nk`` is ``qw`` transposed, (Cout, k*k*Cin) contiguous, the layout
    the GEMM kernel reads: a buffer that is not saved, made again whenever
    a state is loaded and moved with the module. ``same``: TF SAME padding
    (MobileNetV2) rather than slim's (the ResNets)."""

    def __init__(self, k: int, cin: int, cout: int, same: bool = False):
        super().__init__()
        self.k = k
        self.same = same
        self.register_buffer("qw", torch.zeros(k * k * cin, cout,
                                               dtype=torch.int8))
        self.register_buffer("qw_nk", torch.zeros(cout, k * k * cin,
                                                  dtype=torch.int8),
                             persistent=False)
        self.register_buffer("oscale", torch.zeros(cout))
        self.register_buffer("bias", torch.zeros(cout))
        self.act_scale: float | None = None

    def get_extra_state(self):
        return {"act_scale": self.act_scale}

    def set_extra_state(self, state) -> None:
        self.act_scale = state["act_scale"]

    def _load_from_state_dict(self, *args, **kwargs):
        super()._load_from_state_dict(*args, **kwargs)
        self.qw_nk = self.qw.t().contiguous()

    def forward(self, x, stride: int, rate: int, relu: int, out):
        # an int8 input was requantized by its producer with THIS site's
        # act_scale (the _chain_consumer / residual block_out contracts); a
        # wide input is quantized with it, by the kernel as it loads a 1x1
        # stride-1 conv's input, else by a pass of its own
        in_scale = None
        if x.dtype != torch.int8:
            if self.k == 1 and stride == 1:
                in_scale = self.act_scale
            else:
                x = _quantize_to(x, self.act_scale)
        return kernels.conv_int8(x.contiguous(), self.qw, self.k, stride,
                                 rate, _conv_pad(self.same, self.k, stride,
                                                 rate, x),
                                 self.oscale, self.bias, relu, out, in_scale,
                                 w_nk=self.qw_nk)


class DepthwiseSite(nn.Module):
    """One float depthwise 3x3 site of the int8 MobileNetV2: the folded
    weight (C, 1, 3, 3) and bias, float32 (the JAX package's
    ``qvariables["dw"]``). forward: NHWC in, a float32 grouped conv with
    TF SAME padding, + bias, ReLU6, NHWC out in ``carry_dtype``, inside
    the profiler range ``models.mobilenet.DEPTHWISE_RANGE``."""

    def __init__(self, channels: int):
        super().__init__()
        self.register_buffer("weight", torch.zeros(channels, 1, 3, 3))
        self.register_buffer("bias", torch.zeros(channels))

    def forward(self, x, stride: int, rate: int, carry_dtype):
        with torch.profiler.record_function(mnet.DEPTHWISE_RANGE):
            y = _depthwise(x.to(torch.float32),
                           self.weight.permute(2, 3, 1, 0), self.bias,
                           stride, rate)
            return y.to(carry_dtype).contiguous()


def _int8_backbone(cfg: PoseConfig, sites, x, carry_dtype=torch.bfloat16,
                   int8_carry: bool = True, residual_int8: bool = False,
                   dw=None):
    """The int8 backbone walk over NHWC float32 input.

    ``residual_int8`` extends the narrow carry to the residual stream: each
    unit's post-add output requantizes with the NEXT unit's conv1 input
    scale, which the next unit's shortcut_conv shares (both were
    calibrated on the same tensor, so the scales are identical);
    identity / subsampling shortcuts dequantize before the add, and the
    final unit stays wide (it feeds the heads).

    MobileNetV2 carries ``carry_dtype`` everywhere, applies ReLU6 in the
    epilogue and runs its depthwise sites (``dw``) in float32.
    """
    if _mobile(cfg.net_type):
        def conv_fn(site, x, stride, rate, relu):
            return sites[site](x, stride, rate, RELU6 if relu else 0,
                               carry_dtype)

        def dw_fn(site, x, stride, rate):
            return dw[site](x, stride, rate, carry_dtype)

        return _walk_mobilenet(cfg, x, conv_fn, dw_fn)

    def conv_fn(site, x, stride, rate, relu):
        nxt = _chain_consumer(site) if int8_carry else None
        out = (("int8", sites[nxt].act_scale) if nxt in sites
               else carry_dtype)
        return sites[site](x, stride, rate, relu, out)

    block_out = deq = None
    if residual_int8:
        names = [n for n, *_ in unit_plan(BLOCK_UNITS[cfg.net_type],
                                          cfg.output_stride)]
        next_conv1 = {names[i]: f"{names[i + 1]}/conv1"
                      for i in range(len(names) - 1)}

        def block_out(name, x):
            nxt = next_conv1.get(name)
            if nxt is None:  # last unit: wide, feeds the heads
                return x.to(carry_dtype)
            return _quantize_to(x, sites[nxt].act_scale)

        def deq(name, x):
            if x.dtype != torch.int8:
                return x
            return x.to(torch.float32) * sites[f"{name}/conv1"].act_scale

    return _walk_backbone(cfg, BLOCK_UNITS[cfg.net_type], x, conv_fn,
                          block_out=block_out, deq=deq)


class QuantizedPoseModel(nn.Module):
    """The int8 pose model; inference only.

    ``dtype`` is the heads' compute dtype; ``carry_dtype`` the type of
    the activations at graph branch points (block inputs / outputs,
    residual adds); ``int8_carry`` carries the conv1 -> conv2 -> conv3
    chains in int8 (a ResNet's; MobileNetV2 has no such chain);
    ``residual_int8`` carries the residual stream in int8 too (ResNets
    only). Build it with :func:`quantize_model`, or load
    ``core.checkpoint.quant_state_from_flax`` into it.
    """

    def __init__(self, cfg: PoseConfig, dtype=torch.bfloat16,
                 carry_dtype=torch.bfloat16, int8_carry: bool = True,
                 residual_int8: bool = False):
        super().__init__()
        _check_backbone(cfg.net_type)
        _check_residual_int8(cfg.net_type, residual_int8)
        mobile = _mobile(cfg.net_type)
        self.cfg = cfg
        self.dtype = resolve_dtype(dtype)
        self.carry_dtype = resolve_dtype(carry_dtype)
        self.int8_carry = int8_carry
        self.residual_int8 = residual_int8
        self.register_buffer(
            "mean_pixel", torch.tensor(cfg.mean_pixel, dtype=torch.float32),
            persistent=False)
        shapes = site_shapes(cfg.net_type, cfg.output_stride)
        self.sites = nn.ModuleDict({
            site: QuantConv(*shape, same=mobile)
            for site, shape in shapes.items()})
        self.dw = nn.ModuleDict({
            site: DepthwiseSite(c) for site, c in depthwise_sites(
                cfg.net_type, cfg.output_stride).items()})
        feat = list(shapes.values())[-1][-1]  # the last conv's width
        nj, ds = cfg.num_joints, cfg.deconvolutionstride
        self.part_pred = PredictionHead(feat, nj, ds, self.dtype)
        self.head_keys = ["part_pred"]
        if cfg.location_refinement:
            self.locref_pred = PredictionHead(feat, 2 * nj, ds, self.dtype)
            self.head_keys.append("locref")
        if cfg.intermediate_supervision and not mobile:
            self.intermediate_supervision = PredictionHead(1024, nj, ds,
                                                           self.dtype)
            self.head_keys.append("part_pred_interm")

    @property
    def has_state(self) -> bool:
        """Whether every site holds a calibrated input scale."""
        return all(s.act_scale is not None for s in self.sites.values())

    def forward(self, images: torch.Tensor, heads=None, train: bool = False,
                return_features: bool = False) -> dict:
        """images: (T, H, W, 3) RGB in [0, 255]; returns the dict of
        (T, H', W', C) float32 heads named in ``heads`` (default: all
        configured), plus the NHWC ``features`` if asked."""
        if train:
            raise ValueError("QuantizedPoseModel is inference-only")
        if not self.has_state:
            raise RuntimeError(
                "QuantizedPoseModel has no quantized state: build it with "
                "quantize_model, or load_state_dict a quantized state")
        want = self.head_keys if heads is None else list(heads)
        unknown = set(want) - set(self.head_keys)
        if unknown:
            raise ValueError(f"unknown heads {sorted(unknown)}; "
                             f"configured: {self.head_keys}")
        x = (images.to(torch.float32) - self.mean_pixel).contiguous()
        features, end_points = _int8_backbone(
            self.cfg, self.sites, x, carry_dtype=self.carry_dtype,
            int8_carry=self.int8_carry, residual_int8=self.residual_int8,
            dw=self.dw)
        features = features.to(self.dtype)
        out = {}
        if return_features:
            out["features"] = features
        nchw = features.permute(0, 3, 1, 2)
        if "part_pred" in want:
            out["part_pred"] = _nhwc_f32(self.part_pred(nchw))
        if "locref" in want:
            out["locref"] = _nhwc_f32(self.locref_pred(nchw))
        if "part_pred_interm" in want:
            out["part_pred_interm"] = _nhwc_f32(self.intermediate_supervision(
                end_points["block3"].to(self.dtype).permute(0, 3, 1, 2)))
        return out


def abs_percentile(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.percentile(jnp.abs(x).ravel(), q)``: linear interpolation
    between two order statistics at the position q / 100 * (n - 1),
    computed in float32 as jnp.percentile defines it. (Compiled, XLA may
    round that position one float32 step apart, by folding the division
    into a product; the value then moves by that step times the gap
    between the two order statistics.) The order statistics come from
    ``torch.kthvalue``: ``torch.quantile`` refuses more than 2^24 elements,
    and a calibration site at 747x832 holds more."""
    flat = x.reshape(-1).to(torch.float32).abs()
    n = flat.numel()
    f32 = np.float32
    pos = f32(f32(q) / f32(100)) * (f32(n) - f32(1))
    low, high = np.floor(pos), np.ceil(pos)
    high_weight = f32(pos - low)
    low_weight = f32(1) - high_weight
    low = int(min(max(low, 0), n - 1))
    high = int(min(max(high, 0), n - 1))
    low_value = torch.kthvalue(flat, low + 1).values
    high_value = (low_value if high == low
                  else torch.kthvalue(flat, high + 1).values)
    return low_value * float(low_weight) + high_value * float(high_weight)


def _collect_forward(cfg: PoseConfig, folded: dict, images,
                     percentile: float | None = None):
    """float32 forward on folded weights -> ({site: range of its input},
    features). The range is max |x|, or with ``percentile`` (e.g. 99.9)
    that percentile of |x|: a clipped range, so that a few outlying
    activations do not stretch the int8 grid. The features double as the
    fold-parity check."""
    mean = torch.tensor(cfg.mean_pixel, dtype=torch.float32,
                        device=images.device)
    x = images.to(torch.float32) - mean
    amax: dict = {}
    mobile = _mobile(cfg.net_type)
    act = mnet.relu6 if mobile else torch.relu

    def conv_fn(site, x, stride, rate, relu):
        w, b = folded[site]
        amax[site] = (x.abs().amax() if percentile is None
                      else abs_percentile(x, percentile))
        y = _float_conv(x, w, stride, rate,
                        _conv_pad(mobile, w.shape[0], stride, rate, x)) + b
        return act(y) if relu else y

    features, _ = _walk(cfg, x, conv_fn, _float_dw(folded))
    return amax, features


def _conv_pad(same: bool, k: int, stride: int, rate: int, x):
    """A conv's pads: TF SAME's from NHWC ``x`` (MobileNetV2), or slim's
    (the ResNets)."""
    return (_same_pad(k, stride, rate, x) if same
            else _pad_for(k, stride, rate))


def _float_dw(folded: dict):
    """The float depthwise sites of the calibration walks."""
    def dw_fn(site, x, stride, rate):
        return _depthwise(x, *folded[site], stride, rate)
    return dw_fn


def _walk(cfg: PoseConfig, x, conv_fn, dw_fn):
    if _mobile(cfg.net_type):
        return _walk_mobilenet(cfg, x, conv_fn, dw_fn)
    return _walk_backbone(cfg, BLOCK_UNITS[cfg.net_type], x, conv_fn)


def _local_bias_stats(cfg: PoseConfig, folded: dict, sites, images) -> dict:
    """Per-site per-channel E[conv_f32(x) - conv_int8(x)] on the SAME f32
    input: each layer's own quantization-induced output shift, free of
    upstream drift (the f32 walk carries the activations forward)."""
    mean = torch.tensor(cfg.mean_pixel, dtype=torch.float32,
                        device=images.device)
    x = images.to(torch.float32) - mean
    diff: dict = {}
    mobile = _mobile(cfg.net_type)
    act = mnet.relu6 if mobile else torch.relu

    def conv_fn(site, x, stride, rate, relu):
        w, b = folded[site]
        q = sites[site]
        pad = _conv_pad(mobile, w.shape[0], stride, rate, x)
        y32 = _float_conv(x, w, stride, rate, pad) + b
        # the reciprocal in float32, then a multiply (not a divide), as the
        # JAX package computes this statistic
        inv_sx = float(np.float32(1.0) / np.float32(q.act_scale))
        xq = torch.clamp(torch.round(x * inv_sx), -127, 127).to(torch.int8)
        y8 = kernels.conv_int8(xq.contiguous(), q.qw, q.k, stride, rate, pad,
                               q.oscale, b, False, torch.float32,
                               w_nk=q.qw_nk)
        diff[site] = torch.mean(y32 - y8, dim=(0, 1, 2))
        return act(y32) if relu else y32

    _walk(cfg, x, conv_fn, _float_dw(folded))
    return diff


def _exact_f32():
    """float32 convolutions in full float32 (cuDNN would use TF32)."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=True, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


@torch.no_grad()
def quantize_model(cfg: PoseConfig, model, calib_images,
                   dtype=torch.bfloat16, calib_batch: int = CALIB_BATCH,
                   calib_percentile: float | None = None,
                   bias_correction: bool = True,
                   carry_dtype=torch.bfloat16,
                   int8_carry: bool = True,
                   residual_int8: bool = False) -> QuantizedPoseModel:
    """Build the int8 model from a float ``PoseModel``, on its device.

    calib_images: (N, H, W, 3) uint8/f32 frames representative of the
    inference distribution (a handful from the target video suffices),
    run ``calib_batch`` at a time. Each site's input scale is the largest
    over the batches of max |x| or, with ``calib_percentile``, of that
    percentile of |x| (:func:`abs_percentile`). With ``bias_correction``
    (the default) each site's bias takes the measured mean output shift of
    its int8 lowering (:func:`_local_bias_stats`). The arguments and defaults
    are the JAX package's, and so is the weight and scale arithmetic, in
    numpy on the host. MobileNetV2's depthwise sites keep their folded
    float32 weights.
    """
    _check_backbone(cfg.net_type)
    _check_residual_int8(cfg.net_type, residual_int8)
    device = model.mean_pixel.device
    folded = folded_backbone_weights(model)
    calib = np.asarray(calib_images)

    def batches():
        for i in range(0, len(calib), calib_batch):
            yield torch.from_numpy(calib[i:i + calib_batch]).to(device)

    amax: dict[str, float] = {}
    with _exact_f32():
        for batch in batches():
            stats, _ = _collect_forward(cfg, folded, batch,
                                        percentile=calib_percentile)
            values = torch.stack(list(stats.values())).cpu().tolist()
            for site, v in zip(stats, values):
                amax[site] = max(amax.get(site, 0.0), float(v))

    state = {}
    for site, (w, b) in folded.items():
        if site.endswith("/depthwise"):
            state[f"dw.{site}.weight"] = w.permute(3, 2, 0, 1).contiguous(
                ).cpu()
            state[f"dw.{site}.bias"] = b.cpu()
            continue
        w = w.cpu().numpy()
        sw = np.abs(w).reshape(-1, w.shape[-1]).max(axis=0) / 127.0
        sw = np.maximum(sw, 1e-12)
        qw = np.clip(np.rint(w / sw), -127, 127).astype(np.int8)
        sx = max(amax.get(site, 0.0), 1e-12) / 127.0
        state[f"sites.{site}.qw"] = torch.from_numpy(
            np.ascontiguousarray(qw.reshape(-1, qw.shape[-1])))
        state[f"sites.{site}.oscale"] = torch.from_numpy(
            np.asarray(sx * sw, np.float32))
        state[f"sites.{site}.bias"] = b.cpu()
        state[f"sites.{site}._extra_state"] = {
            "act_scale": float(np.float32(sx))}
    qmodel = QuantizedPoseModel(cfg, dtype=dtype, carry_dtype=carry_dtype,
                                int8_carry=int8_carry,
                                residual_int8=residual_int8)
    for attr in HEAD_NAMES:
        if hasattr(qmodel, attr):
            state.update({f"{attr}.{k}": v for k, v in
                          getattr(model, attr).state_dict().items()})
    qmodel.load_state_dict(state, strict=True)
    qmodel = qmodel.to(device).eval()
    if not bias_correction:
        return qmodel

    diffs: dict[str, list] = {}
    with _exact_f32():
        for batch in batches():
            for site, v in _local_bias_stats(cfg, folded, qmodel.sites,
                                             batch).items():
                diffs.setdefault(site, []).append(v.cpu().numpy())
    for site, q in qmodel.sites.items():
        shift = np.mean(diffs[site], axis=0).astype(np.float32)
        q.bias.copy_(q.bias + torch.from_numpy(shift).to(q.bias.device))
    return qmodel


def calib_frames_from_video(video_file, n: int = 8, new_size=None,
                            crop=None, resize_to=None) -> np.ndarray:
    """First-``n``-frames calibration stack, preprocessed as the entry
    points preprocess their batches: resize to ``new_size``, then ``crop``
    (x0, y0, x1, y1). ``resize_to`` (h, w) then resizes every frame that
    is not that size (a serving export at a size other than the video's)."""
    import cv2

    from deepgraphpose_tpu_torch.data.video import VideoReader

    reader = VideoReader(video_file)
    frames = []
    for _, frame in reader.iter_frames():
        if new_size is not None:
            frame = cv2.resize(frame, (new_size[1], new_size[0]))
        if crop is not None:
            x0, y0, x1, y1 = crop
            frame = frame[y0:y1, x0:x1]
        if resize_to is not None and frame.shape[:2] != tuple(resize_to):
            frame = cv2.resize(frame, (resize_to[1], resize_to[0]))
        frames.append(frame)
        if len(frames) >= n:
            break
    reader.close()
    if not frames:
        raise ValueError(f"no decodable frames in {video_file} "
                         "to calibrate on")
    return np.stack(frames)

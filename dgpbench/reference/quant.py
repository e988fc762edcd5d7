"""The int8 post-training quantization of a ResNet pose model, worked out
again in plain PyTorch from the float weights and the calibration frames.

The scheme is the one the configuration runs (DeepGraphPose's TPU
package's ``models/quant.py``, which the program follows):

* frozen batch norm folds into each conv: ``W' = W * inv``,
  ``b = beta - mean * inv``, ``inv = gamma / sqrt(var + eps)``;
* weights per output channel, symmetric: ``sw = max|W'| / qmax``;
* each conv's input per tensor, symmetric: ``sx = max|x| / qmax`` over
  the calibration frames, walked in float32 on the folded weights, in
  batches of 8;
* ``y = acc * (sx * sw) + b`` in float32, rounded once, then ReLU;
  inside a bottleneck the result is requantized with the next conv's
  scale, elsewhere stored as bfloat16 (block outputs, residual adds,
  max-pool);
* bias correction: each conv's bias takes the mean of
  ``conv_f32(x) - conv_q(x)`` over the calibration frames on the float
  walk's own inputs;
* the score-map head runs in float32 here on the bfloat16 features.

``qmax`` is 127 for int8; the control puts 7 (int4) in its place. The
integer sums run as float32 convolutions with TF32 off: every product of
two int8 values is exact, and so is every partial sum below 2^24.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from dgpbench.reference import arch, models
from dgpbench.reference.families import resnet_v1

CALIB_BATCH = 8


def _fold(w: dict, conv: str, bn: str):
    inv = w[f"{bn}.scale"] / torch.sqrt(w[f"{bn}.var"] + models.BN_EPS)
    return (w[f"{conv}.weight"] * inv[:, None, None, None],
            w[f"{bn}.bias"] - w[f"{bn}.mean"] * inv)


def _sites(cfg: dict):
    """(site, conv weight name, bn name, stride, rate, relu, next site in
    the chain or None) in walk order, for a ResNet."""
    if cfg["family"] != "resnet_v1":
        raise NotImplementedError("the int8 reference covers the ResNets")
    b = "backbone."
    out = [("conv1", b + "conv1", b + "bn1", 2, 1, True, None)]
    cin = cfg["root_depth"]
    for name, depth, _, stride, rate in resnet_v1.resnet_units(cfg):
        p = f"{b}{name}."
        if cin != depth:
            out.append((f"{name}/shortcut_conv", p + "shortcut_conv",
                        p + "shortcut_bn", stride, 1, False, None))
        out.append((f"{name}/conv1", p + "conv1", p + "bn1", 1, 1, True,
                    f"{name}/conv2"))
        out.append((f"{name}/conv2", p + "conv2", p + "bn2", stride, rate,
                    True, f"{name}/conv3"))
        out.append((f"{name}/conv3", p + "conv3", p + "bn3", 1, 1, False,
                    None))
        cin = depth
    return out


def _walk(cfg: dict, x, conv_fn):
    """The ResNet topology over NCHW tensors; ``conv_fn(site, x)`` runs a
    site (with its own stride, rate and activation)."""
    x = F.max_pool2d(conv_fn("conv1", x), 3, 2)
    for name, depth, _, stride, _ in resnet_v1.resnet_units(cfg):
        if x.shape[1] != depth:
            sc = conv_fn(f"{name}/shortcut_conv", x)
        elif stride != 1:
            sc = x[:, :, ::stride, ::stride]
        else:
            sc = x
        y = conv_fn(f"{name}/conv3", conv_fn(f"{name}/conv2",
                                             conv_fn(f"{name}/conv1", x)))
        x = torch.relu(sc + y)
    return x


def _float_conv(x, wf, stride, rate):
    k = wf.shape[-1]
    return F.conv2d(x, wf, None, stride, arch.slim_pad(k, rate), rate)


def _quantize(x: torch.Tensor, scale: torch.Tensor, qmax: int):
    """clip(rint(x / scale), -qmax, qmax), kept as float32 integers."""
    return torch.clamp(torch.round(x.to(torch.float32) / scale), -qmax, qmax)


def _epilogue(acc, oscale, bias):
    """acc * oscale + bias rounded once to float32 (a fused multiply-add),
    per output channel of NCHW ``acc``."""
    return (acc.double() * oscale.double()[:, None, None]
            + bias.double()[:, None, None]).to(torch.float32)


def _input(images_u8, cfg):
    x = images_u8.to(torch.float32) - models.mean_pixel(cfg, images_u8.device)
    return x.permute(0, 3, 1, 2).contiguous()


@torch.no_grad()
def calibrate(cfg: dict, w: dict, calib_u8: torch.Tensor, qmax: int = 127):
    """The quantized state from the float weights ``w`` and the
    calibration frames (N, H, W, 3) uint8: per site the integer weight,
    its input scale, output scale and corrected bias."""
    sites = {s[0]: s for s in _sites(cfg)}
    folded = {s: _fold(w, conv, bn) for s, (_, conv, bn, *_r) in
              sites.items()}
    batches = [calib_u8[i:i + CALIB_BATCH]
               for i in range(0, len(calib_u8), CALIB_BATCH)]

    amax: dict = {}
    with models.exact_float32():
        for batch in batches:
            def collect(site, x):
                _, _, _, stride, rate, relu, _ = sites[site]
                wf, b = folded[site]
                m = float(x.abs().amax())
                amax[site] = max(amax.get(site, 0.0), m)
                y = _float_conv(x, wf, stride, rate) + b[:, None, None]
                return torch.relu(y) if relu else y
            _walk(cfg, _input(batch, cfg), collect)

    state = {}
    for site, (wf, b) in folded.items():
        sw = wf.abs().amax(dim=(1, 2, 3)) / float(qmax)
        sw = torch.clamp(sw, min=1e-12)
        qw = torch.clamp(torch.round(wf / sw[:, None, None, None]),
                         -qmax, qmax)
        sx = np.float32(max(amax[site], 1e-12) / qmax)
        state[site] = {"qw": qw, "sx": torch.tensor(sx, device=wf.device),
                       "oscale": sw * torch.tensor(sx, device=wf.device),
                       "bias": b.clone()}

    shifts: dict = {}
    with models.exact_float32():
        for batch in batches:
            def local(site, x):
                _, _, _, stride, rate, relu, _ = sites[site]
                wf, b = folded[site]
                q = state[site]
                y32 = _float_conv(x, wf, stride, rate) + b[:, None, None]
                inv = float(np.float32(1.0) / np.float32(q["sx"].item()))
                xq = torch.clamp(torch.round(x * inv), -qmax, qmax)
                y8 = _epilogue(_float_conv(xq, q["qw"], stride, rate),
                               q["oscale"], b)
                shifts.setdefault(site, []).append(
                    torch.mean(y32 - y8, dim=(0, 2, 3)))
                return torch.relu(y32) if relu else y32
            _walk(cfg, _input(batch, cfg), local)
    for site, q in state.items():
        q["bias"] = q["bias"] + torch.stack(shifts[site]).mean(0)
    return state


@torch.no_grad()
def forward(cfg: dict, w: dict, state: dict, images_u8: torch.Tensor,
            qmax: int = 127) -> torch.Tensor:
    """uint8 frames -> score-map logits (B, H', W', joints) float32 of the
    quantized model."""
    sites = {s[0]: s for s in _sites(cfg)}

    def conv_fn(site, x):
        _, _, _, stride, rate, relu, nxt = sites[site]
        q = state[site]
        if not getattr(x, "quantized", False):
            x = _quantize(x, q["sx"], qmax)
        y = _epilogue(_float_conv(x, q["qw"], stride, rate), q["oscale"],
                      q["bias"])
        if relu:
            y = torch.relu(y)
        if nxt is not None:
            y = _quantize(y, state[nxt]["sx"], qmax)
            y.quantized = True
            return y
        return y.to(torch.bfloat16)

    with models.exact_float32():
        feats = _walk(cfg, _input(images_u8, cfg), conv_fn)
        return models.head(w, "part_pred", feats.to(torch.float32),
                           cfg["deconvolution_stride"]).contiguous()

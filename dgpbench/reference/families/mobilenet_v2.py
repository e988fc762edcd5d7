"""MobileNetV2 (Sandler et al. 2018, arXiv:1801.04381) as DeepLabCut's
``pose_net_mobilenet.py`` wires it: TF SAME padding, relu6, output stride
16 by dilation, the 1x1 to 1280 channels at the end.

Configuration keys: ``width``, ``stem_depth``, ``head_depth``,
``inverted_residual_spec``, ``output_stride``.
"""

from __future__ import annotations

import torch

from dgpbench.reference import arch, models


def mobilenet_units(cfg: dict):
    """(name, expansion, out channels, stride, rate) of every inverted
    residual unit."""
    width = cfg["width"]
    plan, current, rate = [], 2, 1
    for b, (exp, out_c, n_units, first_stride) in enumerate(
            cfg["inverted_residual_spec"]):
        out_ch = arch.make_divisible(out_c, width)
        for u in range(n_units):
            stride = first_stride if u == 0 else 1
            if stride != 1 and current >= cfg["output_stride"]:
                eff, unit_rate, rate = 1, rate, rate * stride
            else:
                eff, unit_rate = stride, rate
            plan.append((f"block{b}_unit{u}", exp, out_ch, eff, unit_rate))
            current *= eff
    return plan


def mobilenet_depths(cfg: dict) -> tuple[int, int]:
    """(stem channels, final 1x1 channels); slim keeps at least 1280."""
    width = cfg["width"]
    return (arch.make_divisible(cfg["stem_depth"], width),
            arch.make_divisible(cfg["head_depth"], max(width, 1.0)))


def specs(cfg: dict, conv, bn) -> int:
    stem, head = mobilenet_depths(cfg)
    conv("conv_stem", stem, 3, 3, "root")
    bn("stem_bn", stem)
    cin = stem
    for name, exp, out_ch, stride, _ in mobilenet_units(cfg):
        mid = cin * exp
        if exp != 1:
            conv(f"{name}.expand", mid, cin, 1)
            bn(f"{name}.expand_bn", mid)
        conv(f"{name}.depthwise", mid, 1, 3)
        bn(f"{name}.depthwise_bn", mid)
        conv(f"{name}.project", out_ch, mid, 1, "linear")
        residual = stride == 1 and cin == out_ch
        bn(f"{name}.project_bn", out_ch, "bn_residual" if residual else "bn")
        cin = out_ch
    conv("conv_head", head, cin, 1)
    bn("head_bn", head)
    return head


def backbone(cfg: dict, w: dict, x: torch.Tensor, conv) -> torch.Tensor:
    b, bn, same, relu6 = ("backbone.", models.frozen_bn, models.same_conv,
                          models.relu6)
    x = relu6(bn(w, b + "stem_bn", same(conv, x, w[b + "conv_stem.weight"],
                                        2)))
    for name, exp, _, stride, rate in mobilenet_units(cfg):
        p = f"{b}{name}."
        y = x
        if exp != 1:
            y = relu6(bn(w, p + "expand_bn",
                         same(conv, y, w[p + "expand.weight"])))
        dw = w[p + "depthwise.weight"]
        y = relu6(bn(w, p + "depthwise_bn", same(
            conv, y, dw, stride, rate, groups=dw.shape[0])))
        y = bn(w, p + "project_bn", same(conv, y, w[p + "project.weight"]))
        x = x + y if (stride == 1 and x.shape[1] == y.shape[1]) else y
    return relu6(bn(w, b + "head_bn",
                    same(conv, x, w[b + "conv_head.weight"])))


def layers(cfg: dict, hw, add):
    def same(size, stride):
        return -(-size // stride)

    h, w = hw
    stem, head = mobilenet_depths(cfg)
    cur = add("conv_stem", 3, 3, stem, 2, 1, (h, w), (same(h, 2), same(w, 2)))
    cin = stem
    for name, exp, out_ch, stride, rate in mobilenet_units(cfg):
        mid = cin * exp
        if exp != 1:
            add(f"{name}/expand", 1, cin, mid, 1, 1, cur, cur)
        nxt = (same(cur[0], stride), same(cur[1], stride))
        add(f"{name}/depthwise", 3, mid, mid, stride, rate, cur, nxt,
            groups=mid)
        add(f"{name}/project", 1, mid, out_ch, 1, 1, nxt, nxt)
        cur, cin = nxt, out_ch
    add("conv_head", 1, cin, head, 1, 1, cur, cur)
    return cur, head

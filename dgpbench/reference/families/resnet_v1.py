"""ResNet v1 as TF-slim's ``resnet_v1_50`` (He et al. 2016,
arXiv:1512.03385) with DeepLabCut's ``pose_net.py``: stride on the 3x3 of
each block's last unit, output stride 16 by atrous convolution in block
4, no global pool.

Configuration keys: ``root_depth``, ``block_units``, ``block_depths``,
``bottleneck_depths``, ``output_stride``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dgpbench.reference import arch, models


def resnet_units(cfg: dict):
    """(name, depth, bottleneck depth, stride, rate) of every unit: stride
    2 on the last unit of blocks 1-3, atrous once the stride reaches the
    output stride (slim's ``stack_blocks_dense``)."""
    plan, current, rate = [], 4, 1
    for b, (n_units, depth, bottleneck) in enumerate(zip(
            cfg["block_units"], cfg["block_depths"],
            cfg["bottleneck_depths"])):
        block_stride = 2 if b < len(cfg["block_units"]) - 1 else 1
        for u in range(n_units):
            stride = block_stride if u == n_units - 1 else 1
            if stride != 1 and current >= cfg["output_stride"]:
                eff, unit_rate, rate = 1, rate, rate * stride
            else:
                eff, unit_rate = stride, rate
            plan.append((f"block{b + 1}_unit{u + 1}", depth, bottleneck, eff,
                         unit_rate))
            current *= eff
    return plan


def specs(cfg: dict, conv, bn) -> int:
    conv("conv1", cfg["root_depth"], 3, 7, "root")
    bn("bn1", cfg["root_depth"])
    cin = cfg["root_depth"]
    for name, depth, bneck, _, _ in resnet_units(cfg):
        if cin != depth:
            conv(f"{name}.shortcut_conv", depth, cin, 1, "linear")
            bn(f"{name}.shortcut_bn", depth)
        conv(f"{name}.conv1", bneck, cin, 1)
        bn(f"{name}.bn1", bneck)
        conv(f"{name}.conv2", bneck, bneck, 3)
        bn(f"{name}.bn2", bneck)
        conv(f"{name}.conv3", depth, bneck, 1, "linear")
        bn(f"{name}.bn3", depth, "bn_residual")
        cin = depth
    return cin


def backbone(cfg: dict, w: dict, x: torch.Tensor, conv) -> torch.Tensor:
    b = "backbone."
    x = conv(x, w[b + "conv1.weight"], 2, arch.slim_pad(7, 1))
    x = F.max_pool2d(torch.relu(models.frozen_bn(w, b + "bn1", x)), 3, 2)
    for name, depth, _, stride, rate in resnet_units(cfg):
        p = f"{b}{name}."
        if x.shape[1] != depth:
            sc = models.frozen_bn(w, p + "shortcut_bn",
                                  conv(x, w[p + "shortcut_conv.weight"],
                                       stride, 0))
        elif stride != 1:
            sc = x[:, :, ::stride, ::stride]
        else:
            sc = x
        y = torch.relu(models.frozen_bn(w, p + "bn1",
                                        conv(x, w[p + "conv1.weight"])))
        y = torch.relu(models.frozen_bn(w, p + "bn2", conv(
            y, w[p + "conv2.weight"], stride, arch.slim_pad(3, rate),
            rate)))
        y = models.frozen_bn(w, p + "bn3", conv(y, w[p + "conv3.weight"]))
        x = torch.relu(sc + y)
    return x


def layers(cfg: dict, hw, add):
    def slim(size, k, stride, rate):
        keff = k + (k - 1) * (rate - 1)
        return (size + 2 * arch.slim_pad(k, rate) - keff) // stride + 1

    h, w = hw
    cur = add("conv1", 7, 3, cfg["root_depth"], 2, 1, (h, w),
              (slim(h, 7, 2, 1), slim(w, 7, 2, 1)))
    cur = ((cur[0] - 3) // 2 + 1, (cur[1] - 3) // 2 + 1)   # VALID pool
    cin = cfg["root_depth"]
    for name, depth, bn, stride, rate in resnet_units(cfg):
        nxt = tuple(slim(n, 3, stride, rate) for n in cur)
        if cin != depth:
            add(f"{name}/shortcut_conv", 1, cin, depth, stride, 1, cur, nxt)
        add(f"{name}/conv1", 1, cin, bn, 1, 1, cur, cur)
        add(f"{name}/conv2", 3, bn, bn, stride, rate, cur, nxt)
        add(f"{name}/conv3", 1, bn, depth, 1, 1, nxt, nxt)
        cur, cin = nxt, depth
    return cur, cin

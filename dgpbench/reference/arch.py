"""The two published architectures as plans of layers, read from a
configuration file of ``configs/``.

* ResNet-50 v1 as TF-slim's ``resnet_v1_50`` (He et al. 2016,
  arXiv:1512.03385) with DeepLabCut's ``pose_net.py``: stride on the 3x3
  of each block's last unit, output stride 16 by atrous convolution in
  block 4, no global pool.
* MobileNetV2 (Sandler et al. 2018, arXiv:1801.04381) as DeepLabCut's
  ``pose_net_mobilenet.py`` wires it: TF SAME padding, relu6, output
  stride 16 by dilation, the 1x1 to 1280 channels at the end.

Both end in DeepLabCut's prediction layer: a 3x3 transposed convolution of
stride ``deconvolution_stride`` to the score maps (and a second to the
location refinement, which inference does not run).
"""

from __future__ import annotations


def make_divisible(channels: float, multiplier: float,
                   divisor: int = 8) -> int:
    """TF slim's ``_make_divisible`` of a width-scaled channel count."""
    v = max(divisor, int(channels * multiplier + divisor / 2)
            // divisor * divisor)
    if v < 0.9 * channels * multiplier:
        v += divisor
    return v


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


def mobilenet_units(cfg: dict):
    """(name, expansion, out channels, stride, rate) of every inverted
    residual unit."""
    width = cfg["width"]
    plan, current, rate = [], 2, 1
    for b, (exp, out_c, n_units, first_stride) in enumerate(
            cfg["inverted_residual_spec"]):
        out_ch = make_divisible(out_c, width)
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
    return (make_divisible(cfg["stem_depth"], width),
            make_divisible(cfg["head_depth"], max(width, 1.0)))


def same_pads(k: int, stride: int, rate: int, size: int) -> tuple[int, int]:
    """TF SAME zero pad (low, high) of one side of length ``size``."""
    keff = rate * (k - 1) + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + keff - size, 0)
    return total // 2, total - total // 2


def slim_pad(k: int, rate: int) -> int:
    """slim's pad of a ResNet conv, each side: TF SAME of a stride-1 conv
    and ``conv2d_same`` of a strided one agree for odd kernels."""
    return (k + (k - 1) * (rate - 1) - 1) // 2


def layers(cfg: dict, hw) -> list[dict]:
    """Every convolution of one frame of ``hw`` through the backbone and
    the score-map head, in order: site, kernel, channels in and out,
    groups, stride, rate, input and output size, and whether it is the
    transposed head."""
    out: list[dict] = []

    def add(site, k, cin, cout, stride, rate, in_hw, out_hw, groups=1,
            transposed=False):
        out.append({"site": site, "k": k, "cin": cin, "cout": cout,
                    "groups": groups, "stride": stride, "rate": rate,
                    "in_hw": tuple(in_hw), "out_hw": tuple(out_hw),
                    "transposed": transposed})
        return tuple(out_hw)

    h, w = hw
    if cfg["family"] == "resnet_v1":
        def slim(size, k, stride, rate):
            keff = k + (k - 1) * (rate - 1)
            return (size + 2 * slim_pad(k, rate) - keff) // stride + 1

        cur = add("conv1", 7, 3, cfg["root_depth"], 2, 1, (h, w),
                  (slim(h, 7, 2, 1), slim(w, 7, 2, 1)))
        cur = ((cur[0] - 3) // 2 + 1, (cur[1] - 3) // 2 + 1)   # VALID pool
        cin = cfg["root_depth"]
        for name, depth, bn, stride, rate in resnet_units(cfg):
            nxt = tuple(slim(n, 3, stride, rate) for n in cur)
            if cin != depth:
                add(f"{name}/shortcut_conv", 1, cin, depth, stride, 1, cur,
                    nxt)
            add(f"{name}/conv1", 1, cin, bn, 1, 1, cur, cur)
            add(f"{name}/conv2", 3, bn, bn, stride, rate, cur, nxt)
            add(f"{name}/conv3", 1, bn, depth, 1, 1, nxt, nxt)
            cur, cin = nxt, depth
    elif cfg["family"] == "mobilenet_v2":
        def same(size, stride):
            return -(-size // stride)

        stem, head = mobilenet_depths(cfg)
        cur = add("conv_stem", 3, 3, stem, 2, 1, (h, w),
                  (same(h, 2), same(w, 2)))
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
        cin = head
    else:
        raise ValueError(f"unknown architecture family {cfg['family']!r}")
    s = cfg["deconvolution_stride"]
    add("part_pred", 3, cin, cfg["num_joints"], s, 1, cur,
        (cur[0] * s, cur[1] * s), transposed=True)
    return out


def map_hw(cfg: dict, hw) -> tuple[int, int]:
    """The score maps' (H, W) for frames of ``hw``."""
    return layers(cfg, hw)[-1]["out_hw"]

"""The published architectures as plans of layers, read from a
configuration file of ``configs/``: each family's backbone from its module
``families/<family>.py``, which also holds its description, then
DeepLabCut's prediction layer: a 3x3 transposed convolution of stride
``deconvolution_stride`` to the score maps (and a second to the location
refinement, which inference does not run). What the families share
(padding rules, slim's channel rounding) lives here.
"""

from __future__ import annotations

from dgpbench.reference import families


def make_divisible(channels: float, multiplier: float,
                   divisor: int = 8) -> int:
    """TF slim's ``_make_divisible`` of a width-scaled channel count."""
    v = max(divisor, int(channels * multiplier + divisor / 2)
            // divisor * divisor)
    if v < 0.9 * channels * multiplier:
        v += divisor
    return v


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

    cur, cin = families.find(cfg).layers(cfg, hw, add)
    s = cfg["deconvolution_stride"]
    add("part_pred", 3, cin, cfg["num_joints"], s, 1, cur,
        (cur[0] * s, cur[1] * s), transposed=True)
    return out


def map_hw(cfg: dict, hw) -> tuple[int, int]:
    """The score maps' (H, W) for frames of ``hw``."""
    return layers(cfg, hw)[-1]["out_hw"]

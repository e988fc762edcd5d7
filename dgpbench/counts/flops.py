"""Operations and bytes of a configuration's published architecture at a
cell's shapes: the same work whatever kernels the program runs it on.

Multiply-adds are counted for every convolution and the score-map head's
transposed convolution; a FLOP is two of them. Elementwise work (batch
norm, activations, adds) is not counted, as the published counts do not.
"""

from __future__ import annotations

from dgpbench.counts import roofline
from dgpbench.reference import arch


def layer_macs(layer: dict) -> int:
    """Multiply-adds of one frame through one layer of ``arch.layers``."""
    k2 = layer["k"] * layer["k"]
    if layer["transposed"]:     # each input pixel scatters a k x k stamp
        h, w = layer["in_hw"]
        return h * w * layer["cin"] * layer["cout"] * k2
    h, w = layer["out_hw"]
    return h * w * layer["cout"] * k2 * layer["cin"] // layer["groups"]


def macs_per_frame(cfg: dict, hw, head: bool = True) -> int:
    """Multiply-adds of one frame: the backbone and, with ``head``, the
    score-map head (inference runs no other head)."""
    return sum(layer_macs(layer) for layer in arch.layers(cfg, hw)
               if head or not layer["transposed"])


def flops_per_frame(cfg: dict, hw) -> float:
    return 2.0 * macs_per_frame(cfg, hw)


def int8_sites(cfg: dict, hw) -> list[dict]:
    """The convolutions that an int8 model runs as int8 GEMMs: every
    backbone convolution but the depthwise ones (one multiply-add a pixel
    and channel: no GEMM) and the head (kept in the float type)."""
    return [layer for layer in arch.layers(cfg, hw)
            if not layer["transposed"] and layer["groups"] == 1]


def int8_gemm_bound_ms(cfg: dict, hw, batch: int) -> float:
    """Least device time of a batch's int8 convolutions: for each, the
    larger of its operations at the int8 peak and its bytes at the HBM
    rate, counting int8 input, weight and output read or written once and
    the float32 scale and bias of each output channel."""
    total = 0.0
    for layer in int8_sites(cfg, hw):
        (ih, iw), (oh, ow) = layer["in_hw"], layer["out_hw"]
        k2, cin, cout = layer["k"] ** 2, layer["cin"], layer["cout"]
        ops = 2.0 * batch * oh * ow * cout * k2 * cin
        n_bytes = (batch * ih * iw * cin + k2 * cin * cout + 8 * cout
                   + batch * oh * ow * cout)
        total += roofline.op_bound(ops, n_bytes,
                                   roofline.PEAK_OPS_PER_S["int8"])["bound_ms"]
    return total

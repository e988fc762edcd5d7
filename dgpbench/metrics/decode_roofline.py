"""The decode kernel's share of its roofline, %: the least time of the
decode of a batch's (B, H, W, joints) float32 maps (``counts/roofline.py::
decode_bound``: bytes in and out at the HBM rate, or its float32
operations) over the kernel's device time a batch."""

from dgpbench import harness
from dgpbench.counts import roofline

KERNEL = r"softargmax_likelihood"


def read(trace):
    ms = harness.device_ms(trace, KERNEL) / trace["batches"]
    if ms <= 0:
        return None
    return 100.0 * roofline.decode_bound(trace["map_shape"])["bound_ms"] / ms

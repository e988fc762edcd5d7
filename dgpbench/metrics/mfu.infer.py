"""The whole step's share of the card's peak, %: the configuration's
counted FLOPs a frame (backbone and score-map head at the cell's frame
size, ``counts/flops.py``) times the run's frames/s, over the dense peak
of the traffic's precision (bf16 989 TFLOP/s, int8 1979 TOP/s)."""

from dgpbench.counts import flops, roofline


def read(trace):
    work = flops.flops_per_frame(trace["config"], trace["frame_hw"])
    peak = roofline.PEAK_OPS_PER_S[trace["traffic"]["precision"]]
    return 100.0 * work * trace["frames_per_s"] / peak

"""The whole step's share of the card's peak over the card's own time, %:
the configuration's counted FLOPs a frame (backbone and score-map head at
the cell's frame size, ``counts/flops.py``) over ``card_ms_per_frame``
(CUDA events around each batch's model and decode), over the dense peak
of the traffic's precision (bf16 989 TFLOP/s, int8 1979 TOP/s). The
host's pace does not enter it; ``mfu.infer`` is the same work over the
wall-clock rate."""

from dgpbench.counts import flops, roofline


def read(trace):
    card_ms = trace.get("card_ms_per_frame")
    if not card_ms:
        return None
    work = flops.flops_per_frame(trace["config"], trace["frame_hw"])
    peak = roofline.PEAK_OPS_PER_S[trace["traffic"]["precision"]]
    return 100.0 * work / (1e-3 * card_ms) / peak

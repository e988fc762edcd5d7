"""The int8 GEMM kernels' share of their roofline, %: the least time of a
batch's int8 convolutions as the architecture counts them
(``counts/flops.py::int8_gemm_bound_ms``) over the device time a batch of
the kernels that run them (``mm_tiled`` and ``conv_int8``, both
instances of ``gemm_kernel`` in ``csrc/int8_gemm.cu``)."""

from dgpbench import harness
from dgpbench.counts import flops

KERNEL = r"gemm_kernel<|gemm_kernelI"


def read(trace):
    ms = harness.device_ms(trace, KERNEL) / trace["batches"]
    if ms <= 0:
        return None
    bound = flops.int8_gemm_bound_ms(trace["config"], trace["frame_hw"],
                                     trace["batch"])
    return 100.0 * bound / ms

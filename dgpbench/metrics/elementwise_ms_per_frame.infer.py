"""Device ms a frame in elementwise kernels: the float model's batch norm,
ReLU and residual adds, the int8 model's quantize, add and pool glue.
The patterns are ``counts/roofline.py::kernel_class``'s: a kernel that
is a decode, copy, GEMM or convolution is none of them."""

from dgpbench import harness

INCLUDE = r"(?i)elementwise|vectorized|reduce|pool|max"
EXCLUDE = (r"softargmax_likelihood|Memcpy HtoD|gemm_kernel"
           r"|(?i:conv|cudnn|xmma|implicit|gemm|wgrad|dgrad|fprop|sm90"
           r"|copy|memcpy|memset|cat|pad)")


def read(trace):
    ms = harness.device_ms(trace, INCLUDE, EXCLUDE)
    return ms / trace["frames"] if ms > 0 else None

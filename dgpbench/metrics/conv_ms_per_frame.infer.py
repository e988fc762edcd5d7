"""Device ms a frame in cuDNN's convolutions (the backbone's and the
heads'), outside MobileNetV2's depthwise range, which has a metric of its
own."""

from dgpbench import harness

INCLUDE = r"(?i)conv|cudnn|xmma|implicit|gemm|wgrad|dgrad|fprop|sm90"
EXCLUDE = r"softargmax_likelihood|Memcpy HtoD|gemm_kernel<|gemm_kernelI"
DEPTHWISE_RANGE = "depthwise_conv"


def read(trace):
    ms = (harness.device_ms(trace, INCLUDE, EXCLUDE)
          - harness.device_ms(trace, INCLUDE, EXCLUDE,
                              in_range=DEPTHWISE_RANGE))
    return ms / trace["frames"] if ms > 0 else None

"""Device ms a frame of MobileNetV2's depthwise convolutions: every kernel
inside the program's profiler range ``depthwise_conv``
(``models/mobilenet.py::DEPTHWISE_RANGE``)."""

from dgpbench import harness

RANGE = "depthwise_conv"


def read(trace):
    ms = harness.device_ms(trace, in_range=RANGE)
    return ms / trace["frames"] if ms > 0 else None

"""Peaks of the card, least times of the kernels, and the device trace's
arithmetic.

Frozen copies of ``chip_smoke.py``'s ``decode_bound``, ``op_bound``,
``kernel_class`` and ``busy_us``, so that the program cannot move the
yardstick. The peaks are NVIDIA's data sheet for one H100 SXM (dense, no
sparsity) and assume its full power limit of 700 W; a run reports the
card's own limit beside them (:func:`power_limit_w`).
"""

from __future__ import annotations

import re
import subprocess

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12           # float32 outside the tensor cores
PEAK_OPS_PER_S = {              # tensor cores, dense
    "bfloat16": 989e12,
    "int8": 1979e12,
    "tf32": 495e12,
}
DATASHEET_POWER_W = 700.0


def power_limit_w() -> float | None:
    """The card's power limit as ``nvidia-smi`` reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def decode_bound(shape) -> dict:
    """Least time of the decode at (B, H, W, C) float32 maps: each logit
    read once, the weight vectors read once, mu and lik written once; 10
    float32 operations a logit (scale, max, exp, three weighted sums)."""
    b, h, w, c = shape
    n_bytes = 4 * (b * h * w * c + 3 * b * c + 2 * (h + w))
    n_ops = 10 * b * h * w * c
    bound = {"bytes": 1e3 * n_bytes / HBM_BYTES_PER_S,
             "operations": 1e3 * n_ops / F32_OPS_PER_S}
    bound_by = max(bound, key=bound.get)
    return {"bound_ms": bound[bound_by], "bound_by": bound_by,
            "bytes": n_bytes}


def op_bound(ops: float, n_bytes: float, ops_per_s: float) -> dict:
    """Least time for ``ops`` tensor-core operations at the dense peak and
    ``n_bytes`` moved (each input read once, each output written once)."""
    bound = {"bytes": 1e3 * n_bytes / HBM_BYTES_PER_S,
             "operations": 1e3 * ops / ops_per_s}
    bound_by = max(bound, key=bound.get)
    return {"bound_ms": bound[bound_by], "bound_by": bound_by}


def kernel_class(name: str) -> str:
    """Sort a device kernel's name into decode, int8_gemm (the port's int8
    GEMM, matched before the library GEMMs), convolution, h2d (copies from
    the host), elementwise, copy (on the device: copies, pads, concats) or
    other."""
    for label, pattern in (
            ("decode", r"softargmax_likelihood"),
            ("h2d", r"Memcpy HtoD"),
            ("int8_gemm", r"gemm_kernel<|gemm_kernelI"),
            ("convolution",
             r"(?i)conv|cudnn|xmma|implicit|gemm|wgrad|dgrad|fprop|sm90"),
            ("copy", r"(?i)copy|memcpy|memset|cat|pad"),
            ("elementwise", r"(?i)elementwise|vectorized|reduce|pool|max")):
        if re.search(pattern, name):
            return label
    return "other"


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(intervals):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        total += cur_end - cur_start
    return total

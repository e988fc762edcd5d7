"""Wrapper of the CUDA decode kernel ``csrc/softargmax.cu``.

``softargmax_likelihood(scoremaps, gamma, gauss_len, truncate)`` turns
(B, H, W, C) float32 logits into ``mu`` (B, C, 2) and ``lik`` (B, C). It
replaces the Pallas kernel of ``deepgraphpose_tpu/ops/pallas/
softargmax_kernel.py`` and the likelihood read of ``infer/predict.py``.

The decode is the custom op ``dgp_torch::softargmax_likelihood`` (``OP``),
so that a ``torch.export`` program holds the kernel as one node: its CPU
implementation is the plain version in ``ops/softargmax.py``, its CUDA
implementation launches the kernel or raises, and its fake implementation
gives the output shapes and builds nothing. ``launches`` counts the kernel
launches, so a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from deepgraphpose_tpu_torch.ops import softargmax as plain
from deepgraphpose_tpu_torch.ops.kernels import build

launches = 0
_weights_cache: dict = {}
_sm_count: dict = {}
MAX_THREADS = 544       # consumer threads a CTA; a producer warp joins them
# logits of one joint that one consumer sums in a frame, in float32: at
# 408 its rounding reached 1.5e-4 cells on the H100, at 94 (the main
# path) 3e-5 (PERF.md)
MAX_TERMS = 128
_MAX_STAGES = 8
_MAX_SMEM = 232448      # bytes of shared memory a CTA may use on sm_90
H100_SMS = 132


class Layout(NamedTuple):
    """A launch of the kernel: clusters of ``cluster`` CTAs split each frame
    (joint group) into contiguous pixel ranges; a CTA of ``threads``
    consumers (and one producer warp) streams its range through ``stages``
    ring slots of ``steps`` pixel rows of consumers. Where threads / joints
    is a multiple of the map width, each consumer keeps one pixel column
    (the kernel's column path)."""
    cluster: int
    threads: int
    stages: int
    steps: int


def _check(scoremaps: torch.Tensor) -> None:
    if scoremaps.dim() != 4:
        raise ValueError(f"expected (B, H, W, C) scoremaps, got shape "
                         f"{tuple(scoremaps.shape)}")
    if scoremaps.dtype != torch.float32:
        raise TypeError(f"expected float32 scoremaps, got {scoremaps.dtype}")
    if scoremaps.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {scoremaps.device}")
    if not scoremaps.is_contiguous():
        raise ValueError("scoremaps must be contiguous (B, H, W, C)")


def kernel_weights(h: int, w: int, gauss_len: float,
                   truncate: float = 1.0) -> np.ndarray:
    """The weight vectors as the kernel reads them: pairs (A(i), Ar(i)) for
    i < H, then (B(j), Bc(j)) for j < W, zero-padded to a multiple of 4
    floats (one bulk copy of whole 16-byte units)."""
    a, ar, b, bc = np.split(
        plain.smoothing_weights(h, w, gauss_len, truncate),
        np.cumsum([h, h, w]))
    pairs = np.concatenate([np.stack([a, ar], 1).ravel(),
                            np.stack([b, bc], 1).ravel()])
    return np.pad(pairs, (0, -pairs.size % 4))


def _weights(h: int, w: int, gauss_len: float, truncate: float,
             device: torch.device) -> torch.Tensor:
    key = (h, w, float(gauss_len), float(truncate), device)
    wts = _weights_cache.get(key)
    if wts is None:     # a fresh allocation: 16-byte aligned
        wts = torch.from_numpy(kernel_weights(h, w, gauss_len,
                                              truncate)).to(device)
        _weights_cache[key] = wts
    return wts


def joint_group(joints: int, hw: int) -> int:
    """Joints a CTA owns (J) on maps of ``hw`` pixels: all of them up to
    MAX_THREADS, else an even split. Where one row of consumers cannot keep
    each consumer's sum within MAX_TERMS logits even with a cluster of 8
    CTAs, at most 512 // rows joints, so that ``launch_shape`` gives each
    joint the ``rows`` it needs."""
    rows = -(-hw // (8 * MAX_TERMS))
    cap = MAX_THREADS if rows == 1 else 512 // rows
    groups = -(-joints // cap)
    return -(-joints // groups)


def smem_bytes(h: int, w: int, joints: int, layout: Layout) -> int:
    """Dynamic shared memory of a launch (smem_bytes in the .cu):
    the barriers, the ring, the weight vectors and the per-joint partials
    of each rank of a cluster."""
    per = joint_group(joints, h * w)
    slot = (layout.steps * (layout.threads // per) * joints + 7) & ~3
    floats = layout.stages * slot + 2 * (h + w)
    return (16 * _MAX_STAGES + 16 + 4 * ((floats + 3) & ~3)
            + 16 * per * layout.cluster)


def launch_shape(batch: int, h: int, w: int, joints: int,
                 sms: int = H100_SMS) -> Layout:
    """The launch for (B, H, W, C) maps on a card with ``sms`` SMs.

    Threads: whole map rows of every joint (one pixel column a consumer)
    where C * W fits a CTA, else about 512 consumers of all the CTA's
    joints; a consumer gets 4 pixels at least. Cluster: 1 while the
    frames (times joint groups) fill half the SMs, else the smallest of 2,
    4, 8 that does while each CTA keeps two chunks of 8 steps: at B = 128
    on the H100 every cluster size is one wave of the same work an SM and
    a cluster only adds its CTAs' fixed latency, while at B = 1, 16 and 64
    clusters were up to 1.7x faster than one CTA a frame (PERF.md).
    Then the cluster grows (to 8 at most) until no consumer sums more
    than MAX_TERMS logits of a frame.
    Steps: the largest of 16, 8, 4 of which a CTA holds two chunks.
    Stages: 2, fewer where a CTA has one chunk.
    """
    per = joint_group(joints, h * w)
    groups = -(-joints // per)
    hw = h * w
    if per == joints and per * w <= MAX_THREADS:   # no more rows than h / 4
        threads = per * w * max(1, min(512 // (per * w), h // 4))
    else:
        threads = per * max(1, min(512 // per, hw // 4))
    rows = threads // per
    cluster = 1
    while (cluster < 8 and 2 * batch * groups * cluster < sms
           and hw >= 2 * cluster * 2 * 8 * rows):
        cluster *= 2
    while cluster < 8 and -(-hw // (cluster * rows)) > MAX_TERMS:
        cluster *= 2
    per_cta = -(-hw // cluster)
    steps = next((s for s in (16, 8) if 2 * s * rows <= per_cta), 4)
    stages = 2 if per_cta > steps * rows else 1
    layout = Layout(cluster, threads, stages, steps)
    if smem_bytes(h, w, joints, layout) > _MAX_SMEM:
        layout = layout._replace(stages=1)
    return layout


_lib_typed = None


def _lib():
    global _lib_typed
    if _lib_typed is None:
        lib = build.load("softargmax")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.softargmax_likelihood_launch.restype = i
        lib.softargmax_likelihood_launch.argtypes = [p] * 4 + [i] * 9 + [
            ctypes.c_float, p]
        _lib_typed = lib
    return _lib_typed


def _sms(dev: torch.device) -> int:
    n = _sm_count.get(dev)
    if n is None:
        n = torch.cuda.get_device_properties(dev).multi_processor_count
        _sm_count[dev] = n
    return n


def _launch(scoremaps: torch.Tensor, gamma: float, gauss_len: float,
            truncate: float, layout: Layout | None = None):
    global launches
    _check(scoremaps)
    b, h, w, c = scoremaps.shape
    dev = scoremaps.device
    mu = torch.empty((b, c, 2), dtype=torch.float32, device=dev)
    lik = torch.empty((b, c), dtype=torch.float32, device=dev)
    if b == 0 or c == 0:
        return mu, lik
    fn = _lib().softargmax_likelihood_launch
    with torch.cuda.device(dev):
        wts = _weights(h, w, gauss_len, truncate, dev)
        lay = layout or launch_shape(b, h, w, c, _sms(dev))
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(scoremaps.data_ptr(), wts.data_ptr(), mu.data_ptr(),
                lik.data_ptr(), b, h, w, c, joint_group(c, h * w), lay.threads,
                lay.cluster, lay.stages, lay.steps, float(gamma), stream)
    if rc != 0:
        raise RuntimeError(f"softargmax_likelihood launch failed: CUDA error "
                           f"{rc} at shape {(b, h, w, c)}, layout {lay}")
    launches += 1
    return mu, lik


@torch.library.custom_op("dgp_torch::softargmax_likelihood", mutates_args=(),
                         device_types="cpu")
def _op(scoremaps: torch.Tensor, gamma: float, gauss_len: float,
        truncate: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W, C) float32 logits -> (mu (B, C, 2), lik (B, C)): the plain
    version on a CPU tensor, the kernel on a CUDA one."""
    _check(scoremaps)
    return plain.softargmax_likelihood(scoremaps, gamma, gauss_len, truncate)


@_op.register_kernel("cuda")
def _op_cuda(scoremaps, gamma, gauss_len, truncate):
    return _launch(scoremaps, gamma, gauss_len, truncate)


@_op.register_fake
def _op_fake(scoremaps, gamma, gauss_len, truncate):
    b, _, _, c = scoremaps.shape
    return scoremaps.new_empty((b, c, 2)), scoremaps.new_empty((b, c))


OP = torch.ops.dgp_torch.softargmax_likelihood


def softargmax_likelihood(scoremaps: torch.Tensor, gamma: float,
                          gauss_len: float, truncate: float = 1.0,
                          layout: Layout | None = None):
    """Forward-only decode: (mu (B, C, 2), lik (B, C)) float32, through
    ``OP``.

    ``layout`` overrides :func:`launch_shape` on the card (the kernel
    launched directly, not through the op), so that layouts can be timed
    against each other.
    """
    _check(scoremaps)
    if layout is not None and scoremaps.device.type == "cuda":
        return _launch(scoremaps, gamma, gauss_len, truncate, layout)
    return OP(scoremaps, float(gamma), float(gauss_len), float(truncate))


class _SoftargmaxCuda(torch.autograd.Function):
    """Kernel forward; the backward recomputes through the plain version,
    as the Pallas kernel's custom VJP does (no backward kernel exists)."""

    @staticmethod
    def forward(ctx, scoremaps, gamma, gauss_len, truncate):
        ctx.save_for_backward(scoremaps)
        ctx.args = (gamma, gauss_len, truncate)
        mu, _ = OP(scoremaps, float(gamma), float(gauss_len), float(truncate))
        return mu

    @staticmethod
    def backward(ctx, grad_mu):
        (scoremaps,) = ctx.saved_tensors
        gamma, gauss_len, truncate = ctx.args
        with torch.enable_grad():
            s = scoremaps.detach().requires_grad_(True)
            mu, _ = plain.softargmax_2d(s, gamma=gamma, gauss_len=gauss_len,
                                        truncate=truncate)
            (grad,) = torch.autograd.grad(mu, s, grad_mu)
        return grad, None, None, None


def softargmax_2d_cuda(scoremaps: torch.Tensor, gamma: float = 1.0,
                       gauss_len: float = 2.0,
                       truncate: float = 1.0) -> torch.Tensor:
    """Differentiable (B, H, W, C) logits -> mu (B, C, 2). On the CPU the
    plain version, in the logits' own float dtype; on the card the kernel,
    which takes float32 only."""
    if scoremaps.device.type == "cpu":
        return plain.softargmax_2d(scoremaps, gamma=gamma,
                                   gauss_len=gauss_len, truncate=truncate)[0]
    _check(scoremaps)
    return _SoftargmaxCuda.apply(scoremaps, gamma, gauss_len, truncate)

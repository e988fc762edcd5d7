"""Wrapper of the CUDA decode kernel ``csrc/softargmax.cu``.

``softargmax_likelihood(scoremaps, gamma, gauss_len, truncate)`` turns
(B, H, W, C) float32 logits into ``mu`` (B, C, 2) and ``lik`` (B, C). It
replaces the Pallas kernel of ``deepgraphpose_tpu/ops/pallas/
softargmax_kernel.py`` and the likelihood read of ``infer/predict.py``.

A tensor on the CPU goes to the plain version in ``ops/softargmax.py``; a
CUDA tensor launches the kernel or raises. ``launches`` counts the kernel
launches, so a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from deepgraphpose_tpu_torch.ops import softargmax as plain
from deepgraphpose_tpu_torch.ops.kernels import build

launches = 0
_weights_cache: dict = {}
_MAX_THREADS = 1024
_UNROLL = 16            # pixels a thread loads per step (kUnroll in the .cu)


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


def _weights(h: int, w: int, gauss_len: float, truncate: float,
             device: torch.device) -> torch.Tensor:
    key = (h, w, float(gauss_len), float(truncate), device)
    wts = _weights_cache.get(key)
    if wts is None:
        host = torch.from_numpy(
            plain.smoothing_weights(h, w, gauss_len, truncate))
        wts = host.to(device)
        _weights_cache[key] = wts
    return wts


def launch_shape(h: int, w: int, joints: int) -> tuple[int, int]:
    """(joints per block J, threads per block) for (H, W, C) maps.

    One block reads all joints of a frame (J = C), so a warp reads
    contiguous floats. Its rows of threads are as many as give each thread
    two steps of ``_UNROLL`` pixels, up to the block's thread limit. On the
    H100 this was the fastest of the layouts ``chip_smoke.py`` times at the
    main path's full-frame and tracked-crop maps (PERF.md).
    """
    per_block = min(joints, _MAX_THREADS)
    rows = min(_MAX_THREADS // per_block, -(-(h * w) // (2 * _UNROLL)))
    return per_block, per_block * max(rows, 1)


def _launch(scoremaps: torch.Tensor, gamma: float, gauss_len: float,
            truncate: float, layout: tuple[int, int] | None = None):
    global launches
    b, h, w, c = scoremaps.shape
    dev = scoremaps.device
    mu = torch.empty((b, c, 2), dtype=torch.float32, device=dev)
    lik = torch.empty((b, c), dtype=torch.float32, device=dev)
    if b == 0 or c == 0:
        return mu, lik
    lib = build.load("softargmax")
    fn = lib.softargmax_likelihood_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p]
    with torch.cuda.device(dev):
        wts = _weights(h, w, gauss_len, truncate, dev)
        per_block, threads = layout or launch_shape(h, w, c)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(scoremaps.data_ptr(), wts.data_ptr(), mu.data_ptr(),
                lik.data_ptr(), b, h, w, c, per_block, threads, float(gamma),
                stream)
    if rc != 0:
        raise RuntimeError(f"softargmax_likelihood launch failed: CUDA error "
                           f"{rc} at shape {(b, h, w, c)}")
    launches += 1
    return mu, lik


def softargmax_likelihood(scoremaps: torch.Tensor, gamma: float,
                          gauss_len: float, truncate: float = 1.0,
                          layout: tuple[int, int] | None = None):
    """Forward-only decode: (mu (B, C, 2), lik (B, C)) float32.

    ``layout`` = (joints per block, threads per block) overrides
    :func:`launch_shape`, so that layouts can be timed against each other.
    """
    _check(scoremaps)
    if scoremaps.device.type == "cpu":
        return plain.softargmax_likelihood(scoremaps, gamma, gauss_len,
                                           truncate)
    return _launch(scoremaps, gamma, gauss_len, truncate, layout)


class _SoftargmaxCuda(torch.autograd.Function):
    """Kernel forward; the backward recomputes through the plain version,
    as the Pallas kernel's custom VJP does (no backward kernel exists)."""

    @staticmethod
    def forward(ctx, scoremaps, gamma, gauss_len, truncate):
        ctx.save_for_backward(scoremaps)
        ctx.args = (gamma, gauss_len, truncate)
        mu, _ = _launch(scoremaps, gamma, gauss_len, truncate)
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
    """Differentiable (B, H, W, C) logits -> mu (B, C, 2)."""
    _check(scoremaps)
    if scoremaps.device.type == "cpu":
        return plain.softargmax_2d(scoremaps, gamma=gamma,
                                   gauss_len=gauss_len, truncate=truncate)[0]
    return _SoftargmaxCuda.apply(scoremaps, gamma, gauss_len, truncate)

"""Wrapper of the CUDA kernel ``csrc/bn_act.cu``: a frozen batch-norm, the
residual add and the activation that follow a convolution, in one pass.

``frozen_bn_act(x, inv, shift, residual, inv_r, shift_r, act)`` computes
``act(x * inv + shift [+ r'])`` per channel of (N, C, H, W) ``x``, where
``r'`` is ``residual``, or ``residual * inv_r + shift_r`` (a projection
shortcut's batch-norm), and ``act`` is ``"none"``, ``"relu"`` or
``"relu6"``. Each operation rounds to ``x``'s type, as the chain of
PyTorch ops does (:func:`plain`), so the kernel gives the chain's bits in
bfloat16 and in float32.

It is the custom op ``dgp_torch::frozen_bn_act`` (``OP``), so that a
``torch.export`` program holds it as one node: its CPU implementation is
:func:`plain`, its CUDA implementation launches the kernel on what
:func:`takes` admits and raises on anything else, and its fake
implementation allocates like ``x``. ``launches`` counts the kernel's
launches. The models call it through ``models/resnet.py::bn_act``, which
runs the plain chain wherever the kernel does not take the call.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from deepgraphpose_tpu_torch.ops.kernels import build

launches = 0
DTYPES = (torch.bfloat16, torch.float32)


def relu6(x: torch.Tensor) -> torch.Tensor:
    return F.hardtanh(x, 0.0, 6.0)


ACTIVATIONS = {"none": lambda y: y, "relu": F.relu, "relu6": relu6}
ACTS = tuple(ACTIVATIONS)           # the kernel's activation codes, in order


def dense(x: torch.Tensor) -> bool:
    """(N, C, H, W) in channels_last or contiguous memory: the layouts the
    kernel reads and writes."""
    return x.dim() == 4 and (x.is_contiguous(memory_format=torch.channels_last)
                             or x.is_contiguous())


def takes(x: torch.Tensor, residual: torch.Tensor | None = None) -> bool:
    """Whether the kernel reads and writes these tensors: ``x`` in
    channels_last memory, 16-byte aligned, its C a multiple of the 16-byte
    vector (8 bfloat16, 4 float32) and at most 1024 vectors, fewer than
    2**31 - 1 pixels; a residual whose channels are contiguous and whose other
    strides are whole vectors (the same layout, or slim's subsample view),
    16-byte aligned. Every site of ResNet-50 and MobileNetV2 qualifies."""
    if x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        return False
    vec = 16 // x.element_size()
    n, c, h, w = x.shape
    if (c % vec or c // vec > 1024 or n * h * w >= 2 ** 31 - 1
            or x.storage_offset() % vec):
        return False
    if residual is None:
        return True
    sn, sc, sh, sw = residual.stride()
    return (sc == 1 and sn % vec == 0 and sh % vec == 0 and sw % vec == 0
            and residual.storage_offset() % vec == 0)


def plain(x, inv, shift, residual=None, inv_r=None, shift_r=None,
          act: str = "none") -> torch.Tensor:
    """The chain the kernel replaces: the BN affine by per-channel factors
    of ``x``'s type, the residual (through its own affine first where
    ``inv_r`` is given), the activation."""
    y = x * inv[:, None, None] + shift[:, None, None]
    if residual is not None:
        if inv_r is not None:
            residual = residual * inv_r[:, None, None] + shift_r[:, None, None]
        y = residual + y
    return ACTIVATIONS[act](y)


def _check(x, inv, shift, residual, inv_r, shift_r, act) -> None:
    if act not in ACTS:
        raise ValueError(f"frozen_bn_act: act {act!r} is not one of {ACTS}")
    if x.dtype not in DTYPES or not dense(x):
        raise ValueError(f"frozen_bn_act: x must be (N, C, H, W) bfloat16 or "
                         f"float32 in channels_last or contiguous memory; got "
                         f"{x.dtype} {tuple(x.shape)} strides {x.stride()}")
    if (inv_r is None) != (shift_r is None) or (residual is None
                                                and inv_r is not None):
        raise ValueError("frozen_bn_act: inv_r and shift_r come together, "
                         "and only with a residual")
    for t in (inv, shift, inv_r, shift_r):
        if t is not None and (t.shape != (x.shape[1],) or t.dtype != x.dtype
                              or t.device != x.device
                              or not t.is_contiguous()):
            raise ValueError(f"frozen_bn_act: per-channel factors must be "
                             f"contiguous ({x.shape[1]},) {x.dtype} on "
                             f"{x.device}")
    if residual is not None and (residual.shape != x.shape
                                 or residual.dtype != x.dtype
                                 or residual.device != x.device):
        raise ValueError(f"frozen_bn_act: residual {residual.dtype} "
                         f"{tuple(residual.shape)} on {residual.device} does "
                         f"not match x")


_lib_typed = None


def _lib():
    global _lib_typed
    if _lib_typed is None:
        lib = build.load("bn_act")
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.frozen_bn_act_launch.restype = i
        lib.frozen_bn_act_launch.argtypes = [p] * 7 + [i, i] + [q] * 8 + [p]
        _lib_typed = lib
    return _lib_typed


def _launch(x, inv, shift, residual, inv_r, shift_r, act):
    global launches
    _check(x, inv, shift, residual, inv_r, shift_r, act)
    vec = 16 // x.element_size()
    if not takes(x, residual) or any(
            t is not None and t.storage_offset() % vec
            for t in (inv, shift, inv_r, shift_r)):
        raise ValueError(f"frozen_bn_act: the kernel does not take x "
                         f"{x.dtype} {tuple(x.shape)} strides {x.stride()}"
                         + ("" if residual is None else
                            f", residual strides {residual.stride()}"))
    out = torch.empty_like(x)       # x's strides: x is dense
    if x.numel() == 0:
        return out

    def ptr(t):
        return None if t is None else t.data_ptr()

    r_strides = (0, 0, 0, 0) if residual is None else residual.stride()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _lib().frozen_bn_act_launch(
            x.data_ptr(), inv.data_ptr(), shift.data_ptr(), ptr(residual),
            ptr(inv_r), ptr(shift_r), out.data_ptr(),
            int(x.dtype == torch.bfloat16), ACTS.index(act), *x.shape,
            *r_strides, stream)
    if rc != 0:
        raise RuntimeError(f"frozen_bn_act launch failed: CUDA error {rc} at "
                           f"{x.dtype} {tuple(x.shape)} strides {x.stride()}")
    launches += 1
    return out


@torch.library.custom_op("dgp_torch::frozen_bn_act", mutates_args=(),
                         device_types="cpu")
def _op(x: torch.Tensor, inv: torch.Tensor, shift: torch.Tensor,
        residual: Optional[torch.Tensor], inv_r: Optional[torch.Tensor],
        shift_r: Optional[torch.Tensor], act: str) -> torch.Tensor:
    """The frozen-BN tail, laid out as ``x``: :func:`plain` on a CPU
    tensor, the kernel on a CUDA one."""
    _check(x, inv, shift, residual, inv_r, shift_r, act)
    return torch.empty_like(x).copy_(
        plain(x, inv, shift, residual, inv_r, shift_r, act))


@_op.register_kernel("cuda")
def _op_cuda(x, inv, shift, residual, inv_r, shift_r, act):
    return _launch(x, inv, shift, residual, inv_r, shift_r, act)


@_op.register_fake
def _op_fake(x, inv, shift, residual, inv_r, shift_r, act):
    return torch.empty_like(x)


OP = torch.ops.dgp_torch.frozen_bn_act


def frozen_bn_act(x: torch.Tensor, inv: torch.Tensor, shift: torch.Tensor,
                  residual: torch.Tensor | None = None,
                  inv_r: torch.Tensor | None = None,
                  shift_r: torch.Tensor | None = None,
                  act: str = "none") -> torch.Tensor:
    """``act(x * inv + shift [+ r'])`` through ``OP`` (forward only)."""
    return OP(x, inv, shift, residual, inv_r, shift_r, act)

"""Wrapper of the CUDA GEMM kernel ``csrc/int8_gemm.cu``.

* :func:`mm` is ``mm_tiled``, the port of ``pallas_mm``
  (``scripts/int8_conv_probe.py``): int8 x int8 -> int32 and bf16 x bf16 ->
  float32.
* :func:`conv_int8` is every quantized conv of the int8 model. A 1x1
  stride-1 conv over NHWC input is a dense product, so it runs on
  ``mm_tiled`` with the epilogue fused, and may take its input wide (bf16
  or f32, with ``in_scale``): the kernel quantizes it as it loads it.
  Every other conv (the 7x7/2 stem, the 3x3s with stride or rate, the
  strided 1x1 shortcuts) runs on ``conv_int8``, which gathers its int8 A
  tile by im2col addressing.

Both take B as (K, N), as the plain versions do; the kernel's ``wgmma``
reads it transposed, (N, K), from a copy that the caller keeps
(``b_nk`` / ``w_nk``) or that the wrapper makes per call.

A tensor on the CPU goes to the plain version in ``ops/int8_gemm.py``; a
CUDA tensor launches the kernel or raises. ``launches`` counts the kernel
launches of each launch function, so a run can show that its main path
went through them.
"""

from __future__ import annotations

import ctypes

import torch

from deepgraphpose_tpu_torch.ops import int8_gemm as plain
from deepgraphpose_tpu_torch.ops.kernels import build

launches = {"mm_tiled": 0, "conv_int8": 0}
RELU6 = plain.RELU6  # the epilogue's ReLU6 code

_OUT_MODES = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2}


def _out_spec(out) -> tuple[int, torch.dtype, float]:
    """-> (kernel out_mode, output dtype, s_next)."""
    if isinstance(out, tuple):
        if len(out) != 2 or out[0] != "int8":
            raise ValueError(f"out must be ('int8', scale) or a dtype, "
                             f"got {out!r}")
        return 3, torch.int8, float(out[1])
    if out not in _OUT_MODES:
        raise TypeError(f"unsupported output type {out!r}")
    return _OUT_MODES[out], out, 0.0


_lib_typed = None


def _lib():
    global _lib_typed
    if _lib_typed is None:
        lib = build.load("int8_gemm")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.mm_tiled_launch.restype = i
        lib.mm_tiled_launch.argtypes = [i, p, p, p, i, i, i, f, p, p, i, i,
                                         f, p]
        lib.conv_int8_launch.restype = i
        lib.conv_int8_launch.argtypes = [p, p, p, p, p, i, i, f] + [i] * 12 + [
            p]
        lib.int8_gemm_stages.restype = i
        lib.int8_gemm_stages.argtypes = []
        _lib_typed = lib
    return _lib_typed


def ring_stages() -> int:
    """The kernel's pipeline depth: K tiles in its shared-memory ring."""
    return _lib().int8_gemm_stages()


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _device_of(*tensors) -> torch.device:
    dev = tensors[0].device
    for t in tensors:
        if t is not None and t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _check_int32(name: str, value: int) -> None:
    """The launch functions take 32-bit sizes (ctypes would wrap a larger
    one silently)."""
    if value > 2 ** 31 - 1:
        raise ValueError(f"{name} = {value} exceeds the kernel's 32-bit "
                         "sizes")


def _launched(name: str, rc: int, shape) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} at "
                           f"shape {shape}")
    launches[name] += 1


def _transposed(b: torch.Tensor, b_nk: torch.Tensor | None) -> torch.Tensor:
    """The kernel's (N, K) form of a (K, N) operand: ``b_nk`` where the
    caller keeps one (checked for shape, type and layout only), else made
    now."""
    if b_nk is None:
        return b.t().contiguous()
    if (b_nk.shape != b.shape[::-1] or b_nk.dtype != b.dtype
            or b_nk.device != b.device or not b_nk.is_contiguous()):
        raise ValueError(f"the (N, K) copy must be a contiguous "
                         f"{tuple(b.shape[::-1])} {b.dtype} on {b.device}, "
                         f"got {tuple(b_nk.shape)} {b_nk.dtype} on "
                         f"{b_nk.device}")
    return b_nk


def mm(a: torch.Tensor, b: torch.Tensor, acc_dtype=None,
       b_nk: torch.Tensor | None = None) -> torch.Tensor:
    """(M, K) @ (K, N), row-major: int8 -> int32, bf16 -> float32.

    The kernel reads B as its (N, K) transpose: ``b_nk``, a contiguous copy
    the caller keeps, or one made per call.
    """
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"expected (M, K) @ (K, N), got {tuple(a.shape)} "
                         f"@ {tuple(b.shape)}")
    dev = _device_of(a, b)
    if dev.type == "cpu":
        return plain.mm(a, b, acc_dtype)
    dtype = {torch.int8: 0, torch.bfloat16: 1}.get(a.dtype)
    if dtype is None or b.dtype != a.dtype:
        raise TypeError(f"mm takes int8 or bf16 operands of one type, got "
                        f"{a.dtype} and {b.dtype}")
    acc = torch.int32 if dtype == 0 else torch.float32
    if acc_dtype is not None and acc_dtype != acc:
        raise TypeError(f"{a.dtype} operands accumulate in {acc}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("mm takes row-major contiguous operands")
    (m, k), n = a.shape, b.shape[1]
    for name, v in (("M", m), ("N", n), ("K", k)):
        _check_int32(name, v)
    out = torch.empty((m, n), dtype=acc, device=dev)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    bt = _transposed(b, b_nk)
    with torch.cuda.device(dev):
        rc = _lib().mm_tiled_launch(
            dtype, a.data_ptr(), bt.data_ptr(), out.data_ptr(), m, n, k, 0.0,
            None, None, 0, 0, 0.0, torch.cuda.current_stream(dev).cuda_stream)
    _launched("mm_tiled", rc, (m, n, k))
    return out


def conv_int8(xq: torch.Tensor, w: torch.Tensor, k: int, stride: int,
              rate: int, pad, oscale: torch.Tensor | None,
              bias: torch.Tensor | None, relu: int, out,
              in_scale: float | None = None,
              w_nk: torch.Tensor | None = None) -> torch.Tensor:
    """One quantized conv over NHWC input; see ``ops/int8_gemm.py``.

    xq (B, H, W, Cin) contiguous: int8, or, for a 1x1 stride-1 conv, bf16 /
    float32 quantized with ``in_scale`` as the kernel loads it; w
    (k*k*Cin, N) int8 contiguous; oscale, bias (N,) float32 (unused when
    ``out`` is ``torch.int32``). The kernel reads the weight as its (N,
    k*k*Cin) transpose: ``w_nk``, a contiguous copy the caller keeps (as
    ``QuantConv.qw_nk``), or one made per call. ``pad`` is an int or
    ((top, bottom), (left, right)), ``relu`` the activation (0 / False, 1 /
    True ReLU, ``RELU6``); see ``ops/int8_gemm.py``. Returns (B, OH, OW, N)
    contiguous in ``out``'s type.
    """
    mode, out_dtype, s_next = _out_spec(out)
    wide = {torch.bfloat16: 2, torch.float32: 3}.get(xq.dtype)
    if xq.dim() != 4 or w.dtype != torch.int8 or not (
            (xq.dtype == torch.int8 and in_scale is None)
            or (wide and in_scale is not None)):
        raise TypeError(f"expected int8 NHWC input (or bf16 / float32 with "
                        f"in_scale) and int8 weights, got {xq.dtype} "
                        f"{tuple(xq.shape)}, in_scale {in_scale}, {w.dtype}")
    (top, bottom), (left, right) = plain.side_pads(pad)
    dense = k == 1 and stride == 1 and top == bottom == left == right == 0
    if wide and not dense:
        raise ValueError("a wide input is quantized on load only by 1x1 "
                         "stride-1 convs; quantize it first")
    b, h, wd, cin = xq.shape
    if w.dim() != 2 or w.shape[0] != k * k * cin:
        raise ValueError(f"weight {tuple(w.shape)} is not ({k * k * cin}, N) "
                         f"for a {k}x{k} conv over {cin} channels")
    n = w.shape[1]
    if mode:
        for name, v in (("oscale", oscale), ("bias", bias)):
            if (v is None or v.dtype != torch.float32 or v.shape != (n,)
                    or not v.is_contiguous()):
                raise ValueError(f"{name} must be a contiguous float32 ({n},)")
    dev = _device_of(xq, w, oscale, bias)
    act = int(relu)
    if not 0 <= act <= plain.RELU6:
        raise ValueError(f"relu must be 0, 1 or {plain.RELU6}, got {relu!r}")
    if min(top, bottom, left, right) < 0:
        raise ValueError(f"negative pad {pad!r}")
    if dev.type == "cpu":
        return plain.conv_int8(xq, w, k, stride, rate, pad, oscale, bias,
                               act, out, in_scale)
    if not (xq.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv_int8 takes contiguous NHWC input and a "
                         "contiguous (K, N) weight")
    oh, ow = plain.conv_out_hw(h, wd, k, stride, rate, pad)
    y = torch.empty((b, oh, ow, n), dtype=out_dtype, device=dev)
    if y.numel() == 0:
        return y
    wt = _transposed(w, w_nk)
    ep = (_ptr(oscale) if mode else None, _ptr(bias) if mode else None, act,
          mode, s_next)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if dense:
            _check_int32("M", b * h * wd)
            rc = _lib().mm_tiled_launch(
                wide or 0, xq.data_ptr(), wt.data_ptr(), y.data_ptr(),
                b * h * wd, n, cin, float(in_scale or 0.0), *ep, stream)
            _launched("mm_tiled", rc, (b * h * wd, n, cin))
        else:
            rc = _lib().conv_int8_launch(
                xq.data_ptr(), wt.data_ptr(), y.data_ptr(), *ep, b, h, wd, cin,
                oh, ow, n, k, stride, rate, top, left, stream)
            _launched("conv_int8", rc, (b, h, wd, cin, n, k, stride, rate))
    return y

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

Each launch function is a custom op, so that a ``torch.export`` program
holds the kernel as one node: ``dgp_torch::mm_tiled`` (``MM_OP``) and
``dgp_torch::conv_int8`` (``CONV_OP``). They take only tensors, ints and
floats: B in its (N, K) form, the epilogue as ``out_mode`` (``OUT_RAW``,
``OUT_F32``, ``OUT_BF16``, ``OUT_INT8``) and ``s_next``, a conv's pads
per side. The Python wrappers :func:`mm` and :func:`conv_int8` make those
choices (the output spec, the transposed operand, the dense route) and
call the ops. An op's CPU implementation is the plain version in
``ops/int8_gemm.py``; its CUDA implementation launches the kernel or
raises; its fake implementation gives the output's shape and type and
builds nothing. ``launches`` counts the kernel launches of each launch
function, so a run can show that its main path went through them.
"""

from __future__ import annotations

import ctypes

import torch

from deepgraphpose_tpu_torch.ops import int8_gemm as plain
from deepgraphpose_tpu_torch.ops.kernels import build

launches = {"mm_tiled": 0, "conv_int8": 0}
RELU6 = plain.RELU6  # the epilogue's ReLU6 code

# the kernel's out_mode: the raw accumulator (int32, or float32 for bf16
# operands), or the epilogue stored as float32, bf16, or requantized int8
OUT_RAW, OUT_F32, OUT_BF16, OUT_INT8 = 0, 1, 2, 3
_OUT_MODES = {torch.int32: OUT_RAW, torch.float32: OUT_F32,
              torch.bfloat16: OUT_BF16}
_OUT_DTYPES = {OUT_F32: torch.float32, OUT_BF16: torch.bfloat16,
               OUT_INT8: torch.int8}


def _out_spec(out) -> tuple[int, float]:
    """-> (kernel out_mode, s_next)."""
    if isinstance(out, tuple):
        if len(out) != 2 or out[0] != "int8":
            raise ValueError(f"out must be ('int8', scale) or a dtype, "
                             f"got {out!r}")
        return OUT_INT8, float(out[1])
    if out not in _OUT_MODES:
        raise TypeError(f"unsupported output type {out!r}")
    return _OUT_MODES[out], 0.0


def _out_dtype(out_mode: int, a_dtype: torch.dtype,
               quantized: bool) -> torch.dtype:
    """The output type of ``out_mode`` over A of ``a_dtype`` (``quantized``:
    a wide A quantized on load)."""
    if out_mode == OUT_RAW:
        return (torch.float32 if a_dtype == torch.bfloat16 and not quantized
                else torch.int32)
    if out_mode not in _OUT_DTYPES:
        raise ValueError(f"out_mode must be 0-3, got {out_mode}")
    return _OUT_DTYPES[out_mode]


def _plain_out(out_mode: int, s_next: float):
    """``out_mode`` as the plain versions' ``out``."""
    if out_mode == OUT_INT8:
        return ("int8", s_next)
    return {OUT_RAW: torch.int32, **_OUT_DTYPES}[out_mode]


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


def _a_code(a: torch.Tensor, in_scale: float | None) -> int:
    """The kernel's A type: 0 int8, 1 bf16, 2 / 3 bf16 / float32 quantized
    on load with ``in_scale``."""
    code = ({torch.int8: 0, torch.bfloat16: 1} if in_scale is None
            else {torch.bfloat16: 2, torch.float32: 3}).get(a.dtype)
    if code is None:
        raise TypeError(f"A of {a.dtype} with in_scale {in_scale} is not an "
                        "operand of mm_tiled")
    return code


@torch.library.custom_op("dgp_torch::mm_tiled", mutates_args=(),
                         device_types="cpu")
def _mm_op(a: torch.Tensor, b_nk: torch.Tensor, oscale: torch.Tensor | None,
           bias: torch.Tensor | None, relu: int, out_mode: int,
           s_next: float, in_scale: float | None) -> torch.Tensor:
    """(M, K) A times the (N, K) ``b_nk``, then the epilogue of
    ``out_mode``; A int8 or bf16, or bf16 / float32 quantized with
    ``in_scale``. The plain version on CPU tensors."""
    if in_scale is not None:
        a = plain.quantize_to(a, in_scale)
    acc = plain.mm(a, b_nk.t())
    if out_mode == OUT_RAW:
        return acc
    return plain.epilogue(acc, oscale, bias, relu,
                          _plain_out(out_mode, s_next))


@_mm_op.register_kernel("cuda")
def _mm_cuda(a, b_nk, oscale, bias, relu, out_mode, s_next, in_scale):
    code = _a_code(a, in_scale)
    if b_nk.dtype != (torch.bfloat16 if code == 1 else torch.int8):
        raise TypeError(f"A of {a.dtype} takes no B of {b_nk.dtype}")
    if code == 1 and out_mode != OUT_RAW:
        raise ValueError("bf16 operands have no epilogue")
    if not (a.is_contiguous() and b_nk.is_contiguous()):
        raise ValueError("mm_tiled takes contiguous (M, K) and (N, K)")
    (m, k), n = a.shape, b_nk.shape[0]
    for name, v in (("M", m), ("N", n), ("K", k)):
        _check_int32(name, v)
    out = torch.empty((m, n), dtype=_out_dtype(out_mode, a.dtype,
                                               in_scale is not None),
                      device=a.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    ep = ((_ptr(oscale), _ptr(bias)) if out_mode != OUT_RAW
          else (None, None))
    with torch.cuda.device(a.device):
        rc = _lib().mm_tiled_launch(
            code, a.data_ptr(), b_nk.data_ptr(), out.data_ptr(), m, n, k,
            float(in_scale or 0.0), *ep, relu, out_mode, s_next,
            torch.cuda.current_stream(a.device).cuda_stream)
    _launched("mm_tiled", rc, (m, n, k))
    return out


@_mm_op.register_fake
def _mm_fake(a, b_nk, oscale, bias, relu, out_mode, s_next, in_scale):
    return a.new_empty((a.shape[0], b_nk.shape[0]),
                       dtype=_out_dtype(out_mode, a.dtype,
                                        in_scale is not None))


@torch.library.custom_op("dgp_torch::conv_int8", mutates_args=(),
                         device_types="cpu")
def _conv_op(xq: torch.Tensor, w_nk: torch.Tensor,
             oscale: torch.Tensor | None, bias: torch.Tensor | None, k: int,
             stride: int, rate: int, pad_top: int, pad_bottom: int,
             pad_left: int, pad_right: int, relu: int, out_mode: int,
             s_next: float) -> torch.Tensor:
    """One int8 conv over NHWC ``xq`` with the (N, k*k*Cin) ``w_nk``, pads
    per side, then the epilogue of ``out_mode``. The plain version on CPU
    tensors."""
    return plain.conv_int8(xq, w_nk.t(), k, stride, rate,
                           ((pad_top, pad_bottom), (pad_left, pad_right)),
                           oscale, bias, relu, _plain_out(out_mode, s_next))


@_conv_op.register_kernel("cuda")
def _conv_cuda(xq, w_nk, oscale, bias, k, stride, rate, pad_top, pad_bottom,
               pad_left, pad_right, relu, out_mode, s_next):
    if xq.dtype != torch.int8 or w_nk.dtype != torch.int8:
        raise TypeError(f"conv_int8 takes int8 input and weights, got "
                        f"{xq.dtype} and {w_nk.dtype}")
    if not (xq.is_contiguous() and w_nk.is_contiguous()):
        raise ValueError("conv_int8 takes contiguous NHWC input and a "
                         "contiguous (N, K) weight")
    b, h, wd, cin = xq.shape
    pads = ((pad_top, pad_bottom), (pad_left, pad_right))
    oh, ow = plain.conv_out_hw(h, wd, k, stride, rate, pads)
    n = w_nk.shape[0]
    y = torch.empty((b, oh, ow, n), dtype=_out_dtype(out_mode, torch.int8,
                                                     False),
                    device=xq.device)
    if y.numel() == 0:
        return y
    ep = ((_ptr(oscale), _ptr(bias)) if out_mode != OUT_RAW
          else (None, None))
    with torch.cuda.device(xq.device):
        rc = _lib().conv_int8_launch(
            xq.data_ptr(), w_nk.data_ptr(), y.data_ptr(), *ep, relu, out_mode,
            s_next, b, h, wd, cin, oh, ow, n, k, stride, rate, pad_top,
            pad_left, torch.cuda.current_stream(xq.device).cuda_stream)
    _launched("conv_int8", rc, (b, h, wd, cin, n, k, stride, rate))
    return y


@_conv_op.register_fake
def _conv_fake(xq, w_nk, oscale, bias, k, stride, rate, pad_top, pad_bottom,
               pad_left, pad_right, relu, out_mode, s_next):
    b, h, wd, _ = xq.shape
    oh, ow = plain.conv_out_hw(h, wd, k, stride, rate,
                               ((pad_top, pad_bottom), (pad_left, pad_right)))
    return xq.new_empty((b, oh, ow, w_nk.shape[0]),
                        dtype=_out_dtype(out_mode, torch.int8, False))


MM_OP = torch.ops.dgp_torch.mm_tiled
CONV_OP = torch.ops.dgp_torch.conv_int8


def mm(a: torch.Tensor, b: torch.Tensor, acc_dtype=None,
       b_nk: torch.Tensor | None = None) -> torch.Tensor:
    """(M, K) @ (K, N), row-major: int8 -> int32, bf16 -> float32, through
    ``MM_OP``.

    The kernel reads B as its (N, K) transpose: ``b_nk``, a contiguous copy
    the caller keeps, or one made per call.
    """
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"expected (M, K) @ (K, N), got {tuple(a.shape)} "
                         f"@ {tuple(b.shape)}")
    _device_of(a, b)
    if a.dtype not in (torch.int8, torch.bfloat16) or b.dtype != a.dtype:
        raise TypeError(f"mm takes int8 or bf16 operands of one type, got "
                        f"{a.dtype} and {b.dtype}")
    acc = _out_dtype(OUT_RAW, a.dtype, False)
    if acc_dtype is not None and acc_dtype != acc:
        raise TypeError(f"{a.dtype} operands accumulate in {acc}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("mm takes row-major contiguous operands")
    return MM_OP(a, _transposed(b, b_nk), None, None, 0, OUT_RAW, 0.0, None)


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
    contiguous in ``out``'s type. A 1x1 stride-1 conv without pads runs on
    ``MM_OP``, every other on ``CONV_OP``.
    """
    mode, s_next = _out_spec(out)
    wide = xq.dtype in (torch.bfloat16, torch.float32)
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
    _device_of(xq, w, oscale, bias)
    act = int(relu)
    if not 0 <= act <= plain.RELU6:
        raise ValueError(f"relu must be 0, 1 or {plain.RELU6}, got {relu!r}")
    if min(top, bottom, left, right) < 0:
        raise ValueError(f"negative pad {pad!r}")
    if not (xq.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv_int8 takes contiguous NHWC input and a "
                         "contiguous (K, N) weight")
    wt = _transposed(w, w_nk)
    if not mode:
        oscale = bias = None
    if dense:
        _check_int32("M", b * h * wd)
        y = MM_OP(xq.view(b * h * wd, cin), wt, oscale, bias, act, mode,
                  s_next, None if in_scale is None else float(in_scale))
        return y.view(b, h, wd, n)
    return CONV_OP(xq, wt, oscale, bias, k, stride, rate, top, bottom, left,
                   right, act, mode, s_next)

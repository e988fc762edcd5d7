"""Tiled GEMM and int8 convolution: the plain PyTorch versions.

What the CUDA kernel ``csrc/int8_gemm.cu`` computes, written with PyTorch
ops. These run on the CPU (the tests hold them to the JAX package), and
``chip_smoke.py`` holds the kernel against them on the card. The kernel's
wrapper is ``ops/kernels/int8_gemm_kernel.py``.

* :func:`mm` is ``pallas_mm`` of ``scripts/int8_conv_probe.py``: (M, K) @
  (K, N), int8 accumulated in int32, bf16 in float32.
* :func:`conv_int8` is one quantized conv of the int8 model
  (``deepgraphpose_tpu/models/quant.py``, ``conv_fn``): an int8 x int8 ->
  int32 convolution over NHWC input, then the f32 epilogue
  ``y = acc * oscale + bias`` (+ ReLU or ReLU6) and either an int8
  requantization with the next conv's input scale or a float store.

A conv's ``pad`` is an int, the zero pad of every side (slim's symmetric
pads, the ResNets'), or ``((top, bottom), (left, right))``: TF SAME pads
one more on the high side for a stride-2 conv over an even side
(MobileNetV2). Its ``relu`` is the epilogue's activation: 0 / False none,
1 / True ReLU, :data:`RELU6` ReLU6.

The sums are exact: they run in float64, which holds every product and
partial sum of int8 (|acc| <= 127^2 * 4608 < 2^53) and of bf16 values
exactly, on the CPU and the card alike (int32 convolutions exist on
neither for the dilated 3x3s). The epilogue's multiply-add rounds once,
as a fused multiply-add does in the kernel and in XLA's CPU code for the
JAX package: the product of the float32 accumulator and scale is exact in
float64, and the float64 sum rounds to float32 (a second rounding can
differ from the fused one only where the float64 sum lands exactly on a
float32 midpoint, about one input in 2^29).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

RELU6 = 2  # the activation code of min(max(y, 0), 6)


def mm(a: torch.Tensor, b: torch.Tensor, acc_dtype=None) -> torch.Tensor:
    """(M, K) @ (K, N): int8 -> int32, bf16 -> float32.

    ``acc_dtype`` may name the accumulator (the Pallas kernel's scratch
    type); it must be the one the input type implies.
    """
    want = {torch.int8: torch.int32, torch.bfloat16: torch.float32}.get(
        a.dtype)
    if want is None or b.dtype != a.dtype:
        raise TypeError(f"mm takes int8 or bf16 operands of one type, got "
                        f"{a.dtype} and {b.dtype}")
    if acc_dtype is not None and acc_dtype != want:
        raise TypeError(f"{a.dtype} operands accumulate in {want}, "
                        f"not {acc_dtype}")
    return (a.double() @ b.double()).to(want)


def side_pads(pad) -> tuple[tuple[int, int], tuple[int, int]]:
    """``pad`` (an int, or per side) as ((top, bottom), (left, right))."""
    if isinstance(pad, int):
        return (pad, pad), (pad, pad)
    (top, bottom), (left, right) = pad
    return (int(top), int(bottom)), (int(left), int(right))


def conv_out_hw(h: int, w: int, k: int, stride: int, rate: int,
                pad) -> tuple[int, int]:
    keff = rate * (k - 1) + 1
    (top, bottom), (left, right) = side_pads(pad)
    return ((h + top + bottom - keff) // stride + 1,
            (w + left + right - keff) // stride + 1)


def conv_acc(xq: torch.Tensor, w: torch.Tensor, k: int, stride: int,
             rate: int, pad) -> torch.Tensor:
    """int32 accumulator (B, OH, OW, N) of an int8 conv.

    xq: (B, H, W, Cin) int8 NHWC. w: (k*k*Cin, N) int8, the HWIO weight
    flattened (row ``(dy*k + dx)*Cin + c``). ``pad``: see the module
    docstring.
    """
    cin = xq.shape[-1]
    n = w.shape[-1]
    weight = w.reshape(k, k, cin, n).permute(3, 2, 0, 1).double()
    (top, bottom), (left, right) = side_pads(pad)
    x = xq.permute(0, 3, 1, 2).double()
    if top != bottom or left != right:
        x = F.pad(x, (left, right, top, bottom))
        top = left = 0
    y = F.conv2d(x, weight, stride=stride, padding=(top, left),
                 dilation=rate)
    return y.permute(0, 2, 3, 1).to(torch.int32).contiguous()


def quantize_to(x: torch.Tensor, scale: float) -> torch.Tensor:
    """``clip(rint(x / scale), -127, 127)`` as int8 (round half to even).

    The divisor is a tensor on ``x``'s device: PyTorch's CUDA division by a
    host scalar multiplies by its reciprocal, which rounds differently.
    """
    s = torch.full((), scale, dtype=torch.float32, device=x.device)
    return torch.clamp(torch.round(x.to(torch.float32) / s), -127,
                       127).to(torch.int8)


def epilogue(acc: torch.Tensor, oscale: torch.Tensor | None,
             bias: torch.Tensor | None, relu: int, out) -> torch.Tensor:
    """The fused epilogue on an int32 accumulator.

    ``out``: ``torch.int32`` returns ``acc`` itself; ``torch.float32`` or
    ``torch.bfloat16`` stores ``y = acc * oscale + bias`` (then the
    activation ``relu``: ReLU for 1 / True, ReLU6 for :data:`RELU6`) in
    that type; ``("int8", s_next)`` requantizes ``y`` with ``s_next``.
    """
    if out == torch.int32:
        return acc
    y = acc.to(torch.float32).double()
    y = y.mul_(oscale.double()).add_(bias.double()).to(torch.float32)
    if relu:
        y = torch.relu(y)
    if relu == RELU6:
        y = torch.clamp(y, max=6.0)
    if isinstance(out, tuple):
        return quantize_to(y, out[1])
    return y.to(out)


def conv_int8(xq: torch.Tensor, w: torch.Tensor, k: int, stride: int,
              rate: int, pad, oscale: torch.Tensor | None,
              bias: torch.Tensor | None, relu: int, out,
              in_scale: float | None = None) -> torch.Tensor:
    """One quantized conv: :func:`conv_acc`, then :func:`epilogue`. With
    ``in_scale``, ``xq`` is a wide (bf16 / f32) input that is first
    quantized with it (:func:`quantize_to`)."""
    if in_scale is not None:
        xq = quantize_to(xq, in_scale)
    return epilogue(conv_acc(xq, w, k, stride, rate, pad), oscale, bias,
                    relu, out)

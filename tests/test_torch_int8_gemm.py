"""The int8 GEMM's plain versions against the JAX package, on the CPU.

The CUDA kernel ``csrc/int8_gemm.cu`` has two functions, and its wrapper
takes the plain version for a CPU tensor, so these tests hold that plain
version to what the JAX package computes:

* ``mm``: ``pallas_mm``'s per-block body is ``jnp.dot(x, y,
  preferred_element_type=acc)``. int8 -> int32 must be exact; bf16 -> f32
  within 1e-6 of the largest |value| (both sum float32 products in other
  orders; the plain version sums in float64 and rounds once).
* ``conv_int8``: the int32 accumulator against ``quant._conv(...,
  preferred=jnp.int32)`` at every kind of ResNet-50 site, exactly, with
  the JAX package's own padding rule (``quant._pad_for``); then the fused
  epilogue against ``conv_fn``'s (quant.py:300-306). XLA's CPU code
  contracts ``acc * oscale + bias`` into one fused multiply-add, as the
  kernel and the plain version do. The bounds are float32 within 1 ulp,
  bf16 within 1 bf16 ulp and int8 within 1 at a rounding tie on at most
  0.1% of the elements; measured, none of the 313,600 outputs of each
  type differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepgraphpose_tpu.models import quant as jax_quant
from deepgraphpose_tpu_torch.models import quant as port_quant
from deepgraphpose_tpu_torch.ops.kernels import int8_gemm_kernel as kernel

# (k, Cin, Cout, stride, rate): the kinds of ResNet-50 conv site
SITES = {
    "stem_7x7_s2": (7, 3, 64, 2, 1),
    "1x1": (1, 64, 32, 1, 1),
    "3x3_s2": (3, 32, 32, 2, 1),
    "3x3_rate2": (3, 32, 32, 1, 2),
    "3x3": (3, 32, 48, 1, 1),
    "1x1_s2_shortcut": (1, 64, 128, 2, 1),
}
# even height: SAME and slim's conv2d_same pad a stride-2 conv differently
IN_HW = (20, 23)


def int8(rng, shape, lo=-127, hi=128):
    return rng.integers(lo, hi, shape, dtype=np.int8)


def bf16_values(rng, shape):
    """float32 numpy values that are exactly bf16, and their torch bf16."""
    t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    t = t.to(torch.bfloat16)
    return t.float().numpy(), t


@pytest.mark.parametrize("shape", [(64, 96, 80), (37, 50, 29),
                                   (256, 512, 128)])
def test_mm_int8_exact(shape):
    m, k, n = shape
    rng = np.random.default_rng(0)
    a, b = int8(rng, (m, k)), int8(rng, (k, n))
    want = np.asarray(jnp.dot(jnp.asarray(a), jnp.asarray(b),
                              preferred_element_type=jnp.int32))
    before = dict(kernel.launches)
    got = kernel.mm(torch.from_numpy(a), torch.from_numpy(b), torch.int32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert kernel.launches == before     # the CPU runs the plain version


@pytest.mark.parametrize("shape", [(64, 96, 80), (37, 50, 29),
                                   (256, 512, 128)])
def test_mm_bf16_f32(shape):
    m, k, n = shape
    rng = np.random.default_rng(1)
    a, ta = bf16_values(rng, (m, k))
    b, tb = bf16_values(rng, (k, n))
    want = np.asarray(jnp.dot(jnp.asarray(a, jnp.bfloat16),
                              jnp.asarray(b, jnp.bfloat16),
                              preferred_element_type=jnp.float32))
    got = kernel.mm(ta, tb)
    assert got.dtype == torch.float32
    assert (np.abs(got.numpy() - want).max()
            <= 1e-6 * np.abs(want).max())


def test_mm_rejects_mixed_and_wrong_accumulator():
    a = torch.zeros(4, 8, dtype=torch.int8)
    with pytest.raises(TypeError):
        kernel.mm(a, a.T.to(torch.bfloat16))
    with pytest.raises(TypeError):
        kernel.mm(a, a.T.contiguous(), torch.float32)
    with pytest.raises(ValueError):
        kernel.mm(a, a)


def jax_acc(x, w_hwio, stride, rate):
    k = w_hwio.shape[0]
    pad = jax_quant._pad_for(k, stride, rate)
    return np.asarray(jax_quant._conv(jnp.asarray(x), jnp.asarray(w_hwio),
                                      stride, rate, pad,
                                      preferred=jnp.int32))


def site_inputs(name, seed=0):
    k, cin, cout, stride, rate = SITES[name]
    rng = np.random.default_rng(seed)
    x = int8(rng, (2, *IN_HW, cin))
    w = int8(rng, (k, k, cin, cout))
    return x, w, (k, stride, rate)


@pytest.mark.parametrize("name", list(SITES))
def test_conv_accumulator_exact(name):
    x, w, (k, stride, rate) = site_inputs(name)
    want = jax_acc(x, w, stride, rate)
    pad = port_quant._pad_for(k, stride, rate)
    got = kernel.conv_int8(torch.from_numpy(x),
                           torch.from_numpy(w.reshape(-1, w.shape[-1])),
                           k, stride, rate, pad, None, None, False,
                           torch.int32)
    assert got.shape == want.shape and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def jax_epilogue(acc, oscale, bias, relu, out):
    """quant.py:300-306, jitted as the model's conv_fn is."""
    def f(acc, oscale, bias):
        y = acc.astype(jnp.float32) * oscale + bias
        if relu:
            y = jax.nn.relu(y)
        if isinstance(out, tuple):
            return jax_quant._quantize_to(y, jnp.float32(out[1]))
        return y.astype(out)
    return np.asarray(jax.jit(f)(acc, oscale, bias).astype(jnp.float32))


@pytest.mark.parametrize("name", list(SITES))
def test_conv_epilogue_matches_jax(name):
    x, w, (k, stride, rate) = site_inputs(name, seed=3)
    acc = jax_acc(x, w, stride, rate)
    cout = w.shape[-1]
    rng = np.random.default_rng(4)
    # scales of the size calibration gives: acc * oscale ~ O(1)
    oscale = (rng.uniform(0.2, 1.0, cout) / np.abs(acc).max()).astype(
        np.float32)
    bias = rng.standard_normal(cout).astype(np.float32) * 0.1
    args = (torch.from_numpy(x), torch.from_numpy(w.reshape(-1, cout)), k,
            stride, rate, port_quant._pad_for(k, stride, rate),
            torch.from_numpy(oscale), torch.from_numpy(bias))
    for relu in (False, True):
        want = jax_epilogue(acc, oscale, bias, relu, jnp.float32)
        got = kernel.conv_int8(*args, relu, torch.float32).numpy()
        ulp = np.spacing(np.abs(want).astype(np.float32))
        assert (np.abs(got - want) <= ulp).all()

        want = jax_epilogue(acc, oscale, bias, relu, jnp.bfloat16)
        got = kernel.conv_int8(*args, relu, torch.bfloat16).float().numpy()
        ulp_bf16 = np.abs(want) * 2.0 ** -7
        assert (np.abs(got - want) <= ulp_bf16).all()

        s_next = float(np.float32(1.0 / 127))
        want = jax_epilogue(acc, oscale, bias, relu, ("int8", s_next))
        got = kernel.conv_int8(*args, relu, ("int8", s_next))
        assert got.dtype == torch.int8
        diff = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1
        assert (diff != 0).mean() <= 1e-3


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_conv_quantizes_wide_input(dtype):
    """A 1x1 stride-1 conv takes its input wide with ``in_scale``: the same
    as ``quant._quantize_to`` and then the int8 conv, exactly."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 9, 11, 48)).astype(
        np.float32) * 3).to(dtype)
    w = int8(rng, (1, 1, 48, 40))
    scale = float(np.float32(x.float().abs().max().item() / 127))
    xq = jax_quant._quantize_to(jnp.asarray(x.float().numpy()),
                                jnp.float32(scale))
    want = jax_acc(np.asarray(xq), w, 1, 1)
    got = kernel.conv_int8(x, torch.from_numpy(w.reshape(48, 40)), 1, 1, 1,
                           0, None, None, False, torch.int32, in_scale=scale)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="1x1 stride-1"):
        kernel.conv_int8(x, torch.zeros(9 * 48, 8, dtype=torch.int8), 3, 1,
                         1, 1, None, None, False, torch.int32, in_scale=scale)


def test_transposed_operand_is_checked():
    """The kernel reads B as (N, K): the wrapper takes a kept copy only
    with the transposed shape, the same type and a contiguous layout, and
    otherwise transposes B itself."""
    w = torch.arange(12, dtype=torch.int8).reshape(3, 4)
    made = kernel._transposed(w, None)
    assert made.is_contiguous() and torch.equal(made, w.t())
    kept = w.t().contiguous()
    assert kernel._transposed(w, kept) is kept
    for bad in (w, kept.float(), w.t()):     # shape, type, layout
        with pytest.raises(ValueError, match="\\(N, K\\) copy"):
            kernel._transposed(w, bad)


# MobileNetV2's int8 sites (k, Cin, Cout, stride): the 3x3/2 stem and 1x1s
# whose K and N sit below the kernel's 128-wide tiles and its K % 16 vector
# path (K = 16, 24, 27, 32; N = 16, 24)
MOBILE_SITES = {
    "stem_3x3_s2": (3, 3, 32, 2),
    "expand_k16": (1, 16, 96, 1),
    "expand_k24": (1, 24, 144, 1),
    "project_n24": (1, 96, 24, 1),
    "project_n16": (1, 32, 16, 1),
    "head": (1, 320, 1280, 1),
}
# even and odd sides: TF SAME pads a stride-2 conv over an even side
# (0, 1), over an odd side (1, 1)
MOBILE_HW = {"even": (20, 24), "odd": (21, 23), "odd_even": (25, 26)}


def same_pads(k, stride, x):
    from deepgraphpose_tpu_torch.models.mobilenet import same_pads as pads
    return tuple(pads(k, stride, 1, n) for n in x.shape[1:3])


def mobile_inputs(name, hw, seed=0):
    k, cin, cout, stride = MOBILE_SITES[name]
    rng = np.random.default_rng(seed)
    x = int8(rng, (2, *MOBILE_HW[hw], cin))
    w = int8(rng, (k, k, cin, cout))
    return x, w, (k, stride)


@pytest.mark.parametrize("hw", list(MOBILE_HW))
@pytest.mark.parametrize("name", list(MOBILE_SITES))
def test_conv_accumulator_same_pads_exact(name, hw):
    """The plain conv with TF SAME's per-side pads against
    ``quant._conv(..., "SAME", preferred=jnp.int32)``: int32, exactly."""
    x, w, (k, stride) = mobile_inputs(name, hw)
    want = np.asarray(jax_quant._conv(jnp.asarray(x), jnp.asarray(w), stride,
                                      1, "SAME", preferred=jnp.int32))
    pad = same_pads(k, stride, x)
    got = kernel.conv_int8(torch.from_numpy(x),
                           torch.from_numpy(w.reshape(-1, w.shape[-1])), k,
                           stride, 1, pad, None, None, False, torch.int32)
    assert got.shape == want.shape and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if hw == "even" and stride == 2:
        assert pad == ((0, 1), (0, 1))


@pytest.mark.parametrize("name", list(MOBILE_SITES))
def test_relu6_epilogue_matches_jax(name):
    """The epilogue's ReLU6 against the JAX package's mobile ``conv_fn``
    (``acc * oscale + bias``, ``jax.nn.relu6``, quant.py:300-301, jitted),
    on even sides and at sizes that put values past 6: float32 within 1
    ulp, bf16 within 1 bf16 ulp, int8 within 1 on at most 0.1%."""
    x, w, (k, stride) = mobile_inputs(name, "even", seed=6)
    acc = np.asarray(jax_quant._conv(jnp.asarray(x), jnp.asarray(w), stride,
                                     1, "SAME", preferred=jnp.int32))
    cout = w.shape[-1]
    rng = np.random.default_rng(7)
    oscale = (rng.uniform(2.0, 12.0, cout) / np.abs(acc).max()).astype(
        np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)

    def want(out):
        def f(acc, oscale, bias):
            y = jax.nn.relu6(acc.astype(jnp.float32) * oscale + bias)
            if isinstance(out, tuple):
                return jax_quant._quantize_to(y, jnp.float32(out[1]))
            return y.astype(out)
        return np.asarray(jax.jit(f)(acc, oscale, bias).astype(jnp.float32))

    args = (torch.from_numpy(x), torch.from_numpy(w.reshape(-1, cout)), k,
            stride, 1, same_pads(k, stride, x), torch.from_numpy(oscale),
            torch.from_numpy(bias), kernel.RELU6)
    w32 = want(jnp.float32)
    assert (w32 == 6.0).any() and (w32 == 0.0).any() and w32.max() == 6.0
    got = kernel.conv_int8(*args, torch.float32).numpy()
    assert (np.abs(got - w32) <= np.spacing(np.abs(w32))).all()
    w16 = want(jnp.bfloat16)
    got = kernel.conv_int8(*args, torch.bfloat16).float().numpy()
    assert (np.abs(got - w16) <= np.abs(w16) * 2.0 ** -7).all()
    s_next = float(np.float32(6.0 / 127))
    w8 = want(("int8", s_next))
    got = kernel.conv_int8(*args, ("int8", s_next)).numpy()
    diff = np.abs(got.astype(np.int32) - w8.astype(np.int32))
    assert diff.max() <= 1 and (diff != 0).mean() <= 1e-3
    with pytest.raises(ValueError, match="relu must be"):
        kernel.conv_int8(*args[:-1], 3, torch.float32)

"""The port's soft-argmax decode against the JAX package.

Grid of tests/test_pallas_softargmax.py: hw (16,16)/(23,31), gauss_len
0/1/2, gamma 1/2.5, plus ``threshold``. The plain port matches the JAX
``softargmax_2d`` to 1e-5 (float32 sums in another order) and its
gradients to 1e-5/1e-6, and the Pallas kernel in interpret mode to 1e-5.
The weight vectors the CUDA kernel is fed reproduce the literal decode
to 1e-4 cells at the main path's 94x104 maps, and the kernel wrapper on a
CPU tensor is the plain version. The likelihood matches the JAX
``infer_forward`` read, with mu on the map edges.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepgraphpose_tpu.ops.pallas.softargmax_kernel import \
    softargmax_2d_pallas
from deepgraphpose_tpu.ops.softargmax import \
    gaussian_smooth_2d as jax_gaussian_smooth_2d
from deepgraphpose_tpu.ops.softargmax import softargmax_2d as jax_softargmax_2d
from deepgraphpose_tpu_torch.ops import softargmax as plain
from deepgraphpose_tpu_torch.ops.kernels import softargmax_kernel as kernel


def softargmax_from_weights(scoremaps, weights, gamma):
    """The CUDA kernel's arithmetic as a plain reduction: (T, H, W, C) -> mu."""
    t, h, w, c = scoremaps.shape
    a, ar, b, bc = torch.split(weights, [h, h, w, w])
    v = scoremaps * gamma
    e = torch.exp(v - torch.amax(v, dim=(1, 2), keepdim=True))
    s0 = torch.einsum("thwc,h,w->tc", e, a, b)
    sr = torch.einsum("thwc,h,w->tc", e, ar, b)
    sc = torch.einsum("thwc,h,w->tc", e, a, bc)
    return torch.stack([sr / s0, sc / s0], dim=-1)


def logits(shape, seed=0, scale=3.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("hw", [(16, 16), (23, 31)])
@pytest.mark.parametrize("gauss_len", [0.0, 1.0, 2.0])
@pytest.mark.parametrize("gamma", [1.0, 2.5])
def test_plain_matches_jax_and_pallas(hw, gauss_len, gamma):
    x = logits((3, *hw, 4))
    mu_j, probs_j = jax_softargmax_2d(jnp.asarray(x), gamma=gamma,
                                      gauss_len=gauss_len)
    mu_t, probs_t = plain.softargmax_2d(torch.from_numpy(x), gamma=gamma,
                                        gauss_len=gauss_len)
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(probs_t.numpy(), np.asarray(probs_j),
                               rtol=1e-5, atol=1e-7)
    mu_p = softargmax_2d_pallas(jnp.asarray(x), gamma, gauss_len, 1.0, True)
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_p),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("threshold", [0.1, 0.5])
def test_plain_threshold_matches_jax(threshold):
    x = logits((2, 23, 31, 3), seed=1)
    mu_j, _ = jax_softargmax_2d(jnp.asarray(x), gamma=1.0, gauss_len=1.0,
                                threshold=threshold)
    mu_t, _ = plain.softargmax_2d(torch.from_numpy(x), gamma=1.0,
                                  gauss_len=1.0, threshold=threshold)
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("gauss_len", [0.0, 1.0, 2.0])
def test_plain_gradient_matches_jax(gauss_len):
    x = logits((2, 10, 14, 3), seed=2, scale=1.0)
    w = np.random.default_rng(3).standard_normal((2, 3, 2)).astype(np.float32)

    def loss_j(s):
        mu, _ = jax_softargmax_2d(s, gamma=1.0, gauss_len=gauss_len)
        return jnp.sum(mu * w)

    g_j = np.asarray(jax.grad(loss_j)(jnp.asarray(x)))
    s = torch.from_numpy(x).requires_grad_(True)
    (plain.softargmax_2d(s, gamma=1.0, gauss_len=gauss_len)[0]
     * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(s.grad.numpy(), g_j, rtol=1e-5, atol=1e-6)
    assert np.linalg.norm(g_j) > 0

    # the kernel's autograd entry point on a CPU tensor is the plain version
    s2 = torch.from_numpy(x).requires_grad_(True)
    (kernel.softargmax_2d_cuda(s2, 1.0, gauss_len)
     * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(s2.grad.numpy(), s.grad.numpy(), rtol=0,
                               atol=0)


@pytest.mark.parametrize("gauss_len", [0.0, 2.0])
def test_gaussian_smooth_matches_jax(gauss_len):
    x = logits((2, 9, 11, 3), seed=4)
    want = jax_gaussian_smooth_2d(jnp.asarray(x), gauss_len)
    got = plain.gaussian_smooth_2d(torch.from_numpy(x), gauss_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("gauss_len", [0.0, 1.0, 2.0])
@pytest.mark.parametrize("gamma", [1.0, 2.5])
def test_kernel_weight_vectors_match_literal_decode(gauss_len, gamma):
    """The CUDA kernel's arithmetic (host-built A/Ar/B/Bc vectors, one
    weighted reduction) reproduces the literal smooth-then-expect decode at
    the main path's 94x104 maps, edges included."""
    x = torch.from_numpy(logits((4, 94, 104, 5), seed=5))
    wts = torch.from_numpy(plain.smoothing_weights(94, 104, gauss_len))
    assert wts.shape == (2 * 94 + 2 * 104,)
    got = softargmax_from_weights(x, wts, gamma)
    want, _ = plain.softargmax_2d(x, gamma=gamma, gauss_len=gauss_len)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-4)

    # a peak in a corner: the zero-padded smoothing pulls mu inward exactly
    # as the weight vectors say
    corner = torch.full((1, 94, 104, 1), -20.0)
    corner[0, 0, 103, 0] = 20.0
    got = softargmax_from_weights(corner, wts, gamma)
    want, _ = plain.softargmax_2d(corner, gamma=gamma, gauss_len=gauss_len)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-4)


def jax_likelihood(pred, mu):
    """The 2x2 read of deepgraphpose_tpu infer/predict.py:51-64, given mu."""
    b, h, w, nj = pred.shape
    r0 = jnp.clip(jnp.floor(mu[..., 0]).astype(jnp.int32), 0, h - 1)
    c0 = jnp.clip(jnp.floor(mu[..., 1]).astype(jnp.int32), 0, w - 1)
    bi = jax.lax.broadcasted_iota(jnp.int32, (b, nj), 0)
    ji = jax.lax.broadcasted_iota(jnp.int32, (b, nj), 1)

    def at(dr, dc):
        return pred[bi, jnp.clip(r0 + dr, 0, h - 1),
                    jnp.clip(c0 + dc, 0, w - 1), ji]

    best = jnp.maximum(jnp.maximum(at(0, 0), at(0, 1)),
                       jnp.maximum(at(1, 0), at(1, 1)))
    return jax.nn.sigmoid(best)


def test_likelihood_matches_jax_at_edges():
    h, w = 12, 17
    pred = logits((2, h, w, 4), seed=6)
    # joints at the four map edges: peaks pull mu onto the last row/col
    for j, (r, c) in enumerate([(0, 0), (h - 1, w - 1), (0, w - 1),
                                (h - 1, 5)]):
        pred[:, r, c, j] = 40.0
    mu_t, lik_t = kernel.softargmax_likelihood(torch.from_numpy(pred), 1.0,
                                               1.0)
    mu_j, _ = jax_softargmax_2d(jnp.asarray(pred), gamma=1.0, gauss_len=1.0)
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), rtol=1e-5,
                               atol=1e-5)
    assert (mu_t[..., 0] > h - 2).any() and (mu_t[..., 1] > w - 2).any()
    want = jax_likelihood(jnp.asarray(pred), jnp.asarray(mu_t.numpy()))
    np.testing.assert_allclose(lik_t.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    # mu exactly past the last cell clips to the map
    mu_edge = torch.tensor([[[h + 0.5, w + 3.0]] * 4] * 2)
    got = plain.max_sigmoid_2x2(torch.from_numpy(pred), mu_edge)
    want = jax_likelihood(jnp.asarray(pred), jnp.asarray(mu_edge.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_wrapper_checks_inputs():
    with pytest.raises(TypeError):
        kernel.softargmax_likelihood(torch.zeros(1, 4, 4, 2,
                                                 dtype=torch.float64), 1, 1)
    with pytest.raises(ValueError):
        kernel.softargmax_likelihood(torch.zeros(4, 4, 2), 1, 1)
    with pytest.raises(ValueError):
        kernel.softargmax_likelihood(
            torch.zeros(1, 2, 4, 4).permute(0, 2, 3, 1), 1, 1)
    before = kernel.launches
    kernel.softargmax_likelihood(torch.zeros(1, 4, 4, 2), 1.0, 1.0)
    assert kernel.launches == before  # the CPU path launches nothing


@pytest.mark.parametrize("h, w, joints", [(94, 104, 5), (52, 56, 5),
                                          (23, 31, 4), (4, 4, 3),
                                          (64, 64, 40), (8, 8, 2000)])
def test_launch_shape(h, w, joints):
    per_block, threads = kernel.launch_shape(h, w, joints)
    assert per_block == min(joints, 1024) and threads % per_block == 0
    assert per_block <= threads <= 1024
    rows = threads // per_block
    # two steps of 16 pixels for each thread, unless the block is full
    assert rows == 1024 // per_block or rows == -(-(h * w) // 32)

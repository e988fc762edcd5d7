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


# (batch, h, w, joints): the main path's full-frame and crop maps, output
# stride 8's full frame, a single frame, small odd maps, more joints than a
# CTA's threads, many joints on large maps, and the DGP training steps'
# maps (step 2's 11 frames, step 1's 2)
LAUNCH_CASES = [(128, 94, 104, 5), (128, 52, 56, 5), (128, 186, 208, 5),
                (1, 94, 104, 5), (3, 23, 31, 4), (2, 4, 4, 3),
                (4, 64, 64, 40), (2, 8, 8, 2000), (128, 94, 104, 300),
                (128, 186, 208, 40), (11, 94, 104, 5), (2, 94, 104, 5)]


def consumer_terms(h, w, lay, rows):
    """Logits of one joint that one consumer sums in a frame."""
    return -(-h * w // (lay.cluster * rows))


@pytest.mark.parametrize("batch, h, w, joints", LAUNCH_CASES)
def test_launch_shape(batch, h, w, joints):
    lay = kernel.launch_shape(batch, h, w, joints)
    per = kernel.joint_group(joints, h * w)
    assert per <= kernel.MAX_THREADS
    if joints <= kernel.MAX_THREADS and h * w <= 8 * kernel.MAX_TERMS:
        assert per == joints
    assert lay.cluster in (1, 2, 4, 8) and 1 <= lay.stages <= 8
    assert lay.steps in (4, 8, 16)
    assert per <= lay.threads <= kernel.MAX_THREADS
    assert lay.threads % per == 0
    assert kernel.smem_bytes(h, w, joints, lay) <= 227 * 1024
    rows = lay.threads // per
    # the cap on a consumer's float32 sum (PERF.md)
    assert consumer_terms(h, w, lay, rows) <= kernel.MAX_TERMS
    # clusters only while the frames leave half the SMs idle or where the
    # cap needs them, and each CTA of a cluster keeps a chunk of pixels
    groups = -(-joints // per)
    sms = kernel.H100_SMS
    half = lay._replace(cluster=lay.cluster // 2)
    assert lay.cluster == 1 or (
        2 * batch * groups * half.cluster < sms
        or consumer_terms(h, w, half, rows) > kernel.MAX_TERMS)
    assert lay.cluster == 8 or 2 * batch * groups * lay.cluster >= sms or (
        h * w < 2 * lay.cluster * 16 * rows)
    assert lay.cluster == 1 or h * w >= lay.cluster * 16 * rows
    assert lay.steps == 4 or 2 * lay.cluster * lay.steps * rows <= h * w
    if (batch, h, w, joints) == (128, 94, 104, 5):  # the measured fastest
        assert lay == kernel.Layout(1, 520, 2, 16)
    if batch in (1, 11) and (h, w, joints) == (94, 104, 5):
        assert lay == kernel.Layout(4, 520, 2, 8)
    if (batch, h, w, joints) == (128, 94, 104, 300):    # six joint groups
        assert per == 50 and lay == kernel.Layout(8, 500, 1, 16)
    if (batch, h, w, joints) == (128, 186, 208, 40):    # four
        assert per == 10 and lay == kernel.Layout(8, 510, 1, 16)
    if joints * w <= kernel.MAX_THREADS:        # one column a consumer
        assert rows % w == 0


@pytest.mark.parametrize("h, w", [(94, 104), (23, 31), (3, 2)])
def test_kernel_weights_are_interleaved_and_padded(h, w):
    """The kernel's copy of the weight vectors: (A, Ar) pairs, then (B, Bc)
    pairs, zero-padded to whole 16-byte units for its bulk copy."""
    a, ar, b, bc = np.split(plain.smoothing_weights(h, w, 2.0),
                            np.cumsum([h, h, w]))
    got = kernel.kernel_weights(h, w, 2.0)
    assert got.dtype == np.float32 and got.size % 4 == 0
    assert got.size - 2 * (h + w) < 4 and not got[2 * (h + w):].any()
    np.testing.assert_array_equal(got[0:2 * h:2], a)
    np.testing.assert_array_equal(got[1:2 * h:2], ar)
    np.testing.assert_array_equal(got[2 * h:2 * (h + w):2], b)
    np.testing.assert_array_equal(got[2 * h + 1:2 * (h + w):2], bc)


def simulate_kernel(x, weights, gamma, layout, offset=0):
    """The CUDA kernel's schedule in numpy: clusters of ranks over pixel
    ranges, chunks of ``steps`` thread rows, the 16-byte aligned body of a
    chunk from its slot and the head and tail from x, a max a chunk, the
    column sums, then the merges. ``offset`` is the floats by which x's
    start lies past a 16-byte boundary. Returns (mu, how often each logit
    was read)."""
    bsz, h, w, c = x.shape
    flat = x.reshape(-1)
    reads = np.zeros(flat.size, np.int64)
    per = kernel.joint_group(c, h * w)
    threads, k, steps = layout.threads, layout.cluster, layout.steps
    rows = threads // per
    column = rows % w == 0
    slot = (steps * rows * c + 7) & ~3
    a_w, ar_w, b_w, bc_w = np.split(weights.astype(np.float32),
                                    np.cumsum([h, h, w]))
    scale = np.float32(gamma * 1.4426950408889634)
    t = np.arange(threads)
    cl, row = t % per, t // per
    mu = np.zeros((bsz, c, 2))
    hw, chunk_px = h * w, steps * rows

    def merge(a, b):
        m = np.maximum(a[0], b[0])
        fa = np.where(a[0] == -np.inf, 0, np.exp2(a[0] - m))
        fb = np.where(b[0] == -np.inf, 0, np.exp2(b[0] - m))
        return (m, *(a[i] * fa + b[i] * fb for i in (1, 2, 3)))

    for b in range(bsz):
        base = b * hw * c
        for c0 in range(0, c, per):
            jg = min(per, c - c0)
            active = cl < jg
            total = None
            for rank in range(k):
                p_lo, p_hi = rank * hw // k, (rank + 1) * hw // k
                q = p_lo + row
                i, j = q // w, q % w
                m = np.full(threads, -np.inf, np.float32)
                s0, sr, sc = (np.zeros(threads, np.float32) for _ in range(3))
                for q0 in range(p_lo, p_hi, chunk_px):
                    q1 = min(q0 + chunk_px, p_hi)
                    ga, n = base + q0 * c, (q1 - q0) * c
                    head = min((4 - (offset + ga) % 4) % 4, n)
                    body = (n - head) & ~3
                    lead = (4 - head) % 4
                    assert (lead + head) % 4 == 0 or body == 0
                    assert lead + head + body <= slot
                    v = np.full((steps, threads), -np.inf, np.float32)
                    for u in range(steps):
                        ok = active & (q + u * rows < q1)
                        loc = (q - q0) * c + c0 + cl + u * rows * c
                        assert (loc[ok] < n).all()
                        reads[ga + loc[ok]] += 1
                        v[u, ok] = flat[ga + loc[ok]]
                    mc = (v * scale).max(0)
                    up = mc > m
                    f = np.exp2(m[up] - mc[up])
                    s0[up] *= f
                    sr[up] *= f
                    sc[up] *= f
                    m[up] = mc[up]
                    t0, tr, tc = (np.zeros(threads, np.float32)
                                  for _ in range(3))   # the chunk's sums
                    for u in range(steps):
                        ok = active & (q + u * rows < q1)
                        # fmaf(x, scale, -m): one rounding (the float64
                        # product of two float32 values is exact)
                        e = np.exp2((v[u, ok].astype(np.float64) * scale
                                     - m[ok]).astype(np.float32))
                        ii, jj = i[ok], j[ok]
                        if column:
                            t0[ok] += e * a_w[ii]
                            tr[ok] += e * ar_w[ii]
                        else:
                            t0[ok] += e * a_w[ii] * b_w[jj]
                            tc[ok] += e * a_w[ii] * bc_w[jj]
                            tr[ok] += e * ar_w[ii] * b_w[jj]
                        i, j = i + rows // w, j + rows % w
                        if not column:
                            i, j = i + (j >= w), np.where(j >= w, j - w, j)
                    s0, sr, sc = s0 + t0, sr + tr, sc + tc
                    q = q + chunk_px
                if column:
                    jj = (p_lo + row) % w
                    s0, sr, sc = b_w[jj] * s0, b_w[jj] * sr, bc_w[jj] * s0
                acc = None
                for r in range(rows):      # the CTA's merge of each joint
                    sel = slice(r * per, r * per + jg)
                    part = (m[sel], s0[sel], sr[sel], sc[sel])
                    acc = part if acc is None else merge(acc, part)
                total = acc if total is None else merge(total, acc)
            mu[b, c0:c0 + jg, 0] = total[2] / total[1]
            mu[b, c0:c0 + jg, 1] = total[3] / total[1]
    return mu, reads


SIM_CASES = [
    # the crop's maps (fewer frames), its own layout and a general one
    ((2, 52, 56, 5), None, 0),
    ((2, 52, 56, 5), kernel.Layout(2, 510, 2, 4), 0),
    ((2, 52, 56, 5), kernel.Layout(1, 280, 3, 16), 2),
    # an odd frame (H*W*C odd) at a storage offset: heads and tails
    ((3, 23, 31, 7), kernel.Layout(4, 217, 2, 8), 1),
    ((3, 23, 31, 7), kernel.Layout(8, 511, 1, 4), 3),
    ((2, 9, 13, 1), None, 2),
    ((2, 11, 12, 33), kernel.Layout(2, 396, 3, 4), 0),
    # joints split over two groups
    ((1, 3, 5, 1100), None, 1),
    # many joints on the full-frame maps: six groups of 50 and a cluster
    # of 8, so no consumer sums more than MAX_TERMS logits
    ((1, 94, 104, 300), None, 1),
]


@pytest.mark.parametrize("shape, layout, offset", SIM_CASES)
def test_kernel_schedule_reads_every_logit_once(shape, layout, offset):
    """The kernel's index arithmetic, run in numpy: every logit is read
    exactly once, slots hold their chunks, and the decode matches the
    plain version within 1e-4 cells."""
    x = logits(shape, seed=7)
    b, h, w, c = shape
    lay = layout or kernel.launch_shape(b, h, w, c)
    assert kernel.smem_bytes(h, w, c, lay) <= 227 * 1024
    wts = plain.smoothing_weights(h, w, 2.0)
    mu, reads = simulate_kernel(x, wts, 2.5, lay, offset)
    assert (reads == 1).all()
    want, _ = plain.softargmax_2d(torch.from_numpy(x), gamma=2.5,
                                  gauss_len=2.0)
    np.testing.assert_allclose(mu, want.numpy(), rtol=0, atol=1e-4)

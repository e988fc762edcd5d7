"""The port's device flow (``ops/flow_device.py``) against the JAX
package's, on the CPU.

JAX's float32 flow is itself sensitive: the box sums are differences of
cumulative sums, which cancel, and the determinant floor sits near the
data. So the port's float32 flow is held against JAX's algorithm run in
float64 (``jax.enable_x64`` with the module's float32 casts read as
float64), within twice JAX's own float32 distance from it; ``-s`` prints
both distances. The helpers are held against JAX's one by one, the
temporal clique's loss from either package's flow within 1e-4 relative,
and the JAX package's three behavioural cases (a static scene, a
translation recovered, agreement with Farneback) run on the port.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepgraphpose_tpu.ops.flow_device as jax_flow
from deepgraphpose_tpu.ops.cliques import \
    temporal_clique_loss as jax_temporal_clique
from deepgraphpose_tpu_torch.data.flow import flow_magnitude_sequence
from deepgraphpose_tpu_torch.ops import flow_device as flow
from deepgraphpose_tpu_torch.ops.cliques import temporal_clique_loss

cv2 = pytest.importorskip("cv2")

CLIQUE_RTOL = 1e-4
HELPER_RTOL = 1e-5     # one helper, float32, of the output's largest value


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two torch threads while this file runs (the suite runs six files at
    once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class _Jnp64:
    """``jax.numpy`` with ``float32`` read as ``float64``."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


@contextlib.contextmanager
def jax_in_float64():
    """The JAX package's flow module computing in float64."""
    with jax.enable_x64(True):
        jax_flow.jnp = _Jnp64()
        try:
            yield
        finally:
            jax_flow.jnp = jnp


def moving_texture(t=3, h=96, w=112, shift=(4.0, 2.0), seed=0):
    """A smooth random texture translating by ``shift`` (dx, dy) a frame
    (the JAX package's ``tests/test_flow_device.py::_moving_blobs``)."""
    rng = np.random.default_rng(seed)
    big = rng.uniform(0, 255, (h // 8 + 6, w // 8 + 6))
    tex = cv2.resize(big, ((w // 8 + 6) * 8, (h // 8 + 6) * 8),
                     interpolation=cv2.INTER_CUBIC)
    frames = np.zeros((t, h, w, 3), np.uint8)
    for i in range(t):
        ox = int(round(8 + i * shift[0]))
        oy = int(round(8 + i * shift[1]))
        crop = tex[oy:oy + h, ox:ox + w]
        frames[i] = np.clip(crop, 0, 255).astype(np.uint8)[..., None]
    return frames


def port_flow(frames: np.ndarray) -> np.ndarray:
    return flow.flow_magnitude_device(torch.from_numpy(frames)).numpy()


def jax_flow_of(frames: np.ndarray) -> np.ndarray:
    """The JAX package's flow, jitted as its pooled step runs it (a fresh
    trace each call, so a float64 run is not served the float32 one)."""
    return np.asarray(jax.jit(lambda f: jax_flow.flow_magnitude_device(f))(
        jnp.asarray(frames)))


@pytest.mark.parametrize("shape,shift", [
    ((3, 96, 112), (3.0, 1.5)),
    ((3, 187, 209), (3.0, 1.5)),    # pyramid steps 23 -> 46 -> 93 -> 187
    ((3, 187, 209), (5.0, -2.5)),
])
def test_flow_matches_jax_in_float64(shape, shift):
    frames = moving_texture(*shape, shift=shift, seed=sum(shape))
    got = port_flow(frames)
    j32 = jax_flow_of(frames)
    with jax_in_float64():
        j64 = jax_flow_of(frames)
    assert j64.dtype == np.float64 and got.dtype == np.float32
    assert got.shape == j64.shape == (shape[0] - 1, *shape[1:])
    port_err = np.abs(got - j64).max()
    jax_err = np.abs(j32 - j64).max()
    print(f"{shape} shift {shift}: port float32 {port_err:.3g}, "
          f"JAX float32 {jax_err:.3g} from JAX float64 "
          f"(flow mean {j64.mean():.3g})")
    assert port_err <= 2.0 * jax_err


def test_float64_frames_run_in_float64():
    frames = moving_texture(shift=(3.0, 1.5))
    got = flow.flow_magnitude_device(torch.from_numpy(frames).double())
    with jax_in_float64():
        want = jax_flow_of(frames)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-9)


@pytest.mark.parametrize("hw,out", [
    ((93, 104), (186, 208)),        # 747x832's pyramid, level 2 -> 1
    ((186, 208), (373, 416)),       # level 1 -> 0: 186 -> 373 is not 2x
    ((373, 416), (747, 832)),       # the last upsample
])
def test_resize_matches_jax_image_resize(hw, out):
    """Against ``jax.image.resize`` in float64, within twice JAX's own
    float32 distance from it or 4 float32 ulps of the largest value (JAX's
    float32 resize is 6e-5 off at the last upsample; the port's two
    weight-matrix products are 4e-7 off)."""
    x = np.random.default_rng(1).standard_normal((2, *hw)).astype(np.float32)
    got = flow._resize(torch.from_numpy(x), out).numpy()
    j32 = np.asarray(jax.image.resize(jnp.asarray(x), (2, *out),
                                      "bilinear"))
    with jax.enable_x64(True):
        j64 = np.asarray(jax.image.resize(jnp.asarray(x, jnp.float64),
                                          (2, *out), "bilinear"))
    ulps = 4 * np.finfo(np.float32).eps * np.abs(j64).max()
    port_err, jax_err = np.abs(got - j64).max(), np.abs(j32 - j64).max()
    print(f"resize {hw} -> {out}: port float32 {port_err:.3g}, JAX "
          f"float32 {jax_err:.3g} from JAX float64")
    assert port_err <= max(2.0 * jax_err, ulps)


def _helper_cases():
    rng = np.random.default_rng(2)
    g = rng.uniform(0, 255, (2, 37, 45)).astype(np.float32)
    g1 = rng.uniform(0, 255, (2, 37, 45)).astype(np.float32)
    u = rng.uniform(-3, 3, (2, 37, 45)).astype(np.float32)
    v = rng.uniform(-3, 3, (2, 37, 45)).astype(np.float32)
    return {
        "box": ((g, 7), {}),
        "down2": ((g,), {}),
        "warp": ((g, u, v), {}),
        "grad_central_x": ((g, -1), {}),
        "grad_central_y": ((g, -2), {}),
        "lk_refine": ((g, g1, u, v, 7, 1e-3), {}),
    }


@pytest.mark.parametrize("name", list(_helper_cases()))
def test_helpers_match_jax(name):
    args, _ = _helper_cases()[name]
    fn = name.rsplit("_", 1)[0] if name.startswith("grad") else name
    port = getattr(flow, f"_{fn}")(*[torch.from_numpy(a) if isinstance(
        a, np.ndarray) else a for a in args])
    ref = getattr(jax_flow, f"_{fn}")(*[jnp.asarray(a) if isinstance(
        a, np.ndarray) else a for a in args])
    port = port if isinstance(port, tuple) else (port,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for p, r in zip(port, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(p.numpy(), r, rtol=0,
                                   atol=HELPER_RTOL * np.abs(r).max())


def test_temporal_clique_from_either_flow():
    """The wt term of the DGP objective from the port's flow and from
    JAX's, each through its own package's clique, on the same joints."""
    frames = moving_texture(t=4, h=96, w=112, shift=(3.0, 1.5), seed=3)
    rng = np.random.default_rng(4)
    coords = rng.uniform(10, 80, (4, 3, 2)).astype(np.float32)
    wt_batch = np.ones(3, np.float32)
    pair_mask = np.array([1, 1, 0], np.float32)
    got = temporal_clique_loss(
        torch.from_numpy(coords), torch.from_numpy(port_flow(frames)),
        torch.from_numpy(wt_batch), 0.0, torch.from_numpy(pair_mask),
        (12, 14)).item()
    want = float(jax_temporal_clique(
        jnp.asarray(coords),
        jnp.asarray(jax_flow_of(frames)),
        jnp.asarray(wt_batch), 0.0, jnp.asarray(pair_mask), (12, 14)))
    assert want > 0
    assert got == pytest.approx(want, rel=CLIQUE_RTOL)


def test_fewer_than_two_frames_give_no_flow():
    out = flow.flow_magnitude_device(torch.zeros(1, 16, 20, 3,
                                                 dtype=torch.uint8))
    assert out.shape == (0, 16, 20) and out.dtype == torch.float32


def test_static_scene_is_near_zero():
    mag = port_flow(moving_texture(shift=(0.0, 0.0)))
    assert mag.shape == (2, 96, 112)
    assert mag.mean() < 0.3


def test_translation_magnitude_recovered():
    """Content moving by (dx, dy) -> flow magnitude ~ |dx| + |dy| in the
    interior (boundaries excluded)."""
    dx, dy = 4.0, 2.0
    mag = port_flow(moving_texture(shift=(dx, dy)))
    interior = mag[:, 24:-24, 24:-24]
    want = dx + dy
    assert want * 0.6 < interior.mean() < want * 1.4, interior.mean()


def test_correlates_with_host_farneback():
    """Spatial agreement with the host (reference-semantics) Farneback
    magnitude on nonuniform motion."""
    h, w = 96, 112
    rng = np.random.default_rng(1)
    base = rng.uniform(0, 255, (h // 8 + 4, w // 8 + 4))
    tex = cv2.resize(base, (w + 32, h + 32), interpolation=cv2.INTER_CUBIC)
    frames = np.zeros((2, h, w, 3), np.uint8)
    frames[0] = np.clip(tex[8:8 + h, 8:8 + w], 0, 255)[..., None]
    # right half moves by (5, 0), left half static
    moved = tex.copy()
    moved[:, (w + 32) // 2:] = np.roll(tex, 5, axis=1)[:, (w + 32) // 2:]
    frames[1] = np.clip(moved[8:8 + h, 8:8 + w], 0, 255)[..., None]

    dev = port_flow(frames)[0]
    host = flow_magnitude_sequence(frames)[0]
    a = dev[16:-16, 16:-16].ravel()
    b = host[16:-16, 16:-16].ravel()
    r = np.corrcoef(a, b)[0, 1]
    assert r > 0.5, r
    # the moving half reads clearly higher than the static half
    assert dev[16:-16, 64:-16].mean() > 3 * max(dev[16:-16, 16:48].mean(),
                                                0.05)

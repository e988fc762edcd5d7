"""The port's on-device augmentation against the JAX package's.

jax.random and torch draw different streams, so the parity cases draw
every random value with jax.random exactly as
``deepgraphpose_tpu/ops/augment_device.py`` splits its keys, hand them to
the port's ``apply_augment``, and hold the result against the JAX
``augment_batch`` on the same key, through its one-shot gather
(``fast_warp=False``): images within 1e-3 on the 0-255 scale, keypoints
within 1e-4 px, ``present`` equal. The reference's own semantics tests
(tests/test_augment_device.py) run on the port's ``augment_batch`` with a
seeded ``torch.Generator``. The pooled DGP step's window augmentation
(``augment_dgp_window``: the frame gate from the visibility mask and the
scoremap-target rewrite around the augmentation) is held against the JAX
package's on the same draws.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepgraphpose_tpu.ops import augment_device as jax_aug
from deepgraphpose_tpu.train import device_data as jax_dd
from deepgraphpose_tpu_torch.data.batcher import DGPBatch
from deepgraphpose_tpu_torch.ops import augment_device as aug
from deepgraphpose_tpu_torch.train import device_data as dd

IMAGE_ATOL = 1e-3
KEYPOINT_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two torch threads while this file runs: the suite runs six files at
    once, and each torch process would otherwise start a thread a core."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_draws(key, cfg, b, hw) -> dict:
    """The draws of the JAX ``augment_batch`` under ``key``, by the port's
    names (its key splits and calls, one for one)."""
    h, w = hw
    u = jax.random.uniform
    k_aff, k_el, k_mb, k_do, k_no = jax.random.split(key, 5)
    ks = jax.random.split(k_aff, 7)
    lo, up = cfg.scale_jitter
    d = {"scale": u(ks[0], (b,), minval=lo, maxval=up),
         "crop_u": u(ks[1], (b, 2)),
         "rot_ang": u(ks[3], (b,), minval=-cfg.rotate_deg,
                      maxval=cfg.rotate_deg),
         "rot_u": u(ks[4], (b,)),
         "cp_pct": u(ks[5], (b,), minval=cfg.crop_pad_percent[0],
                     maxval=cfg.crop_pad_percent[1]),
         "cp_u": u(ks[6], (b,))}
    if cfg.flip:
        d["flip_u"] = u(ks[2], (b,))
    if cfg.elastic_alpha > 0:
        gh = max(2, -(-h // cfg.elastic_cell) + 1)
        gw = max(2, -(-w // cfg.elastic_cell) + 1)
        k1, k2, k3 = jax.random.split(k_el, 3)
        d["el_coarse"] = u(k1, (b, gh, gw, 2), minval=-1.0, maxval=1.0)
        d["el_alpha"] = u(k2, (b,), minval=0.0, maxval=cfg.elastic_alpha)
        d["el_u"] = u(k3, (b,))
    if cfg.motion_blur:
        k1, k2 = jax.random.split(k_mb)
        d["mb_ang"] = u(k1, (b,), minval=-90.0, maxval=90.0)
        d["mb_u"] = u(k2, (b,))
    if cfg.dropout_frac[1] > 0:
        k1, k2, k3 = jax.random.split(k_do, 3)
        d["do_frac"] = u(k1, (b, 1, 1), minval=cfg.dropout_frac[0],
                         maxval=cfg.dropout_frac[1])
        d["do_u"] = u(k2, (b,))
        d["do_keep_u"] = u(k3, (b, -(-h // cfg.dropout_cell),
                                -(-w // cfg.dropout_cell)))
    if cfg.noise_scale > 0:
        k1, k2, k3 = jax.random.split(k_no, 3)
        d["no_scale"] = u(k1, (b,), minval=0.0, maxval=cfg.noise_scale)
        d["no_u"] = u(k2, (b,))
        d["no_n"] = jax.random.normal(k3, (b, h, w, 1))
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def rand_batch(b=3, h=32, w=40, nj=4, seed=0):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 255, (b, h, w, 3), dtype=np.uint8)
    coords = rng.uniform(2, [[w - 3, h - 3]], (b, nj, 2)).astype(np.float32)
    present = np.ones((b, nj), np.float32)
    return imgs, coords, present


def port_cfg(jcfg):
    return aug.DeviceAugmentConfig(**dataclasses.asdict(jcfg))


CONFIGS = {
    "reference": jax_aug.DeviceAugmentConfig.reference(
        scale_jitter=(0.75, 1.25)),
    "reference_all_on": dataclasses.replace(
        jax_aug.DeviceAugmentConfig.reference(scale_jitter=(0.6, 1.4)),
        apply_prob=1.0, crop_pad_prob=1.0, dropout_frac=(0.05, 0.3)),
    "jitter_only": jax_aug.DeviceAugmentConfig.jitter_only(0.75, 1.25),
    "jitter_only_up": jax_aug.DeviceAugmentConfig.jitter_only(1.2, 1.6),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("gated,content", [(False, False), (True, False),
                                           (False, True), (True, True)])
def test_apply_augment_matches_jax(name, gated, content):
    """Both packages on one batch and one set of draws: the reference
    config (and with every op on), jitter-only, with gate 0 on some frames
    and with content sizes below the canvas."""
    b, h, w = 4, 36, 44
    imgs, coords, present = rand_batch(b, h, w, seed=3)
    coords[1, 0] = (w + 5.0, 3.0)               # starts off the canvas
    jcfg = dataclasses.replace(CONFIGS[name], fast_warp=False)
    gate = np.array([1, 0, 1, 1], np.float32) if gated else None
    wh = (np.array([[w, h], [30, 20], [44, 10], [12, 36]], np.float32)
          if content else None)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = jax_aug.augment_batch(
            key, jnp.asarray(imgs), jnp.asarray(coords),
            jnp.asarray(present), jcfg,
            gate=None if gate is None else jnp.asarray(gate),
            content_wh=None if wh is None else jnp.asarray(wh))
        got = aug.apply_augment(
            torch.from_numpy(imgs), torch.from_numpy(coords),
            torch.from_numpy(present), port_cfg(jcfg),
            jax_draws(key, jcfg, b, (h, w)),
            gate=None if gate is None else torch.from_numpy(gate),
            content_wh=None if wh is None else torch.from_numpy(wh))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=0, atol=IMAGE_ATOL)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=0, atol=KEYPOINT_ATOL)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        if gate is not None:                    # gate 0 passes through
            np.testing.assert_allclose(got[0][1].numpy(),
                                       imgs[1].astype(np.float32),
                                       atol=IMAGE_ATOL)


def dgp_window(b, h, w, nj, stride, seed):
    """A DGPBatch of ``b`` frames whose frames 1 and 3 have no visible
    joint (hidden frames: gate 0), with targets on the scoremap grid."""
    rng = np.random.default_rng(seed)
    vis = (rng.uniform(size=(b, nj)) < 0.7).astype(np.float32)
    vis[1] = vis[3] = 0.0
    vis[0, 0] = 1.0
    rc = rng.uniform(0, [[h / stride - 1, w / stride - 1]],
                     (b, nj, 2)).astype(np.float32)
    return DGPBatch(
        images=rng.integers(0, 255, (b, h, w, 3), dtype=np.uint8),
        targets=rc, visible_mask=vis.reshape(-1),
        hidden_mask=(1.0 - vis).reshape(-1), frame_mask=np.ones(b, np.float32),
        wt_batch=np.zeros(b - 1, np.float32),
        pair_mask=np.ones(b - 1, np.float32),
        flow=np.zeros((b - 1, h, w), np.float32),
        frames=np.arange(b, dtype=np.int64))


@pytest.mark.parametrize("name", ["reference", "reference_all_on"])
def test_augment_dgp_window_matches_jax(name, monkeypatch):
    """The pooled DGP step's augmentation of a window, both packages on one
    set of draws: images within 1e-3 (0-255), targets within 1e-4 scoremap
    cells, the hidden frames untouched and every other key passed on."""
    b, h, w, nj, stride = 5, 40, 48, 3, 8.0
    win = dgp_window(b, h, w, nj, stride, seed=4)
    jcfg = dataclasses.replace(CONFIGS[name], fast_warp=False)
    key = jax.random.PRNGKey(7)
    monkeypatch.setattr(
        dd, "augment_batch",
        lambda gen, images, xy, present, cfg, gate: aug.apply_augment(
            images, xy, present, cfg, jax_draws(key, jcfg, b, (h, w)),
            gate=gate))
    jimg, jbatch = jax_dd.augment_dgp_window(
        key, jnp.asarray(win.images),
        {k: jnp.asarray(v) for k, v in win.as_np().items()}, jcfg, stride,
        nj)
    batch = win.as_torch(device="cpu")
    timg, tbatch = dd.augment_dgp_window(
        None, torch.from_numpy(win.images), batch, port_cfg(jcfg), stride,
        nj)
    np.testing.assert_allclose(timg.numpy(), np.asarray(jimg), rtol=0,
                               atol=IMAGE_ATOL)
    np.testing.assert_allclose(tbatch["targets"].numpy(),
                               np.asarray(jbatch["targets"]), rtol=0,
                               atol=KEYPOINT_ATOL)
    for i in (1, 3):                            # gate 0: untouched
        np.testing.assert_array_equal(timg[i].numpy(),
                                      win.images[i].astype(np.float32))
        np.testing.assert_array_equal(tbatch["targets"][i].numpy(),
                                      win.targets[i])
    assert not np.allclose(tbatch["targets"][0].numpy(), win.targets[0])
    assert set(tbatch) == set(jbatch)
    for k in set(batch) - {"targets"}:
        assert tbatch[k] is batch[k], k


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_draws_have_the_jax_shapes_and_ranges(name):
    jcfg = CONFIGS[name]
    want = jax_draws(jax.random.PRNGKey(0), jcfg, 5, (30, 50))
    got = aug.draw_augment(torch.Generator().manual_seed(0),
                           port_cfg(jcfg), 5, (30, 50))
    assert set(got) == set(want)
    lo, up = jcfg.scale_jitter
    for key, value in got.items():
        assert value.shape == want[key].shape, key
        assert value.dtype == want[key].dtype == torch.float32, key
    assert bool(((got["scale"] >= lo) & (got["scale"] <= up)).all())


# ---- the reference's semantics tests, on the port -----------------------

def run(cfg, imgs, coords, present, seed=0, **kw):
    return aug.augment_batch(torch.Generator().manual_seed(seed),
                             torch.from_numpy(np.asarray(imgs)),
                             torch.from_numpy(np.asarray(coords)),
                             torch.from_numpy(np.asarray(present)), cfg, **kw)


def test_identity_config_passthrough():
    imgs, coords, present = rand_batch()
    out, kp, pres = run(aug.DeviceAugmentConfig.jitter_only(1.0, 1.0),
                        imgs, coords, present)
    np.testing.assert_allclose(out.numpy(), imgs.astype(np.float32),
                               atol=1e-3)
    np.testing.assert_allclose(kp.numpy(), coords, atol=1e-4)
    np.testing.assert_array_equal(pres.numpy(), present)


def test_gate_zero_passthrough():
    imgs, coords, present = rand_batch(b=4)
    out, kp, _ = run(aug.DeviceAugmentConfig.reference(
        scale_jitter=(0.5, 2.0)), imgs, coords, present, seed=1,
        gate=torch.zeros(4))
    np.testing.assert_allclose(out.numpy(), imgs.astype(np.float32),
                               atol=1e-3)
    np.testing.assert_allclose(kp.numpy(), coords, atol=1e-3)


def test_flip_mirrors_image_and_coords():
    imgs, coords, present = rand_batch(b=16)
    cfg = aug.DeviceAugmentConfig(
        apply_prob=1.0, scale_jitter=(1.0, 1.0), flip=True, rotate_deg=0.0,
        crop_pad_prob=0.0, elastic_alpha=0.0, motion_blur=False,
        dropout_frac=(0.0, 0.0), noise_scale=0.0)
    out, kp, _ = run(cfg, imgs, coords, present, seed=2)
    w = imgs.shape[2]
    n_flipped = 0
    for i in range(imgs.shape[0]):
        orig = imgs[i].astype(np.float32)
        if np.allclose(out[i].numpy(), orig, atol=0.51):
            np.testing.assert_allclose(kp[i].numpy(), coords[i], atol=1e-3)
        else:
            np.testing.assert_allclose(out[i].numpy(), orig[:, ::-1],
                                       atol=0.51)
            np.testing.assert_allclose(kp[i, :, 0].numpy(),
                                       (w - 1) - coords[i, :, 0], atol=1e-2)
            n_flipped += 1
    assert 0 < n_flipped < imgs.shape[0]   # about half: apply_prob * 0.5


def test_scale_down_places_top_left_and_halves_coords():
    imgs, coords, present = rand_batch(b=2, h=32, w=32)
    out, kp, _ = run(aug.DeviceAugmentConfig.jitter_only(0.5, 0.5), imgs,
                     coords, present, seed=3)
    assert out[:, 20:, 20:].abs().max().item() < 1e-3
    assert out[:, :14, :14].abs().sum().item() > 0
    np.testing.assert_allclose(kp.numpy(), coords * 0.5, atol=0.5)


def test_rotation_preserves_center_distance():
    imgs, coords, present = rand_batch(b=8, h=33, w=33)
    cfg = aug.DeviceAugmentConfig(
        apply_prob=1.0, scale_jitter=(1.0, 1.0), flip=False, rotate_deg=10.0,
        crop_pad_prob=0.0, elastic_alpha=0.0, motion_blur=False,
        dropout_frac=(0.0, 0.0), noise_scale=0.0)
    _, kp, _ = run(cfg, imgs, coords, present, seed=4)
    ctr = np.array([16.0, 16.0])
    d0 = np.linalg.norm(coords - ctr, axis=-1)
    d1 = np.linalg.norm(kp.numpy() - ctr, axis=-1)
    np.testing.assert_allclose(d1, d0, atol=1e-2)
    assert not np.allclose(kp.numpy(), coords, atol=1e-3)


def test_out_of_canvas_joints_marked_absent():
    imgs, coords, present = rand_batch(b=1, h=32, w=32, nj=2)
    coords[0, 0] = (100.0, 5.0)
    _, _, pres = run(aug.DeviceAugmentConfig.jitter_only(1.0, 1.0), imgs,
                     coords, present, seed=5)
    assert pres[0, 0].item() == 0.0 and pres[0, 1].item() == 1.0


def test_reference_pipeline_smoke():
    imgs, coords, present = rand_batch(b=4, h=48, w=40)
    cfg = aug.DeviceAugmentConfig.reference(scale_jitter=(0.75, 1.25))
    out, kp, _ = run(cfg, imgs, coords, present, seed=6)
    assert out.shape == imgs.shape and out.dtype == torch.float32
    assert torch.isfinite(out).all() and torch.isfinite(kp).all()
    assert out.min().item() >= 0.0 and out.max().item() <= 255.0
    out2, _, _ = run(cfg, imgs, coords, present, seed=7)
    assert not torch.allclose(out, out2)

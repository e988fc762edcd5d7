"""The port's losses, targets, cliques and DGP objective against JAX.

Each function gets the same seeded numpy inputs in both packages, on the
CPU in float32. Loss terms agree within 1e-5 relative; gradients with
respect to ``pred`` and ``locref_pred`` (and the clique coordinates)
within 1e-4 of their largest magnitude. The cases are those of
``tests/test_dgp_objective_golden.py`` and ``tests/test_cliques.py``,
extended to gm2 in {0, 1, 2}, gm3 in {0, 3} and wt 0 and > 0. On the CPU
the objective's decode is the plain soft-argmax; on the card it is the
CUDA kernel (tests/test_torch_port.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepgraphpose_tpu.ops import cliques as jax_cliques
from deepgraphpose_tpu.ops import dgp_objective as jax_objective
from deepgraphpose_tpu.ops import losses as jax_losses
from deepgraphpose_tpu.ops import targets as jax_targets
from deepgraphpose_tpu_torch.ops import cliques as torch_cliques
from deepgraphpose_tpu_torch.ops import dgp_objective as torch_objective
from deepgraphpose_tpu_torch.ops import losses as torch_losses
from deepgraphpose_tpu_torch.ops import targets as torch_targets

RTOL = 1e-5          # loss terms, relative
GRAD_TOL = 1e-4      # gradients, relative to their largest magnitude


def t(x):
    return torch.from_numpy(np.asarray(x))


def close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def grad_close(got, want):
    want = np.asarray(want)
    scale = np.abs(want).max()
    assert scale > 0
    assert np.abs(np.asarray(got) - want).max() <= GRAD_TOL * scale


def test_losses_match(rng):
    labels = rng.uniform(0, 1, (3, 6, 7)).astype(np.float32)
    logits = (rng.standard_normal((3, 6, 7)) * 4).astype(np.float32)
    logits[0, 0, :3] = 0.0                  # the max(x, 0) tie
    w = (rng.uniform(0, 1, (3, 6, 7)) > 0.4).astype(np.float32)
    pairs = [
        (torch_losses.sigmoid_cross_entropy_elements(t(labels), t(logits)),
         jax_losses.sigmoid_cross_entropy_elements(labels, logits)),
        (torch_losses.sigmoid_cross_entropy(t(labels), t(logits)),
         jax_losses.sigmoid_cross_entropy(labels, logits)),
        (torch_losses.sigmoid_cross_entropy(t(labels), t(logits), t(w)),
         jax_losses.sigmoid_cross_entropy(labels, logits, w)),
        (torch_losses.huber_elements(t(labels), t(logits), 1.5),
         jax_losses.huber_elements(labels, logits, 1.5)),
        (torch_losses.huber_loss(t(labels), t(logits), t(w)),
         jax_losses.huber_loss(labels, logits, w)),
        (torch_losses.mse_loss(t(labels), t(logits), t(w[:1])),
         jax_losses.mse_loss(labels, logits, w[:1])),
        (torch_losses.weighted_loss(t(logits), 0.0),
         jax_losses.weighted_loss(logits, 0.0)),
        (torch_losses.masked_mean_per_map(t(logits), t(w[:, 0, 0])),
         jax_losses.masked_mean_per_map(logits, w[:, 0, 0])),
        (torch_losses.masked_mean_per_map(t(logits), t(np.zeros(3))),
         jax_losses.masked_mean_per_map(logits, np.zeros(3))),
    ]
    for got, want in pairs:
        close(got, want, atol=1e-7)
    # gradient of the CE through the tie at x = 0
    x = t(logits).requires_grad_(True)
    torch_losses.sigmoid_cross_entropy(t(labels), x, t(w)).backward()
    want = jax.grad(lambda z: jax_losses.sigmoid_cross_entropy(
        labels, z, w))(jnp.asarray(logits))
    grad_close(x.grad, want)


def test_targets_match_with_hidden_labels(rng):
    h, w, nj = 11, 13, 4
    coords_xy = rng.uniform(0, 100, (3, nj, 2)).astype(np.float32)
    coords_xy[0, 1] = np.nan                 # hidden joints
    coords_xy[2, :] = np.nan
    present = ~np.isnan(coords_xy[..., 0])
    got = torch_targets.dlc_scoremap_targets(
        t(coords_xy), t(present), h, w, 8.0, 17, 7.2801, scale=0.8)
    want = jax_targets.dlc_scoremap_targets(
        coords_xy, present, h, w, 8.0, 17, 7.2801, scale=0.8)
    for g, wv in zip(got, want):
        close(g, wv, atol=1e-6)
    assert got[0].sum() > 0 and not got[0][2].any()
    rc = rng.uniform(0, 10, (3, nj, 2)).astype(np.float32)
    got = torch_targets.locref_targets_from_scoremap_coords(
        t(rc), t(present), h, w, 8.0, 17, 7.2801)
    want = jax_targets.locref_targets_from_scoremap_coords(
        rc, present, h, w, 8.0, 17, 7.2801)
    for g, wv in zip(got, want):
        close(g, wv, atol=1e-6)
    c = t(rc.reshape(-1, 2)).requires_grad_(True)
    maps = torch_targets.gaussian_target_maps(c, h, w, 1.5)
    close(maps.detach(), jax_targets.gaussian_target_maps(
        rc.reshape(-1, 2), h, w, 1.5), atol=1e-7)
    maps.square().sum().backward()
    grad_close(c.grad, jax.grad(lambda z: jnp.sum(jnp.square(
        jax_targets.gaussian_target_maps(z, h, w, 1.5))))(
        jnp.asarray(rc.reshape(-1, 2))))


def test_box_mean_flow_matches(rng):
    flow = rng.uniform(0, 3, (2, 20, 30)).astype(np.float32)
    r_min = np.array([[2.0, 0.0], [5.5, 1.25]], np.float32)
    r_max = np.array([[10.0, 20.0], [15.75, 19.0]], np.float32)
    c_min = np.array([[3.0, 0.0], [0.5, 7.0]], np.float32)
    c_max = np.array([[13.0, 30.0], [10.0, 28.5]], np.float32)
    box = [t(v) for v in (r_min, c_min, r_max, c_max)]
    close(torch_cliques.box_mean_flow(t(flow), *box),
          jax_cliques.box_mean_flow(flow, r_min, c_min, r_max, c_max))


@pytest.mark.parametrize("wt_max", [0.0, 1.5])
def test_cliques_match(rng, wt_max):
    T, nj, hw = 5, 3, (12, 16)
    coords = rng.uniform(15, 80, (T, nj, 2)).astype(np.float32)
    coords[4] = coords[3]                    # a padded frame: ties
    flow = rng.uniform(0.0, 4.0, (T - 1, 96, 128)).astype(np.float32)
    wt_batch = np.full(T - 1, 2.0, np.float32)
    pair_mask = np.array([1, 1, 0, 1], np.float32)
    S0 = np.array([[1.0, -1.0, 0.0], [0.0, 1.0, -1.0]], np.float32)
    ws = np.array([0.5, 2.0], np.float32)
    ws_max = np.array([10.0, 5.0], np.float32)
    fmask = np.array([1, 1, 1, 1, 0], np.float32)

    def jax_both(c):
        return (jax_cliques.temporal_clique_loss(
                    c, flow, wt_batch, wt_max, pair_mask, hw)
                + jax_cliques.spatial_clique_loss(c, S0, ws, ws_max, fmask,
                                                  hw))

    c = t(coords).requires_grad_(True)
    temporal = torch_cliques.temporal_clique_loss(
        c, t(flow), t(wt_batch), wt_max, t(pair_mask), hw)
    spatial = torch_cliques.spatial_clique_loss(
        c, t(S0), t(ws), t(ws_max), t(fmask), hw)
    close(temporal.detach(), jax_cliques.temporal_clique_loss(
        coords, flow, wt_batch, wt_max, pair_mask, hw))
    close(spatial.detach(), jax_cliques.spatial_clique_loss(
        coords, S0, ws, ws_max, fmask, hw))
    (temporal + spatial).backward()
    grad_close(c.grad, jax.grad(jax_both)(jnp.asarray(coords)))


def objective_case(gm2, gm3, wt, seed=0):
    """Inputs of tests/test_dgp_objective_golden.py: 4 frames of 10x12
    maps, 3 joints, frames 0 and 2 labeled, one NaN (hidden) joint."""
    rng = np.random.default_rng(seed)
    t_, h, w, nj = 4, 10, 12, 3
    pred = (rng.standard_normal((t_, h, w, nj)) * 2).astype(np.float32)
    locref_pred = (rng.standard_normal((t_, h, w, 2 * nj)) * 0.3
                   ).astype(np.float32)
    targets = rng.uniform(1, 8, (t_, nj, 2)).astype(np.float32)
    visible = np.zeros((t_, nj), bool)
    visible[0] = True
    visible[2] = True
    visible[0, 2] = False
    targets[~visible] = np.nan
    vis = visible.reshape(-1).astype(np.float32)
    batch = {
        "targets": targets,
        "visible_mask": vis,
        "hidden_mask": 1.0 - vis,
        "frame_mask": np.ones(t_, np.float32),
        "wt_batch": np.full(t_ - 1, wt, np.float32),
        "pair_mask": np.array([1, 1, 0], np.float32),
        "flow": rng.uniform(0.1, 2.0, (t_ - 1, 80, 96)).astype(np.float32),
    }
    params = dict(
        nj=nj, stride=8.0, gamma=1.0, gauss_len=1.0, lengthscale=1.0,
        pos_dist_thresh=17.0, locref_stdev=7.2801, locref_loss_weight=0.05,
        locref_huber_loss=True, wn_visible=5.0, wn_hidden=3.0, wt=wt,
        wt_max=0.5, gm2=gm2, gm3=gm3, n_visible_frames_total=11.0,
        n_hidden_frames_total=29.0,
        S0=np.array([[1.0, -1.0, 0.0], [0.0, 1.0, -1.0]], np.float32),
        ws=np.array([0.4, 0.9], np.float32),
        ws_max=np.array([30.0, 22.0], np.float32))
    return pred, locref_pred, batch, params


@pytest.mark.parametrize("wt", [0.0, 1.3])
@pytest.mark.parametrize("gm3", [0, 3])
@pytest.mark.parametrize("gm2", [0, 1, 2])
def test_dgp_loss_matches_jax(gm2, gm3, wt):
    pred, locref_pred, batch, params = objective_case(gm2, gm3, wt)
    p_jax = jax_objective.DGPLossParams(**params)
    p_torch = torch_objective.DGPLossParams(**params).to("cpu")
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jax_objective.dgp_loss(jnp.asarray(pred),
                                  jnp.asarray(locref_pred), jbatch, p_jax)
    x, lx = t(pred).requires_grad_(True), t(locref_pred).requires_grad_(True)
    got = torch_objective.dgp_loss(
        x, lx, {k: t(v) for k, v in batch.items()}, p_torch)
    assert set(got) == set(want)
    assert ("wt_loss" in got) == (wt > 0) and "ws_loss" in got
    for key, value in got.items():
        assert value.dim() == 0
        close(value.detach(), want[key])
    for key in ("total_loss", "total_loss_visible"):
        gx, glx = torch.autograd.grad(got[key], (x, lx), retain_graph=True)
        want_g = jax.grad(lambda a, b: jax_objective.dgp_loss(
            a, b, jbatch, p_jax)[key], argnums=(0, 1))(
            jnp.asarray(pred), jnp.asarray(locref_pred))
        grad_close(gx, want_g[0])
        grad_close(glx, want_g[1])


def test_compute_spatial_bounds_matches(rng):
    S0 = np.array([[1.0, -1.0, 0.0], [0.0, 1.0, -1.0]], np.float32)
    labels = [rng.uniform(0, 20, (5, 3, 2)), rng.uniform(0, 20, (2, 3, 2))]
    labels[0][1, 2] = np.nan
    got = torch_objective.compute_spatial_bounds(labels, S0, 8.0, 1000.0, 1.2)
    want = jax_objective.compute_spatial_bounds(labels, S0, 8.0, 1000.0, 1.2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_loss_params_to_device():
    _, _, _, params = objective_case(0, 0, 0.0)
    p = torch_objective.DGPLossParams(**params).to("cpu")
    assert p.n_limbs == 2 and isinstance(p.S0, torch.Tensor)
    assert p.S0.dtype == torch.float32 and p.to("cpu").n_limbs == 2
    assert torch_objective.DGPLossParams(
        **{**params, "S0": None}).to("cpu").n_limbs == 0

"""The port's int8 model (``models/quant.py``) against the JAX package's.

One JAX ResNet-50 (``num_joints=4``) with randomized frozen-BN statistics,
two seeded frames of 75x83 (as ``tests/test_quant.py``), and one JAX
``quantize_model`` for the module. Both packages hold the same weights:

* fold parity: the port's folded weights equal the JAX package's, and the
  port's folded float32 walk gives its ``PoseModel`` features within
  1e-5 of the largest;
* the JAX int8 variables carried in by ``quant_state_from_flax``: the
  port's forward on the CPU against ``qmodel.apply``, part_pred and locref
  within 1e-3 of the largest |logit| at dtype = carry_dtype = float32 and
  within 2e-2 at the bfloat16 default, with and without the int8
  residual carry. The int32 sums are exact and the epilogue agrees
  bitwise (tests/test_torch_int8_gemm.py); what remains is float32 /
  bfloat16 rounding of the two frameworks' own convolutions and adds in
  the heads and residual stream (measured: 3.0e-6 at float32, 0 to
  3.5e-6 at bfloat16);
* the port's own ``quantize_model`` on the same float weights: ``qw``
  identical, ``act_scale`` and ``oscale`` within 1e-5 relative (the
  calibration maxima come from float32 convolutions summed in other
  orders), and the bias-corrected ``bias`` within 1e-2 of the largest
  |bias|. That last bound is not 1e-4: the correction averages
  E[y_f32 - y_int8] over the float32 walk's own activations, and the two
  frameworks' float32 convolutions round differently, which moves 14 of
  the 2.2 million int8 inputs of that walk by one step; at block 4 the
  mean is over 60 positions (2 frames of 5x6), so one such step shifts a
  channel's statistic by up to 0.7% of the largest bias (measured with
  the JAX scales and weights in both: 0.68%).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepgraphpose_tpu.core.config import PoseConfig as JaxPoseConfig
from deepgraphpose_tpu.models import quant as jax_quant
from deepgraphpose_tpu.models.pose_model import init_model as jax_init_model
from deepgraphpose_tpu_torch.core.checkpoint import (quant_state_from_flax,
                                                     state_dict_from_flax)
from deepgraphpose_tpu_torch.core.config import PoseConfig
from deepgraphpose_tpu_torch.models import quant
from deepgraphpose_tpu_torch.models.pose_model import PoseModel

HW = (75, 83)
PX_TOL, PX_MEAN_TOL = 2.0, 0.5


@pytest.fixture(scope="module")
def setup():
    jcfg = JaxPoseConfig(num_joints=4, net_type="resnet_50")
    jmodel, jvars = jax_init_model(jcfg, jax.random.PRNGKey(0), HW)
    rng = np.random.default_rng(1)
    jvars = jax.tree_util.tree_map(np.asarray, jvars)
    # non-trivial frozen BN, so the fold is exercised
    jvars["batch_stats"] = jax.tree_util.tree_map(
        lambda x: (x * rng.uniform(0.5, 2.0, x.shape)).astype(x.dtype),
        jvars["batch_stats"])
    images = np.random.default_rng(0).integers(
        0, 255, (2, *HW, 3)).astype(np.float32)
    _, qvars = jax_quant.quantize_model(jcfg, jvars, images,
                                        dtype=jnp.float32)
    qvars = jax.tree_util.tree_map(np.asarray, qvars)
    cfg = PoseConfig(num_joints=4, net_type="resnet_50")
    model = PoseModel(cfg)
    model.load_state_dict(state_dict_from_flax(jvars), strict=True)
    return jcfg, jvars, qvars, cfg, model.eval(), images


def test_fold_parity(setup):
    jcfg, jvars, _, cfg, model, images = setup
    want = jax_quant.folded_backbone_weights(jvars)
    got = quant.folded_backbone_weights(model)
    assert set(got) == set(want)
    for site, (w, b) in want.items():
        np.testing.assert_allclose(got[site][0].numpy(), np.asarray(w),
                                   rtol=1e-6, atol=0, err_msg=site)
        np.testing.assert_allclose(got[site][1].numpy(), np.asarray(b),
                                   rtol=1e-6, atol=1e-7, err_msg=site)
    with torch.no_grad():
        x = torch.from_numpy(images)
        _, feats = quant._collect_forward(cfg, got, x)
        nchw = (x - model.mean_pixel).permute(0, 3, 1, 2)
        ref, _ = model.backbone(nchw)
    ref = ref.permute(0, 2, 3, 1)
    assert (feats - ref).abs().max() <= 1e-5 * ref.abs().max()


def jax_heads(jcfg, qvars, images, dtype, residual):
    qm = jax_quant.QuantizedPoseModel(jcfg, dtype=dtype, carry_dtype=dtype,
                                      residual_int8=residual)
    out = jax.jit(qm.apply)(qvars, jnp.asarray(images))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-3), ("bfloat16", 2e-2)])
def test_forward_matches_jax(setup, dtype, tol, residual):
    jcfg, _, qvars, cfg, _, images = setup
    want = jax_heads(jcfg, qvars, images, getattr(jnp, dtype), residual)
    qmodel = quant.QuantizedPoseModel(cfg, dtype=dtype, carry_dtype=dtype,
                                      residual_int8=residual)
    qmodel.load_state_dict(quant_state_from_flax(qvars), strict=True)
    with torch.no_grad():
        got = qmodel.eval()(torch.from_numpy(images))
    assert set(got) == set(want) == {"part_pred", "locref"}
    for key in want:
        g = got[key]
        assert g.dtype == torch.float32 and g.is_contiguous()
        scale = np.abs(want[key]).max()
        err = np.abs(g.numpy() - want[key]).max() / scale
        assert err <= tol, (key, err)


def test_quantize_model_matches_jax(setup):
    _, _, qvars, cfg, model, images = setup
    qmodel = quant.quantize_model(cfg, model, images, dtype=torch.float32)
    assert isinstance(qmodel, quant.QuantizedPoseModel) and qmodel.has_state
    want = quant_state_from_flax(qvars)
    sites = qmodel.sites
    assert set(sites) == set(qvars["qw"])
    bias_scale = max(np.abs(v).max() for v in qvars["bias"].values())
    worst = 0.0
    for site, q in sites.items():
        torch.testing.assert_close(q.qw, want[f"sites.{site}.qw"], rtol=0,
                                   atol=0)
        a_want = want[f"sites.{site}._extra_state"]["act_scale"]
        assert abs(q.act_scale - a_want) <= 1e-5 * a_want, site
        torch.testing.assert_close(q.oscale, want[f"sites.{site}.oscale"],
                                   rtol=1e-5, atol=0)
        worst = max(worst, (q.bias - want[f"sites.{site}.bias"]).abs().max()
                    .item() / bias_scale)
    assert worst <= 1e-2
    _kernel_copy_follows_qw(qmodel)
    for head in ("part_pred", "locref_pred"):
        torch.testing.assert_close(
            getattr(qmodel, head).block4.weight,
            getattr(model, head).block4.weight.float())


def test_weights_stay_two_dimensional_under_channels_last(setup):
    _, _, qvars, cfg, _, _ = setup
    qmodel = quant.QuantizedPoseModel(cfg)
    qmodel.load_state_dict(quant_state_from_flax(qvars))
    qmodel = qmodel.to(memory_format=torch.channels_last)
    for q in qmodel.sites.values():
        assert q.qw.dim() == 2 and q.qw.is_contiguous()
        assert isinstance(q.act_scale, float)


def _kernel_copy_follows_qw(qmodel):
    for site, q in qmodel.sites.items():
        assert q.qw_nk.shape == q.qw.shape[::-1], site
        assert q.qw_nk.is_contiguous() and q.qw_nk.device == q.qw.device
        assert torch.equal(q.qw_nk, q.qw.t()), site


@pytest.mark.parametrize("step", ["load", "reload", "to"])
def test_kernel_weight_copy_follows_qw(setup, step):
    """``QuantConv.qw_nk`` (the (Cout, K) layout the GEMM kernel reads)
    equals ``qw`` transposed after the JAX int8 variables load with
    strict=True, after another state loads over them, and after ``.to()``;
    it never enters the state_dict, whose keys stay those of
    ``quant_state_from_flax``."""
    _, _, qvars, cfg, _, _ = setup
    state = quant_state_from_flax(qvars)
    qmodel = quant.QuantizedPoseModel(cfg)
    keys = set(qmodel.state_dict())
    assert keys == set(state)
    qmodel.load_state_dict(state, strict=True)
    if step == "reload":
        negated = {k: -v if k.endswith(".qw") else v for k, v in state.items()}
        qmodel.load_state_dict(negated, strict=True)
        assert torch.equal(qmodel.sites["conv1"].qw, -state["sites.conv1.qw"])
    elif step == "to":
        qmodel = qmodel.to(torch.device("cpu"), torch.float64)
        assert qmodel.sites["conv1"].oscale.dtype == torch.float64
    _kernel_copy_follows_qw(qmodel)
    assert set(qmodel.state_dict()) == keys


def test_inference_only_and_needs_state(setup):
    _, _, _, cfg, _, images = setup
    qmodel = quant.QuantizedPoseModel(cfg)
    assert not qmodel.has_state
    with pytest.raises(RuntimeError, match="no quantized state"):
        qmodel(torch.from_numpy(images))
    with pytest.raises(ValueError, match="inference-only"):
        qmodel(torch.from_numpy(images), train=True)


# --------------------------------------------------------------------------
# calibration options: calib_batch, calib_percentile, bias_correction
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,q", [(1, 50.0), (2, 50.0), (7, 99.0),
                                 (1000, 99.9), (4097, 0.0), (4097, 100.0),
                                 (12345, 37.5)])
def test_abs_percentile_equals_jnp_percentile(n, q):
    """jnp.percentile's linear interpolation, on values with ties, against
    jnp.percentile run eagerly and compiled (as quantize_model runs it).
    Each computes the position q / 100 * (n - 1) in float32, and the
    three may round it a float32 step apart, so the bound is two such
    steps times the gap between the neighbouring order statistics, plus
    four float32 steps of the value."""
    rng = np.random.default_rng(n)
    x = np.round(rng.standard_normal(n) * 4, 1).astype(np.float32)
    got = quant.abs_percentile(torch.from_numpy(x).reshape(-1, 1), q)
    assert got.dtype == torch.float32
    a = np.sort(np.abs(x))
    pos = q / 100 * (n - 1)
    lo, hi = max(int(np.floor(pos)) - 1, 0), min(int(np.ceil(pos)) + 1,
                                                  n - 1)
    for fn in (jnp.percentile, jax.jit(jnp.percentile)):
        want = float(fn(jnp.abs(jnp.asarray(x)).ravel(), q))
        tol = (2 * np.spacing(np.float32(n)) * (a[hi] - a[lo])
               + 4 * np.spacing(np.float32(want)))
        assert abs(got.item() - want) <= tol, (got.item(), want, tol)


def test_abs_percentile_above_the_quantile_limit():
    """A site above 2^24 elements, where torch.quantile refuses: the
    order statistics still come out, against numpy's float64 percentile
    within float32's position rounding."""
    n = (1 << 24) + 5
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        n, dtype=np.float32))
    with pytest.raises(RuntimeError):
        torch.quantile(x.abs(), 0.999)
    got = quant.abs_percentile(x, 99.9).item()
    want = np.percentile(np.abs(x.numpy()).astype(np.float64), 99.9)
    assert abs(got - want) <= 1e-5 * want


def test_calibration_options_match_jax(setup):
    """calib_batch=1 and calib_percentile=99.0 on the module's weights and
    frames, without bias correction: the act_scales equal JAX's at the same
    options within 1e-5 relative (the activations come from float32
    convolutions summed in other orders) and the biases stay the folded
    ones, as JAX's do."""
    jcfg, jvars, _, cfg, model, images = setup
    for kw in (dict(calib_batch=1), dict(calib_percentile=99.0),
               dict(calib_batch=1, calib_percentile=99.0)):
        _, qvars = jax_quant.quantize_model(jcfg, jvars, images,
                                            dtype=jnp.float32,
                                            bias_correction=False, **kw)
        qvars = jax.tree_util.tree_map(np.asarray, qvars)
        qmodel = quant.quantize_model(cfg, model, images,
                                      dtype=torch.float32,
                                      bias_correction=False, **kw)
        want = quant_state_from_flax(qvars)
        for site, q in qmodel.sites.items():
            a_want = want[f"sites.{site}._extra_state"]["act_scale"]
            assert abs(q.act_scale - a_want) <= 1e-5 * a_want, (kw, site)
            torch.testing.assert_close(q.bias, want[f"sites.{site}.bias"],
                                       rtol=1e-6, atol=1e-6)


def test_percentile_calibration_clips_scales(setup):
    """tests/test_quant.py's case on the port: percentile scales are no
    larger than the max scales, and the model stays finite."""
    _, _, _, cfg, model, images = setup
    q_max = quant.quantize_model(cfg, model, images)
    q_p = quant.quantize_model(cfg, model, images, calib_percentile=99.0)
    clipped = 0
    for site, q in q_p.sites.items():
        assert q.act_scale <= q_max.sites[site].act_scale + 1e-12, site
        clipped += q.act_scale < q_max.sites[site].act_scale
    assert clipped > 0
    with torch.no_grad():
        out = q_p(torch.from_numpy(images))["part_pred"]
    assert torch.isfinite(out).all()


def test_bias_correction_changes_biases_and_not_worse(setup):
    """tests/test_quant.py's case on the port: the correction moves the
    biases, and the int8 part_pred is no farther from the float model's
    (within 5%)."""
    _, _, _, cfg, model, images = setup
    x = torch.from_numpy(images)
    with torch.no_grad():
        ref = model(x)["part_pred"]
        q_off = quant.quantize_model(cfg, model, images, dtype=torch.float32,
                                     bias_correction=False)
        q_on = quant.quantize_model(cfg, model, images, dtype=torch.float32)
        assert any(not torch.equal(q_on.sites[s].bias, q_off.sites[s].bias)
                   for s in q_on.sites)
        err_off = (q_off(x)["part_pred"] - ref).abs().mean()
        err_on = (q_on(x)["part_pred"] - ref).abs().mean()
    assert err_on <= err_off * 1.05, (err_on, err_off)


# --------------------------------------------------------------------------
# MobileNetV2: the dense convs int8 (ReLU6 epilogue, TF SAME pads), the
# depthwise convs float32, no int8 chain carry
# --------------------------------------------------------------------------

MOBILE_NETS = ["mobilenet_v2_0.35", "mobilenet_v2_1.0"]


@pytest.fixture(scope="module", params=MOBILE_NETS)
def mobile_setup(request):
    """As ``setup``, for a MobileNetV2 at the odd 75x83 (TF SAME pads
    every stride-2 conv alike there; the int8 GEMM tests cover the even
    sides)."""
    net = request.param
    jcfg = JaxPoseConfig(num_joints=4, net_type=net)
    jmodel, jvars = jax_init_model(jcfg, jax.random.PRNGKey(0), HW)
    rng = np.random.default_rng(1)
    jvars = jax.tree_util.tree_map(np.asarray, jvars)
    jvars["batch_stats"] = jax.tree_util.tree_map(
        lambda x: (x * rng.uniform(0.5, 2.0, x.shape)).astype(x.dtype),
        jvars["batch_stats"])
    images = np.random.default_rng(0).integers(
        0, 255, (2, *HW, 3)).astype(np.float32)
    _, qvars = jax_quant.quantize_model(jcfg, jvars, images,
                                        dtype=jnp.float32)
    qvars = jax.tree_util.tree_map(np.asarray, qvars)
    cfg = PoseConfig(num_joints=4, net_type=net)
    model = PoseModel(cfg)
    model.load_state_dict(state_dict_from_flax(jvars), strict=True)
    return jcfg, jmodel, jvars, qvars, cfg, model.eval(), images


def test_mobilenet_fold_parity(mobile_setup):
    jcfg, _, jvars, _, cfg, model, images = mobile_setup
    want = jax_quant.folded_backbone_weights(jvars)
    got = quant.folded_backbone_weights(model)
    assert set(got) == set(want)
    assert sum(s.endswith("/depthwise") for s in got) == 17
    for site, (w, b) in want.items():
        np.testing.assert_allclose(got[site][0].numpy(), np.asarray(w),
                                   rtol=1e-6, atol=0, err_msg=site)
        np.testing.assert_allclose(got[site][1].numpy(), np.asarray(b),
                                   rtol=1e-6, atol=1e-7, err_msg=site)
    with torch.no_grad():
        x = torch.from_numpy(images)
        _, feats = quant._collect_forward(cfg, got, x)
        nchw = (x - model.mean_pixel).permute(0, 3, 1, 2)
        ref, _ = model.backbone(nchw)
    ref = ref.permute(0, 2, 3, 1)
    assert (feats - ref).abs().max() <= 1e-5 * ref.abs().max()
    dense = quant.site_shapes(cfg.net_type)
    assert set(dense) | set(quant.depthwise_sites(cfg.net_type)) == set(got)
    for site, (k, cin, cout) in dense.items():
        assert want[site][0].shape == (k, k, cin, cout), site


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mobilenet_forward_matches_jax(mobile_setup, dtype):
    """The JAX int8 variables (``qvariables["dw"]`` included) through
    ``quant_state_from_flax``: the backbone's end points (every block's
    output and the features) bit for bit, and the logits within 1e-5 of
    the largest at float32 (measured 1.8e-6) and within
    one bfloat16 step of the largest (2^-8; measured 0 and 2.8e-4) at
    bfloat16, whose deconv heads round their sums to bfloat16.

    At float32 the reference is the jitted JAX model, whose epilogue
    ``acc * oscale + bias`` XLA contracts into one fused multiply-add, as
    the port's does (op by op JAX rounds it twice: 8.6e-4 apart at the
    features). At bfloat16 it is the JAX model op by op: jitted, XLA keeps
    the bfloat16 carry wider than bfloat16 inside its fusions (3.5e-2 to
    5.7e-2 apart at the end points), while the port, as the op-by-op
    model, rounds it to bfloat16 where the model says so."""
    jcfg, _, _, qvars, cfg, _, images = mobile_setup
    jdtype = getattr(jnp, dtype)
    qm = jax_quant.QuantizedPoseModel(jcfg, dtype=jdtype, carry_dtype=jdtype)
    x = jnp.asarray(images) - jnp.asarray(jcfg.mean_pixel, jnp.float32)

    def walk(x):
        return jax_quant._int8_backbone(jcfg, qvars, x, carry_dtype=jdtype)[1]

    if dtype == "float32":
        want = jax.jit(qm.apply)(qvars, jnp.asarray(images))
        jep = jax.jit(walk)(x)
        tol = 1e-5
    else:
        with jax.disable_jit():
            want = qm.apply(qvars, jnp.asarray(images))
            jep = walk(x)
        tol = 2.0 ** -8
    qmodel = quant.QuantizedPoseModel(cfg, dtype=dtype, carry_dtype=dtype)
    qmodel.load_state_dict(quant_state_from_flax(qvars), strict=True)
    assert set(qmodel.dw) == set(qvars["dw"])
    with torch.no_grad():
        got = qmodel.eval()(torch.from_numpy(images))
        _, tep = quant._int8_backbone(
            cfg, qmodel.sites, torch.from_numpy(np.array(x)),
            carry_dtype=qmodel.carry_dtype, dw=qmodel.dw)
    assert set(tep) == set(jep)
    for key, value in jep.items():
        np.testing.assert_array_equal(
            tep[key].float().numpy(), np.asarray(value.astype(jnp.float32)),
            err_msg=key)
    assert set(got) == set(want) == {"part_pred", "locref"}
    for key in want:
        g, w = got[key], np.asarray(want[key])
        assert g.dtype == torch.float32 and g.is_contiguous()
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert err <= tol, (key, err)


def test_mobilenet_quantize_model_matches_jax(mobile_setup):
    """The port's own quantize_model: JAX's weights and scales (``qw``
    identical, ``act_scale`` and ``oscale`` within 1e-5 relative, bias
    within 1e-2 of the largest, as for ResNet-50 above), the depthwise
    sites' folded float weights within 1e-6; and its int8 forward within
    tests/test_quant.py's bounds of the float32 model (relative error <
    0.25, correlation > 0.99)."""
    jcfg, jmodel, jvars, qvars, cfg, model, images = mobile_setup
    qmodel = quant.quantize_model(cfg, model, images, dtype=torch.float32)
    want = quant_state_from_flax(qvars)
    assert set(qmodel.sites) == set(qvars["qw"])
    assert set(qmodel.dw) == set(qvars["dw"])
    bias_scale = max(np.abs(v).max() for v in qvars["bias"].values())
    for site, q in qmodel.sites.items():
        torch.testing.assert_close(q.qw, want[f"sites.{site}.qw"], rtol=0,
                                   atol=0)
        a_want = want[f"sites.{site}._extra_state"]["act_scale"]
        assert abs(q.act_scale - a_want) <= 1e-5 * a_want, site
        torch.testing.assert_close(q.oscale, want[f"sites.{site}.oscale"],
                                   rtol=1e-5, atol=0)
        err = (q.bias - want[f"sites.{site}.bias"]).abs().max().item()
        assert err <= 1e-2 * bias_scale, site
    for site, d in qmodel.dw.items():
        for name in ("weight", "bias"):
            torch.testing.assert_close(getattr(d, name),
                                       want[f"dw.{site}.{name}"],
                                       rtol=1e-6, atol=1e-7)
    _kernel_copy_follows_qw(qmodel)
    ref = jmodel.apply(jvars, jnp.asarray(images))
    with torch.no_grad():
        out = qmodel(torch.from_numpy(images))
    for key in ("part_pred", "locref"):
        r, q = np.asarray(ref[key]), out[key].numpy()
        assert np.isfinite(q).all()
        assert np.abs(q - r).max() / np.abs(r).max() < 0.25, key
        assert np.corrcoef(r.ravel(), q.ravel())[0, 1] > 0.99, key


def test_mobilenet_depthwise_sites_match_jax(mobile_setup):
    """Each float depthwise site on the input the port's walk gives it,
    against the JAX package's ``dw_fn`` (quant.py:323-327): within 1e-6
    of the largest output (float32 sums of 9 products)."""
    jcfg, _, _, qvars, cfg, _, images = mobile_setup
    qmodel = quant.QuantizedPoseModel(cfg, dtype=torch.float32,
                                      carry_dtype=torch.float32)
    qmodel.load_state_dict(quant_state_from_flax(qvars), strict=True)
    seen = []
    forward = quant.DepthwiseSite.forward

    def record(site, x, stride, rate, carry):
        y = forward(site, x, stride, rate, carry)
        seen.append((site, x, stride, rate, y))
        return y

    names = {id(m): n for n, m in qmodel.dw.items()}
    try:
        quant.DepthwiseSite.forward = record
        with torch.no_grad():
            qmodel(torch.from_numpy(images))
    finally:
        quant.DepthwiseSite.forward = forward
    assert len(seen) == 17
    assert any(s == 2 for _, _, s, _, _ in seen)
    for site, x, stride, rate, y in seen:
        dw = qvars["dw"][names[id(site)]]
        want = jax.nn.relu6(jax_quant._conv(
            jnp.asarray(x.numpy()), jnp.asarray(dw["w"]), stride, rate,
            "SAME", groups=dw["w"].shape[-1]) + dw["b"])
        want = np.asarray(want)
        assert y.shape == want.shape
        assert np.abs(y.numpy() - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("net_type", MOBILE_NETS)
def test_mobilenet_residual_int8_raises(setup, net_type):
    _, _, _, _, model, images = setup
    cfg = PoseConfig(num_joints=4, net_type=net_type)
    assert not quant.supports_residual_int8(net_type)
    with pytest.raises(NotImplementedError, match="residual_int8"):
        quant.QuantizedPoseModel(cfg, residual_int8=True)
    mobile = PoseModel(cfg).eval()
    with pytest.raises(NotImplementedError, match="residual_int8"):
        quant.quantize_model(cfg, mobile, images, residual_int8=True)
    with pytest.raises(NotImplementedError, match="vit_b16"):
        quant.QuantizedPoseModel(PoseConfig(num_joints=4, net_type="vit_b16"))


def test_mobilenet_estimate_pose_with_jax_int8_state_matches_jax(
        synthetic_project, tmp_path):
    """``estimate_pose`` over the synthetic project's video with the JAX
    package's int8 mobilenet_v2_1.0 (calibrated on 16 of its frames,
    float32 carry and heads in both): x / y within 1e-2 px and the
    likelihood within 1e-3, as for ResNet-50 above."""
    from deepgraphpose_tpu.infer import predict as jax_predict
    from deepgraphpose_tpu_torch.infer import predict

    video = synthetic_project[0] + "/videos/synthvid.avi"
    net = "mobilenet_v2_1.0"
    jcfg = JaxPoseConfig(num_joints=3, net_type=net)
    _, jvars = jax_init_model(jcfg, jax.random.PRNGKey(0), (64, 80))
    jvars = jax.tree_util.tree_map(np.asarray, jvars)
    head = jvars["params"]["part_pred"]["block4"]
    head["kernel"] = head["kernel"] * np.float32(0.1)
    head["bias"] = head["bias"] * np.float32(0.1)
    calib = quant.calib_frames_from_video(video, 16)
    _, qvars = jax_quant.quantize_model(jcfg, jvars, calib,
                                        dtype=jnp.float32)
    f32 = dict(dtype=jnp.float32, carry_dtype=jnp.float32)
    kw = dict(save_pose=False, batch_size=8, max_frames=20)
    want = jax_predict.estimate_pose(
        None, tmp_path / "s.ckpt", video, tmp_path, pose_cfg=jcfg,
        model=jax_quant.QuantizedPoseModel(jcfg, **f32), variables=qvars,
        **kw)
    cfg = PoseConfig(num_joints=3, net_type=net)
    qmodel = quant.QuantizedPoseModel(cfg, dtype=torch.float32,
                                      carry_dtype=torch.float32)
    got = predict.estimate_pose(
        None, tmp_path / "s.ckpt", video, tmp_path, pose_cfg=cfg,
        model=qmodel, device="cpu",
        variables=quant_state_from_flax(
            jax.tree_util.tree_map(np.asarray, qvars)), **kw)
    for key in ("x", "y"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-2)
    np.testing.assert_allclose(got["likelihoods"], want["likelihoods"],
                               rtol=0, atol=1e-3)


# --------------------------------------------------------------------------
# entry points on the synthetic project's video (64x80, 40 frames)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def video(synthetic_project):
    return synthetic_project[0] + "/videos/synthvid.avi"


@pytest.fixture(scope="module")
def video_setup(setup):
    """The module's weights with the heads cut to the project's 3 joints
    and part_pred scaled by 0.1 (as tests/test_torch_infer.py does), so
    the logits are O(1) and the soft-argmax is not set by a near-tie of
    saturated peaks."""
    _, jvars, _, _, _, _ = setup
    params = dict(jvars["params"])
    head = params["part_pred"]["block4"]
    params["part_pred"] = {"block4": {
        "kernel": head["kernel"][..., :3] * np.float32(0.1),
        "bias": head["bias"][:3] * np.float32(0.1)}}
    head = params["locref_pred"]["block4"]
    params["locref_pred"] = {"block4": {"kernel": head["kernel"][..., :6],
                                        "bias": head["bias"][:6]}}
    jvars = {"params": params, "batch_stats": jvars["batch_stats"]}
    cfg = PoseConfig(num_joints=3)
    model = PoseModel(cfg)
    model.load_state_dict(state_dict_from_flax(jvars), strict=True)
    return JaxPoseConfig(num_joints=3), jvars, cfg, model.eval()


def test_estimate_pose_with_jax_int8_state_matches_jax(video_setup, video,
                                                       tmp_path):
    """The same int8 weights and scales in both (the JAX package's,
    carried in by quant_state_from_flax): frames, forward and decode agree
    within 1e-2 px and the likelihood within 1e-3."""
    from deepgraphpose_tpu.infer import predict as jax_predict
    from deepgraphpose_tpu_torch.infer import predict

    jcfg, jvars, cfg, _ = video_setup
    calib = quant.calib_frames_from_video(video, 16)
    _, qvars = jax_quant.quantize_model(jcfg, jvars, calib,
                                        dtype=jnp.float32)
    kw = dict(save_pose=False, batch_size=8, max_frames=20)
    want = jax_predict.estimate_pose(
        None, tmp_path / "s.ckpt", video, tmp_path, pose_cfg=jcfg,
        model=jax_quant.QuantizedPoseModel(jcfg, dtype=jnp.float32),
        variables=qvars, **kw)
    qmodel = quant.QuantizedPoseModel(cfg, dtype=torch.float32)
    got = predict.estimate_pose(
        None, tmp_path / "s.ckpt", video, tmp_path, pose_cfg=cfg,
        model=qmodel, device="cpu",
        variables=quant_state_from_flax(
            jax.tree_util.tree_map(np.asarray, qvars)), **kw)
    for key in ("x", "y"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-2)
    np.testing.assert_allclose(got["likelihoods"], want["likelihoods"],
                               rtol=0, atol=1e-3)


@pytest.mark.parametrize("mode", [True, "residual"])
def test_estimate_pose_quantized_matches_jax(video_setup, video, tmp_path,
                                            mode):
    """Each package calibrates on the video's first 16 frames and runs 20
    frames int8. Their scales agree to 1e-6 relative, but the int8 model
    is that sensitive: the JAX model alone moves by 4.3% of its largest
    logit when its scales move by 1e-6, the port's own quantization
    differs from the JAX one by 3.7%, and on these random-weight maps
    that moves mu by up to 0.89 px (mean 0.20 px), 1.38 px (mean 0.27 px)
    with the residual carry. Bounds: max 2 px, mean 0.5 px."""
    from deepgraphpose_tpu.infer import predict as jax_predict
    from deepgraphpose_tpu_torch.infer import predict

    jcfg, jvars, cfg, model = video_setup
    kw = dict(save_pose=False, batch_size=8, max_frames=20, quantize=mode)
    want = jax_predict.estimate_pose(None, tmp_path / "s.ckpt", video,
                                     tmp_path, pose_cfg=jcfg,
                                     variables=jvars, **kw)
    got = predict.estimate_pose(None, tmp_path / "s.ckpt", video, tmp_path,
                                pose_cfg=cfg, model=model, device="cpu", **kw)
    err = np.stack([np.abs(got[k] - want[k]) for k in ("x", "y")])
    assert err.max() <= PX_TOL and err.mean() <= PX_MEAN_TOL


def test_estimate_pose_dynamic_video_quantized_matches_jax(
        video_setup, synthetic_project, video, tmp_path):
    """The tracked crop over a JAX snapshot on disk, int8, each package
    calibrating on the first 8 frames, over 3 chunks of 8 (the third is
    cropped): the same ``cropped`` flags, and x / y within the bounds
    above (measured: max 0.74 px, mean 0.17 px)."""
    from deepgraphpose_tpu.core.checkpoint import save_snapshot
    from deepgraphpose_tpu.infer import dynamic as jax_dynamic
    from deepgraphpose_tpu_torch.infer import dynamic

    _, jvars, _, _ = video_setup
    snap = save_snapshot(tmp_path, 0, "final--0", jvars)
    proj_cfg = synthetic_project[0] + "/config.yaml"
    kw = dict(crop_hw=(48, 64), batch_size=8, max_frames=24,
              detection_threshold=0.5, save_pose=False, quantize=True)
    want = jax_dynamic.estimate_pose_dynamic_video(proj_cfg, snap, video,
                                                   tmp_path, **kw)
    got = dynamic.estimate_pose_dynamic_video(proj_cfg, snap, video,
                                              tmp_path, device="cpu", **kw)
    np.testing.assert_array_equal(got["cropped"], want["cropped"])
    err = np.stack([np.abs(got[k] - want[k]) for k in ("x", "y")])
    assert got["cropped"].any() and not got["cropped"].all()
    assert err.max() <= PX_TOL and err.mean() <= PX_MEAN_TOL


def test_estimate_pose_quantized_model_needs_its_state(setup, video,
                                                       tmp_path):
    from deepgraphpose_tpu_torch.infer import predict

    _, _, _, cfg, _, _ = setup
    with pytest.raises(ValueError, match="quantized state"):
        predict.estimate_pose(None, tmp_path / "s.ckpt", video, tmp_path,
                              pose_cfg=cfg,
                              model=quant.QuantizedPoseModel(cfg),
                              save_pose=False, max_frames=2, device="cpu")

"""The plain reference against the program's CPU forward, decode and int8
calibration at small inputs, on the benchmark's own seeded weights."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from dgpbench import data
from dgpbench.reference import decode, models, quant

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
HW = (96, 112)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def config(name: str) -> dict:
    return json.loads((CONFIGS / f"{name}.json").read_text())


def program(cfg: dict, weights: dict, dtype=torch.float32):
    from deepgraphpose_tpu_torch.core.config import PoseConfig
    from deepgraphpose_tpu_torch.models.pose_model import PoseModel

    pc = PoseConfig(net_type=cfg["net_type"], num_joints=cfg["num_joints"])
    model = PoseModel(pc, dtype)
    model.load_state_dict(weights)
    return pc, model.to(memory_format=torch.channels_last).eval()


@pytest.mark.parametrize("name", ["resnet50_dlc_reaching",
                                  "mobilenet_v2_1.0_dlc_reaching"])
def test_forward_and_decode_match_the_program(name):
    from deepgraphpose_tpu_torch.ops.softargmax import softargmax_likelihood

    cfg = config(name)
    weights = data.make_weights(cfg, 7, "cpu")
    frames = torch.from_numpy(data.make_frames(7, 3, HW, "cpu"))
    _, model = program(cfg, weights)
    with torch.no_grad():
        want = model(frames, heads=("part_pred",))["part_pred"]
        got = models.forward(cfg, weights, frames)
    assert got.shape == want.shape
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    # the score maps have a few units of spread: the decode has work to do
    assert 0.3 < float(got.std()) < 5.0
    mu_w, lik_w = softargmax_likelihood(want, cfg["gamma"], cfg["gauss_len"])
    mu = decode.soft_argmax(want, cfg["gamma"], cfg["gauss_len"])
    torch.testing.assert_close(mu, mu_w, rtol=0, atol=1e-5)
    torch.testing.assert_close(decode.likelihood_at(want, mu), lik_w,
                               rtol=0, atol=1e-6)


def test_int8_scheme_matches_the_programs_quantization():
    """Scales and integer weights equal the program's ``quantize_model``
    on the same calibration frames; the logits agree within a tenth of
    their largest value (a one-unit difference in a requantization,
    from a bias that differs in its last bit, grows through the int8
    network)."""
    from deepgraphpose_tpu_torch.models.quant import quantize_model

    cfg = config("resnet50_dlc_reaching")
    weights = data.make_weights(cfg, 8, "cpu")
    frames = torch.from_numpy(data.make_frames(8, 8, HW, "cpu"))
    pc, model = program(cfg, weights)
    qmodel = quantize_model(pc, model, frames.numpy(), dtype=torch.bfloat16)
    state = quant.calibrate(cfg, weights, frames)
    assert set(state) == set(qmodel.sites)
    for site, q in qmodel.sites.items():
        assert state[site]["sx"].item() == pytest.approx(q.act_scale,
                                                         rel=1e-5)
        qw = state[site]["qw"].permute(2, 3, 1, 0).reshape(q.qw.shape)
        assert (qw != q.qw.float()).float().mean() < 1e-3
        # biases are about 0.1; the corrections' means are summed in
        # another order
        torch.testing.assert_close(state[site]["bias"], q.bias, rtol=0,
                                   atol=1e-4)
    with torch.no_grad():
        want = qmodel(frames, heads=("part_pred",))["part_pred"]
    got = quant.forward(cfg, weights, state, frames)
    assert (got - want).abs().max() <= 0.1 * want.abs().max()


def test_int4_is_far_from_int8():
    cfg = config("resnet50_dlc_reaching")
    weights = data.make_weights(cfg, 9, "cpu")
    frames = torch.from_numpy(data.make_frames(9, 8, HW, "cpu"))
    s8 = quant.calibrate(cfg, weights, frames)
    s4 = quant.calibrate(cfg, weights, frames, qmax=7)
    y8 = quant.forward(cfg, weights, s8, frames)
    y4 = quant.forward(cfg, weights, s4, frames, qmax=7)
    y32 = models.forward(cfg, weights, frames)
    assert float((y4 - y32).abs().max()) > 3 * float((y8 - y32).abs().max())


def test_seeded_inputs_repeat():
    a = data.make_frames(2 ** 31 + 5, 3, (40, 48), "cpu")
    b = data.make_frames(2 ** 31 + 5, 3, (40, 48), "cpu")
    c = data.make_frames(2 ** 31 + 6, 3, (40, 48), "cpu")
    assert a.dtype == np.uint8 and a.shape == (3, 40, 48, 3)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    cfg = config("mobilenet_v2_1.0_dlc_reaching")
    w1 = data.make_weights(cfg, 2 ** 40, "cpu")
    w2 = data.make_weights(cfg, 2 ** 40, "cpu")
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    assert all(float(w1[k].min()) > 0 for k in w1 if k.endswith(".var"))

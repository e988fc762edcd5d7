"""The infer driver's whole run at a tiny size on the CPU (the harness's
look for a card skipped), with its timed path sound and broken, and the
control in the program's place."""

import time

import pytest
import torch

import dgpbench.run as run
from dgpbench import harness
from dgpbench.drivers import infer_stream

ROOT = run.ROOT
CELLS = ["resnet50-infer-bf16", "mnv2-infer-bf16", "resnet50-infer-int8"]


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def tiny(name: str) -> dict:
    """The cell with its limits, at 96x112, batches of 4 over a ring of
    8 frames."""
    cell = harness.load_cell(ROOT, name)
    cell["config"]["frame_hw"] = [96, 112]
    cell["traffic"].update(batch=4, ring_frames=8, calib_frames=4,
                           warmup_batches=2, check_block=4, trace_skip=1,
                           trace_batches=2)
    return cell


def execute(cell, seconds=1.0):
    return run.execute(ROOT, cell, torch.device("cpu"), 2 ** 31 + 77,
                       seconds, False, time.perf_counter())


def test_a_sound_run_is_correct():
    line = execute(tiny("resnet50-infer-bf16"))
    line.pop("diagnostics")
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] and line["failed"] == 0
    assert line["attempted"] >= 8 and line["attempted"] % 4 == 0
    assert set(line["metrics"]) == {"card_ms_per_frame", "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    for check in line["checks"].values():
        assert 0 <= check["value"] <= check["limit"]


def broken_infer(monkeypatch, fault: str):
    from deepgraphpose_tpu_torch.infer import predict

    make = predict.make_infer_fn
    calls = []

    def make_broken(model, cfg):
        infer = make(model, cfg)

        def fn(images):
            calls.append(1)
            if fault == "half_batch":
                half = images.shape[0] // 2
                mu, lik = infer(images[:half])
                return torch.cat([mu, mu]), torch.cat([lik, lik])
            mu, lik = infer(images)
            if len(calls) == 4:          # one answer of one window batch:
                mu, lik = mu.clone(), lik.clone()   # two joints swapped
                mu[1, [1, 3]] = mu[1, [3, 1]]
                lik[1, [1, 3]] = lik[1, [3, 1]]
            return mu, lik
        return fn

    monkeypatch.setattr(predict, "make_infer_fn", make_broken)


@pytest.mark.parametrize("fault", ["half_batch", "one_answer"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    broken_infer(monkeypatch, fault)
    line = execute(tiny("resnet50-infer-bf16"))
    assert not line["correct"]
    assert line["failed"] >= (1 if fault == "one_answer" else 8)


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    """The reference one precision down (fp8 for bf16, int4 for int8) in
    the program's place fails the cell's limits."""
    cell = tiny(name)
    cell["config"]["frame_hw"] = [187, 208]     # a quarter of the cell's
    cell["traffic"]["ring_frames"] = 16
    got = infer_stream.control_readings({
        "config": cell["config"], "traffic": cell["traffic"],
        "limits": cell["limits"], "device": torch.device("cpu"),
        "seed": 2 ** 31 + 91})
    assert got["failed"] > 0
    assert any(got[k] > v for k, v in cell["limits"].items())


def test_the_card_time_lies_inside_the_window():
    """The card's time on the window's batches is no longer than the
    window: its share of it, frames/s times ms a frame, is in (0, 1]."""
    cell = tiny("resnet50-infer-bf16")
    out = infer_stream.run({
        "config": cell["config"], "traffic": cell["traffic"],
        "limits": cell["limits"], "device": torch.device("cpu"),
        "seed": 2 ** 31 + 79, "seconds": 1.0, "trace": False,
        "t_start": time.perf_counter()})
    m = out["metrics"]
    assert 0 < m["card_ms_per_frame"] * m["infer_frames_per_s"] / 1e3 <= 1

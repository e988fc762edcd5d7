"""BENCHMARK.json against the benchmark's contract, and the harness finding
a new cell and a new metric by their names alone."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from dgpbench import harness

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return harness.load_benchmark(ROOT)


def test_benchmark_json_keeps_the_contract(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["dgpbench"]
    assert bench["command"] == ["python3", "dgpbench/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    # a full check of 24 cells at this length fits in 43200 s
    cells = 24
    assert ((2 + 14 * cells) * (bench["run_seconds"] + 60)
            + cells * 2 * 90 + 1200) <= 43200
    names = set()
    for c in bench["configs"]:
        assert NAME.match(c["name"]) and c["name"] not in names
        names.add(c["name"])
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("dgpbench/")
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
        assert all(NAME.match(k) for k in c["reduced"])
        assert harness.load_json(ROOT / c["file"])["reduced"] == c["reduced"]
    pairs = set()
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and w["name"] not in names
        names.add(w["name"])
        assert w["config"] in {c["name"] for c in bench["configs"]}
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert "\n" not in w["why"] and "\t" not in w["why"]
    metrics = bench["end_to_end"] + bench["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
        assert (ROOT / "dgpbench" / "metrics" / f"{m['name']}.py").is_file()
        for cell in m.get("workloads", ()):
            assert m["moves"] in {x["name"] for x in
                                  harness.end_to_end_metrics(bench, cell)}
    for w in bench["workloads"]:
        reported = {m["name"] for m in harness.end_to_end_metrics(
            bench, w["name"])}
        assert "setup_s" in reported and len(reported) >= 2
        assert harness.per_layer_metrics(bench, w["name"])
        cell = harness.load_cell(ROOT, w["name"])
        assert (ROOT / "dgpbench" / "drivers"
                / f"{cell['traffic']['driver']}.py").is_file()
    assert len(json.dumps(bench)) < 64 * 1024


def test_a_new_cell_and_metric_are_found_by_name(tmp_path, bench):
    """A later PR adds files and entries only: a workload file, a traffic
    file and a metric reader, picked up with no code changed."""
    shutil.copytree(ROOT / "dgpbench", tmp_path / "dgpbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    new = json.loads(json.dumps(bench))
    new["workloads"].append({"name": "resnet50-infer-bf16-b64",
                             "config": "resnet50_dlc_reaching",
                             "traffic": "stream_bf16_b64", "chips": 1,
                             "why": "a smaller batch"})
    new["per_layer"].append({"name": "h2d_ms_per_batch.infer", "unit": "ms",
                             "better": "lower", "source": "device_trace",
                             "layer": "host feed",
                             "moves": "infer_frames_per_s",
                             "workloads": ["resnet50-infer-bf16-b64"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    traffic = harness.load_json(ROOT / "dgpbench" / "traffic"
                                / "stream_bf16_b128.json")
    traffic["batch"] = 64
    d = tmp_path / "dgpbench"
    (d / "traffic" / "stream_bf16_b64.json").write_text(json.dumps(traffic))
    (d / "workloads" / "resnet50-infer-bf16-b64.json").write_text(json.dumps(
        {"config": "resnet50_dlc_reaching", "traffic": "stream_bf16_b64",
         "limits": {"mu_err_cells_p50": 1.0, "lik_err": 1.0}}))
    (d / "metrics" / "h2d_ms_per_batch.infer.py").write_text(
        "from dgpbench import harness\n\n"
        "def read(trace):\n"
        "    return harness.device_ms(trace, 'Memcpy HtoD') / "
        "trace['batches']\n")
    cell = harness.load_cell(tmp_path, "resnet50-infer-bf16-b64")
    assert cell["traffic"]["batch"] == 64
    assert cell["config"]["net_type"] == "resnet_50"
    names = [m["name"] for m in harness.per_layer_metrics(
        cell["bench"], cell["name"])]
    assert names == ["h2d_ms_per_batch.infer"]
    trace = {"batches": 2, "kernels": [("Memcpy HtoD (Pinned -> Device)",
                                        0.0, 3000.0, None),
                                       ("softargmax_likelihood_kernel",
                                        3000.0, 3010.0, None)]}
    reader = harness.load_metric(tmp_path, "h2d_ms_per_batch.infer")
    assert reader.read(trace) == pytest.approx(1.5)
    assert harness.load_driver(tmp_path, "infer_stream").run


TOY_FAMILY = '''"""A toy family: two 3x3 convolutions with frozen BN and ReLU, the
first of stride 2, then a gain a channel, a role of its own."""
import torch

from dgpbench.reference import models


def specs(cfg, conv, bn):
    d = cfg["depth"]
    conv("conv_a", d, 3, 3, "root")
    bn("bn_a", d)
    conv("conv_b", d, d, 3)
    bn("bn_b", d)
    conv("gain", d, 1, 1, "toy_gain")
    return d


def backbone(cfg, w, x, conv):
    b = "backbone."
    for name, stride in (("a", 2), ("b", 1)):
        x = torch.relu(models.frozen_bn(w, f"{b}bn_{name}", models.same_conv(
            conv, x, w[f"{b}conv_{name}.weight"], stride)))
    return x * w[b + "gain.weight"].view(1, -1, 1, 1)


def layers(cfg, hw, add):
    d = cfg["depth"]
    half = tuple(-(-n // 2) for n in hw)
    add("conv_a", 3, 3, d, 2, 1, hw, half)
    add("conv_b", 3, d, d, 1, 1, half, half)
    return half, d


def init(role, z, shape):
    return 1.0 + 0.01 * z if role == "toy_gain" else None
'''

TOY_CHECK = '''import json, sys
from pathlib import Path
import torch
import torch.nn.functional as F
from dgpbench import data, harness
from dgpbench.counts import flops
from dgpbench.reference import arch, models

root = Path(__file__).resolve().parent
assert Path(data.__file__).resolve().is_relative_to(root), data.__file__
cell = harness.load_cell(root, "toy-infer")
cfg = cell["config"]
w = data.make_weights(cfg, 2 ** 31 + 5, "cpu")
seen = []


def counting_conv(x, weight, stride=1, padding=0, dilation=1, groups=1):
    y = models.plain_conv(x, weight, stride, padding, dilation, groups)
    seen.append(y[0].numel() * weight[0].numel())
    return y


def counting_transpose(x, weight, bias, stride):
    seen.append(x[0, 0].numel() * weight.numel())
    return F.conv_transpose2d(x, weight, bias, stride)


frames = torch.from_numpy(data.make_frames(3, 2, (64, 72), "cpu"))
with torch.no_grad():
    out = models.forward(cfg, w, frames, counting_conv, counting_transpose)
print(json.dumps({
    "batch": cell["traffic"]["batch"],
    "names": {k: list(v.shape) for k, v in w.items()},
    "gain_dev": float((w["backbone.gain.weight"] - 1).abs().max()),
    "out": list(out.shape), "finite": bool(torch.isfinite(out).all()),
    "std": float(out.std()),
    "layers": [l["site"] for l in arch.layers(cfg, (64, 72))],
    "map_hw": list(arch.map_hw(cfg, (64, 72))),
    "macs": flops.macs_per_frame(cfg, (64, 72)), "seen": sum(seen)}))
'''


def test_a_new_family_joins_as_files_only(tmp_path, bench):
    """A configuration of a backbone family the harness has not seen: its
    family module, config, traffic, workload and ``BENCHMARK.json`` entry
    are new files and entries, and the harness's cell, weights, reference
    forward, layer plan and counts take it with no other file changed."""
    shutil.copytree(ROOT / "dgpbench", tmp_path / "dgpbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    d = tmp_path / "dgpbench"
    (d / "reference" / "families" / "toy.py").write_text(TOY_FAMILY)
    (d / "configs" / "toy_two_conv.json").write_text(json.dumps(
        {"name": "toy_two_conv", "family": "toy", "net_type": "toy",
         "depth": 8, "num_joints": 3, "deconvolution_stride": 2,
         "location_refinement": True, "frame_hw": [64, 72], "stride": 4.0,
         "gamma": 1.0, "gauss_len": 1.0,
         "mean_pixel": [123.68, 116.779, 103.939], "reduced": []}))
    traffic = harness.load_json(ROOT / "dgpbench" / "traffic"
                                / "stream_bf16_b128.json")
    (d / "traffic" / "toy_stream_b4.json").write_text(json.dumps(
        {**traffic, "batch": 4}))
    (d / "workloads" / "toy-infer.json").write_text(json.dumps(
        {"config": "toy_two_conv", "traffic": "toy_stream_b4",
         "limits": {"mu_err_cells_p50": 1.0, "lik_err": 1.0}}))
    new = json.loads(json.dumps(bench))
    new["configs"].append({"name": "toy_two_conv",
                           "source": "https://arxiv.org/abs/1512.03385",
                           "file": "dgpbench/configs/toy_two_conv.json",
                           "reduced": [], "why": "a toy family"})
    new["workloads"].append({"name": "toy-infer", "config": "toy_two_conv",
                             "traffic": "toy_stream_b4", "chips": 1,
                             "why": "a toy family"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    (tmp_path / "check_toy.py").write_text(TOY_CHECK)
    run = subprocess.run([sys.executable, "check_toy.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    got = json.loads(run.stdout.splitlines()[-1])
    assert got["batch"] == 4
    assert got["names"] == {
        "backbone.conv_a.weight": [8, 3, 3, 3],
        **{f"backbone.bn_a.{p}": [8] for p in ("scale", "bias", "mean",
                                                 "var")},
        "backbone.conv_b.weight": [8, 8, 3, 3],
        **{f"backbone.bn_b.{p}": [8] for p in ("scale", "bias", "mean",
                                                 "var")},
        "backbone.gain.weight": [8, 1, 1, 1],
        "part_pred.block4.weight": [8, 3, 3, 3],
        "part_pred.block4.bias": [3],
        "locref_pred.block4.weight": [8, 6, 3, 3],
        "locref_pred.block4.bias": [6]}
    assert 0 < got["gain_dev"] < 0.05       # scaled by the family's init
    assert got["out"] == [2, 64, 72, 3] and got["finite"]
    assert got["std"] > 0
    assert got["layers"] == ["conv_a", "conv_b", "part_pred"]
    assert got["map_hw"] == [64, 72]
    # by hand: 32x36 outputs of 3->8 and 8->8 3x3s, the head 8->3 on 32x36
    assert got["macs"] == got["seen"] == 32 * 36 * 9 * (3 * 8 + 8 * 8
                                                        + 8 * 3)


@pytest.mark.parametrize("family", ["hrnet", "../arch"])
@pytest.mark.parametrize("fn", ["param_specs", "backbone", "layers",
                                "make_weights"])
def test_an_unknown_family_names_the_missing_file(family, fn):
    from dgpbench import data
    from dgpbench.reference import arch, models

    cfg = harness.load_json(ROOT / "dgpbench" / "configs"
                            / "resnet50_dlc_reaching.json")
    cfg["family"] = family
    call = {"param_specs": lambda: models.param_specs(cfg),
            "backbone": lambda: models.backbone(cfg, {}, None),
            "layers": lambda: arch.layers(cfg, (64, 72)),
            "make_weights": lambda: data.make_weights(cfg, 0, "cpu")}[fn]
    missing = f"families/{family}.py"
    with pytest.raises(ValueError, match=re.escape(missing)):
        call()


def test_metric_readers_on_a_trace(bench):
    """Each reader on a made-up trace: the shares stay at or under 100%
    when the kernels take at least their bounds, and a reader with
    nothing to read returns None."""
    cfg = harness.load_json(ROOT / "dgpbench" / "configs"
                            / "resnet50_dlc_reaching.json")
    traffic = harness.load_json(ROOT / "dgpbench" / "traffic"
                                / "stream_int8_b128.json")
    kernels = [("void at::native::vectorized_elementwise_kernel<4>",
                0.0, 50_000.0, None),
               ("sm90_xmma_fprop_implicit_gemm_bf16", 50_000.0, 60_000.0,
                None),
               ("softargmax_likelihood_kernel", 60_000.0, 60_015.3, None),
               ("void gemm_kernel<Dense>", 60_100.0, 150_000.0, None)]
    trace = {"kernels": kernels, "batches": 1, "frames": 128, "batch": 128,
             "busy_s": 0.15, "wall_s": 0.16, "frame_hw": (747, 832),
             "map_shape": (128, 94, 104, 5), "frames_per_s": 900.0,
             "card_ms_per_frame": 0.5, "config": cfg, "traffic": traffic,
             "host_spans": {"host_to_device": [0.04, 0.06]},
             "batch_ms_p95": 700.0}
    got = {m["name"]: harness.load_metric(ROOT, m["name"]).read(trace)
           for m in bench["per_layer"]}
    assert got["device_idle_share.infer"] == pytest.approx(6.25)
    assert got["elementwise_ms_per_frame.infer"] == pytest.approx(50 / 128)
    assert got["conv_ms_per_frame.infer"] == pytest.approx(10 / 128)
    assert got["depthwise_ms_per_frame.infer"] is None
    assert 0 < got["decode_roofline"] <= 100
    assert 0 < got["int8_gemm_roofline"] <= 100
    assert got["host_transfer_ms_per_batch.infer"] == pytest.approx(50.0)
    assert got["infer_batch_ms_p95"] == 700.0
    assert 0 < got["mfu.infer"] < 100
    assert 0 < got["mfu.card"] < 100
    assert got["mfu.card"] == pytest.approx(
        got["mfu.infer"] / (900.0 * 0.5e-3))
    assert got["infer_frames_per_s.paced"] == 900.0
    for m in bench["per_layer"]:
        if m["name"].endswith(".paced") and m["name"] != (
                "infer_frames_per_s.paced"):
            base = m["name"].replace(".paced", ".infer")
            if base not in got:
                base = m["name"].replace(".paced", "")
            assert got[m["name"]] == got[base]

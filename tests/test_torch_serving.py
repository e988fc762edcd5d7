"""The port's serving artifact (``infer/serving.py``) and the custom ops it
calls (``dgp_torch::softargmax_likelihood``, ``dgp_torch::mm_tiled``,
``dgp_torch::conv_int8``), against the JAX package's serving export, on
the CPU; and ``utils/profiling.py``.

Tolerances, as ``tests/test_serving.py`` holds the JAX package's artifact:

* float32 artifact (mobilenet_v2_0.35 at 48x64, batch 2): mu and
  likelihood within 1e-5 (``rtol=atol=1e-5``) of JAX's ``infer_forward``
  and of JAX's own loaded artifact on the same weights;
* int8 artifact (ResNet-50, float32 heads and carry): within 1e-4 of the
  live port model it was exported from, which it computes on the same ops
  (here exactly);
* the artifact exported from a snapshot that JAX's ``fit_dlc`` wrote:
  within 1e-5 of JAX's artifact exported from the same snapshot.

The JAX package is imported inside the tests, so that the card's run
(``python -m pytest --noconftest -m cuda tests/test_torch_serving.py``,
where JAX is not installed) collects this file; the ``cuda`` cases hold
the kernels inside a loaded program against the plain versions.
"""

import copy
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from deepgraphpose_tpu_torch.core import checkpoint as ckpt
from deepgraphpose_tpu_torch.core.config import PoseConfig
from deepgraphpose_tpu_torch.infer import serving
from deepgraphpose_tpu_torch.infer.predict import infer_forward
from deepgraphpose_tpu_torch.models.pose_model import PoseModel, init_model
from deepgraphpose_tpu_torch.models.quant import quantize_model
from deepgraphpose_tpu_torch.ops.kernels import int8_gemm_kernel as gemm
from deepgraphpose_tpu_torch.ops.kernels import softargmax_kernel as decode
from deepgraphpose_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]
HW, BATCH = (48, 64), 2
TOL, INT8_TOL = 1e-5, 1e-4
NAMES = ["a", "b", "c"]


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two torch threads while this file runs (the suite runs six files at
    once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    return torch.device("cuda")


def images(seed: int = 0, n: int = BATCH, hw=HW) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 255, (n, *hw, 3),
                                                dtype=np.uint8)


def jax_model(net_type: str):
    """(JAX model, its variables as numpy, the port's PoseModel holding the
    same weights on the CPU)."""
    import jax

    from deepgraphpose_tpu.models.pose_model import \
        init_model as jax_init_model

    cfg = PoseConfig(num_joints=3, net_type=net_type, all_joints_names=NAMES)
    model, variables = jax_init_model(cfg, jax.random.PRNGKey(0), HW)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    port = PoseModel(cfg)
    port.load_state_dict(ckpt.state_dict_from_flax(variables))
    return cfg, model, variables, port.to(memory_format=torch.channels_last
                                          ).eval()


def test_export_roundtrip_matches_jax(tmp_path):
    """tests/test_serving.py:20-44's case: the port's artifact against
    JAX's infer_forward and JAX's loaded artifact, and the same sidecar."""
    import jax.numpy as jnp

    from deepgraphpose_tpu.infer import serving as jax_serving
    from deepgraphpose_tpu.infer.predict import \
        infer_forward as jax_infer_forward

    cfg, model, variables, port = jax_model("mobilenet_v2_0.35")
    jax_art = jax_serving.export_infer_artifact(
        model, cfg, variables, HW, batch_size=BATCH,
        out_path=tmp_path / "pose.stablehlo", platforms=("cpu",))
    art = serving.export_infer_artifact(port, cfg, HW, BATCH,
                                        tmp_path / "pose.pt2")
    assert art.exists() and art.stat().st_size > 1000

    call, meta = serving.load_infer_artifact(art)
    jax_call, jax_meta = jax_serving.load_infer_artifact(jax_art)
    assert meta == jax_meta
    assert meta["input_shape"] == [BATCH, *HW, 3]
    assert meta["platforms"] == ["cpu"] and meta["quantized_int8"] is False

    x = images()
    mu, lik = call(x)
    assert mu.shape == (BATCH, 3, 2) and lik.shape == (BATCH, 3)
    want_mu, want_lik = jax_infer_forward(model, cfg, variables,
                                          jnp.asarray(x))
    art_mu, art_lik = jax_call(x)
    for ref_mu, ref_lik in ((want_mu, want_lik), (art_mu, art_lik)):
        np.testing.assert_allclose(mu.numpy(), np.asarray(ref_mu), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(lik.numpy(), np.asarray(ref_lik),
                                   rtol=TOL, atol=TOL)
    # and the live port model, on the same ops
    live_mu, live_lik = infer_forward(port, cfg, torch.from_numpy(x))
    assert torch.equal(mu, live_mu) and torch.equal(lik, live_lik)


def test_exported_graph_keeps_layout_mean_and_the_decode_op(tmp_path):
    """The program holds the mean-pixel subtraction and the decode as one
    node of the custom op, and every conv of the loaded program reads its
    input in channels_last memory (the NHWC frames viewed as NCHW, as the
    live model runs them), with channels_last weights."""
    cfg = PoseConfig(num_joints=3, net_type="mobilenet_v2_0.35",
                     all_joints_names=NAMES)
    model = init_model(cfg, device="cpu")
    art = serving.export_infer_artifact(model, cfg, HW, BATCH,
                                        tmp_path / "pose.pt2")
    program = torch.export.load(art)
    assert program.example_inputs is None   # no batch of frames inside
    nodes = [n for n in program.graph.nodes if n.op == "call_function"]
    targets = [str(n.target) for n in nodes]
    assert targets.count("dgp_torch.softargmax_likelihood.default") == 1
    buffers = program.graph_signature.inputs_to_buffers
    mean = next(k for k, v in buffers.items() if v == "model.mean_pixel")
    subs = [n for n in nodes if str(n.target) == "aten.sub.Tensor"
            and any(getattr(a, "name", None) == mean for a in n.args)]
    assert len(subs) == 1
    # a non-persistent buffer: a constant of the program
    assert torch.equal(program.constants["model.mean_pixel"],
                       torch.tensor(cfg.mean_pixel))
    stem = program.state_dict["model.backbone.conv_stem.weight"]
    assert stem.is_contiguous(memory_format=torch.channels_last)

    layouts = []

    class Recorder(torch.fx.Interpreter):
        def call_function(self, target, args, kwargs):
            if target is torch.ops.aten.conv2d.default:
                layouts.append(args[0].is_contiguous(
                    memory_format=torch.channels_last)
                    and not args[0].is_contiguous())
            return super().call_function(target, args, kwargs)

    Recorder(program.module()).run(torch.from_numpy(images()))
    assert len(layouts) == 52 and all(layouts)


@pytest.mark.parametrize("residual", [False, True],
                         ids=["int8", "residual_int8"])
def test_export_int8_matches_live_model(tmp_path, residual):
    """tests/test_serving.py:88-140's cases: the int8 ResNet-50 exported
    with float32 heads and carry against the live model, the sidecar's
    flags, and every conv a node of a GEMM op."""
    cfg = PoseConfig(num_joints=3, net_type="resnet_50",
                     all_joints_names=NAMES)
    model = init_model(cfg, device="cpu")
    calib = images(1).astype(np.float32)
    qmodel = quantize_model(cfg, model, calib, dtype=torch.float32,
                            carry_dtype=torch.float32, residual_int8=residual)
    art = serving.export_infer_artifact(qmodel, cfg, HW, BATCH,
                                        tmp_path / "pose_int8.pt2")
    call, meta = serving.load_infer_artifact(art)
    assert meta["quantized_int8"] is True
    assert meta["residual_int8"] is residual

    x = images(2)
    mu, lik = call(x)
    want_mu, want_lik = infer_forward(qmodel, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(mu.numpy(), want_mu.numpy(), rtol=INT8_TOL,
                               atol=INT8_TOL)
    np.testing.assert_allclose(lik.numpy(), want_lik.numpy(), rtol=INT8_TOL,
                               atol=INT8_TOL)
    program = torch.export.load(art)
    targets = [str(n.target) for n in program.graph.nodes]
    # ResNet-50: 17 convs on conv_int8 (stem, 3x3s, strided shortcuts),
    # 36 1x1 stride-1 convs on mm_tiled
    assert targets.count("dgp_torch.conv_int8.default") == 17
    assert targets.count("dgp_torch.mm_tiled.default") == 36


def jax_fit_project(root: Path) -> Path:
    """tests/test_serving.py's project: synthetic, 48x64, mobilenet_v2_0.35,
    with the step-0 final snapshot of JAX's fit_dlc."""
    from deepgraphpose_tpu.train.fit import fit_dlc as jax_fit_dlc
    from deepgraphpose_tpu.utils.synthetic import make_synthetic_project

    make_synthetic_project(str(root), n_frames=10, n_labeled=3, hw=HW)
    cfg_path = Path(root, "dlc-models/iteration-0/"
                    "SynthJan1-trainset95shuffle1", "train", "pose_cfg.yaml")
    raw = yaml.safe_load(cfg_path.read_text())
    raw["net_type"] = "mobilenet_v2_0.35"
    cfg_path.write_text(yaml.safe_dump(raw))
    jax_fit_dlc(dlcpath=str(root), maxiters=2, displayiters=1, saveiters=100,
                bn_train=False, jitter=False)
    return root


def test_export_from_jax_snapshot(tmp_path):
    """export_from_snapshot on the snapshot JAX's fit_dlc wrote, against
    JAX's artifact from it; then the missing snapshot raises
    FileNotFoundError (tests/test_serving.py:47-85)."""
    from deepgraphpose_tpu.infer import serving as jax_serving

    root = jax_fit_project(tmp_path / "proj")
    config = root / "config.yaml"
    jax_art = jax_serving.export_from_snapshot(
        config, "snapshot-step0-final--0", tmp_path / "model.stablehlo",
        batch_size=BATCH, platforms=("cpu",))
    art = serving.export_from_snapshot(config, "snapshot-step0-final--0",
                                       tmp_path / "model.pt2",
                                       batch_size=BATCH, device="cpu")
    call, meta = serving.load_infer_artifact(art)
    jax_call, jax_meta = jax_serving.load_infer_artifact(jax_art)
    assert meta == jax_meta
    x = images(3)
    mu, lik = call(x)
    want_mu, want_lik = jax_call(x)
    assert np.isfinite(mu.numpy()).all()
    np.testing.assert_allclose(mu.numpy(), np.asarray(want_mu), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(lik.numpy(), np.asarray(want_lik), rtol=TOL,
                               atol=TOL)
    with pytest.raises(FileNotFoundError):
        serving.export_from_snapshot(config, "snapshot-step9-final--0",
                                     tmp_path / "x.pt2", batch_size=1,
                                     in_hw=HW, device="cpu")


def test_export_refuses_other_platforms(tmp_path):
    cfg = PoseConfig(num_joints=3, net_type="mobilenet_v2_0.35")
    model = init_model(cfg, device="cpu")
    for platforms in (("cuda",), ("tpu", "cpu"), ("cpu", "cuda")):
        with pytest.raises(ValueError, match="exported on"):
            serving.export_infer_artifact(model, cfg, HW, 1,
                                          tmp_path / "x.pt2", platforms)
    assert not (tmp_path / "x.pt2").exists()


def _decode_args():
    pred = torch.from_numpy(np.random.default_rng(4).normal(
        0, 2, (2, 6, 8, 3)).astype(np.float32))
    return (pred, 1.0, 2.0, 1.0)


def _conv_args(k: int, stride: int, out_mode: int):
    rng = np.random.default_rng(5)
    cin, n = 16, 24
    x = torch.from_numpy(rng.integers(-127, 128, (2, 9, 11, cin),
                                      dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (n, k * k * cin),
                                      dtype=np.int8))
    oscale = torch.from_numpy(rng.uniform(1e-4, 1e-3, n).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 1, n).astype(np.float32))
    return x, w, oscale, bias


@pytest.mark.parametrize("case", ["decode", "mm_int8", "mm_bf16",
                                  "mm_quantize_on_load", "conv_raw",
                                  "conv_bf16", "conv_int8_out"])
def test_ops_opcheck(case):
    """torch.library.opcheck on the CPU: each op's schema, its fake
    implementation against its CPU implementation, and its dispatch."""
    if case == "decode":
        torch.library.opcheck(decode.OP, _decode_args())
        return
    x, w, oscale, bias = _conv_args(3, 2, 1)
    if case == "mm_int8":
        args = (x.reshape(-1, 16), w[:, :16].contiguous(), oscale, bias,
                1, gemm.OUT_F32, 0.0, None)
    elif case == "mm_bf16":
        a = torch.randn(18, 16, generator=torch.Generator().manual_seed(0))
        args = (a.bfloat16(), a[:7].bfloat16(), None, None, 0, gemm.OUT_RAW,
                0.0, None)
    elif case == "mm_quantize_on_load":
        a = torch.randn(18, 16, generator=torch.Generator().manual_seed(1))
        args = (a, w[:, :16].contiguous(), oscale, bias, gemm.RELU6,
                gemm.OUT_INT8, 0.05, 0.02)
    else:
        mode = {"conv_raw": gemm.OUT_RAW, "conv_bf16": gemm.OUT_BF16,
                "conv_int8_out": gemm.OUT_INT8}[case]
        args = (x, w, oscale if mode else None, bias if mode else None, 3,
                2, 1, 1, 2, 0, 1, 1, mode, 0.05)
        torch.library.opcheck(gemm.CONV_OP, args)
        return
    torch.library.opcheck(gemm.MM_OP, args)


def test_ops_cpu_implementation_is_the_plain_version():
    """On CPU tensors each op runs its plain version (no launch): the
    decode op equals ops/softargmax.py, the GEMM ops ops/int8_gemm.py."""
    from deepgraphpose_tpu_torch.ops import int8_gemm, softargmax

    before = (decode.launches, dict(gemm.launches))
    args = _decode_args()
    got = decode.OP(*args)
    want = softargmax.softargmax_likelihood(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    x, w, oscale, bias = _conv_args(3, 2, 1)
    got = gemm.CONV_OP(x, w, oscale, bias, 3, 2, 1, 1, 2, 0, 1, 1,
                       gemm.OUT_F32, 0.0)
    want = int8_gemm.conv_int8(x, w.t(), 3, 2, 1, ((1, 2), (0, 1)), oscale,
                               bias, 1, torch.float32)
    assert torch.equal(got, want)
    assert (decode.launches, gemm.launches) == before


def test_fresh_process_loads_and_runs_an_artifact(tmp_path):
    """A process that imports only infer.serving, with jax, flax, optax and
    the JAX package blocked, loads the artifact and runs it; its result
    equals this process's."""
    cfg = PoseConfig(num_joints=3, net_type="mobilenet_v2_0.35",
                     all_joints_names=NAMES)
    model = init_model(cfg, device="cpu")
    art = serving.export_infer_artifact(model, cfg, HW, BATCH,
                                        tmp_path / "pose.pt2")
    x = images(6)
    np.save(tmp_path / "x.npy", x)
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'optax', 'deepgraphpose_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(2)\n"
        "from deepgraphpose_tpu_torch.infer.serving import "
        "load_infer_artifact\n"
        f"call, meta = load_infer_artifact({str(art)!r})\n"
        f"mu, lik = call(np.load({str(tmp_path / 'x.npy')!r}))\n"
        f"np.save({str(tmp_path / 'mu.npy')!r}, mu.numpy())\n"
        f"np.save({str(tmp_path / 'lik.npy')!r}, lik.numpy())\n"
        "print(sorted(m for m in sys.modules if m.startswith('deepgraph')))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    call, _ = serving.load_infer_artifact(art)
    mu, lik = call(x)
    assert np.array_equal(np.load(tmp_path / "mu.npy"), mu.numpy())
    assert np.array_equal(np.load(tmp_path / "lik.npy"), lik.numpy())


NEW_MODULES = ("infer.serving", "train.headonly", "infer.video_writer",
               "infer.plotting", "evaluation.maps", "utils.profiling",
               "data.video")


def test_new_modules_import_without_jax():
    """This slice's modules import where jax, flax, optax and the JAX
    package cannot be imported (tests/test_torch_port.py walks every
    module; this names the new ones)."""
    names = [f"deepgraphpose_tpu_torch.{m}" for m in NEW_MODULES]
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'optax', 'deepgraphpose_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_trace_writes_a_chrome_trace(tmp_path, capsys):
    """utils/profiling.trace around a served batch writes a Chrome trace
    that names the decode op; device_memory_stats lists the CPU here."""
    cfg = PoseConfig(num_joints=3, net_type="mobilenet_v2_0.35")
    model = init_model(cfg, device="cpu")
    art = serving.export_infer_artifact(model, cfg, HW, 1,
                                        tmp_path / "pose.pt2")
    call, _ = serving.load_infer_artifact(art)
    with profiling.trace(tmp_path / "tb"):
        call(images(7, n=1))
    (path,) = (tmp_path / "tb").glob("trace-*.json")
    assert f"trace written to {path}" in capsys.readouterr().out
    events = json.loads(path.read_text())["traceEvents"]
    assert any("softargmax_likelihood" in e.get("name", "") for e in events)
    # a second profiler cannot start inside the first: the block still runs
    ran = []
    with profiling.trace(tmp_path / "outer"):
        with pytest.warns(UserWarning, match="could not start trace"):
            with profiling.trace(tmp_path / "inner"):
                ran.append(1)
    assert ran == [1] and not (tmp_path / "inner").exists()
    assert profiling.device_memory_stats() == [{"device": "cpu"}]


@pytest.mark.cuda
def test_exported_kernels_match_plain_on_card(cuda_device, tmp_path):
    """On the card a loaded program launches the decode kernel (and, int8,
    mm_tiled and conv_int8). The float32 artifact's decode against the
    plain decode in float64 of the same model's logits on the card (TF32
    off): mu within 1e-4 cells, likelihood within 1e-5 of the plain 2x2
    read at the kernel's cell, as the kernel's own card tests hold it. The
    int8 artifact (float32 heads and carry) against the same int8 model
    exported on the CPU (the plain versions): its int32 sums are the
    kernel's exactly, the float32 epilogue and heads round elsewhere (mu
    within 1e-3 cells, likelihood within 1e-4)."""
    from deepgraphpose_tpu_torch.infer.predict import forward_heads
    from deepgraphpose_tpu_torch.ops import softargmax as plain

    cfg = PoseConfig(num_joints=3, net_type="resnet_50",
                     all_joints_names=NAMES)
    x = images(8, n=4, hw=(96, 112))
    model = init_model(cfg, device="cpu")
    qmodel = quantize_model(cfg, model, images(9, n=2, hw=(96, 112)),
                            dtype=torch.float32, carry_dtype=torch.float32)
    outs = {}
    for name, m in (("f32", model), ("int8", qmodel)):
        for where, on in (("cpu", m), ("cuda", copy.deepcopy(m).to(
                cuda_device))):
            art = serving.export_infer_artifact(
                on, cfg, (96, 112), 4, tmp_path / f"{name}_{where}.pt2")
            call, meta = serving.load_infer_artifact(art)
            assert meta["platforms"] == [where]
            before = (decode.launches, dict(gemm.launches))
            mu, lik = call(x)
            outs[name, where] = (mu.cpu(), lik.cpu())
            moved = {k: gemm.launches[k] - before[1][k]
                     for k in gemm.launches}
            if where == "cpu":
                assert decode.launches == before[0]
                assert moved == {"mm_tiled": 0, "conv_int8": 0}
            else:
                assert decode.launches == before[0] + 1
                assert moved == ({"mm_tiled": 36, "conv_int8": 17}
                                 if name == "int8"
                                 else {"mm_tiled": 0, "conv_int8": 0})
            if name == "f32" and where == "cuda":
                pred = forward_heads(on, torch.from_numpy(x).to(
                    cuda_device))["part_pred"]
                want, _ = plain.softargmax_2d(pred.double(), gamma=cfg.gamma,
                                              gauss_len=cfg.gauss_len)
                mu_card = mu.to(cuda_device)
                assert (mu_card.double() - want).abs().max().item() <= 1e-4
                want_lik = plain.max_sigmoid_2x2(pred, mu_card)
                assert (lik - want_lik).abs().max().item() <= 1e-5
    (mu_c, lik_c), (mu_g, lik_g) = outs["int8", "cpu"], outs["int8", "cuda"]
    assert (mu_g - mu_c).abs().max().item() <= 1e-3
    assert (lik_g - lik_c).abs().max().item() <= 1e-4

"""Port hygiene, and the CUDA kernel against its plain version on the card.

* Every module of ``deepgraphpose_tpu_torch`` imports in a process where
  ``jax``, ``flax``, ``optax`` and ``deepgraphpose_tpu`` cannot be
  imported, nor ``click``, ``sklearn``, ``h5py``, ``matplotlib`` and
  ``tensorstore`` (the card's host has none of them), and no source of the port (nor
  ``chip_smoke.py``) names the first four or ``click``.
* Tests marked ``cuda`` need an NVIDIA GPU. Whether one exists is decided
  inside the ``cuda_device`` fixture, so every pytest worker collects the
  same tests; without a card they skip. Run them on the card with
  ``python -m pytest -m cuda tests/``.
"""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import deepgraphpose_tpu_torch
from deepgraphpose_tpu_torch.core.config import PoseConfig
from deepgraphpose_tpu_torch.models.pose_model import scoremap_size
from deepgraphpose_tpu_torch.ops import softargmax as plain
from deepgraphpose_tpu_torch.ops.kernels import softargmax_kernel as kernel

REPO = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "flax", "optax", "deepgraphpose_tpu")
# absent on the card's host: imported only inside the functions that need
# them, which raise ImportError there
OPTIONAL = ("click", "sklearn", "h5py", "matplotlib", "tensorstore")
# the part_pred maps of the main path: ResNet-50 at 747x832 full frame and
# at the tracked crop's (408, 448) window, batch 128, 5 joints
_CFG = PoseConfig(net_type="resnet_50", num_joints=5)
FULL_MAPS = (128, *scoremap_size(_CFG, (747, 832)), 5)
CROP_MAPS = (128, *scoremap_size(_CFG, (408, 448)), 5)
# output_stride 8's full frame, 16 frames
STRIDE8_MAPS = (16, *scoremap_size(
    PoseConfig(net_type="resnet_50", num_joints=5, output_stride=8),
    (747, 832)), 5)


def port_modules():
    pkg = deepgraphpose_tpu_torch
    return [pkg.__name__] + [
        m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        f"for name in {BLOCKED + OPTIONAL!r}:\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for name in {port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "print('ok', len(sys.modules))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")
    assert len(port_modules()) >= 20
    assert {"deepgraphpose_tpu_torch.ops.flow_device",
            "deepgraphpose_tpu_torch.ops.decode",
            "deepgraphpose_tpu_torch.infer.analyze",
            "deepgraphpose_tpu_torch.evaluation.metrics",
            "deepgraphpose_tpu_torch.evaluation.filtering",
            "deepgraphpose_tpu_torch.evaluation.outliers",
            "deepgraphpose_tpu_torch.evaluation.skeleton",
            "deepgraphpose_tpu_torch.parallel.mesh",
            "deepgraphpose_tpu_torch.parallel.distributed",
            "deepgraphpose_tpu_torch.parallel.train_dp",
            "deepgraphpose_tpu_torch.parallel.streaming",
            "deepgraphpose_tpu_torch.cli",
            "deepgraphpose_tpu_torch.compat",
            "deepgraphpose_tpu_torch.utils.experiments",
            "deepgraphpose_tpu_torch.utils.compile_cache",
            "deepgraphpose_tpu_torch.native",
            *(f"deepgraphpose_tpu_torch.project.{m}" for m in (
                "conversion", "crop_select", "extract", "hygiene",
                "label_server", "multi_individual", "new", "refine",
                "training_dataset")),
            *(f"deepgraphpose_tpu_torch.threed.{m}" for m in (
                "calibration", "plotting3d", "triangulation"))} <= set(
                port_modules())


def test_port_imports_without_tensorflow():
    """TensorFlow is read only inside ``models/tf_import.py``'s checkpoint
    reader: every port module imports where it cannot be."""
    code = (
        "import sys\n"
        "sys.modules['tensorflow'] = None\n"
        "import importlib\n"
        f"for name in {port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_port_sources_name_no_jax():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|flax|optax|click|deepgraphpose_tpu)"
        r"(\.|\s|$)",
        re.M)
    files = list((REPO / "deepgraphpose_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    for path in files:
        assert not pattern.search(path.read_text()), path


def test_kernel_source_is_in_the_package():
    from deepgraphpose_tpu_torch.ops.kernels import build

    assert {"softargmax", "int8_gemm"} <= set(build.sources())
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert build.BUILD_DIR == REPO / "build" / "kernels"


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    return torch.device("cuda")


def check_against_plain(x: torch.Tensor, gamma: float, gauss_len: float,
                        layout=None):
    """Kernel vs plain on the same device: mu within 1e-4 cells of the
    plain version evaluated in float64 on the same logits (in float32 the
    plain version rounds gamma * x itself, up to 9e-5 cells from float64
    on 186 x 208 maps of noise at gamma 2.5); lik within 1e-5 of the plain
    2x2 read at the kernel's own cell (where mu sits within 1e-4 of an
    integer the two may pick neighbouring cells)."""
    before = kernel.launches
    mu_k, lik_k = kernel.softargmax_likelihood(x, gamma, gauss_len,
                                               layout=layout)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    mu_p, _ = plain.softargmax_2d(x.double(), gamma=gamma,
                                  gauss_len=gauss_len)
    err_mu = (mu_k.double() - mu_p).abs().max().item()
    del mu_p
    lik_ref = plain.max_sigmoid_2x2(x, mu_k)
    err_lik = (lik_k - lik_ref).abs().max().item()
    assert err_mu <= 1e-4 and err_lik <= 1e-5, (err_mu, err_lik)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    FULL_MAPS, CROP_MAPS, (3, 23, 31, 4),
    (2, 23, 31, 7),                 # H*W*C odd: frames start unaligned
    (1, *FULL_MAPS[1:]),            # one frame
    (8, *FULL_MAPS[1:3], 1), (4, *CROP_MAPS[1:3], 33),
    (2, 8, 8, 2000),                # joints split over four CTAs a frame
    STRIDE8_MAPS,                   # a frame larger than the ring
    # many joints on large maps: each consumer sums thousands of logits
    (128, *FULL_MAPS[1:3], 300), (128, *STRIDE8_MAPS[1:3], 40),
    # the DGP training steps' decode: step 2's 11 frames, step 1's 2
    (11, *FULL_MAPS[1:]), (2, *FULL_MAPS[1:])])
@pytest.mark.parametrize("gauss_len", [0.0, 1.0, 2.0])
@pytest.mark.parametrize("gamma", [1.0, 2.5])
def test_kernel_matches_plain(cuda_device, shape, gauss_len, gamma):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    check_against_plain(torch.from_numpy(x * 3).to(cuda_device), gamma,
                        gauss_len)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [FULL_MAPS, (2, 23, 31, 7), (3, 9, 13, 1)])
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_kernel_takes_a_storage_offset(cuda_device, shape, offset):
    """A contiguous view that starts 4, 8 or 12 bytes past its storage:
    every chunk's aligned body moves, and its head and tail change."""
    n = int(np.prod(shape))
    x = np.random.default_rng(3).standard_normal(n + offset).astype(
        np.float32)
    store = torch.from_numpy(x * 3).to(cuda_device)
    check_against_plain(store[offset:].view(shape), 2.5, 2.0)


# (cluster, pixel rows of threads, stages, steps); rows "W" is the map's
# width, a column layout. 6 rows of 5 joints is a CTA of less than a warp.
# (One row at the full-frame maps sums 9776 terms in one thread, and its
# float32 rounding then reaches 2.6e-4 cells.)
LAYOUTS = [(1, 6, 1, 4), (2, 64, 2, 8), (4, "W", 3, 8), (8, 70, 4, 4),
           (8, "W", 8, 4), (2, 37, 5, 8), (1, "W", 2, 16), (2, 75, 3, 16)]


def layout_for(shape, spec):
    cluster, rows, stages, steps = spec
    threads = shape[3] * (shape[2] if rows == "W" else rows)
    return kernel.Layout(cluster, threads, stages, steps)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [FULL_MAPS, CROP_MAPS, (2, 9, 13, 7)])
@pytest.mark.parametrize("layout", LAYOUTS, ids=str)
def test_kernel_layouts_match_plain(cuda_device, shape, layout):
    """Every layout computes the same decode: clusters of 1 to 8 CTAs a
    frame, rings of 1 to 8 slots, column and general thread layouts, and
    CTAs with more threads than pixels."""
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    check_against_plain(torch.from_numpy(x * 3).to(cuda_device), 2.5, 2.0,
                        layout_for(shape, layout))


@pytest.mark.cuda
def test_kernel_gradient_is_plain_gradient(cuda_device):
    x = np.random.default_rng(1).standard_normal((2, 10, 14, 3))
    s = torch.tensor(x, dtype=torch.float32, device=cuda_device,
                     requires_grad=True)
    kernel.softargmax_2d_cuda(s, 1.0, 1.0).square().sum().backward()
    s2 = s.detach().clone().requires_grad_(True)
    plain.softargmax_2d(s2, gamma=1.0, gauss_len=1.0)[0].square().sum(
    ).backward()
    torch.testing.assert_close(s.grad, s2.grad, rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(11, *FULL_MAPS[1:]), (2, *FULL_MAPS[1:])])
def test_kernel_gradient_at_training_maps(cuda_device, shape):
    """The DGP objective's decode (steps 2 and 1): the gradient through the
    kernel path (kernel forward, plain recompute backward) is the plain
    path's, and the forward launches the kernel once."""
    x = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    s = torch.tensor(x * 3, device=cuda_device, requires_grad=True)
    weights = torch.randn(shape[0], shape[3], 2, device=cuda_device)
    before = kernel.launches
    (kernel.softargmax_2d_cuda(s, 1.0, 1.0) * weights).sum().backward()
    assert kernel.launches == before + 1
    s2 = s.detach().clone().requires_grad_(True)
    (plain.softargmax_2d(s2, gamma=1.0, gauss_len=1.0)[0] * weights).sum(
    ).backward()
    assert kernel.launches == before + 1
    err = (s.grad - s2.grad).abs().max().item()
    assert err <= 1e-6 * s2.grad.abs().max().item()


@pytest.fixture
def tiny_resnet(monkeypatch):
    """A ResNet-v1 with one unit per block."""
    from deepgraphpose_tpu_torch.models import resnet

    monkeypatch.setitem(resnet.BLOCK_UNITS, "resnet_tiny", (1, 1, 1, 1))
    return "resnet_tiny"


def smoke_helpers():
    """``chip_smoke.py``'s step-parity helpers, shared with this test."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    return chip_smoke


@pytest.mark.cuda
@pytest.mark.parametrize("bn_train", [False, True])
def test_dgp_step_on_card_matches_cpu(cuda_device, tiny_resnet, bn_train):
    """One step-2 update (limb clique, wt > 0) from one conditioned init
    and batch, held by ``chip_smoke.step_parity``: the card against the
    CPU in float64 (parameters within 1e-5, momentum traces within 1e-4
    of each tensor's largest value) and in float32 (loss terms within 1e-5
    relative; with frozen batch-norm parameters within 1e-5 and traces
    within 2e-3 of the CPU's float64 step); the card's objective launched
    the decode kernel once a step."""
    from deepgraphpose_tpu_torch.models.pose_model import PoseModel
    from deepgraphpose_tpu_torch.ops.dgp_objective import DGPLossParams

    smoke = smoke_helpers()
    cfg = PoseConfig(net_type=tiny_resnet, num_joints=3)
    hw = (64, 80)
    h, w = scoremap_size(cfg, hw)
    rng = np.random.default_rng(5)
    images = torch.from_numpy(rng.integers(0, 256, (4, *hw, 3),
                                           dtype=np.uint8))
    vis = np.zeros((4, 3), np.float32)
    vis[0] = vis[2] = 1.0
    batch = {
        "targets": torch.from_numpy(rng.uniform(1, min(h, w) - 2, (4, 3, 2)
                                                ).astype(np.float32)),
        "visible_mask": torch.from_numpy(vis.ravel()),
        "hidden_mask": torch.from_numpy(1.0 - vis.ravel()),
        "frame_mask": torch.ones(4),
        "wt_batch": torch.full((3,), 1.5),
        "pair_mask": torch.ones(3),
        "flow": torch.from_numpy(rng.uniform(0.1, 2, (3, *hw)).astype(
            np.float32)),
    }
    params = DGPLossParams(
        nj=3, stride=8.0, gamma=1.0, gauss_len=1.0, lengthscale=1.0,
        pos_dist_thresh=17.0, locref_stdev=7.2801, locref_loss_weight=0.05,
        locref_huber_loss=True, wn_visible=5.0, wn_hidden=3.0, wt=1.5,
        wt_max=0.0, gm2=0, gm3=0, n_visible_frames_total=6.0,
        n_hidden_frames_total=30.0,
        S0=np.array([[1.0, -1.0, 0.0]], np.float32),
        ws=np.array([0.05], np.float32), ws_max=np.array([40.0], np.float32))
    init = smoke.conditioned_init(cfg, 0)

    def model(dtype, device):
        m = PoseModel(cfg, dtype=dtype).to(dtype)
        m.load_state_dict(init)
        return m.to(device)

    errors, ok = smoke.step_parity(model, params, images, batch, bn_train,
                                   0.05, cuda_device)
    assert ok, errors


def tied_heads(dtype, seed: int = 0):
    """part_pred and locref heads at the full-frame maps whose scores
    tie: float32 logits on a 0.5 grid with a saturated band, or bfloat16
    logits of 4-12, whose sigmoid rounds mostly to 1."""
    rng = np.random.default_rng(seed)
    b, h, w, nj = FULL_MAPS
    if dtype == torch.bfloat16:
        logits = rng.integers(4, 13, (b, h, w, nj)).astype(np.float32)
    else:
        logits = np.round(rng.uniform(-3, 3, (b, h, w, nj)) * 2) / 2
        logits[:, 40:50] = 30.0
    locref = rng.standard_normal((b, h, w, 2 * nj)).astype(np.float32)
    return (torch.from_numpy(logits.astype(np.float32)).to(dtype),
            torch.from_numpy(locref).to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_top_k_decode_on_card_matches_cpu(cuda_device, dtype):
    """The DLC decodes (``ops/decode.py``) on the card against the same
    code on the CPU, on maps full of ties at the full-frame shape: the
    top-k locations and the argmax equal (the lower flat index first
    among ties), the decoded values within 1e-5. The sigmoid maps agree
    within 2.4e-7 (two float32 steps below 1: the card's and the CPU's
    exp may round apart; equal values stay equal on each side, so the
    ties and the order are the same)."""
    from deepgraphpose_tpu_torch.ops import decode

    part, locref = tied_heads(dtype)
    card = [t.to(cuda_device) for t in (part, locref)]
    scmap, _ = decode.extract_cnn_output(part, locref)
    scmap_card, _ = decode.extract_cnn_output(*card)
    assert (scmap_card.cpu().float() - scmap.float()).abs().max() <= 2.4e-7
    for got, want in zip(decode.get_top_values(scmap_card, 8),
                         decode.get_top_values(scmap, 8)):
        assert torch.equal(got.cpu(), want)
    for fn, kw in ((decode.argmax_pose_decode, {}),
                   (decode.multi_pose_decode, {"num_outputs": 8})):
        got, want = fn(*card, **kw).cpu(), fn(part, locref, **kw)
        assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.cuda
def test_abs_percentile_on_card_matches_cpu(cuda_device):
    """``quantize_model(calib_percentile=)``'s statistic at the size of
    ResNet-50's widest calibration site at 747x832 (8 frames of 374 x 416
    x 64, above torch.quantile's 2^24 elements): the card's order
    statistics equal the CPU's, so the values agree to float32 rounding."""
    from deepgraphpose_tpu_torch.models.quant import abs_percentile

    x = torch.randn(8, 374, 416, 64,
                    generator=torch.Generator().manual_seed(0))
    for q in (99.0, 99.9, 99.99):
        want = abs_percentile(x, q).item()
        got = abs_percentile(x.to(cuda_device), q).item()
        assert abs(got - want) <= 1e-6 * want, (q, got, want)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    x = torch.zeros(2, 8, 8, 3, device=cuda_device)
    with pytest.raises(TypeError):
        kernel.softargmax_likelihood(x.half(), 1.0, 1.0)
    with pytest.raises(ValueError):
        kernel.softargmax_likelihood(x.permute(0, 2, 1, 3), 1.0, 1.0)
    # a launch the kernel refuses raises; it does not fall back
    before = kernel.launches
    for bad in (kernel.Layout(3, 3, 1, 4),     # cluster of 3
                kernel.Layout(2, 3, 9, 4),     # 9 stages
                kernel.Layout(2, 4, 1, 4)):    # not a multiple of C
        with pytest.raises(RuntimeError):
            kernel.softargmax_likelihood(x, 1.0, 1.0, layout=bad)
    assert kernel.launches == before


# --------------------------------------------------------------------------
# the int8 GEMM kernel (csrc/int8_gemm.cu) on the card
# --------------------------------------------------------------------------

# (k, Cin, Cout, stride, rate) at odd sizes: the ResNet-50 site kinds, and
# channel counts that take the scalar (unaligned) load and store paths;
# K = 576 and 4608 (3x3 over 64 and 512 channels) at N = 64: a half-empty
# last K tile, a K that wraps the ring of 128-byte tiles several times, and
# half-empty 128-wide N tiles
GEMM_SITES = [(7, 3, 64, 2, 1), (1, 64, 32, 1, 1), (3, 32, 32, 2, 1),
              (3, 32, 48, 1, 2), (1, 64, 128, 2, 1), (3, 20, 29, 1, 1),
              (1, 24, 40, 1, 1), (3, 64, 64, 1, 1), (3, 512, 64, 1, 2)]


def _forbid_plain(monkeypatch):
    """A CUDA tensor must launch the kernel: the plain versions raise."""
    from deepgraphpose_tpu_torch.ops.kernels import int8_gemm_kernel

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(int8_gemm_kernel.plain, "mm", refuse)
    monkeypatch.setattr(int8_gemm_kernel.plain, "conv_int8", refuse)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(37, 50, 29), (128, 128, 128),
                                   (300, 147, 64), (1000, 256, 520),
                                   (200, 64, 64), (130, 576, 72),
                                   (129, 200, 136), (257, 4608, 136)])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_mm_tiled_matches_plain(cuda_device, monkeypatch, shape, dtype):
    """int8 -> int32 exactly; bf16 -> f32 within 1e-5 of the largest |value|
    (the kernel sums float32 products in float32, the plain version in
    float64). (M, K, N): M tails (M % 128), K = 64, 147, 200 and 576 (a
    half-empty last K tile; K % 64 != 0 for bf16), K = 4608 (the ring
    wraps), N = 64 and N % 8 != 0 (the scalar store)."""
    from deepgraphpose_tpu_torch.ops import int8_gemm as gemm_plain
    from deepgraphpose_tpu_torch.ops.kernels import int8_gemm_kernel as gk

    m, k, n = shape
    rng = np.random.default_rng(0)
    if dtype == torch.int8:
        a = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8))
        b = torch.from_numpy(rng.integers(-127, 128, (k, n), dtype=np.int8))
    else:
        a = torch.from_numpy(rng.standard_normal((m, k), np.float32)).to(dtype)
        b = torch.from_numpy(rng.standard_normal((k, n), np.float32)).to(dtype)
    a, b = a.to(cuda_device), b.to(cuda_device)
    want = gemm_plain.mm(a, b)
    _forbid_plain(monkeypatch)
    before = gk.launches["mm_tiled"]
    got = gk.mm(a, b)
    torch.cuda.synchronize()
    assert gk.launches["mm_tiled"] == before + 1
    assert got.dtype == want.dtype and got.shape == want.shape
    if dtype == torch.int8:
        assert torch.equal(got, want)
    else:
        assert ((got - want).abs().max() <= 1e-5 * want.abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["identity_b", "identity_a", "random"])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_mm_tiled_one_tile(cuda_device, monkeypatch, pattern, dtype):
    """One 128x128x128 product, one block and one K tile: the shared-memory
    swizzle and the wgmma descriptors alone. With B (or A) the identity
    the product is the other operand itself, so a wrong layout shows as
    moved values; B is passed as the (N, K) copy the kernel reads."""
    from deepgraphpose_tpu_torch.ops import int8_gemm as gemm_plain
    from deepgraphpose_tpu_torch.ops.kernels import int8_gemm_kernel as gk

    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.integers(-100, 100, (128, 128), dtype=np.int8))
    b = torch.from_numpy(rng.integers(-100, 100, (128, 128), dtype=np.int8))
    eye = torch.eye(128, dtype=torch.int8)
    if pattern == "identity_b":
        b = eye
    elif pattern == "identity_a":
        a = eye
    a, b = a.to(cuda_device, dtype), b.to(cuda_device, dtype)
    want = gemm_plain.mm(a, b)
    _forbid_plain(monkeypatch)
    got = gk.mm(a, b, b_nk=b.t().contiguous())
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("site", GEMM_SITES)
def test_conv_int8_matches_plain(cuda_device, monkeypatch, site):
    """Every output mode against the plain version on the card: int32
    exactly; f32 within 1 ulp (both round the multiply-add once; the plain
    float64 route can round twice, about once in 2^29); bf16 within 1 bf16
    ulp; int8 within 1 on at most 1e-4 of the elements."""
    from deepgraphpose_tpu_torch.models.quant import _pad_for
    from deepgraphpose_tpu_torch.ops import int8_gemm as gemm_plain
    from deepgraphpose_tpu_torch.ops.kernels import int8_gemm_kernel as gk

    k, cin, cout, stride, rate = site
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.integers(-127, 128, (3, 21, 26, cin),
                                      dtype=np.int8)).to(cuda_device)
    w = torch.from_numpy(rng.integers(-127, 128, (k * k * cin, cout),
                                      dtype=np.int8)).to(cuda_device)
    acc_max = 127 * 127 * k * k * cin
    oscale = torch.from_numpy(rng.uniform(0.2, 1.0, cout).astype(
        np.float32) / np.float32(acc_max / 8)).to(cuda_device)
    bias = torch.from_numpy(rng.standard_normal(cout).astype(
        np.float32) * 0.1).to(cuda_device)
    args = (x, w, k, stride, rate, _pad_for(k, stride, rate), oscale, bias)
    outs = [torch.int32, torch.float32, torch.bfloat16, ("int8", 1 / 127)]
    wants = {str(o): [gemm_plain.conv_int8(*args, relu, o)
                      for relu in (False, True)] for o in outs}
    _forbid_plain(monkeypatch)
    launches = dict(gk.launches)
    for o in outs:
        for relu, want in zip((False, True), wants[str(o)]):
            got = gk.conv_int8(*args, relu, o)
            torch.cuda.synchronize()
            assert got.shape == want.shape and got.dtype == want.dtype
            if o == torch.int32:
                assert torch.equal(got, want)
            elif o == torch.float32:
                ulp = torch.from_numpy(np.spacing(
                    want.abs().cpu().numpy())).to(cuda_device)
                assert ((got - want).abs() <= ulp).all().item()
            elif o == torch.bfloat16:
                err = (got.float() - want.float()).abs()
                assert (err <= want.float().abs() * 2.0 ** -7).all().item()
            else:
                diff = (got.int() - want.int()).abs()
                assert diff.max().item() <= 1
                assert (diff != 0).float().mean().item() <= 1e-4
    name = "mm_tiled" if (k == 1 and stride == 1) else "conv_int8"
    assert gk.launches[name] == launches[name] + 8


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(64, 32), (24, 40), (256, 72),
                                      (512, 64)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("values", ["normal", "half_integers"])
def test_conv_int8_quantizes_wide_input_on_load(cuda_device, monkeypatch,
                                                cin, cout, dtype, values):
    """A wide 1x1 stride-1 input quantized by the kernel as it loads it
    gives the plain quantize-then-conv accumulator exactly: on normal
    values, and on values whose quotients are exact half-integers (every
    chunk then takes the kernel's division path, and rounds half to
    even)."""
    from deepgraphpose_tpu_torch.ops import int8_gemm as gemm_plain
    from deepgraphpose_tpu_torch.ops.kernels import int8_gemm_kernel as gk

    rng = np.random.default_rng(2)
    if values == "normal":
        x = torch.from_numpy(rng.standard_normal((3, 17, 22, cin)).astype(
            np.float32) * 3).to(cuda_device, dtype)
        scale = float(np.float32(x.float().abs().max().item() / 100))
    else:   # k / 8 with scale 1/4: quotients k / 2, beyond the clip too
        x = torch.from_numpy(rng.integers(-1100, 1100, (3, 17, 22, cin)
                                          ).astype(np.float32) / 8).to(
            cuda_device, dtype)
        scale = 0.25
    w = torch.from_numpy(rng.integers(-127, 128, (cin, cout),
                                      dtype=np.int8)).to(cuda_device)
    args = (x, w, 1, 1, 1, 0, None, None, False, torch.int32)
    want = gemm_plain.conv_int8(*args, in_scale=scale)
    _forbid_plain(monkeypatch)
    before = gk.launches["mm_tiled"]
    got = gk.conv_int8(*args, in_scale=scale)
    torch.cuda.synchronize()
    assert gk.launches["mm_tiled"] == before + 1
    assert torch.equal(got, want)


# MobileNetV2's int8 sites (k, Cin, Cout, stride) at their TF SAME pads: the
# 3x3/2 stem and 1x1s with K and N below the 128-wide tiles and the K % 16
# vector path
MOBILE_SITES = [(3, 3, 32, 2), (1, 16, 96, 1), (1, 24, 144, 1),
                (1, 96, 24, 1), (1, 32, 16, 1), (1, 320, 1280, 1)]


def _mobile_site_args(device, site, hw, seed=3):
    from deepgraphpose_tpu_torch.models.mobilenet import same_pads

    k, cin, cout, stride = site
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.integers(-127, 128, (k * k * cin, cout),
                                      dtype=np.int8)).to(device)
    oscale = torch.from_numpy((rng.uniform(2.0, 12.0, cout) / (
        127 * 127 * k * k * cin / 8)).astype(np.float32)).to(device)
    bias = torch.from_numpy(rng.standard_normal(cout).astype(
        np.float32)).to(device)
    pad = tuple(same_pads(k, stride, 1, n) for n in hw)
    return w, k, stride, 1, pad, oscale, bias


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(20, 24), (21, 23), (25, 26)],
                         ids=["even", "odd", "odd_even"])
@pytest.mark.parametrize("site", MOBILE_SITES)
def test_mobilenet_sites_match_plain(cuda_device, monkeypatch, site, hw):
    """MobileNetV2's convs with ReLU6 and TF SAME's split pads on the card
    against the plain version: int32 exactly, float32 within 1 ulp, bf16
    within 1 bf16 ulp, int8 within 1 on at most 1e-4; the 1x1s also on a
    wide bf16 input quantized on load, exactly. Their small K and N take
    the kernel's scalar loads and ragged tiles."""
    from deepgraphpose_tpu_torch.ops import int8_gemm as gemm_plain
    from deepgraphpose_tpu_torch.ops.kernels import int8_gemm_kernel as gk

    args = _mobile_site_args(cuda_device, site, hw)
    k, cin, cout, stride = site
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.integers(-127, 128, (3, *hw, cin),
                                      dtype=np.int8)).to(cuda_device)
    outs = [torch.int32, torch.float32, torch.bfloat16, ("int8", 6 / 127)]
    wants = {str(o): gemm_plain.conv_int8(x, *args, gk.RELU6, o)
             for o in outs}
    wide, scale = None, None
    if k == 1:
        wide = (torch.randn((3, *hw, cin), device=cuda_device) * 3).to(
            torch.bfloat16)
        scale = float(np.float32(wide.float().abs().max().item() / 100))
        want_wide = gemm_plain.conv_int8(wide, *args, gk.RELU6, torch.int32,
                                         scale)
    _forbid_plain(monkeypatch)
    launches = dict(gk.launches)
    for o in outs:
        got, want = gk.conv_int8(x, *args, gk.RELU6, o), wants[str(o)]
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.dtype == want.dtype
        if o == torch.int32:
            assert torch.equal(got, want)
        elif o == torch.float32:
            ulp = torch.from_numpy(np.spacing(
                want.abs().cpu().numpy())).to(cuda_device)
            assert ((got - want).abs() <= ulp).all().item()
        elif o == torch.bfloat16:
            err = (got.float() - want.float()).abs()
            assert (err <= want.float().abs() * 2.0 ** -7).all().item()
        else:
            diff = (got.int() - want.int()).abs()
            assert diff.max().item() <= 1
            assert (diff != 0).float().mean().item() <= 1e-4
    if wide is not None:
        got = gk.conv_int8(wide, *args, gk.RELU6, torch.int32, scale)
        assert torch.equal(got, want_wide)
    name = "mm_tiled" if k == 1 else "conv_int8"
    assert gk.launches[name] == launches[name] + 4 + (wide is not None)


@pytest.mark.cuda
def test_mobilenet_largest_site_exact(cuda_device):
    """MobileNetV2's first expand at batch 128 of 747x832: a wide bf16
    (128, 374, 416, 16) input through a 1x1 to 96 channels, M * N =
    1.91e9 outputs (12% below 2^31), byte offsets past 2^32 in the int32
    output. The int32 accumulator and the bf16 ReLU6 output against the
    plain version, 16 frames at a time: exactly, and within 1 bf16 ulp."""
    from deepgraphpose_tpu_torch.ops import int8_gemm as gemm_plain
    from deepgraphpose_tpu_torch.ops.kernels import int8_gemm_kernel as gk

    w, k, stride, rate, pad, oscale, bias = _mobile_site_args(
        cuda_device, (1, 16, 96, 1), (374, 416))
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    x = (torch.randn((128, 374, 416, 16), generator=gen, device=cuda_device)
         * 3).to(torch.bfloat16)
    scale = 0.05
    args = (w, k, stride, rate, pad, oscale, bias, gk.RELU6)
    acc = gk.conv_int8(x, *args, torch.int32, scale)
    y = gk.conv_int8(x, *args, torch.bfloat16, scale)
    torch.cuda.synchronize()
    assert acc.numel() == 128 * 374 * 416 * 96 > 1.9e9
    for i in range(0, 128, 16):
        part = slice(i, i + 16)
        want = gemm_plain.conv_int8(x[part], *args, torch.int32, scale)
        assert torch.equal(acc[part], want), i
        want = gemm_plain.epilogue(want, oscale, bias, gk.RELU6,
                                   torch.float32)
        err = (y[part].float() - want).abs()
        assert (err <= want.abs() * 2.0 ** -7).all().item(), i


@pytest.mark.cuda
def test_int8_gemm_rejects_what_it_does_not_take(cuda_device):
    from deepgraphpose_tpu_torch.ops.kernels import int8_gemm_kernel as gk

    a = torch.zeros(64, 32, dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError):
        gk.mm(a.T, a)                    # not row-major contiguous
    b = torch.zeros(32, 16, dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError):
        gk.mm(a, b, b_nk=b)              # not the (N, K) transpose
    x = torch.zeros(2, 8, 8, 32, dtype=torch.int8, device=cuda_device)
    w = torch.zeros(9 * 32, 16, dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError):
        gk.conv_int8(x.permute(0, 2, 1, 3), w, 3, 1, 1, 1, None, None,
                     False, torch.int32)
    with pytest.raises(ValueError):
        gk.conv_int8(x, w, 3, 1, 1, 1, None, None, False, torch.float32)


@pytest.fixture
def small_fit_project(monkeypatch, tmp_path, tiny_resnet):
    """chip_smoke's fit project cut to 40 frames of 96x112, 6 labeled, on
    the one-unit ResNet, with a seeded random step-1 final snapshot."""
    from deepgraphpose_tpu_torch.core import checkpoint
    from deepgraphpose_tpu_torch.core.paths import resolve_project
    from deepgraphpose_tpu_torch.models.pose_model import init_model

    smoke = smoke_helpers()
    monkeypatch.setattr(smoke, "HW", (96, 112))
    monkeypatch.setattr(smoke, "FIT_FRAMES", 40)
    monkeypatch.setattr(smoke, "FIT_LABELED", 6)
    root = smoke.make_fit_project(tmp_path / "p", net_type=tiny_resnet)
    _, cfg, train_dir = resolve_project(root)
    model = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    checkpoint.save_snapshot(train_dir, 1, "final--0", model)
    return smoke, root


@pytest.fixture
def small_mobile_project(monkeypatch, tmp_path):
    """``small_fit_project`` on mobilenet_v2_0.35."""
    from deepgraphpose_tpu_torch.core import checkpoint
    from deepgraphpose_tpu_torch.core.paths import resolve_project
    from deepgraphpose_tpu_torch.models.pose_model import init_model

    smoke = smoke_helpers()
    monkeypatch.setattr(smoke, "HW", (96, 112))
    monkeypatch.setattr(smoke, "FIT_FRAMES", 40)
    monkeypatch.setattr(smoke, "FIT_LABELED", 6)
    root = smoke.make_fit_project(tmp_path / "p",
                                  net_type="mobilenet_v2_0.35")
    _, cfg, train_dir = resolve_project(root)
    model = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    checkpoint.save_snapshot(train_dir, 1, "final--0", model)
    return smoke, root


@pytest.mark.cuda
def test_pooled_dgp_step_on_card_matches_host_fed(cuda_device,
                                                  small_fit_project):
    """One step-2 update from the frame pool and one host-fed, without
    augmentation, on the same window and weights: loss terms and every
    parameter and buffer within 1e-6 relative (chip_smoke's fit check)."""
    smoke, root = small_fit_project
    errors, ok = smoke.pooled_vs_host(root, cuda_device,
                                      "snapshot-step1-final--0")
    assert ok, errors


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(13, 23))
@pytest.mark.parametrize("shape", [(11, 747, 832), (3, 37, 53)])
def test_augment_batch_on_card_matches_cpu(cuda_device, shape, seed):
    """The reference augmentation on the card against the CPU on the same
    draws: images within 1e-3 (0-255), keypoints within 1e-4 px, present
    equal (chip_smoke's fit check, at ten seeds of images and draws)."""
    errors, ok = smoke_helpers().augment_card_vs_cpu(cuda_device, shape,
                                                     seed)
    assert ok, errors


@pytest.mark.cuda
@pytest.mark.parametrize("shape,shift", [((3, 187, 209), (3, 1)),
                                         ((11, 747, 832), (5, -2))])
def test_flow_device_on_card_matches_cpu(cuda_device, shape, shift):
    """The Lucas-Kanade flow of a moving texture on the card against the
    CPU: within twice the CPU float32 run's distance from the CPU float64
    run, or 1e-5 of the largest magnitude (chip_smoke's fit check)."""
    t, h, w = shape
    rng = np.random.default_rng(sum(shape))
    coarse = rng.uniform(0, 255, (1, 1, h // 8 + 16, w // 8 + 16))
    tex = torch.nn.functional.interpolate(
        torch.from_numpy(coarse), scale_factor=8,
        mode="bicubic")[0, 0].clamp(0, 255).to(torch.uint8)
    frames = torch.stack([
        tex[64 + i * shift[1]:64 + i * shift[1] + h,
            64 + i * shift[0]:64 + i * shift[0] + w] for i in range(t)])
    frames = frames[..., None].expand(t, h, w, 3).contiguous()
    errors = smoke_helpers().flow_card_vs_cpu(frames.to(cuda_device))
    assert errors["ok"], errors


@pytest.mark.cuda
@pytest.mark.parametrize("aug,bn_train", [(True, False), (False, True)],
                         ids=["augmented", "bn_train"])
def test_superstep_graph_matches_eager(cuda_device, small_fit_project, aug,
                                       bn_train):
    """Three pooled step-2 updates as one superstep dispatch (a warm-up
    update, then replays of a CUDA graph of the update) against three
    eager ones, from one snapshot and generator seed: parameters and loss
    terms within 1e-6 (a replay runs the eager update's kernels, so the
    reading is expected to be 0), the augmentation's draws replayed from
    the generator, one decode launch an update counted through the
    replays."""
    from deepgraphpose_tpu_torch.ops.augment_device import DeviceAugmentConfig

    smoke, root = small_fit_project
    errors = smoke.superstep_vs_eager(
        root, cuda_device, "snapshot-step1-final--0", k=3,
        aug_cfg=DeviceAugmentConfig.reference() if aug else None,
        bn_train=bn_train)
    assert errors["param_rel"] <= 1e-6, errors
    assert errors["loss_rel"] <= 1e-6, errors
    assert errors["decode_launches"] == [3, 3], errors


@pytest.mark.cuda
def test_mobilenet_bf16_superstep_matches_eager(cuda_device,
                                                small_mobile_project):
    """The superstep of a bf16 mobilenet_v2_0.35 (float32 weights, every
    conv's weight cast in the captured graph) against its eager twin, with
    the reference augmentation: within 1e-6, as the ResNet case above."""
    from deepgraphpose_tpu_torch.ops.augment_device import DeviceAugmentConfig

    smoke, root = small_mobile_project
    errors = smoke.superstep_vs_eager(
        root, cuda_device, "snapshot-step1-final--0", k=3,
        aug_cfg=DeviceAugmentConfig.reference(), dtype=torch.bfloat16)
    assert errors["param_rel"] <= 1e-6, errors
    assert errors["loss_rel"] <= 1e-6, errors
    assert errors["decode_launches"] == [3, 3], errors

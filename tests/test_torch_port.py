"""Port hygiene, and the CUDA kernel against its plain version on the card.

* Every module of ``deepgraphpose_tpu_torch`` imports in a process where
  ``jax``, ``flax``, ``optax`` and ``deepgraphpose_tpu`` cannot be
  imported, and no source of the port (nor ``chip_smoke.py``) names them.
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
# the part_pred maps of the main path: ResNet-50 at 747x832 full frame and
# at the tracked crop's (408, 448) window, batch 128, 5 joints
_CFG = PoseConfig(net_type="resnet_50", num_joints=5)
FULL_MAPS = (128, *scoremap_size(_CFG, (747, 832)), 5)
CROP_MAPS = (128, *scoremap_size(_CFG, (408, 448)), 5)


def port_modules():
    pkg = deepgraphpose_tpu_torch
    return [pkg.__name__] + [
        m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        f"for name in {BLOCKED!r}:\n"
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


def test_port_sources_name_no_jax():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|flax|optax|deepgraphpose_tpu)(\.|\s|$)",
        re.M)
    files = list((REPO / "deepgraphpose_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    for path in files:
        assert not pattern.search(path.read_text()), path


def test_kernel_source_is_in_the_package():
    from deepgraphpose_tpu_torch.ops.kernels import build

    assert "softargmax" in build.sources()
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
    """Kernel vs plain on the same device: mu within 1e-4 cells; lik within
    1e-5 of the plain 2x2 read at the kernel's own cell (where mu sits
    within 1e-4 of an integer the two may pick neighbouring cells)."""
    before = kernel.launches
    mu_k, lik_k = kernel.softargmax_likelihood(x, gamma, gauss_len,
                                               layout=layout)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    mu_p, _ = plain.softargmax_2d(x, gamma=gamma, gauss_len=gauss_len)
    assert (mu_k - mu_p).abs().max().item() <= 1e-4
    lik_ref = plain.max_sigmoid_2x2(x, mu_k)
    assert (lik_k - lik_ref).abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [FULL_MAPS, CROP_MAPS, (3, 23, 31, 4)])
@pytest.mark.parametrize("gauss_len", [0.0, 1.0, 2.0])
@pytest.mark.parametrize("gamma", [1.0, 2.5])
def test_kernel_matches_plain(cuda_device, shape, gauss_len, gamma):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    check_against_plain(torch.from_numpy(x * 3).to(cuda_device), gamma,
                        gauss_len)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [FULL_MAPS, CROP_MAPS, (2, 9, 13, 7)])
@pytest.mark.parametrize("layout", [(1, 256), (2, 512), (3, 1023), (5, 510),
                                    (7, 1022)])
def test_kernel_layouts_match_plain(cuda_device, shape, layout):
    """Every (joints per block, threads) layout computes the same decode,
    including groups that do not divide the joints and blocks with more
    threads than pixels."""
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    check_against_plain(torch.from_numpy(x * 3).to(cuda_device), 2.5, 2.0,
                        layout)


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
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    x = torch.zeros(2, 8, 8, 3, device=cuda_device)
    with pytest.raises(TypeError):
        kernel.softargmax_likelihood(x.half(), 1.0, 1.0)
    with pytest.raises(ValueError):
        kernel.softargmax_likelihood(x.permute(0, 2, 1, 3), 1.0, 1.0)

"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C launch function and compiles on
its own into ``build/kernels/<name>-<hash>.so`` at the repository root
(``DGP_COMPILE_CACHE`` moves the root: ``utils/compile_cache.py``), for
``sm_90a``. The hash covers the source and the flags, so an edited
source rebuilds and an unchanged one loads from the build directory.
:func:`build_all` starts one nvcc per source, all at once. Nothing here
runs at import: the first call that launches a kernel builds it. A failed
build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from deepgraphpose_tpu_torch.utils.compile_cache import (DEFAULT_BUILD_ROOT,
                                                         build_dir)

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = DEFAULT_BUILD_ROOT / "kernels"   # without DGP_COMPILE_CACHE
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
# nvcc's output (ptxas register / shared-memory / spill report) per kernel
build_logs: dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (looked on PATH, $CUDA_HOME, "
                       "/usr/local/cuda); the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir("kernels") / f"{name}-{digest[:16]}.so"


def _start(name: str):
    out = _target(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all() -> None:
    """Compile every source that has no current build, in parallel."""
    started = {name: _start(name) for name in sources()}
    for name, s in started.items():
        _finish(name, s)


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, building it if needed."""
    lib = _libs.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(_target(name)))
        _libs[name] = lib
    return lib

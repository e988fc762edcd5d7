"""Where the port's builds are kept across processes.

The JAX package's ``utils/compile_cache.py`` points XLA's persistent
compilation cache at a directory. The port compiles nothing with XLA or
inductor; what it keeps across processes is what it builds at first use:
the CUDA kernels (``ops/kernels/build.py``, ``<root>/kernels/``) and the
native JPEG decoder (``native/``, ``<root>/native/``). The same variable
chooses their root:

* unset: ``build/`` at the repository root;
* ``DGP_COMPILE_CACHE=<dir>``: that directory;
* ``DGP_COMPILE_CACHE=0``: a fresh directory for this process, removed
  when it exits, so every process builds anew.

The root is read once a process, at the first build or at the first call
of :func:`ensure_compile_cache` (``core/paths.py::resolve_project`` and
``infer/predict.py::make_infer_fn`` call it, where the JAX package calls
its own).
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
import threading
from pathlib import Path

DEFAULT_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build"

_lock = threading.Lock()
_root: Path | None = None


def ensure_compile_cache() -> Path:
    """This process's build root (chosen once; see the module docstring)."""
    global _root
    with _lock:
        if _root is None:
            override = os.environ.get("DGP_COMPILE_CACHE")
            if override == "0":
                _root = Path(tempfile.mkdtemp(prefix="dgp_torch_build_"))
                atexit.register(shutil.rmtree, _root, True)
            else:
                _root = Path(override) if override else DEFAULT_BUILD_ROOT
        return _root


def build_dir(kind: str) -> Path:
    """``<build root>/<kind>``: ``kernels`` or ``native``."""
    return ensure_compile_cache() / kind

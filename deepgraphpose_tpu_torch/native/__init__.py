"""Native (C++) batch JPEG decoder, bound with ctypes.

The port's own copy of ``deepgraphpose_tpu/native/__init__.py``, over the
same ``framecache.cc``: a threaded libjpeg decode of a list of JPEG byte
strings straight into one (n, h, w, 3) RGB uint8 array, behind
``data/video.py::FrameCache.get_batch``. It is compiled at first use with
``g++ -O3 -shared -fPIC -std=c++17 ... -ljpeg -pthread`` into
``<build root>/native/framecache-<sha16>.so`` (``build/`` at the
repository root unless ``DGP_COMPILE_CACHE`` moves it:
``utils/compile_cache.py``); the hash covers the source, the flags and the
ABI version, so an edited source rebuilds. A library in the build
directory that this host cannot load (one built on another host) is
built anew, once.

This is host code, not a kernel: where g++ or libjpeg is missing,
:func:`load_framecache_lib` returns None and the cache decodes with
OpenCV, as in the JAX package. It is never silent about it:
:func:`status` says whether the library loaded, from where, and why not.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

from deepgraphpose_tpu_torch.utils.compile_cache import build_dir

SRC = Path(__file__).resolve().parent / "framecache.cc"
ABI = 1
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LINK_FLAGS = ("-ljpeg", "-pthread")

_lock = threading.Lock()
_lib = None
_status: dict | None = None


def _target() -> Path:
    digest = hashlib.sha256(
        SRC.read_bytes() + " ".join(GXX_FLAGS + LINK_FLAGS).encode()
        + str(ABI).encode()).hexdigest()
    return build_dir("native") / f"framecache-{digest[:16]}.so"


def _build(gxx: str, out: Path) -> str | None:
    """Compile into ``out``; None on success, else the reason."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [gxx, *GXX_FLAGS, str(SRC), "-o", str(tmp), *LINK_FLAGS]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        return f"g++ did not run: {e}"
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        lines = res.stderr.strip().splitlines()
        said = [line.strip() for line in lines if "error" in line] or \
            lines[-3:]
        return f"g++ failed (exit {res.returncode}): {' '.join(said)}"
    os.replace(tmp, out)
    return None


def _open(out: Path):
    """(the library, None), or (None, why it does not load)."""
    try:
        return ctypes.CDLL(str(out)), None
    except OSError as e:
        return None, f"load failed: {e}"


def load_framecache_lib():
    """The compiled framecache library, or None when it cannot be built or
    loaded (:func:`status` says why). Built and loaded once a process."""
    global _lib, _status
    with _lock:
        if _status is not None:
            return _lib
        t0 = time.perf_counter()
        out = _target()
        lib, reason = _open(out) if out.exists() else (None, None)
        built = False
        if lib is None:     # no build yet, or one this host cannot load
            gxx = shutil.which("g++")
            if gxx is None:
                reason = "g++ not found on PATH"
            else:
                built, reason = True, _build(gxx, out)
                if reason is None:
                    lib, reason = _open(out)
        if reason is None:
            if lib.fc_abi_version() != ABI:
                reason = (f"ABI {lib.fc_abi_version()} in {out}, "
                          f"expected {ABI}")
            else:
                lib.fc_decode_batch.restype = ctypes.c_int
                lib.fc_decode_batch.argtypes = [
                    ctypes.POINTER(ctypes.c_char_p),
                    ctypes.POINTER(ctypes.c_size_t), ctypes.c_int,
                    ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
                    ctypes.c_int, ctypes.c_int]
                _lib = lib
        _status = {"available": _lib is not None,
                   "path": str(out) if _lib is not None else None,
                   "built_now": built and _lib is not None,
                   "seconds": time.perf_counter() - t0,
                   "reason": reason}
        if reason is not None:
            print(f"[native] framecache unavailable ({reason}); "
                  "FrameCache decodes with OpenCV")
        return _lib


def status() -> dict:
    """Whether the decoder is available (building it if not tried yet):
    ``available``, ``path``, ``built_now`` (compiled by this process),
    ``seconds`` (the build or load) and ``reason`` (None, or why the
    OpenCV path decodes)."""
    load_framecache_lib()
    return dict(_status)


def decode_jpeg_batch(jpegs: list[bytes], h: int, w: int,
                      threads: int = 0) -> np.ndarray | None:
    """Decode a list of JPEG byte strings to (n, h, w, 3) RGB uint8 on
    ``threads`` workers (0: one a core).

    Returns None when the library is unavailable or any frame fails to
    decode or has other dimensions (callers then decode with OpenCV).
    """
    lib = load_framecache_lib()
    if lib is None or not jpegs:
        return None
    n = len(jpegs)
    out = np.empty((n, h, w, 3), dtype=np.uint8)
    buf_arr = (ctypes.c_char_p * n)(*jpegs)
    size_arr = (ctypes.c_size_t * n)(*[len(b) for b in jpegs])
    failures = lib.fc_decode_batch(
        ctypes.cast(buf_arr, ctypes.POINTER(ctypes.c_char_p)), size_arr, n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w, threads)
    if failures:
        return None
    return out

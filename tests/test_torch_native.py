"""The port's native batch JPEG decoder against the JAX package's
(``tests/test_native.py``'s four cases), and where it is built.

* The decode is byte-equal to ``deepgraphpose_tpu.native.decode_jpeg_batch``
  (the same source, the same libjpeg) and within 3 of OpenCV per channel
  value (``tests/test_native.py``'s bound: libjpeg builds differ by a few
  IDCT steps).
* ``FrameCache.get_batch`` on an MJPG video equals the JAX package's.
* The library is built into ``build/native/`` at the repository root, or
  where ``DGP_COMPILE_CACHE`` says (a fresh directory a process for
  ``0``), as are the CUDA kernels; without g++ ``status()`` says why and
  the cache decodes with OpenCV.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from deepgraphpose_tpu import native as jax_native
from deepgraphpose_tpu.data import video as jax_video
from deepgraphpose_tpu_torch import native
from deepgraphpose_tpu_torch.data.video import FrameCache, VideoReader
from deepgraphpose_tpu_torch.utils import compile_cache

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jpegs():
    import cv2

    rng = np.random.default_rng(0)
    frames, bufs = [], []
    for _ in range(24):
        base = rng.integers(0, 255, (12, 16, 3), dtype=np.uint8)
        frame = cv2.resize(base, (160, 120), interpolation=cv2.INTER_CUBIC)
        frames.append(frame)
        ok, buf = cv2.imencode(
            ".jpg", frame[..., ::-1], [int(cv2.IMWRITE_JPEG_QUALITY), 95])
        assert ok
        bufs.append(buf.tobytes())
    return frames, bufs


@pytest.fixture(scope="module")
def lib():
    if native.load_framecache_lib() is None:
        pytest.fail(f"the decoder did not build here: {native.status()}")
    return native.status()


def test_native_decode_matches_jax_and_opencv(jpegs, lib):
    import cv2

    _, bufs = jpegs
    out = native.decode_jpeg_batch(bufs, 120, 160)
    assert out.shape == (24, 120, 160, 3) and out.dtype == np.uint8
    ref = jax_native.decode_jpeg_batch(bufs, 120, 160)
    assert ref is not None and np.array_equal(out, ref)
    for i, buf in enumerate(bufs):
        ocv = cv2.cvtColor(cv2.imdecode(np.frombuffer(buf, np.uint8),
                                        cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
        diff = np.abs(out[i].astype(int) - ocv.astype(int))
        assert diff.max() <= 3, f"frame {i}: max diff {diff.max()}"
    one = native.decode_jpeg_batch(bufs[:5], 120, 160, threads=1)
    assert np.array_equal(one, out[:5])


def test_native_decode_rejects_wrong_dims(jpegs, lib):
    _, bufs = jpegs
    assert native.decode_jpeg_batch(bufs[:2], 64, 64) is None
    assert native.decode_jpeg_batch([b"notajpeg"], 120, 160) is None
    assert native.decode_jpeg_batch([], 120, 160) is None


def test_framecache_get_batch_matches_jax(tmp_path, lib, monkeypatch):
    import cv2

    path = tmp_path / "v.avi"
    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 20.0,
                         (64, 48))
    rng = np.random.default_rng(1)
    for i in range(12):
        f = np.full((48, 64, 3), i * 20, np.uint8)
        f[:, :8] = rng.integers(0, 255, (48, 8, 3), dtype=np.uint8)
        wr.write(f)
    wr.release()

    readers = VideoReader(path), jax_video.VideoReader(path)
    cache = FrameCache(readers[0], indices=range(0, 12, 2))
    jcache = jax_video.FrameCache(readers[1], indices=range(0, 12, 2))
    calls = []
    decode = native.decode_jpeg_batch
    monkeypatch.setattr(native, "decode_jpeg_batch",
                        lambda *a, **k: calls.append(len(a[0])) or decode(
                            *a, **k))
    batch = cache.get_batch([0, 2, 4, 10])
    assert calls == [4]
    assert batch.shape == (4, 48, 64, 3)
    assert np.array_equal(batch, jcache.get_batch([0, 2, 4, 10]))
    assert np.abs(batch[0, :, 20:, :].astype(int)).max() <= 12
    # an index outside the cache: OpenCV a frame, as in the JAX package
    mixed = cache.get_batch([1, 2])
    assert calls == [4]
    assert np.array_equal(mixed, jcache.get_batch([1, 2]))
    # the native batch and the cache's OpenCV path differ by IDCT steps
    ocv = np.stack([cache.get(i) for i in (0, 2, 4, 10)])
    assert np.abs(batch.astype(int) - ocv.astype(int)).max() <= 3
    for r in readers:
        r.close()


def test_native_throughput_informational(jpegs, lib):
    """Times the native decode against OpenCV's; no speed assertion (the
    thread pool wins only where cores are free), only a pathology check."""
    import cv2

    _, bufs = jpegs
    big = bufs * 20
    native.decode_jpeg_batch(big[:8], 120, 160)
    t0 = time.perf_counter()
    assert native.decode_jpeg_batch(big, 120, 160) is not None
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    for buf in big:
        cv2.cvtColor(cv2.imdecode(np.frombuffer(buf, np.uint8),
                                  cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    t_cv2 = time.perf_counter() - t0
    print(f"native {t_native * 1e3:.1f} ms vs cv2 {t_cv2 * 1e3:.1f} ms")
    assert t_native < t_cv2 * 20.0


PROBE = (
    "import json\n"
    "from deepgraphpose_tpu_torch import native\n"
    "from deepgraphpose_tpu_torch.ops.kernels import build\n"
    "from deepgraphpose_tpu_torch.utils import compile_cache\n"
    "st = native.status()\n"
    "st['root'] = str(compile_cache.ensure_compile_cache())\n"
    "st['kernel'] = str(build._target('softargmax'))\n"
    "print(json.dumps(st))\n")


def probe(env_update: dict) -> dict:
    """native.status() and the build paths in a fresh process."""
    env = {k: v for k, v in os.environ.items() if k != "DGP_COMPILE_CACHE"}
    env.update(env_update)
    res = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_build_directory_and_compile_cache_variable(tmp_path):
    # unset: build/ at the repository root
    st = probe({})
    assert st["available"] and st["reason"] is None
    assert Path(st["root"]) == REPO / "build" == \
        compile_cache.DEFAULT_BUILD_ROOT
    assert Path(st["path"]).parent == REPO / "build" / "native"
    assert Path(st["path"]).name.startswith("framecache-")
    assert Path(st["kernel"]).parent == REPO / "build" / "kernels"

    # <dir>: the builds go there, and a second process loads the first's
    st = probe({"DGP_COMPILE_CACHE": str(tmp_path / "cache")})
    assert st["available"] and st["built_now"]
    assert Path(st["path"]).parent == tmp_path / "cache" / "native"
    assert Path(st["kernel"]).parent == tmp_path / "cache" / "kernels"
    assert not probe({"DGP_COMPILE_CACHE": str(tmp_path / "cache")}
                     )["built_now"]

    # 0: a fresh directory a process, removed at its exit
    runs = [probe({"DGP_COMPILE_CACHE": "0", "TMPDIR": str(tmp_path)})
            for _ in range(2)]
    assert all(r["available"] and r["built_now"] for r in runs)
    assert runs[0]["root"] != runs[1]["root"]
    assert all(Path(r["root"]).parent == tmp_path for r in runs)
    assert not any(Path(r["root"]).exists() for r in runs)


def test_status_says_why_without_gxx(tmp_path):
    st = probe({"DGP_COMPILE_CACHE": str(tmp_path), "PATH": ""})
    assert not st["available"] and st["path"] is None
    assert st["reason"] == "g++ not found on PATH"


def test_entry_points_fix_the_build_root(monkeypatch, tmp_path):
    """``resolve_project`` and ``make_infer_fn`` choose the build root,
    where the JAX package's set its compilation cache."""
    from deepgraphpose_tpu_torch.core.paths import resolve_project
    from deepgraphpose_tpu_torch.infer.predict import make_infer_fn
    from deepgraphpose_tpu_torch.utils.synthetic import make_synthetic_project

    root, _, _ = make_synthetic_project(tmp_path / "proj", n_frames=6,
                                        n_labeled=2, hw=(32, 40))
    monkeypatch.setenv("DGP_COMPILE_CACHE", str(tmp_path / "cache"))
    for call in (lambda: resolve_project(root),
                 lambda: make_infer_fn(None, None)):
        monkeypatch.setattr(compile_cache, "_root", None)
        call()
        assert compile_cache._root == tmp_path / "cache"
        assert compile_cache.build_dir("native") == tmp_path / "cache" / \
            "native"


def test_a_build_that_does_not_load_is_rebuilt(tmp_path):
    """A library in the build root that this host cannot load (one built
    elsewhere) is built anew, once."""
    first = probe({"DGP_COMPILE_CACHE": str(tmp_path)})
    Path(first["path"]).write_bytes(b"not a shared object")
    again = probe({"DGP_COMPILE_CACHE": str(tmp_path)})
    assert again["available"] and again["built_now"]
    assert again["path"] == first["path"]

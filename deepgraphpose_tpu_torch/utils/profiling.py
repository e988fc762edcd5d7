"""Tracing, per-step timing and device memory.

The port's own copy of ``deepgraphpose_tpu/utils/profiling.py``:

* :func:`trace`: a context manager around ``torch.profiler`` that writes a
  Chrome trace (host ops and, on a card, its kernels) under ``logdir``;
* :class:`StepTimer`: rolling step timing with JSON-lines output that
  never forces a device sync (callers pass scalars they already fetched);
* :func:`device_memory_stats`: live, peak and total bytes of each card.

The device-time breakdown by kernel class is the profile phase of
``chip_smoke.py``.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
import warnings
from pathlib import Path


@contextlib.contextmanager
def trace(logdir: str | Path):
    """Profile the enclosed block: ``with trace('/tmp/tb'): step(...)``.

    Writes ``logdir/trace-<pid>-<ms>.json`` (load it in Perfetto or
    ``chrome://tracing``), with the card's kernels where CUDA is available.
    If the profiler cannot start (another profile is active: PyTorch would
    start a second session that ends the first), it warns and runs the
    block unprofiled, as the JAX package's does.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    logdir = Path(logdir)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = None
    if torch._C._autograd._profiler_enabled():
        warnings.warn("[profiling] could not start trace: a profiler is "
                      "already active")
    else:
        prof = profile(activities=activities)
        prof.__enter__()
    try:
        yield
    finally:
        if prof is not None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            logdir.mkdir(parents=True, exist_ok=True)
            path = logdir / (f"trace-{os.getpid()}-"
                             f"{int(time.time() * 1000)}.json")
            prof.export_chrome_trace(str(path))
            print(f"[profiling] trace written to {path}")


class StepTimer:
    """Rolling per-step wall timing + metric logging as JSON lines.

    >>> timer = StepTimer(train_dir / 'steps.jsonl', window=50)
    >>> for it in ...:
    ...     out = train_step(...)
    ...     timer.step(it, loss=float(out['total_loss']))
    """

    def __init__(self, path: str | Path | None = None, window: int = 50):
        self.path = Path(path) if path else None
        self.window = window
        self._t_last = time.perf_counter()
        self._durations: list[float] = []
        self._fh = None
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(self.path, "a", buffering=1)

    def tick(self) -> float:
        """Record one step's wall duration without writing a record.

        Call once per training iteration; pair with :meth:`write` at
        display intervals so 'step_seconds' stays a true per-step number.
        """
        now = time.perf_counter()
        dt = now - self._t_last
        self._t_last = now
        self._durations.append(dt)
        if len(self._durations) > self.window:
            self._durations.pop(0)
        return dt

    def write(self, iteration: int, **metrics) -> None:
        """Emit a JSONL record with the rolling mean step time."""
        if self._fh:
            self._fh.write(json.dumps(
                {"iteration": iteration,
                 "step_seconds": round(self.mean_step_seconds, 6),
                 **metrics}) + "\n")

    def step(self, iteration: int, **metrics) -> float:
        """tick() + write() in one call (for loops that log every step)."""
        dt = self.tick()
        self.write(iteration, **metrics)
        return dt

    def interval(self, iteration: int, n_steps: int, **metrics) -> float:
        """Record a synced interval of ``n_steps`` steps as one measurement.

        The right primitive for asynchronous training loops (CUDA): per-
        iteration host timing only measures enqueue cost; the real device
        time is observable at sync points (e.g. fetching the loss every
        displayiters). Call this right after such a sync — it attributes
        the elapsed wall time evenly across the interval's steps and writes
        one record. Returns the per-step seconds.
        """
        now = time.perf_counter()
        dt = (now - self._t_last) / max(n_steps, 1)
        self._t_last = now
        self._durations.append(dt)
        if len(self._durations) > self.window:
            self._durations.pop(0)
        self.write(iteration, **metrics)
        return dt

    @property
    def mean_step_seconds(self) -> float:
        return (sum(self._durations) / len(self._durations)
                if self._durations else 0.0)

    def rate(self, items_per_step: float = 1.0) -> float:
        """Throughput (items/second) over the rolling window."""
        m = self.mean_step_seconds
        return items_per_step / m if m > 0 else 0.0

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def device_memory_stats() -> list[dict]:
    """Memory of each card (bytes): in use, peak in use (since the last
    ``torch.cuda.reset_peak_memory_stats``) and the card's total, as
    PyTorch's caching allocator counts them. Without a card, one entry for
    the CPU with no figures (PyTorch keeps none for it)."""
    import torch

    if not torch.cuda.is_available():
        return [{"device": "cpu"}]
    out = []
    for i in range(torch.cuda.device_count()):
        raw = torch.cuda.memory_stats(i)
        out.append({
            "device": f"cuda:{i}",
            "bytes_in_use": raw.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": raw.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        })
    return out

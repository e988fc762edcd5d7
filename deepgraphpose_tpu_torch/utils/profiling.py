"""Tracing, spans and counters, per-step timing and device memory.

The port's own copy of ``deepgraphpose_tpu/utils/profiling.py``:

* :func:`span` and :func:`count`: named host spans and counters, kept in
  memory by a process-wide :class:`Registry` and read back with
  :func:`spans` and :func:`counters`. A span also becomes a
  ``torch.profiler`` range while the profiler records its thread, so it
  lies on the device trace's clock;
* :func:`trace`: a context manager around ``torch.profiler`` that writes a
  Chrome trace (host ops and, on a card, its kernels) under ``logdir``,
  with a summary of the spans and counters beside it;
* :class:`StepTimer`: rolling step timing with JSON-lines output that
  never forces a device sync (callers pass scalars they already fetched);
* :func:`device_memory_stats`: live, peak and total bytes of each card.

A span must enclose no work on the card (no kernel launch, no copy
enqueued): the benchmark labels each kernel with the profiler range that
holds its start, so a range over device work would take its kernels from
the ranges that measure them.

The device-time breakdown by kernel class is the profile phase of
``chip_smoke.py``.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
import warnings
from pathlib import Path
from typing import NamedTuple

import torch

# records kept for each span name: the newest SPAN_CAP
SPAN_CAP = 4096

_profiler_enabled = torch._C._autograd._profiler_enabled


_thread_local = threading.local()


def _native_id() -> int:
    """``threading.get_native_id()``, asked once a thread: on a host where
    ``gettid`` is a full system call it costs microseconds."""
    try:
        return _thread_local.native_id
    except AttributeError:
        _thread_local.native_id = threading.get_native_id()
        return _thread_local.native_id


class SpanRecord(NamedTuple):
    seq: int        # the n-th span of its name since the last reset
    thread: int     # threading.get_native_id() of the thread that ran it
    start_ns: int   # time.perf_counter_ns()
    end_ns: int


class _Span:
    __slots__ = ("_registry", "_name", "_t0", "_range")

    def __init__(self, registry: "Registry", name: str):
        self._registry, self._name, self._range = registry, name, None

    def __enter__(self):
        # the check costs a fraction of a microsecond, the range about 16
        if self._registry.all_threads or _profiler_enabled():
            self._range = torch.autograd.profiler.record_function(self._name)
            self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        self._registry.add(self._name, self._t0, t1)
        return False


class Registry:
    """Spans and counters of a process, safe to use from several threads.

    Each span name keeps its newest ``cap`` records and numbers them from
    0 since the last :meth:`reset`, so the n-th spans of the names that
    one batch passes through share the number n. Nothing here syncs a
    card.
    """

    def __init__(self, cap: int = SPAN_CAP):
        self.cap = cap
        # True while trace() has the profiler record every thread: spans
        # of threads that did not start it then enter their ranges too
        self.all_threads = False
        self._lock = threading.Lock()
        self._records: dict[str, collections.deque] = {}
        self._next: dict[str, int] = {}
        self._counters: dict[str, int] = {}

    def span(self, name: str) -> _Span:
        """``with span("dgp.feed.wait"): item = q.get()`` records the
        block's start, end, thread and sequence number under ``name``."""
        return _Span(self, name)

    def add(self, name: str, start_ns: int, end_ns: int) -> None:
        thread = _native_id()
        with self._lock:
            seq = self._next.get(name, 0)
            self._next[name] = seq + 1
            records = self._records.get(name)
            if records is None:
                records = self._records[name] = collections.deque(
                    maxlen=self.cap)
            records.append(SpanRecord(seq, thread, start_ns, end_ns))

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def spans(self) -> dict[str, list[SpanRecord]]:
        """A copy of the kept records, oldest first, by name."""
        with self._lock:
            return {name: list(r) for name, r in self._records.items()}

    def counters(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def reset(self) -> None:
        with self._lock:
            self._records.clear()
            self._next.clear()
            self._counters.clear()

    def mark(self) -> dict:
        """The point from which :meth:`since` summarizes."""
        with self._lock:
            return {"next": dict(self._next),
                    "counters": dict(self._counters)}

    def since(self, mark: dict) -> dict:
        """Spans and counters after ``mark``: for each span name its
        ``count`` and the ``total_ms`` and ``mean_ms`` of its kept records
        (the newest ``cap``), and each counter's increase."""
        with self._lock:
            spans = {}
            for name, records in self._records.items():
                first = mark["next"].get(name, 0)
                n = self._next[name] - first
                if n <= 0:
                    continue
                ms = [1e-6 * (r.end_ns - r.start_ns) for r in records
                      if r.seq >= first]
                spans[name] = {"count": n, "total_ms": sum(ms),
                               "mean_ms": sum(ms) / len(ms)}
            counters = {name: v - mark["counters"].get(name, 0)
                        for name, v in self._counters.items()
                        if v != mark["counters"].get(name, 0)}
        return {"spans": spans, "counters": counters}


REGISTRY = Registry()
span = REGISTRY.span
count = REGISTRY.count
spans = REGISTRY.spans
counters = REGISTRY.counters
reset = REGISTRY.reset
mark = REGISTRY.mark
since = REGISTRY.since


def _all_threads_config():
    """The profiler's option to record every thread, where this torch has
    it (else None: only the thread that starts the profiler is seen)."""
    try:
        return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return None


@contextlib.contextmanager
def trace(logdir: str | Path):
    """Profile the enclosed block: ``with trace('/tmp/tb'): step(...)``.

    Writes ``logdir/trace-<pid>-<ms>.json`` (load it in Perfetto or
    ``chrome://tracing``), with the card's kernels where CUDA is available
    and every thread's ops and spans where this torch can record them all,
    and beside it ``spans-<pid>-<ms>.json``: each span name's count, total
    and mean ms and each counter's increase over the block
    (:meth:`Registry.since`). If the profiler cannot start (another
    profile is active: PyTorch would start a second session that ends the
    first), it warns and runs the block unprofiled, as the JAX package's
    does.
    """
    from torch.profiler import ProfilerActivity, profile

    logdir = Path(logdir)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = None
    # a session in any thread (one that records every thread reads as off
    # in the thread-local check)
    if _profiler_enabled() or getattr(torch.autograd.profiler,
                                      "_is_profiler_enabled", False):
        warnings.warn("[profiling] could not start trace: a profiler is "
                      "already active")
    else:
        config = _all_threads_config()
        prof = profile(activities=activities, experimental_config=config)
        prof.__enter__()
        REGISTRY.all_threads = config is not None
        start = REGISTRY.mark()
    try:
        yield
    finally:
        if prof is not None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            REGISTRY.all_threads = False
            prof.__exit__(None, None, None)
            summary = REGISTRY.since(start)
            logdir.mkdir(parents=True, exist_ok=True)
            stem = f"{os.getpid()}-{int(time.time() * 1000)}.json"
            path = logdir / f"trace-{stem}"
            prof.export_chrome_trace(str(path))
            (logdir / f"spans-{stem}").write_text(json.dumps(summary,
                                                             indent=1))
            print(f"[profiling] trace written to {path}")


class StepTimer:
    """Rolling per-interval wall timing + metric logging as JSON lines.

    >>> timer = StepTimer(train_dir / 'steps.jsonl', window=50)
    >>> for it in ...:
    ...     out = train_step(...)
    ...     if it % display == 0:
    ...         loss = float(out['total_loss'])   # waits for the card
    ...         timer.interval(it, display, loss=loss)
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

    def write(self, iteration: int, **metrics) -> None:
        """Emit a JSONL record with the rolling mean step time."""
        if self._fh:
            self._fh.write(json.dumps(
                {"iteration": iteration,
                 "step_seconds": round(self.mean_step_seconds, 6),
                 **metrics}) + "\n")

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

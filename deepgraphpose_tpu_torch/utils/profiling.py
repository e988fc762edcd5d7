"""Per-step timing for training loops.

The port's own copy of :class:`StepTimer` from
``deepgraphpose_tpu/utils/profiling.py``: rolling step timing with
JSON-lines output that never forces a device sync (callers pass scalars
they already fetched). The device-time breakdown by kernel class is the
profile phase of ``chip_smoke.py``.
"""

from __future__ import annotations

import json
import time
from pathlib import Path


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

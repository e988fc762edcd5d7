"""Host->device prefetching.

A bounded background producer assembles numpy batches and starts their
copies to the card, so batch t+1's transfer overlaps batch t's compute
(the JAX package's ``data/prefetch.py``, with :func:`host_to_device` in
place of ``jax.device_put``).

Spans and a counter (``utils/profiling.py``): ``dgp.feed.pin``, the
staging copy into pinned memory; ``dgp.feed.wait``, the consumer's wait
for the next item; ``dgp.feed.starved``, the gets that found the queue
empty.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np
import torch

from deepgraphpose_tpu_torch.utils import profiling


def host_to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """numpy -> tensor on ``device``. To the card the copy goes from pinned
    memory with ``non_blocking=True``: it never waits for the device."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if torch.device(device).type != "cuda":
        return t.to(device)
    with profiling.span("dgp.feed.pin"):
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


class _Stop:
    pass


class DevicePrefetcher:
    """Runs ``producer`` items through ``transfer`` on a background thread.

    producer: iterator of host batches.
    transfer: host batch -> device batch (e.g. :func:`host_to_device`).
    depth: queue size (2 = double buffering).

    :meth:`close` stops the worker: a loop that stops early (a step that
    raises) closes the prefetcher, so no thread keeps producing and holds
    up to ``depth`` device batches.
    """

    def __init__(self, producer: Iterator, transfer: Callable, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err = None
        self._closed = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(producer, transfer), daemon=True,
            name="DevicePrefetcher")
        self._thread.start()

    def _run(self, producer, transfer):
        try:
            for item in producer:
                if self._closed.is_set():
                    return
                self._q.put(transfer(item))
        except Exception as e:  # surfaced on next __next__
            self._err = e
        finally:
            self._q.put(_Stop())

    def __iter__(self):
        return self

    def __next__(self):
        if self._q.empty():
            profiling.count("dgp.feed.starved")
        with profiling.span("dgp.feed.wait"):
            item = self._q.get()
        if isinstance(item, _Stop):
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self) -> None:
        """Stop the worker and drop the batches it queued: drain the queue
        (as the JAX package's ``close`` does, so that a worker blocked on
        a full queue can go on) until the worker has finished the item it
        was producing and left."""
        self._closed.set()
        while self._thread.is_alive():
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)

"""The port's ``DevicePrefetcher`` against the JAX package's.

The six cases of tests/test_prefetch.py (order, a producer exception, a
transfer exception, bounded depth, overlap, ``close`` unblocking the
worker) run on both prefetchers with the same producers, one parametrised
test a case. Then the port's host-fed fits: a step that raises closes the
prefetcher, so no worker thread stays behind holding device batches.
"""

import threading
import time

import pytest

from deepgraphpose_tpu.data import prefetch as jax_prefetch
from deepgraphpose_tpu_torch.data import prefetch as torch_prefetch
from deepgraphpose_tpu_torch.train import fit
from deepgraphpose_tpu_torch.train import steps as steps_lib
from test_torch_fit import (WARM, base_project, project_copy,  # noqa: F401
                            tiny_resnet, two_threads, work)

PREFETCHERS = {"jax": jax_prefetch.DevicePrefetcher,
               "torch": torch_prefetch.DevicePrefetcher}


@pytest.fixture(params=sorted(PREFETCHERS))
def prefetcher(request):
    return PREFETCHERS[request.param]


def test_order_and_completion(prefetcher):
    items = list(range(10))
    pf = prefetcher(iter(items), lambda x: x * 2, depth=3)
    assert list(pf) == [x * 2 for x in items]


def test_producer_exception_propagates(prefetcher):
    def producer():
        yield 1
        raise ValueError("boom")

    pf = prefetcher(producer(), lambda x: x, depth=2)
    assert next(pf) == 1
    with pytest.raises(ValueError, match="boom"):
        next(pf)


def test_transfer_exception_propagates(prefetcher):
    def bad_transfer(x):
        if x == 2:
            raise RuntimeError("transfer failed")
        return x

    pf = prefetcher(iter([1, 2, 3]), bad_transfer, depth=2)
    assert next(pf) == 1
    with pytest.raises(RuntimeError, match="transfer failed"):
        list(pf)


def test_depth_bounds_producer(prefetcher):
    """The producer cannot run more than depth+1 items ahead of
    consumption."""
    produced = []

    def producer():
        for i in range(20):
            produced.append(i)
            yield i

    pf = prefetcher(producer(), lambda x: x, depth=2)
    time.sleep(0.2)  # let the worker fill the queue
    # queue depth 2 + the one blocked in put() + one in transfer
    assert len(produced) <= 4
    assert list(pf) == list(range(20))
    assert len(produced) == 20


def test_overlaps_slow_producer_with_consumer(prefetcher):
    """Consumption time hides production time (the point of
    prefetching)."""
    def producer():
        for i in range(6):
            time.sleep(0.03)
            yield i

    pf = prefetcher(producer(), lambda x: x, depth=3)
    t0 = time.perf_counter()
    for _ in pf:
        time.sleep(0.03)  # simulated device step
    elapsed = time.perf_counter() - t0
    # serial would be ~0.36s; overlapped ~0.21s. generous bound:
    assert elapsed < 0.33


def test_close_unblocks_worker(prefetcher):
    def producer():
        yield from range(100)

    pf = prefetcher(producer(), lambda x: x, depth=1)
    next(pf)
    t0 = time.perf_counter()
    pf.close()  # must not deadlock
    assert time.perf_counter() - t0 < 5.0


def test_close_ends_the_worker():
    """The port's ``close`` also ends the worker, where the JAX package's
    only frees one slot of the queue."""
    pf = torch_prefetch.DevicePrefetcher(iter(range(100)), lambda x: x,
                                         depth=1)
    assert next(pf) == 0
    pf.close()
    assert not pf._thread.is_alive()


def live_workers(before) -> list:
    return [t for t in threading.enumerate()
            if t.name == "DevicePrefetcher" and t.is_alive()
            and t not in before]


@pytest.mark.parametrize("entry,factory", [
    ("fit_dlc", "make_dlc_train_step"),
    ("fit_dgp", "make_dgp_train_step")])
def test_fit_whose_step_raises_leaves_no_worker(tiny_resnet, base_project,
                                                work, monkeypatch, entry,
                                                factory):
    """A host-fed fit on the CPU whose second update raises: the error
    reaches the caller and no prefetch worker is left alive (without
    ``close`` it would stay blocked on a full queue of batches)."""
    make = getattr(steps_lib, factory)

    def failing(*args, **kwargs):
        step = make(*args, **kwargs)
        calls = []

        def wrapped(*a, **k):
            calls.append(1)
            if len(calls) == 2:
                raise RuntimeError("step failed")
            return step(*a, **k)

        return wrapped

    monkeypatch.setattr(steps_lib, factory, failing)
    root = project_copy(base_project, work / "p")
    kw = dict(snapshot=WARM, dlcpath=root, maxiters=20, displayiters=1,
              device_data=False, device="cpu")
    if entry == "fit_dgp":
        kw.update(batch_size=3, nepoch=1)
    before = set(threading.enumerate())
    with pytest.raises(RuntimeError, match="step failed"):
        getattr(fit, entry)(**kw)
    assert live_workers(before) == []

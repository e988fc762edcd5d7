"""The port's spans and counters (``utils/profiling.py``) and the host
feed's use of them (``infer/predict.py::_batch_producer``,
``data/prefetch.py``), on the CPU.

A span records its block's times, thread and sequence number, and becomes
a profiler range only while the profiler records its thread; the feed
spans one ``assemble`` and one ``wait`` a batch and counts the gets that
found the queue empty; ``profiling.trace`` writes the spans' summary
beside its Chrome trace; and no ``dgp.*`` range holds an aten op, so no
range can hold device work on a card.
"""

import json
import sys
import threading
import time

import cv2
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deepgraphpose_tpu_torch.core.config import PoseConfig
from deepgraphpose_tpu_torch.data.prefetch import (DevicePrefetcher,
                                                   host_to_device)
from deepgraphpose_tpu_torch.infer import predict
from deepgraphpose_tpu_torch.models.pose_model import init_model
from deepgraphpose_tpu_torch.utils import profiling

FEED = ("dgp.feed.assemble", "dgp.feed.wait")


class Ring:
    """A reader of ``n`` frames of 6x8x3; ``hold`` (an Event) keeps the
    producer before frame ``hold_at`` until it is set."""

    def __init__(self, n, hold=None, hold_at=None):
        self.frames = [np.full((6, 8, 3), i, np.uint8) for i in range(n)]
        self.hold, self.hold_at = hold, hold_at

    def iter_frames(self):
        for i, frame in enumerate(self.frames):
            if i == self.hold_at:
                assert self.hold.wait(timeout=30)
            yield i, frame


def feed(reader, batch=4, depth=2):
    return DevicePrefetcher(
        predict._batch_producer(reader, batch),
        lambda item: (item[0], item[1], host_to_device(item[2], "cpu")),
        depth=depth)


@pytest.fixture
def registry():
    profiling.reset()
    yield profiling.REGISTRY
    profiling.reset()


def test_registry_from_two_threads():
    """Records, their numbers and threads, the cap, counters and reset
    from two threads at once; a lost update would break the counts."""
    reg = profiling.Registry(cap=50)
    n, go = 400, threading.Barrier(2)
    tids = {}

    def work(tag):
        go.wait(timeout=30)
        tids[tag] = threading.get_native_id()
        for _ in range(n):
            with reg.span("x"):
                pass
            with reg.span(tag):
                pass
            reg.count("c")
            reg.count(tag, 2)

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in ("a", "b")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(saved)
    got = reg.spans()
    assert set(got) == {"x", "a", "b"}
    # the newest 50 of each name, numbered from 0 with no gap or repeat
    assert [r.seq for r in got["x"]] == list(range(2 * n - 50, 2 * n))
    assert [r.seq for r in got["a"]] == list(range(n - 50, n))
    assert {r.thread for r in got["a"]} == {tids["a"]}
    assert {r.thread for r in got["x"]} <= {tids["a"], tids["b"]}
    assert all(0 <= r.end_ns - r.start_ns for r in got["x"])
    assert reg.counters() == {"c": 2 * n, "a": 2 * n, "b": 2 * n}
    # copies: a reader cannot change the registry
    got["x"].clear()
    reg.counters()["c"] = 0
    assert len(reg.spans()["x"]) == 50 and reg.counters()["c"] == 2 * n
    start = reg.mark()
    with reg.span("x"):
        pass
    reg.count("c", 3)
    after = reg.since(start)
    assert after["spans"]["x"]["count"] == 1
    assert after["counters"] == {"c": 3}
    reg.reset()
    assert reg.spans() == {} and reg.counters() == {}
    with reg.span("x"):
        pass
    assert reg.spans()["x"][0].seq == 0


def test_range_only_under_the_profiler(registry, monkeypatch):
    """The range is entered only where the profiler records the calling
    thread: in its events with the profiler on, absent with it off and
    from a thread that did not start it."""
    entered = []
    real = torch.autograd.profiler.record_function

    def spy(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", spy)
    with profiling.span("dgp.feed.wait"):
        pass
    assert entered == []

    def other():
        with profiling.span("dgp.feed.wait"):
            pass

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("dgp.feed.wait"):
            pass
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    assert entered == ["dgp.feed.wait"]
    names = [e.name for e in prof.events()]
    assert names.count("dgp.feed.wait") == 1
    # every span was timed, whether or not it became a range
    assert [r.seq for r in profiling.spans()["dgp.feed.wait"]] == [0, 1, 2]


def test_feed_spans_a_batch_and_counts_a_starved_get(registry):
    """Ten frames in batches of 4 (the last padded): one assemble a batch,
    one wait a get, and a get made while the producer is held finds the
    queue empty."""
    hold = threading.Event()
    pf = feed(Ring(10, hold, hold_at=4))
    try:
        # batch 0 queued before the first get: that get is not starved
        for _ in range(3000):
            if not pf._q.empty():
                break
            time.sleep(0.01)
        start, n_valid, images = next(pf)
        assert (start, n_valid, images.shape) == (0, 4, (4, 6, 8, 3))
        assert profiling.counters() == {}
        # the producer waits at frame 4, so the queue is empty at the
        # next get, which lets it go on
        get = pf._q.get

        def release_then_get(*args, **kwargs):
            hold.set()
            return get(*args, **kwargs)

        pf._q.get = release_then_get
        assert next(pf)[:2] == (4, 4)
        assert profiling.counters() == {"dgp.feed.starved": 1}
        last = next(pf)
        assert last[:2] == (8, 2)
        assert np.array_equal(last[2][3].numpy(), last[2][1].numpy())
        with pytest.raises(StopIteration):
            next(pf)
    finally:
        pf.close()
    got = profiling.spans()
    assert set(got) == set(FEED)        # no pin: the batches stay on the CPU
    assert [r.seq for r in got["dgp.feed.assemble"]] == [0, 1, 2]
    assert [r.seq for r in got["dgp.feed.wait"]] == [0, 1, 2, 3]
    main = threading.get_native_id()
    assert {r.thread for r in got["dgp.feed.wait"]} == {main}
    assert main not in {r.thread for r in got["dgp.feed.assemble"]}
    assert 1 <= profiling.counters()["dgp.feed.starved"] <= 3


@pytest.fixture(scope="module")
def traced_feed(tmp_path_factory):
    """The feed over 24 frames in batches of 4 under ``profiling.trace``,
    with a little CPU work a batch in the consumer: the trace's events,
    the spans file and the consumer's thread."""
    profiling.reset()
    logdir = tmp_path_factory.mktemp("tb")
    with profiling.trace(logdir):
        pf = feed(Ring(24))
        try:
            for _, _, images in pf:
                (images.float() * 2).sum()
        finally:
            pf.close()
    profiling.reset()
    (path,) = logdir.glob("trace-*.json")
    (summary,) = logdir.glob("spans-*.json")
    assert summary.name[len("spans-"):] == path.name[len("trace-"):]
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    return events, json.loads(summary.read_text()), threading.get_native_id()


def test_trace_writes_the_spans_and_the_producer_thread(traced_feed):
    events, summary, main = traced_feed
    spans = summary["spans"]
    assert spans["dgp.feed.assemble"]["count"] == 6
    assert spans["dgp.feed.wait"]["count"] == 7        # 6 batches, the end
    for s in spans.values():
        assert s["total_ms"] == pytest.approx(s["mean_ms"] * s["count"])
    assert summary["counters"].get("dgp.feed.starved", 0) <= 7
    waits = [e for e in events if e["name"] == "dgp.feed.wait"]
    assert len(waits) == 7 and {e["tid"] for e in waits} == {main}
    assembled = [e for e in events if e["name"] == "dgp.feed.assemble"]
    if profiling._all_threads_config() is None:
        assert assembled == []          # this torch records one thread
    else:
        assert len(assembled) == 6
        assert main not in {e["tid"] for e in assembled}


def test_no_feed_range_holds_an_aten_op(traced_feed):
    """On a card an aten op may launch a kernel or enqueue a copy; on the
    CPU none runs inside a ``dgp.*`` range of its thread, though the
    consumer runs aten ops between its waits."""
    events, _, main = traced_feed
    ranges = [e for e in events if e["name"].startswith("dgp.")]
    aten = [e for e in events if e["name"].startswith("aten::")]
    assert ranges and any(e["tid"] == main for e in aten)
    for r in ranges:
        inside = [a["name"] for a in aten if a["tid"] == r["tid"]
                  and r["ts"] <= a["ts"] < r["ts"] + r["dur"]]
        assert inside == [], (r["name"], inside)


def test_estimate_pose_reports_its_gets(registry, tmp_path, capsys):
    """The closing line gives the call's starved gets of all its gets and
    its mean wait, from the call's own spans."""
    path = str(tmp_path / "v.avi")
    out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10, (40, 32))
    for i in range(10):
        out.write(np.full((32, 40, 3), 20 * i, np.uint8))
    out.release()
    for _ in range(5):                   # spans from before the call
        with profiling.span("dgp.feed.wait"):
            pass
    profiling.count("dgp.feed.starved", 5)
    cfg = PoseConfig(num_joints=2, net_type="mobilenet_v2_0.35")
    model = init_model(cfg, device="cpu")
    got = predict.estimate_pose(None, tmp_path / "s.ckpt", path, tmp_path,
                                pose_cfg=cfg, model=model, batch_size=4,
                                save_pose=False, device="cpu")
    assert got["x"].shape == (10, 2)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    starved = profiling.counters()["dgp.feed.starved"] - 5
    assert line.startswith("[estimate_pose] 10 frames in ")
    assert f"; {starved} of 4 gets found the queue empty, " in line
    assert line.endswith(" ms wait a get")

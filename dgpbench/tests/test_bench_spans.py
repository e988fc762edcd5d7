"""The host feed's readers of the program's spans and counter, on a
registry filled by hand: the set-up's spans left out, the starved share's
arithmetic, and None where there is nothing to read."""

import pytest

from dgpbench import harness, program_spans
from deepgraphpose_tpu_torch.utils import profiling

ROOT = harness.BENCH_DIR.parent
MEANS = {"feed_wait_ms_per_batch.infer": "dgp.feed.wait",
         "feed_assemble_ms_per_batch.infer": "dgp.feed.assemble",
         "feed_pin_ms_per_batch.infer": "dgp.feed.pin"}
SHARE = "feed_starved_share.infer"
TRACE = {"traffic": {"warmup_batches": 2}}


@pytest.fixture
def registry():
    profiling.reset()
    yield profiling.REGISTRY
    profiling.reset()


def read(name):
    return harness.load_metric(ROOT, name).read(TRACE)


@pytest.mark.parametrize("metric", sorted(MEANS))
def test_mean_leaves_out_the_setup(registry, metric):
    # the set-up's two spans take 1 s each, the window's 3 ms and 5 ms
    for ms in (1000, 1000, 3, 5):
        registry.add(MEANS[metric], 10 ** 9, 10 ** 9 + ms * 10 ** 6)
    registry.add("dgp.other", 0, 10 ** 9)
    assert read(metric) == pytest.approx(4.0)


def test_starved_share_counts_every_get(registry):
    for _ in range(8):
        registry.add("dgp.feed.wait", 0, 1)
    profiling.count("dgp.feed.starved", 3)
    assert read(SHARE) == pytest.approx(37.5)


def test_starved_share_reads_the_count_past_the_cap():
    reg = profiling.Registry(cap=4)
    for _ in range(10):
        reg.add("dgp.feed.wait", 0, 1)
    reg.count("dgp.feed.starved", 5)
    real = program_spans.registry
    program_spans.registry = lambda: reg
    try:
        assert read(SHARE) == pytest.approx(50.0)
    finally:
        program_spans.registry = real


@pytest.mark.parametrize("metric", sorted(MEANS) + [SHARE])
def test_nothing_to_read(registry, metric, monkeypatch):
    assert read(metric) is None
    # spans of the set-up alone, or of other names
    registry.add("dgp.feed.wait", 0, 1)
    registry.add("dgp.feed.assemble", 0, 1)
    registry.add("dgp.feed.pin", 0, 1)
    registry.add("dgp.other", 0, 1)
    if metric != SHARE:
        assert read(metric) is None
    # a program that keeps no registry, as before the spans came
    monkeypatch.delattr(profiling, "spans")
    assert read(metric) is None

"""The reader of ``bn_fused_share.infer`` on a registry filled by hand:
None where the program keeps neither counter, else the fused share."""

import pytest

from dgpbench import harness
from deepgraphpose_tpu_torch.utils import profiling

ROOT = harness.BENCH_DIR.parent
NAME = "bn_fused_share.infer"


@pytest.fixture
def registry():
    profiling.reset()
    yield profiling.REGISTRY
    profiling.reset()


def read():
    return harness.load_metric(ROOT, NAME).read({})


@pytest.mark.parametrize("fused,plain,share", [
    (53, 0, 100.0), (0, 17, 0.0), (3, 1, 75.0), (106, 0, 100.0)])
def test_share(registry, fused, plain, share):
    if fused:
        profiling.count("dgp.bn.fused", fused)
    if plain:
        profiling.count("dgp.bn.plain", plain)
    assert read() == pytest.approx(share)


def test_nothing_to_read(registry, monkeypatch):
    assert read() is None
    profiling.count("dgp.feed.starved", 3)      # other counters alone
    assert read() is None
    monkeypatch.delattr(profiling, "spans")     # no registry at all
    assert read() is None

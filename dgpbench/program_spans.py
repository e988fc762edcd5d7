"""The program's own spans and counters: the registry of
``deepgraphpose_tpu_torch/utils/profiling.py``, read in the benchmark's
process after the cell's run, as ``run.py`` reads ``launch_counts()``.

Spans of one batch share a sequence number, so a reader leaves out the
set-up by number: the first ``warmup_batches`` of each name. A program
that keeps no such registry gives nothing to read, and the readers
return None.
"""

from __future__ import annotations


def registry():
    """The program's profiling module, or None where it keeps no spans."""
    from deepgraphpose_tpu_torch.utils import profiling

    return profiling if hasattr(profiling, "spans") else None


def mean_ms(trace: dict, name: str) -> float | None:
    """Mean duration of the spans ``name`` after the set-up's, ms."""
    prof = registry()
    if prof is None:
        return None
    skip = trace["traffic"]["warmup_batches"]
    ns = [r.end_ns - r.start_ns for r in prof.spans().get(name, ())
          if r.seq >= skip]
    return 1e-6 * sum(ns) / len(ns) if ns else None

"""Host ms a batch in its staging copy into pinned memory, on the
prefetcher's thread: the program's span ``dgp.feed.pin`` around
``pin_memory()`` in ``data/prefetch.py::host_to_device`` (to a card
only; the copy's enqueue that follows is outside it), averaged over the
batches after the set-up's."""

from dgpbench import program_spans


def read(trace):
    return program_spans.mean_ms(trace, "dgp.feed.pin")

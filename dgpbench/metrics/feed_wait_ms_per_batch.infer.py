"""Host ms a batch that the loop's thread, the one that issues the card's
work, stood waiting for the next batch of the prefetcher: the program's
span ``dgp.feed.wait`` around the queue's get in
``data/prefetch.py::DevicePrefetcher.__next__``, averaged over the gets
after the set-up's."""

from dgpbench import program_spans


def read(trace):
    return program_spans.mean_ms(trace, "dgp.feed.wait")

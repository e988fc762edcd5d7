"""Host ms a batch in the ``np.stack`` of its frames, on the prefetcher's
thread: the program's span ``dgp.feed.assemble`` in
``infer/predict.py::_batch_producer``, averaged over the batches after
the set-up's."""

from dgpbench import program_spans


def read(trace):
    return program_spans.mean_ms(trace, "dgp.feed.assemble")

"""Share of the prefetcher's gets that found its queue empty, so that the
loop's thread waited on the producer, %: the program's counter
``dgp.feed.starved`` over the number of ``dgp.feed.wait`` spans, over
every get of the run. The set-up's gets are included: at most
``warmup_batches`` (8) of more than 300."""

from dgpbench import program_spans


def read(trace):
    prof = program_spans.registry()
    if prof is None:
        return None
    waits = prof.spans().get("dgp.feed.wait")
    if not waits:
        return None
    gets = waits[-1].seq + 1
    return 100.0 * prof.counters().get("dgp.feed.starved", 0) / gets

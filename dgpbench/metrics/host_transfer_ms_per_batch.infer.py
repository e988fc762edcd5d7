"""Host ms a batch in ``data/prefetch.py::host_to_device`` (pinning the
uint8 batch and enqueueing its copy), the benchmark's span around the
call in the transfer it hands ``DevicePrefetcher``, averaged over the
window's batches."""


def read(trace):
    spans = trace["host_spans"]["host_to_device"]
    return 1e3 * sum(spans) / len(spans) if spans else None

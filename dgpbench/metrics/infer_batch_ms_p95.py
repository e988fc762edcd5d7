"""The 95th percentile over the window's batches of the time from a
batch's host frames being handed to the prefetcher to its poses being
numpy on the host, ms (the traced run's whole window). About two batch
times where the host's producer is the slower stage and the queue runs
empty, four to five where the card is and the queue is full."""


def read(trace):
    return trace["batch_ms_p95"]

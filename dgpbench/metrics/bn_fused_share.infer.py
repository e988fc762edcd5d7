"""Share of the float model's batch-norm calls in inference that one
launch of the frozen-BN tail kernel served, %: the program's counter
``dgp.bn.fused`` over it and ``dgp.bn.plain`` (calls that ran the plain
chain of PyTorch ops), over the whole run, set-up included. A program
that keeps neither counter gives nothing to read."""

from dgpbench import program_spans


def read(trace):
    prof = program_spans.registry()
    if prof is None:
        return None
    counts = prof.counters()
    fused = counts.get("dgp.bn.fused", 0)
    total = fused + counts.get("dgp.bn.plain", 0)
    return 100.0 * fused / total if total else None

"""Share of the traced sub-window in which no operation ran on the card
(100 - the union of kernel and copy intervals over the wall time), %."""


def read(trace):
    return 100.0 * (1.0 - trace["busy_s"] / trace["wall_s"])

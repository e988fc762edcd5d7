"""The window's frames over its wall time, frames/s, in a cell where the
host's producer paces the loop and the rate swings with the host's speed
from run to run more than a bound can hold: ``infer_frames_per_s`` of
the traced run, reported here and not end to end."""


def read(trace):
    return trace["frames_per_s"]

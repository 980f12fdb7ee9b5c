"""The host's wait for a frame's results on the host clock: the
program's `detect.wait` span around the result event's wait, median over
the profiled stretch's frames."""

from ._spans import median_per_call

UNIT = "ms"


def read(run, name):
    return median_per_call("detect.wait")

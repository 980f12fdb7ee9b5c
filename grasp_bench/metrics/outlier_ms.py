"""The radius-outlier test on the device clock: the device time of the
program's `prep.outlier` spans, summed over a call's scenes, median over
the profiled stretch's calls."""

from ._spans import median_per_call

UNIT = "ms"


def read(run, name):
    return median_per_call("prep.outlier", "device_ms")

"""A frame's submit on the host clock: the program's `detect.submit`
span (fit, prep, model and post enqueued, the host's waits inside),
median over the profiled stretch's frames."""

from ._spans import median_per_call

UNIT = "ms"


def read(run, name):
    return median_per_call("detect.submit")

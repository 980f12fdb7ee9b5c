"""The train step's backward on the host clock: the program's
`train.backward` span, median over the profiled stretch's steps (beside
`backward_device_ms`, it shows whether the backward is host-bound)."""

from ._spans import median_per_call

UNIT = "ms"


def read(run, name):
    return median_per_call("train.backward")

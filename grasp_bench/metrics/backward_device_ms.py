"""The train step's backward (K8 included) on the device clock: the device
time of the program's `train.backward` span (between two CUDA events,
nothing synchronized), median over the profiled stretch's steps."""

from ._spans import median_per_call

UNIT = "ms"


def read(run, name):
    return median_per_call("train.backward", "device_ms")

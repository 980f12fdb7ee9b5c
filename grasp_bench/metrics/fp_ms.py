"""The model's feature propagation on the device clock: the device time
of the program's `model.fp` spans (each FP stage's 3-NN, interpolation,
edge rows and their mean where it is an edge stage, and MLP), summed over
a call's forwards, median over the profiled stretch's calls."""

from ._spans import median_per_call

UNIT = "ms"


def read(run, name):
    return median_per_call("model.fp", "device_ms")

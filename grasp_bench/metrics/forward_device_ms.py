"""The train step's forward pass and loss on the device clock: the device
time of the program's `train.forward_loss` span (between two CUDA events,
nothing synchronized), median over the profiled stretch's steps."""

from ._spans import median_per_call

UNIT = "ms"


def read(run, name):
    return median_per_call("train.forward_loss", "device_ms")

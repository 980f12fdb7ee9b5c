"""The model's set abstraction after its sampling, on the device clock:
the device time of the program's `model.sa` spans (each SA stage's ball
query, grouping with its edge features where it has them, MLP and pool),
summed over a call's forwards, median over the profiled stretch's
calls."""

from ._spans import median_per_call

UNIT = "ms"


def read(run, name):
    return median_per_call("model.sa", "device_ms")

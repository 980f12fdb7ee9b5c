"""The model's sampling on the device clock: the device time of the
program's `model.sample` spans (each SA stage's FPS and centroid gather,
or the one nested K1 launch of every stage), summed over a call's
forwards, median over the profiled stretch's calls."""

from ._spans import median_per_call

UNIT = "ms"


def read(run, name):
    return median_per_call("model.sample", "device_ms")

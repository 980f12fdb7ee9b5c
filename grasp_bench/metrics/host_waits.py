"""The host's waits on the device a call: the program's `host_waits`
counter of its root span (`detect.submit` in a detect cell, `train.step`
in a train cell; the stage clock's synchronizes and the result's wait not
counted), median over the profiled stretch's calls."""

from ._spans import median_per_call

UNIT = "waits/call"


def read(run, name):
    root = "train.step" if name.endswith(".train") else "detect.submit"
    return median_per_call(root, "host_waits")

"""The train step's wait for its batch: the program's `loader.wait`
spans around the loader's queue, summed over a batch, median over the
profiled stretch's batches."""

from ._spans import median_per_call

UNIT = "ms"


def read(run, name):
    return median_per_call("loader.wait")

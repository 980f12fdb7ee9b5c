"""The loader's collation of one batch on the host clock: the program's
`loader.collate` span in the feeder thread (pickle loads, sampling,
`np.stack`), median over the batches drawn in the profiled stretch."""

from ._spans import median_per_call

UNIT = "ms"


def read(run, name):
    return median_per_call("loader.collate")

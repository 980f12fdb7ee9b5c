"""The 95th percentile of the wall time of every call completed in the
window, from the call to its grasps on the host (linear interpolation
between order statistics, `statistics.quantiles(..., method="inclusive")`)."""

import statistics

UNIT = "ms"


def p95(values):
    return statistics.quantiles(values, n=20, method="inclusive")[18]


def read(run, name):
    lat = [1e3 * (r["t1"] - r["t0"]) for r in run.records]
    return p95(lat) if len(lat) >= 2 else None

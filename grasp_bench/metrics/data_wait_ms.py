"""Median over the traced window's steps of the harness's host-clock span
around `next()` on the loader's iterator (the time a step waited for its
batch)."""

import statistics

UNIT = "ms"


def read(run, name):
    vals = run.spans.get("data_wait")
    return statistics.median(vals) if vals else None

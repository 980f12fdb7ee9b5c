"""Median over the traced window's steps of the harness's synchronized span
around the trainer instance's `update` (Adam)."""

import statistics

UNIT = "ms"


def read(run, name):
    vals = run.spans.get("optimizer")
    return statistics.median(vals) if vals else None

"""The program's synchronized stage clock `GraspDetector.timings
["post_ms"]`, median over the window's calls (per call of the cell's
batch)."""

import statistics

UNIT = "ms"


def read(run, name):
    vals = [r["timings"]["post_ms"] for r in run.records
            if "post_ms" in r.get("timings", {})]
    return statistics.median(vals) if vals else None

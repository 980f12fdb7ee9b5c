"""Samples of every train step completed in the window over the window's
seconds (a synchronize closes the window; the loader runs throughout)."""

UNIT = "samples/s"


def read(run, name):
    span = run.window[1] - run.window[0]
    samples = sum(r["items"] for r in run.records)
    return samples / span if span > 0 and samples else None

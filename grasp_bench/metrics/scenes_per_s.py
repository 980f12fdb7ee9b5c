"""Scenes whose grasps reached the host in the window over the window's
seconds (from its start to the last completion)."""

UNIT = "scenes/s"


def read(run, name):
    span = run.window[1] - run.window[0]
    scenes = sum(r["items"] for r in run.records)
    return scenes / span if span > 0 and scenes else None

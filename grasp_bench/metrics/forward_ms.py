"""Median over the traced window's steps of the harness's synchronized span
around the trainer instance's `forward_loss` (augmentation, the train-mode
forward, the losses)."""

import statistics

UNIT = "ms"


def read(run, name):
    vals = run.spans.get("forward")
    return statistics.median(vals) if vals else None

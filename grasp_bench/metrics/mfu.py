"""The whole step's share of the card's peak: the model FLOPs of the
scenes (samples) completed in the window (`flops.py`, 3x a forward for a train
step) over the window's seconds times the bf16 dense peak (989 TFLOP/s
at 700 W; the run prints the card's power limit beside it)."""

from ..peaks import MFU_PEAK

UNIT = "%"


def read(run, name):
    span = run.window[1] - run.window[0]
    items = sum(r["items"] for r in run.records)
    if span <= 0 or not items:
        return None
    return 100.0 * items * run.flops_per_item / (span * MFU_PEAK)

"""Host waits on the device per submitted frame: warnings of
`torch.cuda.set_sync_debug_mode("warn")` raised inside the detector's
`_submit`, which the traced run wraps; the mean over the window's
submits."""

UNIT = "syncs/frame"


def read(run, name):
    return sum(run.syncs) / len(run.syncs) if run.syncs else None

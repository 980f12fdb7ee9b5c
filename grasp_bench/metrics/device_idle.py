"""1 - the union of the device's kernel, copy and set intervals over the
profiled stretch's length (host clock between two synchronizations)."""

UNIT = "%"


def read(run, name):
    prof = run.profile
    if not prof or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])

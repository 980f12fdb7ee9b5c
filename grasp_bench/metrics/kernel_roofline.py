"""The port kernels' share of their roofline over the profiled stretch:
the sum of each launch's least time (`counts/<kernel>.py`, `peaks.py`)
over the sum of those kernels' device time in the trace.  A kernel with
no counts file, or launched by a route that left no record, is in
neither sum: `kernel_unattributed` reports its share."""

import importlib
import re

from ..peaks import bound_s

UNIT = "%"


def _counts(kernel):
    try:
        return importlib.import_module(f"grasp_bench.counts.{kernel}")
    except ModuleNotFoundError:
        return None


def matches(kname: str, name: str) -> bool:
    """Whether trace kernel `kname` is the device kernel `name` (the whole
    name, at the start or after a space or a scope)."""
    return re.search(rf"(?:^|[\s:]){re.escape(name.lstrip(':'))}\b",
                     kname) is not None


def attributed(launches, model_cfg) -> tuple:
    """(the recorded launches' summed least time in s, the device kernel
    names of the kernels they launched that have a counts file)."""
    bound, names = 0.0, set()
    for kernel, args in launches:
        mod = _counts(kernel)
        if mod is not None:
            bound += bound_s(mod.work(args, model_cfg))
            names.update(mod.NAMES)
    return bound, names


def read(run, name):
    prof = run.profile
    if not prof:
        return None
    bound, names = attributed(prof["launches"], run.model_cfg)
    time_s = 1e-6 * sum(dur for kname, dur in prof["kernels"]
                        if any(matches(kname, n) for n in names))
    return 100.0 * bound / time_s if time_s > 0 else None

"""The share of the port kernels' device time over the profiled stretch
that `kernel_roofline` leaves out: time of kernels the program's sources
define (`devtrace.port_kernel_names`) that have no counts file, or whose
launches left no record (a route past `_build.launch`).  Each such kernel
is named on standard error."""

import sys

from .kernel_roofline import attributed, matches
from ..devtrace import port_kernel_names

UNIT = "%"


def read(run, name):
    prof = run.profile
    if not prof:
        return None
    _, names = attributed(prof["launches"], run.model_cfg)
    port = port_kernel_names()
    total = left = 0.0
    missed = set()
    for kname, dur in prof["kernels"]:
        if not any(matches(kname, p) for p in port):
            continue
        total += dur
        if not any(matches(kname, n) for n in names):
            left += dur
            missed.add(kname[:120])
    for kname in sorted(missed):
        print(f"{name}: no counts for {kname}", file=sys.stderr)
    return 100.0 * left / total if total > 0 else None

"""The readers of the program's spans and counters: the median over the
profiled stretch's calls of `s4g_tpu_torch.utils.profiling.per_call`
(the program records its spans only while a profiler records, so the
stretch's calls are all it holds).  None where nothing was recorded, or
where the program has no span recorder."""

import statistics


def median_per_call(span: str, what: str = "host_ms"):
    from s4g_tpu_torch.utils import profiling
    per_call = getattr(profiling, "per_call", None)
    vals = per_call(span, what) if per_call else []
    return statistics.median(vals) if vals else None

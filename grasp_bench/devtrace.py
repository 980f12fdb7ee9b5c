"""Reading the device from a torch.profiler trace: device busy time as the
union of kernel, copy and set intervals, the longest idle gaps by what
the host was doing, device time by kernel; and the port's kernel launches
(name and arguments), taken by wrapping the program's launcher while a
stretch is profiled."""

from __future__ import annotations

import contextlib
import functools
import glob
import json
import os
import re
import time
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
TOP = 10


def union_us(intervals: list) -> tuple:
    """Merged [start, end) intervals of (start, duration) pairs, and the
    total they cover."""
    merged = []
    for ts, dur in sorted(intervals):
        if merged and ts <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], ts + dur)
        else:
            merged.append([ts, ts + dur])
    return merged, sum(e - s for s, e in merged)


def _host_at(host: list, start: float, mid: float) -> str:
    """What the busiest host thread was doing in a device gap: its
    innermost event running at the gap's middle, else the last event that
    ended before the gap (the host then ran Python or numpy of its own)."""
    inside = [(dur, name) for ts, dur, name in host if ts <= mid <= ts + dur]
    if inside:
        return min(inside)[1]
    before = [(ts + dur, name) for ts, dur, name in host if ts + dur <= start]
    return f"after {max(before)[1]}" if before else "before any op"


def read_trace(path: str) -> dict:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device, kernels, by_tid = [], [], defaultdict(list)
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            device.append((float(e["ts"]), float(e["dur"])))
            kernels.append((e["name"], float(e["dur"])))
        elif cat in HOST_CATS:
            by_tid[e.get("tid")].append((float(e["ts"]), float(e["dur"]),
                                         e["name"]))
    merged, busy_us = union_us(device)
    host = max(by_tid.values(), key=len) if by_tid else []
    gaps = sorted(((b[0] - a[1], a[1]) for a, b in zip(merged, merged[1:])),
                  reverse=True)[:TOP]
    by_name = defaultdict(float)
    for name, dur in kernels:
        by_name[name[:120]] += dur
    return {"busy_s": busy_us * 1e-6, "kernels": kernels,
            "device_ops": [[n, d * 1e-6] for n, d in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:TOP]],
            "idle_gaps": [[f"host: {_host_at(host, a, a + g / 2)}", g * 1e-6]
                          for g, a in gaps]}


PROGRAM = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "s4g_tpu_torch")
_CUDA_KERNEL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")
_TRITON_KERNEL = re.compile(r"@triton\.jit[^\n]*\n\s*def\s+(\w+)")


@functools.lru_cache(maxsize=None)
def port_kernel_names() -> tuple:
    """The names of the device kernels the program's sources define: each
    `__global__` function of its CUDA sources and each `@triton.jit`
    function of its Python."""
    names = set()
    for pattern, regex in (("**/*.cu", _CUDA_KERNEL),
                           ("**/*.cuh", _CUDA_KERNEL),
                           ("**/*.py", _TRITON_KERNEL)):
        for path in glob.glob(os.path.join(PROGRAM, pattern),
                              recursive=True):
            with open(path, errors="replace") as f:
                names.update(regex.findall(f.read()))
    return tuple(sorted(names))


@contextlib.contextmanager
def launches(record: list):
    """Append (kernel, args) of every port kernel launch to `record`."""
    from s4g_tpu_torch import _build
    original = _build.launch

    def launch(kernel, *args):
        record.append((kernel, args))
        return original(kernel, *args)

    _build.launch = launch
    try:
        yield record
    finally:
        _build.launch = original


def profile(fn, workdir: str) -> dict:
    """Run fn() under torch.profiler (host and CUDA), its launches
    recorded; the stretch is timed on the host between two device
    synchronizations.  Returns the trace's reading with "window_s" and
    "launches".  fn() runs once before, its launches recorded and
    dropped: the recorded arguments hold their memory, and without that
    round the allocator would grow (cudaMalloc) inside the stretch."""
    import torch
    from torch.profiler import ProfilerActivity
    with launches([]):
        fn()
    record = []
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof, launches(record):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    path = os.path.join(workdir, "trace.json")
    prof.export_chrome_trace(path)
    try:
        out = read_trace(path)
    finally:
        os.remove(path)
    return {**out, "window_s": window, "launches": record}

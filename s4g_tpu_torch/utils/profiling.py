"""Tracing + stage timing (port of s4g_tpu/utils/profiling.py).

The reference instruments with wall-clock deltas and per-run txt appends
(reference: grasp_detector.py:188-253, grasp_proposal_test.py:69-78,
file_logger_cls.py:202,234-235).  This module keeps those measurement points
(StageTimer + append_timing) and adds what the reference lacks:
torch.profiler traces (a Chrome trace of the host and the card's kernels)
and timing helpers that are correct over asynchronous CUDA launches (CUDA
events, CUDA-graph replays, synchronized host clocks).
"""

from __future__ import annotations

import contextlib
import logging
import os
import statistics
import tempfile
import time
from typing import Optional

import torch


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def sync(tree) -> None:
    """Block until every CUDA tensor in a nested structure (tensors inside
    dicts, lists and tuples) is computed: synchronizes each of their
    devices."""
    devices = {t.device for t in _leaves(tree) if t.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)


class StageTimer:
    """Named stage timing with the reference's log format."""

    def __init__(self, logger: Optional[logging.Logger] = None):
        self.logger = logger or logging.getLogger("S4G.profiling")
        self.stages: dict[str, float] = {}
        self._tic = time.perf_counter()
        self._start = self._tic

    def stage(self, name: str, result=None) -> float:
        """Mark the end of a stage; optionally sync on `result` first."""
        if result is not None:
            sync(result)
        now = time.perf_counter()
        elapsed = now - self._tic
        self._tic = now
        self.stages[name] = elapsed
        self.logger.info("%s finish, cost ***%.4fs***", name, elapsed)
        return elapsed

    def overall(self) -> float:
        total = time.perf_counter() - self._start
        self.logger.info("Overall time cost: ***%.4fs***", total)
        return total


def append_timing(filename: str, milliseconds: float) -> None:
    """Append one latency sample, reference txt format
    (grasp_proposal_test.py:77-78)."""
    with open(filename, "a+") as f:
        f.write("{:.4f}\n".format(milliseconds))


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None, enabled: bool = True):
    """torch.profiler trace context: records the host's ops and, where a GPU
    is present, the card's kernels, and writes a Chrome trace
    (`trace_<pid>_<ns>.json`, for chrome://tracing or Perfetto) into
    `log_dir` (default: `s4g_trace` in the temporary directory).  Yields the
    profiler (its `key_averages()` hold the device times; after the block
    its `trace_file` is the trace's path), or None when not `enabled`."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "s4g_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.trace_file = os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(prof.trace_file)


@contextlib.contextmanager
def annotate(name: str):
    """Named region inside a trace (shows up on the trace's timeline)."""
    with torch.profiler.record_function(name):
        yield


def device_kernel_times(prof) -> list:
    """Device time by kernel name of a torch.profiler run: [(ms, count,
    name)], largest first; only device-side events (kernels and copies:
    the host-side aten:: events carry their kernels' time too), without user
    annotations (an optimizer's step range spans kernels counted on their
    own).  Empty when the profiler recorded no device time."""
    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and dev_us(e) > 0]
    return sorted(((dev_us(e) / 1e3, e.count, e.key) for e in rows),
                  reverse=True)


def event_times(fn, reps: int = 20, warmup: int = 2) -> list:
    """ms of each of `reps` calls of fn() on the card after `warmup`, each
    between two CUDA events (host work inside the call included: the
    device waits for it)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def event_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Median of `event_times`."""
    return statistics.median(event_times(fn, reps, warmup))


def graph_ms(fn, reps: int = 20, per_graph: int = 10) -> float:
    """Median device time of one fn() launch: `per_graph` launches captured
    in a CUDA graph, the replay timed with CUDA events, `reps` times.  fn
    must not wait on the device (no host synchronization)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_graph)
    return statistics.median(times)


def wall_times(fn, device: torch.device, reps: int = 10,
               warmup: int = 2) -> list:
    """ms of each of `reps` calls of fn() after `warmup` on a host clock,
    each call ended by a synchronization of `device` (a CUDA device; on
    the CPU nothing is pending)."""
    def run():
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    for _ in range(warmup):
        run()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        times.append(1e3 * (time.perf_counter() - t0))
    return times


def timed_scalar(fn, *args, iters: int = 10) -> float:
    """Per-call seconds for a fn returning a scalar tensor: warms up,
    loops, syncs by fetching the final scalar (`.item()`: the device runs
    its launches in order, so the last one's value waits for them all)."""
    fn(*args).item()
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = fn(*args)
    out.item()
    return (time.perf_counter() - t0) / iters

"""Tracing + stage timing (port of s4g_tpu/utils/profiling.py).

The reference instruments with wall-clock deltas and per-run txt appends
(reference: grasp_detector.py:188-253, grasp_proposal_test.py:69-78,
file_logger_cls.py:202,234-235).  This module keeps the txt appends
(`append_timing`) and adds what the reference lacks: torch.profiler traces
(a Chrome trace of the host and the card's kernels), the program's spans
and counters on the profiler's clock, and timing helpers that are correct
over asynchronous CUDA launches (CUDA events, CUDA-graph replays,
synchronized host clocks).

Spans.  `span(name)` marks a stage of the program.  It records only while
a torch.profiler records (`trace()`, or any `torch.profiler.profile`);
otherwise it is one flag check and a shared no-op context.  A recorded
span also opens a `torch.profiler.record_function`, so the Chrome trace
holds it as a `user_annotation` on the kernels' clock.  The spans stay in
memory, in a ring of `SPAN_CAPACITY`, read by `spans()` and `per_call()`.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import statistics
import tempfile
import threading
import time
import warnings
from typing import Optional

import torch
from torch.autograd import profiler as _autograd_profiler

SPAN_CAPACITY = 65536
_SPANS: collections.deque = collections.deque(maxlen=SPAN_CAPACITY)
_OPEN = threading.local()          # each thread's stack of open spans
_CALLS = itertools.count()         # ids of calls that no caller named
_OFF = contextlib.nullcontext()
# What torch.cuda.set_sync_debug_mode("warn") says of each host wait.
_SYNC_WARNING = "called a synchronizing CUDA operation"


def _is_cuda(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


class Span:
    """One recorded span: its `name`, the `parent` span's name on the same
    thread (None for a root), the `call` id (the request it serves), the
    `thread`'s name, host start and end (`t0`, `t1`,
    `time.perf_counter_ns`), a pair of CUDA `events` recorded on the
    current stream at its ends (None without a CUDA `device`) and the
    `counts` added inside it."""

    __slots__ = ("name", "parent", "call", "thread", "t0", "t1", "events",
                 "counts", "_waits", "_record", "_caught", "_log", "_mode")

    def __init__(self, name: str, call=None, device=None, waits=None):
        self.name, self.call = name, call
        self.parent = self.thread = self.t0 = self.t1 = None
        self.events = ((torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
                       if _is_cuda(device) else None)
        self.counts: dict = {}
        self._waits = _is_cuda(waits)

    @property
    def host_ms(self) -> Optional[float]:
        return None if self.t1 is None else (self.t1 - self.t0) / 1e6

    def device_ms(self) -> Optional[float]:
        """Device time between the span's two events (waits for the
        second); None without events or before the span ended."""
        if self.events is None or self.t1 is None:
            return None
        start, end = self.events
        end.synchronize()
        return start.elapsed_time(end)

    def __enter__(self) -> "Span":
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        if stack:
            self.parent = stack[-1].name
            if self.call is None:
                self.call = stack[-1].call
        elif self.call is None:
            self.call = next(_CALLS)
        self.thread = threading.current_thread().name
        self._record = torch.profiler.record_function(self.name)
        self._record.__enter__()
        if self._waits:
            self._caught = warnings.catch_warnings(record=True)
            self._log = self._caught.__enter__()
            warnings.filterwarnings("always", message=_SYNC_WARNING)
            self._mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        if self.events is not None:
            self.events[0].record()
        stack.append(self)
        _SPANS.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record()
        if self._waits:
            torch.cuda.set_sync_debug_mode(self._mode)
            self._caught.__exit__(None, None, None)
            waits = 0
            for w in self._log:
                if _SYNC_WARNING in str(w.message):
                    waits += 1
                else:
                    warnings.warn_explicit(w.message, w.category,
                                           w.filename, w.lineno,
                                           source=w.source)
            count("host_waits", waits)
        _OPEN.stack.pop()
        self._record.__exit__(*exc)


def span(name: str, call=None, device=None, waits=None):
    """A span of the program, recorded while a torch.profiler records (a
    no-op otherwise).  `call`: the id of the request it serves; by default
    the enclosing span's, or a new one for a root span.  `device`: where it
    is CUDA, the span's device time is taken between two CUDA events
    recorded on the current stream (read only by `Span.device_ms`).
    `waits`: where it is a CUDA device, the host's waits on the device
    inside the span (the warnings of `torch.cuda.set_sync_debug_mode
    ("warn")`: device values read on the host, copies from pageable
    memory; not `torch.cuda.synchronize()` or an event's wait) are counted
    as its `host_waits`.  Yields the Span, or None when off."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return Span(name, call, device, waits)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` of this thread's innermost open span
    (nothing when no span is open)."""
    stack = getattr(_OPEN, "stack", None)
    if stack:
        counts = stack[-1].counts
        counts[name] = counts.get(name, 0) + n


def spans() -> list:
    """The recorded spans, oldest first (at most SPAN_CAPACITY)."""
    return list(_SPANS)


def clear() -> None:
    """Forget the recorded spans."""
    _SPANS.clear()


def per_call(name: str, what: str = "host_ms") -> list:
    """One value a call, in call order, summed over the ended spans `name`
    of the call: `what` is "host_ms", "device_ms" or a counter's name.
    Spans without the value (no events, no such counter) add nothing."""
    sums: dict = {}
    for s in spans():
        if s.name != name or s.t1 is None:
            continue
        if what == "host_ms":
            value = s.host_ms
        elif what == "device_ms":
            value = s.device_ms()
        else:
            value = s.counts.get(what)
        if value is not None:
            sums[s.call] = sums.get(s.call, 0) + value
    return list(sums.values())


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
    its `trace_file` is the trace's path), or None when not `enabled`.
    Forgets the spans recorded before it (`clear`)."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    clear()

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

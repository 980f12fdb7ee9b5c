"""Measure FPS device time from a torch.profiler trace, one variant per
process (port of tools/measure_fps_sharded.py).

Times `ops.sampling.farthest_point_sample(points, M, num_shards=G)` on a
(1, 3, N) cloud of seeded normal points, each coordinate sorted (the JAX
tool's input), REPS times under `utils.profiling.trace`, and sums the
device time of every kernel the trace records: K1 (`csrc/fps_lane.cu`) at
G = 128, K6 (`csrc/fps_exact.cu`) at G = 1 and at other shard counts.

Usage: python -m s4g_tpu_torch.tools.measure_fps_sharded N M G
           [--trace-dir DIR] [--device cpu]
Prints the card's name and power limit, each kernel's ms per execution,
then "N=... M=... G=...: <ms> ms/exec (device)".
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from .common import add_device_arg, device_label, synchronize

REPS = 8                 # traced executions, after one warm-up


def main(argv=None) -> dict:
    """Returns {"n", "m", "g", "device", "device_ms_per_exec", "kernels":
    [(ms, count, name)] over the REPS executions}."""
    p = argparse.ArgumentParser()
    p.add_argument("n", type=int)
    p.add_argument("m", type=int)
    p.add_argument("g", type=int)
    p.add_argument("--trace-dir", default=None)
    add_device_arg(p)
    args = p.parse_args(argv)

    from ..ops.sampling import farthest_point_sample
    from ..runtime.device import resolve_device
    from ..utils.profiling import device_kernel_times, trace

    dev = resolve_device(args.device, "measure_fps_sharded")
    n, m, g = args.n, args.m, args.g
    trace_dir = args.trace_dir or os.path.join(
        tempfile.gettempdir(), f"s4g_fps_trace_{n}_{m}_{g}")
    rng = np.random.RandomState(0)
    pts = torch.from_numpy(
        np.sort(rng.randn(1, 3, n).astype(np.float32), axis=2)).to(dev)

    def fn():
        return farthest_point_sample(pts, m, num_shards=g)

    fn()                                    # warm-up (first launches)
    synchronize(dev)
    with trace(trace_dir) as prof:
        for _ in range(REPS):
            fn()
        synchronize(dev)
    rows = device_kernel_times(prof)
    ms = sum(r[0] for r in rows) / REPS
    label = device_label(dev)
    print(f"measure_fps_sharded ({label}): Chrome trace {prof.trace_file}")
    for k_ms, count, name in rows:
        print(f"{k_ms / REPS:9.4f} ms  x{count // REPS:<3d} {name[:90]}")
    if rows:
        print(f"N={n} M={m} G={g}: {ms:.3f} ms/exec (device)", flush=True)
    else:
        print(f"N={n} M={m} G={g}: no device time recorded ({label})",
              flush=True)
    return {"n": n, "m": m, "g": g, "device": label,
            "device_ms_per_exec": ms if rows else None, "kernels": rows}


if __name__ == "__main__":
    main()

"""Capture a torch.profiler trace of the deployment-scale forward (or of
the detect pipeline: forward, post-processing and collision check) and
print device time by kernel (port of tools/trace_forward.py).

The complement of profile_stages: that tool times each op alone, the trace
shows where the time goes inside the whole call (every kernel PyTorch and
the port launch, its count and device time).  The Chrome trace file
(chrome://tracing or Perfetto) is written into `--trace-dir`.

Usage: python -m s4g_tpu_torch.tools.trace_forward [--detect] [--batch B]
           [--top 40] [--scene PATH] [--json OUT] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch

from .common import (DEFAULT_CFG, add_device_arg, device_label, load_cloud,
                     seeded_model, synchronize)

REPS = 8                 # traced executions, after one warm-up


def print_kernel_times(rows: list, top: int, reps: int, json_out=None,
                       batch: int = 1) -> float:
    """Print the device time by kernel of `reps` executions (`rows` from
    `utils.profiling.device_kernel_times`), per execution; optionally dump
    the table as JSON.  Returns the device ms per execution."""
    total = sum(ms for ms, _, _ in rows)
    if not rows:
        print("=== the profiler recorded no device time (no GPU) ===")
    else:
        print(f"\n=== device kernel time: {total / reps:.3f} ms/exec "
              f"({reps} reps) ===")
    for ms, count, name in rows[:top]:
        print(f"{ms / reps:9.3f} ms  x{count // reps:<4d} {name[:90]}")
    if json_out:
        with open(json_out, "w") as f:
            json.dump({"batch": batch, "reps": reps,
                       "leaf_ms_per_exec": total / reps,
                       "ms_per_exec": {name: ms / reps
                                       for ms, _, name in rows}}, f)
        print(f"[json] per-kernel table -> {json_out}")
    return total / reps


def main(argv=None) -> dict:
    """Returns {"device", "trace_file", "device_ms_per_exec", "kernels":
    [(ms, count, name)] over the REPS executions}."""
    p = argparse.ArgumentParser()
    p.add_argument("--detect", action="store_true",
                   help="trace forward + post-processing + collision check "
                        "instead of the forward")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--top", type=int, default=40)
    p.add_argument("--trace-dir", default=os.path.join(
        tempfile.gettempdir(), "s4g_trace"))
    p.add_argument("--json", default=None,
                   help="also dump the per-kernel ms table as JSON")
    p.add_argument("--scene", default=None,
                   help="scene pickle to sample from (default: random "
                        "points)")
    p.add_argument("--cfg", default=DEFAULT_CFG)
    add_device_arg(p)
    args = p.parse_args(argv)

    from ..configs.config import load_cfg_from_file
    from ..pipeline.detector import post_one
    from ..runtime.device import resolve_device
    from ..utils.profiling import device_kernel_times, trace

    dev = resolve_device(args.device, "trace_forward")
    cfg = load_cfg_from_file(args.cfg)
    n = cfg.MODEL.PN2.NUM_INPUT
    rng = np.random.RandomState(0)
    if args.scene is None:
        base = (rng.rand(3, n) * 0.6 - 0.3).astype(np.float32)
    else:
        cloud = load_cloud(args.scene)
        base = cloud[:, rng.choice(cloud.shape[1], n,
                                   replace=cloud.shape[1] < n)]
    pts = torch.from_numpy(np.stack([base + np.float32(0.001 * i)
                                     for i in range(args.batch)])).to(dev)
    net = seeded_model(cfg, dev)

    if args.detect:
        cloud_t = pts[0].t().contiguous()                     # (N, 3)
        valid = torch.ones(n, dtype=torch.bool, device=dev)
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)

        def fn():
            with torch.no_grad():
                preds = net({"scene_points": pts[:1]})
                uniforms = torch.rand(5, generator=generator, device=dev)
                return post_one(cloud_t, {k: v[0] for k, v in preds.items()},
                                cloud_t, valid, uniforms, 0.3, -1.0,
                                min(1024, n))
    else:
        def fn():
            with torch.no_grad():
                return net({"scene_points": pts})

    fn()                                    # warm-up (first launches)
    synchronize(dev)
    with trace(args.trace_dir) as prof:
        for _ in range(REPS):
            fn()
            synchronize(dev)
    label = device_label(dev)
    print(f"trace_forward ({label}): {'detect' if args.detect else 'forward'}"
          f", batch {args.batch}; Chrome trace {prof.trace_file}")
    rows = device_kernel_times(prof)
    per_exec = print_kernel_times(rows, args.top, REPS, args.json,
                                  args.batch)
    return {"device": label, "trace_file": prof.trace_file,
            "device_ms_per_exec": per_exec, "kernels": rows}


if __name__ == "__main__":
    main()

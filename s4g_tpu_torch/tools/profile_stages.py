"""Per-op device time of the PN2_CLS forward at deployment scale (port of
tools/profile_stages.py).

One forward of the deployed model (curvature_model.yaml, seeded random
weights) runs with the ops it calls recorded, each with its inputs: the
FPS of the three SA stages (K1, one nested launch; K6 where the config
takes exact FPS), SA1's ball query with its grouping (K2 at batch 1), the
other ball queries (K2f), the fused SA1 stage (K3, at batch >= 2), the
feature groupings, the 3-NN searches (K4), the interpolations and every
SharedMLP chain.  Then each recorded call is timed alone on its own
inputs: a CUDA-graph replay of back-to-back calls where the call does not
wait on the device, else CUDA events around each call (host work
included), the median of REPS; the whole forward is timed with CUDA
events.  On the CPU a host clock times them.

Usage: python -m s4g_tpu_torch.tools.profile_stages [--batch B]
           [--scene PATH] [--cfg PATH] [--device cpu]
"""

from __future__ import annotations

import argparse
import statistics

import numpy as np
import torch

from .common import (DEFAULT_CFG, add_device_arg, call_times, device_label,
                     load_cloud, seeded_model)

REPS = 10


def _targets():
    """(owner, attribute, label) of every op the profile records."""
    from .. import ops
    from ..models import nn_layers, pn2_modules, pointnet2
    from ..ops import sa_fused
    return [(pointnet2, "fps_lane_nested", "fps"),
            (ops, "farthest_point_sample", "fps"),
            (ops, "ball_query_grouped", "ball_query+group"),
            (ops, "ball_query", "ball_query"),
            (sa_fused, "sa1_stage", "sa1_fused"),
            (pn2_modules, "group_cl", "group"),
            (ops, "three_nn", "three_nn"),
            (pn2_modules, "interpolate_cl", "interpolate"),
            (nn_layers.SharedMLP, "forward", "mlp")]


def record_ops(net, batch: dict) -> list:
    """Run net(batch) once with the ops of `_targets` recorded: [(label,
    fn, args, kwargs)] in call order, outermost calls only (an op called
    inside a recorded one is part of its time)."""
    calls, depth = [], [0]

    def recorder(fn, label):
        def call(*args, **kwargs):
            if depth[0] == 0:
                calls.append((label, fn, args, kwargs))
            depth[0] += 1
            try:
                return fn(*args, **kwargs)
            finally:
                depth[0] -= 1
        return call

    saved = [(owner, name, getattr(owner, name))
             for owner, name, _ in _targets()]
    try:
        for (owner, name, label), (_, _, fn) in zip(_targets(), saved):
            setattr(owner, name, recorder(fn, label))
        with torch.no_grad():
            net(batch)
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)
    return calls


def _waits_on_device(call) -> bool:
    """Whether call() synchronizes with the device (a host read of a
    device value), which a CUDA graph cannot capture."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        call()
    except RuntimeError as exc:
        if "synchroniz" not in str(exc):
            raise
        return True
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return False


def op_ms(call, dev: torch.device) -> tuple:
    """(median ms of one call(), how it was timed)."""
    from ..utils.profiling import graph_ms

    if dev.type == "cuda" and not _waits_on_device(call):
        return graph_ms(call, reps=REPS), "graph"
    how = "events" if dev.type == "cuda" else "host clock"
    return statistics.median(call_times(call, dev, REPS)), how


def _shapes(args) -> str:
    return " ".join(str(tuple(a.shape)) for a in args
                    if isinstance(a, torch.Tensor))


def main(argv=None) -> dict:
    """Returns {"device", "batch", "ops": [(name, ms, how)], "forward_ms",
    "ops_ms"}."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--scene", default=None,
                        help="scene pickle to sample from (default: random "
                             "points)")
    parser.add_argument("--cfg", default=DEFAULT_CFG)
    add_device_arg(parser)
    args = parser.parse_args(argv)

    from ..configs.config import load_cfg_from_file
    from ..runtime.device import resolve_device

    dev = resolve_device(args.device, "profile_stages")
    b = args.batch
    cfg = load_cfg_from_file(args.cfg)
    n = cfg.MODEL.PN2.NUM_INPUT
    rng = np.random.RandomState(0)
    if args.scene is None:
        pts_np = (rng.rand(3, n) * 0.6 - 0.3).astype(np.float32)
    else:
        cloud = load_cloud(args.scene)
        pts_np = cloud[:, rng.choice(cloud.shape[1], n,
                                     replace=cloud.shape[1] < n)]
    batch = {"scene_points": torch.from_numpy(
        np.broadcast_to(pts_np, (b, 3, n)).copy()).to(dev)}
    net = seeded_model(cfg, dev)
    label = device_label(dev)
    print(f"profile_stages ({label}): batch {b}, {n} points", flush=True)

    rows = []
    with torch.no_grad():
        for i, (name, fn, args_, kwargs) in enumerate(record_ops(net, batch)):
            ms, how = op_ms(lambda: fn(*args_, **kwargs), dev)
            tag = f"{i:2d} {name} {_shapes(args_)}"
            rows.append((tag, ms, how))
            print(f"{tag[:60]:60s} {ms:8.3f} ms  ({ms / b:7.3f} ms/scene, "
                  f"{how})", flush=True)

        def forward():
            net(batch)
        forward_ms = statistics.median(call_times(forward, dev, REPS))
    ops_ms = sum(ms for _, ms, _ in rows)
    by_op = {}
    for tag, ms, _ in rows:
        op = tag.split()[1]
        by_op[op] = by_op.get(op, 0.0) + ms
    for op, ms in sorted(by_op.items(), key=lambda kv: -kv[1]):
        print(f"{'  all ' + op:60s} {ms:8.3f} ms", flush=True)
    print(f"{'FULL forward':60s} {forward_ms:8.3f} ms", flush=True)
    print(f"{'sum of profiled ops':60s} {ops_ms:8.3f} ms", flush=True)
    print(f"{'residual (gathers, concatenations, heads, waits)':60s} "
          f"{forward_ms - ops_ms:8.3f} ms", flush=True)
    return {"device": label, "batch": b, "ops": rows,
            "forward_ms": forward_ms, "ops_ms": ops_ms}


if __name__ == "__main__":
    main()

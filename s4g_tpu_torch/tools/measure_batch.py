"""Per-scene time of the batched serving program (port of
tools/measure_batch.py).

Usage: python -m s4g_tpu_torch.tools.measure_batch [B] [--scene PATH]
           [--cfg PATH] [--device cpu]

Runs the deployment-config model (curvature_model.yaml: SORT_POINTS, 128
FPS shards, bf16 backbone; seeded random weights) on a (B, 3, 25600) batch
sampled from a scene pickle (random points without `--scene`) and times
(a) the model forward: CUDA events around each call, the median of REPS
after two warm-ups (the forward waits on the device for the ball query's
overflow flag, so it cannot be captured in a CUDA graph), and (b)
forward + post-processing of the top 1,024 points + collision check +
importance sampling (`pipeline.detector.post_batch`, the model input as
the view cloud): the median wall clock of REPS synchronized calls after
two warm-ups.  Prints one JSON line with the
JAX tool's keys (`batch`, `fwd_ms_per_scene`, `e2e_ms_per_scene`,
`scenes_per_sec`) plus `device` (the card's name and power limit) and
`input` (the scene's path or "random").

S4G_SORT_POINTS=0 (which also sets FPS_SHARDS 1: exact FPS through K6, the
parity route) and S4G_FPS_SHARDS=<n> change the config, as in the JAX
tool.  Run one batch size per process, alone on the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics

import numpy as np
import torch

from .common import (DEFAULT_CFG, add_device_arg, call_times, device_label,
                     load_cloud, seeded_model)

REPS = 10


def load_config(path: str):
    """The config at `path` with the S4G_SORT_POINTS / S4G_FPS_SHARDS
    settings of the environment applied."""
    from ..configs.config import load_cfg_from_file

    cfg = load_cfg_from_file(path)
    pn2_over = {}
    if os.environ.get("S4G_SORT_POINTS") is not None:
        on = os.environ["S4G_SORT_POINTS"] == "1"
        pn2_over["SORT_POINTS"] = on
        if not on:
            pn2_over["FPS_SHARDS"] = 1  # sharded FPS needs the sorted cloud
    if os.environ.get("S4G_FPS_SHARDS") is not None:
        pn2_over["FPS_SHARDS"] = int(os.environ["S4G_FPS_SHARDS"])
    if pn2_over:
        cfg = dataclasses.replace(cfg, MODEL=dataclasses.replace(
            cfg.MODEL, PN2=dataclasses.replace(cfg.MODEL.PN2, **pn2_over)))
    return cfg


def sample_points(scene, b: int, n: int) -> tuple:
    """(B, 3, n) float32 points: each scene n points drawn from the scene
    pickle's cloud (with replacement when it holds fewer than n), or
    uniform in a 0.6 m cube 1 m away without a scene; and the input's
    name."""
    rng = np.random.RandomState(0)
    if scene is None:
        points = (rng.rand(b, 3, n) * 0.6 - 0.3).astype(np.float32)
        points[:, 2] += 1.0
        return points, "random"
    cloud = load_cloud(scene)
    return np.stack([cloud[:, rng.choice(cloud.shape[1], n,
                                         replace=cloud.shape[1] < n)]
                     for _ in range(b)]), scene


def main(argv=None) -> dict:
    """Returns the printed JSON object."""
    parser = argparse.ArgumentParser()
    parser.add_argument("batch", type=int, nargs="?", default=1)
    parser.add_argument("--scene", default=None,
                        help="scene pickle to sample from (default: random "
                             "points)")
    parser.add_argument("--cfg", default=DEFAULT_CFG)
    add_device_arg(parser)
    args = parser.parse_args(argv)

    from ..pipeline.detector import post_batch
    from ..runtime.device import resolve_device
    from ..utils.profiling import wall_times

    dev = resolve_device(args.device, "measure_batch")
    b = args.batch
    cfg = load_config(args.cfg)
    net = seeded_model(cfg, dev)
    n = cfg.MODEL.PN2.NUM_INPUT
    points, source = sample_points(args.scene, b, n)
    batch = {"scene_points": torch.from_numpy(points).to(dev)}
    clouds = batch["scene_points"].transpose(1, 2).contiguous()
    valids = torch.ones(clouds.shape[:2], dtype=torch.bool, device=dev)
    generator = torch.Generator(device=dev)
    generator.manual_seed(0)

    def forward():
        with torch.no_grad():
            return net(batch)

    def detect():
        with torch.no_grad():
            preds = net(batch)
            uniforms = torch.rand((b, 5), generator=generator, device=dev)
            return post_batch(clouds, preds, clouds, valids, uniforms, 0.3,
                              -1.0, min(1024, n))

    fwd_ms = statistics.median(call_times(forward, dev, REPS))
    e2e_ms = statistics.median(wall_times(detect, dev, REPS))
    pn2 = cfg.MODEL.PN2
    out = {"batch": b, "fwd_ms_per_scene": fwd_ms / b,
           "e2e_ms_per_scene": e2e_ms / b, "scenes_per_sec": 1e3 * b / e2e_ms,
           "device": device_label(dev), "input": source,
           "sort_points": pn2.SORT_POINTS, "fps_shards": pn2.FPS_SHARDS}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()

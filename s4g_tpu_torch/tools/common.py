"""What the tools share: the device and its label, the default config,
seeded models, scene pickles and per-call timing."""

from __future__ import annotations

import argparse
import os
import subprocess

import numpy as np
import torch

from ..configs.config import Config
from ..models import build_model
from ..utils.profiling import event_times, wall_times

DEFAULT_CFG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "curvature_model.yaml")


def add_device_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda",
                        help='"cuda" (the default; fails without a GPU) or '
                             '"cpu"')


def device_label(dev: torch.device) -> str:
    """The card's name and power limit, as `nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader` gives them, or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def seeded_model(cfg: Config, dev: torch.device,
                 seed: int = 0) -> torch.nn.Module:
    """The config's model with a random init from `seed` (as GraspDetector
    makes it without weights), in eval mode on `dev`."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        net = build_model(cfg)
    return net.to(dev).eval()


def load_cloud(path: str) -> np.ndarray:
    """A scene pickle's "point_cloud", (3, n) float32."""
    data = np.load(path, allow_pickle=True)
    return np.asarray(data["point_cloud"], np.float32)


def call_times(fn, dev: torch.device, reps: int, warmup: int = 2) -> list:
    """ms of each of `reps` calls of fn() after `warmup`: CUDA events on a
    GPU, a host clock on the CPU."""
    if dev.type == "cuda":
        return event_times(fn, reps, warmup)
    return wall_times(fn, dev, reps, warmup)


def synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

"""Logging and windowed metric meters (a copy of s4g_tpu/utils/logger.py:
the port reads no module of the JAX package): a stream + file logger and a
dict of windowed-average meters that take numpy arrays, Python numbers and
CPU tensors.
"""

from __future__ import annotations

import logging
import os
import sys
import time
from collections import defaultdict, deque

import numpy as np

_FORMAT = "%(asctime)s %(name)s %(levelname)s: %(message)s"


def setup_logger(name: str, save_dir: str, prefix: str = "",
                 timestamp: bool = True) -> logging.Logger:
    """Logger writing to stdout and (when save_dir is set) a timestamped
    file under it."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.propagate = False

    handlers: list[logging.Handler] = [logging.StreamHandler(sys.stdout)]
    if save_dir:
        parts = ["log"]
        if prefix:
            parts.append(prefix)
        if timestamp:
            parts.append(time.strftime("%m_%d_%H_%M_%S"))
        handlers.append(logging.FileHandler(
            os.path.join(save_dir, ".".join(parts) + ".txt")))
    for handler in handlers:
        handler.setLevel(logging.INFO)
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
    return logger


def shutdown_logger(logger: logging.Logger) -> None:
    logger.handlers = []


class AverageMeter:
    """Windowed + global running average of a scalar series."""

    def __init__(self, window_size: int = 20):
        self._window_values = deque(maxlen=window_size)
        self._window_counts = deque(maxlen=window_size)
        self._total = 0.0
        self._n = 0

    def update(self, value: float, count: int = 1) -> None:
        self._window_values.append(value)
        self._window_counts.append(count)
        self._total += value
        self._n += count

    @property
    def avg(self) -> float:
        denom = sum(self._window_counts)
        return sum(self._window_values) / denom if denom else 0.0

    @property
    def global_avg(self) -> float:
        return self._total / self._n if self._n else 0.0

    # keep the reference's attribute names available
    count = property(lambda self: self._n)
    sum = property(lambda self: self._total)


class MetricLogger:
    """Dict of AverageMeters with the reference's string rendering."""

    def __init__(self, delimiter: str = "\t"):
        self.meters: dict[str, AverageMeter] = defaultdict(AverageMeter)
        self.delimiter = delimiter

    def update(self, **kwargs) -> None:
        for key, value in kwargs.items():
            arr = np.asarray(value)  # numpy / python / CPU tensor
            n = int(arr.size)
            self.meters[key].update(float(arr.sum()) if n != 1 else float(arr),
                                    n)

    def __getattr__(self, attr: str) -> AverageMeter:
        meters = object.__getattribute__(self, "meters")
        if attr in meters:
            return meters[attr]
        raise AttributeError(attr)

    def __str__(self) -> str:
        return self.delimiter.join(
            f"{name}: Avg: {m.avg:.4f} Global Avg: {m.global_avg:.4f}"
            for name, m in self.meters.items())

    @property
    def summary_str(self) -> str:
        return self.delimiter.join(
            f"{name}: {m.global_avg:.4f}" for name, m in self.meters.items())

"""Logging, SE(3) math, checkpoints, weights and viewers of the port."""

from .logger import setup_logger, shutdown_logger, AverageMeter, MetricLogger
from . import math_utils

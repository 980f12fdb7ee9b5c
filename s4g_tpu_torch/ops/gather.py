"""Gather/group ops (port of s4g_tpu/ops/gather.py, forward only)."""

from __future__ import annotations

import torch


def gather_points(points: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Gather channels for selected point indices.

    Args: points (B, C, N); index (B, M) indices into N.
    Returns: (B, C, M).
    """
    c = points.shape[1]
    return torch.gather(points, 2, index.long()[:, None, :].expand(-1, c, -1))


def group_points(points: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Group neighbour channels by index.

    Args: points (B, C, N); index (B, M, K) neighbour indices.
    Returns: (B, C, M, K).
    """
    b, c, _ = points.shape
    m, k = index.shape[1], index.shape[2]
    return gather_points(points, index.reshape(b, m * k)).reshape(b, c, m, k)

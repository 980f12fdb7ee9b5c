"""Rotation helpers of the models (port of s4g_tpu/models/functional.py).
Only `rot6d_to_mat9`, which the PN2 contact model's forward runs, is here;
the losses' helpers come with training (ROADMAP.md §1)."""

from __future__ import annotations

import torch


def rot6d_to_mat9(repre6d: torch.Tensor) -> torch.Tensor:
    """6-D rotation representation -> flattened 3x3 rotation, channels-first
    (port of `functional.py:102-121`).

    Input (B, 6, N): rows 0:3 the raw first column b1, rows 3:6 the raw
    second column a2.  Output (B, 9, N): the row-major flatten of
    R = [b1 | b2 | b1 x b2].  The norms are sqrt(sum + 1e-24) and a
    division, as in the JAX package (not rsqrt, which may round
    differently), so a zero column stays finite."""
    eps = 1e-24
    b1 = repre6d[:, 0:3]
    b1 = b1 / torch.sqrt(torch.sum(b1 * b1, dim=1, keepdim=True) + eps)
    a2 = repre6d[:, 3:6]
    b2 = a2 - torch.sum(a2 * b1, dim=1, keepdim=True) * b1
    b2 = b2 / torch.sqrt(torch.sum(b2 * b2, dim=1, keepdim=True) + eps)
    b3 = torch.linalg.cross(b1, b2, dim=1)
    r = torch.stack([b1, b2, b3], dim=2)       # (B, 3 rows, 3 cols, N)
    return r.reshape(r.shape[0], 9, -1)

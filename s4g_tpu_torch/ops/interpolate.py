"""3-NN feature interpolation (port of s4g_tpu/ops/interpolate.py).  Its
backward sums in a fixed order (`ops.gather.gather_rows`), as the JAX
package's XLA scatter-add does."""

from __future__ import annotations

import torch

from .gather import gather_points


def feature_interpolate(feature: torch.Tensor, index: torch.Tensor,
                        weight: torch.Tensor) -> torch.Tensor:
    """Inverse-distance-weighted 3-NN feature propagation, accumulated as
    ((t0 + t1) + t2) like the JAX package.

    Args: feature (B, C, N2); index (B, N1, K) into N2; weight (B, N1, K).
    Returns: (B, C, N1).
    """
    out = None
    for j in range(index.shape[-1]):
        term = gather_points(feature, index[:, :, j]) * weight[:, None, :, j]
        out = term if out is None else out + term
    return out


def interpolation_weights(distance: torch.Tensor,
                          eps: float = 1e-10) -> torch.Tensor:
    """Normalized inverse-distance weights from squared distances (B, N, 3)."""
    inv = 1.0 / torch.clamp(distance, min=eps)
    total = inv[..., 0:1] + inv[..., 1:2] + inv[..., 2:3]
    return inv / total

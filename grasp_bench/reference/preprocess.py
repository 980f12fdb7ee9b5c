"""Preprocessing of one camera cloud into the model's input, as the S4G
detector publishes it: pad to the capacity, rotate into the training
frame, average per 5 mm voxel, drop voxels with fewer than 32 voxels
within 2 cm (the voxel itself counted), and sample the model's number of
points without replacement (with replacement when too few are left).

Voxels are ordered by the detector's int32 voxel hash ((c0 * P + c1) * P
+ c2, wrapping), points binned by multiplying with the f32 reciprocal of
the voxel size; the sample takes the voxels with the largest of the
replayed uniforms (ties to the lower voxel), and with replacement the
replayed positions modulo the number kept.  Distances of the outlier test
are exact (float64)."""

from __future__ import annotations

import numpy as np
import torch

from . import geometry as geo
from .precision import F32_VALUES, Precision

_HASH_PRIME = 1_000_003
_INT32_MAX = 2 ** 31 - 1


def _wrap_int32(v: torch.Tensor) -> torch.Tensor:
    return torch.remainder(v + 2 ** 31, 2 ** 32) - 2 ** 31


def voxels(train: torch.Tensor, valid: torch.Tensor, prec: Precision):
    """Per-voxel means of the valid points, ordered by voxel hash: (V, 3)."""
    pts = train[valid]
    origin = pts.amin(dim=0)
    inv = geo.f32(1.0 / np.float32(geo.VOXEL_SIZE))
    coords = torch.floor(prec.round((pts - origin) * inv)).long()
    h = _wrap_int32(coords[:, 0] * _HASH_PRIME + coords[:, 1])
    ids = _wrap_int32(h * _HASH_PRIME + coords[:, 2])
    uniq, inverse = torch.unique(ids, sorted=True, return_inverse=True)
    sums = torch.zeros((len(uniq), 3), dtype=torch.float64,
                       device=train.device).index_add_(0, inverse,
                                                        pts.double())
    counts = torch.bincount(inverse, minlength=len(uniq)).double()
    return prec.round((sums / counts[:, None]).float())


def outlier_keep(vox: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """Voxels with at least 32 voxels (itself included) strictly within
    2 cm, on float64 distances."""
    r2 = geo.f32(geo.OUTLIER_RADIUS * geo.OUTLIER_RADIUS)
    v = vox.double()
    counts = []
    for q0 in range(0, len(v), chunk):
        q = v[q0:q0 + chunk]
        d = sum((q[:, None, a] - v[None, :, a]) ** 2 for a in range(3))
        counts.append((d < r2).sum(dim=1))
    return torch.cat(counts) >= geo.OUTLIER_MIN_NEIGHBORS


def model_input(cloud: np.ndarray, capacity: int, num_input: int,
                uniforms: torch.Tensor, positions: torch.Tensor,
                device, prec: Precision = F32_VALUES) -> torch.Tensor:
    """A camera cloud (n, 3) -> the model input (num_input, 3) f32 in the
    training frame, drawn with the replayed draws of its scene: `uniforms`
    (capacity,) and `positions` (num_input,)."""
    n = len(cloud)
    pts = torch.full((capacity, 3), geo.PAD_VALUE, dtype=torch.float32,
                     device=device)
    pts[:n] = torch.as_tensor(cloud, device=device)
    valid = torch.arange(capacity, device=device) < n
    train = prec.round(pts[:, [1, 0, 2]] * torch.tensor(
        [1.0, 1.0, -1.0], device=device))
    vox = voxels(train, valid, prec)
    keep = outlier_keep(vox)
    num_voxels, num_keep = len(vox), int(keep.sum())
    scores = torch.where(keep, uniforms[:num_voxels], -1.0)
    order = torch.sort(scores, descending=True, stable=True).indices
    if num_keep >= num_input:
        idx = order[:num_input]
    else:
        idx = order[positions % max(num_keep, 1)]
    return vox[idx]

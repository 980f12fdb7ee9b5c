"""Distance tests a ball query needs on its data: where a coordinate of a
scene's points ascends, only the keys within each ball's slab along it
(half-width 1.05 r + 1e-5 |c|: every key outside is farther than r), else
every key.  A copy of `chip_smoke.py`'s `_scene_slab_keys`, with the axis
found from the data."""

from __future__ import annotations

import torch


def ascending_axis(pts: torch.Tensor):
    """The first coordinate along which (3, N) points ascend, or None."""
    for a in range(3):
        if bool(torch.all(pts[a, 1:] >= pts[a, :-1])):
            return a
    return None


def tests(pts: torch.Tensor, cents: torch.Tensor, r2: float) -> float:
    """Needed distance tests of (B, 3, N) points against (B, 3, M)
    centroids within squared radius r2."""
    total = 0.0
    r = float(torch.sqrt(torch.tensor(r2, dtype=torch.float32)))
    for b in range(pts.shape[0]):
        axis = ascending_axis(pts[b])
        if axis is None:
            total += float(pts.shape[2] * cents.shape[2])
            continue
        ka = pts[b, axis].contiguous()
        ca = cents[b, axis]
        half = 1.05 * r + 1e-5 * ca.abs()
        lo = torch.searchsorted(ka, ca - half)
        hi = torch.searchsorted(ka, ca + half, right=True)
        total += float((hi - lo).sum())
    return total


def in_range(pts: torch.Tensor, cents: torch.Tensor, r2: float,
             k: int, chunk: int = 256) -> float:
    """Sum over the centroids of min(points strictly within r, k): the
    rows a grouping of k neighbours needs."""
    rows = 0.0
    for b in range(pts.shape[0]):
        p = pts[b]
        for c0 in range(0, cents.shape[2], chunk):
            c = cents[b, :, c0:c0 + chunk]
            d = sum((c[a][:, None] - p[a][None, :]) ** 2 for a in range(3))
            rows += float((d < r2).sum(dim=1).clamp(max=k).sum())
    return rows

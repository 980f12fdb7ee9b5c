"""Point-cloud preprocessing on the device (port of
s4g_tpu/pipeline/preprocessing.py): workspace crop, voxel downsample
(per-voxel mean), radius outlier removal and the fixed-budget random
sample, all as fixed-capacity masked tensor ops.

The random sample is the only random stage.  `preprocess_cloud` takes
either the sample indices (tests inject the JAX package's draws) or a
`torch.Generator` to draw them from.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from ..ops import neighbors as nb
from ..utils.profiling import span

_INT32_MAX = 2 ** 31 - 1
_HASH_PRIME = 1_000_003


def workspace_crop_mask(points: torch.Tensor,
                        workspace: Sequence[float]) -> torch.Tensor:
    """Strict-interior axis-aligned crop.

    Args: points (N, 3); workspace (low_x, high_x, low_y, high_y, low_z,
        high_z).
    Returns: (N,) bool mask.
    """
    w = torch.tensor(workspace, dtype=points.dtype, device=points.device)
    lo, hi = w[0::2], w[1::2]
    return torch.all((points > lo) & (points < hi), dim=-1)


def _wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """Two's-complement int32 wrap of an int64 tensor."""
    return torch.remainder(v + 2 ** 31, 2 ** 32) - 2 ** 31


def _voxel_ids(points: torch.Tensor, voxel_size: float,
               origin: torch.Tensor, reciprocal: bool = True
               ) -> torch.Tensor:
    """Integer voxel key per point: the JAX package's int32 hash
    ((c0 * P + c1) * P + c2), wrapping like int32 arithmetic (computed in
    int64, wrapped after each product).  Voxels come out in ascending hash
    order, so the wrap decides the voxel order and every index after it.

    With `reciprocal` the coordinates are scaled by the f32 reciprocal of
    the voxel size: in the JAX detect program the voxel size is a
    compile-time constant and XLA turns the division into that multiply,
    which bins points on a voxel boundary differently from a true division.
    Without it they are divided, as where the JAX package passes the voxel
    size as a traced argument (the label factory's `grade_object`): by a
    tensor, as torch divides by a Python scalar on the card as a multiply
    by its reciprocal."""
    if reciprocal:
        inv = torch.tensor(1.0) / torch.tensor(voxel_size,
                                               dtype=torch.float32)
        scaled = (points - origin) * inv.item()
    else:
        scaled = (points - origin) / torch.full_like(points, voxel_size)
    coords = torch.floor(scaled).to(torch.int64)
    h = _wrap_int32(coords[:, 0] * _HASH_PRIME + coords[:, 1])
    return _wrap_int32(h * _HASH_PRIME + coords[:, 2])


class VoxelizeResult(NamedTuple):
    points: torch.Tensor      # (capacity, 3) per-voxel mean positions
    valid: torch.Tensor       # (capacity,) bool
    num_voxels: torch.Tensor  # () int


def _voxel_groups(points: torch.Tensor, valid: torch.Tensor,
                  voxel_size: float, capacity: int, reciprocal: bool = True
                  ) -> tuple:
    """The voxel grid's grouping, shared by `voxel_downsample` and the
    label factory's `processing_and_trace`: voxels in ascending hash order
    (`_voxel_ids`), each summed in sorted order from 0 (the order of the
    JAX scatter-add, and deterministic on the GPU: no atomics), then
    averaged.

    Returns (order, group, mean, num_voxels): the stable hash sort of the
    points, each sorted point's voxel row (invalid points and voxels past
    `capacity` land in the dropped row `capacity`), the (capacity, 3)
    per-voxel means and the voxel count (not capped)."""
    origin = torch.amin(torch.where(valid[:, None], points, float("inf")),
                        dim=0)
    ids = torch.where(valid, _voxel_ids(points, voxel_size, origin,
                                        reciprocal), _INT32_MAX)
    order = torch.argsort(ids, stable=True)
    ids_sorted = ids[order]
    is_new = torch.ones_like(ids_sorted, dtype=torch.bool)
    is_new[1:] = ids_sorted[1:] != ids_sorted[:-1]
    is_new &= ids_sorted != _INT32_MAX
    group = torch.cumsum(is_new, dim=0) - 1
    group = torch.where(ids_sorted == _INT32_MAX, capacity,
                        torch.clamp(group, max=capacity))
    counts = torch.bincount(group, minlength=capacity + 1)
    sums = torch.segment_reduce(points[order], "sum", lengths=counts, axis=0,
                                unsafe=True)
    mean = sums[:capacity] / torch.clamp(counts[:capacity], min=1)[:, None]
    return order, group, mean, is_new.sum()


def voxel_downsample(points: torch.Tensor, valid: torch.Tensor,
                     voxel_size: float, capacity: int,
                     reciprocal: bool = True) -> VoxelizeResult:
    """Per-voxel average downsample (Open3D voxel_down_sample semantics),
    voxels ordered by ascending voxel hash (`reciprocal`: see `_voxel_ids`;
    the grouping: `_voxel_groups`)."""
    _, _, mean, num_voxels = _voxel_groups(points, valid, voxel_size,
                                           capacity, reciprocal)
    out_valid = torch.arange(capacity, device=points.device) \
        < torch.clamp(num_voxels, max=capacity)
    return VoxelizeResult(mean, out_valid, num_voxels)


def radius_outlier_mask(points: torch.Tensor, valid: torch.Tensor,
                        radius: float, min_neighbors: int) -> torch.Tensor:
    """Keep points with >= min_neighbors valid points within radius (self
    included) — Open3D remove_radius_outlier semantics, on matmul-form f32
    distances as in the JAX package: the keep mask of
    `ops.neighbors.radius_outlier_counts` (K9 on CUDA tensors, its plain
    twin, which states the rounding of q.k, on CPU tensors)."""
    return nb.radius_outlier_counts(points.contiguous(), valid.contiguous(),
                                    radius, min_neighbors)[0]


def sample_draws(n: int, num_samples: int, generator: torch.Generator,
                 device) -> tuple:
    """`random_sample_fixed`'s draws for n candidates: (n,) uniforms, then
    (num_samples,) positions.  Their shapes do not depend on the data, so
    a caller that skips a scene draws them and drops them."""
    u = torch.rand(n, generator=generator, device=device)
    pos = torch.randint(0, _INT32_MAX, (num_samples,), generator=generator,
                        device=device)
    return u, pos


def random_sample_fixed(valid: torch.Tensor, num_samples: int,
                        generator: torch.Generator) -> torch.Tensor:
    """Sample `num_samples` indices among valid ones: without replacement
    when enough valid points exist, with replacement otherwise.  Draws come
    from `generator` (on the device of `valid`, `sample_draws`); the count
    of valid points stays on the device.

    Returns (num_samples,) int32 indices into the input axis."""
    num_valid = valid.sum()
    u, pos = sample_draws(valid.shape[0], num_samples, generator,
                          valid.device)
    # Top-k of i.i.d. uniforms over the valid entries is a uniform sample
    # without replacement; ties keep the lower index (stable sort).
    scores = torch.where(valid, u, -1.0)
    order = torch.sort(scores, descending=True, stable=True).indices
    # With replacement: uniform positions among the valid entries, which
    # lead the sorted order.
    with_replace = order[pos % torch.clamp(num_valid, min=1)]
    return torch.where(num_valid >= num_samples, order[:num_samples],
                       with_replace).to(torch.int32)


class PreprocessResult(NamedTuple):
    points: torch.Tensor      # (num_points, 3) model-ready points
    raw_points: torch.Tensor  # (capacity, 3) post-voxel cloud
    raw_valid: torch.Tensor   # (capacity,) bool


def preprocess_cloud(points: torch.Tensor, num_points: int = 25600,
                     voxel_size: float = 0.005, outlier_radius: float = 0.02,
                     outlier_min_neighbors: int = 32, capacity: int = 65536,
                     workspace: Optional[tuple] = None,
                     sample_idx: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> PreprocessResult:
    """[crop] -> voxel average -> radius outlier -> fixed-size sample.

    Give either `sample_idx` ((num_points,) indices into the voxel array,
    e.g. injected draws) or a `generator` to draw them from."""
    if sample_idx is None and generator is None:
        raise ValueError("pass sample_idx or a generator")
    with span("prep.voxel"):
        valid = torch.ones(points.shape[0], dtype=torch.bool,
                           device=points.device)
        if workspace is not None:
            valid &= workspace_crop_mask(points, workspace)
        vox = voxel_downsample(points, valid, voxel_size, capacity)
    with span("prep.outlier", device=points.device):
        keep = radius_outlier_mask(vox.points, vox.valid, outlier_radius,
                                   outlier_min_neighbors)
    with span("prep.sample"):
        if sample_idx is None:
            sample_idx = random_sample_fixed(keep, num_points, generator)
        return PreprocessResult(vox.points[sample_idx.long()], vox.points,
                                keep)

"""Baseline (GPD / PointNetGPD) training-data generation: gripper-frame
close-region point sets and the 12-channel GPD projection maps (port of
s4g_tpu/datagen/baseline_data.py).

Re-design of the reference baseline generators (reference:
pcd_classes/torch_baseline_single_view_point_cloud.py:23-393 and
torch_precomputed_baseline.py): candidate grasps are graded against the
scene, their close-region points are shifted into the non-negative gripper
box ([0, FINGER_LENGTH] x [0, 2*HALF_BOTTOM_SPACE] x
[0, 2*HALF_HAND_THICKNESS], reference :313-315), sampled to a fixed budget,
and voxel-projected into the original GPD paper's 12 channels: for each of
the 3 axis orders, an average-height map + 3-channel averaged-normal map
(reference close_region_projection, :334-393).

The voxel sums are segment sums over the points sorted by voxel (stable),
each voxel added in point order from 0: the order of the JAX package's
scatter-add, and no atomics on the card.  Points out of the box go to a
sink voxel that is dropped, as the JAX scatter drops them.  The sums along
a projection axis are float64, rounded to f32 once.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..configs import gripper_config as G
from ..ops.neighbors import _f32
from ..runtime.device import resolve_device
from ..pipeline.eval_cloud import transform_rows

PROJECTION_RESOLUTION = 60
PROJECTION_MARGIN = 1
X_DIM = G.FINGER_LENGTH
Y_DIM = G.HALF_BOTTOM_SPACE * 2
Z_DIM = G.HALF_HAND_THICKNESS * 2
_DIMS = np.array([X_DIM, Y_DIM, Z_DIM])
_UNITS = _DIMS / (PROJECTION_RESOLUTION - PROJECTION_MARGIN)
_ORDERS = ([0, 1, 2], [1, 2, 0], [2, 0, 1])


def close_region_projection(points: torch.Tensor, normals: torch.Tensor,
                            valid: torch.Tensor) -> torch.Tensor:
    """12-channel GPD projection maps of one close region.

    Args:
        points: (3, N) close-region points in the SHIFTED gripper box
            (all coordinates >= 0); normals: (3, N); valid: (N,) mask.

    Returns:
        (12, R, R): for each axis order (xyz / yzx / zxy):
        [height map, mean normal x, y, z] projected along the last axis.
    """
    res = PROJECTION_RESOLUTION
    dev = points.device
    units = torch.tensor(_UNITS, dtype=torch.float32)
    # XLA turns the division by the constant units into this multiply.
    inv_units = (1.0 / units).to(dev)
    cor = torch.floor(points * inv_units[:, None]).to(torch.int64)
    in_bounds = ((cor >= 0) & (cor < res)).all(dim=0) & valid
    cor = torch.clamp(cor, 0, res - 1)
    flat = (cor[0] * res + cor[1]) * res + cor[2]
    flat = torch.where(in_bounds, flat, res ** 3)     # the dropped sink

    ones = in_bounds.to(points.dtype)
    order = torch.argsort(flat, stable=True)
    lengths = torch.bincount(flat, minlength=res ** 3 + 1)
    rows = torch.cat([ones[None], normals * ones[None]]).t()   # (N, 4)
    sums = torch.segment_reduce(rows[order], "sum", lengths=lengths,
                                axis=0, unsafe=True).t()   # (4, R^3 + 1)
    occupancy = sums[0, :res ** 3].reshape(res, res, res)
    norm_map = (sums[1:, :res ** 3].reshape(3, res, res, res)
                / torch.clamp(occupancy, min=1e-4)[None])
    occ = (occupancy > 0).to(points.dtype)

    maps = []
    for o in _ORDERS:
        last = o[-1]
        height = torch.from_numpy(np.linspace(
            0.5 * _UNITS[last], _DIMS[last] - 0.5 * _UNITS[last],
            res).astype(np.float32)).to(dev)
        occ_t = occ.permute(*o)
        norm_t = norm_map.permute(0, *[i + 1 for i in o])
        proj_occ = torch.clamp(occ_t.sum(dim=-1), min=1e-4)
        proj_norm = (norm_t.sum(dim=-1, dtype=torch.float64).float()
                     / proj_occ[None])
        proj_height = ((occ_t * height).sum(dim=-1, dtype=torch.float64)
                       .float() / proj_occ)
        maps.append(proj_height[None])
        maps.append(proj_norm)
    return torch.cat(maps, dim=0)


def extract_close_region(pose_g2l: torch.Tensor, cloud: torch.Tensor,
                         normals: torch.Tensor, valid: torch.Tensor,
                         num_points: int = 1024
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Close-region points/normals of one grasp in the shifted gripper box.

    Args:
        pose_g2l: (4, 4) global -> gripper-local transform.
        cloud: (N, 3) scene/view points (N >= num_points); normals (N, 3);
            valid (N,).

    Returns:
        points (3, num_points) shifted into the box (padded by repetition),
        normals (3, num_points), count () int32.
    """
    x, y, z = transform_rows(pose_g2l, cloud.t(), (0, 1, 2))
    local_n = torch.stack(transform_rows(pose_g2l, normals.t(), (0, 1, 2),
                                         translate=False))
    fl, hbs = _f32(G.FINGER_LENGTH), _f32(G.HALF_BOTTOM_SPACE)
    hht = _f32(G.HALF_HAND_THICKNESS)
    inside = (valid & (x > 0) & (x < fl) & (y > -hbs) & (y < hbs)
              & (z > -hht) & (z < hht))
    count = inside.sum(dtype=torch.int32)

    # gather the first num_points inside-points (repeat-fill)
    n = cloud.shape[0]
    j = torch.arange(n, device=cloud.device)
    order = torch.argsort(torch.where(inside, j, j + n))[:num_points]
    take = torch.clamp(torch.clamp(count, min=1), max=num_points)
    slot = torch.arange(num_points, device=cloud.device)
    idx = torch.where(slot < take, order, order[0])

    pts = torch.stack([x[idx], y[idx] + hbs, z[idx] + hht])
    return pts, local_n[:, idx], count


def baseline_grasp_data(pose_g2l: np.ndarray, cloud: np.ndarray,
                        normals: np.ndarray, num_points: int = 1024,
                        device: Optional[str] = None) -> dict:
    """Host helper: one grasp -> close-region points + projection maps
    (the per-grasp payload of the baseline training pickles; `device` None
    is CUDA)."""
    dev = resolve_device(device, "baseline_grasp_data")

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    pts, nrm, count = extract_close_region(
        t(pose_g2l), t(cloud), t(normals),
        torch.ones(len(cloud), dtype=torch.bool, device=dev), num_points)
    slot_valid = (torch.arange(num_points, device=dev)
                  < torch.clamp(count, min=1))
    proj = close_region_projection(pts, nrm, slot_valid)
    return {
        "close_region_points": pts.cpu().numpy(),
        "close_region_normals": nrm.cpu().numpy(),
        "close_region_projection_maps": proj.cpu().numpy(),
        "num_close_points": int(count),
    }

"""Gripper-vs-cloud collision checking over all candidate poses at once
(port of s4g_tpu/pipeline/collision.py).

Geometry and thresholds match the reference:
* close plane:  -BOTTOM_LENGTH < x < FINGER_LENGTH
* z slab:       |z| < HALF_HAND_THICKNESS
* back-hand:    |y| < HALF_BOTTOM_WIDTH and x < -BACK_COLLISION_MARGIN,
                colliding if count > BACK_COLLISION_THRESHOLD
* fingers:      HALF_BOTTOM_SPACE < |y| < HALF_BOTTOM_WIDTH,
                colliding if count > FINGER_COLLISION_THRESHOLD

Routes, as in the JAX package (`collision.py:83-86`): with G * N >= 2^22
the counts come from the CUDA kernel `csrc/collision_counts.cu` (K5) on
CUDA tensors, its plain twin on CPU tensors; smaller checks take the
einsum route.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import _build
from ..configs import gripper_config as G
from ..configs import processing_config as P
from ..ops.neighbors import KERNEL_MIN_PAIRS, _f32

# Box bounds rounded to f32 once (what the JAX package's weakly typed
# constants become against f32 coordinates); shared by kernel and twin.
_BOX = tuple(_f32(v) for v in (
    G.FINGER_LENGTH, G.BOTTOM_LENGTH, G.HALF_HAND_THICKNESS,
    G.HALF_BOTTOM_WIDTH, G.HALF_BOTTOM_SPACE, P.BACK_COLLISION_MARGIN))


def gripper_local_masks(local_pts: torch.Tensor,
                        valid: Optional[torch.Tensor] = None) -> dict:
    """Region masks for points already in gripper-local frames.

    Args: local_pts (..., 3, N); valid optional (..., N) or (N,) bool.
    Returns: dict of (..., N) bool masks: close_plane, z_slab, back,
    fingers, close_region.
    """
    fl, bl, hht, hbw, hbs, margin = _BOX
    x, y, z = local_pts[..., 0, :], local_pts[..., 1, :], local_pts[..., 2, :]
    close_plane = (x < fl) & (x > -bl)
    if valid is not None:
        close_plane = close_plane & valid
    z_slab = (z < hht) & (z > -hht)
    back = (close_plane & z_slab & (y < hbw) & (y > -hbw) & (x < -margin))
    finger_y = ((y < hbw) & (y > hbs)) | ((y > -hbw) & (y < -hbs))
    fingers = close_plane & z_slab & finger_y
    close_region = close_plane & z_slab & (y < hbs) & (y > -hbs)
    return {"close_plane": close_plane, "z_slab": z_slab, "back": back,
            "fingers": fingers, "close_region": close_region}


def _collision_counts_plain(global_to_local: torch.Tensor,
                            cloud_valid: torch.Tensor, chunk: int = 64):
    """Plain twin of K5: the transform rounded in the kernel's order
    ((px*r0 + py*r1) + pz*r2) + r3, then the box counts (as f32)."""
    pts = cloud_valid[:, :3].t()
    live = cloud_valid[:, 3] > 0.5
    mats = global_to_local.reshape(-1, 16)
    back, fing = [], []
    for g0 in range(0, mats.shape[0], chunk):
        m = mats[g0:g0 + chunk, :, None]                      # (g, 16, 1)
        px, py, pz = pts[0], pts[1], pts[2]
        rows = [px * m[:, 4 * r] + py * m[:, 4 * r + 1] + pz * m[:, 4 * r + 2]
                + m[:, 4 * r + 3] for r in range(3)]          # 3 x (g, N)
        masks = gripper_local_masks(torch.stack(rows, dim=1), live)
        back.append(masks["back"].sum(dim=-1))
        fing.append(masks["fingers"].sum(dim=-1))
    return torch.cat(back).float(), torch.cat(fing).float()


def collision_counts(global_to_local: torch.Tensor,
                     cloud_valid: torch.Tensor):
    """Per-pose back/finger box point counts (K5).

    Args: global_to_local (G, 4, 4) f32 world->gripper matrices;
        cloud_valid (N, 4) f32 rows (x, y, z, valid), valid 0 excludes.
    Returns: back_count, finger_count: (G,) f32.
    CUDA tensors launch `csrc/collision_counts.cu`; CPU tensors take
    `_collision_counts_plain`."""
    g, n = global_to_local.shape[0], cloud_valid.shape[0]
    if not _build.on_cuda(global_to_local, cloud_valid):
        return _collision_counts_plain(global_to_local, cloud_valid)
    _build.check(global_to_local, "global_to_local", torch.float32, (g, 4, 4))
    _build.check(cloud_valid, "cloud_valid", torch.float32, (n, 4))
    back = torch.empty(g, dtype=torch.float32, device=cloud_valid.device)
    fing = torch.empty(g, dtype=torch.float32, device=cloud_valid.device)
    _build.launch("collision_counts", global_to_local, cloud_valid, g, n,
                  *_BOX, back, fing)
    return back, fing


def batch_view_non_collision(
        global_to_local: torch.Tensor, cloud: torch.Tensor,
        valid: Optional[torch.Tensor] = None,
        back_threshold: float = P.BACK_COLLISION_THRESHOLD,
        finger_threshold: float = P.FINGER_COLLISION_THRESHOLD
) -> torch.Tensor:
    """Vectorized view_non_collision over G poses.

    Args: global_to_local (G, 4, 4) inverse grasp poses; cloud (N, 3) view
        cloud in the global frame; valid optional (N,) bool.
    Returns: (G,) bool — True where the gripper does NOT collide.
    """
    g, n = global_to_local.shape[0], cloud.shape[0]
    if g * n >= KERNEL_MIN_PAIRS:
        v = (torch.ones((n, 1), dtype=torch.float32, device=cloud.device)
             if valid is None else valid.float()[:, None])
        cloud_valid = torch.cat([cloud.float(), v], dim=1)
        back, fing = collision_counts(global_to_local.float().contiguous(),
                                      cloud_valid)
    else:
        homo = torch.cat([cloud.t(), torch.ones((1, n), dtype=cloud.dtype,
                                                device=cloud.device)])
        local = torch.einsum("gij,jn->gin", global_to_local, homo)
        masks = gripper_local_masks(local[:, :3, :], valid)
        back = masks["back"].sum(dim=-1)
        fing = masks["fingers"].sum(dim=-1)
    return (back <= _f32(back_threshold)) & (fing <= _f32(finger_threshold))

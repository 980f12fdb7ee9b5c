"""Constants of the S4G detector as published (yzqin/s4g-release,
inference/grasp_proposal: grasp_detector.py, configs/processing_config.py,
configs/gripper_config.py, configs/real_world_config.py), and the SE(3)
helpers of its post-processing."""

from __future__ import annotations

import math

import numpy as np
import torch

# Camera frame -> the frame the model was trained in, and back.
REAL2TRAIN = np.array([[0, 1, 0], [1, 0, 0], [0, 0, -1]], np.float32)
TRAIN2REAL = np.linalg.inv(REAL2TRAIN).astype(np.float32)
CAMERA2BASE = np.array([[-0.00377177, 0.54720216, -0.83699198],
                        [0.99981506, -0.01372054, -0.01347562],
                        [-0.01885787, -0.83688801, -0.54704921]])

# Preprocessing.
VOXEL_SIZE = 0.005
OUTLIER_RADIUS = 0.02
OUTLIER_MIN_NEIGHBORS = 32
PAD_VALUE = 1e6

# The 4 translation bins of PN2_CLS (depth behind the point, m).
T_BINS = (0.08, 0.06, 0.04, 0.02)

# Gripper boxes (m) and collision thresholds (points).
FINGER_LENGTH = 0.09
BOTTOM_LENGTH = 0.16
HALF_HAND_THICKNESS = 0.012
HALF_BOTTOM_WIDTH = 0.057
HALF_BOTTOM_SPACE = HALF_BOTTOM_WIDTH - 0.023
BACK_COLLISION_MARGIN = 0.0
BACK_COLLISION_THRESHOLD = 10 * math.sqrt(8)
FINGER_COLLISION_THRESHOLD = 10


def f32(x: float) -> float:
    """`x` rounded to f32, as a Python float."""
    return float(np.float32(x))


def gram_schmidt(rot: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) raw columns [x | y | z] -> proper rotations: x normalized,
    y orthogonalized against x twice, z = x cross y; a zero x or a y
    parallel to x falls back to basis vectors."""
    eps = 1e-6

    def dot(a, b):
        return (a[..., 0:1] * b[..., 0:1] + a[..., 1:2] * b[..., 1:2]
                + a[..., 2:3] * b[..., 2:3])

    def norm(a):
        return torch.sqrt(dot(a, a))

    x = rot[..., :, 0]
    xn = norm(x)
    e = torch.eye(3, dtype=rot.dtype, device=rot.device)
    x = torch.where(xn > eps, x / torch.clamp(xn, min=eps),
                    e[0].expand_as(x))
    y = rot[..., :, 1]
    y = y - dot(x, y) * x
    yn = norm(y)
    alt = torch.where(torch.abs(dot(x, e[1].expand_as(x))) < 0.9,
                      e[1].expand_as(x), e[2].expand_as(x))
    alt = alt - dot(x, alt) * x
    alt = alt / torch.clamp(norm(alt), min=eps)
    y = torch.where(yn > eps, y / torch.clamp(yn, min=eps), alt)
    y = y - dot(x, y) * x
    y = y / torch.clamp(norm(y), min=eps)
    return torch.stack([x, y, torch.linalg.cross(x, y, dim=-1)], dim=-1)


def rot6d_to_mat9(r6: torch.Tensor) -> torch.Tensor:
    """(6, N) [b1 raw | a2 raw] -> (9, N) row-major [b1 | b2 | b1 x b2]."""
    eps = 1e-24
    b1 = r6[0:3]
    b1 = b1 / torch.sqrt(torch.sum(b1 * b1, dim=0, keepdim=True) + eps)
    a2 = r6[3:6]
    b2 = a2 - torch.sum(a2 * b1, dim=0, keepdim=True) * b1
    b2 = b2 / torch.sqrt(torch.sum(b2 * b2, dim=0, keepdim=True) + eps)
    b3 = torch.linalg.cross(b1, b2, dim=0)
    return torch.stack([b1, b2, b3], dim=1).reshape(9, -1)


def invert_poses(poses: torch.Tensor) -> torch.Tensor:
    """(G, 4, 4) rigid poses -> their inverses [R^T | -R^T t]."""
    rt = poses[:, :3, :3].transpose(1, 2)
    t = poses[:, :3, 3]
    tinv = -(rt[:, :, 0] * t[:, 0:1] + rt[:, :, 1] * t[:, 1:2]
             + rt[:, :, 2] * t[:, 2:3])
    out = torch.zeros_like(poses)
    out[:, :3, :3] = rt
    out[:, :3, 3] = tinv
    out[:, 3, 3] = 1.0
    return out

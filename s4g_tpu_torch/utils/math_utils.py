"""SE(3) math utilities (port of s4g_tpu/utils/math_utils.py): numpy
helpers for single transforms and their torch counterparts, batched."""

from __future__ import annotations

import numpy as np
import torch


def transformation_inv(transformation: np.ndarray) -> np.ndarray:
    """Inverse of a single SE(3) matrix (numpy), avoiding a general inverse:
    R^T and -R^T t."""
    assert transformation.shape == (4, 4), transformation.shape
    result = np.eye(4, dtype=transformation.dtype)
    rot_inv = transformation[:3, :3].T
    result[:3, :3] = rot_inv
    result[:3, 3:4] = -rot_inv @ transformation[:3, 3:4]
    return result


def transform_numpy_points(cloud_array: np.ndarray,
                           transformation_matrix) -> np.ndarray:
    """Apply a 4x4 transform to a (3, N) numpy cloud, returning (3, N)."""
    assert cloud_array.shape[0] == 3 and cloud_array.ndim == 2
    homo = np.concatenate(
        [cloud_array, np.ones([1, cloud_array.shape[1]],
                              dtype=cloud_array.dtype)], axis=0)
    return (transformation_matrix @ homo)[:3, :]


def batch_transformation_inv(transformation: torch.Tensor) -> torch.Tensor:
    """Inverse of batched SE(3) matrices, (..., 4, 4) -> (..., 4, 4)."""
    rot_inv = transformation[..., :3, :3].transpose(-1, -2)
    t = transformation[..., :3, 3:]
    top = torch.cat([rot_inv, -torch.matmul(rot_inv, t)], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=transformation.dtype,
                          device=transformation.device)
    bottom = bottom.expand(*transformation.shape[:-2], 1, 4)
    return torch.cat([top, bottom], dim=-2)


def transform_points(points: torch.Tensor,
                     transformation: torch.Tensor) -> torch.Tensor:
    """Apply 4x4 transforms (..., 4, 4) to (..., 3, N) points, returning
    (..., 3, N): R . points + t, written out as elementwise products and
    sums, ((r0 x + r1 y) + r2 z) + t, so that no TF32 matmul touches it (the
    JAX version runs at HIGHEST precision) and the card's result is the
    CPU's."""
    rot = transformation[..., :3, :3]
    t = transformation[..., :3, 3:]
    x, y, z = points[..., 0:1, :], points[..., 1:2, :], points[..., 2:3, :]
    return (rot[..., 0:1] * x + rot[..., 1:2] * y) + rot[..., 2:3] * z + t


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Last-axis 3-vector dot, ((a0*b0 + a1*b1) + a2*b2), keepdim."""
    return (a[..., 0:1] * b[..., 0:1] + a[..., 1:2] * b[..., 1:2]
            + a[..., 2:3] * b[..., 2:3])


def _norm(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(_dot(a, a))


def gram_schmidt_frames(rotation9: torch.Tensor) -> torch.Tensor:
    """Orthogonalize raw 9-D rotation predictions, batched.

    Args: rotation9 (..., 3, 3) raw rotation columns [x | y | z] (z ignored).
    Returns: (..., 3, 3) proper rotations: x normalized, y Gram-Schmidt vs
    x (two passes), z = x × y.  Degenerate inputs (zero x, or y parallel to
    x) fall back to basis vectors, so the output is always a rotation.
    """
    eps = 1e-6
    x = rotation9[..., :, 0]
    x_norm = _norm(x)
    e0 = torch.zeros_like(x)
    e0[..., 0] = 1.0
    x = torch.where(x_norm > eps, x / torch.clamp(x_norm, min=eps), e0)
    y = rotation9[..., :, 1]
    y = y - _dot(x, y) * x
    y_norm = _norm(y)
    alt = torch.zeros_like(x)
    alt[..., 1] = 1.0
    alt2 = torch.zeros_like(x)
    alt2[..., 2] = 1.0
    alt = torch.where(torch.abs(_dot(x, alt)) < 0.9, alt, alt2)
    alt = alt - _dot(x, alt) * x
    alt = alt / torch.clamp(_norm(alt), min=eps)
    y = torch.where(y_norm > eps, y / torch.clamp(y_norm, min=eps), alt)
    # Second pass ("twice is enough") for y nearly parallel to x.
    y = y - _dot(x, y) * x
    y = y / torch.clamp(_norm(y), min=eps)
    z = torch.linalg.cross(x, y, dim=-1)
    return torch.stack([x, y, z], dim=-1)


def poses_from_rt(rotation: torch.Tensor,
                  translation: torch.Tensor) -> torch.Tensor:
    """Assemble (..., 4, 4) poses from (..., 3, 3) R and (..., 3) t."""
    top = torch.cat([rotation, translation[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=rotation.dtype,
                          device=rotation.device)
    bottom = bottom.expand(*rotation.shape[:-2], 1, 4)
    return torch.cat([top, bottom], dim=-2)

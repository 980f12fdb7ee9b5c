"""Point-cloud training augmentations (port of
s4g_tpu/train/augmentation.py).

TRAIN.AUGMENTATION lists '"Method"' or '("Method", *args)' entries; the
transforms rotate `best_frame_R` (flattened row-major 3x3, channels-first)
with the cloud:

* PointCloudRotate           - a uniform rotation about the up (z) axis
* PointCloudRotatePerturbation(angle_sigma, angle_clip) - small clipped
  normal rotations about all three axes
* PointCloudTranslate(std)   - a normal shift of the whole scene
* PointCloudJitter(std, clip) - clipped normal noise per point (points
  only; the frames keep their labels)

`best_frame_t` rotates and shifts only when it is (B, 3, nf): PN2's
regression labels, not PN2_CLS's depth-bin classes.  Each transform draws
from the `torch.Generator` it is handed, on the batch's device, through
`_uniform` and `_normal`, and applies the draws through plain functions of
them (`_rot_z`, `_rot_xyz`, `_apply_rotation`), so the tests can feed both
packages the same draws.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

from ..parallel.mesh import global_rows


def _rot_z(angle: torch.Tensor) -> torch.Tensor:
    """(...,) angles -> (..., 3, 3) rotations about z."""
    c, s = torch.cos(angle), torch.sin(angle)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, zero], -1),
                        torch.stack([s, c, zero], -1),
                        torch.stack([zero, zero, one], -1)], -2)


def _rot_xyz(angles: torch.Tensor) -> torch.Tensor:
    """(..., 3) Euler angles -> (..., 3, 3) Rz @ Ry @ Rx."""
    ax, ay, az = angles[..., 0], angles[..., 1], angles[..., 2]
    cx, sx = torch.cos(ax), torch.sin(ax)
    cy, sy = torch.cos(ay), torch.sin(ay)
    cz, sz = torch.cos(az), torch.sin(az)
    zero, one = torch.zeros_like(ax), torch.ones_like(ax)
    rx = torch.stack([torch.stack([one, zero, zero], -1),
                      torch.stack([zero, cx, -sx], -1),
                      torch.stack([zero, sx, cx], -1)], -2)
    ry = torch.stack([torch.stack([cy, zero, sy], -1),
                      torch.stack([zero, one, zero], -1),
                      torch.stack([-sy, zero, cy], -1)], -2)
    rz = torch.stack([torch.stack([cz, -sz, zero], -1),
                      torch.stack([sz, cz, zero], -1),
                      torch.stack([zero, zero, one], -1)], -2)
    return rz @ ry @ rx


def _regression_t(batch: dict) -> bool:
    return "best_frame_t" in batch and batch["best_frame_t"].dim() == 3


def _apply_rotation(batch: dict, rot: torch.Tensor) -> dict:
    """rot (B, 3, 3) applied to scene_points (B, 3, N), best_frame_R
    (B, 9, Nf) and a regression best_frame_t (B, 3, Nf)."""
    out = dict(batch)
    out["scene_points"] = rot @ batch["scene_points"]
    if "best_frame_R" in batch:
        r = batch["best_frame_R"]
        b, _, nf = r.shape
        r33 = r.transpose(1, 2).reshape(b, nf, 3, 3)
        r33 = rot[:, None] @ r33
        out["best_frame_R"] = r33.reshape(b, nf, 9).transpose(1, 2)
    if _regression_t(batch):
        out["best_frame_t"] = rot @ batch["best_frame_t"]
    return out


# Every draw goes through these two, on the batch's device; within
# `parallel.global_batch` at the global batch's shape, of which this rank
# keeps its rows (shape[0] is the local batch).
def _uniform(generator: torch.Generator, shape, like: torch.Tensor
             ) -> torch.Tensor:
    """Uniform in [0, 1)."""
    return global_rows(lambda s: torch.rand(s, generator=generator,
                                            device=like.device), shape)


def _normal(generator: torch.Generator, shape, like: torch.Tensor
            ) -> torch.Tensor:
    return global_rows(lambda s: torch.randn(s, generator=generator,
                                             device=like.device), shape)


def point_cloud_rotate(generator: torch.Generator, batch: dict) -> dict:
    """A uniform rotation about the z (up) axis, angle in [0, 2 pi)."""
    pts = batch["scene_points"]
    angle = _uniform(generator, (pts.shape[0],), pts) * (2.0 * math.pi)
    return _apply_rotation(batch, _rot_z(angle))


def point_cloud_rotate_perturbation(generator: torch.Generator, batch: dict,
                                    angle_sigma: float = 0.06,
                                    angle_clip: float = 0.18) -> dict:
    pts = batch["scene_points"]
    angles = torch.clamp(
        angle_sigma * _normal(generator, (pts.shape[0], 3), pts),
        -angle_clip, angle_clip)
    return _apply_rotation(batch, _rot_xyz(angles))


def point_cloud_translate(generator: torch.Generator, batch: dict,
                          std: float = 0.02) -> dict:
    pts = batch["scene_points"]
    shift = std * _normal(generator, (pts.shape[0], 3), pts)
    out = dict(batch)
    out["scene_points"] = pts + shift[:, :, None]
    if _regression_t(batch):
        out["best_frame_t"] = batch["best_frame_t"] + shift[:, :, None]
    return out


def point_cloud_jitter(generator: torch.Generator, batch: dict,
                       std: float = 0.002, clip: float = 0.01) -> dict:
    pts = batch["scene_points"]
    noise = torch.clamp(std * _normal(generator, pts.shape, pts), -clip, clip)
    out = dict(batch)
    out["scene_points"] = pts + noise
    return out


_REGISTRY = {
    "PointCloudRotate": point_cloud_rotate,
    "PointCloudRotatePerturbation": point_cloud_rotate_perturbation,
    "PointCloudTranslate": point_cloud_translate,
    "PointCloudJitter": point_cloud_jitter,
}


def build_augmentation(spec: Sequence) -> Callable[[torch.Generator, dict],
                                                   dict]:
    """TRAIN.AUGMENTATION entries -> one (generator, batch) -> batch
    function applying them in order.  Each entry is "Method" or
    ("Method", arg0, arg1, ...)."""
    steps = []
    for entry in spec or ():
        if isinstance(entry, str):
            name, args = entry, ()
        else:
            name, args = entry[0], tuple(entry[1:])
        if name not in _REGISTRY:
            raise ValueError(f"unknown augmentation {name!r}; "
                             f"options: {sorted(_REGISTRY)}")
        steps.append((_REGISTRY[name], args))

    def apply(generator: torch.Generator, batch: dict) -> dict:
        for fn, args in steps:
            batch = fn(generator, batch, *args)
        return batch

    return apply

"""Grasp evaluation against labeled scene clouds: collision + antipodal +
multi-object checks, batched (port of s4g_tpu/pipeline/eval_cloud.py).

Per pose {collision, multi_objects, antipodal_score} with the
inference-side thresholds (processing_config.py:33-46), as the JAX
package's `eval_frames` computes them, with two differences of method
that leave the results alone:

* the (G, 4, 4) x (4, N) transform is written out as products and sums in
  one fixed order, ((px*r0 + py*r1) + pz*r2) + r3, as K5's twin does
  (`collision.py::_collision_counts_plain`): an einsum's reduction order,
  and its TF32 use on the card, depend on the backend and its flags, and a
  point within an ulp of a box face would flip with them;
* poses go through in chunks of about 2^26 pose-point pairs: at the label
  factory's size (2,000 poses against ~10^5 points) the whole (G, 3, N)
  local cloud would take 2.4 GB.  The band sums accumulate in float64 and
  round to f32 once, so every chunk size gives the same bits.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..configs import processing_config as P
from .collision import gripper_local_masks

# Pose-point pairs per chunk.
CHUNK_PAIRS = 1 << 26
# Label sentinel of an empty close region (the JAX package's 2**30).
_BIG_LABEL = 2 ** 30


class EvalFrameResult(NamedTuple):
    collision: torch.Tensor        # (G,) bool
    multi_objects: torch.Tensor    # (G,) bool
    antipodal_score: torch.Tensor  # (G,) f32 (0 when invalid)


def _rows(mats: torch.Tensor, pts: torch.Tensor, rows, translate: bool):
    """Rows `rows` of mats (g, 4, 4) applied to pts (3, N), each
    ((px*m0 + py*m1) + pz*m2) [+ m3]: a (g, len(rows), N) tensor."""
    px, py, pz = pts[0], pts[1], pts[2]
    out = []
    for r in rows:
        m = mats[:, r, :, None]                                # (g, 4, 1)
        v = px * m[:, 0] + py * m[:, 1] + pz * m[:, 2]
        out.append(v + m[:, 3] if translate else v)
    return torch.stack(out, dim=1)


def _antipodal(local: torch.Tensor, local_ny: torch.Tensor,
               close_region: torch.Tensor) -> torch.Tensor:
    """Batched antipodal score (reference eval_point_cloud.py:39-62):
    product of mean |n . +-y| in the left/right contact bands.  An empty
    close region gives left_y -inf and right_y +inf, NaN band edges, empty
    bands and 0 / max(0, 1) = 0, as in the JAX package.

    Args: local (g, 3, N) gripper-frame points; local_ny (g, N) the normals'
    y row; close_region (g, N) bool."""
    y = local[:, 1]
    ninf = torch.tensor(-float("inf"), dtype=local.dtype, device=local.device)
    left_y = torch.amax(torch.where(close_region, y, ninf), dim=-1)
    right_y = -torch.amax(torch.where(close_region, -y, ninf), dim=-1)
    depth = torch.clamp((left_y - right_y) / 3.0, max=P.NEIGHBOR_DEPTH)
    left_band = close_region & (y > (left_y - depth)[:, None])
    right_band = close_region & (y < (right_y + depth)[:, None])
    ny = torch.abs(local_ny)

    def mean_masked(mask):
        s = torch.sum(torch.where(mask, ny, 0.0), dim=-1,
                      dtype=torch.float64).to(local.dtype)
        return s / torch.clamp(mask.sum(dim=-1), min=1).to(local.dtype)

    return mean_masked(left_band) * mean_masked(right_band)


def _eval_chunk(mats, pts, nrm, labels, valid):
    local = _rows(mats, pts, (0, 1, 2), True)                  # (g, 3, N)
    local_ny = _rows(mats, nrm, (1,), False)[:, 0]             # (g, N)
    masks = gripper_local_masks(local, valid)
    back_count = masks["back"].sum(dim=-1)
    finger_count = masks["fingers"].sum(dim=-1)
    collision = ((back_count > P.BACK_COLLISION_THRESHOLD)
                 | (finger_count > P.FINGER_COLLISION_THRESHOLD))

    close = masks["close_region"]
    lab = labels[None, :]
    lab_min = torch.amin(torch.where(close, lab, _BIG_LABEL), dim=-1)
    lab_max = torch.amax(torch.where(close, lab, -_BIG_LABEL), dim=-1)
    multi_objects = lab_min != lab_max

    enough = close.sum(dim=-1) >= P.CLOSE_REGION_MIN_POINTS
    score = _antipodal(local, local_ny, close)
    score = torch.where(enough & ~collision & ~multi_objects, score, 0.0)
    return collision, multi_objects, score


def eval_frames(global_to_local: torch.Tensor, cloud: torch.Tensor,
                normals: torch.Tensor, labels: torch.Tensor,
                valid: Optional[torch.Tensor] = None,
                chunk: Optional[int] = None) -> EvalFrameResult:
    """Evaluate G grasp poses against a labeled scene cloud.

    Args:
        global_to_local: (G, 4, 4) f32; cloud: (N, 3); normals: (N, 3);
        labels: (N,) int object labels; valid: optional (N,) mask; chunk:
        poses per chunk (default: about CHUNK_PAIRS / N; the result does not
        depend on it).  All on one device.

    Returns:
        EvalFrameResult — antipodal_score is zero for poses that collide,
        span multiple objects, or close on < CLOSE_REGION_MIN_POINTS points
        (reference eval_point_cloud.py:64-113).  An empty close region
        counts as multi_objects (its label min and max stay at the
        sentinels), as in the JAX package.
    """
    g, n = global_to_local.shape[0], cloud.shape[0]
    dev = global_to_local.device
    if g == 0:
        return EvalFrameResult(torch.zeros(0, dtype=torch.bool, device=dev),
                               torch.zeros(0, dtype=torch.bool, device=dev),
                               torch.zeros(0, dtype=cloud.dtype, device=dev))
    if chunk is None:
        chunk = max(1, CHUNK_PAIRS // max(n, 1))
    pts, nrm = cloud.t(), normals.t()
    parts = [_eval_chunk(global_to_local[g0:g0 + chunk], pts, nrm, labels,
                         valid)
             for g0 in range(0, g, chunk)]
    return EvalFrameResult(*(torch.cat(p) for p in zip(*parts)))

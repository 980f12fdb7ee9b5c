"""Grasp post-processing: dense per-point predictions -> ranked SE(3) poses
(port of s4g_tpu/pipeline/postprocessing.py: the PN2_CLS 4-bin decoding
and the PN2 regression decoding).

A fixed top-K with validity masks, in f32 whatever the backbone's compute
dtype:

* expected score = sum(bin_value * softmax(score_logits)), bins
  linspace(0, 1, C+1)[1:];
* candidates must exceed score_threshold and be vertical enough: the raw
  x-axis mapped through TRAIN2REAL and camera2base must point up;
* PN2_CLS: translation = -(softmax(t_logits) . [0.08, 0.06, 0.04, 0.02])
  along the raw x-axis + point; PN2: the model's absolute grasp origin;
* Gram-Schmidt; map to the camera frame.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..configs import real_world_config as realworld
from ..utils.math_utils import gram_schmidt_frames, poses_from_rt

# Frame remap used by the deployed detector (grasp_detector.py:26-27).
REAL2TRAIN = np.array([[0, 1, 0, 0], [1, 0, 0, 0],
                       [0, 0, -1, 0], [0, 0, 0, 1]], dtype=np.float32)
TRAIN2REAL = np.linalg.inv(REAL2TRAIN).astype(np.float32)

T_BIN_VALUES = np.array([0.08, 0.06, 0.04, 0.02], dtype=np.float32)


class PostProcessResult(NamedTuple):
    poses: torch.Tensor   # (K, 4, 4) camera-frame grasp poses, score-descending
    scores: torch.Tensor  # (K,) expected scores
    valid: torch.Tensor   # (K,) bool — exceeds threshold AND vertical enough


def _softmax0(x: torch.Tensor) -> torch.Tensor:
    """Softmax over axis 0 as jax.nn.softmax computes it: exp(x - max)
    divided (not multiplied by a reciprocal) by the sum, summed in order."""
    e = torch.exp(x - torch.amax(x, dim=0, keepdim=True))
    total = e[0]
    for row in e[1:]:
        total = total + row
    return e / total


def expected_score(score_logits: torch.Tensor,
                   upper_bins: bool = True) -> torch.Tensor:
    """Softmax expectation over score bins (C, N) -> (N,).

    upper_bins=True: bins linspace(0, 1, C + 1)[1:], the detector's
    (grasp_detector.py:145); False: linspace(0, 1, C + 1)[:-1], the file
    logger's (file_logger_cls.py:67)."""
    c = score_logits.shape[0]
    first = 1 if upper_bins else 0
    bins = torch.arange(first, first + c, dtype=torch.float32,
                        device=score_logits.device) / c
    prob = _softmax0(score_logits)
    out = bins[0] * prob[0]
    for i in range(1, c):
        out = out + bins[i] * prob[i]
    return out


def _frames(dev, camera2base: Optional[torch.Tensor],
            train2real: Optional[torch.Tensor]) -> tuple:
    if camera2base is None:
        camera2base = torch.tensor(realworld.camera2base, dtype=torch.float32,
                                   device=dev)
    if train2real is None:
        train2real = torch.tensor(TRAIN2REAL, device=dev)
    return camera2base, train2real


def _top_k(scores: torch.Tensor, k: int) -> tuple:
    """The k largest scores and their indices, ties to the lower index (a
    stable descending sort, as lax.top_k orders them)."""
    order = torch.sort(scores, descending=True, stable=True)
    return order.values[:k], order.indices[:k]


def _valid(top_scores: torch.Tensor, rot: torch.Tensor,
           camera2base: torch.Tensor, train2real: torch.Tensor,
           score_threshold: float, vertical_threshold: float) -> torch.Tensor:
    """Above the score threshold and vertical enough: the raw
    (un-orthogonalized) approach axis in the robot base frame; "disable"
    means a very negative threshold (-1e9)."""
    x_dir = -torch.matmul(torch.matmul(camera2base[:3, :3],
                                       train2real[:3, :3]),
                          rot[:, :, 0].t())
    return (top_scores > score_threshold) & (x_dir[2] > vertical_threshold)


def post_process_predictions(points: torch.Tensor, score_logits: torch.Tensor,
                             frame_r: torch.Tensor,
                             frame_t_logits: torch.Tensor,
                             score_threshold: float,
                             vertical_threshold: float,
                             num_candidates: int = 1024,
                             camera2base: Optional[torch.Tensor] = None,
                             train2real: Optional[torch.Tensor] = None
                             ) -> PostProcessResult:
    """Args (one scene, channels-first like the model preds): points (3, N)
    model-input points (train frame); score_logits (C, N); frame_r (9, N);
    frame_t_logits (4, N).  Returns the top `num_candidates` poses by score
    (ties to the lower point index, as lax.top_k) with a validity mask."""
    dev = points.device
    camera2base, train2real = _frames(dev, camera2base, train2real)
    points = points.float()
    score_logits = score_logits.float()
    frame_r = frame_r.float()
    frame_t_logits = frame_t_logits.float()

    top_scores, top_idx = _top_k(expected_score(score_logits), num_candidates)
    rot = frame_r.t().reshape(-1, 3, 3)[top_idx]              # (K, 3, 3)
    pts = points.t()[top_idx]                                 # (K, 3)
    t_prob = _softmax0(frame_t_logits[:, top_idx])            # (4, K)
    valid = _valid(top_scores, rot, camera2base, train2real, score_threshold,
                   vertical_threshold)

    bins = torch.tensor(T_BIN_VALUES, device=dev)
    depth = t_prob[0] * bins[0]
    for i in range(1, 4):
        depth = depth + t_prob[i] * bins[i]
    translation = -depth[:, None] * rot[:, :, 0] + pts        # (K, 3)

    mat44 = poses_from_rt(gram_schmidt_frames(rot), translation)
    mat44 = torch.matmul(train2real, mat44)
    return PostProcessResult(mat44, top_scores, valid)


def post_process_predictions_regression(
        points: torch.Tensor, score_logits: torch.Tensor,
        frame_r: torch.Tensor, frame_t: torch.Tensor, score_threshold: float,
        vertical_threshold: float, num_candidates: int = 1024,
        camera2base: Optional[torch.Tensor] = None,
        train2real: Optional[torch.Tensor] = None) -> PostProcessResult:
    """Post-processing of the PN2 contact model (port of
    `post_process_predictions_regression`, `postprocessing.py:132-176`):
    frame_r (9, N) is already orthogonal (the model's `rot6d_to_mat9`) and
    frame_t (3, N) is the absolute grasp origin, so no bins are decoded.
    `points` (3, N) is unused, as in the JAX function.  Same top-K, casts
    and order of matmuls as `post_process_predictions`."""
    dev = score_logits.device
    camera2base, train2real = _frames(dev, camera2base, train2real)
    score_logits = score_logits.float()
    frame_r = frame_r.float()
    frame_t = frame_t.float()

    top_scores, top_idx = _top_k(expected_score(score_logits), num_candidates)
    rot = frame_r.t().reshape(-1, 3, 3)[top_idx]              # (K, 3, 3)
    translation = frame_t.t()[top_idx]                        # (K, 3)
    valid = _valid(top_scores, rot, camera2base, train2real, score_threshold,
                   vertical_threshold)

    mat44 = poses_from_rt(gram_schmidt_frames(rot), translation)
    mat44 = torch.matmul(train2real, mat44)
    return PostProcessResult(mat44, top_scores, valid)


def importance_sample(scores: torch.Tensor, valid: torch.Tensor,
                      uniforms: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF importance sampling over exp(5 * score): one index per
    uniform draw in [0, 1) (only valid entries carry mass).

    Returns (len(uniforms),) int32 indices into scores."""
    weights = torch.where(valid, torch.exp(5.0 * scores), 0.0)
    cum = torch.cumsum(weights, dim=0)
    targets = torch.sort(uniforms).values * cum[-1]
    return torch.searchsorted(cum, targets, side="left").to(torch.int32)

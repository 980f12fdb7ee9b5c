"""Loss, metric and rotation helpers of the models (port of
s4g_tpu/models/functional.py): pure tensor functions that autograd
differentiates like the JAX package's `jax.grad` does.

Within `parallel.global_batch` a loss returns this rank's share of the
global batch's loss (`batch_mean`; a weighted cross entropy divides by
the weights summed over every rank): the shares sum to the global loss.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..parallel.mesh import batch_mean, sum_over_ranks


# -----------------------------------------------------------------------------
# Distances
# -----------------------------------------------------------------------------

def bpdist(feature: torch.Tensor) -> torch.Tensor:
    """Batched pairwise squared distances, (B, C, N) -> (B, N, N)."""
    sq = torch.sum(feature ** 2, dim=1, keepdim=True)       # (B, 1, N)
    inner = torch.einsum("bcm,bcn->bmn", feature, feature)
    return sq.transpose(1, 2) + sq - 2.0 * inner


def bpdist2(feature1: torch.Tensor, feature2: torch.Tensor) -> torch.Tensor:
    """(B, C, N1) x (B, C, N2) -> (B, N1, N2) squared distances."""
    sq1 = torch.sum(feature1 ** 2, dim=1)[..., :, None]
    sq2 = torch.sum(feature2 ** 2, dim=1)[..., None, :]
    inner = torch.einsum("bcm,bcn->bmn", feature1, feature2)
    return sq1 + sq2 - 2.0 * inner


def pdist2(feature1: torch.Tensor, feature2: torch.Tensor) -> torch.Tensor:
    """(N1, C) x (N2, C) -> (N1, N2) squared distances."""
    sq1 = torch.sum(feature1 ** 2, dim=1, keepdim=True)
    sq2 = torch.sum(feature2 ** 2, dim=1, keepdim=True)
    return sq1 + sq2.t() - 2.0 * feature1 @ feature2.t()


# -----------------------------------------------------------------------------
# Classification losses
# -----------------------------------------------------------------------------

def encode_one_hot(target: torch.Tensor, num_classes: int) -> torch.Tensor:
    return F.one_hot(target.long(), num_classes).float()


def _nll(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """-log_softmax(logits)[target] with the class axis at dim 1."""
    logp = torch.log_softmax(logits, dim=1)
    return -torch.gather(logp, 1, target.long()[:, None])[:, 0]


def weighted_cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                           class_weight: torch.Tensor) -> torch.Tensor:
    """Cross entropy with per-class weights, class axis at dim 1: logits
    (B, C, ...), target (B, ...) integer labels, class_weight (C,).
    Returns sum(w[y_i] * nll_i) / sum(w[y_i]) (torch's "mean" reduction
    normalises by the summed weights of the targets)."""
    w = class_weight[target.long()]
    return torch.sum(w * _nll(logits, target)) / sum_over_ranks(torch.sum(w))


def cross_entropy(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Unweighted cross entropy, class axis at dim 1, mean reduction."""
    return batch_mean(_nll(logits, target))


def smooth_cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                         label_smoothing: float,
                         weight: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Label-smoothing cross entropy over flattened samples, logits (N, C),
    target (N,): a plain mean over samples; the class weights are not
    renormalised."""
    num_classes = logits.shape[1]
    one_hot = F.one_hot(target.long(), num_classes).to(logits.dtype)
    smooth = one_hot * (1.0 - label_smoothing) + label_smoothing / num_classes
    log_prob = torch.log_softmax(logits, dim=1)
    per_class = -smooth * log_prob
    if weight is not None:
        per_class = per_class * weight[None, :]
    return batch_mean(torch.sum(per_class, dim=1))


# -----------------------------------------------------------------------------
# Rotation representations
# -----------------------------------------------------------------------------

def rot6d_to_mat9(repre6d: torch.Tensor) -> torch.Tensor:
    """6-D rotation representation -> flattened 3x3 rotation, channels-first
    (port of `functional.py:102-121`).

    Input (B, 6, N): rows 0:3 the raw first column b1, rows 3:6 the raw
    second column a2.  Output (B, 9, N): the row-major flatten of
    R = [b1 | b2 | b1 x b2].  The norms are sqrt(sum + 1e-24) and a
    division, as in the JAX package (not rsqrt, which may round
    differently), so a zero column stays finite."""
    eps = 1e-24
    b1 = repre6d[:, 0:3]
    b1 = b1 / torch.sqrt(torch.sum(b1 * b1, dim=1, keepdim=True) + eps)
    a2 = repre6d[:, 3:6]
    b2 = a2 - torch.sum(a2 * b1, dim=1, keepdim=True) * b1
    b2 = b2 / torch.sqrt(torch.sum(b2 * b2, dim=1, keepdim=True) + eps)
    b3 = torch.linalg.cross(b1, b2, dim=1)
    r = torch.stack([b1, b2, b3], dim=2)       # (B, 3 rows, 3 cols, N)
    return r.reshape(r.shape[0], 9, -1)


def euler_to_mat9(euler: torch.Tensor) -> torch.Tensor:
    """Euler angles (a, b, h) -> flattened rotation, channels-first,
    (B, 3, N) -> (B, 9, N)."""
    a, b, h = euler[:, 0], euler[:, 1], euler[:, 2]
    sa, sb, sh = torch.sin(a), torch.sin(b), torch.sin(h)
    ca, cb, ch = torch.cos(a), torch.cos(b), torch.cos(h)
    return torch.stack([
        ca * ch, -ch * sa * cb + sh * sb, ch * sa * sb + sh * cb,
        sa, ca * cb, -ca * sb,
        -sh * ca, sh * sa * cb + ch * sb, -sh * sa * sb + ch * cb,
    ], dim=1)


def flip_mat9_gripper(mat9: torch.Tensor) -> torch.Tensor:
    """Negate rotation columns y and z (the gripper's 180-degree flip
    symmetry) of channels-first flattened rotations (B, 9, N)."""
    r = mat9.reshape(mat9.shape[0], 3, 3, -1)
    return torch.cat([r[:, :, :1], -r[:, :, 1:]], dim=2).reshape(mat9.shape)


def geodesic_angle(gt_mat: torch.Tensor,
                   pred_mat: torch.Tensor) -> torch.Tensor:
    """Rotation angle of gt @ pred^T for (..., 3, 3) rotations."""
    m = torch.einsum("...ij,...kj->...ik", gt_mat, pred_mat)
    trace = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    return torch.arccos(torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0))

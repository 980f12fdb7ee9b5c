"""Post-processing of one scene's predictions into camera-frame grasps, as
the S4G detector publishes it: the expected score over the score bins
(upper edges of C equal bins), the top candidates by score (ties to the
lower point), valid where above the score threshold and vertical enough
(the raw approach axis, mapped into the robot base, points up by more than
the threshold); PN2_CLS's translation is the point moved back along the
approach axis by the expected depth of its 4 bins, PN2's the predicted
origin; rotations are orthonormalized (Gram-Schmidt) and poses mapped to
the camera frame.  A candidate then collides when more than 10 sqrt(8)
valid cloud points lie in the gripper's back box or more than 10 in its
finger boxes.  Grasps are drawn from the valid candidates with weights
exp(5 score) by the replayed uniforms (inverse CDF of the sorted draws),
or every valid candidate is returned when there are no more than the
number asked for."""

from __future__ import annotations

import torch

from . import geometry as geo
from .precision import F32_VALUES, Precision


def expected_score(logits: torch.Tensor, prec: Precision) -> torch.Tensor:
    """(C, N) logits -> (N,) expected score over bins (1..C) / C."""
    c = logits.shape[0]
    e = prec.round(torch.exp(logits - logits.amax(dim=0, keepdim=True)))
    prob = prec.round(e / e.sum(dim=0))
    bins = torch.arange(1, c + 1, dtype=torch.float32,
                        device=logits.device) / c
    return prec.round((bins[:, None] * prob).sum(dim=0))


def decode(points: torch.Tensor, preds: dict, model_type: str, k: int,
           score_threshold: float, vertical_threshold: float,
           prec: Precision = F32_VALUES) -> dict:
    """One scene: points (N, 3) the model's input (training frame), preds
    its predictions channels-first -> the top `k` candidates by expected
    score: camera-frame poses (k, 4, 4), scores (k,), valid (k,) before
    the collision check."""
    dev = points.device
    p = {key: prec.round(v.float()) for key, v in preds.items()}
    logits = p["score"] if model_type == "PN2_CLS" else p["scene_score_logits"]
    scores = expected_score(logits, prec)
    order = torch.sort(scores, descending=True, stable=True)
    top, idx = order.values[:k], order.indices[:k]
    rot = p["frame_R"].t().reshape(-1, 3, 3)[idx]
    c2b = torch.tensor(geo.CAMERA2BASE, dtype=torch.float32, device=dev)
    t2r = torch.tensor(geo.TRAIN2REAL, device=dev)
    up = -((c2b @ t2r)[2] * rot[:, :, 0]).sum(dim=1)
    valid = (top > score_threshold) & (up > vertical_threshold)
    if model_type == "PN2_CLS":
        t = p["frame_t"][:, idx]
        prob = prec.round(torch.softmax(t, dim=0))
        depth = prec.round((torch.tensor(geo.T_BINS, device=dev)[:, None]
                            * prob).sum(dim=0))
        trans = prec.round(-depth[:, None] * rot[:, :, 0]
                           + prec.round(points.float())[idx])
    else:
        trans = p["frame_t"].t()[idx]
    pose = torch.zeros((len(idx), 4, 4), device=dev)
    pose[:, :3, :3] = prec.round(geo.gram_schmidt(rot))
    pose[:, :3, 3] = trans
    pose[:, 3, 3] = 1.0
    pose = prec.round(torch.matmul(
        torch.block_diag(t2r, torch.ones(1, 1, device=dev)), pose))
    return {"poses": pose, "scores": top, "valid": valid}


def collision_free(poses: torch.Tensor, cloud: torch.Tensor,
                   prec: Precision = F32_VALUES,
                   chunk: int = 64) -> torch.Tensor:
    """(G, 4, 4) camera-frame grasp poses, (n, 3) camera-frame cloud ->
    (G,) True where the gripper's back and finger boxes hold few enough
    points."""
    fl, bl = geo.f32(geo.FINGER_LENGTH), geo.f32(geo.BOTTOM_LENGTH)
    hht, hbw = geo.f32(geo.HALF_HAND_THICKNESS), geo.f32(geo.HALF_BOTTOM_WIDTH)
    hbs = geo.f32(geo.HALF_BOTTOM_SPACE)
    margin = geo.f32(geo.BACK_COLLISION_MARGIN)
    inv = prec.round(geo.invert_poses(poses)).reshape(-1, 16)
    pts = prec.round(cloud.float())
    px, py, pz = pts[:, 0], pts[:, 1], pts[:, 2]
    back, fing = [], []
    for g0 in range(0, len(inv), chunk):
        m = inv[g0:g0 + chunk, :, None]
        x, y, z = (prec.round(px * m[:, 4 * r] + py * m[:, 4 * r + 1]
                              + pz * m[:, 4 * r + 2] + m[:, 4 * r + 3])
                   for r in range(3))
        box = (x < fl) & (x > -bl) & (z < hht) & (z > -hht)
        back.append((box & (y < hbw) & (y > -hbw) & (x < -margin)).sum(1))
        fing.append((box & (((y < hbw) & (y > hbs))
                             | ((y > -hbw) & (y < -hbs)))).sum(1))
    return ((torch.cat(back) <= geo.f32(geo.BACK_COLLISION_THRESHOLD))
            & (torch.cat(fing) <= geo.FINGER_COLLISION_THRESHOLD))


def candidates(points, preds, cloud, model_type: str, k: int,
               score_threshold: float, vertical_threshold: float,
               prec: Precision = F32_VALUES) -> dict:
    """`decode` with the collision check folded into `valid`."""
    out = decode(points, preds, model_type, k, score_threshold,
                 vertical_threshold, prec)
    out["valid"] = out["valid"] & collision_free(out["poses"], cloud, prec)
    return out


def grasps(cand: dict, uniforms: torch.Tensor, num_selected: int) -> tuple:
    """The returned grasps: (poses (k, 4, 4), scores (k,)) drawn from the
    valid candidates with the replayed uniforms, or all of them."""
    valid = cand["valid"]
    num_valid = int(valid.sum())
    if num_valid == 0:
        return cand["poses"][:0], cand["scores"][:0]
    if num_valid <= num_selected:
        return cand["poses"][valid], cand["scores"][valid]
    w = torch.where(valid, torch.exp(5.0 * cand["scores"]), 0.0)
    cum = torch.cumsum(w, dim=0)
    sel = torch.searchsorted(cum, torch.sort(uniforms).values * cum[-1])
    sel = sel.clamp(max=len(cum) - 1)
    return cand["poses"][sel], cand["scores"][sel]

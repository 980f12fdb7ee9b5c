"""Contact-pair grasp labeling (the "contact" data flavour; port of
s4g_tpu/datagen/contact.py).

Re-design of GenerateContactObjectData (reference:
data_generator/data_object_contact_point_generator.py:21-221):

1. cache_contact_pairs — antipodal point pairs: within gripper opening
   (|p_i - p_j| < 2*HALF_BOTTOM_SPACE) and with the pair axis aligned to
   both normals (|cos_i * cos_j| > 0.95) (:103-123); host numpy;
2. pair frames — y = pair axis, x = world-y Gram-Schmidt'd off it,
   z = x cross y, origin = pair midpoint (:137-152); host numpy;
3. per frame x 12 thetas (rotation about the local y axis, with the gripper
   pulled back by FINGER_LENGTH - GASKET_RADIUS) x dz in {-0.015, +0.015, 0}:
   back/finger collision + close-region population, accumulated over dz and
   capped by the nominal dz (:167-221) — on the device, in chunks of about
   CHUNK_PAIRS pose-point pairs, the transforms written out in one fixed
   order (`eval_cloud.transform_rows`).

Output layout matches the reference pickle: cloud, normal, global_to_local
frames, search_score, antipodal_score, frame_point_index.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..configs import gripper_config as G
from ..ops.neighbors import _f32
from ..pipeline.eval_cloud import CHUNK_PAIRS, THIRD, transform_rows
from ..runtime.device import resolve_device
from .grading import DATAGEN_BOTTOM_LENGTH

GASKET_RADIUS = 0.012
COS_THRESHOLD = 0.95
THETA_SEARCH = tuple(np.deg2rad(t) for t in range(0, 360, 30))
THETA_NUM = len(THETA_SEARCH)
DW_SEARCH = (-0.015, 0.015, 0.0)
CLOSE_MIN = 50


def contact_search_transforms() -> Tuple[np.ndarray, np.ndarray]:
    """(local_search_to_local, local_to_local_search), each (12, 4, 4):
    rotation about the local y axis composed with a pull-back of
    FINGER_LENGTH - GASKET_RADIUS along x (reference :28-40)."""
    move_back = np.eye(4)
    move_back[0, 3] = -(G.FINGER_LENGTH - GASKET_RADIUS)
    ls2l = np.tile(np.eye(4), (THETA_NUM, 1, 1))
    for i, theta in enumerate(THETA_SEARCH):
        c, s = np.cos(theta), np.sin(theta)
        ls2l[i, 0, 0] = c
        ls2l[i, 2, 2] = c
        ls2l[i, 0, 2] = s
        ls2l[i, 2, 0] = -s
    ls2l = ls2l @ move_back
    return (ls2l.astype(np.float32),
            np.linalg.inv(ls2l).astype(np.float32))


def cache_contact_pairs(points: np.ndarray, normals: np.ndarray,
                        max_pairs: int | None = None,
                        rng: np.random.RandomState | None = None
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Antipodal pair candidates (host numpy; O(N^2) on ~2k points).

    Returns (row_index, col_index, antipodal_score)."""
    diff = points[None, :, :] - points[:, None, :]
    dist = np.linalg.norm(diff, axis=2)
    within = dist < G.HALF_BOTTOM_SPACE * 2
    axis = diff / np.clip(dist[..., None], 1e-4, None)
    cos = np.einsum("ijk,ik->ij", axis, normals)     # cos at point i
    avg_cos = np.abs(cos * cos.T)
    valid = np.triu(within & (avg_cos > COS_THRESHOLD), k=1)
    row, col = np.nonzero(valid)
    score = avg_cos[row, col]
    if max_pairs is not None and len(row) > max_pairs:
        rng = rng or np.random.RandomState(0)
        keep = rng.choice(len(row), max_pairs, replace=False)
        row, col, score = row[keep], col[keep], score[keep]
    return row, col, score.astype(np.float32)


def pair_frames(points: np.ndarray, row: np.ndarray, col: np.ndarray
                ) -> np.ndarray:
    """(P, 4, 4) local-to-global pair frames (reference :137-152)."""
    y = points[col] - points[row]
    y = y / np.clip(np.linalg.norm(y, axis=1, keepdims=True), 1e-8, None)
    ref_x = np.array([0.0, 1.0, 0.0])
    x = ref_x[None, :] - np.sum(ref_x * y, axis=1, keepdims=True) * y
    x = x / np.clip(np.linalg.norm(x, axis=1, keepdims=True), 1e-8, None)
    z = np.cross(x, y)
    frames = np.tile(np.eye(4, dtype=np.float32), (len(row), 1, 1))
    frames[:, :3, 0] = x
    frames[:, :3, 1] = y
    frames[:, :3, 2] = z
    frames[:, :3, 3] = (points[row] + points[col]) / 2
    return frames


def _contact_chunk(g2l_c, l2ls, homo):
    lx, ly, lz, lw = transform_rows(g2l_c, homo, (0, 1, 2, 3))  # (C, N)
    hbs, hbw = _f32(G.HALF_BOTTOM_SPACE), _f32(G.HALF_BOTTOM_WIDTH)
    close_plane = (ly < hbs) & (ly > -hbs)
    plane_ok = close_plane.sum(dim=-1) >= CLOSE_MIN             # (C,)
    finger_plane = (((ly < hbw) & (ly > hbs))
                    | ((ly > -hbw) & (ly < -hbs)))
    back_plane = finger_plane | close_plane

    # search = l2ls @ local: rows x and z, ((x*m0 + y*m1) + z*m2) + w*m3.
    def search_row(r):
        m = l2ls[None, :, r, :, None]                            # (1,12,4,1)
        return (lx[:, None] * m[:, :, 0] + ly[:, None] * m[:, :, 1]
                + lz[:, None] * m[:, :, 2] + lw[:, None] * m[:, :, 3])
    x, z = search_row(0), search_row(2)                          # (C, 12, N)
    back_x = (x < 0.0) & (x > -_f32(DATAGEN_BOTTOM_LENGTH))
    finger_x = (x > 0.0) & (x < _f32(G.FINGER_LENGTH))

    acc = torch.zeros(x.shape[:2], dtype=x.dtype, device=x.device)
    last_count = torch.zeros_like(acc)
    for dw in DW_SEARCH:
        dw = _f32(dw)
        z_ok = ((z < _f32(_f32(G.HALF_HAND_THICKNESS) + dw))
                & (z > _f32(_f32(-G.HALF_HAND_THICKNESS) + dw)))
        back_ok = (back_x & z_ok & back_plane[:, None, :]).sum(dim=-1) <= 0
        finger_ok = ((finger_x & z_ok & finger_plane[:, None, :]).sum(dim=-1)
                     <= 0)
        count = (finger_x & z_ok & close_plane[:, None, :]).sum(
            dim=-1).to(acc.dtype)
        ok = back_ok & finger_ok & (count >= CLOSE_MIN)
        acc = acc + torch.where(ok, count * THIRD, 0.0)
        last_count = torch.where(back_ok & finger_ok, count, last_count)
    valid = ((acc >= CLOSE_MIN) & (last_count >= CLOSE_MIN)
             & plane_ok[:, None])
    return torch.minimum(acc, last_count), valid


def grade_contact_pairs(g2l: torch.Tensor, points_homo: torch.Tensor,
                        chunk: Optional[int] = None):
    """Grade P pair frames x 12 thetas against the object cloud.

    Args:
        g2l: (P, 4, 4) global -> pair-local transforms.
        points_homo: (4, N) (w = 1).
        chunk: frames per chunk (default: about CHUNK_PAIRS / (12 N); the
            result does not depend on it).

    Returns:
        search (P, 12) float, valid (P, 12) bool — pose accepted when the
        dz-accumulated close count >= 50 AND the nominal-dz count >= 50
        (reference :212-217).
    """
    _, l2ls = contact_search_transforms()
    l2ls = torch.from_numpy(l2ls).to(g2l.device)
    p, n = g2l.shape[0], points_homo.shape[1]
    if chunk is None:
        chunk = max(1, CHUNK_PAIRS // (THETA_NUM * max(n, 1)))
    parts = [_contact_chunk(g2l[c0:c0 + chunk], l2ls, points_homo)
             for c0 in range(0, p, chunk)]
    if not parts:
        return (torch.zeros((0, THETA_NUM), device=g2l.device),
                torch.zeros((0, THETA_NUM), dtype=torch.bool,
                            device=g2l.device))
    search, valid = (torch.cat(x) for x in zip(*parts))
    return search, valid


def generate_contact_object_data(points: np.ndarray, normals: np.ndarray,
                                 max_pairs: int = 4096,
                                 rng: np.random.RandomState | None = None,
                                 device: Optional[str] = None) -> dict:
    """Full per-object contact labeling -> reference pickle layout
    (:66-76); the grading on `device` (None is CUDA), the rest host
    numpy."""
    dev = resolve_device(device, "generate_contact_object_data")
    rng = rng or np.random.RandomState(0)
    row, col, pair_score = cache_contact_pairs(points, normals,
                                               max_pairs=max_pairs, rng=rng)
    if len(row) == 0:
        return {"cloud": points, "normal": normals,
                "global_to_local": np.zeros((0, 4, 4), np.float32),
                "search_score": np.zeros((0,), np.float32),
                "antipodal_score": np.zeros((0,), np.float32),
                "frame_point_index": np.zeros((0,), np.int64)}
    frames_l2g = pair_frames(points, row, col)
    g2l = np.linalg.inv(frames_l2g.astype(np.float64)).astype(np.float32)
    homo = np.concatenate(
        [points.T, np.ones((1, len(points)))]).astype(np.float32)
    search, valid = grade_contact_pairs(torch.from_numpy(g2l).to(dev),
                                        torch.from_numpy(homo).to(dev))
    search, valid = search.cpu().numpy(), valid.cpu().numpy()

    ls2l, l2ls = contact_search_transforms()
    out_frames, out_search, out_antip, out_index = [], [], [], []
    centers_l2g = frames_l2g[:, :3, 3]
    for pi, ti in zip(*np.nonzero(valid)):
        final_g2l = l2ls[ti] @ g2l[pi]
        out_frames.append(final_g2l)
        out_search.append(search[pi, ti])
        out_antip.append(pair_score[pi])
        # nearest cloud point to the frame centre (reference :80-86)
        center = np.linalg.inv(final_g2l)[0:3, 3]
        out_index.append(int(np.argmin(
            np.sum((points - center) ** 2, axis=1))))
    return {
        "cloud": points, "normal": normals,
        "global_to_local": (np.stack(out_frames)
                            if out_frames else np.zeros((0, 4, 4), np.float32)),
        "search_score": np.asarray(out_search, np.float32),
        "antipodal_score": np.asarray(out_antip, np.float32),
        "frame_point_index": np.asarray(out_index, np.int64),
    }

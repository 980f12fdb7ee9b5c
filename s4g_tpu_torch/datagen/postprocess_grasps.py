"""Single-object grasp post-processing: dedupe and redistribute frames
(a numpy copy of s4g_tpu/datagen/postprocess_grasps.py).

Re-design of post_process_single_grasp (reference:
post_process_single_grasp.py:31-142): filter by minimum search score, keep
at most FRAME_PER_POINT frames per grasp point, redistribute excess frames
to nearby points that have none, and emit normalized per-point quality
scores plus the final local->global grasp poses.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

MIN_SEARCH_SCORE = 40
FRAME_PER_POINT = 1
MAX_NEIGHBOR_FRAME = 1
NEIGHBOR_RADIUS = 0.01


def inverse_batch_pose(poses: np.ndarray) -> np.ndarray:
    """SE(3) batch inverse (reference post_process_single_grasp.py:21-26)."""
    out = np.zeros_like(poses)
    out[:, :3, :3] = np.transpose(poses[:, :3, :3], (0, 2, 1))
    out[:, 3, 3] = 1.0
    out[:, :3, 3:4] = -np.matmul(out[:, :3, :3], poses[:, :3, 3:4])
    return out


def normalized_point_score(search_score: np.ndarray,
                           antipodal_score: np.ndarray) -> np.ndarray:
    """min(log(search+1)/3, 1) * antipodal, min-max normalized
    (reference :64-66)."""
    score = np.minimum(np.log(search_score + 1.0) / 3.0, 1.0) * antipodal_score
    lo, hi = score.min(), score.max()
    return (score - lo) / max(hi - lo, 1e-12)


def postprocess_single_object_grasps(data: Dict[str, np.ndarray]) -> dict:
    """Args: the contact per-object pickle (cloud/normal/global_to_local/
    search_score/antipodal_score/frame_point_index).

    Returns {grasp_pose (local->global), grasp_point_index, cloud, normal}
    (reference :129-133)."""
    cloud = np.asarray(data["cloud"])
    frames = np.asarray(data["global_to_local"])
    search = np.asarray(data["search_score"])
    point_index = np.asarray(data["frame_point_index"])

    keep = search > MIN_SEARCH_SCORE
    frames, point_index = frames[keep], point_index[keep]

    num_points = len(cloud)
    point_frame_num = np.zeros(num_points, np.int64)
    frame_list, index_list = [], []

    for i in range(num_points):
        mine = np.nonzero(point_index == i)[0]
        if len(mine) == 0:
            continue
        take = min(FRAME_PER_POINT - point_frame_num[i], len(mine))
        if take > 0:
            frame_list.append(frames[mine[:take]])
            index_list.extend([i] * take)
            point_frame_num[i] += take
        rest = mine[take:]
        if len(rest) > 5:
            # redistribute extras to close-by points without frames
            d = np.sum((cloud - cloud[i]) ** 2, axis=1)
            nbrs = np.nonzero(d < NEIGHBOR_RADIUS ** 2)[0]
            ri = 0
            for nb in nbrs[:5]:
                if nb == i or ri >= len(rest):
                    continue
                cap = (FRAME_PER_POINT if nb < i else MAX_NEIGHBOR_FRAME)
                if point_frame_num[nb] < cap:
                    point_frame_num[nb] += 1
                    frame_list.append(frames[rest[ri:ri + 1]])
                    index_list.append(int(nb))
                    ri += 1

    if frame_list:
        final_frames = np.concatenate(frame_list, axis=0)
        final_index = np.asarray(index_list, np.int64)
    else:
        final_frames = np.zeros((0, 4, 4), np.float32)
        final_index = np.zeros((0,), np.int64)

    return {
        "grasp_pose": inverse_batch_pose(final_frames),
        "grasp_point_index": final_index,
        "cloud": cloud,
        "normal": np.asarray(data["normal"]),
    }

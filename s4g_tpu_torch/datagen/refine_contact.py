"""Contact-object grasp refinement + smoothing (contact-flavour pipeline;
port of s4g_tpu/datagen/refine_contact.py).

Re-design of the reference's two post-stages for contact single-object data:

* refine_contact_object — re-check every cached frame under small gripper
  perturbations (reference: data_gen/utils/refine_contact_object.py:20-121):
  for each offset (dz in HEIGHT_SEARCH) x (dy in WIDTH_SEARCH) x
  (dx in LENGTH_SEARCH) the finger-sweep region must be collision-free, the
  close region must hold at least MIN_REFINE_SCORE points, and no close-region
  point may sit behind the palm (local x < 0).  The refined search_score is
  the minimum close-region population over all offsets.  The reference loops
  frame-by-frame in python; here one batched (frames x offsets x points)
  masked reduction runs on the device, in chunks of about CHUNK_PAIRS
  frame-point pairs, the transform written out in one fixed order
  (`eval_cloud.transform_rows`).

* smooth_contact_object — per-point frame budget + neighbour redistribution
  (reference: data_gen/utils/smooth_contact_object.py:18-102): keep at most
  FRAME_PER_POINT frames per grasp point; when a point holds more than that
  and has >5 extras, hand extras to its 5 nearest neighbours within 1 cm
  (earlier points get the full budget, later points MAX_NEIGHBOR_FRAME).
  Sequential by construction (the budget bookkeeping is a running state), so
  this stays host-side numpy like the reference.

Both take/return the contact per-object dict layout produced by
datagen.contact: {cloud (N,3), normal (N,3), global_to_local (F,4,4),
search_score (F,), antipodal_score (F,), frame_point_index (F,)}.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..configs import gripper_config as G
from ..ops.neighbors import _f32
from ..pipeline.eval_cloud import CHUNK_PAIRS
from ..runtime.device import resolve_device
from ..pipeline.eval_cloud import transform_rows
from .grading import DATAGEN_BOTTOM_LENGTH

# reference refine_contact_object.py:16-23
MIN_REFINE_SCORE = 100
WIDTH_SEARCH = (0.0,)
HEIGHT_SEARCH = (-0.01, 0.01, 0.0)
LENGTH_SEARCH = (-0.01, 0.01, 0.0)

# reference smooth_contact_object.py:14-16
SMOOTH_FRAME_PER_POINT = 5
SMOOTH_MAX_NEIGHBOR_FRAME = 4
SMOOTH_MIN_SEARCH_SCORE = 50
SMOOTH_NEIGHBOR_RADIUS = 0.01
SMOOTH_NEIGHBOR_NN = 5


def _refine_chunk(frames: torch.Tensor, homo_cloud: torch.Tensor
                  ) -> torch.Tensor:
    """Batched perturbation re-check for a chunk of frames.

    Args:
        frames: (F, 4, 4) global->local gripper frames.
        homo_cloud: (4, N) homogeneous object cloud (w = 1).

    Returns:
        (F,) int32 refined scores; -1 where the frame fails any offset
        (collision, under-populated close region, or a close-region point
        behind the palm — reference refine_contact_object.py:71-97).
    """
    x, y, z = transform_rows(frames, homo_cloud, (0, 1, 2))     # (F, N)
    hht, hbs = _f32(G.HALF_HAND_THICKNESS), _f32(G.HALF_BOTTOM_SPACE)
    hbw = _f32(G.HALF_BOTTOM_WIDTH)
    all_ok = torch.ones(frames.shape[0], dtype=torch.bool,
                        device=frames.device)
    score = None
    behind_x = x < 0
    for dz in HEIGHT_SEARCH:
        dz = _f32(dz)
        z_bool = (z < _f32(hht + dz)) & (z > _f32(-hht + dz))
        for dy in WIDTH_SEARCH:
            dy = _f32(dy)
            y_in = (y < _f32(hbs + dy)) & (y > _f32(-hbs + dy))
            abs_y = torch.abs(y + dy)
            y_col = (abs_y > hbs) & (abs_y < hbw)
            for dx in LENGTH_SEARCH:
                dx = _f32(dx)
                x_bool = ((x > _f32(_f32(-DATAGEN_BOTTOM_LENGTH) + dx))
                          & (x < _f32(_f32(G.FINGER_LENGTH) + dx)))
                collision = (z_bool & x_bool & y_col).any(dim=-1)
                close = x_bool & z_bool & y_in
                close_num = close.sum(dim=-1, dtype=torch.int32)
                behind = (close & behind_x).any(dim=-1)
                all_ok &= ~collision & (close_num >= MIN_REFINE_SCORE) \
                    & ~behind
                score = (close_num if score is None
                         else torch.minimum(score, close_num))
    return torch.where(all_ok, score, -1)


def refine_contact_object(data: Dict[str, np.ndarray],
                          chunk: Optional[int] = None,
                          device: Optional[str] = None) -> dict:
    """Filter + re-score contact frames under gripper perturbations
    (`device` None is CUDA).

    Mirrors refine_contact_object.py:44-116: frames below MIN_REFINE_SCORE
    are dropped up front, survivors get the min close-region population over
    the offset grid as their new search_score.  `chunk` frames go through
    at a time (default: about CHUNK_PAIRS / N; the result does not depend
    on it).
    """
    dev = resolve_device(device, "refine_contact_object")
    cloud = np.asarray(data["cloud"], np.float32)
    normal = np.asarray(data["normal"], np.float32)
    frames = np.asarray(data["global_to_local"], np.float32)
    search = np.asarray(data["search_score"])
    antipodal = np.asarray(data["antipodal_score"])
    point_index = np.asarray(data["frame_point_index"]).astype(np.int64)

    keep = search > MIN_REFINE_SCORE                # reference :46
    frames, search = frames[keep], search[keep]
    antipodal, point_index = antipodal[keep], point_index[keep]

    homo = torch.from_numpy(np.concatenate(
        [cloud.T, np.ones((1, len(cloud)), np.float32)])).to(dev)
    if chunk is None:
        chunk = max(1, CHUNK_PAIRS // max(len(cloud), 1))
    frames_t = torch.from_numpy(frames).to(dev)
    scores = [_refine_chunk(frames_t[s:s + chunk], homo)
              for s in range(0, len(frames), chunk)]
    scores = (torch.cat(scores).cpu().numpy() if scores
              else np.zeros((0,), np.int32))
    ok = scores > 0

    return {
        "cloud": cloud,
        "normal": normal,
        "global_to_local": frames[ok],
        "frame_point_index": point_index[ok],
        "search_score": scores[ok].astype(np.float64),
        "antipodal_score": antipodal[ok],
    }


def _radius_neighbors(cloud: np.ndarray, i: int, radius: float,
                      max_nn: int) -> np.ndarray:
    """Up to max_nn nearest points within radius, ascending distance —
    open3d search_hybrid_vector_3d semantics (includes the query point)."""
    d2 = np.sum((cloud - cloud[i]) ** 2, axis=1)
    within = np.nonzero(d2 <= radius * radius)[0]
    order = within[np.argsort(d2[within], kind="stable")]
    return order[:max_nn]


def smooth_contact_object(data: Dict[str, np.ndarray]) -> dict:
    """Per-point frame budget + neighbour redistribution.

    Mirrors smooth_contact_object.py:36-99, including its quirks: the
    extras handed to neighbours start at index FRAME_PER_POINT of the
    point's frame list (not after the taken prefix), and the self-neighbour
    returned by the hybrid KD search is skipped because neither budget
    branch matches it.
    """
    cloud = np.asarray(data["cloud"], np.float64)
    frames = np.asarray(data["global_to_local"])
    search = np.asarray(data["search_score"])
    antipodal = np.asarray(data["antipodal_score"])
    point_index = np.asarray(data["frame_point_index"]).astype(np.int64)

    keep = search > SMOOTH_MIN_SEARCH_SCORE         # reference :37
    frames, search = frames[keep], search[keep]
    antipodal, point_index = antipodal[keep], point_index[keep]

    num_points = len(cloud)
    point_frame_num = np.zeros(num_points, np.int64)
    frame_list, index_list, search_list, anti_list = [], [], [], []

    for i in range(num_points):
        mine = np.nonzero(point_index == i)[0]
        if len(mine) > SMOOTH_FRAME_PER_POINT:
            take = mine[:SMOOTH_FRAME_PER_POINT - point_frame_num[i]]
            frame_list.append(frames[take])
            search_list.append(search[take])
            anti_list.append(antipodal[take])
            index_list.extend([i] * len(take))
            point_frame_num[i] += len(take)
            rest = mine[SMOOTH_FRAME_PER_POINT:]
            if len(rest) > 5:
                nbrs = _radius_neighbors(cloud, i, SMOOTH_NEIGHBOR_RADIUS,
                                         SMOOTH_NEIGHBOR_NN)
                for nn_num, nb in enumerate(nbrs):
                    if nn_num >= len(rest):
                        break
                    cap = (SMOOTH_FRAME_PER_POINT if nb < i
                           else SMOOTH_MAX_NEIGHBOR_FRAME)
                    if nb != i and point_frame_num[nb] < cap:
                        point_frame_num[nb] += 1
                        frame_list.append(frames[rest[nn_num:nn_num + 1]])
                        search_list.append(search[rest[nn_num:nn_num + 1]])
                        anti_list.append(antipodal[rest[nn_num:nn_num + 1]])
                        index_list.append(int(nb))
        elif len(mine) > 0:
            take = min(SMOOTH_FRAME_PER_POINT - point_frame_num[i], len(mine))
            frame_list.append(frames[mine[:take]])
            search_list.append(search[mine[:take]])
            anti_list.append(antipodal[mine[:take]])
            index_list.extend([i] * take)
            point_frame_num[i] += take

    if frame_list:
        out_frames = np.concatenate(frame_list, axis=0)
        out_search = np.concatenate(search_list, axis=0)
        out_anti = np.concatenate(anti_list, axis=0)
        out_index = np.asarray(index_list, np.int64)
    else:
        out_frames = np.zeros((0, 4, 4), frames.dtype)
        out_search = np.zeros((0,), search.dtype)
        out_anti = np.zeros((0,), antipodal.dtype)
        out_index = np.zeros((0,), np.int64)

    return {
        "cloud": np.asarray(data["cloud"]),
        "normal": np.asarray(data["normal"]),
        "global_to_local": out_frames,
        "frame_point_index": out_index,
        "search_score": out_search,
        "antipodal_score": out_anti,
    }

"""Evaluation-set builder (port of s4g_tpu/datagen/eval_data.py).

Re-design of EvalDataGenerator (reference:
eval/evaluation_data_generator.py:30-453): per rendered view, sample random
above-table grasp points, estimate Darboux frames on the VIEW cloud itself
(the online variant, unlike the precomputed label transfer), check view
collision (`pipeline.collision.batch_view_non_collision`: the CUDA kernel
K5 on the card once poses x points reach its threshold), and grade ground
truth against the dense labeled scene (antipodal + single-object).
Optionally attach the baseline payloads (close-region clouds + GPD
projection maps) for GPD/PointNetGPD eval.
"""

from __future__ import annotations

import pickle
from typing import Optional

import numpy as np
import torch

from ..pipeline.collision import batch_view_non_collision
from ..pipeline.eval_cloud import eval_frames
from ..runtime.device import resolve_device
from .baseline_generator import baseline_payloads
from .grading import darboux_frames, estimate_normals, se3_inv
from .label_transfer import SAMPLE_REGION

# Baseline payloads attached per view (the first non-colliding grasps).
BASELINE_GRASPS = 300


def generate_eval_view(view_cloud: np.ndarray, camera_location: np.ndarray,
                       scene: dict, num_grasp_points: int = 2000,
                       rng: Optional[np.random.RandomState] = None,
                       with_baseline: bool = False,
                       save_path: Optional[str] = None,
                       device: Optional[str] = None) -> dict:
    """Build one view's eval record (`device` None is CUDA).

    Args:
        view_cloud: (N, 3) single-view points (world frame).
        scene: labeled scene dict (compose_scene output).

    Returns dict with frames, antipodal_score, non_collision_bool,
    single_label_bool (reference evaluation_data_generator.py:91-110).
    """
    dev = resolve_device(device, "generate_eval_view")
    rng = rng or np.random.RandomState()
    view_cloud = np.asarray(view_cloud, np.float32)

    above = np.nonzero(view_cloud[:, 2] > SAMPLE_REGION)[0]
    if len(above) == 0:
        return {"frames": np.zeros((0, 4, 4), np.float32)}
    pick = rng.choice(above, min(num_grasp_points, len(above)),
                      replace=len(above) < num_grasp_points)
    points = view_cloud[pick]

    view_t = torch.from_numpy(view_cloud).to(dev)
    normals = estimate_normals(
        view_t, torch.from_numpy(np.asarray(camera_location,
                                            np.float32)).to(dev))
    frames_all, _ = darboux_frames(view_t, normals)
    frames = frames_all.cpu().numpy()[pick]                  # (P, 3, 3)

    poses = np.tile(np.eye(4, dtype=np.float32), (len(pick), 1, 1))
    poses[:, :3, :3] = frames
    poses[:, :3, 3] = points
    g2l = se3_inv(torch.from_numpy(poses).to(dev))

    non_collision = batch_view_non_collision(g2l, view_t).cpu().numpy()
    result = eval_frames(
        g2l, *[torch.from_numpy(np.asarray(scene[k], dt)).to(dev)
               for k, dt in (("cloud", np.float32), ("normal", np.float32),
                             ("label", np.int32))])

    record = {
        "frames": poses,
        "grasp_point_index": pick.astype(np.int64),
        "view_cloud": view_cloud,
        "antipodal_score": result.antipodal_score.cpu().numpy(),
        "non_collision_bool": non_collision,
        "single_label_bool": ~result.multi_objects.cpu().numpy(),
        "scene_collision_bool": result.collision.cpu().numpy(),
    }

    if with_baseline:
        keep = np.nonzero(non_collision)[0][:BASELINE_GRASPS]
        close, maps = baseline_payloads(
            g2l[torch.from_numpy(keep).to(dev)], view_t, normals)
        record["baseline_index"] = keep.astype(np.int64)
        record["close_region_points"] = close
        record["close_region_projection_maps"] = maps

    if save_path:
        with open(save_path, "wb") as f:
            pickle.dump(record, f)
    return record

"""Baseline (GPD / PointNetGPD) training-data generator (port of
s4g_tpu/datagen/baseline_generator.py).

Re-design of TorchBaseLineSingleViewPointCloud / the precomputed twin
(reference: pcd_classes/torch_baseline_single_view_point_cloud.py:23-332,
generate_baseline_training_data.py): sample candidate grasp points above the
table on a single view, estimate Darboux frames on the view cloud, grade
each (frame x length x theta) pose against the labeled scene (collision +
antipodal, keeping the best-scoring pose per point), and extract the
close-region point sets + 12-channel projection maps for the accepted
grasps.  The grasp-quality CLASS label for training discretizes the
antipodal score.  The draws and the pose bookkeeping are host numpy, as in
the JAX package; normals, frames, grading and payloads run on `device`.
"""

from __future__ import annotations

import pickle
from typing import Optional

import numpy as np
import torch

from ..pipeline.eval_cloud import eval_frames
from ..runtime.device import resolve_device
from .baseline_data import close_region_projection, extract_close_region
from .grading import (darboux_frames, estimate_normals,
                      search_grid_transforms, se3_inv)
from .label_transfer import SAMPLE_REGION


def baseline_payloads(g2l: torch.Tensor, cloud: torch.Tensor,
                      normals: torch.Tensor, num_points: int = 1024):
    """`baseline_data.baseline_grasp_data` for G grasps on device tensors:
    close-region points (G, 3, num_points) and projection maps
    (G, 12, 60, 60), as numpy."""
    valid = torch.ones(cloud.shape[0], dtype=torch.bool, device=cloud.device)
    slots = torch.arange(num_points, device=cloud.device)
    pts_out, maps_out = [], []
    for pose in g2l:
        pts, nrm, count = extract_close_region(pose, cloud, normals, valid,
                                               num_points)
        maps_out.append(close_region_projection(
            pts, nrm, slots < torch.clamp(count, min=1)))
        pts_out.append(pts)
    if not pts_out:
        return (np.zeros((0, 3, num_points), np.float32),
                np.zeros((0, 12, 60, 60), np.float32))
    return (torch.stack(pts_out).cpu().numpy(),
            torch.stack(maps_out).cpu().numpy())


def generate_baseline_view(view_cloud: np.ndarray,
                           camera_location: np.ndarray, scene: dict,
                           grasp_num: int = 300,
                           score_classes: int = 3,
                           num_close_points: int = 1024,
                           rng: Optional[np.random.RandomState] = None,
                           save_path: Optional[str] = None,
                           device: Optional[str] = None) -> dict:
    """One view -> baseline training record (`device` None is CUDA).

    Returns dict with close_region_points (G, 3, P),
    close_region_projection_maps (G, 12, 60, 60), grasp_score_labels (G,),
    baseline_frame (G, 4, 4), antipodal_score (G,).
    """
    dev = resolve_device(device, "generate_baseline_view")
    rng = rng or np.random.RandomState()
    view_cloud = np.asarray(view_cloud, np.float32)

    above = np.nonzero(view_cloud[:, 2] > SAMPLE_REGION)[0]
    if len(above) == 0:
        return {"grasp_score_labels": np.zeros(0, np.int64)}
    rng.shuffle(above)

    view_t = torch.from_numpy(view_cloud).to(dev)
    normals = estimate_normals(
        view_t, torch.from_numpy(np.asarray(camera_location,
                                            np.float32)).to(dev))
    frames_all, _ = darboux_frames(view_t, normals)
    frames_all = frames_all.cpu().numpy()
    scene_t = [torch.from_numpy(np.asarray(scene[k], dt)).to(dev)
               for k, dt in (("cloud", np.float32), ("normal", np.float32),
                             ("label", np.int32))]

    # candidate poses: per sampled point, its Darboux frame across the
    # search grid; keep the best-antipodal pose per point
    # (the reference keeps the max over the local search, :307-311)
    grid_inv = np.linalg.inv(
        search_grid_transforms().astype(np.float64)).astype(np.float32)

    picked, kept_poses, kept_scores = [], [], []
    chunk = 256
    for start in range(0, len(above), chunk):
        if len(picked) >= grasp_num:
            break
        pts_idx = above[start:start + chunk]
        frames = frames_all[pts_idx]
        ok = np.abs(frames).mean(axis=(1, 2)) > 1e-6
        pts_idx, frames = pts_idx[ok], frames[ok]
        if len(pts_idx) == 0:
            continue
        # local->global poses for all grid cells of these points
        l2g = np.tile(np.eye(4, dtype=np.float32), (len(pts_idx), 1, 1))
        l2g[:, :3, :3] = frames
        l2g[:, :3, 3] = view_cloud[pts_idx]
        poses = np.einsum("gij,pjk->pgik", grid_inv, l2g)  # (P, LT, 4, 4)
        flat = poses.reshape(-1, 4, 4)
        res = eval_frames(se3_inv(torch.from_numpy(flat).to(dev)),
                          *scene_t)
        scores = res.antipodal_score.cpu().numpy().reshape(len(pts_idx), -1)
        best = np.argmax(scores, axis=1)
        best_score = scores[np.arange(len(pts_idx)), best]
        good = best_score > 1e-4
        for p in np.nonzero(good)[0]:
            picked.append(int(pts_idx[p]))
            kept_poses.append(flat.reshape(len(pts_idx), -1, 4, 4)[p, best[p]])
            kept_scores.append(float(best_score[p]))
            if len(picked) >= grasp_num:
                break

    if not picked:
        return {"grasp_score_labels": np.zeros(0, np.int64)}

    poses = np.stack(kept_poses)
    scores = np.asarray(kept_scores, np.float32)
    close_pts, proj_maps = baseline_payloads(
        se3_inv(torch.from_numpy(poses).to(dev)), view_t, normals,
        num_close_points)

    labels = np.minimum((scores * score_classes).astype(np.int64),
                        score_classes - 1)
    record = {
        "baseline_frame": poses,
        "grasp_point_index": np.asarray(picked, np.int64),
        "antipodal_score": scores,
        "grasp_score_labels": labels,
        "close_region_points": close_pts,
        "close_region_projection_maps": proj_maps,
        "view_cloud": view_cloud,
    }
    if save_path:
        with open(save_path, "wb") as f:
            pickle.dump(record, f)
    return record


def collate_baseline_batch(records: list, batch_grasps: int,
                           rng: Optional[np.random.RandomState] = None
                           ) -> dict:
    """Stack per-view baseline records into a GPD/PointNetGPD train batch."""
    rng = rng or np.random.RandomState()
    pts, maps, labels = [], [], []
    for rec in records:
        g = len(rec["grasp_score_labels"])
        if g == 0:
            continue
        take = rng.choice(g, min(batch_grasps, g), replace=g < batch_grasps)
        pts.append(rec["close_region_points"][take])
        maps.append(rec["close_region_projection_maps"][take])
        labels.append(rec["grasp_score_labels"][take])
    return {
        "close_region_points": np.concatenate(pts),
        "close_region_projection_maps": np.concatenate(maps),
        "grasp_score_labels": np.concatenate(labels),
    }


def scene_from_ply(path: str, device: Optional[str] = None) -> dict:
    """Load a labeled eval scene from a colored PLY (labels encoded in the
    red channel, reference eval/torch_scene_point_cloud.py +
    dataset_config.color_array_to_label); normals estimated on `device`
    (None is CUDA)."""
    from .dataset_config import color_array_to_label
    dev = resolve_device(device, "scene_from_ply")

    # read points + colors (extend the reader for colors inline)
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        n = 0
        props = []
        for line in header:
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line.startswith("property"):
                props.append(line.split()[-1])
        rows = [f.readline().split() for _ in range(n)]
    data = np.asarray(rows, np.float64)
    name_to_col = {p: i for i, p in enumerate(props)}
    pts = data[:, [name_to_col["x"], name_to_col["y"], name_to_col["z"]]]
    if "red" in name_to_col:
        colors = data[:, [name_to_col["red"], name_to_col["green"],
                          name_to_col["blue"]]] / 255.0
        labels = color_array_to_label(colors)
    else:
        labels = np.zeros(n, np.int64)
    cloud = pts.astype(np.float32)
    # normals for eval scenes: estimated toward the centroid-up direction
    center = cloud.mean(0) + np.array([0, 0, 1.0], np.float32)
    normals = estimate_normals(torch.from_numpy(cloud).to(dev),
                               torch.from_numpy(center).to(dev))
    normals = normals.cpu().numpy()
    return {"cloud": cloud, "normal": normals, "label": labels}

"""Label transfer: precomputed scene grasp labels -> single-view training data
(port of s4g_tpu/datagen/label_transfer.py).

Re-design of TorchPrecomputedSingleViewPointCloud (reference:
pcd_classes/torch_precomputed_single_view_point_cloud.py:14-396):

1. processing_and_trace — workspace crop, voxel downsample with index trace
   (max original index per voxel, matching the reference's
   np.max(trace, axis=1) at :90), radius outlier removal;
2. match_to_scene — per view point, nearest scene point within
   CURVATURE_RADIUS; copy its Darboux frame/normal/scores; flip the frame
   (and swap in the inv scores) when the oriented view normal agrees with
   the frame x-axis (:162-170);
3. the "magic formula" validity filter (search > 50 & antipodal > 0.3 &
   z > SAMPLE_REGION, :172-185);
4. finger_hand — per candidate frame x (length x theta) search pose, check
   table collision (gripper bound corners), back/finger collision vs the
   dense scene cloud, close-region population and single-object membership,
   then copy the per-pose scores (:277-396), over (candidates x poses x
   scene points) in chunks of about CHUNK_PAIRS pose-point pairs.

As in the JAX package: voxels past `capacity` are dropped (a scatter there
drops out-of-range rows; here they land in the dropped sink row), the voxel
hash wraps as int32, the voxel size divides as the multiply by its f32
reciprocal that XLA makes of it, and the sort is stable.  The matmul-form
distances of the outlier test and the 1-NN match are `grading.
matmul_sqdist` (the JAX package's CPU bits, and the same on the card),
taken a block of rows at a time: each row's count or argmin is its own.

Thresholds use the data-gen config (reference data_gen/configs/config.py):
BOTTOM_LENGTH 0.08, BACK/FINGER collision thresholds 0, close-region >= 10.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..configs import gripper_config as G
from ..ops.neighbors import _f32
from ..pipeline.eval_cloud import CHUNK_PAIRS, eval_frames, transform_rows
from ..pipeline.preprocessing import _voxel_groups, workspace_crop_mask
from ..runtime.device import resolve_device
from .grading import (DATAGEN_BOTTOM_LENGTH, DATAGEN_CLOSE_REGION_MIN_POINTS,
                      DATAGEN_NUM_POINTS_THRESHOLD, LENGTH_SEARCH,
                      THETA_SEARCH, _dot3, _global_to_local, _unit,
                      darboux_frames, estimate_normals, local_to_global,
                      mat4_mul, matmul_sqdist, search_grid_transforms,
                      se3_inv)

TABLE_HEIGHT = 0.75
SAMPLE_REGION = TABLE_HEIGHT + 0.015
TABLE_COLLISION_OFFSET = 0.005
CURVATURE_RADIUS = 0.01
DATAGEN_WORKSPACE = (-0.4, 0.4, -0.35, 0.35, TABLE_HEIGHT - 0.001,
                     TABLE_HEIGHT + 0.45)
VOXEL_SIZE = 0.005
OUTLIER_RADIUS = 0.04
OUTLIER_MIN_NEIGHBORS = 8
MAGIC_SEARCH_MIN = 50
MAGIC_ANTIPODAL_MIN = 0.3
VALID_SEARCH_MIN = 1.0
VALID_ANTIPODAL_MIN = 0.1

NUM_L, NUM_T = len(LENGTH_SEARCH), len(THETA_SEARCH)

# Distance-matrix entries per block of rows (outlier test, 1-NN match).
DIST_BLOCK = 1 << 24


class TraceResult(NamedTuple):
    points: torch.Tensor        # (capacity, 3) voxel-averaged view points
    index_in_ref: torch.Tensor  # (capacity,) max original index per voxel
    valid: torch.Tensor         # (capacity,) bool


def _row_blocks(m: int, n: int):
    step = max(1, DIST_BLOCK // max(n, 1))
    return [(r0, min(r0 + step, m)) for r0 in range(0, m, step)]


def _outlier_mask(points, valid, radius: float, min_neighbors: int):
    """Keep points with >= min_neighbors valid points within radius (self
    included), with `matmul_sqdist` distances (the JAX package's
    `radius_outlier_mask`)."""
    r2 = _f32(radius * radius)
    counts = [((matmul_sqdist(points[r0:r1], points) < r2)
               & valid[None, :]).sum(dim=1)
              for r0, r1 in _row_blocks(points.shape[0], points.shape[0])]
    return valid & (torch.cat(counts) >= min_neighbors)


def processing_and_trace(points: torch.Tensor, capacity: int = 32768,
                         workspace=DATAGEN_WORKSPACE) -> TraceResult:
    """Crop -> voxel (with max-index trace) -> outlier removal.

    points: (N, 3) noisy view cloud.
    """
    valid = workspace_crop_mask(points, workspace)
    order, group, mean, num_voxels = _voxel_groups(points, valid, VOXEL_SIZE,
                                                   capacity)
    max_idx = torch.full((capacity + 1,), -1, dtype=torch.int64,
                         device=points.device)
    max_idx.scatter_reduce_(0, group, order, "amax")
    vox_valid = (torch.arange(capacity, device=points.device)
                 < torch.clamp(num_voxels, max=capacity))
    keep = _outlier_mask(mean, vox_valid, OUTLIER_RADIUS,
                         OUTLIER_MIN_NEIGHBORS)
    return TraceResult(mean, max_idx[:capacity].to(torch.int32), keep)


class MatchResult(NamedTuple):
    frames: torch.Tensor           # (V, 3, 3) matched scene frames (flipped)
    normals: torch.Tensor          # (V, 3) oriented view normals
    search_score: torch.Tensor     # (V, L, T)
    antipodal_score: torch.Tensor  # (V, L, T)
    matched: torch.Tensor          # (V,) bool — scene neighbour in radius
    index: torch.Tensor            # (V,) int64 nearest scene point


def match_to_scene(ref_points, camera_location, scene_cloud, scene_normals,
                   scene_frames, scene_inv_frames, scene_search,
                   scene_inv_search, scene_antipodal, scene_inv_antipodal
                   ) -> MatchResult:
    """1-NN match of view points into the labeled scene cloud (the first
    minimum of the matmul-form distances, as `jnp.argmin`).

    ref_points: (V, 3) clean reference positions of the view points.
    scene_*: labeled scene tensors (N, ...).
    """
    nn, nn_d = [], []
    for r0, r1 in _row_blocks(ref_points.shape[0], scene_cloud.shape[0]):
        d = matmul_sqdist(ref_points[r0:r1], scene_cloud)
        i = torch.argmin(d, dim=1)
        nn.append(i)
        nn_d.append(torch.gather(d, 1, i[:, None])[:, 0])
    nn = torch.cat(nn)
    matched = torch.cat(nn_d) <= _f32(CURVATURE_RADIUS ** 2)

    up = torch.tensor([0.0, 0.0, 1.0], dtype=scene_normals.dtype,
                      device=scene_normals.device)
    frames = scene_frames[nn]
    normals = torch.where(matched[:, None], scene_normals[nn], up)
    # Orient normals toward the camera, then flip frames whose x-axis agrees
    # with the oriented normal (the grasp must approach INTO the surface).
    to_cam = camera_location[None, :] - ref_points
    normals = _unit(normals)
    normals = torch.where((_dot3(normals, to_cam) < 0)[:, None], -normals,
                          normals)
    flip = _dot3(normals, frames[:, :, 0]) > 0
    sign = torch.tensor([-1.0, -1.0, 1.0], dtype=frames.dtype,
                        device=frames.device)
    frames = torch.where(flip[:, None, None], frames * sign, frames)
    search = torch.where(flip[:, None, None], scene_inv_search[nn],
                         scene_search[nn])
    antipodal = torch.where(flip[:, None, None], scene_inv_antipodal[nn],
                            scene_antipodal[nn])
    return MatchResult(frames, normals, search, antipodal, matched, nn)


def magic_formula(search, antipodal, matched, z):
    """Candidate filter (reference :172-185): any (L, T) cell with
    search > 50 and antipodal > 0.3, matched, and above the sample region."""
    cell_ok = (search > MAGIC_SEARCH_MIN) & (antipodal > MAGIC_ANTIPODAL_MIN)
    return (cell_ok.any(dim=2).any(dim=1) & matched
            & (z > _f32(SAMPLE_REGION)))


class SceneGradeResult(NamedTuple):
    search_score: torch.Tensor     # (C, L, T) copied where the pose is valid
    antipodal_score: torch.Tensor  # (C, L, T)
    objects_label: torch.Tensor    # (C, L, T) int32 (-1 where invalid)
    frames: torch.Tensor           # (C, L, T, 4, 4) local_search -> global
    valid: torch.Tensor            # (C,) any pose valid and score floors met
    close_counts: torch.Tensor     # (C, L, T) close-region populations


def _gripper_bound() -> np.ndarray:
    """(4, 8) homogeneous corners of the data-gen gripper box, with its
    short bottom (reference config.py:58-64)."""
    bound = np.ones((4, 8), np.float32)
    i = 0
    for x in (G.FINGER_LENGTH, -DATAGEN_BOTTOM_LENGTH):
        for y in (G.HALF_BOTTOM_WIDTH, -G.HALF_BOTTOM_WIDTH):
            for z in (G.HALF_HAND_THICKNESS, -G.HALF_HAND_THICKNESS):
                bound[0:3, i] = [x, y, z]
                i += 1
    return bound


def _scene_chunk(pts_c, frs_c, grid, grid_inv, bound, homo, labels,
                 back_threshold):
    cc = pts_c.shape[0]
    # Table collision: gripper bound corners of every search pose.
    pose_l2g = mat4_mul(local_to_global(pts_c, frs_c)[:, None],
                        grid_inv[None])                      # (cc, LT, 4, 4)
    (corner_z,) = transform_rows(pose_l2g[..., None, :, :],
                                 bound[:3], (2,))            # (cc, LT, 1, 8)
    table_collision = (corner_z[..., 0, :] < _f32(
        TABLE_HEIGHT + TABLE_COLLISION_OFFSET)).any(dim=-1)

    combined = mat4_mul(grid[None], _global_to_local(pts_c, frs_c)[:, None])
    x, y, z = transform_rows(combined, homo, (0, 1, 2))      # (cc, LT, N)
    fl, bl = _f32(G.FINGER_LENGTH), _f32(DATAGEN_BOTTOM_LENGTH)
    hht, hbw = _f32(G.HALF_HAND_THICKNESS), _f32(G.HALF_BOTTOM_WIDTH)
    hbs = _f32(G.HALF_BOTTOM_SPACE)
    close_plane = (x < fl) & (x > -bl)
    plane_ok = close_plane.sum(dim=-1) >= DATAGEN_NUM_POINTS_THRESHOLD
    slab = close_plane & (z < hht) & (z > -hht)
    back = slab & (x < 0.0) & (y < hbw) & (y > -hbw)
    finger = slab & (((y < hbw) & (y > hbs)) | ((y > -hbw) & (y < -hbs)))
    close_region = slab & (y < hbs) & (y > -hbs)
    back_ok = back.sum(dim=-1) <= back_threshold
    finger_ok = finger.sum(dim=-1) <= 0
    count = close_region.sum(dim=-1)
    count_ok = count >= DATAGEN_CLOSE_REGION_MIN_POINTS

    # single-object check: min label == max label inside the close region
    lab = labels[None, None, :]
    lab_min = torch.amin(torch.where(close_region, lab, 2 ** 30), dim=-1)
    lab_max = torch.amax(torch.where(close_region, lab, -2 ** 30), dim=-1)
    pose_valid = (plane_ok & ~table_collision & back_ok & finger_ok
                  & count_ok & (lab_min == lab_max))
    label = torch.where(pose_valid, lab_min, -1).to(torch.int32)
    return pose_valid, label, pose_l2g, count


def grade_against_scene(points, frames, pre_search, pre_antipodal,
                        scene_homo, scene_labels,
                        chunk: Optional[int] = None,
                        back_threshold: float = 0.0) -> SceneGradeResult:
    """Vectorized finger_hand (reference :277-396) over candidate frames.

    Args:
        points: (C, 3) candidate grasp points; frames: (C, 3, 3).
        pre_search / pre_antipodal: (C, L, T) matched per-point scores.
        scene_homo: (4, N) dense labeled scene cloud (w = 1).
        scene_labels: (N,) int32 object labels.
        chunk: candidates per chunk (default: about CHUNK_PAIRS / (L*T*N);
            the result does not depend on it).
    """
    dev = points.device
    grid_np = search_grid_transforms()
    grid = torch.from_numpy(grid_np).to(dev)
    grid_inv = torch.from_numpy(np.linalg.inv(
        grid_np.astype(np.float64)).astype(np.float32)).to(dev)
    bound = torch.from_numpy(_gripper_bound()).to(dev)
    c, n = points.shape[0], scene_homo.shape[1]
    if chunk is None:
        chunk = max(1, CHUNK_PAIRS // (NUM_L * NUM_T * max(n, 1)))
    labels = scene_labels.to(torch.int32)
    parts = [_scene_chunk(points[c0:c0 + chunk], frames[c0:c0 + chunk],
                          grid, grid_inv, bound, scene_homo, labels,
                          back_threshold)
             for c0 in range(0, c, chunk)]
    if parts:
        pose_valid, labels_out, pose_l2g, counts = (torch.cat(x)
                                                    for x in zip(*parts))
    else:
        pose_valid = torch.zeros((0, NUM_L * NUM_T), dtype=torch.bool,
                                 device=dev)
        labels_out = torch.zeros((0, NUM_L * NUM_T), dtype=torch.int32,
                                 device=dev)
        pose_l2g = torch.zeros((0, NUM_L * NUM_T, 4, 4), device=dev)
        counts = torch.zeros((0, NUM_L * NUM_T), dtype=torch.int64,
                             device=dev)
    shape = (c, NUM_L, NUM_T)
    # zero frames never produce valid poses
    frame_ok = frames.abs().mean(dim=(1, 2)) > 1e-6
    pose_valid = pose_valid.reshape(shape) & frame_ok[:, None, None]
    search = torch.where(pose_valid, pre_search, 0.0)
    antipodal = torch.where(pose_valid, pre_antipodal, 0.0)
    valid = ((torch.amax(search, dim=(1, 2)) >= VALID_SEARCH_MIN)
             & (torch.amax(antipodal, dim=(1, 2)) >= VALID_ANTIPODAL_MIN))
    close_counts = torch.where(pose_valid, counts.reshape(shape),
                               0).to(torch.float32)
    return SceneGradeResult(search, antipodal, labels_out.reshape(shape),
                            pose_l2g.reshape(*shape, 4, 4), valid,
                            close_counts)


def _scene_tensors(scene: dict, dev):
    """The scene's cloud as (4, N) homogeneous rows and its int32 labels."""
    cloud = np.asarray(scene["cloud"], np.float32)
    homo = np.concatenate([cloud.T, np.ones((1, len(cloud)), np.float32)])
    return (torch.from_numpy(homo).to(dev),
            torch.from_numpy(np.asarray(scene["label"], np.int32)).to(dev))


def _camera(camera_pose):
    camera_pose = np.asarray(camera_pose, np.float64)
    return (np.linalg.inv(camera_pose).astype(np.float32),
            camera_pose[:3, 3].astype(np.float32))


def _view_record(cam_inv, view_points, sel, graded, valid, search, normals):
    """The reference dump layout (:237-256): cloud and frames in the camera
    frame (host numpy, as the JAX package)."""
    frames_cam = np.einsum("ij,gltjk->gltik", cam_inv,
                           graded.frames[valid].cpu().numpy())
    cloud_cam = cam_inv[:3, :3] @ view_points.T + cam_inv[:3, 3:4]
    return {
        "point_cloud": cloud_cam.astype(np.float32),
        "valid_index": sel.astype(np.int64),
        "valid_frame": frames_cam.astype(np.float32),
        "search_score": search[valid].cpu().numpy(),
        "antipodal_score": graded.antipodal_score[valid].cpu().numpy(),
        "objects_label": graded.objects_label[valid].cpu().numpy(),
        "view_normals": normals,
    }


def generate_view_labels(noise_points: np.ndarray, clean_points: np.ndarray,
                         camera_pose: np.ndarray, scene: dict,
                         capacity: int = 32768, chunk: Optional[int] = None,
                         device: Optional[str] = None) -> dict:
    """Full per-view label transfer (host orchestration of the device
    stages; `device` None is CUDA).

    Mirrors generate_fast_training_data's per-view body (reference:
    generate_fast_training_data.py:14-48): returns the training-data dict in
    the reference dump layout (:237-256), with the cloud and frames mapped to
    the camera frame.
    """
    dev = resolve_device(device, "generate_view_labels")
    cam_inv, cam_loc = _camera(camera_pose)
    trace = processing_and_trace(
        torch.from_numpy(np.asarray(noise_points, np.float32)).to(dev),
        capacity=capacity)
    keep = trace.valid
    view_points = trace.points[keep]
    ref_points = torch.from_numpy(np.asarray(clean_points, np.float32)).to(
        dev)[trace.index_in_ref[keep].long()]

    def scene_t(key):
        return torch.from_numpy(np.asarray(scene[key], np.float32)).to(dev)

    match = match_to_scene(
        ref_points, torch.from_numpy(cam_loc).to(dev), scene_t("cloud"),
        scene_t("normal"), scene_t("frame"), scene_t("inv_frame"),
        scene_t("search_score"), scene_t("inv_search_score"),
        scene_t("antipodal_score"), scene_t("inv_antipodal_score"))
    candidate = magic_formula(match.search_score, match.antipodal_score,
                              match.matched, view_points[:, 2])
    cand_idx = torch.nonzero(candidate)[:, 0]

    scene_homo, labels = _scene_tensors(scene, dev)
    graded = grade_against_scene(
        view_points[cand_idx], match.frames[cand_idx],
        match.search_score[cand_idx], match.antipodal_score[cand_idx],
        scene_homo, labels, chunk=chunk)
    valid = graded.valid
    sel = cand_idx[valid].cpu().numpy()
    return _view_record(cam_inv, view_points.cpu().numpy(), sel, graded,
                        valid, graded.search_score,
                        match.normals.cpu().numpy())


def generate_view_labels_online(noise_points: np.ndarray,
                                camera_pose: np.ndarray, scene: dict,
                                capacity: int = 32768,
                                chunk: Optional[int] = None,
                                device: Optional[str] = None) -> dict:
    """Online variant: Darboux frames estimated on the VIEW cloud itself
    instead of matched from precomputed scene frames (reference:
    pcd_classes/torch_single_view_point_cloud.py:14-358).  Per-pose scores
    come from the scene grading's close-region populations, and the antipodal
    term is evaluated against the labeled scene via eval_frames.
    """
    dev = resolve_device(device, "generate_view_labels_online")
    cam_inv, cam_loc = _camera(camera_pose)
    trace = processing_and_trace(
        torch.from_numpy(np.asarray(noise_points, np.float32)).to(dev),
        capacity=capacity)
    view_points = trace.points[trace.valid]
    normals = estimate_normals(view_points, torch.from_numpy(cam_loc).to(dev))
    frames, _ = darboux_frames(view_points, normals)
    # approach INTO the surface: flip frames agreeing with the camera-facing
    # normal (same rule as the precomputed path)
    flip = _dot3(normals, frames[:, :, 0]) > 0
    sign = torch.tensor([-1.0, -1.0, 1.0], device=dev)
    frames = torch.where(flip[:, None, None], frames * sign, frames)

    candidate = ((frames.abs().mean(dim=(1, 2)) > 1e-6)
                 & (view_points[:, 2] > _f32(SAMPLE_REGION)))
    cand_idx = torch.nonzero(candidate)[:, 0]
    view_np = view_points.cpu().numpy()
    if len(cand_idx) == 0:
        return {"point_cloud": (cam_inv[:3, :3] @ view_np.T
                                + cam_inv[:3, 3:4]).astype(np.float32),
                "valid_index": np.zeros(0, np.int64),
                "valid_frame": np.zeros((0, NUM_L, NUM_T, 4, 4), np.float32),
                "search_score": np.zeros((0, NUM_L, NUM_T), np.float32),
                "antipodal_score": np.zeros((0, NUM_L, NUM_T), np.float32),
                "objects_label": np.zeros((0, NUM_L, NUM_T), np.int32),
                "view_normals": normals.cpu().numpy()}

    # antipodal per candidate against the labeled scene
    poses = local_to_global(view_points[cand_idx], frames[cand_idx])
    scene_cloud = torch.from_numpy(np.asarray(scene["cloud"],
                                              np.float32)).to(dev)
    scene_normals = torch.from_numpy(np.asarray(scene["normal"],
                                                np.float32)).to(dev)
    scene_homo, labels = _scene_tensors(scene, dev)
    ev = eval_frames(se3_inv(poses), scene_cloud,
                     scene_normals, labels)
    pre = ev.antipodal_score[:, None, None].expand(-1, NUM_L, NUM_T)
    # pre_search is a placeholder; the true search score for the online
    # variant is the scene close-region count returned by the grading.
    graded = grade_against_scene(
        view_points[cand_idx], frames[cand_idx], pre + VALID_SEARCH_MIN,
        pre, scene_homo, labels, chunk=chunk)
    valid = graded.valid
    sel = cand_idx[valid].cpu().numpy()
    return _view_record(cam_inv, view_np, sel, graded, valid,
                        graded.close_counts, normals.cpu().numpy())

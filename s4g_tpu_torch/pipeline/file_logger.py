"""Prediction artifact dumping + top-K grasp extraction (port of
s4g_tpu/pipeline/file_logger.py).

Re-design of the reference's loggin_to_file (reference:
utils/file_logger_cls.py:12-246): writes per-step artifacts (scene points,
score softmax, predicted frames, jet-colored score cloud) and, for unlabeled
runs, selects the top-K scoring points, Gram-Schmidt-orthogonalizes their
frames, collision-filters them against the view cloud in one batched call
and saves top_frames.npy.  The same files in the same `np.savetxt` formats
as the JAX package: the softmaxes, the expected score and the top-K frames'
math run in torch on the predictions' device, the text artifacts come from
numpy.

Score expectation uses the file-logger bin convention linspace(0,1,C+1)[:-1]
(file_logger_cls.py:67), which differs from the detector's [1:]
(grasp_detector.py:145): `expected_score(upper_bins=False)`.

The top K are `np.argsort(-scores)[:K]`, which is not a stable sort: where
two scores tie within an ulp, the JAX package and the port may order (and,
at the K-th place, select) them differently.
"""

from __future__ import annotations

import os
import os.path as osp
import time

import numpy as np
import torch

from ..utils.grasp_visualizer import GraspVisualizer
from ..utils.io_ply import write_ply_points
from ..utils.math_utils import (batch_transformation_inv, gram_schmidt_frames,
                                poses_from_rt)
from .collision import batch_view_non_collision
from .postprocessing import T_BIN_VALUES, _softmax0, expected_score


def _jet(values: np.ndarray) -> np.ndarray:
    """Jet colormap without matplotlib: values in [0, 1] -> (N, 3)."""
    v = np.clip(values, 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4 * v - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * v - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * v - 1), 0, 1)
    return np.stack([r, g, b], axis=1)


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.asarray(x))


def log_to_file(data_batch: dict, preds: dict, step: int, output_dir: str,
                prefix: str = "", with_label: bool = True, top_k: int = 50):
    """Dump artifacts for one scene; returns (top_H, scores) when unlabeled.

    Args:
        data_batch: {"scene_points": (1, 3, N), optional labels}, tensors
            or numpy arrays.
        preds: model predictions (reference channels-first layout), tensors
            (on any device) or numpy arrays; the torch math runs on the
            device of preds["score"].
    Appends the top-K extraction's wall ms to `postprocess_time_ours.txt`
    in the working directory, as the JAX package does.
    """
    step_dir = osp.join(output_dir, "{}_step{:05d}".format(prefix, step))
    os.makedirs(step_dir, exist_ok=True)

    if "grasp_logits" in preds:
        np.savetxt(osp.join(step_dir, "grasp_logits.txt"),
                   _numpy(preds["grasp_logits"]), fmt="%.4f")
        return None

    if "score" not in preds:
        return None

    scene_points = _numpy(data_batch["scene_points"][0]).T    # (N, 3)
    np.savetxt(osp.join(step_dir, "scene_points.xyz"), scene_points,
               fmt="%.4f")
    if with_label and "scene_score" in data_batch:
        np.savetxt(osp.join(step_dir, "gt_scene_score.txt"),
                   _numpy(data_batch["scene_score"][0]), fmt="%.4f")
    if with_label and "scene_score_labels" in data_batch:
        np.savetxt(osp.join(step_dir, "gt_scene_score_labels.txt"),
                   _numpy(data_batch["scene_score_labels"][0]), fmt="%d")

    score_logits = _tensor(preds["score"][0]).float()          # (C, N)
    dev = score_logits.device
    score_prob = _numpy(_softmax0(score_logits))
    np.savetxt(osp.join(step_dir, "scene_score_logits.txt"), score_prob.T,
               fmt="%.4f")

    pred_frame_r = _numpy(preds["frame_R"][0]).T              # (N, 9)
    np.savetxt(osp.join(step_dir, "pred_frame_R.txt"), pred_frame_r,
               fmt="%.4f")
    rot = pred_frame_r.reshape(-1, 3, 3)

    t_prob = _numpy(_softmax0(_tensor(preds["frame_t"][0]).float().to(dev))
                    ).T                                       # (N, 4)
    depth = (t_prob * T_BIN_VALUES[None, :]).sum(1, keepdims=True)
    pred_frame_t = -depth * rot[:, :, 0] + scene_points
    np.savetxt(osp.join(step_dir, "pred_frame_t.txt"), pred_frame_t,
               fmt="%.4f")

    # file-logger score convention: lower bin edges (file_logger_cls.py:67)
    scene_pred = _numpy(expected_score(score_logits, upper_bins=False))
    np.savetxt(osp.join(step_dir, "pred_scene_score.txt"), scene_pred,
               fmt="%.4f")
    write_ply_points(osp.join(step_dir, "pred_pts.ply"), scene_points,
                     colors=_jet(scene_pred))

    if with_label:
        return None

    # ---- top-K extraction for real experiments (file_logger_cls.py:190-244)
    tic = time.time()
    top_ind = np.argsort(-scene_pred)[:top_k]
    rot_top = gram_schmidt_frames(torch.from_numpy(rot[top_ind]).to(dev))
    top_poses = poses_from_rt(
        rot_top, torch.from_numpy(pred_frame_t[top_ind]).to(dev))
    g2l = batch_transformation_inv(top_poses)
    non_collision = _numpy(batch_view_non_collision(
        g2l, torch.from_numpy(scene_points).to(dev)))
    with open("postprocess_time_ours.txt", "a+") as f:
        f.write("{:.4f}\n".format((time.time() - tic) * 1000.0))

    top_h = _numpy(top_poses)[non_collision]
    scores = scene_pred[top_ind][non_collision]
    if len(top_h):
        np.save(osp.join(output_dir, "top_frames.npy"), top_h)
        print(f"#### {len(top_h)} viable frames found. ####")
        viz = GraspVisualizer(scene_points)
        viz.add_multiple_poses(top_h[:10])
        viz.save(osp.join(step_dir, "cloud.ply"),
                 osp.join(step_dir, "top_hands.ply"))
    else:
        print(f"### No viable frames in top {top_k}. ###")
    return top_h, scores

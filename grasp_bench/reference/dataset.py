"""The S4G training batches, as the published training set is read: scene
pickles visited in a random permutation per epoch, each scene's cloud
sampled to the model's number of points (its labelled frame points first,
then points drawn without replacement from the rest), per-point quality
min(log(search + 1) / 3, 1) * antipodal binned into the score classes,
the frames' rotations and depth-bin classes for the first
num_frame_points points, movability from the pushed distances over 0.1 m,
clipped to [0, 1].  All draws come from one `RandomState(seed)` in that
order (the permutation, then each scene's fill)."""

from __future__ import annotations

import glob
import os
import pickle

import numpy as np

T_BINS = np.array([0.08, 0.06, 0.04, 0.02], dtype=np.float32)


def collate(data: dict, num_points: int, classes: int, directions: int,
            frame_points: int, rng) -> dict:
    cloud = np.asarray(data["point_cloud"], np.float32)
    valid = np.asarray(data["valid_index"], np.int64)
    frames = np.asarray(data["valid_frame"], np.float32)
    search = np.asarray(data["search_score"], np.float32)
    antipodal = np.asarray(data["antipodal_score"], np.float32)
    labels = np.asarray(data["objects_label"], np.int64)
    quality = np.clip(np.minimum(np.log(search + 1.0) / 3.0, 1.0)
                      * antipodal, 0.0, 1.0)
    keep = min(len(valid), num_points)
    rest = np.setdiff1d(np.arange(cloud.shape[1]), valid[:keep])
    need = num_points - keep
    fill = rng.choice(rest, need, replace=len(rest) < need)
    index = np.concatenate([valid[:keep], fill])
    score = np.zeros(num_points, np.float32)
    score[:keep] = quality[:keep]
    grasp = cloud[:, index[:keep]].T
    x_axis = frames[:keep, :3, 0]
    depth = np.sum(x_axis * (grasp - frames[:keep, :3, 3]), axis=1)
    t_cls = np.argmin(np.abs(depth[:, None] - T_BINS[None, :]),
                      axis=1).astype(np.int32)
    movable = np.zeros((directions, num_points), np.float32)
    if "direction" in data:
        table = np.clip(np.asarray(data["direction"], np.float32) / 0.1,
                        0.0, 1.0)
        movable[:, :keep] = table[np.clip(labels[:keep], 0,
                                          table.shape[0] - 1)].T
    take = min(keep, frame_points)
    rot = np.zeros((9, frame_points), np.float32)
    rot[:, :take] = frames[:take, :3, :3].reshape(take, 9).T
    t = np.zeros(frame_points, np.int32)
    t[:take] = t_cls[:take]
    if keep < frame_points:
        score[keep:frame_points] = 0.0
    return {"scene_points": cloud[:, index], "scene_score": score,
            "scene_score_labels": np.minimum(
                (score * classes).astype(np.int32), classes - 1),
            "scene_movable_labels": movable, "best_frame_R": rot,
            "best_frame_t": t}


def batches(root: str, seed: int, batch_size: int, count: int, **kw):
    """The first `count` batches of the first epoch, as numpy dicts."""
    files = sorted(glob.glob(os.path.join(root, "*.p")))
    rng = np.random.RandomState(seed)
    order = rng.permutation(len(files))
    out, batch = [], []
    for i in order:
        with open(files[i], "rb") as f:
            batch.append(collate(pickle.load(f), rng=rng, **kw))
        if len(batch) == batch_size:
            out.append({k: np.stack([s[k] for s in batch])
                        for k in batch[0]})
            batch = []
            if len(out) == count:
                break
    return out

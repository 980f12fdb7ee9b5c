"""Training dataset over the data-gen scene pickles (a numpy copy of
s4g_tpu/train/dataset.py: the port reads no module of the JAX package).
Both packages draw from `np.random.RandomState(seed)`, so they produce the
same batches from the same files.

* Dump format: point_cloud (3, N) camera frame, valid_index (G,),
  valid_frame (G, 4, 4), search_score (G,), antipodal_score (G,),
  objects_label (G,), optional direction (num_objects+1, 5).

* The per-point scalar quality is min(log(search+1)/3, 1) * antipodal.

* The losses slice the FIRST num_frame_points of the point axis for the
  R/t targets, so labeled frame points are ordered first in the sampled
  cloud.

* PN2_CLS's translation target is the depth-bin class: the grasp origin
  sits at depth d = x_axis . (point - t) with d in {0.08, 0.06, 0.04,
  0.02}, the post-processing bins.

* Movability labels clip the pushed distance into [0, 1] per the 5
  directions.  Unknown (-1) entries and unlabeled points get 0.

`batch_to_tensors` turns a numpy batch into the tensors the model and the
losses take (pinned host memory when asked), `batch_to_device` moves them.
"""

from __future__ import annotations

import glob
import os
import pickle
from typing import Iterator, Optional

import numpy as np
import torch

T_BINS = np.array([0.08, 0.06, 0.04, 0.02], dtype=np.float32)
MOVABLE_DISTANCE_SCALE = 0.1  # distance that counts as fully movable


def scene_quality_score(search_score: np.ndarray,
                        antipodal_score: np.ndarray) -> np.ndarray:
    """min(log(search+1)/3, 1) * antipodal (post_process_single_grasp.py:64)."""
    return np.minimum(np.log(search_score + 1.0) / 3.0, 1.0) * antipodal_score


def discretize_score(score: np.ndarray, score_classes: int) -> np.ndarray:
    """Uniform binning of [0, 1] quality into score classes."""
    return np.minimum((score * score_classes).astype(np.int32),
                      score_classes - 1)


def t_bin_class(points: np.ndarray, frames: np.ndarray) -> np.ndarray:
    """Recover the depth-bin class of each grasp frame.

    Args:
        points: (G, 3) grasp points; frames: (G, 4, 4) grasp poses.
    Returns:
        (G,) int32 class over T_BINS (0 -> 0.08m ... 3 -> 0.02m).
    """
    x_axis = frames[:, :3, 0]
    depth = np.sum(x_axis * (points - frames[:, :3, 3]), axis=1)
    return np.argmin(np.abs(depth[:, None] - T_BINS[None, :]),
                     axis=1).astype(np.int32)


def collate_scene(data: dict, num_points: int, score_classes: int,
                  num_removal_directions: int = 5,
                  rng: Optional[np.random.RandomState] = None,
                  t_classification: bool = True) -> dict:
    """One scene pickle -> model/loss-ready numpy batch (unbatched)."""
    rng = rng or np.random.RandomState()
    cloud = np.asarray(data["point_cloud"], np.float32)        # (3, N)
    n_raw = cloud.shape[1]
    valid_index = np.asarray(data["valid_index"], np.int64)
    frames = np.asarray(data["valid_frame"], np.float32)
    if frames.ndim == 5:
        # Un-reduced dump (G, L, T, 4, 4): take the best (length, theta) cell
        # per point by quality score.
        ss = np.asarray(data["search_score"], np.float32)
        ant = np.asarray(data["antipodal_score"], np.float32)
        q = scene_quality_score(ss, ant).reshape(ss.shape[0], -1)
        best = np.argmax(q, axis=1)
        frames = frames.reshape(frames.shape[0], -1, 4, 4)[
            np.arange(frames.shape[0]), best]
        search = ss.reshape(ss.shape[0], -1)[np.arange(ss.shape[0]), best]
        antipodal = ant.reshape(ant.shape[0], -1)[np.arange(ant.shape[0]), best]
        obj_label = np.asarray(data["objects_label"]).reshape(
            ss.shape[0], -1)[np.arange(ss.shape[0]), best]
    else:
        search = np.asarray(data["search_score"], np.float32)
        antipodal = np.asarray(data["antipodal_score"], np.float32)
        obj_label = np.asarray(data.get(
            "objects_label", np.zeros(len(valid_index))), np.int64)

    quality = np.clip(scene_quality_score(search, antipodal), 0.0, 1.0)
    num_frames = len(valid_index)

    # Frame points first, then random fill from the rest
    # (loss slicing contract, PointNet2.py:183-184).
    keep_frames = min(num_frames, num_points)
    order = np.arange(num_frames)[:keep_frames]
    rest_pool = np.setdiff1d(np.arange(n_raw), valid_index[order])
    need = num_points - keep_frames
    if len(rest_pool) >= need:
        fill = rng.choice(rest_pool, need, replace=False)
    else:
        fill = rng.choice(rest_pool, need, replace=True)
    point_index = np.concatenate([valid_index[order], fill])

    scene_points = cloud[:, point_index]                       # (3, P)
    scene_score = np.zeros(num_points, np.float32)
    scene_score[:keep_frames] = quality[order]
    scene_score_labels = discretize_score(scene_score, score_classes)

    rot9 = frames[order, :3, :3].reshape(keep_frames, 9)        # row-major
    best_frame_r = rot9.T.astype(np.float32)                    # (9, Gf)

    grasp_points = cloud[:, point_index[:keep_frames]].T
    if t_classification:
        best_frame_t = t_bin_class(grasp_points, frames[order])
    else:
        best_frame_t = frames[order, :3, 3].T.astype(np.float32)  # (3, Gf)

    movable = np.zeros((num_removal_directions, num_points), np.float32)
    if "direction" in data:
        direction = np.asarray(data["direction"], np.float32)  # (O+1, 5)
        direction = np.clip(direction / MOVABLE_DISTANCE_SCALE, 0.0, 1.0)
        labels = obj_label[order].astype(np.int64)
        labels = np.clip(labels, 0, direction.shape[0] - 1)
        movable[:, :keep_frames] = direction[labels].T

    return {
        "scene_points": scene_points,
        "scene_score": scene_score,
        "scene_score_labels": scene_score_labels,
        "scene_movable_labels": movable,
        "best_frame_R": best_frame_r,
        "best_frame_t": best_frame_t,
        "num_frame_points": keep_frames,
    }


class SceneGraspDataset:
    """Iterates merged training pickles ({scene}_view_{v}.p) as collated
    batches with a fixed frame-point budget so batch shapes stay static."""

    def __init__(self, root_dir: str, num_points: int = 25600,
                 score_classes: int = 3, batch_size: int = 1,
                 num_frame_points: int = 512, t_classification: bool = True,
                 seed: int = 0, num_removal_directions: int = 5,
                 cache: bool = False):
        self.files = sorted(glob.glob(os.path.join(root_dir, "*.p")))
        if not self.files:
            raise FileNotFoundError(f"no training pickles under {root_dir}")
        self.num_points = num_points
        self.score_classes = score_classes
        self.batch_size = batch_size
        self.num_frame_points = num_frame_points
        self.t_classification = t_classification
        self.num_removal_directions = num_removal_directions
        self.rng = np.random.RandomState(seed)
        # cache=True keeps each view's collated sample in memory after its
        # first load: collation is host numpy (the random fill's
        # setdiff/choice over the raw cloud dominates) paid per view and
        # epoch.  Freezing the per-epoch random fill is the trade: the fill
        # only picks WHICH unlabeled background points pad the cloud
        # (labels unaffected), and epoch-level stochasticity still comes
        # from batch shuffling + augmentation.
        self._cache: Optional[dict] = {} if cache else None

    def __len__(self):
        return len(self.files) // self.batch_size

    def _load_one(self, path: str) -> dict:
        if self._cache is not None and path in self._cache:
            return self._cache[path]
        with open(path, "rb") as f:
            data = pickle.load(f)
        sample = collate_scene(data, self.num_points, self.score_classes,
                               self.num_removal_directions, self.rng,
                               self.t_classification)
        # Pad/trim the frame-point axis to the fixed budget.
        gf = self.num_frame_points
        got = sample.pop("num_frame_points")
        take = min(got, gf)

        def fix(x, pad_value=0):
            out_shape = list(x.shape)
            out_shape[-1] = gf
            out = np.full(out_shape, pad_value, x.dtype)
            out[..., :take] = x[..., :take]
            return out

        sample["best_frame_R"] = fix(sample["best_frame_R"])
        sample["best_frame_t"] = fix(sample["best_frame_t"])
        # Zero scene_score beyond the real frames kills their R/t loss terms.
        if got < gf:
            sample["scene_score"][got:gf] = 0.0
        if self._cache is not None:
            self._cache[path] = sample
        return sample

    def __iter__(self) -> Iterator[dict]:
        order = self.rng.permutation(len(self.files))
        batch = []
        for i in order:
            batch.append(self._load_one(self.files[i]))
            if len(batch) == self.batch_size:
                yield {k: np.stack([s[k] for s in batch])
                       for k in batch[0]}
                batch = []


# Tensor dtypes of a batch's entries; integer labels become int64 (torch's
# class indices), everything else f32.
def _tensor(x: np.ndarray) -> torch.Tensor:
    x = np.asarray(x)
    dtype = np.int64 if np.issubdtype(x.dtype, np.integer) else np.float32
    return torch.from_numpy(np.ascontiguousarray(x, dtype=dtype))


def batch_to_tensors(batch: dict, pin_memory: bool = False) -> dict:
    """A numpy batch -> CPU tensors in the dtypes the model and the losses
    take (scene_score_labels and a PN2_CLS best_frame_t int64, the rest
    f32), in pinned memory when `pin_memory`, so that `batch_to_device`
    copies without blocking."""
    out = {k: _tensor(v) for k, v in batch.items()}
    return {k: v.pin_memory() for k, v in out.items()} if pin_memory \
        else out


def as_tensor(x) -> torch.Tensor:
    """A batch leaf as a tensor: a tensor as it is, a numpy array in the
    dtype `batch_to_tensors` gives it."""
    return x if isinstance(x, torch.Tensor) else _tensor(x)


def batch_to_device(batch: dict, device) -> dict:
    """A numpy or tensor batch -> tensors on `device` (non-blocking copies
    from pinned memory)."""
    return {k: as_tensor(v).to(device, non_blocking=True)
            for k, v in batch.items()}

"""Merge grasp training data with per-object movability labels.

Re-design of merge_data_and_direction (reference:
merge_data_and_direction.py:8-65): the movability table (num_objects+1, 5)
defaults to -1 (unknown) with the table row = 0, and the probe directions
are permuted per camera view because +-x/+-y are camera-relative
(DIRECTION_CHANGE_LIST, :10).

A numpy copy of s4g_tpu/datagen/merge.py: the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List

import numpy as np

NUM_OF_VIEW = 4
# per-view permutation of the 5 probe directions (merge_data_and_direction.py:10)
DIRECTION_CHANGE_LIST = np.array([
    [1, 0, 3, 2, 4],
    [0, 1, 2, 3, 4],
    [3, 2, 0, 1, 4],
    [2, 3, 1, 0, 4],
])


def build_direction_table(direction_data: dict,
                          name_to_index: Dict[str, int],
                          num_labels: int) -> np.ndarray:
    """(num_labels + 1, 5): per-label movability distances; -1 = unknown,
    last row (table) = 0."""
    table = np.full((num_labels + 1, 5), -1.0)
    table[-1] = 0.0
    move = np.asarray(direction_data["move_distance"])
    for obj_i, obj in enumerate(direction_data["obj_list"]):
        if obj in name_to_index:
            table[name_to_index[obj]] = move[obj_i]
    return table


def merge_scene(training_data: dict, direction_table: np.ndarray,
                view: int) -> dict:
    """Attach the view-permuted movability table under the 'direction' key."""
    permuted = direction_table[:, DIRECTION_CHANGE_LIST[view % NUM_OF_VIEW]]
    out = dict(training_data)
    out["direction"] = permuted
    return out


def merge_directory(data_dir: str, direction_dir: str, merge_dir: str,
                    name_to_index: Dict[str, int], num_labels: int,
                    num_views: int = NUM_OF_VIEW) -> List[str]:
    """Directory driver with the reference's resumable completeness check
    (merge_data_and_direction.py:13-37): a scene merges only when all views'
    training pickles exist."""
    os.makedirs(merge_dir, exist_ok=True)
    data_list = set(os.listdir(data_dir))
    merged = []
    for fname in sorted(os.listdir(direction_dir)):
        if fname.startswith("."):
            continue
        scene = os.path.splitext(fname)[0]
        views = [f"{scene}_view_{v}.p" for v in range(num_views)]
        if not all(v in data_list for v in views):
            continue
        with open(os.path.join(direction_dir, fname), "rb") as f:
            direction_data = pickle.load(f)
        table = build_direction_table(direction_data, name_to_index,
                                      num_labels)
        for v, view_file in enumerate(views):
            with open(os.path.join(data_dir, view_file), "rb") as f:
                data = pickle.load(f)
            out = merge_scene(data, table, v)
            out_path = os.path.join(merge_dir, view_file)
            with open(out_path, "wb") as f:
                pickle.dump(out, f)
            merged.append(out_path)
    return merged

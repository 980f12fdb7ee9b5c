"""Dataset path registry (a copy of s4g_tpu/configs/path_registry.py;
reference: data_gen/configs/path.py).

The reference hard-codes a hostname switch between a cluster cephfs root
and a repo-relative default, plus helpers mapping scene names to the
fixed on-disk layout.  This registry keeps the same call surface on this
repo's layout, with the root resolved in priority order:

1. explicit `root=` argument (what every tool in this repo passes —
   the round-2 re-design of the hostname switch);
2. `S4G_DATA_ROOT` environment variable;
3. `S4G_HOST_ROOTS` environment variable: comma-separated
   `hostprefix=/path` pairs matched against this machine's hostname (the
   reference's grasp*/py* cluster switch, without baking cluster names
   into source, reference path.py:8-12);
4. `./s4g_data` under the current directory.

Layout produced by `s4g_tpu_torch.datagen.generate.generate_end_to_end` and
consumed by `s4g_tpu_torch.train.dataset.SceneGraspDataset`:

    <root>/single_object_data/<object>.p     per-object Darboux grading
    <root>/merged_data/<scene>_view_<v>.p    merged training labels
    <root>/<scene>.npy                       composed scene cloud
    <root>/val/merged_data/...               held-out split (same layout)
"""

from __future__ import annotations

import os
import socket
from typing import List, Optional, Tuple

_RESOURCE_KINDS = ("single_object_data", "merged_data", "baseline_data",
                   "eval_data", "scenes")


def data_root(root: Optional[str] = None) -> str:
    """Resolve the dataset root (see module docstring for priority)."""
    if root:
        return root
    env = os.environ.get("S4G_DATA_ROOT")
    if env:
        return env
    host_roots = os.environ.get("S4G_HOST_ROOTS", "")
    if host_roots:
        hostname = socket.gethostname()
        for pair in host_roots.split(","):
            prefix, _, path = pair.partition("=")
            if prefix and path and hostname.startswith(prefix.strip()):
                return path.strip()
    return os.path.abspath("s4g_data")


def resource_dir(kind: str, root: Optional[str] = None,
                 create: bool = True) -> str:
    """Directory for one resource kind (reference get_resource_dir_path,
    path.py:7-16); created on demand like the reference's mkdir."""
    path = os.path.join(data_root(root), kind)
    if create:
        os.makedirs(path, exist_ok=True)
    return path


def scene_npy_path(scene_name, root: Optional[str] = None) -> str:
    """Composed-scene cloud (reference get_npy_and_training_data_path)."""
    return os.path.join(data_root(root), f"{scene_name}.npy")


def scene_view_paths(scene_name, num_views: int,
                     root: Optional[str] = None) -> List[str]:
    """Merged per-view label pickles for one scene (reference
    get_data_scene_and_view_path / get_npy_and_training_data_path —
    one helper: this repo's merge writes a single artifact per view)."""
    merged = resource_dir("merged_data", root, create=False)
    return [os.path.join(merged, f"{scene_name}_view_{v}.p")
            for v in range(num_views)]


def object_grade_path(object_name: str, root: Optional[str] = None) -> str:
    """Per-object Darboux grading pickle."""
    return os.path.join(resource_dir("single_object_data", root,
                                     create=False), f"{object_name}.p")


def npy_and_training_data_path(scene_name, num_views: int,
                               root: Optional[str] = None
                               ) -> Tuple[str, List[str]]:
    """Reference get_npy_and_training_data_path (path.py:53-57)."""
    return (scene_npy_path(scene_name, root),
            scene_view_paths(scene_name, num_views, root))

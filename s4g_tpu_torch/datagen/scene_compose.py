"""Scene composition: per-object precomputed grasp data -> scene-level data.

Re-design of GenerateDarbouxScene (reference:
data_generator/data_scene_generator.py:18-123): transform each object's
cloud / normals / frames by its simulated pose and concatenate, carrying the
per-point grading tensors through.  Pure numpy (host-side, IO-bound).

A numpy copy of s4g_tpu/datagen/scene_compose.py: the port imports nothing of
the JAX package.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np


def quat_to_mat(quat: np.ndarray) -> np.ndarray:
    """(w, x, y, z) quaternion -> 3x3 rotation (transforms3d convention used
    by the reference, data_scene_generator.py:60)."""
    w, x, y, z = quat
    n = w * w + x * x + y * y + z * z
    if n < 1e-12:
        return np.eye(3)
    s = 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array([
        [1 - yy - zz, xy - wz, xz + wy],
        [xy + wz, 1 - xx - zz, yz - wx],
        [xz - wy, yz + wx, 1 - xx - yy]])


def compose_scene(pose_dict: Mapping[str, np.ndarray],
                  object_data: Mapping[str, dict],
                  name_to_index: Mapping[str, int] | None = None,
                  name_to_color: Mapping[str, np.ndarray] | None = None
                  ) -> Dict[str, np.ndarray]:
    """Compose one scene.

    Args:
        pose_dict: {name: (7,) [xyz, quat_wxyz]} from the drop simulation.
        object_data: {name: per-object dict with keys cloud/normal/frame/
            inv_frame/search_score/inv_search_score/antipodal_score/
            inv_antipodal_score} (datagen.grading outputs).

    Returns:
        Scene dict with the reference's keys
        (data_scene_generator.py:105-107).
    """
    out = {k: [] for k in
           ("cloud", "frame", "inv_frame", "label", "color", "normal",
            "search_score", "inv_search_score", "antipodal_score",
            "inv_antipodal_score")}
    for i, (name, pose) in enumerate(pose_dict.items()):
        data = object_data[name]
        rot = quat_to_mat(np.asarray(pose[3:7]))
        t = np.asarray(pose[0:3])
        cloud = np.asarray(data["cloud"])
        out["cloud"].append(cloud @ rot.T + t)
        out["normal"].append(np.asarray(data["normal"]) @ rot.T)
        out["frame"].append(rot[None] @ np.asarray(data["frame"]))
        out["inv_frame"].append(rot[None] @ np.asarray(data["inv_frame"]))
        label = (name_to_index[name] if name_to_index is not None else i)
        out["label"].append(np.full(cloud.shape[0], label, np.int32))
        color = (np.asarray(name_to_color[name])
                 if name_to_color is not None
                 else np.array([(i * 37 % 255) / 255.0,
                                (i * 91 % 255) / 255.0,
                                (i * 151 % 255) / 255.0]))
        out["color"].append(np.tile(color, (cloud.shape[0], 1)))
        for key in ("search_score", "inv_search_score", "antipodal_score",
                    "inv_antipodal_score"):
            out[key].append(np.asarray(data[key]))
    return {k: np.concatenate(v, axis=0) for k, v in out.items()}

"""Movability ("valid direction") labels via kinematic pushes in MuJoCo.

Re-design of DirectionGenerator (reference:
mujoco/grasp_direction_generator.py:21-153): for every object x 5 probe
directions, drive the object at 1 m/s (gravity compensated through
xfrc_applied) and record the distance travelled before any OTHER object
exceeds a velocity tolerance or the object itself rotates past a quaternion
threshold.  Collisions with the table are excluded for the pushed object so
it can slide along the surface.

A numpy copy of s4g_tpu/datagen/movability.py: the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Dict, List, Optional

import numpy as np

from .dataset_config import DIR_LIST

DISPLACEMENT = 0.2
VELOCITY = 1.0
OTHER_VEL_TOLERANCE = 2e-1
QUAT_THRESHOLD = 0.9
GRAVITY = np.array([0.0, 0.0, 9.8])


class DirectionGenerator:
    def __init__(self, xml: str, pose_dict: Dict[str, np.ndarray],
                 timestep: float = 0.002):
        import mujoco
        self._mujoco = mujoco
        self.model = mujoco.MjModel.from_xml_string(xml)
        self.model.opt.timestep = timestep
        self.data = mujoco.MjData(self.model)
        self.timestep = timestep

        self.obj: List[str] = sorted(pose_dict.keys())
        self.pose_dict = pose_dict
        self.qpos_id, self.qvel_id, self.body_id = [], [], []
        for name in self.obj:
            jid = mujoco.mj_name2id(self.model, mujoco.mjtObj.mjOBJ_JOINT,
                                    f"{name}_joint")
            self.qpos_id.append(int(self.model.jnt_qposadr[jid]))
            self.qvel_id.append(int(self.model.jnt_dofadr[jid]))
            self.body_id.append(mujoco.mj_name2id(
                self.model, mujoco.mjtObj.mjOBJ_BODY, name))
        self.dirs = np.asarray(DIR_LIST, np.float64)
        self.dirs /= np.linalg.norm(self.dirs, axis=1, keepdims=True)

    def _reset_to_poses(self):
        self.data.qvel[:] = 0.0
        self.data.xfrc_applied[:] = 0.0
        for i, name in enumerate(self.obj):
            pose = self.pose_dict[name]
            q = self.qpos_id[i]
            self.data.qpos[q:q + 3] = pose[0:3]
            self.data.qpos[q + 3:q + 7] = pose[3:7]
        self._mujoco.mj_forward(self.model, self.data)

    def get_all_valid_direction(self) -> np.ndarray:
        """(num_objects, 5) pushed distance per direction, in meters."""
        mujoco = self._mujoco
        max_step = int(DISPLACEMENT / VELOCITY / self.timestep)
        move_steps = np.full((len(self.obj), len(self.dirs)), max_step,
                             np.float64)
        body_mass = self.model.body_subtreemass

        for i in range(len(self.obj)):
            vel_id = self.qvel_id[i]
            qpos_id = self.qpos_id[i]
            body = self.body_id[i]
            others = np.concatenate([
                [self.qvel_id[j] + k for k in range(3)]
                for j in range(len(self.obj)) if j != i]) \
                if len(self.obj) > 1 else np.array([], np.int64)
            balance = np.concatenate(
                [GRAVITY * body_mass[body], np.zeros(3)])

            for dir_i, direction in enumerate(self.dirs):
                self._reset_to_poses()
                init_quat = np.copy(self.data.qpos[qpos_id + 3:qpos_id + 7])
                self.data.xfrc_applied[body, :] = balance
                qv = np.concatenate([direction * VELOCITY, np.zeros(3)])
                for step in range(max_step):
                    self.data.qvel[vel_id:vel_id + 6] = qv
                    mujoco.mj_step(self.model, self.data)
                    moved_others = (np.max(np.abs(self.data.qvel[others]))
                                    if len(others) else 0.0)
                    tilted = np.inner(
                        self.data.qpos[qpos_id + 3:qpos_id + 7],
                        init_quat) < QUAT_THRESHOLD
                    if moved_others > OTHER_VEL_TOLERANCE or tilted:
                        move_steps[i, dir_i] = step
                        break
                self.data.xfrc_applied[body, :] = 0.0
        return move_steps / max_step * DISPLACEMENT

    def run(self, save_path: Optional[str] = None) -> dict:
        tic = time.time()
        move_distance = self.get_all_valid_direction()
        centers = np.stack([self.data.subtree_com[b] for b in self.body_id])
        result = {"move_distance": move_distance, "obj_list": self.obj,
                  "mesh_center": centers}
        if save_path:
            os.makedirs(os.path.dirname(save_path), exist_ok=True)
            with open(save_path, "wb") as f:
                pickle.dump(result, f)
            print(f"It takes {time.time() - tic:.1f}s for {save_path}")
        return result

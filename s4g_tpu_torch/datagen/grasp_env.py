"""Dynamic grasp evaluation in simulation: place a two-finger gripper at an
SE(3) pose, close the fingers, lift, and report whether an object came along.

Re-design of GraspEnv (reference: mujoco/grasp_env.py:13-114, exploratory in
the reference — not part of the main label path).  Uses a free-floating
gripper body (back hand + two prismatic fingers driven by position
actuators) matching the gripper_config dimensions (the reference ToyGripper,
mujoco/base/gripper_base.py:16-22).

A numpy copy of s4g_tpu/datagen/grasp_env.py over the port's scene_sim and
gripper_config; `mujoco` is imported only where the simulation runs.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..configs import gripper_config as G
from ..robot.grasp_client import _mat2quat
from .scene_sim import ObjectSpec, TableEnv, build_arena_xml


def gripper_xml() -> str:
    """Free-floating parallel gripper: back hand + 2 prismatic fingers.

    Local frame matches the framework convention: +x approach, +-y fingers.
    """
    hw = G.HALF_BOTTOM_WIDTH
    ht = G.HALF_HAND_THICKNESS
    fl = G.FINGER_LENGTH
    fw = G.FINGER_WIDTH
    bl = G.BOTTOM_LENGTH
    return f"""
    <body name="gripper" pos="0 0 2">
      <joint type="free" name="gripper"/>
      <geom name="back_hand" type="box" size="{bl / 2} {hw} {ht}"
            pos="{-bl / 2} 0 0" density="2000"/>
      <body name="left_finger" pos="{fl / 2} {hw - fw / 2} 0">
        <joint name="left_finger_joint" type="slide" axis="0 -1 0"
               range="0 {hw - fw}" damping="10"/>
        <geom type="box" size="{fl / 2} {fw / 2} {ht}" density="2000"
              friction="2 0.01 0.0001"/>
      </body>
      <body name="right_finger" pos="{fl / 2} {-(hw - fw / 2)} 0">
        <joint name="right_finger_joint" type="slide" axis="0 1 0"
               range="0 {hw - fw}" damping="10"/>
        <geom type="box" size="{fl / 2} {fw / 2} {ht}" density="2000"
              friction="2 0.01 0.0001"/>
      </body>
    </body>
"""


def _actuator_xml() -> str:
    return """
  <actuator>
    <position name="left_finger_motor" joint="left_finger_joint"
              kp="200" ctrlrange="0 0.034"/>
    <position name="right_finger_motor" joint="right_finger_joint"
              kp="200" ctrlrange="0 0.034"/>
  </actuator>
"""


class GraspEnv:
    """Settle a scene, then dynamically evaluate grasp poses."""

    def __init__(self, objects: List[ObjectSpec], percentage: float = 1.0,
                 random_seed: Optional[int] = None):
        self.table_env = TableEnv(objects, percentage=percentage,
                                  random_seed=random_seed)
        self.objects = objects
        self._model = None
        self._data = None
        self._settled_qpos = None
        self.pose_dict: Dict[str, np.ndarray] = {}

    def prepare(self) -> Dict[str, np.ndarray]:
        import mujoco
        self.pose_dict = self.table_env.run() or {}
        base_xml = self.table_env.xml
        # splice the gripper + actuators into the settled arena
        xml = base_xml.replace("</worldbody>", gripper_xml() + "</worldbody>")
        xml = xml.replace("</mujoco>", _actuator_xml() + "</mujoco>")
        self._model = mujoco.MjModel.from_xml_string(xml)
        self._data = mujoco.MjData(self._model)
        # restore the settled object poses
        for name, pose in self.pose_dict.items():
            jid = mujoco.mj_name2id(self._model, mujoco.mjtObj.mjOBJ_JOINT,
                                    f"{name}_joint")
            adr = int(self._model.jnt_qposadr[jid])
            self._data.qpos[adr:adr + 3] = pose[0:3]
            self._data.qpos[adr + 3:adr + 7] = pose[3:7]
        mujoco.mj_forward(self._model, self._data)
        self._settled_qpos = self._data.qpos.copy()
        return self.pose_dict

    def evaluate_single_grasp(self, local_to_global: np.ndarray,
                              close_steps: int = 300,
                              lift_steps: int = 500,
                              lift_speed: float = 0.5) -> dict:
        """Place, close, lift; success when some object rises with the hand
        (reference grasp_env.py:78-100)."""
        import mujoco
        model, data = self._model, self._data
        data.qpos[:] = self._settled_qpos
        data.qvel[:] = 0.0
        data.ctrl[:] = 0.0

        jid = mujoco.mj_name2id(model, mujoco.mjtObj.mjOBJ_JOINT, "gripper")
        adr = int(model.jnt_qposadr[jid])
        vadr = int(model.jnt_dofadr[jid])
        pose = np.asarray(local_to_global, np.float64)
        data.qpos[adr:adr + 3] = pose[:3, 3]
        data.qpos[adr + 3:adr + 7] = _mat2quat(pose[:3, :3])
        mujoco.mj_forward(model, data)

        heights_before = {n: self.pose_dict[n][2] for n in self.pose_dict}

        act_l = mujoco.mj_name2id(model, mujoco.mjtObj.mjOBJ_ACTUATOR,
                                  "left_finger_motor")
        act_r = mujoco.mj_name2id(model, mujoco.mjtObj.mjOBJ_ACTUATOR,
                                  "right_finger_motor")
        data.ctrl[act_l] = 0.034
        data.ctrl[act_r] = 0.034
        for _ in range(close_steps):
            # keep the hand pinned while closing
            data.qvel[vadr:vadr + 6] = 0.0
            mujoco.mj_step(model, data)

        for _ in range(lift_steps):
            data.qvel[vadr:vadr + 6] = [0, 0, lift_speed, 0, 0, 0]
            mujoco.mj_step(model, data)

        lifted = {}
        for name in self.pose_dict:
            jid_o = mujoco.mj_name2id(model, mujoco.mjtObj.mjOBJ_JOINT,
                                      f"{name}_joint")
            adr_o = int(model.jnt_qposadr[jid_o])
            lifted[name] = float(data.qpos[adr_o + 2] - heights_before[name])
        best = max(lifted, key=lifted.get) if lifted else None
        success = best is not None and lifted[best] > 0.05
        return {"success": success, "lifted_object": best if success else None,
                "lift_heights": lifted}

"""Real-robot grasp service client (a numpy copy of
s4g_tpu/robot/grasp_client.py).

Re-design of the reference's roslibpy bridge (reference:
data_gen/real_robot/grasp_client.py:23-124): converts camera-frame grasp
poses (our detector output) through the hand<->end-effector calibration into
PoseStamped service requests.  The message-building path is pure and tested;
the network path needs roslibpy + a rosbridge server.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

# hand (our gripper origin at the palm) -> robot ee_link calibration
# (reference grasp_client.py:23-27)
HAND_TO_EE = np.array([[1., 0., 0., -0.03607],
                       [0., 0.956206, 0.292695, -0.002978],
                       [0., -0.292695, 0.956206, -0.01328],
                       [0., 0., 0., 1.]])
EE_TO_HAND = np.linalg.inv(HAND_TO_EE)


def _mat2quat(rot: np.ndarray) -> np.ndarray:
    """Rotation matrix -> (w, x, y, z) quaternion (a copy of
    s4g_tpu/datagen/grasp_env.py::_mat2quat; `datagen.grasp_env` imports
    this one)."""
    t = np.trace(rot)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (rot[2, 1] - rot[1, 2]) / s,
                         (rot[0, 2] - rot[2, 0]) / s,
                         (rot[1, 0] - rot[0, 1]) / s])
    i = int(np.argmax(np.diag(rot)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(rot[i, i] - rot[j, j] - rot[k, k] + 1.0, 1e-12)) * 2
    q = np.zeros(4)
    q[0] = (rot[k, j] - rot[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (rot[j, i] + rot[i, j]) / s
    q[1 + k] = (rot[k, i] + rot[i, k]) / s
    return q


def mat_pose_to_pose_stamped(mat44: np.ndarray, frame_id: str) -> dict:
    """4x4 pose -> ROS PoseStamped dict (reference grasp_client.py:53-67)."""
    quat = _mat2quat(np.asarray(mat44)[:3, :3])
    pos = np.asarray(mat44)[:3, 3]
    return {
        "header": {"frame_id": frame_id},
        "pose": {
            "position": {"x": float(pos[0]), "y": float(pos[1]),
                         "z": float(pos[2])},
            "orientation": {"x": float(quat[1]), "y": float(quat[2]),
                            "z": float(quat[3]), "w": float(quat[0])},
        },
    }


class GraspClient:
    """Send detected grasp poses to the robot-side grasp service."""

    CAMERA_FRAME = "kinect2_rgb_optical_frame"

    def __init__(self, table_to_eye: Optional[np.ndarray] = None,
                 ros=None):
        self.table_to_eye = table_to_eye
        self._service = None
        if ros is not None:  # pragma: no cover - requires rosbridge
            import roslibpy
            self._service = roslibpy.core.Service(
                ros, "/web_server/mat_grasp_server",
                "web_server/MatGraspService")

    def build_request(self, camera_frame_poses: np.ndarray, order: int = 0,
                      service_type: str = "grasp",
                      return_type: str = "init") -> dict:
        """Camera-frame grasp poses -> service request payload.

        Applies the hand->ee calibration so the robot receives ee_link
        targets (reference grasp_client.py:70-90)."""
        grasps: List[dict] = []
        for pose in np.asarray(camera_frame_poses).reshape(-1, 4, 4):
            ee_pose = pose @ HAND_TO_EE
            grasps.append(
                {"pose_stamped": mat_pose_to_pose_stamped(
                    ee_pose, self.CAMERA_FRAME)})
        return {"grasp": grasps, "order": order, "type": service_type,
                "return_type": return_type}

    def call_grasp(self, camera_frame_poses: np.ndarray, **kwargs) -> dict:
        req = self.build_request(camera_frame_poses, **kwargs)
        if self._service is None:
            raise RuntimeError(
                "Not connected to rosbridge; pass ros=connect(...) "
                "(s4g_tpu_torch.robot.ros.connect)")
        import roslibpy  # pragma: no cover
        return self._service.call(roslibpy.core.ServiceRequest(req))

    def add_table_collision_pose(self, table_to_eye: np.ndarray):
        """Publish the table-top pose for the planner's collision scene
        (reference grasp_client.py:46-51)."""
        req = {"grasp": [{"pose_stamped": mat_pose_to_pose_stamped(
            table_to_eye, self.CAMERA_FRAME)}],
            "order": 0, "type": "table", "return_type": "init"}
        if self._service is None:
            return req
        import roslibpy  # pragma: no cover
        return self._service.call(roslibpy.core.ServiceRequest(req))

"""Gripper-pose visualization without Open3D (a numpy copy of
s4g_tpu/utils/grasp_visualizer.py).

Re-design of the reference visualizer (reference:
utils/grasp_visualizer.py:8-65): builds the same back-hand + two-finger box
geometry per pose, but as plain numpy triangle meshes that can be exported
to PLY (utils/io_ply) or rendered with matplotlib if available.
"""

from __future__ import annotations

import numpy as np

from ..configs import gripper_config as G
from ..configs import processing_config as P
from .io_ply import write_ply_mesh, write_ply_points

_BOX_TRIS = np.array([
    [0, 1, 2], [1, 3, 2], [4, 6, 5], [5, 6, 7],
    [0, 4, 1], [1, 4, 5], [2, 3, 6], [3, 7, 6],
    [0, 2, 4], [2, 6, 4], [1, 5, 3], [3, 5, 7],
], dtype=np.int64)


def _box(extent, origin):
    """Axis-aligned box mesh with the given (dx, dy, dz) extent and corner
    origin. Returns (vertices (8, 3), triangles (12, 3))."""
    corners = np.array([[x, y, z]
                        for x in (0, extent[0])
                        for y in (0, extent[1])
                        for z in (0, extent[2])], dtype=np.float64)
    return corners + np.asarray(origin), _BOX_TRIS.copy()


def gripper_hand_mesh(local2global: np.ndarray):
    """Back-hand + two fingers in the gripper local frame, transformed by the
    pose.  Same geometry as the reference (grasp_visualizer.py:31-62).

    Returns (vertices (24, 3), triangles (36, 3))."""
    parts = []
    # back hand: spans x [-BOTTOM_LENGTH, -MARGIN], y +-HALF_BOTTOM_WIDTH,
    # z +-HALF_HAND_THICKNESS
    parts.append(_box(
        (G.BOTTOM_LENGTH - P.BACK_COLLISION_MARGIN,
         2 * G.HALF_BOTTOM_WIDTH, 2 * G.HALF_HAND_THICKNESS),
        (-G.BOTTOM_LENGTH, -G.HALF_BOTTOM_WIDTH, -G.HALF_HAND_THICKNESS)))
    # left finger: y in [HALF_BOTTOM_SPACE, HALF_BOTTOM_WIDTH]
    parts.append(_box(
        (G.FINGER_LENGTH + P.BACK_COLLISION_MARGIN, G.FINGER_WIDTH,
         2 * G.HALF_HAND_THICKNESS),
        (-P.BACK_COLLISION_MARGIN, G.HALF_BOTTOM_SPACE,
         -G.HALF_HAND_THICKNESS)))
    # right finger: y in [-HALF_BOTTOM_WIDTH, -HALF_BOTTOM_SPACE]
    parts.append(_box(
        (G.FINGER_LENGTH + P.BACK_COLLISION_MARGIN, G.FINGER_WIDTH,
         2 * G.HALF_HAND_THICKNESS),
        (-P.BACK_COLLISION_MARGIN, -G.HALF_BOTTOM_WIDTH,
         -G.HALF_HAND_THICKNESS)))

    verts, tris, off = [], [], 0
    rot, t = local2global[:3, :3], local2global[:3, 3]
    for v, f in parts:
        verts.append(v @ rot.T + t)
        tris.append(f + off)
        off += v.shape[0]
    return np.concatenate(verts), np.concatenate(tris)


class GraspVisualizer:
    """Collects a cloud + grasp poses; exports PLY or shows matplotlib."""

    def __init__(self, points: np.ndarray, colors: np.ndarray | None = None):
        """points: (N, 3) or (3, N)."""
        points = np.asarray(points)
        if points.shape[0] == 3 and points.shape[1] != 3:
            points = points.T
        self._points = points
        self._colors = colors
        self._hand_meshes: list[tuple[np.ndarray, np.ndarray]] = []

    def add_single_pose(self, pose: np.ndarray):
        self._hand_meshes.append(gripper_hand_mesh(np.asarray(pose)))

    def add_multiple_poses(self, poses: np.ndarray):
        poses = np.asarray(poses)
        assert poses.ndim == 3 and poses.shape[1:] == (4, 4)
        for i in range(poses.shape[0]):
            self.add_single_pose(poses[i])

    def save(self, cloud_path: str, hands_path: str | None = None):
        write_ply_points(cloud_path, self._points, self._colors)
        if hands_path and self._hand_meshes:
            verts, tris, off = [], [], 0
            for v, f in self._hand_meshes:
                verts.append(v)
                tris.append(f + off)
                off += v.shape[0]
            write_ply_mesh(hands_path, np.concatenate(verts),
                           np.concatenate(tris))

    def visualize(self):  # pragma: no cover - interactive
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            print("matplotlib unavailable; use save() for PLY export")
            return None
        fig = plt.figure()
        ax = fig.add_subplot(projection="3d")
        sub = self._points[:: max(1, len(self._points) // 5000)]
        ax.scatter(sub[:, 0], sub[:, 1], sub[:, 2], s=0.5, c="gray")
        for v, f in self._hand_meshes:
            ax.plot_trisurf(v[:, 0], v[:, 1], v[:, 2], triangles=f,
                            color=(0.1, 0.6, 0.3, 0.5))
        return fig

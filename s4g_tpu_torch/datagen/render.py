"""Depth rendering: scene meshes -> per-view point clouds (clean + noisy).

Replaces the reference's Blender/Cycles depth renderer (reference:
render/cycles_render.py:14-160) with a self-contained z-buffer triangle
rasterizer — no GL, no Blender.  Conventions match the reference exactly:

* intrinsics K = [[700, 0, 320], [0, 700, 240], [0, 0, 1]], 640x480;
* camera looks along -z (Blender convention); a camera-frame point
  p = (x, y, z) with z < 0 projects to u = fx*x/(-z) + cx,
  v = fy*y/(-z) + cy;
* the "depth" channel is RAY DISTANCE (cycles_render.py:131: range image
  times the unit ray direction), and the noisy twin multiplies the ray
  distance by (1 + 0.5% gaussian) (cycles_render.py:126);
* 4 fixed camera poses (pos + wxyz quaternion, cycles_render.py:14-19).

A numpy copy of s4g_tpu/datagen/render.py: the port imports nothing of
the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .scene_compose import quat_to_mat

CAMERA_POSE = [
    [0.8, 0, 1.7, 0.948, 0, 0.317, 0],
    [-0.8, 0, 1.6, -0.94, 0, 0.342, 0],
    [0.0, 0.75, 1.7, 0.671, -0.224, 0.224, 0.671],
    [0.0, -0.75, 1.6, -0.658, -0.259, -0.259, 0.658],
]

K_DEFAULT = np.array([[700.0, 0, 320], [0, 700.0, 240], [0, 0, 1]])
WIDTH, HEIGHT = 640, 480
MAX_RANGE = 5.0
NOISE_STD = 0.005


def camera_pose_matrix(pose7) -> np.ndarray:
    """[x, y, z, qw, qx, qy, qz] -> camera-to-world 4x4."""
    mat = np.eye(4)
    mat[:3, :3] = quat_to_mat(np.asarray(pose7[3:7], np.float64))
    mat[:3, 3] = pose7[0:3]
    return mat


def scaled_intrinsics(width: int, height: int,
                      base: np.ndarray = K_DEFAULT) -> np.ndarray:
    """Scale the reference 640x480 intrinsics to another resolution."""
    k = base.copy()
    k[0] *= width / WIDTH
    k[1] *= height / HEIGHT
    return k


def render_depth_mesh(vertices: np.ndarray, triangles: np.ndarray,
                      camera_to_world: np.ndarray,
                      intrinsics: np.ndarray = K_DEFAULT,
                      width: int = WIDTH, height: int = HEIGHT) -> np.ndarray:
    """Z-buffer rasterization of a world-frame triangle mesh.

    Returns a (H, W) z-depth map (positive distance along -z), inf = no hit.
    """
    world_to_cam = np.linalg.inv(camera_to_world)
    cam = vertices @ world_to_cam[:3, :3].T + world_to_cam[:3, 3]
    z = -cam[:, 2]  # positive in front of the camera
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    eps = 1e-6
    u = fx * cam[:, 0] / np.maximum(z, eps) + cx
    v = fy * cam[:, 1] / np.maximum(z, eps) + cy

    depth = np.full((height, width), np.inf, np.float64)
    tri_uvz = np.stack([u[triangles], v[triangles], z[triangles]], axis=-1)
    # cull triangles behind the camera or outside the frame
    ok = (tri_uvz[:, :, 2] > eps).all(axis=1)
    ok &= (tri_uvz[:, :, 0].max(axis=1) >= 0) & (tri_uvz[:, :, 0].min(axis=1) < width)
    ok &= (tri_uvz[:, :, 1].max(axis=1) >= 0) & (tri_uvz[:, :, 1].min(axis=1) < height)

    for t in tri_uvz[ok]:
        u0 = max(int(np.floor(t[:, 0].min())), 0)
        u1 = min(int(np.ceil(t[:, 0].max())) + 1, width)
        v0 = max(int(np.floor(t[:, 1].min())), 0)
        v1 = min(int(np.ceil(t[:, 1].max())) + 1, height)
        if u0 >= u1 or v0 >= v1:
            continue
        uu, vv = np.meshgrid(np.arange(u0, u1) + 0.5,
                             np.arange(v0, v1) + 0.5)
        # barycentric coordinates in pixel space
        x1, y1 = t[0, 0], t[0, 1]
        x2, y2 = t[1, 0], t[1, 1]
        x3, y3 = t[2, 0], t[2, 1]
        det = (y2 - y3) * (x1 - x3) + (x3 - x2) * (y1 - y3)
        if abs(det) < 1e-12:
            continue
        l1 = ((y2 - y3) * (uu - x3) + (x3 - x2) * (vv - y3)) / det
        l2 = ((y3 - y1) * (uu - x3) + (x1 - x3) * (vv - y3)) / det
        l3 = 1.0 - l1 - l2
        inside = (l1 >= 0) & (l2 >= 0) & (l3 >= 0)
        if not inside.any():
            continue
        # perspective-correct depth: interpolate 1/z
        inv_z = l1 / t[0, 2] + l2 / t[1, 2] + l3 / t[2, 2]
        z_pix = np.where(inside, 1.0 / np.maximum(inv_z, 1e-12), np.inf)
        patch = depth[v0:v1, u0:u1]
        np.minimum(patch, z_pix, out=patch)
    return depth


def depth_to_clouds(depth: np.ndarray, camera_to_world: np.ndarray,
                    intrinsics: np.ndarray = K_DEFAULT,
                    noise_std: float = NOISE_STD,
                    rng: np.random.RandomState | None = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Back-project a z-depth map into world-frame clean + noisy clouds.

    Ray-distance noise semantics match the reference
    (cycles_render.py:126-140).
    Returns (clean (N, 3), noisy (N, 3)).
    """
    rng = rng or np.random.RandomState()
    height, width = depth.shape
    uu, vv = np.meshgrid(np.arange(width) + 0.5, np.arange(height) + 0.5)
    rays = np.linalg.inv(intrinsics) @ np.stack(
        [uu.ravel(), vv.ravel(), np.ones(uu.size)])
    rays /= np.linalg.norm(rays, axis=0, keepdims=True)   # unit rays, +z fwd

    z = depth.ravel()
    valid = np.isfinite(z) & (z < MAX_RANGE)
    # ray distance = z-depth / cos(angle) = z / ray_z
    rng_dist = z[valid] / rays[2, valid]
    noise = rng_dist * (1.0 + rng.randn(rng_dist.size) * noise_std)

    def build(dist):
        pc = rays[:, valid] * dist[None, :]
        pc = pc.copy()
        pc[2, :] *= -1.0                                  # blender -z forward
        world = camera_to_world[:3, :3] @ pc + camera_to_world[:3, 3:4]
        return world.T.astype(np.float32)

    return build(rng_dist), build(noise)


def render_scene_views(meshes: Dict[str, Tuple[np.ndarray, np.ndarray]],
                       pose_dict: Dict[str, np.ndarray],
                       table_mesh: Tuple[np.ndarray, np.ndarray] | None = None,
                       camera_poses: List = None,
                       rng: np.random.RandomState | None = None,
                       width: int = WIDTH, height: int = HEIGHT):
    """Render all camera views of a posed scene.

    Args:
        meshes: {name: (vertices (V, 3), triangles (T, 3))} in object frames.
        pose_dict: {name: (7,) [xyz, quat wxyz]} simulation output.
        table_mesh: optional static mesh appended to every scene.

    Returns:
        list of (clean_cloud (N, 3), noisy_cloud (N, 3), camera_to_world)
        per view, world frame — the reference's rendered/*.pcd pairs
        (cycles_render.py:145-153).
    """
    camera_poses = camera_poses if camera_poses is not None else CAMERA_POSE
    rng = rng or np.random.RandomState()

    verts_all, tris_all, offset = [], [], 0
    for name, pose in pose_dict.items():
        v, t = meshes[name]
        rot = quat_to_mat(np.asarray(pose[3:7], np.float64))
        verts_all.append(v @ rot.T + pose[0:3])
        tris_all.append(np.asarray(t) + offset)
        offset += len(v)
    if table_mesh is not None:
        verts_all.append(table_mesh[0])
        tris_all.append(np.asarray(table_mesh[1]) + offset)
    vertices = np.concatenate(verts_all)
    triangles = np.concatenate(tris_all)

    intrinsics = scaled_intrinsics(width, height)
    views = []
    for pose7 in camera_poses:
        cam = camera_pose_matrix(pose7)
        depth = render_depth_mesh(vertices, triangles, cam,
                                  intrinsics=intrinsics,
                                  width=width, height=height)
        clean, noisy = depth_to_clouds(depth, cam, intrinsics=intrinsics,
                                       rng=rng)
        views.append((clean, noisy, cam))
    return views


def table_mesh(table_half_size=(0.38, 0.345), table_height=0.75,
               grid: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Simple table-top quad mesh at z = table_height."""
    hx, hy = table_half_size
    xs = np.linspace(-hx, hx, grid + 1)
    ys = np.linspace(-hy, hy, grid + 1)
    verts = np.array([[x, y, table_height] for y in ys for x in xs])
    tris = []
    for j in range(grid):
        for i in range(grid):
            a = j * (grid + 1) + i
            b = a + 1
            c = a + grid + 1
            d = c + 1
            tris += [[a, b, c], [b, d, c]]
    return verts, np.asarray(tris)

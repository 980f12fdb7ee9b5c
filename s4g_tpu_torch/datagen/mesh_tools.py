"""Mesh preparation utilities: loading, scaling, convex decomposition.

Re-design of the reference's object pipeline tools (reference:
render/plain_vhacd.py, render/wrl_to_stl.py, render/scale_objects.py):
minimal STL/OBJ loaders (no Open3D/trimesh), per-object scale variants
(name#k convention), dense scene PLY with label colors
(data_generator/point_cloud_scene_generator.py), and a V-HACD subprocess
wrapper gated on the binary being present.

A numpy copy of s4g_tpu/datagen/mesh_tools.py: the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import os
import struct
import subprocess
from typing import Dict, Tuple

import numpy as np

Mesh = Tuple[np.ndarray, np.ndarray]


def load_stl(path: str) -> Mesh:
    """Binary or ascii STL -> (vertices (V, 3), triangles (T, 3))."""
    with open(path, "rb") as f:
        head = f.read(5)
        f.seek(0)
        if head == b"solid" and b"facet" in f.read(512):
            f.seek(0)
            return _load_stl_ascii(f.read().decode("ascii", "ignore"))
        f.seek(80)
        (count,) = struct.unpack("<I", f.read(4))
        data = np.frombuffer(f.read(count * 50), dtype=np.uint8)
        data = data.reshape(count, 50)
        tris = data[:, 12:48].copy().view("<f4").reshape(count, 3, 3)
    return _dedupe(tris.astype(np.float64))


def _load_stl_ascii(text: str) -> Mesh:
    coords = []
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("vertex"):
            coords.append([float(x) for x in line.split()[1:4]])
    tris = np.asarray(coords).reshape(-1, 3, 3)
    return _dedupe(tris)


def _dedupe(tri_verts: np.ndarray) -> Mesh:
    flat = tri_verts.reshape(-1, 3)
    uniq, inverse = np.unique(flat.round(9), axis=0, return_inverse=True)
    return uniq, inverse.reshape(-1, 3).astype(np.int64)


def load_obj(path: str) -> Mesh:
    """Minimal OBJ loader (v/f records; polygons fan-triangulated)."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) - 1 for tok in line.split()[1:]]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, np.float64), np.asarray(faces, np.int64)


def load_wrl(path: str) -> Mesh:
    """Minimal VRML2 loader (Coordinate point + coordIndex), replacing the
    reference's blender-based wrl_to_stl.py."""
    text = open(path).read()
    verts, faces = [], []
    import re
    for block in re.findall(r"point\s*\[(.*?)\]", text, re.S):
        nums = [float(x) for x in re.findall(r"-?\d+\.?\d*(?:[eE][-+]?\d+)?",
                                             block)]
        verts.extend([nums[i:i + 3] for i in range(0, len(nums) - 2, 3)])
    for block in re.findall(r"coordIndex\s*\[(.*?)\]", text, re.S):
        nums = [int(float(x)) for x in
                re.findall(r"-?\d+", block)]
        poly = []
        for n in nums:
            if n == -1:
                for k in range(1, len(poly) - 1):
                    faces.append([poly[0], poly[k], poly[k + 1]])
                poly = []
            else:
                poly.append(n)
    return np.asarray(verts, np.float64), np.asarray(faces, np.int64)


def load_mesh(path: str) -> Mesh:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".stl":
        return load_stl(path)
    if ext == ".obj":
        return load_obj(path)
    if ext == ".wrl":
        return load_wrl(path)
    if ext == ".ply":
        raise ValueError("PLY meshes unsupported; convert to STL/OBJ")
    raise ValueError(f"unsupported mesh format {ext!r}")


def save_stl(path: str, vertices: np.ndarray, triangles: np.ndarray) -> None:
    """Binary STL writer (replaces the blender exporter)."""
    tri = vertices[triangles]                     # (T, 3, 3)
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n /= np.clip(np.linalg.norm(n, axis=1, keepdims=True), 1e-12, None)
    with open(path, "wb") as f:
        f.write(b"\0" * 80)
        f.write(struct.pack("<I", len(triangles)))
        rec = np.zeros((len(triangles), 50), np.uint8)
        payload = np.ascontiguousarray(np.concatenate(
            [n[:, None, :], tri], axis=1).astype("<f4"))     # (T, 4, 3)
        rec[:, :48] = payload.reshape(len(triangles), 12).view(np.uint8)
        f.write(rec.tobytes())


def scale_variants(vertices: np.ndarray, scales=(1.0, 0.85, 0.7)
                   ) -> Dict[int, np.ndarray]:
    """Per-object scale variants (the reference's name#k convention,
    render/scale_objects.py)."""
    return {k: vertices * s for k, s in enumerate(scales)}


def make_icosphere(radius: float = 0.035, subdiv: int = 2) -> Mesh:
    """Watertight subdivided icosahedron — uniformly curved surface.

    Procedural stand-in for mesh assets (the reference assumes 118 YCB
    meshes on disk, data_gen/configs/dataset_config.py:3-56; these
    generators let the datagen pipeline run without any asset download).
    """
    t = (1 + 5 ** 0.5) / 2
    v = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
                  [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
                  [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], float)
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                  [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                  [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                  [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]])
    for _ in range(subdiv):
        vlist, mid, nf = list(v), {}, []

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                vlist.append((vlist[a] + vlist[b]) / 2.0)
                mid[key] = len(vlist) - 1
            return mid[key]

        for a, b, c in f:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            nf += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
        v, f = np.array(vlist), np.array(nf)
    v = v / np.linalg.norm(v, axis=1, keepdims=True) * radius
    return v, f


def make_box(dx: float = 0.06, dy: float = 0.04, dz: float = 0.08) -> Mesh:
    """Watertight axis-aligned box — flat faces and sharp edges."""
    x, y, z = dx / 2, dy / 2, dz / 2
    v = np.array([[sx, sy, sz] for sx in (-x, x) for sy in (-y, y)
                  for sz in (-z, z)], float)
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                  [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                  [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]])
    return v, f


def make_cylinder(r: float = 0.025, h: float = 0.09, n: int = 24) -> Mesh:
    """Watertight capped cylinder — mixed flat/curved surface."""
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    ring = np.stack([r * np.cos(ang), r * np.sin(ang)], 1)
    bot = np.concatenate([ring, np.full((n, 1), -h / 2)], 1)
    top = np.concatenate([ring, np.full((n, 1), h / 2)], 1)
    v = np.concatenate([bot, top, [[0, 0, -h / 2]], [[0, 0, h / 2]]])
    f = []
    for i in range(n):
        j = (i + 1) % n
        f += [[i, j, n + i], [j, n + j, n + i],          # side quads
              [2 * n, j, i], [2 * n + 1, n + i, n + j]]  # caps
    return v, np.array(f)


def make_torus(ring_radius: float = 0.032, tube_radius: float = 0.012,
               n_major: int = 24, n_minor: int = 12) -> Mesh:
    """Watertight torus — genus-1 topology, curvature of both signs (the
    inner ring is a saddle), a geometry class none of the other
    procedural objects cover."""
    th = np.linspace(0, 2 * np.pi, n_major, endpoint=False)
    ph = np.linspace(0, 2 * np.pi, n_minor, endpoint=False)
    th, ph = np.meshgrid(th, ph, indexing="ij")       # (maj, min)
    rr = ring_radius + tube_radius * np.cos(ph)
    v = np.stack([rr * np.cos(th), rr * np.sin(th),
                  tube_radius * np.sin(ph)], -1).reshape(-1, 3)
    f = []
    for i in range(n_major):
        i2 = (i + 1) % n_major
        for j in range(n_minor):
            j2 = (j + 1) % n_minor
            a, b = i * n_minor + j, i2 * n_minor + j
            c, d = i2 * n_minor + j2, i * n_minor + j2
            f += [[a, b, c], [a, c, d]]
    return v, np.array(f)


def make_cone(r: float = 0.03, h: float = 0.075, n: int = 24) -> Mesh:
    """Watertight capped cone — sloped curved surface tapering to a point."""
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    base = np.stack([r * np.cos(ang), r * np.sin(ang),
                     np.zeros(n)], 1)
    v = np.concatenate([base, [[0, 0, h]], [[0, 0, 0]]])
    f = []
    for i in range(n):
        j = (i + 1) % n
        f += [[i, j, n],            # side to apex
              [n + 1, j, i]]        # base cap (down)
    return v, np.array(f)


def make_wedge(dx: float = 0.07, dy: float = 0.045, dz: float = 0.05) -> Mesh:
    """Watertight triangular prism (door-stop wedge) — one sloped face."""
    v = np.array([[0, 0, 0], [dx, 0, 0], [0, 0, dz],
                  [0, dy, 0], [dx, dy, 0], [0, dy, dz]], float)
    v -= v.mean(axis=0)
    f = np.array([[0, 1, 2], [3, 5, 4],                    # triangle ends
                  [0, 4, 1], [0, 3, 4],                    # bottom
                  [0, 5, 3], [0, 2, 5],                    # back
                  [1, 5, 2], [1, 4, 5]])                   # slope
    return v, f


def make_pyramid(base: float = 0.055, h: float = 0.07) -> Mesh:
    """Watertight square pyramid — four sloped flat faces, sharp apex."""
    s = base / 2
    v = np.array([[-s, -s, 0], [s, -s, 0], [s, s, 0], [-s, s, 0],
                  [0, 0, h]], float)
    f = np.array([[0, 1, 4], [1, 2, 4], [2, 3, 4], [3, 0, 4],
                  [0, 3, 1], [1, 3, 2]])                   # base (down)
    return v, f


def make_ellipsoid(a: float = 0.045, b: float = 0.03, c: float = 0.022,
                   subdiv: int = 2) -> Mesh:
    """Watertight tri-axial ellipsoid — anisotropic curvature (egg-like)."""
    v, f = make_icosphere(radius=1.0, subdiv=subdiv)
    return v * np.array([a, b, c]), f


def make_capsule(r: float = 0.018, h: float = 0.06, n: int = 20,
                 rings: int = 5) -> Mesh:
    """Watertight capsule (cylinder + hemispherical caps) — the classic
    bottle/can-with-rounded-ends grasp geometry."""
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    cs = np.stack([np.cos(ang), np.sin(ang)], 1)
    verts = [[0.0, 0.0, -h / 2 - r]]                       # bottom pole: 0
    ring_rows = []
    # bottom hemisphere rings (near-pole up to the cylinder joint) ...
    for k in range(1, rings + 1):
        phi = np.pi / 2 * (k / rings)                      # 0 -> pi/2
        rr, zz = r * np.sin(phi), -h / 2 - r * np.cos(phi)
        ring_rows.append(np.concatenate(
            [rr * cs, np.full((n, 1), zz)], 1))
    # ... then top hemisphere rings (joint up to near-pole); phi measured
    # from the equator upward, pole vertex appended separately.
    for k in range(rings):
        phi = np.pi / 2 * (k / rings)
        rr, zz = r * np.cos(phi), h / 2 + r * np.sin(phi)
        ring_rows.append(np.concatenate(
            [rr * cs, np.full((n, 1), zz)], 1))
    base = 1
    v = np.concatenate([verts, np.concatenate(ring_rows),
                        [[0.0, 0.0, h / 2 + r]]])
    top_pole = len(v) - 1
    f = []
    for i in range(n):                                     # bottom fan
        j = (i + 1) % n
        f.append([0, base + j, base + i])
    nrows = len(ring_rows)
    for row in range(nrows - 1):                           # band quads
        r0, r1 = base + row * n, base + (row + 1) * n
        for i in range(n):
            j = (i + 1) % n
            f += [[r0 + i, r0 + j, r1 + j], [r0 + i, r1 + j, r1 + i]]
    last = base + (nrows - 1) * n
    for i in range(n):                                     # top fan
        j = (i + 1) % n
        f.append([last + i, last + j, top_pole])
    return v, np.array(f)


def make_lshape(leg: float = 0.07, thickness: float = 0.025,
                depth: float = 0.04) -> Mesh:
    """Watertight extruded L-profile — CONCAVE cross-section (inside
    corner), the geometry that separates first-K-scan grasp candidates
    from convex objects."""
    w = h = leg
    t = thickness
    # counter-clockwise L polygon; fan from vertex 0 stays inside the L
    poly = np.array([[0, 0], [w, 0], [w, t], [t, t], [t, h], [0, h]], float)
    m = len(poly)
    bot = np.concatenate([poly, np.zeros((m, 1))], 1)
    top = np.concatenate([poly, np.full((m, 1), depth)], 1)
    v = np.concatenate([bot, top])
    v -= v.mean(axis=0)
    cap = [[0, 2, 1], [0, 3, 2], [0, 4, 3], [0, 5, 4]]     # z=0, down
    f = list(cap)
    f += [[m + a, m + b, m + c] for a, c, b in cap]        # z=depth, up
    for i in range(m):                                     # side quads
        j = (i + 1) % m
        f += [[i, j, m + j], [i, m + j, m + i]]
    return v, np.array(f)


def make_cup(r_outer: float = 0.03, wall: float = 0.005, h: float = 0.065,
             n: int = 24) -> Mesh:
    """Watertight open-top cup (annular wall + bottom) — the only
    procedural class with an interior cavity surface (rim grasps)."""
    ri = r_outer - wall
    zb = wall                                              # inner floor z
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    cs = np.stack([np.cos(ang), np.sin(ang)], 1)

    ob = np.concatenate([r_outer * cs, np.zeros((n, 1))], 1)    # 0
    ot = np.concatenate([r_outer * cs, np.full((n, 1), h)], 1)  # n
    it = np.concatenate([ri * cs, np.full((n, 1), h)], 1)       # 2n
    ib = np.concatenate([ri * cs, np.full((n, 1), zb)], 1)      # 3n
    v = np.concatenate([ob, ot, it, ib,
                        [[0, 0, 0]], [[0, 0, zb]]])
    cb, ci = 4 * n, 4 * n + 1          # bottom center, inner-floor center
    f = []
    for i in range(n):
        j = (i + 1) % n
        f += [[i, j, n + j], [i, n + j, n + i]]            # outer wall (out)
        f += [[n + i, n + j, 2 * n + j],
              [n + i, 2 * n + j, 2 * n + i]]               # rim (up)
        f += [[2 * n + i, 2 * n + j, 3 * n + j],
              [2 * n + i, 3 * n + j, 3 * n + i]]           # inner wall (in)
        f += [[ci, 3 * n + i, 3 * n + j]]                  # inner floor (up)
        f += [[cb, j, i]]                                  # bottom (down)
    return v, np.array(f)


# Procedural object inventory: the datagen factory's stand-in for the
# reference's 118-mesh YCB catalog (data_gen/configs/dataset_config.py:3-56)
# when no assets are on disk — 11 distinct geometry classes spanning flat,
# curved, tapered, saddle, concave, and cavity surfaces.
PROCEDURAL_CLASSES = {
    "icosphere": make_icosphere,
    "box": make_box,
    "cylinder": make_cylinder,
    "torus": make_torus,
    "cone": make_cone,
    "wedge": make_wedge,
    "pyramid": make_pyramid,
    "ellipsoid": make_ellipsoid,
    "capsule": make_capsule,
    "lshape": make_lshape,
    "cup": make_cup,
}


def vhacd_decompose(input_path: str, output_dir: str,
                    binary: str = "vhacd") -> list:
    """Convex decomposition via the V-HACD CLI (reference
    render/plain_vhacd.py wraps the same binary).  Returns the produced
    part paths; raises FileNotFoundError when the binary is absent."""
    os.makedirs(output_dir, exist_ok=True)
    name = os.path.splitext(os.path.basename(input_path))[0]
    out = os.path.join(output_dir, f"{name}_vhacd.obj")
    subprocess.run([binary, "--input", input_path, "--output", out],
                   check=True, capture_output=True)
    return [out]


def scene_ply(object_meshes: Dict[str, Mesh],
              pose_dict: Dict[str, np.ndarray], path: str,
              samples_per_object: int = 4000,
              rng: np.random.RandomState | None = None,
              table_height: float = 0.75,
              table_half=(0.38, 0.345)) -> np.ndarray:
    """Dense colored scene cloud with label-encoding colors (reference:
    data_generator/point_cloud_scene_generator.py:22-106 +
    dataset_config color hashing).  Returns the (N, 3) cloud."""
    from .dataset_config import NAME_TO_COLOR, TABLE_COLOR, label_to_color
    from .generate import sample_mesh_surface
    from .scene_compose import quat_to_mat
    from ..utils.io_ply import write_ply_points

    rng = rng or np.random.RandomState(0)
    pts, colors = [], []
    for i, (name, pose) in enumerate(pose_dict.items()):
        verts, tris = object_meshes[name]
        cloud = sample_mesh_surface(verts, tris, samples_per_object, rng)
        rot = quat_to_mat(np.asarray(pose[3:7], np.float64))
        pts.append(cloud @ rot.T + pose[0:3])
        color = NAME_TO_COLOR.get(name, label_to_color(np.array([i]))[0])
        colors.append(np.tile(color, (len(cloud), 1)))
    # table top
    tx = rng.uniform(-table_half[0], table_half[0], samples_per_object)
    ty = rng.uniform(-table_half[1], table_half[1], samples_per_object)
    pts.append(np.stack([tx, ty, np.full_like(tx, table_height)], axis=1))
    colors.append(np.tile(TABLE_COLOR, (samples_per_object, 1)))

    cloud = np.concatenate(pts).astype(np.float32)
    write_ply_points(path, cloud, colors=np.concatenate(colors))
    return cloud

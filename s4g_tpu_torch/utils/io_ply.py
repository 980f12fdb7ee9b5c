"""Minimal PLY I/O (ascii) for point clouds and triangle meshes (a numpy
copy of s4g_tpu/utils/io_ply.py: the port reads no module of the JAX
package; the files it writes are byte for byte the JAX package's).

Replaces the reference's Open3D file I/O (write_point_cloud /
write_triangle_mesh) — the framework has no Open3D dependency.
"""

from __future__ import annotations

import numpy as np


def write_ply_points(path: str, points: np.ndarray,
                     colors: np.ndarray | None = None,
                     normals: np.ndarray | None = None) -> None:
    """points (N, 3), optional colors (N, 3) in [0, 1], normals (N, 3)."""
    points = np.asarray(points, np.float32)
    n = points.shape[0]
    props = ["property float x", "property float y", "property float z"]
    cols = [points]
    if normals is not None:
        props += ["property float nx", "property float ny", "property float nz"]
        cols.append(np.asarray(normals, np.float32))
    if colors is not None:
        props += ["property uchar red", "property uchar green",
                  "property uchar blue"]
        cols.append(np.clip(np.asarray(colors) * 255, 0, 255).astype(np.uint8))
    header = ("ply\nformat ascii 1.0\n"
              f"element vertex {n}\n" + "\n".join(props) +
              "\nend_header\n")
    with open(path, "w") as f:
        f.write(header)
        for i in range(n):
            row = []
            for c in cols:
                row.extend(str(v) for v in np.asarray(c[i]).ravel())
            f.write(" ".join(row) + "\n")


def write_ply_mesh(path: str, vertices: np.ndarray, triangles: np.ndarray,
                   vertex_colors: np.ndarray | None = None) -> None:
    """vertices (V, 3), triangles (T, 3) int, optional colors (V, 3)."""
    vertices = np.asarray(vertices, np.float32)
    triangles = np.asarray(triangles, np.int64)
    v, t = vertices.shape[0], triangles.shape[0]
    props = ["property float x", "property float y", "property float z"]
    if vertex_colors is not None:
        props += ["property uchar red", "property uchar green",
                  "property uchar blue"]
        colors = np.clip(np.asarray(vertex_colors) * 255, 0, 255).astype(np.uint8)
    header = ("ply\nformat ascii 1.0\n"
              f"element vertex {v}\n" + "\n".join(props) + "\n"
              f"element face {t}\n"
              "property list uchar int vertex_indices\nend_header\n")
    with open(path, "w") as f:
        f.write(header)
        for i in range(v):
            row = [str(x) for x in vertices[i]]
            if vertex_colors is not None:
                row += [str(x) for x in colors[i]]
            f.write(" ".join(row) + "\n")
        for i in range(t):
            f.write("3 " + " ".join(str(x) for x in triangles[i]) + "\n")


def read_ply_points(path: str) -> np.ndarray:
    """Read vertex positions from an ascii or binary-LE PLY file -> (N, 3)."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        n = 0
        props = []
        fmt = "ascii"
        in_vertex = False
        for line in header:
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element vertex"):
                n = int(line.split()[-1])
                in_vertex = True
            elif line.startswith("element"):
                in_vertex = False
            elif line.startswith("property") and in_vertex:
                props.append(line.split()[1:])
        if fmt == "ascii":
            pts = []
            for _ in range(n):
                vals = f.readline().split()
                pts.append([float(vals[0]), float(vals[1]), float(vals[2])])
            return np.asarray(pts, np.float32)
        type_map = {"float": "f4", "double": "f8", "uchar": "u1",
                    "uint8": "u1", "int": "i4", "float32": "f4",
                    "float64": "f8"}
        dtype = np.dtype([(f"p{i}", type_map[p[0]])
                          for i, p in enumerate(props)])
        data = np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype, count=n)
        return np.stack([data["p0"], data["p1"], data["p2"]],
                        axis=1).astype(np.float32)

"""ctypes bindings for the native host-ops library, with numpy fallbacks
(port of s4g_tpu/runtime/host_ops.py).

The C++ kernels (`runtime/csrc/host_ops.cpp`, the port's own copy) cover
the host-side stages the reference delegated to Open3D's C++: voxel
downsample with index trace, radius outlier removal, and grid-accelerated
1-NN matching.  They run on the host CPU, not on the card.  The library is
built with g++ at first use (never at import) into the package's
gitignored `_build/` directory, beside the CUDA kernels' library, and every
entry point falls back to its numpy implementation when the toolchain is
unavailable (`native_available()` says which one runs).  The numpy
outlier and 1-NN paths materialise (n, n, 3) arrays: they are for small
inputs and for checking the native ones.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "csrc", "host_ops.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libs4g_host.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> Optional[str]:
    """Compile the library unless a build newer than the source exists;
    the build lands under a temporary name and is renamed into place, so
    a concurrent process never loads a half-written file."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    if (os.path.exists(_LIB_PATH)
            and os.path.getmtime(_LIB_PATH) >= os.path.getmtime(_SRC)):
        return _LIB_PATH
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except (subprocess.CalledProcessError, FileNotFoundError):
        os.unlink(tmp)
        return None
    os.replace(tmp, _LIB_PATH)
    return _LIB_PATH


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        f32p = ctypes.POINTER(ctypes.c_float)
        i64p = ctypes.POINTER(ctypes.c_int64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.voxel_downsample_trace.restype = ctypes.c_int64
        lib.voxel_downsample_trace.argtypes = [
            f32p, ctypes.c_int64, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_float, f32p, i64p, ctypes.c_int64]
        lib.radius_outlier_mask.restype = None
        lib.radius_outlier_mask.argtypes = [
            f32p, ctypes.c_int64, ctypes.c_float, ctypes.c_int32, u8p]
        lib.nearest_neighbor_match.restype = None
        lib.nearest_neighbor_match.argtypes = [
            f32p, ctypes.c_int64, f32p, ctypes.c_int64, ctypes.c_float,
            i64p, f32p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def _f32(x) -> np.ndarray:
    return np.ascontiguousarray(x, dtype=np.float32)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def voxel_downsample_trace(points: np.ndarray, voxel_size: float,
                           origin: Optional[np.ndarray] = None
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """(n, 3) -> (voxel mean points (m, 3), max-original-index trace (m,))."""
    points = _f32(points)
    n = len(points)
    if origin is None:
        origin = points.min(0) if n else np.zeros(3, np.float32)
    lib = _load()
    if lib is not None and n:
        out_pts = np.empty((n, 3), np.float32)
        out_trace = np.empty(n, np.int64)
        m = lib.voxel_downsample_trace(
            _ptr(points, ctypes.c_float), n, float(voxel_size),
            float(origin[0]), float(origin[1]), float(origin[2]),
            _ptr(out_pts, ctypes.c_float), _ptr(out_trace, ctypes.c_int64), n)
        return out_pts[:m], out_trace[:m]
    return numpy_voxel_downsample_trace(points, voxel_size, origin)


def numpy_voxel_downsample_trace(points: np.ndarray, voxel_size: float,
                                 origin: np.ndarray
                                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The numpy path of `voxel_downsample_trace` (its fallback, and the
    native library's check)."""
    points = _f32(points)
    n = len(points)
    coords = np.floor((points - origin) / voxel_size).astype(np.int64)
    keys = (coords[:, 0] * 1_000_003 + coords[:, 1]) * 1_000_003 + coords[:, 2]
    order = np.argsort(keys, kind="stable")
    keys_s = keys[order]
    boundaries = np.concatenate([[0], np.nonzero(np.diff(keys_s))[0] + 1,
                                 [n]])
    pts_out, trace_out = [], []
    for a, b in zip(boundaries[:-1], boundaries[1:]):
        sel = order[a:b]
        pts_out.append(points[sel].mean(0))
        trace_out.append(sel.max())
    return (np.asarray(pts_out, np.float32),
            np.asarray(trace_out, np.int64))


def radius_outlier_mask(points: np.ndarray, radius: float,
                        min_neighbors: int) -> np.ndarray:
    """(n, 3) -> (n,) bool keep-mask (self counts as a neighbour)."""
    points = _f32(points)
    n = len(points)
    lib = _load()
    if lib is not None and n:
        keep = np.empty(n, np.uint8)
        lib.radius_outlier_mask(_ptr(points, ctypes.c_float), n,
                                float(radius), int(min_neighbors),
                                _ptr(keep, ctypes.c_uint8))
        return keep.astype(bool)
    return numpy_radius_outlier_mask(points, radius, min_neighbors)


def numpy_radius_outlier_mask(points: np.ndarray, radius: float,
                              min_neighbors: int) -> np.ndarray:
    """The numpy path of `radius_outlier_mask`: (n, n, 3) differences."""
    points = _f32(points)
    d2 = np.sum((points[:, None] - points[None]) ** 2, -1)
    return (d2 < radius * radius).sum(1) >= min_neighbors


def nearest_neighbor_match(query: np.ndarray, ref: np.ndarray,
                           max_radius: float
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """1-NN within max_radius: -1 index (and -1 dist2) when no neighbour is
    in range."""
    query, ref = _f32(query), _f32(ref)
    nq = len(query)
    lib = _load()
    if lib is not None and nq and len(ref):
        idx = np.empty(nq, np.int64)
        dist2 = np.empty(nq, np.float32)
        lib.nearest_neighbor_match(
            _ptr(query, ctypes.c_float), nq, _ptr(ref, ctypes.c_float),
            len(ref), float(max_radius), _ptr(idx, ctypes.c_int64),
            _ptr(dist2, ctypes.c_float))
        return idx, dist2
    return numpy_nearest_neighbor_match(query, ref, max_radius)


def numpy_nearest_neighbor_match(query: np.ndarray, ref: np.ndarray,
                                 max_radius: float
                                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The numpy path of `nearest_neighbor_match`: (nq, nr, 3)
    differences."""
    query, ref = _f32(query), _f32(ref)
    nq = len(query)
    d2 = np.sum((query[:, None] - ref[None]) ** 2, -1)
    idx = d2.argmin(1)
    dist2 = d2[np.arange(nq), idx]
    out = np.where(dist2 <= max_radius ** 2, idx, -1)
    return out.astype(np.int64), np.where(out >= 0, dist2, -1.0).astype(
        np.float32)

"""Grasp-quality grading on the device (port of s4g_tpu/datagen/grading.py).

* normal estimation and Darboux frames (reference:
  data_generator/data_object_darboux_generator.py:62-92): a self ball query
  (`ops.neighbors.ball_query`, the CUDA kernel K2f on CUDA tensors) and a
  3x3 symmetric eigendecomposition per point;
* gripper-pose grading "finger_hand_view" (reference:
  data_object_darboux_generator.py:131-221): the cloud is transformed into
  every (point x length x theta) search pose and every collision,
  close-region and antipodal term is a masked reduction over the points,
  with the reference's stateful dz loop reproduced (`_reduce_dz`).

The results are the same bits on the CPU and on the card, by
construction, but for the antipodal band sums (float64 sums in the
backend's order, rounded to f32 once: they part only where a sum lies on
an f32 rounding boundary):

* the neighbour-slot sums (means, covariances) are adds over the K slots in
  slot order, one elementwise op at a time (a library reduction's order is
  the backend's);
* the eigenvectors come from `_eigh3`, a cyclic Jacobi solver with a fixed
  number of sweeps in float64 written with +, -, *, / and square roots
  only.  torch's `sqrt` is not correctly rounded on both devices (the
  CPU's and the card's roots part by an ulp on some inputs), so the
  square roots are `sqrt_rn` (f32, moved to the correctly rounded root)
  and `_sqrt64` (Newton steps in float64 from it); torch divides by a
  Python scalar on the card as a multiply by its reciprocal, so every
  divisor here is a tensor, and x / 3 is x * THIRD on both devices.
  Eigenvalues ascend (ties keep the lower index); each eigenvector's sign
  is the one the fixed rotation sequence gives, with no further rule.  The JAX package
  takes whatever its backend's `eigh` returns, so the signs of the two
  packages' eigenvectors agree only by chance: the normals get theirs
  from the camera (only a normal perpendicular to the camera ray can
  differ), and a Darboux frame whose minor axis has the other sign is the
  same frame turned 180 degrees about x, the gripper's symmetry.  A flat
  patch or a crease has no minor axis; `darboux_gaps` gives each point's
  relative eigenvalue gap, which says where frames of two solvers can be
  compared;
* the pose transforms are products and sums in one fixed order,
  ((px*m0 + py*m1) + pz*m2) + m3, as `pipeline.eval_cloud` writes them;
  the small products that feed them (4x4 products `mat4_mul`, SE(3)
  inverses `se3_inv`, matmul-form distances) are chains of fused
  multiply-adds (`fma_chain`), the order XLA's CPU dot gives most of them,
  so mostly the JAX package's bits there (the search poses of
  `label_transfer.grade_against_scene`, which XLA multiplies unfused, are
  within an ulp of the JAX package's).  A point within an ulp of a box
  face, or a gripper corner within an ulp of the table plane, can still
  land on the other side of it than in the JAX package;
* poses go through in chunks of about CHUNK_PAIRS pose-point pairs, and the
  masked band sums accumulate in float64 and round to f32 once, so the
  result does not depend on the chunk size.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..configs import gripper_config as G
from ..ops.neighbors import _f32, ball_query
from ..pipeline.eval_cloud import (CHUNK_PAIRS, THIRD, antipodal,
                                   transform_rows)

# Data-gen geometry constants (reference: data_gen/configs/config.py:17-56).
# The data-gen gripper uses a SHORTER bottom (0.08 vs inference 0.16) and
# looser thresholds.
DATAGEN_BOTTOM_LENGTH = 0.08
DATAGEN_NUM_POINTS_THRESHOLD = 8
DATAGEN_BACK_COLLISION_THRESHOLD = 0.0
DATAGEN_FINGER_COLLISION_THRESHOLD = 0
DATAGEN_CLOSE_REGION_MIN_POINTS = 10
NEIGHBOR_DEPTH = 0.005
LENGTH_SEARCH = (-0.08, -0.06, -0.04, -0.02)
THETA_SEARCH = tuple(t / 57.29578 for t in range(-90, 90, 15))
DZ_SEARCH = (-0.02, 0.02, 0.0)

# Cyclic Jacobi sweeps of `_eigh3` (3x3 in float64 converges in 4-5).
JACOBI_SWEEPS = 8



def search_grid_transforms(length_search=LENGTH_SEARCH,
                           theta_search=THETA_SEARCH) -> np.ndarray:
    """LOCAL_TO_LOCAL_SEARCH grid (reference: data_gen/configs/config.py:67-85):
    translate -length along x, rotate theta about x.  (L*T, 4, 4)."""
    grids = []
    for length in length_search:
        for theta in theta_search:
            m = np.eye(4)
            m[0, 3] = -length
            c, s = np.cos(theta), np.sin(theta)
            m[1, 1] = c
            m[2, 2] = c
            m[1, 2] = s
            m[2, 1] = -s
            grids.append(m)
    return np.asarray(grids, np.float32)


# -----------------------------------------------------------------------------
# Device-independent arithmetic
# -----------------------------------------------------------------------------

def fma_chain(terms) -> torch.Tensor:
    """sum_k x_k * y_k of f32 tensors as XLA's CPU dot computes it: the
    first product rounded, then one fused multiply-add per term.  Each fma
    is float64 arithmetic (the product of two f32 values is exact there)
    rounded to f32 once, so the bits are the same on every device (a
    library matmul's order and fusion are the backend's)."""
    (x0, y0), *rest = terms
    acc = x0 * y0
    for x, y in rest:
        acc = (x.double() * y.double() + acc.double()).float()
    return acc


def mat4_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) @ (..., 4, 4), broadcast, each entry an `fma_chain`."""
    return fma_chain([(a[..., :, j, None], b[..., j, None, :])
                      for j in range(4)])


def se3_inv(transformation: torch.Tensor) -> torch.Tensor:
    """Inverse of batched SE(3) matrices, (..., 4, 4) -> (..., 4, 4):
    [R^T | -R^T t], the translation an `fma_chain` (the JAX package's
    `batch_transformation_inv` on the CPU, bit for bit, and the same bits
    on the card)."""
    rot_inv = transformation[..., :3, :3].transpose(-1, -2)
    t = transformation[..., :3, 3]
    trans = -fma_chain([(rot_inv[..., :, k], t[..., k, None])
                        for k in range(3)])
    top = torch.cat([rot_inv, trans[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=transformation.dtype,
                          device=transformation.device)
    bottom = bottom.expand(*transformation.shape[:-2], 1, 4)
    return torch.cat([top, bottom], dim=-2)


def matmul_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Matmul-form squared distances (|a|^2 + |b|^2) - 2 a.b, (M, 3) x
    (N, 3) -> (M, N), with the norms and the dot products `fma_chain`s:
    the bits of the JAX package's `sum(a**2) + sum(b**2) - 2 a @ b.T` on
    the CPU, and the same on the card."""
    a2 = fma_chain([(a[:, k], a[:, k]) for k in range(3)])
    b2 = fma_chain([(b[:, k], b[:, k]) for k in range(3)])
    ab = fma_chain([(a[:, k, None], b[None, :, k]) for k in range(3)])
    return (a2[:, None] + b2[None, :]) - 2.0 * ab


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root of f32 x >= 0, the same bits on every
    device: torch's root (within an ulp) moved to the f32 neighbour whose
    rounding interval holds the true root, decided by squaring the
    interval's ends in float64, where the square of a 25-bit midpoint is
    exact."""
    s = torch.sqrt(x)
    x64 = x.double()
    up = torch.nextafter(s, torch.full_like(s, float("inf")))
    down = torch.nextafter(s, torch.zeros_like(s))
    hi = (s.double() + up.double()) * 0.5
    lo = (s.double() + down.double()) * 0.5
    s = torch.where(hi * hi < x64, up, s)
    return torch.where(lo * lo > x64, down, s)


def _sqrt64(x: torch.Tensor) -> torch.Tensor:
    """Square root of float64 1 <= x <= 1e20: two Newton steps from
    `sqrt_rn` of x rounded to f32, all IEEE divisions and sums, so the
    same bits on every device (within an ulp of the true root)."""
    y = sqrt_rn(x.float()).double()
    for _ in range(2):
        y = 0.5 * (y + x / y)
    return y


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a0*b0 + a1*b1) + a2*b2 over the last axis."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the last axis, each component one product minus another
    (`torch.linalg.cross` may fuse them into an fma on one device only)."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]],
                       dim=-1)


def _unit(v: torch.Tensor) -> torch.Tensor:
    """v / max(|v|, 1e-12) over the last axis, |v|^2 an `fma_chain` (as
    XLA fuses `jnp.linalg.norm` on the CPU)."""
    norm2 = fma_chain([(v[..., k], v[..., k]) for k in range(3)])
    return v / torch.clamp(sqrt_rn(norm2), min=1e-12)[..., None]


def _slot_sum(values: torch.Tensor) -> torch.Tensor:
    """(N, K, C) -> (N, C): the K slots added in slot order."""
    acc = values[:, 0]
    for k in range(1, values.shape[1]):
        acc = acc + values[:, k]
    return acc


def _slot_cov(diff: torch.Tensor) -> torch.Tensor:
    """(N, K, 3) -> (N, 3, 3): sum over slots of the outer products, in
    slot order."""
    return _slot_sum(diff[..., :, None] * diff[..., None, :])


def _eigh3(cov: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigen-decomposition of (N, 3, 3) symmetric f32 matrices.

    Cyclic Jacobi in float64 with JACOBI_SWEEPS sweeps over the pairs
    (0, 1), (0, 2), (1, 2) (Numerical Recipes' rotation: t = sgn(th) /
    (|th| + sqrt(th^2 + 1)), th = (a_qq - a_pp) / 2 a_pq, and t = 1 / 2th
    past |th| = 1e10), then a stable sort of the eigenvalues.  Returns eigenvalues (N, 3) ascending and
    eigenvectors (N, 3, 3) as columns, f32."""
    a = [[cov[:, i, j].double() for j in range(3)] for i in range(3)]
    one = torch.ones_like(a[0][0])
    zero = torch.zeros_like(one)
    v = [[one if i == j else zero for j in range(3)] for i in range(3)]
    for _ in range(JACOBI_SWEEPS):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            r = 3 - p - q
            apq = a[p][q]
            live = apq != 0.0
            theta = (a[q][q] - a[p][p]) / (2.0 * torch.where(live, apq, one))
            sgn = torch.where(theta < 0.0, -one, one)
            huge = torch.abs(theta) > 1e10
            small = torch.where(huge, zero, theta)
            t = torch.where(huge, 0.5 / theta, sgn / (
                torch.abs(small) + _sqrt64(small * small + 1.0)))
            t = torch.where(live, t, zero)
            c = 1.0 / _sqrt64(t * t + 1.0)
            s = t * c
            tau = s / (1.0 + c)
            app = a[p][p] - t * apq
            aqq = a[q][q] + t * apq
            arp = a[r][p] - s * (a[r][q] + tau * a[r][p])
            arq = a[r][q] + s * (a[r][p] - tau * a[r][q])
            a[p][p], a[q][q] = app, aqq
            a[p][q] = a[q][p] = zero
            a[r][p] = a[p][r] = arp
            a[r][q] = a[q][r] = arq
            for i in range(3):
                vip, viq = v[i][p], v[i][q]
                v[i][p] = vip - s * (viq + tau * vip)
                v[i][q] = viq + s * (vip - tau * viq)
    vals = [a[0][0], a[1][1], a[2][2]]
    cols = [[v[i][j] for i in range(3)] for j in range(3)]
    # Bubble sort of three (a stable sorting network).
    for i, j in ((0, 1), (1, 2), (0, 1)):
        swap = vals[i] > vals[j]
        vals[i], vals[j] = (torch.where(swap, vals[j], vals[i]),
                            torch.where(swap, vals[i], vals[j]))
        cols[i], cols[j] = (
            [torch.where(swap, y, x) for x, y in zip(cols[i], cols[j])],
            [torch.where(swap, x, y) for x, y in zip(cols[i], cols[j])])
    vecs = torch.stack([torch.stack(col, dim=1) for col in cols], dim=2)
    return torch.stack(vals, dim=1).float(), vecs.float()


# -----------------------------------------------------------------------------
# Normals + Darboux frames
# -----------------------------------------------------------------------------

def _radius_neighbors(points: torch.Tensor, radius: float, k: int):
    """First-k neighbours within radius (scan order), slot-0 fill: a self
    ball query, K2f on CUDA tensors.

    points: (N, 3) -> (index (N, k) int64, count (N,) int32)."""
    pts_cf = points.t()[None].contiguous()
    idx, count = ball_query(pts_cf, pts_cf, radius, k)
    return idx[0].long(), count[0]


def _slot_weights(count: torch.Tensor, k: int, dtype) -> torch.Tensor:
    """(N, k, 1) 1.0 on the filled slots, 0.0 on the rest."""
    slots = torch.arange(k, device=count.device)[None, :]
    return (slots < count[:, None]).to(dtype)[..., None]


def estimate_normals(points: torch.Tensor, camera_location: torch.Tensor,
                     radius: float = 0.01, max_nn: int = 30) -> torch.Tensor:
    """Normal estimation via local covariance (Open3D-equivalent semantics:
    smallest-eigenvector of the neighbourhood covariance, oriented TOWARD the
    camera location).  points (N, 3) -> normals (N, 3)."""
    idx, count = _radius_neighbors(points, radius, max_nn)
    nbr = points[idx]                                   # (N, k, 3)
    w = _slot_weights(count, idx.shape[1], points.dtype)
    denom = torch.clamp(count, min=1).to(points.dtype)[:, None]
    mean = _slot_sum(nbr * w) / denom
    diff = (nbr - mean[:, None, :]) * w
    _, vecs = _eigh3(_slot_cov(diff))
    normal = vecs[:, :, 0]                              # smallest eigenvalue
    to_cam = camera_location[None, :] - points
    sign = torch.where(_dot3(normal, to_cam) < 0, -1.0, 1.0)
    return normal * sign[:, None]


def _darboux_parts(points: torch.Tensor, normals: torch.Tensor,
                   curvature_radius: float, max_nn: int):
    """The mean normal (N, 3), the projected covariance's eigenvalues
    (N, 3), the same with the normal-aligned ones penalized, its
    eigenvectors (N, 3, 3) and the neighbour counts."""
    idx, count = _radius_neighbors(points, curvature_radius, max_nn)
    nbr_normals = normals[idx]                          # (N, k, 3)
    w = _slot_weights(count, idx.shape[1], points.dtype)
    denom = torch.clamp(count, min=1).to(points.dtype)[:, None]
    mean_n = _unit(_slot_sum(nbr_normals * w) / denom)

    # M = I - n n^T projects neighbour normals off the mean normal.
    eye = torch.eye(3, dtype=points.dtype, device=points.device)
    m_proj = eye[None] - mean_n[:, :, None] * mean_n[:, None, :]
    projected = _dot3(m_proj[:, None, :, :], nbr_normals[:, :, None, :])
    centroid = _slot_sum(projected * w) / denom
    diff = (projected - centroid[:, None, :]) * w
    vals, vecs = _eigh3(_slot_cov(diff))

    # Minor-curvature axis = in-plane eigenvector with the SMALLEST in-plane
    # eigenvalue (the JAX package's reading of the reference, grading.py):
    # eigenvectors parallel to the normal are skipped.
    align = torch.abs(_dot3(vecs.transpose(1, 2), mean_n[:, None, :]))
    big = torch.amax(vals, dim=1, keepdim=True) + 1.0
    penalized = torch.where(align > 0.5, vals + big, vals)
    return mean_n, vals, penalized, vecs, count


def darboux_frames(points: torch.Tensor, normals: torch.Tensor,
                   curvature_radius: float = 0.01, max_nn: int = 64
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Darboux frame per point (reference:
    data_object_darboux_generator.py:62-92).

    Columns are [x, y, z] = [-normal, -principal_curvature, minor_curvature];
    inv_frame negates x and y.  Points with < 5 neighbours inside
    curvature_radius get zero frames.

    Args:
        points: (N, 3); normals: (N, 3) (unit, any orientation convention).
    Returns:
        frames (N, 3, 3), inv_frames (N, 3, 3).
    """
    mean_n, _, penalized, vecs, count = _darboux_parts(
        points, normals, curvature_radius, max_nn)
    col = torch.argmin(penalized, dim=1)                # first minimum
    minor = torch.gather(vecs, 2, col[:, None, None].expand(-1, 3, 1))[..., 0]
    minor = _unit(minor - _dot3(minor, mean_n)[:, None] * mean_n)
    principal = _cross(minor, mean_n)

    frames = torch.stack([-mean_n, -principal, minor], dim=2)
    inv_frames = torch.stack([mean_n, principal, minor], dim=2)
    ok = (count >= 5)[:, None, None]
    return (torch.where(ok, frames, 0.0), torch.where(ok, inv_frames, 0.0))


def darboux_gaps(points: torch.Tensor, normals: torch.Tensor,
                 curvature_radius: float = 0.01, max_nn: int = 64
                 ) -> torch.Tensor:
    """Relative eigenvalue gap min(l1 - l0, l2 - l1) / l2 of each point's
    projected normal covariance (l0 <= l1 <= l2; 0 where l2 is 0): how far
    the minor axis `darboux_frames` picks is from arbitrary.  It is
    arbitrary on a flat patch (the in-plane l1 and l2 meet) and on a crease
    between flat faces (the minor l1 meets the normal's own l0 = 0, and a
    solver may mix the two).  (N,) f32."""
    _, vals, _, _, _ = _darboux_parts(points, normals, curvature_radius,
                                      max_nn)
    gap = torch.minimum(vals[:, 1] - vals[:, 0], vals[:, 2] - vals[:, 1])
    live = vals[:, 2] > 0
    return torch.where(live, gap / torch.where(live, vals[:, 2], 1.0), 0.0)


# -----------------------------------------------------------------------------
# Vectorized finger_hand_view grading
# -----------------------------------------------------------------------------

def antipodal_scores(local: torch.Tensor, local_normals: torch.Tensor,
                     close_region: torch.Tensor) -> torch.Tensor:
    """Antipodal score (reference: data_object_darboux_generator.py:
    223-247) of gripper-local points: local, local_normals (..., 3, N);
    close_region (..., N)."""
    return antipodal(local[..., 1, :], local_normals[..., 1, :],
                     close_region, NEIGHBOR_DEPTH)


def _reduce_dz(reach, valid, counts, antipodals):
    """Reproduce the reference's stateful dz loop reduction
    (data_object_darboux_generator.py:179-218):

    * `count_last` / `antipodal_last` are the values of the LAST dz (in order
      [-0.02, +0.02, 0]) that reached the close-region stage (reach) /
      passed all checks (valid);
    * sums accumulate only over valid dz, divided by 3;
    * final search = min(sum/3, count_last); antipodal likewise.

    All inputs are lists over the dz axis of (...) tensors.
    """
    def last_where(mask, values):
        out = torch.zeros_like(values[0])
        for m, v in zip(mask, values):
            out = torch.where(m, v, out)
        return out

    def valid_sum(values):
        acc = torch.where(valid[0], values[0], 0.0)
        for m, v in zip(valid[1:], values[1:]):
            acc = acc + torch.where(m, v, 0.0)
        return acc * THIRD

    search = torch.minimum(valid_sum(counts), last_where(reach, counts))
    antip = torch.minimum(valid_sum(antipodals),
                          last_where(valid, antipodals))
    return search, antip


def _box_bounds(bottom_length: float):
    """The f32 box faces the JAX package's weakly typed constants give."""
    return {"finger": _f32(G.FINGER_LENGTH),
            "bottom": -_f32(bottom_length),
            "hbw": _f32(G.HALF_BOTTOM_WIDTH),
            "hbs": _f32(G.HALF_BOTTOM_SPACE)}


def _global_to_local(points: torch.Tensor, frames: torch.Tensor):
    """(C, 4, 4) [R^T | -R^T p; 0 0 0 1] of local frames R at points p."""
    return se3_inv(local_to_global(points, frames))


def local_to_global(points: torch.Tensor, frames: torch.Tensor):
    """(C, 4, 4) [R | p; 0 0 0 1]."""
    top = torch.cat([frames, points[:, :, None]], dim=2)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=points.dtype,
                          device=points.device).expand(points.shape[0], 1, 4)
    return torch.cat([top, bottom], dim=1)


def _grade_chunk(pts_c, frs_c, grid, homo, nrm, bottom_length):
    """One chunk of grade_frames: (C, L*T) search and antipodal scores."""
    b = _box_bounds(bottom_length)
    combined = mat4_mul(grid[None], _global_to_local(pts_c, frs_c)[:, None])
    x, y, z = transform_rows(combined, homo, (0, 1, 2))     # (C, LT, N)
    (ny,) = transform_rows(combined, nrm, (1,), translate=False)
    valid_frame = frs_c.abs().mean(dim=(1, 2)) > 1e-6       # (C,)

    # `local` is already in the SEARCH frame (the grid translates by
    # -length along x), so the close-plane bounds use dl = 0.
    close_plane = (x < b["finger"]) & (x > b["bottom"])
    plane_ok = close_plane.sum(dim=-1) >= DATAGEN_NUM_POINTS_THRESHOLD
    y_back = (y < b["hbw"]) & (y > -b["hbw"])
    y_finger = (((y < b["hbw"]) & (y > b["hbs"]))
                | ((y > -b["hbw"]) & (y < -b["hbs"])))
    y_close = (y < b["hbs"]) & (y > -b["hbs"])
    back_x = close_plane & (x < 0.0)
    counts, antips, reach, valid = [], [], [], []
    for dz in DZ_SEARCH:
        dz = _f32(dz)
        z_ok = ((z < _f32(_f32(G.HALF_HAND_THICKNESS) + dz))
                & (z > _f32(_f32(-G.HALF_HAND_THICKNESS) + dz)))
        back_ok = ((back_x & z_ok & y_back).sum(dim=-1)
                   <= DATAGEN_BACK_COLLISION_THRESHOLD)
        finger_ok = ((close_plane & z_ok & y_finger).sum(dim=-1)
                     <= DATAGEN_FINGER_COLLISION_THRESHOLD)
        close_region = close_plane & z_ok & y_close
        count = close_region.sum(dim=-1).to(x.dtype)
        r = plane_ok & back_ok & finger_ok
        v = r & (count >= DATAGEN_CLOSE_REGION_MIN_POINTS)
        antip = antipodal(y, ny, close_region, NEIGHBOR_DEPTH)
        counts.append(count)
        antips.append(torch.where(v, antip, 0.0))
        reach.append(r)
        valid.append(v)
    search, antip = _reduce_dz(reach, valid, counts, antips)
    return (torch.where(valid_frame[:, None], search, 0.0),
            torch.where(valid_frame[:, None], antip, 0.0))


def grade_frames(points: torch.Tensor, normals: torch.Tensor,
                 frames: torch.Tensor, eval_points_homo: torch.Tensor,
                 chunk: Optional[int] = None,
                 bottom_length: float = DATAGEN_BOTTOM_LENGTH
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grade every (point, frame) against the L x T x dz search grid.

    Args:
        points: (P, 3) grasp points (origins of the local frames).
        normals: (3, N) normals of the evaluated cloud.
        frames: (P, 3, 3) local frames (columns x/y/z).
        eval_points_homo: (4, N) homogeneous cloud (w = 1) to grade against.
        chunk: points per chunk (default: about CHUNK_PAIRS / (L*T*N); the
            result does not depend on it).

    Returns:
        search_score (P, L, T) float, antipodal_score (P, L, T) float —
        the reference's per-point grading tensors
        (data_object_darboux_generator.py:104-128).
    """
    num_l, num_t = len(LENGTH_SEARCH), len(THETA_SEARCH)
    dev = points.device
    grid = torch.from_numpy(search_grid_transforms()).to(dev)
    p, n = points.shape[0], eval_points_homo.shape[1]
    if chunk is None:
        chunk = max(1, CHUNK_PAIRS // (num_l * num_t * max(n, 1)))
    parts = [_grade_chunk(points[c0:c0 + chunk], frames[c0:c0 + chunk],
                          grid, eval_points_homo, normals, bottom_length)
             for c0 in range(0, p, chunk)]
    if not parts:
        empty = torch.zeros((0, num_l, num_t), dtype=points.dtype,
                            device=dev)
        return empty, empty.clone()
    search, antipodal = (torch.cat(x) for x in zip(*parts))
    return (search.reshape(p, num_l, num_t),
            antipodal.reshape(p, num_l, num_t))

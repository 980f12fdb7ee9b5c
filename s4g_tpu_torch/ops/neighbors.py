"""Neighbourhood search ops: pairwise distances, ball query, 3-NN.

Port of s4g_tpu/ops/neighbors.py, with the same semantics:

* ball_query returns, per centroid, the in-range points (f32
  difference-form squared distance strictly < radius^2) in scan order:
  the first K, or with `stratified` and an overfull ball the in-range
  points of rank floor(s * total / K) + 1.  Unfilled slots repeat slot 0;
  with no point in range all slots are 0 and count is 0.
* three_nn returns the 3 smallest squared distances, ascending, ties to the
  lower index, with the distances recomputed in exact difference form.

Routes, as in the JAX package (`neighbors.py:482-490, 684-693`):

* a sorted cloud with N > slab capacity (SA1 at deployment) takes the
  sorted-slab ball query — the CUDA kernel `csrc/ball_query_slab.cu` (K2)
  on CUDA tensors, its plain twin on CPU tensors — with a full-scan
  fallback when a tile's key window overflows (part of the semantics);
  every other ball query is the plain full scan;
* 3-NN with N1 * N2 >= 2^22 selects with the CUDA kernel
  `csrc/three_nn.cu` (K4) (plain twin on CPU); smaller stages select with
  matmul-form distances, the twin of `_three_nn_select_xla`.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import _build

# Sorted-slab geometry of the TPU kernel (pallas/neighbor_kernels.py), kept
# so the port scans the same key windows: a 512-centroid tile scans the
# 4 * 2048 keys starting at its lo_tile * 2048.
BQ_C_TILE = 512
BQ_K_TILE = 2048
BQ_SLAB_TILES = 4
BQ_WINDOW = BQ_SLAB_TILES * BQ_K_TILE

# 3-NN and collision switch to their kernels at this many pairs.
KERNEL_MIN_PAIRS = 1 << 22

# Times the sorted-slab route fell back to the full scan (a tile's
# in-radius keys overflowed its window); read by chip_smoke.py.
SLAB_FALLBACKS = {"overflow": 0}


def _f32(x: float) -> float:
    """`x` rounded to f32, as a Python float (what a weakly typed JAX
    scalar becomes when compared with an f32 array)."""
    return torch.tensor(x, dtype=torch.float32).item()


def invert_permutation(perm: torch.Tensor) -> torch.Tensor:
    """(B, N) permutation per row -> its inverse (a unique-index scatter)."""
    b, n = perm.shape
    inv = torch.empty_like(perm)
    iota = torch.arange(n, dtype=perm.dtype, device=perm.device)
    inv.scatter_(1, perm.long(), iota.expand(b, n))
    return inv


def flat_gather_rows(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Batched row gather (B, M, W) x (B, M2) -> (B, M2, W)."""
    w = x.shape[2]
    return torch.gather(x, 1, index.long()[..., None].expand(-1, -1, w))


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Matmul-form squared distances ||a||^2 + ||b||^2 - 2ab in full f32.

    Args: a (..., 3, M), b (..., 3, N).  Returns (..., M, N)."""
    a2 = (a[..., 0, :] * a[..., 0, :] + a[..., 1, :] * a[..., 1, :]
          + a[..., 2, :] * a[..., 2, :])[..., :, None]
    b2 = (b[..., 0, :] * b[..., 0, :] + b[..., 1, :] * b[..., 1, :]
          + b[..., 2, :] * b[..., 2, :])[..., None, :]
    ab = torch.matmul(a.transpose(-1, -2), b)
    return a2 + b2 - 2.0 * ab


def pairwise_sqdist_exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Difference-form squared distances ((dx*dx + dy*dy) + dz*dz) in f32,
    d = a - b — bit-identical to the CUDA kernels and the JAX reference.
    Range queries must use this form: the matmul form cancels when |a - b|
    is small relative to |a| and flips strict-< tests at the radius.

    Args: a (..., 3, M), b (..., 3, N).  Returns (..., M, N)."""
    dx = a[..., 0, :, None] - b[..., 0, None, :]
    dy = a[..., 1, :, None] - b[..., 1, None, :]
    dz = a[..., 2, :, None] - b[..., 2, None, :]
    return dx * dx + dy * dy + dz * dz


def _select_in_range(mask: torch.Tensor, k: int, stratified: bool):
    """Rank selection over an in-range mask in scan order.

    Args: mask (R, W) bool.
    Returns: local index (R, K) int32 (slot-0 fill; 0 with no hit) and
    count (R,) int32 = min(total, K)."""
    r, w = mask.shape
    cum = torch.cumsum(mask, dim=1, dtype=torch.int32)     # inclusive ranks
    total = cum[:, -1]
    count = torch.clamp(total, max=k)
    slot = torch.arange(k, dtype=torch.int32, device=mask.device)[None, :]
    target = (slot + 1).expand(r, k)
    if stratified:
        strided = (slot * total[:, None]) // k + 1          # exact in int32
        target = torch.where(total[:, None] > k, strided, target)
    # First scan position whose inclusive rank reaches the target.
    idx = torch.searchsorted(cum, target.contiguous(), side="left")
    idx = torch.clamp(idx, max=w - 1).to(torch.int32)
    first = torch.where(count > 0, idx[:, 0], 0)
    idx = torch.where(slot < count[:, None], idx, first[:, None])
    return idx, count


def _first_k_in_range(sqdist: torch.Tensor, radius2: float, k: int,
                      stratified: bool = False):
    """Selection for one chunk of centroids (port of `_first_k_in_range`).

    Args: sqdist (M, N).  Returns index (M, K) int32, count (M,) int32."""
    return _select_in_range(sqdist < _f32(radius2), k, stratified)


def _axis_keys(arr: torch.Tensor, sorted_axis: torch.Tensor) -> torch.Tensor:
    """Sort-key coordinate of channels-first points: (B, 3, N) -> (B, N).
    `sorted_axis` is a (B,) integer tensor (each scene's own axis); the
    keys are gathered on the device, never read back to the host."""
    b, _, n = arr.shape
    ax = sorted_axis.long().reshape(b, 1, 1).expand(b, 1, n)
    return torch.gather(arr, 1, ax)[:, 0]


def _ball_query_full(points, centroids, radius2: float, k: int,
                     chunk: int = 512, stratified: bool = False):
    """Full-scan ball query (the plain route of every non-slab stage and the
    slab route's overflow fallback)."""
    b, _, m = centroids.shape
    idx_out, cnt_out = [], []
    for bi in range(b):
        idx_b, cnt_b = [], []
        for c0 in range(0, m, chunk):
            d = pairwise_sqdist_exact(centroids[bi, :, c0:c0 + chunk],
                                      points[bi])
            i, c = _first_k_in_range(d, radius2, k, stratified)
            idx_b.append(i)
            cnt_b.append(c)
        idx_out.append(torch.cat(idx_b))
        cnt_out.append(torch.cat(cnt_b))
    return torch.stack(idx_out), torch.stack(cnt_out)


def _ball_query_slab_plain(points, centroids, lo_tile, radius2: float,
                           k: int, stratified: bool = False):
    """Plain twin of K2: each 512-centroid tile scans its BQ_WINDOW-key
    window starting at lo_tile * BQ_K_TILE (keys past N never match)."""
    b, _, n = points.shape
    m = centroids.shape[2]
    r2 = _f32(radius2)
    window = torch.arange(BQ_WINDOW, device=points.device)
    idx_out, cnt_out = [], []
    for bi in range(b):
        idx_b, cnt_b = [], []
        for t, c0 in enumerate(range(0, m, BQ_C_TILE)):
            base = lo_tile[bi, t].long() * BQ_K_TILE
            keys = base + window
            real = keys < n
            win = points[bi][:, torch.clamp(keys, max=n - 1)]
            # (c - k)^2 == (k - c)^2 bit for bit, so centroid-major is fine.
            d = pairwise_sqdist_exact(centroids[bi, :, c0:c0 + BQ_C_TILE], win)
            mask = (d < r2) & real[None, :]
            i, c = _select_in_range(mask, k, stratified)
            idx_b.append(torch.where(c[:, None] > 0, i + base.to(torch.int32),
                                     0))
            cnt_b.append(c)
        idx_out.append(torch.cat(idx_b))
        cnt_out.append(torch.cat(cnt_b))
    return torch.stack(idx_out), torch.stack(cnt_out)


def ball_query_fused_slab(points: torch.Tensor, centroids: torch.Tensor,
                          lo_tile: torch.Tensor, radius: float,
                          num_neighbours: int, stratified: bool = False):
    """Sorted-slab ball query (K2).

    The caller guarantees that each scene's points and centroids are sorted
    ascending along one axis and that every in-range point of centroid tile
    t of scene b lies in keys [lo_tile[b, t] * 2048, +8192).

    Args: points (B, 3, N) f32, centroids (B, 3, M) f32, lo_tile
        (B, ceil(M/512)) int32.
    Returns: index (B, M, K) int32 into the sorted order, count (B, M)."""
    b, _, n = points.shape
    m = centroids.shape[2]
    ntile = -(-m // BQ_C_TILE)
    radius2 = radius * radius
    if not _build.on_cuda(points, centroids, lo_tile):
        return _ball_query_slab_plain(points, centroids, lo_tile, radius2,
                                      num_neighbours, stratified)
    _build.check(points, "points", torch.float32, (b, 3, n))
    _build.check(centroids, "centroids", torch.float32, (b, 3, m))
    _build.check(lo_tile, "lo_tile", torch.int32, (b, ntile))
    idx = torch.empty((b, m, num_neighbours), dtype=torch.int32,
                      device=points.device)
    cnt = torch.empty((b, m), dtype=torch.int32, device=points.device)
    _build.launch("ball_query_slab", points, centroids, lo_tile, b, n, m,
                  ntile, _f32(radius2), num_neighbours, int(stratified),
                  idx, cnt)
    return idx, cnt


def slab_windows(pkeys: torch.Tensor, ckeys_s: torch.Tensor, radius2: float,
                 n: int):
    """Key windows of the sorted-slab route (`neighbors.py:346-363`).

    Args: pkeys (B, N) ascending point keys; ckeys_s (B, M) ascending
        centroid keys.
    Returns: lo_tile (B, ntile) int32 and a device bool that is True when
        some tile's in-radius keys do not fit its window."""
    b, m = ckeys_s.shape
    radius = torch.sqrt(torch.tensor(radius2, dtype=torch.float32,
                                     device=pkeys.device))
    padt = (-m) % BQ_C_TILE
    ck_t = torch.cat([ckeys_s, ckeys_s[:, -1:].expand(b, padt)], dim=1)
    tiles = ck_t.reshape(b, -1, BQ_C_TILE)
    t_min = (tiles[:, :, 0] - radius).contiguous()
    t_max = (tiles[:, :, -1] + radius).contiguous()
    pk = pkeys.contiguous()
    lo_t = torch.searchsorted(pk, t_min, side="left")
    hi_t = torch.searchsorted(pk, t_max, side="right")
    n_pad_k = max(-(-n // BQ_K_TILE) * BQ_K_TILE, BQ_WINDOW)
    max_lo = n_pad_k // BQ_K_TILE - BQ_SLAB_TILES
    lo_tile = torch.clamp(lo_t // BQ_K_TILE, 0, max_lo)
    overflow = torch.max(hi_t - lo_tile * BQ_K_TILE) > BQ_WINDOW
    return lo_tile.to(torch.int32), overflow


def _ball_query_sorted_pruned(points, centroids, radius2: float,
                              num_neighbours: int, chunk: int,
                              sorted_axis: torch.Tensor,
                              centroids_sorted: bool = False,
                              stratified: bool = False):
    """Slab-pruned ball query for scenes sorted ascending along
    `sorted_axis` (port of `_ball_query_sorted_pruned`, kernel route).

    The overflow test reads one device bool on the host (one sync): on
    overflow the whole call takes the full scan, which gives the same
    result because the slab result is exactly the full-scan result."""
    b, _, m = centroids.shape
    n = points.shape[2]
    pkeys = _axis_keys(points, sorted_axis)
    ckeys = _axis_keys(centroids, sorted_axis)
    if centroids_sorted:
        corder = None
        cent_s = centroids
        ckeys_s = ckeys
    else:
        corder = torch.argsort(ckeys, dim=1, stable=True)
        cent_s = torch.gather(centroids, 2,
                              corder[:, None, :].expand(b, 3, m))
        ckeys_s = torch.gather(ckeys, 1, corder)
    lo_tile, overflow = slab_windows(pkeys, ckeys_s, radius2, n)
    if bool(overflow):
        SLAB_FALLBACKS["overflow"] += 1
        idx_s, cnt_s = _ball_query_full(points, cent_s, radius2,
                                        num_neighbours, chunk, stratified)
    else:
        idx_s, cnt_s = ball_query_fused_slab(
            points.contiguous(), cent_s.contiguous(), lo_tile,
            radius2 ** 0.5, num_neighbours, stratified)
    if corder is None:
        return idx_s, cnt_s
    inv = invert_permutation(corder)
    idx = flat_gather_rows(idx_s, inv)
    count = torch.gather(cnt_s, 1, inv)
    return idx, count


def ball_query(points: torch.Tensor, centroids: torch.Tensor, radius: float,
               num_neighbours: int, chunk: int = 512,
               sorted_axis: Optional[torch.Tensor] = None,
               slab_capacity: int = 6144, centroids_sorted: bool = False,
               stratified: bool = False):
    """Ball query with reference-CUDA semantics (see module docstring).

    Args:
        points: (B, 3, N); centroids: (B, 3, M).
        radius: strict < on squared distance.
        sorted_axis: optional (B,) integer tensor; the caller guarantees the
            points are sorted ascending along that coordinate.  With
            N > slab_capacity the sorted-slab route runs (K2).
        centroids_sorted: promise that the centroids are sorted the same way.
        stratified: overfull balls take rank-stratified in-range points.

    Returns: index (B, M, K) int32, count (B, M) int32.
    """
    n = points.shape[2]
    radius2 = radius * radius
    if sorted_axis is not None and n > slab_capacity:
        return _ball_query_sorted_pruned(points, centroids, radius2,
                                         num_neighbours, chunk, sorted_axis,
                                         centroids_sorted=centroids_sorted,
                                         stratified=stratified)
    return _ball_query_full(points, centroids, radius2, num_neighbours,
                            chunk, stratified)


def ball_query_grouped(points: torch.Tensor, centroids: torch.Tensor,
                       radius: float, num_neighbours: int, chunk: int = 512,
                       sorted_axis: Optional[torch.Tensor] = None,
                       slab_capacity: int = 6144,
                       centroids_sorted: bool = False,
                       stratified: bool = False):
    """ball_query plus the grouped relative coordinates
    rel = points[index] - centroid, (B, M, K, 3) f32 (0 where count == 0)."""
    b, _, m = centroids.shape
    idx, count = ball_query(points, centroids, radius, num_neighbours, chunk,
                            sorted_axis, slab_capacity, centroids_sorted,
                            stratified)
    g = flat_gather_rows(points.transpose(1, 2).float(),
                         idx.reshape(b, m * num_neighbours))
    rel = (g.reshape(b, m, num_neighbours, 3)
           - centroids.transpose(1, 2)[:, :, None, :].float())
    rel = torch.where(count[..., None, None] > 0, rel, 0.0)
    return idx, count, rel


def _exact_resort3(idx: torch.Tensor, query_xyz: torch.Tensor,
                   key_xyz: torch.Tensor):
    """Recompute exact difference-form distances of the 3 selected keys and
    restore ascending (distance, index) order with a 3-element sorting
    network (port of `_exact_resort3`)."""
    b, n1, _ = idx.shape
    k_t = key_xyz.transpose(1, 2)                          # (B, N2, 3)
    sel = torch.gather(k_t, 1, idx.long().reshape(b, n1 * 3, 1)
                       .expand(-1, -1, 3)).reshape(b, n1, 3, 3)
    diff = sel - query_xyz.transpose(1, 2)[:, :, None, :]
    d = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
         + diff[..., 2] * diff[..., 2])                    # (B, N1, 3)
    vals = [d[..., s] for s in range(3)]
    inds = [idx[..., s] for s in range(3)]

    def swap(a, c):
        do = (vals[a] > vals[c]) | ((vals[a] == vals[c]) & (inds[a] > inds[c]))
        vals[a], vals[c] = (torch.where(do, vals[c], vals[a]),
                            torch.where(do, vals[a], vals[c]))
        inds[a], inds[c] = (torch.where(do, inds[c], inds[a]),
                            torch.where(do, inds[a], inds[c]))

    swap(0, 1)
    swap(1, 2)
    swap(0, 1)
    return (torch.stack(inds, -1).to(torch.int32), torch.stack(vals, -1))


def _three_nn_select_matmul(query_xyz, key_xyz, chunk: int = 2048):
    """Matmul-form 3-NN selection (twin of `_three_nn_select_xla`): three
    rounds of min extraction, ties to the lower index."""
    b, _, n1 = query_xyz.shape
    n2 = key_xyz.shape[2]
    col = torch.arange(n2, device=query_xyz.device)[None, None, :]
    out = []
    for q0 in range(0, n1, chunk):
        d = pairwise_sqdist(query_xyz[:, :, q0:q0 + chunk], key_xyz)
        picks = []
        for _ in range(3):
            i = torch.argmin(d, dim=-1)                     # first minimum
            picks.append(i)
            d = torch.where(col == i[..., None], float("inf"), d)
        out.append(torch.stack(picks, -1))
    return torch.cat(out, dim=1).to(torch.int32)


def _three_nn_plain(query_xyz, key_xyz, chunk: int = 2048):
    """Plain twin of K4: exact difference-form distances, 3 smallest by
    (distance, index)."""
    b, _, n1 = query_xyz.shape
    n2 = key_xyz.shape[2]
    col = torch.arange(n2, device=query_xyz.device)[None, None, :]
    idx_out, dist_out = [], []
    for q0 in range(0, n1, chunk):
        d = pairwise_sqdist_exact(query_xyz[:, :, q0:q0 + chunk], key_xyz)
        picks, dists = [], []
        for _ in range(3):
            mn = torch.amin(d, dim=-1, keepdim=True)
            i = torch.where(d == mn, col, n2).amin(dim=-1)   # lowest index
            picks.append(i)
            dists.append(mn[..., 0])
            d = torch.where(col == i[..., None], float("inf"), d)
        idx_out.append(torch.stack(picks, -1))
        dist_out.append(torch.stack(dists, -1))
    return (torch.cat(idx_out, dim=1).to(torch.int32),
            torch.cat(dist_out, dim=1))


def three_nn_fused(query_xyz: torch.Tensor, key_xyz: torch.Tensor):
    """3-NN selection (K4): (B, 3, N1) x (B, 3, N2) f32 -> index (B, N1, 3)
    int32 and exact squared distances (B, N1, 3), ascending, ties to the
    lowest key index.  CUDA tensors launch `csrc/three_nn.cu`; CPU tensors
    take `_three_nn_plain`."""
    b, _, n1 = query_xyz.shape
    n2 = key_xyz.shape[2]
    if n2 < 3:
        raise ValueError(f"3-NN needs at least 3 keys, got {n2}")
    if not _build.on_cuda(query_xyz, key_xyz):
        return _three_nn_plain(query_xyz, key_xyz)
    _build.check(query_xyz, "query_xyz", torch.float32, (b, 3, n1))
    _build.check(key_xyz, "key_xyz", torch.float32, (b, 3, n2))
    idx = torch.empty((b, n1, 3), dtype=torch.int32, device=query_xyz.device)
    dist = torch.empty((b, n1, 3), dtype=torch.float32,
                       device=query_xyz.device)
    _build.launch("three_nn", query_xyz, key_xyz, b, n1, n2, idx, dist)
    return idx, dist


def three_nn(query_xyz: torch.Tensor, key_xyz: torch.Tensor,
             num_neighbors: int = 3, chunk: int = 2048):
    """3 nearest neighbours of each query point among the key points.

    Args: query_xyz (B, 3, N1), key_xyz (B, 3, N2).
    Returns: index (B, N1, 3) int32, ascending distance, ties to the lower
        index; distance (B, N1, 3) exact difference-form squared distances.
    """
    if num_neighbors != 3:
        raise ValueError("three_nn is hard-coded to K=3")
    if query_xyz.shape[2] * key_xyz.shape[2] >= KERNEL_MIN_PAIRS:
        idx, _ = three_nn_fused(query_xyz.contiguous(), key_xyz.contiguous())
    else:
        idx = _three_nn_select_matmul(query_xyz, key_xyz, chunk)
    return _exact_resort3(idx, query_xyz, key_xyz)

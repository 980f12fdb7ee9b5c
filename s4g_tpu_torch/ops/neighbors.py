"""Neighbourhood search ops: pairwise distances, ball query, 3-NN.

Port of s4g_tpu/ops/neighbors.py, with the same semantics:

* ball_query returns, per centroid, the in-range points (f32
  difference-form squared distance strictly < radius^2) in scan order:
  the first K, or with `stratified` and an overfull ball the in-range
  points of rank floor(s * total / K) + 1.  Unfilled slots repeat slot 0;
  with no point in range all slots are 0 and count is 0.
* three_nn returns the 3 smallest squared distances, ascending, ties to the
  lower index, with the distances recomputed in exact difference form.

Routes, as in the JAX package's "auto" (`neighbors.py:482-496, 684-693`):

* a sorted cloud with N > slab capacity (SA1 at deployment) takes the
  sorted-slab ball query — the CUDA kernel `csrc/ball_query_slab.cu` (K2)
  on CUDA tensors, its plain twin on CPU tensors — with a full-scan
  fallback when a tile's key window overflows (part of the semantics);
* every other ball query, and that fallback, is the full scan — the CUDA
  kernel `csrc/ball_query_full.cu` (K2f) on CUDA tensors, its plain twin
  `_ball_query_full` on CPU tensors.  Handed the sort promise, K2f checks
  it on the card and scans only each ball's slab where it holds.  The
  slab and full-scan selections are the same keys bit for bit, so the
  route never changes a result;
* 3-NN with N1 * N2 >= 2^22 selects with the CUDA kernel
  `csrc/three_nn.cu` (K4) (plain twin on CPU); smaller stages select with
  matmul-form distances, the twin of `_three_nn_select_xla`;
* the radius-outlier counts of preprocessing launch `csrc/radius_outlier.cu`
  (K9) on CUDA tensors, its plain twin `_radius_outlier_counts_plain` on
  CPU tensors.
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
    """Full-scan ball query in plain PyTorch: K2f's twin (CPU tensors) and
    its oracle on the card."""
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


def ball_query_full_scan(points: torch.Tensor, centroids: torch.Tensor,
                         radius: float, num_neighbours: int,
                         stratified: bool = False,
                         sorted_axis: Optional[torch.Tensor] = None):
    """Full-scan ball query (K2f): every centroid tests every point.

    Args: points (B, 3, N) f32; centroids (B, 3, M) f32; sorted_axis
        optional (B,) integer tensor: the caller promises that each scene's
        points ascend along that coordinate.
    Returns: index (B, M, K) int32, count (B, M) int32.  CUDA tensors
    launch `csrc/ball_query_full.cu`, which checks the promise on the card
    and, where it holds, tests only the keys of each ball's slab; CPU
    tensors take `_ball_query_full`, promise or not.  The result is the
    same either way."""
    b, _, n = points.shape
    m = centroids.shape[2]
    radius2 = radius * radius
    if n < 1 or m < 1 or num_neighbours < 1:
        raise ValueError(f"ball query needs N, M, K >= 1 (N={n}, M={m}, "
                         f"K={num_neighbours})")
    operands = (points, centroids) + (() if sorted_axis is None
                                      else (sorted_axis,))
    if not _build.on_cuda(*operands):
        return _ball_query_full(points, centroids, radius2, num_neighbours,
                                stratified=stratified)
    _build.check(points, "points", torch.float32, (b, 3, n))
    _build.check(centroids, "centroids", torch.float32, (b, 3, m))
    axes = None
    if sorted_axis is not None:
        axes = sorted_axis.to(torch.int32).reshape(b).contiguous()
    idx = torch.empty((b, m, num_neighbours), dtype=torch.int32,
                      device=points.device)
    cnt = torch.empty((b, m), dtype=torch.int32, device=points.device)
    _build.launch("ball_query_full", points, centroids, axes, b, n, m,
                  _f32(radius2), num_neighbours, int(stratified), idx, cnt)
    return idx, cnt


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
    """Key windows of the sorted-slab route (`neighbors.py:346-363`): the
    tile spans widen by sqrt(f32(radius2)), as the JAX route does.

    Args: pkeys (B, N) ascending point keys; ckeys_s (B, M) ascending
        centroid keys.
    Returns: lo_tile (B, ntile) int32 and a device bool that is True when
        some tile's in-radius keys do not fit its window."""
    radius = torch.sqrt(torch.tensor(radius2, dtype=torch.float32,
                                     device=pkeys.device))
    return tile_windows(pkeys, ckeys_s, radius, n)


def tile_windows(pkeys: torch.Tensor, ckeys_s: torch.Tensor,
                 radius: torch.Tensor, n: int):
    """Windows of 512-centroid tiles over the sorted keys: searchsorted for
    each tile's [first - radius, last + radius] span, the window start
    clamped to a 2048-key boundary, and the overflow flag.  `radius` is an
    f32 tensor: callers differ in how they round it (`slab_windows`,
    `sa_fused.sa1_slab_setup`), and at a boundary key that decides the
    window."""
    b, m = ckeys_s.shape
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


def _ball_query_sorted_pruned(points, centroids, radius: float,
                              num_neighbours: int, sorted_axis: torch.Tensor,
                              centroids_sorted: bool = False,
                              stratified: bool = False):
    """Slab-pruned ball query for scenes sorted ascending along
    `sorted_axis` (port of `_ball_query_sorted_pruned`, kernel route).

    The overflow test reads one device bool on the host (one sync): on
    overflow the whole call takes the full scan (K2f), which gives the same
    result because the slab result is exactly the full-scan result."""
    b, _, m = centroids.shape
    n = points.shape[2]
    radius2 = radius * radius
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
        idx_s, cnt_s = ball_query_full_scan(
            points.contiguous(), cent_s.contiguous(), radius, num_neighbours,
            stratified, sorted_axis)
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
               num_neighbours: int, sorted_axis: Optional[torch.Tensor] = None,
               slab_capacity: int = 6144, centroids_sorted: bool = False,
               stratified: bool = False):
    """Ball query with reference-CUDA semantics (see module docstring).

    Args:
        points: (B, 3, N); centroids: (B, 3, M).
        radius: strict < on squared distance.
        sorted_axis: optional (B,) integer tensor; the caller guarantees the
            points are sorted ascending along that coordinate.  With
            N > slab_capacity the sorted-slab route runs (K2); every other
            query is the full scan (K2f), which is handed the promise and
            tests only each ball's slab where it holds.
        centroids_sorted: promise that the centroids are sorted the same way.
        stratified: overfull balls take rank-stratified in-range points.

    Returns: index (B, M, K) int32, count (B, M) int32.
    """
    if sorted_axis is not None and points.shape[2] > slab_capacity:
        return _ball_query_sorted_pruned(points, centroids, radius,
                                         num_neighbours, sorted_axis,
                                         centroids_sorted=centroids_sorted,
                                         stratified=stratified)
    return ball_query_full_scan(points.contiguous(), centroids.contiguous(),
                                radius, num_neighbours, stratified,
                                sorted_axis)


def ball_query_grouped(points: torch.Tensor, centroids: torch.Tensor,
                       radius: float, num_neighbours: int,
                       sorted_axis: Optional[torch.Tensor] = None,
                       slab_capacity: int = 6144,
                       centroids_sorted: bool = False,
                       stratified: bool = False):
    """ball_query plus the grouped relative coordinates
    rel = points[index] - centroid, (B, M, K, 3) f32 (0 where count == 0)."""
    b, _, m = centroids.shape
    idx, count = ball_query(points, centroids, radius, num_neighbours,
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


# K4's key split: a block takes NN_TILE_Q queries (128 threads x 4), and the
# key range is cut so that a call puts at least NN_BLOCKS_PER_SM blocks on
# each SM of the card (16 warps to hide the distance chains' latency), in
# chunks of a multiple of NN_CHUNK_ALIGN keys.
NN_TILE_Q = 512
NN_BLOCKS_PER_SM = 4
NN_CHUNK_ALIGN = 64


def sm_count(device) -> int:
    """Streaming multiprocessors of CUDA device `device`."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def three_nn_key_chunk(b: int, n1: int, n2: int, sms: int) -> int:
    """Keys per block of K4 for a (B, N1) x (B, N2) call on a card with
    `sms` SMs; n2 when one chunk already fills the card."""
    min_blocks = NN_BLOCKS_PER_SM * sms
    tiles = b * -(-n1 // NN_TILE_Q)
    split = -(-min_blocks // tiles)
    chunk = -(-n2 // split)
    chunk = -(-chunk // NN_CHUNK_ALIGN) * NN_CHUNK_ALIGN
    # Rounding up may leave too few chunks: shorten until the card is full.
    while chunk > NN_CHUNK_ALIGN and tiles * -(-n2 // chunk) < min_blocks:
        chunk -= NN_CHUNK_ALIGN
    return min(chunk, n2)


def _top3(d: torch.Tensor, ids: torch.Tensor):
    """The 3 smallest entries of d (..., W) by (distance, id): three rounds
    of min extraction, each taking the lowest id among the equal minima
    and removing that entry.  Returns ids and distances (..., 3)."""
    big = torch.iinfo(ids.dtype).max
    picks, dists = [], []
    for _ in range(3):
        mn = torch.amin(d, dim=-1, keepdim=True)
        i = torch.where(d == mn, ids, big).amin(dim=-1, keepdim=True)
        picks.append(i[..., 0])
        dists.append(mn[..., 0])
        d = torch.where(ids == i, float("inf"), d)
    return torch.stack(picks, -1), torch.stack(dists, -1)


def _three_nn_plain(query_xyz, key_xyz, chunk: int | None = None):
    """Plain twin of K4, in the kernel's steps: exact difference-form
    distances; the keys cut in `chunk`-key ranges (default: one range of
    all keys; `three_nn_key_chunk` gives the kernel's split), each range's
    3 smallest by (distance, index), then the 3 smallest of those partials
    by (distance, index).  Each partial is exact on its range, so the
    result is the 3 smallest of all keys whatever the chunk."""
    n1, n2 = query_xyz.shape[2], key_xyz.shape[2]
    if chunk is None:
        chunk = n2
    col = torch.arange(n2, device=query_xyz.device)[None, None, :]
    idx_out, dist_out = [], []
    for q0 in range(0, n1, 2048):
        q = query_xyz[:, :, q0:q0 + 2048]
        parts_i, parts_d = [], []
        for k0 in range(0, n2, chunk):
            d = pairwise_sqdist_exact(q, key_xyz[:, :, k0:k0 + chunk])
            ids = col[..., k0:k0 + chunk].expand_as(d)
            if d.shape[-1] < 3:    # a short last range: pad with misses
                pad = 3 - d.shape[-1]
                d = torch.cat([d, d.new_full((*d.shape[:-1], pad),
                                             float("inf"))], -1)
                ids = torch.cat([ids, ids.new_full((*ids.shape[:-1], pad),
                                                   n2)], -1)
            i, dd = _top3(d, ids)
            parts_i.append(i)
            parts_d.append(dd)
        i, dd = _top3(torch.cat(parts_d, -1), torch.cat(parts_i, -1))
        idx_out.append(i)
        dist_out.append(dd)
    return (torch.cat(idx_out, dim=1).to(torch.int32),
            torch.cat(dist_out, dim=1))


def three_nn_fused(query_xyz: torch.Tensor, key_xyz: torch.Tensor):
    """3-NN selection (K4): (B, 3, N1) x (B, 3, N2) f32 -> index (B, N1, 3)
    int32 and exact squared distances (B, N1, 3), ascending, ties to the
    lowest key index.  CUDA tensors launch `csrc/three_nn.cu` (one call:
    the key chunks of `three_nn_key_chunk`, then their merge into the
    result when there is more than one chunk); CPU tensors take
    `_three_nn_plain`."""
    b, _, n1 = query_xyz.shape
    n2 = key_xyz.shape[2]
    if n2 < 3:
        raise ValueError(f"3-NN needs at least 3 keys, got {n2}")
    if not _build.on_cuda(query_xyz, key_xyz):
        return _three_nn_plain(query_xyz, key_xyz)
    _build.check(query_xyz, "query_xyz", torch.float32, (b, 3, n1))
    _build.check(key_xyz, "key_xyz", torch.float32, (b, 3, n2))
    dev = query_xyz.device
    chunk = three_nn_key_chunk(b, n1, n2, sm_count(dev))
    nsplit = -(-n2 // chunk)
    pidx = pdist = None
    if nsplit > 1:   # the chunks' partial top-3s, merged by the same call
        pidx = torch.empty((b, nsplit, 3, n1), dtype=torch.int32, device=dev)
        pdist = torch.empty((b, nsplit, 3, n1), dtype=torch.float32,
                            device=dev)
    idx = torch.empty((b, n1, 3), dtype=torch.int32, device=dev)
    dist = torch.empty((b, n1, 3), dtype=torch.float32, device=dev)
    _build.launch("three_nn", query_xyz, key_xyz, b, n1, n2, chunk, pidx,
                  pdist, idx, dist)
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


# K9's tiles: a block takes RO_TILE_Q queries and RO_TILE_K keys
# (`csrc/radius_outlier.cu`).
RO_TILE_Q = 512
RO_TILE_K = 1024


def _valid_tiles(valid: torch.Tensor, tile: int) -> list:
    """The valid rows of each `tile`-row tile that holds one, ascending."""
    idx = torch.nonzero(valid)[:, 0]
    edges = torch.searchsorted(idx, torch.arange(
        0, valid.shape[0] + tile, tile, device=valid.device)).tolist()
    return [idx[a:b] for a, b in zip(edges[:-1], edges[1:]) if b > a]


def _radius_outlier_counts_plain(points: torch.Tensor, valid: torch.Tensor,
                                 r2: float, tile_q: int = RO_TILE_Q,
                                 tile_k: int = RO_TILE_K) -> torch.Tensor:
    """Plain twin of K9, in its tiles and its rounding: for each valid
    query, the valid keys j with d < r2, itself included, where every f32
    operation is rounded on its own:
    |p|^2 = (x*x + y*y) + z*z, q.k = (q0*k0 + q1*k1) + q2*k2,
    d = (|q|^2 + |k|^2) - 2*(q.k).  Tiles without a valid row are skipped
    (an invalid key never counts), and the tiles' integer partial counts are
    summed, so the counts do not depend on the tiles.

    Args: points (N, 3) f32; valid (N,) bool; r2 an f32 value.
    Returns: counts (N,) int32, 0 for an invalid row."""
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    sq = (x * x + y * y) + z * z
    counts = torch.zeros(points.shape[0], dtype=torch.int32,
                         device=points.device)
    key_tiles = _valid_tiles(valid, tile_k)
    for qi in _valid_tiles(valid, tile_q):
        q = points[qi]
        for ki in key_tiles:
            k = points[ki]
            dot = ((q[:, 0, None] * k[None, :, 0]
                    + q[:, 1, None] * k[None, :, 1])
                   + q[:, 2, None] * k[None, :, 2])
            d = (sq[qi, None] + sq[None, ki]) - 2.0 * dot
            counts[qi] += (d < r2).sum(dim=1, dtype=torch.int32)
    return counts


def radius_outlier_counts(points: torch.Tensor, valid: torch.Tensor,
                          radius: float, min_neighbors: int):
    """Radius-outlier test (K9): for each valid row, the valid rows within
    `radius` (strict < on the f32 rounding of radius * radius), itself
    included, on matmul-form f32 distances in the rounding that
    `_radius_outlier_counts_plain` states.

    Args: points (N, 3) f32; valid (N,) bool.
    Returns: keep (N,) bool = valid & (count >= min_neighbors), and counts
    (N,) int32 (0 for an invalid row).  CUDA tensors launch
    `csrc/radius_outlier.cu` (one call, no host synchronisation); CPU
    tensors take `_radius_outlier_counts_plain`."""
    n = points.shape[0]
    if n < 1:
        raise ValueError("the radius-outlier test needs N >= 1")
    r2 = _f32(radius * radius)
    if not _build.on_cuda(points, valid):
        counts = _radius_outlier_counts_plain(points, valid, r2)
        return valid & (counts >= min_neighbors), counts
    _build.check(points, "points", torch.float32, (n, 3))
    _build.check(valid, "valid", torch.bool, (n,))
    counts = torch.empty(n, dtype=torch.int32, device=points.device)
    keep = torch.empty(n, dtype=torch.bool, device=points.device)
    _build.launch("radius_outlier", points, valid, n, r2, int(min_neighbors),
                  counts, keep)
    return keep, counts

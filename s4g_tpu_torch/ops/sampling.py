"""Farthest point sampling (FPS).

Port of s4g_tpu/ops/sampling.py.  Semantics:

* exact FPS starts at point 0, relaxes the per-point min-distance to the
  selected set in f32 difference form and picks the argmax, ties to the
  lowest index;
* sharded FPS (FPS_SHARDS = G > 1 with SORT_POINTS) runs exact FPS inside
  each contiguous N/G slice for M/G centroids and returns shard-major
  global indices; `sort_local` then sorts each shard's picks.

Routes: on a CUDA tensor every FPS is a kernel — the 128-shard case
`csrc/fps_lane.cu` (K1), exact FPS and every other shard count
`csrc/fps_exact.cu` (K6).  On a CPU tensor they take the plain twins
`_fps_sharded_plain` and `_fps_plain`.  A sorted forward whose SA stages
all take 128-shard FPS computes every stage's indices at once
(`fps_lane_nested`: one K1 launch on the card, `_fps_nested_plain` on the
CPU).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from .. import _build

_LANES = 128


def _fps_plain(points: torch.Tensor, num_centroids: int) -> torch.Tensor:
    """Exact FPS, (B, 3, N) -> (B, M) int32 (port of `_fps_xla`)."""
    b, _, n = points.shape
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    min_d = torch.full((b, n), float("inf"), dtype=points.dtype,
                       device=points.device)
    out = torch.zeros((b, num_centroids), dtype=torch.int32,
                      device=points.device)
    last = torch.zeros((b, 1), dtype=torch.int64, device=points.device)
    for i in range(1, num_centroids):
        dx = x - torch.gather(x, 1, last)
        dy = y - torch.gather(y, 1, last)
        dz = z - torch.gather(z, 1, last)
        min_d = torch.minimum(min_d, dx * dx + dy * dy + dz * dz)
        last = torch.argmax(min_d, dim=1, keepdim=True)   # first max
        out[:, i] = last[:, 0].to(torch.int32)
    return out


def _shard_offsets(num_shards: int, ns: int, device) -> torch.Tensor:
    return (torch.arange(num_shards, dtype=torch.int32, device=device)
            * ns)[None, :, None]


def _fps_sharded_plain(points: torch.Tensor, num_centroids: int,
                       num_shards: int = _LANES) -> torch.Tensor:
    """Plain twin of K1 and of K6's G-shard case: exact FPS per contiguous
    shard (port of `_fps_sharded_xla`), shard-major global indices (B, M)
    int32."""
    b, _, n = points.shape
    g = num_shards
    ns, m_g = n // g, num_centroids // g
    shards = points.reshape(b, 3, g, ns).permute(0, 2, 1, 3) \
        .reshape(b * g, 3, ns)
    loc = _fps_plain(shards, m_g)
    out = loc.reshape(b, g, m_g) + _shard_offsets(g, ns, points.device)
    return out.reshape(b, num_centroids)


def fps_lane_sharded(points: torch.Tensor,
                     num_centroids: int) -> torch.Tensor:
    """128-shard FPS (K1): (B, 3, N) f32 -> (B, M) int32 shard-major global
    indices.  Requires 128 | N, 128 | M and N/128 >= M/128.  CUDA tensors
    launch `csrc/fps_lane.cu`; CPU tensors take `_fps_sharded_plain`."""
    b, _, n = points.shape
    if not fps_sharding_applies(n, num_centroids, _LANES):
        raise ValueError(f"128-shard FPS needs 128 | N, 128 | M and "
                         f"N >= M (N={n}, M={num_centroids})")
    if not _build.on_cuda(points):
        return _fps_sharded_plain(points, num_centroids)
    _build.check(points, "points", torch.float32, (b, 3, n))
    out = torch.empty((b, num_centroids), dtype=torch.int32,
                      device=points.device)
    _build.launch("fps_lane", points, b, n, 0, num_centroids, 0, 0, out,
                  None, None)
    return out


# The nested K1 kernel keeps a shard's points in registers, 8 per lane of a
# warp, and runs up to 3 stages in one launch.
FPS_NESTED_MAX_SHARD = 256
FPS_NESTED_MAX_STAGES = 3


def fps_nesting_applies(n: int, centroids: Sequence[int],
                        num_shards: int) -> bool:
    """True iff `fps_lane_nested` computes the FPS of SA stages taking
    `centroids` from an N-point cloud: 128 shards at every stage
    (`fps_sharding_applies` for each stage's input and M), at most 3
    stages, and shards of at most FPS_NESTED_MAX_SHARD points."""
    sizes = (n, *centroids)
    return (num_shards == _LANES
            and 1 <= len(centroids) <= FPS_NESTED_MAX_STAGES
            and n // num_shards <= FPS_NESTED_MAX_SHARD
            and all(fps_sharding_applies(a, m, num_shards)
                    for a, m in zip(sizes, sizes[1:])))


def _sort_shards(index: torch.Tensor, num_shards: int) -> torch.Tensor:
    """sort_local: each shard's picks in ascending order."""
    b, m = index.shape
    return torch.sort(index.reshape(b, num_shards, m // num_shards),
                      dim=2)[0].reshape(b, m)


def _fps_nested_plain(points: torch.Tensor,
                      centroids: Sequence[int]) -> list:
    """Plain twin of nested K1: the per-stage route chained — 128-shard FPS
    with sort_local, then the picks' coordinates gathered as the next
    stage's cloud."""
    b = points.shape[0]
    out, cur = [], points
    for m in centroids:
        index = _sort_shards(_fps_sharded_plain(cur, m), _LANES)
        out.append(index)
        cur = torch.gather(cur, 2, index.long()[:, None, :].expand(b, 3, m))
    return out


def fps_lane_nested(points: torch.Tensor, centroids: Sequence[int]) -> list:
    """Nested 128-shard FPS (K1) of the SA stages of a sorted forward:
    (B, 3, N) f32 -> one (B, M_s) int32 index per stage, each what
    `farthest_point_sample(..., num_shards=128, sort_local=True)` gives on
    the previous stage's picks (stage 1: on `points`).  Requires
    `fps_nesting_applies(N, centroids, 128)`.  CUDA tensors launch
    `csrc/fps_lane.cu` once for every stage; CPU tensors take
    `_fps_nested_plain`."""
    b, _, n = points.shape
    if not fps_nesting_applies(n, centroids, _LANES):
        raise ValueError(f"nested 128-shard FPS does not apply to N={n}, "
                         f"M={tuple(centroids)}")
    if not _build.on_cuda(points):
        return _fps_nested_plain(points, centroids)
    _build.check(points, "points", torch.float32, (b, 3, n))
    outs = [torch.empty((b, m), dtype=torch.int32, device=points.device)
            for m in centroids]
    pad = FPS_NESTED_MAX_STAGES - len(centroids)
    _build.launch("fps_lane", points, b, n, len(centroids),
                  *centroids, *([0] * pad), *outs, *([None] * pad))
    return outs


# K6's exchange of each step's winner between the blocks of a chain's
# cluster: "push" (st.async into every peer's shared memory, completing on
# its mbarrier) or "barrier" (a cluster barrier, then reads of every peer's
# slot).  The model takes "push"; "barrier" is kept only for chip_smoke.py
# to time the two against each other.
FPS_EXCHANGES = ("push", "barrier")


def fps_exact_plan(ns: int, exchange: str = "push") -> tuple:
    """K6's plan on this card for chains of `ns` points: (blocks per chain,
    scratch floats each block needs past its registers).  The blocks are
    the fewest, up to 16, that leave each at most 2,048 points, halved
    while such a cluster cannot be resident."""
    plan = (ctypes.c_int * 2)()
    _build.query("fps_exact_plan", ns, FPS_EXCHANGES.index(exchange),
                 ctypes.cast(plan, ctypes.c_void_p))
    return plan[0], plan[1]


def _fps_exact_launch(points: torch.Tensor, num_centroids: int,
                      num_shards: int, exchange: str = "push"
                      ) -> torch.Tensor:
    """Launch K6 on B * G chains, each a cluster of blocks: exact FPS over
    each contiguous N/G slice for M/G centroids, shard-major global indices
    (B, M) int32.  A block whose slice is longer than its registers hold
    keeps the rest of its min-distances in an f32 scratch buffer allocated
    here."""
    b, _, n = points.shape
    _build.check(points, "points", torch.float32, (b, 3, n))
    ns = n // num_shards
    blocks, per_block = fps_exact_plan(ns, exchange)
    spill = None
    if per_block:
        spill = torch.empty(b * num_shards * blocks * per_block,
                            dtype=torch.float32, device=points.device)
    out = torch.empty((b, num_centroids), dtype=torch.int32,
                      device=points.device)
    _build.launch("fps_exact", points, b, n, num_shards,
                  num_centroids // num_shards, FPS_EXCHANGES.index(exchange),
                  spill, out)
    return out


def fps_exact(points: torch.Tensor, num_centroids: int) -> torch.Tensor:
    """Exact FPS over B whole scenes (K6): (B, 3, N) f32 -> (B, M) int32,
    slot 0 is point 0.  CUDA tensors launch `csrc/fps_exact.cu`; CPU
    tensors take `_fps_plain`."""
    if points.shape[2] < 1 or num_centroids < 1:
        raise ValueError(f"FPS needs N >= 1 and M >= 1 (N={points.shape[2]}, "
                         f"M={num_centroids})")
    if not _build.on_cuda(points):
        return _fps_plain(points, num_centroids)
    return _fps_exact_launch(points, num_centroids, 1)


def fps_sharded(points: torch.Tensor, num_centroids: int,
                num_shards: int) -> torch.Tensor:
    """G-shard FPS (K6): exact FPS in each of the G contiguous N/G slices of
    a scene for M/G centroids, (B, 3, N) f32 -> (B, M) int32 shard-major
    global indices.  Requires `fps_sharding_applies(N, M, G)`.  CUDA tensors
    launch `csrc/fps_exact.cu` with B * G chains; CPU tensors take
    `_fps_sharded_plain`."""
    n = points.shape[2]
    if not fps_sharding_applies(n, num_centroids, num_shards):
        raise ValueError(f"{num_shards}-shard FPS needs G | N, G | M and "
                         f"N >= M (N={n}, M={num_centroids})")
    if not _build.on_cuda(points):
        return _fps_sharded_plain(points, num_centroids, num_shards)
    return _fps_exact_launch(points, num_centroids, num_shards)


def fps_sharding_applies(n: int, num_centroids: int,
                         num_shards: int) -> bool:
    """True iff farthest_point_sample(num_shards=G) takes the sharded path
    for these sizes (callers use it to know whether the output index order
    is per-shard, e.g. for sortedness invariants)."""
    return (num_shards > 1 and n % num_shards == 0
            and num_centroids % num_shards == 0
            and num_centroids >= num_shards
            and n // num_shards >= num_centroids // num_shards)


def farthest_point_sample(points: torch.Tensor, num_centroids: int,
                          num_shards: int = 1,
                          sort_local: bool = False) -> torch.Tensor:
    """Farthest point sampling.

    Args:
        points: (B, 3, N) xyz, channels-first.
        num_centroids: number of centroids M to select.
        num_shards: 1 = exact FPS (K6).  G > 1 = sharded FPS when
            `fps_sharding_applies` (K1 at G = 128, K6 otherwise); exact FPS
            when it does not.
        sort_local: sharded path only — sort each shard's picks by index,
            so a cloud sorted along an axis yields sorted centroids.

    Returns:
        (B, M) int32 centroid indices.
    """
    n = points.shape[2]
    if fps_sharding_applies(n, num_centroids, num_shards):
        if num_shards == _LANES:
            out = fps_lane_sharded(points, num_centroids)
        else:
            out = fps_sharded(points, num_centroids, num_shards)
        return _sort_shards(out, num_shards) if sort_local else out
    return fps_exact(points, num_centroids)

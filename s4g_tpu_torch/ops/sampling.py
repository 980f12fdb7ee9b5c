"""Farthest point sampling (FPS).

Port of s4g_tpu/ops/sampling.py.  Semantics:

* exact FPS starts at point 0, relaxes the per-point min-distance to the
  selected set in f32 difference form and picks the argmax, ties to the
  lowest index;
* sharded FPS (deployment, FPS_SHARDS=128 with SORT_POINTS) runs exact FPS
  inside each contiguous N/128 slab for M/128 centroids and returns
  shard-major global indices; `sort_local` then sorts each shard's picks.

Routes: the 128-shard case is the CUDA kernel `csrc/fps_lane.cu` (K1) on a
CUDA tensor and its plain twin `_fps_sharded_plain` on a CPU tensor.  Exact
FPS (the non-sharded case) is plain PyTorch on every device, as it is plain
XLA in the JAX package off the TPU.
"""

from __future__ import annotations

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
    """Plain twin of K1: exact FPS per contiguous shard (port of
    `_fps_sharded_xla`), shard-major global indices (B, M) int32."""
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
    _build.launch("fps_lane", points, b, n, num_centroids, out)
    return out


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
        num_centroids: number of centroids M to select (M <= N).
        num_shards: 1 = exact FPS.  128 = sharded FPS (K1) when
            `fps_sharding_applies`; exact FPS otherwise.  Other shard counts
            are the JAX package's G-shard kernel, not ported yet.
        sort_local: sharded path only — sort each shard's picks by index,
            so a cloud sorted along an axis yields sorted centroids.

    Returns:
        (B, M) int32 centroid indices.
    """
    n = points.shape[2]
    if fps_sharding_applies(n, num_centroids, num_shards):
        if num_shards != _LANES:
            raise NotImplementedError(
                f"sharded FPS with {num_shards} shards is the G-shard "
                "kernel (K6 in ROADMAP.md §2), not ported yet")
        out = fps_lane_sharded(points, num_centroids)
        if sort_local:
            m_g = num_centroids // num_shards
            out = torch.sort(out.reshape(-1, num_shards, m_g), dim=2)[0] \
                .reshape(-1, num_centroids)
        return out
    return _fps_plain(points, num_centroids)

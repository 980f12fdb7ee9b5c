"""Fused set-abstraction stage 1 (port of
s4g_tpu/ops/pallas/sa_fused_kernels.py).

One kernel per stage: the sorted-slab ball query, the rel-xyz grouping, the
stage's 3-layer SharedMLP with BatchNorm folded into each layer, and the
max over the K neighbours.  The JAX package runs SA1 this way at batch >= 2
(`pn2_modules.py:175-202`); the port follows that rule
(`models/pn2_modules.py`).  The numbers are the TPU kernel's:

* selection is K2's (`ops/neighbors.py`) on the tile's key window;
* rel = key - centroid in exact f32, then rounded to bf16;
* layer 1 is ((rx*w0 + ry*w1) + rz*w2) + b1 in f32 with bf16-rounded
  weights, then ReLU and bf16;
* layers 2 and 3 multiply bf16 by bf16 with f32 sums, add the f32 bias and
  apply ReLU; layer 2's output is rounded to bf16, layer 3's stays f32;
* the output is the max over the K slots, (B, M, C3) f32, and a zero row
  where no key is in range.

`sa1_stage` is the whole route as the model runs it: the keys along the
sort axis, the key windows, one host read of their overflow flag, then
either the kernel or, on overflow, a full-scan ball query and the chain in
torch with the same folded weights and rounding.  `sa1_fused_slab`
launches the CUDA kernel `csrc/sa1_fused.cu` (K3) on CUDA tensors, with W2
and W3 packed by `pack_sa1_weights` into the layout the kernel's shared
memory takes (the model hands them in, packed once per weights by
`SharedMLP.packed_operands`); CPU tensors take its plain twin
`_sa1_fused_plain`.  K3 holds widths 128/128/C3 <= 256 and K <= 128; a
stage outside that range computes the same function through two other
hand-written kernels (`_sa1_wide`: K2's selection on the stage's own
windows, then K7 over the three layers with the max over the slots), whose
numbers differ from K3's only in the order of f32 sums.
"""

from __future__ import annotations

import functools

import torch

from .. import _build
from .mlp_chain import mlp_chain
from .neighbors import (BQ_C_TILE, BQ_K_TILE, BQ_SLAB_TILES, _axis_keys,
                        _ball_query_slab_plain, _f32, ball_query_fused_slab,
                        ball_query_grouped, flat_gather_rows, tile_windows)

# Tile geometry of the TPU kernel; the same as the slab ball query's, so
# the two scan the same key windows.
SA_C_TILE = 512
SA_K_TILE = 2048
SA_SLAB_TILES = 4
assert (SA_C_TILE, SA_K_TILE, SA_SLAB_TILES) == (BQ_C_TILE, BQ_K_TILE,
                                                 BQ_SLAB_TILES)

# Times the fused stage took the full scan because a tile's in-radius keys
# overflowed its window; read by chip_smoke.py.
SA1_FALLBACKS = {"overflow": 0}

# What the CUDA kernel holds (its operands live in registers and W2 and W3
# in shared memory): C1 = C2 = 128, C3 a multiple of 128 up to 256, K <= 128.
_KERNEL_C12 = 128
_KERNEL_MAX_C3 = 256
_KERNEL_MAX_K = 128


def sa1_slab_setup(pkeys: torch.Tensor, ckeys: torch.Tensor, radius: float,
                   n: int):
    """Key windows of the fused stage (`sa_fused_kernels.py:290-323`).

    The tile spans widen by `radius` rounded to f32 (the JAX code subtracts
    the weakly typed Python float), not by sqrt(f32(radius^2)) as the slab
    ball query does: at a boundary key the two give different windows.

    Args: pkeys (B, N) ascending point keys; ckeys (B, M) ascending
        centroid keys.
    Returns: lo_tile (B, ceil(M/512)) int32 and a device bool, True when
        some tile's in-radius keys do not fit its window."""
    rad = torch.tensor(radius, dtype=torch.float32, device=pkeys.device)
    return tile_windows(pkeys, ckeys, rad, n)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to bf16 values, kept in f32."""
    return x.to(torch.bfloat16).float()


# K3 reads W2 and W3 from shared memory as wgmma's B operand: bf16, K-major
# (each output column's K inputs contiguous), in 64-wide atoms of K whose
# rows (128 bytes) hold their 16-byte chunks XOR-swizzled by the row index
# mod 8 (the hardware's 128-byte swizzle).
SWIZZLE_K = 64


@functools.lru_cache(maxsize=None)
def _b_operand_positions(k: int, n: int, device: torch.device):
    """Flat position of element (k, n) of a (K, N) B operand in K3's
    shared-memory layout, as a (K, N) int64 tensor."""
    if k % SWIZZLE_K:
        raise ValueError(f"K3's B operands need K % {SWIZZLE_K} == 0, got {k}")
    kk = torch.arange(k).view(k, 1)
    nn = torch.arange(n).view(1, n)
    pos = ((kk // SWIZZLE_K) * (n * SWIZZLE_K) + nn * SWIZZLE_K
           + (((kk % SWIZZLE_K) // 8) ^ (nn % 8)) * 8 + kk % 8)
    return pos.to(device)


def pack_b_operand(w: torch.Tensor) -> torch.Tensor:
    """(K, N) f32 weights -> flat bf16 (K*N,) in K3's B-operand layout."""
    pos = _b_operand_positions(*w.shape, w.device)
    out = torch.empty(w.numel(), dtype=torch.bfloat16, device=w.device)
    out[pos.reshape(-1)] = w.to(torch.bfloat16).reshape(-1)
    return out


def pack_sa1_weights(params):
    """K3's operands from the folded [(w1, b1), (w2, b2), (w3, b3)]:
    `wpack` bf16, W2 then W3 in the B-operand layout; `fpack` f32, the
    bf16-rounded W1 (3, C1) row-major, then b1, b2, b3."""
    (w1, b1), (w2, b2), (w3, b3) = params
    wpack = torch.cat([pack_b_operand(w2), pack_b_operand(w3)])
    fpack = torch.cat([_bf16(w1).reshape(-1), b1, b2, b3]).float()
    return wpack, fpack.contiguous()


def _sa1_fused_plain(points, centroids, lo_tile, radius: float,
                     num_neighbours: int, w1, b1, w23, b23,
                     stratified: bool = True,
                     kpad: int | None = None) -> torch.Tensor:
    """Plain twin of K3 (see the module docstring): K2's plain selection on
    the same windows, then the chain as f32 products of bf16-rounded
    operands, which are exact, with f32 sums.  `kpad` > K pads each
    centroid's slots to kpad by repeating slot 0, as the kernel does; a
    repeated slot never changes the max."""
    b, _, _ = points.shape
    m = centroids.shape[2]
    k = num_neighbours
    idx, cnt = _ball_query_slab_plain(points, centroids, lo_tile,
                                      radius * radius, k, stratified)
    if kpad is not None and kpad > k:
        idx = torch.cat([idx, idx[..., :1].expand(b, m, kpad - k)], -1)
        k = kpad
    keys = flat_gather_rows(points.transpose(1, 2), idx.reshape(b, m * k))
    rel = _bf16(keys.reshape(b, m, k, 3)
                - centroids.transpose(1, 2)[:, :, None, :])
    w1r = _bf16(w1)
    h = (rel[..., 0:1] * w1r[0] + rel[..., 1:2] * w1r[1]) \
        + rel[..., 2:3] * w1r[2]
    h = _bf16(torch.relu(h + b1))
    (w2, w3), (b2, b3) = w23, b23
    h = _bf16(torch.relu(torch.matmul(h, _bf16(w2)) + b2))
    h = torch.relu(torch.matmul(h, _bf16(w3)) + b3)
    return torch.where(cnt[..., None] > 0, torch.amax(h, dim=2), 0.0)


def _sa1_wide(points, centroids, lo_tile, radius: float, num_neighbours: int,
              w1, b1, w23, b23, stratified: bool = True) -> torch.Tensor:
    """The fused stage outside K3's range: K2 (`ball_query_fused_slab`) on
    the stage's own windows `lo_tile`, the slots padded to a power of two
    by repeating slot 0 (as `_sa1_fused_plain`'s kpad), rel = key -
    centroid in f32 rounded to bf16, then K7 (`mlp_chain`) over the three
    layers in bf16 with ReLU and the max over each centroid's slots, and
    zero rows where no key is in range.  K7 rounds hidden layers to bf16
    and keeps the last in f32, at K3's rounding points; its bf16 x bf16
    products are exact in f32, so only the order of the f32 sums differs
    from K3 (layer 1 included).  On CPU tensors both kernels take their
    twins."""
    b = points.shape[0]
    m = centroids.shape[2]
    kpad = 1 << (num_neighbours - 1).bit_length()
    idx, cnt = ball_query_fused_slab(points, centroids, lo_tile, radius,
                                     num_neighbours, stratified)
    if kpad > num_neighbours:
        idx = torch.cat([idx, idx[..., :1].expand(b, m,
                                                  kpad - num_neighbours)], -1)
    keys = flat_gather_rows(points.transpose(1, 2), idx.reshape(b, m * kpad))
    rel = (keys.reshape(b, m, kpad, 3)
           - centroids.transpose(1, 2)[:, :, None, :]).to(torch.bfloat16)
    (w2, w3), (b2, b3) = w23, b23
    out = mlp_chain(rel.reshape(-1, 3), [(w1, b1), (w2, b2), (w3, b3)],
                    (True, True, True), kpad, torch.bfloat16)
    return torch.where(cnt[..., None] > 0, out.reshape(b, m, -1), 0.0)


def sa1_fused_slab(points: torch.Tensor, centroids: torch.Tensor,
                   lo_tile: torch.Tensor, radius: float, num_neighbours: int,
                   w1: torch.Tensor, b1: torch.Tensor, w23: tuple,
                   b23: tuple, stratified: bool = True,
                   packed: tuple | None = None) -> torch.Tensor:
    """Fused SA stage 1 over per-tile key windows (K3).

    Same caller contract as the slab ball query: each scene's points and
    centroids are sorted ascending along one axis, and every in-range point
    of centroid tile t of scene b lies in keys [lo_tile[b, t] * 2048,
    +8192) (`sa1_slab_setup`).

    Args: points (B, 3, N) f32; centroids (B, 3, M) f32; lo_tile
        (B, ceil(M/512)) int32; w1 (3, C1), b1 (C1,), w23 ((C1, C2),
        (C2, C3)), b23 ((C2,), (C3,)): the folded f32 affines; packed
        optional, their `pack_sa1_weights` (packed here otherwise).
    Returns: (B, M, C3) f32 max-pooled stage output.  Stages outside K3's
    range take `_sa1_wide` on CUDA tensors."""
    b, _, n = points.shape
    m = centroids.shape[2]
    (w2, w3), (b2, b3) = w23, b23
    c1, c2, c3 = w1.shape[1], w2.shape[1], w3.shape[1]
    if num_neighbours % 8 or any(c % 128 for c in (c1, c2, c3)):
        raise ValueError(f"the fused stage needs K % 8 == 0 and widths that "
                         f"are multiples of 128 (K={num_neighbours}, "
                         f"widths {c1}/{c2}/{c3})")
    operands = (points, centroids, lo_tile, w1, b1, w2, b2, w3, b3)
    if not _build.on_cuda(*operands):
        return _sa1_fused_plain(points, centroids, lo_tile, radius,
                                num_neighbours, w1, b1, w23, b23, stratified)
    ntile = -(-m // SA_C_TILE)
    if (c1, c2) != (_KERNEL_C12, _KERNEL_C12) or c3 > _KERNEL_MAX_C3 \
            or num_neighbours > _KERNEL_MAX_K:
        return _sa1_wide(points, centroids, lo_tile, radius, num_neighbours,
                         w1, b1, w23, b23, stratified)
    for t, name, shape in ((points, "points", (b, 3, n)),
                           (centroids, "centroids", (b, 3, m)),
                           (w1, "w1", (3, c1)), (b1, "b1", (c1,)),
                           (w2, "w2", (c1, c2)), (b2, "b2", (c2,)),
                           (w3, "w3", (c2, c3)), (b3, "b3", (c3,))):
        _build.check(t, name, torch.float32, shape)
    _build.check(lo_tile, "lo_tile", torch.int32, (b, ntile))
    if packed is None:
        packed = pack_sa1_weights([(w1, b1), (w2, b2), (w3, b3)])
    wpack, fpack = packed
    out = torch.empty((b, m, c3), dtype=torch.float32, device=points.device)
    _build.launch("sa1_fused", points, centroids, lo_tile, wpack, fpack, b, n,
                  m, ntile, _f32(radius * radius), num_neighbours, c3,
                  int(stratified), out)
    return out


def sa1_stage(points: torch.Tensor, centroids: torch.Tensor,
              sorted_axis: torch.Tensor, radius: float, num_neighbours: int,
              operands: tuple, dtype: torch.dtype) -> torch.Tensor:
    """A whole xyz-only SA stage (port of `_sa1_fused_eval`): slab ball
    query with rank-stratified neighbours (the cloud is sorted), grouping,
    the 3-layer chain and the max over the K neighbours, as one kernel
    (`sa1_fused_slab`).

    The window overflow flag is read on the host once for the whole batch,
    as JAX's `lax.cond` decides once: on overflow the stage takes a
    full-scan ball query (K2f, handed `sorted_axis` so that it scans only
    each ball's slab) and runs the chain with the same folded weights and
    bf16 rounding (counted in `SA1_FALLBACKS`).

    Args: points (B, 3, N) sorted along each scene's axis; centroids
        (B, 3, M) sorted the same way; sorted_axis (B,) tensor, that axis;
        operands the stage's (folded [(w, b)] per layer, their
        `pack_sa1_weights`), as `SharedMLP.packed_operands` returns them.
    Returns: (B, M, C3) pooled features in `dtype`."""
    points, centroids = points.contiguous(), centroids.contiguous()
    ((w1, b1), (w2, b2), (w3, b3)), packed = operands
    lo_tile, overflow = sa1_slab_setup(_axis_keys(points, sorted_axis),
                                       _axis_keys(centroids, sorted_axis),
                                       radius, points.shape[2])
    if bool(overflow):
        SA1_FALLBACKS["overflow"] += 1
        # The full scan, as JAX's fallback (slab_capacity = N keeps it off
        # the slab route); the promise only narrows K2f's scan.
        _, cnt, rel = ball_query_grouped(
            points, centroids, radius, num_neighbours,
            sorted_axis=sorted_axis, slab_capacity=points.shape[2],
            stratified=True)
        h = rel.to(torch.bfloat16)
        for w, b in ((w1, b1), (w2, b2), (w3, b3)):
            # bf16 x bf16 products are exact in f32: an f32 matmul of the
            # rounded operands is the f32-accumulating bf16 matmul.
            h = torch.relu(torch.matmul(h.float(), _bf16(w)) + b) \
                .to(torch.bfloat16)
        pooled = torch.amax(h.float(), dim=2)
        out = torch.where(cnt[..., None] > 0, pooled, 0.0)
    else:
        out = sa1_fused_slab(points, centroids, lo_tile, radius,
                             num_neighbours, w1, b1, (w2, w3), (b2, b3),
                             packed=packed)
    return out.to(dtype)

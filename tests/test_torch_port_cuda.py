"""The port's CUDA kernels against their plain PyTorch twins on the card, at
edge shapes the main path does not reach: ragged tiles, windows that run
past the last point, exact ties, invalid rows, empty balls, N below a block,
M = 1, one-row chains and all-zero rows; and the launches of a narrow
deployed forward.  chip_smoke.py holds the kernels at the main paths' shapes.

Needs a CUDA device (a CUDA kernel has no CPU mode), so every test carries
the `cuda` marker and skips without one.  On a machine with a GPU and no
JAX (the tests here import no JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_cuda.py -q
"""

import os

import numpy as np
import pytest
import torch

from s4g_tpu_torch import _build
from s4g_tpu_torch.configs.config import load_cfg_from_dict
from s4g_tpu_torch.models import build_model
from s4g_tpu_torch.models import nn_layers as nnl
from s4g_tpu_torch.ops import mlp_chain as mc
from s4g_tpu_torch.ops import neighbors as nb
from s4g_tpu_torch.ops import sa_fused as sf
from s4g_tpu_torch.ops import sampling as sp
from s4g_tpu_torch.pipeline import collision as col
from s4g_tpu_torch.pipeline.detector import GraspDetector, prep_one
from s4g_tpu_torch.utils.checkpoint import Checkpointer

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _sorted_cloud(rng, b, n, grid=None):
    pts = rng.rand(b, 3, n).astype(np.float32) * 0.7
    if grid is not None:                          # exact ties on a lattice
        pts = (np.round(pts / grid) * grid).astype(np.float32)
    order = np.argsort(pts[:, 0], axis=1, kind="stable")
    return torch.from_numpy(np.take_along_axis(pts, order[:, None], axis=2))


@pytest.mark.parametrize("ns,m_g,grid", [(200, 40, None), (37, 5, 0.1),
                                         (8, 8, None)])
def test_fps_lane_kernel_matches_plain(cuda, ns, m_g, grid):
    pts = _sorted_cloud(np.random.RandomState(ns), 2, 128 * ns, grid)
    want = sp._fps_sharded_plain(pts, 128 * m_g)
    got = sp.fps_lane_sharded(pts.to(cuda), 128 * m_g)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("b,n,m,case", [
    (1, 25, 25, "random"),        # N below one warp, M = N
    (3, 5003, 700, "random"),     # b = 3, ragged N and M
    (1, 20000, 300, "random"),    # N past the shared-memory cache: L2 reads
    (2, 1030, 1, "random"),       # M = 1
    (2, 300, 200, "duplicates"),  # 40 distinct points: ties at 0 after them
    (1, 2000, 50, "one point"),   # every distance 0: every pick is 0
])
def test_fps_exact_kernel_matches_plain(cuda, b, n, m, case):
    rng = np.random.RandomState(n + m)
    pts = rng.rand(b, 3, n).astype(np.float32)
    if case == "duplicates":
        pts = pts[:, :, rng.randint(0, 40, n)]
    elif case == "one point":
        pts[:] = pts[:, :, :1]
    pts = torch.from_numpy(np.ascontiguousarray(pts))
    want = sp._fps_plain(pts, m)
    got = sp.fps_exact(pts.to(cuda), m)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    if case == "one point":
        assert not want.any()


@pytest.mark.parametrize("b,g,n,m", [(2, 8, 4000, 800), (3, 3, 999, 99),
                                     (1, 4, 64, 64)])
def test_fps_sharded_kernel_matches_plain(cuda, b, g, n, m):
    pts = torch.from_numpy(np.random.RandomState(n).rand(b, 3, n)
                           .astype(np.float32))
    want = sp._fps_sharded_plain(pts, m, g)
    got = sp.fps_sharded(pts.to(cuda), m, g)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("b,n,centroids,grid", [
    (1, 25600, (5120, 1024, 256), None),   # the deployed stages
    (4, 25600, (5120, 1024, 256), 0.05),   # b = 4, ties on a lattice
    (2, 32768, (4096, 1024, 256), None),   # 256-point shards: every slot
    (2, 8192, (1024, 256, 128), 0.1),      # one pick a shard at stage 3
    (1, 4096, (4096, 512), None),          # two stages; every row picked
])
def test_fps_nested_kernel_matches_plain(cuda, b, n, centroids, grid):
    """Nested K1 (every SA stage in one launch) against the chained
    per-stage twin, bit for bit.  With `grid`, shard 5 of each scene is one
    repeated point, so its picks after the first are row 0 again."""
    pts = _sorted_cloud(np.random.RandomState(n + b), b, n, grid)
    if grid is not None:
        ns = n // 128
        pts[:, :, 5 * ns:6 * ns] = pts[:, :, 5 * ns:5 * ns + 1]
    want = sp._fps_nested_plain(pts, centroids)
    before = _build.LAUNCHES["fps_lane"]
    got = sp.fps_lane_nested(pts.to(cuda), centroids)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fps_lane"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_fps_on_cuda_launches_a_kernel(cuda, monkeypatch):
    """farthest_point_sample never hands a CUDA tensor to the plain loop:
    exact FPS and G-shard FPS launch K6, 128 shards K1."""
    monkeypatch.setattr(sp, "_fps_plain",
                        lambda *a: pytest.fail("plain FPS on the card"))
    pts = torch.rand(2, 3, 128 * 16, device=cuda)
    for shards, kernel in ((1, "fps_exact"), (8, "fps_exact"),
                           (5, "fps_exact"), (128, "fps_lane")):
        before = _build.LAUNCHES[kernel]
        sp.farthest_point_sample(pts, 256, num_shards=shards)
        assert _build.LAUNCHES[kernel] == before + 1, shards


@pytest.mark.parametrize("b,n,m,radius,k,shift", [
    (1, 20, 7, 0.3, 8, 0.0),          # N below one 32-key chunk
    (3, 5001, 1000, 0.05, 64, 0.0),   # b = 3, ragged N and M
    (2, 25600, 333, 0.02, 64, 0.0),   # SA1's N: 800 words per centroid
    (2, 4096, 300, 0.5, 8, 0.0),      # K = 8, overfull balls
    (1, 3000, 64, 0.1, 16, 9.0),      # balls with no hit
    (1, 41568, 40, 0.05, 24, 0.0),    # 1,299 words: two segments
    (1, 50000, 40, 0.05, 24, 0.0),    # past 41,568 keys
    (1, 25600, 5120, 0.02, 64, 0.0),  # M fills the card at 32 a block
    (2, 100000, 30, 0.3, 64, 0.0),    # 4 segments, overfull balls
])
@pytest.mark.parametrize("stratified", [False, True])
def test_ball_query_full_kernel_matches_plain(cuda, b, n, m, radius, k,
                                              shift, stratified):
    rng = np.random.RandomState(n + m)
    pts = (rng.rand(b, 3, n) * 0.6).astype(np.float32)
    cents = np.ascontiguousarray(pts[:, :, rng.choice(n, m, replace=False)]
                                 + np.float32(shift))
    pts, cents = torch.from_numpy(pts), torch.from_numpy(cents)
    want = nb._ball_query_full(pts, cents, radius * radius, k,
                               stratified=stratified)
    got = nb.ball_query_full_scan(pts.to(cuda), cents.to(cuda), radius, k,
                                  stratified)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    if shift:
        assert not want[1].any()
    else:
        assert int(want[1].min()) > 0


def test_k6_and_k2f_wrappers_check_their_operands(cuda):
    pts = torch.rand(1, 3, 1000, device=cuda)
    with pytest.raises(TypeError):
        sp.fps_exact(pts.double(), 10)
    with pytest.raises(ValueError, match="contiguous"):
        sp.fps_exact(pts.transpose(1, 2).contiguous().transpose(1, 2), 10)
    cents = pts[:, :, :10].contiguous()
    with pytest.raises(TypeError):
        nb.ball_query_full_scan(pts, cents.double(), 0.1, 8)
    with pytest.raises(ValueError, match="mixed devices"):
        nb.ball_query_full_scan(pts, cents.cpu(), 0.1, 8)
    with pytest.raises(ValueError, match="mixed devices"):
        nb.ball_query_full_scan(pts, cents, 0.1, 8,
                                sorted_axis=torch.zeros(1, dtype=torch.long))
    before = _build.LAUNCHES["ball_query_full"]
    nb.ball_query(pts, cents, 0.1, 8)
    assert _build.LAUNCHES["ball_query_full"] == before + 1


@pytest.mark.parametrize("b,n,m,shards", [
    (1, 16 * 8192 + 5000, 64, 1),   # 313 min-distances a block past its regs
    (2, 2 * 140000, 96, 2),         # 4 chains: each block its own scratch
    (1, 16 * 8192, 40, 1),          # exactly the registers: no scratch
])
def test_fps_exact_kernel_past_the_registers(cuda, b, n, m, shards):
    pts = torch.from_numpy(np.random.RandomState(n).rand(b, 3, n)
                           .astype(np.float32))
    if shards == 1:
        want = sp._fps_plain(pts, m)
        got = sp.fps_exact(pts.to(cuda), m)
    else:
        want = sp._fps_sharded_plain(pts, m, shards)
        got = sp.fps_sharded(pts.to(cuda), m, shards)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("b,n,m,blocks,case", [
    (2, 1000, 200, 1, "random"),       # one block a chain
    (1, 3000, 300, 2, "random"),
    (2, 6000, 400, 4, "random"),
    (1, 12000, 500, 8, "random"),
    (1, 25600, 600, 16, "random"),     # SA1 of the parity configuration
    (1, 25600, 64, 16, "one point"),   # every distance 0: every pick is 0
    (1, 25600, 300, 16, "mirrored"),   # each value twice, 8 blocks apart
    (16, 25600, 96, 16, "random"),     # 256 blocks: clusters in waves
    (1, 400000, 24, 16, "random"),     # past the cluster's shared memory
])
def test_fps_exact_cluster_matches_plain(cuda, b, n, m, blocks, case):
    """K6 as a cluster of blocks per chain, bit for bit:
    one chain length per cluster size the launcher picks; identical points
    (the lowest index wins across blocks); duplicate maxima in different
    blocks (the second half of the chain mirrors the first); enough chains
    that clusters run in waves; and a chain whose coordinates do not fit
    its cluster's shared memory (the rest from L2, min-distances in the
    scratch buffer)."""
    rng = np.random.RandomState(n + m + b)
    pts = rng.rand(b, 3, n).astype(np.float32)
    if case == "one point":
        pts[:] = pts[:, :, :1]
    elif case == "mirrored":
        pts[:, :, n // 2:] = pts[:, :, :n // 2]
    pts = torch.from_numpy(np.ascontiguousarray(pts)).to(cuda)
    assert sp.fps_exact_plan(n)[0] == blocks
    want = sp._fps_plain(pts, m)
    got = sp._fps_exact_launch(pts, m, 1)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if case == "one point":
        assert not want.any()


@pytest.mark.parametrize("b,g,n,m", [(2, 8, 25600, 5120), (3, 5, 30000, 600)])
def test_fps_sharded_cluster_matches_plain(cuda, b, g, n, m):
    """G-shard K6 (8 shards at SA1's shape: 2-block clusters) bit for
    bit."""
    pts = torch.from_numpy(np.random.RandomState(g).rand(b, 3, n)
                           .astype(np.float32)).to(cuda)
    assert sp.fps_exact_plan(n // g)[0] > 1
    want = sp._fps_sharded_plain(pts, m, g)
    got = sp._fps_exact_launch(pts, m, g)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _sorted_scene(rng, b, n, m, spread=(1.1, 0.9, 0.3)):
    """Scenes sorted ascending along x with centroids among their points,
    sorted the same way (what SA2 and SA3 hand K2f)."""
    pts = (rng.rand(b, 3, n) * np.array(spread)[None, :, None]
           ).astype(np.float32)
    pts = np.take_along_axis(pts, np.argsort(pts[:, 0], axis=1,
                                             kind="stable")[:, None], axis=2)
    sel = np.sort(rng.choice(n, m, replace=False))
    return (torch.from_numpy(np.ascontiguousarray(pts)),
            torch.from_numpy(np.ascontiguousarray(pts[:, :, sel])))


@pytest.mark.parametrize("n,m,radius,k", [
    (5120, 1024, 0.08, 64),     # SA2's shape
    (1024, 256, 0.32, 64),      # SA3's shape: overfull balls
    (25600, 5120, 0.02, 64),    # SA1's overflow fallback
    (50000, 300, 0.05, 32),     # past 32,768 keys: slabs in one segment
    (200000, 200, 0.1, 16),     # slabs wider than a segment: two passes
    (100000, 200, 0.6, 16),     # slabs past a third of the scene: in full
])
@pytest.mark.parametrize("stratified", [False, True])
def test_ball_query_full_kernel_on_sorted_scenes(cuda, n, m, radius, k,
                                                 stratified):
    """With the sort promise K2f scans each ball's slab only (where the
    slab spans at most a third of the scene), and where the promise is
    broken (scene 1: two keys swapped) the whole scene; both bit for bit
    the full scan."""
    pts, cents = _sorted_scene(np.random.RandomState(n + m), 2, n, m)
    pts[1, 0, [10, n // 2]] = pts[1, 0, [n // 2, 10]]
    axes = torch.zeros(2, dtype=torch.long)
    want = nb._ball_query_full(pts, cents, radius * radius, k,
                               stratified=stratified)
    got = nb.ball_query_full_scan(pts.to(cuda), cents.to(cuda), radius, k,
                                  stratified, sorted_axis=axes.to(cuda))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert 2 * int((want[1] > 0).sum()) > want[1].numel()


@pytest.mark.parametrize("n,m,radius,k", [
    (9000, 1000, 0.03, 16),      # ragged last centroid tile
    (9000, 1000, 0.2, 64),       # overfull balls (stratified ranks)
    (3000, 600, 0.05, 32),       # N below one window: keys past N
    (9000, 700, 0.001, 8),       # mostly empty balls: all-zero rows
])
@pytest.mark.parametrize("stratified", [False, True])
def test_ball_query_slab_kernel_matches_plain(cuda, n, m, radius, k,
                                              stratified):
    rng = np.random.RandomState(n + m)
    pts = _sorted_cloud(rng, 2, n)
    sel = np.sort(rng.choice(n, m, replace=False))
    cents = pts[:, :, sel].contiguous()
    lo_tile, _ = nb.slab_windows(pts[:, 0].contiguous(),
                                 cents[:, 0].contiguous(), radius * radius, n)
    want = nb._ball_query_slab_plain(pts, cents, lo_tile, radius * radius, k,
                                     stratified)
    got = nb.ball_query_fused_slab(pts.to(cuda), cents.to(cuda),
                                   lo_tile.to(cuda), radius, k, stratified)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("b,n,m,radius,k", [
    (1, 25600, 5120, 0.02, 64),    # SA1 at b = 1
    (2, 25600, 5120, 0.02, 64),    # SA1 at b = 2 (SA1_FUSE "0")
    (4, 25600, 5120, 0.02, 128),   # b = 4, K = 128
    (1, 9000, 1000, 0.2, 128),     # overfull balls, slabs past one chunk
    (4, 9000, 1000, 0.05, 64),
])
@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("stratified", [False, True])
def test_ball_query_slab_kernel_restricted_and_not(cuda, b, n, m, radius, k,
                                                   ascending, stratified):
    """K2 where x ascends over every window (each ball scans its slab
    only) and where no coordinate does (keys shuffled inside each 2,048-key
    tile, so each window holds the same keys out of order: the whole window
    is scanned), bit for bit its twin either way."""
    rng = np.random.RandomState(n + m + b)
    pts, cents = _sorted_scene(rng, b, n, m, spread=(1.1, 0.9, 0.05))
    lo_tile, _ = nb.slab_windows(pts[:, 0].contiguous(),
                                 cents[:, 0].contiguous(), radius * radius, n)
    if not ascending:
        for s in range(b):
            for t0 in range(0, n, nb.BQ_K_TILE):
                perm = t0 + rng.permutation(min(nb.BQ_K_TILE, n - t0))
                pts[s, :, t0:t0 + len(perm)] = pts[s][:, perm]
    want = nb._ball_query_slab_plain(pts, cents, lo_tile, radius * radius, k,
                                     stratified)
    got = nb.ball_query_fused_slab(pts.to(cuda), cents.to(cuda),
                                   lo_tile.to(cuda), radius, k, stratified)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert int((want[1] > 1).sum()) > m // 2


@pytest.mark.parametrize("b,n1,n2,grid", [
    (2, 3000, 5000, None), (2, 700, 4099, 0.05), (2, 129, 3, None),
    (2, 200, 30000, None),    # few queries, many keys: 469 chunks, merged
    (4, 5120, 1024, None),    # b = 4 at the small FP stage
    (4, 2000, 6000, 0.1),     # tie grid: duplicate keys across the chunks
    (1, 600, 2500, None),     # one query tile, a ragged last chunk
])
def test_three_nn_kernel_matches_plain(cuda, b, n1, n2, grid):
    rng = np.random.RandomState(n2)
    q = torch.from_numpy(rng.rand(b, 3, n1).astype(np.float32))
    keys = rng.rand(b, 3, n2).astype(np.float32)
    if grid is not None:                          # duplicate keys: ties
        keys = (np.round(keys / grid) * grid).astype(np.float32)
    keys = torch.from_numpy(keys)
    chunk = nb.three_nn_key_chunk(b, n1, n2, nb.sm_count(cuda))
    want_i, want_d = nb._three_nn_plain(q, keys, chunk)   # the kernel's split
    got_i, got_d = nb.three_nn_fused(q.to(cuda), keys.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got_i.cpu(), want_i)
    assert torch.equal(got_d.cpu(), want_d)
    # The split itself: one pass must give what many chunks give.
    one_i, one_d = nb._three_nn_plain(q, keys)
    assert torch.equal(one_i, want_i) and torch.equal(one_d, want_d)


def test_collision_kernel_on_a_raster_cloud(cuda):
    """K5 at the main path's shape, 1,024 poses x 65,536 rows, on a cloud
    in camera raster order (a depth image of a tilted plane with a box,
    the last rows invalid padding), poses on its points: bit for bit."""
    rng = np.random.RandomState(5)
    h, w = 256, 256
    v, u = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    depth = 0.75 + 0.0004 * v
    depth[100:150, 80:140] -= 0.08                  # a box on the table
    x = (u - w / 2) / 300.0 * depth
    y = (v - h / 2) / 300.0 * depth
    cloud = np.stack([x, y, depth], -1).reshape(-1, 3).astype(np.float32)
    cloud += rng.normal(0, 0.001, cloud.shape).astype(np.float32)
    valid = np.ones(len(cloud), np.float32)
    valid[-1500:] = 0.0
    g = 1024
    poses = np.tile(np.eye(4, dtype=np.float32), (g, 1, 1))
    poses[:, :3, :3] = np.linalg.qr(rng.randn(g, 3, 3))[0]
    poses[:, :3, 3] = cloud[rng.choice(len(cloud) - 1500, g)]
    g2l = torch.from_numpy(np.linalg.inv(poses).astype(np.float32))
    cv = torch.from_numpy(np.concatenate([cloud, valid[:, None]], axis=1))
    want = col._collision_counts_plain(g2l, cv)
    got = col.collision_counts(g2l.to(cuda), cv.to(cuda))
    torch.cuda.synchronize()
    for gg, ww in zip(got, want):
        assert torch.equal(gg.cpu(), ww)
    assert float(want[0].sum()) > 0 and float(want[1].sum()) > 0


@pytest.mark.parametrize("g,n", [(1001, 20000), (8, 65536), (5000, 3001)])
def test_collision_kernel_matches_plain(cuda, g, n):
    rng = np.random.RandomState(g)
    cloud = ((rng.rand(n, 3) - 0.5) * 0.3).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (g, 1, 1))
    poses[:, :3, :3] = np.linalg.qr(rng.randn(g, 3, 3))[0]
    poses[:, :3, 3] = cloud[rng.choice(n, g)]      # grippers among points
    g2l = torch.from_numpy(np.linalg.inv(poses).astype(np.float32))
    valid = (rng.rand(n) > 0.2).astype(np.float32)
    cv = torch.from_numpy(np.concatenate([cloud, valid[:, None]], axis=1))
    want = col._collision_counts_plain(g2l, cv)
    got = col.collision_counts(g2l.to(cuda), cv.to(cuda))
    torch.cuda.synchronize()
    for gg, w in zip(got, want):
        assert torch.equal(gg.cpu(), w)
    assert float(want[0].sum()) > 0 and float(want[1].sum()) > 0


def _k3_operands(rng, b, n, m, radius, shift=0.0, c3=256):
    """Sorted scenes, sorted centroids among their points (moved by
    `shift`), the fused stage's windows and folded affines."""
    pts = _sorted_cloud(rng, b, n)
    sel = np.sort(rng.choice(n, m, replace=False))
    cents = (pts[:, :, sel] + shift).contiguous()
    lo_tile, _ = sf.sa1_slab_setup(pts[:, 0].contiguous(),
                                   cents[:, 0].contiguous(), radius, n)
    shapes = ((3, 128), (128,), (128, 128), (128,), (128, c3), (c3,))
    w1, b1, w2, b2, w3, b3 = (
        torch.from_numpy((rng.randn(*sh) * sc).astype(np.float32))
        for sh, sc in zip(shapes, (0.5, 0.1, 0.1, 0.1, 0.1, 0.1)))
    return pts, cents, lo_tile, (w1, b1, (w2, w3), (b2, b3))


@pytest.mark.parametrize("b,n,m,radius,k,shift,c3", [
    (2, 9000, 1000, 0.03, 64, 0.0, 256),   # ragged last centroid tile
    (2, 3000, 600, 0.05, 32, 0.0, 256),    # N below one window: keys past N
    (3, 9000, 700, 0.2, 16, 0.0, 128),     # b = 3, overfull balls, C3 = 128
    (2, 9000, 700, 0.001, 8, 0.0, 256),    # mostly empty balls, K pads to 16
    (2, 9000, 1024, 0.03, 24, 10.0, 256),  # every tile empty: zero rows
    # 1,280 centroid groups: several per persistent block, across tiles and
    # scenes.
    (4, 12000, 5120, 0.03, 16, 0.0, 256),
    (2, 9000, 600, 0.2, 128, 0.0, 256),    # K = 128: two tiles a centroid
    (1, 25600, 5120, 0.02, 64, 0.0, 256),  # b = 1, SA1 (SA1_FUSE "1")
])
def test_sa1_fused_kernel_matches_plain(cuda, b, n, m, radius, k, shift, c3):
    rng = np.random.RandomState(n + m + k)
    pts, cents, lo_tile, w = _k3_operands(rng, b, n, m, radius, shift, c3)
    want = sf._sa1_fused_plain(pts, cents, lo_tile, radius, k, *w)
    _, cnt = nb._ball_query_slab_plain(pts, cents, lo_tile, radius * radius,
                                       k, True)
    dev = [x.to(cuda) if isinstance(x, torch.Tensor)
           else tuple(y.to(cuda) for y in x) for x in w]
    got = sf.sa1_fused_slab(pts.to(cuda), cents.to(cuda), lo_tile.to(cuda),
                            radius, k, *dev)
    torch.cuda.synchronize()
    got = got.cpu()
    assert got.shape == want.shape == (b, m, c3)
    empty = cnt == 0
    assert torch.all(got[empty] == 0) and torch.all(want[empty] == 0)
    if shift:
        assert bool(empty.all())
    else:
        assert int(empty.sum()) < b * m
        # f32 sums in another order flip an odd bf16 rounding of a hidden
        # activation.
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-2 * scale


@pytest.mark.parametrize("widths,k,radius", [
    ((256, 256, 512), 64, 0.03),   # SA1 widths K3 does not hold
    ((128, 128, 384), 48, 0.2),    # C3 > 256, K padded to 64, overfull
    ((128, 128, 256), 160, 0.2),   # K > 128
])
def test_sa1_fused_wide_stage_matches_plain(cuda, widths, k, radius):
    """Stages outside K3's range run as K2 + K7 on the card, within K3's
    tolerance of the twin, zero rows exact, and never as K3."""
    rng = np.random.RandomState(k)
    pts = _sorted_cloud(rng, 2, 9000)
    cents = pts[:, :, np.sort(rng.choice(9000, 1000, replace=False))]
    cents = cents.contiguous()
    cents[1, :, -100:] += 10.0                    # empty balls, still sorted
    lo_tile, _ = sf.sa1_slab_setup(pts[:, 0].contiguous(),
                                   cents[:, 0].contiguous(), radius, 9000)
    c1, c2, c3 = widths
    shapes = ((3, c1), (c1,), (c1, c2), (c2,), (c2, c3), (c3,))
    w1, b1, w2, b2, w3, b3 = (
        torch.from_numpy((rng.randn(*sh) * sc).astype(np.float32))
        for sh, sc in zip(shapes, (0.5, 0.1, 0.1, 0.1, 0.1, 0.1)))
    want = sf._sa1_fused_plain(pts, cents, lo_tile, radius, k, w1, b1,
                               (w2, w3), (b2, b3))
    before = dict(_build.LAUNCHES)
    got = sf.sa1_fused_slab(
        pts.to(cuda), cents.to(cuda), lo_tile.to(cuda), radius, k,
        w1.to(cuda), b1.to(cuda), (w2.to(cuda), w3.to(cuda)),
        (b2.to(cuda), b3.to(cuda))).cpu()
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sa1_fused"] == before["sa1_fused"]
    _, cnt = nb._ball_query_slab_plain(pts, cents, lo_tile, radius * radius,
                                       k, True)
    empty = cnt == 0
    assert 0 < int(empty.sum()) < empty.numel()
    assert torch.all(got[empty] == 0) and torch.all(want[empty] == 0)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-2 * scale


def test_sa1_fused_wrapper_checks_its_operands(cuda):
    rng = np.random.RandomState(0)
    pts, cents, lo_tile, (w1, b1, (w2, w3), (b2, b3)) = _k3_operands(
        rng, 2, 3000, 600, 0.05)
    p, c, lo = pts.to(cuda), cents.to(cuda), lo_tile.to(cuda)
    w1, b1, w2, b2, w3, b3 = (x.to(cuda) for x in (w1, b1, w2, b2, w3, b3))
    with pytest.raises(TypeError):
        sf.sa1_fused_slab(p.double(), c, lo, 0.05, 16, w1, b1, (w2, w3),
                          (b2, b3))
    with pytest.raises(ValueError, match="contiguous"):
        sf.sa1_fused_slab(p, c.transpose(1, 2).contiguous().transpose(1, 2),
                          lo, 0.05, 16, w1, b1, (w2, w3), (b2, b3))
    with pytest.raises(ValueError, match="shape"):
        sf.sa1_fused_slab(p, c, lo[:, :1].contiguous(), 0.05, 16, w1, b1,
                          (w2, w3), (b2, b3))
    with pytest.raises(ValueError, match="K % 8"):
        sf.sa1_fused_slab(p, c, lo, 0.05, 12, w1, b1, (w2, w3), (b2, b3))
    # C2 = 256 is outside K3: the stage runs as K2 + K7, not K3.
    wide = torch.zeros(128, 256, device=cuda)
    before = dict(_build.LAUNCHES)
    sf.sa1_fused_slab(p, c, lo, 0.05, 16, w1, b1,
                      (wide, torch.zeros(256, 256, device=cuda)),
                      (torch.zeros(256, device=cuda), b3))
    assert [_build.LAUNCHES[x] - before[x] for x in
            ("sa1_fused", "ball_query_slab", "mlp_chain")] == [0, 1, 1]
    with pytest.raises(ValueError, match="mixed devices"):
        sf.sa1_fused_slab(p, c.cpu(), lo, 0.05, 16, w1, b1, (w2, w3),
                          (b2, b3))
    before = _build.LAUNCHES["sa1_fused"]
    sf.sa1_fused_slab(p, c, lo, 0.05, 16, w1, b1, (w2, w3), (b2, b3))
    assert _build.LAUNCHES["sa1_fused"] == before + 1


def test_wrappers_check_their_operands(cuda):
    pts = torch.rand(1, 3, 128 * 8, device=cuda)
    with pytest.raises(TypeError):
        sp.fps_lane_sharded(pts.double(), 128)
    with pytest.raises(ValueError, match="contiguous"):
        nb.three_nn_fused(pts[:, :, ::2], pts[:, :, :16].contiguous())
    with pytest.raises(ValueError, match="mixed devices"):
        nb.three_nn_fused(pts, pts.cpu())
    before = dict(_build.LAUNCHES)
    nb.three_nn_fused(pts, pts[:, :, :16].contiguous())
    assert _build.LAUNCHES["three_nn"] == before["three_nn"] + 1


def _chain(rng, p, widths, zero_rows=False):
    """(P, C_in) rows and folded f32 affines scaled by 1/sqrt(fan-in)."""
    x = rng.randn(p, widths[0]).astype(np.float32)
    if zero_rows:
        x[::3] = 0.0
    params = [(torch.from_numpy((rng.randn(widths[i], widths[i + 1])
                                 / np.sqrt(widths[i])).astype(np.float32)),
               torch.from_numpy((rng.randn(widths[i + 1]) * 0.1)
                                .astype(np.float32)))
              for i in range(len(widths) - 1)]
    return torch.from_numpy(x), params


@pytest.mark.parametrize("p,widths,pool,dtype,zero_rows", [
    (1, (3, 128, 128, 256), None, "bfloat16", False),        # P = 1
    (1000, (259, 256, 256, 512), None, "bfloat16", False),   # ragged tile
    (4096, (3, 128, 128, 256), 64, "bfloat16", False),       # SA1's chain
    (1000, (259, 256, 256, 512), 8, "float32", True),        # pool 8, f32
    (300, (1536, 1024, 1024), None, "bfloat16", False),      # FP1's widths
    (300, (1536, 1024, 1024), None, "float32", False),
    (640, (515, 512, 512, 1024), 64, "bfloat16", True),      # SA3's chain
    (333, (256, 512, 256, 256, 128), None, "bfloat16", True),  # 4 layers
    (96, (20, 48), 16, "float32", False),                     # 1 layer
    # Split into sub-chains: 6 layers (4 + 2) with pooling, in both dtypes.
    (1024, (3, 64, 64, 128, 128, 256, 256), 32, "bfloat16", False),
    (1024, (3, 64, 64, 128, 128, 256, 256), 32, "float32", True),
    # A 4,096-wide input: one layer at 16-row tiles in bf16; its own
    # sub-chain in f32 at 16 rows.
    (200, (4096, 64, 32), None, "bfloat16", False),
    (200, (1024, 3000, 64), 8, "float32", False),
    # one layer wider than any tile: its input channels split in the kernel
    (100, (7300, 48), None, "bfloat16", False),
    (128, (7300, 48), 16, "bfloat16", True),
    (100, (3700, 48), None, "float32", False),
    (128, (3700, 300), 4, "float32", True),
    (128, (32, 7300, 48), 64, "bfloat16", False),   # a wide hidden layer
    # wgmma tiles: 128 rows (two warpgroups) and 64 rows (SA3's widths),
    # ragged; widths that are not multiples of 64.
    (70 * 64, (3, 128, 128, 256), 64, "bfloat16", False),
    (70 * 64, (515, 512, 512, 1024), 64, "bfloat16", True),
    (9000, (100, 200, 72), None, "bfloat16", False),
    # pooled groups spanning sub-tiles: 256 rows over 128-row tiles, 128
    # over 64-row ones; and groups of 2 and 4 inside a row half.
    (512 * 40, (100, 200, 72), 256, "bfloat16", False),
    (128 * 70, (515, 512, 512, 1024), 128, "bfloat16", False),
    (384 * 40, (100, 200, 72), 2, "bfloat16", True),
    (384 * 40, (100, 200, 72), 4, "float32", False),
    # FP1's and FP2's rows and widths: one layer a launch, output columns
    # split over blocks; few pooled rows
    (1000, (1536, 1024, 1024), None, "bfloat16", False),
    (5120, (1280, 512, 512), None, "bfloat16", True),
    (300, (130, 1000, 260), 4, "bfloat16", False),
])
def test_mlp_chain_kernel_matches_plain(cuda, p, widths, pool, dtype,
                                        zero_rows):
    rng = np.random.RandomState(p + len(widths))
    x, params = _chain(rng, p, widths, zero_rows)
    relu = tuple([True] * (len(params) - 1) + [len(params) % 2 == 0])
    cd = getattr(torch, dtype)
    want = mc._mlp_chain_plain(x, params, relu, pool, cd)
    got = mc.mlp_chain(x.to(cuda), [(w.to(cuda), b.to(cuda))
                                    for w, b in params], relu, pool, cd)
    torch.cuda.synchronize()
    got = got.cpu()
    assert got.dtype == torch.float32 and got.shape == want.shape
    scale = float(want.abs().max())
    assert scale > 0.1
    # f32: sums in another order.  bf16: an f32 sum in another order flips
    # an odd bf16 rounding of a hidden activation (as for K3).
    tol = 1e-5 if dtype == "float32" else 1e-2
    assert float((got - want).abs().max()) <= tol * scale


def test_mlp_chain_wrapper_refuses_and_counts(cuda, monkeypatch):
    rng = np.random.RandomState(0)
    x, params = _chain(rng, 64, (40, 32, 16))
    x = x.to(cuda)
    params = [(w.to(cuda), b.to(cuda)) for w, b in params]
    plain = mc._mlp_chain_plain
    monkeypatch.setattr(mc, "_mlp_chain_plain",
                        lambda *a, **kw: pytest.fail("plain chain on the card"))
    with pytest.raises(ValueError, match="mixed devices"):
        mc.mlp_chain(x.cpu(), params, (True, True))
    with pytest.raises(RuntimeError, match="mlp_chain failed to launch"):
        mc.mlp_chain(x[:48], params, (True, True), pool_k=24)  # not 2^k
    before = _build.LAUNCHES["mlp_chain"]
    mc.mlp_chain(x, params, (True, True), pool_k=16)
    assert _build.LAUNCHES["mlp_chain"] == before + 1
    mc.mlp_chain(x, params, (True, True), pool_k=16,
                 compute_dtype=torch.float32)
    assert _build.LAUNCHES["mlp_chain"] == before + 2
    five = [(torch.eye(40, device=cuda), torch.zeros(40, device=cuda))] * 5
    mc.mlp_chain(x, five, (True,) * 5)        # 4 + 1 layers: two launches
    assert _build.LAUNCHES["mlp_chain"] == before + 4
    before = _build.LAUNCHES["mlp_chain"]
    # A layer whose input is wider than any row tile takes (1,600 bf16,
    # 3,632 f32) splits its input channels: one launch, the twin's result.
    for width, cd, tol in ((1600, torch.bfloat16, 1e-2),
                           (3632, torch.float32, 1e-5)):
        xw, wide = _chain(rng, 8, (width, 16))
        wide = [(w.to(cuda), b.to(cuda)) for w, b in wide]
        got = mc.mlp_chain(xw.to(cuda), wide, (True,), compute_dtype=cd)
        torch.cuda.synchronize()
        want = plain(xw, [(w.cpu(), b.cpu()) for w, b in wide], (True,),
                     None, cd)
        assert float((got.cpu() - want).abs().max()) <= \
            tol * float(want.abs().max())
    assert _build.LAUNCHES["mlp_chain"] == before + 2


def test_sa1_fallback_hands_k2f_the_sort_axis(cuda):
    """detect_batch's SA1 fallback (K3's windows overflow) on the card:
    handed the sort axis it is one K2f launch that scans the slabs (no K2,
    no K3), with the bits of the full scan without the promise."""
    rng = np.random.RandomState(6)
    n, m, radius, k = 12288, 512, 0.05, 16
    x = np.concatenate([rng.rand(2288) * 0.5,
                        0.25 + 0.01 * rng.rand(10000)])
    pts = torch.from_numpy(np.stack([np.sort(x), rng.rand(n) * 0.05,
                                     rng.rand(n) * 0.05])[None]
                           .astype(np.float32)).to(cuda)
    sel = torch.from_numpy(np.sort(rng.choice(n, m, False))).to(cuda)
    cent = pts[:, :, sel].contiguous()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        mlp = nnl.SharedMLP(3, (128, 128, 256), ndim=2,
                            dtype=torch.bfloat16).to(cuda).eval()
    keys = (pts[:, 0].contiguous(), cent[:, 0].contiguous())
    fallbacks = sf.SA1_FALLBACKS["overflow"]
    with torch.no_grad():
        want = mlp.sa1_fused_eval(pts, cent, *keys, radius, k)
        before = dict(_build.LAUNCHES)
        got = mlp.sa1_fused_eval(pts, cent, *keys, radius, k,
                                 sorted_axis=torch.zeros(1, dtype=torch.long,
                                                         device=cuda))
        torch.cuda.synchronize()
    launched = {key: _build.LAUNCHES[key] - before[key] for key in before}
    assert sf.SA1_FALLBACKS["overflow"] == fallbacks + 2
    assert launched["ball_query_full"] == 1
    assert launched["ball_query_slab"] == launched["sa1_fused"] == 0
    assert torch.equal(got, want)
    assert float(want.float().abs().max()) > 0


@pytest.mark.parametrize("dtype,pool,widths", [
    ("bfloat16", None, lambda w: (w, 16)),          # one layer
    ("bfloat16", None, lambda w: (16, w, 16)),      # both buffers
    ("bfloat16", 64, lambda w: (16, 512, w)),       # the pooled maxima
    ("float32", None, lambda w: (w, 16)),
    ("float32", 8, lambda w: (16, 1024, w)),
])
def test_mlp_chain_planner_agrees_with_the_launcher(cuda, dtype, pool,
                                                    widths):
    """`chain_pieces` plans from copies of the launcher's shared-memory
    sums (`mlp_chain._wg_smem` in bf16, `_tile_smem` in f32): at the
    widest width whose tile fits, the launcher must launch the chain as
    one piece; one padding step wider, a chain of several layers must be
    planned apart and refused by the launcher as one piece, while a single
    layer stays one piece that the launcher runs by splitting its input
    channels."""
    cd = getattr(torch, dtype)
    # Widths grow by whole padding steps of the widened width: 16 in f32;
    # in bf16 64 for the chain's input, 128 for a layer's output.
    at = next(i for i, (a, b) in enumerate(zip(widths(1), widths(2)))
              if a != b)
    step = 16 if cd == torch.float32 else (64 if at == 0 else 128)

    def fits(w):
        kpads = mc.padded_widths(widths(w), cd)
        return mc._fits(kpads[:-1], kpads[-1], pool, cd)

    w = step
    while fits(w + step):
        w += step
    rows = pool or 16
    for width, fit in ((w, True), (w + step, False)):
        chain = widths(width)
        single = len(chain) == 2
        one_piece = mc.chain_pieces(chain, pool, cd) == [(0, len(chain) - 1)]
        assert one_piece is (fit or single)
        params = [(torch.full((a, b), 1e-3, device=cuda),
                   torch.zeros(b, device=cuda))
                  for a, b in zip(chain, chain[1:])]
        packed = mc._pack(params, chain[0], cd)
        x = torch.ones(rows, chain[0], dtype=cd, device=cuda)
        relu = (True,) * len(params)
        if one_piece:
            out = mc._launch(mc._kernel_input(x, packed, pool), packed,
                             relu, pool)
            torch.cuda.synchronize()
            assert bool(torch.isfinite(out).all())
        else:
            with pytest.raises(RuntimeError, match="mlp_chain failed"):
                mc._launch(mc._kernel_input(x, packed, pool), packed, relu,
                           pool)


def test_fused_forward_packs_once_per_weights(cuda, monkeypatch):
    """The fused route packs a SharedMLP's operands once: a second forward
    with unchanged weights packs nothing; after `load_state_dict` the
    next forward re-packs every chain and matches the twin."""
    monkeypatch.setattr(nnl, "MLP_IMPL", "fused")
    rng = np.random.RandomState(4)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(4)
        mlp = nnl.SharedMLP(67, (128, 96, 200), ndim=2,
                            dtype=torch.bfloat16).to(cuda).eval()
        other = nnl.SharedMLP(67, (128, 96, 200), ndim=2,
                              dtype=torch.bfloat16).to(cuda)
    with torch.no_grad():
        for layer in other:
            layer.bn.running_var.uniform_(0.5, 2.0)
    x = torch.from_numpy(rng.randn(3, 700, 32, 67).astype(np.float32)
                         ).to(cuda)

    def forward():
        before = dict(nnl.PACK_CACHE)
        with torch.no_grad():
            out = mlp(x, max_pool_k=32)
        torch.cuda.synchronize()
        return out, {k: nnl.PACK_CACHE[k] - before[k] for k in before}

    def twin():
        with torch.no_grad():
            params = mlp.folded_params()
            return mc._mlp_chain_plain(x.reshape(-1, 67), params,
                                       (True,) * 3, 32, torch.bfloat16)

    _, counts = forward()
    assert counts["packs"] <= 1
    first, counts = forward()
    assert counts == {"hits": 1, "packs": 0}
    mlp.load_state_dict(other.state_dict())
    got, counts = forward()
    assert counts == {"hits": 0, "packs": 1}
    want = twin()
    scale = float(want.abs().max())
    assert scale > 0.1
    assert float((got.float().reshape(want.shape) - want).abs().max()) \
        <= 1e-2 * scale
    assert not torch.equal(got, first)


NARROW_DEPLOYED = {
    "MODEL": {"TYPE": "PN2_CLS", "COMPUTE_DTYPE": "bfloat16", "PN2": {
        "NUM_INPUT": 16384, "NUM_CENTROIDS": (4096, 256, 128),
        "RADIUS": (0.02, 0.08, 0.32), "NUM_NEIGHBOURS": (32, 32, 32),
        "SA_CHANNELS": ((32, 32, 64), (64, 64, 64), (64, 64, 128)),
        "FP_CHANNELS": ((64, 64), (64, 64), (64, 64, 32)),
        "NUM_FP_NEIGHBOURS": (3, 3, 3), "SEG_CHANNELS": (64, 32),
        "SORT_POINTS": True, "FPS_SHARDS": 128}},
    "DATA": {"SCORE_CLASSES": 3},
}


def _narrow_forward(cuda, dense_column, centroids=None):
    """One b = 1 forward of a narrow deployed PN2_CLS (sorted cloud, SA1
    above the slab capacity) on a seeded cloud; with `dense_column`, most
    points share one sliver along the sort axis, so SA1's slab windows
    overflow; `centroids` replaces the SA stages' centroid counts."""
    rng = np.random.RandomState(1)
    pts = (rng.rand(1, 3, 16384) * [[[0.6], [0.4], [0.3]]]).astype(np.float32)
    if dense_column:
        pts[0, 0, :13000] = 0.3 + 0.001 * rng.rand(13000)
    spec = NARROW_DEPLOYED
    if centroids is not None:
        model = spec["MODEL"]
        spec = {**spec, "MODEL": {**model, "PN2": {
            **model["PN2"], "NUM_CENTROIDS": centroids}}}
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        net = build_model(load_cfg_from_dict(spec)).to(cuda)
    out = net({"scene_points": torch.from_numpy(pts).to(cuda)})
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("dense_column,full", [(False, 2), (True, 3)])
def test_deployed_forward_scans_in_full_through_k2f(cuda, monkeypatch,
                                                    dense_column, full):
    """SA2 and SA3 are full scans (K2f); an overflowing SA1 adds its
    fallback.  No ball query reaches the plain full scan on the card."""
    monkeypatch.setattr(nb, "_ball_query_full",
                        lambda *a, **kw: pytest.fail("plain scan on the card"))
    before = dict(_build.LAUNCHES)
    fallbacks = nb.SLAB_FALLBACKS["overflow"]
    out = _narrow_forward(cuda, dense_column)
    launched = {k: _build.LAUNCHES[k] - before[k] for k in before}
    assert launched["ball_query_full"] == full
    assert launched["ball_query_slab"] == 3 - full
    assert nb.SLAB_FALLBACKS["overflow"] - fallbacks == full - 2
    assert launched["mlp_chain"] == 0
    assert bool(torch.isfinite(out["score"]).all())


@pytest.mark.parametrize("centroids,fps_lane,fps_exact", [
    ((4096, 256, 128), 1, 0),   # every stage 128-shard: nested, one launch
    ((4096, 256, 64), 2, 1),    # SA3 exact FPS: per stage, K1 twice, K6
])
def test_deployed_forward_launches_k1_once_where_the_stages_nest(
        cuda, monkeypatch, centroids, fps_lane, fps_exact):
    monkeypatch.setattr(sp, "_fps_nested_plain",
                        lambda *a: pytest.fail("plain FPS on the card"))
    before = dict(_build.LAUNCHES)
    out = _narrow_forward(cuda, False, centroids)
    launched = {k: _build.LAUNCHES[k] - before[k] for k in before}
    assert launched["fps_lane"] == fps_lane
    assert launched["fps_exact"] == fps_exact
    assert bool(torch.isfinite(out["score"]).all())


@pytest.mark.parametrize("settings,chains", [
    ({"MLP_IMPL": "fused"}, 10),
    ({"MLP_IMPL": "auto", "MLP_FUSE_MIN_ROWS": 1}, 10),
    ({"MLP_IMPL": "auto", "MLP_FUSE_MIN_ROWS": 1, "MLP_FUSE_SCOPE": "pooled"},
     3),
])
def test_fused_chain_route_launches_k7(cuda, monkeypatch, settings, chains):
    """Every eligible chain is fused, and K7 launches once per piece the
    planner makes of it (a narrow forward's chains are one piece each)."""
    for name, value in settings.items():
        monkeypatch.setattr(nnl, name, value)
    monkeypatch.setattr(mc, "_mlp_chain_plain",
                        lambda *a, **kw: pytest.fail("plain chain on the card"))
    planned = []
    pieces = mc.chain_pieces

    def spy(widths, pool_k, compute_dtype):
        out = pieces(widths, pool_k, compute_dtype)
        planned.append(len(out))
        return out

    monkeypatch.setattr(mc, "chain_pieces", spy)
    before = _build.LAUNCHES["mlp_chain"]
    out = _narrow_forward(cuda, False)
    assert len(planned) == chains
    assert _build.LAUNCHES["mlp_chain"] - before == sum(planned) == chains
    assert bool(torch.isfinite(out["score"]).all())


@pytest.mark.parametrize("setting,b,k3,k2", [("1", 1, 1, 0), ("0", 2, 0, 1)])
def test_sa1_fuse_setting_routes_sa1(cuda, monkeypatch, setting, b, k3, k2):
    """`nn_layers.SA1_FUSE`: "1" runs SA1 through K3 at b = 1, "0" through
    K2 at b = 2; the card's predictions against the CPU's (plain twins) on
    the same weights, within the bf16 tolerances of the JAX package's
    tests."""
    monkeypatch.setattr(nnl, "SA1_FUSE", setting)
    rng = np.random.RandomState(2)
    pts = torch.from_numpy((rng.rand(b, 3, 16384) * [[[0.6], [0.4], [0.3]]]
                            ).astype(np.float32))
    model = NARROW_DEPLOYED["MODEL"]
    spec = {**NARROW_DEPLOYED, "MODEL": {**model, "PN2": {
        **model["PN2"], "SA_CHANNELS": ((128, 128, 256), (64, 64, 64),
                                        (64, 64, 128))}}}   # K3's widths
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        net = build_model(load_cfg_from_dict(spec))
    want = net({"scene_points": pts})
    net = net.to(cuda)
    before = dict(_build.LAUNCHES)
    got = net({"scene_points": pts.to(cuda)})
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sa1_fused"] - before["sa1_fused"] == k3
    assert _build.LAUNCHES["ball_query_slab"] - before["ball_query_slab"] \
        == k2
    for key, w in want.items():
        d = (got[key].cpu() - w).abs()
        assert float(d.max()) <= 5e-2 and float(d.mean()) <= 5e-3, key


NARROW_CONTACT = {**NARROW_DEPLOYED, "MODEL": {
    **NARROW_DEPLOYED["MODEL"], "TYPE": "PN2", "COMPUTE_DTYPE": "float32"}}


def _table(rng, n=30000):
    """A camera-frame tabletop ~0.75 m away with a few boxes."""
    xy = rng.uniform([-0.3, -0.2], [0.3, 0.2], (n, 2))
    z = np.full(n, 0.75)
    box = (np.abs(xy[:, 0]) < 0.05) & (np.abs(xy[:, 1]) < 0.05)
    z[box] -= 0.06
    return np.column_stack([xy, z]).astype(np.float32)


def _narrow_detector(tmp_path, spec, device, seed=0, name="narrow"):
    import yaml
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(spec))
    return GraspDetector(model=str(path), device=device,
                         output_dir=str(tmp_path / f"{name}_{device}"),
                         cloud_capacity=32768, num_candidates=256, seed=seed)


def test_contact_detect_on_the_card_matches_the_cpu(cuda, tmp_path):
    """The contact model (PN2, f32) at a narrow width on the card and on
    the CPU with the same weights and draws: predictions within 1e-4, and
    a fresh model's grasp origins are its points exactly."""
    gpu = _narrow_detector(tmp_path, NARROW_CONTACT, "cuda")
    cpu = _narrow_detector(tmp_path, NARROW_CONTACT, "cpu")
    cloud = _table(np.random.RandomState(3))
    idx = torch.from_numpy(np.random.RandomState(4).choice(
        2000, 16384).astype(np.int32))
    want = cpu.eval(cloud, sample_idx=idx)
    got = gpu.eval(cloud, sample_idx=idx.to(cuda))
    for key, w in want.items():
        assert float((got[key].cpu() - w).abs().max()) <= 1e-4, key
    padded, valid = gpu._pad_cloud(cloud)
    points = prep_one(padded, valid, gpu.num_input, sample_idx=idx.to(cuda))
    assert torch.equal(got["frame_t"][0], points.t())
    poses, scores = gpu.detect(cloud, score_threshold=0.0,
                               verticalness_threshold=-1e9,
                               collision_check=False)
    assert len(poses) == len(scores) > 0
    r = torch.from_numpy(poses[:, :3, :3]).double()
    assert float((r @ r.transpose(1, 2) - torch.eye(3, dtype=torch.float64)
                  ).abs().max()) < 1e-4


def test_stream_on_the_card_equals_detect(cuda, tmp_path):
    """detect_stream at depths 1-3 yields, bit for bit, what sequential
    detect gives on a detector with the same seed."""
    frames = [_table(np.random.RandomState(s)) for s in range(4)]
    kw = {"score_threshold": 0.0, "verticalness_threshold": -1e9}
    seq = _narrow_detector(tmp_path, NARROW_DEPLOYED, "cuda", name="seq")
    want = [seq.detect(f, **kw) for f in frames]
    for depth in (1, 2, 3):
        det = _narrow_detector(tmp_path, NARROW_DEPLOYED, "cuda",
                               name=f"d{depth}")
        got = list(det.detect_stream(frames, depth=depth, **kw))
        assert len(got) == len(frames)
        for (gp, gs), (wp, ws) in zip(got, want):
            assert np.array_equal(gp, wp) and np.array_equal(gs, ws)


def test_checkpoint_saved_on_the_card_loads_back(cuda, tmp_path):
    """A checkpoint of a detector's weights on the card, saved with
    `Checkpointer`, makes a new detector with the same output directory
    give the same predictions (its `last_checkpoint`)."""
    det = _narrow_detector(tmp_path, NARROW_CONTACT, "cuda", seed=1)
    with torch.no_grad():
        det.net.t_logit.weight.normal_(0.0, 0.01)
    Checkpointer(det.output_dir).save(
        "model_001", {"model": det.net.state_dict(), "extra": {"epoch": 1}})
    again = _narrow_detector(tmp_path, NARROW_CONTACT, "cuda", seed=2)
    assert again.output_dir == det.output_dir
    cloud = _table(np.random.RandomState(5))
    idx = torch.from_numpy(np.random.RandomState(6).choice(
        2000, 16384).astype(np.int32)).to(cuda)
    want, got = det.eval(cloud, sample_idx=idx), again.eval(cloud,
                                                            sample_idx=idx)
    for key in want:
        assert torch.equal(got[key], want[key]), key


# EDGEPN2D at a narrow four-stage pyramid of the reference's shape (a
# global last stage, unsorted: exact FPS K6, full scans K2f, 3-NN K4).
NARROW_EDGE = {"MODEL": {
    "TYPE": "EDGEPN2D", "COMPUTE_DTYPE": "float32",
    "PN2": {"NUM_INPUT": 16384},
    "EDGEPN2D": {"NUM_CENTROIDS": (2048, 512, 128, 0),
                 "RADIUS": (0.02, 0.08, 0.32, -1.0),
                 "NUM_NEIGHBOURS": (32, 32, 32, -1),
                 "SA_CHANNELS": ((32, 32, 64), (64, 64, 64), (64, 64, 128),
                                 (128, 128)),
                 "FP_CHANNELS": ((64, 64), (64, 64), (64, 64), (64, 32)),
                 "NUM_FP_NEIGHBOURS": (0, 3, 3, 3),
                 "SEG_CHANNELS": (64, 32)}},
    "DATA": {"SCORE_CLASSES": 3}}


def test_edge_detect_on_the_card_matches_the_cpu(cuda, tmp_path):
    """EDGEPN2D (f32, narrow) on the card and on the CPU with the same
    weights and draws: predictions within 1e-4, launching K6, K2f and K4
    and no K1, K2 or K3; then a detect returns orthonormal grasps."""
    gpu = _narrow_detector(tmp_path, NARROW_EDGE, "cuda", name="edge")
    cpu = _narrow_detector(tmp_path, NARROW_EDGE, "cpu", name="edge")
    cloud = _table(np.random.RandomState(7))
    idx = torch.from_numpy(np.random.RandomState(8).choice(
        2000, 16384).astype(np.int32))
    want = cpu.eval(cloud, sample_idx=idx)
    _build.reset_launches()
    got = gpu.eval(cloud, sample_idx=idx.to(cuda))
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    assert launches["fps_exact"] == 3 and launches["ball_query_full"] == 3
    assert launches["three_nn"] == 1
    assert launches["fps_lane"] == launches["ball_query_slab"] == \
        launches["sa1_fused"] == 0
    for key, w in want.items():
        assert float((got[key].cpu() - w).abs().max()) <= 1e-4, key
    poses, scores = gpu.detect(cloud, score_threshold=0.0,
                               verticalness_threshold=-1e9,
                               collision_check=False)
    assert len(poses) == len(scores) > 0
    r = torch.from_numpy(poses[:, :3, :3]).double()
    assert float((r @ r.transpose(1, 2) - torch.eye(3, dtype=torch.float64)
                  ).abs().max()) < 1e-4


def test_local_forward_on_the_card_matches_the_cpu(cuda):
    """PN2_LOCAL (f32) at the narrow deployed width, b = 1 in deployment
    mode and b = 2 with candidate frames, on the card and on the CPU from
    the same weights: every output within 1e-4 (b = 2's SA1 is K3, so
    within 5e-2 there, as the bf16 tolerances of detect_batch)."""
    spec = {**NARROW_DEPLOYED, "MODEL": {**NARROW_DEPLOYED["MODEL"],
                                         "TYPE": "PN2_LOCAL",
                                         "COMPUTE_DTYPE": "float32"}}
    torch.manual_seed(0)
    net = build_model(load_cfg_from_dict(spec))
    rng = np.random.RandomState(9)
    pts = torch.from_numpy((rng.rand(2, 3, 16384) * [[0.6], [0.4], [0.3]])
                           .astype(np.float32))
    lsf = torch.from_numpy(rng.randn(2, 12, 64, 4).astype(np.float32))
    for batch, tol in (({"scene_points": pts[:1]}, 1e-4),
                       ({"scene_points": pts, "local_search_frame": lsf},
                        5e-2)):
        want = net({k: v.clone() for k, v in batch.items()})
        got = net.to(cuda)({k: v.to(cuda) for k, v in batch.items()})
        net.cpu()
        assert set(got) == set(want)
        for key, w in want.items():
            assert float((got[key].cpu() - w).abs().max()) <= tol, key


def test_eval_frames_on_the_card_matches_the_cpu(cuda):
    """`eval_frames` on the card and on the CPU on the same seeded labeled
    cloud and poses (random rotations at its points): collision and
    multi_objects equal, the antipodal score within 1e-5; on the card
    every chunk size gives the same bits."""
    from s4g_tpu_torch.pipeline.eval_cloud import eval_frames

    rng = np.random.RandomState(12)
    centers = np.array([[0.0, 0.0, 0.0], [0.07, 0.0, 0.0], [0.0, 0.08, 0.0]])
    cloud = np.concatenate([c + rng.uniform(-0.025, 0.025, (3000, 3))
                            for c in centers]).astype(np.float32)
    normals = rng.randn(len(cloud), 3)
    normals = (normals / np.linalg.norm(normals, axis=1, keepdims=True)
               ).astype(np.float32)
    labels = np.repeat(np.arange(3, dtype=np.int32), 3000)
    q, r = np.linalg.qr(rng.randn(400, 3, 3))
    q = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    poses = np.tile(np.eye(4), (400, 1, 1))
    poses[:, :3, :3] = q
    poses[:, :3, 3] = cloud[rng.choice(len(cloud), 400)] \
        - rng.uniform(0.0, 0.04, (400, 1)) * q[:, :, 0]
    g2l = np.linalg.inv(poses).astype(np.float32)
    args = [torch.from_numpy(x) for x in (g2l, cloud, normals, labels)]
    want = eval_frames(*args)
    got = eval_frames(*(a.to(cuda) for a in args))
    for g, w in zip(got[:2], want[:2]):
        assert torch.equal(g.cpu(), w)
    assert float((got[2].cpu() - want[2]).abs().max()) <= 1e-5
    assert bool((want[2] > 0).any())
    for chunk in (1, 37):
        again = eval_frames(*(a.to(cuda) for a in args), chunk=chunk)
        for g, a in zip(got, again):
            assert torch.equal(g, a)


def _factory_scene():
    """A graded ellipsoid on the table (its object data on the CPU) and a
    noisy copy of its scene cloud."""
    from s4g_tpu_torch.datagen import generate, mesh_tools, scene_compose
    data = generate.grade_object(*mesh_tools.make_ellipsoid(),
                                 rng=np.random.RandomState(0),
                                 frame_stride=3, device="cpu")
    pose = np.array([0.0, 0.0, 0.772, 1.0, 0, 0, 0])
    scene = scene_compose.compose_scene({"egg": pose}, {"egg": data},
                                        name_to_index={"egg": 0})
    rng = np.random.RandomState(1)
    clean = scene["cloud"].astype(np.float32)
    noise = clean * (1 + rng.randn(*clean.shape).astype(np.float32) * 1e-3)
    return data, scene, clean, noise


def test_grade_object_on_the_card_is_the_cpu_bits(cuda):
    """Normals, frames (one device-independent eigensolver, slot sums in
    slot order) and every score the same bits on the card as on the CPU;
    two K2f launches (estimate_normals + darboux_frames)."""
    from s4g_tpu_torch.datagen import generate, mesh_tools
    mesh = mesh_tools.make_ellipsoid()
    want = generate.grade_object(*mesh, rng=np.random.RandomState(0),
                                 frame_stride=3, device="cpu")
    _build.reset_launches()
    got = generate.grade_object(*mesh, rng=np.random.RandomState(0),
                                frame_stride=3, device="cuda")
    assert _build.LAUNCHES["ball_query_full"] == 2
    for key in want:
        if "antipodal" in key:
            assert np.abs(got[key] - want[key]).max() <= 1e-6, key
        else:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_label_transfer_on_the_card_matches_the_cpu(cuda):
    """processing_and_trace, match_to_scene and the whole view transfer on
    the same inputs: indices, masks and labels exact, scores within 1e-6."""
    from s4g_tpu_torch.datagen import label_transfer as lt
    _, scene, clean, noise = _factory_scene()
    for cap in (4096, 128):
        want = lt.processing_and_trace(torch.from_numpy(noise), cap)
        got = lt.processing_and_trace(torch.from_numpy(noise).to(cuda), cap)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
    cam = np.eye(4)
    cam[:3, 3] = [0.2, 0.1, 1.8]
    want = lt.generate_view_labels(noise, clean, cam, scene, capacity=4096,
                                   device="cpu")
    got = lt.generate_view_labels(noise, clean, cam, scene, capacity=4096,
                                  device="cuda")
    assert len(want["valid_index"]) > 0
    for key in want:
        if key in ("antipodal_score", "valid_frame"):
            assert np.abs(got[key] - want[key]).max() <= 1e-6, key
        else:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_contact_and_baseline_on_the_card_match_the_cpu(cuda):
    """The contact flavour, its refinement and the baseline payload on the
    same inputs: frames and counts exact, maps within 1e-6."""
    from s4g_tpu_torch.datagen import baseline_data, contact, refine_contact
    data, _, _, _ = _factory_scene()
    cloud, normals = data["cloud"], data["normal"]
    want = contact.generate_contact_object_data(
        cloud, normals, max_pairs=256, rng=np.random.RandomState(0),
        device="cpu")
    got = contact.generate_contact_object_data(
        cloud, normals, max_pairs=256, rng=np.random.RandomState(0),
        device="cuda")
    assert len(want["search_score"]) > 0
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    ref_w = refine_contact.refine_contact_object(want, device="cpu")
    ref_g = refine_contact.refine_contact_object(want, device="cuda")
    for key in ref_w:
        np.testing.assert_array_equal(ref_g[key], ref_w[key], err_msg=key)
    pose = want["global_to_local"][0]
    pw = baseline_data.baseline_grasp_data(pose, cloud, normals, 256, "cpu")
    pg = baseline_data.baseline_grasp_data(pose, cloud, normals, 256, "cuda")
    assert pg["num_close_points"] == pw["num_close_points"] > 0
    for key in ("close_region_points", "close_region_projection_maps"):
        assert np.abs(pg[key] - pw[key]).max() <= 1e-6, key


def test_eval_view_on_the_card_launches_k5(cuda):
    """generate_eval_view at G * N >= KERNEL_MIN_PAIRS: one K5 launch and
    two K2f; the same record as on the CPU (masks exact, scores 1e-5)."""
    from s4g_tpu_torch.datagen import eval_data
    from s4g_tpu_torch.datagen.label_transfer import SAMPLE_REGION
    _, scene, _, noise = _factory_scene()
    table = np.random.RandomState(2).uniform(-0.1, 0.1, (4000, 3))
    table[:, 2] = 0.75
    view = np.concatenate([noise, table]).astype(np.float32)
    g = 2000
    picks = min(g, int((view[:, 2] > SAMPLE_REGION).sum()))
    assert picks * len(view) >= nb.KERNEL_MIN_PAIRS
    cam = np.array([0.2, 0.1, 1.8], np.float32)
    want = eval_data.generate_eval_view(view, cam, scene, g,
                                        rng=np.random.RandomState(0),
                                        with_baseline=True, device="cpu")
    _build.reset_launches()
    got = eval_data.generate_eval_view(view, cam, scene, g,
                                       rng=np.random.RandomState(0),
                                       with_baseline=True, device="cuda")
    assert _build.LAUNCHES["collision_counts"] == 1
    assert _build.LAUNCHES["ball_query_full"] == 2
    for key in ("frames", "non_collision_bool", "single_label_bool",
                "scene_collision_bool", "baseline_index"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(got["antipodal_score"],
                               want["antipodal_score"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["close_region_projection_maps"],
                               want["close_region_projection_maps"], rtol=0,
                               atol=1e-6)


# -- the label factory's tools slice: host ops, guard, measure_fps_sharded -------

def test_host_ops_native_matches_numpy_on_the_card_host(cuda):
    """The native host library builds on the card's machine and equals its
    numpy paths on a 4,096-point cloud (the numpy outlier and 1-NN paths
    are n x n: the whole scene would take ~50 GB)."""
    from s4g_tpu_torch.runtime import host_ops as ho
    assert ho.native_available()
    rng = np.random.RandomState(5)
    pts = (rng.rand(4096, 3) * [0.3, 0.2, 0.1]).astype(np.float32)
    assert np.array_equal(ho.radius_outlier_mask(pts, 0.01, 8),
                          ho.numpy_radius_outlier_mask(pts, 0.01, 8))
    q = pts[::4] + rng.normal(0, 1e-3, (1024, 3)).astype(np.float32)
    for got, want in zip(ho.nearest_neighbor_match(q, pts, 0.002),
                         ho.numpy_nearest_neighbor_match(q, pts, 0.002)):
        assert np.array_equal(got, want)
    p, t = ho.voxel_downsample_trace(pts, 0.02)
    wp, wt = ho.numpy_voxel_downsample_trace(pts, 0.02, pts.min(0))
    o, wo = np.argsort(t), np.argsort(wt)
    assert np.array_equal(t[o], wt[wo])
    # the library sums in float64, numpy in float32: a few ulps apart
    assert np.abs(p[o] - wp[wo]).max() <= 4 * np.finfo(np.float32).eps * \
        np.abs(wp).max()


def test_guard_probes_find_the_card(cuda):
    from s4g_tpu_torch.runtime import guard
    ok, line = guard.backend_reachable(timeout_s=300)
    assert ok, line
    assert guard.kernels_build(timeout_s=600)


def test_measure_fps_sharded_names_k1_and_k6(cuda, tmp_path):
    """The tool's trace, read by `device_kernel_times`, names K1's kernel
    at G = 128 and K6's at G = 1, and their time is the device time."""
    from s4g_tpu_torch.tools import measure_fps_sharded
    for g, name in ((128, "fps_lane_kernel"), (1, "fps_cluster_kernel")):
        got = measure_fps_sharded.main(["25600", "5120", str(g),
                                        "--trace-dir", str(tmp_path)])
        names = [row[2] for row in got["kernels"]]
        assert any(name in n for n in names), names
        assert got["device_ms_per_exec"] > 0


# -- data parallelism on the card (s4g_tpu_torch.parallel) -----------------------

def _gpu_detector(tmp, name, mesh=None):
    from test_torch_port_parallel import CANDIDATES, CAPACITY
    return GraspDetector(model=os.path.join(tmp, "tiny.yaml"),
                         output_dir=os.path.join(tmp, name),
                         cloud_capacity=CAPACITY, num_candidates=CANDIDATES,
                         seed=5, mesh=mesh)


def _nccl_rank(rank, world, tmp, port):
    """A launched world of one: its mesh takes NCCL.  Two train steps and
    a detect_batch with the mesh and without, under
    use_deterministic_algorithms (the gather's backward sums with atomics
    otherwise)."""
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      CUBLAS_WORKSPACE_CONFIG=":4096:8")
    import torch.distributed as dist
    from s4g_tpu_torch.parallel import make_mesh
    from test_torch_port_parallel import NUM_SELECTED, THRESHOLDS, clouds
    from test_torch_port_parallel_train import (_flat, _steps, tiny_batch,
                                                tiny_cfg)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    torch.use_deterministic_algorithms(True, warn_only=True)
    mesh = make_mesh()
    out = {"backend": dist.get_backend()}
    for name, m in (("mesh", mesh), ("plain", None)):
        _flat(f"{name}/train/", _steps(
            m, tiny_cfg(0.5, ("PointCloudRotate",)),
            [tiny_batch(4, s) for s in range(2)],
            os.path.join(tmp, name), device="cuda"), out)
        det = _gpu_detector(tmp, f"det_{name}", m)
        for i, (p, s) in enumerate(det.detect_batch(
                clouds(2), num_selected=NUM_SELECTED, **THRESHOLDS)):
            out[f"{name}/detect/{i}/poses"] = p
            out[f"{name}/detect/{i}/scores"] = s
    np.savez(os.path.join(tmp, "nccl.npz"), **out)
    dist.destroy_process_group()


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_nccl_world_of_one_is_bit_exact(cuda, tmp_path):
    """A world of one launched as torchrun launches it takes NCCL; two
    train steps (dropout and augmentation on) and a detect_batch with its
    mesh are bit for bit the same calls without one."""
    import torch.multiprocessing as mp
    import yaml
    from test_torch_port_parallel import TINY
    (tmp_path / "tiny.yaml").write_text(yaml.safe_dump(TINY))
    mp.start_processes(_nccl_rank, args=(1, str(tmp_path), _free_port()),
                       nprocs=1, start_method="spawn")
    got = dict(np.load(tmp_path / "nccl.npz"))
    assert str(got["backend"]) == "nccl"
    plain = {k[len("plain/"):]: v for k, v in got.items()
             if k.startswith("plain/")}
    assert len(plain) > 20
    for k, v in plain.items():
        np.testing.assert_array_equal(got[f"mesh/{k}"], v, err_msg=k)


def _gloo_rank(rank, world, tmp):
    """One of two gloo ranks that share cuda:0: two sharded train steps,
    and detect_batch over 4 scenes with its draws recorded, then a single
    process's call over this rank's scenes on those draws."""
    import torch.distributed as dist
    from s4g_tpu_torch.parallel import make_mesh, shard_rows
    from test_torch_port_parallel import (NUM_SELECTED, THRESHOLDS, _recording,
                                          _replaying, _results, _run, clouds)
    from test_torch_port_parallel_train import (_flat, _steps, tiny_batch,
                                                tiny_cfg)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            rank=rank, world_size=world)
    mesh = make_mesh(["cuda:0"] * world)
    out = {"backend": dist.get_backend()}
    _flat("train/", _steps(mesh, tiny_cfg(0.5, ("PointCloudRotate",)),
                           [tiny_batch(4, s) for s in range(2)],
                           os.path.join(tmp, f"train{rank}")), out)
    det = _gpu_detector(tmp, f"det{rank}", mesh)
    samples, uniforms = [], []
    _results("sharded", _run(_recording(samples, uniforms),
                             lambda: det.detect_batch(
                                 clouds(4), num_selected=NUM_SELECTED,
                                 **THRESHOLDS)), out)
    rows = shard_rows(mesh, 4)
    single = _gpu_detector(tmp, f"single{rank}")
    _results("replayed", _run(_replaying(samples, uniforms[0][rows]),
                              lambda: single.detect_batch(
                                  clouds(4)[rows], num_selected=NUM_SELECTED,
                                  **THRESHOLDS)), out)
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


def test_two_gloo_ranks_share_the_card(cuda, tmp_path):
    """Two gloo ranks on cuda:0 (NCCL refuses two ranks on one GPU): the
    ranks' train states, gradients and generators bit for bit equal, the
    losses and gradients within tests/test_train.py's data-parallel
    tolerances of one process's steps on the card; detect_batch returns
    the same four results on both ranks, each rank's scenes bit for bit a
    single process's call over them on the same draws."""
    import torch.multiprocessing as mp
    import yaml
    from test_torch_port_parallel import TINY
    from test_torch_port_parallel_train import (_flat, _steps, tiny_batch,
                                                tiny_cfg)
    (tmp_path / "tiny.yaml").write_text(yaml.safe_dump(TINY))
    mp.start_processes(_gloo_rank, args=(2, str(tmp_path)), nprocs=2,
                       start_method="spawn")
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    assert str(ranks[0]["backend"]) == "gloo"
    for k, v in ranks[0].items():
        if k.startswith(("train/grads", "train/state", "train/generator",
                         "sharded/")):
            np.testing.assert_array_equal(ranks[1][k], v, err_msg=k)
    for r, got in enumerate(ranks):
        for i in range(2):
            for part in ("poses", "scores"):
                np.testing.assert_array_equal(
                    got[f"replayed/{i}/{part}"],
                    got[f"sharded/{2 * r + i}/{part}"])
    want = _flat("train/", _steps(None, tiny_cfg(0.5, ("PointCloudRotate",)),
                                  [tiny_batch(4, s) for s in range(2)],
                                  str(tmp_path / "single"),
                                  device="cuda"), {})
    for k, v in want.items():
        got = ranks[0][k]
        if k.startswith("train/scalars"):
            np.testing.assert_allclose(got, v, rtol=2e-5, atol=1e-7,
                                       err_msg=k)
        elif k.startswith("train/grads0"):
            scale = max(float(np.abs(v).max()), 1e-3)
            np.testing.assert_allclose(got, v, rtol=2e-3, atol=5e-4 * scale,
                                       err_msg=k)


def _collision_index(rng, b, n, m, case):
    """(B, M) int32 indices into N: "heavy" sends 70 % of the positions to
    three rows, "lone" every position to row 3, "sparse" leaves most rows
    without a source, "random" is uniform."""
    if case == "lone":
        return np.full((b, m), 3, np.int32)
    idx = rng.randint(0, n, (b, m))
    if case == "heavy":
        idx = np.where(rng.rand(b, m) < 0.7, rng.randint(0, 3, (b, m)), idx)
    elif case == "sparse":
        idx = rng.randint(0, max(n // 50, 1), (b, m)) * 50
    return idx.astype(np.int32)


@pytest.mark.parametrize("b,n,m,c,dtype,case", [
    (2, 50, 4000, 131, torch.float32, "heavy"),     # SA2's 259 less, ragged
    (1, 300, 2000, 3, torch.float32, "random"),     # C below a warp
    (2, 64, 5000, 640, torch.bfloat16, "heavy"),    # five channel passes
    (3, 100, 1000, 7, torch.float64, "heavy"),
    (1, 40, 800, 33, torch.bfloat16, "lone"),       # one row takes all
    (2, 5000, 300, 129, torch.float32, "sparse"),   # rows with no source
    (4, 1024, 3 * 5120, 512, torch.float32, "random"),  # FP2's 3-NN shape
])
def test_gather_backward_kernel_matches_plain(cuda, b, n, m, c, dtype,
                                              case):
    """K8 on the card equals its plain twin on the CPU bit for bit: both add
    each row's sources in ascending order in f32 (f64 for f64) and round
    once; a row with no source is 0."""
    from s4g_tpu_torch.ops import gather as gt
    rng = np.random.RandomState(m + c)
    idx = torch.from_numpy(_collision_index(rng, b, n, m, case))
    grad = torch.from_numpy(rng.randn(b, m, c)).to(dtype)
    want = gt.gather_backward(grad, idx, n)
    before = _build.LAUNCHES["gather_backward"]
    got = gt.gather_backward(grad.to(cuda), idx.to(cuda), n)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["gather_backward"] == before + 1
    assert got.dtype == dtype and got.shape == (b, n, c)
    assert torch.equal(got.cpu(), want)


def test_narrow_train_step_repeats_bit_for_bit(cuda, tmp_path):
    """A narrow bf16 train step with dropout, run twice on the card from one
    state (model, optimizer moments, generator): the scalars, every
    gradient and the state after the update (parameters after Adam,
    BatchNorm statistics) equal bit for bit, K8 launched once per gather
    that carries a gradient (SA2, SA3 and each FP stage's three
    neighbours)."""
    import pickle
    from chip_smoke import NARROW_TRAIN, train_scene
    from s4g_tpu_torch.tools.train_repeat import rerun
    from s4g_tpu_torch.train.dataset import SceneGraspDataset
    from s4g_tpu_torch.train.trainer import Trainer
    data = tmp_path / "data"
    data.mkdir()
    for i in range(2):
        with open(data / f"{i}_view_0.p", "wb") as f:
            pickle.dump(train_scene(np.random.RandomState(200 + i)), f)
    spec = {**NARROW_TRAIN, "MODEL": {
        **NARROW_TRAIN["MODEL"], "COMPUTE_DTYPE": "bfloat16",
        "PN2": {**NARROW_TRAIN["MODEL"]["PN2"], "DROPOUT_PROB": 0.5}}}
    cfg = load_cfg_from_dict(spec)
    batch = next(iter(SceneGraspDataset(
        str(data), num_points=cfg.MODEL.PN2.NUM_INPUT, batch_size=2,
        num_frame_points=128, seed=0)))
    tr = Trainer(cfg, output_dir=str(tmp_path / "out"), device="cuda")
    tr.init_state()
    before = _build.LAUNCHES["gather_backward"]
    spread = rerun(tr, batch)
    assert _build.LAUNCHES["gather_backward"] == before + 2 * 11
    assert all(v["bit_equal"] for v in spread.values()), spread

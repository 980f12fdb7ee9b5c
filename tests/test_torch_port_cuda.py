"""The port's CUDA kernels against their plain PyTorch twins on the card, at
edge shapes the main path does not reach: ragged tiles, windows that run
past the last point, exact ties, invalid rows.  chip_smoke.py holds the
kernels at the main path's shapes.

Needs a CUDA device (a CUDA kernel has no CPU mode), so every test carries
the `cuda` marker and skips without one.  On a machine with a GPU and no
JAX (the tests here import no JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_cuda.py -q
"""

import numpy as np
import pytest
import torch

from s4g_tpu_torch import _build
from s4g_tpu_torch.ops import neighbors as nb
from s4g_tpu_torch.ops import sampling as sp
from s4g_tpu_torch.pipeline import collision as col

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


@pytest.mark.parametrize("n1,n2,grid", [(3000, 5000, None), (700, 4099, 0.05),
                                        (129, 3, None)])
def test_three_nn_kernel_matches_plain(cuda, n1, n2, grid):
    rng = np.random.RandomState(n2)
    q = torch.from_numpy(rng.rand(2, 3, n1).astype(np.float32))
    keys = rng.rand(2, 3, n2).astype(np.float32)
    if grid is not None:                          # duplicate keys: ties
        keys = (np.round(keys / grid) * grid).astype(np.float32)
    keys = torch.from_numpy(keys)
    want_i, want_d = nb._three_nn_plain(q, keys)
    got_i, got_d = nb.three_nn_fused(q.to(cuda), keys.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got_i.cpu(), want_i)
    assert torch.equal(got_d.cpu(), want_d)


@pytest.mark.parametrize("g,n", [(1001, 20000), (8, 65536)])
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

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
    # The largest N whose ballot words fit a block's 227 KB of shared
    # memory: 32 * ((232448 - 24576) // 160).
    (1, 41568, 40, 0.05, 24, 0.0),
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
    # One point more than 1,024 threads with 32 min-distances each hold.
    with pytest.raises(RuntimeError, match="fps_exact failed to launch"):
        sp.fps_exact(torch.rand(1, 3, 1024 * 32 + 1, device=cuda), 10)
    cents = pts[:, :, :10].contiguous()
    with pytest.raises(TypeError):
        nb.ball_query_full_scan(pts, cents.double(), 0.1, 8)
    with pytest.raises(ValueError, match="mixed devices"):
        nb.ball_query_full_scan(pts, cents.cpu(), 0.1, 8)
    with pytest.raises(RuntimeError,
                       match="ball_query_full failed to launch"):
        nb.ball_query_full_scan(torch.rand(1, 3, 41568 + 1, device=cuda),
                                cents, 0.1, 8)
    before = _build.LAUNCHES["ball_query_full"]
    nb.ball_query(pts, cents, 0.1, 8)
    assert _build.LAUNCHES["ball_query_full"] == before + 1


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
    wide = torch.zeros(128, 256, device=cuda)     # C2 = 256: not held
    with pytest.raises(ValueError, match="holds"):
        sf.sa1_fused_slab(p, c, lo, 0.05, 16, w1, b1,
                          (wide, torch.zeros(256, 256, device=cuda)),
                          (torch.zeros(256, device=cuda), b3))
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
    monkeypatch.setattr(mc, "_mlp_chain_plain",
                        lambda *a, **kw: pytest.fail("plain chain on the card"))
    with pytest.raises(ValueError, match="mixed devices"):
        mc.mlp_chain(x.cpu(), params, (True, True))
    with pytest.raises(ValueError, match="up to 4 layers"):
        five = [(torch.eye(40, device=cuda), torch.zeros(40, device=cuda))] * 5
        mc.mlp_chain(x, five, (True,) * 5)
    with pytest.raises(RuntimeError, match="mlp_chain failed to launch"):
        mc.mlp_chain(x[:48], params, (True, True), pool_k=24)  # not 2^k
    wide = torch.zeros(4096, 16, device=cuda)   # a 32-row tile: 262 KB
    with pytest.raises(RuntimeError, match="mlp_chain failed to launch"):
        mc.mlp_chain(torch.zeros(8, 4096, device=cuda),
                     [(wide, torch.zeros(16, device=cuda))], (True,))
    before = _build.LAUNCHES["mlp_chain"]
    mc.mlp_chain(x, params, (True, True), pool_k=16)
    assert _build.LAUNCHES["mlp_chain"] == before + 1


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


def _narrow_forward(cuda, dense_column):
    """One b = 1 forward of a narrow deployed PN2_CLS (sorted cloud, SA1
    above the slab capacity) on a seeded cloud; with `dense_column`, most
    points share one sliver along the sort axis, so SA1's slab windows
    overflow."""
    rng = np.random.RandomState(1)
    pts = (rng.rand(1, 3, 16384) * [[[0.6], [0.4], [0.3]]]).astype(np.float32)
    if dense_column:
        pts[0, 0, :13000] = 0.3 + 0.001 * rng.rand(13000)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        net = build_model(load_cfg_from_dict(NARROW_DEPLOYED)).to(cuda)
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


@pytest.mark.parametrize("settings,chains", [
    ({"MLP_IMPL": "fused"}, 10),
    ({"MLP_IMPL": "auto", "MLP_FUSE_MIN_ROWS": 1}, 10),
    ({"MLP_IMPL": "auto", "MLP_FUSE_MIN_ROWS": 1, "MLP_FUSE_SCOPE": "pooled"},
     3),
])
def test_fused_chain_route_launches_k7(cuda, monkeypatch, settings, chains):
    for name, value in settings.items():
        monkeypatch.setattr(nnl, name, value)
    monkeypatch.setattr(mc, "_mlp_chain_plain",
                        lambda *a, **kw: pytest.fail("plain chain on the card"))
    before = _build.LAUNCHES["mlp_chain"]
    out = _narrow_forward(cuda, False)
    assert _build.LAUNCHES["mlp_chain"] - before == chains
    assert bool(torch.isfinite(out["score"]).all())

"""The port's routes for inputs past its kernels' old limits, and K5's and
K2f's twins, against the JAX package on the CPU.

On the CPU every kernel wrapper takes its plain twin, so these tests hold
the functions the card computes through other routes:

* the fused SA1 stage outside K3's range (`sa_fused._sa1_wide`: K2's
  selection feeding K7) against `sa1_fused_slab_pallas(interpret=True)`;
* a K7 chain split into sub-chains (`mlp_chain.chain_pieces`), and a
  layer wider than any row tile, against `mlp_chain_pallas(interpret=True)`;
* K2f's full scan on sorted scenes, and the selection K2f makes there
  when it scans only each ball's slab (`_slab_scan`, a plain model of the
  kernel's restriction kept here), against the JAX full scan
  (`_first_k_in_range`), and K2f and K6 past their old sizes;
* K5's twin against `collision_counts_pallas(interpret=True)`, run in a
  child process whose XLA may not use FMA.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from s4g_tpu.ops import neighbors as jnb
from s4g_tpu.ops import sampling as jsamp
from s4g_tpu.ops.pallas.mlp_kernels import mlp_chain_pallas
from s4g_tpu.ops.pallas.sa_fused_kernels import (sa1_fused_slab_pallas,
                                                 sa1_slab_setup as j_setup)

from s4g_tpu_torch.ops import mlp_chain as mc
from s4g_tpu_torch.ops import neighbors as tnb
from s4g_tpu_torch.ops import sa_fused as sf
from s4g_tpu_torch.ops import sampling as tsamp
from s4g_tpu_torch.pipeline import collision as tcol


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# -- the fused SA1 stage outside K3's range: K2 + K7 ---------------------------

@pytest.mark.parametrize("widths,k,radius", [
    ((256, 256, 512), 64, 0.05),    # wider SA1 layers
    ((128, 128, 384), 48, 0.2),     # C3 > 256; K padded to 64; overfull
])
def test_sa1_wide_route_matches_jax_kernel(widths, k, radius):
    rng = np.random.RandomState(k)
    n, m = 4096, 512
    pts = np.sort(rng.rand(1, n).astype(np.float32))[:, None, :] * 0.5
    pts = np.concatenate([pts, rng.rand(1, 2, n).astype(np.float32) * 0.5],
                         axis=1)
    cent = np.ascontiguousarray(pts[:, :, np.sort(rng.choice(n, m, False))])
    cent[:, :, -40:] += np.float32(10.0)          # empty balls, still sorted
    c1, c2, c3 = widths
    w1, b1, w2, b2, w3, b3 = (
        (rng.randn(*shape) * scale).astype(np.float32)
        for shape, scale in (((3, c1), 0.5), ((c1,), 0.1), ((c1, c2), 0.1),
                             ((c2,), 0.1), ((c2, c3), 0.1), ((c3,), 0.1)))
    lo_j, _ = j_setup(jnp.asarray(pts[:, 0]), jnp.asarray(cent[:, 0]),
                      radius, n)
    want = np.asarray(sa1_fused_slab_pallas(
        jnp.asarray(pts), jnp.asarray(cent), lo_j, radius, k,
        jnp.asarray(w1), jnp.asarray(b1), (jnp.asarray(w2), jnp.asarray(w3)),
        (jnp.asarray(b2), jnp.asarray(b3)), interpret=True, stratified=True))
    lo_t, _ = sf.sa1_slab_setup(_t(pts[:, 0]), _t(cent[:, 0]), radius, n)
    args = (_t(pts), _t(cent), lo_t, radius, k, _t(w1), _t(b1),
            (_t(w2), _t(w3)), (_t(b2), _t(b3)))
    got = sf._sa1_wide(*args).numpy()
    twin = sf._sa1_fused_plain(*args).numpy()
    assert got.shape == want.shape == (1, m, c3)
    empty = ~np.any(want, axis=-1)
    assert empty[0, -40:].all() and not empty.all()
    assert not np.any(got[empty]) and not np.any(twin[empty])   # exact zeros
    # K3's tolerance: f32 sums in another order flip an odd bf16 rounding
    # of a hidden activation.
    scale = float(np.abs(want).max())
    assert scale > 0.1
    assert float(np.abs(got - want).max()) <= 1e-2 * scale
    assert float(np.abs(got - twin).max()) <= 1e-2 * scale


# -- K7 chains split into sub-chains ------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_split_chain_matches_jax_kernel(dtype):
    """A 6-layer pooled chain runs as 4 + 2 layers; composed through the
    twin it is `mlp_chain_pallas`'s chain (the split rounds where the
    kernel rounds a hidden layer)."""
    rng = np.random.RandomState(6)
    widths = (3, 64, 64, 128, 128, 256, 256)
    p, pool = 512, 32
    x = rng.randn(p, widths[0]).astype(np.float32)
    params = [((rng.randn(widths[i], widths[i + 1])
                / np.sqrt(widths[i])).astype(np.float32),
               (rng.randn(widths[i + 1]) * 0.1).astype(np.float32))
              for i in range(6)]
    relu = (True, True, False, True, True, True)
    cd = getattr(torch, dtype)
    pieces = mc.chain_pieces(widths, pool, cd)
    assert pieces == [(0, 4), (4, 6)]
    want = np.asarray(mlp_chain_pallas(
        jnp.asarray(x), tuple((jnp.asarray(w), jnp.asarray(b))
                              for w, b in params), relu, pool,
        getattr(jnp, dtype), interpret=True))
    got = mc.run_pieces(_t(x), [(_t(w), _t(b)) for w, b in params], relu,
                        pool, cd, pieces, mc._mlp_chain_plain)
    assert got.shape == want.shape == (p // pool, widths[-1])
    scale = float(np.abs(want).max())
    tol = 1e-5 if dtype == "float32" else 1e-2
    assert float(np.abs(got.numpy() - want).max()) <= tol * scale
    whole = mc._mlp_chain_plain(_t(x), [(_t(w), _t(b)) for w, b in params],
                                relu, pool, cd)
    assert torch.equal(got, whole)   # the split changes no bit


@pytest.mark.parametrize("widths,pool,dtype,pieces", [
    # FP1: two 64-row bf16 buffers of 1,536 + 1,024 do not fit, one layer a
    # launch
    ((1536, 1024, 1024), None, torch.bfloat16, [(0, 1), (1, 2)]),
    ((515, 512, 512, 1024), 64, torch.bfloat16, [(0, 3)]),  # SA3
    ((40,) * 6, None, torch.bfloat16, [(0, 4), (4, 5)]),    # 5 layers
    ((4096, 64, 32), None, torch.bfloat16, [(0, 1), (1, 2)]),   # wide input
    ((1024, 3000, 64), 8, torch.float32, [(0, 1), (1, 2)]),
])
def test_chain_pieces(widths, pool, dtype, pieces):
    assert mc.chain_pieces(widths, pool, dtype) == pieces


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("widths,pool", [((1536, 1024, 1024), None),
                                         ((1280, 512, 512), 16)])
def test_per_layer_pieces_match_jax(widths, pool, dtype):
    """FP1's and FP2's widths, which the planner runs one layer a launch in
    bf16 (two activation buffers do not fit), composed through the twin
    are `mlp_chain_pallas`'s chain, and equal the unsplit twin bit for bit
    (in f32 too, run through the same pieces)."""
    rng = np.random.RandomState(len(widths) + (pool or 0))
    p = 256
    x = rng.randn(p, widths[0]).astype(np.float32)
    params = [((rng.randn(a, b) / np.sqrt(a)).astype(np.float32),
               (rng.randn(b) * 0.1).astype(np.float32))
              for a, b in zip(widths, widths[1:])]
    relu = (False, True)
    per_layer = [(0, 1), (1, 2)]
    assert mc.chain_pieces(widths, pool, torch.bfloat16) == per_layer
    cd = getattr(torch, dtype)
    want = np.asarray(mlp_chain_pallas(
        jnp.asarray(x), tuple((jnp.asarray(w), jnp.asarray(b))
                              for w, b in params), relu, pool,
        getattr(jnp, dtype), interpret=True))
    tparams = [(_t(w), _t(b)) for w, b in params]
    got = mc.run_pieces(_t(x), tparams, relu, pool, cd, per_layer,
                        mc._mlp_chain_plain)
    assert got.shape == want.shape == (p // (pool or 1), widths[-1])
    scale = float(np.abs(want).max())
    assert scale > 0.1
    tol = 1e-5 if dtype == "float32" else 1e-2
    assert float(np.abs(got.numpy() - want).max()) <= tol * scale
    assert torch.equal(got, mc._mlp_chain_plain(_t(x), tparams, relu, pool,
                                                cd))


@pytest.mark.parametrize("widths,pool,dtype,pieces,whole", [
    ((1536, 16), None, torch.bfloat16, [(0, 1)], True),   # widest whole tile
    ((1537, 16), None, torch.bfloat16, [(0, 1)], False),  # channels split
    ((3616, 16), None, torch.float32, [(0, 1)], True),
    ((3632, 16), None, torch.float32, [(0, 1)], False),
    ((64, 7300, 32, 16), 8, torch.bfloat16, [(0, 1), (1, 2), (2, 3)], False),
])
def test_chain_pieces_splits_the_input_channels(widths, pool, dtype, pieces,
                                                whole):
    """Past the widest tile a layer is a piece of its own, which the kernel
    runs by splitting its input channels (no width is refused)."""
    assert mc.chain_pieces(widths, pool, dtype) == pieces
    a, b = next(p for p in pieces if widths[p[0]] > 1024)
    kpads = mc.padded_widths(widths, dtype)
    last = pool if b == len(widths) - 1 else None
    assert mc._fits(kpads[a:b], kpads[b], last, dtype) is whole


@pytest.mark.parametrize("pool", [None, 16])
@pytest.mark.parametrize("dtype,width", [("bfloat16", 7300),
                                         ("float32", 3700)])
def test_wide_layer_matches_jax_kernel(dtype, width, pool):
    """A layer wider than any row tile (the kernel sums its input channels
    in chunks): the twin against `mlp_chain_pallas`, with and without the
    group max, within K7's tolerances."""
    rng = np.random.RandomState(width)
    p, c_out = 64, 48
    x = rng.randn(p, width).astype(np.float32)
    w = (rng.randn(width, c_out) / np.sqrt(width)).astype(np.float32)
    b = (rng.randn(c_out) * 0.1).astype(np.float32)
    cd = getattr(torch, dtype)
    assert mc.chain_pieces((width, c_out), pool, cd) == [(0, 1)]
    want = np.asarray(mlp_chain_pallas(
        jnp.asarray(x), ((jnp.asarray(w), jnp.asarray(b)),), (True,), pool,
        getattr(jnp, dtype), interpret=True))
    got = mc.mlp_chain(_t(x), [(_t(w), _t(b))], (True,), pool, cd)
    assert got.shape == want.shape == (p // (pool or 1), c_out)
    scale = float(np.abs(want).max())
    assert scale > 0.1
    tol = 1e-5 if dtype == "float32" else 1e-2
    assert float(np.abs(got.numpy() - want).max()) <= tol * scale


def test_wide_hidden_layer_matches_jax_kernel():
    """A wide hidden layer: the chain splits before and after it (the
    split rounds where the kernel rounds a hidden layer) and, composed
    through the twin, is `mlp_chain_pallas`'s chain."""
    rng = np.random.RandomState(7)
    widths, p, pool = (32, 7300, 48), 64, 16
    x = rng.randn(p, widths[0]).astype(np.float32)
    params = [((rng.randn(a, b) / np.sqrt(a)).astype(np.float32),
               (rng.randn(b) * 0.1).astype(np.float32))
              for a, b in zip(widths, widths[1:])]
    pieces = mc.chain_pieces(widths, pool, torch.bfloat16)
    assert pieces == [(0, 1), (1, 2)]
    want = np.asarray(mlp_chain_pallas(
        jnp.asarray(x), tuple((jnp.asarray(w), jnp.asarray(b))
                              for w, b in params), (True, True), pool,
        jnp.bfloat16, interpret=True))
    tparams = [(_t(w), _t(b)) for w, b in params]
    got = mc.run_pieces(_t(x), tparams, (True, True), pool, torch.bfloat16,
                        pieces, mc._mlp_chain_plain)
    scale = float(np.abs(want).max())
    assert float(np.abs(got.numpy() - want).max()) <= 1e-2 * scale
    assert torch.equal(got, mc._mlp_chain_plain(_t(x), tparams, (True, True),
                                                pool, torch.bfloat16))


# -- K2f on sorted scenes, and past its old size --------------------------------

def _sorted_scenes(rng, n, m):
    """Two scenes sorted along x, with duplicate keys, centroids among
    their points, and, for scene 0's first centroids, keys placed exactly
    at the slab margin and just inside the radius along x."""
    pts = (rng.rand(2, 3, n) * np.array([[[0.8], [0.5], [0.3]]])
           ).astype(np.float32)
    pts[:, :, n // 2:n // 2 + 200] = pts[:, :, n // 2:n // 2 + 1]  # dups
    pts = np.take_along_axis(pts, np.argsort(pts[:, 0], axis=1,
                                             kind="stable")[:, None], axis=2)
    cent = np.ascontiguousarray(
        pts[:, :, np.sort(rng.choice(n, m, replace=False))])
    return pts, cent


def _slab_margin(r2, c):
    """Half-width of a ball's slab along an ascending coordinate
    (`slab_select.cuh`'s `margin`): a key farther than this from the
    centroid along it has a squared distance above r2.  r2 an f32 scalar
    tensor, c the centroids' coordinates (f32)."""
    return 1.05 * torch.sqrt(r2) + 1e-5 * c.abs()


def _slab_scan(points, centroids, radius2, k, sorted_axis, stratified=False):
    """The selection K2f makes on scenes promised to ascend along
    `sorted_axis`: a scene whose key coordinate ascends is scanned only over
    the 32-key words that hold each centroid's slab (`_slab_margin`, found
    by searchsorted); one that does not is scanned in full."""
    b, _, n = points.shape
    r2 = torch.tensor(tnb._f32(radius2), dtype=torch.float32)
    pkeys = tnb._axis_keys(points, sorted_axis)
    ckeys = tnb._axis_keys(centroids, sorted_axis)
    col = torch.arange(n)
    idx_out, cnt_out = [], []
    for bi in range(b):
        ka = pkeys[bi].contiguous()
        mask = tnb.pairwise_sqdist_exact(centroids[bi], points[bi]) < r2
        if bool(torch.all(ka[1:] >= ka[:-1])):
            ca = ckeys[bi]
            mg = _slab_margin(r2, ca)
            lo = torch.searchsorted(ka, ca - mg, side="left") // 32 * 32
            hi = -(-torch.searchsorted(ka, ca + mg, side="right") // 32) * 32
            mask &= (col[None] >= lo[:, None]) & (col[None] < hi[:, None])
        i, c = tnb._select_in_range(mask, k, stratified)
        idx_out.append(i)
        cnt_out.append(c)
    return torch.stack(idx_out), torch.stack(cnt_out)


def _margin_keys(pts, cent, r2):
    """Scene 0: for centroids 0..9, keys at exactly c_x -+ margin (out of
    range) and at c_x -+ 0.999 r (in range), y and z the centroid's; the
    scene re-sorted along x."""
    c = torch.from_numpy(cent[0, 0, :10])
    mg = _slab_margin(torch.tensor(r2, dtype=torch.float32), c).numpy()
    r = np.float32(np.sqrt(r2))
    new = []
    for j in range(10):
        for dx in (-mg[j], mg[j], -0.999 * r, 0.999 * r):
            new.append([cent[0, 0, j] + np.float32(dx), cent[0, 1, j],
                        cent[0, 2, j]])
    new = np.asarray(new, np.float32).T
    pts[0, :, -new.shape[1]:] = new
    pts[0] = pts[0][:, np.argsort(pts[0, 0], kind="stable")]
    return pts


@pytest.mark.parametrize("radius,k,stratified", [
    (0.08, 64, True),     # SA2's radius and K
    (0.32, 16, True),     # overfull balls, stratified ranks
    (0.32, 16, False),    # overfull balls, first K
])
def test_sorted_full_scan_matches_jax(radius, k, stratified):
    rng = np.random.RandomState(int(radius * 100) + k)
    n, m = 2048, 256
    pts, cent = _sorted_scenes(rng, n, m)
    pts = _margin_keys(pts, cent, np.float32(radius * radius))
    pts[1, 0, [7, n - 9]] = pts[1, 0, [n - 9, 7]]   # scene 1 breaks it
    want = jnb.ball_query(jnp.asarray(pts), jnp.asarray(cent), radius, k,
                          impl="xla", stratified=stratified)
    axis = torch.zeros(2, dtype=torch.long)
    got = tnb.ball_query_full_scan(_t(pts), _t(cent), radius, k, stratified,
                                   sorted_axis=axis)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # Scanning only the slabs (scene 0) selects the same keys.
    slab = _slab_scan(_t(pts), _t(cent), radius * radius, k, axis,
                      stratified)
    for g, w in zip(slab, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if stratified:
        assert int(np.asarray(want[1]).max()) == k
    # The sorted route hands the promise on; its result is the full scan's.
    routed = tnb.ball_query(_t(pts), _t(cent), radius, k, sorted_axis=axis,
                            centroids_sorted=True, stratified=stratified)
    for g, w in zip(routed, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_sorted_full_scan_restricts_to_the_slab(monkeypatch):
    """On a scene that ascends, keys outside a ball's slab are never in
    `_slab_scan`'s scan: a far key made to look in range (its distance 0
    through a patched distance) is not selected, while on a scene that does
    not ascend it is."""
    rng = np.random.RandomState(3)
    pts = np.sort(rng.rand(1, 3, 1024).astype(np.float32), axis=2)
    pts = _t(pts)
    cent = pts[:, :, ::128].contiguous()
    exact = tnb.pairwise_sqdist_exact

    def near_first(a, b):
        d = exact(a, b)
        d[:, -1] = 0.0   # the last key (largest x) "in range" of every ball
        return d

    monkeypatch.setattr(tnb, "pairwise_sqdist_exact", near_first)
    axis = torch.zeros(1, dtype=torch.long)
    idx, _ = _slab_scan(pts, cent, 1e-4, 64, axis)
    far = cent[0, 0] < float(pts[0, 0, -1]) - 0.1
    assert bool(far.any())
    assert not bool((idx[0][far] == 1023).any())
    descending = pts.flip(2).contiguous()
    idx, _ = _slab_scan(descending, cent, 1e-4, 64, axis)
    assert bool((idx[0] == 1023).any(dim=1).all())


def test_full_scan_past_its_old_size_matches_jax():
    """K2f's old limit was 41,568 keys; the twin (and now the kernel) take
    any N, sorted or not."""
    rng = np.random.RandomState(5)
    n, m = 50000, 64
    pts, cent = _sorted_scenes(rng, n, m)
    want = jnb.ball_query(jnp.asarray(pts), jnp.asarray(cent), 0.05, 32,
                          impl="xla", stratified=True)
    for axis in (None, torch.zeros(2, dtype=torch.long)):
        got = tnb.ball_query_full_scan(_t(pts), _t(cent), 0.05, 32, True,
                                       sorted_axis=axis)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- K6 past its old size -----------------------------------------------------

def test_fps_exact_past_the_registers_matches_jax():
    """K6's old limit was 32,768 points per chain."""
    pts = np.random.RandomState(8).rand(1, 3, 40000).astype(np.float32)
    want = jsamp._fps_xla(jnp.asarray(pts), 24)
    got = tsamp.fps_exact(_t(pts), 24)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- K5's twin against the TPU kernel ------------------------------------------

_JAX_COLLISION_CHILD = """
import sys
import numpy as np
import jax.numpy as jnp
from s4g_tpu.ops.pallas.collision_kernels import collision_counts_pallas
data = np.load(sys.argv[1])
back, fing = collision_counts_pallas(jnp.asarray(data["g2l"]),
                                     jnp.asarray(data["cv"]), True)
np.savez(sys.argv[2], back=np.asarray(back), fing=np.asarray(fing))
"""


def test_collision_twin_matches_jax_kernel(tmp_path):
    """Poses among a cloud of consecutive runs of nearby points (as a
    camera's raster rows give), so that their boxes cut the runs; half of
    them with the origin exactly on a cloud point, whose x then cancels to
    +-0 at the back box's plane x < -0.0.  XLA's CPU backend contracts the
    interpreted kernel's products and sums into FMAs where the CPU has
    them, which moves the sign of such an x; capped at SSE4.2 (no FMA) it
    rounds after every operation, as the twin and K5 do.  So the JAX side
    runs in a child process with that cap (as the 3-NN tests do)."""
    rng = np.random.RandomState(9)
    runs = [rng.rand(3) * 0.3 + rng.randn(64, 3) * 0.01 for _ in range(48)]
    cloud = np.concatenate(runs).astype(np.float32)       # 3,072 rows
    n = len(cloud)
    valid = (rng.rand(n) > 0.1).astype(np.float32)
    g = 150
    poses = np.tile(np.eye(4, dtype=np.float32), (g, 1, 1))
    poses[:, :3, :3] = np.linalg.qr(rng.randn(g, 3, 3))[0]
    poses[:, :3, 3] = cloud[rng.choice(n, g)]
    poses[::2, :3, 3] += rng.randn(g // 2, 3) * 0.005
    g2l = np.linalg.inv(poses).astype(np.float32)
    cv = np.concatenate([cloud, valid[:, None]], axis=1)
    repo = Path(__file__).resolve().parents[1]
    np.savez(tmp_path / "in.npz", g2l=g2l, cv=cv)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(repo), os.environ.get("PYTHONPATH", "")]),
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_cpu_max_isa=SSE4_2").strip())
    run = subprocess.run([sys.executable, "-c", _JAX_COLLISION_CHILD,
                          str(tmp_path / "in.npz"), str(tmp_path / "out.npz")],
                         capture_output=True, text=True, timeout=300,
                         cwd=repo, env=env)
    assert run.returncode == 0, run.stderr
    want = np.load(tmp_path / "out.npz")
    got = tcol._collision_counts_plain(_t(g2l), _t(cv))
    np.testing.assert_array_equal(got[0].numpy(), want["back"])
    np.testing.assert_array_equal(got[1].numpy(), want["fing"])
    assert float(got[0].sum()) > 0 and float(got[1].sum()) > 0

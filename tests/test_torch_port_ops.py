"""The port's ops (s4g_tpu_torch.ops, collision counts) against the JAX
package on the same seeded inputs.  The port runs on the CPU, so every
kernel wrapper takes its plain PyTorch twin; the JAX side takes its CPU
routes (XLA, or Pallas interpret mode for the 3-NN kernel).  Indices and
counts must match exactly."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from s4g_tpu import ops as jops
from s4g_tpu.ops import neighbors as jnb
from s4g_tpu.ops import sampling as jsamp
from s4g_tpu.ops.interpolate import (feature_interpolate as j_interp,
                                     interpolation_weights as j_weights)
from s4g_tpu.ops.pallas.neighbor_kernels import three_nn_pallas
from s4g_tpu.pipeline import collision as jcol

from s4g_tpu_torch import ops as tops
from s4g_tpu_torch.ops import neighbors as tnb
from s4g_tpu_torch.ops import sampling as tsamp
from s4g_tpu_torch.ops.interpolate import (feature_interpolate as t_interp,
                                           interpolation_weights as t_weights)
from s4g_tpu_torch.pipeline import collision as tcol


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _sorted_cloud(rng, n, axis=0, scale=0.7):
    pts = rng.rand(1, 3, n).astype(np.float32) * scale
    return pts[:, :, np.argsort(pts[0, axis], kind="stable")]


# -- FPS (K1) -----------------------------------------------------------------

@pytest.mark.parametrize("n,m", [(2048, 512), (8192, 1024), (1024, 256)])
def test_fps_sharded_matches_jax(n, m):
    pts = _sorted_cloud(np.random.RandomState(n), n)
    want = jops.farthest_point_sample(jnp.asarray(pts), m, impl="xla",
                                      num_shards=128, sort_local=True)
    got = tops.farthest_point_sample(_t(pts), m, num_shards=128,
                                     sort_local=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # The kernel's own output (before sort_local) is shard-major.
    raw = tsamp.fps_lane_sharded(_t(pts), m)
    np.testing.assert_array_equal(
        raw.numpy(), np.asarray(jsamp._fps_sharded_xla(jnp.asarray(pts), m,
                                                       128)))


def test_fps_exact_matches_jax():
    pts = np.random.RandomState(3).rand(2, 3, 600).astype(np.float32)
    want = jsamp._fps_xla(jnp.asarray(pts), 64)
    got = tops.farthest_point_sample(_t(pts), 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- ball query, full scan ------------------------------------------------------

@pytest.mark.parametrize("stratified", [False, True])
@pytest.mark.parametrize("n,m,radius,k", [
    (700, 300, 0.1, 16),      # counts straddle k
    (700, 300, 0.9, 64),      # counts far above k
    (700, 300, 0.001, 8),     # mostly-empty balls (slot-0 fill, count 0)
    (2500, 600, 0.05, 32),    # several centroid chunks
])
def test_ball_query_full_scan_matches_jax(n, m, radius, k, stratified):
    rng = np.random.RandomState(2)
    pts = (rng.rand(2, 3, n) * 0.6).astype(np.float32)
    cent = pts[:, :, :m]
    want_i, want_c = jops.ball_query(jnp.asarray(pts), jnp.asarray(cent),
                                     radius, k, impl="xla",
                                     stratified=stratified)
    got_i, got_c = tops.ball_query(_t(pts), _t(cent), radius, k,
                                   stratified=stratified)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


# -- ball query, sorted slab (K2) ------------------------------------------------

@pytest.mark.parametrize("radius,centroids_sorted,overflow", [
    (0.06, True, False),
    (0.03, False, False),
    (0.5, True, True),        # windows overflow -> full-scan fallback
])
@pytest.mark.parametrize("stratified", [False, True])
def test_ball_query_slab_matches_jax(radius, centroids_sorted, overflow,
                                     stratified):
    rng = np.random.RandomState(11)
    n, m, k = 9000, 2000, 16
    pts = _sorted_cloud(rng, n)
    sel = np.sort(rng.choice(n, m, replace=False))
    if not centroids_sorted:
        sel = rng.permutation(sel)
    cent = pts[:, :, sel]
    want_i, want_c = jnb._ball_query_sorted_pruned(
        jnp.asarray(pts), jnp.asarray(cent), radius * radius, k, 512,
        jnp.int32(0), 6144, centroids_sorted=centroids_sorted,
        slab_route="xla", stratified=stratified)
    axis = torch.zeros(1, dtype=torch.int64)
    cent_s = np.sort(cent[0, 0])[None]
    _, fired = tnb.slab_windows(_t(pts[:, 0]), _t(cent_s), radius * radius, n)
    assert bool(fired) == overflow
    got_i, got_c = tops.ball_query(_t(pts), _t(cent), radius, k,
                                   sorted_axis=axis,
                                   centroids_sorted=centroids_sorted,
                                   stratified=stratified)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_ball_query_grouped_rel_matches_jax():
    rng = np.random.RandomState(5)
    pts = (rng.rand(1, 3, 900) * 0.5).astype(np.float32)
    cent = pts[:, :, ::7]
    want = jops.ball_query_grouped(jnp.asarray(pts), jnp.asarray(cent), 0.05,
                                   16, stratified=True)
    got = tops.ball_query_grouped(_t(pts), _t(cent), 0.05, 16,
                                  stratified=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- 3-NN (K4) -------------------------------------------------------------------

def test_three_nn_kernel_twin_matches_pallas_interpret():
    rng = np.random.RandomState(0)
    q = rng.rand(2, 3, 300).astype(np.float32)
    k = rng.rand(2, 3, 200).astype(np.float32)
    want_i, want_d = three_nn_pallas(jnp.asarray(q), jnp.asarray(k),
                                     interpret=True)
    got_i, got_d = tnb.three_nn_fused(_t(q), _t(k))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=1e-6)


def test_three_nn_small_route_matches_jax():
    rng = np.random.RandomState(1)
    q = rng.rand(2, 3, 1500).astype(np.float32)
    k = rng.rand(2, 3, 400).astype(np.float32)
    want_i, want_d = jops.three_nn(jnp.asarray(q), jnp.asarray(k),
                                   impl="xla")
    got_i, got_d = tops.three_nn(_t(q), _t(k))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=1e-7)


# -- collision counts (K5) ---------------------------------------------------------

def _poses_and_cloud(rng, g, n, span=0.4):
    poses = np.tile(np.eye(4, dtype=np.float32), (g, 1, 1))
    poses[:, :3, :3] = np.linalg.qr(rng.randn(g, 3, 3))[0]
    poses[:, :3, 3] = rng.rand(g, 3).astype(np.float32) * 0.2 - 0.1
    cloud = (rng.rand(n, 3).astype(np.float32) - 0.5) * span
    valid = rng.rand(n) > 0.2
    return poses, cloud, valid


def test_collision_counts_twin_matches_xla_masks():
    rng = np.random.RandomState(4)
    g, n = 70, 900
    poses, cloud, valid = _poses_and_cloud(rng, g, n)
    homo = jnp.concatenate([jnp.asarray(cloud).T, jnp.ones((1, n))], axis=0)
    local = jnp.einsum("gij,jn->gin", jnp.asarray(poses), homo)
    masks = jcol.gripper_local_masks(local[:, :3, :], jnp.asarray(valid))
    cv = np.concatenate([cloud, valid[:, None].astype(np.float32)], axis=1)
    back, fing = tcol.collision_counts(_t(poses), _t(cv))
    np.testing.assert_array_equal(back.numpy().astype(int),
                                  np.asarray(jnp.sum(masks["back"], -1)))
    np.testing.assert_array_equal(fing.numpy().astype(int),
                                  np.asarray(jnp.sum(masks["fingers"], -1)))


@pytest.mark.parametrize("g,n,span", [(70, 900, 0.4),      # einsum route
                                      (64, 65536, 2.0)])   # kernel route
def test_batch_view_non_collision_matches_jax(g, n, span):
    rng = np.random.RandomState(g)
    poses, cloud, valid = _poses_and_cloud(rng, g, n, span)
    want = jcol.batch_view_non_collision(
        jnp.asarray(poses), jnp.asarray(cloud), jnp.asarray(valid),
        impl="xla", back_threshold=3.0, finger_threshold=2.0)
    got = tcol.batch_view_non_collision(_t(poses), _t(cloud), _t(valid),
                                        back_threshold=3.0,
                                        finger_threshold=2.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < got.sum() < g          # both outcomes occur


# -- small ops ----------------------------------------------------------------------

def test_small_ops_match_jax():
    rng = np.random.RandomState(7)
    perm = np.stack([rng.permutation(50) for _ in range(3)]).astype(np.int32)
    np.testing.assert_array_equal(
        tnb.invert_permutation(_t(perm)).numpy(),
        np.asarray(jnb.invert_permutation(jnp.asarray(perm))))

    feat = rng.randn(2, 5, 40).astype(np.float32)
    idx3 = rng.randint(0, 40, (2, 30, 3)).astype(np.int32)
    dist = rng.rand(2, 30, 3).astype(np.float32)
    dist[0, 0, 0] = 0.0                                # eps clamp
    w_t = t_weights(_t(dist))
    w_j = j_weights(jnp.asarray(dist))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-6)
    np.testing.assert_allclose(
        t_interp(_t(feat), _t(idx3), w_t).numpy(),
        np.asarray(j_interp(jnp.asarray(feat), jnp.asarray(idx3), w_j)),
        atol=1e-6)
    gidx = rng.randint(0, 40, (2, 6, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        tops.group_points(_t(feat), _t(gidx)).numpy(),
        np.asarray(jops.group_points(jnp.asarray(feat), jnp.asarray(gidx))))
    np.testing.assert_array_equal(
        tops.gather_points(_t(feat), _t(gidx[:, :, 0])).numpy(),
        np.asarray(jops.gather_points(jnp.asarray(feat),
                                      jnp.asarray(gidx[:, :, 0]))))
    a = rng.rand(2, 3, 20).astype(np.float32)
    b = rng.rand(2, 3, 30).astype(np.float32)
    np.testing.assert_allclose(
        tops.pairwise_sqdist(_t(a), _t(b)).numpy(),
        np.asarray(jops.pairwise_sqdist(jnp.asarray(a), jnp.asarray(b))),
        atol=1e-6)

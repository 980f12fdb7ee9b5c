"""The port's reference-parity configuration against the JAX package on the
CPU: exact and G-shard FPS (K6's plain twins against the TPU kernel in
interpret mode), the full-scan ball query (K2f's plain twin against
`ball_query_fused_pallas` in interpret mode), the ball query's one route
(slab for a big sorted cloud, else K2f), PN2_CLS with SORT_POINTS false and
FPS_SHARDS 1 against both of JAX's ball-query routes, the sort-only
ablation at batch 2 and `GraspDetector.eval`.

Inputs are made with numpy from a seed.  Indices and counts must match
exactly; model outputs within 1e-4 in f32 and within the bf16 tolerances of
tests/test_sa_fused.py (max 5e-2, mean 5e-3) in bf16.
"""

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

import s4g_tpu.ops.pallas.neighbor_kernels as jnk
from s4g_tpu.configs.config import load_cfg_from_dict as j_cfg
from s4g_tpu.models import build_model as j_build
from s4g_tpu.models import nn_layers as jnn
from s4g_tpu.ops import neighbors as jnb
from s4g_tpu.ops import sampling as jsamp
from s4g_tpu.pipeline import postprocessing as jpost
from s4g_tpu.pipeline import preprocessing as jpre
from s4g_tpu.pipeline.detector import GraspDetector as JaxDetector

from s4g_tpu_torch import ops as tops
from s4g_tpu_torch.configs.config import load_cfg_from_dict as t_cfg
from s4g_tpu_torch.models import build_model as t_build
from s4g_tpu_torch.models.nn_layers import SharedMLP
from s4g_tpu_torch.ops import neighbors as tnb
from s4g_tpu_torch.ops import sa_fused as sf
from s4g_tpu_torch.ops import sampling as tsamp
from s4g_tpu_torch.pipeline import detector as tdet
from s4g_tpu_torch.utils.weights import state_dict_from_flax

from test_torch_port_detector import TINY, clutter_cloud
from test_torch_port_model import (NARROW, _perturb,  # noqa: F401
                                   kernel_routed_three_nn)

PARITY = dict(NARROW, SORT_POINTS=False, FPS_SHARDS=1)
# The sort-only ablation (tools/parity_at_speed.py "sort"): exact FPS with
# the re-sort, and an SA1 that the fused stage (K3) takes at batch >= 2.
SORT_ONLY = dict(NARROW, SORT_POINTS=True, FPS_SHARDS=1,
                 SA_CHANNELS=((128, 128, 256), (32, 32, 32), (32, 32, 32)))


def _t(x):
    return torch.from_numpy(np.array(x))


def _spy(monkeypatch, module, name):
    """Count the calls of module.name (still calling through)."""
    calls = []
    fn = getattr(module, name)
    monkeypatch.setattr(module, name,
                        lambda *a, **kw: calls.append(1) or fn(*a, **kw))
    return calls


def _fps_cloud(rng, b, n, case):
    pts = rng.rand(b, 3, n).astype(np.float32)
    if case == "duplicates":     # 40 distinct points: later picks tie at 0
        pts = pts[:, :, rng.randint(0, 40, n)]
    return pts


# -- K6: exact and G-shard FPS ------------------------------------------------

@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("n,m,case", [(300, 64, "random"),
                                      (200, 64, "duplicates"),
                                      (130, 128, "random")])     # M ~ N
def test_fps_exact_twin_matches_pallas_interpret(b, n, m, case):
    pts = _fps_cloud(np.random.RandomState(n + b), b, n, case)
    want = np.asarray(jsamp.farthest_point_sample(
        jnp.asarray(pts), m, impl="pallas_interpret"))
    np.testing.assert_array_equal(tsamp.fps_exact(_t(pts), m).numpy(), want)
    np.testing.assert_array_equal(
        tops.farthest_point_sample(_t(pts), m).numpy(), want)


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("g,n,m,case", [(4, 512, 128, "random"),
                                        (8, 512, 64, "random"),
                                        (8, 240, 240, "duplicates")])
def test_fps_sharded_twin_matches_pallas_interpret(b, g, n, m, case):
    pts = _fps_cloud(np.random.RandomState(n + g + b), b, n, case)
    want = np.asarray(jsamp.farthest_point_sample(
        jnp.asarray(pts), m, impl="pallas_interpret", num_shards=g))
    np.testing.assert_array_equal(tsamp.fps_sharded(_t(pts), m, g).numpy(),
                                  want)
    want_sorted = jsamp.farthest_point_sample(
        jnp.asarray(pts), m, impl="pallas_interpret", num_shards=g,
        sort_local=True)
    got_sorted = tops.farthest_point_sample(_t(pts), m, num_shards=g,
                                            sort_local=True)
    np.testing.assert_array_equal(got_sorted.numpy(), np.asarray(want_sorted))


def test_fps_wrappers_check_their_sizes():
    pts = torch.rand(1, 3, 100)
    with pytest.raises(ValueError, match="shard FPS needs"):
        tsamp.fps_sharded(pts, 64, 8)            # 8 does not divide 100
    with pytest.raises(ValueError, match="M >= 1"):
        tsamp.fps_exact(pts, 0)
    # A shard count that does not divide N falls back to exact FPS.
    np.testing.assert_array_equal(
        tops.farthest_point_sample(pts, 20, num_shards=8).numpy(),
        tsamp._fps_plain(pts, 20).numpy())


# -- K2f: the full-scan ball query --------------------------------------------

@pytest.mark.parametrize("stratified", [False, True])
@pytest.mark.parametrize("b,n,m,radius,k,shift", [
    (2, 3000, 700, 0.1, 16, 0.0),     # ragged M over two centroid tiles
    (1, 3000, 300, 0.6, 64, 0.0),     # overfull balls (stratified ranks)
    (2, 2500, 333, 0.002, 8, 0.0),    # mostly empty balls
    (1, 1000, 100, 0.1, 32, 5.0),     # every ball empty
])
def test_ball_query_full_twin_matches_pallas_interpret(b, n, m, radius, k,
                                                       shift, stratified):
    rng = np.random.RandomState(n + m)
    pts = (rng.rand(b, 3, n) * 0.6).astype(np.float32)
    cents = (pts[:, :, rng.choice(n, m, replace=False)] + shift
             ).astype(np.float32)
    want_i, want_c = jnk.ball_query_fused_pallas(
        jnp.asarray(pts), jnp.asarray(cents), radius, k, True, stratified)
    got_i, got_c = tnb.ball_query_full_scan(_t(pts), _t(cents), radius, k,
                                            stratified)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    if shift:
        assert not got_c.any() and not got_i.any()


@pytest.fixture
def jax_bq_kernel(monkeypatch):
    """JAX's ball-query override (`impl="pallas"`) with its kernel in
    interpret mode, so that it runs on the CPU."""
    orig = jnk.ball_query_fused_pallas
    monkeypatch.setattr(
        jnk, "ball_query_fused_pallas",
        lambda p, c, r, k, interpret=False, stratified=False:
            orig(p, c, r, k, True, stratified))


def _sorted_scene(seed, n, m):
    rng = np.random.RandomState(seed)
    pts = (rng.rand(1, 3, n) * 0.5).astype(np.float32)
    pts = pts[:, :, np.argsort(pts[0, 0], kind="stable")]
    cents = pts[:, :, np.sort(rng.choice(n, m, replace=False))]
    return pts, np.ascontiguousarray(cents)


@pytest.mark.parametrize("stratified", [False, True])
def test_kernel_route_skips_the_slab_route(jax_bq_kernel, monkeypatch,
                                           stratified):
    """A sorted cloud above the slab capacity: JAX's kernel route
    (impl="pallas") scans in full; the port, which has one route, takes the
    slab route (K2's twin) there and the full scan (K2f's wrapper) without
    the sort.  All three agree: the slab result is the full-scan one."""
    pts, cents = _sorted_scene(0, 8192, 1024)
    axis = jnp.zeros((1,), jnp.int32)
    want_i, want_c = jnb.ball_query(
        jnp.asarray(pts), jnp.asarray(cents), 0.03, 32, impl="pallas",
        sorted_axis=axis, centroids_sorted=True, stratified=stratified)
    full = _spy(monkeypatch, tnb, "ball_query_full_scan")
    slab = _spy(monkeypatch, tnb, "_ball_query_sorted_pruned")
    for sorted_axis, calls in ((torch.zeros(1, dtype=torch.long), (0, 1)),
                               (None, (1, 1))):
        got = tops.ball_query(_t(pts), _t(cents), 0.03, 32,
                              sorted_axis=sorted_axis, centroids_sorted=True,
                              stratified=stratified)
        assert (len(full), len(slab)) == calls
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want_c))


def test_route_override(monkeypatch):
    """The ball-query override is gone: every full scan goes through K2f's
    wrapper (its twin `_ball_query_full` on CPU tensors), grouped or not,
    and the route takes no `impl` argument."""
    pts = np.random.RandomState(1).rand(2, 3, 500).astype(np.float32)
    cents = pts[:, :, :50]
    full = _spy(monkeypatch, tnb, "ball_query_full_scan")
    want = tnb._ball_query_full(_t(pts), _t(cents), 0.2 * 0.2, 16)
    got = tops.ball_query(_t(pts), _t(cents), 0.2, 16)
    assert len(full) == 1
    idx, cnt, rel = tops.ball_query_grouped(_t(pts), _t(cents), 0.2, 16)
    assert len(full) == 2 and rel.shape == (2, 50, 16, 3)
    for g, w, h in zip(got, want, (idx, cnt)):
        assert torch.equal(g, w) and torch.equal(h, w)
    for gone in ("set_default_bq_impl", "_DEFAULT_BQ_IMPL",
                 "_resolve_bq_impl"):
        assert not hasattr(tnb, gone)
    with pytest.raises(TypeError, match="impl"):
        tops.ball_query(_t(pts), _t(cents), 0.2, 16, impl="kernel")


def test_sa1_fused_fallback_takes_the_override(monkeypatch):
    """The full-scan fallback of the fused SA1 stage (a tile's keys
    overflow its window) is an ordinary ball query, so it runs K2f (as the
    JAX stage's fallback, nn_layers.py:149-151, runs its full scan)."""
    n, m = 9000, 1000
    rng = np.random.RandomState(2)
    pts = np.zeros((1, 3, n), np.float32)          # one dense column
    pts[0, 0] = np.sort(rng.rand(n)).astype(np.float32) * 1e-3
    pts[0, 1:] = rng.rand(2, n) * 0.5
    cents = np.ascontiguousarray(pts[:, :, np.sort(rng.choice(n, m, False))])
    mlp = SharedMLP(3, (128, 128, 256), ndim=2).eval()
    full = _spy(monkeypatch, tnb, "ball_query_full_scan")
    before = sf.SA1_FALLBACKS["overflow"]
    out = sf.sa1_stage(_t(pts), _t(cents), torch.zeros(1, dtype=torch.long),
                       0.02, 32, mlp.packed_operands(sf.pack_sa1_weights),
                       torch.float32)
    assert sf.SA1_FALLBACKS["overflow"] == before + 1 and len(full) == 1
    assert out.shape == (1, m, 256)


# -- PN2_CLS at the parity configuration --------------------------------------

def _model_pair(pn2, dtype, cloud):
    cfg = {"MODEL": {"TYPE": "PN2_CLS", "COMPUTE_DTYPE": dtype, "PN2": pn2},
           "DATA": {"SCORE_CLASSES": 3}}
    jnet, _, _ = j_build(j_cfg(cfg))
    variables = jnet.init(jax.random.key(0),
                          {"scene_points": jnp.asarray(cloud)}, train=False)
    variables = _perturb(jax.tree.map(np.asarray, dict(variables)),
                         np.random.RandomState(0))
    tnet = t_build(t_cfg(cfg))
    tnet.load_state_dict(state_dict_from_flax(variables))
    return jnet, variables, tnet


def _assert_close(got, want, dtype):
    for key in ("score", "frame_R", "frame_t", "movable_logits"):
        g, w = got[key].numpy(), np.asarray(want[key])
        assert g.shape == w.shape, key
        if dtype == "float32":
            np.testing.assert_allclose(g, w, atol=1e-4, err_msg=key)
        else:
            np.testing.assert_allclose(g, w, atol=5e-2, err_msg=key)
            assert float(np.abs(g - w).mean()) < 5e-3, key


@pytest.mark.parametrize("route", ["auto", "kernel"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pn2_cls_parity_config_matches_jax(kernel_routed_three_nn,
                                           jax_bq_kernel, monkeypatch, dtype,
                                           route):
    """SORT_POINTS false, FPS_SHARDS 1: exact FPS at all three stages (K6's
    twin) and full-scan ball queries through K2f's wrapper (its twin here),
    held against JAX on either of its ball-query routes: XLA ("auto") and
    its kernel ("kernel": `impl="pallas"`, in interpret mode)."""
    cloud = (np.random.RandomState(0).rand(1, 3, PARITY["NUM_INPUT"])
             * [[[0.6], [0.4], [0.3]]]).astype(np.float32)
    jnet, variables, tnet = _model_pair(dict(PARITY), dtype, cloud)
    if route == "kernel":
        monkeypatch.setattr(jnb, "_ENV_BQ_IMPL", "pallas")
    want = jnet.apply(variables, {"scene_points": jnp.asarray(cloud)},
                      train=False)
    fps = _spy(monkeypatch, tsamp, "fps_exact")
    full = _spy(monkeypatch, tnb, "ball_query_full_scan")
    monkeypatch.setattr(tsamp, "fps_lane_sharded",
                        lambda *a: pytest.fail("128-shard FPS"))
    got = tnet({"scene_points": _t(cloud)})
    assert len(fps) == 3 and len(full) == 3
    _assert_close(got, want, dtype)


def test_sort_only_ablation_batch2_matches_jax(kernel_routed_three_nn,
                                               monkeypatch):
    """SORT_POINTS with FPS_SHARDS 1 at b = 2: exact FPS, the re-sort of its
    picks, and SA1 through the fused stage (K3's twin; JAX's kernel in
    interpret mode)."""
    monkeypatch.setattr(jnn, "ENV_SA1_FUSE", "interpret")
    cloud = (np.random.RandomState(1).rand(2, 3, SORT_ONLY["NUM_INPUT"])
             * np.array([[[0.6], [0.4], [0.3]], [[0.3], [0.5], [0.4]]])
             ).astype(np.float32)
    jnet, variables, tnet = _model_pair(dict(SORT_ONLY), "bfloat16", cloud)
    want = jnet.apply(variables, {"scene_points": jnp.asarray(cloud)},
                      train=False)
    fps = _spy(monkeypatch, tsamp, "fps_exact")
    fused = _spy(monkeypatch, sf, "sa1_fused_slab")
    before = sf.SA1_FALLBACKS["overflow"]
    got = tnet({"scene_points": _t(cloud)})
    assert len(fps) == 3 and len(fused) == 1
    assert sf.SA1_FALLBACKS["overflow"] == before
    _assert_close(got, want, "bfloat16")


# -- GraspDetector.eval -------------------------------------------------------

def test_eval_matches_jax_eval(tmp_path, monkeypatch):
    """eval on the tiny parity model (no sort, exact FPS): the JAX
    detector's draws, replayed from its key, injected into the port."""
    cfg_file = tmp_path / "tiny.yaml"
    cfg_file.write_text(yaml.safe_dump(TINY))
    cap = 8192
    jdet = JaxDetector(model=str(cfg_file), output_dir=str(tmp_path),
                       cloud_capacity=cap, num_candidates=64)
    cloud = clutter_cloud(np.random.RandomState(5))
    key = jdet._key
    want = jdet.eval(cloud.T)                       # (3, n) is accepted too
    _, sub = jax.random.split(key)
    padded, _ = jdet._pad_cloud(cloud)
    train = jnp.matmul(padded, jnp.asarray(jpost.REAL2TRAIN[:3, :3]).T)
    pre = jpre.preprocess_cloud(train, sub, num_points=512, capacity=cap)
    sample_idx = jpre.random_sample_fixed(sub, pre.raw_valid, 512)

    tdetector = tdet.GraspDetector(
        model=str(cfg_file), device="cpu", output_dir=str(tmp_path),
        cloud_capacity=cap, num_candidates=64,
        state_dict=state_dict_from_flax(jax.tree.map(np.asarray,
                                                     jdet.variables)))
    fps = _spy(monkeypatch, tsamp, "fps_exact")
    got = tdetector.eval(cloud, sample_idx=_t(sample_idx))
    assert len(fps) == 2
    _assert_close(got, want, "float32")
    drawn = tdetector.eval(cloud)                   # the detector's own draws
    assert {k: v.shape for k, v in drawn.items()} == \
        {k: v.shape for k, v in got.items()}
    assert all(bool(torch.isfinite(v).all()) for v in drawn.values())

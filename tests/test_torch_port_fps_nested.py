"""Nested 128-shard FPS (the port's K1 over every SA stage of a sorted
forward) against the JAX package on the CPU.

On the CPU `ops.sampling.fps_lane_nested` takes its plain twin
`_fps_nested_plain`.  The JAX package computes the same indices in three
calls of `farthest_point_sample(..., num_shards=128, sort_local=True)`, each
on the previous stage's gathered picks (`s4g_tpu/models/pn2_modules.py:
113-117`); the nested result must equal that chain exactly, through its XLA
route and through the Pallas kernel `_fps_lane_kernel` in interpret mode.
A sorted backbone forward must take the nested route and hand each SA stage
the indices JAX's stages compute; a configuration where nesting does not
apply keeps the per-stage route and still matches JAX.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s4g_tpu.configs.config import load_cfg_from_dict as j_cfg
from s4g_tpu.models import build_model as j_build
from s4g_tpu.models.pointnet2 import PointNet2Backbone as JBackbone
from s4g_tpu.ops import sampling as jsamp

from s4g_tpu_torch import ops as tops
from s4g_tpu_torch.configs.config import load_cfg_from_dict as t_cfg
from s4g_tpu_torch.models import build_model as t_build
from s4g_tpu_torch.models import pointnet2 as tpn2
from s4g_tpu_torch.ops import sampling as tsamp
from s4g_tpu_torch.utils.weights import state_dict_from_flax


def _jax_chain(points, centroids, impl):
    """JAX's per-stage route: FPS with sort_local on each stage's gathered
    picks; the indices of every stage."""
    out, cur = [], jnp.asarray(points)
    for m in centroids:
        idx = jsamp.farthest_point_sample(cur, m, impl=impl, num_shards=128,
                                          sort_local=True)
        out.append(np.asarray(idx))
        cur = jnp.take_along_axis(cur, idx[:, None, :], axis=2)
    return out


def _cloud(rng, b, n, ties):
    """A (B, 3, N) cloud sorted along x.  With `ties`, coordinates sit on a
    coarse grid (many equal distances) and one shard is a single repeated
    point (every row at distance 0 after the first pick)."""
    pts = rng.rand(b, 3, n).astype(np.float32) * np.float32([[0.8], [0.5],
                                                             [0.3]])
    if ties:
        pts = np.round(pts * 16) / 16
    pts = np.take_along_axis(pts, np.argsort(pts[:, :1], axis=2,
                                             kind="stable"), axis=2)
    if ties:
        ns = n // 128
        pts[:, :, 5 * ns:6 * ns] = pts[:, :, 5 * ns:5 * ns + 1]
    return np.ascontiguousarray(pts.astype(np.float32))


@pytest.mark.parametrize("b,n,centroids,ties", [
    (1, 25600, (5120, 1024, 256), False),   # the deployed stages
    (2, 25600, (5120, 1024, 256), True),
    (2, 8192, (1024, 256, 128), True),      # one pick a shard at stage 3
    (1, 4096, (4096, 512), False),          # every row picked at stage 1
])
def test_nested_twin_matches_chained_jax_fps(b, n, centroids, ties):
    pts = _cloud(np.random.RandomState(n + b), b, n, ties)
    assert tsamp.fps_nesting_applies(n, centroids, 128)
    got = tsamp.fps_lane_nested(torch.from_numpy(pts), centroids)
    want = _jax_chain(pts, centroids, "xla")
    assert len(got) == len(want) == len(centroids)
    for s, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.int32 and g.shape == (b, centroids[s])
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"stage {s}")


def test_nested_twin_matches_jax_lane_kernel_interpret():
    centroids = (512, 256, 128)
    pts = _cloud(np.random.RandomState(3), 1, 2048, True)
    got = tsamp.fps_lane_nested(torch.from_numpy(pts), centroids)
    want = _jax_chain(pts, centroids, "pallas_interpret")
    for s, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"stage {s}")


@pytest.mark.parametrize("n,centroids,num_shards,applies", [
    (25600, (5120, 1024, 256), 128, True),
    (32768, (4096, 1024, 256), 128, True),     # 256-point shards
    (32768 + 128, (4096, 1024, 256), 128, False),  # 257-point shards
    (8192, (1024, 256, 64), 128, False),       # stage 3 below 128 centroids
    (8192, (1024, 256, 128, 128), 128, False),  # four stages
    (8192, (1024, 256, 128), 64, False),       # other shard counts: K6
    (8192, (1024, 2048), 128, False),          # more centroids than points
])
def test_fps_nesting_applies(n, centroids, num_shards, applies):
    assert tsamp.fps_nesting_applies(n, centroids, num_shards) is applies


def test_nested_route_refuses_what_does_not_nest():
    pts = torch.zeros(1, 3, 8192)
    with pytest.raises(ValueError, match="does not apply"):
        tsamp.fps_lane_nested(pts, (1024, 256, 64))


PN2 = {
    "NUM_INPUT": 4096,
    "NUM_CENTROIDS": (512, 256, 128),
    "RADIUS": (0.04, 0.1, 0.3),
    "NUM_NEIGHBOURS": (16, 16, 16),
    "SA_CHANNELS": ((16, 16, 32), (32, 32, 32), (32, 32, 32)),
    "FP_CHANNELS": ((32, 32), (32, 32), (32, 32, 16)),
    "NUM_FP_NEIGHBOURS": (3, 3, 3),
    "SEG_CHANNELS": (32, 16),
    "SORT_POINTS": True,
    "FPS_SHARDS": 128,
}


def _backbones(centroids):
    """The JAX backbone (with its variables) and the port's PN2_CLS on the
    same weights, f32, at PN2 with `centroids`."""
    cfg = {"MODEL": {"TYPE": "PN2_CLS", "COMPUTE_DTYPE": "float32",
                     "PN2": {**PN2, "NUM_CENTROIDS": centroids}},
           "DATA": {"SCORE_CLASSES": 3}}
    jnet, _, _ = j_build(j_cfg(cfg))
    rng = np.random.RandomState(1)
    cloud = (rng.rand(1, 3, PN2["NUM_INPUT"]) * [[[0.6], [0.4], [0.3]]]
             ).astype(np.float32)
    variables = jax.tree.map(np.asarray, dict(jnet.init(
        jax.random.key(0), {"scene_points": jnp.asarray(cloud)},
        train=False)))
    tnet = t_build(t_cfg(cfg))
    tnet.load_state_dict(state_dict_from_flax(variables))
    jbb = JBackbone(centroids, PN2["RADIUS"], PN2["NUM_NEIGHBOURS"],
                    PN2["SA_CHANNELS"], PN2["FP_CHANNELS"],
                    PN2["NUM_FP_NEIGHBOURS"], sort_points=True,
                    fps_shards=128)
    jvars = {k: variables[k]["backbone"] for k in ("params", "batch_stats")}
    return jbb, jvars, tnet, cloud


def _run(centroids, monkeypatch):
    """Both backbones on one cloud: JAX's features and each SA stage's
    centroids, the port's, and the port's FPS calls by route."""
    jbb, jvars, tnet, cloud = _backbones(centroids)
    xyz = np.ascontiguousarray(cloud.transpose(0, 2, 1))
    want, inter = jbb.apply(jvars, jnp.asarray(xyz),
                            capture_intermediates=True,
                            mutable=["intermediates"])
    want_xyz = [np.asarray(inter["intermediates"][f"sa{i}"]["__call__"][0][0])
                for i in range(3)]

    calls = {"nested": 0, "per_stage": 0}

    def counted(name, fn):
        def run(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return run

    monkeypatch.setattr(tpn2, "fps_lane_nested",
                        counted("nested", tpn2.fps_lane_nested))
    monkeypatch.setattr(tops, "farthest_point_sample",
                        counted("per_stage", tops.farthest_point_sample))
    got_xyz = []
    hooks = [sa.register_forward_hook(
        lambda mod, args, out: got_xyz.append(out[0].numpy()))
        for sa in tnet.sa_modules]
    try:
        with torch.no_grad():
            got = tnet.backbone(torch.from_numpy(xyz))
    finally:
        for h in hooks:
            h.remove()
    return np.asarray(want), want_xyz, got.numpy(), got_xyz, calls


def test_sorted_backbone_takes_the_nested_route_and_matches_jax(monkeypatch):
    want, want_xyz, got, got_xyz, calls = _run(PN2["NUM_CENTROIDS"],
                                               monkeypatch)
    assert calls == {"nested": 1, "per_stage": 0}
    for s, (g, w) in enumerate(zip(got_xyz, want_xyz)):
        np.testing.assert_array_equal(g, w, err_msg=f"SA{s + 1} centroids")
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_backbone_that_does_not_nest_keeps_the_per_stage_route(monkeypatch):
    centroids = (512, 256, 64)     # SA3 below 128 centroids: exact FPS
    assert not tsamp.fps_nesting_applies(PN2["NUM_INPUT"], centroids, 128)
    want, want_xyz, got, got_xyz, calls = _run(centroids, monkeypatch)
    assert calls == {"nested": 0, "per_stage": 3}
    for s, (g, w) in enumerate(zip(got_xyz, want_xyz)):
        np.testing.assert_array_equal(g, w, err_msg=f"SA{s + 1} centroids")
    np.testing.assert_allclose(got, want, atol=1e-4)

"""The port's host-side modules against the JAX package's, on the same
numpy inputs: the numpy copies (path_registry, datagen.stats,
postprocess_grasps, json_to_pcd, grasp_env's XML) exactly, the native
host_ops library exactly (the port's own build of its copy of host_ops.cpp
against the JAX package's build), the port's numpy host_ops paths against
its native ones, and runtime.guard's deadline-bounded children."""

import json
import os
import pickle
import socket
import time

import numpy as np
import pytest

from s4g_tpu.configs import path_registry as jpr
from s4g_tpu.datagen import grasp_env as jge
from s4g_tpu.datagen import json_to_pcd as jjp
from s4g_tpu.datagen import postprocess_grasps as jpp
from s4g_tpu.datagen import stats as jst
from s4g_tpu.runtime import host_ops as jho
from s4g_tpu_torch.configs import path_registry as tpr
from s4g_tpu_torch.datagen import grasp_env as tge
from s4g_tpu_torch.datagen import json_to_pcd as tjp
from s4g_tpu_torch.datagen import postprocess_grasps as tpp
from s4g_tpu_torch.datagen import stats as tst
from s4g_tpu_torch.runtime import guard
from s4g_tpu_torch.runtime import host_ops as tho
from test_datagen_grading import make_box_cloud


def _same(got, want):
    """Equal nested results: arrays exactly (dtype included), the rest
    by ==."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (tuple, list)) and want and isinstance(
            want[0], np.ndarray):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


# -- configs/path_registry ---------------------------------------------------

@pytest.mark.parametrize("env", [
    {},                                                # ./s4g_data
    {"S4G_DATA_ROOT": "ENV_ROOT"},
    {"S4G_HOST_ROOTS": "zzz=/nowhere,HOST=/cluster/ycb"},
    {"S4G_HOST_ROOTS": "zzz=/nowhere"},
])
def test_path_registry_matches_jax(env, tmp_path, monkeypatch):
    monkeypatch.delenv("S4G_DATA_ROOT", raising=False)
    monkeypatch.delenv("S4G_HOST_ROOTS", raising=False)
    monkeypatch.chdir(tmp_path)
    for k, v in env.items():
        v = v.replace("ENV_ROOT", str(tmp_path / "env_root")).replace(
            "HOST", socket.gethostname()[:3])
        monkeypatch.setenv(k, v)
    for root in (None, str(tmp_path / "arg")):
        assert tpr.data_root(root) == jpr.data_root(root)
        assert tpr.scene_npy_path(3, root) == jpr.scene_npy_path(3, root)
        assert tpr.scene_view_paths(0, 2, root) == jpr.scene_view_paths(
            0, 2, root)
        assert tpr.object_grade_path("cam0", root) == \
            jpr.object_grade_path("cam0", root)
        assert tpr.npy_and_training_data_path(0, 2, root) == \
            jpr.npy_and_training_data_path(0, 2, root)
        for kind in jpr._RESOURCE_KINDS:
            assert tpr.resource_dir(kind, root) == jpr.resource_dir(kind,
                                                                    root)
            assert os.path.isdir(tpr.resource_dir(kind, root))
    assert tpr._RESOURCE_KINDS == jpr._RESOURCE_KINDS


# -- datagen/stats -----------------------------------------------------------

def _merged_views(root, rng):
    """Merged-view pickles with labels, one with none, one without
    antipodal scores, and a file that is not a pickle."""
    os.makedirs(root)
    views = [{"search_score": rng.rand(40) * 100,
              "antipodal_score": rng.rand(40)},
             {"search_score": np.zeros(0), "antipodal_score": np.zeros(0)},
             {"search_score": rng.rand(7) * 60}]
    for i, v in enumerate(views):
        with open(os.path.join(root, f"{i}_view_0.p"), "wb") as f:
            pickle.dump(v, f)
    with open(os.path.join(root, "notes.txt"), "w") as f:
        f.write("x")
    return views


def test_stats_match_jax(tmp_path):
    views = _merged_views(str(tmp_path / "merged"),
                          np.random.RandomState(0))
    for v in views:
        assert tst.per_view_stats(v) == jst.per_view_stats(v)
    got = tst.dataset_statistics(str(tmp_path / "merged"))
    assert got == jst.dataset_statistics(str(tmp_path / "merged"))
    assert got["summary"]["num_views"] == 3
    assert got["summary"]["views_with_labels"] == 2


# -- datagen/postprocess_grasps ----------------------------------------------

def test_postprocess_grasps_match_jax():
    rng = np.random.RandomState(0)
    q, _ = np.linalg.qr(rng.randn(5, 3, 3))
    poses = np.tile(np.eye(4), (5, 1, 1))
    poses[:, :3, :3] = q
    poses[:, :3, 3] = rng.randn(5, 3)
    _same(tpp.inverse_batch_pose(poses), jpp.inverse_batch_pose(poses))
    s, a = rng.rand(9) * 300, rng.rand(9)
    _same(tpp.normalized_point_score(s, a), jpp.normalized_point_score(s, a))
    for name in ("MIN_SEARCH_SCORE", "FRAME_PER_POINT",
                 "MAX_NEIGHBOR_FRAME", "NEIGHBOR_RADIUS"):
        assert getattr(tpp, name) == getattr(jpp, name)


@pytest.mark.parametrize("case", ["one_point", "spread", "none_kept"])
def test_postprocess_single_object_grasps_match_jax(case):
    """The JAX test's case (40 frames on point 0: the redistribution to
    neighbours), frames spread over the cloud with mixed scores, and no
    frame above the score threshold."""
    cloud, normals = make_box_cloud(np.random.RandomState(21),
                                    n_per_face=150, half=0.025)
    rng = np.random.RandomState(1)
    g = 40 if case == "one_point" else 120
    frames = np.tile(np.eye(4, dtype=np.float32), (g, 1, 1))
    frames[:, :3, 3] = rng.randn(g, 3).astype(np.float32)
    point_index = (np.zeros(g, np.int64) if case == "one_point"
                   else rng.randint(0, len(cloud), g))
    search = {"one_point": np.full(g, 100.0),
              "spread": rng.rand(g) * 100,
              "none_kept": np.full(g, 10.0)}[case]
    data = {"cloud": cloud, "normal": normals, "global_to_local": frames,
            "search_score": search, "frame_point_index": point_index}
    got = tpp.postprocess_single_object_grasps(data)
    _same(got, jpp.postprocess_single_object_grasps(data))
    if case == "one_point":
        assert np.bincount(got["grasp_point_index"]).max() <= 1
        assert len(got["grasp_pose"]) > 1           # redistributed
    if case == "none_kept":
        assert len(got["grasp_pose"]) == 0


# -- datagen/json_to_pcd -----------------------------------------------------

def test_json_to_pcd_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    jdir = tmp_path / "json"
    jdir.mkdir()
    for name in ("025_mug", ".hidden", "unknown_object", "013_apple"):
        pts = rng.rand(20, 3)
        nrm = rng.randn(20, 3)
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        with open(jdir / f"{name}.json", "w") as f:
            json.dump([{"v": list(map(float, p)), "n": list(map(float, m))}
                       for p, m in zip(pts, nrm)], f)
    _same(tjp.load_json_cloud(str(jdir / "025_mug.json")),
          jjp.load_json_cloud(str(jdir / "025_mug.json")))
    assert tjp.NAME_SCALE == jjp.NAME_SCALE
    for table in (None, {"025_mug": [0.8, 1.0, 2.0]}):
        got = tjp.convert_json_dir(str(jdir), str(tmp_path / "t"), table)
        want = jjp.convert_json_dir(str(jdir), str(tmp_path / "j"), table)
        assert [os.path.basename(p) for p in got] == \
            [os.path.basename(p) for p in want]
        for g, w in zip(got, want):
            with open(g, "rb") as fg, open(w, "rb") as fw:
                assert fg.read() == fw.read(), g
    assert len(got) == 3                         # the mug's three scales
    out = tjp.main(["-j", str(jdir), "-p", str(tmp_path / "cli")])
    assert out is None and len(os.listdir(tmp_path / "cli")) == 8


# -- datagen/grasp_env -------------------------------------------------------

def test_grasp_env_xml_matches_jax():
    assert tge.gripper_xml() == jge.gripper_xml()
    assert tge._actuator_xml() == jge._actuator_xml()
    from s4g_tpu_torch.robot import grasp_client
    rng = np.random.RandomState(3)
    q, _ = np.linalg.qr(rng.randn(4, 3, 3))
    for rot in list(q) + [np.diag([1, -1, -1]), np.diag([-1, 1, -1])]:
        _same(grasp_client._mat2quat(rot), jge._mat2quat(rot))
        _same(tge._mat2quat(rot), jge._mat2quat(rot))


@pytest.mark.slow
def test_grasp_env_lift():
    """The JAX package's lift test on the port's GraspEnv (a MuJoCo drop
    and two grasps: slow, as the JAX test)."""
    pytest.importorskip("mujoco")
    from s4g_tpu_torch.datagen.scene_sim import ObjectSpec

    env = tge.GraspEnv([ObjectSpec(name="box0", size="0.02 0.02 0.04")],
                       percentage=1.1, random_seed=5)
    poses = env.prepare()
    assert "box0" in poses
    pose = np.eye(4)
    pose[:3, 0] = [0, 0, -1]
    pose[:3, 1] = [0, 1, 0]
    pose[:3, 2] = [1, 0, 0]
    pose[:3, 3] = poses["box0"][:3] + np.array([0, 0, 0.06])
    result = env.evaluate_single_grasp(pose)
    assert "success" in result and "lift_heights" in result
    miss = pose.copy()
    miss[:3, 3] = [0.3, 0.3, 1.0]
    assert not env.evaluate_single_grasp(miss)["success"]


# -- runtime/host_ops --------------------------------------------------------

def test_native_library_builds():
    assert tho.native_available(), "g++ toolchain expected in this image"
    assert jho.native_available()
    assert os.path.dirname(tho._LIB_PATH).endswith(
        os.path.join("s4g_tpu_torch", "_build"))


def _dirty_cloud():
    """test_runtime's sentinel case: a dense cluster with invalid-depth
    points at 1e4, -9.9e3 and 1e8 m."""
    rng = np.random.RandomState(0)
    pts = (rng.rand(3000, 3) * 0.05).astype(np.float32)
    pts[:30] = 1e4
    pts[30:60] = -9.9e3
    pts[60:70] = np.array([1e8, -1e8, 5e7], np.float32)
    return pts


def _host_cases():
    """The inputs of tests/test_runtime.py's host-op cases."""
    rng = np.random.RandomState(0)
    uniform = rng.uniform(0, 0.1, (500, 3)).astype(np.float32)
    small = np.random.RandomState(1).uniform(0, 0.05, (200, 3)).astype(
        np.float32)
    rng = np.random.RandomState(2)
    blob = np.concatenate([rng.normal(0, 0.002, (60, 3)),
                           np.array([[1.0, 1, 1], [2, 2, 2]])]).astype(
                               np.float32)
    rng = np.random.RandomState(3)
    ref = rng.uniform(0, 0.2, (300, 3)).astype(np.float32)
    query = ref[:50] + rng.normal(0, 0.001, (50, 3)).astype(np.float32)
    dirty = _dirty_cloud()
    return {
        "voxel": [(uniform, 0.02), (small, 0.01), (dirty, 0.004)],
        "outlier": [(blob, 0.02, 10), (dirty, 0.01, 5), (dirty[70:], 0.01, 5)],
        "nn": [(query, ref, 0.01), (np.full((3, 3), 10.0, np.float32),
                                    np.zeros((5, 3), np.float32), 0.05),
               (dirty[:500], dirty[500:], 0.002)],
    }


def test_host_ops_native_matches_jax_native():
    cases = _host_cases()
    for pts, size in cases["voxel"]:
        _same(tho.voxel_downsample_trace(pts, size),
              jho.voxel_downsample_trace(pts, size))
    for pts, r, k in cases["outlier"]:
        _same(tho.radius_outlier_mask(pts, r, k),
              jho.radius_outlier_mask(pts, r, k))
    for q, ref, r in cases["nn"]:
        _same(tho.nearest_neighbor_match(q, ref, r),
              jho.nearest_neighbor_match(q, ref, r))
    keep = tho.radius_outlier_mask(*cases["outlier"][1])
    assert keep[70:].mean() > 0.95              # sane points unaffected
    assert len(tho.voxel_downsample_trace(*cases["voxel"][2])[0]) > 100
    idx, d2 = tho.nearest_neighbor_match(*cases["nn"][1])
    assert (idx == -1).all() and (d2 == -1).all()


def voxel_sets(points, trace):
    """A voxel trace as order-free rows: (trace, x, y, z) sorted by trace
    (the native library emits voxels in discovery order, numpy in key
    order)."""
    order = np.argsort(trace)
    return trace[order], points[order]


def test_host_ops_numpy_paths_match_native():
    """The numpy paths against the native library: outlier masks and 1-NN
    exactly, the voxel traces as the same sets, their means within f32
    rounding (the library sums in float64, numpy in float32)."""
    cases = _host_cases()
    for pts, size in cases["voxel"][:2]:
        nat = voxel_sets(*tho.voxel_downsample_trace(pts, size))
        ref = voxel_sets(*tho.numpy_voxel_downsample_trace(pts, size,
                                                           pts.min(0)))
        np.testing.assert_array_equal(nat[0], ref[0])
        np.testing.assert_allclose(nat[1], ref[1], rtol=0, atol=1e-7)
    for pts, r, k in cases["outlier"][::2]:
        _same(tho.radius_outlier_mask(pts, r, k),
              tho.numpy_radius_outlier_mask(pts, r, k))
    for q, ref, r in cases["nn"]:
        _same(tho.nearest_neighbor_match(q, ref, r),
              tho.numpy_nearest_neighbor_match(q, ref, r))


def test_host_ops_take_numpy_without_the_library(monkeypatch):
    """Where the library does not build, every entry point takes its
    numpy path (the JAX module's contract)."""
    monkeypatch.setattr(tho, "_lib", None)
    monkeypatch.setattr(tho, "_tried", True)
    assert not tho.native_available()
    pts, size = _host_cases()["voxel"][1]
    _same(tho.voxel_downsample_trace(pts, size),
          tho.numpy_voxel_downsample_trace(pts, size, pts.min(0)))
    pts, r, k = _host_cases()["outlier"][0]
    _same(tho.radius_outlier_mask(pts, r, k),
          jho.radius_outlier_mask(pts, r, k))


# -- runtime/guard -----------------------------------------------------------

def test_run_subprocess_captures_and_kills():
    rc, out = guard.run_subprocess("print('hello'); import sys; "
                                   "sys.stderr.write('err\\n')", 60)
    assert rc == 0 and "hello" in out and "err" in out
    rc, _ = guard.run_subprocess("raise SystemExit(3)", 60)
    assert rc == 3
    t0 = time.perf_counter()
    rc, out = guard.run_subprocess(
        "print('started', flush=True); import time; time.sleep(60)", 2.0)
    assert rc is None and "started" in out
    assert time.perf_counter() - t0 < 30


def test_scrubbed_cpu_env_hides_the_card():
    env = guard.scrubbed_cpu_env()
    assert env["CUDA_VISIBLE_DEVICES"] == ""
    # n_devices keeps the JAX signature; nothing reads it.
    assert guard.scrubbed_cpu_env(4) == env
    rc, out = guard.run_subprocess(
        "import os; print(repr(os.environ['CUDA_VISIBLE_DEVICES']))", 60,
        env=env)
    assert rc == 0 and out.strip() == "''"


def test_backend_reachable_reports_no_gpu():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the probe would find it")
    t0 = time.perf_counter()
    ok, reason = guard.backend_reachable(timeout_s=120)
    assert not ok and "no GPU" in reason
    assert time.perf_counter() - t0 < 120
    assert not guard.kernels_build(timeout_s=120)
    assert not hasattr(guard, "enable_persistent_cache")

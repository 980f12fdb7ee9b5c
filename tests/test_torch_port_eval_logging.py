"""The port's eval and logging modules against the JAX package on the same
inputs: `pipeline.eval_cloud.eval_frames` (every chunk size),
`pipeline.file_logger.log_to_file` (the same files, the same top-K set),
`postprocessing.expected_score(upper_bins=)`, the numpy copies
(`utils.io_ply`, `utils.grasp_visualizer`, `utils.html_viewer`,
`robot/*`: byte for byte or value for value) and `utils.profiling`."""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from s4g_tpu.pipeline import eval_cloud as jeval
from s4g_tpu.pipeline import file_logger as jlog
from s4g_tpu.pipeline import postprocessing as jpost
from s4g_tpu.robot import grasp_client as jgc
from s4g_tpu.robot import vision_client as jvc
from s4g_tpu.utils import grasp_visualizer as jviz
from s4g_tpu.utils import html_viewer as jhtml
from s4g_tpu.utils import io_ply as jply

from s4g_tpu_torch.configs import gripper_config as G
from s4g_tpu_torch.configs import processing_config as P
from s4g_tpu_torch.pipeline import eval_cloud as teval
from s4g_tpu_torch.pipeline import file_logger as tlog
from s4g_tpu_torch.pipeline import postprocessing as tpost
from s4g_tpu_torch.robot import grasp_client as tgc
from s4g_tpu_torch.robot import vision_client as tvc
from s4g_tpu_torch.utils import grasp_visualizer as tviz
from s4g_tpu_torch.utils import html_viewer as thtml
from s4g_tpu_torch.utils import io_ply as tply
from s4g_tpu_torch.utils import profiling as tprof

from test_datagen_grading import make_box_cloud


# -- eval_frames -----------------------------------------------------------------

def _pose(x_axis, y_axis, t):
    """A local->global pose from its approach (x) and finger (y) axes."""
    pose = np.eye(4)
    pose[:3, 0], pose[:3, 1] = x_axis, y_axis
    pose[:3, 2] = np.cross(x_axis, y_axis)
    pose[:3, 3] = t
    return pose


def labeled_scene(rng):
    """Box A (label 0, half 0.025) at the origin, box B (label 1, half 0.02)
    centred at x = 0.07, and a sparse 20-point cluster (label 2) at x = 0.3:
    cloud (N, 3), normals (N, 3), int32 labels."""
    a_pts, a_nrm = make_box_cloud(rng, n_per_face=200, half=0.025)
    b_pts, b_nrm = make_box_cloud(rng, n_per_face=150, half=0.02)
    c_pts = rng.uniform(-0.005, 0.005, (20, 3)) + [0.3, 0.0, 0.0]
    c_nrm = np.tile([0.0, 1.0, 0.0], (20, 1))
    cloud = np.concatenate([a_pts, b_pts + [0.07, 0.0, 0.0], c_pts])
    normals = np.concatenate([a_nrm, b_nrm, c_nrm])
    labels = np.repeat([0, 1, 2], [len(a_pts), len(b_pts), 20])
    return (cloud.astype(np.float32), normals.astype(np.float32),
            labels.astype(np.int32))


def scene_poses(rng, cloud, num_random=120, num_down=40):
    """(G, 4, 4) f32 world->gripper matrices: a graspable top-down pose on
    box A, one far away (an empty close region), one straddling A and B
    (two labels), one sunk into A (collides), one on the 20-point cluster
    (too few points), then random rotations at random scene points, then
    top-down grasps over either box at random yaws and heights."""
    down, along_y, along_x = [0, 0, -1.0], [0, 1.0, 0], [1.0, 0, 0]
    poses = [_pose(down, along_y, [0.001, 0.002, 0.03]),
             _pose(down, along_y, [5.0, 5.0, 5.0]),
             _pose(down, along_x, [0.0475, 0.0, 0.03]),
             _pose(down, along_y, [0.0, 0.0, -0.03]),
             _pose(down, along_y, [0.3, 0.0, 0.02])]
    q, r = np.linalg.qr(rng.randn(num_random, 3, 3))
    q = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    centers = cloud[rng.choice(len(cloud), num_random)]
    for rot, c in zip(q, centers):
        poses.append(_pose(rot[:, 0], rot[:, 1],
                           c - rng.uniform(0.0, 0.03) * rot[:, 0]))
    for _ in range(num_down):
        yaw = rng.uniform(0, np.pi)
        x0 = rng.choice([0.0, 0.07]) + rng.uniform(-0.01, 0.01)
        poses.append(_pose(down, [np.cos(yaw), np.sin(yaw), 0.0],
                           [x0, rng.uniform(-0.01, 0.01),
                            rng.uniform(0.02, 0.06)]))
    return np.linalg.inv(np.stack(poses)).astype(np.float32)


def near_faces(g2l, cloud, ulps=4):
    """Pose-point pairs whose gripper-frame coordinate lies within `ulps`
    f32 ulps of a box face the masks test (float64 arithmetic)."""
    homo = np.concatenate([cloud.T, np.ones((1, len(cloud)))]).astype(
        np.float64)
    local = np.einsum("gij,jn->gin", g2l.astype(np.float64), homo)[:, :3]
    faces = {0: (G.FINGER_LENGTH, -G.BOTTOM_LENGTH,
                 -P.BACK_COLLISION_MARGIN),
             1: (G.HALF_BOTTOM_WIDTH, -G.HALF_BOTTOM_WIDTH,
                 G.HALF_BOTTOM_SPACE, -G.HALF_BOTTOM_SPACE),
             2: (G.HALF_HAND_THICKNESS, -G.HALF_HAND_THICKNESS)}
    tol = ulps * np.finfo(np.float32).eps * 0.2   # coordinates up to ~0.2 m
    near = np.zeros(local.shape[::2], bool)
    for axis, values in faces.items():
        for v in values:
            near |= np.abs(local[:, axis] - v) <= tol
    return int(near.sum())


@pytest.fixture(scope="module")
def scene():
    rng = np.random.RandomState(9)
    cloud, normals, labels = labeled_scene(rng)
    return cloud, normals, labels, scene_poses(rng, cloud)


def _jax_eval(g2l, cloud, normals, labels, valid=None):
    res = jeval.eval_frames(jnp.asarray(g2l), jnp.asarray(cloud),
                            jnp.asarray(normals), jnp.asarray(labels),
                            None if valid is None else jnp.asarray(valid))
    return [np.asarray(x) for x in res]


def _port_eval(g2l, cloud, normals, labels, valid=None, chunk=None):
    res = teval.eval_frames(
        torch.from_numpy(g2l), torch.from_numpy(cloud),
        torch.from_numpy(normals), torch.from_numpy(labels),
        None if valid is None else torch.from_numpy(valid), chunk=chunk)
    return [x.numpy() for x in res]


@pytest.mark.parametrize("masked", [False, True])
def test_eval_frames_matches_jax(scene, masked):
    """collision and multi_objects equal on every pose, the antipodal score
    within 1e-5, with and without a validity mask; the constructed poses
    land in the cases they were built for."""
    cloud, normals, labels, g2l = scene
    valid = (np.random.RandomState(3).rand(len(cloud)) > 0.2
             if masked else None)
    want = _jax_eval(g2l, cloud, normals, labels, valid)
    got = _port_eval(g2l, cloud, normals, labels, valid)
    near = near_faces(g2l, cloud)
    for name, g, w in zip(("collision", "multi_objects"), got, want):
        assert g.dtype == np.bool_ and g.shape == (len(g2l),)
        np.testing.assert_array_equal(
            g, w, err_msg=f"{name}; {near} pose-point pairs lie within 4 "
                          "ulp of a box face")
    assert got[2].dtype == np.float32
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-5)
    if not masked:
        collision, multi, score = got
        assert score[0] > 0.3 and not collision[0] and not multi[0]
        assert multi[1] and score[1] == 0          # empty close region
        assert multi[2] and score[2] == 0          # two labels
        assert collision[3] and score[3] == 0
        assert not collision[4] and not multi[4] and score[4] == 0
        assert (score[5:] > 0).any() and (score[5:] == 0).any()


@pytest.mark.parametrize("chunk", [1, 7, 64, 1000])
def test_eval_frames_is_the_same_for_every_chunk(scene, chunk):
    cloud, normals, labels, g2l = scene
    whole = _port_eval(g2l, cloud, normals, labels)
    got = _port_eval(g2l, cloud, normals, labels, chunk=chunk)
    for g, w in zip(got, whole):
        np.testing.assert_array_equal(g, w)


def test_eval_frames_default_chunk_follows_the_cloud(scene, monkeypatch):
    """The default chunk keeps chunk x N near CHUNK_PAIRS: with a small
    budget the poses go through in many chunks, with the same result."""
    cloud, normals, labels, g2l = scene
    whole = _port_eval(g2l, cloud, normals, labels)
    monkeypatch.setattr(teval, "CHUNK_PAIRS", 5 * len(cloud))
    seen = []
    real = teval._eval_chunk
    monkeypatch.setattr(teval, "_eval_chunk", lambda m, *a: (
        seen.append(len(m)), real(m, *a))[1])
    got = _port_eval(g2l, cloud, normals, labels)
    assert max(seen) == 5 and len(seen) == -(-len(g2l) // 5)
    for g, w in zip(got, whole):
        np.testing.assert_array_equal(g, w)


def test_eval_frames_without_poses(scene):
    cloud, normals, labels, _ = scene
    empty = np.zeros((0, 4, 4), np.float32)
    want = _jax_eval(empty, cloud, normals, labels)
    got = _port_eval(empty, cloud, normals, labels)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (0,) and g.dtype == w.dtype


def test_antipodal_empty_region_is_zero():
    """An empty close region: left_y -inf, right_y +inf, NaN band edges,
    empty bands, 0 / max(0, 1) = 0 in both packages."""
    rng = np.random.RandomState(1)
    local = rng.randn(2, 3, 30).astype(np.float32)
    ny = rng.randn(2, 30).astype(np.float32)
    close = np.zeros((2, 30), bool)
    close[1, :10] = True
    want = np.asarray(jeval._antipodal(
        jnp.asarray(local), jnp.asarray(np.stack([ny] * 3, axis=1)),
        jnp.asarray(close)))
    got = teval.antipodal(torch.from_numpy(local[:, 1]),
                          torch.from_numpy(ny),
                          torch.from_numpy(close)).numpy()
    assert got[0] == want[0] == 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# -- expected_score ----------------------------------------------------------------

@pytest.mark.parametrize("upper", [True, False])
@pytest.mark.parametrize("c", [3, 4, 10])
def test_expected_score_bins_match_jax(upper, c):
    logits = np.random.RandomState(c).randn(c, 500).astype(np.float32) * 3
    want = np.asarray(jpost.expected_score(jnp.asarray(logits),
                                           upper_bins=upper))
    got = tpost.expected_score(torch.from_numpy(logits),
                               upper_bins=upper).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-7)
    other = tpost.expected_score(torch.from_numpy(logits),
                                 upper_bins=not upper).numpy()
    shift = 1.0 / c if upper else -1.0 / c
    np.testing.assert_allclose(got - other, shift, atol=1e-6)


# -- log_to_file --------------------------------------------------------------------

def _predictions(rng, n=600, c=3):
    """A camera-frame cloud (a table with two boxes ~0.7 m away) and random
    channels-first predictions for it, batch of one."""
    plane = np.column_stack([rng.uniform(-0.2, 0.2, (n - 200, 2)),
                             np.full(n - 200, 0.75)])
    boxes = np.concatenate([rng.uniform(-0.02, 0.02, (100, 3))
                            + [x, 0.0, 0.7] for x in (-0.1, 0.1)])
    pts = np.concatenate([plane, boxes]).astype(np.float32)
    preds = {"score": rng.randn(1, c, n).astype(np.float32) * 2,
             "frame_R": rng.randn(1, 9, n).astype(np.float32),
             "frame_t": rng.randn(1, 4, n).astype(np.float32)}
    batch = {"scene_points": pts.T[None].copy(),
             "scene_score": rng.rand(1, n).astype(np.float32),
             "scene_score_labels": rng.randint(0, c, (1, n))}
    return batch, preds


def _loadtxt(path):
    return np.loadtxt(path, ndmin=1)


_EXACT = ("scene_points.xyz", "pred_frame_R.txt", "gt_scene_score.txt",
          "gt_scene_score_labels.txt")
_AT_FORMAT = ("scene_score_logits.txt", "pred_frame_t.txt",
              "pred_scene_score.txt")


def _match_rows(got, want, atol):
    """Every row of `got` within `atol` of a distinct row of `want` (a set
    comparison: np.argsort's order of near-ties is not fixed)."""
    assert got.shape == want.shape
    flat_g, flat_w = got.reshape(len(got), -1), want.reshape(len(want), -1)
    free = list(range(len(flat_w)))
    for row in flat_g:
        dist = [np.abs(row - flat_w[j]).max() for j in free]
        k = int(np.argmin(dist))
        assert dist[k] <= atol, (row, dist[k])
        free.pop(k)


@pytest.mark.parametrize("with_label", [True, False])
def test_log_to_file_matches_jax(tmp_path, monkeypatch, with_label):
    """The same files: inputs written as they are byte for byte, softmaxes,
    frames and expected scores at the "%.4f" format's resolution, the jet
    cloud's colours within one step; unlabeled, the top-K poses and scores
    as a set within 1e-5 (the top K are an unstable argsort of scores that
    may differ by an ulp between the packages) and top_frames.npy alike;
    each call appends one line to postprocess_time_ours.txt in the working
    directory."""
    monkeypatch.chdir(tmp_path)
    batch, preds = _predictions(np.random.RandomState(5))
    want = jlog.log_to_file(batch, preds, 3, str(tmp_path / "jax"), "t",
                            with_label=with_label)
    got = tlog.log_to_file({k: torch.from_numpy(v) for k, v in batch.items()},
                           {k: torch.from_numpy(v) for k, v in preds.items()},
                           3, str(tmp_path / "port"), "t",
                           with_label=with_label)
    jdir, tdir = tmp_path / "jax" / "t_step00003", tmp_path / "port" / \
        "t_step00003"
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(tdir)) == names
    for name in set(_EXACT) & set(names):
        assert (tdir / name).read_bytes() == (jdir / name).read_bytes()
    assert ("gt_scene_score.txt" in names) == with_label
    for name in _AT_FORMAT:
        np.testing.assert_allclose(_loadtxt(tdir / name),
                                   _loadtxt(jdir / name), rtol=0,
                                   atol=1e-4 + 1e-9)
    g_ply = np.loadtxt(tdir / "pred_pts.ply", skiprows=10)
    w_ply = np.loadtxt(jdir / "pred_pts.ply", skiprows=10)
    np.testing.assert_array_equal(g_ply[:, :3], w_ply[:, :3])
    assert np.abs(g_ply[:, 3:] - w_ply[:, 3:]).max() <= 1
    if with_label:
        assert got is None and want is None
        assert not (tmp_path / "postprocess_time_ours.txt").exists()
        return
    (g_h, g_s), (w_h, w_s) = got, want
    assert len(g_h) > 0
    _match_rows(np.concatenate([g_h.reshape(-1, 16), g_s[:, None]], 1),
                np.concatenate([w_h.reshape(-1, 16), w_s[:, None]], 1),
                1e-5)
    _match_rows(np.load(tmp_path / "port" / "top_frames.npy"),
                np.load(tmp_path / "jax" / "top_frames.npy"), 1e-5)
    assert (tdir / "cloud.ply").read_bytes() == (jdir / "cloud.ply")\
        .read_bytes()
    assert len((tmp_path / "postprocess_time_ours.txt").read_text()
               .splitlines()) == 2


def test_log_to_file_other_outputs(tmp_path):
    """Grasp logits are dumped alone; predictions without a score head (the
    contact model's) write nothing past the step directory."""
    logits = np.random.RandomState(0).randn(5, 2).astype(np.float32)
    for pkg, out in ((jlog, "jax"), (tlog, "port")):
        assert pkg.log_to_file({}, {"grasp_logits": logits}, 0,
                               str(tmp_path / out)) is None
        assert pkg.log_to_file({}, {"frame_R": logits}, 1,
                               str(tmp_path / out)) is None
    assert (tmp_path / "port" / "_step00000" / "grasp_logits.txt")\
        .read_bytes() == (tmp_path / "jax" / "_step00000" /
                          "grasp_logits.txt").read_bytes()
    assert os.listdir(tmp_path / "port" / "_step00001") == []


def test_jet_matches_jax():
    v = np.linspace(-0.2, 1.2, 57)
    np.testing.assert_array_equal(tlog._jet(v), jlog._jet(v))


# -- numpy copies: PLY, visualizer, HTML viewer ----------------------------------

@pytest.mark.parametrize("colors,normals", [(False, False), (True, False),
                                            (True, True)])
def test_ply_points_are_byte_identical(tmp_path, colors, normals):
    rng = np.random.RandomState(2)
    pts = rng.randn(40, 3).astype(np.float32)
    kw = {"colors": rng.rand(40, 3) if colors else None,
          "normals": rng.randn(40, 3) if normals else None}
    jply.write_ply_points(str(tmp_path / "j.ply"), pts, **kw)
    tply.write_ply_points(str(tmp_path / "t.ply"), pts, **kw)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply")\
        .read_bytes()
    np.testing.assert_array_equal(tply.read_ply_points(str(tmp_path /
                                                           "t.ply")),
                                  jply.read_ply_points(str(tmp_path /
                                                           "j.ply")))


@pytest.mark.parametrize("colors", [False, True])
def test_ply_mesh_is_byte_identical_and_binary_reads(tmp_path, colors):
    rng = np.random.RandomState(3)
    verts, tris = rng.randn(12, 3), rng.randint(0, 12, (7, 3))
    vc = rng.rand(12, 3) if colors else None
    jply.write_ply_mesh(str(tmp_path / "j.ply"), verts, tris, vc)
    tply.write_ply_mesh(str(tmp_path / "t.ply"), verts, tris, vc)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply")\
        .read_bytes()
    # a binary little-endian file with an extra property
    rec = np.zeros(5, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                             ("red", "u1")])
    rec["x"], rec["y"], rec["z"] = rng.randn(3, 5)
    header = ("ply\nformat binary_little_endian 1.0\nelement vertex 5\n"
              "property float x\nproperty float y\nproperty float z\n"
              "property uchar red\nend_header\n").encode()
    (tmp_path / "b.ply").write_bytes(header + rec.tobytes())
    np.testing.assert_array_equal(
        tply.read_ply_points(str(tmp_path / "b.ply")),
        jply.read_ply_points(str(tmp_path / "b.ply")))


def test_grasp_visualizer_is_byte_identical(tmp_path):
    rng = np.random.RandomState(4)
    pts = rng.randn(3, 50).astype(np.float32)      # (3, N): transposed
    q, _ = np.linalg.qr(rng.randn(4, 3, 3))
    poses = np.tile(np.eye(4), (4, 1, 1))
    poses[:, :3, :3], poses[:, :3, 3] = q, rng.randn(4, 3) * 0.1
    for pkg, tag in ((jviz, "j"), (tviz, "t")):
        viz = pkg.GraspVisualizer(pts, colors=rng.rand(50, 3) * 0 + 0.5)
        viz.add_multiple_poses(poses[:3])
        viz.add_single_pose(poses[3])
        viz.save(str(tmp_path / f"{tag}_cloud.ply"),
                 str(tmp_path / f"{tag}_hands.ply"))
    for part in ("cloud", "hands"):
        assert (tmp_path / f"t_{part}.ply").read_bytes() \
            == (tmp_path / f"j_{part}.ply").read_bytes()
    for g, w in zip(tviz.gripper_hand_mesh(poses[0]),
                    jviz.gripper_hand_mesh(poses[0])):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("max_points,with_frames", [(40000, True),
                                                    (30, True),
                                                    (40000, False)])
def test_html_viewer_is_byte_identical(tmp_path, max_points, with_frames):
    rng = np.random.RandomState(6)
    pts = rng.randn(80, 3)
    kw = {}
    if with_frames:
        idx = np.array([3, 17, 50])
        kw = {"scores": rng.rand(80), "grasp_point_indices": idx,
              "frames_per_point": [np.tile(np.eye(4), (k, 1, 1)) + 0.01 * k
                                   for k in (1, 2, 3)]}
    jhtml.export_interactive_viewer(str(tmp_path / "j.html"), pts,
                                    max_points=max_points, **kw)
    tpath = thtml.export_interactive_viewer(str(tmp_path / "t.html"), pts,
                                            max_points=max_points, **kw)
    assert tpath == str(tmp_path / "t.html")
    assert (tmp_path / "t.html").read_bytes() == (tmp_path / "j.html")\
        .read_bytes()


# -- robot clients -------------------------------------------------------------------

def _rotations(rng):
    """Random rotations and the 180-degree turns that take every branch of
    the quaternion conversion (trace > 0, and each largest diagonal)."""
    q, r = np.linalg.qr(rng.randn(6, 3, 3))
    q = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    q[np.linalg.det(q) < 0, :, 2] *= -1
    turns = [np.diag(d) for d in ([1, -1, -1], [-1, 1, -1], [-1, -1, 1])]
    return list(q) + turns + [np.eye(3)]


def test_mat2quat_matches_jax():
    from s4g_tpu.datagen.grasp_env import _mat2quat as want
    for rot in _rotations(np.random.RandomState(7)):
        np.testing.assert_array_equal(tgc._mat2quat(rot), want(rot))


def test_grasp_requests_match_jax():
    rng = np.random.RandomState(8)
    poses = np.tile(np.eye(4), (10, 1, 1))
    poses[:, :3, :3] = np.stack(_rotations(rng))
    poses[:, :3, 3] = rng.randn(10, 3)
    np.testing.assert_array_equal(tgc.HAND_TO_EE, jgc.HAND_TO_EE)
    np.testing.assert_array_equal(tgc.EE_TO_HAND, jgc.EE_TO_HAND)
    got, want = tgc.GraspClient(), jgc.GraspClient()
    assert got.build_request(poses, order=2, service_type="grasp",
                             return_type="all") \
        == want.build_request(poses, order=2, service_type="grasp",
                              return_type="all")
    assert got.add_table_collision_pose(poses[1]) \
        == want.add_table_collision_pose(poses[1])
    assert tgc.mat_pose_to_pose_stamped(poses[2], "base") \
        == jgc.mat_pose_to_pose_stamped(poses[2], "base")
    with pytest.raises(RuntimeError, match="rosbridge"):
        got.call_grasp(poses)


def test_vision_client_parses_like_jax():
    rng = np.random.RandomState(9)
    response = {"points": [dict(zip("xyz", p)) for p in rng.randn(25, 3)]}
    got = tvc.VisionClient.parse_cloud_response(response)
    np.testing.assert_array_equal(
        got, jvc.VisionClient.parse_cloud_response(response))
    assert got.shape == (25, 3) and got.dtype == np.float32
    assert tvc.VisionClient.parse_cloud_response({}).shape == (0,)
    with pytest.raises(RuntimeError, match="rosbridge"):
        tvc.VisionClient().capture()


# -- profiling ------------------------------------------------------------------------

def test_stage_timer_and_append_timing(tmp_path):
    path = str(tmp_path / "times.txt")
    tprof.append_timing(path, 1.23456)
    tprof.append_timing(path, 7)
    assert open(path).read() == "1.2346\n7.0000\n"


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path / "tr")) as prof:
        with tprof.span("s4g_region"):
            torch.ones(64).cumsum(0)
    files = os.listdir(tmp_path / "tr")
    assert [os.path.join(tmp_path / "tr", f) for f in files] \
        == [prof.trace_file]
    events = json.load(open(prof.trace_file))["traceEvents"]
    assert any(e.get("name") == "s4g_region" for e in events)
    assert tprof.device_kernel_times(prof) == []
    with tprof.trace(str(tmp_path / "off"), enabled=False) as off:
        assert off is None
    assert not (tmp_path / "off").exists()

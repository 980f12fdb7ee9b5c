"""The port's contact flavour (`datagen.contact`, `datagen.refine_contact`),
baseline and eval data (`datagen.baseline_data`, `baseline_generator`,
`eval_data`) and the MuJoCo stages (`scene_sim`, `movability`,
`generate_end_to_end`, `generate_scenes`) against the JAX package on the
same numpy inputs, the port on the CPU.  Tolerances as in
test_torch_port_datagen.py: integers and masks exact bar cells with a point
within 4 ulp of a box face; floats within 1e-6 (projection maps, close
regions) or 1e-5 (scores through `eval_frames`)."""

import os
import pickle

import numpy as np
import pytest
import torch

from s4g_tpu.datagen import baseline_data as jbd
from s4g_tpu.datagen import baseline_generator as jbg
from s4g_tpu.datagen import contact as jct
from s4g_tpu.datagen import eval_data as jev
from s4g_tpu.datagen import grading as jgrad
from s4g_tpu.datagen import refine_contact as jrc
from s4g_tpu.utils.math_utils import batch_transformation_inv as jinv

from s4g_tpu_torch.configs import gripper_config as G
from s4g_tpu_torch.datagen import baseline_data as tbd
from s4g_tpu_torch.datagen import baseline_generator as tbg
from s4g_tpu_torch.datagen import contact as tct
from s4g_tpu_torch.datagen import eval_data as tev
from s4g_tpu_torch.datagen import grading as tgrad
from s4g_tpu_torch.datagen import refine_contact as trc

from test_datagen_grading import make_box_cloud
from test_torch_port_datagen import (_inject_jax_frames, assert_cells_equal,
                                     ellipsoid_cloud, j, near_cells, t)


@pytest.fixture(scope="module")
def contact_object():
    """An ellipsoid cloud, its pairs and pair frames (host numpy)."""
    cloud, normals = ellipsoid_cloud(np.random.RandomState(21), n=1200,
                                     axes=(0.02, 0.03, 0.04))
    row, col, score = jct.cache_contact_pairs(cloud, normals, max_pairs=256,
                                              rng=np.random.RandomState(0))
    frames = jct.pair_frames(cloud, row, col)
    g2l = np.linalg.inv(frames.astype(np.float64)).astype(np.float32)
    homo = np.concatenate([cloud.T, np.ones((1, len(cloud)))]).astype(
        np.float32)
    return cloud, normals, g2l, homo


def contact_faces():
    """Faces of `grade_contact_pairs` in the theta search frames."""
    return {0: (0.0, -jgrad.DATAGEN_BOTTOM_LENGTH, G.FINGER_LENGTH),
            2: tuple(s * G.HALF_HAND_THICKNESS + dw for s in (1, -1)
                     for dw in jct.DW_SEARCH)}


def test_contact_host_stages_are_copies(contact_object):
    cloud, normals, _, _ = contact_object
    for g, w in zip(tct.contact_search_transforms(),
                    jct.contact_search_transforms()):
        np.testing.assert_array_equal(g, w)
    got = tct.cache_contact_pairs(cloud, normals, max_pairs=256,
                                  rng=np.random.RandomState(0))
    want = jct.cache_contact_pairs(cloud, normals, max_pairs=256,
                                   rng=np.random.RandomState(0))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(tct.pair_frames(cloud, *got[:2]),
                                  jct.pair_frames(cloud, *want[:2]))


@pytest.mark.parametrize("chunk", [None, 7])
def test_grade_contact_pairs_matches_jax(contact_object, chunk):
    """search and valid exact bar (pair, theta) cells near a face; the
    pair-plane count (y faces) decides whole pairs, so its near pairs are
    exempt too."""
    cloud, _, g2l, homo = contact_object
    want_s, want_v = [np.asarray(x) for x in jct.grade_contact_pairs(
        j(g2l), j(homo), chunk=32)]
    got_s, got_v = [x.numpy() for x in tct.grade_contact_pairs(
        t(g2l), t(homo), chunk=chunk)]
    _, l2ls = tct.contact_search_transforms()
    cells = np.einsum("tij,pjk->ptik", l2ls.astype(np.float64),
                      g2l.astype(np.float64)).reshape(-1, 4, 4)
    near = near_cells(cells, cloud, contact_faces(), scale=0.1)
    near_pair = near_cells(g2l, cloud, {1: (
        G.HALF_BOTTOM_SPACE, -G.HALF_BOTTOM_SPACE, G.HALF_BOTTOM_WIDTH,
        -G.HALF_BOTTOM_WIDTH)}, scale=0.1)
    near |= np.repeat(near_pair, tct.THETA_NUM)
    assert_cells_equal(got_s, want_s, near, "search")
    assert_cells_equal(got_v, want_v, near, "valid")
    assert got_v.any() and got_s.dtype == np.float32


def test_generate_contact_object_data_matches_jax(contact_object):
    cloud, normals, _, _ = contact_object
    want = jct.generate_contact_object_data(cloud, normals, max_pairs=256,
                                            rng=np.random.RandomState(0))
    got = tct.generate_contact_object_data(cloud, normals, max_pairs=256,
                                           rng=np.random.RandomState(0),
                                           device="cpu")
    assert len(got["search_score"]) > 0
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def refine_faces():
    return {0: tuple(v + dx for v in (-jgrad.DATAGEN_BOTTOM_LENGTH,
                                      G.FINGER_LENGTH)
                     for dx in jrc.LENGTH_SEARCH) + (0.0,),
            1: (G.HALF_BOTTOM_SPACE, -G.HALF_BOTTOM_SPACE,
                G.HALF_BOTTOM_WIDTH, -G.HALF_BOTTOM_WIDTH),
            2: tuple(s * G.HALF_HAND_THICKNESS + dz for s in (1, -1)
                     for dz in jrc.HEIGHT_SEARCH)}


@pytest.fixture(scope="module")
def contact_data(contact_object):
    cloud, normals, _, _ = contact_object
    return jct.generate_contact_object_data(cloud, normals, max_pairs=1024,
                                            rng=np.random.RandomState(1))


def test_refine_chunk_matches_jax(contact_object, contact_data):
    """Scores exact bar frames near a face; the frames pushed 3 cm along
    their approach axis collide (-1)."""
    cloud, _, _, homo = contact_object
    pushed = contact_data["global_to_local"].copy()
    pushed[:, 0, 3] -= 0.03
    frames = np.concatenate([contact_data["global_to_local"], pushed])
    want = np.asarray(jrc._refine_chunk(j(frames), j(homo)))
    got = trc._refine_chunk(t(frames), t(homo)).numpy()
    near = near_cells(frames, cloud, refine_faces(), scale=0.1)
    assert_cells_equal(got, want, near, "refined score")
    assert got.dtype == np.int32 and (got > 0).any() and (got < 0).any()


@pytest.mark.parametrize("chunk", [None, 5])
def test_refine_and_smooth_match_jax(contact_object, contact_data, chunk):
    """refine_contact_object equal to JAX's bar frames near a face (which
    keep their frame but may score one point apart); every chunk size the
    same; smooth_contact_object (host numpy) of the same input equal."""
    cloud = contact_object[0]
    want = jrc.refine_contact_object(contact_data)
    got = trc.refine_contact_object(contact_data, chunk=chunk,
                                    device="cpu")
    assert len(got["search_score"]) > 0
    for key in want:
        assert got[key].dtype == want[key].dtype, key
    np.testing.assert_array_equal(got["global_to_local"],
                                  want["global_to_local"])
    near = near_cells(want["global_to_local"], cloud, refine_faces(),
                      scale=0.1)
    assert_cells_equal(got["search_score"], want["search_score"], near,
                       "refined search_score")
    for key in ("frame_point_index", "antipodal_score"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    whole = trc.refine_contact_object(contact_data, device="cpu")
    np.testing.assert_array_equal(got["search_score"], whole["search_score"])
    smooth_got, smooth_want = (trc.smooth_contact_object(want),
                               jrc.smooth_contact_object(want))
    for key in smooth_want:
        np.testing.assert_array_equal(smooth_got[key], smooth_want[key])


# -- baseline payloads -------------------------------------------------------

@pytest.fixture(scope="module")
def box_scene():
    rng = np.random.RandomState(3)
    cloud, normals = make_box_cloud(rng, n_per_face=300, half=0.025)
    return cloud, normals


def _grasp_g2l(rng, cloud, count=12):
    """(count, 4, 4) world -> gripper poses approaching the box from above
    at random yaws and heights."""
    poses = np.tile(np.eye(4), (count, 1, 1))
    for i in range(count):
        yaw = rng.uniform(0, np.pi)
        poses[i, :3, 0] = [0, 0, -1.0]
        poses[i, :3, 1] = [np.cos(yaw), np.sin(yaw), 0]
        poses[i, :3, 2] = np.cross(poses[i, :3, 0], poses[i, :3, 1])
        poses[i, :3, 3] = [rng.uniform(-0.01, 0.01), rng.uniform(-0.01, 0.01),
                           rng.uniform(0.03, 0.09)]
    return np.linalg.inv(poses).astype(np.float32)


def test_close_region_and_projection_match_jax(box_scene):
    cloud, normals = box_scene
    g2l = _grasp_g2l(np.random.RandomState(4), cloud)
    valid = np.ones(len(cloud), bool)
    for pose in g2l:
        w_pts, w_nrm, w_cnt = [np.asarray(x) for x in jbd.extract_close_region(
            j(pose), j(cloud), j(normals), j(valid), 256)]
        g_pts, g_nrm, g_cnt = [x.numpy() for x in tbd.extract_close_region(
            t(pose), t(cloud), t(normals), t(valid), 256)]
        assert int(g_cnt) == int(w_cnt)
        np.testing.assert_allclose(g_pts, w_pts, rtol=0, atol=1e-6)
        np.testing.assert_allclose(g_nrm, w_nrm, rtol=0, atol=1e-6)
        slot = np.arange(256) < max(int(w_cnt), 1)
        want = np.asarray(jbd.close_region_projection(j(w_pts), j(w_nrm),
                                                      j(slot)))
        got = tbd.close_region_projection(t(w_pts), t(w_nrm),
                                          t(slot)).numpy()
        assert got.shape == (12, 60, 60) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert int(g_cnt) > 0


def test_projection_bins_like_xla():
    """Coordinates on bin edges: XLA multiplies by the reciprocal of the
    constant units, and so does the port."""
    units = tbd._UNITS.astype(np.float32)
    k = np.random.RandomState(0).randint(0, 60, (3, 4000))
    pts = (k * units[:, None]).astype(np.float32)
    nrm = np.tile(np.array([[0.0], [1.0], [0.0]], np.float32), (1, 4000))
    valid = np.ones(4000, bool)
    want = np.asarray(jbd.close_region_projection(j(pts), j(nrm), j(valid)))
    got = tbd.close_region_projection(t(pts), t(nrm), t(valid)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_baseline_grasp_data_matches_jax(box_scene):
    cloud, normals = box_scene
    pose = _grasp_g2l(np.random.RandomState(5), cloud, 1)[0]
    want = jbd.baseline_grasp_data(pose, cloud, normals, num_points=512)
    got = tbd.baseline_grasp_data(pose, cloud, normals, num_points=512,
                                  device="cpu")
    assert got["num_close_points"] == want["num_close_points"] > 0
    for key in ("close_region_points", "close_region_normals",
                "close_region_projection_maps"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6)


def test_batch_transformation_inv_is_jax_bits():
    """The factory's SE(3) inverse (`grading.se3_inv`) is the JAX
    package's `batch_transformation_inv` bit for bit."""
    rng = np.random.RandomState(0)
    q, _ = np.linalg.qr(rng.randn(500, 3, 3))
    poses = np.tile(np.eye(4), (500, 1, 1))
    poses[:, :3, :3] = q
    poses[:, :3, 3] = rng.rand(500, 3)
    poses = poses.astype(np.float32)
    np.testing.assert_array_equal(tgrad.se3_inv(t(poses)).numpy(),
                                  np.asarray(jinv(j(poses))))


# -- eval and baseline views -------------------------------------------------

@pytest.fixture(scope="module")
def view_scene():
    """Two boxes above the table (labels 0 and 1, 4.5 cm apart) as the
    labeled scene, and a view of 70 % of their points."""
    rng = np.random.RandomState(8)
    parts, nrms, labels = [], [], []
    for lab, (x, half) in enumerate(((0.0, 0.03), (0.085, 0.025))):
        p, n = make_box_cloud(rng, n_per_face=160, half=half)
        parts.append(p + [x, 0.0, 0.8])
        nrms.append(n)
        labels.append(np.full(len(p), lab, np.int32))
    scene = {"cloud": np.concatenate(parts).astype(np.float32),
             "normal": np.concatenate(nrms).astype(np.float32),
             "label": np.concatenate(labels)}
    view = scene["cloud"][rng.rand(len(scene["cloud"])) < 0.7]
    return scene, view, np.array([0.3, 0.1, 1.6], np.float32)


@pytest.mark.parametrize("with_baseline", [False, True])
def test_generate_eval_view_matches_jax(view_scene, monkeypatch,
                                        with_baseline):
    """On JAX's frames: the same picks, poses, masks; scores within 1e-5;
    baseline payloads within 1e-6."""
    scene, view, cam = view_scene
    want = jev.generate_eval_view(view, cam, scene, num_grasp_points=150,
                                  rng=np.random.RandomState(2),
                                  with_baseline=with_baseline)
    _inject_jax_frames(monkeypatch, tev)
    got = tev.generate_eval_view(view, cam, scene, num_grasp_points=150,
                                 rng=np.random.RandomState(2),
                                 with_baseline=with_baseline, device="cpu")
    assert set(got) == set(want)
    for key in ("frames", "grasp_point_index", "view_cloud",
                "non_collision_bool", "single_label_bool",
                "scene_collision_bool", "baseline_index"):
        if key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(got["antipodal_score"],
                               want["antipodal_score"], rtol=0, atol=1e-5)
    assert (got["antipodal_score"] > 0).any()
    if with_baseline:
        assert len(got["baseline_index"]) > 0
        for key in ("close_region_points", "close_region_projection_maps"):
            np.testing.assert_allclose(got[key], want[key], rtol=0,
                                       atol=1e-6, err_msg=key)


def test_generate_baseline_view_matches_jax(view_scene, monkeypatch,
                                            tmp_path):
    scene, view, cam = view_scene
    want = jbg.generate_baseline_view(view, cam, scene, grasp_num=12,
                                      num_close_points=256,
                                      rng=np.random.RandomState(3))
    _inject_jax_frames(monkeypatch, tbg)
    path = str(tmp_path / "b.p")
    got = tbg.generate_baseline_view(view, cam, scene, grasp_num=12,
                                     num_close_points=256,
                                     rng=np.random.RandomState(3),
                                     save_path=path, device="cpu")
    assert len(got["grasp_score_labels"]) == 12
    for key in ("baseline_frame", "grasp_point_index", "grasp_score_labels",
                "view_cloud"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key, tol in (("antipodal_score", 1e-5), ("close_region_points", 1e-6),
                     ("close_region_projection_maps", 1e-6)):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=tol,
                                   err_msg=key)
    with open(path, "rb") as f:
        assert pickle.load(f)["grasp_point_index"].tolist() == \
            got["grasp_point_index"].tolist()
    batch = tbg.collate_baseline_batch([got, got], 8,
                                       rng=np.random.RandomState(0))
    want_batch = jbg.collate_baseline_batch([got, got], 8,
                                            rng=np.random.RandomState(0))
    for key in want_batch:
        np.testing.assert_array_equal(batch[key], want_batch[key])


def test_scene_from_ply_matches_jax(tmp_path):
    from s4g_tpu_torch.datagen import mesh_tools as tmesh
    meshes = {"egg": tmesh.make_ellipsoid()}
    pose = {"egg": np.array([0.0, 0.0, 0.79, 1.0, 0, 0, 0])}
    path = str(tmp_path / "s.ply")
    tmesh.scene_ply(meshes, pose, path, samples_per_object=600,
                    table_half=(0.06, 0.06))   # dense: no lone table points
    want = jbg.scene_from_ply(path)
    got = tbg.scene_from_ply(path, device="cpu")
    np.testing.assert_array_equal(got["cloud"], want["cloud"])
    np.testing.assert_array_equal(got["label"], want["label"])
    to_cam = want["cloud"].mean(0) + [0, 0, 1.0] - want["cloud"]
    facing = np.abs(np.sum(got["normal"] * to_cam, axis=1)) > 1e-3
    # a point with fewer than 3 neighbours has no normal (rank <= 1)
    _, count = tgrad._radius_neighbors(t(got["cloud"]), 0.01, 30)
    defined = count.numpy() >= 3
    assert int((~defined).sum()) == 1 and facing.mean() > 0.95
    keep = facing & defined
    assert np.abs(got["normal"][keep] - want["normal"][keep]).max() <= 1e-5


def test_entry_points_need_a_gpu_without_device(monkeypatch):
    """device=None means CUDA: without a GPU every entry point raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cloud = np.zeros((4, 3), np.float32)
    with pytest.raises(RuntimeError, match="no GPU"):
        tev.generate_eval_view(cloud + [0, 0, 1.0], np.zeros(3), {})
    with pytest.raises(RuntimeError, match="no GPU"):
        tbd.baseline_grasp_data(np.eye(4), cloud, cloud)
    with pytest.raises(RuntimeError, match="no GPU"):
        trc.refine_contact_object({})


# -- MuJoCo stages -----------------------------------------------------------

def _mujoco():
    return pytest.importorskip("mujoco")


def test_table_env_and_directions_match_jax():
    _mujoco()
    from s4g_tpu.datagen import movability as jmov
    from s4g_tpu.datagen import scene_sim as jsim
    from s4g_tpu_torch.datagen import movability as tmov
    from s4g_tpu_torch.datagen import scene_sim as tsim
    out = {}
    for name, sim, mov in (("jax", jsim, jmov), ("port", tsim, tmov)):
        specs = [sim.ObjectSpec(name=f"box{i}", geom_type="box",
                                size="0.025 0.02 0.03") for i in range(2)]
        env = sim.TableEnv(specs, percentage=1.1, random_seed=0)
        poses = env.run()
        direction = mov.DirectionGenerator(env.xml, poses).run()
        out[name] = (env.xml, poses, direction)
    assert out["port"][0] == out["jax"][0]
    for key in out["jax"][1]:
        np.testing.assert_array_equal(out["port"][1][key],
                                      out["jax"][1][key])
    for key in out["jax"][2]:
        np.testing.assert_array_equal(np.asarray(out["port"][2][key]),
                                      np.asarray(out["jax"][2][key]))


def _box_mesh(half):
    from test_datagen_pipeline import _box_mesh as box
    return box(half)


def _box_specs(sim):
    return [sim.ObjectSpec(name="boxA", geom_type="box",
                           size="0.028 0.028 0.028"),
            sim.ObjectSpec(name="boxB", geom_type="box",
                           size="0.022 0.022 0.022")]


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.mark.slow
def test_generate_end_to_end_on_the_port(tmp_path, monkeypatch):
    """The whole factory (`generate_end_to_end`: object grading and its
    cache, the MuJoCo drop, render, view labels, movability, merge) on the
    port against the JAX package's on the same meshes, specs and seed, the
    port fed JAX's normals and frames, each run twice (the second reads
    the object cache the first wrote): object records equal bar cells near
    a box face (counted), drop poses and direction tables exact, merged
    records equal (valid frames and antipodal scores within 1e-6); and the
    port's records feed its trainer's dataset."""
    _mujoco()
    from s4g_tpu.datagen import generate as jgen
    from s4g_tpu.datagen import scene_sim as jsim
    from s4g_tpu_torch.datagen import generate as tgen
    from s4g_tpu_torch.datagen import scene_sim as tsim
    from s4g_tpu_torch.train.dataset import SceneGraspDataset
    from test_torch_port_datagen import grading_faces, search_cell_transforms
    meshes = {"boxA": _box_mesh(0.028), "boxB": _box_mesh(0.022)}
    _inject_jax_frames(monkeypatch, tgen)
    runs = {}
    for name, gen, sim, kw in (("jax", jgen, jsim, {}),
                               ("port", tgen, tsim, {"device": "cpu"})):
        out_dir = str(tmp_path / name)
        runs[name] = [gen.generate_end_to_end(
            meshes, _box_specs(sim), out_dir, scene_id=scene, num_views=2,
            percentage=1.1, seed=3 + scene, label_capacity=8192,
            render_wh=(320, 240), **kw) for scene in (0, 1)]
    for scene, (want_paths, got_paths) in enumerate(zip(runs["jax"],
                                                         runs["port"])):
        assert len(got_paths) == len(want_paths) == 2
        npy = f"{scene}.npy"
        want_pose = np.load(str(tmp_path / "jax" / npy), allow_pickle=True)[()]
        got_pose = np.load(str(tmp_path / "port" / npy), allow_pickle=True)[()]
        assert set(got_pose) == set(want_pose)
        for key in want_pose:
            np.testing.assert_array_equal(got_pose[key], want_pose[key])
        for gp, wp in zip(got_paths, want_paths):
            got, want = _load(gp), _load(wp)
            assert set(got) == set(want) and len(want["valid_index"]) > 0
            for key in want:
                if key in ("valid_frame", "antipodal_score"):
                    np.testing.assert_allclose(got[key], want[key], rtol=0,
                                               atol=1e-6, err_msg=key)
                else:
                    np.testing.assert_array_equal(got[key], want[key],
                                                  err_msg=key)
    differ = 0
    for n in meshes:
        obj = os.path.join("single_object_data", f"{n}.p")
        want, got = _load(tmp_path / "jax" / obj), _load(tmp_path / "port" / obj)
        assert set(got) == set(want)
        for key in ("cloud", "normal", "frame", "inv_frame"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        for kind in ("", "inv_"):
            near = near_cells(search_cell_transforms(
                want["cloud"], want[kind + "frame"]), want["cloud"],
                grading_faces(), scale=0.2)
            differ += assert_cells_equal(got[kind + "search_score"],
                                         want[kind + "search_score"], near,
                                         f"{n} {kind}search_score")
            far = ~near.reshape(len(want["cloud"]), -1)
            diff = np.abs(got[kind + "antipodal_score"]
                          - want[kind + "antipodal_score"])
            assert diff.reshape(len(far), -1)[far].max() <= 1e-6
    assert differ == 0

    ds = SceneGraspDataset(os.path.dirname(runs["port"][0][0]),
                           num_points=256, score_classes=3, batch_size=2,
                           num_frame_points=32, seed=0)
    batch = next(iter(ds))
    assert batch["scene_points"].shape == (2, 3, 256)


@pytest.mark.slow
def test_generate_scenes_parallel_matches_resumed_sequential(tmp_path):
    """workers=2 (spawned, on the caller's device) gives the labels of a
    resumed sequential run, byte for byte."""
    _mujoco()
    import shutil
    from s4g_tpu_torch.datagen.generate import generate_scenes
    from s4g_tpu_torch.datagen.scene_sim import ObjectSpec
    meshes = {"boxA": _box_mesh(0.028), "boxB": _box_mesh(0.022)}
    specs = [[ObjectSpec(name="boxA", geom_type="box",
                         size="0.028 0.028 0.028")],
             [ObjectSpec(name="boxB", geom_type="box",
                         size="0.022 0.022 0.022")]]
    kwargs = dict(num_views=1, percentage=1.1, base_seed=3,
                  label_capacity=4096, render_wh=(320, 240), device="cpu")
    seq_dir, par_dir = str(tmp_path / "seq"), str(tmp_path / "par")
    generate_scenes(meshes, specs, seq_dir, workers=1, **kwargs)
    seq = generate_scenes(meshes, specs, seq_dir, workers=1, **kwargs)
    shutil.copytree(os.path.join(seq_dir, "single_object_data"),
                    os.path.join(par_dir, "single_object_data"))
    par = generate_scenes(meshes, specs, par_dir, workers=2, **kwargs)
    assert [len(p) for p in seq] == [len(p) for p in par]
    for s_paths, p_paths in zip(seq, par):
        for sp, pp in zip(s_paths, p_paths):
            with open(sp, "rb") as f:
                a = pickle.load(f)
            with open(pp, "rb") as f:
                b = pickle.load(f)
            for key in ("point_cloud", "search_score", "valid_index"):
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)

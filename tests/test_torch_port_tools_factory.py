"""The label factory's tools in the port (s4g_tpu_torch.tools:
train_at_scale, detect_qa, demo_full_system, datagen_mesh_qa,
parity_at_speed) and the measurement tools (measure_fps_sharded,
trace_diff, r3_summarize) on the CPU, against the JAX tools where the two
compute the same thing on the same numpy inputs: the procedural catalog
(names, vertices, STL bytes) and the QA scene's draw exactly, the QA stage
by stage (the MuJoCo pose dict and the rendered view exactly, the
preprocessed cloud exactly, the summary from the same sample indices and
weights: counts exact, floats within 1e-5), parity's `_run_config` within
1e-5 and `_divergence_metrics` exactly, trace_diff's and r3_summarize's
output line for line.  The tools' own runs use `--device cpu`, the
tools' module constants (QA_CAPACITY, QA_WH, parity's CFG_FILE and REPS)
lowered, and object caches graded at a strided frame budget where the tool
would grade (`grade_object(frame_stride=64)`: every point still in the
cloud); the whole factory with full grading runs in the one `slow` test."""

import argparse
import contextlib
import io
import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from s4g_tpu.configs.config import load_cfg_from_dict as j_cfg
from s4g_tpu.models import build_model as j_build
from s4g_tpu_torch.configs.config import load_cfg_from_dict as t_cfg
from s4g_tpu_torch.datagen.generate import grade_object
from s4g_tpu_torch.tools import (datagen_mesh_qa, demo_full_system,
                                 detect_qa, measure_fps_sharded,
                                 parity_at_speed, r3_summarize, trace_diff,
                                 train_at_scale)
from s4g_tpu_torch.utils.checkpoint import Checkpointer, model_state_dict
from s4g_tpu_torch.utils.weights import state_dict_from_flax

from outlier_boundary import outlier_flips
from test_torch_port_model import _perturb
from test_torch_port_train import write_scenes
from tools import parity_at_speed as j_parity
from tools import r3_summarize as j_r3
from tools import trace_diff as j_trace_diff
from tools import train_at_scale as j_tas

CPU = ["--device", "cpu"]
QA_WH = (160, 120)
QA_CAPACITY = 16384
TINY_PN2 = {
    "NUM_INPUT": 512,
    "NUM_CENTROIDS": (128, 32),
    "RADIUS": (0.02, 0.08),
    "NUM_NEIGHBOURS": (16, 16),
    "SA_CHANNELS": ((16, 32), (32, 64)),
    "FP_CHANNELS": ((32, 32), (32, 32)),
    "NUM_FP_NEIGHBOURS": (3, 3),
    "SEG_CHANNELS": (32,),
}
TINY = {"MODEL": {"TYPE": "PN2_CLS", "COMPUTE_DTYPE": "float32",
                  "PN2": TINY_PN2},
        "DATA": {"SCORE_CLASSES": 3}}


def _jax_variables(n: int, seed: int = 0):
    """The tiny JAX net and its initial variables with non-trivial
    BatchNorm statistics and affines (numpy leaves)."""
    jnet, _, _ = j_build(j_cfg(TINY))
    variables = jnet.init(jax.random.key(seed),
                          {"scene_points": jnp.zeros((1, 3, n))},
                          train=False)
    return jnet, _perturb(jax.tree.map(np.asarray, dict(variables)),
                          np.random.RandomState(seed + 1))


def _spread_scores(jnet, variables, pts, gain=10.0):
    """Score logits centred per class over `pts` and scaled by `gain`: at
    init the expected scores of every point lie within ~1e-3 of one value
    (near-ties everywhere); after it the top 1,024 spread over ~4e-3."""
    logits = np.asarray(jnet.apply(variables, {"scene_points": pts},
                                   train=False)["score"][0])
    head = variables["params"]["head_seg"]["logit"]
    head["kernel"] = (head["kernel"] * gain).astype(np.float32)
    head["bias"] = ((head["bias"] - logits.mean(1)) * gain).astype(
        np.float32)


def _strided_grades(out_dir, meshes, names):
    """Seed `out_dir`'s object cache with strided gradings (see the module
    docstring) of `names`."""
    obj_dir = os.path.join(out_dir, "single_object_data")
    os.makedirs(obj_dir, exist_ok=True)
    for i, name in enumerate(names):
        with open(os.path.join(obj_dir, f"{name}.p"), "wb") as f:
            pickle.dump(grade_object(*meshes[name], frame_stride=64,
                                     rng=np.random.RandomState(i),
                                     device="cpu"), f)


def _box_obj(path):
    """A synthetic OBJ mesh (a 6 x 4 x 3 cm box) standing in for a real
    asset."""
    verts, tris = train_at_scale.box_mesh(0.03, 0.02, 0.015)
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for t in tris + 1:
            f.write(f"f {t[0]} {t[1]} {t[2]}\n")
    return str(path)


# -- the procedural catalog and the QA draw --------------------------------------

@pytest.fixture(scope="module")
def catalogs(tmp_path_factory):
    root = tmp_path_factory.mktemp("catalog")
    return ((root / "port",) + train_at_scale.build_procedural_catalog(
                str(root / "port")),
            (root / "jax",) + j_tas.build_procedural_catalog(
                str(root / "jax")))


def test_procedural_catalog_matches_jax(catalogs):
    (t_dir, t_meshes, t_specs), (j_dir, j_meshes, j_specs) = catalogs
    assert list(t_meshes) == list(j_meshes) and len(t_meshes) == 33
    for name in j_meshes:
        np.testing.assert_array_equal(t_meshes[name][0], j_meshes[name][0])
        np.testing.assert_array_equal(t_meshes[name][1], j_meshes[name][1])
        assert t_specs[name].geom_type == j_specs[name].geom_type == "mesh"
    assert sorted(os.listdir(t_dir / "assets")) == \
        sorted(os.listdir(j_dir / "assets"))
    for f in os.listdir(j_dir / "assets"):
        assert (t_dir / "assets" / f).read_bytes() == \
            (j_dir / "assets" / f).read_bytes(), f
    np.testing.assert_array_equal(train_at_scale.box_mesh(0.1, 0.2, 0.3)[0],
                                  j_tas.box_mesh(0.1, 0.2, 0.3)[0])


@pytest.mark.parametrize("seed", [777, 3])
def test_qa_draw_matches_jax(catalogs, seed):
    """The JAX tools' per-scene draw (train_at_scale's specs_of,
    detect_qa's and parity_at_speed's copies of it)."""
    (_, _, t_specs), (_, j_meshes, j_specs) = catalogs
    names = sorted(j_meshes)
    r = np.random.RandomState(10_000 + seed)
    k = int(r.randint(4, 7))
    want = [names[i] for i in r.choice(len(names), size=k, replace=False)]
    assert [s.name for s in train_at_scale.draw_specs(t_specs, seed)] \
        == want


# -- run_detect_qa, stage by stage ------------------------------------------------

@pytest.fixture
def small_qa(monkeypatch):
    monkeypatch.setattr(train_at_scale, "QA_WH", QA_WH)
    monkeypatch.setattr(train_at_scale, "QA_CAPACITY", QA_CAPACITY)


def test_run_detect_qa_matches_jax(catalogs, small_qa, monkeypatch):
    """JAX's run_detect_qa with its render size and capacity lowered to
    the port's test constants (its render_scene_views and preprocess_cloud
    wrapped: the wrappers record the pose dict, the view and the sample
    indices its key draws), and the port's fed those indices and the same
    weights."""
    import s4g_tpu.datagen.render as j_render
    import s4g_tpu.pipeline.preprocessing as j_pre
    import s4g_tpu_torch.datagen.render as t_render
    import s4g_tpu_torch.pipeline.preprocessing as t_pre

    (_, t_meshes, t_specs), (_, j_meshes, j_specs) = catalogs
    n = TINY_PN2["NUM_INPUT"]
    seen, t_seen = {}, {}

    def recorded(real, record, size):
        def render(meshes, pose_dict, **kw):
            if size:
                kw.update(width=QA_WH[0], height=QA_WH[1])
            record["poses"] = pose_dict
            record["view"] = real(meshes, pose_dict, **kw)[0]
            return [record["view"]]
        return render

    real_pre = j_pre.preprocess_cloud

    def pre(points, key, num_points=25600, capacity=65536, **kw):
        res = real_pre(points, key, num_points=num_points,
                       capacity=QA_CAPACITY, **kw)
        seen["idx"] = np.array(j_pre.random_sample_fixed(
            key, res.raw_valid, num_points))
        seen["pre"] = jax.tree.map(np.asarray, res)
        return res

    monkeypatch.setattr(j_render, "render_scene_views",
                        recorded(j_render.render_scene_views, seen, True))
    monkeypatch.setattr(j_pre, "preprocess_cloud", pre)
    jnet, variables = _jax_variables(n)
    t_qa_specs = train_at_scale.draw_specs(t_specs, 777)
    want = j_tas.run_detect_qa(variables, j_cfg(TINY), j_meshes,
                               [j_specs[s.name] for s in t_qa_specs], n)

    real_tpre = t_pre.preprocess_cloud

    def t_pre_injected(points, **kw):
        kw.pop("generator")
        t_seen["pre"] = real_tpre(points, sample_idx=torch.from_numpy(
            seen["idx"]), **kw)
        return t_seen["pre"]

    monkeypatch.setattr(t_render, "render_scene_views",
                        recorded(t_render.render_scene_views, t_seen, False))
    monkeypatch.setattr(t_pre, "preprocess_cloud", t_pre_injected)
    got = train_at_scale.run_detect_qa(
        state_dict_from_flax(variables), t_cfg(TINY), t_meshes, t_qa_specs,
        n, device="cpu")

    assert list(t_seen["poses"]) == list(seen["poses"])
    for name in seen["poses"]:
        np.testing.assert_array_equal(t_seen["poses"][name],
                                      seen["poses"][name])
    for a, b in zip(t_seen["view"], seen["view"]):
        np.testing.assert_array_equal(a, b)
    assert seen["view"][1].shape[0] > QA_WH[0] * QA_WH[1] // 4
    jp, tp = seen["pre"], t_seen["pre"]
    np.testing.assert_array_equal(tp.raw_points.numpy(), jp.raw_points)
    flips = outlier_flips(jp.raw_points, jp.raw_points[:, 0] < 1e30,
                          tp.raw_valid.numpy(), jp.raw_valid)
    assert flips <= 1e-3 * len(jp.raw_valid)
    np.testing.assert_array_equal(tp.points.numpy(), jp.points)
    assert set(got) == set(want)
    for k in ("num_valid_grasps", "num_score_valid", "num_points"):
        assert got[k] == want[k], k
    for k in ("top_score", "frac_heights_in_table_band",
              "heights_min_med_max"):
        if want[k] is None:
            assert got[k] is None, k
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5)
    assert want["num_score_valid"] > 0


# -- parity_at_speed ---------------------------------------------------------------

def _run_result(rng, k=80, c=3, n=300):
    """A `_run_config` result of random poses on shared anchor points."""
    q, _ = np.linalg.qr(rng.randn(k, 3, 3))
    poses = np.tile(np.eye(4, dtype=np.float32), (k, 1, 1))
    poses[:, :3, :3] = q
    poses[:, :3, 3] = rng.rand(k, 3) * 0.05
    return {"score": rng.randn(c, n).astype(np.float32), "poses": poses,
            "scores": rng.rand(k).astype(np.float32),
            "valid": rng.rand(k) > 0.2, "cand_point": poses[:, :3, 3]}


def test_divergence_metrics_match_jax():
    rng = np.random.RandomState(0)
    a = _run_result(rng)
    b = _run_result(rng)
    b["poses"][:30] = a["poses"][:30]       # some shared anchors and grasps
    b["cand_point"] = b["poses"][:, :3, 3]
    b["scores"][:30] = a["scores"][:30]
    for x, y in ((a, b), (a, a), (b, a)):
        got = parity_at_speed._divergence_metrics(x, y)
        assert got == j_parity._divergence_metrics(x, y)
    assert 0 < got["top50_anchor_overlap"] < 1


def test_run_config_matches_jax():
    n = 2048
    jnet, variables = _jax_variables(n)
    pts = (np.random.RandomState(4).rand(1, 3, n)
           * [[[0.6], [0.4], [0.3]]]).astype(np.float32)
    _spread_scores(jnet, variables, jnp.asarray(pts))
    want = j_parity._run_config(jnet, variables, jnp.asarray(pts))
    from s4g_tpu_torch.models import build_model
    got = parity_at_speed._run_config(build_model(t_cfg(TINY)),
                                      state_dict_from_flax(variables),
                                      torch.from_numpy(pts))
    assert set(got) == set(want)
    np.testing.assert_allclose(got["score"], want["score"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(got["valid"], want["valid"])
    assert np.ptp(want["scores"]) > 1e-3 and 0 < want["valid"].sum()
    # candidates as (pose, score) rows: the same set, each within 1e-5,
    # among the ranks clear of the top-K cut by more than the tolerance
    # (near-equal scores may take their ranks in either order)
    clear = want["scores"] > want["scores"][-1] + 1e-5
    rows = [np.concatenate([r["poses"].reshape(-1, 16),
                            r["scores"][:, None]], 1) for r in (got, want)]
    free = list(range(len(rows[1])))
    for row in rows[0][clear]:
        dist = np.abs(rows[1][free] - row).max(1)
        k = int(np.argmin(dist))
        assert dist[k] <= 1e-5, dist[k]
        free.pop(k)


@pytest.fixture(scope="module")
def parity_files(tmp_path_factory):
    """The tiny config's YAML and a seeded 30,000-point scene pickle."""
    root = tmp_path_factory.mktemp("parity")
    cfg = root / "tiny.yaml"
    cfg.write_text(yaml.safe_dump(
        {**TINY, "MODEL": {**TINY["MODEL"], "PN2": {
            k: (str(v) if isinstance(v, tuple) else v)
            for k, v in TINY_PN2.items()}}}))
    scene = root / "scene.p"
    rng = np.random.RandomState(0)
    with open(scene, "wb") as f:
        pickle.dump({"point_cloud": (rng.rand(3, 30000) * [[0.6], [0.4],
                                                           [0.3]]
                                     ).astype(np.float32)}, f)
    return {"cfg": str(cfg), "scene": str(scene)}


_DIVERGENCE_KEYS = {"score_expectation_max_abs_delta",
                    "score_expectation_frac_gt_0p05", "top50_anchor_overlap",
                    "top50_grasp_overlap_1cm_10deg",
                    "matched_pose_t_delta_mm_max",
                    "matched_pose_R_delta_deg_max", "n_valid_parity",
                    "n_valid_deploy", "mode", "weights", "scene", "device"}


@pytest.mark.parametrize("mode,lines", [("compare", 1), ("selfnoise", 1),
                                        ("sortnoise", 1), ("ablate", 3),
                                        ("time-parity", 1)])
def test_parity_modes_print_their_keys(parity_files, mode, lines, capsys,
                                       monkeypatch):
    monkeypatch.setattr(parity_at_speed, "CFG_FILE", parity_files["cfg"])
    monkeypatch.setattr(parity_at_speed, "REPS", 2)
    got = parity_at_speed.main([mode, "--scene", parity_files["scene"],
                                *CPU])
    printed = [json.loads(x) for x in
               capsys.readouterr().out.strip().splitlines()]
    assert printed == got and len(got) == lines
    if mode == "time-parity":
        assert set(got[0]) == {"config", "e2e_ms_per_scene",
                               "scenes_per_sec", "device"}
        assert got[0]["e2e_ms_per_scene"] > 0
    else:
        assert all(set(r) == _DIVERGENCE_KEYS for r in got)
        assert all(r["device"] == "cpu" and r["scene"] == parity_files[
            "scene"] for r in got)
    if mode == "compare":       # the tiny config is parity-like: same run
        assert got[0]["top50_anchor_overlap"] == 1.0


# -- the at-scale run, its QA weights, detect_qa and parity's qa: scene ------------

@pytest.fixture(scope="module")
def scale_run(tmp_path_factory):
    """train_at_scale --skip-datagen on synthetic training pickles (four
    views, two held out), the procedural object set, 512 points, b = 2,
    two steps, a steady-state loop of 2; run_detect_qa wrapped to record
    the weights it gets."""
    out = tmp_path_factory.mktemp("scale")
    write_scenes(str(out / "merged_data"), 4, n=3000, num_frames=100)
    write_scenes(str(out / "val" / "merged_data"), 2, n=3000, num_frames=100)
    from s4g_tpu_torch.train.trainer import Trainer
    qa_weights, trainers = [], []
    real, real_fit = train_at_scale.run_detect_qa, Trainer.fit

    def recording(weights, *args, **kw):
        qa_weights.append(weights)
        return real(weights, *args, **kw)

    def fit(self, *args, **kw):
        trainers.append(self)
        return real_fit(self, *args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_at_scale, "QA_WH", QA_WH)
        mp.setattr(train_at_scale, "QA_CAPACITY", QA_CAPACITY)
        mp.setattr(train_at_scale, "run_detect_qa", recording)
        mp.setattr(train_at_scale, "STEADY_REPS", 2)
        mp.setattr(Trainer, "fit", fit)
        summary = train_at_scale.main([
            "--out", str(out), "--skip-datagen", "--object-set",
            "procedural", "--steps", "2", "--batch", "2", "--num-points",
            "512", *CPU])
    return {"out": str(out), "summary": summary, "qa_weights": qa_weights,
            "trainer": trainers[0]}


def test_train_at_scale_summary(scale_run):
    s = scale_run["summary"]
    assert set(s) == {"steps", "steady_state_s_per_step", "final_scalars",
                      "val_metrics", "detect_qa", "wall_s", "batch",
                      "num_points", "device"}
    assert s["steps"] == 2 and s["batch"] == 2 and s["device"] == "cpu"
    assert s["val_metrics"] and s["steady_state_s_per_step"] > 0
    assert s["detect_qa"]["num_points"] == 512
    with open(os.path.join(scale_run["out"], "scale_run.json")) as f:
        assert json.load(f) == s


def test_train_at_scale_qa_runs_on_the_fitted_weights(scale_run):
    """The QA's weights are the fitted ones (the checkpoint fit saved at
    its last step), not the model after the steady-state loop, which
    trains it further."""
    (weights,) = scale_run["qa_weights"]
    saved = model_state_dict(Checkpointer(
        os.path.join(scale_run["out"], "train_out")).load(None))
    assert set(weights) == set(saved)
    for k, v in saved.items():
        assert torch.equal(weights[k], v), k
    # the steady-state loop trained the model on in place: the copy matters
    after = scale_run["trainer"].net.state_dict()
    assert scale_run["trainer"].step == 2 + 1 + 2
    assert any(not torch.equal(after[k], v) for k, v in weights.items())


def test_detect_qa_restores_the_checkpoint(scale_run, small_qa, tmp_path):
    got = detect_qa.main(["--out", scale_run["out"], "--num-points", "512",
                          "--json-out", str(tmp_path / "qa.json"), *CPU])
    assert got.pop("checkpoint_step") == 2
    assert got == scale_run["summary"]["detect_qa"]
    with open(tmp_path / "qa.json") as f:
        assert json.load(f) == {**got, "checkpoint_step": 2}


def test_parity_quality_on_the_qa_scene(scale_run, parity_files, small_qa,
                                        capsys, monkeypatch):
    """quality on qa:<the run's directory> with its checkpoint: the QA
    scene's objects graded into the run's cache first."""
    out = scale_run["out"]
    meshes, specs = train_at_scale.build_procedural_catalog(out)
    poses, _ = train_at_scale.qa_scene(meshes,
                                       train_at_scale.draw_specs(specs, 777))
    _strided_grades(out, meshes, list(poses))
    monkeypatch.setattr(parity_at_speed, "CFG_FILE", parity_files["cfg"])
    (rec,) = parity_at_speed.main(["quality", "--scene", f"qa:{out}", *CPU])
    assert json.loads(capsys.readouterr().out.strip()) == rec
    for tag in ("parity", "deploy"):
        assert set(rec[tag]) == {"num_scored", "collision_rate",
                                 "multi_object_rate", "frac_good",
                                 "antipodal_mean", "antipodal_mean_good",
                                 "antipodal_max"}
    with pytest.raises(SystemExit, match="qa:"):
        parity_at_speed.main(["quality", "--scene", parity_files["scene"],
                              *CPU])


def test_train_at_scale_mixed_needs_a_real_mesh(tmp_path, capsys):
    with pytest.raises(SystemExit):
        train_at_scale.main(["--out", str(tmp_path), "--object-set", "mixed",
                             *CPU])
    assert "--real-mesh" in capsys.readouterr().err


def test_real_mesh_catalog(tmp_path):
    """build_real_mesh_catalog on a synthetic OBJ: three scale variants
    named after the file, each graded once and cached in every root."""
    obj = _box_obj(tmp_path / "gadget.obj")
    out, extra = tmp_path / "out", tmp_path / "out" / "val"
    meshes, specs = train_at_scale.build_real_mesh_catalog(
        str(out), obj, frame_stride=256, extra_cache_dirs=[str(extra)],
        device="cpu")
    assert sorted(meshes) == ["gadget#0", "gadget#1", "gadget#2"]
    for name in meshes:
        a = pickle.load(open(out / "single_object_data" / f"{name}.p", "rb"))
        b = pickle.load(open(extra / "single_object_data" / f"{name}.p",
                             "rb"))
        np.testing.assert_array_equal(a["cloud"], b["cloud"])
        assert specs[name].mesh_files[0].endswith(
            name.replace("#", "_") + ".stl")


# -- datagen_mesh_qa -------------------------------------------------------------

def test_datagen_mesh_qa_procedural_assets(tmp_path):
    """--procedural's scene: three generated meshes written as STL and
    read back, four instances (two boxes sharing one grade)."""
    args = argparse.Namespace(procedural=True, mesh=None)
    meshes, specs, groups = datagen_mesh_qa._scene_assets(
        args, str(tmp_path))
    assert [s.name for s in specs] == ["ico", "boxm", "cyl", "boxm2"]
    assert groups == {"ico": ["ico"], "boxm": ["boxm", "boxm2"],
                      "cyl": ["cyl"]}
    assert specs[3].mesh_files == specs[1].mesh_files
    np.testing.assert_array_equal(meshes["boxm2"][0], meshes["boxm"][0])
    assert sorted(os.listdir(tmp_path / "meshes")) == [
        "boxm.stl", "cyl.stl", "ico.stl"]


def test_datagen_mesh_qa_on_a_mesh_file(tmp_path):
    """Two instances of a synthetic OBJ mesh through the factory (one
    640 x 480 view), the grade seeded."""
    from s4g_tpu_torch.datagen import mesh_tools as mt
    out = str(tmp_path / "out")
    obj = _box_obj(tmp_path / "gadget.obj")
    mesh = mt.load_obj(obj)
    _strided_grades(out, {"cam0": mesh, "cam1": mesh}, ["cam0", "cam1"])
    stats = datagen_mesh_qa.main(["--mesh", obj, "--out", out, "--views",
                                  "1", *CPU])
    assert len(stats) == 1 and stats[0]["num_labeled_grasp_points"] > 0
    assert {"search_score", "direction", "point_cloud"} <= set(
        stats[0]["keys"])
    with pytest.raises(SystemExit):           # a mode is required
        datagen_mesh_qa.main(["--out", out, *CPU])


# -- the measurement tools ---------------------------------------------------------

def _capture(fn, argv=None, sys_argv=None):
    """stdout of fn(argv), or of fn() under sys.argv = sys_argv."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if sys_argv is None:
            fn(argv)
        else:
            old, sys.argv = sys.argv, sys_argv
            try:
                fn()
            finally:
                sys.argv = old
    return buf.getvalue()


def test_trace_diff_matches_jax(tmp_path):
    a = {"batch": 1, "leaf_ms_per_exec": 10.0, "ms_per_exec": {
        "fusion.12": 2.0, "fusion.7": 1.5, "custom-call.3": 4.0,
        "%dynamic-slice.44": 0.5, "copy_start.2": 0.25}}
    b = {"batch": 2, "leaf_ms_per_exec": 22.0, "ms_per_exec": {
        "fusion.99": 5.0, "custom-call.1": 9.0, "%dynamic-slice.2": 1.5,
        "transpose.8": 2.0}}
    for name, table in (("a", a), ("b", b)):
        with open(tmp_path / f"{name}.json", "w") as f:
            json.dump(table, f)
    args = [str(tmp_path / "a.json"), str(tmp_path / "b.json")]
    got = _capture(trace_diff.main, args)
    assert got == _capture(j_trace_diff.main, sys_argv=["trace_diff"] + args)
    assert "fusion" in got and "delta" in got


def test_trace_diff_keeps_template_instances_apart():
    """CUDA kernel names: the template arguments tell a kernel's instances
    apart; the digits of the name itself are variants of one class."""
    table = {"void (anonymous namespace)::mlp_wg_kernel<64, true>(float)": 1,
             "void (anonymous namespace)::mlp_wg_kernel<128, true>(float)": 2,
             "sm90_xmma_gemm_tilesize128x128x32_kernel": 3,
             "sm90_xmma_gemm_tilesize64x128x32_kernel": 4,
             "fps_cluster_kernel": 5, "fusion.3": 6, "fusion.4": 7}
    classes = trace_diff._classes(table)
    assert len(classes) == 5
    assert classes["sm_xmma_gemm_tilesizexx_kernel"] == 7
    assert classes["fusion"] == 13


def test_r3_summarize_matches_jax(tmp_path):
    logs = {
        "measure_batch_b2.log": "noise\n" + json.dumps({
            "batch": 2, "fwd_ms_per_scene": 7.4, "e2e_ms_per_scene": 90.1,
            "scenes_per_sec": 11.1, "device": "cpu"}) + "\n",
        "parity_compare.log": json.dumps({"top50_anchor_overlap": 0.5,
                                          "n_valid_parity": 3,
                                          "mode": "parity vs deploy"}) + "\n",
        "broken.log": "{not json}\n",
        "skip.txt": "{}\n",
    }
    for name, text in logs.items():
        (tmp_path / name).write_text(text)
    got = _capture(r3_summarize.main, [str(tmp_path)])
    assert got == _capture(j_r3.main, sys_argv=["r3", str(tmp_path)])
    (tmp_path / "trace_b1.log").write_text(
        "x\n=== device kernel time: 12.345 ms/exec (8 reps) ===\n")
    rows = r3_summarize.main([str(tmp_path)])
    assert rows["trace_b1"] == {"device_ms_per_exec": 12.345}
    assert rows["broken"] is None and "skip" not in rows


def test_measure_fps_sharded_on_the_cpu(tmp_path, capsys):
    got = measure_fps_sharded.main(["2048", "256", "128", "--trace-dir",
                                    str(tmp_path), *CPU])
    assert got["device"] == "cpu" and got["kernels"] == []
    assert got["device_ms_per_exec"] is None
    assert "N=2048 M=256 G=128: no device time" in capsys.readouterr().out


# -- the whole factory, graded in full (slow) ------------------------------------

@pytest.mark.slow
def test_factory_tools_end_to_end(tmp_path, small_qa):
    """demo_full_system whole (three boxes graded in full, one scene, one
    epoch) and train_at_scale with its datagen (the box set, one training
    and one held-out scene of one view each, both graded in full): the
    MuJoCo drop plus ~22 s of grading an object on the CPU."""
    got = demo_full_system.main(["--out", str(tmp_path / "demo"),
                                 "--scenes", "1", "--epochs", "1",
                                 "--num-points", "2048", *CPU])
    assert got["views"] == 2 and got["steps"] == 1
    summary = train_at_scale.main([
        "--out", str(tmp_path / "scale"), "--scenes", "2", "--val-scenes",
        "2", "--views", "1", "--steps", "1", "--batch", "2", "--num-points",
        "1024", *CPU])
    assert summary["steps"] == 1 and summary["val_metrics"]
    assert os.path.exists(tmp_path / "scale" / "dataset_stats.json")

"""The port's detector pipeline (s4g_tpu_torch.pipeline) against the JAX
package: preprocessing and post-processing stages, and `detect`'s and
`detect_batch`'s stages end to end on the tiny-model recipe of
tests/test_pipeline.py with the same weights and the same random draws (the
JAX detector's sample indices and importance uniforms, fed to the port's
stage functions)."""

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from s4g_tpu.models import nn_layers as jnn
from s4g_tpu.pipeline import postprocessing as jpost
from s4g_tpu.pipeline import preprocessing as jpre
from s4g_tpu.pipeline.detector import GraspDetector as JaxDetector
from s4g_tpu.utils import math_utils as jmath

from s4g_tpu_torch.ops import sa_fused as sf
from s4g_tpu_torch.pipeline import detector as tdet
from s4g_tpu_torch.pipeline import postprocessing as tpost
from s4g_tpu_torch.pipeline import preprocessing as tpre
from s4g_tpu_torch.utils import math_utils as tmath
from s4g_tpu_torch.utils.weights import state_dict_from_flax

TINY = {
    "MODEL": {"TYPE": "PN2_CLS", "COMPUTE_DTYPE": "float32", "PN2": {
        "NUM_INPUT": 512,
        "NUM_CENTROIDS": "(128, 32)",
        "RADIUS": "(0.02, 0.08)",
        "NUM_NEIGHBOURS": "(16, 16)",
        "SA_CHANNELS": "((16, 32), (32, 64))",
        "FP_CHANNELS": "((32, 32), (32, 32))",
        "NUM_FP_NEIGHBOURS": "(3, 3)",
        "SEG_CHANNELS": "(32,)",
    }},
    "DATA": {"SCORE_CLASSES": 3},
    "TEST": {"BATCH_SIZE": 1},
}
CAPACITY = 8192
CANDIDATES = 512      # 512 x 8192 = 2^22 pairs: the collision kernel route
# detect_batch's config: TINY with a sorted cloud and an SA1 that the fused
# stage (K3) takes at batch >= 2 (widths multiples of 128, K % 8 == 0).
TINY_FUSED = {**TINY, "MODEL": {**TINY["MODEL"], "PN2": {
    **TINY["MODEL"]["PN2"], "SA_CHANNELS": "((128, 128, 256), (32, 64))",
    "SORT_POINTS": True, "FPS_SHARDS": 128}}}


def _t(x):
    return torch.from_numpy(np.asarray(x))


def clutter_cloud(rng, num_objects=6, n_per_object=450):
    """Camera-frame clutter ~0.7 m away: a few dense 4 cm objects, far
    enough apart that many random grasps clear the collision check."""
    centers = np.column_stack([rng.uniform(-0.25, 0.25, (num_objects, 2)),
                               rng.uniform(0.65, 0.75, num_objects)])
    centers[:, 0] = np.linspace(-0.3, 0.3, num_objects)
    pts = [c + rng.uniform(-0.02, 0.02, (n_per_object, 3)) for c in centers]
    return np.concatenate(pts).astype(np.float32)


# -- preprocessing / post-processing stages --------------------------------------

def test_preprocessing_stages_match_jax():
    """Against the stages as the JAX detect program runs them (jitted, with
    a constant voxel size)."""
    rng = np.random.RandomState(0)
    pts = clutter_cloud(rng)[:, [1, 0, 2]] * [1, 1, -1]
    pts = np.concatenate([pts, np.full((700, 3), 1e6)]).astype(np.float32)
    cap = len(pts)
    want = jpre.preprocess_cloud(jnp.asarray(pts), jax.random.key(0), 256,
                                 0.005, 0.02, 32, cap)
    vox = tpre.voxel_downsample(_t(pts), torch.ones(cap, dtype=torch.bool),
                                0.005, cap)
    np.testing.assert_array_equal(vox.points.numpy(),
                                  np.asarray(want.raw_points))
    keep = tpre.radius_outlier_mask(vox.points, vox.valid, 0.02, 32)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(want.raw_valid))
    assert 0 < keep.sum() < vox.valid.sum()
    crop = (-0.2, 0.2, -0.2, 0.2, -1.0, 0.0)
    np.testing.assert_array_equal(
        tpre.workspace_crop_mask(_t(pts), crop).numpy(),
        np.asarray(jpre.workspace_crop_mask(jnp.asarray(pts), crop)))


def test_random_sample_fixed_is_a_valid_sample():
    gen = torch.Generator().manual_seed(0)
    valid = torch.zeros(100, dtype=torch.bool)
    valid[::3] = True                                   # 34 valid points
    idx = tpre.random_sample_fixed(valid, 20, gen)      # without replacement
    assert valid[idx.long()].all() and len(set(idx.tolist())) == 20
    idx = tpre.random_sample_fixed(valid, 50, gen)      # with replacement
    assert valid[idx.long()].all() and len(idx) == 50


def test_postprocessing_matches_jax():
    rng = np.random.RandomState(1)
    n, k = 300, 64
    points = rng.rand(3, n).astype(np.float32)
    score = rng.randn(3, n).astype(np.float32)
    score[:, 10] = score[:, 20]                         # a score tie
    frame_r = rng.randn(9, n).astype(np.float32)
    frame_r[3:6, 5] = 2.0 * frame_r[0:3, 5]             # degenerate y
    frame_t = rng.randn(4, n).astype(np.float32)
    want = jpost.post_process_predictions(
        jnp.asarray(points), jnp.asarray(score), jnp.asarray(frame_r),
        jnp.asarray(frame_t), 0.3, 0.0, num_candidates=k)
    got = tpost.post_process_predictions(_t(points), _t(score), _t(frame_r),
                                         _t(frame_t), 0.3, 0.0,
                                         num_candidates=k)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-6)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(want.poses),
                               atol=1e-5)

    key = jax.random.key(3)
    uniforms = jax.random.uniform(key, (7,))
    sel_j = jpost.importance_sample(key, want.scores, want.valid, 7)
    sel_t = tpost.importance_sample(got.scores, got.valid, _t(uniforms))
    np.testing.assert_array_equal(sel_t.numpy(), np.asarray(sel_j))

    rot = rng.randn(50, 3, 3).astype(np.float32)
    rot[0, :, 0] = 0.0                                  # zero x
    np.testing.assert_allclose(
        tmath.gram_schmidt_frames(_t(rot)).numpy(),
        np.asarray(jmath.gram_schmidt_frames(jnp.asarray(rot))), atol=1e-6)
    poses = np.asarray(want.poses)
    np.testing.assert_allclose(
        tmath.batch_transformation_inv(_t(poses)).numpy(),
        np.asarray(jmath.batch_transformation_inv(jnp.asarray(poses))),
        atol=1e-6)


# -- detect, stage by stage, against the JAX detector ------------------------------

def _pair_candidates(got, want, rtol=2e-6):
    """Candidate i of `got` -> its twin in `want`.  Candidates whose scores
    agree to within `rtol` may come out of the top-K in either order: the
    two frameworks' f32 sums and exp differ in the last bit, and the random
    tiny model scores many points within an ulp of each other."""
    perm, used = [], set()
    for i, s_i in enumerate(got["scores"]):
        near = [j for j in np.nonzero(np.abs(want["scores"] - s_i)
                                      <= rtol * abs(s_i))[0] if j not in used]
        assert near, f"candidate {i} (score {s_i}) has no twin"
        err = [np.abs(want["poses"][j] - got["poses"][i]).max() for j in near]
        perm.append(near[int(np.argmin(err))])
        used.add(perm[-1])
    return np.asarray(perm)


def test_detect_stages_match_jax_detector(tmp_path):
    cfg_file = tmp_path / "tiny.yaml"
    cfg_file.write_text(yaml.safe_dump(TINY))
    jdet = JaxDetector(model=str(cfg_file), output_dir=str(tmp_path),
                       cloud_capacity=CAPACITY, num_candidates=CANDIDATES)
    cloud = clutter_cloud(np.random.RandomState(2))
    padded, valid = jdet._pad_cloud(cloud)
    variables = jax.tree.map(np.asarray, jdet.variables)
    key = jax.random.key(123)
    num_selected, st, vt = 5, 0.0, -1e9
    want = jax.tree.map(np.asarray, jdet._detect_fn(
        variables, padded, valid, key, st, vt, num_selected, True))

    # The JAX detector's own draws, replayed from its key.
    k_sample, k_importance = jax.random.split(key)
    train = jnp.matmul(padded, jnp.asarray(jpost.REAL2TRAIN[:3, :3]).T)
    pre = jpre.preprocess_cloud(train, k_sample, num_points=512,
                                capacity=CAPACITY)
    sample_idx = jpre.random_sample_fixed(k_sample, pre.raw_valid, 512)
    uniforms = jax.random.uniform(k_importance, (num_selected,))

    tdetector = tdet.GraspDetector(
        model=str(cfg_file), device="cpu", output_dir=str(tmp_path),
        cloud_capacity=CAPACITY, num_candidates=CANDIDATES,
        state_dict=state_dict_from_flax(variables))
    cloud_t, valid_t = _t(padded), _t(valid)
    points = tdet.prep_one(cloud_t, valid_t, 512, sample_idx=_t(sample_idx))
    np.testing.assert_array_equal(points.numpy(), np.asarray(pre.points))
    preds = tdetector.net({"scene_points": points.t()[None].contiguous()})
    got = tdet.post_one(points, {k: v[0] for k, v in preds.items()}, cloud_t,
                        valid_t, _t(uniforms), st, vt, CANDIDATES)
    got = {k: v.numpy() for k, v in got.items()}

    perm = _pair_candidates(got, want)
    # Score-sorted, so position by position; XLA's exp and torch's differ
    # in the last bit, so a score may be one ulp off.
    np.testing.assert_array_max_ulp(got["scores"], want["scores"], maxulp=1)
    np.testing.assert_allclose(got["poses"], want["poses"][perm], atol=1e-4)
    np.testing.assert_array_equal(got["valid"], want["valid"][perm])
    np.testing.assert_array_equal(got["selected"], want["selected"])
    assert 0 < int(got["num_valid"]) < CANDIDATES     # collisions happen


def test_detect_batch_stages_match_jax_detector(tmp_path, monkeypatch):
    """detect_batch at b = 2 on the fused SA1 route (the JAX side pinned to
    it in interpret mode), stage by stage: prep on the JAX program's draws
    (exact), the model on the same points (K3 rounds hidden activations to
    bf16 after f32 sums taken in another order, so a rare rounding flips:
    bf16 tolerances), and post-processing on the JAX model's predictions
    against the JAX program's outputs, as `detect`'s test holds them."""
    monkeypatch.setattr(jnn, "ENV_SA1_FUSE", "interpret")
    cfg_file = tmp_path / "tiny_fused.yaml"
    cfg_file.write_text(yaml.safe_dump(TINY_FUSED))
    jdet = JaxDetector(model=str(cfg_file), output_dir=str(tmp_path),
                       cloud_capacity=CAPACITY, num_candidates=CANDIDATES)
    clouds = [clutter_cloud(np.random.RandomState(s)) for s in (2, 3)]
    padded, valid = (jnp.stack(a) for a in
                     zip(*(jdet._pad_cloud(c) for c in clouds)))
    variables = jax.tree.map(np.asarray, jdet.variables)
    keys = jax.random.split(jax.random.key(321), 2)
    num_selected, st, vt = 5, 0.0, -1e9
    want = jax.tree.map(np.asarray, jdet._detect_batch_fn(
        variables, padded, valid, keys, st, vt, num_selected, True))

    # The JAX program's own draws, replayed from its per-scene keys.
    ks = jax.vmap(jax.random.split)(keys)
    sample_idx, uniforms, want_points = [], [], []
    for i in range(2):
        train = jnp.matmul(padded[i], jnp.asarray(jpost.REAL2TRAIN[:3, :3]).T)
        pre = jpre.preprocess_cloud(train, ks[i, 0], num_points=512,
                                    capacity=CAPACITY)
        sample_idx.append(jpre.random_sample_fixed(ks[i, 0], pre.raw_valid,
                                                   512))
        uniforms.append(jax.random.uniform(ks[i, 1], (num_selected,)))
        want_points.append(np.asarray(pre.points))

    tdetector = tdet.GraspDetector(
        model=str(cfg_file), device="cpu", output_dir=str(tmp_path),
        cloud_capacity=CAPACITY, num_candidates=CANDIDATES,
        state_dict=state_dict_from_flax(variables))
    cloud_t, valid_t = _t(padded), _t(valid)
    points = tdet.prep_batch(cloud_t, valid_t, 512,
                             sample_idx=_t(np.stack(sample_idx)))
    np.testing.assert_array_equal(points.numpy(), np.stack(want_points))

    jpreds = jax.tree.map(np.asarray, jdet.net.apply(
        variables,
        {"scene_points": jnp.asarray(points.numpy()).swapaxes(1, 2)},
        train=False))
    fused = sf.sa1_fused_slab
    calls = []
    monkeypatch.setattr(sf, "sa1_fused_slab",
                        lambda *a, **kw: calls.append(1) or fused(*a, **kw))
    tpreds = tdetector.net({"scene_points": points.transpose(1, 2)
                            .contiguous()})
    assert calls == [1]
    for key, w in jpreds.items():
        g = tpreds[key].numpy()
        np.testing.assert_allclose(g, w, atol=5e-2, err_msg=key)
        assert float(np.abs(g - w).mean()) < 5e-3, key

    got = tdet.post_batch(points, {k: _t(v) for k, v in jpreds.items()},
                          cloud_t, valid_t, _t(np.stack(uniforms)), st, vt,
                          CANDIDATES)
    got = {k: v.numpy() for k, v in got.items()}
    for i in range(2):
        g = {k: v[i] for k, v in got.items()}
        w = {k: v[i] for k, v in want.items()}
        perm = _pair_candidates(g, w)
        # One ulp from exp, as in `detect`'s test, plus the last bits in
        # which the program's fused predictions and `net.apply`'s differ.
        np.testing.assert_array_max_ulp(g["scores"], w["scores"], maxulp=4)
        np.testing.assert_allclose(g["poses"], w["poses"][perm], atol=1e-4)
        np.testing.assert_array_equal(g["valid"], w["valid"][perm])
        np.testing.assert_array_equal(g["selected"], w["selected"])
        assert 0 < int(g["num_valid"]) < CANDIDATES


def test_detect_batch_runs_on_cpu_when_asked(tmp_path):
    cfg_file = tmp_path / "tiny_fused.yaml"
    cfg_file.write_text(yaml.safe_dump(TINY_FUSED))
    det = tdet.GraspDetector(model=str(cfg_file), device="cpu",
                             output_dir=str(tmp_path),
                             cloud_capacity=CAPACITY, num_candidates=64)
    clouds = [clutter_cloud(np.random.RandomState(4)),
              clutter_cloud(np.random.RandomState(6), num_objects=4)]
    results = det.detect_batch(clouds, score_threshold=0.0,
                               verticalness_threshold=-1e9)
    assert len(results) == 2 and len(det.last_num_valid) == 2
    for (poses, scores), num_valid in zip(results, det.last_num_valid):
        assert poses.shape[1:] == (4, 4) and len(poses) == len(scores)
        assert len(poses) == min(num_valid, 5) > 0
        r = poses[:, :3, :3]
        np.testing.assert_allclose(np.einsum("nij,nkj->nik", r, r),
                                   np.broadcast_to(np.eye(3), r.shape),
                                   atol=1e-5)
    assert set(det.timings) == {"pad_ms", "prep_ms", "model_ms", "post_ms",
                                "total_ms"}
    with pytest.raises(ValueError, match="shape"):
        det.detect_batch([np.zeros((10, 4), np.float32)])


def test_detect_runs_on_cpu_when_asked(tmp_path):
    cfg_file = tmp_path / "tiny.yaml"
    cfg_file.write_text(yaml.safe_dump(TINY))
    det = tdet.GraspDetector(model=str(cfg_file), device="cpu",
                             output_dir=str(tmp_path),
                             cloud_capacity=CAPACITY, num_candidates=64)
    poses, scores = det.detect(clutter_cloud(np.random.RandomState(4)),
                               score_threshold=0.0,
                               verticalness_threshold=-1e9)
    assert poses.shape[1:] == (4, 4) and len(poses) == len(scores) > 0
    r = poses[:, :3, :3]
    np.testing.assert_allclose(np.einsum("nij,nkj->nik", r, r),
                               np.broadcast_to(np.eye(3), r.shape), atol=1e-5)
    assert set(det.timings) >= {"prep_ms", "model_ms", "post_ms", "total_ms"}


def test_detector_without_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no GPU"):
        tdet.GraspDetector()


REPO = Path(__file__).resolve().parents[1]


# The modules of the label factory's tools slice: each must be among
# those the walk below imports.
FACTORY_TOOL_MODULES = (
    "configs.path_registry", "datagen.stats", "datagen.postprocess_grasps",
    "datagen.json_to_pcd", "datagen.grasp_env", "runtime.host_ops",
    "runtime.guard", "tools.train_at_scale", "tools.detect_qa",
    "tools.demo_full_system", "tools.datagen_mesh_qa",
    "tools.parity_at_speed", "tools.measure_fps_sharded",
    "tools.trace_diff", "tools.r3_summarize")


def test_port_imports_neither_jax_nor_s4g_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import chip_smoke, s4g_tpu_torch\n"
        "for m in pkgutil.walk_packages(s4g_tpu_torch.__path__,"
        " 's4g_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 's4g_tpu' or m.startswith('s4g_tpu.')]\n"
        "assert not bad, bad\n"
        f"missing = [m for m in {FACTORY_TOOL_MODULES!r}"
        " if 's4g_tpu_torch.' + m not in sys.modules]\n"
        "assert not missing, missing\n"
        "print(len([m for m in sys.modules if m.startswith('s4g_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_datagen_imports_neither_jax_nor_s4g_tpu():
    """`import s4g_tpu_torch.datagen` on its own, and every module of it,
    loads no jax module and nothing of the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import s4g_tpu_torch.datagen as d\n"
        "for m in pkgutil.walk_packages(d.__path__, d.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 's4g_tpu' or m.startswith('s4g_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules"
        " if m.startswith('s4g_tpu_torch.datagen.')]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == 19


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_gpu(tmp_path, alone):
    """Without a CUDA device chip_smoke.py exits non-zero and prints no
    result — in the repository and copied into a directory of its own."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run for real")
    script = REPO / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path))
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=120, cwd=script.parent)
    assert out.returncode != 0
    assert out.stdout == ""

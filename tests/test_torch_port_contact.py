"""The port's contact model (PN2: `models.pointnet2.PointNet2Reg`, its
`rot6d_to_mat9`, the regression post-processing and the detector on a PN2
config) against the JAX package on the same weights and the same inputs.

The model config is the narrow one of tests/test_torch_port_model.py (every
deployment route: sorted 128-shard FPS, the SA1 slab ball query, 3-NN at
N1 * N2 >= 2^22), with the JAX 3-NN routed as on the TPU; the detector runs
the tiny recipe of tests/test_torch_port_detector.py with the JAX
detector's own draws."""

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from s4g_tpu.configs.config import load_cfg_from_dict as j_cfg
from s4g_tpu.models import build_model as j_build
from s4g_tpu.models.functional import rot6d_to_mat9 as j_rot6d
from s4g_tpu.pipeline import postprocessing as jpost
from s4g_tpu.pipeline import preprocessing as jpre
from s4g_tpu.pipeline.detector import GraspDetector as JaxDetector
from s4g_tpu.utils.checkpoint import import_pn2_torch_state_dict

from s4g_tpu_torch.configs.config import load_cfg_from_dict as t_cfg
from s4g_tpu_torch.models import build_model as t_build
from s4g_tpu_torch.models.functional import rot6d_to_mat9
from s4g_tpu_torch.models.pointnet2 import PointNet2Reg
from s4g_tpu_torch.pipeline import detector as tdet
from s4g_tpu_torch.pipeline import postprocessing as tpost
from s4g_tpu_torch.utils.weights import state_dict_from_flax

from test_torch_port_detector import TINY as DET_TINY
from test_torch_port_detector import _pair_candidates, _t
from test_torch_port_model import (NARROW, _perturb,  # noqa: F401
                                   kernel_routed_three_nn)

TINY = {**DET_TINY, "MODEL": {**DET_TINY["MODEL"], "TYPE": "PN2"}}
CAPACITY = 8192
CANDIDATES = 512


def _cfg_dict(dtype):
    return {"MODEL": {"TYPE": "PN2", "COMPUTE_DTYPE": dtype,
                      "PN2": dict(NARROW)},
            "DATA": {"SCORE_CLASSES": 3}}


def perturb(tree, rng):
    """`_perturb` (non-trivial BatchNorm statistics and affines), then a
    small random translation logit (init gives zeros): residuals of a few
    millimetres, so grasp origins stay on the cloud and some grippers hit
    it."""
    out = _perturb(tree, rng)
    logit = out["params"]["head_t"]["logit"]
    for key, scale in (("kernel", 0.01), ("bias", 0.002)):
        logit[key] = (scale * rng.randn(*logit[key].shape)).astype(np.float32)
    return out


def _pair(dtype):
    """(jax net, numpy variables, port net, numpy cloud (1, 3, N))."""
    jnet, _, _ = j_build(j_cfg(_cfg_dict(dtype)))
    rng = np.random.RandomState(0)
    cloud = (rng.rand(1, 3, NARROW["NUM_INPUT"]) * [[[0.6], [0.4], [0.3]]]
             ).astype(np.float32)
    variables = jnet.init(jax.random.key(0),
                          {"scene_points": jnp.asarray(cloud)}, train=False)
    variables = perturb(jax.tree.map(np.asarray, dict(variables)), rng)
    tnet = t_build(t_cfg(_cfg_dict(dtype)))
    tnet.load_state_dict(state_dict_from_flax(variables))
    return jnet, variables, tnet, cloud


def _run_both(dtype):
    jnet, variables, tnet, cloud = _pair(dtype)
    want = jnet.apply(variables, {"scene_points": jnp.asarray(cloud)},
                      train=False)
    got = tnet({"scene_points": torch.from_numpy(cloud)})
    assert set(got) == set(want) == {"scene_score_logits", "frame_R",
                                     "frame_t", "movable_logits"}
    return ({k: np.asarray(v) for k, v in want.items()},
            {k: v.numpy() for k, v in got.items()})


# -- rot6d_to_mat9 ----------------------------------------------------------------

@pytest.mark.parametrize("case", ["random", "zero first column",
                                  "zero second column", "parallel columns"])
def test_rot6d_to_mat9_matches_jax(case):
    """f32, atol 1e-6: the normalized columns and their cross product,
    including the degenerate columns a fresh model can emit (sqrt(sum +
    1e-24) keeps them finite in both packages)."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 6, 40).astype(np.float32)
    if case == "zero first column":
        x[:, 0:3, :7] = 0.0
    elif case == "zero second column":
        x[:, 3:6, :7] = 0.0
    elif case == "parallel columns":
        x[:, 3:6, :7] = 2.0 * x[:, 0:3, :7]
    want = np.asarray(j_rot6d(jnp.asarray(x)))
    got = rot6d_to_mat9(_t(x)).numpy()
    assert got.shape == (2, 9, 40) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-6)


# -- the model --------------------------------------------------------------------

def test_pn2_f32_matches_jax(kernel_routed_three_nn):
    want, got = _run_both("float32")
    for key, w in want.items():
        assert got[key].shape == w.shape, key
        np.testing.assert_allclose(got[key], w, atol=1e-4, err_msg=key)
    assert got["frame_t"].shape[1] == 3 and got["frame_R"].shape[1] == 9


def test_pn2_bf16_matches_jax(kernel_routed_three_nn):
    # bf16 tolerances of the JAX package's own bf16 comparison
    # (tests/test_sa_fused.py), as tests/test_torch_port_model.py.
    want, got = _run_both("bfloat16")
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, atol=5e-2, err_msg=key)
        assert float(np.abs(got[key] - w).mean()) < 5e-3, key


def test_fresh_pn2_has_a_zero_translation_head():
    """A fresh contact model's translation logit is zero, as JAX's
    zero-initialized head (`pointnet2.py:252`): every grasp origin is its
    point, exactly.  PN2_CLS's translation head is not zeroed."""
    torch.manual_seed(0)
    net = t_build(t_cfg(TINY))
    assert isinstance(net, PointNet2Reg)
    assert net.t_logit.weight.shape[0] == 3 and net.R_logit.out_channels == 6
    assert not net.t_logit.weight.any() and not net.t_logit.bias.any()
    pts = torch.rand(2, 3, 512)
    out = net({"scene_points": pts})
    assert torch.equal(out["frame_t"], pts)
    cls = t_build(t_cfg({**TINY, "MODEL": {**TINY["MODEL"],
                                           "TYPE": "PN2_CLS"}}))
    assert cls.t_logit.weight.any()
    jnet, _, _ = j_build(j_cfg(TINY))
    variables = jnet.init(jax.random.key(0), {"scene_points": jnp.asarray(
        pts[:1].numpy())}, train=False)
    assert not np.asarray(variables["params"]["head_t"]["logit"]["kernel"]
                          ).any()


def test_pn2_state_dict_round_trips_through_jax_importer():
    _, variables, tnet, _ = _pair("float32")
    sd = tnet.state_dict()
    assert sd["R_logit.weight"].shape[0] == 6
    assert sd["t_logit.weight"].shape[0] == 3
    back = import_pn2_torch_state_dict({k: v.numpy() for k, v in sd.items()})
    flat_want = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_want) == len(flat_back)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(flat_back[path], leaf)


def test_unported_model_types_still_raise():
    """The port builds all seven of the JAX package's types; a type that
    neither package builds raises ValueError, as JAX's `build_model`
    does."""
    cfg = {**TINY, "MODEL": {**TINY["MODEL"], "TYPE": "PN2_GLOBAL"}}
    with pytest.raises(ValueError, match="Unknown model"):
        j_build(j_cfg(cfg))
    with pytest.raises(ValueError, match="Unknown model"):
        t_build(t_cfg(cfg))


# -- post-processing ------------------------------------------------------------------

def test_regression_postprocessing_matches_jax():
    """Scores rtol 1e-6 (exp may differ in the last bit), validity exact,
    poses atol 1e-5; a score tie (ties to the lower index) and raw,
    un-normalized rotations."""
    rng = np.random.RandomState(2)
    n, k = 300, 64
    points = rng.rand(3, n).astype(np.float32)
    score = rng.randn(3, n).astype(np.float32)
    score[:, 10] = score[:, 20]
    frame_r = np.array(j_rot6d(jnp.asarray(rng.randn(1, 6, n).astype(
        np.float32))))[0]
    frame_r[:, :5] = rng.randn(9, 5)                  # raw, not orthogonal
    frame_t = (points + 0.01 * rng.randn(3, n)).astype(np.float32)
    want = jpost.post_process_predictions_regression(
        jnp.asarray(points), jnp.asarray(score), jnp.asarray(frame_r),
        jnp.asarray(frame_t), 0.3, 0.0, num_candidates=k)
    got = tpost.post_process_predictions_regression(
        _t(points), _t(score), _t(frame_r), _t(frame_t), 0.3, 0.0,
        num_candidates=k)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-6)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert 0 < got.valid.sum() < k
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(want.poses),
                               atol=1e-5)


# -- the detector ------------------------------------------------------------------------

def table_cloud(rng, num_objects=4, n_per_object=450, n_table=3000):
    """Camera-frame scene ~0.7 m away: a few dense 4 cm objects standing on
    a 0.3 x 0.2 m table, so that grasp origins on the points (a fresh
    contact model's) collide with the table for some rotations."""
    centers = np.column_stack([np.linspace(-0.1, 0.1, num_objects),
                               rng.uniform(-0.05, 0.05, num_objects),
                               np.full(num_objects, 0.70)])
    pts = [c + rng.uniform(-0.02, 0.02, (n_per_object, 3)) for c in centers]
    table = rng.uniform([-0.15, -0.1], [0.15, 0.1], (n_table, 2))
    pts.append(np.column_stack([table, np.full(n_table, 0.72)]))
    return np.concatenate(pts).astype(np.float32)


def test_contact_detect_stages_match_jax_detector(tmp_path):
    """The contact detector, stage by stage, against the JAX detect program
    on the same (perturbed) weights and its own draws: prep exact, the
    model on the same points within 1e-4, post-processing + collision +
    importance sampling as `test_detect_stages_match_jax_detector` holds
    them."""
    cfg_file = tmp_path / "tiny_contact.yaml"
    cfg_file.write_text(yaml.safe_dump(TINY))
    jdet = JaxDetector(model=str(cfg_file), output_dir=str(tmp_path),
                       cloud_capacity=CAPACITY, num_candidates=CANDIDATES)
    cloud = table_cloud(np.random.RandomState(2))
    padded, valid = jdet._pad_cloud(cloud)
    variables = perturb(jax.tree.map(np.asarray, dict(jdet.variables)),
                        np.random.RandomState(9))
    key = jax.random.key(123)
    num_selected, st, vt = 5, 0.0, -1e9
    want = jax.tree.map(np.asarray, jdet._detect_fn(
        variables, padded, valid, key, st, vt, num_selected, True))

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
    jpreds = jdet.net.apply(variables, {"scene_points": jnp.asarray(
        points.t()[None].numpy())}, train=False)
    for k, w in jpreds.items():
        np.testing.assert_allclose(preds[k].numpy(), np.asarray(w),
                                   atol=1e-4, err_msg=k)
    assert float((preds["frame_t"][0] - points.t()).abs().max()) > 1e-3
    got = tdet.post_one(points, {k: v[0] for k, v in preds.items()}, cloud_t,
                        valid_t, _t(uniforms), st, vt, CANDIDATES)
    got = {k: v.numpy() for k, v in got.items()}

    perm = _pair_candidates(got, want)
    # Score-sorted, so position by position: the port's and the program's
    # logits differ in their last bits (perturbed weights), and exp too, so
    # scores agree to rtol 1e-6, as `test_postprocessing_matches_jax` holds
    # them.
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-6)
    np.testing.assert_allclose(got["poses"], want["poses"][perm], atol=1e-4)
    np.testing.assert_array_equal(got["valid"], want["valid"][perm])
    np.testing.assert_array_equal(got["selected"], want["selected"])
    assert 0 < int(got["num_valid"]) < CANDIDATES


def test_contact_model_is_served_by_name(tmp_path):
    """`GraspDetector("contact_model")` builds the full-width PN2 of the
    port's own copy of the JAX config."""
    det = tdet.GraspDetector(model="contact_model", device="cpu",
                             output_dir=str(tmp_path))
    assert isinstance(det.net, PointNet2Reg)
    assert det.cfg.MODEL.TYPE == "PN2"
    assert tuple(det.cfg.MODEL.PN2.SEG_CHANNELS) == (512, 256, 256, 128)
    assert not det.net.t_logit.weight.any()

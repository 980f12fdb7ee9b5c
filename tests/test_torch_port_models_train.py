"""The port's other PointNet++ models against the JAX package, past single
forwards: one f32 training step of EDGEPN2D, EDGEPN2DU and PN2_LOCAL
(losses, gradients, BatchNorm statistics), a sorted backbone through the
all-points and global stages, and an EDGEPN2D detector stage by stage.
Weights, inputs and tolerances as tests/test_torch_port_models.py, whose
helpers these tests share.
"""

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from s4g_tpu.configs.config import load_cfg_from_dict as j_cfg
from s4g_tpu.models import build_model as j_build
from s4g_tpu.pipeline import postprocessing as jpost
from s4g_tpu.pipeline import preprocessing as jpre
from s4g_tpu.pipeline.detector import GraspDetector as JaxDetector

from s4g_tpu_torch.configs.config import load_cfg_from_dict as t_cfg
from s4g_tpu_torch.models import build_model
from s4g_tpu_torch.models import pointnet2 as tp2
from s4g_tpu_torch.pipeline import detector as tdet
from s4g_tpu_torch.utils.weights import params_from_flax, state_dict_from_flax

from test_torch_port_contact import perturb, table_cloud
from test_torch_port_detector import TINY as DET_TINY
from test_torch_port_detector import _pair_candidates, _t
from test_torch_port_models import TINY4, _cfg_dict, _pair, _scale_close
from test_torch_port_train_step import _check_grad


def _jax_train_step(jnet, jloss, variables, batch):
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_of(params):
        preds, mutated = jnet.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jbatch, train=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.key(0)})
        loss_dict = jloss(preds, jbatch)
        return sum(jax.tree.leaves(loss_dict)), (loss_dict, mutated)

    (total, (loss_dict, mutated)), grads = jax.jit(jax.value_and_grad(
        loss_of, has_aux=True))(variables["params"])
    host = lambda t: jax.tree.map(np.asarray, t)    # noqa: E731
    return (float(total), host(loss_dict), host(grads),
            host(mutated["batch_stats"]))


def _f64_losses(model_type, batch, tloss):
    """The port's training-mode losses in float64 (net and features; the
    cloud, and so every index, stays f32; each PointConv rounds its output
    to f32 before its BatchNorm, as the float64 step of
    tests/test_torch_port_train_step.py), from `_pair`'s weights."""
    tnet = _pair(model_type)[3].double().train()
    for m in tnet.modules():
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = torch.float64
    tb = {k: _t(v) if v.dtype != np.float32 or k == "scene_points"
          else _t(v.astype(np.float64)) for k, v in batch.items()}
    with torch.no_grad():
        return {k: float(v) for k, v in tloss(tnet(
            tb, generator=torch.Generator()), tb).items()}


@pytest.mark.parametrize("model_type", ["EDGEPN2D", "EDGEPN2DU",
                                        "PN2_LOCAL"])
def test_train_step_matches_jax(model_type):
    """One f32 training step (batch statistics, dropout 0): the loss dict,
    every gradient by name and the BatchNorm running statistics after it.

    The losses are held, each package's, within 1e-5 relative of the
    port's float64 step: on PN2_LOCAL's R_loss the port is 2.9e-6 from it,
    JAX 7.9e-6 (the two f32 values 1.09e-5 apart), as train-mode BatchNorm
    (E[x^2] - E[x]^2) amplifies f32 rounding."""
    jnet, jloss, variables, tnet, tloss, batch = _pair(model_type)
    total, loss_dict, jgrads, stats = _jax_train_step(jnet, jloss,
                                                      variables, batch)
    tnet.train()
    tb = {k: _t(v) for k, v in batch.items()}
    got = tloss(tnet(tb, generator=torch.Generator()), tb)
    assert set(got) == set(loss_dict)
    f64 = _f64_losses(model_type, batch, tloss)
    for k, v in loss_dict.items():
        np.testing.assert_allclose(float(got[k].detach()), f64[k],
                                   rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(float(v), f64[k], rtol=1e-5, err_msg=k)
    ttotal = sum(got[k] for k in sorted(got))
    np.testing.assert_allclose(float(ttotal.detach()), sum(f64.values()),
                               rtol=1e-5)
    np.testing.assert_allclose(total, sum(f64.values()), rtol=1e-5)
    ttotal.backward()
    want = params_from_flax(jgrads)
    grads = dict(tnet.named_parameters())
    assert set(want) == set(grads)
    for name, w in want.items():
        _check_grad(name, grads[name].grad.numpy(), w.numpy())
    want = state_dict_from_flax({"params": variables["params"],
                                 "batch_stats": stats})
    state = tnet.state_dict()
    for k in (k for k in want if "running" in k):
        w = want[k].numpy()
        assert np.abs(state[k].numpy() - w).max() <= 3e-6 * np.abs(w).max(), k


def test_sorted_special_stages_match_jax(monkeypatch):
    """A sorted four-stage backbone (128-shard FPS, an all-points and a
    global stage) against JAX: the backbone hands no FPS index to the
    special stages and every stage's centroids are exact."""
    pn2 = dict(TINY4, NUM_INPUT=512, NUM_CENTROIDS=(256, -1, 128, 0),
               SORT_POINTS=True, FPS_SHARDS=128)
    cfg = _cfg_dict("PN2", pn2)
    jnet, _, _ = j_build(j_cfg(cfg))
    rng = np.random.RandomState(6)
    pts = (rng.rand(1, 3, 512) * [[[0.6], [0.4], [0.3]]]).astype(np.float32)
    variables = perturb(jax.tree.map(np.asarray, dict(jnet.init(
        jax.random.key(0), {"scene_points": jnp.asarray(pts)},
        train=False))), rng)
    want = jnet.apply(variables, {"scene_points": jnp.asarray(pts)},
                      train=False)
    tnet = build_model(t_cfg(cfg))
    tnet.load_state_dict(state_dict_from_flax(variables))
    seen = []
    for sa in tnet.sa_modules:
        orig = sa.forward

        def spy(xyz, feature, sorted_axis=None, fps_index=None, _o=orig,
                _sa=sa):
            seen.append((_sa.num_centroids, fps_index is None,
                         sorted_axis is not None))
            return _o(xyz, feature, sorted_axis, fps_index)
        monkeypatch.setattr(sa, "forward", spy)
    got = tnet({"scene_points": _t(pts)})
    assert seen == [(256, True, True), (-1, True, True), (128, True, True),
                    (0, True, True)]
    for k, w in want.items():
        _scale_close(got[k].numpy(), w, name=k)


# -- an edge model served by the detector ---------------------------------------------

TINY_EDGE = {**DET_TINY, "MODEL": {
    "TYPE": "EDGEPN2D", "COMPUTE_DTYPE": "float32",
    "PN2": DET_TINY["MODEL"]["PN2"],
    "EDGEPN2D": {**DET_TINY["MODEL"]["PN2"],
                 "NUM_CENTROIDS": "(128, 32, 0)", "RADIUS": "(0.02, 0.08, -1)",
                 "NUM_NEIGHBOURS": "(16, 16, -1)",
                 "SA_CHANNELS": "((16, 32), (32, 64), (64, 64))",
                 "FP_CHANNELS": "((32, 32), (32, 32), (32, 32))",
                 "NUM_FP_NEIGHBOURS": "(0, 3, 3)"}}}


def test_edge_detect_stages_match_jax_detector(tmp_path):
    """An EDGEPN2D detector (a YAML of that type: the net from its own
    section, NUM_INPUT from MODEL.PN2, as in both packages), stage by stage
    against the JAX detect program on the same perturbed weights and its
    own draws, held as `test_contact_detect_stages_match_jax_detector`
    holds the contact model's."""
    cfg_file = tmp_path / "tiny_edge.yaml"
    cfg_file.write_text(yaml.safe_dump(TINY_EDGE))
    capacity, candidates = 8192, 512
    jdet = JaxDetector(model=str(cfg_file), output_dir=str(tmp_path),
                       cloud_capacity=capacity, num_candidates=candidates)
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
                                capacity=capacity)
    sample_idx = jpre.random_sample_fixed(k_sample, pre.raw_valid, 512)
    uniforms = jax.random.uniform(k_importance, (num_selected,))

    tdetector = tdet.GraspDetector(
        model=str(cfg_file), device="cpu", output_dir=str(tmp_path),
        cloud_capacity=capacity, num_candidates=candidates,
        state_dict=state_dict_from_flax(variables))
    assert isinstance(tdetector.net, tp2.PointNet2Reg)
    assert tdetector.net.sa_modules[2].num_centroids == 0
    assert tdetector.net.sa_modules[1].edge
    cloud_t, valid_t = _t(padded), _t(valid)
    points = tdet.prep_one(cloud_t, valid_t, 512, sample_idx=_t(sample_idx))
    np.testing.assert_array_equal(points.numpy(), np.asarray(pre.points))
    preds = tdetector.net({"scene_points": points.t()[None].contiguous()})
    jpreds = jdet.net.apply(variables, {"scene_points": jnp.asarray(
        points.t()[None].numpy())}, train=False)
    for k, w in jpreds.items():
        np.testing.assert_allclose(preds[k].numpy(), np.asarray(w),
                                   atol=1e-4, err_msg=k)
    got = tdet.post_one(points, {k: v[0] for k, v in preds.items()}, cloud_t,
                        valid_t, _t(uniforms), st, vt, candidates)
    got = {k: v.numpy() for k, v in got.items()}
    perm = _pair_candidates(got, want)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-6)
    np.testing.assert_allclose(got["poses"], want["poses"][perm], atol=1e-4)
    np.testing.assert_array_equal(got["valid"], want["valid"][perm])
    np.testing.assert_array_equal(got["selected"], want["selected"])
    assert 0 < int(got["num_valid"]) < candidates

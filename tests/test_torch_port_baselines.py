"""The port's baselines (GPD, PointNetGPD) and API-completeness modules
(`PointNetSAModuleMSG`, `nn_layers.MLP`) against the JAX package on the
same weights (carried over by `utils.weights.state_dict_from_flax`) and
the same seeded inputs: forwards in f32 and bf16, one f32 training step
(losses, gradients, BatchNorm statistics), the losses and metrics, and
the weights' round trip.  Tolerances as tests/test_torch_port_models.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s4g_tpu.configs.config import load_cfg_from_dict as j_cfg
from s4g_tpu.models import build_model as j_build
from s4g_tpu.models import gpd as jgpd
from s4g_tpu.models import pn2_modules as jpm
from s4g_tpu.models.nn_layers import MLP as JMLP

from s4g_tpu_torch.configs.config import load_cfg_from_dict as t_cfg
from s4g_tpu_torch.models import build_loss_and_metric, build_model
from s4g_tpu_torch.models import gpd as tgpd
from s4g_tpu_torch.models import nn_layers as tnn
from s4g_tpu_torch.models import pn2_modules as tpm
from s4g_tpu_torch.utils import weights
from s4g_tpu_torch.utils.weights import params_from_flax, state_dict_from_flax

from test_torch_port_detector import _t
from test_torch_port_model import _perturb
from test_torch_port_models import _scale_close
from test_torch_port_train_step import _check_grad

IN_CHANNELS = 12          # the baseline maps' channels


def _cfg(model_type, dtype="float32", dropout=False):
    return {"MODEL": {"TYPE": model_type, "COMPUTE_DTYPE": dtype,
                      "GPD": {"DROPOUT": dropout}},
            "DATA": {"SCORE_CLASSES": 3, "GPD_IN_CHANNELS": IN_CHANNELS}}


def _batch(rng, model_type, lead=(2, 3)):
    """Seeded inputs of the baseline's layout, with flat labels (one per
    candidate)."""
    if model_type == "GPD":
        x = {"close_region_projection_maps": rng.rand(
            *lead, IN_CHANNELS, 60, 60).astype(np.float32)}
    else:
        x = {"close_region_points": (rng.rand(*lead, 3, 64) * 0.05
                                     ).astype(np.float32)}
    x["grasp_score_labels"] = rng.randint(0, 3, (int(np.prod(lead)),))
    return x


def _pair(model_type, dtype="float32", lead=(2, 3), seed=0):
    """(JAX net, loss, numpy variables, port net, port loss, batch)."""
    cfg = _cfg(model_type, dtype)
    jnet, jloss, _ = j_build(j_cfg(cfg))
    rng = np.random.RandomState(seed)
    batch = _batch(rng, model_type, lead)
    variables = jnet.init(jax.random.key(0), {
        k: jnp.asarray(v) for k, v in batch.items()}, train=False)
    variables = _perturb(jax.tree.map(np.asarray, dict(variables)), rng)
    tnet = build_model(t_cfg(cfg))
    tnet.load_state_dict(state_dict_from_flax(variables))
    tloss, _ = build_loss_and_metric(t_cfg(cfg))
    return jnet, jloss, variables, tnet, tloss, batch


def _forwards(model_type, dtype, lead):
    jnet, _, variables, tnet, _, batch = _pair(model_type, dtype, lead)
    want = jnet.apply(variables, {k: jnp.asarray(v) for k, v in
                                  batch.items()}, train=False)
    got = tnet({k: _t(v) for k, v in batch.items()})
    assert got["grasp_logits"].dtype == torch.float32
    return got["grasp_logits"].numpy(), np.asarray(want["grasp_logits"])


@pytest.mark.parametrize("model_type,dtype,lead", [
    ("GPD", "float32", (4,)), ("GPD", "float32", (2, 3)),
    ("GPD", "bfloat16", (2, 3)),
    ("PointNetGPD", "float32", (4,)), ("PointNetGPD", "float32", (2, 3)),
    ("PointNetGPD", "bfloat16", (2, 3))])
def test_forward_matches_jax(model_type, dtype, lead):
    """f32 within 1e-5 of the logits' largest; bf16 within 5e-2 (max) and
    5e-3 (mean) of the logits' scale."""
    got, want = _forwards(model_type, dtype, lead)
    assert got.shape == (int(np.prod(lead)), 3)
    if dtype == "float32":
        _scale_close(got, want)
    else:
        d = np.abs(got - want) / max(1.0, np.abs(want).max())
        assert d.max() <= 5e-2 and d.mean() <= 5e-3, (d.max(), d.mean())


def test_gpd_flatten_order_is_caught():
    """JAX flattens the pooled maps NHWC, the port NCHW: fc1 taken across
    without the permutation `utils.weights` applies (the Dense kernel
    merely transposed) gives other logits, far past the tolerance."""
    jnet, _, variables, tnet, _, batch = _pair("GPD")
    kernel = variables["params"]["fc1"]["kernel"]
    naive = dict(tnet.state_dict())
    naive["fc1.weight"] = torch.from_numpy(np.ascontiguousarray(kernel.T))
    assert not torch.equal(naive["fc1.weight"],
                           tnet.state_dict()["fc1.weight"])
    tnet.load_state_dict(naive)
    want = np.asarray(jnet.apply(variables, {k: jnp.asarray(v) for k, v in
                                             batch.items()})["grasp_logits"])
    got = tnet({k: _t(v) for k, v in batch.items()})["grasp_logits"].numpy()
    assert np.abs(got - want).max() > 1e-2 * np.abs(want).max()


def _jax_train_step(jnet, jloss, variables, batch):
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    stats = variables.get("batch_stats", {})

    def loss_of(params):
        preds, mutated = jnet.apply(
            {"params": params, "batch_stats": stats}, jbatch, train=True,
            mutable=["batch_stats"], rngs={"dropout": jax.random.key(0)})
        loss_dict = jloss(preds, jbatch)
        return sum(jax.tree.leaves(loss_dict)), (loss_dict, mutated)

    (_, (loss_dict, mutated)), grads = jax.jit(jax.value_and_grad(
        loss_of, has_aux=True))(variables["params"])
    host = lambda t: jax.tree.map(np.asarray, t)    # noqa: E731
    return host(loss_dict), host(grads), host(mutated.get("batch_stats",
                                                          {}))


def test_gpd_train_step_matches_jax():
    """One f32 GPD training step (no dropout): the loss within 1e-5
    relative, every gradient within 5e-2 of its tensor's largest at cosine
    >= 0.9995."""
    jnet, jloss, variables, tnet, tloss, batch = _pair("GPD")
    loss_dict, jgrads, _ = _jax_train_step(jnet, jloss, variables, batch)
    tnet.train()
    tb = {k: _t(v) for k, v in batch.items()}
    got = tloss(tnet(tb, generator=torch.Generator()), tb)
    assert set(got) == set(loss_dict) == {"cls_loss"}
    np.testing.assert_allclose(float(got["cls_loss"].detach()),
                               float(loss_dict["cls_loss"]), rtol=1e-5)
    got["cls_loss"].backward()
    want = params_from_flax(jgrads)
    grads = dict(tnet.named_parameters())
    assert set(want) == set(grads)
    for name, w in want.items():
        _check_grad(name, grads[name].grad.numpy(), w.numpy())


def _as_f64(net):
    net = net.double()
    for m in net.modules():
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = torch.float64
    return net


def _port_step(tnet, tloss, batch):
    """The port's training step: (loss, {name: gradient}, state_dict)."""
    tnet.train()
    tb = {k: _t(v) for k, v in batch.items()}
    loss = tloss(tnet(tb, generator=torch.Generator()), tb)["cls_loss"]
    loss.backward()
    return (float(loss.detach()),
            {n: p.grad.double() for n, p in tnet.named_parameters()},
            tnet.state_dict())


def test_pointnet_gpd_train_step_matches_jax(monkeypatch):
    """One PointNetGPD training step.  Its train-mode BatchNorm takes six
    samples after the max pool, and over 5 cm close-region points the f32
    step is ill-conditioned: JAX's own f32 step is 1.5e-4 (loss) and up to
    17 % of a tensor's largest (STN gradients) from its float64 step.  So
    the semantics are held in float64 and the port's rounding against its
    own float64 step:

    * JAX in float64 (its BatchNorm too) against the port in float64: the
      loss within 1e-6 relative, every gradient within 1e-5 of its
      tensor's largest (plus 1e-9), the BatchNorm running statistics after
      the step within 1e-6;
    * the port's f32 step against that float64 step at the f32 tolerances:
      the loss within 1e-5 relative (measured 4.9e-6), every gradient
      within 5e-2 of its tensor's largest at cosine >= 0.9995 (measured
      4.7e-3 at worst), except the biases of the Dense layers before a
      train-mode BatchNorm, whose gradient is zero (the batch mean takes
      them out): their f32 rounding stays within 1e-4 of the model's
      largest gradient."""
    import flax.linen as fnn
    from s4g_tpu.models import pointnet_gpd as jpg
    import s4g_tpu_torch.utils.weights as tw

    jnet, jloss, variables, tnet, tloss, batch = _pair("PointNetGPD")
    orig = fnn.BatchNorm
    monkeypatch.setattr(fnn, "BatchNorm", lambda *a, **k: orig(
        *a, **{**k, "dtype": jnp.float64}))
    with jax.enable_x64():
        net64 = jpg.PointNetGPDClassifier(3, dtype=jnp.float64)
        wide = lambda t: jax.tree.map(              # noqa: E731
            lambda a: np.asarray(a, np.float64), t)
        b64 = {k: v.astype(np.float64) if v.dtype == np.float32 else v
               for k, v in batch.items()}
        loss_dict, jgrads, stats = _jax_train_step(net64, jloss,
                                                   wide(variables), b64)
    monkeypatch.setattr(tw, "_t", lambda x: torch.from_numpy(
        np.array(x, dtype=np.float64)))
    want_grads = tw.params_from_flax(jgrads)
    want_state = tw.state_dict_from_flax({"params": wide(
        variables["params"]), "batch_stats": stats})
    monkeypatch.undo()

    f32 = _port_step(tnet, tloss, batch)
    _, _, _, tnet64, _, _ = _pair("PointNetGPD")
    f64 = _port_step(_as_f64(tnet64), tloss, b64)
    np.testing.assert_allclose(f64[0], float(loss_dict["cls_loss"]),
                               rtol=1e-6)
    assert set(want_grads) == set(f64[1])
    for name, w in want_grads.items():
        got = f64[1][name]
        assert float((got - w).abs().max()) <= \
            1e-5 * float(w.abs().max()) + 1e-9, name
    names = [k for k in want_state if "running" in k]
    assert len(names) == 2 * 10
    for k in names:
        w = want_state[k]
        assert float((f64[2][k] - w).abs().max()) <= \
            1e-6 * float(w.abs().max()), k

    np.testing.assert_allclose(f32[0], f64[0], rtol=1e-5)
    top = max(float(g.abs().max()) for g in f64[1].values())
    for name, want in f64[1].items():
        got = f32[1][name]
        if float(want.abs().max()) <= 1e-9 * top:
            assert float(got.abs().max()) <= 1e-4 * top, name
            continue
        _check_grad(name, got.numpy(), want.numpy())


def test_gpd_dropout_takes_the_generator():
    """GPD with DROPOUT drops fc1's outputs element-wise in training, from
    the caller's generator (the same state gives the same logits), and not
    in eval mode."""
    cfg = _cfg("GPD", dropout=True)
    torch.manual_seed(0)
    net = build_model(t_cfg(cfg))
    plain = build_model(t_cfg(_cfg("GPD")))
    plain.load_state_dict(net.state_dict())
    batch = {k: _t(v) for k, v in _batch(np.random.RandomState(1),
                                        "GPD").items()}
    assert torch.equal(net(batch)["grasp_logits"],
                       plain(batch)["grasp_logits"])
    net.train()
    g = torch.Generator().manual_seed(2)
    state = g.get_state()
    first = net(batch, generator=g)["grasp_logits"]
    g.set_state(state)
    assert torch.equal(first, net(batch, generator=g)["grasp_logits"])
    assert not torch.allclose(first, plain.train()(batch)["grasp_logits"])
    with pytest.raises(ValueError, match="Generator"):
        net(batch)


@pytest.mark.parametrize("model_type", ["GPD", "PointNetGPD"])
def test_losses_and_metrics_match_jax(model_type):
    rng = np.random.RandomState(3)
    preds = {"grasp_logits": rng.randn(40, 3).astype(np.float32)}
    labels = {"grasp_score_labels": rng.randint(0, 3, (40,))}
    preds["grasp_logits"][:5, 2] = 9.0                 # some true positives
    labels["grasp_score_labels"][:3] = 2
    jnet, jloss, jmetric = j_build(j_cfg(_cfg(model_type)))
    tloss, tmetric = build_loss_and_metric(t_cfg(_cfg(model_type)))
    jp = {k: jnp.asarray(v) for k, v in {**preds, **labels}.items()}
    tp = {k: _t(v) for k, v in {**preds, **labels}.items()}
    np.testing.assert_allclose(float(tloss(tp, tp)["cls_loss"]),
                               float(jloss(jp, jp)["cls_loss"]), rtol=1e-6)
    want, got = jmetric(jp, jp), tmetric(tp, tp)
    assert set(got) == set(want) == {"cls_acc", "prec", "recall"}
    np.testing.assert_array_equal(got["cls_acc"].numpy(),
                                  np.asarray(want["cls_acc"]))
    for k in ("prec", "recall"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6)
        assert 0 < float(got[k]) < 1, k
    assert jmetric is jgpd.gpd_metric and tmetric is tgpd.gpd_metric


@pytest.mark.parametrize("model_type", ["GPD", "PointNetGPD"])
def test_state_dict_round_trips(model_type):
    """The converted variables load strictly, under the JAX module names
    and torch layouts, and come back out unchanged; a model built from the
    config has the same names and shapes (GPD's conv1 takes
    DATA.GPD_IN_CHANNELS)."""
    _, _, variables, tnet, _, _ = _pair(model_type)
    sd = state_dict_from_flax(variables)
    back = tnet.state_dict()
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    fresh = build_model(t_cfg(_cfg(model_type))).state_dict()
    assert {k: tuple(v.shape) for k, v in fresh.items()} == \
        {k: tuple(v.shape) for k, v in sd.items()}
    if model_type == "GPD":
        assert sd["conv1.weight"].shape == (20, IN_CHANNELS, 5, 5)
        assert sd["fc1.weight"].shape == (500, 12 * 12 * 50)
    else:
        assert sd["stn.conv3.fc.weight"].shape == (1024, 128)
        assert sd["bn3.running_var"].shape == (1024,)


def test_unknown_model_type_raises_in_both_factories():
    cfg = t_cfg({"MODEL": {"TYPE": "PN3"}})
    with pytest.raises(ValueError, match="Unknown model"):
        build_model(cfg)
    with pytest.raises(ValueError, match="Unknown model"):
        build_loss_and_metric(cfg)


# -- API-completeness modules ------------------------------------------------

@pytest.mark.parametrize("centroids,features", [(16, 5), (16, 0), (-1, 5)])
def test_msg_stage_matches_jax(centroids, features):
    """Multi-scale grouping: two scales' SharedMLPs over the same exact-FPS
    centroids (every point at -1), concatenated."""
    rng = np.random.RandomState(7 + features)
    xyz = (rng.rand(2, 64, 3) * [0.6, 0.4, 0.3]).astype(np.float32)
    feature = (rng.randn(2, 64, features).astype(np.float32) if features
               else None)
    jmod = jpm.PointNetSAModuleMSG(((8, 12), (16,)), centroids, (0.15, 0.3),
                                   (8, 16))
    args = [jnp.asarray(xyz), None if feature is None
            else jnp.asarray(feature)]
    variables = _perturb(jax.tree.map(np.asarray, dict(
        jmod.init(jax.random.key(0), *args))), rng)
    want_xyz, want = jmod.apply(variables, *args)
    tmod = tpm.PointNetSAModuleMSG(features, ((8, 12), (16,)), centroids,
                                   (0.15, 0.3), (8, 16)).eval()
    sd = {}
    for i in range(2):
        weights._shared_mlp(variables["params"][f"mlp{i}"],
                            variables["batch_stats"][f"mlp{i}"],
                            f"mlp.{i}", 2, sd)
    tmod.load_state_dict(sd)
    got_xyz, got = tmod(_t(xyz), None if feature is None else _t(feature))
    np.testing.assert_array_equal(got_xyz.numpy(), np.asarray(want_xyz))
    assert got.shape == (2, 64 if centroids < 0 else centroids, 28)
    _scale_close(got.detach().numpy(), want)


@pytest.mark.parametrize("train", [False, True])
def test_mlp_matches_jax(train):
    """`nn_layers.MLP` over (B, C) vectors, in eval mode and in training
    mode (batch statistics; the running ones after it within 3e-6)."""
    rng = np.random.RandomState(8)
    x = (rng.randn(16, 6) * 2 + 0.5).astype(np.float32)
    jmlp = JMLP((12, 5))
    variables = _perturb(jax.tree.map(np.asarray, dict(
        jmlp.init(jax.random.key(0), jnp.asarray(x)))), rng)
    want, mutated = jmlp.apply(variables, jnp.asarray(x), train=train,
                               mutable=["batch_stats"])
    tmlp = tnn.MLP(6, (12, 5))
    sd = {}
    weights._shared_mlp(variables["params"], variables["batch_stats"], "",
                        1, sd)
    tmlp.load_state_dict({k[1:]: v for k, v in sd.items()})
    if train:
        tmlp.train()
    got = tmlp(_t(x))
    _scale_close(got.detach().numpy(), want)
    for j in range(2):
        stats = mutated["batch_stats"][f"layer{j}"]["bn"]
        for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
            w = np.asarray(stats[theirs])
            assert np.abs(getattr(tmlp[j].bn, ours).numpy() - w).max() <= \
                3e-6 * np.abs(w).max()

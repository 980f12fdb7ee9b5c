"""The port's other PointNet++ models (EDGEPN2D, EDGEPN2DU, PN2_LOCAL) and
the modules they add (the global and all-points SA stages, the 0-neighbour
FP broadcast, edge SA features, `EdgeFPModule`, channel dropout) against
the JAX package on the same weights (carried over by
`utils.weights.state_dict_from_flax`) and the same seeded inputs.

Configs are tiny: tests/test_models.py's TINY_PN2 and a four-stage
variant with an all-points (-1) and a global (0) stage.  No 3-NN here
reaches the kernel's pair threshold, so JAX's XLA route is the reference.
Tolerances are the port's: f32 outputs within 1e-5 of each tensor's
largest, losses 1e-5 relative, gradients within 5e-2 of each tensor's
largest at cosine >= 0.9995, BatchNorm statistics within 3e-6; bf16
outputs within 5e-2 (max) and 5e-3 (mean), as
tests/test_torch_port_contact.py holds them.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s4g_tpu.configs.config import load_cfg_from_dict as j_cfg
from s4g_tpu.models import build_model as j_build
from s4g_tpu.models import pn2_modules as jpm
from s4g_tpu.models import pointnet2 as jp2
from s4g_tpu.models.nn_layers import SharedMLP as JSharedMLP

from s4g_tpu_torch.configs.config import load_cfg_from_dict as t_cfg
from s4g_tpu_torch.models import build_loss_and_metric, build_model
from s4g_tpu_torch.models import nn_layers as tnn
from s4g_tpu_torch.models import pn2_modules as tpm
from s4g_tpu_torch.models import pointnet2 as tp2
from s4g_tpu_torch.ops.sampling import fps_nesting_applies
from s4g_tpu_torch.utils import weights
from s4g_tpu_torch.utils.weights import params_from_flax, state_dict_from_flax

from test_torch_port_contact import perturb
from test_torch_port_detector import _t

TINY_PN2 = dict(
    NUM_INPUT=64,
    NUM_CENTROIDS=(16, 8),
    RADIUS=(0.2, 0.4),
    NUM_NEIGHBOURS=(8, 8),
    SA_CHANNELS=((8, 16), (16, 32)),
    FP_CHANNELS=((16, 16), (16, 8)),
    NUM_FP_NEIGHBOURS=(3, 3),
    SEG_CHANNELS=(16, 8),
)
# The reference pyramid's shape (a global last stage, its FP a broadcast),
# with an all-points stage in the middle.
TINY4 = dict(
    NUM_INPUT=64,
    NUM_CENTROIDS=(32, -1, 8, 0),
    RADIUS=(0.3, 0.4, 0.6, -1.0),
    NUM_NEIGHBOURS=(8, 8, 8, -1),
    SA_CHANNELS=((8, 16), (16, 16), (16, 32), (32, 32)),
    FP_CHANNELS=((32, 16), (16, 16), (16, 16), (16, 8)),
    NUM_FP_NEIGHBOURS=(0, 3, 3, 3),
    SEG_CHANNELS=(16, 8),
)
B, N, NF = 2, 64, 10
V, S = 10, 4


def _section(model_type):
    return model_type if model_type.startswith("EDGE") else "PN2"


def _cfg_dict(model_type, pn2=TINY4, dtype="float32", **section):
    return {"MODEL": {"TYPE": model_type, "COMPUTE_DTYPE": dtype,
                      _section(model_type): {**pn2, "DROPOUT_PROB": 0.0,
                                             **section}},
            "DATA": {"SCORE_CLASSES": 3}}


def _scale_close(got, want, rel=1e-5, name=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    scale = max(float(np.abs(want).max()), 1e-30)
    assert np.abs(got - want).max() <= rel * scale, \
        (name, float(np.abs(got - want).max()), scale)


def _variables(module, rng, *args, **kwargs):
    v = module.init(jax.random.key(0), *args, **kwargs)
    return perturb_any(jax.tree.map(np.asarray, dict(v)), rng)


def perturb_any(tree, rng):
    """Non-trivial BatchNorm statistics and affines, and a translation
    logit where the tree has one (`perturb`)."""
    if "head_t" in tree.get("params", {}):
        return perturb(tree, rng)
    from test_torch_port_model import _perturb
    return _perturb(tree, rng)


def _mlp_state(variables, ndim, prefix="mlp"):
    out = {}
    weights._shared_mlp(variables["params"]["mlp"],
                        variables["batch_stats"]["mlp"], prefix, ndim, out)
    return out


# -- SA stages -----------------------------------------------------------------

def _cloud(rng, b=B, n=N, sort_axis=None):
    xyz = (rng.rand(b, n, 3) * [0.6, 0.4, 0.3]).astype(np.float32)
    if sort_axis is not None:
        xyz = np.take_along_axis(
            xyz, np.argsort(xyz[..., sort_axis], axis=1, kind="stable")
            [..., None], axis=1)
    return xyz


@pytest.mark.parametrize("centroids,edge,pool,sort", [
    (0, False, "max", False),        # global
    (0, True, "max", False),         # global stage of an edge model
    (-1, False, "max", False),       # all points
    (-1, True, "max", True),         # all points, sorted: stratified
    (16, True, "max", False),        # edge features
    (16, True, "max", True),         # edge, sorted (re-sorted exact FPS)
    (16, False, "mean", False),      # mean pool
])
def test_sa_stage_matches_jax(centroids, edge, pool, sort):
    rng = np.random.RandomState(1 + centroids)
    xyz = _cloud(rng, sort_axis=0 if sort else None)
    feature = rng.randn(B, N, 5).astype(np.float32)
    jmod = jpm.PointNetSAModule((16, 12), centroids, 0.25, 8, edge=edge,
                                pool=pool)
    sa = (jnp.zeros((B,), jnp.int32) if sort else None)
    variables = _variables(jmod, rng, jnp.asarray(xyz), jnp.asarray(feature))
    want_xyz, want = jmod.apply(variables, jnp.asarray(xyz),
                                jnp.asarray(feature), sorted_axis=sa)
    tmod = tpm.PointNetSAModule(5, (16, 12), centroids, 0.25, 8, edge=edge,
                                pool=pool).eval()
    tmod.load_state_dict(_mlp_state(variables, 2))
    got_xyz, got = tmod(_t(xyz), _t(feature),
                        sorted_axis=(torch.zeros(B, dtype=torch.int64)
                                     if sort else None))
    np.testing.assert_array_equal(got_xyz.numpy(), np.asarray(want_xyz))
    _scale_close(got.detach().numpy(), want)
    widths = 3 + 5 * (2 if edge and centroids != 0 else 1)
    assert tmod.mlp[0].conv.in_channels == widths


def test_xyz_only_edge_stage_never_fuses(monkeypatch):
    """An edge stage never takes the whole-stage kernel (JAX `not
    self.edge`), nor a mean-pool one, even where SA1_FUSE asks for it."""
    monkeypatch.setattr(tnn, "SA1_FUSE", "1")
    axis = torch.zeros(2, dtype=torch.int64)
    kw = dict(num_centroids=128, radius=0.1, num_neighbours=16)
    def stage(**more):
        return tpm.PointNetSAModule(0, (128, 128, 128), **kw, **more).eval()
    assert stage()._fuses(2, axis)
    assert not stage(edge=True)._fuses(2, axis)
    assert not stage(pool="mean")._fuses(2, axis)


# -- FP stages -----------------------------------------------------------------

@pytest.mark.parametrize("cls,k,dense", [
    ("PointnetFPModule", 0, True),   # broadcast of the global feature
    ("EdgeFPModule", 0, True),
    ("EdgeFPModule", 3, True),
    ("EdgeFPModule", 3, False),      # the last stage: no dense feature
])
def test_fp_stage_matches_jax(cls, k, dense):
    rng = np.random.RandomState(k + 2 * dense)
    m = 1 if k == 0 else 16
    dense_xyz, sparse_xyz = _cloud(rng), _cloud(rng, n=m)
    dense_f = rng.randn(B, N, 6).astype(np.float32) if dense else None
    sparse_f = rng.randn(B, m, 7).astype(np.float32)
    jmod = getattr(jpm, cls)((16, 12), k)
    args = [jnp.asarray(dense_xyz), jnp.asarray(sparse_xyz),
            None if dense_f is None else jnp.asarray(dense_f),
            jnp.asarray(sparse_f)]
    variables = _variables(jmod, rng, *args)
    want = jmod.apply(variables, *args)
    edge = cls == "EdgeFPModule"
    width = 7 * (2 if edge and k == 3 else 1) + (6 if dense else 0)
    tmod = getattr(tpm, cls)(width, (16, 12), k).eval()
    tmod.load_state_dict(_mlp_state(variables, 1))
    got = tmod(_t(dense_xyz), _t(sparse_xyz),
               None if dense_f is None else _t(dense_f), _t(sparse_f))
    _scale_close(got.detach().numpy(), want)


def test_fp_stage_refuses_other_neighbour_counts():
    with pytest.raises(ValueError, match="0 or 3"):
        tpm.PointnetFPModule(8, (8,), 2)
    with pytest.raises(ValueError, match="0 or 3"):
        tpm.EdgeFPModule(8, (8,), 1)


# -- whole models ------------------------------------------------------------------

def _batch(rng, model_type, b=B):
    batch = {"scene_points": (rng.rand(b, 3, N) * [[0.6], [0.4], [0.3]]
                              ).astype(np.float32)}
    if model_type == "PN2_LOCAL":
        lsf = rng.randn(b, 12, V, S).astype(np.float32)
        lsf[:, 9:] = batch["scene_points"][:, :, :V, None] \
            + 0.02 * rng.randn(b, 3, V, S)
        batch.update(
            local_search_frame=lsf.astype(np.float32),
            scored_grasp_labels=rng.randint(0, 3, (b, V, S)),
            scene_movable_labels=rng.randint(0, 2, (b, N)),
            best_frame_R=rng.randn(b, 9, V).astype(np.float32),
            best_frame_t=rng.randn(b, 3, V).astype(np.float32) * 0.1)
    else:
        batch.update(
            scene_score_labels=rng.randint(0, 3, (b, N)),
            scene_score=rng.rand(b, N).astype(np.float32),
            scene_movable_labels=rng.rand(b, 5, N).astype(np.float32),
            best_frame_R=rng.randn(b, 9, NF).astype(np.float32),
            best_frame_t=rng.randn(b, 3, NF).astype(np.float32) * 0.1)
    return batch


def _pair(model_type, pn2=TINY4, dtype="float32", candidates=True, seed=0):
    """(JAX net, loss, numpy variables, port net, port loss, batch)."""
    cfg = _cfg_dict(model_type, pn2, dtype)
    jnet, jloss, _ = j_build(j_cfg(cfg))
    rng = np.random.RandomState(seed)
    batch = _batch(rng, model_type)
    if not candidates:
        batch.pop("local_search_frame", None)
    variables = jnet.init(jax.random.key(0), {
        k: jnp.asarray(v) for k, v in batch.items()}, train=False)
    variables = perturb(jax.tree.map(np.asarray, dict(variables)), rng)
    tnet = build_model(t_cfg(cfg))
    tnet.load_state_dict(state_dict_from_flax(variables))
    tloss, _ = build_loss_and_metric(t_cfg(cfg))
    return jnet, jloss, variables, tnet, tloss, batch


FORWARDS = [("EDGEPN2D", TINY4, True), ("EDGEPN2DU", TINY4, True),
            ("EDGEPN2D", TINY_PN2, True), ("PN2", TINY4, True),
            ("PN2_LOCAL", TINY4, True), ("PN2_LOCAL", TINY4, False),
            ("PN2_LOCAL", TINY_PN2, True)]


@pytest.mark.parametrize("model_type,pn2,candidates", FORWARDS)
def test_forward_matches_jax(model_type, pn2, candidates):
    jnet, _, variables, tnet, _, batch = _pair(model_type, pn2,
                                               candidates=candidates)
    want = jnet.apply(variables, {k: jnp.asarray(v) for k, v in
                                  batch.items()}, train=False)
    got = tnet({k: _t(v) for k, v in batch.items()})
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == torch.float32, k
        _scale_close(got[k].numpy(), w, name=k)
    if model_type == "PN2_LOCAL":
        lead = (B, 3, V, S) if candidates else (B, 3, N, 1)
        assert got["local_search_logits"].shape == lead
        assert got["movable_logits"].shape == (B, 2, N)


@pytest.mark.parametrize("model_type", ["EDGEPN2D", "EDGEPN2DU",
                                        "PN2_LOCAL"])
def test_bf16_forward_matches_jax(model_type):
    """PN2_LOCAL's eval MLP takes f32 features beside the bf16 pose: both
    packages promote the concatenation to f32 (deployment mode)."""
    jnet, _, variables, tnet, _, batch = _pair(model_type, dtype="bfloat16",
                                               candidates=False)
    want = jnet.apply(variables, {k: jnp.asarray(v) for k, v in
                                  batch.items()}, train=False)
    got = tnet({k: _t(v) for k, v in batch.items()})
    for k, w in want.items():
        d = np.abs(got[k].numpy() - np.asarray(w))
        assert d.max() <= 5e-2 and d.mean() <= 5e-3, (k, d.max(), d.mean())


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_local_loss_and_metric_match_jax(smoothing):
    rng = np.random.RandomState(4)
    q, _ = np.linalg.qr(rng.randn(B, V, 3, 3))
    preds = {"local_search_logits": rng.randn(B, 3, V, S).astype(np.float32),
             "frame_R": rng.randn(B, 9, N).astype(np.float32),
             "frame_t": rng.randn(B, 3, N).astype(np.float32),
             "movable_logits": rng.randn(B, 2, N).astype(np.float32)}
    labels = {"scored_grasp_labels": rng.randint(0, 3, (B, V, S)),
              "scene_movable_labels": rng.randint(0, 2, (B, N)),
              "best_frame_R": q.reshape(B, V, 9).transpose(0, 2, 1)
              .astype(np.float32),
              "best_frame_t": rng.randn(B, 3, V).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in {**preds, **labels}.items()}
    tp = {k: _t(v) for k, v in {**preds, **labels}.items()}
    want = jp2.pointnet2_local_loss(jp, jp, smoothing, 0.5)
    got = tp2.pointnet2_local_loss(tp, tp, smoothing, 0.5)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    want, got = jp2.pointnet2_local_metric(jp, jp), \
        tp2.pointnet2_local_metric(tp, tp)
    assert set(got) == set(want)
    for k in want:
        if k.endswith("_acc"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        else:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=1e-5, err_msg=k)


# -- the factory and the weights ---------------------------------------------------

@pytest.mark.parametrize("model_type", ["PN2_CLS", "PN2", "PN2_LOCAL",
                                        "EDGEPN2D", "EDGEPN2DU"])
def test_pn2_family_reads_its_own_section(model_type):
    """Each type builds from its section (the edge types from
    MODEL.EDGEPN2D / EDGEPN2DU, the rest from MODEL.PN2), with that
    section's NEG_WEIGHT and LABEL_SMOOTHING bound into the loss; the
    other sections are ignored.  The variables' names and shapes are the
    JAX model's."""
    other = dict(TINY_PN2, SA_CHANNELS=((4, 4), (4, 4)))
    d = {"MODEL": {"TYPE": model_type, "COMPUTE_DTYPE": "float32",
                   "PN2": dict(other), "EDGEPN2D": dict(other),
                   "EDGEPN2DU": dict(other)},
         "DATA": {"SCORE_CLASSES": 3}}
    d["MODEL"][_section(model_type)] = dict(TINY4, NEG_WEIGHT=0.3,
                                            LABEL_SMOOTHING=0.2)
    net = build_model(t_cfg(d))
    loss, _ = build_loss_and_metric(t_cfg(d))
    assert loss.keywords == {"label_smoothing": 0.2, "neg_weight": 0.3}
    assert len(net.sa_modules) == 4 and not net.training
    jnet, _, _ = j_build(j_cfg(d))
    batch = _batch(np.random.RandomState(0), model_type)
    variables = jnet.init(jax.random.key(0), {
        k: jnp.asarray(v) for k, v in batch.items()}, train=False)
    want = params_from_flax(jax.tree.map(np.asarray, variables["params"]))
    got = dict(net.named_parameters())
    assert set(got) == set(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == tuple(w.shape), k


@pytest.mark.parametrize("model_type,candidates", [
    ("EDGEPN2D", True), ("EDGEPN2DU", True), ("PN2_LOCAL", True)])
def test_state_dict_round_trips(model_type, candidates):
    """Converted variables load strictly and come back out of the port
    unchanged; the PN2-family names also load into the JAX importer (which
    takes the edge models' variables whole)."""
    from s4g_tpu.utils.checkpoint import import_pn2_torch_state_dict
    _, _, variables, tnet, _, _ = _pair(model_type, candidates=candidates)
    sd = state_dict_from_flax(variables)
    back = tnet.state_dict()
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    if model_type == "PN2_LOCAL":
        assert back["movable_logit.weight"].shape[0] == 2
        assert back["grasp_eval_logit.weight"].shape[1:] == (8, 1, 1)
        return
    flax = import_pn2_torch_state_dict({k: v.numpy() for k, v in sd.items()})
    flat_want = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(flax)[0])
    assert len(flat_want) == len(flat_back)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(flat_back[path], leaf)


# -- sorted backbones with the special stages ----------------------------------------

def test_fps_nesting_refuses_special_stages():
    """Nested K1 takes only positive centroid counts, at most 3 stages."""
    assert fps_nesting_applies(4096, (1024, 256, 128), 128)
    assert not fps_nesting_applies(4096, (1024, 256, 128, 0), 128)
    assert not fps_nesting_applies(4096, (1024, 256, 0), 128)
    assert not fps_nesting_applies(4096, (1024, -1, 128), 128)
    assert not fps_nesting_applies(4096, (1024, 256, 128, 128), 128)


# -- dropout ------------------------------------------------------------------------

def test_channel_dropout_drops_whole_channels():
    """Channel dropout zeroes whole (batch, channel) columns over every
    spatial axis, a share within 4 sigma of p, and scales the rest by
    1 / (1 - p); element-wise dropout still drops single elements."""
    x = torch.rand(4, 30, 6, 8) + 0.1
    layer = tnn.SharedMLP(8, (64,), ndim=2, dropout_prob=0.5,
                          channel_dropout=True)
    plain = tnn.SharedMLP(8, (64,), ndim=2)
    plain.load_state_dict(layer.state_dict())
    layer.train()
    plain.train()
    out = layer(x, generator=torch.Generator().manual_seed(3))
    full = plain(x)
    kept = (out != 0).any(dim=(1, 2))                       # (B, C)
    live = (full != 0).any(dim=(1, 2))
    dropped = live & ~kept
    for b, c in zip(*torch.nonzero(live, as_tuple=True)):
        col = out[b, :, :, c]
        if kept[b, c]:
            torch.testing.assert_close(col, full[b, :, :, c] / 0.5)
        else:
            assert not col.any()
    share = dropped.sum().item() / live.sum().item()
    assert abs(share - 0.5) < 4 * np.sqrt(0.25 / live.sum().item())

    elem = tnn.SharedMLP(8, (64,), ndim=2, dropout_prob=0.5).train()
    elem.load_state_dict(layer.state_dict())
    eout = elem(x, generator=torch.Generator().manual_seed(3))
    per_col = (eout != 0).float().mean(dim=(1, 2))[live]
    assert ((per_col > 0) & (per_col < 1)).float().mean() > 0.99

    # The JAX layer's masks are whole channels too.
    jx = jnp.asarray(x.numpy())
    v = JSharedMLP((64,)).init(jax.random.key(0), jx)
    jfull, jout = (np.asarray(JSharedMLP(
        (64,), dropout_prob=p, channel_dropout=True).apply(
            v, jx, train=True, rngs={"dropout": jax.random.key(1)},
            mutable=["batch_stats"])[0]) for p in (0.0, 0.5))
    jlive = (jfull != 0).any(axis=(1, 2))
    jkept = (jout != 0).any(axis=(1, 2))
    assert (jkept <= jlive).all() and 0 < jkept.sum() < jlive.sum()
    for b, c in zip(*np.nonzero(jlive & ~jkept)):
        assert not jout[b, :, :, c].any()


def test_local_dropout_takes_the_generator():
    """PN2_LOCAL in training drops eval-MLP channels from the caller's
    generator: the same generator state gives the same logits; none
    raises."""
    cfg = _cfg_dict("PN2_LOCAL", TINY_PN2)
    cfg["MODEL"]["PN2"]["DROPOUT_PROB"] = 0.5
    torch.manual_seed(0)
    net = build_model(t_cfg(cfg)).train()
    assert net.mlp_grasp_eval.channel_dropout
    assert net.mlp_grasp_eval.dropout_prob == 0.5
    batch = {k: _t(v) for k, v in _batch(np.random.RandomState(0),
                                        "PN2_LOCAL").items()}
    g = torch.Generator().manual_seed(5)
    state = g.get_state()
    first = net(batch, generator=g)["local_search_logits"]
    g.set_state(state)
    assert torch.equal(first, net(batch, generator=g)["local_search_logits"])
    with pytest.raises(ValueError, match="Generator"):
        net(batch)

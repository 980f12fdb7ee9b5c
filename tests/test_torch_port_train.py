"""The port's training pieces (s4g_tpu_torch.models losses and metrics,
train-mode layers, train.optim, train.augmentation, train.dataset,
runtime.loader, models.freezer) against the JAX package on the same seeded
inputs, and serving kept gradient-free."""

import os
import pickle

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

import s4g_tpu.models.functional as jF
import s4g_tpu.models.pointnet2 as jp2
from s4g_tpu.configs.config import load_cfg_from_dict as j_cfg
from s4g_tpu.models.nn_layers import PointConv as JPointConv
from s4g_tpu.models.nn_layers import SharedMLP as JSharedMLP
from s4g_tpu.runtime import loader as jloader
from s4g_tpu.train import augmentation as jaug
from s4g_tpu.train import dataset as jds
from s4g_tpu.train.optim import build_lr_schedule as j_schedule
from s4g_tpu.train.optim import build_optimizer as j_optimizer

import s4g_tpu_torch.models.functional as tF
import s4g_tpu_torch.models.pointnet2 as tp2
from s4g_tpu_torch.configs.config import load_cfg_from_dict as t_cfg
from s4g_tpu_torch.models import nn_layers as tnn
from s4g_tpu_torch.models.freezer import freeze_by_patterns
from s4g_tpu_torch.pipeline import detector as tdet
from s4g_tpu_torch.runtime import loader as tloader
from s4g_tpu_torch.train import augmentation as taug
from s4g_tpu_torch.train import dataset as tds
from s4g_tpu_torch.train import optim as toptim
from s4g_tpu_torch.train.trainer import Trainer


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# -- synthetic scenes in the dump format ------------------------------------------

def synthetic_scene(rng, n=2000, num_frames=200, num_objects=3,
                    unreduced=False):
    """A scene pickle's dict: a camera-frame cloud ~0.7 m away, grasp frames
    at `num_frames` of its points (random rotations, origins at the
    0.02-0.08 m depth bins), scores, object labels and a direction table.
    `unreduced`: frames and scores per (length, theta) cell, (G, 2, 3,
    ...), as the un-reduced dumps hold them."""
    cloud = (rng.rand(n, 3) * [0.4, 0.3, 0.1] + [-0.2, -0.15, 0.65]
             ).astype(np.float32)
    valid = rng.choice(n, num_frames, replace=False)
    cells = 6 if unreduced else 1
    q, r = np.linalg.qr(rng.randn(num_frames * cells, 3, 3))
    q = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    q[np.linalg.det(q) < 0, :, 2] *= -1
    depth = rng.choice([0.02, 0.04, 0.06, 0.08], num_frames * cells)
    frames = np.tile(np.eye(4), (num_frames * cells, 1, 1))
    frames[:, :3, :3] = q
    pts = np.repeat(cloud[valid], cells, axis=0)
    frames[:, :3, 3] = pts - depth[:, None] * q[:, :, 0]
    shape = (num_frames, 2, 3) if unreduced else (num_frames,)
    return {
        "point_cloud": cloud.T.copy(),
        "valid_index": valid,
        "valid_frame": frames.reshape(*shape, 4, 4).astype(np.float32),
        "search_score": rng.uniform(0, 30, shape).astype(np.float32),
        "antipodal_score": rng.uniform(0, 1, shape).astype(np.float32),
        "objects_label": rng.randint(0, num_objects + 1, shape),
        "direction": rng.uniform(-0.05, 0.15, (num_objects + 1, 5)
                                 ).astype(np.float32),
    }


def write_scenes(root, count, **kwargs):
    os.makedirs(root, exist_ok=True)
    for i in range(count):
        with open(os.path.join(root, f"{i}_view_0.p"), "wb") as f:
            pickle.dump(synthetic_scene(np.random.RandomState(i), **kwargs),
                        f)


# -- loss helpers (models/functional.py) ------------------------------------------

def _helper_cases(rng):
    logits = rng.randn(4, 3, 7).astype(np.float32)
    target = rng.randint(0, 3, (4, 7))
    flat = rng.randn(30, 5).astype(np.float32)
    flat_t = rng.randint(0, 5, 30)
    w3 = np.array([0.3, 1.0, 1.0], np.float32)
    w5 = rng.rand(5).astype(np.float32)
    mat = rng.randn(2, 9, 11).astype(np.float32)
    euler = rng.randn(2, 3, 11).astype(np.float32)
    q, _ = np.linalg.qr(rng.randn(2, 8, 3, 3))
    q2, _ = np.linalg.qr(rng.randn(2, 8, 3, 3))
    f1 = rng.randn(2, 4, 9).astype(np.float32)
    f2 = rng.randn(2, 4, 6).astype(np.float32)
    return {
        "weighted_cross_entropy": (logits, target, w3),
        "cross_entropy": (logits, target),
        "smooth_cross_entropy": (flat, flat_t, 0.1),
        "smooth_cross_entropy_weighted": (flat, flat_t, 0.2, w5),
        "encode_one_hot": (flat_t, 5),
        "flip_mat9_gripper": (mat,),
        "geodesic_angle": (q.astype(np.float32), q2.astype(np.float32)),
        "euler_to_mat9": (euler,),
        "bpdist": (f1,),
        "bpdist2": (f1, f2),
        "pdist2": (f1[0].T.copy(), f2[0].T.copy()),
    }


@pytest.mark.parametrize("name", list(_helper_cases(np.random.RandomState(0))))
def test_loss_helpers_match_jax(name):
    args = _helper_cases(np.random.RandomState(0))[name]
    fn = name.replace("_weighted", "")
    want = getattr(jF, fn)(*[jnp.asarray(a) if isinstance(a, np.ndarray)
                            else a for a in args])
    got = getattr(tF, fn)(*[_t(a) if isinstance(a, np.ndarray) else a
                            for a in args])
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# -- the models' losses and metrics --------------------------------------------

def _preds_labels(rng, model, b=2, n=64, nf=24, classes=3):
    """Seeded predictions and labels in the layouts the models and the
    dataset give them."""
    q, _ = np.linalg.qr(rng.randn(b, nf, 3, 3))
    gt_r = q.reshape(b, nf, 9).transpose(0, 2, 1).astype(np.float32)
    labels = {
        "scene_score_labels": rng.randint(0, classes, (b, n)),
        "scene_movable_labels": rng.uniform(0, 1.2, (b, 5, n)
                                            ).clip(0, 1).astype(np.float32),
        "scene_score": rng.rand(b, n).astype(np.float32),
        "best_frame_R": gt_r,
    }
    preds = {"frame_R": rng.randn(b, 9, n).astype(np.float32),
             "movable_logits": rng.rand(b, 5, n).astype(np.float32)}
    score = rng.randn(b, classes, n).astype(np.float32)
    if model == "PN2_CLS":
        preds["score"] = score
        preds["frame_t"] = rng.randn(b, 4, n).astype(np.float32)
        labels["best_frame_t"] = rng.randint(0, 4, (b, nf))
    else:
        preds["scene_score_logits"] = score
        preds["frame_t"] = rng.randn(b, 3, n).astype(np.float32)
        labels["best_frame_t"] = rng.randn(b, 3, nf).astype(np.float32)
    return preds, labels


@pytest.mark.parametrize("model,smoothing", [("PN2_CLS", 0.0),
                                             ("PN2_CLS", 0.1),
                                             ("PN2", 0.0), ("PN2", 0.1)])
def test_model_losses_and_metrics_match_jax(model, smoothing):
    preds, labels = _preds_labels(np.random.RandomState(1), model)
    j_loss, t_loss = ((jp2.pointnet2_cls_loss, tp2.pointnet2_cls_loss)
                      if model == "PN2_CLS"
                      else (jp2.pointnet2_loss, tp2.pointnet2_loss))
    j_metric, t_metric = ((jp2.pointnet2_cls_metric, tp2.pointnet2_cls_metric)
                          if model == "PN2_CLS"
                          else (jp2.pointnet2_metric, tp2.pointnet2_metric))
    jp = {k: jnp.asarray(v) for k, v in preds.items()}
    jl = {k: jnp.asarray(v) for k, v in labels.items()}
    tp = {k: _t(v) for k, v in preds.items()}
    tl = {k: _t(v) for k, v in labels.items()}
    want = j_loss(jp, jl, label_smoothing=smoothing, neg_weight=0.5)
    got = t_loss(tp, tl, label_smoothing=smoothing, neg_weight=0.5)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                   rtol=1e-5, err_msg=k)
    want, got = j_metric(jp, jl), t_metric(tp, tl)
    assert set(got) == set(want)
    for k in want:
        if k.endswith("_acc"):      # argmax / threshold based: exact
            np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]),
                                          err_msg=k)
        else:
            np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                       rtol=1e-5, err_msg=k)


# -- train-mode PointConv / SharedMLP against flax ------------------------------

def _conv_state_dict(params, stats, ndim, prefix=""):
    """One flax PointConv's params and batch_stats -> the port's names."""
    kernel = np.asarray(params["conv"]["kernel"])
    return {
        f"{prefix}conv.weight": _t(kernel.T.copy()).reshape(
            kernel.shape[1], kernel.shape[0], *([1] * ndim)),
        f"{prefix}bn.weight": _t(params["bn"]["scale"]),
        f"{prefix}bn.bias": _t(params["bn"]["bias"]),
        f"{prefix}bn.running_mean": _t(stats["bn"]["mean"]),
        f"{prefix}bn.running_var": _t(stats["bn"]["var"]),
        f"{prefix}bn.num_batches_tracked": torch.tensor(0)}


def _perturbed(variables, rng):
    out = jax.tree.map(lambda v: np.asarray(v, np.float32), variables)

    def walk(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v)
            elif k in ("mean", "bias"):
                tree[k] = (v + 0.1 * rng.randn(*v.shape)).astype(np.float32)
            elif k in ("var", "scale"):
                tree[k] = (v * (0.5 + rng.rand(*v.shape))).astype(np.float32)
    walk(out)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ndim", [1, 2])
def test_train_mode_shared_mlp_matches_flax(dtype, ndim):
    """SharedMLP (two layers, with max pooling in 2-D) and one PointConv in
    training mode against flax `apply(train=True, mutable=["batch_stats"])`:
    the outputs and the new running mean and variance."""
    rng = np.random.RandomState(5 + ndim)
    shape = (2, 40, 8, 6) if ndim == 2 else (2, 50, 6)
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    pool = 8 if ndim == 2 else None
    # f32 within 1e-6 relative of the output's scale; bf16 at the
    # tolerance of test_shared_mlp_matches_jax (one bf16 rounding of a
    # product flips where the f32 sums' order differs).
    atol = 1e-6 if dtype == "float32" else 2e-2
    stat_rtol = 1e-6 if dtype == "float32" else 1e-2

    jmlp = JSharedMLP((16, 12), dtype=jd)
    variables = _perturbed(jmlp.init(jax.random.key(1), jnp.asarray(x)), rng)
    want, mutated = jmlp.apply(variables, jnp.asarray(x), train=True,
                               max_pool_k=pool, mutable=["batch_stats"])
    tmlp = tnn.SharedMLP(6, (16, 12), ndim=ndim, dtype=td)
    tmlp.load_state_dict({
        k: v for j in range(2) for k, v in _conv_state_dict(
            variables["params"][f"layer{j}"],
            variables["batch_stats"][f"layer{j}"], ndim, f"{j}.").items()})
    tmlp.train()
    got = tmlp(_t(x), max_pool_k=pool)
    scale = max(1.0, float(np.abs(np.asarray(want)).max()))
    np.testing.assert_allclose(_np(got), np.asarray(want),
                               atol=atol * scale)
    for j in range(2):
        stats = mutated["batch_stats"][f"layer{j}"]["bn"]
        np.testing.assert_allclose(_np(tmlp[j].bn.running_mean),
                                   np.asarray(stats["mean"]),
                                   rtol=stat_rtol, atol=1e-7)
        np.testing.assert_allclose(_np(tmlp[j].bn.running_var),
                                   np.asarray(stats["var"]),
                                   rtol=stat_rtol, atol=1e-7)

    jconv = JPointConv(5, dtype=jd)
    cvars = _perturbed(jconv.init(jax.random.key(2), jnp.asarray(x)), rng)
    want, mutated = jconv.apply(cvars, jnp.asarray(x), train=True,
                                mutable=["batch_stats"])
    tconv = tnn.PointConv(6, 5, ndim=ndim, dtype=td).train()
    tconv.load_state_dict(_conv_state_dict(cvars["params"],
                                           cvars["batch_stats"], ndim))
    got = tconv(_t(x))
    scale = max(1.0, float(np.abs(np.asarray(want)).max()))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=atol * scale)
    np.testing.assert_allclose(
        _np(tconv.bn.running_var),
        np.asarray(mutated["batch_stats"]["bn"]["var"]), rtol=stat_rtol)


def test_train_mode_batch_norm_is_not_torch_batch_norm():
    """The trap the explicit statistics avoid: `F.batch_norm` moves
    running_var by the unbiased batch variance, flax by the biased one
    (16 rows: torch's increment is 16/15 of flax's)."""
    x = torch.from_numpy(np.random.RandomState(0).randn(16, 4)
                         .astype(np.float32))
    conv = tnn.PointConv(4, 4).train()
    with torch.no_grad():
        conv.conv.weight.copy_(torch.eye(4)[..., None])
    conv(x)
    ours = conv.bn.running_var - 0.9
    ref = torch.ones(4)
    torch.nn.functional.batch_norm(x, torch.zeros(4), ref, training=True,
                                   momentum=0.1)
    np.testing.assert_allclose(_np((ref - 0.9) / ours), 16 / 15, rtol=1e-5)


def test_dropout_semantics():
    """Eval is the identity; training zeroes a share within 4 sigma of p and
    scales the rest by 1 / (1 - p); the same generator state gives the
    same mask; no generator in training raises."""
    mlp = tnn.SharedMLP(8, (64,), dropout_prob=0.5)
    x = torch.rand(4, 256, 8)
    eval_out = mlp(x)
    plain = tnn.SharedMLP(8, (64,))
    plain.load_state_dict(mlp.state_dict())
    assert torch.equal(eval_out, plain(x))

    mlp.train()
    plain.train()
    g = torch.Generator().manual_seed(7)
    state = g.get_state()
    out = mlp(x, generator=g)
    full = plain(x)
    dropped = (out == 0) & (full != 0)
    share = dropped.sum().item() / (full != 0).sum().item()
    n = (full != 0).sum().item()
    assert abs(share - 0.5) < 4 * np.sqrt(0.25 / n)
    kept = out != 0
    torch.testing.assert_close(out[kept], full[kept] / 0.5)
    g.set_state(state)
    assert torch.equal(mlp(x, generator=g), out)
    with pytest.raises(ValueError, match="Generator"):
        mlp(x)


# -- optimizers and schedules -------------------------------------------------------

def _solver_cfg(solver, lr=0.05):
    d = {"SOLVER": {"TYPE": solver, "BASE_LR": lr, "WEIGHT_DECAY": 0.01},
         "SCHEDULER": {"TYPE": "StepLR",
                       "StepLR": {"step_size": 2, "gamma": 0.5}}}
    return j_cfg(d), t_cfg(d)


@pytest.mark.parametrize("solver", ["Adam", "SGD", "RMSprop"])
def test_optimizer_matches_optax_chain(solver):
    """Three steps on a fixed parameter and gradient sequence (gradients
    from 1e-5 to 1 in size; the learning rate halves at step 2) against
    the optax chain of `s4g_tpu.train.optim.build_optimizer`: the
    parameters within 1e-6 of their largest.  (Not element-wise: optax
    takes Adam's bias correction 1 - 0.999^t in f32, 1.3e-5 off at t = 1,
    torch in double, so an update differs by up to ~7e-6 of its size,
    which is more than 1e-6 of a parameter near zero.)"""
    rng = np.random.RandomState(3)
    p0 = rng.randn(6, 5).astype(np.float32)
    grads = [(rng.randn(6, 5) * 10.0 ** rng.uniform(-5, 0, (6, 5))
              ).astype(np.float32) for _ in range(3)]
    jc, tc = _solver_cfg(solver)
    opt = j_optimizer(jc, steps_per_epoch=1)
    params = {"w": jnp.asarray(p0)}
    state = opt.init(params)
    want = []
    for g in grads:
        updates, state = opt.update({"w": jnp.asarray(g)}, state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        want.append(np.asarray(params["w"]))

    def run(optimizer, p):
        schedule = toptim.build_lr_schedule(tc, 1)
        out = []
        for step, g in enumerate(grads):
            p.grad = _t(g)
            toptim.set_learning_rate(optimizer, schedule(step))
            optimizer.step()
            out.append(_np(p).copy())
        return out

    def close(got, w):
        return np.abs(got - w).max() <= 1e-6 * np.abs(w).max()

    p = torch.nn.Parameter(_t(p0.copy()))
    for got, w in zip(run(toptim.build_optimizer(tc, [p]), p), want):
        assert close(got, w), np.abs(got - w).max()
    if solver == "RMSprop":
        # torch's RMSprop divides by sqrt(nu) + eps, not sqrt(nu + eps).
        p = torch.nn.Parameter(_t(p0.copy()))
        off = run(torch.optim.RMSprop(
            [p], lr=0.05, alpha=tc.SOLVER.RMSprop.alpha,
            weight_decay=0.01), p)
        assert not close(off[0], want[0])


def test_schedules_match_jax():
    d = {"SOLVER": {"BASE_LR": 0.001},
         "SCHEDULER": {"TYPE": "StepLR",
                       "StepLR": {"step_size": 20, "gamma": 0.5}}}
    want, got = j_schedule(j_cfg(d), 10), toptim.build_lr_schedule(
        t_cfg(d), 10)
    for step in (0, 199, 200, 400):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6)
    assert got(200) == pytest.approx(0.0005)
    d = {"SOLVER": {"BASE_LR": 1.0},
         "SCHEDULER": {"TYPE": "MultiStepLR",
                       "MultiStepLR": {"milestones": "(2, 4)",
                                       "gamma": 0.1}}}
    want, got = j_schedule(j_cfg(d), 3), toptim.build_lr_schedule(
        t_cfg(d), 3)
    for step in (0, 5, 6, 11, 12, 30):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6)
    d["SCHEDULER"]["TYPE"] = "Cosine"
    with pytest.raises(ValueError, match="Cosine"):
        toptim.build_lr_schedule(t_cfg(d), 1)


# -- augmentation ---------------------------------------------------------------------

def _aug_batch(rng, regression):
    b, n, nf = 2, 40, 12
    q, _ = np.linalg.qr(rng.randn(b, nf, 3, 3))
    batch = {"scene_points": rng.randn(b, 3, n).astype(np.float32),
             "best_frame_R": q.reshape(b, nf, 9).transpose(0, 2, 1)
             .astype(np.float32)}
    batch["best_frame_t"] = (rng.randn(b, 3, nf).astype(np.float32)
                             if regression else rng.randint(0, 4, (b, nf)))
    return batch


@pytest.mark.parametrize("regression", [False, True])
@pytest.mark.parametrize("name,args", [
    ("PointCloudRotate", ()),
    ("PointCloudRotatePerturbation", (0.3, 0.5)),
    ("PointCloudTranslate", (0.05,)),
    ("PointCloudJitter", (0.01, 0.015)),
])
def test_augmentation_matches_jax(monkeypatch, name, args, regression):
    """Each transform fed JAX's draws (the port's `_uniform` / `_normal`
    return what `jax.random` drew from the same key): the outputs within
    1e-6.  PN2_CLS's integer best_frame_t passes through untouched."""
    batch = _aug_batch(np.random.RandomState(4), regression)
    key = jax.random.key(11)
    monkeypatch.setattr(taug, "_uniform", lambda g, shape, like: _t(
        np.asarray(jax.random.uniform(key, tuple(shape)))))
    monkeypatch.setattr(taug, "_normal", lambda g, shape, like: _t(
        np.asarray(jax.random.normal(key, tuple(shape)))))
    want = jaug._REGISTRY[name](key, {k: jnp.asarray(v)
                                      for k, v in batch.items()}, *args)
    got = taug._REGISTRY[name](None, {k: _t(v) for k, v in batch.items()},
                               *args)
    for k in batch:
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                   atol=1e-6, err_msg=k)
    if not regression:
        assert torch.equal(got["best_frame_t"], _t(batch["best_frame_t"]))


def test_augmentation_spec_parsing():
    batch = {k: _t(v) for k, v in _aug_batch(np.random.RandomState(5),
                                             True).items()}
    spec = ("PointCloudRotate", ("PointCloudRotatePerturbation", 0.1, 0.2),
            ["PointCloudTranslate", 0.01], "PointCloudJitter")
    out = taug.build_augmentation(spec)(torch.Generator().manual_seed(0),
                                        batch)
    assert all(out[k].shape == v.shape for k, v in batch.items())
    r = out["best_frame_R"].transpose(1, 2).reshape(-1, 3, 3)
    torch.testing.assert_close(r @ r.transpose(1, 2),
                               torch.eye(3).expand_as(r), atol=1e-5,
                               rtol=0)
    assert taug.build_augmentation(())(None, batch) is batch
    for build in (taug.build_augmentation, jaug.build_augmentation):
        with pytest.raises(ValueError, match="unknown augmentation"):
            build(["PointCloudShear"])


# -- dataset and loaders ------------------------------------------------------------

@pytest.mark.parametrize("t_classification", [True, False])
@pytest.mark.parametrize("unreduced", [False, True])
def test_collate_scene_matches_jax(t_classification, unreduced):
    data = synthetic_scene(np.random.RandomState(2), unreduced=unreduced)
    want = jds.collate_scene(data, 1024, 3, rng=np.random.RandomState(0),
                             t_classification=t_classification)
    got = tds.collate_scene(data, 1024, 3, rng=np.random.RandomState(0),
                            t_classification=t_classification)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["num_frame_points"] == 200
    x, p = data["valid_frame"], data["point_cloud"][:, data["valid_index"]]
    if not unreduced and t_classification:
        np.testing.assert_array_equal(got["best_frame_t"],
                                      tds.t_bin_class(p.T, x))


def test_dataset_and_loaders_match_jax(tmp_path):
    """SceneGraspDataset (two epochs), FileBackedSceneLoader and
    AsyncSceneLoader against the JAX package's: arrays exactly equal; the
    port's loaders yield tensors in the losses' dtypes."""
    write_scenes(str(tmp_path), 5)
    kw = dict(num_points=512, score_classes=3, batch_size=2,
              num_frame_points=64, seed=3)
    jd, td = jds.SceneGraspDataset(str(tmp_path), **kw), \
        tds.SceneGraspDataset(str(tmp_path), **kw)
    assert len(td) == len(jd) == 2
    for _ in range(2):
        for want, got in zip(list(jd), list(td), strict=True):
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for loader in ("FileBackedSceneLoader", "AsyncSceneLoader"):
        jd, td = jds.SceneGraspDataset(str(tmp_path), **kw), \
            tds.SceneGraspDataset(str(tmp_path), **kw)
        # One worker: with more, the threads draw the random fill from the
        # dataset's one RandomState in whatever order they run.
        want = list(getattr(jloader, loader)(jd, num_workers=1))
        got = list(getattr(tloader, loader)(td, num_workers=1))
        assert len(got) == len(want) == 2
        for w, g in zip(want, got):
            assert g["best_frame_t"].dtype == torch.int64
            assert g["scene_score_labels"].dtype == torch.int64
            assert g["scene_points"].dtype == torch.float32
            for k in w:
                np.testing.assert_array_equal(_np(g[k]), w[k], err_msg=k)


# -- the freezer ------------------------------------------------------------------------

TINY_PN2 = dict(
    NUM_INPUT=128, NUM_CENTROIDS=(32, 8), RADIUS=(0.02, 0.08),
    NUM_NEIGHBOURS=(8, 8), SA_CHANNELS=((8, 16), (16, 32)),
    FP_CHANNELS=((16, 16), (16, 8)), NUM_FP_NEIGHBOURS=(3, 3),
    SEG_CHANNELS=(16,))


def test_freezer_keeps_frozen_parameters(tmp_path):
    """Frozen parameters take no gradient and keep their values through a
    step (Adam with weight decay); the rest move; BatchNorm running
    statistics of frozen layers still update."""
    write_scenes(str(tmp_path / "data"), 2)
    cfg = t_cfg({"MODEL": {"TYPE": "PN2_CLS", "PN2": dict(TINY_PN2)},
                 "SOLVER": {"WEIGHT_DECAY": 0.01}})
    trainer = Trainer(cfg, output_dir=str(tmp_path / "out"), device="cpu")
    trainer.init_state()
    names = freeze_by_patterns(trainer.net, ["^sa_modules", r"\.bn\."])
    assert names and all(n.startswith("sa_modules") or ".bn." in n
                         for n in names)
    trainer.optimizer = toptim.build_optimizer(cfg, trainer.net.parameters())
    before = {k: v.clone() for k, v in trainer.net.state_dict().items()}
    batch = next(iter(tds.SceneGraspDataset(
        str(tmp_path / "data"), num_points=128, batch_size=2,
        num_frame_points=16)))
    trainer.train_step(batch)
    params = dict(trainer.net.named_parameters())
    for name, p in params.items():
        if name in names:
            assert p.grad is None and torch.equal(p, before[name]), name
        else:
            assert not torch.equal(p, before[name]), name
    stat = "sa_modules.0.mlp.0.bn.running_mean"
    assert not torch.equal(trainer.net.state_dict()[stat], before[stat])


# -- serving stays gradient-free ---------------------------------------------------

SERVING = {
    "MODEL": {"TYPE": "PN2_CLS", "COMPUTE_DTYPE": "float32", "PN2": {
        "NUM_INPUT": 512, "NUM_CENTROIDS": "(128, 32)",
        "RADIUS": "(0.02, 0.08)", "NUM_NEIGHBOURS": "(16, 16)",
        "SA_CHANNELS": "((16, 32), (32, 64))",
        "FP_CHANNELS": "((32, 32), (32, 32))",
        "NUM_FP_NEIGHBOURS": "(3, 3)", "SEG_CHANNELS": "(32,)",
        "DROPOUT_PROB": 0.5}},
    "DATA": {"SCORE_CLASSES": 3},
}


def test_serving_builds_no_graph(tmp_path):
    """detect, detect_batch, detect_stream and eval on a narrow detector:
    no output requires grad, and the net's forward runs with grad mode
    off."""
    cfg_file = tmp_path / "serving.yaml"
    cfg_file.write_text(yaml.safe_dump(SERVING))
    det = tdet.GraspDetector(model=str(cfg_file), device="cpu",
                             output_dir=str(tmp_path), cloud_capacity=4096,
                             num_candidates=64)
    seen = []
    det.net.register_forward_hook(
        lambda mod, args, out: seen.append(
            (torch.is_grad_enabled(),
             any(v.requires_grad for v in out.values()))))
    rng = np.random.RandomState(0)
    clouds = [(rng.rand(1500, 3) * [0.3, 0.3, 0.1] + [0, 0, 0.7])
              .astype(np.float32) for _ in range(2)]
    kw = {"score_threshold": 0.0, "verticalness_threshold": -1e9}
    outs = [det.detect(clouds[0], **kw), *det.detect_batch(clouds, **kw),
            *det.detect_stream(clouds, depth=2, **kw)]
    preds = det.eval(clouds[0])
    assert len(seen) == 5 and not any(g or r for g, r in seen)
    assert not any(v.requires_grad for v in preds.values())
    for poses, scores in outs:
        assert isinstance(poses, np.ndarray) and isinstance(scores,
                                                            np.ndarray)
    assert not det.net.training

"""Whole training steps of the port (s4g_tpu_torch.train.trainer.Trainer)
against the JAX package's step on the same weights and the same batch: the
loss dict, every gradient (name by name, through
`utils.weights.params_from_flax`) and the BatchNorm running statistics
after the step; then `Trainer.fit` with checkpoints and resume on the CPU.

The narrow PN2_CLS config takes every kernel route of the deployed train
step (SORT_POINTS with 128-shard FPS: K1's twin; SA1 over the slab
capacity: K2's; SA2 and SA3: K2f's; FP 8192 <- 1024: K4's).  Dropout is 0
and there is no augmentation: torch cannot replay `jax.random`'s masks and
draws (tests/test_torch_port_train.py holds the transforms on the same
draws).  Gradients are compared, not parameters after Adam: one Adam step
turns the sign of a near-zero gradient into a full +/- lr.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s4g_tpu.configs.config import load_cfg_from_dict as j_cfg
from s4g_tpu.models import build_model as j_build
from s4g_tpu.train.dataset import SceneGraspDataset as JDataset

from s4g_tpu_torch.configs.config import load_cfg_from_dict as t_cfg
from s4g_tpu_torch.train.dataset import SceneGraspDataset
from s4g_tpu_torch.train.state import TrainState
from s4g_tpu_torch.train.trainer import Trainer
from s4g_tpu_torch.utils.weights import params_from_flax, state_dict_from_flax

from test_torch_port_model import NARROW, _perturb, kernel_routed_three_nn  # noqa: F401
from test_torch_port_train import TINY_PN2, write_scenes

NUM_FRAME_POINTS = 128


def _cfg_dict(model="PN2_CLS", dtype="float32", **train):
    return {"MODEL": {"TYPE": model, "COMPUTE_DTYPE": dtype,
                      "PN2": {**NARROW, "DROPOUT_PROB": 0.0,
                              "NEG_WEIGHT": 0.5}},
            "DATA": {"SCORE_CLASSES": 3},
            "TRAIN": {"BATCH_SIZE": 2, **train}}


def _batch(tmp_path, model):
    """One b = 2 batch of seeded synthetic scenes, identical from both
    packages' datasets."""
    root = str(tmp_path / "data")
    write_scenes(root, 2, n=10000, num_frames=300)
    kw = dict(num_points=NARROW["NUM_INPUT"], score_classes=3, batch_size=2,
              num_frame_points=NUM_FRAME_POINTS,
              t_classification=model == "PN2_CLS", seed=0)
    batch = next(iter(SceneGraspDataset(root, **kw)))
    want = next(iter(JDataset(root, **kw)))
    for k in want:
        np.testing.assert_array_equal(batch[k], want[k])
    return batch


def _jax_step(cfg_dict, batch):
    """JAX's train-step gradient as tests/test_train.py builds it: the
    perturbed variables, the loss dict, the gradients and the mutated
    batch statistics."""
    net, loss_fn, _ = j_build(j_cfg(cfg_dict))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = net.init(jax.random.key(0), jbatch, train=False)
    variables = _perturb(jax.tree.map(np.asarray, dict(variables)),
                         np.random.RandomState(1))

    def loss_of(params):
        preds, mutated = net.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jbatch, train=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.key(0)})
        loss_dict = loss_fn(preds, jbatch)
        return sum(jax.tree.leaves(loss_dict)), (loss_dict, mutated)

    (total, (loss_dict, mutated)), grads = jax.jit(jax.value_and_grad(
        loss_of, has_aux=True))(variables["params"])
    host = lambda t: jax.tree.map(np.asarray, t)    # noqa: E731
    return (variables, float(total), host(loss_dict), host(grads),
            host(mutated["batch_stats"]))


def _port_step(cfg_dict, variables, batch, tmp_path):
    """The port's Trainer.train_step from the same weights: its scalars,
    each parameter's gradient and the state_dict after the step."""
    trainer = Trainer(t_cfg(cfg_dict), output_dir=str(tmp_path / "out"),
                      device="cpu")
    trainer.init_state()
    trainer.net.load_state_dict(state_dict_from_flax(variables))
    scalars = trainer.train_step(batch)
    grads = {n: p.grad.numpy() for n, p in trainer.net.named_parameters()}
    return scalars, grads, trainer.net.state_dict(), trainer


def _check_losses(scalars, total, loss_dict, rtol):
    for k, v in loss_dict.items():
        np.testing.assert_allclose(float(scalars[k]), float(v), rtol=rtol,
                                   err_msg=k)
    np.testing.assert_allclose(float(scalars["total_loss"]), total,
                               rtol=rtol)


def _check_stats(state, variables, stats, scale_tol):
    """The port's BatchNorm running statistics after the step against
    JAX's mutated batch_stats, by the port's names: each tensor within
    `scale_tol` of its largest."""
    want = state_dict_from_flax({"params": variables["params"],
                                 "batch_stats": stats})
    names = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert names
    for k in names:
        w = want[k].numpy()
        assert np.abs(state[k].numpy() - w).max() <= \
            scale_tol * np.abs(w).max(), k


def _grads_by_name(jgrads, grads):
    want = {k: v.numpy() for k, v in params_from_flax(jgrads).items()}
    assert set(want) == set(grads)
    return {k: (grads[k].reshape(w.shape), w) for k, w in want.items()}


def _cosine(a, b):
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return float(a @ b / np.sqrt((a @ a) * (b @ b)))


def _f64_grads(cfg_dict, variables, batch, tmp_path):
    """The port's step in float64 (net, features and labels; the cloud and
    so every index stay f32), gradients by name: the oracle for both f32
    steps' rounding."""
    trainer = Trainer(t_cfg(cfg_dict), output_dir=str(tmp_path / "f64"),
                      device="cpu")
    trainer.init_state()
    trainer.net.load_state_dict(state_dict_from_flax(variables))
    trainer.net.double()
    for m in trainer.net.modules():
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = torch.float64
    batch = {k: torch.from_numpy(v.astype(np.float64))
             if v.dtype == np.float32 and k != "scene_points"
             else torch.from_numpy(v) for k, v in batch.items()}
    total, _, _, _ = trainer.forward_loss(batch)
    trainer.backward(total)
    return {n: p.grad.numpy() for n, p in trainer.net.named_parameters()}


def _check_grad(name, got, want):
    """f32: within 5e-2 of the tensor's largest, cosine >= 0.9995 (a
    tensor whose gradient is below 1e-6 everywhere only by the first)."""
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 5e-2 * scale + 1e-7, name
    assert scale < 1e-6 or _cosine(got, want) >= 0.9995, name


def test_f32_train_step_matches_jax(tmp_path, kernel_routed_three_nn):
    """The loss dict within rtol 1e-5; every gradient within 5e-2 of its
    tensor's largest and at cosine >= 0.9995; the BatchNorm running
    statistics within 3e-6 of their tensor's largest.

    Measured on this batch: gradients 2.0e-2 of the max at worst (SA2's
    first conv), loss 5e-6, statistics 1.3e-6.  The gap is JAX's: against
    the port's step in float64 the port's f32 gradients are within 2e-3
    of each tensor's max (held below at 5e-3), JAX's within 2e-2."""
    cfg = _cfg_dict()
    batch = _batch(tmp_path, "PN2_CLS")
    variables, total, loss_dict, jgrads, stats = _jax_step(cfg, batch)
    scalars, grads, state, _ = _port_step(cfg, variables, batch, tmp_path)
    _check_losses(scalars, total, loss_dict, rtol=1e-5)
    f64 = _f64_grads(cfg, variables, batch, tmp_path)
    for name, (got, want) in _grads_by_name(jgrads, grads).items():
        scale = np.abs(want).max()
        _check_grad(name, got, want)
        ref = f64[name].reshape(got.shape)
        assert np.abs(got - ref).max() <= 5e-3 * np.abs(ref).max() + 1e-7, \
            name
    _check_stats(state, variables, stats, 3e-6)


def test_bf16_train_step_matches_jax(tmp_path, kernel_routed_three_nn):
    """The same step on a bf16 backbone: the loss dict within 2e-2 (measured
    2e-3); gradients by cosine: the logit layers' >= 0.99 (measured 0.998),
    every conv weight's >= 0.6 (measured 0.74), all gradients together
    >= 0.7 (measured 0.83).  The backbone's bf16 gradients are noise-bound:
    the port's own bf16 and f32 gradients of this step are at cosine
    0.3-0.8 per tensor, as the Dense outputs reach train-mode BatchNorm
    rounded to bf16."""
    cfg = _cfg_dict(dtype="bfloat16")
    batch = _batch(tmp_path, "PN2_CLS")
    variables, total, loss_dict, jgrads, _ = _jax_step(cfg, batch)
    scalars, grads, _, _ = _port_step(cfg, variables, batch, tmp_path)
    _check_losses(scalars, total, loss_dict, rtol=2e-2)
    pairs = _grads_by_name(jgrads, grads)
    for name, (got, want) in pairs.items():
        if "logit" in name:
            assert _cosine(got, want) >= 0.99, name
        if name.endswith("conv.weight"):
            assert _cosine(got, want) >= 0.6, name
    assert _cosine(np.concatenate([g.ravel() for g, _ in pairs.values()]),
                   np.concatenate([w.ravel() for _, w in pairs.values()])
                   ) >= 0.7


def test_pn2_train_step_matches_jax(tmp_path, kernel_routed_three_nn):
    """The contact model (PN2: regression translation, `pointnet2_loss`),
    one f32 step: the loss dict, the gradients and the statistics at the
    PN2_CLS step's tolerances (measured: gradients 3.1e-2 of the max at
    worst, SA1's last BatchNorm bias)."""
    cfg = _cfg_dict(model="PN2")
    batch = _batch(tmp_path, "PN2")
    assert batch["best_frame_t"].shape == (2, 3, NUM_FRAME_POINTS)
    variables, total, loss_dict, jgrads, stats = _jax_step(cfg, batch)
    scalars, grads, state, _ = _port_step(cfg, variables, batch, tmp_path)
    _check_losses(scalars, total, loss_dict, rtol=1e-5)
    assert set(scalars) == {"cls_loss", "R_loss", "t_loss", "mov_loss",
                            "cls_acc", "mov_acc", "R_err", "t_err",
                            "total_loss"}
    for name, (got, want) in _grads_by_name(jgrads, grads).items():
        _check_grad(name, got, want)
    _check_stats(state, variables, stats, 3e-6)


def test_trainer_fit_checkpoints_and_resumes(tmp_path):
    """`Trainer.fit` on the CPU: an epoch of two steps with validation and a
    checkpoint; a new Trainer resumes from `last_checkpoint` (weights,
    optimizer, generator and step as saved, the files loadable with
    weights_only=True) and fits epoch 2, steps 2 -> 4."""
    write_scenes(str(tmp_path / "data"), 4)
    cfg = t_cfg({
        "MODEL": {"TYPE": "PN2_CLS", "COMPUTE_DTYPE": "float32",
                  "PN2": dict(TINY_PN2)},
        "DATA": {"SCORE_CLASSES": 3},
        "TRAIN": {"BATCH_SIZE": 2, "LOG_PERIOD": 1, "CHECKPOINT_PERIOD": 1,
                  "AUGMENTATION": ("PointCloudRotate", "PointCloudJitter")},
        "SCHEDULER": {"MAX_EPOCH": 2, "TYPE": "StepLR",
                      "StepLR": {"step_size": 1, "gamma": 0.5}}})
    ds = SceneGraspDataset(str(tmp_path / "data"), num_points=128,
                           batch_size=2, num_frame_points=16, seed=0)
    out = str(tmp_path / "out")
    trainer = Trainer(cfg, output_dir=out, steps_per_epoch=len(ds),
                      device="cpu")
    state = trainer.fit(ds, val_data=ds, max_epochs=1)
    assert state.step == 2 and trainer.optimizer.param_groups[0]["lr"] \
        == pytest.approx(1e-3)
    assert sorted(f for f in os.listdir(out) if f.endswith(".ckpt")) \
        == ["model_001.ckpt"]
    saved = torch.load(os.path.join(out, "model_001.ckpt"),
                       weights_only=True)
    assert saved["extra"]["step"] == 2

    resumed = Trainer(cfg, output_dir=out, steps_per_epoch=len(ds),
                      device="cpu")
    start = resumed.resume_or_init()
    assert start.step == 2
    for k, v in state.model.items():
        assert torch.equal(start.model[k], v), k
    assert torch.equal(start.generator, state.generator)
    assert start.optimizer["state"][0]["step"] == 2
    final = resumed.fit(ds, val_data=ds, max_epochs=2)
    assert final.step == 4
    assert resumed.optimizer.param_groups[0]["lr"] == pytest.approx(5e-4)
    assert any(not torch.equal(final.model[k], state.model[k])
               for k in state.model)
    assert open(os.path.join(out, "last_checkpoint")).read().endswith(
        "model_002.ckpt")
    again = TrainState.from_checkpoint(torch.load(
        os.path.join(out, "model_002.ckpt"), weights_only=True))
    assert again.step == 4


def test_trainer_without_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no GPU"):
        Trainer(t_cfg({}), output_dir="unused")

"""Data-parallel training in the port (`Trainer(mesh=...)`,
`parallel.global_batch`) on CPU ranks: the sharded step against the
port's single step on the same global batch (W = 4, dropout 0.5 and
augmentation on), against JAX's sharded step (W = 4, dropout 0), all seven
model types (W = 2, float64), and `Trainer.fit` and the train CLI with
checkpoints across world sizes (W = 2).

The ranks are spawned processes (torch.multiprocessing, start method
spawn) in a gloo group that meets through a file under the test's
directory, so no port is shared between test workers.  Their bodies are
this module's `_rank_*` functions: this module imports JAX only inside the
tests, so a rank imports none.  Each rank writes its results as an .npz
file; one group runs every case of its world size.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from s4g_tpu_torch.configs.config import load_cfg_from_dict as t_cfg
from s4g_tpu_torch.models import nn_layers as tnn
from s4g_tpu_torch.parallel import mesh as pm
from s4g_tpu_torch.train.trainer import Trainer

# __graft_entry__._dryrun_impl's tiny PN2_CLS.
TINY = dict(NUM_INPUT=128, NUM_CENTROIDS=(32, 8), RADIUS=(0.05, 0.2),
            NUM_NEIGHBOURS=(8, 8), SA_CHANNELS=((8, 16), (16, 32)),
            FP_CHANNELS=((16, 16), (16, 8)), NUM_FP_NEIGHBOURS=(3, 3),
            SEG_CHANNELS=(16,))
# The reference pyramid's shape: an all-points stage and a global one
# (tests/test_torch_port_models.py's TINY4).
TINY4 = dict(NUM_INPUT=64, NUM_CENTROIDS=(32, -1, 8, 0),
             RADIUS=(0.3, 0.4, 0.6, -1.0), NUM_NEIGHBOURS=(8, 8, 8, -1),
             SA_CHANNELS=((8, 16), (16, 16), (16, 32), (32, 32)),
             FP_CHANNELS=((32, 16), (16, 16), (16, 16), (16, 8)),
             NUM_FP_NEIGHBOURS=(0, 3, 3, 3), SEG_CHANNELS=(16, 8))
AUGMENTATION = ("PointCloudRotate", ("PointCloudRotatePerturbation", 0.06,
                                     0.18),
                ("PointCloudTranslate", 0.02),
                ("PointCloudJitter", 0.002, 0.01))
MODEL_TYPES = ("PN2_CLS", "PN2", "EDGEPN2D", "EDGEPN2DU", "PN2_LOCAL", "GPD",
               "PointNetGPD")
B4 = 8                 # the W = 4 group's global batch (2 rows a rank)
B2 = 4                 # the W = 2 group's


def tiny_cfg(dropout: float, augmentation=(), **train) -> dict:
    return {"MODEL": {"TYPE": "PN2_CLS", "COMPUTE_DTYPE": "float32",
                      "PN2": {**TINY, "DROPOUT_PROB": dropout}},
            "DATA": {"SCORE_CLASSES": 3},
            "TRAIN": {"BATCH_SIZE": B4, "AUGMENTATION": augmentation,
                      **train}}


def tiny_batch(b: int, seed: int = 0, n: int = 128, nf: int = 16) -> dict:
    """_dryrun_impl's batch recipe, but the points in a 0.2 m cube: its
    standard normal cloud leaves SA1's 0.05 m balls with their centre
    alone, SA1's BatchNorm then sees a near-constant input, and the f32
    gradients of that step are noise (the port's f32 step is 1e18 of a
    tensor's largest from its float64 step there, 5e-6 in the cube)."""
    rng = np.random.RandomState(seed)
    return {"scene_points": (rng.rand(b, 3, n) * 0.2).astype(np.float32),
            "scene_score_labels": rng.randint(0, 3, (b, n)),
            "scene_score": rng.rand(b, n).astype(np.float32),
            "scene_movable_labels": rng.rand(b, 5, n).astype(np.float32),
            "best_frame_R": rng.randn(b, 9, nf).astype(np.float32),
            "best_frame_t": rng.randint(0, 4, (b, nf))}


def _type_cfg(model_type: str) -> dict:
    if model_type in ("GPD", "PointNetGPD"):
        return {"MODEL": {"TYPE": model_type, "COMPUTE_DTYPE": "float32",
                          "GPD": {"DROPOUT": True}},
                "DATA": {"SCORE_CLASSES": 3, "GPD_IN_CHANNELS": 12}}
    section = model_type if model_type.startswith("EDGE") else "PN2"
    pn2 = TINY if model_type in ("PN2_CLS", "PN2") else TINY4
    return {"MODEL": {"TYPE": model_type, "COMPUTE_DTYPE": "float32",
                      section: {**pn2, "DROPOUT_PROB": 0.5}},
            "DATA": {"SCORE_CLASSES": 3}}


def _type_batch(model_type: str, b: int = B2) -> dict:
    """A seeded global batch of the model's layout, as tensors: the
    PN2 family's clouds in f32 (every index stays the f32 run's), the
    other float leaves as they are drawn (float64 but for `tiny_batch`'s
    f32 labels)."""
    rng = np.random.RandomState(3)
    if model_type == "GPD":
        batch = {"close_region_projection_maps": rng.rand(b, 3, 12, 60, 60),
                 "grasp_score_labels": rng.randint(0, 3, (b * 3,))}
    elif model_type == "PointNetGPD":
        batch = {"close_region_points": rng.rand(b, 3, 3, 64) * 0.05,
                 "grasp_score_labels": rng.randint(0, 3, (b * 3,))}
    elif model_type in ("PN2_CLS", "PN2"):
        batch = tiny_batch(b, seed=3)
        if model_type == "PN2":
            batch["best_frame_t"] = rng.randn(b, 3, 16) * 0.1
    else:
        n, v, s, nf = 64, 10, 4, 10
        pts = (rng.rand(b, 3, n) * [[0.6], [0.4], [0.3]]).astype(np.float32)
        batch = {"scene_points": pts,
                 "best_frame_R": rng.randn(b, 9, nf if model_type !=
                                           "PN2_LOCAL" else v),
                 "best_frame_t": rng.randn(b, 3, nf if model_type !=
                                           "PN2_LOCAL" else v) * 0.1}
        if model_type == "PN2_LOCAL":
            lsf = rng.randn(b, 12, v, s)
            lsf[:, 9:] = pts[:, :, :v, None] + 0.02 * rng.randn(b, 3, v, s)
            batch.update(local_search_frame=lsf,
                         scored_grasp_labels=rng.randint(0, 3, (b, v, s)),
                         scene_movable_labels=rng.randint(0, 2, (b, n)))
        else:
            batch.update(scene_score_labels=rng.randint(0, 3, (b, n)),
                         scene_score=rng.rand(b, n),
                         scene_movable_labels=rng.rand(b, 5, n))
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _f64(net):
    """`net` in float64 throughout, BatchNorm inputs included (each
    PointConv's product stays float64)."""
    import types

    def forward(self, x):
        w = self.conv.weight.reshape(self.conv.out_channels, -1)
        return torch.relu(tnn.batch_norm(
            torch.matmul(x.to(self.dtype), w.t().to(self.dtype)), self.bn))

    net.double()
    for m in net.modules():
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = torch.float64
        if isinstance(m, tnn.PointConv):
            m.forward = types.MethodType(forward, m)
    return net


def _type_step(model_type: str, mesh, out: str) -> dict:
    """One float64 forward + backward of the model's Trainer (gradients
    summed over the ranks under a mesh): its losses and gradients."""
    tr = Trainer(t_cfg(_type_cfg(model_type)), output_dir=out,
                 device="cpu", mesh=mesh)
    tr.init_state()
    _f64(tr.net)
    total, losses, _, _ = tr.forward_loss(_type_batch(model_type))
    tr.backward(total)
    return {"loss": {k: _sum(v.detach().clone(), mesh)
                     for k, v in losses.items()},
            "grad": {n: p.grad for n, p in tr.net.named_parameters()
                     if p.grad is not None}}


def _sum(x: torch.Tensor, mesh) -> torch.Tensor:
    if mesh is not None:
        dist.all_reduce(x, group=mesh.get_group())
    return x


def _flat(prefix: str, tree: dict, out: dict) -> dict:
    for k, v in tree.items():
        if isinstance(v, dict):
            _flat(f"{prefix}{k}/", v, out)
        else:
            out[prefix + k] = (v.detach().cpu().numpy()
                               if isinstance(v, torch.Tensor)
                               else np.asarray(v))
    return out


def _join(rank: int, world: int, init: str):
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world)
    return pm.make_mesh(["cpu"] * world)


def _spawn(body, world: int, tmp, *args) -> None:
    mp.start_processes(body, args=(world, str(tmp / "rendezvous"),
                                   str(tmp), *args),
                       nprocs=world, start_method="spawn")


def _steps(mesh, cfg: dict, batches, out: str, state=None,
           device: str = "cpu") -> dict:
    """Train steps on the global batches (on the mesh's device, else on
    `device`): each step's scalars and gradients, then the state_dict and
    the generator's state."""
    tr = Trainer(t_cfg(cfg), output_dir=out, device=device, mesh=mesh)
    tr.init_state()
    if state is not None:
        tr.net.load_state_dict(state)
    res = {}
    for i, batch in enumerate(batches):
        res[f"scalars{i}"] = tr.train_step(batch)
        res[f"grads{i}"] = {n: p.grad for n, p in tr.net.named_parameters()}
        res[f"stats{i}"] = {k: v.clone() for k, v in
                            tr.net.state_dict().items() if "running" in k}
    res["state"] = tr.net.state_dict()
    res["generator"] = tr.generator.get_state()
    return res


# -- W = 4 ---------------------------------------------------------------------

def _rank_train4(rank, world, init, tmp, jax_state):
    mesh = _join(rank, world, init)
    out = os.path.join(tmp, f"rank{rank}")
    res = {"rows": pm.shard_batch(mesh, tiny_batch(B4)),
           "dropout": _steps(mesh, tiny_cfg(0.5, AUGMENTATION),
                             [tiny_batch(B4, s) for s in range(2)], out),
           "jax": _steps(mesh, tiny_cfg(0.0), [tiny_batch(B4, 7)], out,
                         torch.load(jax_state))}
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **_flat("", res, {}))
    dist.destroy_process_group()


def _jax_sharded_step(batch):
    """JAX's step on a 4-device mesh, as `_dryrun_impl` and
    tests/test_train.py shard it: the variables, the loss dict, the total,
    the gradients and the mutated batch statistics."""
    import jax
    from s4g_tpu.configs.config import load_cfg_from_dict as j_cfg
    from s4g_tpu.models import build_model as j_build
    from s4g_tpu.parallel.mesh import (make_mesh, replicate_sharding,
                                       shard_batch)
    from test_torch_port_model import _perturb

    net, loss_fn, _ = j_build(j_cfg(tiny_cfg(0.0)))
    variables = jax.jit(lambda key, b: net.init(key, b, train=False))(
        jax.random.key(1), batch)
    variables = _perturb(jax.tree.map(np.asarray, dict(variables)),
                         np.random.RandomState(1))

    def loss_of(params, batch):
        preds, mutated = net.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            batch, train=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.key(0)})
        loss_dict = loss_fn(preds, batch)
        return sum(jax.tree.leaves(loss_dict)), (loss_dict, mutated)

    mesh = make_mesh(jax.devices()[:4])
    (total, (loss_dict, mutated)), grads = jax.jit(jax.value_and_grad(
        loss_of, has_aux=True))(
        jax.device_put(variables["params"], replicate_sharding(mesh)),
        shard_batch(mesh, batch))
    host = lambda t: jax.tree.map(np.asarray, jax.device_get(t))  # noqa
    return (variables, float(total), host(loss_dict), host(grads),
            host(mutated["batch_stats"]))


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """JAX's sharded step, then the W = 4 group from the same weights:
    (the ranks' results, JAX's)."""
    from s4g_tpu_torch.utils.weights import state_dict_from_flax
    tmp = tmp_path_factory.mktemp("world4")
    want = _jax_sharded_step(tiny_batch(B4, 7))
    torch.save(state_dict_from_flax(want[0]), tmp / "jax_state.pt")
    _spawn(_rank_train4, 4, tmp, str(tmp / "jax_state.pt"))
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)]
    return ranks, want, tmp


def _group(ranks, prefix):
    n = len(prefix)
    return [{k[n:]: v for k, v in r.items() if k.startswith(prefix)}
            for r in ranks]


def test_shard_batch_rows_at_four_ranks(world4):
    ranks, _, _ = world4
    batch = tiny_batch(B4)
    for r, got in enumerate(_group(ranks, "rows/")):
        assert set(got) == set(batch)
        for k, v in batch.items():
            np.testing.assert_array_equal(got[k], v[2 * r:2 * r + 2])
            assert got[k].dtype == v.dtype


def test_sharded_step_matches_single_step(world4, tmp_path):
    """Two steps of the W = 4 step (dropout 0.5 in the heads, every
    augmentation) against the single step on the same global batches, from
    the same seed: the losses within rtol 2e-5, each gradient within
    tests/test_train.py's data-parallel tolerances (rtol 2e-3, atol 5e-4
    of its tensor's largest, norms rtol 1e-4), the BatchNorm running
    statistics after the first step within 1e-6 of their largest (the
    second step's forward runs on parameters that one Adam step has
    already set apart: it turns the sign of a near-zero gradient into a
    full +/- lr), the generator's state equal; every rank's gradients,
    state and generator bit for bit rank 0's."""
    ranks, _, _ = world4
    want = _steps(None, tiny_cfg(0.5, AUGMENTATION),
                  [tiny_batch(B4, s) for s in range(2)], str(tmp_path))
    want = _flat("", want, {})
    got = _group(ranks, "dropout/")
    for r in got[1:]:
        assert set(r) == set(got[0])
        for k, v in got[0].items():
            if not k.startswith("scalars"):
                np.testing.assert_array_equal(r[k], v, err_msg=k)
    got = got[0]
    for k, v in want.items():
        if k.startswith("scalars"):
            np.testing.assert_allclose(got[k], v, rtol=2e-5, atol=1e-7,
                                       err_msg=k)
        elif k.startswith("grads"):
            scale = max(float(np.abs(v).max()), 1e-3)
            np.testing.assert_allclose(got[k], v, rtol=2e-3,
                                       atol=5e-4 * scale, err_msg=k)
            np.testing.assert_allclose(np.linalg.norm(got[k]),
                                       np.linalg.norm(v), rtol=1e-4,
                                       atol=1e-6, err_msg=k)
        elif k.startswith("stats0/"):
            assert np.abs(got[k] - v).max() <= 1e-6 * np.abs(v).max(), k
    np.testing.assert_array_equal(got["generator"], want["generator"])
    assert any(k.startswith("scalars0/") for k in want)


def test_sharded_step_matches_jax_sharded_step(world4):
    """The port's W = 4 step (dropout 0) against JAX's step on a 4-device
    mesh from the same weights: tests/test_torch_port_train_step.py's
    tolerances (losses rtol 1e-5; each gradient within 5e-2 of its
    tensor's largest at cosine >= 0.9995; BatchNorm statistics within 3e-6
    of their largest)."""
    from test_torch_port_train_step import (_check_grad, _check_stats,
                                            _grads_by_name)
    ranks, (variables, total, loss_dict, jgrads, stats), _ = world4
    got = _group(ranks, "jax/")[0]
    for k, v in loss_dict.items():
        np.testing.assert_allclose(got[f"scalars0/{k}"], v, rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(got["scalars0/total_loss"], total, rtol=1e-5)
    grads = {k[len("grads0/"):]: v for k, v in got.items()
             if k.startswith("grads0/")}
    for name, (g, w) in _grads_by_name(jgrads, grads).items():
        _check_grad(name, g, w)
    state = {k[len("state/"):]: torch.from_numpy(v) for k, v in got.items()
             if k.startswith("state/")}
    _check_stats(state, variables, stats, 3e-6)


# -- W = 2 ---------------------------------------------------------------------

def fit_cfg() -> dict:
    return tiny_cfg(0.5, ("PointCloudRotate",), BATCH_SIZE=B2, LOG_PERIOD=1,
                    CHECKPOINT_PERIOD=1)


FIT_BATCHES = 2        # per epoch


def _fit(mesh, out: str, epochs: int) -> dict:
    """`Trainer.fit` (resumed from `out` where it holds a checkpoint) to
    `epochs`: each step's scalars as `fit` logs them, how many
    checkpoints this process wrote, the final state."""
    tr = Trainer(t_cfg(fit_cfg()), output_dir=out, device="cpu", mesh=mesh,
                 steps_per_epoch=FIT_BATCHES)
    steps, saves = {}, []
    step, save = tr.train_step, tr.checkpointer.save

    def train_step(batch):
        key = str(tr.step)
        steps[key] = step(batch)
        return steps[key]

    tr.train_step = train_step
    tr.checkpointer.save = lambda *a: saves.append(1) or save(*a)
    data = [tiny_batch(B2, 10 + i, nf=8) for i in range(FIT_BATCHES)]
    final = tr.fit(data, max_epochs=epochs)
    return {"scalars": steps,
            "saves": len(saves), "step": final.step,
            "state": final.model, "generator": final.generator}


def _rank_train2(rank, world, init, tmp, single_out, data_dir):
    from s4g_tpu_torch.tools import train as train_cli
    mesh = _join(rank, world, init)
    res = {"types": {t: _type_step(t, mesh, os.path.join(tmp, "types"))
                     for t in MODEL_TYPES}}
    out = os.path.join(tmp, "fit")
    res["fit1"] = _fit(mesh, out, 1)
    res["fit2"] = _fit(mesh, out, 2)     # resumed from epoch 1
    tr = Trainer(t_cfg(fit_cfg()), output_dir=single_out, device="cpu",
                 mesh=mesh)
    res["from_single"] = tr.resume_or_init().model
    cli = os.path.join(tmp, "cli")
    state = train_cli.main(["--cfg", os.path.join(tmp, "cli.yaml"),
                            "--data-dir", data_dir, "--output", cli,
                            "--device", "cpu", "--max-epochs", "1",
                            "--num-frame-points", "16",
                            "--async-workers", "1"])
    res["cli"] = {"state": state.model, "generator": state.generator,
                  "step": state.step}
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **_flat("", res, {}))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """A single-process fit (its checkpoints the W = 2 ranks resume from),
    the train CLI's scenes and config, then the W = 2 group: (the ranks'
    results, the single fit's, the directory)."""
    import yaml
    from test_torch_port_train import write_scenes
    tmp = tmp_path_factory.mktemp("world2")
    single = _flat("", _fit(None, str(tmp / "single"), 2), {})
    write_scenes(str(tmp / "scenes"), 4, n=400, num_frames=40)
    cfg = fit_cfg()
    cfg["DATA"]["NUM_WORKERS"] = 1
    (tmp / "cli.yaml").write_text(yaml.safe_dump(_plain(cfg)))
    _spawn(_rank_train2, 2, tmp, str(tmp / "single"), str(tmp / "scenes"))
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]
    return ranks, single, tmp


def _plain(tree):
    """Tuples as lists, for a YAML file."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return [_plain(v) for v in tree]
    return tree


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_every_model_type_sharded_step_matches_single(world2, model_type,
                                                      tmp_path):
    """Each model type's float64 step (dropout on where the type has it)
    at W = 2 against the single step on the same global batch: the losses
    summed over the ranks within rtol 1e-12 (float64) or 1e-6 (the f32
    predictions' terms: every model's outputs come out in f32), each
    summed gradient within 1e-9 of its tensor's largest plus 1e-10 of the
    model's largest (the Dense biases before a train-mode BatchNorm have
    a zero gradient but for rounding).  GPD's and PointNetGPD's BatchNorm
    and dropout see the (B, G) rows folded."""
    ranks, _, _ = world2
    want = _flat("", _type_step(model_type, None, str(tmp_path)), {})
    top = max(float(np.abs(w).max()) for k, w in want.items()
              if k.startswith("grad/"))
    for got in _group(ranks, f"types/{model_type}/"):
        assert set(got) == set(want)
        for k, w in want.items():
            err = float(np.abs(got[k] - w).max())
            if k.startswith("loss/"):
                rtol = 1e-12 if w.dtype == np.float64 else 1e-6
                assert err <= rtol * abs(float(w)), (k, err, float(w))
            else:
                assert err <= 1e-9 * float(np.abs(w).max()) + 1e-10 * top, \
                    (k, err, float(np.abs(w).max()))


def test_gpd_metrics_take_global_counts(monkeypatch):
    """GPD's precision and recall within `global_batch` are the global
    batch's on each shard: each half of a batch, under a two-rank context
    whose all-reduce adds the other half's counts, gives the whole batch's
    values exactly (a half's own differ)."""
    from s4g_tpu_torch.models import gpd
    rng = np.random.RandomState(4)
    logits = torch.from_numpy(rng.randn(40, 3).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, 3, 40))

    def metric(rows):
        return gpd.gpd_metric({"grasp_logits": logits[rows]},
                              {"grasp_score_labels": labels[rows]})

    def counts(rows):
        pred = torch.argmax(logits[rows], dim=1) == 2
        gt = labels[rows] == 2
        return [torch.sum((gt & pred).float()), torch.sum(pred.float()),
                torch.sum(gt.float())]

    want = metric(slice(0, 40))
    halves = (slice(0, 20), slice(20, 40))
    for half in halves:
        own = metric(half)
        assert not torch.equal(own["prec"], want["prec"])
        assert not torch.equal(own["recall"], want["recall"])
    for mine, theirs in (halves, halves[::-1]):
        queue = counts(theirs)
        monkeypatch.setattr(pm, "all_reduce_sum",
                            lambda x, group: x + queue.pop(0))
        token = pm._GLOBAL_BATCH.set(pm._Ranks(None, 0, 2))
        try:
            got = metric(mine)
        finally:
            pm._GLOBAL_BATCH.reset(token)
        assert queue == []
        for k in ("prec", "recall"):
            assert torch.equal(got[k], want[k]), k


def test_fit_with_checkpoints_across_world_sizes(world2, tmp_path):
    """`Trainer.fit` at W = 2 for an epoch, then a new W = 2 Trainer resumed
    from its checkpoint for epoch 2: every logged scalar within rtol 2e-5
    of the single-process fit's (dropout 0.5, a rotation augmentation;
    the parameters are not compared: Adam turns the sign of a near-zero
    gradient into a full +/- lr); rank 0 wrote every checkpoint and rank 1
    none; both ranks end bit for bit equal.
    The W = 2 checkpoint loads into a one-device Trainer as exactly the
    ranks' state, and W = 2 ranks resume from the single fit's checkpoint
    as exactly its state."""
    ranks, single, tmp = world2
    for epoch, key in ((1, "fit1/"), (2, "fit2/")):
        got = _group(ranks, key)
        assert int(got[0]["saves"]) == 1 and int(got[1]["saves"]) == 0
        assert int(got[0]["step"]) == epoch * FIT_BATCHES
        for k, v in got[0].items():
            if k != "saves":
                np.testing.assert_array_equal(got[1][k], v, err_msg=k)
    steps = {k: v for key in ("fit1/", "fit2/")
             for k, v in _group(ranks, key)[0].items()
             if k.startswith("scalars/")}
    want = {k: v for k, v in single.items() if k.startswith("scalars/")}
    assert set(steps) == set(want) and len(want) > 4 * FIT_BATCHES
    for k, v in want.items():
        np.testing.assert_allclose(steps[k], v, rtol=2e-5, atol=1e-7,
                                   err_msg=k)
    final = _group(ranks, "fit2/")[0]
    # Across world sizes, both ways.
    one = Trainer(t_cfg(fit_cfg()), output_dir=str(tmp / "fit"),
                  device="cpu")
    loaded = one.resume_or_init()
    assert loaded.step == 2 * FIT_BATCHES
    for k, v in loaded.model.items():
        np.testing.assert_array_equal(v.numpy(), final[f"state/{k}"])
    np.testing.assert_array_equal(loaded.generator.numpy(),
                                  final["generator"])
    for got in _group(ranks, "from_single/"):
        for k, v in single.items():
            if k.startswith("state/"):
                np.testing.assert_array_equal(got[k[len("state/"):]], v)


def test_train_cli_runs_data_parallel(world2):
    """tools/train.py in a launched world of two CPU ranks: both ranks end
    on the same state after one epoch, and rank 0 alone wrote the one
    checkpoint (the output holds one model file)."""
    ranks, _, tmp = world2
    got = _group(ranks, "cli/")
    assert int(got[0]["step"]) == 1     # 4 scenes, a global batch of 4
    for k, v in got[0].items():
        np.testing.assert_array_equal(got[1][k], v, err_msg=k)
    assert sorted(f for f in os.listdir(tmp / "cli")
                  if f.endswith(".ckpt")) == ["model_001.ckpt"]

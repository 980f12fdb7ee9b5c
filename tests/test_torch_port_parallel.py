"""The port's data mesh (s4g_tpu_torch.parallel) and mesh serving
(`GraspDetector(mesh=...).detect_batch`) on CPU ranks, and the kernels'
one-device-per-process rule (`_build.launch`).

The ranks are spawned processes (torch.multiprocessing, start method
spawn) in a gloo group that meets through a file under the test's
directory, so no port is shared between test workers.  Their bodies are
this module's `_rank_*` functions: this module imports JAX only inside the
tests, so a rank imports none.  Each rank writes its results as an .npz
file; one group runs every case of its world size (W = 2, and a world of
one that no launcher made).
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
import yaml

from s4g_tpu_torch import _build
from s4g_tpu_torch.parallel import mesh as pm
from s4g_tpu_torch.pipeline import detector as tdet
from s4g_tpu_torch.pipeline import preprocessing as tpre

# tests/test_torch_port_detector.py's tiny model; the clouds (2,700
# points) fit a capacity of 4,096.
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
CAPACITY = 4096
CANDIDATES = 512
NUM_SELECTED = 5
THRESHOLDS = dict(score_threshold=0.0, verticalness_threshold=-1e9)


def clutter_cloud(rng, num_objects=6, n_per_object=450):
    """tests/test_torch_port_detector.py's camera-frame clutter."""
    centers = np.column_stack([rng.uniform(-0.25, 0.25, (num_objects, 2)),
                               rng.uniform(0.65, 0.75, num_objects)])
    centers[:, 0] = np.linspace(-0.3, 0.3, num_objects)
    pts = [c + rng.uniform(-0.02, 0.02, (n_per_object, 3)) for c in centers]
    return np.concatenate(pts).astype(np.float32)


def clouds(count, first=2):
    return [clutter_cloud(np.random.RandomState(s))
            for s in range(first, first + count)]


def _detector(tmp, name, state, mesh=None):
    return tdet.GraspDetector(
        model=os.path.join(tmp, "tiny.yaml"), device="cpu",
        output_dir=os.path.join(tmp, name), cloud_capacity=CAPACITY,
        num_candidates=CANDIDATES, state_dict=state, seed=5, mesh=mesh)


def _results(prefix, results, out):
    for i, (poses, scores) in enumerate(results):
        out[f"{prefix}/{i}/poses"] = poses
        out[f"{prefix}/{i}/scores"] = scores
    return out


class _Patched:
    """Replace `module.name` by `fn` inside the block."""

    def __init__(self, module, name, fn):
        self.module, self.name, self.fn = module, name, fn

    def __enter__(self):
        self.orig = getattr(self.module, self.name)
        setattr(self.module, self.name, self.fn)

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def _recording(samples, uniforms):
    """Patches that keep the detector's sample indices and importance
    uniforms as it draws them."""
    sample, draw = tpre.random_sample_fixed, tdet._uniforms

    def record_sample(*a, **k):
        samples.append(sample(*a, **k))
        return samples[-1]

    def record_uniforms(*a, **k):
        uniforms.append(draw(*a, **k))
        return uniforms[-1]

    return (_Patched(tpre, "random_sample_fixed", record_sample),
            _Patched(tdet, "_uniforms", record_uniforms))


def _replaying(samples, uniforms):
    """Patches that hand the detector the given sample indices (in
    order) and importance uniforms instead of drawing them."""
    queue = list(samples)
    return (_Patched(tpre, "random_sample_fixed",
                     lambda *a, **k: queue.pop(0)),
            _Patched(tdet, "_uniforms", lambda *a, **k: uniforms))


def _run(patches, fn):
    with patches[0], patches[1]:
        return fn()


def _spawn(body, world, tmp, *args):
    mp.start_processes(body, args=(world, str(tmp / "rendezvous"),
                                   str(tmp), *args),
                       nprocs=world, start_method="spawn")


# -- W = 2 ---------------------------------------------------------------------

def _rank_serving(rank, world, init, tmp):
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world)
    mesh = pm.make_mesh(["cpu"] * world)
    state = torch.load(os.path.join(tmp, "state.pt"))
    out = {"rows/points": pm.shard_batch(mesh, {"p": np.arange(
        12, dtype=np.int32).reshape(4, 3)})["p"],
           "rows/frames": pm.shard_batch(mesh, {"f": torch.arange(
               16.0).reshape(4, 2, 2)})["f"]}
    try:
        pm.shard_rows(mesh, 3)
    except ValueError:
        out["rows/uneven_refused"] = 1

    # detect runs on the rank alone, as without a mesh.
    det = _detector(tmp, f"det{rank}", state, mesh)
    plain = _detector(tmp, f"plain{rank}", state)
    cloud = clutter_cloud(np.random.RandomState(9))
    _results("detect", [det.detect(cloud, **THRESHOLDS)], out)
    _results("detect_plain", [plain.detect(cloud, **THRESHOLDS)], out)

    # The sharded B = 4 call, its draws recorded, then a single process's
    # call over this rank's two scenes on those draws.
    det = _detector(tmp, f"det{rank}", state, mesh)
    samples, uniforms = [], []
    results = _run(_recording(samples, uniforms), lambda: det.detect_batch(
        clouds(4), num_selected=NUM_SELECTED, **THRESHOLDS))
    _results("sharded", results, out)
    out["sharded/num_valid"] = np.asarray(det.last_num_valid)
    out["sharded/timings"] = np.asarray(sorted(det.timings))
    rows = pm.shard_rows(mesh, 4)
    single = _detector(tmp, f"single{rank}", state)
    _results("replayed", _run(
        _replaying(samples, uniforms[0][rows]),
        lambda: single.detect_batch(clouds(4)[rows],
                                    num_selected=NUM_SELECTED,
                                    **THRESHOLDS)), out)

    # An uneven batch is refused before any draw.
    before = det.generator.get_state()
    try:
        det.detect_batch(clouds(3), **THRESHOLDS)
    except ValueError:
        out["uneven_refused"] = int(torch.equal(det.generator.get_state(),
                                                before))

    # B = 2 on JAX's draws: this rank's post-processing outputs.
    jax_draws = np.load(os.path.join(tmp, "jax_draws.npz"))
    posts = []
    post = tdet.post_batch
    with _Patched(tdet, "post_batch",
                  lambda *a, **k: posts.append(post(*a, **k)) or posts[-1]):
        _run(_replaying([torch.from_numpy(s) for s in
                         jax_draws["sample_idx"][rank:rank + 1]],
                        torch.from_numpy(jax_draws["uniforms"])),
             lambda: _detector(tmp, f"jax{rank}", state, mesh).detect_batch(
                 clouds(2), num_selected=NUM_SELECTED, **THRESHOLDS))
    for k, v in posts[0].items():
        out[f"jax/{k}"] = v.numpy()
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **{
        k: v.numpy() if isinstance(v, torch.Tensor) else v
        for k, v in out.items()})
    dist.destroy_process_group()


def _jax_mesh_detect(tmp):
    """JAX's detect_batch program built on a 2-device mesh (shard_map), at
    B = 2, and its draws replayed from its per-scene keys, as
    tests/test_torch_port_detector.py replays the unsharded program's."""
    import jax
    import jax.numpy as jnp
    from s4g_tpu.configs.config import load_cfg_from_file
    from s4g_tpu.models import build_model
    from s4g_tpu.parallel.mesh import make_mesh
    from s4g_tpu.pipeline import postprocessing as jpost
    from s4g_tpu.pipeline import preprocessing as jpre
    from s4g_tpu.pipeline.detector import GraspDetector as JaxDetector
    # The detector's random init, jitted (flax's eager init takes ~20 s).
    net = build_model(load_cfg_from_file(str(tmp / "tiny.yaml")))[0]
    variables = jax.jit(lambda key: net.init(key, {"scene_points": jnp.zeros(
        (1, 3, 512), jnp.float32)}, train=False))(jax.random.key(0))
    jdet = JaxDetector(model=str(tmp / "tiny.yaml"), output_dir=str(tmp),
                       cloud_capacity=CAPACITY, num_candidates=CANDIDATES,
                       variables=variables, mesh=make_mesh(jax.devices()[:2]))
    padded, valid = (jnp.stack(a) for a in
                     zip(*(jdet._pad_cloud(c) for c in clouds(2))))
    variables = jax.tree.map(np.asarray, jdet.variables)
    keys = jax.random.split(jax.random.key(321), 2)
    want = jax.tree.map(np.asarray, jdet._detect_batch_fn(
        variables, padded, valid, keys, THRESHOLDS["score_threshold"],
        THRESHOLDS["verticalness_threshold"], NUM_SELECTED, True))
    ks = jax.vmap(jax.random.split)(keys)
    sample_idx, uniforms = [], []
    for i in range(2):
        train = jnp.matmul(padded[i], jnp.asarray(jpost.REAL2TRAIN[:3, :3]).T)
        pre = jpre.preprocess_cloud(train, ks[i, 0], num_points=512,
                                    capacity=CAPACITY)
        sample_idx.append(np.asarray(jpre.random_sample_fixed(
            ks[i, 0], pre.raw_valid, 512)))
        uniforms.append(np.asarray(jax.random.uniform(ks[i, 1],
                                                      (NUM_SELECTED,))))
    np.savez(tmp / "jax_draws.npz", sample_idx=np.stack(sample_idx),
             uniforms=np.stack(uniforms))
    return variables, want


@pytest.fixture(scope="module")
def serving(tmp_path_factory):
    """JAX's mesh program and its draws, then the W = 2 group from the
    same weights: (the ranks' results, JAX's outputs, the directory)."""
    from s4g_tpu_torch.utils.weights import state_dict_from_flax
    tmp = tmp_path_factory.mktemp("serving")
    (tmp / "tiny.yaml").write_text(yaml.safe_dump(TINY))
    variables, want = _jax_mesh_detect(tmp)
    torch.save(state_dict_from_flax(variables), tmp / "state.pt")
    _spawn(_rank_serving, 2, tmp)
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]
    return ranks, want, tmp


def _scenes(npz, prefix, count):
    return [(npz[f"{prefix}/{i}/poses"], npz[f"{prefix}/{i}/scores"])
            for i in range(count)]


def test_shard_batch_rows_at_two_ranks(serving):
    """Rank r holds rows 2r and 2r + 1 of every leaf, numpy or tensor, in
    its dtype; a batch of 3 does not split over 2 ranks and is refused."""
    ranks, _, _ = serving
    points = np.arange(12, dtype=np.int32).reshape(4, 3)
    frames = np.arange(16.0, dtype=np.float32).reshape(4, 2, 2)
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["rows/points"], points[2 * r:
                                                                 2 * r + 2])
        assert got["rows/points"].dtype == np.int32
        np.testing.assert_array_equal(got["rows/frames"], frames[2 * r:
                                                                 2 * r + 2])
        assert int(got["rows/uneven_refused"]) == 1


def test_detect_is_unaffected_by_the_mesh(serving):
    ranks, _, _ = serving
    for got in ranks:
        for a, b in zip(_scenes(got, "detect", 1),
                        _scenes(got, "detect_plain", 1)):
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])


def test_sharded_detect_batch_matches_unsharded(serving):
    """detect_batch over 4 scenes at W = 2: every rank returns all four in
    input order, bit for bit the unsharded call's (the same draws: each
    rank draws the whole batch's in its order), with the whole batch's
    valid counts; each rank's scenes are bit for bit a single process's
    detect_batch over them on the draws the rank used."""
    ranks, _, tmp = serving
    state = torch.load(tmp / "state.pt")
    det = _detector(str(tmp), "unsharded", state)
    want = det.detect_batch(clouds(4), num_selected=NUM_SELECTED,
                            **THRESHOLDS)
    assert sum(len(p) for p, _ in want) > 0
    for r, got in enumerate(ranks):
        for (p, s), (wp, ws) in zip(_scenes(got, "sharded", 4), want):
            np.testing.assert_array_equal(p, wp)
            np.testing.assert_array_equal(s, ws)
        np.testing.assert_array_equal(got["sharded/num_valid"],
                                      det.last_num_valid)
        assert "gather_ms" in set(got["sharded/timings"])
        for (p, s), (wp, ws) in zip(_scenes(got, "replayed", 2),
                                    _scenes(got, "sharded", 4)[2 * r:]):
            np.testing.assert_array_equal(p, wp)
            np.testing.assert_array_equal(s, ws)


def test_uneven_batch_is_refused_before_any_work(serving):
    ranks, _, _ = serving
    for got in ranks:
        assert int(got["uneven_refused"]) == 1


def test_sharded_detect_batch_matches_jax_mesh_program(serving):
    """detect_batch over 2 scenes at W = 2 on the JAX mesh program's draws
    against that program (shard_map over a 2-device mesh): each rank's
    post-processing outputs against its row, as
    tests/test_torch_port_detector.py holds `detect`'s (scores within an
    ulp, poses within 1e-4, validity and the importance draws exact)."""
    from test_torch_port_detector import _pair_candidates
    ranks, want, _ = serving
    for r, got in enumerate(ranks):
        g = {k[len("jax/"):]: v[0] for k, v in got.items()
             if k.startswith("jax/")}
        w = {k: v[r] for k, v in want.items()}
        perm = _pair_candidates(g, w)
        np.testing.assert_array_max_ulp(g["scores"], w["scores"], maxulp=1)
        np.testing.assert_allclose(g["poses"], w["poses"][perm], atol=1e-4)
        np.testing.assert_array_equal(g["valid"], w["valid"][perm])
        np.testing.assert_array_equal(g["selected"], w["selected"])
        assert 0 < int(g["num_valid"]) < CANDIDATES


# -- a world of one ------------------------------------------------------------

def _rank_world_of_one(rank, world, init, tmp):
    """No process group and no launcher: make_mesh makes the world of
    one.  detect_batch and two train steps with and without it."""
    from test_torch_port_parallel_train import _flat, _steps, tiny_batch, \
        tiny_cfg
    mesh = pm.make_mesh(["cpu"])
    out = {"world": dist.get_world_size(), "backend": dist.get_backend()}
    state = torch.load(os.path.join(tmp, "state.pt"))
    for name, m in (("mesh", mesh), ("plain", None)):
        det = _detector(tmp, name, state, m)
        _results(f"{name}/detect_batch", det.detect_batch(
            clouds(2), num_selected=NUM_SELECTED, **THRESHOLDS), out)
        _flat(f"{name}/train/", _steps(
            m, tiny_cfg(0.5, ("PointCloudRotate",)),
            [tiny_batch(4, s) for s in range(2)],
            os.path.join(tmp, name)), out)
    np.savez(os.path.join(tmp, "rank0.npz"), **out)


def test_world_of_one_is_bit_exact(tmp_path):
    """A mesh outside a launched world is a gloo world of one; under it
    detect_batch and two train steps (dropout and augmentation on) are
    bit for bit what they are without a mesh: outputs, scalars,
    gradients, parameters, buffers and the generator."""
    (tmp_path / "tiny.yaml").write_text(yaml.safe_dump(TINY))
    torch.save(_detector(str(tmp_path), "init", None).net.state_dict(),
               tmp_path / "state.pt")
    _spawn(_rank_world_of_one, 1, tmp_path)
    got = dict(np.load(tmp_path / "rank0.npz"))
    assert int(got["world"]) == 1 and str(got["backend"]) == "gloo"
    mesh = {k[len("mesh/"):]: v for k, v in got.items()
            if k.startswith("mesh/")}
    plain = {k[len("plain/"):]: v for k, v in got.items()
             if k.startswith("plain/")}
    assert set(mesh) == set(plain) and len(mesh) > 20
    for k, v in plain.items():
        np.testing.assert_array_equal(mesh[k], v, err_msg=k)


# -- the mesh's refusals and helpers, in this process ----------------------------

def test_make_mesh_refuses_missing_gpus(monkeypatch):
    """A rank on a GPU this host lacks raises before any process group is
    made: with no GPU at all, and past the host's count."""
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no GPU is available"):
        pm.make_mesh(["cuda:0"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="has 1 GPU"):
        pm.make_mesh(["cuda:1"])
    assert not dist.is_initialized()


@pytest.mark.parametrize("devices,match", [
    (["cpu", "cpu"], "2 devices for a world of 1"),
    (["cuda"], "with its index"),
    (["meta"], "all 'cpu' or all"),
])
def test_make_mesh_refuses_malformed_devices(devices, match):
    with pytest.raises(ValueError, match=match):
        pm.make_mesh(devices)


@pytest.mark.parametrize("devices,backend", [
    (None, "nccl"), (["cuda:0", "cuda:1"], "nccl"),
    (["cuda:0", "cuda:0"], "gloo"), (["cpu", "cpu"], "gloo")])
def test_backend_choice(devices, backend):
    """NCCL where every rank owns a distinct GPU; gloo for CPU ranks and
    ranks that share a card (NCCL refuses two ranks on one GPU)."""
    listed = None if devices is None else pm._devices(devices, len(devices))
    assert pm._backend(listed)[0] == backend


def test_global_batch_helpers_are_inert_outside_the_context():
    """Outside `global_batch` (and within one of mesh None) the helpers are
    the single-process operations; no mesh is made in a world of one."""
    x = torch.arange(6.0).reshape(3, 2)
    g = torch.Generator().manual_seed(0)
    want = torch.rand((3, 2), generator=torch.Generator().manual_seed(0))
    with pm.global_batch(None):
        assert pm.global_ranks() is None
        assert torch.equal(pm.global_rows(
            lambda s: torch.rand(s, generator=g), (3, 2)), want)
        assert pm.sum_over_ranks(x) is x
        assert torch.equal(pm.batch_mean(x), torch.mean(x))
    assert pm.launched_mesh("cpu") is None


def test_launch_keeps_one_device_per_process(monkeypatch):
    """`_build.launch` takes tensors on one CUDA device, and a process
    launches on one GPU: the first launch's; another raises and names the
    per-process caches."""
    monkeypatch.setattr(_build, "_launch_device", [])
    with pytest.raises(ValueError, match="one CUDA device"):
        _build.launch("fps_lane", torch.zeros(3), 1)
    assert _build._launch_device == []
    first = torch.device("cuda", 0)
    _build.claim_device("fps_lane", first)
    _build.claim_device("three_nn", torch.device("cuda", 0))
    with pytest.raises(RuntimeError, match="SM count.*one process runs "
                                           "one GPU"):
        _build.claim_device("three_nn", torch.device("cuda", 1))
    assert _build._launch_device == [first]

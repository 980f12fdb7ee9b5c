"""The rest of the port's serving API against its own sequential path and
the JAX package: `GraspDetector.detect_stream`, checkpoints and weight
loading (`utils.checkpoint`, TEST.WEIGHT, `last_checkpoint`), and the two
model settings `nn_layers.SA1_FUSE` and `nn_layers.CAST_ACTIVATIONS`.

Synthetic clouds from a numpy seed, the tiny model recipe of
tests/test_torch_port_detector.py, on the CPU."""

import functools
import os
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from s4g_tpu.configs.config import load_cfg_from_dict as j_cfg
from s4g_tpu.models import build_model as j_build
from s4g_tpu.models import nn_layers as jnn
from s4g_tpu.pipeline import postprocessing as jpost
from s4g_tpu.pipeline import preprocessing as jpre
from s4g_tpu.pipeline.detector import GraspDetector as JaxDetector

from s4g_tpu_torch.configs.config import load_cfg_from_dict as t_cfg
from s4g_tpu_torch.models import build_model as t_build
from s4g_tpu_torch.models import nn_layers as tnn
from s4g_tpu_torch.ops import sa_fused as sf
from s4g_tpu_torch.pipeline import detector as tdet
from s4g_tpu_torch.utils.checkpoint import (Checkpointer,
                                            load_torch_checkpoint)
from s4g_tpu_torch.utils.weights import state_dict_from_flax

from test_torch_port_detector import TINY, TINY_FUSED, _t, clutter_cloud
from test_torch_port_model import _perturb

CAPACITY = 8192
KW = {"score_threshold": 0.0, "verticalness_threshold": -1e9}
# A fresh contact model puts every grasp origin on its point, where the
# gripper hits the cloud: its stream runs without the collision check.
STREAM_KW = {"PN2_CLS": KW, "PN2": {**KW, "collision_check": False}}


def _write_cfg(path, cfg, weight=None):
    cfg = {**cfg, "TEST": {**cfg.get("TEST", {}),
                           **({"WEIGHT": weight} if weight else {})}}
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _contact(cfg):
    return {**cfg, "MODEL": {**cfg["MODEL"], "TYPE": "PN2"}}


def _detector(cfg_file, out_dir, seed=0, **kw):
    return tdet.GraspDetector(model=cfg_file, device="cpu",
                              output_dir=str(out_dir),
                              cloud_capacity=CAPACITY, num_candidates=64,
                              seed=seed, **kw)


# -- detect_stream ------------------------------------------------------------------

FRAMES = [clutter_cloud(np.random.RandomState(s)) for s in (11, 12, 13)]


@functools.lru_cache(maxsize=None)
def _sequential(model_type: str, tmp: str):
    """Sequential `detect` over FRAMES on a fresh seed-0 detector: each
    frame's (poses, scores, num_valid)."""
    cfg = TINY if model_type == "PN2_CLS" else _contact(TINY)
    os.makedirs(tmp, exist_ok=True)
    det = _detector(_write_cfg(Path(tmp) / "seq.yaml", cfg), tmp)
    out = []
    for frame in FRAMES:
        poses, scores = det.detect(frame, **STREAM_KW[model_type])
        out.append((poses, scores, det.last_num_valid))
    return out


@pytest.mark.parametrize("model_type,depth,frames", [
    ("PN2_CLS", 1, 3), ("PN2_CLS", 2, 3), ("PN2_CLS", 3, 3),
    ("PN2_CLS", 4, 2),                  # fewer frames than depth
    ("PN2", 2, 3),                      # the contact model
])
def test_detect_stream_equals_sequential_detect(tmp_path_factory, model_type,
                                                depth, frames):
    """Frame for frame, exactly, what `detect` gives on a detector with
    the same seed; one frame given as (3, n)."""
    want = _sequential(model_type, str(tmp_path_factory.getbasetemp()
                                       / f"seq_{model_type}"))
    cfg = TINY if model_type == "PN2_CLS" else _contact(TINY)
    out = tmp_path_factory.mktemp("stream")
    det = _detector(_write_cfg(out / "s.yaml", cfg), out)
    clouds = [FRAMES[0].T] + FRAMES[1:frames]
    got = []
    for poses, scores in det.detect_stream(iter(clouds), depth=depth,
                                           **STREAM_KW[model_type]):
        got.append((poses, scores, det.last_num_valid))
    assert len(got) == frames
    assert len(det.timings["frame_ms"]) == frames
    for (gp, gs, gn), (wp, ws, wn) in zip(got, want):
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_array_equal(gs, ws)
        assert gn == wn and len(gp) == min(wn, 5) > 0
    with pytest.raises(ValueError, match="depth"):
        next(det.detect_stream(clouds, depth=0))


def test_detect_debug_writes_scores_and_poses(tmp_path):
    det = _detector(_write_cfg(tmp_path / "t.yaml", TINY), tmp_path)
    poses, scores = det.detect(FRAMES[0], debug=True, **KW)
    dbg = tmp_path / "debug"
    np.testing.assert_allclose(np.loadtxt(dbg / "top_scores.txt", ndmin=1),
                               scores, atol=1e-4)
    np.testing.assert_allclose(
        np.loadtxt(dbg / "processed_mat44.txt", ndmin=2).reshape(-1, 4, 4),
        poses, atol=1e-4)


# -- checkpoints --------------------------------------------------------------------

def _state(seed):
    """A seeded port state_dict of the tiny PN2_CLS."""
    torch.manual_seed(seed)
    return t_build(t_cfg(TINY)).state_dict()


def _same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_checkpointer_save_load_and_last_checkpoint(tmp_path):
    ck = Checkpointer(str(tmp_path / "ck"))
    assert not ck.has_checkpoint() and ck.load() is None
    states = [{"model": _state(s), "optimizer": {
        "state": {0: {"exp_avg": torch.full((2,), float(s))}},
        "param_groups": [{"lr": 0.1 * s, "params": [0]}]},
        "extra": {"epoch": s}} for s in (1, 2)]
    p1 = ck.save("model_001", states[0])
    assert ck.has_checkpoint() and ck.last_checkpoint_path() == p1
    assert p1.endswith("model_001.ckpt") and os.path.isfile(p1)
    p2 = ck.save("model_002", states[1])
    assert ck.last_checkpoint_path() == p2
    for got, want in ((ck.load(), states[1]),
                      (ck.load(p1, resume=False), states[0]),
                      (Checkpointer(str(tmp_path / "none")).load(p1),
                       states[0])):
        assert _same(got["model"], want["model"])
        assert got["extra"] == want["extra"]
        assert torch.equal(got["optimizer"]["state"][0]["exp_avg"],
                           want["optimizer"]["state"][0]["exp_avg"])
    assert Checkpointer("").save("x", states[0]) == ""


@pytest.mark.parametrize("case", ["orbax directory", "pickled object"])
def test_unreadable_checkpoints_are_refused(tmp_path, case):
    """An orbax checkpoint (a directory) names the way across; a file that
    pickles objects other than tensors and containers is refused by
    `weights_only=True`."""
    if case == "orbax directory":
        path = tmp_path / "model_010.ckpt"
        (path / "default").mkdir(parents=True)
        match = "state_dict_from_flax"
    else:
        path = tmp_path / "model.pth"
        torch.save({"model": _state(1),
                    "scheduler": functools.partial(max, 0)}, path)
        match = "weights_only"
    with pytest.raises(ValueError, match=match):
        load_torch_checkpoint(str(path))
    with pytest.raises(ValueError, match=match):
        Checkpointer(str(tmp_path)).load(str(path), resume=False)


def test_module_prefixed_pth_loads(tmp_path):
    """A reference `.pth`: {"model": state_dict} with DataParallel's
    "module." prefixes, beside other entries."""
    sd = _state(4)
    path = tmp_path / "reference.pth"
    torch.save({"model": {f"module.{k}": v for k, v in sd.items()},
                "epoch": 7}, path)
    assert _same(load_torch_checkpoint(str(path)), sd)
    det = _detector(_write_cfg(tmp_path / "t.yaml", TINY, str(path)),
                    tmp_path / "out")
    assert _same(det.net.state_dict(), sd)


@pytest.mark.parametrize("case", [
    "state_dict", "weight pth", "weight ckpt", "project home",
    "weight missing", "last checkpoint", "random init"])
def test_weights_resolve_in_jax_order(tmp_path, caplog, case):
    """An explicit state_dict, else TEST.WEIGHT (`${PROJECT_HOME}` the
    package directory; `.pth` as a reference file, anything else as a
    checkpoint; a missing file warns), else `output_dir/last_checkpoint`,
    else the random init from the seed (JAX `detector.py:105-124`)."""
    explicit, weight, last = _state(3), _state(1), _state(2)
    out = tmp_path / "out"
    Checkpointer(str(out)).save("model_002", {"model": last})
    pth = tmp_path / "weights.pth"
    torch.save({"model": weight}, pth)
    ckpt = Checkpointer(str(tmp_path / "other")).save("w", {"model": weight})
    home = os.path.join(os.path.dirname(tdet.__file__), "..")
    given, kw, want = {
        "state_dict": (str(pth), {"state_dict": explicit}, explicit),
        "weight pth": (str(pth), {}, weight),
        "weight ckpt": (ckpt, {}, weight),
        "project home": ("${PROJECT_HOME}/" + os.path.relpath(pth, home),
                         {}, weight),
        "weight missing": (str(tmp_path / "missing.pth"), {}, last),
        "last checkpoint": (None, {}, last),
        "random init": (None, {}, None),
    }[case]
    if case == "random init":
        out = tmp_path / "empty"
        torch.manual_seed(0)
        want = t_build(t_cfg(TINY)).state_dict()
    with caplog.at_level("WARNING"):
        det = _detector(_write_cfg(tmp_path / "t.yaml", TINY, given), out,
                        **kw)
    assert _same(det.net.state_dict(), want)
    assert ("not found" in caplog.text) == (case == "weight missing")


@pytest.mark.parametrize("model_type", ["PN2_CLS", "PN2"])
def test_port_pth_gives_jax_detector_the_same_predictions(tmp_path,
                                                           model_type):
    """A `.pth` written by the port, read by the JAX detector through
    TEST.WEIGHT (`import_torch_checkpoint`): its `eval` equals the port's
    `eval` on the JAX draws (f32, atol 1e-4)."""
    cfg = TINY if model_type == "PN2_CLS" else _contact(TINY)
    port = _detector(_write_cfg(tmp_path / "p.yaml", cfg), tmp_path / "p",
                     seed=5)
    with torch.no_grad():
        port.net.t_logit.weight.normal_(0.0, 0.01)
        port.net.t_logit.bias.normal_(0.0, 0.002)
    pth = tmp_path / "port.pth"
    torch.save({"model": port.net.state_dict()}, pth)

    jdet = JaxDetector(model=_write_cfg(tmp_path / "j.yaml", cfg, str(pth)),
                       output_dir=str(tmp_path / "j"),
                       cloud_capacity=CAPACITY, num_candidates=64)
    cloud = FRAMES[1]
    _, sub = jax.random.split(jdet._key)
    want = jdet.eval(cloud)
    padded, _ = jdet._pad_cloud(cloud)
    train = jnp.matmul(padded, jnp.asarray(jpost.REAL2TRAIN[:3, :3]).T)
    pre = jpre.preprocess_cloud(train, sub, num_points=512,
                                capacity=CAPACITY)
    sample_idx = jpre.random_sample_fixed(sub, pre.raw_valid, 512)
    got = port.eval(cloud, sample_idx=_t(sample_idx))
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w), atol=1e-4,
                                   err_msg=k)


# -- SA1_FUSE and CAST_ACTIVATIONS ---------------------------------------------------

def _model_pair(cfg, b):
    """(jax net, variables, port net, cloud (b, 3, N)) on the same
    perturbed weights."""
    jnet, _, _ = j_build(j_cfg(cfg))
    rng = np.random.RandomState(7)
    n = cfg["MODEL"]["PN2"]["NUM_INPUT"]
    cloud = (rng.rand(b, 3, n) * [[[0.3], [0.2], [0.1]]]).astype(np.float32)
    variables = jnet.init(jax.random.key(0),
                          {"scene_points": jnp.asarray(cloud)}, train=False)
    variables = _perturb(jax.tree.map(np.asarray, dict(variables)), rng)
    tnet = t_build(t_cfg(cfg))
    tnet.load_state_dict(state_dict_from_flax(variables))
    return jnet, variables, tnet, cloud


def _forward_both(jnet, variables, tnet, cloud, monkeypatch):
    calls = []
    fused = sf.sa1_fused_slab
    monkeypatch.setattr(sf, "sa1_fused_slab",
                        lambda *a, **kw: calls.append(1) or fused(*a, **kw))
    want = jnet.apply(variables, {"scene_points": jnp.asarray(cloud)},
                      train=False)
    got = tnet({"scene_points": _t(cloud)})
    return ({k: np.asarray(v) for k, v in want.items()},
            {k: v.numpy() for k, v in got.items()}, len(calls))


def _assert_close(got, want, bf16):
    for k, w in want.items():
        if bf16:   # the bf16 tolerances of tests/test_sa_fused.py
            np.testing.assert_allclose(got[k], w, atol=5e-2, err_msg=k)
            assert float(np.abs(got[k] - w).mean()) < 5e-3, k
        else:
            np.testing.assert_allclose(got[k], w, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("setting,jax_setting,b,launches", [
    ("1", "interpret", 1, 1),   # K3 at b = 1
    ("0", "0", 2, 0),           # K2 at b = 2
])
def test_sa1_fuse_matches_jax(monkeypatch, setting, jax_setting, b,
                              launches):
    """`SA1_FUSE` against JAX's `ENV_SA1_FUSE` ("1" fuses only on a TPU
    there, so the JAX side runs the kernel in interpret mode): the fused
    stage at b = 1 (K3's twin once; it rounds hidden activations to bf16,
    so bf16 tolerances) and the unfused one at b = 2 (f32, atol 1e-4)."""
    monkeypatch.setattr(jnn, "ENV_SA1_FUSE", jax_setting)
    monkeypatch.setattr(tnn, "SA1_FUSE", setting)
    want, got, calls = _forward_both(*_model_pair(TINY_FUSED, b),
                                     monkeypatch)
    assert calls == launches
    _assert_close(got, want, bf16=launches > 0)


def test_sa1_fuse_refuses_other_values(monkeypatch):
    monkeypatch.setattr(tnn, "SA1_FUSE", "interpret")
    with pytest.raises(ValueError, match="SA1_FUSE"):
        tnn.sa1_fuse_wanted(1)


@pytest.mark.parametrize("b", [1, 2])
def test_cast_activations_matches_jax(monkeypatch, b):
    """`CAST_ACTIVATIONS` against JAX's `ENV_CAST_ACTIVATIONS` on a bf16
    backbone: every PointConv hands on bf16; at b = 2 SA1 is the fused
    stage on both sides (K3's twin; JAX in interpret mode).  bf16
    tolerances; the setting must change the port's outputs."""
    cfg = {**TINY_FUSED, "MODEL": {**TINY_FUSED["MODEL"],
                                   "COMPUTE_DTYPE": "bfloat16"}}
    pair = _model_pair(cfg, b)
    monkeypatch.setattr(jnn, "ENV_SA1_FUSE", "interpret")
    monkeypatch.setattr(jnn, "ENV_CAST_ACTIVATIONS", True)
    plain = pair[2]({"scene_points": _t(pair[3])})
    monkeypatch.setattr(tnn, "CAST_ACTIVATIONS", True)
    want, got, calls = _forward_both(*pair, monkeypatch)
    assert calls == (b >= 2)
    _assert_close(got, want, bf16=True)
    assert any(not np.array_equal(got[k], plain[k].numpy()) for k in got)
    layer = pair[2].fp_modules[0].mlp[0]
    assert layer(torch.rand(4, layer.conv.in_channels)).dtype == torch.bfloat16

"""The port's entry points (s4g_tpu_torch.tools) run on the CPU at a tiny
config: each `main(argv)` with `--device cpu` (the recipe of
tests/test_pipeline.py::test_detector_end_to_end_tiny), on synthetic scene
pickles in the training dump format.  Without `--device cpu` a tool needs
a GPU.  The tools' numbers here are CPU timings: only their keys and
artifacts are checked."""

import json
import os

import numpy as np
import pytest
import torch
import yaml

from s4g_tpu_torch.tools import (datagen_mesh_qa, demo_full_system,
                                 detect_qa, grasp_proposal_test,
                                 measure_batch, measure_fps_sharded,
                                 measure_stream, parity_at_speed,
                                 pick_grasp_viewer, profile_stages,
                                 trace_forward, train, train_at_scale,
                                 visualize_scored_grasp)
from s4g_tpu_torch.utils.checkpoint import Checkpointer

from test_torch_port_train import write_scenes

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
    "DATA": {"SCORE_CLASSES": 3, "NUM_WORKERS": 1},
    "TEST": {"BATCH_SIZE": 1},
    "TRAIN": {"BATCH_SIZE": 2},
    "SCHEDULER": {"MAX_EPOCH": 1},
}
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The tiny config's YAML, four scene pickles (3,000-point clouds with
    100 labeled frames each) and two of them again in a validation
    directory of their own."""
    root = tmp_path_factory.mktemp("tools")
    cfg = root / "tiny.yaml"
    cfg.write_text(yaml.safe_dump(TINY))
    write_scenes(str(root / "data"), 4, n=3000, num_frames=100)
    write_scenes(str(root / "val"), 2, n=3000, num_frames=100)
    return {"cfg": str(cfg), "data": str(root / "data"),
            "val": str(root / "val"),
            "scene": str(root / "data" / "0_view_0.p")}


def test_train_writes_a_checkpoint(files, tmp_path, monkeypatch):
    from s4g_tpu_torch.train.trainer import Trainer
    val_batches, real = [], Trainer.val_step

    def val_step(self, batch):
        val_batches.append(batch["scene_points"].shape[0])
        return real(self, batch)

    monkeypatch.setattr(Trainer, "val_step", val_step)
    out = str(tmp_path / "out")
    state = train.main(["--cfg", files["cfg"], "--data-dir", files["data"],
                        "--val-dir", files["val"], "--output", out,
                        "--num-frame-points", "64", *CPU])
    assert state.step == 2                       # 4 scenes, batch 2
    assert val_batches == [2]                    # 2 validation scenes
    ckpt = Checkpointer(out)
    assert ckpt.has_checkpoint()
    assert ckpt.last_checkpoint_path().endswith("model_001.ckpt")
    saved = ckpt.load(None, resume=True)
    for k, v in state.model.items():
        assert torch.equal(saved["model"][k], v), k


def test_grasp_proposal_test_writes_its_artifacts(files, tmp_path,
                                                  monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "out"
    got = grasp_proposal_test.main(["--scene", files["scene"], "--output",
                                    str(out), "--model", files["cfg"], *CPU])
    assert got["device"] == "cpu" and got["forward_ms"] > 0
    assert 0 < got["num_poses"] <= 50
    step = out / "test_step00000"
    for name in ("scene_points.xyz", "scene_score_logits.txt",
                 "pred_frame_R.txt", "pred_frame_t.txt",
                 "pred_scene_score.txt", "pred_pts.ply", "cloud.ply",
                 "top_hands.ply"):
        assert (step / name).stat().st_size > 0, name
    assert np.loadtxt(step / "scene_points.xyz").shape == (512, 3)
    assert np.load(out / "top_frames.npy").shape == (got["num_poses"], 4, 4)
    for log in ("inference_time_ours.txt", "postprocess_time_ours.txt"):
        assert len((tmp_path / log).read_text().splitlines()) == 1
    assert any(f.startswith("log.unit_test") for f in os.listdir(out))


def test_load_static_data_batch_is_seeded(files):
    gen = torch.Generator()
    gen.manual_seed(0)
    a = grasp_proposal_test.load_static_data_batch(files["scene"], 256, gen)
    gen.manual_seed(0)
    b = grasp_proposal_test.load_static_data_batch(files["scene"], 256, gen)
    assert a["scene_points"].shape == (1, 3, 256)
    assert torch.equal(a["scene_points"], b["scene_points"])


_BATCH_KEYS = {"batch", "fwd_ms_per_scene", "e2e_ms_per_scene",
               "scenes_per_sec", "device", "input", "sort_points",
               "fps_shards"}


@pytest.mark.parametrize("b,scene", [(1, True), (2, False)])
def test_measure_batch_prints_its_keys(files, capsys, b, scene):
    argv = [str(b), "--cfg", files["cfg"], *CPU] + (
        ["--scene", files["scene"]] if scene else [])
    got = measure_batch.main(argv)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == got and set(line) == _BATCH_KEYS
    assert line["batch"] == b and line["device"] == "cpu"
    assert line["input"] == (files["scene"] if scene else "random")
    assert line["e2e_ms_per_scene"] > 0


def test_measure_batch_reads_the_sort_settings(files, monkeypatch):
    monkeypatch.setenv("S4G_SORT_POINTS", "0")
    cfg = measure_batch.load_config(files["cfg"])
    assert not cfg.MODEL.PN2.SORT_POINTS and cfg.MODEL.PN2.FPS_SHARDS == 1
    monkeypatch.setenv("S4G_SORT_POINTS", "1")
    monkeypatch.setenv("S4G_FPS_SHARDS", "8")
    cfg = measure_batch.load_config(files["cfg"])
    assert cfg.MODEL.PN2.SORT_POINTS and cfg.MODEL.PN2.FPS_SHARDS == 8


def test_measure_stream_prints_its_keys(files, tmp_path, capsys,
                                       monkeypatch):
    monkeypatch.setattr(measure_stream, "CAPACITY", 4096)
    got = measure_stream.main(["3", "2", "--scene", files["scene"],
                               "--model", files["cfg"],
                               "--output", str(tmp_path / "out"), *CPU])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == got
    assert set(line) == {"n_frames", "depth", "sequential_ms_per_frame",
                         "streamed_ms_per_frame", "sequential_fps",
                         "streamed_fps", "device"}
    assert line["n_frames"] == 3 and line["depth"] == 2


@pytest.mark.parametrize("b", [1, 2])
def test_profile_stages_times_every_op(files, b, monkeypatch):
    monkeypatch.setattr(profile_stages, "REPS", 2)
    got = profile_stages.main(["--cfg", files["cfg"], "--batch", str(b),
                               *CPU])
    ops = [tag.split()[1] for tag, _, _ in got["ops"]]
    # two SA stages (FPS each), SA1's ball query with its grouping, SA2's
    # ball query and grouping, two FP stages, the head chains
    assert ops.count("fps") == 2 and ops.count("three_nn") == 2
    assert ops.count("ball_query+group") == 1 and ops.count("ball_query") == 1
    assert ops.count("interpolate") == 2 and ops.count("mlp") >= 4
    assert all(ms > 0 for _, ms, _ in got["ops"]) and got["forward_ms"] > 0


def test_record_ops_restores_the_model(files):
    """After recording, the ops and SharedMLP methods are the originals."""
    from s4g_tpu_torch import ops
    from s4g_tpu_torch.models import nn_layers
    before = (ops.ball_query, nn_layers.SharedMLP.forward)
    cfg = measure_batch.load_config(files["cfg"])
    from s4g_tpu_torch.tools.common import seeded_model
    net = seeded_model(cfg, torch.device("cpu"))
    calls = profile_stages.record_ops(
        net, {"scene_points": torch.rand(1, 3, 512)})
    assert calls and (ops.ball_query, nn_layers.SharedMLP.forward) == before


@pytest.mark.parametrize("detect", [False, True])
def test_trace_forward_writes_a_trace(files, tmp_path, detect):
    argv = ["--cfg", files["cfg"],
            "--trace-dir", str(tmp_path / "trace"), "--json",
            str(tmp_path / "table.json"), *CPU] + (["--detect"] if detect
                                                   else [])
    got = trace_forward.main(argv)
    assert os.path.dirname(got["trace_file"]) == str(tmp_path / "trace")
    events = json.load(open(got["trace_file"]))["traceEvents"]
    assert any("three_nn" in str(e.get("name", "")) or "aten::" in
               str(e.get("name", "")) for e in events)
    assert got["kernels"] == []                  # no device on the CPU
    table = json.load(open(tmp_path / "table.json"))
    assert table["reps"] == trace_forward.REPS and table["ms_per_exec"] == {}


def test_visualize_scored_grasp_writes_plys(files, tmp_path):
    out = str(tmp_path / "vis")
    assert visualize_scored_grasp.main(["--data", files["scene"], "--out",
                                        out, "--top", "5"]) == out
    for name in ("scored_cloud.ply", "cloud.ply", "grasp_hands.ply"):
        assert os.path.getsize(os.path.join(out, name)) > 0
    head = open(os.path.join(out, "grasp_hands.ply")).read().split(
        "end_header")[0]
    assert "element vertex 120" in head          # 5 hands x 24 vertices
    visualize_scored_grasp.main(["--data", files["scene"], "--out", out,
                                 "--point", "7"])


def test_pick_grasp_viewer_writes_html(files, tmp_path):
    path = pick_grasp_viewer.main(["--data", files["scene"], "--out",
                                   str(tmp_path / "v.html")])
    html = open(path).read()
    assert html.startswith("<!DOCTYPE html>") and '"labeled": [' in html


@pytest.mark.parametrize("tool,argv", [
    (train, ["--data-dir", "."]),
    (grasp_proposal_test, ["--scene", "x.p"]),
    (measure_batch, []),
    (measure_stream, ["--scene", "x.p"]),
    (profile_stages, []),
    (trace_forward, []),
    (train_at_scale, ["--out", "out"]),
    (detect_qa, ["--out", "out"]),
    (demo_full_system, ["--out", "out"]),
    (datagen_mesh_qa, ["--procedural", "--out", "out"]),
    (parity_at_speed, ["compare", "--scene", "x.p"]),
    (parity_at_speed, ["quality", "--scene", "qa:out"]),
    (parity_at_speed, ["time-parity", "--scene", "x.p"]),
    (measure_fps_sharded, ["2048", "256", "128"]),
])
def test_tools_need_a_gpu_by_default(tool, argv, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no GPU"):
        tool.main(argv)
    assert os.listdir(tmp_path) == []            # nothing made before

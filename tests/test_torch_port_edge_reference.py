"""EDGEPN2DU and EDGEPN2D, the edge-convolution models, against the
benchmark's plain reference (`grasp_bench/reference/edge.py`) on the CPU
at a narrow four-stage pyramid (25,600 -> 10,240 / 1,024 / 128 / global
cut to 1,024 -> 256 / 64 / 16 / global, the published pattern of an edge SA stage after
an xyz-only one, a global stage, a broadcast FP stage and three edge FP
stages) with seeded weights (`edge.make_weights`):

- the port's forwards per head, in f32 (TF32 off) and in bf16;
- `edge.param_shapes` against the port's `state_dict`, narrow and at the
  published widths, and `edge.forward_flops` against a hand count;
- the new cell's harness run narrow comes out correct, and its control
  (the reference one precision step below) and planted faults do not;
- the model's spans under the profiler and their readers, and nothing
  recorded with the profiler off;
- K6's counts (`grasp_bench/counts/fps_exact.py`) on one known launch.
"""

import collections
import copy
import os

import numpy as np
import pytest
import torch
import yaml

from s4g_tpu_torch.configs.config import load_cfg_from_dict
from s4g_tpu_torch.models import build_model
from s4g_tpu_torch.ops import neighbors
from s4g_tpu_torch.pipeline.detector import GraspDetector
from s4g_tpu_torch.utils import profiling

from grasp_bench import check, faults, harness, scenes
from grasp_bench.calibrate_edge import stand_in_numbers
from grasp_bench.counts import fps_exact
from grasp_bench.reference import edge
from grasp_bench.reference.precision import control
from grasp_bench.tests import narrow

CELL = "edgepn2du.detect_batch_edge.vga_b4"
LIMITS = harness.cell_files(CELL)[0]["limits"]
NARROW = dict(
    NUM_INPUT=1024, NUM_CENTROIDS=[256, 64, 16, 0],
    RADIUS=[0.04, 0.08, 0.16, -1.0], NUM_NEIGHBOURS=[16, 16, 16, -1],
    SA_CHANNELS=[[16, 16, 32], [32, 32, 64], [64, 64, 128], [64, 128, 256]],
    FP_CHANNELS=[[64, 64], [64, 32], [32, 32], [32, 32, 32]],
    NUM_FP_NEIGHBOURS=[0, 3, 3, 3], SEG_CHANNELS=[32])
B = 2


@pytest.fixture(autouse=True)
def _full_f32():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(prev)


def _ref_cfg(model_type, dtype, section=NARROW):
    return dict(section, TYPE=model_type, COMPUTE_DTYPE=dtype,
                SCORE_CLASSES=3, NUM_REMOVAL_DIRECTIONS=5,
                SORT_POINTS=False, FPS_SHARDS=1)


def _net(model_type, dtype, section=NARROW):
    return build_model(load_cfg_from_dict({
        "MODEL": {"TYPE": model_type, "COMPUTE_DTYPE": dtype,
                  "PN2": {"NUM_INPUT": section["NUM_INPUT"]},
                  model_type: dict(section)},
        "DATA": {"SCORE_CLASSES": 3}}))


def _points(seed=3):
    """B narrow model inputs: points of a small seeded tabletop."""
    cloud = scenes.tabletop_cloud(scenes.rng(seed, 1, 0), n_plane=8000,
                                  n_box=1000, half_size=(0.15, 0.1))
    pick = np.random.RandomState(seed).choice(len(cloud), B * 1024,
                                              replace=False)
    return torch.from_numpy(cloud[pick]).reshape(B, 1024, 3)


# -- the forwards -------------------------------------------------------------

@pytest.mark.parametrize("model_type", ["EDGEPN2DU", "EDGEPN2D"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_the_reference(monkeypatch, model_type, dtype):
    """Per head, the RMS of the gap over the reference's RMS
    (`check.head_errors`, as the cell's check reads it).  Every 3-NN takes
    the exact route (K4's twin): under 2^22 pairs the port selects by
    matmul-form distances, which may take another third neighbour on a
    near-tie (a property of the JAX package it copies), and the narrow
    stages are all under it.  f32: 1e-6, as both sides compute the same
    f32 operations (the gap reads 0 here); bf16: the cell's `model_error`
    limit, as the bf16 products of torch's matmul and of the reference's
    f32 matmul of bf16 operands sum in other orders."""
    monkeypatch.setattr(neighbors, "KERNEL_MIN_PAIRS", 0)
    cfg = _ref_cfg(model_type, dtype)
    sd = edge.make_weights(cfg, 7, "cpu")
    net = _net(model_type, dtype)
    net.load_state_dict(sd)
    pts = _points()
    with torch.no_grad():
        out = net({"scene_points": pts.transpose(1, 2).contiguous()})
    tol = 1e-6 if dtype == "float32" else LIMITS["model_error"]
    for b in range(B):
        ref = edge.forward(sd, cfg, pts[b])
        assert ref.keys() == out.keys()
        errs = check.head_errors({k: v[b] for k, v in out.items()}, ref,
                                 pts[b])
        assert max(errs.values()) <= tol, (b, errs)


def test_fp8_operands_leave_the_reference_by_more_than_the_limit():
    """The control's precision (fp8 operands, bf16 values) against the
    stated one on the same points: past the cell's `model_error` limit."""
    cfg = _ref_cfg("EDGEPN2DU", "bfloat16")
    sd = edge.make_weights(cfg, 7, "cpu")
    pts = _points()[0]
    ctrl = edge.forward(sd, cfg, pts, control(cfg))
    errs = check.head_errors(ctrl, edge.forward(sd, cfg, pts), pts)
    assert max(errs.values()) > LIMITS["model_error"], errs


# -- shapes and FLOPs -----------------------------------------------------------

@pytest.mark.parametrize("model_type", ["EDGEPN2DU", "EDGEPN2D"])
@pytest.mark.parametrize("width", ["narrow", "published"])
def test_param_shapes_are_the_ports(model_type, width):
    section = NARROW if width == "narrow" else {
        k: harness.cell_files(CELL)[1]["model"][k] for k in NARROW}
    sd = _net(model_type, "float32", section).state_dict()
    shapes = edge.param_shapes(_ref_cfg(model_type, "float32", section))
    assert list(shapes) == list(sd)
    assert all(tuple(sd[k].shape) == tuple(s) for k, s in shapes.items())


def _hand_flops(edge_fp):
    """2 a multiply-add, rows x C_in x C_out of every layer, NARROW."""
    def chain(rows, cin, widths):
        total = 0
        for c in widths:
            total += 2 * rows * cin * c
            cin = c
        return total

    sa = (chain(256 * 16, 3, [16, 16, 32])           # xyz only
          + chain(64 * 16, 3 + 2 * 32, [32, 32, 64])
          + chain(16 * 16, 3 + 2 * 64, [64, 64, 128])
          + chain(16, 3 + 128, [64, 128, 256]))      # global: 16 points
    k = 3 if edge_fp else 1
    fp = (chain(16, 256 + 128, [64, 64])              # broadcast
          + chain(64 * k, 64 * (k > 1) + 64 + 64, [64, 32])
          + chain(256 * k, 32 * (k > 1) + 32 + 32, [32, 32])
          + chain(1024 * k, 32 * (k > 1) + 32, [32, 32, 32]))
    heads = 4 * chain(1024, 32, [32]) + chain(1024, 32, [3 + 6 + 3 + 5])
    return float(sa + fp + heads)


@pytest.mark.parametrize("model_type", ["EDGEPN2DU", "EDGEPN2D"])
def test_forward_flops_is_the_hand_count(model_type):
    cfg = _ref_cfg(model_type, "bfloat16")
    assert edge.forward_flops(cfg) == _hand_flops(model_type == "EDGEPN2DU")


def test_forward_flops_at_the_published_widths():
    """18.79 GFLOP a scene: the edge FP's 3 rows a dense point included."""
    cfg = harness.cell_files(CELL)[1]["model"]
    assert edge.forward_flops(cfg) == pytest.approx(18.790940672e9)


# -- the harness, narrow ----------------------------------------------------------

def _files(tmp):
    """The cell's files with NARROW's model (the port's YAML written into
    `tmp`) and the narrow traffic of the other cells' CPU tests, its first
    call judged."""
    cell, config, traffic = copy.deepcopy(harness.cell_files(CELL))
    config["model"].update(NARROW)
    traffic.update(copy.deepcopy(narrow.NARROW_TRAFFIC))
    # The first call alone is judged: a window on a loaded CPU may hold
    # only one call of four scenes.
    traffic.update(sample_calls=1, sample_from=1)
    with open(os.path.join(harness.ROOT, "s4g_tpu_torch", "configs",
                           f"{config['port_model']}.yaml")) as f:
        port = yaml.safe_load(f)
    port["MODEL"]["EDGEPN2DU"].update(NARROW)
    port["MODEL"]["PN2"]["NUM_INPUT"] = NARROW["NUM_INPUT"]
    path = os.path.join(tmp, "edgepn2du_narrow.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(port, f)
    config["port_model"] = path
    return cell, config, traffic


def _run(files, seed=2 ** 40 + 5):
    return harness.run_cell(CELL, seed, 1.0, False, "cpu", files=files,
                            log=lambda s: None)


def test_the_cell_comes_out_correct(tmp_path):
    res = _run(_files(str(tmp_path)))
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"scenes_per_s", "setup_s"}


def test_the_control_is_not_correct(tmp_path):
    got = stand_in_numbers(CELL, 5, "cpu", "control",
                           files=_files(str(tmp_path)))
    assert got["model_error"] > LIMITS["model_error"], got
    assert any(v > LIMITS[k] for k, v in got.items() if k in LIMITS), got


@pytest.mark.parametrize("fault", ["altered", "half_answered"])
def test_a_fault_is_not_correct(tmp_path, fault):
    with faults.planted(fault):
        res = _run(_files(str(tmp_path)), seed=11)
    assert not res["correct"], res["checks"]


def test_the_detector_serves_the_published_model(tmp_path):
    """`GraspDetector(model="edgepn2du_model")`: EDGEPN2DU from its own
    section at the published widths, the detector's input 25,600."""
    det = GraspDetector(model="edgepn2du_model", device="cpu",
                        output_dir=str(tmp_path))
    cfg = harness.cell_files(CELL)[1]["model"]
    assert det.cfg.MODEL.TYPE == "EDGEPN2DU" and det.num_input == 25600
    assert [sa.num_centroids for sa in det.net.sa_modules] \
        == cfg["NUM_CENTROIDS"]
    assert [sa.edge for sa in det.net.sa_modules] == [True] * 4
    assert type(det.net.fp_modules[1]).__name__ == "EdgeFPModule"


# -- spans ------------------------------------------------------------------------

SPANS = collections.Counter({"model.sample": 3, "model.sa": 4,
                            "model.fp": 4})   # a forward of NARROW


def _forward(net, pts):
    with torch.no_grad():
        net({"scene_points": pts.transpose(1, 2).contiguous()})


def test_the_model_records_its_spans_under_the_profiler():
    net = _net("EDGEPN2DU", "float32")
    pts = _points()
    profiling.clear()
    _forward(net, pts)
    assert profiling.spans() == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(2):
            with profiling.span("call"):
                _forward(net, pts)
    spans = profiling.spans()
    calls = [s.call for s in spans if s.name == "call"]
    for call in calls:
        mine = [s for s in spans if s.call == call and s.name != "call"]
        assert collections.Counter(s.name for s in mine) == SPANS
        assert {s.parent for s in mine} == {"call"}
    # The readers: device time summed over a call's spans, the median of
    # the calls (CUDA events faked: the CPU has none).
    for s in spans:
        s.events = (_Event(0.0), _Event(1.0 if s.call == calls[0] else 3.0))
    for metric, span in (("sample_ms.edge", "model.sample"),
                         ("sa_ms.edge", "model.sa"),
                         ("fp_ms.edge", "model.fp")):
        assert harness.reader(metric).read(None, metric) \
            == pytest.approx(2.0 * SPANS[span])


class _Event:
    def __init__(self, ms):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.ms - self.ms


# -- K6's counts ------------------------------------------------------------------

def test_fps_exact_counts_one_launch():
    """B = 2 scenes of 1,000 points in G = 4 chains of 250, 25 centroids
    a chain: 24 steps over every point, 10 operations a point a step."""
    pts = torch.zeros(2, 3, 1000)
    work = fps_exact.work((pts, 2, 1000, 4, 25, None, None), {})
    assert work == {"f32": 10.0 * 2 * 1000 * 24,
                    "bytes": 12.0 * 2 * 1000 + 4.0 * 2 * 4 * 25}
    assert fps_exact.NAMES == ("fps_cluster_kernel",)

"""The plain reference against the port on the CPU at a narrow size: a run
of each cell's harness (set-up, window, check) comes out correct; the
control (the reference one precision step below, in the program's place)
and each fault a cell can have, planted in the port under a run, come out
not correct.  The CUDA devices are not looked for: the runs are on the
CPU."""

import numpy as np
import pytest
import torch

from grasp_bench import calibrate, faults, harness
from grasp_bench.tests import narrow

CELLS = ("curvature.detect.vga", "contact.detect_batch.vga_b4",
         "curvature.detect_stream.vga_d2", "curvature.train.b2")
SECONDS = {"curvature.detect.vga": 2.0, "contact.detect_batch.vga_b4": 6.0,
           "curvature.detect_stream.vga_d2": 2.5}


@pytest.fixture(autouse=True)
def _full_f32():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(prev)


def _run(cell, files, seed=20260101):
    return harness.run_cell(cell, seed, SECONDS.get(cell, 1.0), False, "cpu",
                            files=files, log=lambda s: None)


@pytest.mark.parametrize("cell", CELLS)
def test_the_port_agrees_with_the_reference(cell, tmp_path):
    res = _run(cell, narrow.f32_files(cell, str(tmp_path)))
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0


@pytest.mark.parametrize("cell", ("curvature.detect.vga",
                                  "curvature.train.b2"))
def test_the_control_is_not_correct(cell, tmp_path):
    files = narrow.files(cell, str(tmp_path))
    limits = files[0]["limits"]
    got = calibrate.stand_in_numbers(cell, 5, "cpu", "control", files=files)
    assert any(v > limits[k] for k, v in got.items()), got


@pytest.mark.parametrize("cell, fault", [
    ("curvature.detect.vga", "altered"),
    ("curvature.detect.vga", "all_invalid"),
    ("curvature.detect.vga", "no_grasps"),
    ("curvature.detect_stream.vga_d2", "altered"),
    ("curvature.detect_stream.vga_d2", "no_grasps"),
    ("contact.detect_batch.vga_b4", "altered"),
    ("contact.detect_batch.vga_b4", "half_answered"),
    ("contact.detect_batch.vga_b4", "all_invalid"),
    ("curvature.train.b2", "unchanged"),
    ("curvature.train.b2", "half_batch")])
def test_a_fault_is_not_correct(cell, fault, tmp_path):
    with faults.planted(fault):
        res = _run(cell, narrow.f32_files(cell, str(tmp_path)))
    assert not res["correct"], res["checks"]


def test_the_same_seed_makes_the_same_inputs():
    from grasp_bench import scenes, weights
    cfg = harness.cell_files("curvature.detect.vga")[1]["model"]
    traffic = narrow.NARROW_TRAFFIC
    a, b = (scenes.scene_pool(2 ** 40 + 3, traffic) for _ in range(2))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    wa, wb = (weights.make(cfg, 2 ** 40 + 3, "cpu") for _ in range(2))
    assert all(torch.equal(wa[k], wb[k]) for k in wa)

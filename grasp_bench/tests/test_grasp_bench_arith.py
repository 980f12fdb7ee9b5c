"""The readers' arithmetic: the tail, rates over the window, the idle
share as a union of intervals, mfu, the least time of a piece of work,
the trace reading, the port kernels' time the roofline leaves out, and the
training check's leaf measure."""

import json
import statistics

import pytest
import torch

from grasp_bench import devtrace, harness, peaks, train_check
from grasp_bench.metrics import (detect_p95_ms, device_idle,
                                 kernel_roofline, kernel_unattributed, mfu,
                                 scenes_per_s, train_samples_per_s)


def _run(records, window, flops=0.0):
    run = harness.Run({}, flops)
    run.records, run.window = records, window
    return run


def test_p95_interpolates_between_order_statistics():
    assert detect_p95_ms.p95(list(range(1, 101))) == pytest.approx(95.05)
    lat = [{"t0": 0.0, "t1": t / 1e3, "items": 1} for t in range(1, 21)]
    assert detect_p95_ms.read(_run(lat, (0, 1)), "") == pytest.approx(19.05)


def test_rates_are_all_the_work_over_all_the_window():
    recs = [{"t0": 0, "t1": 0, "items": 4}] * 10
    assert scenes_per_s.read(_run(recs, (2.0, 6.0)), "") == 10.0
    assert train_samples_per_s.read(_run(recs, (0.0, 8.0)), "") == 5.0
    assert scenes_per_s.read(_run([], (0.0, 8.0)), "") is None


def test_mfu_is_model_flops_over_the_window_at_the_bf16_peak():
    recs = [{"t0": 0, "t1": 0, "items": 1}] * 989
    run = _run(recs, (0.0, 1.0), flops=1e10)
    assert mfu.read(run, "mfu.detect") == pytest.approx(1.0)


def test_idle_is_one_minus_the_union_of_device_intervals():
    merged, busy = devtrace.union_us([(0, 10), (5, 10), (30, 5), (31, 1)])
    assert merged == [[0, 15], [30, 35]] and busy == 20
    run = _run([], (0, 1))
    run.profile = {"busy_s": 0.25, "window_s": 1.0}
    assert device_idle.read(run, "") == pytest.approx(75.0)
    run.profile = {"busy_s": 0.0, "window_s": 1.0}
    assert device_idle.read(run, "") is None


def test_trace_reading(tmp_path):
    ev = [{"ph": "X", "cat": "kernel", "name": "k1", "ts": 0, "dur": 10},
          {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 5,
           "dur": 10},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 40, "dur": 20},
          {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 14,
           "dur": 20, "tid": 1},
          {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0,
           "dur": 3, "tid": 1}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    out = devtrace.read_trace(str(path))
    assert out["busy_s"] == pytest.approx(35e-6)
    assert out["device_ops"][0] == ["k1", pytest.approx(30e-6)]
    assert out["idle_gaps"] == [["host: aten::item", pytest.approx(25e-6)]]


def test_bound_is_the_larger_of_operations_and_bytes():
    assert peaks.bound_s({"f32": 67e12}) == pytest.approx(1.0)
    assert peaks.bound_s({"f32": 67e12, "bf16": 989e12}) \
        == pytest.approx(2.0)
    assert peaks.bound_s({"f32": 1.0, "bytes": 3.35e12}) \
        == pytest.approx(1.0)


def test_leaf_gaps_are_against_the_larger_of_the_leaf_and_the_median():
    ref = {"a": torch.tensor([3.0, 4.0]), "b": torch.tensor([1.0]),
           "c": torch.tensor([0.001])}
    prog = {"a": torch.tensor([3.0, 4.5]), "b": torch.tensor([1.0]),
            "c": torch.tensor([0.002])}
    med = statistics.median([5.0, 1.0, 0.001])
    want = max((4.5 ** 2 + 9) ** 0.5 - 5.0, 0.0) / 5.0
    got = train_check.leaf_gaps(prog, ref, list(ref))
    assert got == pytest.approx([want, 0.0, 0.001 / med])


def test_the_program_defines_the_kernels_the_counts_name():
    names = devtrace.port_kernel_names()
    for kernel in ("three_nn_kernel", "three_nn_merge_kernel",
                   "collision_counts_kernel", "gather_backward_kernel",
                   "warp_kernel", "tile_kernel", "sa1_fused_kernel"):
        assert kernel in names
    assert kernel_roofline.matches(
        "void (anonymous namespace)::warp_kernel<64>(float const*)",
        "::warp_kernel")
    assert not kernel_roofline.matches("three_nn_merge_kernel(int)",
                                       "three_nn_kernel")


def test_port_kernel_time_without_counts_or_launches_is_unattributed(
        capsys):
    run = _run([], (0, 1))
    kernels = [("void (anonymous namespace)::three_nn_kernel<8>(x)", 30.0),
               ("void (anonymous namespace)::three_nn_merge_kernel(x)", 10.0),
               ("collision_counts_kernel(float const*)", 20.0),
               ("void at::native::reduce_kernel<512>(x)", 500.0)]
    run.profile = {"launches": [("three_nn", (0, 0, 1, 64, 256))],
                   "kernels": kernels}
    # K5 ran by a route that left no launch record: its 20 of 60 us.
    assert kernel_unattributed.read(run, "kernel_unattributed.detect") \
        == pytest.approx(100.0 * 20 / 60)
    assert "collision_counts_kernel" in capsys.readouterr().err
    run.profile["kernels"] = kernels[:2] + kernels[3:]
    assert kernel_unattributed.read(run, "") == 0.0
    run.profile["kernels"] = kernels[3:]
    assert kernel_unattributed.read(run, "") is None

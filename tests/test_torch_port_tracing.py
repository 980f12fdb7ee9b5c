"""The port's spans and counters (`s4g_tpu_torch.utils.profiling.span`) on
the CPU: off without a profiler (one flag check, nothing recorded, no
`record_function`, CUDA event or sync-debug mode); under a CPU
torch.profiler the detector's, model's, trainer's and loader's spans with
their parents and call ids, in the Chrome trace as `user_annotation` events;
outputs bit for bit the same with tracing on and off; the benchmark's
readers of the spans (`grasp_bench/metrics/`) on synthetic stores; and
`grasp_bench.devtrace` naming a span for an idle gap inside it."""

import collections
import json
import threading
import time
import warnings

import numpy as np
import pytest
import torch
import yaml

from s4g_tpu_torch.configs.config import load_cfg_from_dict
from s4g_tpu_torch.pipeline.detector import GraspDetector
from s4g_tpu_torch.runtime.loader import AsyncSceneLoader
from s4g_tpu_torch.train.dataset import SceneGraspDataset
from s4g_tpu_torch.train.trainer import Trainer
from s4g_tpu_torch.utils import profiling
from s4g_tpu_torch.utils.logger import MetricLogger

from grasp_bench import devtrace, harness

from test_torch_port_detector import TINY, clutter_cloud
from test_torch_port_train import TINY_PN2, write_scenes

CAPACITY = 2048    # under the clutter clouds' 2,700 points: detect.fit subsets
KW = dict(num_selected=5, score_threshold=0.0, verticalness_threshold=-1e9)
DETECT_SPANS = {       # span -> its parent
    "detect.submit": None, "detect.fit": "detect.submit",
    "detect.prep": "detect.submit", "prep.voxel": "detect.prep",
    "prep.outlier": "detect.prep", "prep.sample": "detect.prep",
    "detect.model": "detect.submit", "detect.post": "detect.submit",
    "post.candidates": "detect.post", "post.collision": "detect.post",
    "detect.wait": None}
# The model's spans a forward of the two-stage TINY and TINY_PN2 pyramids:
# span -> how many (one a stage).
MODEL_SPANS = {"model.sample": 2, "model.sa": 2, "model.fp": 2}
TRAIN_SPANS = {"train.step": None, "train.forward_loss": "train.step",
               "train.backward": "train.step", "train.update": "train.step",
               "loader.wait": None, "loader.collate": None,
               **{name: "train.forward_loss" for name in MODEL_SPANS}}


def _profiled():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


# -- off ----------------------------------------------------------------------

def test_span_is_one_flag_check_without_a_profiler(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("called with tracing off")

    for module, name in ((torch.profiler, "record_function"),
                         (torch.cuda, "Event"),
                         (torch.cuda, "set_sync_debug_mode"),
                         (warnings, "catch_warnings")):
        monkeypatch.setattr(module, name, refuse)
    profiling.clear()
    with profiling.span("a", device="cuda", waits="cuda") as rec:
        profiling.count("n")
        assert rec is None
    assert profiling.span("b") is profiling.span("c", call=3)
    assert profiling.spans() == []


# -- the recorder ---------------------------------------------------------------

def test_spans_nest_share_calls_and_sum_per_call(tmp_path):
    profiling.clear()
    with _profiled():
        with profiling.span("root") as root:
            with profiling.span("child", device="cpu") as child:
                profiling.count("n", 2)
                profiling.count("n")
        with profiling.span("child", call=root.call):
            pass
        with profiling.span("root") as second:
            pass

        def other_thread():
            with profiling.span("child", call=root.call):
                pass

        t = threading.Thread(target=other_thread, name="feeder")
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    assert (root.parent, child.parent, child.call) == (None, "root",
                                                       root.call)
    assert second.call != root.call and child.counts == {"n": 3}
    assert child.events is None and child.device_ms() is None
    assert child.host_ms >= 0
    spans = profiling.spans()
    assert [s.name for s in spans] == ["root", "child", "child", "root",
                                       "child"]
    assert spans[-1].thread == "feeder" and spans[-1].parent is None
    assert len(profiling.per_call("child")) == 1
    assert profiling.per_call("child", "n") == [3]
    assert len(profiling.per_call("root")) == 2
    assert profiling.per_call("child", "device_ms") == []
    # Outside a profiler nothing more is recorded; trace() starts anew.
    with profiling.span("root"):
        pass
    assert len(profiling.spans()) == 5
    with profiling.trace(str(tmp_path)):
        assert profiling.spans() == []


def test_waits_count_sync_warnings_and_pass_the_others_on(monkeypatch):
    """`waits` counts the sync-debug warnings raised inside the span as its
    `host_waits` and re-emits every other warning (the CUDA side faked:
    the debug mode's getter and setter, the device test)."""
    modes = []
    monkeypatch.setattr(profiling, "_is_cuda", lambda d: d == "cuda")
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    with _profiled():
        with pytest.warns(DeprecationWarning, match="other"):
            with profiling.span("root", waits="cuda") as rec:
                for _ in range(3):
                    warnings.warn("called a synchronizing CUDA operation")
                warnings.warn("other", DeprecationWarning)
    assert rec.counts == {"host_waits": 3} and modes == ["warn", 0]


# -- detect ----------------------------------------------------------------------

def _detector(tmp, name):
    cfg_file = tmp / "tiny.yaml"
    cfg_file.write_text(yaml.safe_dump(TINY))
    return GraspDetector(model=str(cfg_file), device="cpu",
                         output_dir=str(tmp / name),
                         cloud_capacity=CAPACITY, num_candidates=64, seed=5)


def _serve(det, clouds):
    """One `detect`, then a stream of the other clouds at depth 2."""
    return [det.detect(clouds[0], **KW),
            *det.detect_stream(clouds[1:], depth=2, **KW)]


@pytest.fixture(scope="module")
def detect_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("detect")
    clouds = [clutter_cloud(np.random.RandomState(i)) for i in range(3)]
    off = _serve(_detector(tmp, "off"), clouds)
    det = _detector(tmp, "on")
    profiling.clear()
    with _profiled() as prof:
        on = _serve(det, clouds)
    path = str(tmp / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {"off": off, "on": on, "spans": profiling.spans(),
            "events": events, "trace": path}


def test_detect_records_its_spans_with_parents_and_one_call(detect_run):
    spans = detect_run["spans"]
    first = [s for s in spans if s.call == spans[0].call]
    assert {s.name: s.parent for s in first} == {
        **DETECT_SPANS, **{name: "detect.model" for name in MODEL_SPANS}}
    main = [s for s in spans if s.thread == "MainThread"]
    assert all(s.t1 is not None for s in main)
    # The next call's subsets, drawn ahead on the worker thread, one call
    # of its own each: every fit but the last was handed its draw, so
    # those draws have ended.
    ahead = [s for s in spans if s not in main]
    fits = [s for s in main if s.name == "detect.fit"]
    assert all(s.name == "fit.ahead" and s.parent is None
               and s.thread.startswith("subset-draws") for s in ahead)
    assert len(fits) - 1 <= sum(s.t1 is not None for s in ahead) \
        <= len(ahead) <= len(fits)
    assert not {s.call for s in ahead} & {s.call for s in main}
    # One scene: one span of each stage a call, and the model's one a
    # stage of its forward.
    assert sorted(s.name for s in first) == sorted(
        [*DETECT_SPANS, *(name for name, n in MODEL_SPANS.items()
                          for _ in range(n))])
    assert not any("host_waits" in s.counts for s in spans)   # the CPU


def test_detect_stream_frames_share_their_ids(detect_run):
    spans = detect_run["spans"]
    submits = [s.call for s in spans if s.name == "detect.submit"]
    waits = [s.call for s in spans if s.name == "detect.wait"]
    assert len(set(submits)) == 3 and waits == submits
    # Two frames in flight: the second frame is submitted before the first
    # one's wait.
    order = [(s.name, s.call) for s in spans
             if s.name in ("detect.submit", "detect.wait")]
    assert order[2:5] == [("detect.submit", submits[1]),
                          ("detect.submit", submits[2]),
                          ("detect.wait", submits[1])]


def test_chrome_trace_holds_the_spans(detect_run):
    names = collections.Counter(
        e["name"] for e in detect_run["events"]
        if e.get("cat") == "user_annotation")
    assert all(names[n] == 3 for n in DETECT_SPANS)
    host = [(float(e["ts"]), float(e["dur"]), e["name"])
            for e in detect_run["events"]
            if e.get("cat") == "user_annotation"
            and e["name"] == "prep.outlier"]
    ts, dur, _ = host[0]
    assert devtrace._host_at(host, ts, ts + dur / 2) == "prep.outlier"


def test_detect_is_bit_identical_with_tracing_on(detect_run):
    assert len(detect_run["on"]) == len(detect_run["off"]) == 3
    for (p_on, s_on), (p_off, s_off) in zip(detect_run["on"],
                                            detect_run["off"]):
        assert len(p_on) > 0
        np.testing.assert_array_equal(p_on, p_off)
        np.testing.assert_array_equal(s_on, s_off)


# -- train ----------------------------------------------------------------------

def _trainer(tmp, name):
    cfg = load_cfg_from_dict({
        "MODEL": {"TYPE": "PN2_CLS", "COMPUTE_DTYPE": "float32",
                  "PN2": dict(TINY_PN2)},
        "DATA": {"SCORE_CLASSES": 3}, "TRAIN": {"BATCH_SIZE": 2}})
    trainer = Trainer(cfg, output_dir=str(tmp / name), device="cpu")
    trainer.init_state()
    return trainer


def _train(tmp, name):
    """Two epochs of one loader over four scenes: four steps."""
    trainer = _trainer(tmp, name)
    loader = AsyncSceneLoader(SceneGraspDataset(
        str(tmp / "data"), num_points=128, batch_size=2,
        num_frame_points=16, seed=0), num_workers=1)
    for _ in range(2):
        for batch in loader:
            trainer.train_step(batch)
    return {k: v.detach().clone() for k, v in trainer.net.state_dict().items()}


@pytest.fixture(scope="module")
def train_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train")
    write_scenes(str(tmp / "data"), 4)
    off = _train(tmp, "off")
    profiling.clear()
    with _profiled():
        on = _train(tmp, "on")
    return {"off": off, "on": on, "spans": profiling.spans()}


def test_trainer_and_loader_record_their_spans(train_run):
    spans = train_run["spans"]
    assert {s.name: s.parent for s in spans} == TRAIN_SPANS
    steps = [s.call for s in spans if s.name == "train.step"]
    assert steps == [0, 1, 2, 3]
    for part in ("train.forward_loss", "train.backward", "train.update"):
        assert [s.call for s in spans if s.name == part] == steps
    # The loader's batch numbers run on over its passes.
    assert sorted({s.call for s in spans if s.name == "loader.wait"}) \
        == [0, 1, 2, 3, 4]
    collate = [s for s in spans if s.name == "loader.collate"]
    assert sorted({s.call for s in collate}) == [0, 1, 2, 3, 4]
    assert all(s.thread != "MainThread" for s in collate)
    assert len(profiling.per_call("loader.wait")) == 5


def test_train_is_bit_identical_with_tracing_on(train_run):
    assert train_run["on"].keys() == train_run["off"].keys()
    for k, v in train_run["off"].items():
        assert torch.equal(train_run["on"][k], v), k


def test_fit_logs_the_period_wall_time_a_step():
    """`Trainer._log`: a step's "time" is the log period's wall time (to
    the scalars' copy to the host) over its steps; "data" each step's
    wait for its batch."""
    meters = MetricLogger()
    pending = [(0.25, {"loss": torch.tensor(float(i))}) for i in range(4)]
    start = time.perf_counter() - 2.0
    end = Trainer._log(meters, pending, start)
    assert pending == [] and end >= start + 2.0
    assert meters.time.count == 4
    assert meters.time.global_avg == pytest.approx((end - start) / 4)
    assert meters.data.global_avg == 0.25
    assert meters.loss.global_avg == 1.5


# -- the benchmark's readers ------------------------------------------------------

READERS = [   # metric, span, value
    ("outlier_ms.detect", "prep.outlier", "device_ms"),
    ("outlier_ms.batch", "prep.outlier", "device_ms"),
    ("host_waits.detect", "detect.submit", "host_waits"),
    ("host_waits.batch", "detect.submit", "host_waits"),
    ("host_waits.stream", "detect.submit", "host_waits"),
    ("host_waits.train", "train.step", "host_waits"),
    ("submit_ms.stream", "detect.submit", "host_ms"),
    ("result_wait_ms.stream", "detect.wait", "host_ms"),
    ("forward_device_ms.train", "train.forward_loss", "device_ms"),
    ("backward_device_ms.train", "train.backward", "device_ms"),
    ("optimizer_device_ms.train", "train.update", "device_ms"),
    ("backward_host_ms.train", "train.backward", "host_ms"),
    ("loader_wait_ms.train", "loader.wait", "host_ms"),
    ("collate_ms.train", "loader.collate", "host_ms"),
    ("sample_ms.edge", "model.sample", "device_ms"),
    ("sa_ms.edge", "model.sa", "device_ms"),
    ("fp_ms.edge", "model.fp", "device_ms"),
]


class _Event:
    def __init__(self, ms):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.ms - self.ms


def _fake(name, call, value, what):
    s = profiling.Span(name, call)
    s.t0, s.t1 = 0, 1
    if what == "host_ms":
        s.t1 = int(value * 1e6)
    elif what == "device_ms":
        s.events = (_Event(1.0), _Event(1.0 + value))
    else:
        s.counts[what] = value
    return s


@pytest.mark.parametrize("metric,span,what", READERS)
def test_reader_takes_the_median_per_call(monkeypatch, metric, span, what):
    reader = harness.reader(metric)
    assert reader.UNIT
    monkeypatch.setattr(profiling, "_SPANS", collections.deque())
    assert reader.read(None, metric) is None
    # Calls 7, 8, 9 of two spans each: sums 3, 30 and 9; the median 9.
    store = [_fake(span, c, v, what) for c, v in
             ((7, 1), (8, 10), (7, 2), (9, 4), (8, 20), (9, 5))]
    other = "detect.submit" if span != "detect.submit" else "detect.wait"
    store += [_fake(other, 7, 1000, what), _fake(span, 7, 1000, "other")]
    unfinished = profiling.Span(span, 7)
    unfinished.t0 = 0
    store.append(unfinished)
    monkeypatch.setattr(profiling, "_SPANS", collections.deque(store))
    assert reader.read(None, metric) == pytest.approx(9)


def test_devtrace_names_the_span_a_gap_falls_in(tmp_path):
    """A synthetic trace: kernels at 0-10 and 60-70 us; the host in
    `detect.submit` (0-100) › `detect.fit` (12-58), and an `aten::copy_`
    before it.  The gap's host is the innermost span at its middle."""
    events = [
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 0, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 60, "dur": 10},
        {"ph": "X", "cat": "user_annotation", "name": "detect.submit",
         "ts": 0, "dur": 100, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "detect.fit",
         "ts": 12, "dur": 46, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 10,
         "dur": 1, "tid": 1},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    out = devtrace.read_trace(str(path))
    assert out["idle_gaps"] == [["host: detect.fit", pytest.approx(50e-6)]]
    host = [(e["ts"], e["dur"], e["name"]) for e in events[2:]]
    assert devtrace._host_at(host, 10, 35) == "detect.fit"
    assert devtrace._host_at(host[2:], 12, 35) == "after aten::copy_"

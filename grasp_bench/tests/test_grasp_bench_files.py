"""Every data file of the benchmark parses and names files that exist; a
cell, traffic mix, configuration or metric is found by its name alone; the
manifest at the repository's root agrees with the files."""

import glob
import importlib
import json
import os

import pytest

from grasp_bench import check, harness, train_check
from grasp_bench.reference.model import param_shapes

BENCH = harness.BENCH_DIR
CELLS = sorted(os.path.basename(p)[:-5]
               for p in glob.glob(os.path.join(BENCH, "workloads", "*.json")))
MANIFEST = os.path.join(harness.ROOT, "BENCHMARK.json")
NAME_CHARS = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
                 "0123456789_.-")


def _numbers(traffic):
    return (train_check.NUMBERS if traffic["driver"] == "train"
            else check.NUMBERS)


@pytest.mark.parametrize("cell_name", CELLS)
def test_cell_files_load_by_name(cell_name):
    cell, config, traffic = harness.cell_files(cell_name)
    assert cell["chips"] in (1, 4) and 0 < len(cell["why"]) <= 200
    drv = importlib.import_module(f"grasp_bench.drivers.{traffic['driver']}")
    assert hasattr(drv, "Driver")
    for kind in ("end_to_end", "per_layer"):
        for metric in cell["metrics"][kind]:
            mod = harness.reader(metric)
            assert callable(mod.read) and mod.UNIT
    assert "setup_s" in cell["metrics"]["end_to_end"]
    assert set(cell["limits"]) == set(_numbers(traffic))
    assert set(config["reduced"]) <= set(config["model"])
    assert param_shapes(config["model"])


def test_every_port_kernel_on_a_cell_path_has_counts():
    from s4g_tpu_torch import _build
    for kernel in ("fps_lane", "ball_query_slab", "ball_query_full",
                   "sa1_fused", "three_nn", "collision_counts",
                   "gather_backward"):
        assert kernel in _build.LAUNCHES
        mod = importlib.import_module(f"grasp_bench.counts.{kernel}")
        assert mod.NAMES and callable(mod.work)


def test_the_manifest_agrees_with_the_files():
    with open(MANIFEST) as f:
        bench = json.load(f)
    assert bench["command"] == ["python3", "grasp_bench/run.py"]
    assert bench["paths"] == ["grasp_bench"]
    cells = {w["name"]: w for w in bench["workloads"]}
    assert set(cells) <= set(CELLS)
    configs = {c["name"]: c for c in bench["configs"]}
    for c in configs.values():
        with open(os.path.join(harness.ROOT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]
    metrics = {m["name"]: m for m in bench["end_to_end"] + bench["per_layer"]}
    for name, w in cells.items():
        cell, config, _ = harness.cell_files(name)
        assert (w["config"], w["traffic"], w["chips"], w["why"]) == (
            cell["config"], cell["traffic"], cell["chips"], cell["why"])
        assert w["config"] in configs
        for kind in ("end_to_end", "per_layer"):
            for m in cell["metrics"][kind]:
                assert m in metrics and harness.reader(m).UNIT \
                    == metrics[m]["unit"]
                assert name in metrics[m].get("workloads", cells)
    for m in bench["per_layer"]:
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
        for w in m["workloads"]:
            assert m["moves"] in harness.cell_files(w)[0]["metrics"][
                "end_to_end"]
    for text in [bench["command"], *cells, *configs, *metrics]:
        for word in ([text] if isinstance(text, str) else text[1:]):
            assert set(word) <= NAME_CHARS | {"/"}

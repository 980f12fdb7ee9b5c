"""One run of one cell: set-up, a measured window, the readers, and the
check that decides `correct`.

The harness is driven by the files under `grasp_bench/`, found by name:

- `workloads/<cell>.json`: the cell's configuration and traffic, chips,
  why, the metrics it reports and the limits of its check;
- `configs/<config>.json`: the model configuration (its source, the
  port's model name, the sizes, departures, `assumed`, `reduced`);
- `traffic/<traffic>.json`: the traffic's driver and parameters;
- `drivers/<driver>.py`: the driver (`serving.Detector`);
- `metrics/<family>.py`: the reader of every metric `<family>.<cell kind>`;
- `counts/<kernel>.py`: each port kernel's operations and bytes.

A later change adds a cell, a traffic mix, a configuration or a metric by
adding files.
"""

from __future__ import annotations

import importlib
import json
import os
import shutil
import sys
import tempfile
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# Top-level modules that must not be loaded: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "s4g_tpu")


def load(kind: str, name: str) -> dict:
    with open(os.path.join(BENCH_DIR, kind, f"{name}.json")) as f:
        return json.load(f)


def cell_files(cell_name: str) -> tuple:
    """(cell, configuration, traffic) dicts of a cell."""
    cell = load("workloads", cell_name)
    return cell, load("configs", cell["config"]), load("traffic",
                                                       cell["traffic"])


def reader(metric: str):
    return importlib.import_module(
        f"grasp_bench.metrics.{metric.split('.')[0]}")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Run:
    """What a run recorded, for the readers."""

    def __init__(self, model_cfg: dict, flops_per_item: float):
        self.model_cfg = model_cfg
        self.flops_per_item = flops_per_item   # a scene's, or a sample's
        self.records: list = []                # {"t0", "t1", "items", ...}
        self.spans: dict = {}                  # name -> [ms]
        self.window = (0.0, 0.0)
        self.syncs: list = []
        self.profile = None
        self.setup_s = None


def device_info(device: str) -> dict:
    import torch
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None,
             files: tuple | None = None, log=print,
             detail: bool = False) -> dict:
    """One run: returns the result line's dict.  `files` replaces the
    cell's (cell, configuration, traffic) dicts (the CPU tests' narrow
    cells); `t_start` is when the process started its set-up; `detail`
    adds the check's diagnostic readings under "detail"."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell, config, traffic = files or cell_files(cell_name)
    drv = importlib.import_module(f"grasp_bench.drivers.{traffic['driver']}")
    workdir = tempfile.mkdtemp(prefix="grasp_bench_")
    try:
        driver = drv.Driver(cell, config, traffic, seed, device, trace,
                            workdir)
        run = Run(config["model"], driver.flops_per_item)
        t_setup = time.perf_counter()
        parts = driver.setup()
        run.setup_s = time.perf_counter() - t_start
        log("setup_s " + json.dumps({
            "total": run.setup_s, "start_torch_cuda": t_setup - t_start,
            **parts}))
        driver.window(seconds, run)
        if trace and device == "cuda":
            from . import devtrace
            run.profile = devtrace.profile(driver.stretch, workdir)
        info = device_info(device)
        if device == "cuda":
            info["power_limit"] = power_limit()
        if trace and run.profile:
            info["busy_s"] = run.profile["busy_s"]
            info["window_s"] = run.profile["window_s"]
        kind = "per_layer" if trace else "end_to_end"
        metrics = {}
        for name in cell["metrics"][kind]:
            mod = reader(name)
            value = mod.read(run, name)
            if value is not None:
                metrics[name] = {"value": value, "unit": mod.UNIT}
        attempted = sum(r["items"] for r in run.records)
        driver.release()
        numbers = driver.check(detail)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    limits = cell["limits"]
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = all(numbers[k] <= limits[k] for k in limits)
    result = {"correct": correct, "attempted": attempted,
              "failed": int(numbers.get("missing", 0)), "metrics": metrics,
              "device": info}
    if trace and run.profile:
        result["breakdown"] = {"device_ops": run.profile["device_ops"],
                               "idle_gaps": run.profile["idle_gaps"]}
    if detail:
        result["detail"] = numbers
    result["checks"] = checks
    return result


def power_limit() -> str:
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"

"""Narrow copies of the committed cells for the CPU tests: the same files
with the model's sizes cut (a port YAML written beside them), a small
dense tabletop and short windows."""

from __future__ import annotations

import copy
import os

import yaml

from grasp_bench import harness

NARROW_MODEL = {
    "NUM_INPUT": 2048, "NUM_CENTROIDS": [512, 256, 128],
    "NUM_NEIGHBOURS": [16, 16, 16],
    "SA_CHANNELS": [[128, 128, 128], [64, 64, 128], [128, 128, 256]],
    "FP_CHANNELS": [[128, 128], [64, 64], [64, 64]],
    "SEG_CHANNELS": [64, 32]}
NARROW_TRAFFIC = {
    "scenes": [["tabletop", {"n_plane": 8000, "n_box": 1000,
                             "half_size": [0.15, 0.1]}]],
    "pool": 3, "capacity": 8192, "num_candidates": 64, "warmup_calls": 1,
    "sample_calls": 2, "sample_from": 2, "profile_calls": 1}
NARROW_TRAIN_TRAFFIC = {
    "scene": {"num_frames": 100, "num_objects": 5, "n_plane": 3000,
              "n_box": 500, "half_size": [0.15, 0.1]},
    "pool": 8, "num_frame_points": 64, "workers": 2, "checked_steps": 3,
    "profile_calls": 1}


def files(cell_name: str, tmpdir: str) -> tuple:
    """(cell, configuration, traffic) of a committed cell, narrowed, with
    the port's YAML of the narrow model in `tmpdir`."""
    cell, config, traffic = copy.deepcopy(harness.cell_files(cell_name))
    config["model"].update(NARROW_MODEL)
    traffic.update(copy.deepcopy(NARROW_TRAIN_TRAFFIC
                                 if traffic["driver"] == "train"
                                 else NARROW_TRAFFIC))
    port_dir = os.path.join(harness.ROOT, "s4g_tpu_torch", "configs")
    with open(os.path.join(port_dir, f"{config['port_model']}.yaml")) as f:
        port = yaml.safe_load(f)
    port["MODEL"]["PN2"].update(NARROW_MODEL)
    path = os.path.join(tmpdir, f"{config['name']}_narrow.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(port, f)
    config["port_model"] = path
    return cell, config, traffic


def f32_files(cell_name: str, tmpdir: str) -> tuple:
    """`files` with an f32 compute dtype, where the port and the plain
    reference agree to f32 rounding."""
    cell, config, traffic = files(cell_name, tmpdir)
    config["model"]["COMPUTE_DTYPE"] = "float32"
    with open(config["port_model"]) as f:
        port = yaml.safe_load(f)
    port["MODEL"]["COMPUTE_DTYPE"] = "float32"
    with open(config["port_model"], "w") as f:
        yaml.safe_dump(port, f)
    return cell, config, traffic

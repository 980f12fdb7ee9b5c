"""The readings a cell's limits are set from, in one process:

    python3 grasp_bench/calibrate.py --workload <cell> --seeds 1 2 3 ... \
        --control-seeds 1 2 3 [--kinds control half_batch] \
        [--faults all_invalid no_grasps] [--seconds 6]

For each of `--seeds` a run of the program with a short window, judged as
the benchmark's runs are (its worst number over the sampled scenes); for
each of `--control-seeds` the control: the plain reference put in the
program's place one precision step below the configuration's (fp8 matmul
operands for the bf16 ones, bf16 values for the f32 ones;
`reference.precision.control`; for a training cell also "half_batch",
the stated precision on half of each batch), on the same inputs,
judged the same way; for each of `--faults` (`faults.py`) and each
control seed, a run of the program with that fault planted.  Prints one
JSON line per reading and a summary (the largest program reading and the
smallest control or fault reading of each number).  The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from grasp_bench import (check, faults, harness, scenes,  # noqa: E402
                         train_check, weights)
from grasp_bench.reference.precision import control  # noqa: E402


def stand_in_numbers(cell_name: str, seed: int, device: str, kind: str,
                     files=None) -> dict:
    """The worst numbers of the reference put in the program's place on
    what a run of `seed` would check: `kind` "control" (one precision step
    below the configuration's) for every cell, "half_batch" (the stated
    precision on half of every batch's rows) for a training cell."""
    import importlib
    import tempfile
    cell, config, traffic = files or harness.cell_files(cell_name)
    mod = importlib.import_module(f"grasp_bench.drivers.{traffic['driver']}")
    if traffic["driver"] == "train":
        with tempfile.TemporaryDirectory() as tmp:
            drv = mod.Driver(cell, config, traffic, seed, device, False, tmp)
            drv.root = drv._write_scenes()
            drv.sd = weights.make(config["model"], seed, device)
            return train_check.judge(drv, train_check.stand_in(drv, kind),
                                     detail=True)
    drv = mod.Driver(cell, config, traffic, seed, device, False, None)
    drv.pool = scenes.scene_pool(seed, traffic)
    sd = weights.make(config["model"], seed, device)
    ctrl = [check.control_scene(scene, sd, config["model"], traffic,
                                control(config["model"]))
            for _, _, scene in drv.inputs()]
    return check.judge(ctrl, sd, config["model"], traffic, detail=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--kinds", nargs="*", default=["control"],
                    help="stand-ins: control, and half_batch for training")
    ap.add_argument("--faults", nargs="*", default=[],
                    choices=sorted(faults.PLANTS),
                    help="faults planted in the program, on the control seeds")
    ap.add_argument("--seconds", type=float, default=6.0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    prog, ctrl = [], []
    for seed in args.seeds:
        t = time.perf_counter()
        res = harness.run_cell(args.workload, seed, args.seconds, False,
                               "cuda", log=lambda s: None, detail=True)
        nums = res["detail"]
        prog.append(nums)
        print(json.dumps({"program": seed, "correct": res["correct"],
                          "numbers": nums, "metrics": res["metrics"],
                          "s": time.perf_counter() - t}), flush=True)
    for kind in args.kinds:
        for seed in args.control_seeds:
            t = time.perf_counter()
            nums = stand_in_numbers(args.workload, seed, "cuda", kind)
            ctrl.append((kind, nums))
            print(json.dumps({kind: seed, "numbers": nums,
                              "s": time.perf_counter() - t}), flush=True)
    for fault in args.faults:
        for seed in args.control_seeds:
            t = time.perf_counter()
            with faults.planted(fault):
                res = harness.run_cell(args.workload, seed, args.seconds,
                                       False, "cuda", log=lambda s: None,
                                       detail=True)
            ctrl.append((fault, res["detail"]))
            print(json.dumps({fault: seed, "correct": res["correct"],
                              "numbers": res["detail"],
                              "s": time.perf_counter() - t}), flush=True)
    names = prog[0] if prog else ctrl[0][1] if ctrl else {}
    kinds = [*args.kinds, *args.faults] if args.control_seeds else []
    summary = {k: {"program_max": max((p[k] for p in prog), default=None),
                   **{f"{kind}_min": min(c[k] for kd, c in ctrl if kd == kind)
                      for kind in kinds}}
               for k in names}
    print(json.dumps({"workload": args.workload, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

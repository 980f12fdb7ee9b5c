"""`calibrate.py` for a cell whose driver carries its own control
(`Driver.control`, as `drivers/detect_batch_edge.py` does): the same
arguments, readings and summary, with the control taken from the cell's
driver.

    python3 grasp_bench/calibrate_edge.py --workload <cell> --seeds 1 2 3 \
        --control-seeds 1 2 3 [--faults altered no_grasps] [--seconds 6]
"""

from __future__ import annotations

import importlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from grasp_bench import calibrate, harness  # noqa: E402

_PN2_STAND_IN = calibrate.stand_in_numbers


def stand_in_numbers(cell_name: str, seed: int, device: str, kind: str,
                     files=None) -> dict:
    """The driver's `control()` for kind "control" where the cell's driver
    has one; `calibrate.stand_in_numbers` otherwise."""
    cell, config, traffic = files or harness.cell_files(cell_name)
    mod = importlib.import_module(f"grasp_bench.drivers.{traffic['driver']}")
    if kind != "control" or not hasattr(mod.Driver, "control"):
        return _PN2_STAND_IN(cell_name, seed, device, kind, files)
    return mod.Driver(cell, config, traffic, seed, device, False,
                      None).control()


def main(argv=None) -> int:
    calibrate.stand_in_numbers = stand_in_numbers
    try:
        return calibrate.main(argv)
    finally:
        calibrate.stand_in_numbers = _PN2_STAND_IN


if __name__ == "__main__":
    sys.exit(main())

"""A short run of a cell through the command on the card:

    python3 -m pytest -m cuda grasp_bench/tests/test_grasp_bench_cuda.py

Skips without a CUDA device (decided inside the test)."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.mark.cuda
@pytest.mark.parametrize("cell, trace", [("curvature.detect.vga", 1),
                                         ("curvature.train.b2", 0)])
def test_a_short_run_on_the_card(cell, trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    out = subprocess.run(
        [sys.executable, "grasp_bench/run.py", "--workload", cell, "--seed",
         str(2 ** 33 + 7), "--seconds", "8", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert result["metrics"]

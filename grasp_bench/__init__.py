"""The benchmark of the PyTorch and CUDA port (`s4g_tpu_torch`) on one
NVIDIA H100: `python3 grasp_bench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`.  See `harness.py`."""

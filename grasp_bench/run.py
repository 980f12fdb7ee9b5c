"""Run one cell of the benchmark of `s4g_tpu_torch` once:

    python3 grasp_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA devices.
Prints the result as one JSON line, the last of standard output, and the
numbers of the check beside their limits as the last lines of standard
error.  Exits non-zero, printing no result, without enough CUDA devices,
or if JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "grasp_bench", "_cache")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # Kernel caches inside the checkout, at fixed paths.
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    sys.path.insert(0, ROOT)
    from grasp_bench import harness
    cell, _, _ = harness.cell_files(args.workload)
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    result = harness.run_cell(
        args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
        T_START, log=lambda s: print(s, file=sys.stderr, flush=True))
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"loaded JAX or the JAX package: {loaded}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

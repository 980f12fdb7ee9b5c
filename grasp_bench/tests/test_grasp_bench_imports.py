"""The benchmark loads neither JAX nor the JAX package, and its plain
reference nothing of the program."""

import ast
import os
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "s4g_tpu"}
NO_PROGRAM = ("reference", "check.py", "train_check.py", "peaks.py",
              "flops.py", "scenes.py", "weights.py")


def _imports(path):
    """Top-level names of the absolute modules a source file imports."""
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_jax_or_the_jax_package():
    bad = {p: n for p in _sources() for n in _imports(p) if n in FORBIDDEN}
    assert not bad


def test_the_yardstick_imports_nothing_of_the_program():
    bad = {}
    for name in NO_PROGRAM:
        paths = ([os.path.join(BENCH, name)] if name.endswith(".py")
                 else _sources(name))
        for p in paths:
            names = set(_imports(p))
            if names & (FORBIDDEN | {"s4g_tpu_torch"}):
                bad[p] = names
    assert not bad


def test_a_run_loads_no_jax_module():
    """Every module of the harness, drivers and readers imported in a fresh
    interpreter, then the program's entry points the drivers use: no
    forbidden top-level module is loaded."""
    code = (
        "import sys, pkgutil, importlib\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "import grasp_bench\n"
        "for m in pkgutil.walk_packages(grasp_bench.__path__, "
        "'grasp_bench.'):\n"
        "    if '.tests' not in m.name and not m.name.endswith('.run'):\n"
        "        importlib.import_module(m.name)\n"
        "import s4g_tpu_torch.pipeline.detector, s4g_tpu_torch.train.trainer\n"
        "import s4g_tpu_torch.runtime.loader, s4g_tpu_torch._build\n"
        "from grasp_bench import harness\n"
        "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"

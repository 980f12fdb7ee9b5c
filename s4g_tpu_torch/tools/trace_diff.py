r"""Diff two per-kernel device-time tables from `trace_forward --json`
(port of tools/trace_diff.py).

Normalizes each side to ms/SCENE (divides by its batch) and prints the
class deltas, so what a batch adds per scene can be attributed in one
command:

    python -m s4g_tpu_torch.tools.trace_forward --json t1.json
    python -m s4g_tpu_torch.tools.trace_forward --batch 2 --json t2.json
    python -m s4g_tpu_torch.tools.trace_diff t1.json t2.json

Entries are grouped by class name: the JAX tool's rule (`[.\-_]?\d+`
removed, which merged XLA op instances such as "fusion.12" into one
class), applied only outside a name's `<...>` and `(...)` groups.  A CUDA
kernel's name is the same in both programs, and its template arguments
tell its instances apart (`mlp_wg_kernel<64>` and `mlp_wg_kernel<128>` are
two widths and stay two classes), while digits in the name itself (tile
shapes such as `..._tilesize128x128x32_...`, `sm90`) are variants of one
class.  On names without such groups (XLA's) the classes are the JAX
tool's.
"""

from __future__ import annotations

import argparse
import json
import re
from collections import defaultdict


def _class_name(name: str) -> str:
    """`name` with the digits of its outermost text (outside `<...>` and
    `(...)`) stripped by the JAX tool's rule."""
    parts, depth, start = [], 0, 0
    for i, ch in enumerate(name):
        if ch in "<(":
            if depth == 0:
                parts.append(re.sub(r"[.\-_]?\d+", "", name[start:i]))
                start = i
            depth += 1
        elif ch in ">)" and depth:
            depth -= 1
            if depth == 0:
                parts.append(name[start:i + 1])
                start = i + 1
    tail = name[start:]
    parts.append(tail if depth else re.sub(r"[.\-_]?\d+", "", tail))
    return "".join(parts).strip("%. ")


def _classes(table: dict) -> dict:
    out = defaultdict(float)
    for name, ms in table.items():
        out[_class_name(name) or name] += ms
    return out


def main(argv=None) -> list:
    """Returns the printed lines."""
    p = argparse.ArgumentParser()
    p.add_argument("a", help="baseline table json (e.g. batch 1)")
    p.add_argument("b", help="comparison table json (e.g. batch 2)")
    p.add_argument("--top", type=int, default=25)
    args = p.parse_args(argv)

    with open(args.a) as f:
        ta = json.load(f)
    with open(args.b) as f:
        tb = json.load(f)
    ba, bb = max(ta.get("batch", 1), 1), max(tb.get("batch", 1), 1)

    la = ta["leaf_ms_per_exec"] / ba
    lb = tb["leaf_ms_per_exec"] / bb
    lines = [f"leaf ms/scene: a(b={ba}) {la:.3f}   b(b={bb}) {lb:.3f}   "
             f"delta {lb - la:+.3f}"]

    ca = {k: v / ba for k, v in _classes(ta["ms_per_exec"]).items()}
    cb = {k: v / bb for k, v in _classes(tb["ms_per_exec"]).items()}
    keys = set(ca) | set(cb)
    rows = sorted(keys, key=lambda k: -abs(cb.get(k, 0.0) - ca.get(k, 0.0)))
    lines.append(f"{'op class':<58}{'a ms/sc':>9}{'b ms/sc':>9}{'delta':>9}")
    for k in rows[:args.top]:
        va, vb = ca.get(k, 0.0), cb.get(k, 0.0)
        if abs(vb - va) < 5e-4:
            continue
        lines.append(f"{k[:57]:<58}{va:9.3f}{vb:9.3f}{vb - va:+9.3f}")
    for line in lines:
        print(line)
    return lines


if __name__ == "__main__":
    main()

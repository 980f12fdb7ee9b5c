"""Summarize a directory of the port tools' logs into one table (port of
tools/r3_summarize.py, named as the JAX tool for a reader who looks for
its counterpart).

Parses the last JSON line each measure tool prints (measure_batch,
measure_stream, parity_at_speed) and the trace tools' headline, `=== device kernel time: X ms/exec`
(`trace_forward`), from DIR/*.log, and prints a compact JSON + markdown
summary.  A log whose name starts with "trace" is read for the headline.

Usage: python -m s4g_tpu_torch.tools.r3_summarize DIR
"""

from __future__ import annotations

import json
import os
import re
import sys


def last_json(path):
    try:
        with open(path, errors="replace") as f:
            lines = f.readlines()
    except OSError:
        return None
    for line in reversed(lines):
        line = line.strip()
        if line.startswith("{") and line.endswith("}"):
            try:
                return json.loads(line)
            except json.JSONDecodeError:
                continue
    return None


def trace_headline(path):
    try:
        with open(path, errors="replace") as f:
            text = f.read()
    except OSError:
        return None
    hits = re.findall(r"device kernel time: ([0-9.]+) ms/exec", text)
    return float(hits[-1]) if hits else None


def main(argv=None) -> dict:
    """Returns the rows by step (the log's name without ".log")."""
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        raise SystemExit("usage: python -m s4g_tpu_torch.tools.r3_summarize "
                         "DIR")
    out = argv[0]
    rows = {}
    for name in sorted(os.listdir(out)):
        if not name.endswith(".log"):
            continue
        step = name[:-4]
        path = os.path.join(out, name)
        if step.startswith("trace"):
            ms = trace_headline(path)
            rows[step] = {"device_ms_per_exec": ms} if ms is not None else None
        else:
            rows[step] = last_json(path)

    print(json.dumps(rows, indent=1))
    print()
    print("| step | headline |")
    print("|---|---|")
    for step, data in rows.items():
        if data is None:
            head = "(no parsable output — check the log)"
        elif "device_ms_per_exec" in data:
            head = f"{data['device_ms_per_exec']:.3f} ms device/exec"
        elif "e2e_ms_per_scene" in data:
            head = (f"b={data.get('batch', '?')}: "
                    f"fwd {data.get('fwd_ms_per_scene')} ms/scene, "
                    f"e2e {data.get('e2e_ms_per_scene')} ms/scene, "
                    f"{data.get('scenes_per_sec')} scenes/s")
        else:
            keys = [k for k in data if isinstance(data[k], (int, float))][:4]
            head = ", ".join(f"{k}={data[k]}" for k in keys) or str(data)[:80]
        print(f"| {step} | {head} |")
    return rows


if __name__ == "__main__":
    main()

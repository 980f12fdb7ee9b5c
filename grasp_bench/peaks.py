"""Published peaks of one NVIDIA H100 SXM (NVIDIA data sheet, dense, at
the 700 W power limit), and the least time a piece of work can take."""

from __future__ import annotations

PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12}
PEAK_BYTES = 3.35e12
MFU_PEAK = PEAK_FLOPS["bf16"]


def bound_s(work: dict) -> float:
    """Least seconds for `work`: {"f32": operations, "bf16": operations,
    "bytes": traffic}; the operations of each type at its peak, against
    the bytes at the memory's."""
    t_ops = sum(work.get(kind, 0.0) / peak
                for kind, peak in PEAK_FLOPS.items())
    return max(t_ops, work.get("bytes", 0.0) / PEAK_BYTES)

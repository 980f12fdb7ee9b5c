"""K8, the fixed-order backward of a row gather: one f32 add per source
element (P x C); the source gradients and their row lists read once, the
destination rows written once (a copy of `chip_smoke.py`'s count)."""

NAMES = ("gather_backward_kernel",)
BYTES = {0: 4, 1: 2, 2: 8}    # the launcher's dtype codes: f32, bf16, f64


def work(args, cfg):
    grad, rows, c, dtype = args[0], args[3], args[4], args[5]
    p = grad.shape[0]
    es = BYTES[dtype]
    return {"f32": float(p * c),
            "bytes": (p + rows) * c * es + 4.0 * (p + rows + 1)}

"""Model FLOPs of one scene's forward, counted from the configuration's
shapes: 2 per multiply-add of every dense layer (the SA stages over all
K neighbour slots of every centroid, the FP stages over every dense
point, the four heads and their logit layers over every input point).
The 3-NN, ball-query and FPS arithmetic is not model FLOPs."""

from __future__ import annotations

from .reference.model import param_shapes


def forward_flops(cfg: dict) -> float:
    """FLOPs of one forward of one scene (a train step counts 3x)."""
    rows = {}
    for i, (m, k) in enumerate(zip(cfg["NUM_CENTROIDS"],
                                   cfg["NUM_NEIGHBOURS"])):
        rows[f"sa_modules.{i}."] = m * k
    dense = [cfg["NUM_INPUT"], *cfg["NUM_CENTROIDS"]]
    for i in range(len(cfg["FP_CHANNELS"])):
        rows[f"fp_modules.{i}."] = dense[-2 - i]
    total = 0.0
    for name, shape in param_shapes(cfg).items():
        if not name.endswith("weight") or ".bn." in name:
            continue
        r = next((v for p, v in rows.items() if name.startswith(p)),
                 cfg["NUM_INPUT"])
        total += 2.0 * r * shape[0] * shape[1]
    return total

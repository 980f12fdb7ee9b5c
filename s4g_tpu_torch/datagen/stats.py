"""Label statistics over merged training pickles (a copy of
s4g_tpu/datagen/stats.py).

One definition shared by the QA tool (tools/datagen_mesh_qa.py) and the
at-scale dataset tool (tools/train_at_scale.py), so their dataset_stats
JSONs stay comparable with each other and with the JAX tools'.
"""

from __future__ import annotations

import os
import pickle

import numpy as np


def per_view_stats(merged: dict) -> dict:
    """Core label stats for ONE merged view dict (see datagen/merge.py)."""
    search = np.asarray(merged["search_score"])
    anti = np.asarray(merged.get("antipodal_score", np.zeros(0)))
    return {
        "num_labeled_grasp_points": int(search.shape[0]),
        "search_score_max": round(float(search.max()), 2)
        if search.size else 0.0,
        "frac_search_gt_50": round(float((search > 50).mean()), 4)
        if search.size else 0.0,
        "antipodal_max": round(float(anti.max()), 3) if anti.size else None,
    }


def dataset_statistics(data_dir: str) -> dict:
    """Aggregate per_view_stats over every merged pickle in a directory."""
    views = []
    for fname in sorted(os.listdir(data_dir)):
        if not fname.endswith(".p"):
            continue
        with open(os.path.join(data_dir, fname), "rb") as f:
            d = pickle.load(f)
        views.append({"view": fname, **per_view_stats(d)})
    labeled = [v["num_labeled_grasp_points"] for v in views]
    summary = {
        "num_views": len(views),
        "views_with_labels": int(sum(1 for n in labeled if n > 0)),
        "labeled_points_mean": round(float(np.mean(labeled)), 1)
        if labeled else 0.0,
        "labeled_points_min": int(min(labeled)) if labeled else 0,
        "labeled_points_max": int(max(labeled)) if labeled else 0,
        "search_score_max": max((v["search_score_max"] for v in views),
                                default=0.0),
        "antipodal_max": max((v["antipodal_max"] or 0.0 for v in views),
                             default=0.0),
    }
    return {"summary": summary, "views": views}

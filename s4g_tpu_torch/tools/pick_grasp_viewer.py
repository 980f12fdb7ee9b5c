"""Interactive pick-a-point grasp inspection (HTML) (port of
tools/pick_grasp_viewer.py; numpy only).

The reference workflow (reference: data_gen/visualize_single_grasp.py:1-61,
README.md:81-96) opens an Open3D editing window, lets the user shift-click a
point, and renders that point's grasp frames.  This tool produces the same
workflow as a self-contained HTML file (works headless / over ssh): jet
score-colored cloud, labeled points ringed, shift-click one to see its
gripper wireframes and 4x4 poses.

Usage:
    python -m s4g_tpu_torch.tools.pick_grasp_viewer --data scene_view.p \
        --out viewer.html
"""

from __future__ import annotations

import argparse

import numpy as np


def build_viewer(data_path: str, out_path: str, max_frames_per_point: int = 6,
                 max_points: int = 40000) -> str:
    from ..train.dataset import scene_quality_score
    from ..utils.html_viewer import export_interactive_viewer

    data = dict(np.load(data_path, allow_pickle=True))
    cloud = np.asarray(data["point_cloud"]).T                 # (n, 3)
    valid_index = np.asarray(data["valid_index"]).astype(np.int64)
    search = np.asarray(data["search_score"], np.float64)
    antipodal = np.asarray(data["antipodal_score"], np.float64)
    frames = np.asarray(data["valid_frame"], np.float64)

    quality = scene_quality_score(search, antipodal)
    point_scores = np.zeros(len(cloud))
    frames_per_point = []
    if quality.ndim > 1:                                      # (g, L, T) grid
        flat_q = quality.reshape(len(valid_index), -1)
        order = np.argsort(-flat_q, axis=1)[:, :max_frames_per_point]
        flat_f = frames.reshape(len(valid_index), -1, 4, 4)
        for gi in range(len(valid_index)):
            keep = order[gi][flat_q[gi, order[gi]] > 0]
            if keep.size == 0:
                keep = order[gi][:1]
            frames_per_point.append(flat_f[gi, keep])
        point_scores[valid_index] = np.clip(flat_q.max(axis=1), 0, 1)
    else:                                                     # one frame each
        frames_per_point = [frames[gi][None] for gi in
                            range(len(valid_index))]
        point_scores[valid_index] = np.clip(quality, 0, 1)

    return export_interactive_viewer(
        out_path, cloud, scores=point_scores,
        grasp_point_indices=valid_index,
        frames_per_point=frames_per_point, max_points=max_points)


def main(argv=None) -> str:
    """Returns the path written."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--data", required=True,
                        help="training-data pickle ({scene}_view_{v}.p)")
    parser.add_argument("--out", default="grasp_viewer.html")
    parser.add_argument("--max-frames", type=int, default=6,
                        help="top frames shown per picked point")
    args = parser.parse_args(argv)
    path = build_viewer(args.data, args.out, args.max_frames)
    print(f"wrote {path} — open in any browser; shift-click a ringed point")
    return path


if __name__ == "__main__":
    main()

"""Visualize a training-data pickle: score-colored cloud + top grasp hands
(port of tools/visualize_scored_grasp.py; numpy only).

Re-design of the reference's Open3D GUI tools (reference:
data_gen/utils/visualize_scored_grasp.py, data_gen/visualize_single_grasp.py,
README.md:81-96) as headless PLY exporters: writes `scored_cloud.ply`
(jet-colored by per-point quality) and `grasp_hands.ply` (gripper meshes of
the top grasps) for any mesh viewer.

Usage:
    python -m s4g_tpu_torch.tools.visualize_scored_grasp --data scene_view.p \
        --out out_dir
    python -m s4g_tpu_torch.tools.visualize_scored_grasp --data scene_view.p \
        --point 123
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None) -> str:
    """Returns the output directory."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--data", required=True,
                        help="training-data pickle ({scene}_view_{v}.p)")
    parser.add_argument("--out", default="./output_vis")
    parser.add_argument("--top", type=int, default=10)
    parser.add_argument("--point", type=int, default=None,
                        help="visualize grasps of ONE labeled point "
                             "(the reference's pick-a-point mode)")
    args = parser.parse_args(argv)

    from ..pipeline.file_logger import _jet
    from ..train.dataset import scene_quality_score
    from ..utils.grasp_visualizer import GraspVisualizer
    from ..utils.io_ply import write_ply_points

    data = dict(np.load(args.data, allow_pickle=True))
    cloud = np.asarray(data["point_cloud"]).T          # (n, 3)
    valid_index = np.asarray(data["valid_index"])
    search = np.asarray(data["search_score"], np.float64)
    antipodal = np.asarray(data["antipodal_score"], np.float64)
    frames = np.asarray(data["valid_frame"])

    quality = scene_quality_score(search, antipodal)
    if quality.ndim > 1:
        flat_q = quality.reshape(len(valid_index), -1)
        best_cell = np.argmax(flat_q, axis=1)
        quality = flat_q[np.arange(len(valid_index)), best_cell]
        frames = frames.reshape(len(valid_index), -1, 4, 4)[
            np.arange(len(valid_index)), best_cell]

    os.makedirs(args.out, exist_ok=True)
    point_scores = np.zeros(len(cloud))
    point_scores[valid_index] = np.clip(quality, 0, 1)
    write_ply_points(os.path.join(args.out, "scored_cloud.ply"), cloud,
                     colors=_jet(point_scores))

    viz = GraspVisualizer(cloud)
    if args.point is not None:
        sel = np.nonzero(valid_index == args.point)[0]
        print(f"point {args.point}: {len(sel)} grasps")
        for g in sel:
            viz.add_single_pose(frames[g])
    else:
        order = np.argsort(-quality)[:args.top]
        for g in order:
            viz.add_single_pose(frames[g])
        print(f"top-{len(order)} grasps, best quality "
              f"{quality[order[0]]:.3f}" if len(order) else "no grasps")
    viz.save(os.path.join(args.out, "cloud.ply"),
             os.path.join(args.out, "grasp_hands.ply"))
    print(f"wrote {args.out}/scored_cloud.ply and {args.out}/grasp_hands.ply")
    return args.out


if __name__ == "__main__":
    main()

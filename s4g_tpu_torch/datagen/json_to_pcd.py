"""JSON capture -> scaled point-cloud PLY converter (a numpy copy of
s4g_tpu/datagen/json_to_pcd.py, over the port's utils/io_ply.py).

Part of the real-robot capture loop: object scans arrive as JSON lists of
``{"v": [x, y, z], "n": [nx, ny, nz]}`` records; this expands each object
into its per-scale PLY variants named ``{object}#{k}.ply`` (k enumerates the
object's scale list), with normals preserved (uniform scaling leaves unit
normals unchanged).

Re-design of the reference converter (reference:
data_gen/utils/json_to_pcd.py:1-45, scale table from
data_gen/configs/not_used_config.py:1-55) without the Open3D dependency.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..utils.io_ply import write_ply_points

# Per-object scale variants (reference: configs/not_used_config.py:1-55).
NAME_SCALE: Dict[str, List[float]] = {
    "002_master_chef_can": [0.5, 0.8, 1.0, 1.2],
    "003_cracker_box": [0.5, 0.8, 1.0],
    "004_sugar_box": [0.8, 1.0, 1.2, 1.5],
    "005_tomato_soup_can": [0.5, 0.7, 0.9],
    "006_mustard_bottle": [0.5, 0.8, 1.0, 1.2],
    "007_tuna_fish_can": [0.8, 1.0, 1.2, 1.5],
    "008_pudding_box": [0.8, 1.0, 1.2, 1.5],
    "009_gelatin_box": [0.8, 1.0, 1.2, 1.5, 2.0],
    "010_potted_meat_can": [0.5, 0.8, 1.0],
    "011_banana": [0.8, 1.0, 1.2, 1.5, 2.0],
    "012_strawberry": [0.8, 1.0, 1.2, 1.5, 2.0],
    "013_apple": [0.5, 0.8, 1.0],
    "014_lemon": [0.8, 1.0, 1.2],
    "015_peach": [0.8, 1.0, 1.2],
    "016_pear": [0.5, 0.8, 1.0, 1.2],
    "017_orange": [0.5, 0.8],
    "018_plum": [0.8, 1.0, 1.2],
    "019_pitcher_base": [0.6, 0.8, 1.0],
    "021_bleach_cleanser": [0.8, 1.0],
    "024_bowl": [0.8, 1.0, 1.2],
    "025_mug": [0.8, 1.0, 1.2, 1.5, 2.0],
    "026_sponge": [1.0, 1.2, 1.5, 2.0, 3.0, 4.0],
    "029_plate": [0.8, 1.0, 1.2],
    "033_spatula": [0.8, 1.0, 1.2],
    "035_power_drill": [0.6, 0.8, 1.0, 1.2],
    "036_wood_block": [0.3, 0.5, 0.8],
    "038_padlock": [1.0, 1.2, 1.5, 2],
    "040_large_marker": [0.8, 1.0, 1.2, 1.5],
    "044_flat_screwdriver": [0.8, 1.0, 1.2],
    "048_hammer": [0.8, 1.0, 1.2],
    "051_large_clamp": [0.8, 1.0, 1.2],
    "053_mini_soccer_ball": [0.2, 0.4, 0.7],
    "054_softball": [0.4, 0.6],
    "055_baseball": [0.5, 0.8, 1.0],
    "056_tennis_ball": [0.5, 0.8, 1.0],
    "057_racquetball": [0.8, 1.0, 1.2],
    "058_golf_ball": [0.8, 1.0, 1.2, 1.5],
    "061_foam_brick": [0.8, 1.0, 1.2],
    "063-a_marbles": [0.8, 1.0, 1.2],
    "065-a_cups": [0.8, 1.0],
    "065-b_cups": [0.8, 1.0],
    "065-c_cups": [0.8, 1.0],
    "065-d_cups": [0.8, 1.0],
    "065-e_cups": [0.8, 1.0],
    "065-f_cups": [0.5, 0.8],
    "065-g_cups": [1.0, 1.2],
    "065-h_cups": [0.8, 1.0],
    "065-i_cups": [1.0],
    "065-j_cups": [1.0],
    "071_nine_hole_peg_test": [0.8, 1.0, 1.2],
    "072-b_toy_airplane": [0.8, 1.0, 1.2],
    "072-c_toy_airplane": [0.8, 1.0, 1.2],
    "072-d_toy_airplane": [0.8, 1.0, 1.2],
    "072-e_toy_airplane": [0.8, 1.0, 1.2],
    "077_rubiks_cube": [0.8, 1.0],
}


def load_json_cloud(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read a capture JSON -> (points (N, 3), normals (N, 3)) float64."""
    with open(path) as f:
        records = json.load(f)
    points = np.asarray([r["v"] for r in records], dtype=np.float64)
    normals = np.asarray([r["n"] for r in records], dtype=np.float64)
    return points, normals


def convert_json_file(json_path: str, output_dir: str,
                      scales: Sequence[float]) -> List[str]:
    """One object JSON -> one PLY per scale variant; returns written paths."""
    name = os.path.splitext(os.path.basename(json_path))[0]
    points, normals = load_json_cloud(json_path)
    written = []
    for num, scale in enumerate(scales):
        out = os.path.join(output_dir, f"{name}#{num}.ply")
        write_ply_points(out, points * scale, normals=normals)
        written.append(out)
    return written


def convert_json_dir(json_dir: str, output_dir: str,
                     name_scale: Dict[str, List[float]] | None = None
                     ) -> List[str]:
    """Convert every known-object JSON in a directory (reference CLI loop,
    json_to_pcd.py:20-45): hidden files and objects outside the scale table
    are skipped."""
    name_scale = NAME_SCALE if name_scale is None else name_scale
    os.makedirs(output_dir, exist_ok=True)
    written: List[str] = []
    for filename in sorted(os.listdir(json_dir)):
        name = os.path.splitext(filename)[0]
        if name.startswith(".") or name not in name_scale:
            continue
        written.extend(convert_json_file(os.path.join(json_dir, filename),
                                         output_dir, name_scale[name]))
    return written


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--json_dir", "-j", required=True)
    p.add_argument("--pcd_dir", "-p", required=True)
    args = p.parse_args(argv)
    for path in convert_json_dir(args.json_dir, args.pcd_dir):
        print(path)


if __name__ == "__main__":
    main()

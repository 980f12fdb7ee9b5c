"""Dataset registry: YCB object inventory, push directions, color labels.

Mirrors the reference's dataset config surface (reference:
data_gen/configs/dataset_config.py:1-90).  The 118-instance inventory is
stored compactly as {ycb_object: scale-variant indices} and expanded to the
reference's "name#variant" convention.

A numpy copy of s4g_tpu/datagen/dataset_config.py: the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import numpy as np

# {YCB object id: tuple of scale-variant suffixes}
_VARIANTS = {
    "002_master_chef_can": (0,),
    "003_cracker_box": (0,),
    "004_sugar_box": (0, 1, 2),
    "005_tomato_soup_can": (0, 1, 2),
    "006_mustard_bottle": (0, 1, 2, 3),
    "007_tuna_fish_can": (0, 1, 2, 3),
    "008_pudding_box": (0, 1, 2, 3),
    "009_gelatin_box": (0, 1, 2, 3),
    "010_potted_meat_can": (0, 1, 2),
    "011_banana": (0, 1, 2, 3),
    "012_strawberry": (0, 1, 2, 3),
    "013_apple": (0, 1),
    "014_lemon": (0, 1, 2),
    "015_peach": (0, 1),
    "016_pear": (0, 1),
    "017_orange": (0, 1),
    "018_plum": (0, 1, 2),
    "019_pitcher_base": (0, 1, 2),
    "021_bleach_cleanser": (0, 1),
    "024_bowl": (0, 1, 2),
    "025_mug": (0, 1, 2, 3, 4),
    "026_sponge": (0, 1, 2, 3, 4),
    "029_plate": (0, 1, 2),
    "033_spatula": (0, 1, 2),
    "035_power_drill": (0, 1, 2, 3),
    "036_wood_block": (0, 1),
    "038_padlock": (0, 1, 2),
    "040_large_marker": (0, 1, 2, 3),
    "044_flat_screwdriver": (0, 1, 2),
    "048_hammer": (0, 1, 2),
    "053_mini_soccer_ball": (0, 1),
    "054_softball": (0, 1),
    "055_baseball": (0, 1),
    "056_tennis_ball": (1,),
    "057_racquetball": (0, 1),
    "058_golf_ball": (0, 1),
    "063-a_marbles": (0, 1, 2),
    "065-a_cups": (0, 1),
    "065-b_cups": (1,),
    "065-c_cups": (1,),
    "065-d_cups": (1,),
    "065-f_cups": (1,),
    "065-h_cups": (0,),
    "071_nine_hole_peg_test": (0, 1, 2),
    "072-b_toy_airplane": (1, 2),
    "072-c_toy_airplane": (1, 2),
    "077_rubiks_cube": (0, 1),
}

NAME_LIST = sorted(f"{obj}#{v}" for obj, variants in _VARIANTS.items()
                   for v in variants)

# Movability probe directions: +-x, +-y, +z (reference dataset_config.py:57).
DIR_LIST = [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1)]

ROUND_FACTOR = 3
TABLE_COLOR = np.array([1.0, 0.6, 0.0])
TABLE_LABEL = len(NAME_LIST)

# Label i -> color (p, 1-p, p^2) with p = i / num_labels; the red channel
# alone recovers the label (reference dataset_config.py:80-90).
NAME_TO_INDEX = {name: i for i, name in enumerate(NAME_LIST)}
NAME_TO_COLOR = {
    name: np.array([i / len(NAME_LIST), 1 - i / len(NAME_LIST),
                    (i / len(NAME_LIST)) ** 2])
    for name, i in NAME_TO_INDEX.items()}
NAME_TO_COLOR["table"] = TABLE_COLOR


def color_array_to_label(color_array: np.ndarray) -> np.ndarray:
    """Recover labels from the red channel."""
    return np.rint(color_array[:, 0] * len(NAME_LIST)).astype(np.int64)


def label_to_color(labels: np.ndarray) -> np.ndarray:
    """Inverse of the label color encoding (objects only)."""
    p = np.asarray(labels, np.float64) / len(NAME_LIST)
    return np.stack([p, 1 - p, p ** 2], axis=1)

"""Parallel-gripper geometry constants (a copy of
s4g_tpu/configs/gripper_config.py).

Values match the reference gripper (reference:
inference/grasp_proposal/configs/gripper_config.py:9-30), expressed as plain
numpy.

Gripper local frame convention: +x is the approach direction (out of the palm
toward the fingertips), ±y spans the finger opening, ±z is hand thickness.
"""

import numpy as np

HALF_BOTTOM_WIDTH = 0.057
BOTTOM_LENGTH = 0.16
FINGER_WIDTH = 0.023
HALF_HAND_THICKNESS = 0.012
FINGER_LENGTH = 0.09

# Derived
HAND_LENGTH = BOTTOM_LENGTH + BOTTOM_LENGTH
HALF_BOTTOM_SPACE = HALF_BOTTOM_WIDTH - FINGER_WIDTH

# Homogeneous corners of the gripper bounding box, (4, 8): the 8 combinations
# of x in {FINGER_LENGTH, -BOTTOM_LENGTH}, y in ±HALF_BOTTOM_WIDTH,
# z in ±HALF_HAND_THICKNESS.
GRIPPER_BOUND = np.ones([4, 8])
_i = 0
for _x in (FINGER_LENGTH, -BOTTOM_LENGTH):
    for _y in (HALF_BOTTOM_WIDTH, -HALF_BOTTOM_WIDTH):
        for _z in (HALF_HAND_THICKNESS, -HALF_HAND_THICKNESS):
            GRIPPER_BOUND[0:3, _i] = [_x, _y, _z]
            _i += 1
del _i, _x, _y, _z

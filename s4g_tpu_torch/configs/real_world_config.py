"""Real-robot camera/table calibration constants (a copy of
s4g_tpu/configs/real_world_config.py).

Mirrors the reference's hardware-setup module (reference:
inference/grasp_proposal/configs/real_world_config.py:9-33).  The published
example extrinsics are kept so the verticality filter and robot-frame
mapping behave identically; adapt `camera2table` / `camera2base` per
deployment (precision is not critical — they only gate the grasp-approach
verticality check and the planner's table pose).
"""

from __future__ import annotations

import numpy as np

# Table footprint (length, width); populated per deployment.
table_size: tuple = ()

# Highest expected clutter above the table plane, meters.
max_height = 0.4

_CAMERA_EXTRINSICS = np.array([
    [-0.00377177, 0.54720216, -0.83699198, 0.766],
    [0.99981506, -0.01372054, -0.01347562, -0.276],
    [-0.01885787, -0.83688801, -0.54704921, 0.62],
    [0.0, 0.0, 0.0, 1.0],
])

# Camera frame -> table-centre frame (x along table length, y along width).
camera2table = _CAMERA_EXTRINSICS
# Camera frame -> robot base frame (same rig in the published setup).
camera2base = _CAMERA_EXTRINSICS.copy()

# Derived inverses + workspace boxes (low_x, high_x, low_y, high_y, ...).
workspace = [-0.4, 0.4, -0.6, 0.1, -0.08, 0.5]
target_space = [-0.4, 0.4, -0.6, -0.15, -0.06, 0.4]
table2camera = np.linalg.inv(camera2table)
base2camera = np.linalg.inv(camera2base)

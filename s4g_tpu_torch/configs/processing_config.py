"""Point-cloud processing + grasp-search constants (a copy of
s4g_tpu/configs/processing_config.py).

Numeric values mirror the reference's constant module (reference:
inference/grasp_proposal/configs/processing_config.py:14-75) but are built
with pure numpy so the 36-pose LOCAL_TO_LOCAL_SEARCH grid is a traceable
constant inside jitted TPU code (no host/device state).
"""

import math

import numpy as np

from .gripper_config import (  # noqa: F401  (re-exported like the reference)
    HALF_BOTTOM_WIDTH, BOTTOM_LENGTH, FINGER_WIDTH, HALF_HAND_THICKNESS,
    FINGER_LENGTH, HAND_LENGTH, HALF_BOTTOM_SPACE, GRIPPER_BOUND,
)

# --- Point-cloud pre-processing -------------------------------------------
TABLE_HEIGHT = 0.75
SAMPLE_REGION = TABLE_HEIGHT + 0.015
# (6,): low_x, high_x, low_y, high_y, low_z, high_z
WORKSPACE = [-0.40, 0.40, -0.4, 0.4, TABLE_HEIGHT - 0.001, TABLE_HEIGHT + 0.45]
WORKSPACE_SCENE = [-0.40, 0.40, -0.35, 0.35, TABLE_HEIGHT - 0.001, TABLE_HEIGHT + 0.45]
VOXEL_SIZE = 0.005
NUM_POINTS_THRESHOLD = 32
RADIUS_THRESHOLD = 0.02

# --- Scene point cloud ------------------------------------------------------
SCENE_MULTIPLE = 8  # density of the complete scene cloud relative to one view

# --- Normal estimation ------------------------------------------------------
NORMAL_RADIUS = 0.01
NORMAL_MAX_NN = 30

# --- Local frame search grid ------------------------------------------------
# Approach-depth offsets along -x and in-plane rotation sweep.  The inference
# stack uses 3 lengths x 12 thetas = 36 candidate poses per local frame.
LENGTH_SEARCH = [-0.55, -0.35, -0.15]
THICKNESS_SEARCH = [0]
THETA_SEARCH = [t / 57.29578 for t in range(-90, 90, 15)]
CURVATURE_RADIUS = 0.01
# If more than this many points sit behind the back of the hand, grasp fails.
BACK_COLLISION_THRESHOLD = 10 * math.sqrt(SCENE_MULTIPLE)
BACK_COLLISION_MARGIN = 0.0
FINGER_COLLISION_THRESHOLD = 10
CLOSE_REGION_MIN_POINTS = 50

# --- Antipodal grasp --------------------------------------------------------
NEIGHBOR_DEPTH = 0.005

# --- GPD projection ---------------------------------------------------------
GRASP_NUM = 600
PROJECTION_RESOLUTION = 60
PROJECTION_MARGIN = 1

# --- Precomputed search-pose grid -------------------------------------------
# INDEX_TO_ARRAY[i] = (length, theta, height) for flat search index i; the
# matching LOCAL_TO_LOCAL_SEARCH[i] maps the local Darboux frame into search
# pose i (translate by -length along x, -height along z, rotate theta about x).
INDEX_TO_ARRAY = [
    (length, theta, height)
    for length in LENGTH_SEARCH
    for theta in THETA_SEARCH
    for height in THICKNESS_SEARCH
]
GRASP_PER_LENGTH = len(THETA_SEARCH) * len(THICKNESS_SEARCH)


def _build_local_to_local_search() -> np.ndarray:
    arr = np.asarray(INDEX_TO_ARRAY, dtype=np.float64)  # (P, 3)
    num = arr.shape[0]
    grid = np.tile(np.eye(4), (num, 1, 1))
    grid[:, 0, 3] = -arr[:, 0]
    grid[:, 2, 3] = -arr[:, 2]
    cos_t, sin_t = np.cos(arr[:, 1]), np.sin(arr[:, 1])
    grid[:, 1, 1] = cos_t
    grid[:, 2, 2] = cos_t
    grid[:, 1, 2] = sin_t
    grid[:, 2, 1] = -sin_t
    return grid.astype(np.float32)


LOCAL_TO_LOCAL_SEARCH = _build_local_to_local_search()           # (P, 4, 4)
LOCAL_SEARCH_TO_LOCAL = np.linalg.inv(
    LOCAL_TO_LOCAL_SEARCH.astype(np.float64)).astype(np.float32)  # (P, 4, 4)
# Aliases kept for reference-API familiarity.
NUMPY_LOCAL_SEARCH_TO_LOCAL = LOCAL_SEARCH_TO_LOCAL

TABLE_COLLISION_OFFSET = 0.005

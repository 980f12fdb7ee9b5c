"""The one traffic generator: scenes made from a seed and a traffic file's
parameters.

The scene makers are copies of `chip_smoke.py`'s `tabletop_cloud`,
`clutter_cloud` and `train_scene` (a later change to the program cannot
move the yardstick), with their sizes taken from the traffic file.  Every
random draw comes from `rng(seed, stream)`: the same seed gives the same
scenes, and each seed gives scenes of the same sizes.
"""

from __future__ import annotations

import numpy as np


def rng(seed: int, *stream: int) -> np.random.RandomState:
    """A RandomState for `seed` (any whole number, also past 32 bits) and a
    stream id, independent across streams."""
    return np.random.RandomState(np.random.MT19937(
        np.random.SeedSequence([int(seed) % (1 << 64), *stream])))


def tabletop_cloud(rng, n_plane: int = 57000, n_box: int = 8000,
                   half_size=(0.55, 0.45)):
    """Seeded camera-frame tabletop, ~0.75 m from the camera: a plane (1.1 x
    0.9 m by default) plus five boxes (their tops and two sides), (n, 3)
    float32.  The default 65,000 points fit the 65,536-point capacity and
    keep ~26,600 voxels after the outlier filter, above the 25,600-point
    model input."""
    hx, hy = half_size
    xy = rng.uniform([-hx, -hy], [hx, hy], (n_plane, 2))
    parts = [np.column_stack([xy, 0.75 + 0.05 * xy[:, 1]])]
    per = n_box // 5
    for i in range(5):
        cx, cy = -0.3 + 0.15 * i, 0.1 * ((-1) ** i)
        sx, sy, h = 0.04 + 0.01 * i, 0.05, 0.05 + 0.03 * (i % 3)
        top = rng.uniform([-sx, -sy], [sx, sy], (per // 2, 2))
        parts.append(np.column_stack([cx + top[:, 0], cy + top[:, 1],
                                      np.full(per // 2, 0.75 - h)]))
        side = rng.uniform([-sx, 0.0], [sx, h], (per - per // 2, 2))
        ys = cy + np.where(rng.rand(len(side)) < 0.5, -sy, sy)
        parts.append(np.column_stack([cx + side[:, 0], ys,
                                      0.75 - side[:, 1]]))
    cloud = np.concatenate(parts)
    return (cloud + rng.normal(0.0, 0.001, cloud.shape)).astype(np.float32)


def clutter_cloud(rng, num_objects: int = 10, n_per_object: int = 450):
    """Seeded camera-frame clutter without a table (items on a wire shelf):
    4 cm objects ~0.7 m away, 15 cm apart."""
    grid = [(x, y) for y in (-0.1, 0.05) for x in np.linspace(-0.3, 0.3, 5)]
    parts = [np.array([x, y, rng.uniform(0.65, 0.75)])
             + rng.uniform(-0.02, 0.02, (n_per_object, 3))
             for x, y in grid[:num_objects]]
    return np.concatenate(parts).astype(np.float32)


def train_scene(rng, num_frames: int = 600, num_objects: int = 5, **tabletop):
    """A seeded scene in the training dump format: a camera-frame tabletop
    as `point_cloud` (3, N); `num_frames` of its points with grasp frames
    (random rotations, origins at the 0.02-0.08 m depth bins along the
    frame's x axis), search and antipodal scores, object labels and an
    (objects + 1, 5) pushed-distance `direction` table."""
    cloud = tabletop_cloud(rng, **tabletop)
    valid = rng.choice(len(cloud), num_frames, replace=False)
    q, r = np.linalg.qr(rng.randn(num_frames, 3, 3))
    q = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    q[np.linalg.det(q) < 0, :, 2] *= -1
    depth = rng.choice([0.02, 0.04, 0.06, 0.08], num_frames)
    frames = np.tile(np.eye(4), (num_frames, 1, 1))
    frames[:, :3, :3] = q
    frames[:, :3, 3] = cloud[valid] - depth[:, None] * q[:, :, 0]
    return {"point_cloud": cloud.T.copy(), "valid_index": valid,
            "valid_frame": frames.astype(np.float32),
            "search_score": rng.uniform(0, 30, num_frames).astype(np.float32),
            "antipodal_score": rng.uniform(0, 1, num_frames)
            .astype(np.float32),
            "objects_label": rng.randint(0, num_objects + 1, num_frames),
            "direction": rng.uniform(-0.05, 0.15, (num_objects + 1, 5))
            .astype(np.float32)}


SCENES = {"tabletop": tabletop_cloud, "clutter": clutter_cloud}


def scene_pool(seed: int, traffic: dict) -> list:
    """The traffic's pool of camera clouds: `pool` scenes of the kinds in
    `scenes` ([kind, {parameters}] pairs, cycled), scene i from stream
    (1, i) of `seed`."""
    kinds = traffic["scenes"]
    pool = []
    for i in range(traffic["pool"]):
        kind, params = kinds[i % len(kinds)]
        params = {k: tuple(v) if isinstance(v, list) else v
                  for k, v in params.items()}
        pool.append(SCENES[kind](rng(seed, 1, i), **params))
    return pool

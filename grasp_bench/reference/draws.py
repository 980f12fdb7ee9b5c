"""Replay of a detector's random draws from the seeds the benchmark gave
it.  A call of B scenes first fits each scene to the capacity (a cloud of
more points keeps a subset: numpy's `RandomState(seed).choice(n,
capacity, replace=False)`, scene by scene), then draws, scene by scene,
(capacity,) uniforms and (num_input,) positions in [0, 2^31 - 1) from the
torch generator, then (B, num_selected) uniforms for the grasps: the
detector's documented order (`GraspDetector.detect_batch`; `detect` and
each frame of `detect_stream` are calls of one scene)."""

from __future__ import annotations

import numpy as np
import torch


def replay(seed: int, device, calls: list, capacity: int, num_input: int,
           num_selected: int, wanted) -> dict:
    """`calls`: per call, its scenes' point counts.  Returns {call:
    ([(subset or None, uniforms, positions)] per scene, grasp uniforms
    (B, S))} for the calls in `wanted`, replaying every call before
    them."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    rng = np.random.RandomState(seed)
    out = {}
    for call, sizes in enumerate(calls[:max(wanted) + 1]):
        subsets = [rng.choice(n, capacity, replace=False) if n > capacity
                   else None for n in sizes]
        scenes = [(sub, torch.rand(capacity, generator=g, device=device),
                   torch.randint(0, 2 ** 31 - 1, (num_input,), generator=g,
                                 device=device)) for sub in subsets]
        uni = torch.rand((len(sizes), num_selected), generator=g,
                         device=device)
        if call in wanted:
            out[call] = (scenes, uni)
    return out

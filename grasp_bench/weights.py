"""Seeded random weights of a configuration, made on the device in two
large draws (one normal, one uniform) from a `torch.Generator` there, in
f32 (the type the detector's parameters are held in).  No trained
checkpoint is public in a form the benchmark may ship; random weights are
enough for speed and for the comparison with the reference, which gets
the same tensors.

Conv weights ~ N(0, 2 / fan_in) (He), logit weights ~ N(0, 1 / fan_in),
BatchNorm scale and running variance ~ U(0.8, 1.2), shift, running mean
and logit biases ~ N(0, 0.1^2)."""

from __future__ import annotations

import math

import torch

from .reference.model import param_shapes


def make(cfg: dict, seed: int, device) -> dict:
    shapes = param_shapes(cfg)
    normal = {k: s for k, s in shapes.items()
              if k.endswith(("conv.weight", "logit.weight", "logit.0.weight",
                             ".bias", "running_mean"))}
    uniform = {k: s for k, s in shapes.items()
               if k.endswith(("bn.weight", "running_var"))}
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    sizes = {k: math.prod(s) for k, s in shapes.items()}
    z = torch.randn(sum(sizes[k] for k in normal), generator=g, device=device)
    u = torch.rand(sum(sizes[k] for k in uniform), generator=g, device=device)
    sd, zi, ui = {}, 0, 0
    for k, s in shapes.items():
        if k in normal:
            t = z[zi:zi + sizes[k]].reshape(s)
            zi += sizes[k]
            if k.endswith("conv.weight"):
                t = t * math.sqrt(2.0 / math.prod(s[1:]))
            elif k.endswith("weight"):
                t = t * math.sqrt(1.0 / math.prod(s[1:]))
            else:
                t = t * 0.1
        elif k in uniform:
            t = 0.8 + 0.4 * u[ui:ui + sizes[k]].reshape(s)
            ui += sizes[k]
        else:   # num_batches_tracked
            t = torch.zeros(s, dtype=torch.int64, device=device)
        sd[k] = t
    return sd

"""Point-wise MLP stacks with BatchNorm + ReLU, eval mode (port of
s4g_tpu/models/nn_layers.py).

Layers run over the trailing channel axis of channels-last tensors, as in
the JAX package.  Parameters keep the reference torch layout and names
(`conv.weight` (C_out, C_in, 1[, 1]), `bn.{weight,bias,running_mean,
running_var}`), so a port state_dict is a reference state_dict.

Rounding points match flax `nn.Dense(dtype=compute_dtype)` + `nn.BatchNorm`:
the input and kernel are cast to the compute dtype and the product comes
out in it; BatchNorm runs in f32 from the running statistics as
(x - mean) * (scale * rsqrt(var + 1e-5)) + bias, then ReLU; activations stay
f32 between layers.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

BN_EPS = 1e-5


class PointConv(nn.Module):
    """Dense (= 1x1 conv, no bias) + BatchNorm + ReLU over the last axis.

    `ndim` is the reference conv's dimensionality (2 in SA stages, 1 in FP
    stages and heads); it only shapes the stored weight."""

    def __init__(self, in_features: int, features: int, ndim: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        conv = nn.Conv2d if ndim == 2 else nn.Conv1d
        self.conv = conv(in_features, features, 1, bias=False)
        self.bn = (nn.BatchNorm2d if ndim == 2 else nn.BatchNorm1d)(features)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.conv.weight.reshape(self.conv.out_channels, -1)
        y = torch.matmul(x.to(self.dtype), w.t().to(self.dtype))
        bn = self.bn
        mul = torch.rsqrt(bn.running_var + BN_EPS) * bn.weight
        y = (y.float() - bn.running_mean) * mul + bn.bias
        return torch.relu(y)


class SharedMLP(nn.ModuleList):
    """Stack of PointConv layers (reference SharedMLP; dropout is a no-op in
    eval mode and is not carried).  A ModuleList, so layer j's parameters
    are named `{j}.conv.*` / `{j}.bn.*` as in the reference."""

    def __init__(self, in_features: int, mlp_channels: Sequence[int],
                 ndim: int = 1, dtype: torch.dtype = torch.float32):
        layers = []
        for c in mlp_channels:
            layers.append(PointConv(in_features, c, ndim=ndim, dtype=dtype))
            in_features = c
        super().__init__(layers)

    def forward(self, x: torch.Tensor,
                max_pool_k: Optional[int] = None) -> torch.Tensor:
        """`max_pool_k`: max-pool the output over the second-to-last
        (neighbour) axis, which must have that size."""
        for layer in self:
            x = layer(x)
        if max_pool_k is not None:
            if x.shape[-2] != max_pool_k:
                raise ValueError(f"pool axis {x.shape[-2]} != {max_pool_k}")
            x = torch.amax(x, dim=-2)
        return x

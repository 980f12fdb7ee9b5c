"""Point-wise MLP stacks with BatchNorm + ReLU (port of
s4g_tpu/models/nn_layers.py).

Layers run over the trailing channel axis of channels-last tensors, as in
the JAX package.  Parameters keep the reference torch layout and names
(`conv.weight` (C_out, C_in, 1[, 1]), `bn.{weight,bias,running_mean,
running_var}`), so a port state_dict is a reference state_dict.

Rounding points match flax `nn.Dense(dtype=compute_dtype)` + `nn.BatchNorm`:
the input and kernel are cast to the compute dtype and the product comes
out in it; BatchNorm runs in f32 as (x - mean) * (scale * rsqrt(var +
1e-5)) + bias, then ReLU; activations stay f32 between layers.  In eval
mode mean and var are the running statistics.  In training mode
(the BatchNorm module's `training`, so `bn.eval()` inside a training
model keeps the running statistics, torch's way of freezing them) they
are flax 0.12's batch statistics, written out as
tensor ops so that autograd differentiates the formula XLA does: f32 over
every axis but the channels, var = max(E[x^2] - E[x]^2, 0) (flax's
`use_fast_variance`; `F.batch_norm` takes two passes and keeps the
unbiased variance, which differs beyond f32 rounding), and the running
statistics move by 0.1 towards the batch's mean and biased variance
(torch's momentum 0.1, flax's 0.9).  A `SharedMLP` built with
`dropout_prob` p > 0 drops elements after every layer in training mode:
each is kept with probability 1 - p, drawn from the caller's
`torch.Generator`, and scaled by 1 / (1 - p), as flax `nn.Dropout`; with
`channel_dropout` one draw per (batch, channel) drops whole channels, as
flax `nn.Dropout(broadcast_dims=...)`.  `MLP` is the same stack over
(B, C) vectors, and `batch_norm` the BatchNorm formula alone (the
baselines' Dense + BatchNorm layers use it).

`SharedMLP.fused_eval` is the fused-chain route: the whole chain, and the
SA stages' max over the neighbours, as one kernel (K7, `ops/mlp_chain.py`)
with BatchNorm folded in, hidden activations rounded to the compute dtype
and the result cast to it (so the next stage gets bf16 features where the
unfused route hands it f32), as JAX's `_fused_eval`.  Its folded and
packed operands are made once per weights (`SharedMLP.packed_operands`,
counted in `PACK_CACHE`, which also serves K3, the whole xyz-only SA
stage as one kernel: `ops/sa_fused.sa1_stage`).  `fuses_chain` is
JAX's rule for taking it (`nn_layers.py:201-224`), read from three module
settings, the counterparts of JAX's S4G_MLP_* flags (the port reads no
environment variable; set the attributes, as the tests do):

* `MLP_IMPL`: "auto" (fuse bf16 chains of CUDA tensors only, where the two
  settings below allow), "unfused" (never; JAX's "xla") or "fused" (every
  eligible chain, any compute dtype, on any device; JAX's "pallas" /
  "pallas_interpret");
* `MLP_FUSE_MIN_ROWS`: "auto" fuses a chain of at least this many rows;
* `MLP_FUSE_SCOPE`: "all" or "pooled" (only the SA stages' pooled chains).

`fused_route` is the whole decision `SharedMLP.forward` takes: the rule,
eval mode, and under "auto" a bf16 compute dtype.  The defaults fuse every
eligible bf16 eval-mode chain on the card (a row floor of 1), where the JAX
package keeps the route off after a TPU measurement.  On the H100 K7 beat
the layer-by-layer route at every chain shape of the curvature (b = 1),
contact (b = 4) and EDGEPN2DU (b = 4) forwards, CUDA-graph replays in turns;
its f32 path took 2.32 ms at SA2's chain against 1.29 for plain f32 matmuls
of the same chain, so f32 chains stay layer by layer.  CPU tensors under
"auto" never fuse, so every CPU comparison with the JAX package runs its
unfused route.  Each eval-mode chain adds one to the span counter
`mlp.fused` or `mlp.unfused` (`utils.profiling.count`: nothing unless a
profiler records).

Two more settings, the counterparts of S4G_CAST_ACTIVATIONS and
S4G_SA1_FUSE (`nn_layers.py:35, 42`):

* `CAST_ACTIVATIONS`: when true, every PointConv casts its output to the
  compute dtype (bf16 activations between layers and stages);
* `SA1_FUSE`: when an xyz-only SA stage runs as one kernel (K3,
  `PointNetSAModule._fuses`): "auto" at batch >= 2, "1" at any batch,
  "0" never.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch import nn

from ..ops.mlp_chain import _pack, mlp_chain
from ..parallel.mesh import global_ranks, global_rows, sum_over_ranks
from ..utils import profiling

BN_EPS = 1e-5

MLP_IMPL = "auto"
MLP_FUSE_MIN_ROWS = 1
MLP_FUSE_SCOPE = "all"
_MLP_IMPLS = ("auto", "unfused", "fused")
_MLP_SCOPES = ("all", "pooled")

CAST_ACTIVATIONS = False
SA1_FUSE = "auto"
_SA1_FUSES = ("auto", "0", "1")


def sa1_fuse_wanted(batch: int) -> bool:
    """Whether `SA1_FUSE` asks for the whole-stage kernel at this batch
    (JAX `pn2_modules.py:176-180`, where "1" also needs a TPU backend; here
    "1" fuses on any device, as the wrapper takes the twin on the CPU)."""
    if SA1_FUSE not in _SA1_FUSES:
        raise ValueError(f"SA1_FUSE {SA1_FUSE!r} is not one of {_SA1_FUSES}")
    return SA1_FUSE == "1" or (SA1_FUSE == "auto" and batch >= 2)

# Lookups of SharedMLP.packed_operands: "hits" reused a module's packed
# operands, "packs" folded and packed anew (read by chip_smoke.py).
PACK_CACHE = {"hits": 0, "packs": 0}


def fuses_chain(impl: str, min_rows: int, scope: str, shape: Sequence[int],
                max_pool_k: Optional[int], on_cuda: bool) -> bool:
    """JAX's rule for the fused chain (`nn_layers.py:201-224`), with "the
    backend is the TPU" read as "the tensor is on CUDA".  A pooled chain is
    eligible only when the pool axis has `max_pool_k` rows and `max_pool_k`
    divides 2,048 (the TPU kernel's row tile: it decides the numerics, so
    it is kept); "fused" ignores `min_rows` and `scope`."""
    if impl not in _MLP_IMPLS:
        raise ValueError(f"MLP_IMPL {impl!r} is not one of {_MLP_IMPLS}")
    if scope not in _MLP_SCOPES:
        raise ValueError(f"MLP_FUSE_SCOPE {scope!r} is not one of "
                         f"{_MLP_SCOPES}")
    force = impl == "fused"
    rows = 1
    for d in shape[:-1]:
        rows *= d
    pooled_ok = (max_pool_k is not None and shape[-2] == max_pool_k
                 and 2048 % max_pool_k == 0)
    unpooled_ok = max_pool_k is None and (force or scope == "all")
    eligible = (pooled_ok or unpooled_ok) and (force or rows >= min_rows)
    return impl != "unfused" and eligible and (force or on_cuda)


def fused_route(shape: Sequence[int], max_pool_k: Optional[int],
                dtype: torch.dtype, training: bool, on_cuda: bool) -> bool:
    """Whether `SharedMLP.forward` runs a chain of compute dtype `dtype` on
    an input of `shape` through K7: eval mode only (K7 has no backward),
    `fuses_chain` under the module settings, and under "auto" a bf16
    chain (K7's f32 path is slower than plain f32 matmuls on the card)."""
    return (not training
            and fuses_chain(MLP_IMPL, MLP_FUSE_MIN_ROWS, MLP_FUSE_SCOPE,
                            shape, max_pool_k, on_cuda)
            and (MLP_IMPL == "fused" or dtype == torch.bfloat16))


class PointConv(nn.Module):
    """Dense (= 1x1 conv, no bias) + BatchNorm + ReLU over the last axis.

    `ndim` is the reference conv's dimensionality (2 in SA stages, 1 in FP
    stages and heads); it only shapes the stored weight.  Built in eval
    mode, as the JAX layers default to `train=False`; `.train()` switches
    to the batch statistics."""

    def __init__(self, in_features: int, features: int, ndim: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        conv = nn.Conv2d if ndim == 2 else nn.Conv1d
        self.conv = conv(in_features, features, 1, bias=False)
        self.bn = (nn.BatchNorm2d if ndim == 2 else nn.BatchNorm1d)(features)
        self.dtype = dtype
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.conv.weight.reshape(self.conv.out_channels, -1)
        y = torch.matmul(x.to(self.dtype), w.t().to(self.dtype)).float()
        y = torch.relu(batch_norm(y, self.bn))
        return y.to(self.dtype) if CAST_ACTIVATIONS else y


def batch_norm(y: torch.Tensor, bn: nn.Module) -> torch.Tensor:
    """flax `nn.BatchNorm(dtype=float32)` over the last axis of `y` with
    `bn`'s affine, in f32 (f64 stays f64, for a float64 oracle; PointConv
    hands it f32): the running statistics in eval mode, the batch's
    (`_batch_stats`, which moves the running ones) in training mode."""
    y = y.to(torch.promote_types(y.dtype, torch.float32))
    if bn.training:
        mean, var = _batch_stats(y, bn)
    else:
        mean, var = bn.running_mean, bn.running_var
    mul = torch.rsqrt(var + BN_EPS) * bn.weight
    return (y - mean) * mul + bn.bias


def _batch_stats(y: torch.Tensor, bn: nn.Module) -> tuple:
    """flax BatchNorm's training statistics of f32 `y` over every axis but
    the last, (mean, max(E[y^2] - mean^2, 0)); moves `bn`'s running
    statistics by its momentum towards them (the biased variance).  Within
    `parallel.global_batch` they are the global batch's, the same on every
    rank."""
    axes = tuple(range(y.dim() - 1))
    ranks = global_ranks()
    if ranks is None:
        mean = torch.mean(y, dim=axes)
        var = torch.clamp(torch.mean(y * y, dim=axes) - mean * mean,
                          min=0.0)
    else:
        # The global batch's: one all-reduce of the local sums of y and
        # y^2 over the global count (every rank holds as many rows).
        count = (y.numel() // y.shape[-1]) * ranks.size
        sums = sum_over_ranks(torch.cat([torch.sum(y, dim=axes),
                                         torch.sum(y * y, dim=axes)]))
        mean, mean_sq = torch.chunk(sums / count, 2)
        var = torch.clamp(mean_sq - mean * mean, min=0.0)
    with torch.no_grad():
        keep = 1.0 - bn.momentum
        bn.running_mean.copy_(keep * bn.running_mean + bn.momentum * mean)
        bn.running_var.copy_(keep * bn.running_var + bn.momentum * var)
    return mean, var


def dropout(x: torch.Tensor, p: float,
            generator: Optional[torch.Generator],
            channel: bool = False) -> torch.Tensor:
    """flax `nn.Dropout(p)` in training: each element kept with probability
    1 - p (a uniform draw from `generator` below 1 - p) and scaled by
    1 / (1 - p), the rest zero.  `channel`: one draw per (batch, channel),
    shared over every axis between them (flax `broadcast_dims=range(1,
    ndim - 1)`, torch's dropout2d): whole channels are dropped.  Within
    `parallel.global_batch` the draws are the global batch's (this rank's
    rows of them)."""
    if generator is None:
        raise ValueError("dropout in training mode draws its masks from a "
                         "torch.Generator: pass generator=")
    keep_prob = 1.0 - p
    shape = ((x.shape[0], *[1] * (x.dim() - 2), x.shape[-1]) if channel
             else x.shape)
    keep = global_rows(lambda s: torch.rand(s, generator=generator,
                                            device=x.device), shape) \
        < keep_prob
    return torch.where(keep, x / keep_prob, 0.0)


class SharedMLP(nn.ModuleList):
    """Stack of PointConv layers (reference SharedMLP), with dropout after
    every layer in training mode when `dropout_prob` > 0: element-wise, or
    of whole channels with `channel_dropout` (JAX `nn_layers.py:229-234`);
    built in eval mode, as PointConv.  A ModuleList, so layer j's
    parameters are named `{j}.conv.*` / `{j}.bn.*` as in the reference."""

    def __init__(self, in_features: int, mlp_channels: Sequence[int],
                 ndim: int = 1, dtype: torch.dtype = torch.float32,
                 dropout_prob: float = 0.0, channel_dropout: bool = False):
        layers = []
        for c in mlp_channels:
            layers.append(PointConv(in_features, c, ndim=ndim, dtype=dtype))
            in_features = c
        super().__init__(layers)
        self.dropout_prob = dropout_prob
        self.channel_dropout = channel_dropout
        self._packed = {}   # packed_operands' entries, one per kernel
        self.eval()

    def forward(self, x: torch.Tensor, max_pool_k: Optional[int] = None,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """`max_pool_k`: max-pool the output over the second-to-last
        (neighbour) axis, which must have that size (`torch.amax`, which
        splits a tie's gradient evenly, as `jnp.max`).  The fused-chain
        route (`fused_route`) runs the chain as one kernel instead in eval
        mode; each eval-mode chain counts `mlp.fused` or `mlp.unfused`.
        `generator`: the dropout masks' draws (training mode with
        `dropout_prob` > 0 only)."""
        if fused_route(x.shape, max_pool_k, self[0].dtype, self.training,
                       x.is_cuda):
            profiling.count("mlp.fused")
            return self.fused_eval(x, max_pool_k)
        if not self.training:
            profiling.count("mlp.unfused")
        drop = self.training and self.dropout_prob > 0.0
        for layer in self:
            x = layer(x)
            if drop:
                x = dropout(x, self.dropout_prob, generator,
                            self.channel_dropout)
        if max_pool_k is not None:
            if x.shape[-2] != max_pool_k:
                raise ValueError(f"pool axis {x.shape[-2]} != {max_pool_k}")
            x = torch.amax(x, dim=-2)
        return x

    def folded_params(self) -> list:
        """Per-layer f32 (w (C_in, C_out), b (C_out,)) with BatchNorm folded
        in (port of `_folded_params`): w * (scale * rsqrt(var + 1e-5)) and
        bias - mean * that factor."""
        params = []
        for layer in self:
            w = layer.conv.weight.reshape(layer.conv.out_channels, -1).t()
            bn = layer.bn
            inv = bn.weight.float() * torch.rsqrt(bn.running_var.float()
                                                  + BN_EPS)
            params.append(((w.float() * inv[None, :]).contiguous(),
                           (bn.bias.float() - bn.running_mean.float() * inv)
                           .contiguous()))
        return params

    def _weight_key(self) -> tuple:
        """What the folded operands depend on: the version and storage of
        every conv weight and BatchNorm tensor."""
        return tuple((t._version, t.data_ptr())
                     for layer in self
                     for t in (layer.conv.weight, layer.bn.weight,
                               layer.bn.bias, layer.bn.running_mean,
                               layer.bn.running_var))

    def packed_operands(self, pack: Callable, *args) -> tuple:
        """(folded_params(), pack(folded_params(), *args)), made once per
        weights and kernel: one entry per pack function (K7's
        `mlp_chain._pack`, K3's `sa_fused.pack_sa1_weights`), kept while
        every conv weight and BatchNorm tensor keeps its version and
        storage and `args` are the same (any in-place change,
        `load_state_dict` included, or a move to another device re-packs).
        Nothing is kept in training mode."""
        key = (self._weight_key(), args, self[0].conv.weight.device)
        cached = self._packed.get(pack)
        if not self.training and cached is not None and cached[0] == key:
            PACK_CACHE["hits"] += 1
            return cached[1], cached[2]
        PACK_CACHE["packs"] += 1
        with torch.no_grad():
            params = self.folded_params()
            packed = pack(params, *args)
        if self.training:
            self._packed.clear()
        else:
            self._packed[pack] = (key, params, packed)
        return params, packed

    def fused_eval(self, x: torch.Tensor,
                   max_pool_k: Optional[int] = None) -> torch.Tensor:
        """The whole chain (and the max over the second-to-last axis when
        `max_pool_k` is set) as one kernel, K7 (port of `_fused_eval`), on
        operands packed once per weights (`packed_operands`).

        Returns the chain's output cast to the compute dtype, (..., C_out),
        without the pooled axis when pooling."""
        params, packed = self.packed_operands(
            _pack, self[0].conv.in_channels, self[0].dtype)
        lead = x.shape[:-1]
        out = mlp_chain(x.reshape(-1, x.shape[-1]), params,
                        (True,) * len(params), max_pool_k, self[0].dtype,
                        packed=packed)
        if max_pool_k is not None:
            lead = lead[:-1]
        return out.to(self[0].dtype).reshape(*lead, out.shape[-1])


class MLP(SharedMLP):
    """FC + BN + ReLU stack over (B, C) vectors (port of JAX `MLP`,
    `nn_layers.py:244-258`, the reference's mlp.py:8-52), with element-wise
    dropout after every layer in training mode.  No configured model uses
    it.  Its layers are PointConvs over the last axis, named `{j}.conv.*` /
    `{j}.bn.*` after the JAX module's layers."""

    def __init__(self, in_features: int, mlp_channels: Sequence[int],
                 dtype: torch.dtype = torch.float32,
                 dropout_prob: float = 0.0):
        super().__init__(in_features, mlp_channels, ndim=1, dtype=dtype,
                         dropout_prob=dropout_prob)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        drop = self.training and self.dropout_prob > 0.0
        for layer in self:
            x = layer(x)
            if drop:
                x = dropout(x, self.dropout_prob, generator)
        return x

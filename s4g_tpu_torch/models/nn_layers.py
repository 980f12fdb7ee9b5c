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

`SharedMLP.sa1_fused_eval` is the other route of an xyz-only SA stage: the
whole stage as one kernel (K3, `ops/sa_fused.py`) with BatchNorm folded
into each layer and bf16 rounding between layers, as the JAX package runs
SA1 at batch >= 2.

`SharedMLP.fused_eval` is the fused-chain route: the whole chain, and the
SA stages' max over the neighbours, as one kernel (K7, `ops/mlp_chain.py`)
with BatchNorm folded in, hidden activations rounded to the compute dtype
and the result cast to it (so the next stage gets bf16 features where the
unfused route hands it f32), as JAX's `_fused_eval`.  Its folded and
packed operands are made once per weights (`SharedMLP.packed_operands`,
counted in `PACK_CACHE`).  `fuses_chain` is
JAX's rule for taking it (`nn_layers.py:201-224`), read from three module
settings, the counterparts of JAX's S4G_MLP_* flags (the port reads no
environment variable; set the attributes, as the tests do):

* `MLP_IMPL`: "auto" (fuse on CUDA tensors only, where the two settings
  below allow), "unfused" (never; JAX's "xla") or "fused" (every eligible
  chain, on any device; JAX's "pallas" / "pallas_interpret");
* `MLP_FUSE_MIN_ROWS`: "auto" fuses a chain of at least this many rows;
* `MLP_FUSE_SCOPE`: "all" or "pooled" (only the SA stages' pooled chains).

Defaults keep the route off, as in the JAX package.

Two more settings, the counterparts of S4G_CAST_ACTIVATIONS and
S4G_SA1_FUSE (`nn_layers.py:35, 42`):

* `CAST_ACTIVATIONS`: when true, every PointConv casts its output to the
  compute dtype (bf16 activations between layers and stages);
* `SA1_FUSE`: when an xyz-only SA stage runs as one kernel (K3,
  `PointNetSAModule._fuses`): "auto" at batch >= 2, "1" at any batch,
  "0" never.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..ops import sa_fused
from ..ops.mlp_chain import _pack, mlp_chain
from ..ops.neighbors import ball_query_grouped

BN_EPS = 1e-5

MLP_IMPL = "auto"
MLP_FUSE_MIN_ROWS = 1 << 60
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
        y = torch.relu((y.float() - bn.running_mean) * mul + bn.bias)
        return y.to(self.dtype) if CAST_ACTIVATIONS else y


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
        (neighbour) axis, which must have that size.  The fused-chain route
        (`fuses_chain`) runs the chain as one kernel instead."""
        if not self.training and fuses_chain(
                MLP_IMPL, MLP_FUSE_MIN_ROWS, MLP_FUSE_SCOPE, x.shape,
                max_pool_k, x.is_cuda):
            return self.fused_eval(x, max_pool_k)
        for layer in self:
            x = layer(x)
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

    def packed_operands(self, compute_dtype: torch.dtype) -> tuple:
        """(folded_params(), K7's packed operands `_pack`) for
        `compute_dtype`, made once per weights: kept while every conv
        weight and BatchNorm tensor keeps its version and storage (any
        in-place change, `load_state_dict` included, or a move to another
        device re-packs).  Nothing is kept in training mode."""
        key = (self._weight_key(), compute_dtype,
               self[0].conv.weight.device)
        cached = getattr(self, "_packed", None)
        if not self.training and cached is not None and cached[0] == key:
            PACK_CACHE["hits"] += 1
            return cached[1], cached[2]
        PACK_CACHE["packs"] += 1
        with torch.no_grad():
            params = self.folded_params()
            packed = _pack(params, params[0][0].shape[0], compute_dtype)
        self._packed = None if self.training else (key, params, packed)
        return params, packed

    def fused_eval(self, x: torch.Tensor,
                   max_pool_k: Optional[int] = None) -> torch.Tensor:
        """The whole chain (and the max over the second-to-last axis when
        `max_pool_k` is set) as one kernel, K7 (port of `_fused_eval`), on
        operands packed once per weights (`packed_operands`).

        Returns the chain's output cast to the compute dtype, (..., C_out),
        without the pooled axis when pooling."""
        params, packed = self.packed_operands(self[0].dtype)
        lead = x.shape[:-1]
        out = mlp_chain(x.reshape(-1, x.shape[-1]), params,
                        (True,) * len(params), max_pool_k, self[0].dtype,
                        packed=packed)
        if max_pool_k is not None:
            lead = lead[:-1]
        return out.to(self[0].dtype).reshape(*lead, out.shape[-1])

    def sa1_fused_eval(self, points: torch.Tensor, centroids: torch.Tensor,
                       pkeys: torch.Tensor, ckeys: torch.Tensor,
                       radius: float, k: int, stratified: bool = True,
                       sorted_axis: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
        """A whole xyz-only SA stage as one kernel (port of
        `_sa1_fused_eval`): slab ball query, grouping, this 3-layer chain
        and the max over the K neighbours (K3).

        The window overflow flag is read on the host once for the whole
        batch, as JAX's `lax.cond` decides once: on overflow the stage takes
        a full-scan ball query (K2f, handed `sorted_axis` so that it scans
        only each ball's slab) and runs the chain with the same folded
        weights and bf16 rounding (counted in `sa_fused.SA1_FALLBACKS`).

        Args: points (B, 3, N) sorted along each scene's axis; centroids
            (B, 3, M) sorted the same way; pkeys / ckeys (B, N) / (B, M)
            their keys along that axis; sorted_axis optional (B,) tensor,
            that axis.
        Returns: (B, M, C3) pooled features in the compute dtype."""
        (w1, b1), (w2, b2), (w3, b3) = self.folded_params()
        lo_tile, overflow = sa_fused.sa1_slab_setup(pkeys, ckeys, radius,
                                                    points.shape[2])
        if bool(overflow):
            sa_fused.SA1_FALLBACKS["overflow"] += 1
            # The full scan, as JAX's fallback (slab_capacity = N keeps it
            # off the slab route); the promise only narrows K2f's scan.
            _, cnt, rel = ball_query_grouped(
                points, centroids, radius, k, sorted_axis=sorted_axis,
                slab_capacity=points.shape[2], stratified=stratified)
            h = rel.to(torch.bfloat16)
            for w, b in ((w1, b1), (w2, b2), (w3, b3)):
                # bf16 x bf16 products are exact in f32: an f32 matmul of
                # the rounded operands is the f32-accumulating bf16 matmul.
                w16 = w.to(torch.bfloat16).float()
                h = torch.relu(torch.matmul(h.float(), w16) + b) \
                    .to(torch.bfloat16)
            pooled = torch.amax(h.float(), dim=2)
            out = torch.where(cnt[..., None] > 0, pooled, 0.0)
        else:
            out = sa_fused.sa1_fused_slab(
                points.contiguous(), centroids.contiguous(), lo_tile, radius,
                k, w1, b1, (w2, w3), (b2, b3), stratified=stratified)
        return out.to(self[0].dtype)

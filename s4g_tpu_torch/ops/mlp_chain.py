"""Fused SharedMLP chain (port of s4g_tpu/ops/pallas/mlp_kernels.py).

One kernel runs every layer of a BatchNorm-folded point-wise MLP, and
optionally the max over consecutive groups of `pool_k` rows, on a tile of
rows, so that only the chain's input and its (pooled) output touch device
memory.  The numbers are the TPU kernel's (`mlp_chain_pallas`):

* the input (P, C_in) is cast to the compute dtype;
* layer i: W_i, the f32 folded weight rounded to the compute dtype, times
  the activations with f32 sums, plus the f32 bias, then ReLU where
  `relu[i]`;
* every layer but the last is rounded to the compute dtype;
* with `pool_k`: the max over each run of `pool_k` consecutive rows, in f32;
* the output is (P or P / pool_k, C_out) f32.

Compute dtypes: bfloat16 and float32 (f32 products in full f32, no TF32).
`mlp_chain` launches the CUDA kernel `csrc/mlp_chain.cu` (K7) on CUDA
tensors; CPU tensors take its plain twin `_mlp_chain_plain`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .. import _build

# What the CUDA kernel takes: up to 4 layers, widths padded to multiples of
# 16 (mma tiles); its C launcher refuses tiles that do not fit a block's
# shared memory.
_MAX_LAYERS = 4
_PAD = 16
_DTYPES = (torch.bfloat16, torch.float32)


def _mlp_chain_plain(x: torch.Tensor, params: Sequence, relu: Sequence[bool],
                     pool_k: Optional[int] = None,
                     compute_dtype: torch.dtype = torch.bfloat16
                     ) -> torch.Tensor:
    """Plain twin of K7 (see the module docstring): f32 matmuls of operands
    rounded to the compute dtype, which are exact for bf16 operands, so the
    sums are f32 sums as in the kernel."""
    h = x.to(compute_dtype)
    last = len(params) - 1
    for i, (w, b) in enumerate(params):
        y = torch.matmul(h.float(), w.to(compute_dtype).float()) + b.float()
        if relu[i]:
            y = torch.relu(y)
        h = y.to(compute_dtype) if i < last else y
    if pool_k is not None:
        h = torch.amax(h.reshape(-1, pool_k, h.shape[-1]), dim=1)
    return h


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _pack(params: Sequence, c_in: int, compute_dtype: torch.dtype):
    """Weights as the kernel reads them: rounded to the compute dtype and
    zero-padded to widths that are multiples of 16, bf16 transposed to
    (N, K) (mma B fragments), f32 kept (K, N); biases zero-padded f32.
    Returns the packed (w, b) pairs and the padded input width."""
    kpad0 = kpad = _round_up(c_in, _PAD)
    packed = []
    for w, b in params:
        k, n = w.shape
        npad = _round_up(n, _PAD)
        wp = torch.zeros((kpad, npad), dtype=compute_dtype, device=w.device)
        wp[:k, :n] = w
        if compute_dtype == torch.bfloat16:
            wp = wp.t().contiguous()
        bp = torch.zeros(npad, dtype=torch.float32, device=b.device)
        bp[:n] = b
        packed.append((wp, bp))
        kpad = npad
    return packed, kpad0


def mlp_chain(x: torch.Tensor, params: Sequence, relu: Sequence[bool],
              pool_k: Optional[int] = None,
              compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Run a BN-folded point-wise MLP chain (and the group max) fused (K7).

    Args:
        x: (P, C_in) rows by channels, any float dtype (cast to the compute
            dtype).
        params: per layer (W (C_in_i, C_out_i) f32, b (C_out_i,) f32),
            BatchNorm folded in.
        relu: per-layer bools.
        pool_k: optional group size; the output is the max over each run of
            `pool_k` consecutive rows (P must be a multiple of it).
        compute_dtype: torch.bfloat16 or torch.float32.

    Returns: (P, C_out) f32, or (P / pool_k, C_out) with pooling."""
    p, c_in = x.shape
    if len(relu) != len(params) or not params:
        raise ValueError(f"{len(params)} layers but {len(relu)} relu flags")
    if compute_dtype not in _DTYPES:
        raise TypeError(f"compute dtype {compute_dtype} is not one of "
                        f"{_DTYPES}")
    if pool_k is not None and (pool_k < 1 or p % pool_k):
        raise ValueError(f"{p} rows do not split into groups of {pool_k}")
    widths = [c_in] + [w.shape[1] for w, _ in params]
    for i, (w, b) in enumerate(params):
        if tuple(w.shape) != (widths[i], widths[i + 1]) \
                or tuple(b.shape) != (widths[i + 1],):
            raise ValueError(f"layer {i}: weight {tuple(w.shape)} and bias "
                             f"{tuple(b.shape)} do not chain from width "
                             f"{widths[i]}")
    tensors = [x] + [t for wb in params for t in wb]
    if not _build.on_cuda(*tensors):
        return _mlp_chain_plain(x, params, relu, pool_k, compute_dtype)
    if len(params) > _MAX_LAYERS:
        raise ValueError(f"the K7 kernel holds up to {_MAX_LAYERS} layers, "
                         f"got {len(params)}")
    packed, kpad0 = _pack(params, c_in, compute_dtype)
    return _launch(x.to(compute_dtype).contiguous(), packed, kpad0,
                   widths[-1], relu, pool_k)


def _launch(xc: torch.Tensor, packed: list, kpad0: int, c_out: int,
            relu: Sequence[bool], pool_k: Optional[int]) -> torch.Tensor:
    """The kernel alone, on a contiguous input in the compute dtype and the
    weights `_pack` made (`mlp_chain` is `_pack` then this)."""
    p, c_in = xc.shape
    out = torch.empty((p // (pool_k or 1), c_out), dtype=torch.float32,
                      device=xc.device)
    slots = packed + [(0, 0)] * (_MAX_LAYERS - len(packed))
    npads = [b.shape[0] for _, b in packed] + [0] * (_MAX_LAYERS
                                                     - len(packed))
    relu_mask = sum(1 << i for i, r in enumerate(relu) if r)
    _build.launch("mlp_chain", xc, *[t for wb in slots for t in wb], p, c_in,
                  c_out, len(packed), kpad0, *npads, relu_mask, pool_k or 0,
                  int(xc.dtype == torch.bfloat16), out)
    return out

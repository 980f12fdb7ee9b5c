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
tensors; CPU tensors take its plain twin `_mlp_chain_plain`.  The kernel
holds up to 4 layers whose row tile fits a block's shared memory; a longer
or wider chain runs as consecutive sub-chains that do (`chain_pieces`), one
launch each, only the last one pooling.  A split changes no number: a
sub-chain's output is f32 after its bias and ReLU, and the next one casts
it to the compute dtype, the rounding the kernel gives a hidden layer.  A
one-layer bf16 launch whose row tiles are fewer than the card's SMs splits
its output columns over blocks, so that few rows still fill the card.  A
single layer whose tile does not fit is a sub-chain of its own; the kernel
then splits its input channels into chunks and sums their products in f32
before the bias, ReLU and pooling, so any width runs.  The operands are
packed once (`_pack`); a SharedMLP keeps its packed operands until its
weights change (`SharedMLP.packed_operands`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .. import _build

# What the CUDA kernel takes in one piece: up to 4 layers whose tile fits a
# block's shared memory, or any single layer.  bf16 (mlp_wg_kernel): the
# input width padded to a multiple of 64 (a 128-byte swizzle row), every
# output width to 128 (a wgmma chunk); a tile of 128 or 64 rows holds two
# activation buffers (rows x the widest even and odd layer inputs, bf16), a
# ring of 2-4 weight slices of 16 KB, the pooled maxima (groups of >= 16
# rows) and its barriers.  f32 (mlp_chain_kernel): widths padded to 16,
# 16-row tiles with 8 elements of row padding.  `_wg_smem` and `_tile_smem`
# copy the launcher's sums; a GPU test
# (`test_mlp_chain_planner_agrees_with_the_launcher`) holds them equal at
# the widest chains they take.
_MAX_LAYERS = 4
_PAD = {torch.bfloat16: (64, 128), torch.float32: (16, 16)}
_MAX_SMEM = 232448
_WG_TILES = ((128, 4), (128, 3), (128, 2), (64, 4), (64, 3), (64, 2))
_WG_STAGE = 128 * 128
_WG_FIXED = 1024 + 80            # alignment slack, barriers
_F32_TILE = 16
_ROW_PAD = 8
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


def padded_widths(widths: Sequence[int], compute_dtype: torch.dtype) -> list:
    """The kernel's widths of a chain with layer widths `widths` (input
    first): the padded input width, then each layer's padded output width
    (the next layer's padded input)."""
    k_pad, n_pad = _PAD[compute_dtype]
    return [_round_up(widths[0], k_pad)] + [_round_up(w, n_pad)
                                            for w in widths[1:]]


def _wg_smem(kpads: Sequence[int], npad_last: int, pool_k: Optional[int],
             rows: int, stages: int) -> int:
    """Shared memory of mlp_wg_kernel's tile of `rows` rows and `stages`
    ring stages for layers taking padded input widths `kpads` (the C
    launcher's wg_smem)."""
    width = [0, 0]
    for i, kp in enumerate(kpads):
        width[i % 2] = max(width[i % 2], kp)
    pool = pool_k or 0
    groups = max(pool, rows) // pool if pool >= 16 else 0
    return (_WG_FIXED + rows * sum(width) * 2 + stages * _WG_STAGE
            + 4 * groups * npad_last)


def _wg_tile(kpads, npad_last, pool_k) -> Optional[tuple]:
    """(rows, stages) of the bf16 tile the launcher takes, or None."""
    return next((t for t in _WG_TILES
                 if _wg_smem(kpads, npad_last, pool_k, *t) <= _MAX_SMEM), None)


def _tile_smem(kpads: Sequence[int], npad_last: int, pool_k: Optional[int],
               elem: int, tile: int) -> int:
    """Shared memory of mlp_chain_kernel's `tile`-row tile (f32) of a chain
    whose layers take padded input widths `kpads` (the C launcher's
    tile_smem)."""
    width = [0, 0]
    for i, kp in enumerate(kpads):
        width[i % 2] = max(width[i % 2], kp)
    rows = max(pool_k or 0, tile)
    groups = rows // pool_k if pool_k else 0
    return (elem * tile * sum(w + _ROW_PAD for w in width if w)
            + 4 * groups * npad_last)


def _fits(kpads, npad_last, pool_k, compute_dtype) -> bool:
    """True iff the kernel's tile of these layers fits shared memory."""
    if compute_dtype == torch.bfloat16:
        return _wg_tile(kpads, npad_last, pool_k) is not None
    return _tile_smem(kpads, npad_last, pool_k, 4, _F32_TILE) <= _MAX_SMEM


def chain_pieces(widths: Sequence[int], pool_k: Optional[int],
                 compute_dtype: torch.dtype) -> list:
    """Consecutive sub-chains [a, b) of a chain with layer widths `widths`
    (input first) that the kernel holds: each of at most 4 layers and with
    a tile that fits, taken greedily from the first layer; only the last
    one pools.  A layer that fits no tile alone is a piece of its own (the
    kernel splits its input channels)."""
    kpads = padded_widths(widths, compute_dtype)
    layers = len(widths) - 1
    pieces, a = [], 0
    while a < layers:
        b = a
        while b < layers and b - a < _MAX_LAYERS and _fits(
                kpads[a:b + 1], kpads[b + 1],
                pool_k if b + 1 == layers else None, compute_dtype):
            b += 1
        b = max(b, a + 1)
        pieces.append((a, b))
        a = b
    return pieces


def _pack(params: Sequence, c_in: int, compute_dtype: torch.dtype) -> list:
    """Weights as the kernel reads them, per layer: rounded to the compute
    dtype and zero-padded to `padded_widths`; bf16 transposed to W^T (N, K)
    (K-major, the TMA maps' rows), f32 kept (K, N); biases zero-padded f32.
    Returns [(w, b, C_out)] per layer; any run of layers is a piece's
    operands."""
    widths = [c_in] + [w.shape[1] for w, _ in params]
    kpads = padded_widths(widths, compute_dtype)
    packed = []
    for i, (w, b) in enumerate(params):
        k, n = w.shape
        kpad, npad = kpads[i], kpads[i + 1]
        wp = torch.zeros((kpad, npad), dtype=compute_dtype, device=w.device)
        wp[:k, :n] = w
        if compute_dtype == torch.bfloat16:
            wp = wp.t().contiguous()
        bp = torch.zeros(npad, dtype=torch.float32, device=b.device)
        bp[:n] = b
        packed.append((wp, bp, n))
    return packed


def mlp_chain(x: torch.Tensor, params: Sequence, relu: Sequence[bool],
              pool_k: Optional[int] = None,
              compute_dtype: torch.dtype = torch.bfloat16,
              packed: Optional[list] = None) -> torch.Tensor:
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
        packed: `_pack(params, C_in, compute_dtype)`, where the caller keeps
            it (packed here otherwise).

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
    if packed is None:
        packed = _pack(params, c_in, compute_dtype)
    pieces = chain_pieces(widths, pool_k, compute_dtype)
    return run_pieces(x, packed, relu, pool_k, compute_dtype, pieces,
                      _launch_piece)


def _kernel_input(x: torch.Tensor, packed: list, pool_k: Optional[int]):
    """x as the kernel reads it for a piece of `_pack`'s layers `packed`:
    contiguous in the compute dtype.  A bf16 piece on wgmma tiles reads its
    input by TMA, so there the rows are padded with zero channels to a
    multiple of 8 and 16-byte aligned (the padded channels meet zero weight
    rows), in one cast-and-copy pass; the wide-layer kernel reads rows of
    any width."""
    p, c_in = x.shape
    compute_dtype = packed[0][0].dtype
    if compute_dtype != torch.bfloat16 or _wg_tile(
            [w.shape[1] for w, _, _ in packed], packed[-1][1].shape[0],
            pool_k) is None:
        return x.to(compute_dtype).contiguous()
    c8 = _round_up(c_in, 8)
    if (c8 == c_in and x.dtype == compute_dtype and x.is_contiguous()
            and x.data_ptr() % 16 == 0):
        return x
    xc = torch.empty((p, c8), dtype=compute_dtype, device=x.device)
    xc[:, c_in:].zero_()
    xc[:, :c_in].copy_(x)
    return xc


def _launch_piece(x, packed, relu, pool_k, compute_dtype):
    return _launch(_kernel_input(x, packed, pool_k), packed, relu, pool_k)


def run_pieces(x, params, relu, pool_k, compute_dtype, pieces, run):
    """The chain as its sub-chains `pieces`, each through `run(x, params,
    relu, pool_k, compute_dtype)` (the kernel on packed operands on the
    card, the twin in the CPU tests); only the last one pools."""
    h = x
    for a, b in pieces:
        last = b == len(params)
        h = run(h, params[a:b], relu[a:b], pool_k if last else None,
                compute_dtype)
    return h


def _launch(xc: torch.Tensor, packed: list, relu: Sequence[bool],
            pool_k: Optional[int]) -> torch.Tensor:
    """The kernel alone, once, on an input made by `_kernel_input` and a
    run of `_pack`'s layers (one piece)."""
    p, c_in = xc.shape
    bf16 = xc.dtype == torch.bfloat16
    kpad0 = packed[0][0].shape[1 if bf16 else 0]
    c_out = packed[-1][2]
    out = torch.empty((p // (pool_k or 1), c_out), dtype=torch.float32,
                      device=xc.device)
    slots = [(w, b) for w, b, _ in packed]
    slots += [(None, None)] * (_MAX_LAYERS - len(packed))
    npads = [b.shape[0] for _, b, _ in packed] + [0] * (_MAX_LAYERS
                                                        - len(packed))
    relu_mask = sum(1 << i for i, r in enumerate(relu) if r)
    _build.launch("mlp_chain", xc, *[t for wb in slots for t in wb], p, c_in,
                  c_out, len(packed), kpad0, *npads, relu_mask, pool_k or 0,
                  int(bf16), out)
    return out

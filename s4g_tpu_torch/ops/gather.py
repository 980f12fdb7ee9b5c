"""Gather/group ops (port of s4g_tpu/ops/gather.py).

The JAX package differentiates its gathers through XLA's scatter-add, which
adds the contributions to one point in source order: the same gradients on
every run (s4g_tpu/ops/gather.py:5-7).  torch.gather's own backward on CUDA
adds them with atomics, in an order that changes between runs wherever an
index repeats (a padded ball-query group repeats its first neighbour; 3-NN
interpolation shares keys).  `gather_rows` keeps torch.gather's forward and
replaces the backward by a fixed-order sum: on the card the kernel K8
(`csrc/gather_backward.cu`), on the CPU its plain twin, equal bit for bit.
"""

from __future__ import annotations

import torch

from .. import _build
from .neighbors import flat_gather_rows

# dtype -> the kernel's dtype code: the gradients of the models' gathers
# (f32; bf16 under CAST_ACTIVATIONS; f64 in the float64 oracle steps).
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}


def row_lists(index: torch.Tensor, n: int) -> tuple:
    """The sources of every destination row of a batched gather of (B, N, C)
    rows by `index` (B, M): (order, offsets), where `order` (B*M,) lists the
    flat source rows b*M + p sorted by destination row b*N + index[b, p]
    (a stable sort: ascending p within one destination) and `offsets`
    (B*N + 1,) is each destination's first slot in `order`.  Both int32,
    exact and the same on every run and device."""
    b, m = index.shape
    base = torch.arange(b, device=index.device, dtype=torch.int64)[:, None]
    keys = (index.long() + base * n).reshape(-1)
    sorted_keys, order = torch.sort(keys, stable=True)
    bounds = torch.arange(b * n + 1, device=index.device, dtype=torch.int64)
    offsets = torch.searchsorted(sorted_keys, bounds)
    return order.int(), offsets.int()


def _fixed_order_sum(grad: torch.Tensor, order: torch.Tensor,
                     offsets: torch.Tensor) -> torch.Tensor:
    """K8's arithmetic: (P, C) source gradients -> (R, C), R the offsets
    less one; row r the sum of grad[order[s]] over offsets[r] <= s <
    offsets[r + 1], added in ascending s in f32 (f64 for f64) and rounded
    once to grad's dtype.  The k-th pass adds every row's k-th term (rows
    sorted by their count, so the rows still adding are a prefix), the
    order K8 adds in."""
    acc_dtype = (torch.float64 if grad.dtype == torch.float64
                 else torch.float32)
    rows, c = offsets.numel() - 1, grad.shape[1]
    start = offsets[:-1].long()
    counts = offsets[1:].long() - start
    by_count = torch.argsort(counts, descending=True, stable=True)
    start = start[by_count]
    # live[k]: rows with more than k terms (a prefix of by_count).
    hist = torch.bincount(counts, minlength=1)
    live = (counts.numel() - torch.cumsum(hist, 0))[:-1].tolist()
    acc = torch.zeros(rows, c, dtype=acc_dtype, device=grad.device)
    src = grad.to(acc_dtype)
    for k, n in enumerate(live):
        acc[:n] += src[order[start[:n] + k].long()]
    out = torch.empty(rows, c, dtype=grad.dtype, device=grad.device)
    out[by_count] = acc.to(grad.dtype)
    return out


def _gather_backward_plain(grad: torch.Tensor, index: torch.Tensor,
                           n: int) -> torch.Tensor:
    """K8's plain twin, on the wrapper's arguments."""
    b, m, c = grad.shape
    order, offsets = row_lists(index, n)
    return _fixed_order_sum(grad.contiguous().reshape(b * m, c), order,
                            offsets).reshape(b, n, c)


def gather_backward(grad: torch.Tensor, index: torch.Tensor,
                    n: int) -> torch.Tensor:
    """The gradient of a batched row gather, (B, M, C) -> (B, N, C): row
    (b, i) the sum of grad[b, p] over the p with index[b, p] == i, in
    ascending p (`row_lists`).  On the card through K8; on the CPU its
    twin."""
    b, m, c = grad.shape
    if grad.dtype not in _DTYPES:
        raise TypeError(f"gather_backward: unsupported dtype {grad.dtype}")
    if not _build.on_cuda(grad, index):
        return _gather_backward_plain(grad, index, n)
    grad = grad.contiguous().reshape(b * m, c)
    order, offsets = row_lists(index, n)
    out = torch.empty(b * n, c, dtype=grad.dtype, device=grad.device)
    if b * n:
        _build.launch("gather_backward", grad, order, offsets, b * n, c,
                      _DTYPES[grad.dtype], out)
    return out.reshape(b, n, c)


class _GatherRows(torch.autograd.Function):
    """torch.gather of whole rows along `dim` (1: (B, N, C) rows; 2:
    (B, C, N) columns) whose backward is `gather_backward`."""

    @staticmethod
    def forward(ctx, x, index, dim):
        ctx.save_for_backward(index)
        ctx.dim, ctx.n = dim, x.shape[dim]
        return _gather(x, index, dim)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        (index,) = ctx.saved_tensors
        if ctx.dim == 1:
            return gather_backward(grad, index, ctx.n), None, None
        g = gather_backward(grad.transpose(1, 2), index, ctx.n)
        return g.transpose(1, 2), None, None


def _gather(x: torch.Tensor, index: torch.Tensor, dim: int) -> torch.Tensor:
    """torch.gather of whole rows (dim 1, `flat_gather_rows`) or columns."""
    if dim == 1:
        return flat_gather_rows(x, index)
    return torch.gather(x, 2, index.long()[:, None, :].expand(
        -1, x.shape[1], -1))


def gather_rows(x: torch.Tensor, index: torch.Tensor,
                dim: int = 1) -> torch.Tensor:
    """Batched gather of whole rows: (B, N, C) x (B, M) -> (B, M, C) with
    `dim` 1, (B, C, N) x (B, M) -> (B, C, M) with `dim` 2.  The forward is
    torch.gather's, bit for bit; where `x` needs a gradient, the backward
    sums each source's contributions in a fixed order (`gather_backward`).
    Where it does not, nothing else runs."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherRows.apply(x, index, dim)
    return _gather(x, index, dim)


def gather_points(points: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Gather channels for selected point indices.

    Args: points (B, C, N); index (B, M) indices into N.
    Returns: (B, C, M).
    """
    return gather_rows(points, index, dim=2)


def group_points(points: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Group neighbour channels by index.

    Args: points (B, C, N); index (B, M, K) neighbour indices.
    Returns: (B, C, M, K), differentiable w.r.t. points with a fixed-order
    backward.
    """
    b, c, _ = points.shape
    m, k = index.shape[1], index.shape[2]
    return gather_points(points, index.reshape(b, m * k)).reshape(b, c, m, k)


def gather_knn(feature: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Gather k-NN features (same contract as group_points; a separate entry
    point mirrors the reference's dgcnn_ext.gather_knn used by EdgeConv)."""
    return group_points(feature, index)

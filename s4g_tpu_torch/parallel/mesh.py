"""Data parallelism over `torch.distributed` (port of
s4g_tpu/parallel/mesh.py).

One process per device.  `make_mesh` returns a 1-D `DeviceMesh` over the
"data" axis that spans the launched world (torchrun's RANK / WORLD_SIZE /
LOCAL_RANK, or a process group already initialized); outside a launched
world it is a world of one, whose collectives are identities.  Batches
are sharded on their leading axis (rank r holds rows r*B/W .. (r+1)*B/W -
1, `shard_batch`) and parameters are replicated, as in the JAX package.

The JAX trainer computes one jitted step over a batch-sharded global
array, so everything in it is a function of the global batch.  The port
gets the same function from `global_batch(mesh)`, a context that the
Trainer enters around its forward, losses and metrics (nothing else
enters it: serving never does):

* train-mode BatchNorm takes the global mean and E[y^2] from all-reduced
  local sums (`sum_over_ranks`, differentiable: its backward is a sum
  all-reduce too), so the statistics and the running averages are the
  global batch's on every rank;
* dropout masks and augmentation draws are drawn at the global batch's
  shape and the rank keeps its rows (`global_rows`), so every rank draws
  the single process's numbers and its generator stays in its state;
* a loss returns the rank's share of the global loss: a batch mean is the
  local mean over W (`batch_mean`; every rank holds B/W rows), a ratio's
  denominator is all-reduced (`sum_over_ranks`).  The shares sum over the
  ranks to the global loss, and the Trainer sums the gradients over the
  ranks (not DDP's mean), which gives the global loss's gradient;
* metrics are local means over equal-sized shards, which the Trainer
  averages over the ranks; a ratio of counts (GPD's precision and recall)
  all-reduces its counts and is global on every rank.

In a world of one the context changes nothing, so a mesh of one is bit
for bit the single-device program.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"


def world_size() -> int:
    """The launched world's size: the initialized process group's, else
    the launcher's WORLD_SIZE, else 1."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def _rank_and_world() -> tuple:
    """(rank, world size, launched): from the process group, else
    torchrun's variables, else a world of one that no launcher made."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), True
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), True
    return 0, 1, False


def _devices(devices: Optional[Sequence], world: int) -> Optional[list]:
    """Every rank's device; None is `cuda:LOCAL_RANK` on each rank (one
    GPU per rank, so distinct GPUs).  Listed CUDA devices carry their
    index: a rank cannot know another rank's LOCAL_RANK."""
    if devices is None:
        return None
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for a world of {world} "
                         "ranks: name one device per rank")
    out = [torch.device(d) for d in devices]
    if len({d.type for d in out}) != 1 or out[0].type not in ("cpu",
                                                              "cuda"):
        raise ValueError(f"the ranks' devices must be all 'cpu' or all "
                         f"CUDA, got {[str(d) for d in out]}")
    if out[0].type == "cuda" and any(d.index is None for d in out):
        raise ValueError("name each rank's GPU with its index ('cuda:k')")
    return out


def _backend(devices: Optional[list]) -> tuple:
    """(backend, why): NCCL where every rank owns a distinct GPU, gloo for
    CPU ranks or ranks that share a card (NCCL refuses two ranks on one
    GPU)."""
    if devices is None:
        return "nccl", "one GPU per rank (cuda:LOCAL_RANK)"
    if devices[0].type == "cpu":
        return "gloo", "CPU ranks"
    if len({d.index for d in devices}) == len(devices):
        return "nccl", "every rank owns a distinct GPU"
    return "gloo", "ranks share a GPU, which NCCL refuses"


def make_mesh(devices: Optional[Sequence] = None,
              axis_name: str = DATA_AXIS):
    """A 1-D data-parallel DeviceMesh over the launched world.

    `devices`: one per rank, e.g. ["cpu"] * W, or the same card twice
    (["cuda:0", "cuda:0"]); None is `cuda:LOCAL_RANK` on every rank.  The
    rank's GPU is made current before anything can launch on it.  The
    backend is NCCL where every rank owns a distinct GPU, else gloo; the
    choice is printed.  A rank whose GPU this host does not have raises
    (nothing falls back to the CPU).  Outside a launched world the mesh is
    a world of one over an in-process store."""
    from torch.distributed.device_mesh import DeviceMesh

    rank, world, launched = _rank_and_world()
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    listed = _devices(devices, world)
    device = (torch.device("cuda", local_rank) if listed is None
              else listed[rank])
    backend, why = _backend(listed)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank} runs on {device} and no GPU is "
                               "available; name 'cpu' devices to run on "
                               "the CPU")
        count = torch.cuda.device_count()
        if device.index >= count:
            raise RuntimeError(f"rank {rank} asks for {device} and this "
                               f"host has {count} GPU(s)")
        torch.cuda.set_device(device)
    if dist.is_initialized():
        have = dist.get_backend()
        if have != backend:
            raise RuntimeError(f"the process group runs {have}; these "
                               f"devices need {backend} ({why})")
    elif launched:
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    mesh = DeviceMesh(device.type, list(range(world)),
                      mesh_dim_names=(axis_name,))
    if device.type == "cuda":
        torch.cuda.set_device(device)   # whatever DeviceMesh chose
    print(f"make_mesh: rank {rank} of {world} on {device}, backend "
          f"{backend} ({why})", flush=True)
    return mesh


def launched_mesh(device=None):
    """In a launched world of W > 1 ranks, `make_mesh` with every rank on
    `device` (None or "cuda": cuda:LOCAL_RANK; "cpu"; "cuda:k": one shared
    card); None in a world of one."""
    world = world_size()
    if world <= 1:
        return None
    spec = None if device is None else str(device)
    return make_mesh(None if spec in (None, "cuda") else [spec] * world)


def mesh_device(mesh) -> torch.device:
    """This rank's device: its current GPU, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def batch_sharding(mesh, axis_name: str = DATA_AXIS):
    """The batch's placement: sharded on the leading axis."""
    from torch.distributed.tensor import Shard
    return Shard(0)


def replicate_sharding(mesh):
    """The parameters' placement: replicated on every rank."""
    from torch.distributed.tensor import Replicate
    return Replicate()


def shard_rows(mesh, batch_size: int) -> slice:
    """This rank's rows of a global batch of `batch_size`; raises when the
    world's size does not divide it."""
    world = mesh.size()
    if batch_size % world:
        raise ValueError(f"a batch of {batch_size} does not split over "
                         f"{world} ranks")
    n = batch_size // world
    rank = mesh.get_local_rank()
    return slice(rank * n, (rank + 1) * n)


def shard_batch(mesh, batch: dict, axis_name: str = DATA_AXIS) -> dict:
    """A dict of host arrays or tensors (the global batch) -> this rank's
    rows of every leaf, as tensors on its device (numpy leaves keep their
    dtype).  Every leading axis must split over the world."""
    device = mesh_device(mesh)

    def leaf(x):
        x = x[shard_rows(mesh, x.shape[0])]
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(device)

    return {k: leaf(v) for k, v in batch.items()}


class _AllReduceSum(torch.autograd.Function):
    """all_reduce(SUM) whose backward is all_reduce(SUM) of the gradient:
    the gradient of sum_q x_q with respect to x_r, gathered from every
    rank's use of the sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=ctx.group)
        return out, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over the group's ranks, differentiable."""
    return _AllReduceSum.apply(x, group)


@dataclass(frozen=True)
class _Ranks:
    group: object
    rank: int
    size: int


_GLOBAL_BATCH: contextvars.ContextVar = contextvars.ContextVar(
    "s4g_global_batch", default=None)


@contextlib.contextmanager
def global_batch(mesh):
    """Within: BatchNorm statistics, dropout masks, augmentation draws and
    loss denominators are the global batch's (the module docstring says
    how).  Inert for mesh None or a world of one."""
    ranks = None
    if mesh is not None and mesh.size() > 1:
        ranks = _Ranks(mesh.get_group(), mesh.get_local_rank(), mesh.size())
    token = _GLOBAL_BATCH.set(ranks)
    try:
        yield
    finally:
        _GLOBAL_BATCH.reset(token)


def global_ranks() -> Optional[_Ranks]:
    """The group, rank and size of the `global_batch` in force, or None."""
    return _GLOBAL_BATCH.get()


def global_rows(draw: Callable[[tuple], torch.Tensor],
                shape: Sequence[int]) -> torch.Tensor:
    """`draw(shape)`, where shape[0] is the local batch; within
    `global_batch`, drawn at the global batch's shape with this rank's
    rows kept."""
    ranks = _GLOBAL_BATCH.get()
    if ranks is None:
        return draw(tuple(shape))
    b = shape[0]
    full = draw((b * ranks.size, *shape[1:]))
    return full[ranks.rank * b:(ranks.rank + 1) * b]


def sum_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """Within `global_batch`, the sum of `x` over the ranks
    (differentiable); else `x`."""
    ranks = _GLOBAL_BATCH.get()
    return x if ranks is None else all_reduce_sum(x, ranks.group)


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of every element of `x`, a loss term over the batch;
    within `global_batch`, this rank's share of the global mean (its
    local mean over W: the shards are equal)."""
    ranks = _GLOBAL_BATCH.get()
    mean = torch.mean(x)
    return mean if ranks is None else mean / ranks.size

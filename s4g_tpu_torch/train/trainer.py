"""Trainer: the training loop with checkpoint and resume (port of
s4g_tpu/train/trainer.py).

One step: the batch to the device, augmentation, the forward in training
mode (batch statistics, dropout masks from the trainer's generator), the
loss dict summed, backward, the optimizer's update at the schedule's
learning rate; the metrics come from the same predictions.  Validation
runs in eval mode under `torch.no_grad()` (on the card its bf16 chains
take K7 and, at b >= 2, SA1 K3, as serving does).  Gradients are
autograd's over plain torch ops: the JAX package has no backward kernel
either, and a training step never takes the fused SA1 (K3) or chain (K7)
kernels.  The indices, counts and distances of the neighbour kernels (K1,
K2, K2f, K4) take no gradient.

The step's scalars stay on the device until the log period, then come to
the host in one copy: a copy per step would make every step wait for the
card.

Data parallelism (`mesh=`, the JAX trainer's mesh): one process per
device, each rank handed the global batch, of which it keeps its rows
(`parallel.shard_batch`).  Forward, losses and metrics run within
`parallel.global_batch`, so the BatchNorm statistics, the dropout masks,
the augmentation draws and the loss denominators are the global batch's,
as in the JAX program's one jitted step; each rank's loss is its share of
the global loss, and the gradients are summed over the ranks
(`all_reduce_grads`, one all-reduce per dtype) before the optimizer.  So
parameters, optimizer moments, BatchNorm buffers and generator states stay
equal on every rank.  The logged scalars are the global ones.  Rank 0
alone writes checkpoints, in the single-device format, and logs; a
barrier follows each checkpoint.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional

import torch
import torch.distributed as dist

from ..configs.config import Config
from ..models import build_loss_and_metric, build_model
from ..parallel.mesh import (global_batch, launched_mesh, mesh_device,
                             shard_batch)
from ..runtime.device import resolve_device
from ..utils.checkpoint import Checkpointer
from ..utils.logger import MetricLogger, setup_logger
from ..utils.profiling import span
from .augmentation import build_augmentation
from .dataset import as_tensor, batch_to_device
from .optim import build_lr_schedule, build_optimizer, set_learning_rate
from .state import TrainState


def _to_host(steps: list) -> list:
    """Per-step dicts of device scalars -> dicts of floats, in one
    device-to-host copy."""
    if not steps:
        return []
    keys = list(steps[0])
    rows = torch.stack([torch.stack([s[k].float() for k in keys])
                        for s in steps]).cpu().tolist()
    return [dict(zip(keys, row)) for row in rows]


class Trainer:
    def __init__(self, cfg: Config, output_dir: str = "output",
                 steps_per_epoch: int = 1, device: Optional[str] = None,
                 logger=None, mesh=None):
        """`device`: "cuda" (the default) or "cpu" (the tests); without a
        GPU a trainer is only made when the CPU is asked for.
        `steps_per_epoch` turns the schedule's epochs into steps.  `mesh`:
        a `parallel.make_mesh` mesh to train data-parallel over, on its
        rank's device; None in a launched world of W > 1 ranks is
        `make_mesh` over it (each rank on `device`: "cuda" is
        cuda:LOCAL_RANK), as the JAX trainer defaults to every device, and
        one device otherwise."""
        if mesh is None:
            mesh = launched_mesh(device)
        self.mesh = mesh
        self.device = (resolve_device(device, "Trainer") if mesh is None
                       else mesh_device(mesh))
        self.lead = mesh is None or mesh.get_local_rank() == 0
        self.cfg = cfg
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        if not self.lead:           # rank 0 alone logs
            logger = logging.getLogger(
                f"S4G.train.rank{mesh.get_local_rank()}")
            logger.setLevel(logging.WARNING)
        self.logger = logger or setup_logger("S4G.train", output_dir, "train")
        self.loss_fn, self.metric_fn = build_loss_and_metric(cfg)
        self.schedule = build_lr_schedule(cfg, steps_per_epoch)
        self.augment = build_augmentation(cfg.TRAIN.AUGMENTATION)
        # Checkpoints load on the host: load_state_dict moves the weights
        # and moments to the parameters' device, but keeps Adam's step
        # counts where they come, and one on the card is read back (a
        # wait) for every parameter at every step.
        self.checkpointer = Checkpointer(output_dir, self.logger,
                                         map_location="cpu")
        self.generator = torch.Generator(device=self.device)
        self.net: Optional[torch.nn.Module] = None
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.step = 0

    # -- state ---------------------------------------------------------------

    def init_state(self, seed: Optional[int] = None) -> TrainState:
        """A fresh model from `seed` (cfg.RNG_SEED), a fresh optimizer over
        its trainable parameters, the generator seeded, step 0.  Under a
        mesh every rank builds it and takes rank 0's."""
        seed = self.cfg.RNG_SEED if seed is None else seed
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            net = build_model(self.cfg)
        self.net = net.to(self.device).train()
        if self.mesh is not None:
            for t in self.net.state_dict().values():
                dist.broadcast(t, src=0, group=self.mesh.get_group())
        self.optimizer = build_optimizer(self.cfg, self.net.parameters())
        self.generator.manual_seed(seed)
        self.step = 0
        return self.state()

    def state(self) -> TrainState:
        return TrainState(step=self.step, model=self.net.state_dict(),
                          optimizer=self.optimizer.state_dict(),
                          generator=self.generator.get_state())

    def load_state(self, state: TrainState) -> None:
        if self.net is None:
            self.init_state()
        self.net.load_state_dict(state.model)
        self.optimizer.load_state_dict(state.optimizer)
        self.generator.set_state(state.generator)
        self.step = state.step

    def resume_or_init(self) -> TrainState:
        """`init_state`, then with AUTO_RESUME the checkpoint that
        `output_dir/last_checkpoint` points at, where there is one."""
        state = self.init_state()
        if self.cfg.AUTO_RESUME and self.checkpointer.has_checkpoint():
            checkpoint = self.checkpointer.load(None, resume=True)
            if checkpoint is not None:
                self.load_state(TrainState.from_checkpoint(checkpoint))
                self.logger.info("Resumed from step %d", self.step)
                return self.state()
        return state

    # -- steps ---------------------------------------------------------------

    def _on_device(self, batch: dict) -> dict:
        """The global batch -> this rank's rows on its device (the whole
        batch without a mesh)."""
        if self.mesh is None:
            return batch_to_device(batch, self.device)
        return shard_batch(self.mesh, {k: as_tensor(v)
                                       for k, v in batch.items()})

    def forward_loss(self, batch: dict) -> tuple:
        """The (global) batch on the device (this rank's rows) and
        augmented, the training-mode forward and the loss dict: (total
        loss, loss dict, predictions, batch); under a mesh the losses are
        this rank's shares."""
        with span("train.forward_loss", device=self.device), \
                global_batch(self.mesh):
            batch = self.augment(self.generator, self._on_device(batch))
            self.net.train()
            preds = self.net(batch, generator=self.generator)
            loss_dict = self.loss_fn(preds, batch)
        # The JAX trainer sums the dict's leaves, which come in key order.
        total = sum(loss_dict[k] for k in sorted(loss_dict))
        return total, loss_dict, preds, batch

    def backward(self, total: torch.Tensor) -> None:
        with span("train.backward", device=self.device):
            self.optimizer.zero_grad(set_to_none=True)
            total.backward()
            if self.mesh is not None:
                self.all_reduce_grads()

    def all_reduce_grads(self) -> None:
        """Sum every gradient over the ranks: one all-reduce of the
        gradients flattened together, per dtype."""
        grads = {}
        for p in self.net.parameters():
            if p.grad is not None:
                grads.setdefault(p.grad.dtype, []).append(p.grad)
        for group in grads.values():
            flat = torch.cat([g.reshape(-1) for g in group])
            dist.all_reduce(flat, group=self.mesh.get_group())
            offset = 0
            for g in group:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()

    def _global_scalars(self, scalars: dict, losses) -> dict:
        """Under a mesh, the scalars over the global batch: the loss
        shares summed over the ranks, the metrics' means averaged (one
        all-reduce)."""
        if self.mesh is None:
            return scalars
        keys = list(scalars)
        vec = torch.stack([scalars[k].double() for k in keys])
        dist.all_reduce(vec, group=self.mesh.get_group())
        world = self.mesh.size()
        return {k: (vec[i] if k in losses else vec[i] / world)
                .to(scalars[k].dtype) for i, k in enumerate(keys)}

    def update(self) -> None:
        """The optimizer's step at the schedule's learning rate for the
        updates made so far."""
        with span("train.update", device=self.device):
            set_learning_rate(self.optimizer, self.schedule(self.step))
            self.optimizer.step()
            self.step += 1

    def train_step(self, batch: dict) -> dict:
        """One update; returns the losses, the metrics' means and
        "total_loss" as device scalars.  The span `train.step` (call id:
        the step) counts the host's waits on the device in it."""
        with span("train.step", call=self.step, waits=self.device):
            total, loss_dict, preds, batch = self.forward_loss(batch)
            self.backward(total)
            self.update()
            with torch.no_grad(), global_batch(self.mesh):
                metrics = self.metric_fn(preds, batch)
                scalars = {k: torch.mean(v.detach().float())
                           for k, v in {**loss_dict, **metrics}.items()}
            scalars["total_loss"] = total.detach()
            return self._global_scalars(scalars,
                                        {*loss_dict, "total_loss"})

    def val_step(self, batch: dict) -> dict:
        """Losses and metrics' means in eval mode, as device scalars (over
        the global batch under a mesh)."""
        batch = self._on_device(batch)
        self.net.eval()
        with torch.no_grad(), global_batch(self.mesh):
            preds = self.net(batch)
            losses = self.loss_fn(preds, batch)
            out = {**losses, **self.metric_fn(preds, batch)}
            return self._global_scalars(
                {k: torch.mean(v.float()) for k, v in out.items()}, losses)

    # -- loop ----------------------------------------------------------------

    def fit(self, train_data, val_data=None,
            max_epochs: Optional[int] = None,
            state: Optional[TrainState] = None) -> TrainState:
        """Train to `max_epochs` (SCHEDULER.MAX_EPOCH) from `state`, else
        from where `resume_or_init` finds it: the resumed step count says
        which epoch to start.  Logs every LOG_PERIOD steps, validates on
        `val_data` every VAL_PERIOD epochs and checkpoints every
        CHECKPOINT_PERIOD epochs and after the last as
        `model_{epoch:03d}`."""
        max_epochs = max_epochs or self.cfg.SCHEDULER.MAX_EPOCH
        log_period = self.cfg.TRAIN.LOG_PERIOD
        val_period = self.cfg.TRAIN.VAL_PERIOD
        ckpt_period = self.cfg.TRAIN.CHECKPOINT_PERIOD
        if state is not None:
            self.load_state(state)
        elif self.net is None:
            self.resume_or_init()
        steps_per_epoch = max(len(train_data), 1) if hasattr(
            train_data, "__len__") else 1
        start_epoch = self.step // steps_per_epoch
        if start_epoch:
            self.logger.info("Resuming at epoch %d (step %d)", start_epoch,
                             self.step)
        meters = MetricLogger(delimiter="  ")
        for epoch in range(start_epoch, max_epochs):
            period = tic = time.perf_counter()
            pending = []
            for it, batch in enumerate(train_data):
                data_time = time.perf_counter() - tic
                pending.append((data_time, self.train_step(batch)))
                if (it + 1) % log_period == 0:
                    period = self._log(meters, pending, period)
                    self.logger.info("epoch %d iter %d  %s", epoch, it + 1,
                                     meters)
                tic = time.perf_counter()
            self._log(meters, pending, period)

            if val_data is not None and (epoch + 1) % val_period == 0:
                val_meters = MetricLogger(delimiter="  ")
                for scalars in _to_host([self.val_step(b)
                                         for b in val_data]):
                    val_meters.update(**scalars)
                self.logger.info("VAL epoch %d  %s", epoch, val_meters)

            if (epoch + 1) % ckpt_period == 0 or epoch + 1 == max_epochs:
                self.save_checkpoint(f"model_{epoch + 1:03d}")
        return self.state()

    def save_checkpoint(self, name: str) -> None:
        """`Checkpointer.save` of the state, by rank 0 alone under a mesh,
        then a barrier: every rank can read it once this returns."""
        if self.lead:
            self.checkpointer.save(name, self.state().to_checkpoint())
        if self.mesh is not None:
            dist.barrier(group=self.mesh.get_group())

    @staticmethod
    def _log(meters: MetricLogger, pending: list, start: float) -> float:
        """Move the pending (data wait, scalars) steps to the host (one
        copy, which waits for the device) into `meters`, and empty
        `pending`.  Each step's "time" is the log period's wall time, from
        `start` (the previous period's end, `time.perf_counter`) to the
        copy's end, over its steps: the device's time a step, not the
        host's enqueue time.  Returns the period's end."""
        host = _to_host([scalars for _, scalars in pending])
        end = time.perf_counter()
        for (data_time, _), scalars in zip(pending, host):
            meters.update(time=(end - start) / len(pending), data=data_time,
                          **scalars)
        pending.clear()
        return end

"""Trainer: the training loop with checkpoint and resume (port of
s4g_tpu/train/trainer.py).

One step: the batch to the device, augmentation, the forward in training
mode (batch statistics, dropout masks from the trainer's generator), the
loss dict summed, backward, the optimizer's update at the schedule's
learning rate; the metrics come from the same predictions.  Validation
runs in eval mode under `torch.no_grad()`.  Gradients are autograd's over
plain torch ops: the JAX package has no backward kernel either, and
training never takes the fused SA1 (K3) or chain (K7) kernels.  The
indices, counts and distances of the neighbour kernels (K1, K2, K2f, K4)
take no gradient.

The step's scalars stay on the device until the log period, then come to
the host in one copy: a copy per step would make every step wait for the
card.

One device only: the JAX trainer's mesh (data parallelism) is not ported
yet (ROADMAP.md §1 item 7), so this Trainer takes no mesh.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import torch

from ..configs.config import Config
from ..models import build_loss_and_metric, build_model
from ..runtime.device import resolve_device
from ..utils.checkpoint import Checkpointer
from ..utils.logger import MetricLogger, setup_logger
from .augmentation import build_augmentation
from .dataset import batch_to_device
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
                 logger=None):
        """`device`: "cuda" (the default) or "cpu" (the tests); without a
        GPU a trainer is only made when the CPU is asked for.
        `steps_per_epoch` turns the schedule's epochs into steps."""
        self.device = resolve_device(device, "Trainer")
        self.cfg = cfg
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
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
        its trainable parameters, the generator seeded, step 0."""
        seed = self.cfg.RNG_SEED if seed is None else seed
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            net = build_model(self.cfg)
        self.net = net.to(self.device).train()
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

    def forward_loss(self, batch: dict) -> tuple:
        """The batch on the device and augmented, the training-mode
        forward and the loss dict: (total loss, loss dict, predictions,
        batch)."""
        batch = self.augment(self.generator,
                             batch_to_device(batch, self.device))
        self.net.train()
        preds = self.net(batch, generator=self.generator)
        loss_dict = self.loss_fn(preds, batch)
        # The JAX trainer sums the dict's leaves, which come in key order.
        total = sum(loss_dict[k] for k in sorted(loss_dict))
        return total, loss_dict, preds, batch

    def backward(self, total: torch.Tensor) -> None:
        self.optimizer.zero_grad(set_to_none=True)
        total.backward()

    def update(self) -> None:
        """The optimizer's step at the schedule's learning rate for the
        updates made so far."""
        set_learning_rate(self.optimizer, self.schedule(self.step))
        self.optimizer.step()
        self.step += 1

    def train_step(self, batch: dict) -> dict:
        """One update; returns the losses, the metrics' means and
        "total_loss" as device scalars."""
        total, loss_dict, preds, batch = self.forward_loss(batch)
        self.backward(total)
        self.update()
        with torch.no_grad():
            metrics = self.metric_fn(preds, batch)
            scalars = {k: torch.mean(v.detach().float())
                       for k, v in {**loss_dict, **metrics}.items()}
        scalars["total_loss"] = total.detach()
        return scalars

    def val_step(self, batch: dict) -> dict:
        """Losses and metrics' means in eval mode, as device scalars."""
        batch = batch_to_device(batch, self.device)
        self.net.eval()
        with torch.no_grad():
            preds = self.net(batch)
            out = {**self.loss_fn(preds, batch),
                   **self.metric_fn(preds, batch)}
            return {k: torch.mean(v.float()) for k, v in out.items()}

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
            tic = time.time()
            pending = []
            for it, batch in enumerate(train_data):
                data_time = time.time() - tic
                scalars = self.train_step(batch)
                batch_time = time.time() - tic
                tic = time.time()
                pending.append((batch_time, data_time, scalars))
                if (it + 1) % log_period == 0:
                    self._log(meters, pending)
                    self.logger.info("epoch %d iter %d  %s", epoch, it + 1,
                                     meters)
            self._log(meters, pending)

            if val_data is not None and (epoch + 1) % val_period == 0:
                val_meters = MetricLogger(delimiter="  ")
                for scalars in _to_host([self.val_step(b)
                                         for b in val_data]):
                    val_meters.update(**scalars)
                self.logger.info("VAL epoch %d  %s", epoch, val_meters)

            if (epoch + 1) % ckpt_period == 0 or epoch + 1 == max_epochs:
                self.checkpointer.save(f"model_{epoch + 1:03d}",
                                       self.state().to_checkpoint())
        return self.state()

    @staticmethod
    def _log(meters: MetricLogger, pending: list) -> None:
        """Move the pending steps' scalars to the host (one copy) into
        `meters`, and empty `pending`."""
        host = _to_host([scalars for _, _, scalars in pending])
        for (bt, dt, _), scalars in zip(pending, host):
            meters.update(time=bt, data=dt, **scalars)
        pending.clear()

"""Optimizer and learning-rate schedule factory (port of
s4g_tpu/train/optim.py, whose optax chains these reproduce): Adam (betas),
SGD (momentum), RMSprop (alpha), weight decay as L2 added to the raw
gradient before the optimizer's statistics, and StepLR / MultiStepLR epoch
schedules.

Adam and SGD are torch's own: `torch.optim.Adam` (eps 1e-8 outside the
square root, bias-corrected) is optax's `scale_by_adam` up to rounding,
and `torch.optim.SGD(momentum, dampening=0, nesterov=False)` is
`optax.trace` (the first step's buffer is the gradient).  RMSprop is not:
optax's `scale_by_rms` divides by sqrt(nu + eps) with nu starting at 0
and no momentum, `torch.optim.RMSprop` by sqrt(nu) + eps, so a 1e-4
gradient's first update at decay 0.9 is 0.953 lr in optax and 3.16 lr in
torch.  `RMSprop` below is optax's.

The learning rate follows optax's `scale_by_learning_rate(schedule)`:
before each update, `set_learning_rate(optimizer, schedule(step))` with
`step` the number of updates already made (optax's count, from 0).
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch

from ..configs.config import Config


def build_lr_schedule(cfg: Config, steps_per_epoch: int
                      ) -> Callable[[int], float]:
    """step -> learning rate: SCHEDULER.TYPE's per-epoch rule at epoch
    step // steps_per_epoch (constant BASE_LR without a type)."""
    base_lr = cfg.SOLVER.BASE_LR
    sched_type = cfg.SCHEDULER.TYPE
    if not sched_type:
        return lambda step: base_lr
    if sched_type == "StepLR":
        step_size = max(cfg.SCHEDULER.StepLR.step_size, 1)
        gamma = cfg.SCHEDULER.StepLR.gamma
        return lambda step: base_lr * gamma ** (
            step // steps_per_epoch // step_size)
    if sched_type == "MultiStepLR":
        milestones = cfg.SCHEDULER.MultiStepLR.milestones
        gamma = cfg.SCHEDULER.MultiStepLR.gamma

        def schedule(step: int) -> float:
            epoch = step // steps_per_epoch
            factor = 1.0
            for m in milestones:
                factor = factor * (gamma if epoch >= m else 1.0)
            return base_lr * factor
        return schedule
    raise ValueError(f"Unknown scheduler {sched_type!r}")


class RMSprop(torch.optim.Optimizer):
    """optax `add_decayed_weights(weight_decay)` + `scale_by_rms(alpha,
    eps)` + the learning rate: g' = g + wd p, nu = (1 - alpha) g'^2 +
    alpha nu (nu from 0), p = p - lr g' rsqrt(nu + eps)."""

    def __init__(self, params, lr: float, alpha: float = 0.9,
                 eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, alpha=alpha, eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            alpha, wd = group["alpha"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if wd > 0:
                    g = g + wd * p
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                nu = state["nu"]
                nu.copy_((1 - alpha) * (g * g) + alpha * nu)
                p.add_(torch.rsqrt(nu + group["eps"]) * g * -group["lr"])
        return loss


def build_optimizer(cfg: Config, params: Iterable[torch.nn.Parameter]
                    ) -> torch.optim.Optimizer:
    """SOLVER.TYPE's optimizer over `params` (pass only the trainable
    ones: see models/freezer.py), at the learning rate BASE_LR until
    `set_learning_rate` sets the schedule's."""
    params = list(params)
    lr, wd = cfg.SOLVER.BASE_LR, cfg.SOLVER.WEIGHT_DECAY
    solver = cfg.SOLVER.TYPE
    if solver == "Adam":
        return torch.optim.Adam(params, lr=lr, betas=cfg.SOLVER.Adam.betas,
                                eps=1e-8, weight_decay=wd)
    if solver == "SGD":
        return torch.optim.SGD(params, lr=lr,
                               momentum=cfg.SOLVER.SGD.momentum,
                               dampening=0.0, nesterov=False,
                               weight_decay=wd)
    if solver == "RMSprop":
        return RMSprop(params, lr=lr, alpha=cfg.SOLVER.RMSprop.alpha,
                       weight_decay=wd)
    raise ValueError(f"Unknown solver {solver!r}")


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr

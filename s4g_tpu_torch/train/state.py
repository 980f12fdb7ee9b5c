"""Train state: the checkpointable unit (port of s4g_tpu/train/state.py),
the step counter, the model's state_dict (parameters and BatchNorm
buffers), the optimizer's state_dict and the generator's state (the
augmentation draws and dropout masks).  `utils.checkpoint.Checkpointer`
saves it as `{"model", "optimizer", "extra"}`, which loads with
`weights_only=True`."""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class TrainState:
    step: int
    model: dict
    optimizer: dict
    generator: torch.Tensor

    def to_checkpoint(self) -> dict:
        return {"model": self.model, "optimizer": self.optimizer,
                "extra": {"step": self.step, "generator": self.generator}}

    @classmethod
    def from_checkpoint(cls, checkpoint: dict) -> "TrainState":
        extra = checkpoint["extra"]
        return cls(step=int(extra["step"]), model=checkpoint["model"],
                   optimizer=checkpoint["optimizer"],
                   generator=extra["generator"])

"""Faults planted in the program under a run, to show that the check comes
out not correct on each fault a cell can have (the CPU tests at a narrow
size; `calibrate.py --faults` on the card at the cell's own size):

- `altered`: every grasp the detector returns moved by 1 cm;
- `half_answered`: a batch call answers for its first half of scenes only;
- `all_invalid`: the collision check (K5) marks every candidate as
  colliding, so no candidate is valid and no grasp is returned;
- `no_grasps`: the detector returns no grasps, whatever it found;
- `unchanged`: a train step that leaves the parameters as they were;
- `half_batch`: a train step over the first half of the batch's rows (the
  mean over them).
"""

from __future__ import annotations

import contextlib

import numpy as np


def _altered():
    from s4g_tpu_torch.pipeline.detector import GraspDetector
    real = GraspDetector._materialize

    def materialize(self, job):
        out = real(self, job)
        for poses, _ in out:
            poses[:, :3, 3] += 0.01
        return out
    return GraspDetector, "_materialize", materialize


def _half_answered():
    from s4g_tpu_torch.pipeline.detector import GraspDetector
    real = GraspDetector._materialize
    return GraspDetector, "_materialize", lambda self, job: real(self, job)[
        :max(1, job["scenes"] // 2)]


def _all_invalid():
    from s4g_tpu_torch.pipeline import detector
    real = detector.batch_view_non_collision
    return detector, "batch_view_non_collision", \
        lambda *a, **k: real(*a, **k) & False


def _no_grasps():
    from s4g_tpu_torch.pipeline import detector
    return detector, "_grasps", lambda out, num_selected: (
        np.zeros((0, 4, 4), np.float32), np.zeros((0,), np.float32))


def _unchanged():
    from s4g_tpu_torch.train.trainer import Trainer
    return Trainer, "update", lambda self: setattr(self, "step",
                                                   self.step + 1)


def _half_batch():
    from s4g_tpu_torch.train.trainer import Trainer
    real = Trainer.forward_loss

    def forward_loss(self, batch):
        half = {k: v[:max(1, len(v) // 2)] for k, v in batch.items()}
        return real(self, half)
    return Trainer, "forward_loss", forward_loss


PLANTS = {"altered": _altered, "half_answered": _half_answered,
          "all_invalid": _all_invalid, "no_grasps": _no_grasps,
          "unchanged": _unchanged, "half_batch": _half_batch}


@contextlib.contextmanager
def planted(name: str):
    """The program with fault `name` in it, for the block."""
    owner, attr, replacement = PLANTS[name]()
    real = owner.__dict__[attr]
    setattr(owner, attr, replacement)
    try:
        yield
    finally:
        setattr(owner, attr, real)

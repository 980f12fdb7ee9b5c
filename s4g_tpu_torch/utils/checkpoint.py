"""Checkpoints (port of s4g_tpu/utils/checkpoint.py): save and load with a
`last_checkpoint` pointer, and the loading of reference `.pth` weights.

Same contract as the JAX package's `Checkpointer` (and the reference's
CheckPointer): a checkpoint holds a dict `{"model": state_dict,
"optimizer": ..., "extra": ...}`, and `save` points `save_dir/
last_checkpoint` at the file it wrote, so a later run can resume from it.
Files are written with `torch.save` and read with `weights_only=True`:
tensors, numbers, strings and containers of them load; a file that pickles
other objects (an optimizer entry holding a scheduler's lambda, say) is
refused.

The JAX package writes orbax directories, which this package cannot read:
load such a checkpoint in JAX, convert its variables with
`s4g_tpu_torch.utils.weights.state_dict_from_flax` and save the result
with this `Checkpointer`.
"""

from __future__ import annotations

import logging
import os
import pickle
from typing import Any, Optional

import torch


def _load(path: str, map_location=None) -> Any:
    try:
        return torch.load(path, map_location=map_location, weights_only=True)
    except pickle.UnpicklingError as err:
        raise ValueError(
            f"{path} holds objects other than tensors, numbers, strings and "
            "containers of them, which are not loaded (weights_only=True); "
            "re-save it as {'model': state_dict}") from err


def _refuse_orbax(path: str) -> None:
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory (an orbax checkpoint of the JAX "
            "package?), which this package cannot read: load it with "
            "s4g_tpu.utils.checkpoint.Checkpointer, convert its variables "
            "with s4g_tpu_torch.utils.weights.state_dict_from_flax and save "
            "that with s4g_tpu_torch.utils.checkpoint.Checkpointer")


class Checkpointer:
    """Save and load checkpoints with last-checkpoint semantics."""

    def __init__(self, save_dir: str = "", logger=None, map_location=None):
        """`map_location`: where `load` puts the tensors (a device)."""
        self.save_dir = os.path.abspath(save_dir) if save_dir else ""
        self.logger = logger or logging.getLogger(__name__)
        self.map_location = map_location

    def _pointer_file(self) -> str:
        return os.path.join(self.save_dir, "last_checkpoint")

    def save(self, name: str, state: dict) -> str:
        """Write `state` ({"model", "optimizer", "extra"}) to
        `save_dir/name.ckpt` and point `last_checkpoint` at it.  Returns the
        path, or "" without a save directory."""
        if not self.save_dir:
            self.logger.warning("No save directory specified; skipping save")
            return ""
        os.makedirs(self.save_dir, exist_ok=True)
        path = os.path.join(self.save_dir, f"{name}.ckpt")
        torch.save(state, path)
        with open(self._pointer_file(), "w") as f:
            f.write(path)
        self.logger.info("Saved checkpoint to %s", path)
        return path

    def has_checkpoint(self) -> bool:
        return os.path.exists(self._pointer_file())

    def last_checkpoint_path(self) -> str:
        try:
            with open(self._pointer_file()) as f:
                return f.read().strip()
        except IOError:
            self.logger.warning("last_checkpoint pointer missing in %s",
                                self.save_dir)
            return ""

    def load(self, filename: Optional[str] = None,
             resume: bool = True) -> Optional[dict]:
        """The checkpoint `last_checkpoint` points at (with `resume`, where
        there is one), else `filename`; None when there is neither."""
        if resume and self.has_checkpoint():
            filename = self.last_checkpoint_path()
        if not filename:
            self.logger.info("No checkpoint found; initializing from scratch")
            return None
        _refuse_orbax(filename)
        self.logger.info("Loading checkpoint from %s", filename)
        return _load(filename, self.map_location)


def _strip_module_prefix(state_dict: dict) -> dict:
    """Drop DataParallel's "module." prefix (reference: checkpoint.py:80-89)."""
    return {(k[7:] if k.startswith("module.") else k): v
            for k, v in state_dict.items()}


def model_state_dict(checkpoint: dict) -> dict:
    """A checkpoint's model weights: its "model" entry where it has one,
    else the checkpoint itself, with any "module." prefix stripped."""
    return _strip_module_prefix(checkpoint.get("model", checkpoint))


def load_torch_checkpoint(path: str, map_location=None) -> dict:
    """A reference `.pth` file -> the model's state_dict (the role of the
    JAX package's `import_torch_checkpoint`).  The reference's names are
    this package's, so nothing is renamed: the "model" entry is unwrapped
    and "module." stripped."""
    _refuse_orbax(path)
    return model_state_dict(_load(path, map_location))

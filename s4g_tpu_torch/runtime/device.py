"""The device a detector, a trainer or a tool runs on."""

from __future__ import annotations

from typing import Optional

import torch


def resolve_device(device: Optional[str], who: str) -> torch.device:
    """`device` as a torch.device: None means "cuda".  A CUDA device without
    a GPU raises (nothing falls back to the CPU unless it is asked for)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who} runs on CUDA and no GPU is available; "
                           "pass device='cpu' to run on the CPU")
    return device

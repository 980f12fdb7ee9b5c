"""GPD baseline: a LeNet-style CNN over gripper-frame projection maps (port
of s4g_tpu/models/gpd.py), with its loss and metric.

Input: "close_region_projection_maps", (B, C_in, 60, 60) or (B, G, C_in,
60, 60), folded to (B * G, ...); output "grasp_logits" (B * G, classes) in
f32.  Two VALID 5x5 convolutions (20 and 50 channels), each followed by a
2x2 max pool, then fc1 (500, ReLU, optional element-wise dropout 0.5 in
training) and fc2.  A torch Conv2d needs its input channels up front,
which flax infers from the data: the model is built with
`DATA.GPD_IN_CHANNELS` (the baseline maps have 12).

The forward runs in NCHW, so fc1 reads the pooled maps flattened in
(channel, row, column) order, the reference's `view`; the JAX model
flattens NHWC, (row, column, channel), and `utils/weights.py` permutes
fc1's inputs across.  Each layer computes in the compute dtype (operands
cast, the bias added in it), as flax `nn.Conv` / `nn.Dense(dtype=...)`.
Names follow the JAX modules: `conv1`, `conv2`, `fc1`, `fc2`.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as TF
from torch import nn

from . import functional as F
from .nn_layers import dropout
from ..parallel.mesh import sum_over_ranks

POOLED = 12          # 60 -> conv 56 -> pool 28 -> conv 24 -> pool 12


def dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype
          ) -> torch.Tensor:
    """flax `nn.Dense(dtype=...)`: the product in the compute dtype, then
    the bias added in it."""
    return torch.matmul(x.to(dtype), layer.weight.t().to(dtype)) \
        + layer.bias.to(dtype)


def _conv(x: torch.Tensor, layer: nn.Conv2d, dtype: torch.dtype
          ) -> torch.Tensor:
    return TF.conv2d(x.to(dtype), layer.weight.to(dtype),
                     layer.bias.to(dtype))


class GPDClassifier(nn.Module):
    """(B, C_in, 60, 60) or (B, G, C_in, 60, 60) maps -> grasp logits."""

    def __init__(self, score_classes: int, in_channels: int = 3,
                 dropout: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, 20, 5)
        self.conv2 = nn.Conv2d(20, 50, 5)
        self.fc1 = nn.Linear(50 * POOLED * POOLED, 500)
        self.fc2 = nn.Linear(500, score_classes)
        self.dropout = dropout
        self.dtype = dtype
        self.eval()

    def forward(self, data_batch: dict,
                generator: Optional[torch.Generator] = None) -> dict:
        maps = data_batch["close_region_projection_maps"]
        if maps.dim() == 5:
            maps = maps.reshape(-1, *maps.shape[2:])
        dt = self.dtype
        with torch.set_grad_enabled(self.training
                                    and torch.is_grad_enabled()):
            x = TF.max_pool2d(_conv(maps, self.conv1, dt), 2)
            x = TF.max_pool2d(_conv(x, self.conv2, dt), 2)
            x = torch.relu(dense(x.flatten(1), self.fc1, dt))
            if self.dropout and self.training:
                x = dropout(x, 0.5, generator)
            return {"grasp_logits": dense(x, self.fc2, dt).float()}


def gpd_loss(preds: dict, labels: dict) -> dict:
    """Cross entropy of the grasp logits against "grasp_score_labels"."""
    return {"cls_loss": F.cross_entropy(
        preds["grasp_logits"][..., None],
        labels["grasp_score_labels"][..., None])}


def gpd_metric(preds: dict, labels: dict) -> dict:
    """Accuracy, and precision and recall of the top score class (within
    `parallel.global_batch`, of the global batch's counts)."""
    logits = preds["grasp_logits"]
    top = logits.shape[-1] - 1
    target = labels["grasp_score_labels"]
    pred_cls = torch.argmax(logits, dim=1)
    gt_pos = target == top
    pred_pos = pred_cls == top
    true_pos = sum_over_ranks(torch.sum((gt_pos & pred_pos).float()))
    return {"cls_acc": (pred_cls == target).float(),
            "prec": true_pos / torch.clamp(
                sum_over_ranks(torch.sum(pred_pos.float())), min=1e-6),
            "recall": true_pos / torch.clamp(
                sum_over_ranks(torch.sum(gt_pos.float())), min=1e-6)}

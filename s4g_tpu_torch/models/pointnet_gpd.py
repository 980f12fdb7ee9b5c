"""PointNetGPD baseline: a vanilla PointNet classifier over close-region
points (port of s4g_tpu/models/pointnet_gpd.py), with its loss; its
metric is GPD's.

Input: "close_region_points", (B, 3, N) or (B, G, 3, N), folded to
(B * G, 3, N); output "grasp_logits" (B * G, classes) in f32.  `STN3d`
predicts a 3x3 alignment (plus the identity) that the points are
multiplied by, then Dense + BatchNorm + ReLU layers per point (the third
without ReLU), a max over the points and Dense + BatchNorm + ReLU layers.
Each Dense computes in the compute dtype (`gpd.dense`); each BatchNorm
runs in f32 with flax's formula and statistics (momentum 0.9 there, 0.1
here; `nn_layers.batch_norm`).  Names follow the JAX modules:
`stn.conv1.fc.*`, `stn.conv1.bn.*`, ..., `stn.fc3.*`, `conv1.fc.*`, ...,
`conv3.*`, `bn3.*`, `fc3.*`.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from . import functional as F
from .gpd import dense
from .gpd import gpd_metric as pointnet_gpd_metric  # noqa: F401
from .nn_layers import batch_norm


class DenseBNRelu(nn.Module):
    """Dense + BatchNorm + ReLU over the last axis (JAX `_DenseBNRelu`);
    built in eval mode."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc = nn.Linear(in_features, features)
        self.bn = nn.BatchNorm1d(features)
        self.dtype = dtype
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(batch_norm(dense(x, self.fc, self.dtype),
                                     self.bn))


class STN3d(nn.Module):
    """Spatial transformer: (B, N, 3) points -> a (B, 3, 3) alignment."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = DenseBNRelu(3, 64, dtype)
        self.conv2 = DenseBNRelu(64, 128, dtype)
        self.conv3 = DenseBNRelu(128, 1024, dtype)
        self.fc1 = DenseBNRelu(1024, 512, dtype)
        self.fc2 = DenseBNRelu(512, 256, dtype)
        self.fc3 = nn.Linear(256, 9)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv3(self.conv2(self.conv1(x)))
        h = self.fc2(self.fc1(torch.amax(h, dim=1)))
        mat = dense(h, self.fc3, self.dtype).reshape(-1, 3, 3)
        return mat + torch.eye(3, dtype=mat.dtype, device=mat.device)


class PointNetGPDClassifier(nn.Module):
    """(B, 3, N) or (B, G, 3, N) close-region points -> grasp logits."""

    def __init__(self, score_classes: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stn = STN3d(dtype)
        self.conv1 = DenseBNRelu(3, 64, dtype)
        self.conv2 = DenseBNRelu(64, 128, dtype)
        self.conv3 = nn.Linear(128, 1024)
        self.bn3 = nn.BatchNorm1d(1024)
        self.fc1 = DenseBNRelu(1024, 512, dtype)
        self.fc2 = DenseBNRelu(512, 256, dtype)
        self.fc3 = nn.Linear(256, score_classes)
        self.dtype = dtype
        self.eval()

    def forward(self, data_batch: dict,
                generator: Optional[torch.Generator] = None) -> dict:
        pts = data_batch["close_region_points"]
        if pts.dim() == 4:
            pts = pts.reshape(-1, *pts.shape[2:])
        dt = self.dtype
        with torch.set_grad_enabled(self.training
                                    and torch.is_grad_enabled()):
            x = pts.transpose(1, 2)                           # (B, N, 3)
            # f32 points times the compute-dtype alignment: f32, as jnp
            # promotes them.
            trans = self.stn(x)
            wide = torch.promote_types(x.dtype, trans.dtype)
            x = torch.einsum("bnc,bcd->bnd", x.to(wide), trans.to(wide))
            x = self.conv2(self.conv1(x))
            x = batch_norm(dense(x, self.conv3, dt), self.bn3)
            x = self.fc2(self.fc1(torch.amax(x, dim=1)))
            return {"grasp_logits": dense(x, self.fc3, dt).float()}


def pointnet_gpd_loss(preds: dict, labels: dict) -> dict:
    """Cross entropy of the grasp logits against "grasp_score_labels"."""
    return {"cls_loss": F.cross_entropy(
        preds["grasp_logits"][..., None],
        labels["grasp_score_labels"][..., None])}

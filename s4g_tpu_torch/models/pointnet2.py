"""PointNet++ backbone and the PN2_CLS grasp-proposal model, eval mode
(port of s4g_tpu/models/pointnet2.py).

Modules keep the reference torch names (`sa_modules.{i}.mlp.{j}.{conv,bn}`,
`fp_modules.{i}.mlp.{j}.*`, `mlp_{seg,R,t,movable}.{j}.*`,
`{seg,R,t}_logit.*`, `movable_logit.0.*`), so `state_dict()` is a reference
PN2_CLS state dict (`utils/weights.py` converts the JAX package's variables
into it).  Predictions come out channels-first in f32, like the JAX model's.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .nn_layers import SharedMLP
from .pn2_modules import PointnetFPModule, PointNetSAModule, gather_cl
from ..ops.neighbors import invert_permutation


class PointNet2Backbone(nn.Module):
    """SA pyramid + FP pyramid producing per-point features (B, N, C)."""

    def __init__(self, num_centroids: Sequence[int], radius: Sequence[float],
                 num_neighbours: Sequence[int],
                 sa_channels: Sequence[Sequence[int]],
                 fp_channels: Sequence[Sequence[int]],
                 num_fp_neighbours: Sequence[int], sort_points: bool = False,
                 fps_shards: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        num_layers = len(num_centroids)
        assert (len(radius) == len(num_neighbours) == len(sa_channels)
                == num_layers)
        assert len(fp_channels) == len(num_fp_neighbours) == num_layers
        self.sort_points = sort_points
        widths = [0] + [c[-1] for c in sa_channels]
        self.sa_modules = nn.ModuleList(
            PointNetSAModule(widths[i], sa_channels[i], num_centroids[i],
                             radius[i], num_neighbours[i],
                             fps_shards=fps_shards if sort_points else 1,
                             dtype=dtype)
            for i in range(num_layers))
        fp = []
        sparse_width = widths[-1]
        for i in range(num_layers):
            fp.append(PointnetFPModule(sparse_width + widths[-2 - i],
                                       fp_channels[i], num_fp_neighbours[i],
                                       dtype=dtype))
            sparse_width = fp_channels[i][-1]
        self.fp_modules = nn.ModuleList(fp)

    def backbone(self, xyz: torch.Tensor) -> torch.Tensor:
        """xyz (B, N, 3) channels-last -> per-point features (B, N, C)."""
        sorted_axis = None
        order = None
        if self.sort_points:
            # Deployment path (SORT_POINTS): each scene is sorted along its
            # widest axis so the SA1 ball query can prune to contiguous key
            # slabs; per-point outputs are restored to the caller's order.
            # The axis stays on the device (no host read).
            spread = torch.amax(xyz, dim=1) - torch.amin(xyz, dim=1)
            sorted_axis = torch.argmax(spread, dim=1)            # (B,)
            keys = torch.gather(xyz, 2, sorted_axis[:, None, None]
                                .expand(-1, xyz.shape[1], 1))[..., 0]
            order = torch.argsort(keys, dim=1, stable=True)
            xyz = gather_cl(xyz, order)

        inter_xyz = [xyz]
        inter_feature: list[Optional[torch.Tensor]] = [None]
        feature = None
        cur_xyz = xyz
        for sa in self.sa_modules:
            cur_xyz, feature = sa(cur_xyz, feature, sorted_axis=sorted_axis)
            inter_xyz.append(cur_xyz)
            inter_feature.append(feature)

        sparse_xyz, sparse_feature = cur_xyz, feature
        for i, fp in enumerate(self.fp_modules):
            dense_xyz = inter_xyz[-2 - i]
            sparse_feature = fp(dense_xyz, sparse_xyz, inter_feature[-2 - i],
                                sparse_feature)
            sparse_xyz = dense_xyz
        if order is not None:
            sparse_feature = gather_cl(sparse_feature,
                                       invert_permutation(order))
        return sparse_feature


def _head(mlp: SharedMLP, logit: nn.Conv1d, feature: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    """SharedMLP head + linear logit layer (the JAX `_Head`): the product
    comes out in the compute dtype and the bias is added in it, like flax
    `nn.Dense(dtype=...)`."""
    x = mlp(feature)
    w = logit.weight.reshape(logit.out_channels, -1)
    return torch.matmul(x.to(dtype), w.t().to(dtype)) + logit.bias.to(dtype)


class PointNet2CLS(PointNet2Backbone):
    """PN2_CLS — the deployed curvature model.  Heads: score logits over
    score bins, raw 9-D rotation, 4-class translation-offset logits, 5-way
    sigmoid movability."""

    def __init__(self, score_classes: int, seg_channels: Sequence[int],
                 num_removal_directions: int = 5,
                 dtype: torch.dtype = torch.float32, **backbone_kwargs):
        super().__init__(dtype=dtype, **backbone_kwargs)
        self.dtype = dtype
        width = backbone_kwargs["fp_channels"][-1][-1]
        seg_out = seg_channels[-1]
        for name in ("seg", "R", "t", "movable"):
            setattr(self, f"mlp_{name}",
                    SharedMLP(width, seg_channels, ndim=1, dtype=dtype))
        self.seg_logit = nn.Conv1d(seg_out, score_classes, 1)
        self.R_logit = nn.Conv1d(seg_out, 9, 1)
        self.t_logit = nn.Conv1d(seg_out, 4, 1)
        self.movable_logit = nn.Sequential(
            nn.Conv1d(seg_out, num_removal_directions, 1), nn.Sigmoid())

    @torch.no_grad()
    def forward(self, data_batch: dict) -> dict:
        points = data_batch["scene_points"]            # (B, 3, N)
        feature = self.backbone(points.transpose(1, 2))
        dt = self.dtype
        logits = _head(self.mlp_seg, self.seg_logit, feature, dt)
        r = _head(self.mlp_R, self.R_logit, feature, dt)
        t = _head(self.mlp_t, self.t_logit, feature, dt)
        # Sigmoid in the compute dtype, then f32 (as the JAX model).
        mov = torch.sigmoid(_head(self.mlp_movable, self.movable_logit[0],
                                  feature, dt))

        def to_cf(x):
            return x.transpose(1, 2).float()
        return {"score": to_cf(logits), "frame_R": to_cf(r),
                "frame_t": to_cf(t), "movable_logits": to_cf(mov)}

"""PointNet++ backbone and the two grasp-proposal models, eval mode (port
of s4g_tpu/models/pointnet2.py): PN2_CLS, the curvature model, and PN2,
the contact model with a regression translation.

Modules keep the reference torch names (`sa_modules.{i}.mlp.{j}.{conv,bn}`,
`fp_modules.{i}.mlp.{j}.*`, `mlp_{seg,R,t,movable}.{j}.*`,
`{seg,R,t}_logit.*`, `movable_logit.0.*`), so `state_dict()` is a reference
PN2_CLS or PN2 state dict (`utils/weights.py` converts the JAX package's
variables into it).  Predictions come out channels-first in f32, like the
JAX models'.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .functional import rot6d_to_mat9
from .nn_layers import SharedMLP
from .pn2_modules import PointnetFPModule, PointNetSAModule, gather_cl
from ..ops.neighbors import invert_permutation
from ..ops.sampling import fps_lane_nested, fps_nesting_applies


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
        self.fps_shards = fps_shards
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

        # A sorted forward whose SA stages all take 128-shard FPS nests
        # them: every stage's indices in one K1 launch.
        centroids = [sa.num_centroids for sa in self.sa_modules]
        fps_index = [None] * len(centroids)
        if self.sort_points and fps_nesting_applies(
                xyz.shape[1], centroids, self.fps_shards):
            fps_index = fps_lane_nested(xyz.transpose(1, 2).contiguous(),
                                        centroids)

        inter_xyz = [xyz]
        inter_feature: list[Optional[torch.Tensor]] = [None]
        feature = None
        cur_xyz = xyz
        for sa, index in zip(self.sa_modules, fps_index):
            cur_xyz, feature = sa(cur_xyz, feature, sorted_axis=sorted_axis,
                                  fps_index=index)
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


class _GraspHeads(PointNet2Backbone):
    """The backbone and the four heads both grasp models share: score
    logits, rotation (`rot_width` outputs), translation (`trans_width`)
    and 5-way sigmoid movability, built in the reference's order."""

    def __init__(self, score_classes: int, seg_channels: Sequence[int],
                 rot_width: int, trans_width: int,
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
        self.R_logit = nn.Conv1d(seg_out, rot_width, 1)
        self.t_logit = nn.Conv1d(seg_out, trans_width, 1)
        self.movable_logit = nn.Sequential(
            nn.Conv1d(seg_out, num_removal_directions, 1), nn.Sigmoid())

    def heads(self, points: torch.Tensor) -> tuple:
        """points (B, 3, N) -> the four heads' outputs, channels-first f32:
        score logits, rotation, translation, movability (the sigmoid taken
        in the compute dtype, then f32, as the JAX models do)."""
        feature = self.backbone(points.transpose(1, 2))
        dt = self.dtype
        out = (_head(self.mlp_seg, self.seg_logit, feature, dt),
               _head(self.mlp_R, self.R_logit, feature, dt),
               _head(self.mlp_t, self.t_logit, feature, dt),
               torch.sigmoid(_head(self.mlp_movable, self.movable_logit[0],
                                   feature, dt)))
        return tuple(x.transpose(1, 2).float() for x in out)


class PointNet2CLS(_GraspHeads):
    """PN2_CLS — the deployed curvature model.  Heads: score logits over
    score bins, raw 9-D rotation, 4-class translation-offset logits, 5-way
    sigmoid movability."""

    def __init__(self, score_classes: int, seg_channels: Sequence[int],
                 num_removal_directions: int = 5,
                 dtype: torch.dtype = torch.float32, **backbone_kwargs):
        super().__init__(score_classes, seg_channels, 9, 4,
                         num_removal_directions, dtype, **backbone_kwargs)

    @torch.no_grad()
    def forward(self, data_batch: dict) -> dict:
        logits, r, t, mov = self.heads(data_batch["scene_points"])
        return {"score": logits, "frame_R": r, "frame_t": t,
                "movable_logits": mov}


class PointNet2Reg(_GraspHeads):
    """PN2 — the contact model (port of `PointNet2Reg`,
    `pointnet2.py:213-267`).  Heads: score logits, a 6-D rotation turned
    into a 3x3 one in the net (`rot6d_to_mat9`), a translation residual
    added to each input point, whose logit layer starts at zero so a fresh
    model puts every grasp origin on its point, and 5-way sigmoid
    movability."""

    def __init__(self, score_classes: int, seg_channels: Sequence[int],
                 num_removal_directions: int = 5,
                 dtype: torch.dtype = torch.float32, **backbone_kwargs):
        super().__init__(score_classes, seg_channels, 6, 3,
                         num_removal_directions, dtype, **backbone_kwargs)
        nn.init.zeros_(self.t_logit.weight)
        nn.init.zeros_(self.t_logit.bias)

    @torch.no_grad()
    def forward(self, data_batch: dict) -> dict:
        points = data_batch["scene_points"]            # (B, 3, N)
        logits, r6, dt, mov = self.heads(points)
        return {"scene_score_logits": logits, "frame_R": rot6d_to_mat9(r6),
                "frame_t": points.float() + dt, "movable_logits": mov}

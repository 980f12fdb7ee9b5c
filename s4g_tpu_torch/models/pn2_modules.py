"""PointNet++ building blocks, eval mode (port of
s4g_tpu/models/pn2_modules.py).

Modules work on channels-last tensors — xyz (B, N, 3), features (B, N, C),
grouped features (B, M, K, C) — and call the channels-first ops through
thin transposes, as the JAX package does.  Only the max-pool SA stage with
a positive centroid count and the 3-NN FP stage are ported (what PN2_CLS on
curvature_model.yaml runs); the global / all-points stages, edge variants
and MSG stay in ROADMAP.md §1 item 8.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from .. import ops
from ..ops.interpolate import interpolation_weights
from ..ops.neighbors import _axis_keys
from ..ops.sampling import fps_sharding_applies
from .nn_layers import SharedMLP


def _cf(x: torch.Tensor) -> torch.Tensor:
    """channels-last (B, N, C) -> channels-first (B, C, N)."""
    return x.transpose(1, 2)


def gather_cl(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Gather rows: (B, N, C) x (B, M) -> (B, M, C)."""
    c = x.shape[2]
    return torch.gather(x, 1, index.long()[..., None].expand(-1, -1, c))


def group_cl(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Group rows: (B, N, C) x (B, M, K) -> (B, M, K, C)."""
    b, _, c = x.shape
    m, k = index.shape[1], index.shape[2]
    return gather_cl(x, index.reshape(b, m * k)).reshape(b, m, k, c)


class PointNetSAModule(nn.Module):
    """Set abstraction: FPS -> ball-query grouping -> SharedMLP -> max pool."""

    def __init__(self, in_features: int, mlp_channels: Sequence[int],
                 num_centroids: int, radius: float, num_neighbours: int,
                 fps_shards: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        if num_centroids <= 0:
            raise NotImplementedError(
                "global / all-points SA stages are not ported yet "
                "(ROADMAP.md §1 item 8)")
        self.num_centroids = num_centroids
        self.radius = radius
        self.num_neighbours = num_neighbours
        self.fps_shards = fps_shards
        # use_xyz: the grouped relative xyz leads the feature channels.
        self.mlp = SharedMLP(in_features + 3, mlp_channels, ndim=2,
                             dtype=dtype)

    def _fuses(self, batch: int, sorted_axis) -> bool:
        """The JAX package's `auto` rule for whole-stage fusion of an
        xyz-only stage (`pn2_modules.py:175-188`): batch >= 2, a sorted
        cloud, eval mode, max pool (the only pool ported), 3 layers whose
        widths are multiples of 128, and K a multiple of 8."""
        widths = [layer.conv.out_channels for layer in self.mlp]
        return (batch >= 2 and sorted_axis is not None and not self.training
                and len(widths) == 3 and all(c % 128 == 0 for c in widths)
                and self.num_neighbours % 8 == 0)

    def forward(self, xyz: torch.Tensor, feature: Optional[torch.Tensor],
                sorted_axis: Optional[torch.Tensor] = None,
                fps_index: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """`sorted_axis`: (B,) tensor promising that `xyz` is sorted
        ascending along that coordinate.  Then this stage keeps the
        sortedness invariant (its centroids come out sorted too), promises
        sorted centroids to the ball query and selects rank-stratified
        neighbours (`ops/neighbors.py`).  `fps_index`: this stage's
        centroid indices (B, M) into `xyz`, computed by the backbone for
        every stage at once (`ops.sampling.fps_lane_nested`), in place of
        this stage's FPS."""
        if fps_index is not None:
            index = fps_index
        else:
            sharded = (sorted_axis is not None and fps_sharding_applies(
                xyz.shape[1], self.num_centroids, self.fps_shards))
            index = ops.farthest_point_sample(
                _cf(xyz).contiguous(), self.num_centroids,
                num_shards=self.fps_shards if sharded else 1,
                sort_local=sharded)
            if sorted_axis is not None and not sharded:
                # Exact FPS emits centroids in pick order: re-sort them
                # along the sort axis (stable, as jnp.argsort).
                ckeys = torch.gather(_axis_keys(_cf(xyz), sorted_axis), 1,
                                     index.long())
                index = torch.gather(index, 1,
                                     torch.argsort(ckeys, dim=1, stable=True))
        new_xyz = gather_cl(xyz, index)

        csorted = sorted_axis is not None
        if feature is not None:
            nbr_index, _ = ops.ball_query(
                _cf(xyz), _cf(new_xyz), self.radius, self.num_neighbours,
                sorted_axis=sorted_axis, centroids_sorted=csorted,
                stratified=csorted)
            # One combined [xyz || feature] gather.
            both = group_cl(torch.cat([xyz, feature], dim=-1), nbr_index)
            group_xyz = both[..., :3] - new_xyz[:, :, None, :]
            group_feature = torch.cat([group_xyz, both[..., 3:]], dim=-1)
        elif self._fuses(xyz.shape[0], sorted_axis):
            # xyz-only stage at batch >= 2: the whole stage is one kernel
            # (K3), as in the JAX package.
            pts_cf, cent_cf = _cf(xyz).contiguous(), _cf(new_xyz).contiguous()
            new_feature = self.mlp.sa1_fused_eval(
                pts_cf, cent_cf, _axis_keys(pts_cf, sorted_axis),
                _axis_keys(cent_cf, sorted_axis), self.radius,
                self.num_neighbours, sorted_axis=sorted_axis)
            return new_xyz, new_feature
        else:
            # xyz-only stage, unfused (batch 1, or a stage K3 does not take).
            _, _, group_feature = ops.ball_query_grouped(
                _cf(xyz), _cf(new_xyz), self.radius, self.num_neighbours,
                sorted_axis=sorted_axis, centroids_sorted=csorted,
                stratified=csorted)
            group_feature = group_feature.to(xyz.dtype)
        new_feature = self.mlp(group_feature,
                               max_pool_k=group_feature.shape[2])
        return new_xyz, new_feature


class PointnetFPModule(nn.Module):
    """Feature propagation: 3-NN inverse-distance interpolation ->
    SharedMLP."""

    def __init__(self, in_features: int, mlp_channels: Sequence[int],
                 num_neighbors: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        if num_neighbors != 3:
            raise NotImplementedError(
                "only 3-NN feature propagation is ported "
                "(ROADMAP.md §1 item 8)")
        self.mlp = SharedMLP(in_features, mlp_channels, ndim=1, dtype=dtype)

    def forward(self, dense_xyz, sparse_xyz, dense_feature, sparse_feature):
        index, distance = ops.three_nn(_cf(dense_xyz), _cf(sparse_xyz))
        weight = interpolation_weights(distance)
        # Per-neighbour gather-then-fma, accumulated ((t0 + t1) + t2).
        interpolated = None
        for j in range(3):
            term = gather_cl(sparse_feature, index[:, :, j]) \
                * weight[:, :, j:j + 1]
            interpolated = term if interpolated is None \
                else interpolated + term
        if dense_feature is not None:
            new_feature = torch.cat([interpolated, dense_feature], dim=-1)
        else:
            new_feature = interpolated
        return self.mlp(new_feature)

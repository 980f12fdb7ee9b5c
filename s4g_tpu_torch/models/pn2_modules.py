"""PointNet++ building blocks (port of s4g_tpu/models/pn2_modules.py).

Modules work on channels-last tensors — xyz (B, N, 3), features (B, N, C),
grouped features (B, M, K, C) — and call the channels-first ops through
thin transposes, as the JAX package does.  The special cases are the JAX
package's (and the reference's):

* an SA stage with `num_centroids` 0 is global: one centroid at the
  origin whose group is every point, absolute xyz leading the features;
* `num_centroids` -1 makes every point a centroid;
* an `edge` SA stage appends neighbour-minus-centroid features;
* `pool="mean"` pools the neighbours with a mean (no config uses it, nor
  `PointNetSAModuleMSG`);
* an FP stage with `num_neighbors` 0 broadcasts the single global
  feature; `EdgeFPModule` runs its MLP over each of the 3 neighbours'
  interpolated and edge features and averages.

Parameter names follow the JAX modules (`mlp.{j}.conv.*`; the MSG stage's
scales `mlp.{i}.{j}.*`), with the PN2 layouts: an FP stage's MLP, the
edge one's too, is stored as 1x1 Conv1d weights.  For the edge and MSG
stages the reference's own torch names cannot be checked here.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from .. import ops
from ..ops.gather import gather_rows
from ..ops.interpolate import interpolation_weights
from ..ops.neighbors import _axis_keys
from ..ops.sampling import fps_sharding_applies
from . import nn_layers
from .nn_layers import SharedMLP


def _cf(x: torch.Tensor) -> torch.Tensor:
    """channels-last (B, N, C) -> channels-first (B, C, N)."""
    return x.transpose(1, 2)


def gather_cl(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Gather rows: (B, N, C) x (B, M) -> (B, M, C), with a fixed-order
    backward (`ops.gather.gather_rows`)."""
    return gather_rows(x, index)


def group_cl(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Group rows: (B, N, C) x (B, M, K) -> (B, M, K, C), with a
    fixed-order backward."""
    b, _, c = x.shape
    m, k = index.shape[1], index.shape[2]
    return gather_rows(x, index.reshape(b, m * k)).reshape(b, m, k, c)


def interpolate_cl(feature: torch.Tensor, index: torch.Tensor,
                   weight: torch.Tensor) -> torch.Tensor:
    """3-NN interpolation, channels-last: (B, N2, C) features, (B, N1, 3)
    indices and weights -> (B, N1, C), a per-neighbour gather-then-fma
    accumulated ((t0 + t1) + t2).  Each neighbour's gather has its own
    fixed-order backward and autograd adds the three, as JAX's transpose
    adds its three scatter-adds."""
    out = None
    for j in range(index.shape[-1]):
        term = gather_rows(feature, index[:, :, j]) * weight[:, :, j:j + 1]
        out = term if out is None else out + term
    return out


class PointNetSAModule(nn.Module):
    """Set abstraction: FPS -> ball-query grouping -> SharedMLP -> pool
    (max, or mean with `pool="mean"`).  `num_centroids` 0 is the global
    stage, -1 the all-points stage; `edge` appends neighbour-minus-centroid
    features where the stage has features (EdgeSAModule)."""

    def __init__(self, in_features: int, mlp_channels: Sequence[int],
                 num_centroids: int, radius: float, num_neighbours: int,
                 fps_shards: int = 1, dtype: torch.dtype = torch.float32,
                 edge: bool = False, pool: str = "max"):
        super().__init__()
        if num_centroids < -1:
            raise ValueError(f"num_centroids {num_centroids} < -1")
        if pool not in ("max", "mean"):
            raise ValueError(pool)
        self.num_centroids = num_centroids
        self.radius = radius
        self.num_neighbours = num_neighbours
        self.fps_shards = fps_shards
        self.edge = edge
        self.pool = pool
        # use_xyz: the grouped xyz leads the feature channels; an edge stage
        # with features (never the global one) doubles them.
        twice = edge and num_centroids != 0
        self.mlp = SharedMLP(3 + in_features * (2 if twice else 1),
                             mlp_channels, ndim=2, dtype=dtype)

    def _fuses(self, batch: int, sorted_axis) -> bool:
        """The JAX package's rule for whole-stage fusion of an xyz-only
        stage (`pn2_modules.py:170-188`): `nn_layers.SA1_FUSE` asks for it
        at this batch (`sa1_fuse_wanted`), a sorted cloud, eval mode, max
        pool, no edge features, 3 layers whose widths are multiples of 128,
        and K a multiple of 8."""
        widths = [layer.conv.out_channels for layer in self.mlp]
        return (nn_layers.sa1_fuse_wanted(batch) and sorted_axis is not None
                and not self.training and self.pool == "max"
                and not self.edge
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
        if self.num_centroids == 0:
            # Global stage: one centroid at the origin, the group is every
            # point with its absolute xyz.
            new_xyz = xyz.new_zeros((xyz.shape[0], 1, 3))
            return new_xyz, self._pool(torch.cat([xyz, feature],
                                                 dim=-1)[:, None])
        if self.num_centroids == -1:
            index = None
            new_xyz = xyz
        else:
            index = self._sample(xyz, sorted_axis, fps_index)
            new_xyz = gather_cl(xyz, index)

        csorted = sorted_axis is not None
        if feature is not None:
            nbr_index, _ = ops.ball_query(
                _cf(xyz), _cf(new_xyz), self.radius, self.num_neighbours,
                sorted_axis=sorted_axis, centroids_sorted=csorted,
                stratified=csorted)
            # One combined [xyz || feature] gather.
            both = group_cl(torch.cat([xyz, feature], dim=-1), nbr_index)
            gf = both[..., 3:]
            parts = [both[..., :3] - new_xyz[:, :, None, :], gf]
            if self.edge:
                centroid_feature = (feature if index is None
                                    else gather_cl(feature, index))
                parts.append(gf - centroid_feature[:, :, None, :])
            group_feature = torch.cat(parts, dim=-1)
        elif self._fuses(xyz.shape[0], sorted_axis):
            # xyz-only stage at batch >= 2 (or any batch under SA1_FUSE
            # "1"): the whole stage is one kernel (K3), as in the JAX
            # package.
            pts_cf, cent_cf = _cf(xyz).contiguous(), _cf(new_xyz).contiguous()
            new_feature = self.mlp.sa1_fused_eval(
                pts_cf, cent_cf, _axis_keys(pts_cf, sorted_axis),
                _axis_keys(cent_cf, sorted_axis), self.radius,
                self.num_neighbours, sorted_axis=sorted_axis)
            return new_xyz, new_feature
        else:
            # xyz-only stage, unfused (batch 1, SA1_FUSE "0", or a stage K3
            # does not take).
            _, _, group_feature = ops.ball_query_grouped(
                _cf(xyz), _cf(new_xyz), self.radius, self.num_neighbours,
                sorted_axis=sorted_axis, centroids_sorted=csorted,
                stratified=csorted)
            group_feature = group_feature.to(xyz.dtype)
        return new_xyz, self._pool(group_feature)

    def _sample(self, xyz, sorted_axis, fps_index) -> torch.Tensor:
        """This stage's centroid indices: `fps_index`, else its FPS (kept
        sorted along `sorted_axis` when there is one)."""
        if fps_index is not None:
            return fps_index
        sharded = (sorted_axis is not None and fps_sharding_applies(
            xyz.shape[1], self.num_centroids, self.fps_shards))
        index = ops.farthest_point_sample(
            _cf(xyz).contiguous(), self.num_centroids,
            num_shards=self.fps_shards if sharded else 1,
            sort_local=sharded)
        if sorted_axis is not None and not sharded:
            # Exact FPS emits centroids in pick order: re-sort them along
            # the sort axis (stable, as jnp.argsort).
            ckeys = torch.gather(_axis_keys(_cf(xyz), sorted_axis), 1,
                                 index.long())
            index = torch.gather(index, 1,
                                 torch.argsort(ckeys, dim=1, stable=True))
        return index

    def _pool(self, group_feature: torch.Tensor) -> torch.Tensor:
        """The MLP over (B, M, K, C) and the pool over K."""
        if self.pool == "max":
            return self.mlp(group_feature, max_pool_k=group_feature.shape[2])
        return torch.mean(self.mlp(group_feature), dim=2)


class PointNetSAModuleMSG(nn.Module):
    """Multi-scale-grouping set abstraction (port of JAX
    `PointNetSAModuleMSG`, `pn2_modules.py:223-260`): exact FPS (every
    point when `num_centroids` <= 0), then per scale a ball query, the
    grouped relative xyz and features, a SharedMLP and a max over the
    neighbours; the scales' features concatenated.  No config uses it."""

    def __init__(self, in_features: int,
                 mlp_channels_list: Sequence[Sequence[int]],
                 num_centroids: int, radius_list: Sequence[float],
                 num_neighbours_list: Sequence[int],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_centroids = num_centroids
        self.radius_list = tuple(radius_list)
        self.num_neighbours_list = tuple(num_neighbours_list)
        self.mlp = nn.ModuleList(
            SharedMLP(3 + in_features, channels, ndim=2, dtype=dtype)
            for channels in mlp_channels_list)

    def forward(self, xyz: torch.Tensor, feature: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.num_centroids > 0:
            index = ops.farthest_point_sample(_cf(xyz).contiguous(),
                                              self.num_centroids)
            new_xyz = gather_cl(xyz, index)
        else:
            new_xyz = xyz
        outs = []
        for mlp, radius, k in zip(self.mlp, self.radius_list,
                                  self.num_neighbours_list):
            nbr_index, _ = ops.ball_query(_cf(xyz), _cf(new_xyz), radius, k)
            group_feature = group_cl(xyz, nbr_index) - new_xyz[:, :, None, :]
            if feature is not None:
                group_feature = torch.cat(
                    [group_feature, group_cl(feature, nbr_index)], dim=-1)
            outs.append(mlp(group_feature, max_pool_k=k))
        return new_xyz, torch.cat(outs, dim=-1)


def _broadcast(dense_xyz, sparse_xyz, dense_feature, sparse_feature):
    """The 0-neighbour FP input: the single global feature beside every
    dense point's own, [global || dense]."""
    if sparse_xyz.shape[1] != 1:
        raise ValueError("a 0-neighbour FP stage takes one sparse point, "
                         f"got {sparse_xyz.shape[1]}")
    expanded = sparse_feature.expand(-1, dense_xyz.shape[1], -1)
    return torch.cat([expanded, dense_feature], dim=-1)


class PointnetFPModule(nn.Module):
    """Feature propagation: 3-NN inverse-distance interpolation ->
    SharedMLP; with `num_neighbors` 0 the global feature is broadcast."""

    def __init__(self, in_features: int, mlp_channels: Sequence[int],
                 num_neighbors: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        if num_neighbors not in (0, 3):
            raise ValueError(f"num_neighbors must be 0 or 3, got "
                             f"{num_neighbors}")
        self.num_neighbors = num_neighbors
        self.mlp = SharedMLP(in_features, mlp_channels, ndim=1, dtype=dtype)

    def forward(self, dense_xyz, sparse_xyz, dense_feature, sparse_feature):
        if self.num_neighbors == 0:
            return self.mlp(_broadcast(dense_xyz, sparse_xyz, dense_feature,
                                       sparse_feature))
        index, distance = ops.three_nn(_cf(dense_xyz), _cf(sparse_xyz))
        interpolated = interpolate_cl(sparse_feature, index,
                                      interpolation_weights(distance))
        if dense_feature is not None:
            new_feature = torch.cat([interpolated, dense_feature], dim=-1)
        else:
            new_feature = interpolated
        return self.mlp(new_feature)


class EdgeFPModule(nn.Module):
    """Edge feature propagation (port of JAX `EdgeFPModule`,
    `pn2_modules.py:306-341`): per each of the 3 nearest sparse points,
    [interpolated || gathered - interpolated || dense] through a SharedMLP
    over (B, N1, 3, C), then the mean over the 3; with `num_neighbors` 0
    the broadcast of `PointnetFPModule` (no mean).  The interpolation sums
    the materialized (B, N1, 3, C) weighted neighbours over their axis, as
    JAX does, so that its rounding follows JAX's."""

    def __init__(self, in_features: int, mlp_channels: Sequence[int],
                 num_neighbors: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        if num_neighbors not in (0, 3):
            raise ValueError(f"num_neighbors must be 0 or 3, got "
                             f"{num_neighbors}")
        self.num_neighbors = num_neighbors
        self.mlp = SharedMLP(in_features, mlp_channels, ndim=1, dtype=dtype)

    def forward(self, dense_xyz, sparse_xyz, dense_feature, sparse_feature):
        if self.num_neighbors == 0:
            return self.mlp(_broadcast(dense_xyz, sparse_xyz, dense_feature,
                                       sparse_feature))
        index, distance = ops.three_nn(_cf(dense_xyz), _cf(sparse_xyz))
        weight = interpolation_weights(distance)
        gathered = group_cl(sparse_feature, index)            # (B, N1, 3, C)
        interpolated = torch.sum(gathered * weight[..., None], dim=2)
        interp_k = interpolated[:, :, None, :].expand_as(gathered)
        parts = [interp_k, gathered - interp_k]
        if dense_feature is not None:
            parts.append(dense_feature[:, :, None, :].expand(
                -1, -1, 3, -1))
        return torch.mean(self.mlp(torch.cat(parts, dim=-1)), dim=2)

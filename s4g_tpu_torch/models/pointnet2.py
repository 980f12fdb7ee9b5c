"""PointNet++ backbone, the grasp-proposal models and their losses and
metrics (port of s4g_tpu/models/pointnet2.py): PN2_CLS, the curvature
model; PN2, the contact model with a regression translation, which with
`edge_sa` (and `edge_fp`) is also EDGEPN2D (EDGEPN2DU); and PN2_LOCAL,
which grades SE(3) frames with an eval MLP.

In training mode (`.train()`) the forwards build autograd graphs, with
batch statistics and dropout (masks drawn from the caller's `generator`):
the score and movability heads' in PN2_CLS and PN2, the eval MLP's whole
channels in PN2_LOCAL.  In eval mode they build none, whatever the grad
mode, as serving and validation need none (the detector also runs them
under `torch.no_grad()`).

Modules keep the reference torch names (`sa_modules.{i}.mlp.{j}.{conv,bn}`,
`fp_modules.{i}.mlp.{j}.*`, `mlp_{seg,R,t,movable}.{j}.*`,
`{seg,R,t}_logit.*`, `movable_logit.0.*`), so `state_dict()` is a reference
PN2_CLS or PN2 state dict (`utils/weights.py` converts the JAX package's
variables into it).  PN2_LOCAL's eval MLP and logit are
`mlp_grasp_eval.{j}.*` and `grasp_eval_logit.*`, and its movability logit,
which has no sigmoid, `movable_logit.*`: these follow the JAX modules, as
the reference's own names cannot be checked here.  Predictions come out
channels-first in f32, like the JAX models'.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from . import functional as F
from .functional import rot6d_to_mat9
from .nn_layers import SharedMLP
from .pn2_modules import EdgeFPModule, PointnetFPModule, PointNetSAModule
from ..ops.neighbors import flat_gather_rows, invert_permutation
from ..ops.sampling import fps_lane_nested, fps_nesting_applies
from ..parallel.mesh import batch_mean


class PointNet2Backbone(nn.Module):
    """SA pyramid + FP pyramid producing per-point features (B, N, C)."""

    def __init__(self, num_centroids: Sequence[int], radius: Sequence[float],
                 num_neighbours: Sequence[int],
                 sa_channels: Sequence[Sequence[int]],
                 fp_channels: Sequence[Sequence[int]],
                 num_fp_neighbours: Sequence[int], sort_points: bool = False,
                 fps_shards: int = 1, dtype: torch.dtype = torch.float32,
                 edge_sa: bool = False, edge_fp: bool = False):
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
                             dtype=dtype, edge=edge_sa)
            for i in range(num_layers))
        fp = []
        sparse_width = widths[-1]
        for i in range(num_layers):
            # An edge FP stage over 3 neighbours takes [interpolated ||
            # edge || dense].
            twice = edge_fp and num_fp_neighbours[i] == 3
            fp.append((EdgeFPModule if edge_fp else PointnetFPModule)(
                sparse_width * (2 if twice else 1) + widths[-2 - i],
                fp_channels[i], num_fp_neighbours[i], dtype=dtype))
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
            # The sort and the restore below are permutations: each row is
            # written once by torch.gather's backward, with no collision to
            # order, so they keep torch.gather (no K8 launch).
            xyz = flat_gather_rows(xyz, order)

        # A sorted forward whose SA stages all take 128-shard FPS nests
        # them: every stage's indices in one K1 launch.  A pyramid with a
        # global (0) or all-points (-1) stage never nests.
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
            sparse_feature = flat_gather_rows(sparse_feature,
                                              invert_permutation(order))
        return sparse_feature


def _head(mlp: SharedMLP, logit: nn.Conv1d, feature: torch.Tensor,
          dtype: torch.dtype,
          generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """SharedMLP head + linear logit layer (the JAX `_Head`): the product
    comes out in the compute dtype and the bias is added in it, like flax
    `nn.Dense(dtype=...)`."""
    x = mlp(feature, generator=generator)
    w = logit.weight.reshape(logit.out_channels, -1)
    return torch.matmul(x.to(dtype), w.t().to(dtype)) + logit.bias.to(dtype)


class _GraspHeads(PointNet2Backbone):
    """The backbone and the four heads both grasp models share: score
    logits, rotation (`rot_width` outputs), translation (`trans_width`)
    and 5-way sigmoid movability, built in the reference's order.  The
    score and movability heads drop out with `dropout_prob` in training
    (JAX `pointnet2.py:192-201, 247-256`); rotation and translation do
    not."""

    def __init__(self, score_classes: int, seg_channels: Sequence[int],
                 rot_width: int, trans_width: int,
                 num_removal_directions: int = 5,
                 dtype: torch.dtype = torch.float32,
                 dropout_prob: float = 0.0, **backbone_kwargs):
        super().__init__(dtype=dtype, **backbone_kwargs)
        self.dtype = dtype
        width = backbone_kwargs["fp_channels"][-1][-1]
        seg_out = seg_channels[-1]
        for name in ("seg", "R", "t", "movable"):
            p = dropout_prob if name in ("seg", "movable") else 0.0
            setattr(self, f"mlp_{name}",
                    SharedMLP(width, seg_channels, ndim=1, dtype=dtype,
                              dropout_prob=p))
        self.seg_logit = nn.Conv1d(seg_out, score_classes, 1)
        self.R_logit = nn.Conv1d(seg_out, rot_width, 1)
        self.t_logit = nn.Conv1d(seg_out, trans_width, 1)
        self.movable_logit = nn.Sequential(
            nn.Conv1d(seg_out, num_removal_directions, 1), nn.Sigmoid())

    def heads(self, points: torch.Tensor,
              generator: Optional[torch.Generator] = None) -> tuple:
        """points (B, 3, N) -> the four heads' outputs, channels-first f32:
        score logits, rotation, translation, movability (the sigmoid taken
        in the compute dtype, then f32, as the JAX models do).
        `generator`: the dropout masks' draws, in training mode."""
        with torch.set_grad_enabled(self.training
                                    and torch.is_grad_enabled()):
            feature = self.backbone(points.transpose(1, 2))
            dt, g = self.dtype, generator
            out = (_head(self.mlp_seg, self.seg_logit, feature, dt, g),
                   _head(self.mlp_R, self.R_logit, feature, dt),
                   _head(self.mlp_t, self.t_logit, feature, dt),
                   torch.sigmoid(_head(self.mlp_movable,
                                       self.movable_logit[0], feature, dt,
                                       g)))
            return tuple(x.transpose(1, 2).float() for x in out)


class PointNet2CLS(_GraspHeads):
    """PN2_CLS — the deployed curvature model.  Heads: score logits over
    score bins, raw 9-D rotation, 4-class translation-offset logits, 5-way
    sigmoid movability."""

    def __init__(self, score_classes: int, seg_channels: Sequence[int],
                 num_removal_directions: int = 5,
                 dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(score_classes, seg_channels, 9, 4,
                         num_removal_directions, dtype, **kwargs)

    def forward(self, data_batch: dict,
                generator: Optional[torch.Generator] = None) -> dict:
        logits, r, t, mov = self.heads(data_batch["scene_points"], generator)
        return {"score": logits, "frame_R": r, "frame_t": t,
                "movable_logits": mov}


class PointNet2Reg(_GraspHeads):
    """PN2 — the contact model (port of `PointNet2Reg`,
    `pointnet2.py:213-267`).  Heads: score logits, a 6-D rotation turned
    into a 3x3 one in the net (`rot6d_to_mat9`), a translation residual
    added to each input point, whose logit layer starts at zero so a fresh
    model puts every grasp origin on its point, and 5-way sigmoid
    movability.  With `edge_sa=True` it is EDGEPN2D, with `edge_fp=True`
    too EDGEPN2DU (a working model here, as in the JAX package, where the
    reference's is not runnable)."""

    def __init__(self, score_classes: int, seg_channels: Sequence[int],
                 num_removal_directions: int = 5,
                 dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(score_classes, seg_channels, 6, 3,
                         num_removal_directions, dtype, **kwargs)
        nn.init.zeros_(self.t_logit.weight)
        nn.init.zeros_(self.t_logit.bias)

    def forward(self, data_batch: dict,
                generator: Optional[torch.Generator] = None) -> dict:
        points = data_batch["scene_points"]            # (B, 3, N)
        logits, r6, dt, mov = self.heads(points, generator)
        return {"scene_score_logits": logits, "frame_R": rot6d_to_mat9(r6),
                "frame_t": points.float() + dt, "movable_logits": mov}


# -----------------------------------------------------------------------------
# Losses and metrics (port of `pointnet2.py:353-416, 455-502`): pure
# functions (preds, labels) -> dict with the reference's loss weights.  The
# R / t terms take the first nf = best_frame_R.shape[2] points.  Within
# `parallel.global_batch` each loss term is this rank's share of the global
# batch's (`batch_mean`, `functional.weighted_cross_entropy`); the metrics
# stay local means, which the Trainer averages over the ranks.
# -----------------------------------------------------------------------------

def _symmetric_r_loss(pred_r: torch.Tensor, gt_r: torch.Tensor,
                      gt_score: torch.Tensor) -> torch.Tensor:
    """Min-over-flip rotation MSE, score-weighted, x5."""
    loss_1 = torch.mean((pred_r - gt_r) ** 2, dim=1)
    loss_2 = torch.mean((pred_r - F.flip_mat9_gripper(gt_r)) ** 2, dim=1)
    return batch_mean(torch.minimum(loss_1, loss_2) * gt_score) * 5.0


def _score_cls_loss(logits: torch.Tensor, labels: torch.Tensor,
                    neg_weight: float, label_smoothing: float
                    ) -> torch.Tensor:
    """Per-point score-bin cross entropy with class 0 weighted
    `neg_weight`."""
    score_classes = logits.shape[1]
    # Made on the device: writing neg_weight into a tensor there would
    # copy it from the host and wait.
    weight = torch.where(torch.arange(score_classes, device=logits.device)
                         == 0, neg_weight, 1.0)
    if label_smoothing > 0:
        flat = logits.transpose(1, 2).reshape(-1, score_classes)
        return F.smooth_cross_entropy(flat, labels.reshape(-1),
                                      label_smoothing, weight=weight)
    return F.weighted_cross_entropy(logits, labels, weight)


def _shared_losses(score_logits: torch.Tensor, preds: dict, labels: dict,
                   neg_weight: float, label_smoothing: float) -> tuple:
    """The terms both models share: the score loss, the movability L1 and
    the symmetric R loss; and nf with the first nf points' gt scores."""
    cls_loss = _score_cls_loss(score_logits, labels["scene_score_labels"],
                               neg_weight, label_smoothing)
    mov_loss = batch_mean(torch.abs(preds["movable_logits"]
                                    - labels["scene_movable_labels"]))
    gt_r = labels["best_frame_R"]
    nf = gt_r.shape[2]
    gt_score = labels["scene_score"][:, :nf]
    r_loss = _symmetric_r_loss(preds["frame_R"][:, :, :nf], gt_r, gt_score)
    return cls_loss, mov_loss, r_loss, nf, gt_score


def pointnet2_loss(preds: dict, labels: dict, label_smoothing: float = 0.0,
                   neg_weight: float = 0.1) -> dict:
    """PN2 (regression translation) loss dict."""
    cls_loss, mov_loss, r_loss, nf, gt_score = _shared_losses(
        preds["scene_score_logits"], preds, labels, neg_weight,
        label_smoothing)
    pred_t = preds["frame_t"][:, :, :nf]
    t_loss = batch_mean(torch.sum((pred_t - labels["best_frame_t"]) ** 2,
                                  dim=1) * gt_score) * 20.0
    return {"cls_loss": cls_loss, "R_loss": r_loss, "t_loss": t_loss,
            "mov_loss": mov_loss}


def pointnet2_cls_loss(preds: dict, labels: dict,
                       label_smoothing: float = 0.0,
                       neg_weight: float = 0.1) -> dict:
    """PN2_CLS loss dict: the same R term, and cross entropy over the 4
    translation bins x0.2 (`best_frame_t` holds integer classes)."""
    cls_loss, mov_loss, r_loss, nf, _ = _shared_losses(
        preds["score"], preds, labels, neg_weight, label_smoothing)
    t_loss = F.cross_entropy(preds["frame_t"][:, :, :nf],
                             labels["best_frame_t"]) * 0.2
    return {"cls_loss": cls_loss, "R_loss": r_loss, "t_loss": t_loss,
            "mov_loss": mov_loss}


def _r_metric(preds: dict, labels: dict,
              score_weighted: bool) -> torch.Tensor:
    """Symmetry-aware geodesic rotation error."""
    gt_r = labels["best_frame_R"]
    b, _, nf = gt_r.shape
    gt = gt_r.transpose(1, 2).reshape(b * nf, 3, 3)
    pred = preds["frame_R"][:, :, :nf].transpose(1, 2).reshape(b * nf, 3, 3)
    gt_flip = torch.cat([gt[:, :, :1], -gt[:, :, 1:]], dim=2)
    angle = torch.minimum(F.geodesic_angle(gt, pred),
                          F.geodesic_angle(gt_flip, pred))
    if score_weighted:
        return torch.mean(labels["scene_score"][:, :nf].reshape(-1) * angle)
    return torch.mean(angle)


def _accuracies(score_logits: torch.Tensor, preds: dict,
                labels: dict) -> tuple:
    """Per-point score-class and movability accuracies (f32 0 / 1)."""
    cls_acc = (torch.argmax(score_logits, dim=1).reshape(-1)
               == labels["scene_score_labels"].reshape(-1)).float()
    mov_acc = ((preds["movable_logits"] > 0.5).reshape(-1).to(torch.int32)
               == labels["scene_movable_labels"].reshape(-1).to(torch.int32)
               ).float()
    return cls_acc, mov_acc


def pointnet2_metric(preds: dict, labels: dict) -> dict:
    """PN2 metrics: accuracies, rotation error, translation error."""
    score_key = ("scene_score_logits" if "scene_score_logits" in preds
                 else "score")
    cls_acc, mov_acc = _accuracies(preds[score_key], preds, labels)
    nf = labels["best_frame_R"].shape[2]
    t_err = torch.mean(torch.sqrt(torch.sum(
        (labels["best_frame_t"] - preds["frame_t"][:, :, :nf]) ** 2, dim=1)))
    return {"cls_acc": cls_acc, "mov_acc": mov_acc,
            "R_err": _r_metric(preds, labels, score_weighted=True),
            "t_err": t_err}


def pointnet2_cls_metric(preds: dict, labels: dict) -> dict:
    """PN2_CLS metrics: accuracies, rotation error, translation-bin
    accuracy."""
    cls_acc, mov_acc = _accuracies(preds["score"], preds, labels)
    nf = labels["best_frame_R"].shape[2]
    t_pred = torch.argmax(preds["frame_t"][:, :, :nf], dim=1).reshape(-1)
    t_acc = (t_pred == labels["best_frame_t"].reshape(-1)).float()
    return {"cls_acc": cls_acc, "mov_acc": mov_acc,
            "R_err": _r_metric(preds, labels, score_weighted=True),
            "t_acc": t_acc}


class PointNet2Local(PointNet2Backbone):
    """PN2_LOCAL — the grasp-evaluation model (port of `PointNet2Local`,
    `pointnet2.py:270-346`).  Heads over the backbone's features: a raw
    9-D rotation, a translation residual (zero-initialized logit, added to
    each point) and 2-way movability logits; then an eval MLP (whole
    channels dropped in training) and a logit layer grade a 12-D pose,
    repeated 4 times, beside each point's features.  Two modes:

    * candidates: `data_batch["local_search_frame"]` (B, 12, V, S) holds S
      frames for each of the first V points (rows 0-8 the rotation, 9-11
      the translation, made relative to the point), graded into
      "local_search_logits" (B, C, V, S);
    * deployment: the model grades its own rotation and residual at every
      point, (B, C, N, 1).

    The eval MLP's input concatenates the f32 features with the
    compute-dtype pose, promoted to f32 as JAX promotes it."""

    def __init__(self, score_classes: int, seg_channels: Sequence[int],
                 dtype: torch.dtype = torch.float32,
                 dropout_prob: float = 0.0, **backbone_kwargs):
        super().__init__(dtype=dtype, **backbone_kwargs)
        self.dtype = dtype
        width = backbone_kwargs["fp_channels"][-1][-1]
        seg_out = seg_channels[-1]
        for name, out in (("R", 9), ("t", 3), ("movable", 2)):
            setattr(self, f"mlp_{name}",
                    SharedMLP(width, seg_channels, ndim=1, dtype=dtype))
            setattr(self, f"{name}_logit", nn.Conv1d(seg_out, out, 1))
        nn.init.zeros_(self.t_logit.weight)
        nn.init.zeros_(self.t_logit.bias)
        self.mlp_grasp_eval = SharedMLP(
            width + 48, seg_channels, ndim=2, dtype=dtype,
            dropout_prob=dropout_prob, channel_dropout=True)
        self.grasp_eval_logit = nn.Conv2d(seg_out, score_classes, 1)

    def forward(self, data_batch: dict,
                generator: Optional[torch.Generator] = None) -> dict:
        points = data_batch["scene_points"]            # (B, 3, N)
        with torch.set_grad_enabled(self.training
                                    and torch.is_grad_enabled()):
            feature = self.backbone(points.transpose(1, 2))
            dt = self.dtype
            r = _head(self.mlp_R, self.R_logit, feature, dt)      # (B, N, 9)
            d = _head(self.mlp_t, self.t_logit, feature, dt)      # (B, N, 3)
            mov = _head(self.mlp_movable, self.movable_logit, feature, dt)
            if "local_search_frame" in data_batch:
                lsf = data_batch["local_search_frame"]       # (B, 12, V, S)
                v, s = lsf.shape[2], lsf.shape[3]
                rel_t = lsf[:, 9:] - points[:, :, :v, None]
                pose = torch.cat([lsf[:, :9], rel_t], dim=1) \
                    .permute(0, 2, 3, 1)                     # (B, V, S, 12)
                x = torch.cat([feature[:, :v, None, :].expand(-1, -1, s, -1),
                               pose.repeat(1, 1, 1, 4)], dim=-1)
            else:
                pose = torch.cat([r, d], dim=-1).repeat(1, 1, 4)
                x = torch.cat([feature, pose], dim=-1)[:, :, None, :]
            logits = _head(self.mlp_grasp_eval, self.grasp_eval_logit, x,
                           dt, generator)                    # (B, V, S, C)
            to_cf = lambda y: y.transpose(1, 2).float()      # noqa: E731
            return {"local_search_logits": logits.permute(0, 3, 1, 2)
                    .float(),
                    "frame_R": to_cf(r),
                    "frame_t": points.float() + to_cf(d),
                    "movable_logits": to_cf(mov)}


def pointnet2_local_loss(preds: dict, labels: dict,
                         label_smoothing: float = 0.0,
                         neg_weight: float = 0.1) -> dict:
    """PN2_LOCAL loss dict: the candidates' score-class cross entropy (class
    0 weighted `neg_weight`), the 2-way movability cross entropy (class 0
    weighted 0.4), the symmetric R MSE x4 and the translation MSE x20 over
    the first nf points."""
    logits = preds["local_search_logits"]              # (B, C, V, S)
    classes = logits.shape[1]
    weight = torch.where(torch.arange(classes, device=logits.device) == 0,
                         neg_weight, 1.0)
    mov_logits = preds["movable_logits"]
    mov_weight = torch.where(torch.arange(2, device=logits.device) == 0,
                             0.4, 1.0)
    grasp_labels = labels["scored_grasp_labels"]
    mov_labels = labels["scene_movable_labels"]
    if label_smoothing > 0:
        cls_loss = F.smooth_cross_entropy(
            logits.permute(0, 2, 3, 1).reshape(-1, classes),
            grasp_labels.reshape(-1), label_smoothing, weight=weight)
        mov_loss = F.smooth_cross_entropy(
            mov_logits.transpose(1, 2).reshape(-1, 2),
            mov_labels.reshape(-1), label_smoothing, weight=mov_weight)
    else:
        cls_loss = F.weighted_cross_entropy(logits, grasp_labels, weight)
        mov_loss = F.weighted_cross_entropy(mov_logits, mov_labels,
                                            mov_weight)
    gt_r = labels["best_frame_R"]
    nf = gt_r.shape[2]
    pred_r = preds["frame_R"][:, :, :nf]
    loss_1 = torch.mean((pred_r - gt_r) ** 2, dim=1)
    loss_2 = torch.mean((pred_r - F.flip_mat9_gripper(gt_r)) ** 2, dim=1)
    r_loss = batch_mean(torch.minimum(loss_1, loss_2)) * 4.0
    t_loss = batch_mean((preds["frame_t"][:, :, :nf]
                         - labels["best_frame_t"]) ** 2) * 20.0
    return {"cls_loss": cls_loss, "R_loss": r_loss, "t_loss": t_loss,
            "mov_loss": mov_loss}


def pointnet2_local_metric(preds: dict, labels: dict) -> dict:
    """PN2_LOCAL metrics: the candidates' class and the movability class
    accuracies, the unweighted rotation error and the translation error."""
    cls_acc = (torch.argmax(preds["local_search_logits"], dim=1).reshape(-1)
               == labels["scored_grasp_labels"].reshape(-1)).float()
    mov_acc = (torch.argmax(preds["movable_logits"], dim=1).reshape(-1)
               == labels["scene_movable_labels"].reshape(-1)).float()
    nf = labels["best_frame_R"].shape[2]
    t_err = torch.mean(torch.sqrt(torch.sum(
        (labels["best_frame_t"] - preds["frame_t"][:, :, :nf]) ** 2, dim=1)))
    return {"cls_acc": cls_acc, "mov_acc": mov_acc,
            "R_err": _r_metric(preds, labels, score_weighted=False),
            "t_err": t_err}

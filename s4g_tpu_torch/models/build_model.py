"""Model factory (port of s4g_tpu/models/build_model.py): cfg -> torch
module, and cfg -> the model's loss and metric functions with the config's
hyperparameters bound in.  MODEL.TYPE selects among the JAX package's
seven: GPD, PointNetGPD, PN2 (the contact model), PN2_CLS (the curvature
model), PN2_LOCAL, EDGEPN2D and EDGEPN2DU.  The PN2 family reads its
section: MODEL.EDGEPN2D / EDGEPN2DU for the edge models, MODEL.PN2 for
the rest."""

from __future__ import annotations

import functools

import torch

from ..configs.config import Config
from .gpd import GPDClassifier, gpd_loss, gpd_metric
from .pointnet2 import (PointNet2CLS, PointNet2Local, PointNet2Reg,
                        pointnet2_cls_loss, pointnet2_cls_metric,
                        pointnet2_local_loss, pointnet2_local_metric,
                        pointnet2_loss, pointnet2_metric)
from .pointnet_gpd import (PointNetGPDClassifier, pointnet_gpd_loss,
                           pointnet_gpd_metric)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# PN2-family types: (net, its extra keyword arguments, loss, metric).
_PN2_FAMILY = {
    "PN2_CLS": (PointNet2CLS, {}, pointnet2_cls_loss, pointnet2_cls_metric),
    "PN2": (PointNet2Reg, {}, pointnet2_loss, pointnet2_metric),
    "PN2_LOCAL": (PointNet2Local, {}, pointnet2_local_loss,
                  pointnet2_local_metric),
    "EDGEPN2D": (PointNet2Reg, {"edge_sa": True}, pointnet2_loss,
                 pointnet2_metric),
    "EDGEPN2DU": (PointNet2Reg, {"edge_sa": True, "edge_fp": True},
                  pointnet2_loss, pointnet2_metric),
}
_BASELINES = {"GPD": (gpd_loss, gpd_metric),
              "PointNetGPD": (pointnet_gpd_loss, pointnet_gpd_metric)}


def compute_dtype(cfg: Config) -> torch.dtype:
    return _DTYPES[cfg.MODEL.COMPUTE_DTYPE]


def _check(model_type: str) -> None:
    if model_type not in _PN2_FAMILY and model_type not in _BASELINES:
        raise ValueError(f"Unknown model: {model_type!r}")


def _section(cfg: Config):
    """The PN2-family config section of cfg.MODEL.TYPE."""
    model_type = cfg.MODEL.TYPE
    return getattr(cfg.MODEL, model_type if model_type.startswith("EDGE")
                   else "PN2")


def build_model(cfg: Config) -> torch.nn.Module:
    """Returns the network for cfg.MODEL.TYPE in eval mode, as the detector
    runs it; a trainer calls `.train()` on it."""
    model_type = cfg.MODEL.TYPE
    _check(model_type)
    dtype = compute_dtype(cfg)
    if model_type == "GPD":
        return GPDClassifier(cfg.DATA.SCORE_CLASSES,
                             in_channels=cfg.DATA.GPD_IN_CHANNELS,
                             dropout=cfg.MODEL.GPD.DROPOUT,
                             dtype=dtype).eval()
    if model_type == "PointNetGPD":
        return PointNetGPDClassifier(cfg.DATA.SCORE_CLASSES,
                                     dtype=dtype).eval()
    net_cls, extra, _, _ = _PN2_FAMILY[model_type]
    if net_cls is not PointNet2Local:
        extra = {**extra,
                 "num_removal_directions": cfg.DATA.NUM_REMOVAL_DIRECTIONS}
    pn2 = _section(cfg)
    net = net_cls(
        score_classes=cfg.DATA.SCORE_CLASSES,
        seg_channels=pn2.SEG_CHANNELS,
        dtype=dtype,
        dropout_prob=pn2.DROPOUT_PROB,
        num_centroids=pn2.NUM_CENTROIDS,
        radius=pn2.RADIUS,
        num_neighbours=pn2.NUM_NEIGHBOURS,
        sa_channels=pn2.SA_CHANNELS,
        fp_channels=pn2.FP_CHANNELS,
        num_fp_neighbours=pn2.NUM_FP_NEIGHBOURS,
        sort_points=pn2.SORT_POINTS,
        fps_shards=pn2.FPS_SHARDS,
        **extra,
    )
    return net.eval()


def build_loss_and_metric(cfg: Config) -> tuple:
    """(loss_fn, metric_fn) for cfg.MODEL.TYPE: pure (preds, labels) -> dict
    functions, a PN2-family loss with its section's LABEL_SMOOTHING and
    NEG_WEIGHT bound (the JAX package's `build_model` triple without the
    net)."""
    model_type = cfg.MODEL.TYPE
    _check(model_type)
    if model_type in _BASELINES:
        return _BASELINES[model_type]
    _, _, loss, metric = _PN2_FAMILY[model_type]
    pn2 = _section(cfg)
    return (functools.partial(loss, label_smoothing=pn2.LABEL_SMOOTHING,
                              neg_weight=pn2.NEG_WEIGHT), metric)

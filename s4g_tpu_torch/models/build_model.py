"""Model factory (port of s4g_tpu/models/build_model.py): cfg -> torch
module, and cfg -> the model's loss and metric functions with the config's
hyperparameters bound in.  PN2_CLS (the curvature model) and PN2 (the
contact model) are ported; the other model types come later
(ROADMAP.md §1)."""

from __future__ import annotations

import functools

import torch

from ..configs.config import Config
from .pointnet2 import (PointNet2CLS, PointNet2Reg, pointnet2_cls_loss,
                        pointnet2_cls_metric, pointnet2_loss,
                        pointnet2_metric)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_MODELS = {"PN2_CLS": (PointNet2CLS, pointnet2_cls_loss,
                       pointnet2_cls_metric),
           "PN2": (PointNet2Reg, pointnet2_loss, pointnet2_metric)}


def compute_dtype(cfg: Config) -> torch.dtype:
    return _DTYPES[cfg.MODEL.COMPUTE_DTYPE]


def _entry(cfg: Config) -> tuple:
    if cfg.MODEL.TYPE not in _MODELS:
        raise NotImplementedError(
            f"model type {cfg.MODEL.TYPE!r} is not ported yet "
            f"(ROADMAP.md §1 item 5); the port runs {tuple(_MODELS)}")
    return _MODELS[cfg.MODEL.TYPE]


def build_model(cfg: Config) -> torch.nn.Module:
    """Returns the network for cfg.MODEL.TYPE ("PN2_CLS" or "PN2") in eval
    mode, as the detector runs it; a trainer calls `.train()` on it."""
    pn2 = cfg.MODEL.PN2
    net = _entry(cfg)[0](
        score_classes=cfg.DATA.SCORE_CLASSES,
        seg_channels=pn2.SEG_CHANNELS,
        num_removal_directions=cfg.DATA.NUM_REMOVAL_DIRECTIONS,
        dtype=compute_dtype(cfg),
        dropout_prob=pn2.DROPOUT_PROB,
        num_centroids=pn2.NUM_CENTROIDS,
        radius=pn2.RADIUS,
        num_neighbours=pn2.NUM_NEIGHBOURS,
        sa_channels=pn2.SA_CHANNELS,
        fp_channels=pn2.FP_CHANNELS,
        num_fp_neighbours=pn2.NUM_FP_NEIGHBOURS,
        sort_points=pn2.SORT_POINTS,
        fps_shards=pn2.FPS_SHARDS,
    )
    return net.eval()


def build_loss_and_metric(cfg: Config) -> tuple:
    """(loss_fn, metric_fn) for cfg.MODEL.TYPE: pure (preds, labels) -> dict
    functions, the loss with MODEL.PN2.LABEL_SMOOTHING and NEG_WEIGHT
    bound (the JAX package's `build_model` triple without the net)."""
    _, loss, metric = _entry(cfg)
    pn2 = cfg.MODEL.PN2
    return (functools.partial(loss, label_smoothing=pn2.LABEL_SMOOTHING,
                              neg_weight=pn2.NEG_WEIGHT), metric)

"""Model factory: cfg -> torch module (port of
s4g_tpu/models/build_model.py).  PN2_CLS (the curvature model) and PN2 (the
contact model) are ported; the other model types, and the losses and
metrics, come later (ROADMAP.md §1)."""

from __future__ import annotations

import torch

from ..configs.config import Config
from .pointnet2 import PointNet2CLS, PointNet2Reg

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_MODELS = {"PN2_CLS": PointNet2CLS, "PN2": PointNet2Reg}


def compute_dtype(cfg: Config) -> torch.dtype:
    return _DTYPES[cfg.MODEL.COMPUTE_DTYPE]


def build_model(cfg: Config) -> torch.nn.Module:
    """Returns the eval-mode network for cfg.MODEL.TYPE ("PN2_CLS" or
    "PN2")."""
    if cfg.MODEL.TYPE not in _MODELS:
        raise NotImplementedError(
            f"model type {cfg.MODEL.TYPE!r} is not ported yet "
            f"(ROADMAP.md §1 item 5); the port runs {tuple(_MODELS)}")
    pn2 = cfg.MODEL.PN2
    net = _MODELS[cfg.MODEL.TYPE](
        score_classes=cfg.DATA.SCORE_CLASSES,
        seg_channels=pn2.SEG_CHANNELS,
        num_removal_directions=cfg.DATA.NUM_REMOVAL_DIRECTIONS,
        dtype=compute_dtype(cfg),
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

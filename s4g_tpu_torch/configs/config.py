"""Config tree for s4g_tpu_torch (a copy of s4g_tpu/configs/config.py: the
port reads no module of the JAX package).

A frozen-dataclass re-design of the reference's yacs CfgNode tree
(reference: inference/grasp_proposal/configs/yacs_config.py:4-172).  Defaults
match the reference's defaults exactly; YAML files with the same section
layout (DATA / MODEL / SOLVER / SCHEDULER / TRAIN / TEST) merge on top.

Unlike yacs, tuples-in-strings ("(0.02, 0.08, 0.32)") are parsed eagerly and
the result is immutable after construction, so a Config can be shared freely.
"""

from __future__ import annotations

import ast
import dataclasses
from dataclasses import dataclass, field, fields, replace
from typing import Any, Mapping, Optional, Tuple

import yaml


def _tup(x):
    """Parse yacs-style tuple literals: already-a-sequence or "(a, b, c)"
    strings.  Non-literal strings (e.g. augmentation method names) pass
    through unchanged."""
    if isinstance(x, str):
        try:
            x = ast.literal_eval(x)
        except (ValueError, SyntaxError):
            return x
    if isinstance(x, (list, tuple)):
        return tuple(_tup(v) if isinstance(v, (list, tuple, str)) else v
                     for v in x)
    return x


@dataclass(frozen=True)
class DataSplitConfig:
    ROOT_DIR: str = ""
    NUM_GRASP: int = 300


@dataclass(frozen=True)
class DataConfig:
    # reference: yacs_config.py:19-44
    NUM_WORKERS: int = 1
    SCORE_CLASSES: int = 3
    NUM_REMOVAL_DIRECTIONS: int = 5
    TYPE: str = "Scene"
    STD_R: float = 0.1
    STD_T: float = 0.02
    NUM_POINTS: int = 25600
    NUM_CLOSE_REGION_POINTS: int = 1024
    GPD_IN_CHANNELS: int = 3
    TRAIN: DataSplitConfig = field(default_factory=DataSplitConfig)
    VAL: DataSplitConfig = field(default_factory=DataSplitConfig)
    TEST: DataSplitConfig = field(default_factory=DataSplitConfig)


@dataclass(frozen=True)
class PN2Config:
    # reference defaults: yacs_config.py:82-93; the released curvature model
    # overrides these with a 3-stage pyramid (configs/curvature_model.yaml:12-22)
    NUM_INPUT: int = 25600
    NUM_CENTROIDS: Tuple[int, ...] = (10240, 1024, 128, 0)
    RADIUS: Tuple[float, ...] = (0.2, 0.3, 0.4, -1.0)
    NUM_NEIGHBOURS: Tuple[int, ...] = (64, 64, 64, -1)
    SA_CHANNELS: Tuple[Tuple[int, ...], ...] = (
        (32, 32, 64), (64, 64, 128), (128, 128, 256), (256, 512, 1024))
    FP_CHANNELS: Tuple[Tuple[int, ...], ...] = (
        (256, 256), (256, 128), (128, 128), (64, 64, 64))
    NUM_FP_NEIGHBOURS: Tuple[int, ...] = (0, 3, 3, 3)
    SEG_CHANNELS: Tuple[int, ...] = (128,)
    DROPOUT_PROB: float = 0.5
    LABEL_SMOOTHING: float = 0.0
    NEG_WEIGHT: float = 1.0
    # TPU deployment knob (no reference equivalent): internally reorder the
    # cloud along its widest axis so stage-1 ball query prunes to
    # contiguous slabs (~2.7x on that stage).  Off by default: it re-rolls
    # the arbitrary scan order, so per-point outputs differ from the
    # unsorted run at neighbour-selection level (docs/divergences.md).
    SORT_POINTS: bool = False
    # TPU deployment knob (no reference equivalent): G > 1 replaces exact
    # FPS with sharded FPS — exact FPS per contiguous N/G slab of the
    # sorted cloud, M/G centroids each, all G chains lane-parallel in one
    # Pallas kernel (128 shards: 2.57 ms -> 0.01 ms on v5e).  Only active
    # together with SORT_POINTS (slabs must be spatial); documented
    # divergence from reference FPS (docs/divergences.md).
    FPS_SHARDS: int = 1


@dataclass(frozen=True)
class GPDConfig:
    DROPOUT: bool = False


@dataclass(frozen=True)
class ModelConfig:
    WEIGHT: str = ""
    TYPE: str = ""
    GPD: GPDConfig = field(default_factory=GPDConfig)
    PN2: PN2Config = field(default_factory=PN2Config)
    EDGEPN2D: PN2Config = field(default_factory=PN2Config)
    EDGEPN2DU: PN2Config = field(default_factory=PN2Config)
    # TPU-specific knobs (no reference equivalent): compute dtype for the
    # backbone matmuls.  "float32" preserves parity; "bfloat16" maximizes MXU
    # throughput.
    COMPUTE_DTYPE: str = "bfloat16"


@dataclass(frozen=True)
class AdamConfig:
    betas: Tuple[float, float] = (0.9, 0.999)


@dataclass(frozen=True)
class SGDConfig:
    momentum: float = 0.9


@dataclass(frozen=True)
class RMSpropConfig:
    alpha: float = 0.9


@dataclass(frozen=True)
class SolverConfig:
    # reference: yacs_config.py:99-118
    TYPE: str = "Adam"
    BASE_LR: float = 0.001
    WEIGHT_DECAY: float = 0.0
    RMSprop: RMSpropConfig = field(default_factory=RMSpropConfig)
    SGD: SGDConfig = field(default_factory=SGDConfig)
    Adam: AdamConfig = field(default_factory=AdamConfig)


@dataclass(frozen=True)
class StepLRConfig:
    step_size: int = 0
    gamma: float = 0.1


@dataclass(frozen=True)
class MultiStepLRConfig:
    milestones: Tuple[int, ...] = ()
    gamma: float = 0.1


@dataclass(frozen=True)
class SchedulerConfig:
    # reference: yacs_config.py:123-134
    MAX_EPOCH: int = 2
    TYPE: str = ""
    StepLR: StepLRConfig = field(default_factory=StepLRConfig)
    MultiStepLR: MultiStepLRConfig = field(default_factory=MultiStepLRConfig)


@dataclass(frozen=True)
class TrainConfig:
    # reference: yacs_config.py:139-153
    BATCH_SIZE: int = 1
    CHECKPOINT_PERIOD: int = 1
    LOG_PERIOD: int = 10
    FILE_LOG_PERIOD: int = 1000
    VAL_PERIOD: int = 1
    AUGMENTATION: Tuple[Any, ...] = ()
    VAL_METRIC: str = "cls_acc"


@dataclass(frozen=True)
class TestConfig:
    # reference: yacs_config.py:158-172
    BATCH_SIZE: int = 1
    WEIGHT: str = ""
    AUGMENTATION: Tuple[Any, ...] = ()
    LOG_PERIOD: int = 10
    FILE_LOG_PERIOD: int = 1000
    TOPK: int = 10


@dataclass(frozen=True)
class Config:
    OUTPUT_DIR: str = "@"
    AUTO_RESUME: bool = True
    RNG_SEED: int = 1
    DATA: DataConfig = field(default_factory=DataConfig)
    MODEL: ModelConfig = field(default_factory=ModelConfig)
    SOLVER: SolverConfig = field(default_factory=SolverConfig)
    SCHEDULER: SchedulerConfig = field(default_factory=SchedulerConfig)
    TRAIN: TrainConfig = field(default_factory=TrainConfig)
    TEST: TestConfig = field(default_factory=TestConfig)


_TUPLE_OF_TUPLES = {"SA_CHANNELS", "FP_CHANNELS"}


def _merge(dc, overrides: Mapping[str, Any]):
    """Recursively merge a dict of overrides into a (frozen) dataclass."""
    updates = {}
    valid = {f.name: f for f in fields(dc)}
    for key, value in overrides.items():
        if key not in valid:
            raise KeyError(
                f"Unknown config key {key!r} for {type(dc).__name__}; "
                f"valid keys: {sorted(valid)}")
        current = getattr(dc, key)
        if dataclasses.is_dataclass(current) and isinstance(value, Mapping):
            updates[key] = _merge(current, value)
        else:
            if isinstance(current, tuple) or key in _TUPLE_OF_TUPLES:
                value = _tup(value)
            updates[key] = value
    return replace(dc, **updates)


def default_config() -> Config:
    return Config()


def load_cfg_from_file(cfg_filename: str) -> Config:
    """Load a YAML config and merge it over the defaults.

    Mirrors load_cfg_from_file (reference yacs_config.py:175-190) with the
    same section layout, so the reference's released YAMLs translate 1:1.
    """
    with open(cfg_filename, "r") as f:
        overrides = yaml.safe_load(f) or {}
    return _merge(Config(), overrides)


def load_cfg_from_dict(overrides: Mapping[str, Any]) -> Config:
    return _merge(Config(), overrides)

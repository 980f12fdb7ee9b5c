"""Training stack (port of s4g_tpu/train): dataset, augmentation,
optimizers and schedules, the train state and the Trainer."""

from .optim import build_optimizer, build_lr_schedule
from .state import TrainState
from .trainer import Trainer
from .dataset import SceneGraspDataset, collate_scene

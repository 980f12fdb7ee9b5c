"""Training stack (port of s4g_tpu/train): dataset, augmentation,
optimizers and schedules, the train state and the Trainer."""

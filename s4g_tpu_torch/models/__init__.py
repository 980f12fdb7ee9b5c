from .build_model import build_loss_and_metric, build_model

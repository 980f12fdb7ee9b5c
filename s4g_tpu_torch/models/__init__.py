from .build_model import build_model

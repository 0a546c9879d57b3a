"""The port's models: the dense transformer family behind ``Model``."""
from .common import ModelConfig
from .api import Model, build_model

__all__ = ["ModelConfig", "Model", "build_model"]

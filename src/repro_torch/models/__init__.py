"""The port's models: every family of the reference (dense, moe, vlm,
audio, hybrid_ssm, xlstm) behind ``Model``."""
from .common import ModelConfig
from .api import Model, build_model, is_subquadratic

__all__ = ["ModelConfig", "Model", "build_model", "is_subquadratic"]

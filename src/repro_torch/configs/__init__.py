"""Model configurations of the port (jax-free copies of `repro.configs`)."""
from .base import ModelConfig
from .registry import ARCHS, get_config

__all__ = ["ARCHS", "ModelConfig", "get_config"]

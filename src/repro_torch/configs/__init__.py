"""Model configurations of the port (jax-free copies of `repro.configs`)."""
from .base import SHAPES, ModelConfig, ShapeCell, cell_applicable, input_specs
from .registry import ARCHS, get_config

__all__ = ["ARCHS", "SHAPES", "ModelConfig", "ShapeCell", "cell_applicable", "get_config",
           "input_specs"]

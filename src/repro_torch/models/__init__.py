"""Model substrate of the port (PyTorch counterpart of `repro.models`): the
decoder LM forward with attention (through the `flash_attn` kernel) and
Mamba-1 (through the `ssm_scan` kernel) blocks."""
from .api import init_model
from .convert import params_from_reference
from .lm import LM

__all__ = ["LM", "init_model", "params_from_reference"]

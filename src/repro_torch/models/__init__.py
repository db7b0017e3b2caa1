"""Model substrate of the port (PyTorch counterpart of `repro.models`): the
decoder LM with attention (through the `flash_attn` kernel), MoE FFN,
Mamba-1 (through the `ssm_scan` kernel), Mamba-2 (plain torch, as the
reference's jnp) and zamba's shared attention blocks -- its forward, loss,
and prefill and one-token decode with KV and SSM caches."""
from .api import decode_step, init_caches, init_model, loss_fn, param_count, prefill
from .convert import caches_from_reference, params_from_reference
from .lm import LM

__all__ = ["LM", "caches_from_reference", "decode_step", "init_caches", "init_model",
           "loss_fn", "param_count", "params_from_reference", "prefill"]

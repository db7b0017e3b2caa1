"""Model substrate of the port (PyTorch counterpart of `repro.models`): the
decoder LM with attention (through the `flash_attn` kernel), MoE FFN,
Mamba-1 (through the `ssm_scan` kernel), Mamba-2 (plain torch, as the
reference's jnp) and zamba's shared attention blocks; the VLM (patch
embeddings spliced ahead of the text, M-RoPE); the whisper encoder-decoder
(cross attention through `flash_attn`) -- their forward, loss, and prefill
and one-token decode with KV, SSM and cross-attention caches."""
from .api import decode_step, init_caches, init_model, loss_fn, param_count, prefill
from .convert import (caches_from_reference, params_from_reference, params_to_reference,
                      train_state_from_reference, train_state_to_reference)
from .lm import LM
from .vlm import mrope_positions, splice_patches
from .whisper import Whisper, WhisperCache

__all__ = ["LM", "Whisper", "WhisperCache", "caches_from_reference", "decode_step",
           "init_caches", "init_model", "loss_fn", "mrope_positions", "param_count",
           "params_from_reference", "params_to_reference", "prefill", "splice_patches",
           "train_state_from_reference", "train_state_to_reference"]

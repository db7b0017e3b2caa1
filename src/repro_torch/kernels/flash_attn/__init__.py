"""flash_attn: blocked flash attention forward (causal, sliding window,
logit soft-capping; grouped-query heads) and its backward."""
from .ops import flash_attention, flash_attention_bwd
from .ref import attn_mask, attn_ref, flash_attention_bwd_ref, flash_attention_ref

__all__ = ["attn_mask", "attn_ref", "flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_ref", "flash_attention_ref"]

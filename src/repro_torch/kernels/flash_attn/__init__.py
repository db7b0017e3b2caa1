"""flash_attn: blocked flash attention forward (causal, sliding window,
logit soft-capping; grouped-query heads)."""
from .ops import flash_attention
from .ref import attn_mask, attn_ref, flash_attention_ref

__all__ = ["attn_mask", "attn_ref", "flash_attention", "flash_attention_ref"]

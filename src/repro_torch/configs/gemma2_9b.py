"""gemma2-9b [dense] -- 42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000; local+global alternating (window 4096), logit softcaps,
head_dim=256.  [arXiv:2408.00118; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv=8, head_dim=256,
    d_ff=14336, vocab=256000,
    pattern=("local", "global"), repeats=21,
    activation="gelu", embed_scale=True, tie_embeddings=True,
    post_norms=True, window=4096,
    attn_softcap=50.0, final_softcap=30.0,
    supports_long=False,
    source="[arXiv:2408.00118; hf]",
)

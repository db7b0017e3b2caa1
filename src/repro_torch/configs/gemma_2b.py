"""gemma-2b [dense] -- 18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=256000; GeGLU, head_dim=256.  [arXiv:2403.08295; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv=1, head_dim=256,
    d_ff=16384, vocab=256000,
    pattern=("attn",), repeats=18,
    activation="gelu", embed_scale=True, tie_embeddings=True,
    supports_long=False,
    source="[arXiv:2403.08295; hf]",
)

"""qwen2-7b [dense] -- 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064; GQA + QKV bias.  [arXiv:2407.10671; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b", family="dense",
    n_layers=28, d_model=3584, n_heads=28, n_kv=4, head_dim=128,
    d_ff=18944, vocab=152064,
    pattern=("attn",), repeats=28,
    qkv_bias=True, tie_embeddings=False, rope_theta=1_000_000.0,
    supports_long=False,
    source="[arXiv:2407.10671; hf]",
)

"""qwen2-vl-7b [vlm] -- 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064; M-RoPE, dynamic resolution (frontend stubbed: precomputed
patch embeddings).  [arXiv:2409.12191; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv=4, head_dim=128,
    d_ff=18944, vocab=152064,
    pattern=("attn",), repeats=28,
    qkv_bias=True, tie_embeddings=False, rope_theta=1_000_000.0,
    mrope=True, vlm=True, n_patches=256,
    vlm_sharded_splice=True,  # §Perf it.1: 41x collective reduction (EXPERIMENTS.md)
    supports_long=False,
    source="[arXiv:2409.12191; hf]",
)

"""qwen3-moe-235b-a22b [moe] -- 94L d_model=4096 64H (GQA kv=4)
d_ff=1536 (per expert) vocab=151936; 128 experts top-8.
[hf:Qwen/Qwen3-30B-A3B; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv=4, head_dim=128,
    d_ff=1536, vocab=151936,
    pattern=("moe",), repeats=94,
    tie_embeddings=False, rope_theta=1_000_000.0,
    n_experts=128, moe_top_k=8, capacity_factor=1.25,
    supports_long=False,
    source="[hf:Qwen/Qwen3-30B-A3B; hf]",
)

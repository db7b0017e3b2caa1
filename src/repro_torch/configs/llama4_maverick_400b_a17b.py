"""llama4-maverick-400b-a17b [moe] -- 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048; 128 experts top-1, interleaved MoE (every other
layer) + shared expert so the 400B-total / 17B-active budget holds; early
fusion stubbed at the embedding level.  [hf:meta-llama/Llama-4-Scout-17B-16E;
unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv=8, head_dim=128,
    d_ff=8192, vocab=202048,
    pattern=("dense", "moe"), repeats=24,
    tie_embeddings=False, rope_theta=500_000.0,
    n_experts=128, moe_top_k=1, capacity_factor=1.25,
    shared_expert_ff=8192,
    supports_long=False,
    source="[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]",
)

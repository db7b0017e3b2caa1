"""zamba2-7b [hybrid] -- 81L d_model=3584 32H (kv=32) d_ff=14336
vocab=32000, ssm_state=64; Mamba2 backbone + ONE shared transformer block
applied every 6th position (Zamba design: shared weights, not stacked).
[arXiv:2411.15242; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv=32, head_dim=112,
    d_ff=14336, vocab=32000,
    pattern=("m2", "m2", "m2", "m2", "m2", "shared_attn"),
    repeats=13, tail=("m2", "m2", "m2"),
    tie_embeddings=True,
    ssm_d_inner=7168, ssm_state=64, ssm_head_dim=64, ssm_conv=4,
    supports_long=True,  # hybrid: SSM backbone
    source="[arXiv:2411.15242; unverified]",
)

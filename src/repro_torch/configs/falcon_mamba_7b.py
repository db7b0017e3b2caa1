"""falcon-mamba-7b [ssm] -- 64L d_model=4096 (attn-free) vocab=65024,
ssm_state=16; Mamba-1 architecture (d_inner=8192, dt_rank=256, conv 4).
[arXiv:2410.05355; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv=0, head_dim=0,
    d_ff=0, vocab=65024,
    pattern=("m1",), repeats=64,
    tie_embeddings=True,
    ssm_d_inner=8192, ssm_state=16, ssm_dt_rank=256, ssm_conv=4,
    ssm_fused_chunks=True,  # §Perf it.1: 25% memory-term cut (EXPERIMENTS.md)
    supports_long=True,  # attention-free
    source="[arXiv:2410.05355; unverified]",
)

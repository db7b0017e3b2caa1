"""gemma3-1b [dense] -- 26L d_model=1152 4H (MQA kv=1) d_ff=6912
vocab=262144; 5:1 local:global, 128k context, head_dim=256, sliding
window 512, global rope theta 1M.  [hf:google/gemma-3-1b-pt; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv=1, head_dim=256,
    d_ff=6912, vocab=262144,
    pattern=("local", "local", "local", "local", "local", "global"),
    repeats=4, tail=("local", "local"),
    activation="gelu", embed_scale=True, tie_embeddings=True,
    post_norms=True, window=512,
    rope_theta=1_000_000.0, rope_theta_local=10_000.0,
    supports_long=False,  # [dense]: global layers are full attention
    source="[hf:google/gemma-3-1b-pt; unverified]",
)

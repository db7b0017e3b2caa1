"""whisper-tiny [audio] -- 4L encoder + 4L decoder, d_model=384 6H (kv=6)
d_ff=1536 vocab=51865 (padded to 51968 for sharding); enc-dec, conv audio
frontend STUBBED (precomputed frame embeddings).  [arXiv:2212.04356;
unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio",
    n_layers=8, d_model=384, n_heads=6, n_kv=6, head_dim=64,
    d_ff=1536, vocab=51865,
    pattern=("attn",), repeats=4,  # decoder layers; encoder separate
    enc_dec=True, n_enc_layers=4, n_audio_frames=1500,
    max_pos=40960,  # covers the 32k decode shape cells
    norm="ln", activation="gelu", gated_mlp=False, qkv_bias=True,
    tie_embeddings=True, rope_theta=0.0,
    supports_long=False,
    source="[arXiv:2212.04356; unverified]",
)

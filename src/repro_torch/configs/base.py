"""ModelConfig: one dataclass describing each architecture (a jax-free copy
of `repro.configs.base.ModelConfig`), and the shape cells every LM-family
architecture is analysed at (`SHAPES`, `cell_applicable`), with
`input_specs`, the batch of a cell as meta tensors (the reference's
ShapeDtypeStructs).
"""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    d_ff: int
    vocab: int

    # layer pattern: pattern x repeats + tail  (sum == n_layers)
    pattern: tuple[str, ...] = ("attn",)
    repeats: int = 0
    tail: tuple[str, ...] = ()

    # attention / norm details
    norm: str = "rms"
    activation: str = "silu"
    gated_mlp: bool = True
    qkv_bias: bool = False
    window: int = 0  # sliding window for "local" blocks
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    post_norms: bool = False
    rope_theta: float = 10000.0
    rope_theta_local: float = 10000.0
    mrope: bool = False
    causal: bool = True
    embed_scale: bool = False  # gemma: x *= sqrt(d_model)
    tie_embeddings: bool = True

    # moe
    n_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25
    shared_expert_ff: int = 0
    aux_loss_weight: float = 0.01

    # ssm
    ssm_d_inner: int = 0
    ssm_state: int = 0
    ssm_dt_rank: int = 0
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    ssm_chunk: int = 64
    # §Perf hillclimb knobs (False = paper-faithful/naive baseline)
    ssm_fused_chunks: bool = False  # compute dtA/dBx per chunk inside the
    # scan instead of materialising (B, L, Di, N) activations
    vlm_sharded_splice: bool = False  # sharding-aware patch/text concat
    moe_bf16_gather: bool = False  # cast expert weights to bf16 before the
    # ZeRO all-gather inside the MoE block
    attn_bf16_probs: bool = False  # store softmax probabilities in bf16
    # between the exp and the PV matmul (fp32 max/sum statistics kept)
    ssm_bf16_acts: bool = False  # carry dt/x/B/C scan inputs in bf16
    # (recurrence state h stays fp32; casts happen per step in-register)

    # modality frontends (stubs per spec)
    vlm: bool = False
    n_patches: int = 256
    enc_dec: bool = False
    n_enc_layers: int = 0
    n_audio_frames: int = 1500
    max_pos: int = 4096  # learned-position table size (whisper decoder)

    # execution
    kv_chunk: int = 1024
    remat: bool = True
    remat_policy: str = "dots"  # dots | nothing (full recompute)

    # shape-cell applicability
    supports_decode: bool = True
    supports_long: bool = False  # long_500k needs sub-quadratic attention

    source: str = ""  # [citation; verification tier]

    def __post_init__(self):
        n = len(self.pattern) * self.repeats + len(self.tail)
        if self.enc_dec:
            n += self.n_enc_layers
        if n != self.n_layers:
            raise ValueError(
                f"{self.name}: pattern*repeats+tail = {n} != n_layers {self.n_layers}"
            )

    @property
    def vocab_padded(self) -> int:
        return (self.vocab + 127) // 128 * 128

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        n_rep = min(self.repeats, 2) if self.repeats else 0
        tail = self.tail[: min(len(self.tail), 1)]
        n_layers = len(self.pattern) * n_rep + len(tail)
        n_enc = min(self.n_enc_layers, 2)
        if self.enc_dec:
            n_layers += n_enc
        d_model = 64
        n_heads = min(self.n_heads, 4)
        n_kv = min(self.n_kv, n_heads)
        if n_kv:
            n_heads = (n_heads // n_kv) * n_kv
        return replace(
            self,
            n_layers=n_layers,
            d_model=d_model,
            n_heads=n_heads,
            n_kv=n_kv,
            head_dim=16,
            d_ff=128,
            vocab=512,
            repeats=n_rep,
            tail=tail,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            moe_top_k=min(self.moe_top_k, 2) if self.moe_top_k else 0,
            shared_expert_ff=128 if self.shared_expert_ff else 0,
            ssm_d_inner=128 if self.ssm_d_inner else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_dt_rank=8 if self.ssm_dt_rank else 0,
            ssm_head_dim=32 if self.ssm_d_inner else 64,
            ssm_chunk=8,
            n_patches=8,
            n_enc_layers=n_enc,
            n_audio_frames=16,
            kv_chunk=32,
            window=min(self.window, 16) if self.window else 0,
            remat=False,
        )


# ---------------------------------------------------------------------------
# Shape cells (assigned to every LM-family architecture)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


def cell_applicable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """(whether `cfg` runs shape cell `shape`, the reference's reason where
    it does not)."""
    cell = SHAPES[shape]
    if cell.name == "long_500k" and not cfg.supports_long:
        return False, "long_500k skipped: full-attention arch (DESIGN.md §4)"
    if cell.kind == "decode" and not cfg.supports_decode:
        return False, "decode skipped: encoder-only arch"
    return True, ""


def input_specs(cfg: ModelConfig, shape: "str | ShapeCell", device="meta") -> dict:
    """Every model input of a shape cell (a name in SHAPES, or a cell) as
    tensors without data (on the meta device, or fake tensors under a
    FakeTensorMode), in the reference's shapes and dtypes: int32 tokens and
    labels, float32 patch and frame embeddings; a decode cell's one new
    token a sequence."""
    import torch

    cell = SHAPES[shape] if isinstance(shape, str) else shape
    B, S = cell.global_batch, cell.seq_len

    def t(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device=device)

    i32, f32 = torch.int32, torch.float32
    if cell.kind == "decode":
        return {"token": t((B, 1), i32)}
    train = cell.kind == "train"
    if cfg.vlm:
        batch = {"tokens": t((B, S - cfg.n_patches), i32)}
        if train:
            batch["labels"] = t((B, S), i32)
        batch["patch_embeds"] = t((B, cfg.n_patches, cfg.d_model), f32)
        return batch
    batch = {}
    if cfg.enc_dec:
        batch["frames"] = t((B, cfg.n_audio_frames, cfg.d_model), f32)
    batch["tokens"] = t((B, S), i32)
    if train:
        batch["labels"] = t((B, S), i32)
    return batch

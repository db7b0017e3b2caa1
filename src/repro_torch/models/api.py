"""Model entry points (port of `repro.models.api`): init, loss, prefill,
cache init and one-token decode of every model the reference defines --
the decoder LM (dense, MoE, Mamba-1 and the hybrid family), the VLM (the
LM over patch embeddings spliced ahead of the text, at M-RoPE positions)
and the encoder-decoder (`Whisper`).  Each runs on the model's device;
`init_model` and `init_caches` take theirs, CUDA by default (raising
without it)."""
from __future__ import annotations

import torch

from ..core.index import resolve_device
from . import lm
from .lm import LM
from .vlm import splice_patches
from .whisper import Whisper, WhisperCache


def _tokens(model: LM | Whisper, t) -> torch.Tensor:
    """Token ids (a tensor or an array) as int64 on the model's device."""
    return torch.as_tensor(t).to(device=model.embedding.device, dtype=torch.long)


def _frames(model: Whisper, batch: dict) -> torch.Tensor:
    """The batch's frame embeddings (B, S_enc, D) as float32 on the model's
    device."""
    return torch.as_tensor(batch["frames"]).to(device=model.embedding.device,
                                               dtype=torch.float32)


def init_model(cfg, seed: int = 0, device=None) -> LM | Whisper:
    """A randomly initialised model for `cfg` (a `Whisper` for an
    encoder-decoder, else an `LM`) on `device` (None = CUDA; raises without
    it).  The weights are drawn on the device itself from a
    `torch.Generator` seeded with `seed`, so a full-width model is never
    built on the host and copied.  Returned in eval mode without gradients,
    as serving runs it; `train.init_train_state` makes the parameters
    trainable.  On the meta device (a dry run's shapes, `launch.dryrun`)
    nothing is drawn: a generator draws no number there."""
    dev = resolve_device(device)
    model = Whisper(cfg, device=dev) if cfg.enc_dec else LM(cfg, device=dev)
    if dev.type != "meta":
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        model.reset_parameters(gen)
    return model.eval().requires_grad_(False)


def loss_fn(model: LM | Whisper, batch: dict):
    """batch: {"tokens" (B, S), "labels" (B, S)} and optionally "mask"
    (B, S) and "positions" ((B, S), or (B, S, 3) streams for M-RoPE; 0 ..
    S - 1 without) -> (scalar loss ce + aux_loss_weight * aux, {"ce",
    "aux"}), aux the MoE layers' load-balancing loss (0 without one).  A
    VLM's batch also has "patch_embeds" (B, P, D), spliced ahead of the
    text at their own positions, and its labels cover both (B, P + S); a
    whisper batch has "frames" (B, S_enc, D)."""
    dev = model.embedding.device
    mask = batch.get("mask")
    mask = None if mask is None else torch.as_tensor(mask).to(dev)
    labels = _tokens(model, batch["labels"])
    if model.cfg.enc_dec:
        return model.loss(_frames(model, batch), _tokens(model, batch["tokens"]), labels, mask)
    if model.cfg.vlm:
        embeds, positions = splice_patches(model, batch)
        return model.loss(None, labels, mask, positions=positions, inputs_embeds=embeds)
    positions = batch.get("positions")
    if positions is not None:
        positions = _tokens(model, positions)
    return model.loss(_tokens(model, batch["tokens"]), labels, mask, positions=positions)


@torch.no_grad()
def prefill(model: LM | Whisper, batch: dict, max_len: int):
    """batch: {"tokens" (B, S)} (a VLM's with "patch_embeds", a whisper's
    with "frames", as `loss_fn`) -> (last logits (B, vocab_padded), caches
    of `max_len` slots: a list, one a layer in layer order, or a whisper's
    `WhisperCache`)."""
    if model.cfg.enc_dec:
        return model.prefill(_frames(model, batch), _tokens(model, batch["tokens"]), max_len)
    if model.cfg.vlm:
        embeds, positions = splice_patches(model, batch)
        return model.prefill(None, max_len, positions=positions, inputs_embeds=embeds)
    return model.prefill(_tokens(model, batch["tokens"]), max_len)


def init_caches(cfg, batch: int, max_len: int, device=None) -> list:
    """Empty caches of every layer on `device` (None = CUDA; raises without
    it): bf16 KV caches of `max_len` slots (one a place of zamba's shared
    block), float32 Mamba-1 state (B, d_inner, N) and Mamba-2 state (B, H,
    N, head_dim)."""
    if cfg.enc_dec:
        # the cross-attention keys and values depend on the audio
        raise NotImplementedError("whisper caches come from prefill")
    return lm.init_caches(cfg, batch, max_len, device=resolve_device(device))


@torch.no_grad()
def decode_step(model: LM | Whisper, token, caches: list | WhisperCache):
    """One token a sequence, token (B, 1) -> (logits (B, vocab_padded), the
    new caches)."""
    return model.decode_step(_tokens(model, token), caches)


def param_count(model: LM | Whisper) -> int:
    """The parameters, each tensor once (zamba's shared block once, not a
    place), as the reference's `param_count`."""
    return sum(p.numel() for p in model.parameters())

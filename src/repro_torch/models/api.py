"""Model entry points (port of `repro.models.api`): init, loss, prefill,
cache init and one-token decode of the decoder LM.  Encoder-decoder and
VLM configurations raise (ROADMAP A11).  Each runs on the model's device;
`init_model` and `init_caches` take theirs, CUDA by default (raising
without it)."""
from __future__ import annotations

import torch

from ..core.index import resolve_device
from . import lm
from .lm import LM


def _decoder_only(cfg) -> None:
    if cfg.enc_dec or cfg.vlm:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder and VLM models are not ported yet (ROADMAP A11)")


def _tokens(model: LM, t) -> torch.Tensor:
    """Token ids (a tensor or an array) as int64 on the model's device."""
    return torch.as_tensor(t).to(device=model.embedding.device, dtype=torch.long)


def init_model(cfg, seed: int = 0, device=None) -> LM:
    """A randomly initialised `LM` for `cfg` on `device` (None = CUDA; raises
    without it).  The weights are drawn on the device itself from a
    `torch.Generator` seeded with `seed`, so a full-width model is never
    built on the host and copied.  Returned in eval mode without gradients
    (the port serves; it does not train yet)."""
    dev = resolve_device(device)
    model = LM(cfg, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    model.reset_parameters(gen)
    return model.eval().requires_grad_(False)


def loss_fn(model: LM, batch: dict):
    """batch: {"tokens" (B, S), "labels" (B, S)} and optionally "mask"
    (B, S) -> (scalar loss ce + aux_loss_weight * aux, {"ce", "aux"}), aux
    the MoE layers' load-balancing loss (0 without one).  Tokens sit at
    positions 0 .. S - 1: the reference's per-token "positions" (its VLM's)
    are not ported and raise."""
    _decoder_only(model.cfg)
    if "positions" in batch:
        raise NotImplementedError("per-token positions are not ported yet (ROADMAP A11)")
    dev = model.embedding.device
    mask = batch.get("mask")
    return model.loss(_tokens(model, batch["tokens"]), _tokens(model, batch["labels"]),
                      mask=None if mask is None else torch.as_tensor(mask).to(dev))


@torch.no_grad()
def prefill(model: LM, batch: dict, max_len: int):
    """batch: {"tokens" (B, S)} -> (last logits (B, vocab_padded), caches of
    `max_len` slots, one a layer in layer order)."""
    _decoder_only(model.cfg)
    return model.prefill(_tokens(model, batch["tokens"]), max_len)


def init_caches(cfg, batch: int, max_len: int, device=None) -> list:
    """Empty caches of every layer on `device` (None = CUDA; raises without
    it): bf16 KV caches of `max_len` slots, float32 Mamba-1 state."""
    _decoder_only(cfg)
    return lm.init_caches(cfg, batch, max_len, device=resolve_device(device))


@torch.no_grad()
def decode_step(model: LM, token, caches: list):
    """One token a sequence, token (B, 1) -> (logits (B, vocab_padded), the
    new caches)."""
    _decoder_only(model.cfg)
    return model.decode_step(_tokens(model, token), caches)


def param_count(model: LM) -> int:
    return sum(p.numel() for p in model.parameters())

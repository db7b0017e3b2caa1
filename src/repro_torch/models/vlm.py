"""The VLM (port of `repro.models.vlm`, qwen2-vl): the modality frontend is
a stub, as in the reference -- a batch carries precomputed patch embeddings
(B, P, d_model) -- and this module splices them ahead of the text's
embeddings and builds the M-RoPE position streams (t, h, w): patches get
grid positions, text continues sequentially.  The LM then runs the spliced
sequence (`LM.hidden` / `loss` / `prefill` with `inputs_embeds` and
`positions`), and decode continues the text streams at the cache's length.

The config's `vlm_sharded_splice` (set by qwen2-vl-7b) is a sharding hint
of the reference: under a mesh it aligns the two inputs to batch-only
shardings, concatenates them locally, then shards the result's sequence;
without a mesh its constraints do nothing."""
from __future__ import annotations

import torch

from ..sharding import with_logical_constraint as wlc
from .lm import LM


def mrope_positions(batch: int, n_patches: int, s_text: int, grid: int | None = None,
                    device=None) -> torch.Tensor:
    """(B, P + S_text, 3) int64 position streams: patch i at (0, i // grid,
    i % grid), grid = max(1, int(sqrt(P))) unless given; text token j at
    P + j on all three streams (P is at least the patches' largest spatial
    index, so the two never overlap, and decode's position, the cache's
    length, continues the text exactly)."""
    grid = grid or max(1, int(n_patches ** 0.5))
    idx = torch.arange(n_patches, device=device)
    patch_pos = torch.stack([torch.zeros_like(idx), idx // grid, idx % grid], dim=-1)
    tpos = n_patches + torch.arange(s_text, device=device)
    text_pos = tpos[:, None].expand(s_text, 3)
    pos = torch.cat([patch_pos, text_pos], dim=0)
    return pos.expand(batch, n_patches + s_text, 3)


def splice_patches(model: LM, batch: dict):
    """batch: {"tokens" (B, S_text), "patch_embeds" (B, P, D)} (tensors or
    arrays) -> (inputs_embeds (B, P + S_text, D): the patches, then the
    tokens' embeddings; positions (B, P + S_text, 3), `mrope_positions`)
    on the model's device."""
    dev = model.embedding.device
    tokens = torch.as_tensor(batch["tokens"]).to(device=dev, dtype=torch.long)
    text = model.embed_tokens(tokens)
    patches = torch.as_tensor(batch["patch_embeds"]).to(device=dev, dtype=text.dtype)
    B, P, _ = patches.shape
    if model.cfg.vlm_sharded_splice:
        patches = wlc(patches, "batch", None, None)
        text = wlc(text, "batch", None, None)
        x = wlc(torch.cat([patches, text], dim=1), "batch", "seq", None)
    else:
        x = torch.cat([patches, text], dim=1)
    return x, mrope_positions(B, P, tokens.shape[1], device=dev)

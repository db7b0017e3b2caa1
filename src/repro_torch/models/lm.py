"""Decoder LM (port of `repro.models.lm`): the embedding, the layer stack,
the final norm and the unembedding (tied, or the untied `lm_head`), the
loss, and serving's prefill and one-token decode with a cache a layer.

The reference scans the repeated layer pattern over stacked parameters and
stacks its caches alike ({"pattern": {"slot{j}": ...}, "tail": ...}); the
port holds the layers as a flat `ModuleList` in the order they run, and
their caches as a list in the same order: repeat r, pattern slot j is layer
r * len(pattern) + j, then the tail blocks.

zamba's `shared_attn` pattern slot is one block applied at every repeat, as
the reference's one `params["shared"]`: the LM registers it once, as
`shared`, and each of its places in `layers` is a `SharedPlace` that calls
it, so every place runs the same tensors while each keeps its own KV cache
in the list."""
from __future__ import annotations

import torch
from torch import nn

from .blocks import ATTN_KINDS, Block, init_block_cache
from .common import dense_init_, layer_norm, rms_norm, softmax_cross_entropy


def layer_kinds(cfg) -> list[str]:
    return list(cfg.pattern) * cfg.repeats + list(cfg.tail)


def init_caches(cfg, batch: int, max_len: int, device=None) -> list:
    """Empty caches of every layer, in layer order: a KVCache of `max_len`
    bf16 slots an attention, MoE or shared-attention layer (one a place of
    the shared block), an SSMCache a Mamba-1 or Mamba-2 layer."""
    return [init_block_cache(kind, cfg, batch, max_len, device=device)
            for kind in layer_kinds(cfg)]


class SharedPlace(nn.Module):
    """A place of the LM's shared block in the layer order.  It has no
    parameters of its own: the block is held in a tuple, so that it is not
    registered again here and `parameters()` and `state_dict()` hold its
    tensors once, under the LM's `shared`."""

    def __init__(self, block: Block):
        super().__init__()
        self._shared = (block,)
        self.kind = block.kind

    @property
    def block(self) -> Block:
        return self._shared[0]

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Nothing: the LM resets its shared block once."""

    def forward(self, x: torch.Tensor, positions: torch.Tensor):
        return self.block(x, positions)

    def prefill(self, x: torch.Tensor, positions: torch.Tensor, max_len: int):
        return self.block.prefill(x, positions, max_len)

    def decode(self, x: torch.Tensor, cache, position: torch.Tensor | None):
        return self.block.decode(x, cache, position)


class LM(nn.Module):
    """Parameters: `embedding` (vocab_padded, D), `lm_head` (D, vocab_padded)
    where the embeddings are not tied, `layers`, zamba's `shared` block
    where the pattern has a `shared_attn` slot, and the final norm
    `fn_scale` (+ `fn_bias` for layer norms).  Built with uninitialised
    storage on `device`; `reset_parameters` fills it (see `api.init_model`)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        if cfg.enc_dec or cfg.vlm:
            raise NotImplementedError(
                f"{cfg.name}: encoder-decoder and VLM models are not ported yet (ROADMAP A11)")
        self.cfg = cfg
        self.embedding = nn.Parameter(torch.empty((cfg.vocab_padded, cfg.d_model),
                                                  device=device))
        self.lm_head = (None if cfg.tie_embeddings
                        else nn.Parameter(torch.empty((cfg.d_model, cfg.vocab_padded),
                                                      device=device)))
        self.shared = (Block("shared_attn", cfg, device=device)
                       if "shared_attn" in cfg.pattern else None)
        n_pat = len(cfg.pattern) * cfg.repeats  # the tail's blocks are its own
        self.layers = nn.ModuleList(
            SharedPlace(self.shared) if kind == "shared_attn" and i < n_pat
            else Block(kind, cfg, device=device) for i, kind in enumerate(layer_kinds(cfg)))
        self.attends = any(kind in ATTN_KINDS for kind in layer_kinds(cfg))
        self.fn_scale = nn.Parameter(torch.empty(cfg.d_model, device=device))
        self.fn_bias = (None if cfg.norm == "rms"
                        else nn.Parameter(torch.empty(cfg.d_model, device=device)))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's distributions: embedding normal * 0.02, dense
        weights (the untied head too) normal / sqrt(fan_in), norms zero
        (rms) or one / zero (layer), the SSM's own constants."""
        with torch.no_grad():
            self.embedding.normal_(0.0, 0.02, generator=generator)
            self.fn_scale.fill_(0.0 if self.cfg.norm == "rms" else 1.0)
            if self.fn_bias is not None:
                self.fn_bias.zero_()
        if self.lm_head is not None:
            dense_init_(self.lm_head, generator)
        for layer in self.layers:
            layer.reset_parameters(generator)
        if self.shared is not None:
            self.shared.reset_parameters(generator)

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embedding[tokens]
        if self.cfg.embed_scale:  # gemma: x * sqrt(d_model), in the activation dtype
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
        return x

    def final_norm(self, x: torch.Tensor) -> torch.Tensor:
        if self.fn_bias is None:
            return rms_norm(x, self.fn_scale)
        return layer_norm(x, self.fn_scale, self.fn_bias)

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        """Final hidden states (..., D) -> logits (..., vocab_padded), through
        the tied embedding or `lm_head`, soft-capped by `final_softcap`."""
        logits = x @ (self.embedding.T if self.lm_head is None else self.lm_head)
        cap = self.cfg.final_softcap
        if cap > 0:
            logits = cap * torch.tanh(logits / cap)
        return logits

    def hidden(self, tokens: torch.Tensor):
        """tokens: (B, S) int, at positions 0 .. S - 1 -> (final hidden
        states (B, S, D), the layers' auxiliary losses summed: the MoE
        layers', 0 without one), the reference's `forward`."""
        x = self.embed_tokens(tokens)
        B, S = x.shape[:2]
        positions = torch.arange(S, device=x.device).expand(B, S)
        aux = 0.0  # a float until a MoE layer adds its tensor
        for layer in self.layers:
            x, layer_aux = layer(x, positions)
            aux = aux + layer_aux
        return self.final_norm(x), torch.as_tensor(aux, dtype=torch.float32, device=x.device)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens: (B, S) int, at positions 0 .. S - 1 -> final hidden
        states (B, S, D)."""
        return self.hidden(tokens)[0]

    def loss(self, tokens: torch.Tensor, labels: torch.Tensor, mask=None):
        """The reference's `ce + aux_loss_weight * aux`: the mean
        cross-entropy of `labels` under the logits of `tokens` (over the
        tokens where `mask` is set), and the MoE layers' load-balancing loss
        (0 in a model without one).  Returns (loss, {"ce": ce, "aux": aux})."""
        hidden, aux = self.hidden(tokens)
        ce = softmax_cross_entropy(self.unembed(hidden), labels, mask)
        return ce + self.cfg.aux_loss_weight * aux, {"ce": ce, "aux": aux}

    def prefill(self, tokens: torch.Tensor, max_len: int):
        """Run the prompt (B, S) at positions 0 .. S - 1 and build every
        layer's cache (attention caches of `max_len` slots).  Returns (the
        last position's logits (B, vocab_padded), caches in layer order)."""
        x = self.embed_tokens(tokens)
        B, S = x.shape[:2]
        positions = torch.arange(S, device=x.device).expand(B, S)
        caches = []
        for layer in self.layers:
            x, cache = layer.prefill(x, positions, max_len)
            caches.append(cache)
        return self.unembed(self.final_norm(x[:, -1:]))[:, 0], caches

    def decode_step(self, token: torch.Tensor, caches: list):
        """One token a sequence, token (B, 1) int, against `caches`.  Returns
        (logits (B, vocab_padded), the new caches).  An attention cache's
        tensors are written in place at the slot of its length, which is
        the token's position (one for the whole step, built once)."""
        if len(caches) != len(self.layers):
            raise ValueError(f"{len(caches)} caches for {len(self.layers)} layers")
        lengths = {cache.length for cache in caches}
        if len(lengths) > 1:
            raise ValueError(f"caches of lengths {sorted(lengths)} in one step")
        x = self.embed_tokens(token)
        position = (torch.full(token.shape, caches[0].length, dtype=torch.long, device=x.device)
                    if self.attends else None)
        new = []
        for layer, cache in zip(self.layers, caches):
            x, cache = layer.decode(x, cache, position)
            new.append(cache)
        return self.unembed(self.final_norm(x))[:, 0], new

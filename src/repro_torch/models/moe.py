"""Mixture-of-Experts FFN (port of `repro.models.moe`'s single-device path,
`_moe_local`): top-k routing with a load-balancing auxiliary loss,
sort-based dispatch into (E, cap, D) capacity slots with rank-within-expert
dropping, the expert SwiGLU as batched products over every expert, and the
gate-weighted combine; plus the optional shared expert.

The reference's expert-parallel path (`_moe_sharded`: shard_map, ZeRO
gathers, all-to-all) is not ported (ROADMAP A9b): under a mesh with a
`model` axis, where the reference takes it, the block raises; on one
device the reference itself takes `_moe_local`.

The reference's combine scatter-adds each token's K contributions
(`.at[st].add`), which XLA on the CPU adds in the sorted order, by expert.
`index_add_` on CUDA is atomic and its order changes from run to run, so
the port gathers each token's K contributions in that same sorted order and
adds them one after another: the CPU and the card add in one order, and the
result is the reference's bit for bit given the same expert outputs."""
from __future__ import annotations

from contextlib import contextmanager
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.lsh import topk_largest
from ..sharding import current_mesh, with_logical_constraint as wlc
from ..sharding.specs import mesh_axes
from .common import dense_init_, matmul
from .ffn import MLP

# elements of one (experts, cap, F) intermediate of the expert SwiGLU: the
# experts run in groups under this size, and without grad each group writes
# over its own rows of the dispatch buffer.  At the configs' capacity factor
# every shape fits one group; the one user of both is chip_smoke.py's
# decode-vs-forward gate, at a capacity of one slot a token (capacity_factor
# = E / K) beside llama4-maverick's weights
EXPERT_CHUNK_ELEMS = 1 << 26


class MoEConfig(NamedTuple):
    d_model: int
    d_ff: int  # per-expert hidden
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    shared_expert_ff: int = 0  # 0 = none


class Routed(NamedTuple):
    """What one MoE layer call routed (`recording`): its dropped assignments
    (0-dim int64), expert ids (T, K) and router probabilities (T, E)."""
    dropped: torch.Tensor
    eidx: torch.Tensor
    probs: torch.Tensor


class Routes(NamedTuple):
    """The T * K assignments sorted by expert (stable: by token within an
    expert): capacity slot (slot_e, slot_r), source token, gate (0 where
    dropped), and `order`, the flat (t * K + k) index each came from."""
    slot_e: torch.Tensor
    slot_r: torch.Tensor
    token: torch.Tensor
    gate: torch.Tensor
    order: torch.Tensor


def capacity(tokens: int, cfg: MoEConfig) -> int:
    """Slots an expert, the reference's `int(max(K, T K cf / E))`: Python
    float arithmetic and a floor (the sharded path's ceil is another)."""
    return int(max(cfg.top_k, tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts))


def route(xt: torch.Tensor, router: torch.Tensor, top_k: int):
    """xt (T, D) -> gates (T, K) renormalised by max(sum, 1e-9), expert ids
    (T, K) int64 (ties to the lower expert, as `lax.top_k`), and the
    router's probabilities (T, E)."""
    probs = torch.softmax(matmul(xt.to(torch.float32), router), dim=-1)
    gates, eidx = topk_largest(probs, top_k)
    return gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9), eidx, probs


def expert_counts(eidx: torch.Tensor, E: int) -> torch.Tensor:
    """(E,) int64: how many of `eidx`'s entries name each expert.  Exact,
    and without `bincount`, which on CUDA reads the ids' range back to the
    host and so stalls every layer of every step."""
    flat = eidx.reshape(-1)
    return torch.zeros(E, dtype=torch.int64, device=eidx.device).scatter_add_(
        0, flat, torch.ones_like(flat))


def balance_loss(eidx: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """The reference's aux, E * sum(frac_tokens * frac_probs): the share of
    tokens whose first choice is each expert, times its mean probability."""
    T, E = probs.shape
    frac_tokens = expert_counts(eidx[:, 0], E).to(torch.float32) / T
    return E * torch.sum(frac_tokens * probs.mean(0))


def fill_slots(eidx: torch.Tensor, gates: torch.Tensor, cap: int, E: int) -> Routes:
    """Sort the assignments by expert (a stable argsort: ties keep token
    order) and rank them within their expert; those ranked past `cap` are
    dropped to slot (E - 1, cap - 1) with gate 0."""
    T, K = eidx.shape
    flat_t = torch.arange(T, device=eidx.device).repeat_interleave(K)
    order = torch.argsort(eidx.reshape(-1), stable=True)
    se, st, sg = eidx.reshape(-1)[order], flat_t[order], gates.reshape(-1)[order]
    counts = expert_counts(se, E)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(T * K, device=eidx.device) - starts[se]
    keep = rank < cap
    return Routes(torch.where(keep, se, E - 1), torch.where(keep, rank, cap - 1), st,
                  torch.where(keep, sg, torch.zeros_like(sg)), order)


def dispatch(xt: torch.Tensor, routes: Routes, E: int, cap: int) -> torch.Tensor:
    """The (E, cap, D) buffer: each kept assignment's token in its slot,
    every other slot 0.  As in the reference, an assignment is kept where its
    gate is > 0, so one ranked within `cap` whose gate is exactly 0 leaves
    its slot 0 too.  Slots are unique among kept assignments; the others are
    written to one spare row past the buffer, which is dropped."""
    D = xt.shape[1]
    slot = routes.slot_e * cap + routes.slot_r
    slot = torch.where(routes.gate > 0, slot, torch.full_like(slot, E * cap))
    buf = torch.zeros((E * cap + 1, D), dtype=xt.dtype, device=xt.device)
    buf.index_copy_(0, slot, xt[routes.token])
    return buf[:-1].view(E, cap, D)


def expert_mlp(buf: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
               wd: torch.Tensor) -> torch.Tensor:
    """silu(buf @ wg) * (buf @ wu) @ wd for every expert, (E, cap, D) ->
    (E, cap, D), in groups of experts whose (cap, F) intermediates stay
    under EXPERT_CHUNK_ELEMS.  Without grad, each group writes its output
    over its own rows of `buf` (read before), which is returned."""
    E, cap, _ = buf.shape
    step = max(1, EXPERT_CHUNK_ELEMS // max(1, cap * wg.shape[2]))
    out = torch.empty_like(buf) if torch.is_grad_enabled() else buf
    for a in range(0, E, step):
        b = min(E, a + step)
        h = F.silu(torch.bmm(buf[a:b], wg[a:b])) * torch.bmm(buf[a:b], wu[a:b])
        out[a:b] = torch.bmm(h, wd[a:b])
    return out


def combine(eo: torch.Tensor, routes: Routes, T: int) -> torch.Tensor:
    """(T, D): each token's K gate-weighted expert outputs, added from 0 in
    the order the sort placed them (by expert), one after another."""
    K = routes.order.numel() // T
    pos = torch.empty_like(routes.order)
    pos[routes.order] = torch.arange(routes.order.numel(), device=pos.device)
    pos = pos.view(T, K).sort(dim=1).values  # a token's assignments in sorted order
    contrib = eo[routes.slot_e[pos], routes.slot_r[pos]] * routes.gate[pos][..., None]
    out = torch.zeros((T, eo.shape[2]), dtype=eo.dtype, device=eo.device)
    for k in range(K):
        out = out + contrib[:, k]
    return out


@contextmanager
def recording(model: nn.Module):
    """Collect what every MoE layer of `model` routes inside the block:
    yields a list to which each layer call appends a `Routed`, in the order
    the layers ran, on their device (no host sync).  Its `dropped` counts
    the assignments with gate 0 after `fill_slots`, which the reference's
    `keep = sg > 0` drops.  Blocks nest; the innermost collects."""
    layers = [m for m in model.modules() if isinstance(m, MoE)]
    log: list = []
    saved = [m.log for m in layers]
    for m in layers:
        m.log = log
    try:
        yield log
    finally:
        for m, prev in zip(layers, saved):
            m.log = prev


class MoE(nn.Module):
    """Parameters as the reference names them: `router` (D, E) float32,
    `e_gate` and `e_up` (E, D, F), `e_down` (E, F, D), and the shared
    expert's `shared.{w_gate, w_up, w_down}` where `shared_expert_ff` > 0.
    `log` is set by `recording`."""

    def __init__(self, cfg: MoEConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.log: list | None = None
        E, D, Fd = cfg.n_experts, cfg.d_model, cfg.d_ff
        self.router = nn.Parameter(torch.empty((D, E), device=device))
        self.e_gate = nn.Parameter(torch.empty((E, D, Fd), device=device))
        self.e_up = nn.Parameter(torch.empty((E, D, Fd), device=device))
        self.e_down = nn.Parameter(torch.empty((E, Fd, D), device=device))
        # the reference's init_mlp(D, shared_expert_ff): gated, and run with
        # mlp_block's default activation, silu, whatever cfg.activation says
        self.shared = (MLP(D, cfg.shared_expert_ff, gated=True, activation="silu",
                           device=device) if cfg.shared_expert_ff else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """dense_init: the router over D, the experts with fan-in on axis 1
        (D for gate and up, F for down)."""
        dense_init_(self.router, generator)
        for w in (self.e_gate, self.e_up, self.e_down):
            dense_init_(w, generator, in_axis=1)
        if self.shared is not None:
            self.shared.reset_parameters(generator)

    def forward(self, x: torch.Tensor):
        """x (B, S, D) -> (out (B, S, D), aux: E * sum(frac_tokens * frac_probs))."""
        mesh = current_mesh()
        if mesh is not None and "model" in mesh_axes(mesh):
            # the reference takes its expert-parallel `_moe_sharded` here
            raise NotImplementedError(
                "MoE under a mesh with a model axis: the expert-parallel _moe_sharded "
                "(shard_map, ZeRO gathers, all-to-all) is not ported yet (ROADMAP A9b)")
        cfg = self.cfg
        B, S, D = x.shape
        T, E = B * S, cfg.n_experts
        cap = capacity(T, cfg)
        xt = x.reshape(T, D)
        gates, eidx, probs = route(xt, self.router, cfg.top_k)
        routes = fill_slots(eidx, gates, cap, E)
        if self.log is not None:
            self.log.append(Routed((routes.gate <= 0).sum(), eidx, probs))
        eo = expert_mlp(dispatch(xt, routes, E, cap), self.e_gate, self.e_up, self.e_down)
        out = combine(eo, routes, T).reshape(B, S, D).to(x.dtype)
        if self.shared is not None:
            out = out + self.shared(x)
        return wlc(out, "batch", "seq", None), balance_loss(eidx, probs)

"""Functional AdamW over a model's named parameters (port of
`repro.optim.adamw`): the moments mirror the parameters' names, the
arithmetic follows the reference op for op (float32 moments whatever
`state_dtype` stores, the bias corrections on the incremented step, the
weight decay inside the update), so that one step of either package moves
the same weights alike.  `torch.optim.AdamW` is not used: it decays before
the update and adds eps after sqrt(v) / sqrt(bc2).

The port updates in place: a full-width model's parameters, gradients and
moments fill most of one card, and a second copy of any of them would not
fit.  `clip_by_global_norm` scales the gradients it is given and
`adamw_update` writes the new parameters and moments into the tensors it
is given; both return them, as the reference returns its new trees."""
from __future__ import annotations

from typing import NamedTuple

import torch


class AdamWState(NamedTuple):
    m: dict[str, torch.Tensor]
    v: dict[str, torch.Tensor]
    step: torch.Tensor  # int32 scalar on the parameters' device


def adamw_init(params: dict[str, torch.Tensor], state_dtype=torch.float32) -> AdamWState:
    """Zero moments of `state_dtype` (bf16 halves their memory) beside each
    named parameter, on its device; step 0."""
    zeros = {name: torch.zeros(p.shape, dtype=state_dtype, device=p.device)
             for name, p in params.items()}
    dev = next(iter(params.values())).device if params else None
    return AdamWState(m=zeros, v={name: torch.zeros_like(z) for name, z in zeros.items()},
                      step=torch.zeros((), dtype=torch.int32, device=dev))


@torch.no_grad()
def clip_by_global_norm(grads: dict[str, torch.Tensor], max_norm: float):
    """Scale the gradients (in place) by min(1, max_norm / max(norm, 1e-9)),
    norm the float32 global L2 norm over every tensor.  Returns (grads,
    norm)."""
    gsq = sum(torch.sum(g.to(torch.float32) ** 2) for g in grads.values())
    gnorm = torch.sqrt(torch.as_tensor(gsq, dtype=torch.float32))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    for g in grads.values():
        g.copy_((g.to(torch.float32) * scale).to(g.dtype))
    return grads, gnorm


@torch.no_grad()
def adamw_update(grads: dict[str, torch.Tensor], state: AdamWState,
                 params: dict[str, torch.Tensor], lr, *, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1):
    """One AdamW step at learning rate `lr` (a float or a float32 scalar
    tensor), each named tensor as the reference's `upd`: m = b1 m + (1 - b1)
    g, v = b2 v + (1 - b2) g^2 in float32, delta = (m / bc1) / (sqrt(v / bc2)
    + eps) + weight_decay p, p -= lr delta, with bc = 1 - b^step at the
    incremented step; the moments are stored back in their dtype.  Writes
    into `params`, `state.m` and `state.v`; returns (params, the new
    AdamWState)."""
    f32 = torch.float32
    step = state.step + 1
    stepf = step.to(f32)
    one = torch.ones((), dtype=f32, device=step.device)
    bc1 = 1 - (one * b1) ** stepf
    bc2 = 1 - (one * b2) ** stepf
    for name, p in params.items():
        g32 = grads[name].to(f32)
        m, v = state.m[name], state.v[name]
        m32 = b1 * m.to(f32) + (1 - b1) * g32
        v32 = b2 * v.to(f32) + (1 - b2) * g32 * g32
        p32 = p.to(f32)
        delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + eps) + weight_decay * p32
        m.copy_(m32)
        v.copy_(v32)
        del m32, v32
        p.copy_(p32 - lr * delta)
    return params, AdamWState(m=state.m, v=state.v, step=step)

"""Train step (port of `repro.train.step`): mixed-precision loss, backward,
global-norm clip, cosine-scheduled AdamW.

The parameters live in float32 (the master copy, the model's own tensors,
trainable); the forward runs in `compute_dtype` (bf16 by default) on cast
copies, through `torch.func.functional_call`, so that the gradient flows
back through the casts to the float32 masters.  Which tensors are cast
follows the reference (`_cast_params`): a float32 leaf of rank >= 2 in the
reference's tree.  The reference stacks a pattern slot's layers, so a
per-layer vector there (a norm scale, a bias, `A_log`, `D`) is 2-D and is
cast, while the same vector of a tail block or of zamba's shared block is
1-D and stays float32: the rule reads the reference leaf's rank
(`models.convert.reference_ndim`), not the port's.  On the card every
attention layer runs the `flash_attn` kernel forward and its backward
kernel (`kernels.flash_attn.ops.FlashAttention`)."""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..models import api
from ..models.convert import reference_ndim
from ..models.lm import LM
from ..models.whisper import Whisper
from ..optim import AdamWState, adamw_init, adamw_update, clip_by_global_norm


class TrainState(NamedTuple):
    """The model (its parameters the float32 masters, trainable) and the
    AdamW state over its named parameters."""
    model: LM | Whisper
    opt: AdamWState


def init_train_state(cfg, seed: int = 0, device=None, *,
                     opt_dtype=torch.float32) -> TrainState:
    """A randomly initialised model (`api.init_model`, seed `seed`) on
    `device` (None = CUDA; raises without it), made trainable, and zero
    AdamW moments of `opt_dtype`."""
    model = api.init_model(cfg, seed, device).train().requires_grad_(True)
    return TrainState(model, adamw_init(dict(model.named_parameters()), opt_dtype))


def cast_names(cfg, model: LM | Whisper) -> set[str]:
    """The parameters the reference's `_cast_params` casts: float32, rank >=
    2 in the reference's tree."""
    ndim = reference_ndim(cfg, model)
    return {name for name, p in model.named_parameters()
            if p.dtype == torch.float32 and ndim[name] >= 2}


class _Loss(nn.Module):
    """`api.loss_fn` as a module's forward, so that `functional_call` can
    run it on substituted parameters (named `model.<name>`)."""

    def __init__(self, model: LM | Whisper):
        super().__init__()
        self.model = model

    def forward(self, batch: dict):
        return api.loss_fn(self.model, batch)


def _split(batch: dict, n: int, size: int) -> list[dict]:
    """The batch's leading axis in n microbatches of `size` rows."""
    return [{k: v[i * size:(i + 1) * size] for k, v in batch.items()} for i in range(n)]


def make_train_step(cfg, lr_fn, *, compute_dtype=torch.bfloat16, clip_norm: float = 1.0,
                    microbatch: int = 0):
    """train_step(state, batch) -> (state, metrics).  `lr_fn(step)` maps the
    AdamW step (before this update) to the learning rate; `microbatch` > 0
    splits the batch's leading axis into B // microbatch pieces whose
    gradients (and losses, and metrics) are averaged, as the reference's
    `lax.scan`; a batch that `microbatch` does not divide raises ValueError
    before any forward, as the reference's reshape does.  The batch is the
    pipeline's dict (numpy arrays or tensors; the loss moves them to the
    model's device).  The state is updated in place (`optim.adamw`);
    metrics are float32 scalar tensors on the device: loss, grad_norm, lr,
    ce, aux."""

    def loss_of(loss_mod, params, cast, batch):
        args = {f"model.{name}": (p.to(compute_dtype) if name in cast else p)
                for name, p in params.items()}
        return torch.func.functional_call(loss_mod, args, (batch,))

    def grads_of(loss_mod, params, cast, batch):
        tensors = list(params.values())
        loss, metrics = loss_of(loss_mod, params, cast, batch)
        grads = torch.autograd.grad(loss, tensors, allow_unused=True)
        grads = {name: torch.zeros_like(p) if g is None else g
                 for (name, p), g in zip(params.items(), grads)}
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(state: TrainState, batch: dict):
        model = state.model
        params = dict(model.named_parameters())
        cast = cast_names(cfg, model)
        loss_mod = _Loss(model)
        if not microbatch:
            loss, metrics, grads = grads_of(loss_mod, params, cast, batch)
        else:
            B = len(batch["tokens"])
            if B % microbatch != 0:
                raise ValueError(f"train_step: a batch of {B} rows does not split into "
                                 f"microbatches of {microbatch}")
            n_micro = B // microbatch
            grads = {name: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for name, p in params.items()}
            loss, ms = 0.0, []
            for mb in _split(batch, n_micro, microbatch):
                l_mb, m_mb, g_mb = grads_of(loss_mod, params, cast, mb)
                for name, g in g_mb.items():
                    grads[name] += g
                del g_mb
                loss = loss + l_mb
                ms.append(m_mb)
            for g in grads.values():
                g /= n_micro
            loss = loss / n_micro
            metrics = {k: torch.mean(torch.stack([m[k] for m in ms])) for k in ms[0]}
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        lr = torch.as_tensor(lr_fn(state.opt.step), dtype=torch.float32)
        _, opt = adamw_update(grads, state.opt, params, lr.to(gnorm.device))
        del grads
        out = {"loss": loss.to(torch.float32), "grad_norm": gnorm, "lr": lr,
               **{k: torch.as_tensor(v).to(torch.float32) for k, v in metrics.items()}}
        return TrainState(model, opt), out

    return train_step

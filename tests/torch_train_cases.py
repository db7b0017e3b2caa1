"""Shared pieces of the CPU training parity tests (tests/test_torch_train*.py,
tests/test_torch_checkpoint.py): the reference's train state carried into the
port, batches from a numpy seed, and the comparison of two train states by
the reference's tree.  Imports JAX and the reference package: CPU tests only."""
import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import ARCHS as REF_ARCHS
from repro.data import lm_token_batches as ref_batches
from repro.train import init_train_state as ref_init_train_state
from repro.train import make_train_step as ref_make_train_step
from repro_torch.configs import ARCHS
from repro_torch.models.convert import train_state_from_reference, train_state_to_reference

# the archs whose one fp32 train step is held to the reference's
TRAIN_ARCHS = ("gemma-2b", "gemma2-9b", "qwen3-moe-235b-a22b", "zamba2-7b", "falcon-mamba-7b",
               "whisper-tiny")
# after one step at lr 1e-3: the reference's own microbatch test's bound
PARAM_ATOL = 5e-4


def configs(arch: str):
    """(the reference's smoke config, the port's)."""
    return REF_ARCHS[arch].smoke(), ARCHS[arch].smoke()


def batch(cfg, B: int = 4, S: int = 16, seed: int = 0, step: int = 0) -> dict:
    """The pipeline's batch at `step` (tokens, labels, a mask with one row
    dropped); whisper's with frames (B, n_audio_frames, d_model) N(0, 1)."""
    toks, labels = ref_batches(cfg.vocab, seed=seed)(step, B, S)
    mask = np.ones(toks.shape, np.float32)
    mask[-1] = 0.0
    out = {"tokens": toks, "labels": labels, "mask": mask}
    if cfg.enc_dec:
        rng = np.random.default_rng(seed + 100 * step)
        out["frames"] = rng.normal(size=(B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    return out


def ref_state(ref_cfg, seed: int = 0):
    return ref_init_train_state(jax.random.key(seed), ref_cfg)


def ref_step(ref_cfg, state, b, lr=1e-3, **kw):
    step = jax.jit(ref_make_train_step(ref_cfg, lambda s: lr, **kw))
    new, metrics = step(state, {k: jnp.asarray(v) for k, v in b.items()})
    return new, {k: float(v) for k, v in metrics.items()}


def to_port(cfg, state):
    """The reference's train state as the port's, on the CPU."""
    return train_state_from_reference(cfg, jax.tree.map(np.asarray, state), "cpu")


def leaves(state) -> list[np.ndarray]:
    """A train state's leaves in the reference's flatten order (params, m,
    v, step), from either package's state."""
    if isinstance(state, tuple) and hasattr(state[0], "named_parameters"):
        state = train_state_to_reference(state)
    return [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(
        jax.tree.map(np.asarray, state))]

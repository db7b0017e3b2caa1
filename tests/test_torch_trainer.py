"""The port's fault-tolerant trainer (`repro_torch.train.trainer`) on the
CPU: a run preempted at step 6 and resumed to 12 bit-follows an
uninterrupted one (the reference's own schedule and tolerance, rel 1e-4,
at steps 9 and 12); a checkpoint written mid-run by the async path
restores; the history of a run from the reference's initial state (its
checkpoint at step 0, restored by both) follows the reference `Trainer`'s
-- bf16 compute in both, so the loss within rel 1e-4 and the grad norm
within rel 5e-3 (each rounds to bf16 at other places), the learning rate
within rel 1e-6 (float32 cosine)."""
import numpy as np
import pytest
import torch
from torch_train_cases import configs, ref_state

from repro.checkpoint import CheckpointManager as RefManager
from repro.data import DataPipeline as RefPipeline
from repro.data import lm_token_batches as ref_batches
from repro.train.trainer import Trainer as RefTrainer
from repro.train.trainer import TrainerConfig as RefTrainerConfig
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import DataPipeline, lm_token_batches
from repro_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(2)


def _trainer(cfg, steps, d, **kw):
    pipe = DataPipeline(lm_token_batches(cfg.vocab, seed=1), global_batch=4, seq_len=16)
    return Trainer(cfg, pipe, TrainerConfig(steps=steps, total_steps=12, ckpt_every=3,
                                            ckpt_dir=str(d), log_every=3, warmup=2, **kw),
                   device="cpu")


def test_trainer_resumes_after_preemption(tmp_path):
    _, cfg = configs("gemma-2b")
    r1 = _trainer(cfg, 6, tmp_path / "a").run()
    assert r1["final_step"] == 6 and not r1["preempted"]
    assert CheckpointManager(tmp_path / "a").steps() == [3, 6]
    r2 = _trainer(cfg, 12, tmp_path / "a").run()  # the same dir: resumes at 6
    assert r2["final_step"] == 12
    r3 = _trainer(cfg, 12, tmp_path / "b").run()  # uninterrupted
    h2 = {h["step"]: h["loss"] for h in r2["history"]}
    h3 = {h["step"]: h["loss"] for h in r3["history"]}
    for s in (9, 12):
        assert h2[s] == pytest.approx(h3[s], rel=1e-4), (s, h2[s], h3[s])
    assert np.isfinite(r3["final_loss"]) and r3["final_loss"] < r3["history"][0]["loss"]
    assert CheckpointManager(tmp_path / "b").steps() == [6, 9, 12]  # keep 3


def test_trainer_history_follows_the_reference_trainer(tmp_path):
    ref_cfg, cfg = configs("gemma-2b")
    for sub in ("ref", "port"):  # both start from the reference's initial state
        RefManager(tmp_path / sub).save(0, ref_state(ref_cfg), extra={"data": {"step": 0}})
    kw = dict(steps=12, total_steps=12, ckpt_every=100, log_every=3, warmup=2)
    ref = RefTrainer(ref_cfg, RefPipeline(ref_batches(ref_cfg.vocab, seed=1), global_batch=4,
                                          seq_len=16),
                     RefTrainerConfig(ckpt_dir=str(tmp_path / "ref"), **kw)).run()
    mine = Trainer(cfg, DataPipeline(lm_token_batches(cfg.vocab, seed=1), global_batch=4,
                                     seq_len=16),
                   TrainerConfig(ckpt_dir=str(tmp_path / "port"), **kw), device="cpu").run()
    assert [h["step"] for h in mine["history"]] == [h["step"] for h in ref["history"]]
    for a, b in zip(mine["history"], ref["history"]):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-4), a["step"]
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=5e-3), a["step"]
        assert a["lr"] == pytest.approx(b["lr"], rel=1e-6), a["step"]
    assert set(mine) == set(ref)

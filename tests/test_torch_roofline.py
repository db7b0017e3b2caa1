"""The port's roofline counting (`repro_torch.launch.roofline`) against the
reference's (`repro.launch.roofline`) and against torch's own counters, on
the CPU:

  * `model_flops` equals the reference's for every architecture and shape
    cell (the port's parameters on the meta device);
  * `OpCounter`'s aten FLOPs over a smoke train step equal
    `FlopCounterMode`'s on the same step, for five families; the dry run's
    on a 1x1 fake mesh equal FlopCounterMode's over the real step of a
    Mamba-1 model (whose scan has no plain product on the CPU);
  * the collective conventions equal `_collective_bytes` for each kind;
  * a kernel's unmasked pairs equal its mask's (`flash_attn.attn_mask`);
  * the live-bytes tracker's peak, and the three-term bound."""
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.launch import roofline as ref_rf
from repro_torch.configs import ARCHS, SHAPES, ShapeCell
from repro_torch.kernels.flash_attn import attn_mask
from repro_torch.launch import roofline as rf
from repro_torch.train import init_train_state, make_train_step

torch.set_num_threads(2)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_flops_equal_reference(arch):
    for shape in SHAPES:
        assert rf.model_flops(ARCHS[arch], SHAPES[shape]) == \
            ref_rf.model_flops(REF_ARCHS[arch], REF_SHAPES[shape]), shape


def _batch(cfg, B: int = 4, S: int = 16) -> dict:
    rng = np.random.default_rng(0)
    b = {k: rng.integers(0, cfg.vocab, (B, S)).astype(np.int32) for k in ("tokens", "labels")}
    if cfg.enc_dec:
        b["frames"] = rng.normal(size=(B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    if cfg.vlm:
        b["tokens"] = b["tokens"][:, :S - cfg.n_patches]
        b["patch_embeds"] = rng.normal(size=(B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return b


@pytest.mark.parametrize("arch", ["gemma-2b", "falcon-mamba-7b", "zamba2-7b", "whisper-tiny",
                                  "qwen2-vl-7b"])
def test_counter_flops_equal_flop_counter_mode(arch):
    cfg = dataclasses.replace(ARCHS[arch].smoke(), remat=True)
    b = _batch(cfg)
    state = init_train_state(cfg, 0, "cpu")
    step = make_train_step(cfg, lambda s: 1e-3)
    with FlopCounterMode(display=False) as fc:
        step(state, b)
    counter = rf.OpCounter()
    with counter:
        step(state, b)
    assert counter.aten_flops() == fc.get_total_flops() > 0
    assert counter.peak_bytes > 0 and counter.launches == {}


def test_dry_run_flops_equal_a_real_cpu_step():
    import torch.distributed as dist

    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.launch.mesh import make_fake_mesh, release_fake_group

    cfg = dataclasses.replace(ARCHS["falcon-mamba-7b"].smoke(), remat=True)
    cell = ShapeCell("train_s", 16, 4, "train")
    with FlopCounterMode(display=False) as fc:
        make_train_step(cfg, lambda s: 1e-3)(init_train_state(cfg, 0, "cpu"), _batch(cfg))
    assert not dist.is_initialized()
    try:
        rec = lower_cell("falcon-mamba-7b", cell, mesh=make_fake_mesh((1, 1), ("data", "model")),
                         cfg=cfg)
    finally:
        release_fake_group()
    assert rec["aten_flops_per_device"] == fc.get_total_flops() > 0
    assert rec["kernel_launches"] == {"ssm_scan": 2 * cfg.n_layers,
                                      "ssm_scan_bwd": cfg.n_layers}


@pytest.mark.parametrize("kind", ["all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                                  "collective-permute"])
def test_collective_conventions_equal_reference(kind):
    for out_elems, in_bytes in ((1024, 256.0), (4096, 16384.0), (7, 3.0)):
        assert rf.collective_bytes(kind, 4 * out_elems, in_bytes) == \
            ref_rf._collective_bytes(kind, f"f32[{out_elems}]", in_bytes)


@pytest.mark.parametrize("Sq,Skv,causal,window", [(64, 64, True, 0), (16, 80, True, 0),
                                                  (64, 64, True, 8), (1, 700, True, 512),
                                                  (33, 90, False, 0), (48, 48, True, 100),
                                                  (20, 50, False, 16), (60, 40, True, 0)])
def test_unmasked_pairs_equal_the_mask(Sq, Skv, causal, window):
    mask = attn_mask(Sq, Skv, causal=causal, window=window, device="cpu")
    assert rf.unmasked_pairs(Sq, Skv, causal, window) == int(mask.sum())


def test_kernel_costs():
    fwd = rf.kernel_cost("flash_attn", B=2, Sq=8, Skv=8, Hq=4, Hkv=1, dh=16, causal=True,
                         window=0)
    pairs = 2 * 4 * 36
    assert fwd == {"flops": {"tf32x3": 4 * 16 * pairs}, "exps": pairs,
                   "bytes": 4 * (2 * 2 * 8 * 4 * 16 + 2 * 2 * 8 * 1 * 16)}
    bwd = rf.kernel_cost("flash_attn_bwd_bf16", B=2, Sq=8, Skv=8, Hq=4, Hkv=1, dh=16,
                         causal=True, window=0)
    assert bwd["flops"] == {"tf32x3": 6 * 16 * pairs, "bf16": 4 * 16 * pairs}
    f32 = rf.kernel_cost("ssm_scan", B=2, L=64, D=32, N=16)
    bf16 = rf.kernel_cost("ssm_scan_bf16", B=2, L=64, D=32, N=16)
    assert f32["bytes"] - bf16["bytes"] == 2 * (2 * 2 * 64 * 32 + 2 * 2 * 64 * 16)
    ck = rf.kernel_cost("ssm_scan", B=2, L=64, D=32, N=16, ckpt_tiles=2)
    assert ck["bytes"] - f32["bytes"] == 4 * 2 * 2 * 32 * 16
    with pytest.raises(KeyError):
        rf.kernel_cost("hash_rp")


def test_live_bytes_peak():
    counter = rf.OpCounter()
    x = torch.ones(1000)
    counter.exclude([x])
    with counter:
        y = x * 2  # 4,000 bytes
        z = y + 1  # 8,000 live
        del y
        w = z * 3  # 8,000 live again
        x.add_(1)  # an argument, updated in place: nothing new
    assert counter.peak_bytes == 8000 and counter.live == 8000
    del z, w
    assert counter.live == 0
    assert counter.ops["aten.mul"]["calls"] == 2
    assert counter.ops["aten.mul"]["bytes"] == 2 * 8000


def test_roofline_terms_pick_the_largest():
    t = rf.roofline_terms({"compute_s": 1.0, "hlo_bytes_per_device": 2 * rf.HBM_BYTES_PER_S,
                           "collective_s": 0.5})
    assert t["bottleneck"] == "memory" and t["roofline_bound_s"] == 2.0
    assert t["compute_fraction_of_bound"] == 0.5

"""The port's dry run (`repro_torch.launch.dryrun`) and its tables
(`launch.report`), on the CPU (meta tensors on a fake process group: no
allocation, no launch):

  * `lower_cell` on a smoke config of each family (dense, Mamba-1, the
    Mamba-2 hybrid, the VLM, the encoder-decoder, MoE) for a train, a
    prefill and a decode cell, on a (2, 4) and a 1x1 fake mesh: `ok`, or
    `not_ported` for the MoE (A9b), never `error`; its argument bytes equal
    the local shards' sum from the specs (`argument_bytes`); its kernel
    launches those the step makes (the forward twice a layer under the
    recompute);
  * a production cell that does not apply is `skipped` with the reference's
    reason, an MoE cell `not_ported`;
  * the CLI on one production cell of each mesh, and `report` on its
    output."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import ARCHS, ShapeCell
from repro_torch.launch import dryrun, report
from repro_torch.launch.mesh import make_fake_mesh, release_fake_group

torch.set_num_threads(2)

FAMILIES = ("gemma-2b", "falcon-mamba-7b", "zamba2-7b", "qwen2-vl-7b", "whisper-tiny",
            "qwen3-moe-235b-a22b")
CELLS = (ShapeCell("train_s", 32, 8, "train"), ShapeCell("prefill_s", 32, 8, "prefill"),
         ShapeCell("decode_s", 32, 8, "decode"))
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", params=[(2, 4), (1, 1)], ids=["2x4", "1x1"])
def mesh(request):
    import torch.distributed as dist

    assert not dist.is_initialized()
    yield make_fake_mesh(request.param, ("data", "model"))
    release_fake_group()


def _smoke(arch: str, remat: bool):
    return dataclasses.replace(ARCHS[arch].smoke(), remat=remat)


def _want_launches(cfg, kind: str) -> dict:
    from repro_torch.models.blocks import ATTN_KINDS
    from repro_torch.models.lm import layer_kinds

    if cfg.enc_dec:
        n_dec = cfg.n_layers - cfg.n_enc_layers
        fwd = {"flash_attn": 2 * n_dec + (cfg.n_enc_layers if kind != "decode" else 0)}
    else:
        kinds = layer_kinds(cfg)
        fwd = {"flash_attn": sum(k in ATTN_KINDS for k in kinds), "ssm_scan": kinds.count("m1")}
    fwd = {k: v for k, v in fwd.items() if v}
    if kind != "train":
        return fwd
    out = dict(fwd)
    if cfg.remat and not cfg.enc_dec:
        rep = layer_kinds(cfg)[:cfg.repeats * len(cfg.pattern)]
        extra = {"flash_attn": sum(k in ATTN_KINDS for k in rep), "ssm_scan": rep.count("m1")}
        out = {k: v + extra[k] for k, v in out.items()}
    out.update({f"{k}_bwd": v for k, v in fwd.items()})
    return out


@pytest.mark.parametrize("arch", FAMILIES)
def test_lower_cell_each_family(mesh, arch):
    for cell in CELLS:
        cfg = _smoke(arch, remat=cell.kind == "train")
        rec = dryrun.lower_cell(arch, cell, mesh=mesh, cfg=cfg)
        if cfg.n_experts:
            assert rec["status"] == "not_ported" and "A9b" in rec["reason"]
            continue
        assert rec["status"] == "ok", rec
        assert rec["memory_analysis"]["argument_size_in_bytes"] == \
            dryrun.argument_bytes(cfg, cell, mesh), (arch, cell.kind)
        assert rec["memory_analysis"]["temp_size_in_bytes"] > 0
        assert rec["kernel_launches"] == _want_launches(cfg, cell.kind), (arch, cell.kind)
        r = rec["roofline"]
        assert r["roofline_bound_s"] == max(r["compute_s"], r["memory_s"], r["collective_s"]) > 0
        if mesh.size() == 1:
            assert rec["collective_bytes_per_device"] == 0
        if cell.kind == "train":
            assert rec["memory_analysis"]["alias_size_in_bytes"] > 0


def test_production_cells_skipped_and_not_ported():
    rec = dryrun.lower_cell("gemma-2b", "long_500k")
    assert rec["status"] == "skipped"
    assert rec["reason"] == "long_500k skipped: full-attention arch (DESIGN.md §4)"
    rec = dryrun.lower_cell("llama4-maverick-400b-a17b", "train_4k", multi_pod=True)
    assert rec["status"] == "not_ported" and rec["mesh"] == "pod2x16x16"


def test_cli_and_report(tmp_path):
    out = tmp_path / "dryrun.jsonl"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                          "falcon-mamba-7b", "--shape", "long_500k", "--both-meshes", "--out",
                          str(out)], capture_output=True, text=True, env=env, timeout=600)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-2000:]
    rows = report.load([out])
    assert {r["status"] for r in rows.values()} == {"ok"}
    assert set(m for _, _, m in rows) == {"16x16", "pod2x16x16"}
    for r in rows.values():
        assert r["n_chips"] in (256, 512)
        assert set(r["memory_analysis"]) >= {"argument_size_in_bytes", "temp_size_in_bytes",
                                              "output_size_in_bytes"}
        json.dumps(r)
    table = report.table(rows, "16x16")
    assert "| falcon-mamba-7b | long_500k |" in table
    assert report.summary(rows) == {"ok": 2, "skipped": 0, "not_ported": 0, "error": 0,
                                    "total": 2}
    assert report.compact(rows).count("| falcon-mamba-7b | long_500k |") == 1


def test_report_renders_every_status():
    rows = {("a", "train_4k", "16x16"): {"status": "skipped", "reason": "r"},
            ("b", "train_4k", "16x16"): {"status": "not_ported", "reason": "A9b"},
            ("c", "train_4k", "16x16"): {"status": "error", "error": "x"},
            ("d", "train_4k", "16x16"): {
                "status": "ok", "useful_flops_ratio": 0.5,
                "memory_analysis": {"argument_size_in_bytes": 60e9, "temp_size_in_bytes": 30e9},
                "roofline": {"compute_s": 1.0, "memory_s": 2.0, "collective_s": 0.5,
                             "bottleneck": "memory"}}}
    table = report.table(rows, "16x16")
    assert "| a | train_4k | - | - | - | skipped |" in table
    assert "| b | train_4k | - | - | - | not_ported |" in table
    assert "ERROR" in table
    assert "90.0GB!" in table  # above the card's 80 GB
    assert report.summary(rows)["error"] == 1
    compact = report.compact(rows, meshes=("16x16",))
    assert "| d | train_4k | 1.000 / 2.000 / 0.500, memory, 90.0GB! |" in compact
    assert "a x train_4k (skipped)" in compact and "c x train_4k (error)" in compact

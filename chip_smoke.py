"""On-card smoke run of the PyTorch/CUDA port (`src/repro_torch`).

    python3 chip_smoke.py

Drives the port's paths on one NVIDIA card at the paper's SIFT size
(n = 1,000,000, d = 128, m = 64; clustered synthetic data):

  * the main path (Euclidean family at w = 16): LCCSIndex.build on the card,
    then LCCSIndex.search of 10,000 queries in batches of 1,000 through the
    "lccs" and "multiprobe-skip" sources (fp32 store) and the two-stage int8
    store;
  * the angular path (the paper's sift-angular: normalised rows, the
    gaussian cross-polytope family): build + "lccs" search;
  * the paper's comparison set (phase 8b, `repro_torch.baselines`) beside
    LCCS on the first 1,000 queries of both paths, reusing their corpora
    (checked equal to `paper_dataset_analogue`), exact kNN and indexes:
    benchmarks/fig4_5_recall.py's grid (LCCS at lam 20-400, MP-LCCS at
    probes 9 and 33, E2LSH, MultiProbeLSH, C2LSH, FALCONN-like on the
    angular path, LinearScan), one line a point (QPS, recall@10, overall
    ratio, build seconds, index bytes, candidates, launches), a summary
    line, a theory line, and each baseline on the card against its CPU
    build at n 20,000;
  * the dynamic path (SegmentedLCCSIndex, the main path's family): a bulk
    load into one segment, a stream of inserts into the delta buffer,
    deletes from both, search, a size-tiered compaction, search again;
  * the "bruteforce" source on the main fp32 index (it and the dynamic
    path's delta buffer rank through the circrun_topk kernels);
  * the out-of-core build (phase `out_of_core`): the main corpus from its
    host rows in four chunks of 262,144 (`LCCSIndex.build(chunk_rows=)`,
    int8, the fp32 tail streamed to disk): its tables equal the monolithic
    build's, its store the int8 index's, its `lccs` ids the int8 index's;
    its build seconds split by span and its peak device memory beside the
    monolithic int8 build's; and the dynamic path's bulk rows through
    `SegmentedLCCSIndex.ingest_chunks` (phase `ingest_chunks`), its segment
    equal to the bulk load's;
  * the sharded topology (phase `sharded`): the main fp32 and int8
    indexes in 4 and 3 row shards on the card (`LCCSIndex.shard`), the
    "lccs" and "multiprobe-skip" searches through each, every shard's probe
    and verify on the kernels; at n 4,000 (`sharded_small`) the sharded
    search equals the monolithic one under complete coverage and the
    card's equals the CPU's;
  * the retrieval serving path (RetrievalEngine, as `repro_torch.launch.serve`
    drives it) with two embedding models at full width and depth, random
    weights from seed 0: gemma-2b (18 attention layers, the flash_attn
    kernel) over 4,096 documents of 32 tokens and 256 requests, and
    falcon-mamba-7b (64 Mamba-1 layers, the ssm_scan kernel) over 1,024
    documents and 128 requests; each static, then as a dynamic stream with
    an insert / delete / compact burst; gemma-2b's corpus also built out of
    core (bit for bit the static index) and served from 2 shards, and one
    CLI run with `--shards 2 --build-chunk-rows 64` (`serve_shards_cli`);
  * gemma-2b's static index behind the async serving front (phase
    `serve_async`, `launch.serve --async`'s own `_serve_async` and
    `_obs_epilogue`): 256 requests submitted at once to two replicas that
    share the model and the index, a 500 ms SLO, a /metrics scrape while
    they are served and the recall-drift probe after; the answers held to
    `serve_batch`'s, no plan built or evicted after warm-up, and the same
    requests through instrumented plans bit for bit against the fused ones,
    with the stage histogram's per-stage medians; then one run of the CLI
    with every flag of the async front on a smoke model
    (`serve_async_cli`);
  * the same smoke-size models on the card and on the CPU;
  * the LM's loss, prefill and decode (phase `lm_decode`): qwen2-7b (7 of
    its 28 attention layers, GQA 28/4, dh 128), gemma3-1b (26 layers, 5:1
    local:global at window 512, MQA, dh 256), falcon-mamba-7b (64
    Mamba-1 layers) and zamba2-7b (81 layers: 68 Mamba-2, plain torch, and
    one shared attention block of 32 heads of 112 applied at 13 places) at
    full width, one at a time, random weights
    from seed 0: `loss_fn` over a 640-token prompt at batch 4, `prefill`,
    then 64 greedy `decode_step`s against the bf16 KV caches and the
    Mamba-1 and Mamba-2 states, every pass launching flash_attn once an
    attention layer or a place of the shared block, ssm_scan once a
    Mamba-1 layer, and nothing else (counted, and no plain version may
    run); the decode logits held to unembed(forward) over the
    same tokens (DECODE_VS_FORWARD_TOL), one decode step profiled
    (`profile_decode_step`); before them the smoke-size models (with
    gemma2-9b's softcaps, and the MoE models with their expert choices
    compared) on the card against the CPU (`lm_decode_vs_cpu`);
  * the MoE FFN (phase `lm_moe`): qwen3-moe-235b-a22b (128 experts, top 8,
    GQA 64/4) at 4 layers and llama4-maverick-400b-a17b (128 experts, top
    1, a dense layer, a shared expert, GQA 40/8) at 2, full width, one at a
    time, as lm_decode runs its models, with the dropped assignments
    counted in the loss's forward and over the decode steps and the peak
    memory beside a reckoning of weights, logits and dispatch buffer; the
    decode-vs-forward gate at capacity_factor E / K (nothing dropped), with
    the forward's expert choices replayed in decode so that every position
    compares, and the router's perturbation (`moe_replay_gap`,
    MOE_ROUTE_TOL);
  * the VLM and the encoder-decoder (phase `lm_multimodal`): qwen2-vl-7b
    (28 layers, GQA 28/4, dh 128, M-RoPE) over 256 patch embeddings spliced
    ahead of the 640-token prompt, and whisper-tiny (4 encoder layers over
    1,500 frame embeddings, 4 decoder layers with cross attention, 6 heads
    of 64) under the 640-token decoder prompt, at full width and depth, one
    at a time, as lm_decode runs its models: flash_attn once a layer a pass
    and a step for the VLM; for whisper once an encoder layer and twice a
    decoder layer a pass, twice a decoder layer a step (the encoder's and
    the cross attention not causal, Sq != Skv); decode against the full
    forward (the VLM's over the spliced sequence, whisper's
    decode_train(encode(frames))) within DECODE_VS_FORWARD_TOL;
  * training (phases `train_full`, `profile_train_step`, `train_mamba`,
    `profile_train_mamba_step`, `train_smoke_vs_cpu`, `train_resume`):
    gemma-2b at full width and depth (18 layers, 2.506 B parameters, seed 0)
    takes 10 steps
    of the port's train step (bf16 compute over float32 masters, clip,
    cosine-scheduled AdamW with float32 moments) on the train launcher's
    batches (8 x 64 tokens) through `DataPipeline` and the LCCS near-dup
    filter (its history check on the circrun kernels), every attention
    layer launching the flash_attn forward (with its log-sum-exp) and the
    hand-written flash_attn backward once a step: losses finite and
    falling, launches exact, peak memory beside the state's bytes, one step
    profiled; then falcon-mamba-7b the same at full width, 24 of its 64
    Mamba-1 layers (2.79 B parameters: the full depth's state does not fit
    one card), every layer launching the ssm_scan forward (with its tiles'
    checkpoints) and the hand-written ssm_scan backward once a step; the
    smoke gemma-2b, qwen3-moe, whisper-tiny and falcon-mamba-7b on the card
    against the CPU for 3 steps; the Trainer resumed at step 6 against an
    uninterrupted run, then `launch.train --ckpt-dir D` and `launch.serve
    --ckpt-dir D` (restores the trained step);
  * the models' bf16 activation knobs (phase `bf16_knobs`): gemma-2b served
    with attn_bf16_probs and falcon-mamba-7b with ssm_bf16_acts, each on the
    weights its serving phase built (top-1 self-retrieval equal to the
    knob-off run's, the bf16 form once a layer and batch, the float32 form
    never); one training step of gemma-2b (18 layers) and of falcon-mamba-7b
    (24 layers) with the knob on the states of train_full / train_mamba
    (loss finite; gemma-2b's within KNOB_LOSS_REL_TOL of the knob-off loss
    and not equal to it, falcon-mamba-7b's equal to it; one bf16 forward and
    one bf16 backward launch a layer, nothing else); the four bf16 forms
    against their plain versions (ssm_scan / ssm_scan_bwd bit for bit the
    float32 forms on the widened inputs, flash_attn / flash_attn_bwd by
    knob_gap_check: the mean gap from the plain mirror of their own
    roundings within KNOB_MIRROR_FACTOR of the knob's mean gap) at the
    paths' shapes, each timed beside its float32 form; a mixed bf16 scan
    refused.

Each search QPS of the index paths is the median of QPS_PASSES passes over
its queries, with the passes' min, max and spread beside it (C10).

It builds the CUDA kernels from the sources in the checkout, shows through
their launch counts (reset before each path, read after it) that each path
went through its kernels, holds each kernel against its plain PyTorch
version on the card at the paths' shapes (csa_probe also on probes that
land at pos 0 and pos n, and timed on the multiprobe-skip pairs worklist
beside the lccs one; flash_attn and ssm_scan also at long shapes (flash_attn
at B 4, S 2048 with gemma2-9b's heads, causal and with window 1024 + softcap
50, and at B 1, S 4096 with gemma-2b's; ssm_scan at B 4, L 2048 and B 1,
L 4096; both also at the last decode step's shapes of phases lm_decode and
lm_moe, flash_attn also at the prefill shapes of lm_moe (GQA groups 16 and 5),
of zamba2-7b (dh 112, G 1), of qwen2-vl-7b (S 896) and whisper-tiny's three,
not causal at dh 64 over 1,500 keys among them, and at its cross-attention
decode, Sq 1 over the 1,500 frames; flash_attn_bwd at gemma-2b's training
shape, the long causal shape, gemma2-9b's window with softcap, whisper's
cross attention and rows that see no key, beside SDPA's float32 backward,
bit for bit from one run to the next; ssm_scan_bwd at falcon-mamba-7b's
training shape and at the forward's two long shapes, bit for bit from one
run to the next, the forward's outputs bit for bit with and without its
checkpoints),
hash_rp and hash_xp also at the GIST width d = 960 and over one query batch, pool_topk also at a multiprobe-skip pool of
several tiles and at the serving pool (each with its device time and a
`pool_stats` line: the cut lcp and the ids and entries at or above it) and
against the scatter-max dedupe, which no card path may call; circrun_topk also against the parent's route, circrun + the int64-key
top-k, which no card path may take; the fused verify, gather_l2_topk and
gather_q_topk, bit for bit against the parent's route, the scan kernel +
the plain epilogue and stable sort, which no card path's exact_topk or
survivors may take either),
and times both beside each kernel's bound and, where one PyTorch call
computes the same function, that call (of_bound, vs_library).  Device times
(`device_ms`, torch.profiler) count only profiler sessions that saw every
kernel they expected (`device_launches_seen`); three short sessions fail the
run.  Phase 7
also reruns each device's verify of its small input 20 times
(`verify_repeats`): the card's reruns must all equal its first.

Each phase prints one JSON line; any failure exits non-zero.  The last line
is {"ok": true, "device": {...}}.  Without CUDA, or without the rest of the
repository beside it, the script fails before printing a result.
"""
from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import warnings
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

N, D, M, W_BUCKET = 1_000_000, 128, 64, 16.0
N_QUERIES, BATCH, K = 10_000, 1_000, 10
# each search QPS of the index paths is the median of this many passes over
# its queries, with the passes' spread beside it: one pass read >= 40 %
# apart between runs of unchanged code (ROADMAP C10)
QPS_PASSES = 5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (published)
L2_BYTES = 50 * 2**20  # H100 SXM L2 cache (published)
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores (published)
TF32_FLOPS = 495e12  # H100 SXM TF32 on the tensor cores, dense (NVIDIA H100 data sheet)
# H100 SXM int32 outside the tensor cores: 132 SMs x 64 INT32 lanes (Hopper
# architecture white paper) x 1.98 GHz boost clock, one operation a lane
INT32_OPS = 132 * 64 * 1.98e9
BF16_FLOPS = 989e12  # H100 SXM bf16 on the tensor cores, dense (NVIDIA H100 data sheet)
# H100 SXM exps: 16 exp2 results a clock an SM on the special-function units
# (CUDA C++ Programming Guide, arithmetic instruction throughput table,
# compute capability 9.0) x 132 SMs x 1.98 GHz boost clock
SFU_EXP_PER_S = 132 * 16 * 1.98e9
# the dynamic path: a bulk load of the first rows into one segment (padded to
# 2^20), then the rest streamed in inserts of 2^14 rows (a 2^16 buffer)
N_BULK, INSERT_ROWS, N_DELETE = 934_464, 16_384, 10_000
# the kernels of each path: each must launch at least once in its run
MAIN_KERNELS = ("csa_probe", "pool_topk", "gather_l2_topk", "gather_q_topk", "hash_rp")
ANGULAR_KERNELS = ("hash_xp", "csa_probe", "pool_topk", "gather_l2_topk")
DYNAMIC_KERNELS = ("hash_rp", "csa_probe", "pool_topk", "circrun", "circrun_topk",
                   "gather_l2_topk")
# the bruteforce source and the delta buffer: the circrun scorer and the select
# kernel behind it
CIRCRUN_KERNELS = ("circrun", "circrun_topk")
# a hash may differ between kernel and plain version (another summation
# order) only where the float64 value lies within this relative distance of
# a bucket boundary (hash_rp) or of a tie between vertices (hash_xp), and in
# at most this share of the outputs
HASH_BOUNDARY_RTOL, HASH_MAX_SHARE = 1e-5, 1e-4
# the hashes' wide shapes in phase 12: the paper's GIST width, 2^18 rows for
# hash_rp (the angular path's 65,536 for hash_xp)
WIDE_D, WIDE_RP_ROWS = 960, 1 << 18
LCCS = dict(k=K, lam=100, width=100, source="lccs")
SKIP = dict(k=K, lam=200, width=64, source="multiprobe-skip", probes=17)
GATHER_TOL = dict(rtol=1e-5, atol=1e-5)  # fp32 summation order
# phase out_of_core: cell 1's corpus built out of core in chunks of this many
# rows (four chunks, so the cross-chunk merge runs); phase 9's ingest_chunks
# of the bulk rows takes the same chunks
OOC_CHUNK = 262_144
# phase sharded: the shard counts on cell 1's indexes (3: an uneven split),
# and the small exactness / card-vs-CPU checks' corpus size
SHARD_COUNTS, SHARD_SMALL_N = (4, 3), 4_000
# the serving path: (arch, corpus documents, requests), documents of 32
# tokens, an angular index of m = 32 (the CLI's defaults), batches of 32
SERVE = (("gemma-2b", 4096, 256), ("falcon-mamba-7b", 1024, 128))
SERVE_TOKENS, SERVE_M, SERVE_BATCH = 32, 32, 32
SERVE_KERNEL = {"gemma-2b": "flash_attn", "falcon-mamba-7b": "ssm_scan"}
SMALL_SERVE_DOCS = 256
# gemma-2b's corpus built again on the engine: out of core in chunks of this
# many rows, and as this many shards
SERVE_CHUNK_ROWS, SERVE_SHARDS = 1024, 2
# one run of the CLI with both flags on a smoke model
SHARDS_CLI = ("--smoke", "--corpus", "256", "--requests", "64", "--shards", "2",
              "--build-chunk-rows", "64")
# phase serve_async, on gemma-2b's static index: the serving CLI's --async
# front as `launch.serve` drives it (its defaults: all requests submitted at
# once, a 500 ms SLO), two replicas, a /metrics scrape and the drift probe
ASYNC_ARGS = ("--async", "--replicas", "2", "--slo-ms", "500", "--queue-depth", "256",
              "--metrics-port", "0", "--drift-probe", "64")
# one run of the CLI itself with every flag of the async front (smoke model)
ASYNC_CLI = ("--smoke", "--async", "--replicas", "2", "--instrument", "--metrics-port", "0",
             "--drift-probe", "16", "--slo-ms", "500", "--queue-depth", "256",
             "--stats-interval", "1")
# the spans a traced async run must hold
ASYNC_SPANS = {"router.submit", "queue_wait", "serve_batch", "embed", "search",
               "exec.hash_queries", "exec.probe", "exec.gather"}
# a Prometheus text-format sample line
PROM_SAMPLE = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? [^ ]+$')
# card vs CPU embeddings of the smoke models: float32 through a few layers,
# cuBLAS against the CPU's summation order
EMB_TOL = dict(rtol=1e-4, atol=1e-5)
# phase lm_decode at full width (LM_FULL's depth): max |teacher-forced decode logit -
# unembed(forward) logit| over the largest forward logit, per model.  At
# least 8 x the reference's own gap (its bf16 KV cache; falcon-mamba-7b's
# float32 state only reorders sums) at full width, derived on the CPU by
# tests/test_torch_decode.py (test_reference_decode_gap_is_under_the_card_
# tolerance): measured at full depth over three widths and extrapolated as
# a power of the width.  qwen2-7b: 5.3e-3 / 2.5e-3 / 2.6e-3 at d_model
# 64 / 256 / 1024 (it does not grow; x 8 = 0.042); gemma3-1b: 6.2e-3 /
# 4.6e-3 / 2.9e-3 (x 8 = 0.050); falcon-mamba-7b: 4.3e-5 / 1.1e-4 / 3.0e-4
# at d_inner 128 / 512 / 2048, w^0.71, so 7.9e-4 at 8192 (x 8 = 6.3e-3,
# rounded up to 1e-2 against the CPU's own variation of the fit);
# zamba2-7b (13 bf16 KV caches of the shared block, 68 Mamba-2 states, the
# forward's SSD in chunks of 64, decode's in one-step chunks): 1.04e-2 /
# 5.5e-3 / 5.0e-3 at d_model 64 / 256 / 512, w^-0.36, so 2.3e-3 at 3584;
# the largest measured x 8 = 0.083, rounded up to 0.1.
# Phase lm_multimodal's models, derived the same way by
# tests/test_torch_vlm.py and tests/test_torch_whisper.py
# (test_reference_decode_gap_is_under_the_card_tolerance): qwen2-vl-7b
# (unembed(forward) over the spliced patches, the prompt and the greedy
# tokens) 4.7e-3 / 4.3e-3 / 3.8e-3 at d_model 64 / 256 / 1024, 28 layers
# (it falls with the width; x 8 = 0.037, at 0.06 with qwen2-7b);
# whisper-tiny (decode_train(encode(frames)), 4 + 4 layers, 1,500 frames,
# its bf16 self-attention cache; the cross K and V stay float32) 1.2e-3 /
# 7.3e-4 / 6.7e-4 at d_model 96 / 192 / 384, the last its full width (x 8
# = 9.8e-3, rounded up to 0.02).
# The MoE models (phase lm_moe) are gated at capacity_factor = E / K on both
# sides (no assignment drops), over every position, with the forward's
# expert choices replayed in decode (moe_replay, moe_replay_gap): a route
# flip is discontinuous, and the bf16 cache flips a near-tie within a few
# steps, so replayed routes leave their limit to hold the cache's rounding,
# as for the attention models.  Derived by tests/test_torch_moe.py
# (test_reference_moe_decode_gap_is_under_the_card_tolerance) from the
# reference on the CPU, its routes replayed the same way, at the depth the
# card runs (LM_MOE), all 128 experts and the config's K, over d_model 128 /
# 256 / 512 (expert F at the config's F / D): qwen3-moe 1.9e-3 / 1.9e-3 /
# 1.8e-3 (flat; x 8 = 0.015), llama4-maverick 4.8e-3 / 3.0e-3 / 4.5e-3 (x 8
# = 0.038); both at 0.06 with the attention models.  The router's
# perturbation there (MOE_ROUTE_TOL: max |p_decode - p_forward| over the
# K-th probability, up to a sequence's first would-be flip) read 0.024 /
# 0.037 / 0.015 and 6.6e-3 / 8.0e-3 / 7.0e-3 (x 8 = 0.30 and 0.064, rounded
# up to 0.4 and 0.1).
DECODE_VS_FORWARD_TOL = {"qwen2-7b": 0.06, "gemma3-1b": 0.06, "falcon-mamba-7b": 1e-2,
                         "zamba2-7b": 0.1, "qwen3-moe-235b-a22b": 0.06,
                         "llama4-maverick-400b-a17b": 0.06, "qwen2-vl-7b": 0.06,
                         "whisper-tiny": 0.02}
MOE_ROUTE_TOL = {"qwen3-moe-235b-a22b": 0.4, "llama4-maverick-400b-a17b": 0.1}
# moe_replay_gap's flip_tie_over_bound is at most 1 in exact arithmetic;
# this is the float32 rounding of the tie and the perturbation it divides
FLIP_BOUND_SLACK = 1e-5
# phase lm_decode: each model at full width, one at a time, random weights
# from seed 0: loss_fn over the prompt, prefill, greedy decode steps; at
# full depth (None) but qwen2-7b, cut to 7 of its 28 layers (the same layer
# 28 times; its limit above was derived at full depth) so that the run,
# with phase lm_moe, keeps to the time it took before that phase came;
# zamba2-7b whole (81 layers, 22.49 GB of float32 weights)
LM_FULL = {"qwen2-7b": 7, "gemma3-1b": None, "falcon-mamba-7b": None, "zamba2-7b": None}
LM_BATCH, LM_PROMPT, LM_STEPS = 4, 640, 64
# phase lm_moe: the MoE models at full width with the depth cut so that their
# float32 weights fit one 80 GB card (qwen3-moe 44.8 GB at 4 layers,
# llama4-maverick 74.2 GB at one (dense, moe) repeat), as lm_decode runs them
LM_MOE = {"qwen3-moe-235b-a22b": 4, "llama4-maverick-400b-a17b": 2}
# phase lm_multimodal: qwen2-vl-7b (28 layers, 30.46 GB of float32 weights;
# its prompt LM_BATCH x the config's 256 patch embeddings, then LM_PROMPT
# text tokens) and whisper-tiny (4 encoder + 4 decoder layers; the
# config's 1,500 frame embeddings, then an LM_PROMPT-token decoder prompt),
# both at full width and depth, the patches and frames drawn N(0, 1) on the
# card, as lm_decode runs its models
LM_MULTIMODAL = ("qwen2-vl-7b", "whisper-tiny")
# and at smoke size on the card against the CPU (the prompt is longer than
# the smoke window of 16), with the CPU tests' tolerances
# (tests/test_torch_decode.py): the loss and prefill's logits float32 in
# another order; prefill's K and V, at the prompt's positions before and
# after decode, one bf16 step (+ LM_TOL) apart at most; decode logits, and
# the caches that decode writes, within 2^-8 (a bf16 step, relative) of the
# largest CPU value, as a cache entry may round one bf16 step apart and
# move what later layers and steps compute
LM_SMOKE = ("qwen2-7b", "gemma3-1b", "gemma2-9b", "falcon-mamba-7b", "qwen3-moe-235b-a22b",
            "llama4-maverick-400b-a17b", "zamba2-7b", *LM_MULTIMODAL)
# flash_attn is also held to its plain version at these models' prefill
# shapes (their first prefill call; whisper-tiny's every distinct one: the
# encoder's, the decoder's causal self-attention and its cross attention
# over the frames): the MoE models' GQA groups 16 and 5, zamba2-7b's dh 112
# (padded to 128) at G 1, qwen2-vl-7b's GQA 28/4 over the patches and the
# prompt, whisper-tiny's 6 heads of 64, not causal
FLASH_PREFILL_RECORDED = (*LM_MOE, "zamba2-7b", *LM_MULTIMODAL)
LM_SMOKE_PROMPT, LM_SMOKE_STEPS = 24, 16
LM_TOL = dict(rtol=1e-4, atol=1e-5)
# zamba2-7b's 13-layer smoke model turns float32 rounding alone into more
# than LM_TOL: the reference against itself, every weight moved by at most
# half an ulp, reads up to 1.3 x (tests/test_torch_zamba.py, whose ZAMBA_TOL
# this is), and an H100's prefill caches against the CPU's went past LM_TOL
# too; its caches are held at 4 x LM_TOL (+ one bf16 step for K and V)
LM_CACHE_TOL = {"zamba2-7b": dict(rtol=4e-4, atol=4e-5)}
BF16_REL = 2.0 ** -8
# the smoke MoE models on the card against the CPU: an expert choice may
# differ only at a near-tie of the CPU's router probabilities, (p_k -
# p_{k+1}) / p_k within 2 x BF16_REL (two probabilities crossing, each moved
# by at most the decode logits' tolerance); a sequence whose routes differ at
# a decode step is another function from there on, and leaves the logit and
# cache checks
SMOKE_ROUTE_TIE = 2 * BF16_REL
# kernel vs plain version on the card: float32 summation order, and the
# order of the online softmax (flash_attn) or of the C contraction (ssm_scan)
FLASH_TOL = dict(rtol=1e-4, atol=1e-4)
SCAN_TOL = dict(rtol=1e-5, atol=1e-5)
# the baselines phase (8b): benchmarks/fig4_5_recall.py's grid over the first
# 1,000 queries of the main and angular paths, and the card-vs-CPU check's size
BASE_QUERIES, BASE_SMALL_N, BASE_SMALL_Q = 1_000, 20_000, 50
BASE_LAMS, BASE_PROBES = (20, 50, 100, 200, 400), (9, 33)
BASE_QUERY = dict(k=K, lam=400, cap_per_table=128)
EUCLID_BASELINES = (("E2LSH", dict(K=2, L=16, w=W_BUCKET)), ("E2LSH", dict(K=4, L=32, w=W_BUCKET)),
                    ("MultiProbeLSH", dict(K=4, L=8, w=W_BUCKET, n_probes=8)),
                    ("C2LSH", dict(m=64, w=W_BUCKET, l_threshold=2)))
ANGULAR_BASELINES = (("E2LSH", dict(K=1, L=16)), ("E2LSH", dict(K=2, L=32)),
                     ("MultiProbeLSH", dict(K=2, L=8, n_probes=8)),
                     ("C2LSH", dict(m=64, l_threshold=2)),
                     ("FALCONNLike", dict(K=2, L=32, n_probes=8)))
# untimed runs of a profiled function in each torch.profiler session, before
# its marker kernel
# training: gemma-2b at full width and depth, the train launcher's
# defaults (global batch 8, seq 64, peak lr 1e-3, warmup 10 of its 100
# steps, clip 1.0, bf16 compute, float32 AdamW moments, the near-dup filter
# at threshold 30), TRAIN_STEPS steps; falcon-mamba-7b the same at full
# width, its depth cut to TRAIN_MAMBA_LAYERS of 64 (0.266 B embedding + 24 x
# 0.1053 B = 2.79 B parameters: ~50 GB of float32 params, m, v, grads and
# bf16 copies, as gemma-2b's; the full depth's ~120 GB of state does not fit
# one 80 GB card); smoke models card vs CPU; the trainer's resume; the
# backward kernels of flash_attn and ssm_scan against their plain versions
TRAIN_ARCH = "gemma-2b"
TRAIN_MAMBA_ARCH = "falcon-mamba-7b"
TRAIN_MAMBA_LAYERS = 24
TRAIN_STEPS = 10
TRAIN = dict(global_batch=8, seq_len=64, peak_lr=1e-3, warmup=10, total=100, clip=1.0,
             dedup_threshold=30)
TRAIN_SMOKE = ("gemma-2b", "qwen3-moe-235b-a22b", "whisper-tiny", "falcon-mamba-7b")
TRAIN_SMOKE_STEPS = 3
# card vs CPU in float32 compute: loss and grad norm (the 3xTF32 attention
# and both backward orders of summation), parameters after one step at lr
# 1e-3 (the reference's own microbatch bound); the resumed run's losses
TRAIN_SMOKE_RTOL = 1e-4
TRAIN_PARAM_ATOL = 5e-4
RESUME_RTOL = 1e-4
# the backward kernel against its plain version: each of dq, dk and dv
# within this share of the tensor's largest entry (the forward's 3xTF32
# output and lse, float32 sums in another order, ex2 / rcp ulps)
FLASH_BWD_REL_TOL = 2e-4
# the scan's backward kernel against its plain version: each of ddt, dx, dB,
# dC, dA and dh0 within this share of the tensor's largest entry (float32
# sums over channels, states, steps and batch rows in other orders;
# ex2.approx's 2 ulp in each a_t)
SCAN_BWD_REL_TOL = 5e-5
# steps a sub-tile of the scan's backward kernel (ssm_scan_bwd.cu kSub): it
# recomputes each step once in its sub-tile and the steps before a tile's
# last sub-tile once more, for the entering states of the sub-tiles
SCAN_BWD_SUB = 8
# kernels one launch of a wrapper runs on the card (flash_attn_bwd at the
# training step's shape: the dQ pass with delta, the dK / dV pass cut into
# row chunks, the chunks' reduce; flash_bwd_record counts each of its
# shapes' own, `bwd_kernels`; ssm_scan_bwd: the walk and the partials'
# reduce); every other wrapper runs one
KERNELS_PER_LAUNCH = {"flash_attn_bwd": 3, "ssm_scan_bwd": 2}
# phase bf16_knobs: the serving model's bf16 knob and the form of its kernel
# that the knob runs; each bf16 form's float32 form
KNOB_KERNEL = {"gemma-2b": "flash_attn_bf16", "falcon-mamba-7b": "ssm_scan_bf16"}
BF16_FORM_OF = {"flash_attn": "flash_attn_bf16", "flash_attn_bwd": "flash_attn_bwd_bf16",
                "ssm_scan": "ssm_scan_bf16", "ssm_scan_bwd": "ssm_scan_bwd_bf16"}
# a bf16-P flash_attn / flash_attn_bwd output (knob_gap_check): the mean of
# its gap from the plain mirror of its own roundings (the forward's walk of
# its key tiles, flash_attention_bf16_tiles_ref; the plain bf16-P backward
# on the kernel's own o and lse) within KNOB_MIRROR_FACTOR of the knob's mean
# gap (mean |plain bf16-P - plain float32|), and its largest gap from the
# plain bf16-P version within KNOB_GAP_FACTOR of the knob's largest gap.
# tests/test_torch_bf16_knobs.py shows the mean gate's margins on the CPU:
# scores moved by 1e-6 of themselves (3xTF32 products against float32 sums)
# stay under half of it, while the P V product without its roundings, or
# with only some of its three, lies above 10 times it
KNOB_MIRROR_FACTOR = 0.02
KNOB_GAP_FACTOR = 2.0
KNOB_GATE = (f"mean |kernel - plain mirror| <= {KNOB_MIRROR_FACTOR} x the knob's mean gap; "
             f"max |kernel - plain bf16-P| <= {KNOB_GAP_FACTOR} x its largest gap")
# a training step's loss with the knob on against the same state's loss with
# it off on the same batch, relative.  gemma-2b (attn_bf16_probs): above 0
# (the rounding happened) and at most KNOB_LOSS_REL_TOL, about 3 x the gap
# read on the card (1.0578e-5 in two runs, bit for bit, PERF.md §6).
# falcon-mamba-7b (ssm_bf16_acts): equal bit for bit, since in bf16 compute
# dt, x, B and C are bf16 already and the bf16 scan is the float32 scan on
# its widened inputs
KNOB_LOSS_REL_TOL = 3e-5
PROFILE_PAD = 32
# tiny kernels launched first in each torch.profiler session, one entry a
# try: the profiler drops the first kernels of a session, the more of them
# the older the process, and late in a run that can be every kernel of a
# short call with its pad and marker; a wait on the host does not reliably
# help (tools/profiler_clock.py shows both)
PROFILE_LEAD_KERNELS = (512, 4096, 32768)


def emit(**rec) -> None:
    print(json.dumps(rec), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def sync_time(fn):
    """(result, seconds) of fn() on the host clock, fenced by synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def qps_passes(fn, n_q: int):
    """C10: a search of n_q queries, fn(), run QPS_PASSES times, each pass
    timed by sync_time.  The launch counts are reset before the first pass
    and read after it.  Returns (the last pass's output, the first pass's
    launch counts, {"qps": n_q over the median pass's seconds, "qps_min",
    "qps_max", "qps_spread": (max - min) / median seconds, "seconds": the
    median's, "passes"})."""
    from repro_torch.kernels import common

    common.reset_launch_counts()
    secs, counts = [], None
    for _ in range(QPS_PASSES):
        out, s = sync_time(fn)
        secs.append(s)
        if counts is None:
            counts = common.launch_counts()
    med = statistics.median(secs)
    return out, counts, dict(qps=n_q / med, qps_min=n_q / max(secs), qps_max=n_q / min(secs),
                             qps_spread=(max(secs) - min(secs)) / med, seconds=med,
                             passes=QPS_PASSES)


def median_ms(fn, reps: int) -> float:
    """Median device time of fn() over `reps` runs, CUDA events, after one
    warm-up run."""
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def after_marker(pad, timed, pad_runs: int = PROFILE_PAD,
                 lead: int = PROFILE_LEAD_KERNELS[0]) -> list | None:
    """Under one torch.profiler session: `lead` tiny kernels, pad()
    `pad_runs` times, a marker kernel (torch.cuda._sleep's spin_kernel), then
    timed().  Returns the card's kernels that ran after the marker, in order
    of start; None when the session recorded no marker.  The lead kernels
    absorb the session's first kernels, which the profiler may drop
    (PROFILE_LEAD_KERNELS)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    lead_buf = torch.zeros(1, device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(lead):
            lead_buf.add_(1.0)
        for _ in range(pad_runs):
            pad()
        torch.cuda.synchronize()
        torch.cuda._sleep(1)
        timed()
        torch.cuda.synchronize()
    kern = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)
    marks = [i for i, e in enumerate(kern) if "spin_kernel" in e.name]
    return kern[marks[-1] + 1:] if marks else None


def device_events(fn, reps: int, launches: int, match: str | None = None) -> list:
    """The device time (ms) of each kernel that `reps` runs of fn() launch on
    the card under torch.profiler (after_marker, fn() as the pad), after
    one warm-up run; fn() launches `launches` kernels a run (of those whose
    name holds `match`, where given).  A session that saw fewer than reps x
    launches kernels is run again with more lead kernels (PROFILE_LEAD_KERNELS);
    after three such sessions the run fails, as it does at once on a session
    that saw more."""
    fn()
    torch.cuda.synchronize()
    want, seen = reps * launches, []

    def runs():
        for _ in range(reps):
            fn()

    for lead in PROFILE_LEAD_KERNELS:
        timed = after_marker(fn, runs, lead=lead)
        if timed is not None:
            timed = [e for e in timed if match is None or match in e.name]
            if len(timed) == want:
                return [e.time_range.elapsed_us() / 1e3 for e in timed]
            if len(timed) > want:
                fail(f"device_ms: a profiler session saw {len(timed)} kernels, {want} expected "
                     f"({reps} runs of {launches})")
        seen.append(None if timed is None else len(timed))
    fail(f"device_ms: three profiler sessions saw {seen} of the {want} kernels expected "
         f"({reps} runs of {launches}; None: the marker itself unseen)")


def kernels_per_call(fn) -> int:
    """The number of kernels one run of fn() launches on the card, counted by
    torch.profiler after a marker (the most of two sessions: a session can
    only miss kernels; a third, with the most lead kernels of
    PROFILE_LEAD_KERNELS, where both saw none)."""
    counts = []
    for lead in PROFILE_LEAD_KERNELS:
        counts.append(len(after_marker(fn, fn, lead=lead) or []))
        if len(counts) >= 2 and max(counts) > 0:
            return max(counts)
    fail("device_ms: three profiler sessions saw no kernel of one call on the card")


def device_ms(fn, reps: int, launches: int | None = None, match: str | None = None,
              key: str = "device", floor_ms: float | None = None) -> dict:
    """{key}_ms: the mean device time of fn() over `reps` runs (its kernels'
    time on the card under torch.profiler, summed, without the host's launch
    cost that the CUDA events of median_ms include), beside
    {key}_launches_seen and {key}_launches_expected.  `launches` (kernels a
    run, of those named `match`) is counted with kernels_per_call where not
    given.  `floor_ms`: the least time the work can take (bound_floor); a
    reading under it is taken again in a fresh session, up to three times
    in all ({key}_readings_under_floor counts the ones set aside), and the
    run fails if every one of them reads under it."""
    if launches is None:
        launches = kernels_per_call(fn)
    under = []
    for _ in range(3):
        events = device_events(fn, reps, launches, match)
        ms = sum(events) / reps
        if floor_ms is None or ms >= floor_ms:
            return {f"{key}_ms": ms, f"{key}_launches_seen": len(events),
                    f"{key}_launches_expected": reps * launches,
                    f"{key}_readings_under_floor": under}
        under.append(ms)
    fail(f"device_ms: {key} read {under} ms, under the work's least time {floor_ms} ms, "
         "in three sessions")


def forbid_scatter() -> None:
    """Make every card path fail the run if it reaches the scatter-max dedupe
    (`dedupe_topk_scatter`, a (B, n) buffer a batch): the probe's pool goes
    through `pool_topk`.  Phases 3b and 6 time and compare the original
    function through their own reference to it."""
    import repro_torch.core.sources as sources
    import repro_torch.kernels.csa_probe as probe_pkg
    from repro_torch.kernels.csa_probe import ops, ref

    def forbidden(*args, **kw):
        fail("a card path called dedupe_topk_scatter")

    for module in (probe_pkg, ops, ref, sources):
        module.dedupe_topk_scatter = forbidden


def forbid_circrun_ranking() -> None:
    """Make every card path fail the run if it ranks circrun lengths with the
    plain route (`circrun_topk_plain`: the (B, n) int32 lengths, then
    `topk_largest_lcp` over (B, n) int64 keys): the bruteforce source and the
    delta buffer go through the circrun_topk kernels.  CPU tensors (phase
    10's CPU index) keep the plain route; phases 11 and 12 time and compare
    it through `circrun.ref`."""
    import repro_torch.kernels.circrun as circrun_pkg
    from repro_torch.kernels.circrun import ops

    plain = ops.circrun_topk_plain

    def guarded(h, *args, **kw):
        if h.device.type != "cpu":
            fail("a card path ranked circrun lengths with circrun_topk_plain")
        return plain(h, *args, **kw)

    for module in (circrun_pkg, ops):
        module.circrun_topk_plain = guarded


def forbid_sorted_verify() -> None:
    """Make every card path fail the run if `exact_topk` or `survivors`
    ranks a gather kernel's output through torch.sort (the unfused route:
    the scan kernel, then `topk_ids` or `_smallest`): the verify goes
    through the fused kernels (`gather_l2_topk`, `gather_q_topk`).
    `rerank_rows` keeps its sort; phases 3b, 6 and 7 call the scan kernels
    outside these stages, to compare and time them."""
    from repro_torch.exec import stages
    from repro_torch.kernels.gather_l2 import ops as l2_ops
    from repro_torch.kernels.gather_q import ops as q_ops

    inside = []

    def staged(fn):
        def run(*args, **kw):
            inside.append(fn.__name__)
            try:
                return fn(*args, **kw)
            finally:
                inside.pop()
        return run

    def scan(fn):
        def run(rows, *args, **kw):
            if inside and rows.device.type != "cpu":
                fail(f"a card path's {inside[-1]} ranked a gather kernel's output through "
                     "torch.sort")
            return fn(rows, *args, **kw)
        return run

    stages.exact_topk = staged(stages.exact_topk)
    stages.survivors = staged(stages.survivors)
    l2_ops.gather_dist_kernel = scan(l2_ops.gather_dist_kernel)
    q_ops.gather_dist_q_kernel = scan(q_ops.gather_dist_q_kernel)


@contextmanager
def recording(module, name: str, store: list, keep: int | None = None):
    """Record the arguments of every call (or of the first `keep` calls) to
    module.<name> (the wrapper the main path calls) while the block runs."""
    orig = getattr(module, name)

    def rec(*args, **kw):
        if keep is None or len(store) < keep:
            store.append((args, kw))
        return orig(*args, **kw)

    setattr(module, name, rec)
    try:
        yield
    finally:
        setattr(module, name, orig)


def exact_knn(X: torch.Tensor, Q: torch.Tensor, k: int) -> torch.Tensor:
    """Ground-truth k nearest rows by chunked torch.cdist (smoke check only)."""
    out = []
    for s in range(0, Q.shape[0], BATCH):
        d = torch.cdist(Q[s:s + BATCH], X)
        out.append(torch.topk(d, k, dim=1, largest=False).indices)
    return torch.cat(out)


def run_searches(index, Q: torch.Tensor, params):
    ids, dists = [], []
    for s in range(0, Q.shape[0], BATCH):
        i, d = index.search(Q[s:s + BATCH], params)
        ids.append(i)
        dists.append(d)
    return torch.cat(ids), torch.cat(dists)


def check_outputs(ids, dists, n_q: int) -> None:
    if ids.shape != (n_q, K) or dists.shape != (n_q, K) or ids.dtype != torch.int32:
        fail(f"bad output shapes {tuple(ids.shape)} {tuple(dists.shape)} {ids.dtype}")
    valid = ids >= 0
    if not torch.isfinite(dists[valid]).all() or not bool(valid[:, 0].all()):
        fail("non-finite distances or empty results")


def recall_at_k(ids: torch.Tensor, truth: torch.Tensor) -> float:
    hit = (ids[:, :, None].long() == truth[:, None, :]).any(dim=2).sum()
    return float(hit) / truth.numel()


def main() -> None:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA card")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    torch.manual_seed(0)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    run(dev, t_start)


def run(dev: torch.device, t_start: float) -> None:
    from repro_torch.core import LCCSIndex, SearchParams
    import repro_torch.kernels.csa_probe as probe_pkg
    from repro_torch.core.index import candidates
    from repro_torch.core.search import dedupe_topk
    from repro_torch.data import clustered_vectors, queries_from
    from repro_torch.exec import stages
    from repro_torch.kernels import common
    from repro_torch.kernels.csa_probe import ops as probe_ops
    from repro_torch.kernels.csa_probe.ref import csa_probe_plain, dedupe_topk_scatter
    from repro_torch.kernels.gather_l2 import ops as l2_ops
    from repro_torch.kernels.gather_q import ops as q_ops

    card = card_line()
    forbid_scatter()
    forbid_circrun_ranking()
    forbid_sorted_verify()

    # -- 1. card + kernel build ---------------------------------------------
    t0 = time.perf_counter()
    so = common.build(verbose=True)
    common.library()
    emit(phase="build_kernels", card=card, library=so.name,
         seconds=time.perf_counter() - t0)

    # -- 2. fp32 index on the card -------------------------------------------
    X_np = clustered_vectors(N, D, n_clusters=100, seed=0)
    Q_np = queries_from(X_np, N_QUERIES, jitter=0.05, seed=1)
    X = torch.from_numpy(X_np).to(dev)
    Q = torch.from_numpy(Q_np).to(dev)
    index, build_s = sync_time(
        lambda: LCCSIndex.build(X, m=M, family="euclidean", w=W_BUCKET, device=dev))
    emit(phase="build_index", store="fp32", n=N, d=D, m=M, seconds=build_s,
         index_bytes=index.index_bytes(), store_bytes=index.store_bytes(),
         peak_mem_bytes=torch.cuda.max_memory_allocated())
    truth = exact_knn(X, Q, K)
    src_rows = torch.from_numpy(
        np.random.default_rng(1).choice(N, N_QUERIES, replace=False)).to(dev)

    # -- 3. main path: fp32 searches -----------------------------------------
    index.search(Q[:BATCH], SearchParams(**LCCS))  # warm-up
    index.search(Q[:BATCH], SearchParams(**SKIP))
    results, fp32_counts = {}, {k: 0 for k in common.LAUNCHES}
    for name, kw in (("lccs", LCCS), ("multiprobe-skip", SKIP)):
        (ids, dists), counts, timing = qps_passes(
            lambda: run_searches(index, Q, SearchParams(**kw)), N_QUERIES)
        for k in fp32_counts:
            fp32_counts[k] += counts[k]
        check_outputs(ids, dists, N_QUERIES)
        results[name] = ids
        emit(phase="search", store="fp32", source=name, params=kw, **timing,
             recall_at_10=recall_at_k(ids, truth),
             top1_self=float((ids[:, 0].long() == src_rows).float().mean()))
    emit(phase="launches", run="fp32 lccs + multiprobe-skip", counts=fp32_counts)
    top1 = float((results["lccs"][:, 0].long() == src_rows).float().mean())
    if top1 < 0.90:
        fail(f"lccs top-1 self-retrieval {top1} < 0.90")

    # -- 3b. where one lccs batch spends its time (not counted as launches) --
    qb = Q[:BATCH]
    pl = SearchParams(**LCCS, use_probe_kernel=True, use_gather_kernel=True)
    qh = stages.hash_queries(index.family, qb)
    w_ids, w_lcps = probe_ops.csa_probe_windows(index.csa, qh, width=pl.width)
    pool_ids, pool_lcps = w_ids.reshape(BATCH, -1), w_lcps.reshape(BATCH, -1)
    cand, _ = probe_ops.pool_topk(pool_ids, pool_lcps, N, pl.lam)
    stage_ms = {
        "hash_queries": median_ms(lambda: stages.hash_queries(index.family, qb), 5),
        "probe_windows (csa_probe)": median_ms(
            lambda: probe_ops.csa_probe_windows(index.csa, qh, width=pl.width), 5),
        "pool_topk": median_ms(lambda: probe_ops.pool_topk(pool_ids, pool_lcps, N, pl.lam), 5),
        # the dedupes it replaces, for the record
        "dedupe_topk_scatter (plain torch)": median_ms(
            lambda: dedupe_topk_scatter(pool_ids, pool_lcps, N, pl.lam), 5),
        "dedupe_topk (plain torch, two stable sorts)": median_ms(
            lambda: dedupe_topk(pool_ids, pool_lcps, pl.lam), 5),
        "verify (gather_l2 + top-k)": median_ms(
            lambda: stages.verify(index.store, index.tail, qb, cand, pl, "euclidean"), 5),
        # the verify's parent route: the scan kernel, its mask and epilogue,
        # then the stable sort of topk_ids
        "verify, the parent's route (gather_l2 scan + topk_ids)": median_ms(
            lambda: stages.topk_ids(index.store.gather_dist(
                cand, qb, metric="euclidean", use_kernel=True), cand, K), 5),
        "search (whole batch)": median_ms(lambda: index.search(qb, pl), 5),
    }
    emit(phase="stages", store="fp32", source="lccs", batch=BATCH, ms=stage_ms)

    # -- 4. fused probe == legacy window path (first 100 queries) ------------
    fused = candidates(index, Q[:100], SearchParams(**LCCS, use_probe_kernel=True))
    legacy = candidates(index, Q[:100], SearchParams(**LCCS, use_probe_kernel=False))
    same = torch.equal(fused[0], legacy[0]) and torch.equal(fused[1], legacy[1])
    emit(phase="fused_vs_legacy", queries=100, identical=same)
    if not same:
        fail("fused and legacy candidates differ")

    # -- 5. main path: int8 two-stage ----------------------------------------
    torch.cuda.synchronize()
    base8 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    index8, build8_s = sync_time(
        lambda: LCCSIndex.build(X, m=M, family="euclidean", w=W_BUCKET, store="int8",
                                device=dev))
    # the corpus X is resident before the build (its in-memory tail)
    peak8 = torch.cuda.max_memory_allocated() - base8
    emit(phase="build_index", store="int8", seconds=build8_s,
         index_bytes=index8.index_bytes(), store_bytes=index8.store_bytes(),
         total_bytes=index8.total_bytes(), peak_mem_over_base_bytes=peak8)
    p8 = SearchParams(**LCCS, store="int8")
    index8.search(Q[:BATCH], p8)  # warm-up
    (ids8, d8), int8_counts, timing = qps_passes(lambda: run_searches(index8, Q, p8),
                                                 N_QUERIES)
    check_outputs(ids8, d8, N_QUERIES)
    emit(phase="search", store="int8", source="lccs", params=dict(LCCS, rerank_mult=4),
         **timing, recall_at_10=recall_at_k(ids8, truth))
    emit(phase="launches", run="int8 lccs", counts=int8_counts)
    emit(phase="stages", store="int8", source="lccs", batch=BATCH,
         ms=int8_stage_ms(index8, qb, p8))
    launches = {k: fp32_counts[k] + int8_counts[k] for k in fp32_counts}
    for k in MAIN_KERNELS:
        if launches[k] == 0:
            fail(f"kernel {k} was never launched on the main path")

    # -- 6. each kernel vs its plain version at the main path's shapes ------
    probe_calls, l2_calls, q_calls, pool_calls = [], [], [], []
    with recording(probe_ops, "csa_probe", probe_calls), \
            recording(probe_ops, "pool_topk", pool_calls), \
            recording(probe_pkg, "pool_topk", pool_calls), \
            recording(l2_ops, "gather_topk", l2_calls), \
            recording(q_ops, "gather_topk_q", q_calls):
        index.search(Q[:BATCH], SearchParams(**LCCS))
        index.search(Q[:BATCH], SearchParams(**SKIP))
        index8.search(Q[:BATCH], p8)
    kernels = []

    # B1: the lccs worklist (all shifts of a batch), the skip pairs worklist,
    # and every shift of probes whose symbols are all int32's least (pos 0) or
    # greatest (pos n) value beside a few real ones
    # calls: lccs all-shift windows; skip base windows, skip pairs; int8 lccs
    if len(probe_calls) != 4 or not l2_calls or not q_calls:
        fail(f"unexpected kernel calls: {len(probe_calls)} {len(l2_calls)} {len(q_calls)}")
    worklists = {"lccs": probe_calls[0][0], "multiprobe-skip pairs": probe_calls[2][0]}
    I, L, Hd, qd, shifts, qidx, width = worklists["lccs"]
    i32 = torch.iinfo(torch.int32)
    edge_q = torch.cat([torch.full_like(qd[:1], i32.min), torch.full_like(qd[:1], i32.max), qd[:6]])
    worklists["pos 0 / pos n"] = (
        I, L, Hd, edge_q, torch.arange(M, dtype=torch.int32, device=dev).repeat(8),
        torch.arange(8, dtype=torch.int32, device=dev).repeat_interleave(M), width)
    probe_rows, probe_ids = {}, {}
    for tag, args in worklists.items():
        k_out = probe_ops.csa_probe(*args)
        p_out = csa_probe_plain(*args)
        if not (torch.equal(k_out[0], p_out[0]) and torch.equal(k_out[1], p_out[1])):
            fail(f"csa_probe kernel != plain version on the {tag} worklist")
        probe_rows[tag], probe_ids[tag] = int(args[4].shape[0]), k_out[0]
    # at pos 0 the window's upper half holds the first W sorted ids, at pos n
    # its lower half the last W
    e_ids = probe_ids["pos 0 / pos n"]
    if not (torch.equal(e_ids[:M, width:], I[:, :width])
            and torch.equal(e_ids[M:2 * M, :width], I[:, N - width:])):
        fail("csa_probe: the least / greatest probes did not land at pos 0 / pos n")
    timed = {tag: dict(max_abs_err=0, ms=median_ms(lambda: probe_ops.csa_probe(*args), 20),
                       plain_ms=median_ms(lambda: csa_probe_plain(*args), 3),
                       bound_ms=probe_bound_ms(args, 2 if tag == "lccs" else 0),
                       bound_by="bytes", library_ms=None)
             for tag, args in worklists.items() if tag != "pos 0 / pos n"}
    kernels.append(dict(
        name="csa_probe", route="cuda", source="src/repro_torch/kernels/csrc/csa_probe.cu",
        replaces="src/repro/kernels/csa_probe/csa_probe.py:98",
        launches=launches["csa_probe"], **timed["lccs"],
        shape=dict(R=probe_rows["lccs"], n=N, m=M, width=width, rows_checked=probe_rows),
        worklists={"multiprobe-skip pairs": timed["multiprobe-skip pairs"]},
    ))

    # B1's consumer: the lccs pool and the multiprobe-skip pool (several
    # tiles), bit for bit against its plain version and the scatter-max dedupe
    # calls: lccs, multiprobe-skip, int8 lccs
    if len(pool_calls) != 3:
        fail(f"unexpected pool_topk calls: {len(pool_calls)}")
    pool_recs = {tag: pool_record(tag, args, dedupe_topk_scatter)
                 for tag, (args, _) in (("lccs", pool_calls[0]),
                                        ("multiprobe-skip", pool_calls[1]))}
    if pool_recs["lccs"]["shape"]["launches_per_call"] != 1:
        fail("the lccs pool took more than one pool_topk launch a call")
    if pool_recs["multiprobe-skip"]["shape"]["launches_per_call"] < 2:
        fail("the multiprobe-skip pool fits one tile: no merge was checked")
    kernels.append(dict(
        name="pool_topk", route="cuda", source="src/repro_torch/kernels/csrc/pool_topk.cu",
        replaces="src/repro/kernels/csa_probe/ref.py:114", launches=launches["pool_topk"],
        **pool_recs["lccs"], pool={"multiprobe-skip": pool_recs["multiprobe-skip"]},
        checked_bit_identical=["pool_topk_plain", "dedupe_topk_scatter"]))

    # B2 / B3: the verify scans and the fused verify behind them
    if len(l2_calls) != 2 or len(q_calls) != 1:
        fail(f"unexpected fused verify calls: {len(l2_calls)} {len(q_calls)}")
    kernels += verify_kernels_vs_plain(l2_calls[0], q_calls[0], launches)
    emit(phase="kernels_vs_plain", tolerance=dict(
        csa_probe="bit-identical", pool_topk="bit-identical", gather=GATHER_TOL,
        gather_topk="bit-identical to the scan kernel + the plain epilogue"), ok=True)

    # -- 7. small input: the kernel path agrees with the plain CPU path ------
    Xs = X_np[:4000]
    cpu = LCCSIndex.build(Xs, m=M, family="euclidean", w=W_BUCKET, device="cpu")
    with tempfile.TemporaryDirectory() as tmp:
        cpu.save(Path(tmp) / "small.pkl")
        gpu = LCCSIndex.load(Path(tmp) / "small.pkl", device=dev)
    Qs = torch.from_numpy(Xs[:64] + 0.05)
    qh = stages.hash_queries(cpu.family, Qs)
    cand, mismatch = {}, []
    for kw in (LCCS, SKIP):
        p = SearchParams(**kw, use_probe_kernel=True, use_gather_kernel=True)
        ci, cl = stages.probe(cpu, Qs, qh, p)
        gi, gl = stages.probe(gpu, Qs.to(dev), qh.to(dev), p)
        if not (torch.equal(ci, gi.cpu()) and torch.equal(cl, gl.cpu())):
            fail(f"small input: {kw['source']} candidates differ between card and CPU")
        cand[kw["source"]] = (p, ci, gi)
        _, cd = stages.verify(cpu.store, cpu.tail, Qs, ci, p, "euclidean")
        _, gd = stages.verify(gpu.store, gpu.tail, Qs.to(dev), gi, p, "euclidean")
        if not torch.allclose(cd, gd.cpu(), **GATHER_TOL):
            explain_verify_mismatch(cpu, gpu, Qs, ci, gi, p, kw["source"], cd, gd)
            mismatch.append(kw["source"])
    # C8: each device's verify again, 20 times, each rerun held to the first
    repeats = verify_repeats(cpu, gpu, Qs, cand)
    emit(phase="verify_repeats", reps=20, differing_reruns=repeats)
    if mismatch:
        fail(f"small input: the {mismatch} verify differs between card and CPU")
    if any(c["card"] for c in repeats.values()):
        fail(f"the card's verify differs from its first run on a rerun: {repeats}")
    emit(phase="small_input_vs_cpu", n=4000, ok=True)

    # -- 7b.-7d. the out-of-core build and the sharded topology --------------
    ctx = dict(dev=dev, X=X, Q=Q, X_np=X_np, truth=truth, src_rows=src_rows, index=index,
               index8=index8, ids8=ids8, d8=d8, peak8=peak8, results=results)
    for part in (run_out_of_core(ctx), run_sharded(ctx)):
        for k in launches:
            launches[k] += part[k]
    del ctx

    # -- 8.-12. the paths of the second slice ---------------------------------
    del index8
    torch.cuda.empty_cache()
    ctx = dict(dev=dev, X=X, Q=Q, X_np=X_np, truth=truth, src_rows=src_rows, index=index,
               build_s=build_s)
    angular = run_angular(ctx)
    base_counts = run_baselines(ctx, angular)
    for key in ("index", "X", "Q", "truth"):
        del angular[key]
    torch.cuda.empty_cache()
    dynamic = run_dynamic(ctx)
    brute_counts = run_bruteforce(ctx)
    for part in (angular["counts"], base_counts, dynamic["counts"], dynamic["ingest_counts"],
                 brute_counts):
        for k in launches:
            launches[k] += part[k]
    for rec in kernels:  # every path's launches, not only the main path's
        rec["launches"] = launches[rec["name"]]
    kernels += new_kernels_vs_plain(ctx, angular, dynamic, launches)

    # -- 13.-16. the serving path of the third slice --------------------------
    del ctx, angular, dynamic, index, X, Q, truth, src_rows, results, ids, dists, ids8, d8
    # phases 3b-7's arguments and outputs on the card (the index's tables
    # and store among them): the LM phases need the room
    del (probe_calls, l2_calls, q_calls, pool_calls, worklists, I, L, Hd, qd, shifts, qidx,
         edge_q, e_ids, probe_ids, k_out, p_out, pool_ids, pool_lcps, w_ids, w_lcps, qh, qb,
         fused, legacy, cand, gpu, Qs)
    torch.cuda.empty_cache()
    serve = run_serving(dev)
    lm = run_lm_decode(dev)
    train = run_training(dev)
    for k in launches:
        launches[k] += (serve["counts"][k] + lm["counts"][k] + train["counts"][k]
                        + serve["knob_counts"][k] + train["knob_counts"][k])
    for rec in kernels:
        rec["launches"] = launches[rec["name"]]
    kernels += serve_kernels_vs_plain(serve, launches)
    decode_kernels_vs_plain(kernels, lm)
    kernels.append(flash_bwd_kernels_vs_plain(launches))
    kernels.append(scan_bwd_kernels_vs_plain(launches))
    kernels += knob_kernels_vs_plain(serve, launches)
    pool_rec = next(rec for rec in kernels if rec["name"] == "pool_topk")
    pool_rec["pool"]["serving"] = pool_record("serving", serve["recorded"]["pool_topk"][0],
                                              dedupe_topk_scatter)
    names = [rec["name"] for rec in kernels]
    if sorted(names) != sorted(common.LAUNCHES):
        fail(f"the kernels line lists {names}, the library has {sorted(common.LAUNCHES)}")
    for name in BF16_FORM_OF.values():  # every bf16 form ran on a main path of the phase
        if launches[name] == 0:
            fail(f"bf16_knobs: {name} was never launched on the knobs' paths")

    for rec in kernels:
        subs = [sub for k in ("wide", "batch", "long", "pool", "worklists", "decode", "prefill",
                              "train")
                for sub in rec.get(k, {}).values()]
        for r in (rec, *subs):
            with_ratios(r)
    emit(phase="run", seconds=time.perf_counter() - t_start)  # the whole run, build included
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


def pool_record(tag: str, args, scatter) -> dict:
    """pool_topk at one recorded pool (ids, lcps, n, lam): the kernel bit for
    bit against its plain version and the scatter-max dedupe (`scatter`, the
    original function: forbid_scatter replaced the module's), timed by CUDA
    events and by its kernels' device time beside its bound (the pool read
    once, the (B, lam) lists written once), the plain version and the two
    plain-torch dedupes; and a `pool_stats` line: what its band filter rests
    on, per row (`ref.pool_cut_stats`), as median, min and max over rows."""
    from repro_torch.core.search import dedupe_topk
    from repro_torch.kernels.csa_probe import ops as probe_ops
    from repro_torch.kernels.csa_probe.ref import (
        pool_chunk,
        pool_cut_stats,
        pool_levels,
        pool_topk_plain,
    )

    p_ids, p_lcps, n_, lam_ = args
    B_, pool_ = p_ids.shape
    k_out = probe_ops.pool_topk(*args)
    for ref_name, ref_fn in (("pool_topk_plain", pool_topk_plain),
                             ("dedupe_topk_scatter", scatter)):
        r_out = ref_fn(*args)
        if not (torch.equal(k_out[0], r_out[0]) and torch.equal(k_out[1], r_out[1])):
            fail(f"pool_topk kernel != {ref_name} on the {tag} pool")
    levels = pool_levels(pool_, min(lam_, n_), n_)

    def summary(x: torch.Tensor) -> dict:
        v = x.double().cpu()
        return dict(median=float(v.median()), min=float(v.min()), max=float(v.max()))

    cut, above, entries, distinct = pool_cut_stats(*args)
    emit(phase="pool_stats", pool=tag, B=B_, entries=pool_, n=n_, lam=lam_,
         cut_lcp=summary(cut), distinct_at_or_above_cut=summary(above),
         entries_at_or_above_cut=summary(entries), distinct=summary(distinct))
    rec = dict(
        max_abs_err=0, ms=median_ms(lambda: probe_ops.pool_topk(*args), 20),
        **device_ms(lambda: probe_ops.pool_topk(*args), 20, len(levels), "pool_topk_kernel"),
        plain_ms=median_ms(lambda: pool_topk_plain(*args), 3),
        # bytes: the pool's ids and lcps read once, (B, lam) ids and lcps written once
        bound_ms=(B_ * pool_ + B_ * lam_) * 8 / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=None,
        scatter_ms=median_ms(lambda: scatter(*args), 3),
        two_sorts_ms=median_ms(lambda: dedupe_topk(p_ids, p_lcps, lam_), 3),
        shape=dict(B=B_, pool=pool_, n=n_, lam=lam_,
                   tiles=-(-pool_ // pool_chunk(min(lam_, n_), n_)),
                   launches_per_call=len(levels)))
    rec["device_of_bound"] = rec["bound_ms"] / rec["device_ms"]
    return rec


def int8_stage_ms(index8, qb: torch.Tensor, p8) -> dict:
    """Where one int8 `lccs` batch spends its time (not counted as
    launches): the probe, the survivors (the fused gather_q_topk, and as its
    yardstick the parent's route: the gather_q scan, its epilogue and the
    stable sort), the fp32 rows of the survivors, the plain-torch rerank, and
    the whole search call."""
    from repro_torch.exec import resolve_params, stages

    pr = resolve_params(index8, p8)
    qh = stages.hash_queries(index8.family, qb)
    cand, _ = stages.probe(index8, qb, qh, pr)
    surv, _ = stages.survivors(index8.store, qb, cand, pr, "euclidean")
    rows = stages.gather_fp32(index8.store, index8.tail, surv)
    r = stages.survivor_budget(pr, cand.shape[1])
    return {
        "hash_queries (hash_rp)": median_ms(lambda: stages.hash_queries(index8.family, qb), 5),
        "probe (csa_probe + pool_topk)": median_ms(
            lambda: stages.probe(index8, qb, qh, pr), 5),
        f"survivors, R {r} (gather_q_topk)": median_ms(
            lambda: stages.survivors(index8.store, qb, cand, pr, "euclidean"), 5),
        "survivors, the parent's route (gather_q scan + _smallest)": median_ms(
            lambda: stages._smallest(index8.store.gather_dist(
                cand, qb, metric="euclidean", use_kernel=True), r), 5),
        "gather_fp32 (the resident tail's rows)": median_ms(
            lambda: stages.gather_fp32(index8.store, index8.tail, surv), 5),
        "rerank_rows (plain torch, stable sort)": median_ms(
            lambda: stages.rerank_rows(rows, qb, surv, K, "euclidean"), 5),
        "search (whole batch)": median_ms(lambda: index8.search(qb, p8), 5),
    }


def verify_kernels_vs_plain(l2_call, q_call, launches) -> list:
    """Phase 6, B2 / B3 at the main path's verify batches (the fp32 `lccs`
    verify, k 10; the int8 `lccs` survivors, R 40): each scan (gather_l2,
    gather_q) against its plain version within GATHER_TOL, and each fused
    verify (gather_l2_topk, gather_q_topk) against the parent's route, the
    scan kernel + the store's epilogue + `topk_ids` / `_smallest`, bit for
    bit; both metrics, a zero row (NaN under angular) included.  Each timed
    (CUDA events, and its kernels' device time under torch.profiler) beside
    its bound, its plain version and (fused) the parent's route."""
    from repro_torch.exec import stages
    from repro_torch.kernels.gather_l2 import ops as l2_ops
    from repro_torch.kernels.gather_l2.ref import gather_dist_ref, gather_topk_ref
    from repro_torch.kernels.gather_q import ops as q_ops
    from repro_torch.kernels.gather_q.ref import gather_dist_q_ref, gather_topk_q_ref
    from repro_torch.store.stores import Fp32Store, Int8Store

    (data, ids, queries, k), l2_kw = l2_call
    (codes, scale, ids_q, queries_q, r), q_kw = q_call
    if l2_kw.get("survivors") or not q_kw.get("survivors"):
        fail("the recorded fused calls are not the fp32 verify and the int8 survivors")
    src = "src/repro_torch/kernels/csrc/gather.cu"
    l2_src, q_src = ("src/repro/kernels/gather_l2/gather_l2.py:38",
                     "src/repro/kernels/gather_q/gather_q.py:41")
    out = []
    for name, kernel, plain, k_args, row_bytes, repl in (
        ("gather_l2", l2_ops.gather_dist_kernel, gather_dist_ref, (data, ids, queries),
         4 * D, l2_src),
        ("gather_q", q_ops.gather_dist_q_kernel, gather_dist_q_ref,
         (codes, scale, ids_q, queries_q), D + 4, q_src),
    ):
        err = 0.0
        for metric in ("euclidean", "angular"):
            z_args = list(k_args)
            z_args[0] = k_args[0].clone()
            z_args[0][max(0, int(k_args[-2][0, 0]))] = 0  # a zero row: NaN from the norms
            kd = kernel(*z_args, metric=metric)
            pd = plain(*z_args, metric=metric)
            if not torch.equal(torch.isnan(kd), torch.isnan(pd)):
                fail(f"{name} {metric}: NaN pattern differs from the plain version")
            torch.testing.assert_close(kd.nan_to_num(), pd.nan_to_num(), **GATHER_TOL)
            if metric == "angular" and not bool(torch.isnan(kd[0, 0])):
                fail(f"{name}: zero row did not give NaN")
            err = max(err, float((kd.nan_to_num() - pd.nan_to_num()).abs().max()))
        b_ids = k_args[-2]
        uniq = int(torch.unique(torch.clamp(b_ids, min=0)).numel())
        B, Lc = b_ids.shape
        nbytes = uniq * row_bytes + b_ids.numel() * 4 * 2 + B * D * 4
        flops = 3 * B * Lc * D
        out.append(dict(
            name=name, route="cuda", source=src, replaces=repl,
            launches=launches[name], max_abs_err=err,
            ms=median_ms(lambda: kernel(*k_args, metric="euclidean"), 50),
            **device_ms(lambda: kernel(*k_args, metric="euclidean"), 20),
            plain_ms=median_ms(lambda: plain(*k_args, metric="euclidean"), 5),
            **bound(nbytes, flops, FP32_FLOPS),
            library_ms=None, shape=dict(B=B, L=Lc, n=N, d=D, unique_rows=uniq),
        ))

    # the fused verify: the kernel, its plain version and the parent's route
    # over one store of the recorded rows (a zero row swapped in where named)
    def fp32(rows, metric):
        st = Fp32Store(rows=rows)
        fused = lambda: l2_ops.gather_topk(rows, ids, queries, k, metric=metric,
                                           report_ids=l2_kw["report_ids"])
        parent = lambda: stages.topk_ids(st.gather_dist(ids, queries, metric=metric,
                                                        use_kernel=True),
                                         l2_kw["report_ids"], k)
        plain = lambda: gather_topk_ref(rows, ids, queries, k, metric=metric,
                                        report_ids=l2_kw["report_ids"])
        return fused, parent, plain

    def int8(rows, metric):
        st = Int8Store(q=rows, scale=scale)
        fused = lambda: q_ops.gather_topk_q(rows, scale, ids_q, queries_q, r, metric=metric,
                                            survivors=True)

        def parent():
            vals, idx = stages._smallest(st.gather_dist(ids_q, queries_q, metric=metric,
                                                        use_kernel=True), r)
            return torch.gather(ids_q, 1, idx), vals

        plain = lambda: gather_topk_q_ref(rows, scale, ids_q, queries_q, r, metric=metric,
                                          survivors=True)
        return fused, parent, plain

    for name, make, rows, b_ids, cols, row_bytes, repl, consumer in (
        ("gather_l2_topk", fp32, data, ids, k, 4 * D, l2_src, "src/repro/exec/stages.py:150"),
        ("gather_q_topk", int8, codes, ids_q, r, D + 4, q_src, "src/repro/exec/stages.py:187"),
    ):
        err = 0.0
        for metric in ("euclidean", "angular"):
            for zero in (False, True):
                z_rows = rows
                if zero:  # the first candidate's row zero: NaN -> 1 under angular
                    z_rows = rows.clone()
                    z_rows[max(0, int(b_ids[0, 0]))] = 0
                fused, parent, plain = make(z_rows, metric)
                f_out, p_out, q_out = fused(), parent(), plain()
                if not (torch.equal(f_out[0], p_out[0])
                        and torch.equal(f_out[1].view(torch.int32),
                                        p_out[1].view(torch.int32))):
                    fail(f"{name} {metric} (zero row {zero}): the fused kernel differs from "
                         "the scan kernel + the plain epilogue")
                torch.testing.assert_close(f_out[1], q_out[1], **GATHER_TOL)
                fin = torch.isfinite(q_out[1])
                err = max(err, float((f_out[1][fin] - q_out[1][fin]).abs().max()))
        fused, parent, plain = make(rows, "euclidean")
        B, Lc = b_ids.shape
        live = b_ids >= 0
        uniq = int(torch.unique(b_ids[live]).numel())
        # bytes: the live rows read once, the ids (and the report ids of the
        # exact mode, here the same tensor) and the queries read once, the
        # (B, cols) ids and values written once; 3d flops a live candidate
        nbytes = uniq * row_bytes + b_ids.numel() * 4 + B * D * 4 + B * cols * 8
        flops = 3 * int(live.sum()) * D
        out.append(dict(
            name=name, route="cuda", source=src, replaces=repl, consumer=consumer,
            launches=launches[name], max_abs_err=err,
            ms=median_ms(fused, 50), **device_ms(fused, 20),
            plain_ms=median_ms(plain, 5), parent_route_ms=median_ms(parent, 50),
            **device_ms(parent, 20, key="parent_route_device"),
            **bound(nbytes, flops, FP32_FLOPS), library_ms=None,
            shape=dict(B=B, L=Lc, n=N, d=D, k=cols, unique_rows=uniq,
                       mode="survivors" if name == "gather_q_topk" else "exact_topk"),
            checked_bit_identical=["scan kernel + store epilogue + "
                                   + ("_smallest" if name == "gather_q_topk" else "topk_ids")],
        ))
    return out


def verify_repeats(cpu, gpu, Qs, cand: dict, reps: int = 20) -> dict:
    """C8: each device's verify on phase 7's inputs (`cand`: source ->
    (params, CPU candidates, card candidates)) run `reps` times; per source
    and device, how many reruns differ from the first run (ids or
    distances, bit for bit)."""
    from repro_torch.exec import stages

    out = {}
    for source, (p, ci, gi) in cand.items():
        counts = {}
        for tag, idx, q, ids in (("card", gpu, Qs.to(gi.device), gi), ("cpu", cpu, Qs, ci)):
            first = stages.verify(idx.store, idx.tail, q, ids, p, "euclidean")
            counts[tag] = sum(
                not (torch.equal(a[0], first[0])
                     and torch.equal(a[1].view(torch.int32), first[1].view(torch.int32)))
                for a in (stages.verify(idx.store, idx.tail, q, ids, p, "euclidean")
                          for _ in range(reps)))
        out[source] = counts
    return out


def explain_verify_mismatch(cpu, gpu, Qs, ci, gi, p, source: str, cd, gd) -> None:
    """Print what differs when the card's and the CPU's verify disagree
    (their first results cd and gd): the inputs, the gather kernel against
    its plain version on both devices, and a second run of each device's
    verify held to its first (the side whose rerun differs is the one whose
    first result was wrong)."""
    from repro_torch.exec import stages
    from repro_torch.kernels.gather_l2 import gather_dist_kernel, gather_dist_ref

    dev = gi.device
    qd = Qs.to(dev)

    def rel(a, b):
        a, b = a.cpu(), b.cpu()
        ok = torch.isfinite(a) & torch.isfinite(b)
        return float(((a - b).abs() / b.abs().clamp(min=1e-6))[ok].max())

    k = gather_dist_kernel(gpu.store.rows, gi, qd)
    # every candidate's distance on both devices, against float64 on the CPU
    full_c = cpu.store.gather_dist(ci, Qs, metric="euclidean", use_kernel=True)
    full_g = gpu.store.gather_dist(gi, qd, metric="euclidean", use_kernel=True).cpu()
    rows = cpu.store.rows[torch.clamp(ci, min=0).long()].double()
    f64 = ((rows - Qs.double()[:, None, :]) ** 2).sum(-1).sqrt()
    bad = ~torch.isclose(full_c, full_g, **GATHER_TOL) & (ci >= 0)
    bad_first = ~torch.isclose(cd, gd.cpu(), **GATHER_TOL)
    g_again = stages.verify(gpu.store, gpu.tail, qd, gi, p, "euclidean")[1]
    c_again = stages.verify(cpu.store, cpu.tail, Qs, ci, p, "euclidean")[1]
    emit(phase="verify_mismatch", source=source,
         bad_slots=int(bad.sum()), bad_queries=bad.any(dim=1).nonzero()[:, 0].tolist(),
         cpu_vs_float64=rel(full_c, f64), card_vs_float64=rel(full_g, f64),
         tf32=[torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
               torch.get_float32_matmul_precision()],
         rows_equal=torch.equal(cpu.store.rows, gpu.store.rows.cpu()),
         ids_equal=torch.equal(ci, gi.cpu()), queries_equal=torch.equal(Qs, qd.cpu()),
         kernel_vs_card_plain=rel(k, gather_dist_ref(gpu.store.rows, gi, qd)),
         kernel_vs_cpu_plain=rel(k, gather_dist_ref(cpu.store.rows, ci, Qs)),
         queries_first_results_differ=bad_first.any(dim=1).nonzero()[:, 0].tolist(),
         card_first_equals_rerun=torch.equal(gd, g_again),
         cpu_first_equals_rerun=torch.equal(cd, c_again),
         reruns_close=torch.allclose(c_again, g_again.cpu(), **GATHER_TOL))


def exact_top_cos(X: torch.Tensor, Q: torch.Tensor, k: int) -> torch.Tensor:
    """Ground-truth k most cosine-similar rows of a row-normalised X, by
    chunked Q @ X.T (smoke check only)."""
    out = []
    for s in range(0, Q.shape[0], BATCH):
        out.append(torch.topk(Q[s:s + BATCH] @ X.T, k, dim=1).indices)
    return torch.cat(out)


def probe_bound_ms(args, boundary: int) -> float:
    """csa_probe's least time on a worklist (bytes): per row, the search's
    steps and `boundary` boundary compares, each an I entry and at least the
    first compared Hd symbol of its row; 2W I and L window entries; the
    (R, 2W) ids and lcps written; the worklist; and the probe symbols the
    rows read, once (every shift of an lccs probe reads its doubled string,
    a pairs row its own probe's m symbols).  The lccs worklist keeps the
    two boundary compares of the earlier slices' formula, so its of_bound
    compares with theirs; the kernel takes the boundary LCPs from the rows
    its search compared, so the pairs worklist counts none."""
    I, _, _, qd, shifts, _, width = args
    (m, n), R = I.shape, shifts.shape[0]
    steps = max(1, n.bit_length())
    probe_bytes = min(qd.numel(), R * m) * 4
    nbytes = R * ((steps + boundary) * 8 + 2 * width * 8 + 2 * width * 8 + 8) + probe_bytes
    return nbytes / HBM_BYTES_PER_S * 1e3


def bound(nbytes: float, ops: float, rate: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over their peak rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def with_ratios(rec: dict) -> None:
    """Add of_bound (bound_ms / ms) and vs_library (ms / library_ms, None
    without a library call) to a kernel record."""
    rec["of_bound"] = rec["bound_ms"] / rec["ms"]
    rec["vs_library"] = rec["ms"] / rec["library_ms"] if rec.get("library_ms") else None


def rp_mismatch(x, a, b, w: float, k: torch.Tensor, p: torch.Tensor):
    """Hold hash_rp's kernel output k to its plain version p: they may differ
    by one bucket, only where the float64 value lies within
    HASH_BOUNDARY_RTOL of a bucket boundary, in at most HASH_MAX_SHARE of the
    outputs.  Returns (max abs difference, mismatch share)."""
    diff = k != p
    n_diff = int(diff.sum())
    if n_diff:
        rows = diff.any(dim=1).nonzero()[:, 0]
        v = (x[rows].double() @ a.double() + b.double()) / w
        near = (v - torch.round(v)).abs() <= HASH_BOUNDARY_RTOL * torch.clamp(v.abs(), min=1.0)
        if bool((diff[rows] & ~near).any()) or int((k - p).abs().max()) > 1:
            fail("hash_rp kernel differs from its plain version away from a bucket boundary")
    share = n_diff / diff.numel()
    if share > HASH_MAX_SHARE:
        fail(f"hash_rp mismatch share {share} > {HASH_MAX_SHARE}")
    return int((k - p).abs().max()), share


def xp_mismatch(x, rot, k: torch.Tensor, p: torch.Tensor):
    """Hold hash_xp's kernel output k to its plain version p: they may pick
    another vertex only where the two largest of cat([y, -y]) in float64 are
    within HASH_BOUNDARY_RTOL (relative), in at most HASH_MAX_SHARE of the
    outputs.  Returns (max abs difference, mismatch share)."""
    diff = k != p
    n_diff = int(diff.sum())
    if n_diff:
        rows = diff.any(dim=1).nonzero()[:, 0]
        y = torch.einsum("nd,mde->nme", x[rows].double(), rot.double())
        top2 = torch.topk(torch.cat([y, -y], dim=-1), 2, dim=-1).values
        near = (top2[..., 0] - top2[..., 1]) <= HASH_BOUNDARY_RTOL * top2[..., 0].abs()
        if bool((diff[rows] & ~near).any()):
            fail("hash_xp kernel differs from its plain version away from a near tie")
    share = n_diff / diff.numel()
    if share > HASH_MAX_SHARE:
        fail(f"hash_xp mismatch share {share} > {HASH_MAX_SHARE}")
    return int((k - p).abs().max()), share


def pow2_at_least(x: int) -> int:
    return 1 << (x - 1).bit_length()


def require(counts: dict, names, path: str) -> None:
    for k in names:
        if counts[k] == 0:
            fail(f"kernel {k} was never launched on the {path} path")


def dyadic(x, bits: int = 4) -> np.ndarray:
    """Round to multiples of 2^-bits: the projections of such rows by such a
    family are exact in fp32, so the card and the CPU hash them alike."""
    return (np.round(np.asarray(x, np.float64) * 2 ** bits) / 2 ** bits).astype(np.float32)


def run_angular(ctx) -> dict:
    """Phase 8: the paper's sift-angular configuration (normalised rows,
    gaussian cross-polytope family, m = 64) built and searched on the card."""
    from repro_torch.core import LCCSIndex, SearchParams
    from repro_torch.data import clustered_vectors, queries_from
    from repro_torch.kernels import common

    dev = ctx["dev"]
    Xa_np = clustered_vectors(N, D, n_clusters=100, seed=0, normalize=True)
    Qa_np = queries_from(Xa_np, N_QUERIES, jitter=0.001, seed=1)
    Xa = torch.from_numpy(Xa_np).to(dev)
    Qa = torch.from_numpy(Qa_np).to(dev)
    del Xa_np
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    common.reset_launch_counts()
    aidx, build_s = sync_time(lambda: LCCSIndex.build(
        Xa, m=M, family="angular", rotation="gaussian", device=dev))
    build_counts = common.launch_counts()
    emit(phase="build_index", config="sift-angular gaussian", n=N, d=D, m=M, seconds=build_s,
         index_bytes=aidx.index_bytes(), store_bytes=aidx.store_bytes(),
         peak_mem_bytes=torch.cuda.max_memory_allocated(), mem_before_bytes=base)
    p = SearchParams(**LCCS)
    aidx.search(Qa[:BATCH], p)  # warm-up
    (ids, dists), search_counts, timing = qps_passes(lambda: run_searches(aidx, Qa, p),
                                                     N_QUERIES)
    check_outputs(ids, dists, N_QUERIES)
    truth = exact_top_cos(Xa, Qa, K)
    top1 = float((ids[:, 0].long() == ctx["src_rows"]).float().mean())
    emit(phase="search", config="sift-angular gaussian", source="lccs", params=LCCS,
         **timing, recall_at_10=recall_at_k(ids, truth),
         top1_self=top1)
    counts = {k: build_counts[k] + search_counts[k] for k in build_counts}
    emit(phase="launches", run="sift-angular build + lccs", counts=counts)
    require(counts, ANGULAR_KERNELS, "angular")
    if top1 < 0.90:
        fail(f"angular lccs top-1 self-retrieval {top1} < 0.90")
    # the index, corpus, queries and exact kNN stay for the baselines phase
    return dict(counts=counts, family=aidx.family, x_rows=Xa[:65_536].clone(),
                queries=Qa[:BATCH].clone(), index=aidx, X=Xa, Q=Qa, truth=truth,
                build_s=build_s)


def timed_call(call):
    """The paper's timing (`benchmarks/common.py:timed`): one warm-up call,
    whose kernel launches are counted, then the median of 2 calls on the
    host clock fenced by synchronize.  Returns (result, counts, seconds).
    Phase 8b's points keep it, not QPS_PASSES: it is the timing the paper's
    figures were read with, and the hash-table baselines are host numpy
    loops a query whose calls take seconds each, so more passes would add
    minutes to the run without a claim resting on these QPS."""
    from repro_torch.kernels import common

    common.reset_launch_counts()
    out, _ = sync_time(call)
    counts = common.launch_counts()
    secs = []
    for _ in range(2):
        out, s = sync_time(call)
        secs.append(s)
    return out, counts, statistics.median(secs)


def overall_ratio(dists: torch.Tensor, gt_d: torch.Tensor) -> float:
    """`benchmarks/common.py:overall_ratio`: the mean over the k ranks of
    Dist(o_i, q) / Dist(o_i*, q), 1 where a rank is missing or the true
    distance is 0."""
    d, g = dists.double(), gt_d.double()
    ok = torch.isfinite(d) & (g > 1e-12)
    return float(torch.where(ok, d / g.clamp(min=1e-12), torch.ones_like(d)).mean())


def run_baselines(ctx, angular) -> dict:
    """Phase 8b: the paper's comparison set (§6.3) beside LCCS at the SIFT
    shape, on the main and angular paths' corpora, exact kNN and LCCS
    indexes: benchmarks/fig4_5_recall.py's grid over the first 1,000
    queries, one JSON line a point, a summary line (the lower-envelope
    reading of Figs. 4/5), the theory line, and each baseline on the card
    against its CPU build at n 20,000.  Returns the counted launches."""
    from repro_torch.data import paper_dataset_analogue
    from repro_torch.kernels import common

    t0 = time.perf_counter()
    # the two corpora are the paper's dataset analogues, bit for bit
    for name, corpus in (("sift", ctx["X_np"]), ("sift-angular", angular["X"].cpu().numpy())):
        analogue, _ = paper_dataset_analogue(name)
        if not np.array_equal(corpus, analogue):
            fail(f"the {name} corpus is not paper_dataset_analogue({name!r})")
        del analogue
    emit(phase="baselines_data", sift="paper_dataset_analogue('sift')",
         sift_angular="paper_dataset_analogue('sift-angular')", n_clusters=100,
         query_jitter=dict(sift=0.05, sift_angular=0.001), queries=BASE_QUERIES, ok=True)
    counts = dict.fromkeys(common.LAUNCHES, 0)
    keys = ("index", "X", "Q", "truth", "build_s")
    for tag, path in (("euclidean", ctx), ("angular", angular)):
        part = compare_methods(tag, **{k: path[k] for k in keys})
        counts = {k: counts[k] + part.get(k, 0) for k in counts}
    common.reset_launch_counts()
    theory_line(ctx)
    counts = {k: counts[k] + v for k, v in common.launch_counts().items()}
    baselines_vs_cpu(ctx, angular)
    emit(phase="baselines_done", seconds=time.perf_counter() - t0,
         launches={k: v for k, v in counts.items() if v})
    return counts


def compare_methods(metric: str, index, X, Q, truth, build_s) -> dict:
    """One metric's points: LCCS at each lam (and MP-LCCS at each probes x
    lam on the Euclidean path) through the path's index, each baseline
    built on the card, LinearScan; then the summary line."""
    from repro_torch import baselines
    from repro_torch.core import SearchParams, candidates, lsh

    angular = metric == "angular"
    Qb, truth = Q[:BASE_QUERIES], truth[:BASE_QUERIES].long()
    gt_d = lsh.distance(X[truth], Qb[:, None, :], metric).sort(dim=1).values
    hash_kernel = "hash_xp" if angular else "hash_rp"
    points, total = [], {}

    def point(method, params, call, build_seconds, index_bytes, cands=None, obj=None):
        (ids, dists), counts, secs = timed_call(call)
        if ids.shape != (BASE_QUERIES, K) or dists.shape != ids.shape or ids.dtype != torch.int32:
            fail(f"{metric} {method}: bad output shapes {tuple(ids.shape)} {tuple(dists.shape)}")
        if not torch.isfinite(dists[ids >= 0]).all():
            fail(f"{metric} {method}: non-finite distances")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        rec = dict(phase="baselines", metric=metric, method=method, params=params,
                   queries=BASE_QUERIES, build_s=build_seconds, qps=BASE_QUERIES / secs,
                   seconds=secs, recall_at_10=recall_at_k(ids, truth),
                   ratio=overall_ratio(dists, gt_d), index_bytes=index_bytes,
                   last_cands=obj.last_cands if obj is not None else cands,
                   empty_queries=int((ids[:, 0] < 0).sum()),
                   launches={k: v for k, v in counts.items() if v})
        emit(**rec)
        points.append(rec)
        return rec, counts

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # from_legacy's width < lam warning, as the grid takes it
        for probes in ((1,) + BASE_PROBES if not angular else (1,)):
            for lam in BASE_LAMS:
                p = SearchParams.from_legacy(k=K, lam=lam, probes=probes)
                cand = int((candidates(index, Qb, p)[0] >= 0).sum())
                point("LCCS" if probes == 1 else "MP-LCCS",
                      dict(lam=lam, probes=probes, source=p.source, width=p.resolved_width()),
                      lambda: index.search(Qb, p), build_s, index.index_bytes(), cands=cand)
    grid = ANGULAR_BASELINES if angular else EUCLID_BASELINES
    for method, kw in grid:
        kw = dict(kw, family="angular", rotation="gaussian") if angular else kw
        obj, b_s = sync_time(lambda: getattr(baselines, method).build(X, seed=0, device=X.device,
                                                                      **kw))
        _, counts = point(method, kw, lambda: obj.query(Qb, **BASE_QUERY), b_s,
                             obj.stats()["index_bytes"], obj=obj)
        require(counts, (hash_kernel, "gather_l2_topk"), f"{metric} {method} {kw}")
        del obj
    scan = baselines.LinearScan.build(X, metric=metric, device=X.device)
    rec, _ = point("LinearScan", dict(metric=metric), lambda: scan.query(Qb, k=K), 0.0, 0)
    if rec["recall_at_10"] < 0.999:
        fail(f"{metric} LinearScan recall@10 {rec['recall_at_10']} < 0.999")
    emit(phase="baselines_summary", metric=metric, **envelope(points))
    return total


def envelope(points: list) -> dict:
    """The lower-envelope reading of Figs. 4/5: each method's best recall and
    its QPS there, beside LCCS's QPS at the smallest lam that reaches that
    recall (None where no lam does)."""
    lccs = sorted((p for p in points if p["method"] == "LCCS"), key=lambda p: p["params"]["lam"])
    methods = {}
    for name in dict.fromkeys(p["method"] for p in points if p["method"] != "LCCS"):
        best = max((p for p in points if p["method"] == name),
                   key=lambda p: (p["recall_at_10"], p["qps"]))
        reach = next((p for p in lccs if p["recall_at_10"] >= best["recall_at_10"]), None)
        methods[name] = dict(best_recall=best["recall_at_10"], qps=best["qps"],
                             params=best["params"],
                             lccs_lam=None if reach is None else reach["params"]["lam"],
                             lccs_qps=None if reach is None else reach["qps"])
    return dict(methods=methods, lccs=[dict(lam=p["params"]["lam"], recall=p["recall_at_10"],
                                            qps=p["qps"]) for p in lccs])


def theory_line(ctx) -> None:
    """The paper's closed forms beside what cell 1's family does on the
    first 1,000 queries and their exact nearest neighbours: the
    per-function collision rate, the mean of Eq. 2 at those pairs'
    distances, the pairs' |LCCS| (the circrun kernel, one launch over the
    batch, its diagonal) beside Lemma 5.2's median, and Theorem 5.1's lambda
    for p1 at the median distance and p2 at twice it."""
    from repro_torch.core import lsh, theory
    from repro_torch.kernels.circrun import circrun

    X, fam = ctx["X"], ctx["index"].family
    Qb = ctx["Q"][:BASE_QUERIES]
    nn = X[ctx["truth"][:BASE_QUERIES, 0]]
    hq, hn = fam.hash(Qb), fam.hash(nn)
    tau = lsh.distance(nn, Qb, "euclidean").double().cpu().numpy()
    lens = circrun(hn, hq).diagonal()
    tau_med = float(np.median(tau))
    p1, p2 = fam.collision_prob(tau_med), fam.collision_prob(2 * tau_med)
    rec = dict(phase="baselines_theory", family=dict(kind="euclidean", m=M, w=W_BUCKET),
               pairs=BASE_QUERIES, tau_median=tau_med,
               collision_rate=float((hq == hn).double().mean()),
               rp_collision_prob_mean=float(np.mean([theory.rp_collision_prob(t, W_BUCKET)
                                                     for t in tau])),
               p1=p1, p2=p2, rho=theory.rho(p1, p2),
               lccs_mean=float(lens.double().mean()), lccs_median_lemma52=theory.lccs_median(M, p1),
               theorem51_lambda=theory.theorem51_lambda(M, N, p1, p2))
    emit(**rec)
    bad = [k for k, v in rec.items() if isinstance(v, float) and not np.isfinite(v)]
    if bad:
        fail(f"the theory line has non-finite values: {bad}")


def baselines_vs_cpu(ctx, angular) -> None:
    """Each baseline of the grid built on the card and on the CPU over one
    family, at n 20,000 and 50 queries: ids and last_cands equal, distances
    within GATHER_TOL.  Rows, queries and families are dyadic (exact
    projections on both devices, as phase 10), so the hashes agree bit for
    bit and any difference is a fault."""
    from repro_torch import baselines
    from repro_torch.kernels import common

    dev = ctx["dev"]
    rows = {"euclidean": dyadic(ctx["X_np"][:BASE_SMALL_N]),
            "angular": dyadic(angular["x_rows"][:BASE_SMALL_N].cpu(), bits=10)}
    queries = {"euclidean": rows["euclidean"][:BASE_SMALL_Q] + 0.0625,
               "angular": rows["angular"][:BASE_SMALL_Q] + 2.0 ** -8}
    checked = []
    for metric in ("euclidean", "angular"):
        grid = ANGULAR_BASELINES if metric == "angular" else EUCLID_BASELINES
        for method, kw in grid + (("LinearScan", dict(metric=metric)),):
            fam = None
            if method != "LinearScan":
                fam = small_family(metric, kw["m"] if method == "C2LSH" else kw["K"] * kw["L"])
            out = {}
            for device in ("cpu", dev):
                dkw = dict(kw) if fam is None else dict(kw, family=family_on(fam, device))
                obj = getattr(baselines, method).build(rows[metric], seed=0, device=device,
                                                       **dkw)
                common.reset_launch_counts()
                ids, dists = obj.query(queries[metric], **BASE_QUERY)
                out["card" if device == dev else "cpu"] = (
                    ids.cpu(), dists.cpu(), getattr(obj, "last_cands", None),
                    common.launch_counts())
            (ci, cd, cc, _), (gi, gd, gc, counts) = out["cpu"], out["card"]
            if fam is not None:
                require(counts, ("hash_xp" if metric == "angular" else "hash_rp",
                                 "gather_l2_topk"), f"small {metric} {method}")
            bad = ~((ci == gi).all(dim=1) & torch.isclose(cd, gd, **GATHER_TOL).all(dim=1))
            if bool(bad.any()) or cc != gc:
                b = int(bad.nonzero()[0, 0]) if bool(bad.any()) else 0
                emit(phase="baselines_mismatch", metric=metric, method=method, params=kw,
                     first_query=b, cpu_ids=ci[b].tolist(), card_ids=gi[b].tolist(),
                     cpu_dists=cd[b].tolist(), card_dists=gd[b].tolist(),
                     differing_queries=int(bad.sum()), cpu_last_cands=cc, card_last_cands=gc)
                fail(f"small input: {metric} {method} {kw} differs between card and CPU")
            checked.append(f"{metric} {method} {kw}")
    emit(phase="baselines_vs_cpu", n=BASE_SMALL_N, queries=BASE_SMALL_Q, checked=checked,
         tolerance=dict(ids="equal", dists=GATHER_TOL), ok=True)


def family_on(fam, device):
    """A copy of family `fam` on `device`, through its arrays."""
    import dataclasses

    from repro_torch.core import lsh

    fields = {f.name: getattr(fam, f.name) for f in dataclasses.fields(fam)}
    return lsh.family_from_arrays(type(fam).__name__, {
        k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v for k, v in fields.items()},
        device)


def small_family(metric: str, m: int):
    """A CPU family of m functions with dyadic parameters: the Euclidean
    phase 10 way (a and b to 2^-4), or a gaussian rotation to 2^-12, whose
    products with rows to 2^-10 sum exactly in float32."""
    from repro_torch.core import lsh

    if metric == "euclidean":
        fam = lsh.make_family("euclidean", 0, D, m, device="cpu", w=W_BUCKET)
        fam.a, fam.b = (torch.from_numpy(dyadic(t)) for t in (fam.a, fam.b))
        return fam
    fam = lsh.make_family("angular", 0, D, m, device="cpu", rotation="gaussian")
    fam.rot = torch.from_numpy(dyadic(fam.rot, bits=12))
    return fam


def run_dynamic(ctx) -> dict:
    """Phase 9: the dynamic index on the main corpus: bulk load, streamed
    inserts, deletes from segment and buffer, search, compaction, search."""
    from repro_torch.core import SearchParams, SegmentedLCCSIndex
    from repro_torch.kernels import common

    dev, X, Q = ctx["dev"], ctx["X"], ctx["Q"]
    common.reset_launch_counts()
    didx, bulk_s = sync_time(lambda: SegmentedLCCSIndex.build(
        X[:N_BULK], m=M, family="euclidean", w=W_BUCKET, device=dev))
    bulk_counts = common.launch_counts()
    ingest_counts = ingest_vs_bulk(ctx, didx)  # counted apart from the dynamic path
    common.reset_launch_counts()
    insert_s = []
    for s in range(N_BULK, N, INSERT_ROWS):
        _, secs = sync_time(lambda: didx.insert(X[s:s + INSERT_ROWS]))
        insert_s.append(secs)
    dels = np.random.default_rng(3).choice(N, N_DELETE, replace=False)
    was_live, del_s = sync_time(lambda: didx.delete(dels))
    if was_live != N_DELETE:
        fail(f"delete reported {was_live} live rows, expected {N_DELETE}")
    emit(phase="dynamic_load", bulk_rows=N_BULK, bulk_seconds=bulk_s,
         insert_rows=INSERT_ROWS, insert_seconds=insert_s, delete_seconds=del_s,
         deleted_in_buffer=int((dels >= N_BULK).sum()), n_live=didx.n_live,
         buffer_count=didx.buffer_count, segment_caps=[sg.cap for sg in didx.segments],
         index_bytes=didx.index_bytes(), store_bytes=didx.store_bytes())
    caps = [pow2_at_least(N_BULK), pow2_at_least(N - N_BULK)]
    if [sg.cap for sg in didx.segments] != caps[:1] or didx.buffer_count != N - N_BULK:
        fail(f"the bulk load did not give one segment of {caps[0]} rows and a full buffer")
    live = didx.alive[:N].clone()
    live_rows = live.nonzero()[:, 0]
    truth = live_rows[exact_knn(X[live_rows], Q, K)]
    src_live = live[ctx["src_rows"]]
    p = SearchParams(**LCCS)
    buf_h = didx.buf_h.clone()  # the full delta buffer and its live slots, for phase 12
    buf_ok = didx._live(didx.buf_gid)

    def searched(tag, counts_before):
        didx.search(Q[:BATCH], p)  # warm-up
        (ids, dists), counts, timing = qps_passes(lambda: run_searches(didx, Q, p), N_QUERIES)
        check_outputs(ids, dists, N_QUERIES)
        got = ids[ids >= 0].long()
        if bool((~live[got]).any()):
            fail(f"dynamic search ({tag}) returned a deleted id")
        hit1 = (ids[:, 0].long() == ctx["src_rows"]) & src_live
        top1 = float(hit1.sum()) / float(src_live.sum())
        emit(phase="search", config="dynamic sift", state=tag, source="lccs", params=LCCS,
             **timing, recall_at_10=recall_at_k(ids, truth),
             top1_self_live=top1, segment_sizes=didx.segment_sizes(),
             buffer_count=didx.buffer_count)
        if top1 < 0.90:
            fail(f"dynamic lccs top-1 self-retrieval {top1} < 0.90 ({tag})")
        return {k: counts_before[k] + counts[k] for k in counts}

    counts = searched("segment + buffer",
                      {k: bulk_counts[k] + v for k, v in common.launch_counts().items()})
    emit(phase="launches", run="dynamic load + lccs", counts=counts)
    emit(phase="stages", config="dynamic sift", state="segment + buffer", batch=BATCH,
         ms=dynamic_stage_ms(didx, Q[:BATCH], p))
    common.reset_launch_counts()
    merged, comp_s = sync_time(lambda: didx.compact())
    emit(phase="compact", merged_rows=merged, seconds=comp_s,
         segment_sizes=didx.segment_sizes(), segment_caps=[sg.cap for sg in didx.segments])
    if [sg.cap for sg in didx.segments] != caps:
        fail(f"compaction gave segments of {[sg.cap for sg in didx.segments]} rows, "
             f"expected {caps}")
    after = searched("two segments", common.launch_counts())
    counts = {k: counts[k] + after[k] for k in counts}
    emit(phase="launches", run="dynamic load + lccs + compact + lccs", counts=counts)
    require(counts, DYNAMIC_KERNELS, "dynamic")
    qh_batch = didx.family.hash(Q[:BATCH])  # after the count: phase 12's input
    del didx, truth
    torch.cuda.empty_cache()
    small_dynamic_vs_cpu(ctx)
    return dict(counts=counts, ingest_counts=ingest_counts, buf_h=buf_h, ok=buf_ok,
                qh=qh_batch)


def dynamic_stage_ms(didx, qb: torch.Tensor, p) -> dict:
    """Where one dynamic search batch spends its time (not counted as
    launches): hashing, each segment's inner source, the delta buffer's
    top-k (the circrun_topk kernels, and as its yardstick the parent's route:
    circrun's (B, n) lengths, then the int64-key top-k), and the whole
    search call."""
    from repro_torch.core import LCCSIndex, get_source
    from repro_torch.core.lsh import topk_largest_lcp
    from repro_torch.core.segments import _buffer_topk
    from repro_torch.exec import resolve_params
    from repro_torch.kernels.circrun import circrun

    pr = resolve_params(didx, p)
    inner = get_source(pr.inner)
    qh = didx.family.hash(qb)
    ms = {"hash_queries (hash_rp)": median_ms(lambda: didx.family.hash(qb), 5)}
    for seg in didx.segments:
        view = LCCSIndex(family=didx.family, store=didx.store, h=seg.h, csa=seg.csa,
                         metric=didx.metric, tail=didx.tail)
        ms[f"segment of {seg.cap} rows: {pr.inner}"] = median_ms(
            lambda: inner(view, qb, qh, pr), 5)
    nb = didx.buf_h.shape[0]
    ok = didx._live(didx.buf_gid)

    def parent_route():
        lens = circrun(didx.buf_h, qh)
        return topk_largest_lcp(torch.where(ok, lens, torch.full_like(lens, -1)), min(pr.lam, nb))

    ms[f"buffer of {nb} rows: top-k (_buffer_topk, circrun_topk)"] = median_ms(
        lambda: _buffer_topk(didx, qh, pr.lam), 5)
    ms[f"buffer of {nb} rows: circrun + topk_largest_lcp (the parent's route)"] = median_ms(
        parent_route, 5)
    ms["search (whole batch)"] = median_ms(lambda: didx.search(qb, p), 5)
    return ms


def small_dynamic_vs_cpu(ctx) -> None:
    """Phase 10: the same ops on a CPU and a card dynamic index sharing one
    family, on dyadic rows (exact projections on both devices): equal hash
    strings and CSA tables, equal candidates for shared query strings."""
    from repro_torch.core import SearchParams, SegmentedLCCSIndex
    from repro_torch.exec import stages

    dev = ctx["dev"]
    Xs = dyadic(ctx["X_np"][:4000])
    pair = []
    for device in ("cpu", dev):
        idx = SegmentedLCCSIndex.create(D, m=M, family="euclidean", w=W_BUCKET, device=device)
        idx.family.a = torch.from_numpy(dyadic(idx.family.a.cpu())).to(device)
        idx.family.b = torch.from_numpy(dyadic(idx.family.b.cpu())).to(device)
        idx.insert(Xs[:3000])
        idx.compact()
        idx.insert(Xs[3000:3500])
        idx.delete(np.arange(0, 3500, 9))
        idx.insert(Xs[3500:])
        pair.append(idx)
    cpu, gpu = pair
    if not torch.equal(cpu.buf_h, gpu.buf_h.cpu()):
        fail("small dynamic input: buffer hash strings differ between card and CPU")
    for s_c, s_g in zip(cpu.segments, gpu.segments, strict=True):
        for t_c, t_g in zip(s_c.csa.tables(), s_g.csa.tables()):
            if not torch.equal(t_c, t_g.cpu()):
                fail("small dynamic input: segment tables differ between card and CPU")
    Qs = torch.from_numpy(Xs[:64] + 0.0625)
    qh = cpu.family.hash(Qs)
    for inner in ("lccs", "multiprobe-skip", "bruteforce"):
        kw = dict(SKIP) if inner == "multiprobe-skip" else dict(LCCS)
        kw.update(source="segmented", inner=inner)
        p = SearchParams(**kw, use_probe_kernel=True, use_gather_kernel=True)
        ci, cl = stages.probe(cpu, Qs, qh, p)
        gi, gl = stages.probe(gpu, Qs.to(dev), qh.to(dev), p)
        if not (torch.equal(ci, gi.cpu()) and torch.equal(cl, gl.cpu())):
            fail(f"small dynamic input: {inner} candidates differ between card and CPU")
        _, cd = stages.verify(cpu.store, cpu.tail, Qs, ci, p, "euclidean")
        _, gd = stages.verify(gpu.store, gpu.tail, Qs.to(dev), gi, p, "euclidean")
        torch.testing.assert_close(cd, gd.cpu(), **GATHER_TOL)
    emit(phase="small_dynamic_vs_cpu", n=4000, segments=cpu.segment_sizes(),
         buffer_count=cpu.buffer_count, ok=True)


def span_seconds(events: list) -> dict:
    """Seconds per span name, summed over the spans of that name (the
    out-of-core build's `build.*` and `csa.*` spans)."""
    out: dict = {}
    for e in events:
        out[e["name"]] = out.get(e["name"], 0.0) + e["dur"] / 1e6
    return out


def traced(fn):
    """(result, seconds, spans) of fn() on the host clock, fenced, with the
    port's tracing on for the call (`span_seconds` of its spans)."""
    from repro_torch.obs.trace import clear_trace, disable_tracing, enable_tracing, events

    enable_tracing()
    try:
        out, secs = sync_time(fn)
        spans = span_seconds(events())
    finally:
        disable_tracing()
        clear_trace()
    return out, secs, spans


def run_out_of_core(ctx) -> dict:
    """Phase 7b: cell 1's corpus built out of core from the host rows
    (`LCCSIndex.build(chunk_rows=OOC_CHUNK)`, int8 store, fp32 tail streamed
    to disk): its tables equal the monolithic fp32 index's, its store
    index8's, its tail file the rows; `hash_rp` launched once a chunk; the
    10,000 `lccs` queries (the disk tail through the plan's host gather)
    give index8's ids.  The build's seconds split by its spans, and its peak
    device memory beside the monolithic int8 build's (phase 5).  Returns
    the phase's launch counts."""
    from repro_torch.core import LCCSIndex, SearchParams
    from repro_torch.kernels import common

    dev, X_np, Q, index, index8 = (ctx[k] for k in ("dev", "X_np", "Q", "index", "index8"))
    t_phase = time.perf_counter()
    chunks = -(-N // OOC_CHUNK)
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        common.reset_launch_counts()
        ooc, build_s, spans = traced(lambda: LCCSIndex.build(
            X_np, m=M, family="euclidean", w=W_BUCKET, store="int8",
            tail_path=Path(tmp) / "tail", chunk_rows=OOC_CHUNK, device=dev))
        peak = torch.cuda.max_memory_allocated() - base
        counts = common.launch_counts()
        if counts["hash_rp"] != chunks:
            fail(f"out_of_core: hash_rp launched {counts['hash_rp']} times for {chunks} chunks")
        tables = (("h", ooc.h, index.h),
                  *zip("I P Hd L".split(), ooc.csa.tables(), index.csa.tables()))
        differ = [name for name, a, b in tables if not torch.equal(a, b)]
        if differ:
            fail(f"out_of_core: the chunked tables {differ} differ from the monolithic build's")
        if not (torch.equal(ooc.store.q, index8.store.q)
                and torch.equal(ooc.store.scale, index8.store.scale)):
            fail("out_of_core: the chunked int8 store differs from index8's")
        if ooc.tail is not None or not np.array_equal(np.load(ooc.tail_path, mmap_mode="r"),
                                                      X_np):
            fail("out_of_core: the disk tail does not hold the corpus rows")
        p8 = SearchParams(**LCCS, store="int8")
        ooc.search(Q[:BATCH], p8)  # warm-up
        (ids, dists), search_counts, timing = qps_passes(lambda: run_searches(ooc, Q, p8),
                                                         N_QUERIES)
        check_outputs(ids, dists, N_QUERIES)
        same = torch.equal(ids, ctx["ids8"])
        dist_diff = float((dists - ctx["d8"]).abs().max())
        footprint = ooc.total_bytes()
        del ooc
    torch.cuda.empty_cache()
    named = ("build.hash", "build.ranks", "csa.merge", "csa.upload")
    emit(phase="out_of_core", n=N, d=D, m=M, store="int8", chunk_rows=OOC_CHUNK, chunks=chunks,
         build_seconds=build_s,
         build_split_seconds={"hash (hash_rp, card)": spans.get("build.hash", 0.0),
                              "ranks (circular_ranks, card)": spans.get("build.ranks", 0.0),
                              "quantize + tail write + copies (rest of the chunk loop)":
                                  spans.get("build.chunks", 0.0) - spans.get("build.hash", 0.0)
                                  - spans.get("build.ranks", 0.0),
                              "host merge (numpy)": spans.get("csa.merge", 0.0),
                              "table upload (+ P on the card)": spans.get("csa.upload", 0.0),
                              "rest": build_s - spans.get("build.chunks", 0.0)
                              - spans.get("csa.merge", 0.0) - spans.get("csa.upload", 0.0)},
         spans_seen=sorted(k for k in spans if k in named or k == "build.chunks"),
         peak_mem_over_base_bytes=peak, total_bytes=footprint,
         monolithic_int8=dict(peak_mem_over_base_bytes=ctx["peak8"],
                              total_bytes=index8.total_bytes()),
         tables_equal_monolithic=True, store_equal_index8=True, tail_equal_rows=True,
         search=dict(source="lccs", params=dict(LCCS, rerank_mult=4), tail="disk", **timing,
                     recall_at_10=recall_at_k(ids, ctx["truth"]), ids_equal_index8=same,
                     max_abs_dist_diff_index8=dist_diff),
         launches=dict(build=counts, search=search_counts),
         seconds=time.perf_counter() - t_phase)
    if not same:
        fail("out_of_core: the chunked index's lccs ids differ from index8's")
    return {k: counts[k] + search_counts[k] for k in counts}


def run_sharded(ctx) -> dict:
    """Phase 7c: cell 1's fp32 index and index8 (resident tail) partitioned
    into S = 4 and S = 3 row shards (333,334 rows a shard, the last padded)
    on the card; the `lccs` and `multiprobe-skip` searches of the main path
    over the 10,000 queries through each: recall@10, QPS at batch 1,000,
    and the launches of the probe, pool and verify kernels, each at least S
    a batch (the verify exactly S a batch); top-1 self-retrieval >= 0.90.
    Then the instrumented plan of each S and store, bit for bit against the
    plain plan, and phase 7d.  Returns the phase's launch counts."""
    from repro_torch.core import SearchParams
    from repro_torch.exec import execute
    from repro_torch.kernels import common

    dev, Q, truth = ctx["dev"], ctx["Q"], ctx["truth"]
    t_phase = time.perf_counter()
    total = {k: 0 for k in common.LAUNCHES}
    n_batches = -(-N_QUERIES // BATCH)
    mono_ids = {("fp32", "lccs"): ctx["results"]["lccs"],
                ("fp32", "multiprobe-skip"): ctx["results"]["multiprobe-skip"],
                ("int8", "lccs"): ctx["ids8"]}
    for S in SHARD_COUNTS:
        (s32, s8), shard_s = sync_time(lambda: (ctx["index"].shard(S), ctx["index8"].shard(S)))
        emit(phase="shard_index", shards=S, rows_per_shard=s32.rows_per_shard,
             padded_rows=S * s32.rows_per_shard - N, seconds=shard_s,
             fp32_total_bytes=s32.total_bytes(), int8_total_bytes=s8.total_bytes())
        for store, sidx in (("fp32", s32), ("int8", s8)):
            verify_kernel = "gather_l2_topk" if store == "fp32" else "gather_q_topk"
            for name, kw in (("lccs", LCCS), ("multiprobe-skip", SKIP)):
                p = SearchParams(**kw, store=store)
                sidx.search(Q[:BATCH], p)  # warm-up (the plan)
                (ids, dists), counts, timing = qps_passes(lambda: run_searches(sidx, Q, p),
                                                          N_QUERIES)
                check_outputs(ids, dists, N_QUERIES)
                top1 = float((ids[:, 0].long() == ctx["src_rows"]).float().mean())
                mono = mono_ids.get((store, name))
                emit(phase="sharded", shards=S, store=store, source=name,
                     params=dict(kw, store=store), **timing,
                     recall_at_10=recall_at_k(ids, truth), top1_self=top1,
                     monolithic_recall_at_10=None if mono is None else recall_at_k(mono, truth),
                     launches={k: counts[k] for k in ("csa_probe", "pool_topk", verify_kernel)},
                     batches=n_batches)
                for k in ("csa_probe", "pool_topk", verify_kernel):
                    if counts[k] < S * n_batches:
                        fail(f"sharded S={S} {store} {name}: {k} launched {counts[k]} times, "
                             f"fewer than {S} a batch")
                if counts[verify_kernel] != S * n_batches:
                    fail(f"sharded S={S} {store} {name}: {verify_kernel} launched "
                         f"{counts[verify_kernel]} times, not {S} a batch")
                if top1 < 0.90:
                    fail(f"sharded S={S} {store} {name}: top-1 self-retrieval {top1} < 0.90")
                for k in total:
                    total[k] += counts[k]
            # the whole pipeline: the instrumented plan's bits == the plain plan's
            p = SearchParams(**LCCS, store=store)
            plain = execute(sidx, Q[:BATCH], p)
            inst = execute(sidx, Q[:BATCH], p, instrument=True)
            if not (torch.equal(plain[0], inst[0]) and torch.equal(plain[1], inst[1])):
                fail(f"sharded S={S} {store}: the instrumented plan's bits differ from the plain "
                     "plan's")
        del s32, s8
        torch.cuda.empty_cache()
    emit(phase="sharded_instrumented", shards=list(SHARD_COUNTS), stores=["fp32", "int8"],
         batch=BATCH, bits_equal=True)
    small_sharded_checks(dev, ctx["X_np"])
    emit(phase="sharded_done", seconds=time.perf_counter() - t_phase)
    return total


def small_sharded_checks(dev, X_np) -> None:
    """Phase 7d: SHARD_SMALL_N dyadic rows hashed by a dyadic family (exact
    projections, so the card and the CPU hash alike), fp32 and int8.  On the
    card, under complete coverage (lam = width >= n, rerank_mult covering
    every survivor), the sharded `lccs` search gives the monolithic ids for
    S = 1..4; at S = 3 under the main path's `lccs` budget the card and the
    CPU (plain versions) give equal ids and distances within GATHER_TOL."""
    from repro_torch.core import LCCSIndex, SearchParams
    from repro_torch.core.csa import build_csa
    from repro_torch.store import make_store

    Xd = dyadic(X_np[:SHARD_SMALL_N])
    Qd = torch.from_numpy(Xd[:64] + 0.0625)
    fam_c = small_family("euclidean", M)

    def mono(device, store):
        fam = family_on(fam_c, device)
        X = torch.from_numpy(Xd).to(device)
        h = fam.hash(X)
        vs = make_store(store, X)
        return LCCSIndex(family=fam, store=vs, h=h, csa=build_csa(h), metric="euclidean",
                         tail=None if vs.exact else X)

    lam = pow2_at_least(SHARD_SMALL_N)
    complete = SearchParams(k=K, lam=lam, width=lam, rerank_mult=-(-lam // K) + 1)
    for store in ("fp32", "int8"):
        card, cpu = mono(dev, store), mono("cpu", store)
        if not torch.equal(card.h.cpu(), cpu.h):
            fail(f"sharded_small {store}: dyadic hash strings differ between card and CPU")
        p = complete.replace(store=store)
        want, want_d = card.search(Qd.to(dev), p)
        for S in (1, 2, 3, 4):
            got, got_d = card.shard(S).search(Qd.to(dev), p)
            if not torch.equal(got, want):
                fail(f"sharded_small {store} S={S}: the sharded ids differ from the monolithic "
                     "ones under complete coverage")
            torch.testing.assert_close(got_d, want_d, **GATHER_TOL)
        pb = SearchParams(**LCCS, store=store)
        ci, cd = cpu.shard(3).search(Qd, pb)
        gi, gd = card.shard(3).search(Qd.to(dev), pb)
        if not torch.equal(ci, gi.cpu()):
            fail(f"sharded_small {store} S=3: the card's ids differ from the CPU's")
        torch.testing.assert_close(gd.cpu(), cd, **GATHER_TOL)
    emit(phase="sharded_small", n=SHARD_SMALL_N, queries=64, stores=["fp32", "int8"],
         complete=dict(lam=lam, width=lam, rerank_mult=complete.rerank_mult, shards=[1, 2, 3, 4],
                       ids_equal_monolithic=True),
         card_vs_cpu=dict(shards=3, params=LCCS, ids_equal=True, dist_tol=GATHER_TOL))


def ingest_vs_bulk(ctx, didx) -> dict:
    """Phase 9a: `SegmentedLCCSIndex.ingest_chunks` of the bulk rows (host
    rows, chunks of OOC_CHUNK) into a fresh index with the same family
    seed: its one segment (2^20 rows, padded) equals the bulk load's
    segment table for table, and a search of the 10,000 queries gives the
    same ids.  Freed before phase 9's inserts.  Returns the phase's own
    launch counts (its ingest and both searches), which stay out of the
    dynamic path's."""
    from repro_torch.core import SearchParams, SegmentedLCCSIndex
    from repro_torch.core.index import iter_row_blocks
    from repro_torch.kernels import common

    dev = ctx["dev"]
    common.reset_launch_counts()
    ing = SegmentedLCCSIndex.create(D, m=M, family="euclidean", w=W_BUCKET, device=dev)
    gids, secs, spans = traced(
        lambda: ing.ingest_chunks(iter_row_blocks(ctx["X_np"][:N_BULK], OOC_CHUNK)))
    if not np.array_equal(gids, np.arange(N_BULK)):
        fail("ingest_chunks: the gids are not 0 .. N_BULK - 1")
    if len(ing.segments) != 1 or len(didx.segments) != 1 or ing.buffer_count:
        fail(f"ingest_chunks: {len(ing.segments)} segments, {ing.buffer_count} buffered rows")
    a, b = ing.segments[0], didx.segments[0]
    pairs = (("h", a.h, b.h), ("gid", a.gid, b.gid),
             *zip("I P Hd L".split(), a.csa.tables(), b.csa.tables()))
    differ = [name for name, x, y in pairs if not torch.equal(x, y)]
    if differ:
        fail(f"ingest_chunks: the segment's {differ} differ from the bulk load's")
    p = SearchParams(**LCCS)
    ids_i, _ = run_searches(ing, ctx["Q"], p)
    ids_b, _ = run_searches(didx, ctx["Q"], p)
    counts = common.launch_counts()
    emit(phase="launches", run="ingest_chunks + lccs (ingested and bulk)", counts=counts)
    emit(phase="ingest_chunks", rows=N_BULK, chunk_rows=OOC_CHUNK, segment_cap=a.cap,
         seconds=secs, split_seconds={"host merge (numpy)": spans.get("csa.merge", 0.0),
                                      "table upload": spans.get("csa.upload", 0.0)},
         segment_equal_bulk=True, ids_equal_bulk=torch.equal(ids_i, ids_b))
    if not torch.equal(ids_i, ids_b):
        fail("ingest_chunks: the ingested index's lccs ids differ from the bulk load's")
    del ing, a
    torch.cuda.empty_cache()
    return counts


def run_bruteforce(ctx) -> dict:
    """Phase 11: the "bruteforce" source (the circrun_topk kernels over all n
    strings) on the main fp32 index, the first 1,000 queries; its stages
    beside the parent's route (circrun's lengths and the int64-key top-k,
    chunk by chunk) on the same batch."""
    from repro_torch.core import SearchParams

    index, Q = ctx["index"], ctx["Q"]
    kw = dict(k=K, lam=100, source="bruteforce")
    p = SearchParams(**kw)
    index.search(Q[:100], p)  # warm-up
    (ids, dists), counts, timing = qps_passes(lambda: index.search(Q[:BATCH], p), BATCH)
    check_outputs(ids, dists, BATCH)
    emit(phase="search", store="fp32", source="bruteforce", params=kw, **timing,
         recall_at_10=recall_at_k(ids, ctx["truth"][:BATCH]),
         top1_self=float((ids[:, 0].long() == ctx["src_rows"][:BATCH]).float().mean()))
    emit(phase="launches", run="fp32 bruteforce", counts=counts)
    require(counts, CIRCRUN_KERNELS, "bruteforce")
    # the batch's time: the fused route (4 chunks of 256 queries), against
    # the parent's route (circrun's lengths, then the top-k of each chunk's
    # int64 ranking keys, 15 chunks of 67 queries), which must agree
    from repro_torch.core.bruteforce import _LENS_ELEMS, bruteforce_topk
    from repro_torch.core.lsh import topk_largest, topk_largest_lcp
    from repro_torch.kernels.circrun import circrun, circrun_topk
    from repro_torch.kernels.circrun.ops import stored_layout

    qh = index.family.hash(Q[:BATCH])
    step = max(1, _LENS_ELEMS // N)

    def parent_route():
        out = [topk_largest_lcp(circrun(index.h, qh[s:s + step]), 100)
               for s in range(0, BATCH, step)]
        return torch.cat([v for v, _ in out]), torch.cat([r for _, r in out])

    fused, parent = circrun_topk(index.h, qh, 100), parent_route()
    if not (torch.equal(fused[0], parent[0]) and torch.equal(fused[1], parent[1])):
        fail("bruteforce: circrun_topk differs from circrun + topk_largest_lcp")
    lens = circrun(index.h, qh[:step])
    if not all(torch.equal(a, b.to(torch.int32)) for a, b in
               zip(topk_largest_lcp(lens, 100), topk_largest(lens, 100))):
        fail("the two top-k of one bruteforce chunk differ")
    kstep = stored_layout(N, M)[2]
    emit(phase="stages", store="fp32", source="bruteforce", batch=BATCH, ms={
        f"circrun_topk (the fused route, chunks of {kstep})": median_ms(
            lambda: circrun_topk(index.h, qh, 100), 3),
        f"circrun + topk_largest_lcp (the parent's route, chunks of {step})": median_ms(
            parent_route, 3),
        f"circrun (chunks of {step})": median_ms(
            lambda: [circrun(index.h, qh[s:s + step]) for s in range(0, BATCH, step)], 3),
        f"top-100 of one ({step}, {N}) chunk: unique int64 keys (topk_largest_lcp)":
            median_ms(lambda: topk_largest_lcp(lens, 100), 3),
        f"top-100 of one ({step}, {N}) chunk: stable sort (topk_largest)":
            median_ms(lambda: topk_largest(lens, 100), 3),
        "bruteforce_topk (circrun_topk + padding)": median_ms(
            lambda: bruteforce_topk(index.h, qh, 100), 3),
        "search (whole batch)": median_ms(lambda: index.search(Q[:BATCH], p), 3),
    }, fused_equals_parent_route=True)
    return counts


def new_kernels_vs_plain(ctx, angular, dynamic, launches) -> list:
    """Phase 12: hash_rp, hash_xp, circrun and circrun_topk against their
    plain versions at the paths' shapes (the hashes also at d = 960 and over
    a query batch), timed beside their bounds and a library call (the hashes
    and their library calls also by their device time alone, `device_ms`;
    circrun_topk also beside the parent's route)."""
    from repro_torch.core.bruteforce import _LENS_ELEMS
    from repro_torch.core.lsh import topk_largest_lcp
    from repro_torch.kernels.circrun import circrun, circrun_ref, circrun_topk
    from repro_torch.kernels.circrun.ref import circrun_topk_plain
    from repro_torch.kernels.hash_rp import hash_rp, hash_rp_ref
    from repro_torch.kernels.hash_xp import hash_xp, hash_xp_ref

    X, index = ctx["X"], ctx["index"]
    kernels = []

    # B6 circrun, bit for bit: the delta buffer's shape, then one chunk of the
    # bruteforce source at n = 10^6
    buf_h, qh = dynamic["buf_h"], dynamic["qh"]
    chunk = max(1, _LENS_ELEMS // N)
    qh_main = index.family.hash(ctx["Q"][:chunk])
    shapes = {}
    for tag, h, q in (("buffer", buf_h, qh), ("bruteforce chunk", index.h, qh_main)):
        if not torch.equal(circrun(h, q), circrun_ref(h, q)):
            fail(f"circrun kernel != plain version at the {tag} shape")
        shapes[tag] = dict(B=int(q.shape[0]), n=int(h.shape[0]), m=int(h.shape[1]))
    Bq, nb = qh.shape[0], buf_h.shape[0]
    c_bytes = 4 * (nb * M + Bq * M + Bq * nb)
    c_ops = Bq * nb * M  # one compare a (pair, position): the least an exact scorer does
    kernels.append(dict(
        name="circrun", route="cuda", source="src/repro_torch/kernels/csrc/circrun.cu",
        replaces="src/repro/kernels/circrun/circrun.py:45", launches=launches["circrun"],
        max_abs_err=0, ms=median_ms(lambda: circrun(buf_h, qh), 20),
        plain_ms=median_ms(lambda: circrun_ref(buf_h, qh), 3),
        **bound(c_bytes, c_ops, INT32_OPS), library_ms=None, int32_ops_per_s=INT32_OPS,
        # the earlier bound, two operations a (pair, position)
        bound_ms_two_ops=bound(c_bytes, 2 * c_ops, INT32_OPS)["bound_ms"],
        shape=shapes["buffer"], checked_bit_identical=shapes,
        launches_note="the scorer's launches, inside circrun_topk on both paths",
    ))

    # B6's consumer: the fused top-k at the delta buffer (its live slots,
    # k 100) and one bruteforce chunk, bit for bit against its plain version
    buf_ok, k = dynamic["ok"], 100
    topk_shapes = {}
    for tag, h, q, ok in (("buffer", buf_h, qh, buf_ok), ("bruteforce chunk", index.h, qh_main,
                                                          None)):
        kv, kr = circrun_topk(h, q, k, ok)
        pv, pr = circrun_topk_plain(h, q, k, ok)
        if not (torch.equal(kv, pv) and torch.equal(kr, pr)):
            fail(f"circrun_topk kernels != plain version at the {tag} shape")
        topk_shapes[tag] = dict(B=int(q.shape[0]), n=int(h.shape[0]), m=int(h.shape[1]), k=k,
                                masked=ok is not None)

    def parent_route():
        lens = circrun(buf_h, qh)
        return topk_largest_lcp(torch.where(buf_ok, lens, torch.full_like(lens, -1)), k)

    # bytes: h, q and ok read once, (B, k) values and rows written once
    t_bytes = 4 * (nb * M + Bq * M) + nb + Bq * k * 8
    kernels.append(dict(
        name="circrun_topk", route="cuda", source="src/repro_torch/kernels/csrc/circrun.cu",
        replaces="src/repro/kernels/circrun/circrun.py:45",
        consumer_of=["src/repro/core/bruteforce.py:34", "src/repro/core/segments.py:496"],
        launches=launches["circrun_topk"], max_abs_err=0,
        ms=median_ms(lambda: circrun_topk(buf_h, qh, k, buf_ok), 20),
        plain_ms=median_ms(lambda: circrun_topk_plain(buf_h, qh, k, buf_ok), 3),
        **bound(t_bytes, c_ops, INT32_OPS),
        bound_ops_ms=c_ops / INT32_OPS * 1e3, bound_bytes_ms=t_bytes / HBM_BYTES_PER_S * 1e3,
        library_ms=None,
        parent_route_ms=median_ms(parent_route, 10),
        shape=topk_shapes["buffer"], checked_bit_identical=topk_shapes,
    ))

    # B4 hash_rp over the full build input of the main path, then at the GIST
    # width (d = 960) on random rows, then over one query batch
    fam = index.family
    a, b, w = fam.a.contiguous(), fam.b.contiguous(), fam.w
    g = torch.Generator(device=X.device)
    g.manual_seed(0)
    xw = torch.randn(WIDE_RP_ROWS, WIDE_D, generator=g, device=X.device) * 5
    aw = torch.randn(WIDE_D, M, generator=g, device=X.device)
    rp = {}
    for tag, x_, a_, b_ in (("main", X, a, b), ("wide", xw, aw, b),
                            ("batch", ctx["Q"][:BATCH], a, b)):
        n_, d_ = x_.shape
        err, share = rp_mismatch(x_, a_, b_, w, hash_rp(x_, a_, b_, w=w),
                                 hash_rp_ref(x_, a_, b_, w=w))
        rp[tag] = dict(
            max_abs_err=err, mismatch_share=share,
            ms=median_ms(lambda: hash_rp(x_, a_, b_, w=w), 20),
            plain_ms=median_ms(lambda: hash_rp_ref(x_, a_, b_, w=w), 5),
            **bound(4 * (n_ * d_ + d_ * M + M + n_ * M), 2 * n_ * d_ * M, FP32_FLOPS),
            library_ms=median_ms(lambda: torch.addmm(b_, x_, a_), 20),
            **device_ms(lambda: hash_rp(x_, a_, b_, w=w), 20),
            **device_ms(lambda: torch.addmm(b_, x_, a_), 20, key="library_device"),
            shape=dict(n=n_, d=d_, m=M))
    del xw, aw
    # a small call's device time against its row count (d 128, m 64): one
    # tile's latency or the grid
    by_rows = {}
    for n_ in (1, 1000, 8000, 33_000):
        x_ = X[:n_]
        by_rows[n_] = dict(**device_ms(lambda: hash_rp(x_, a, b, w=w), 20),
                           **device_ms(lambda: torch.addmm(b, x_, a), 20, key="library_device"))
    kernels.append(dict(
        name="hash_rp", route="cuda", source="src/repro_torch/kernels/csrc/hash_rp.cu",
        replaces="src/repro/kernels/hash_rp/hash_rp.py:41", launches=launches["hash_rp"],
        **rp["main"], library_call="torch.addmm(b, x, a)", wide={"d 960": rp["wide"]},
        batch={"query batch": rp["batch"]}, device_ms_by_rows=by_rows))

    # B5 hash_xp over the first 65,536 rows of the angular corpus, then at the
    # GIST width on random normalised rows, then over one query batch
    xa, rot = angular["x_rows"], angular["family"].rot.contiguous()
    na, ma, dr = xa.shape[0], rot.shape[0], rot.shape[2]
    xw = torch.nn.functional.normalize(
        torch.randn(na, WIDE_D, generator=g, device=xa.device), dim=1)
    rotw = torch.randn(ma, WIDE_D, dr, generator=g, device=xa.device) / WIDE_D ** 0.5
    xp = {}
    for tag, x_, r_ in (("main", xa, rot), ("wide", xw, rotw), ("batch", angular["queries"], rot)):
        n_, d_ = x_.shape
        err, share = xp_mismatch(x_, r_, hash_xp(x_, r_), hash_xp_ref(x_, r_))
        r_flat = r_.permute(1, 0, 2).reshape(d_, ma * dr).contiguous()
        xp[tag] = dict(
            max_abs_err=err, mismatch_share=share,
            ms=median_ms(lambda: hash_xp(x_, r_), 10),
            plain_ms=median_ms(lambda: hash_xp_ref(x_, r_), 3),
            **bound(4 * (n_ * d_ + ma * d_ * dr + n_ * ma), 2 * n_ * ma * d_ * dr, FP32_FLOPS),
            library_ms=median_ms(lambda: x_ @ r_flat, 10),
            **device_ms(lambda: hash_xp(x_, r_), 10),
            **device_ms(lambda: x_ @ r_flat, 10, key="library_device"),
            shape=dict(n=n_, d=d_, m=ma, dr=dr))
        del r_flat
    del xw, rotw
    kernels.append(dict(
        name="hash_xp", route="cuda", source="src/repro_torch/kernels/csrc/hash_xp.cu",
        replaces="src/repro/kernels/hash_xp/hash_xp.py:27", launches=launches["hash_xp"],
        **xp["main"], library_call="x @ rot as (d, m*dr)", wide={"d 960": xp["wide"]},
        batch={"query batch": xp["batch"]}))

    # the multiprobe invariant: no alternative equals the base string's
    # symbol, for both hashed families, on one query batch
    for tag, family, qb in (("rp", fam, ctx["Q"][:BATCH]),
                            ("xp gaussian", angular["family"], angular["queries"])):
        vals, _ = family.alternatives(qb, 4)
        if bool((vals == family.hash(qb)[..., None]).any()):
            fail(f"multiprobe: an {tag} alternative equals the base symbol")
    emit(phase="kernels_vs_plain", kernels=["circrun", "circrun_topk", "hash_rp", "hash_xp"],
         tolerance=dict(circrun="bit-identical", circrun_topk="bit-identical",
                        hash=dict(boundary_rtol=HASH_BOUNDARY_RTOL, max_share=HASH_MAX_SHARE)),
         multiprobe_invariant=True, ok=True)
    return kernels


def run_serving(dev) -> dict:
    """Phases 13-15: each serving model at full width and depth, static then
    dynamic (counts reset before each run and read after it), the kernel's
    arguments of one embedded batch recorded for phase 16, then the smoke
    models on the card against the CPU."""
    import repro_torch.kernels.csa_probe as probe_pkg
    from repro_torch.configs import ARCHS
    from repro_torch.data import lm_token_batches
    from repro_torch.kernels import common
    from repro_torch.kernels.csa_probe import ops as probe_ops
    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.kernels.ssm_scan import ops as scan_ops
    from repro_torch.models import init_model
    from repro_torch.serve import RetrievalEngine

    counts = {k: 0 for k in common.LAUNCHES}
    knob_counts = {k: 0 for k in common.LAUNCHES}
    recorded = {}
    for arch, n_docs, n_req in SERVE:
        cfg = ARCHS[arch]
        base = torch.cuda.memory_allocated()
        model, init_s = sync_time(lambda: init_model(cfg, seed=0, device=dev))
        emit(phase="init_model", arch=arch, seconds=init_s, n_layers=cfg.n_layers,
             d_model=cfg.d_model, params=sum(p.numel() for p in model.parameters()),
             weight_bytes=torch.cuda.memory_allocated() - base)
        engine = RetrievalEngine(cfg, model, m=SERVE_M, metric="angular",
                                 max_batch=SERVE_BATCH, device=dev)
        corpus, _ = lm_token_batches(vocab=cfg.vocab, seed=0)(0, n_docs, SERVE_TOKENS)
        for dynamic in (False, True):
            run_counts, retrieval = serve_once(engine, corpus, n_req, dynamic)
            for k in counts:
                counts[k] += run_counts[k]
            if not dynamic:  # after the static run's counts are read
                static_index = engine.index
                static_retrieval = retrieval
                profile_batch(engine, corpus[:SERVE_BATCH])
                if arch == "gemma-2b":  # the serving pool of one static batch's probe
                    pool = []
                    with recording(probe_ops, "pool_topk", pool, keep=1), \
                            recording(probe_pkg, "pool_topk", pool, keep=1):
                        engine.serve_batch(corpus[:SERVE_BATCH])
                    recorded["pool_topk"] = pool[0]
                if arch == "gemma-2b":  # the async front on the same static index
                    async_counts = serve_async(engine, corpus, n_req)
                    for k in counts:
                        counts[k] += async_counts[k]
        if arch == "gemma-2b":  # the out-of-core and the sharded builds of the corpus
            for k, v in serve_chunked_and_sharded(engine, corpus, n_req, static_index).items():
                counts[k] += v
        del static_index
        kernel = SERVE_KERNEL[arch]
        module, fn = (flash_ops, "flash_attention") if kernel == "flash_attn" \
            else (scan_ops, "ssm_scan")
        calls = []
        with recording(module, fn, calls, keep=1):
            engine.embed(corpus[:SERVE_BATCH])
        recorded[kernel] = calls[0]
        # phase bf16_knobs: the same weights served with the model's bf16 knob
        run_counts, recorded[KNOB_KERNEL[arch]] = serve_with_knob(engine, corpus, n_req,
                                                                  static_retrieval)
        for k in knob_counts:
            knob_counts[k] += run_counts[k]
        del engine, model
        torch.cuda.empty_cache()
    serve_async_cli()
    serve_shards_cli()
    small_serve_vs_cpu(dev)
    return dict(counts=counts, recorded=recorded, knob_counts=knob_counts)


def serve_chunked_and_sharded(engine, corpus: np.ndarray, n_req: int, static_index) -> dict:
    """Phase 13d: gemma-2b's corpus built again on the engine, out of core
    (`build_index(chunk_rows=SERVE_CHUNK_ROWS)`): bit for bit the static
    build's index; then an engine on the same model with
    `shards=SERVE_SHARDS` serves the static run's request stream
    (`serve_once`: self-retrieval >= 0.90, its requests/s beside the static
    run's).  Returns the launch counts of both."""
    from repro_torch.kernels import common
    from repro_torch.serve import RetrievalEngine

    common.reset_launch_counts()
    chunked, secs = sync_time(lambda: engine.build_index(corpus, chunk_rows=SERVE_CHUNK_ROWS))
    counts = common.launch_counts()
    pairs = (("h", chunked.h, static_index.h),
             ("rows", chunked.store.rows, static_index.store.rows),
             *zip("I P Hd L".split(), chunked.csa.tables(), static_index.csa.tables()))
    differ = [name for name, a, b in pairs if not torch.equal(a, b)]
    emit(phase="serve_chunked_build", arch=engine.cfg.name, docs=corpus.shape[0],
         chunk_rows=SERVE_CHUNK_ROWS, build_seconds=secs, equal_static=not differ,
         launches=counts)
    if differ:
        fail(f"serve {engine.cfg.name}: the chunked build's {differ} differ from the static "
             "build's")
    sharded = RetrievalEngine(engine.cfg, engine.model, m=SERVE_M, metric="angular",
                              max_batch=SERVE_BATCH, shards=SERVE_SHARDS, device=engine.device)
    served, _ = serve_once(sharded, corpus, n_req, dynamic=False)
    del sharded
    return {k: counts[k] + served[k] for k in counts}


def serve_shards_cli() -> None:
    """Phase 13e: one run of `python -m repro_torch.launch.serve` with
    `--shards 2 --build-chunk-rows 64` (SHARDS_CLI, a smoke model on the
    card): it must exit 0, build two shards and reach self-retrieval >= 0.90."""
    root = Path(__file__).resolve().parent
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", *SHARDS_CLI]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=root,
                         env={**os.environ, "PYTHONPATH": str(root / "src")})
    secs = time.perf_counter() - t0
    if out.returncode != 0:
        fail(f"serve_shards_cli: exit {out.returncode}\n{out.stdout[-3000:]}\n"
             f"{out.stderr[-3000:]}")
    m = re.search(r"self-retrieval (\d+)/(\d+)", out.stdout)
    emit(phase="serve_shards_cli", args=list(SHARDS_CLI), seconds=secs,
         stdout=[ln for ln in out.stdout.splitlines() if "[launch.serve]" in ln][-4:])
    if "2 shards" not in out.stdout:
        fail(f"serve_shards_cli: no sharded index built:\n{out.stdout[-2000:]}")
    if not m or int(m.group(1)) < 0.90 * int(m.group(2)):
        fail(f"serve_shards_cli: self-retrieval below 0.90:\n{out.stdout[-2000:]}")


def serve_once(engine, corpus: np.ndarray, n_req: int, dynamic: bool,
               kernel: str | None = None) -> tuple[dict, dict]:
    """One serving run as `repro_torch.launch.serve` drives it: build the
    index over the corpus, then serve a stream of corpus documents (with
    --dynamic: an insert / delete / compact burst in its middle).  Checks
    the answers and that the path launched its kernel (`kernel`, or the
    model's SERVE_KERNEL) once a layer and embedded batch.  Returns the
    launch counts and {"self_retrieval", "top1"} (the pick in the top k,
    and first)."""
    from repro_torch.data import lm_token_batches
    from repro_torch.kernels import common
    from repro_torch.launch.serve import request_stream

    cfg, n_docs = engine.cfg, corpus.shape[0]
    state = "dynamic" if dynamic else f"{engine.shards} shards" if engine.shards else "static"
    engine.stats.reset()
    torch.cuda.reset_peak_memory_stats()
    common.reset_launch_counts()
    _, build_s = sync_time(lambda: engine.build_index(corpus, dynamic=dynamic))
    extra = None
    if dynamic:
        extra, _ = lm_token_batches(vocab=cfg.vocab, seed=0)(1, SERVE_BATCH, SERVE_TOKENS)
    picks, stream = request_stream(corpus, n_req, extra)
    results, wall = sync_time(lambda: engine.serve_stream(stream))
    counts = common.launch_counts()
    qres = [r for r in results if not (isinstance(r, tuple) and isinstance(r[0], str))]
    ids = np.stack([i for i, _ in qres])
    dists = np.stack([d for _, d in qres])
    k = engine.search_params.k
    if ids.shape != (n_req, k) or not np.isfinite(dists[ids >= 0]).all():
        fail(f"serve {cfg.name} {state}: bad answers {ids.shape}")
    hit = (ids == picks[:, None]).any(axis=1)
    first = ids[:, 0] == picks
    live = np.ones(n_req, bool)
    if dynamic:  # queries after the delete: the picks still live, no deleted id back
        mid = next(i for i, r in enumerate(stream) if isinstance(r, tuple))  # the insert
        deleted = stream[mid + 1][1]
        live[mid:] = ~np.isin(picks[mid:], deleted)
        if np.isin(ids[mid:], deleted).any():
            fail(f"serve {cfg.name} dynamic: a deleted id came back")
    self_ret, top1 = float(hit[live].mean()), float(first[live].mean())
    s = engine.stats
    embedded = -(-n_docs // SERVE_BATCH) + s.batches + (1 if dynamic else 0)
    kernel = kernel or SERVE_KERNEL[cfg.name]
    emit(phase="serve", arch=cfg.name, state=state, docs=n_docs, tokens=SERVE_TOKENS,
         requests=n_req, m=SERVE_M, params=dict(k=k, lam=engine.search_params.lam),
         build_seconds=build_s, embed_seconds=s.embed_s,
         embed_tokens_per_s=s.requests * SERVE_TOKENS / s.embed_s, search_seconds=s.search_s,
         serve_seconds=wall, requests_per_s=n_req / wall, batches=s.batches,
         embed_ms_per_batch=s.embed_s / s.batches * 1e3,
         search_ms_per_batch=s.search_s / s.batches * 1e3, self_retrieval=self_ret,
         top1_self_retrieval=top1, self_retrieval_queries=int(live.sum()), kernel=kernel, churn=[s.inserts, s.deletes, s.compactions],
         embedded_batches=embedded, launches=counts,
         index_bytes=engine.index.index_bytes(), store_bytes=engine.index.store_bytes(),
         peak_mem_bytes=torch.cuda.max_memory_allocated())
    if self_ret < 0.90:
        fail(f"serve {cfg.name} {state}: self-retrieval {self_ret} < 0.90")
    if counts[kernel] != cfg.n_layers * embedded:
        fail(f"serve {cfg.name} {state}: {kernel} launched {counts[kernel]} times, expected "
             f"{cfg.n_layers} x {embedded} embedded batches")
    require(counts, ("csa_probe", "pool_topk", "gather_l2_topk")
            + (CIRCRUN_KERNELS if dynamic else ()),
            f"{cfg.name} {state} serving")
    return counts, dict(self_retrieval=self_ret, top1=top1)


def registry_value(name: str) -> float:
    """A counter's sum over its series in the port's metrics registry (0
    before anything declared it)."""
    from repro_torch.obs.registry import registry

    try:
        return registry().get(name).value()
    except KeyError:
        return 0.0


def serve_async(engine, corpus: np.ndarray, n_req: int) -> dict:
    """Phase 13b: gemma-2b's static index behind the async serving front, as
    `repro_torch.launch.serve --async` drives it (`_serve_async`,
    `_obs_epilogue`; ASYNC_ARGS).  First the same requests, a batch of 32 at
    a time, through `serve_batch` and through a second engine on the same
    model and index with instrumented plans: the answers must be equal bit
    for bit, and the stage histogram gains one observation a stage a batch.
    Then all requests submitted at once to two replicas, with a /metrics
    scrape while they are served and the drift probe after: every request
    answered (self-retrieval >= 0.90; the ids `serve_batch` gave, or
    distances tied within GATHER_TOL), no plan built or evicted after warm,
    flash_attn launched n_layers times a padded batch embedded.  Returns
    the launch counts of the phase."""
    from repro_torch.exec import resolve_params, stages
    from repro_torch.kernels import common
    from repro_torch.launch.serve import _obs_epilogue, _serve_async, build_parser, \
        request_stream
    from repro_torch.obs import start_metrics_server
    from repro_torch.obs.registry import registry
    from repro_torch.serve import RetrievalEngine

    t_phase = time.perf_counter()
    cfg, p, reg = engine.cfg, engine.search_params, registry()
    args = build_parser().parse_args(list(ASYNC_ARGS))
    picks, _ = request_stream(corpus, n_req)
    batches = [corpus[picks[lo:lo + SERVE_BATCH]] for lo in range(0, n_req, SERVE_BATCH)]

    # the instrumented plan against the fused plan, the same requests
    inst = RetrievalEngine(cfg, engine.model, m=engine.m, metric=engine.metric,
                           max_batch=engine.max_batch, search_params=p, store=engine.store,
                           device=engine.device, name="serve_async-instrumented",
                           instrument=True)
    inst.index = engine.index
    snap = reg.snapshot()
    want_ids, want_d = [], []
    for b in batches:
        ids, d = engine.serve_batch(b)
        ids_i, d_i = inst.serve_batch(b)
        if not (np.array_equal(ids, ids_i) and np.array_equal(d, d_i)):
            same_emb = torch.equal(engine.embed(b), engine.embed(b))
            fail(f"serve_async: the instrumented plan's answers differ from the fused plan's "
                 f"(two embeds of the batch equal: {same_emb})")
        want_ids.append(ids)
        want_d.append(d)
    want_ids, want_d = np.concatenate(want_ids), np.concatenate(want_d)
    window = reg.since(snap)
    hist = "repro_exec_stage_seconds"
    seen = {ls["stage"] for ls in reg.get(hist).labelsets() if ls["topology"] == "monolithic"
            and window.count(hist, **ls)}
    if seen != {"hash_queries", "probe", "gather"}:
        fail(f"serve_async: instrumented stages {sorted(seen)}, expected hash_queries, probe, "
             "gather (the fp32 store's fused verify)")
    stage_hist_ms = {}
    for st_name in ("hash_queries", "probe", "gather"):
        obs = window.samples(hist, topology="monolithic", stage=st_name)
        if len(obs) != len(batches):
            fail(f"serve_async: {len(obs)} observations of stage {st_name}, expected "
                 f"{len(batches)} (one a batch)")
        stage_hist_ms[st_name] = statistics.median(obs) * 1e3
    # the same stages of one served batch by CUDA events, beside the histogram
    q = engine.embed(batches[0])
    pr = resolve_params(engine.index, p)
    qh = stages.hash_queries(engine.index.family, q)
    cand, _ = stages.probe(engine.index, q, qh, pr)
    stage_event_ms = {
        "hash_queries": median_ms(lambda: stages.hash_queries(engine.index.family, q), 5),
        "probe": median_ms(lambda: stages.probe(engine.index, q, qh, pr), 5),
        "gather (fused verify)": median_ms(
            lambda: stages.verify(engine.index.store, engine.index.tail, q, cand, pr,
                                  engine.index.metric), 5),
        "search (whole batch)": median_ms(lambda: engine.index.search(q, p), 5),
    }
    del inst

    # the async front, with one scrape of /metrics while it serves
    srv = start_metrics_server(0, host="127.0.0.1")
    scrape: dict = {}
    stop = threading.Event()
    base = registry_value("repro_router_completed_total")

    def scraper():
        while not stop.is_set():
            done = registry_value("repro_router_completed_total") - base
            if done > 0:
                scrape["completed_before"] = done
                url = f"http://127.0.0.1:{srv.port}/metrics"
                with urllib.request.urlopen(url, timeout=60) as resp:
                    scrape["status"] = resp.status
                    scrape["body"] = resp.read().decode()
                scrape["completed_after"] = registry_value("repro_router_completed_total") - base
                return
            time.sleep(0.001)

    th = threading.Thread(target=scraper, daemon=True)
    th.start()
    common.reset_launch_counts()
    res, _ = sync_time(lambda: _serve_async(engine, corpus, picks, args, p))
    counts = common.launch_counts()
    stop.set()
    th.join(timeout=60)
    recall = _obs_epilogue(engine, corpus, args, p, srv, None)
    phase_counts = common.launch_counts()  # with the drift probe's launches
    engine.name = None  # Router.replicate named it replica-0

    st = res["stats"]
    outs = res["outs"]
    if st.completed != n_req or st.rejected or len(outs) != n_req:
        fail(f"serve_async: {st.completed} completed, {st.rejected} rejected of {n_req}")
    ids = np.stack([o[1][0] for o in outs])
    dists = np.stack([o[1][1] for o in outs])
    if [o[0] for o in outs] != [int(i) for i in picks]:
        fail("serve_async: the answers are not in submission order")
    if ids.shape != (n_req, p.k) or not np.isfinite(dists[ids >= 0]).all():
        fail(f"serve_async: bad answers {ids.shape}")
    self_ret = float((ids == picks[:, None]).any(axis=1).mean())
    differ = np.nonzero((ids != want_ids).any(axis=1))[0]
    for j in differ[:1]:
        print(f"serve_async: request {j} (doc {picks[j]}): router ids {ids[j].tolist()} dists "
              f"{dists[j].tolist()}; serve_batch ids {want_ids[j].tolist()} dists "
              f"{want_d[j].tolist()}", flush=True)
    untied = [int(j) for j in differ if not np.allclose(dists[j], want_d[j], **GATHER_TOL)]
    reps = [dict(name=r.name, batches=r.serve["batches"], requests=r.serve["requests"],
                 batch_sizes=r.batch_size_hist, plan_hits=r.serve["plan_hits"],
                 plan_misses=r.serve["plan_misses"], plan_evictions=r.serve["plan_evictions"],
                 embed_s=r.serve["embed_s"], search_s=r.serve["search_s"],
                 deadline_misses=r.deadline_misses) for r in st.replicas]
    embedded = args.replicas + sum(r["batches"] for r in reps)  # warm: one batch a replica
    body = scrape.get("body", "")
    lines = [ln for ln in body.splitlines() if ln]
    bad_lines = [ln for ln in lines if not ln.startswith("#") and not PROM_SAMPLE.match(ln)]
    emit(phase="serve_async", arch=cfg.name, docs=corpus.shape[0], requests=n_req,
         replicas=args.replicas, slo_ms=args.slo_ms, queue_depth=args.queue_depth,
         params=dict(k=p.k, lam=p.lam), completed=st.completed, rejected=st.rejected,
         slo_misses=st.deadline_misses, qps=st.completed / res["wall"], wall_s=res["wall"],
         ready_ms=res["ready_s"] * 1e3, latency_ms=st.latency, self_retrieval=self_ret,
         answers_differing=len(differ), answers_untied=untied, replica=reps,
         batch_size_hist=st.batch_size_hist, embedded_batches=embedded, launches=counts,
         stage_hist_ms_median=stage_hist_ms, stage_event_ms=stage_event_ms,
         instrumented_batches=len(batches), instrumented_bits_equal=True,
         drift_probe=dict(queries=args.drift_probe, recall_at_k=recall),
         scrape=dict(status=scrape.get("status"), lines=len(lines),
                     completed_before=scrape.get("completed_before"),
                     completed_after=scrape.get("completed_after"), bad_lines=bad_lines[:3]),
         seconds=time.perf_counter() - t_phase)
    if self_ret < 0.90:
        fail(f"serve_async: self-retrieval {self_ret} < 0.90")
    if untied:
        fail(f"serve_async: {len(untied)} requests differ from serve_batch's answers beyond "
             f"ties (first: request {untied[0]})")
    for r in reps:
        if r["plan_misses"] or r["plan_evictions"]:
            fail(f"serve_async: {r['name']} built or evicted a plan after warm: {r}")
    if sum(r["requests"] for r in reps) != n_req:
        fail(f"serve_async: the replicas counted {[r['requests'] for r in reps]} requests")
    if counts["flash_attn"] != cfg.n_layers * embedded:
        fail(f"serve_async: flash_attn launched {counts['flash_attn']} times, expected "
             f"{cfg.n_layers} x {embedded} embedded batches")
    require(counts, ("csa_probe", "pool_topk", "gather_l2_topk"), "gemma-2b serve_async")
    if scrape.get("status") != 200 or bad_lines:
        fail(f"serve_async: the /metrics scrape failed: {scrape.get('status')} {bad_lines[:3]}")
    if not scrape["completed_before"] < n_req:
        fail("serve_async: the /metrics scrape came after the run")
    for series in ("repro_plan_cache_hits_total{", "repro_serve_requests_total{",
                   "repro_router_latency_seconds_bucket{"):
        if not any(ln.startswith(series) for ln in lines):
            fail(f"serve_async: the /metrics scrape lacks {series}")
    if recall is None or not 0.0 <= recall <= 1.0:
        fail(f"serve_async: drift probe recall {recall}")
    return phase_counts


def serve_async_cli() -> None:
    """Phase 13c: one run of `python -m repro_torch.launch.serve` with every
    flag of the async front (ASYNC_CLI, a smoke model on the card): it must
    exit 0, answer every request, build no plan after warm, scrape its own
    metrics endpoint's line, and write a Chrome trace holding ASYNC_SPANS."""
    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        trace = Path(tmp) / "serve_trace.json"
        cmd = [sys.executable, "-m", "repro_torch.launch.serve", *ASYNC_CLI,
               "--trace", str(trace)]
        t0 = time.perf_counter()
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=root,
                             env={**os.environ, "PYTHONPATH": str(root / "src")})
        secs = time.perf_counter() - t0
        if out.returncode != 0:
            fail(f"serve_async_cli: exit {out.returncode}\n{out.stdout[-3000:]}\n"
                 f"{out.stderr[-3000:]}")
        doc = json.loads(trace.read_text())
    m = re.search(r"async: (\d+) completed / (\d+) rejected / (\d+) SLO misses .*"
                  r"self-retrieval (\d+)/(\d+)", out.stdout)
    audits = re.findall(r"replica-\d: \d+ batches, .* plan (\d+) compiles / \d+ reuses / "
                        r"(\d+) evictions", out.stdout)
    names = {e["name"] for e in doc["traceEvents"]}
    emit(phase="serve_async_cli", args=list(ASYNC_CLI), seconds=secs,
         stdout=[ln for ln in out.stdout.splitlines() if "[launch.serve]" in ln][-8:],
         trace_events=len(doc["traceEvents"]), span_names=sorted(names))
    if not m or int(m.group(1)) != int(m.group(5)) or int(m.group(2)):
        fail(f"serve_async_cli: not every request was answered:\n{out.stdout[-2000:]}")
    if int(m.group(4)) < 0.90 * int(m.group(5)):
        fail(f"serve_async_cli: self-retrieval {m.group(4)}/{m.group(5)}")
    if len(audits) != 2 or any(a != ("0", "0") for a in audits):
        fail(f"serve_async_cli: a replica built or evicted a plan after warm: {audits}")
    for needle in ("Prometheus metrics on :", "recall-drift probe: recall@",
                   "trace events to"):
        if needle not in out.stdout:
            fail(f"serve_async_cli: no {needle!r} line")
    if not ASYNC_SPANS <= names:
        fail(f"serve_async_cli: the trace lacks {sorted(ASYNC_SPANS - names)}")


# kernel-name fragments -> the part of a served batch they belong to
# a kernel's group: the first fragment its lower-cased name holds ("nvjet":
# cuBLAS's bf16 GEMMs on Hopper; the elementwise and reduction groups are
# torch's own kernels, the train step's casts, clip and AdamW among them)
KERNEL_GROUPS = (("flash_attn_kernel", "flash_attn"), ("flash_attn_bwd", "flash_attn_bwd"),
                 ("ssm_scan_bwd", "ssm_scan_bwd"), ("ssm_scan_kernel", "ssm_scan"),
                 ("gemm", "matmul (cuBLAS)"), ("gemv", "matmul (cuBLAS)"),
                 ("nvjet", "matmul (cuBLAS)"),
                 ("splitkreduce", "matmul (cuBLAS)"), ("csa_probe_kernel", "index kernels"),
                 ("pool_topk_kernel", "index kernels"),
                 ("gather_scan_kernel", "index kernels"), ("gather_topk_kernel", "index kernels"),
                 ("gather_merge", "index kernels"), ("gather_emit_kernel", "index kernels"),
                 ("circrun_kernel", "index kernels"),
                 ("circrun_topk_kernel", "index kernels"),
                 ("elementwise_kernel", "elementwise (torch)"),
                 ("reduce_kernel", "reductions (torch)"))


def profile_call(run, phase: str, **fields) -> None:
    """Where one call of run() spends the card's time: torch.profiler over
    one call, after an untimed call and a marker kernel in the same session;
    device time and kernels summed by kernel group, and the share of the
    call's wall time in which no kernel ran (measured under the profiler,
    which adds host time).  The flash_attn, flash_attn_bwd, ssm_scan and
    ssm_scan_bwd kernels seen (KERNELS_PER_LAUNCH a launch) must equal their launches
    (`common.LAUNCHES`) over the call: a session that
    saw fewer is run again with more lead kernels (PROFILE_LEAD_KERNELS),
    and after three the run fails.  Emits one line of `phase` with
    `fields`."""
    from repro_torch.kernels import common

    out: dict = {}

    def timed():
        common.reset_launch_counts()
        _, out["wall"] = sync_time(run)
        out["counts"] = common.launch_counts()

    run()  # warm-up
    short = []
    for lead in PROFILE_LEAD_KERNELS:
        kern = after_marker(run, timed, pad_runs=1, lead=lead) or []
        groups: dict = {}
        seen: dict = {}
        for e in kern:
            g = next((grp for frag, grp in KERNEL_GROUPS if frag in e.name.lower()), "other")
            groups[g] = groups.get(g, 0.0) + e.time_range.elapsed_us() / 1e3
            seen[g] = seen.get(g, 0) + 1
        expected = {k: out["counts"][k] * KERNELS_PER_LAUNCH.get(k, 1)
                    for k in ("flash_attn", "flash_attn_bwd", "ssm_scan", "ssm_scan_bwd")}
        if any(seen.get(k, 0) > n for k, n in expected.items()):
            fail(f"{phase}: the profiler saw {seen}, more than the launches {expected}")
        if all(seen.get(k, 0) == n for k, n in expected.items()):
            break
        short.append({k: seen.get(k, 0) for k in expected})
    else:
        fail(f"{phase}: three profiler sessions saw {short} of the launches {expected}")
    wall = out["wall"]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy, end = 0.0, float("-inf")
    for a, b in spans:  # the union of the kernels' intervals
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    busy_ms = busy / 1e3
    emit(phase=phase, **fields, wall_ms=wall * 1e3, kernels=len(kern), device_busy_ms=busy_ms,
         idle_share=(1.0 - busy_ms / (wall * 1e3)) if kern else "not measured",
         device_ms_by_group=groups, launches_seen_by_group=seen, launches=expected,
         short_sessions=short)


def profile_batch(engine, tokens: np.ndarray) -> None:
    """Where one served batch (`serve_batch`: embed + search on the static
    index) spends the card's time (profile_call)."""
    profile_call(lambda: engine.serve_batch(tokens), "profile_batch", arch=engine.cfg.name,
                 batch=len(tokens))


def small_serve_vs_cpu(dev) -> None:
    """Phase 15: the smoke-size models with the same weights on the card and
    on the CPU: embeddings within EMB_TOL, and an index built on each device
    from the CPU's embeddings serves identical ids.  The embeddings are
    rounded to multiples of 2^-10 for the index, so the pseudo-rotation
    hashes and the verify sums are exact in fp32 on both devices."""
    import copy

    from repro_torch.configs import ARCHS
    from repro_torch.core import LCCSIndex, SearchParams
    from repro_torch.data import lm_token_batches
    from repro_torch.models import init_model
    from repro_torch.serve import RetrievalEngine

    for arch in SERVE_KERNEL:
        cfg = ARCHS[arch].smoke()
        cpu_model = init_model(cfg, seed=0, device="cpu")
        card_model = copy.deepcopy(cpu_model).to(dev)
        corpus, _ = lm_token_batches(vocab=cfg.vocab, seed=0)(0, SMALL_SERVE_DOCS, SERVE_TOKENS)
        e_cpu = RetrievalEngine(cfg, cpu_model, device="cpu").embed(corpus)
        e_card = RetrievalEngine(cfg, card_model, device=dev).embed(corpus).cpu()
        err = float((e_card - e_cpu).abs().max())
        torch.testing.assert_close(e_card, e_cpu, **EMB_TOL)
        X = torch.from_numpy(dyadic(e_cpu.numpy(), bits=10))
        p = SearchParams(k=5, lam=64)
        idx = {d: LCCSIndex.build(X, m=SERVE_M, family="angular", seed=0, device=d)
               for d in ("cpu", dev)}
        ids_cpu, _ = idx["cpu"].search(X[:64], p)
        ids_card, _ = idx[dev].search(X[:64].to(dev), p)
        if not torch.equal(idx["cpu"].h, idx[dev].h.cpu()):
            fail(f"small serve {arch}: hash strings differ between card and CPU")
        if not torch.equal(ids_cpu, ids_card.cpu()):
            fail(f"small serve {arch}: served ids differ between card and CPU")
        emit(phase="small_serve_vs_cpu", arch=arch, docs=SMALL_SERVE_DOCS,
             embed_max_abs_err=err, tolerance=EMB_TOL, ids_identical=True, ok=True)


@contextmanager
def plain_versions_refused():
    """Fail the run if the plain version of flash_attn or ssm_scan runs
    while the block does: on the card the LM's path launches the kernels or
    raises, and never gives way to them."""
    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.kernels.ssm_scan import ops as scan_ops

    saved = flash_ops.flash_attention_ref, scan_ops.ssm_scan_batched_ref

    def refuse(*args, **kw):
        fail("lm_decode: a plain version of flash_attn or ssm_scan ran on the card's path")

    flash_ops.flash_attention_ref = scan_ops.ssm_scan_batched_ref = refuse
    try:
        yield
    finally:
        flash_ops.flash_attention_ref, scan_ops.ssm_scan_batched_ref = saved


def lm_kernel_layers(cfg) -> tuple[dict, dict]:
    """The launches of one forward pass over the layers (loss_fn, prefill)
    and of one decode step: flash_attn once an attention layer (zamba's
    shared block once a place), ssm_scan once a Mamba-1 layer, nothing else
    (a Mamba-2 layer is plain torch); whisper's flash_attn once an encoder
    layer and twice a decoder layer (self and cross attention), and a decode
    step runs only the decoder."""
    from repro_torch.kernels import common
    from repro_torch.models.blocks import ATTN_KINDS
    from repro_torch.models.lm import layer_kinds

    want = {k: 0 for k in common.LAUNCHES}
    if cfg.enc_dec:
        n_dec = cfg.n_layers - cfg.n_enc_layers
        return dict(want, flash_attn=cfg.n_enc_layers + 2 * n_dec), dict(want,
                                                                        flash_attn=2 * n_dec)
    kinds = layer_kinds(cfg)
    want["ssm_scan"] = kinds.count("m1")
    want["flash_attn"] = sum(kind in ATTN_KINDS for kind in kinds)
    return want, dict(want)


def cache_list(caches) -> list:
    """A model's caches as a list of (first, second) tensor pairs with
    their types: the LM's list as it is; whisper's self-attention KVCaches,
    then each layer's cross (K, V) pair."""
    if isinstance(caches, list):
        return caches
    return list(caches.self_kv) + list(zip(caches.ck, caches.cv))


def cache_length(caches) -> int:
    return caches[0].length if isinstance(caches, list) else caches.length


def cache_bytes(caches) -> int:
    return sum(t.numel() * t.element_size() for c in cache_list(caches) for t in c[:2])


def lm_extra_inputs(cfg, batch: int, make) -> dict:
    """What a prefill batch carries beside the tokens: a VLM's cfg.n_patches
    patch embeddings, a whisper's cfg.n_audio_frames frame embeddings,
    (batch, n, d_model) each from make(shape) (N(0, 1) draws); nothing for a
    decoder LM."""
    if cfg.vlm:
        return {"patch_embeds": make((batch, cfg.n_patches, cfg.d_model))}
    if cfg.enc_dec:
        return {"frames": make((batch, cfg.n_audio_frames, cfg.d_model))}
    return {}


def lm_labels(cfg, toks, make_ids):
    """Labels of a loss batch over the prompt toks[:, :-1]: the next tokens,
    and ahead of them, for a VLM, make_ids((B, n_patches)) for the
    patches (the reference's labels cover both)."""
    if not cfg.vlm:
        return toks[:, 1:]
    return torch.cat([torch.as_tensor(make_ids((toks.shape[0], cfg.n_patches))),
                      torch.as_tensor(toks[:, 1:])], dim=1)


def forward_logits(model, extra: dict, seq: torch.Tensor, start: int) -> torch.Tensor:
    """The full forward's logits over the token sequence `seq` at its
    positions start .. end (decode's counterparts): unembed(forward(seq))
    of a decoder LM; of a VLM over the patches of `extra` spliced ahead of
    seq; whisper's decode_train(encode(frames), seq)."""
    from repro_torch.models import splice_patches

    cfg = model.cfg
    if cfg.enc_dec:
        return model.decode_train(seq, model.encode(extra["frames"]))[:, start:]
    if cfg.vlm:
        embeds, pos = splice_patches(model, dict(extra, tokens=seq))
        return model.unembed(model(None, pos, embeds)[:, cfg.n_patches + start:])
    return model.unembed(model(seq)[:, start:])


def route_diffs(card: list, cpu: list):
    """The expert choices of the same MoE layer calls on the card and on the
    CPU (`moe.recording(model)` lists).  Returns (agreeing (token, k)
    choices, all choices, a bool (T,) a call: the tokens whose choices
    differ, and the largest tie of a differing choice: on the CPU's
    probabilities sorted, (p_k - p_{k+1}) / p_k with its nearer neighbour,
    rank k - 1 or k + 1, the K + 1-th included)."""
    agree = total = 0
    tie, differ = 0.0, []
    for g, c in zip(card, cpu):
        d = g.eidx.cpu() != c.eidx
        agree += int((~d).sum())
        total += d.numel()
        K = c.eidx.shape[1]
        top = c.probs.topk(K + 1, dim=-1).values
        gaps = (top[:, :-1] - top[:, 1:]) / top[:, :-1]  # rank k against k + 1
        left = torch.cat([torch.full_like(gaps[:, :1], float("inf")), gaps[:, :-1]], 1)
        if bool(d.any()):
            tie = max(tie, float(torch.minimum(left, gaps)[d].max()))
        differ.append(d.any(-1))
    return agree, total, differ, tie


def lm_smoke_vs_cpu(dev) -> None:
    """The smoke-size models with the same weights on the card and on the
    CPU: loss_fn, prefill of LM_SMOKE_PROMPT tokens, then LM_SMOKE_STEPS
    greedy decode steps, both devices fed the CPU's greedy tokens.  Gates:
    the loss and prefill's logits within LM_TOL, each step's logits within
    BF16_REL of the largest CPU logit, the card's greedy token the CPU's
    wherever the CPU's top two are further apart than that tolerance,
    prefill's K and V within one bf16 step (+ LM_TOL), and still so at the
    prompt's positions after the steps, the rest of the caches after the
    steps within the decode tolerance (`caches_close`), and each decode
    step on the card launching its kernels once a layer (whisper's twice a
    decoder layer).  A VLM's batch carries patch embeddings and a
    whisper's frame embeddings (`lm_extra_inputs`, from the same numpy seed
    on both devices); whisper's cross K and V are held as the conv tail and
    state are.  The line reports
    the largest K / V difference in bf16 steps of the entry.  The MoE
    models' expert choices are recorded on both devices at every call
    (`route_diffs`): the line reports the share of (token, k) choices that
    agree, and one may differ only at a near-tie (SMOKE_ROUTE_TIE); a
    sequence whose choices differ at a decode step leaves the later logit,
    token and cache checks (`diverged_sequences`)."""
    import copy

    from repro_torch.configs import ARCHS
    from repro_torch.kernels import common
    from repro_torch.models import decode_step, init_model, loss_fn, prefill
    from repro_torch.models.attention import KVCache
    from repro_torch.models.moe import recording as moe_recording

    def bf16_step(mag):
        _, e = torch.frexp(mag)
        return torch.ldexp(torch.ones_like(mag), e - 8)

    def caches_close(card, cpu, prompt: int | None, tol: dict, rows=slice(None)) -> dict:
        """The largest |card - cpu| over its bound across every cache
        (`of_bound`).  After prefill (`prompt` None) every entry is bound by
        `tol` (LM_TOL, or the model's LM_CACHE_TOL), plus one bf16 step for
        K and V.  After decode, K and V at
        positions < `prompt` (written by prefill, read by every step) keep
        that bound; K and V at the decode positions, and the conv tail and
        state, are bound by BF16_REL of the largest CPU value (plus one step
        for K and V): they are computed from hidden states that the steps'
        bf16 reads move apart.  Also the readings: the largest K / V
        difference in bf16 steps of the entry at the prompt's and at the
        decode positions, and the largest difference of what decode wrote
        over the largest CPU value of its tensor.  `rows` selects the
        sequences compared."""
        out = dict(of_bound=0.0, prompt_kv_bf16_steps=0.0, decode_kv_bf16_steps=0.0,
                   decode_rel=0.0)
        p = prompt
        for c, h in zip(cache_list(card), cache_list(cpu)):
            kv = isinstance(c, KVCache)
            for a, b in zip(c[:2], h[:2]):
                a, b = a.cpu().float()[rows], b.float()[rows]
                diff, mag = (a - b).abs(), torch.maximum(a.abs(), b.abs())
                step = bf16_step(mag) if kv else torch.zeros_like(mag)
                bound = tol["atol"] + tol["rtol"] * mag + step
                if prompt is not None:
                    loose = BF16_REL * float(b.abs().max()) + step
                    bound = torch.cat([bound[:, :p], loose[:, p:]], 1) if kv else loose
                    written = diff[:, p:] if kv else diff
                    out["decode_rel"] = max(out["decode_rel"], float(
                        written.max() / b.abs().max().clamp_min(1e-30)))
                out["of_bound"] = max(out["of_bound"], float((diff / bound).max()))
                if kv:
                    steps = diff / step
                    out["prompt_kv_bf16_steps"] = max(out["prompt_kv_bf16_steps"],
                                                      float(steps[:, :p].max()))
                    if prompt is not None:
                        out["decode_kv_bf16_steps"] = max(out["decode_kv_bf16_steps"],
                                                          float(steps[:, p:].max()))
        return out

    for arch in LM_SMOKE:
        t0 = time.perf_counter()
        cfg = ARCHS[arch].smoke()
        cpu = init_model(cfg, seed=0, device="cpu")
        card = copy.deepcopy(cpu).to(dev)
        rng = np.random.default_rng(0)
        toks = rng.integers(0, cfg.vocab, (LM_BATCH, LM_SMOKE_PROMPT + 1))
        prompt = {"tokens": toks[:, :-1],
                  **lm_extra_inputs(cfg, LM_BATCH,
                                    lambda shape: rng.normal(size=shape).astype(np.float32))}
        batch = dict(prompt, labels=lm_labels(cfg, toks, lambda shape: rng.integers(
            0, cfg.vocab, shape)))
        routes = dict(agree=0, total=0, tie=0.0)

        def both(on_cpu, on_card):
            """Both calls, their expert choices compared (route_diffs)."""
            with moe_recording(cpu) as rc:
                out_cpu = on_cpu()
            with moe_recording(card) as rg:
                out_card = on_card()
            agree, total, differ, tie = route_diffs(rg, rc)
            if tie > SMOKE_ROUTE_TIE:
                fail(f"lm_decode_vs_cpu {arch}: an expert choice differs from the CPU's at "
                     f"a tie of {tie}, past {SMOKE_ROUTE_TIE}")
            routes.update(agree=routes["agree"] + agree, total=routes["total"] + total,
                          tie=max(routes["tie"], tie))
            return out_cpu, out_card, differ

        with torch.no_grad():
            loss_cpu, loss_card, _ = both(lambda: loss_fn(cpu, batch)[0],
                                          lambda: loss_fn(card, batch)[0].cpu())
        torch.testing.assert_close(loss_card, loss_cpu, **LM_TOL)
        max_len = LM_SMOKE_PROMPT + LM_SMOKE_STEPS + (cfg.n_patches if cfg.vlm else 0)
        (lc, cc), (lg, cg), _ = both(lambda: prefill(cpu, prompt, max_len),
                                     lambda: prefill(card, prompt, max_len))
        torch.testing.assert_close(lg.cpu(), lc, **LM_TOL)
        cache_tol = LM_CACHE_TOL.get(arch, LM_TOL)
        prefill_caches = caches_close(cg, cc, None, cache_tol)
        if prefill_caches["of_bound"] > 1.0:
            fail(f"lm_decode_vs_cpu {arch}: prefill caches past their bound: {prefill_caches}")
        want = lm_kernel_layers(cfg)[1]
        err, equal, near_ties = 0.0, 0, 0
        diverged = torch.zeros(LM_BATCH, dtype=torch.bool)
        for _ in range(LM_SMOKE_STEPS):
            tc, tg = lc.argmax(-1), lg.argmax(-1).cpu()
            tol = BF16_REL * float(lc.abs().max())
            top2 = lc.topk(2, dim=-1).values
            tie = (top2[:, 0] - top2[:, 1]) <= 2 * tol
            if bool(((tc != tg) & ~tie & ~diverged).any()):
                fail(f"lm_decode_vs_cpu {arch}: the card's greedy token differs from the CPU's")
            equal += int((tc == tg).sum())
            near_ties += int(tie.sum())

            def card_step():
                common.reset_launch_counts()
                out = decode_step(card, tc[:, None], cg)
                if common.launch_counts() != want:
                    fail(f"lm_decode_vs_cpu {arch}: a decode step launched "
                         f"{common.launch_counts()}, expected {want}")
                return out

            (lc, cc), (lg, cg), differ = both(lambda: decode_step(cpu, tc[:, None], cc),
                                              card_step)
            for d in differ:
                diverged |= d.cpu()
            kept = ~diverged
            step_err = float((lg.cpu() - lc)[kept].abs().max()) if bool(kept.any()) else 0.0
            if step_err > BF16_REL * float(lc.abs().max()):
                fail(f"lm_decode_vs_cpu {arch}: decode logits {step_err} apart")
            err = max(err, step_err)
        decoded_caches = caches_close(cg, cc, cache_length(cc) - LM_SMOKE_STEPS, cache_tol,
                                      ~diverged)
        if decoded_caches["of_bound"] > 1.0:
            fail(f"lm_decode_vs_cpu {arch}: caches after decode past their bound: "
                 f"{decoded_caches}")
        moe = {}
        if cfg.n_experts:
            moe = dict(experts=cfg.n_experts, top_k=cfg.moe_top_k,
                       route_agreement=f"{routes['agree']}/{routes['total']}",
                       route_share=routes["agree"] / routes["total"],
                       route_tie_max=routes["tie"], diverged_sequences=int(diverged.sum()),
                       route_tie_limit=SMOKE_ROUTE_TIE)
        emit(phase="lm_decode_vs_cpu", arch=arch, batch=LM_BATCH, prompt=LM_SMOKE_PROMPT,
             steps=LM_SMOKE_STEPS, window=cfg.window, loss_cpu=float(loss_cpu),
             loss_card=float(loss_card), decode_logits_max_abs_err=err,
             greedy_tokens_equal=f"{equal}/{LM_BATCH * LM_SMOKE_STEPS}",
             cpu_near_ties=near_ties, prefill_caches=prefill_caches,
             decoded_caches=decoded_caches, **moe,
             tolerance=dict(loss_prefill=LM_TOL, caches=cache_tol, decode_rel=BF16_REL),
             ok=True,
             seconds=time.perf_counter() - t0)


def lm_full(dev, arch: str, recorded: dict, depth: int | None = None) -> dict:
    """One model at full width (random weights, seed 0), at full depth or
    cut to `depth` layers: loss_fn over the prompt, prefill, then LM_STEPS
    greedy decode steps, with the launches of each counted; the greedy
    tokens' logits against the full forward over the prompt and those
    tokens (`forward_logits`).  Records the kernels' arguments of the last
    decode step into `recorded`.  A model with MoE layers (phase lm_moe) has
    their dropped assignments counted in the loss's forward and over the
    decode steps, its prefill's first flash_attn call recorded too, and
    `moe_gate` as its decode-vs-forward gate.  A VLM or a whisper (phase
    lm_multimodal) runs its prompt after its patch or frame embeddings
    (`lm_extra_inputs`), and has its prefill's flash_attn calls recorded
    (whisper's each distinct shape).  Returns the phase's launches."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.kernels import common
    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.kernels.ssm_scan import ops as scan_ops
    from repro_torch.models import decode_step, init_model, loss_fn, param_count, prefill
    from repro_torch.models.lm import layer_kinds
    from repro_torch.models.moe import capacity
    from repro_torch.models.moe import recording as moe_recording

    t0 = time.perf_counter()
    cfg = ARCHS[arch]
    if depth is not None:
        cfg = dataclasses.replace(cfg, repeats=depth // len(cfg.pattern), n_layers=depth)
    phase = ("lm_multimodal" if cfg.vlm or cfg.enc_dec
             else "lm_moe" if cfg.n_experts else "lm_decode")
    base = torch.cuda.memory_allocated()
    model, init_s = sync_time(lambda: init_model(cfg, seed=0, device=dev))
    param_bytes = torch.cuda.memory_allocated() - base
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    toks = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT + 1), generator=g, device=dev)
    extra = lm_extra_inputs(cfg, LM_BATCH,
                            lambda shape: torch.randn(shape, generator=g, device=dev))
    prompt = {"tokens": toks[:, :-1], **extra}
    max_len = LM_PROMPT + LM_STEPS + (cfg.n_patches if cfg.vlm else 0)
    per_pass, per_step = lm_kernel_layers(cfg)
    counts = {k: 0 for k in common.LAUNCHES}

    def counted(fn, want: dict, what: str):
        common.reset_launch_counts()
        out = fn()
        got = common.launch_counts()
        if got != want:
            fail(f"{phase} {arch}: {what} launched {got}, expected {want}")
        for k in counts:
            counts[k] += got[k]
        return out

    with torch.no_grad(), plain_versions_refused():
        torch.cuda.reset_peak_memory_stats()
        batch = dict(prompt, labels=lm_labels(cfg, toks, lambda shape: torch.randint(
            0, cfg.vocab, shape, generator=g, device=dev)))
        with moe_recording(model) as routed:
            loss, _ = counted(lambda: loss_fn(model, batch), per_pass, "loss_fn")
        loss_drops = sum(int(r.dropped) for r in routed)
        loss_ms = median_ms(lambda: loss_fn(model, batch), 3)
        loss_peak = torch.cuda.max_memory_allocated() - base
        prefill_ms = median_ms(lambda: prefill(model, prompt, max_len), 3)
        torch.cuda.reset_peak_memory_stats()
        prefill_calls: list = []
        with recording(flash_ops, "flash_attention", prefill_calls,
                       keep=None if cfg.enc_dec else 1):
            logits, caches = counted(lambda: prefill(model, prompt, max_len), per_pass,
                                     "prefill")
        distinct = {}  # whisper: the encoder's, the decoder's self and cross shapes
        for (q, k, v), kw in prefill_calls:
            distinct.setdefault((q.shape, k.shape, kw["causal"]), ((q, k, v), kw))
        prefill_calls = list(distinct.values())
        out, fed, events, decode_routed = [logits], [], [], []
        calls = {"flash_attn": [], "ssm_scan": []}
        for i in range(LM_STEPS):
            token = logits.argmax(-1, keepdim=True)
            fed.append(token)
            if i == LM_STEPS - 1:  # the step rewrites its slot with the same token
                profile_call(lambda: decode_step(model, token, caches), "profile_decode_step",
                             arch=arch, batch=LM_BATCH, cache_length=cache_length(caches))

            def step():
                return counted(lambda: decode_step(model, token, caches), per_step,
                               f"decode step {i}")

            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            with moe_recording(model) as routed:
                a.record()
                if i < LM_STEPS - 1:
                    logits, caches = step()
                else:  # the last step's kernel arguments, for decode_kernels_vs_plain
                    with recording(flash_ops, "flash_attention", calls["flash_attn"]), \
                            recording(scan_ops, "ssm_scan", calls["ssm_scan"]):
                        logits, caches = step()
                b.record()
            decode_routed += routed
            events.append((a, b))
            out.append(logits)
        torch.cuda.synchronize()
        step_ms = [a.elapsed_time(b) for a, b in events]
        decode_peak = torch.cuda.max_memory_allocated() - base
        decode_drops = sum(int(r.dropped) for r in decode_routed)
        kv = cache_bytes(caches)
        # one call of each (Skv, window, causal): gemma3-1b's local and global
        # layers, whisper's self and cross attention
        shapes = {}
        for args, kw in calls["flash_attn"]:
            shapes.setdefault((args[1].shape[1], kw["window"], kw["causal"]), (args, kw))
        if shapes:
            recorded["flash_attn"][arch] = list(shapes.values())
        if arch in FLASH_PREFILL_RECORDED:
            recorded["flash_attn_prefill"][arch] = prefill_calls
        if calls["ssm_scan"]:
            recorded["ssm_scan"][arch] = calls["ssm_scan"][:1]
        decoded = torch.stack(out, 1)  # (B, STEPS + 1, V): positions P - 1 .. P + STEPS - 1
        if cfg.n_experts:
            del caches
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            gate = moe_gate(model, toks[:, :-1], fed, max_len, decoded)
            gate["peak_mem_over_base_bytes"] = torch.cuda.max_memory_allocated() - base
            gap, finite = gate["gap"], gate.pop("finite")
        else:
            seq = torch.cat([toks[:, :-1]] + fed, dim=1)
            forward = forward_logits(model, extra, seq, LM_PROMPT - 1)
            finite = bool(torch.isfinite(forward).all())
            gap = float((decoded - forward).abs().max() / forward.abs().max())
            gate = {}
    finite = finite and bool(torch.isfinite(decoded).all() and torch.isfinite(loss)
                             and torch.isfinite(logits).all())
    med = statistics.median(step_ms)
    T = LM_BATCH * (LM_PROMPT + (cfg.n_patches if cfg.vlm else 0))
    # what the weights, the loss's logits and the caches (KV and SSM state)
    # take, beside the peaks (+ prefill's dispatch buffer in a MoE model)
    reckoning = dict(weights_bytes=4 * param_count(model),
                     loss_logits_bytes=4 * T * cfg.vocab_padded, cache_bytes=kv)
    fields = {}  # the family's own readings
    if cfg.vlm:
        fields = dict(patches=cfg.n_patches)
    elif cfg.enc_dec:
        fields = dict(frames=cfg.n_audio_frames, encoder_layers=cfg.n_enc_layers,
                      cross_cache_bytes=sum(t.numel() * t.element_size()
                                            for t in caches.ck + caches.cv))
    if cfg.n_experts:
        n_moe = layer_kinds(cfg).count("moe")
        moe_cfg = model.layers[cfg.pattern.index("moe")].moe.cfg
        cap = capacity(T, moe_cfg)
        reckoning["prefill_dispatch_bytes"] = 4 * cfg.n_experts * cap * cfg.d_model
        fields = dict(experts=cfg.n_experts, top_k=cfg.moe_top_k,
                      capacity_factor=cfg.capacity_factor, prefill_capacity=cap,
                      decode_capacity=capacity(LM_BATCH, moe_cfg),
                      dropped=dict(loss=f"{loss_drops}/{T * cfg.moe_top_k * n_moe}",
                                   decode=f"{decode_drops}/"
                                          f"{LM_STEPS * LM_BATCH * cfg.moe_top_k * n_moe}"),
                      decode_vs_forward_gate=gate, route_tolerance=MOE_ROUTE_TOL[arch])
    emit(phase=phase, arch=arch, n_layers=cfg.n_layers, d_model=cfg.d_model,
         vocab=cfg.vocab, params=param_count(model), param_bytes=param_bytes, base_bytes=base,
         init_seconds=init_s, batch=LM_BATCH, prompt=LM_PROMPT, steps=LM_STEPS,
         window=cfg.window, loss=float(loss), loss_ms=loss_ms, prefill_ms=prefill_ms,
         decode_ms_per_step_median=med, decode_ms_per_step_min=min(step_ms),
         decode_ms_per_step_max=max(step_ms), decode_tokens_per_s=LM_BATCH * 1e3 / med,
         cache_bytes=kv, peak_mem_over_base_bytes=dict(loss=loss_peak, decode=decode_peak),
         reckoning=reckoning,
         launches_per_pass={k: v for k, v in per_pass.items() if v},
         launches_per_step={k: v for k, v in per_step.items() if v}, launches=counts,
         **fields, decode_vs_forward_rel=gap, tolerance=DECODE_VS_FORWARD_TOL[arch],
         finite=finite, seconds=time.perf_counter() - t0)
    if not finite:
        fail(f"{phase} {arch}: a logit or the loss is not finite")
    if gap > DECODE_VS_FORWARD_TOL[arch]:
        fail(f"{phase} {arch}: decode logits {gap} (relative) off the forward's, "
             f"tolerance {DECODE_VS_FORWARD_TOL[arch]}")
    if cfg.n_experts:
        if gate["route_perturbation"] > MOE_ROUTE_TOL[arch]:
            fail(f"{phase} {arch}: the router's decode-vs-forward perturbation "
                 f"{gate['route_perturbation']} past {MOE_ROUTE_TOL[arch]}")
        if gate["dropped"]:
            fail(f"{phase} {arch}: {gate['dropped']} assignments dropped at capacity_factor E / K")
        if not gate["replayed"]:
            fail(f"{phase} {arch}: decode did not take the forward's expert choices")
        if gate["flip_tie_over_bound"] > 1.0 + FLIP_BOUND_SLACK:
            fail(f"{phase} {arch}: a route decode would flip at a tie of "
                 f"{gate['flip_tie_over_bound']} x twice its perturbation")
    del model, logits, decoded
    torch.cuda.empty_cache()
    return counts


@contextmanager
def moe_capacity(model, factor: float):
    """Every MoE layer of `model` at capacity_factor `factor` inside the block."""
    from repro_torch.models.moe import MoE

    moes = [m for m in model.modules() if isinstance(m, MoE)]
    saved = [m.cfg for m in moes]
    for m in moes:
        m.cfg = m.cfg._replace(capacity_factor=factor)
    try:
        yield
    finally:
        for m, c in zip(moes, saved):
            m.cfg = c


def moe_gate(model, prompt: torch.Tensor, fed: list, max_len: int, greedy) -> dict:
    """Phase lm_moe's decode-vs-forward gate, at capacity_factor = E / K on
    both sides (nothing dropped): unembed(forward) over `prompt` and the
    greedy tokens `fed`, with its expert choices recorded; then prefill of
    `prompt` and a teacher-forced decode of `fed` with those choices
    replayed (`moe_replay`), so that no near-tie which the bf16 cache moves
    flips a route and every position compares (moe_replay_gap).  The
    forward and prefill run one sequence at a time: with nothing dropped a
    token's output does not depend on the batch's other tokens, and at this
    capacity (a slot a token) one sequence's (E, T, D) dispatch buffer fits
    beside llama4-maverick's weights where four do not; the caches are
    joined for the batch's decode.  Also: how far these decode logits are
    from the greedy run's (`greedy`, at the config's capacity factor), and
    the drops (0 expected)."""
    from repro_torch.models import decode_step, prefill
    from repro_torch.models.moe import recording as moe_recording

    cfg = model.cfg
    B, P = prompt.shape
    E, K = cfg.n_experts, cfg.moe_top_k
    n = sum(layer.kind == "moe" for layer in model.layers)

    def per_layer(recs: list, l: int, rows: int, dim: int):
        """Layer l's (eidx, probs) of every call in `recs`, (rows, -1, K / E)
        each, joined along `dim`."""
        return tuple(torch.cat([t.view(rows, -1, t.shape[-1])
                                for t in (getattr(r, f) for r in recs[l::n])], dim)
                     for f in ("eidx", "probs"))

    seq = torch.cat([prompt] + fed, dim=1)
    with moe_capacity(model, E / K):
        with moe_recording(model) as fwd:
            forward = torch.cat([model.unembed(model(seq[b:b + 1])[:, P - 1:])
                                 for b in range(B)])
        fwd_routes = [per_layer(fwd, l, 1, 0) for l in range(n)]
        replay = replay_order([e for e, _ in fwd_routes], P, per_sequence=True)
        with moe_replay(replay), moe_recording(model) as dec:
            parts = [prefill(model, {"tokens": prompt[b:b + 1]}, max_len) for b in range(B)]
            out = [torch.cat([logits for logits, _ in parts])]
            caches = [type(c)(torch.cat([p[1][i].k for p in parts]),
                              torch.cat([p[1][i].v for p in parts]), c.length)
                      for i, c in enumerate(parts[0][1])]
            del parts
            for token in fed:
                logits, caches = decode_step(model, token, caches)
                out.append(logits)
        del caches
    if len(dec) != len(replay):
        fail(f"lm_moe: {len(dec)} MoE calls in prefill and decode, {len(replay)} replayed")
    pre, steps = dec[:B * n], dec[B * n:]
    dec_routes = [tuple(torch.cat(pair, 1) for pair in zip(per_layer(pre, l, 1, 0),
                                                             per_layer(steps, l, B, 1)))
                  for l in range(n)]
    decoded = torch.stack(out, 1)
    res = moe_replay_gap(decoded, forward, dec_routes, fwd_routes)
    res.update(capacity_factor=E / K, moe_layers=n,
               dropped=sum(int(r.dropped) for r in fwd + dec),
               vs_greedy_run_rel=float((decoded - greedy).abs().max() / greedy.abs().max()),
               finite=bool(torch.isfinite(decoded).all() and torch.isfinite(forward).all()))
    return res


def replay_order(fwd_eidx: list, prompt: int, per_sequence: bool) -> list:
    """The forward's expert ids, one (B, L, K) a MoE layer in layer order,
    in the order in which prefill of the first `prompt` positions (the
    whole batch in one call, or with `per_sequence` one sequence a call) and
    then one decode step a later position call the layers."""
    B, L, K = fwd_eidx[0].shape
    if per_sequence:
        pre = [e[b, :prompt] for b in range(B) for e in fwd_eidx]
    else:
        pre = [e[:, :prompt].reshape(-1, K) for e in fwd_eidx]
    return pre + [e[:, i] for i in range(prompt, L) for e in fwd_eidx]


@contextmanager
def moe_replay(routes: list):
    """Inside the block every MoE layer call takes the next (T, K) expert
    ids of `routes` (in call order) in place of its own top K; its gates are
    its own router probabilities at those experts, renormalised as
    `moe.route` does.  Where its own top K is the same, so are the bits."""
    from repro_torch.models import moe

    own, queue = moe.route, iter(routes)

    def replayed(xt, router, top_k):
        _, _, probs = own(xt, router, top_k)
        eidx = next(queue).to(probs.device)
        gates = probs.gather(1, eidx)
        return gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9), eidx, probs

    moe.route = replayed
    try:
        yield
    finally:
        moe.route = own


def moe_replay_gap(decoded, forward, dec_routes, fwd_routes) -> dict:
    """Decode against the forward of a model with MoE layers, the forward's
    expert choices replayed in decode (`moe_replay`).  `decoded`, `forward`
    (B, N, V): logits at the same N positions; `dec_routes`, `fwd_routes`:
    one (eidx (B, L, K), probs (B, L, E)) a MoE layer in layer order over
    positions 0 .. L - 1, from prefill and the decode steps, and from the
    forward.  Returns the logits' gap over every position (`gap`, relative
    to the largest forward logit) and `replayed`, whether decode's expert
    ids are the forward's everywhere.  A (token, layer) where decode's own
    top K set would differ from the forward's is a would-be flip: from
    there on, unreplayed, the sequence would compute another function.  The
    router's perturbation, max over experts of |p_decode - p_forward| over
    the forward's K-th probability p_K, is read at each (token, layer) of a
    sequence up to its first would-be flip (`route_perturbation`, the
    reading MOE_ROUTE_TOL was derived on) and over all (`_all`).  At each
    would-be flip, the forward's tie (p_K - p_{K+1}) / p_K (`flip_tie_max`)
    is at most twice that (token, layer)'s perturbation, since two experts
    cross only where each moved by half the gap between them
    (`flip_tie_over_bound`, at most 1)."""
    from repro_torch.core.lsh import topk_largest

    B, L = fwd_routes[0][0].shape[:2]
    pos = torch.arange(L, device=decoded.device)
    rels, flips = [], []
    for (_, dp), (fe, fp) in zip(dec_routes, fwd_routes):
        K = fe.shape[-1]
        top = fp.topk(K + 1, dim=-1).values
        rels.append((dp - fp).abs().amax(-1) / top[..., K - 1])
        own = topk_largest(dp, K)[1]
        flips.append((own.sort(-1).values != fe.sort(-1).values).any(-1))
    first = torch.where(torch.stack(flips).any(0), pos, L).amin(-1, keepdim=True)  # (B, 1)
    seen = torch.zeros((B, L), dtype=torch.bool, device=decoded.device)
    eps = tie_max = over = 0.0
    for rel, flip, (fe, fp) in zip(rels, flips, fwd_routes):
        K = fe.shape[-1]
        eps = max(eps, float(rel[(pos < first) | ((pos == first) & ~seen)].max()))
        seen |= flip
        if bool(flip.any()):
            top = fp.topk(K + 1, dim=-1).values
            tie = (top[..., K - 1] - top[..., K]) / top[..., K - 1]
            tie_max = max(tie_max, float(tie[flip].max()))
            over = max(over, float((tie / (2 * rel))[flip].max()))
    rel_gap = (decoded - forward).abs().amax(-1) / forward.abs().max()
    n_flips = sum(int(f.sum()) for f in flips)
    return dict(gap=float(rel_gap.max()), positions=rel_gap.numel(),
                replayed=all(torch.equal(d[0], f[0]) for d, f in zip(dec_routes, fwd_routes)),
                route_perturbation=eps,
                route_perturbation_all=float(torch.stack(rels).max()),
                first_would_flip_positions=first[:, 0].tolist(),
                token_layers_would_flip=f"{n_flips}/{sum(f.numel() for f in flips)}",
                flip_tie_max=tie_max, flip_tie_over_bound=over)


def run_lm_decode(dev) -> dict:
    """Phases lm_decode, lm_moe and lm_multimodal: the smoke models on the
    card against the CPU, then each full-width model of LM_FULL and LM_MOE
    at its depth and of LM_MULTIMODAL at full depth, one at a time, freed
    before the next."""
    from repro_torch.kernels import common

    lm_smoke_vs_cpu(dev)
    counts = {k: 0 for k in common.LAUNCHES}
    recorded: dict = {"flash_attn": {}, "ssm_scan": {}, "flash_attn_prefill": {}}
    launches = {}
    for arch, depth in [*LM_FULL.items(), *LM_MOE.items(), *((a, None) for a in LM_MULTIMODAL)]:
        launches[arch] = lm_full(dev, arch, recorded, depth)
        for k, v in launches[arch].items():
            counts[k] += v
    return dict(counts=counts, recorded=recorded, launches=launches)


def decode_kernels_vs_plain(kernels: list, lm: dict) -> None:
    """flash_attn and ssm_scan against their plain versions at decode's
    shapes (the arguments of each model's last decode step: one call of
    each key count and window), timed beside their bounds (and SDPA for
    flash_attn); each record carries its kernel's launches in that model's
    run of the phase (loss_fn, prefill, every decode step).  flash_attn
    also at the prefill shapes of FLASH_PREFILL_RECORDED (each model's
    first prefill call: S 640 at its GQA group and head width, qwen2-vl-7b's
    S 896 over its patches and prompt; whisper-tiny's encoder over 1,500
    frames, its decoder's self attention and its cross attention of the
    prompt over the frames), under `prefill`."""
    from repro_torch.configs import ARCHS

    recs = {rec["name"]: rec for rec in kernels}
    prefill = {}
    for arch in FLASH_PREFILL_RECORDED:
        calls = lm["recorded"]["flash_attn_prefill"].get(arch, [])
        if len(calls) != (3 if ARCHS[arch].enc_dec else 1):
            fail(f"lm_decode: {len(calls)} prefill flash_attn shapes recorded for {arch}")
        for (q, k, v), kw in calls:
            tag = (f"{arch} prefill, B {q.shape[0]}, Sq {q.shape[1]}, Skv {k.shape[1]}, "
                   f"Hq {q.shape[2]} / Hkv {k.shape[2]}, dh {q.shape[3]}, "
                   f"{'causal' if kw['causal'] else 'not causal'}")
            prefill[tag] = dict(flash_record(q, k, v, dict(kw)),
                                launches=lm["launches"][arch]["flash_attn"])
    recs["flash_attn"]["prefill"] = prefill
    for kernel in ("flash_attn", "ssm_scan"):
        decode = {}
        for arch, calls in lm["recorded"][kernel].items():
            for args, kw in calls:
                if kernel == "flash_attn":
                    tag = (f"{arch} decode, Sq 1, Skv {args[1].shape[1]}, window {kw['window']}"
                           + ("" if kw["causal"] else ", not causal"))
                    rec = flash_record(*args, dict(kw))
                else:
                    tag, rec = f"{arch} decode, L 1", scan_record(*args)
                decode[tag] = dict(rec, launches=lm["launches"][arch][kernel])
        if not decode:
            fail(f"lm_decode: no {kernel} call recorded at a decode step")
        recs[kernel]["decode"] = decode
    emit(phase="kernels_vs_plain",
         kernels=["flash_attn (decode; lm_moe's, zamba2-7b's and lm_multimodal's prefill)",
                  "ssm_scan (decode)"],
         tolerance=dict(flash_attn=FLASH_TOL, ssm_scan=SCAN_TOL), ok=True)


def launched_once(before: dict, name: str, other: str, times: int = 1) -> bool:
    """True where `name` counted `times` launches since `before` and its
    other form (float32 or bf16) none."""
    from repro_torch.kernels import common

    after = common.launch_counts()
    return (after[name] - before[name], after[other] - before[other]) == (times, 0)


def bound_floor(terms: dict, nbytes: int) -> float:
    """The least device time a kernel's reading may show: its bound's
    operation terms, and its bytes' term where the bytes do not fit the L2
    (a run repeated on inputs that fit may read them from there)."""
    return max([t for key, t in terms.items() if key != "bytes"]
               + ([terms["bytes"]] if nbytes > L2_BYTES else []))


def flash_record(q, k, v, kw: dict, bf16_probs: bool = False) -> dict:
    """flash_attn against its plain version on one input: error, times
    (CUDA events around one call, and the mean device time of a launch under
    torch.profiler with the launches it saw), the time of
    scaled_dot_product_attention with the same mask (it has no softcap),
    and the bound: the largest of the bytes (q, k, v read once, o written
    once), the tensor-core products (Q K^T and P V, each 2 dh operations
    for every unmasked (query, key) pair, three MMAs each at the TF32 rate)
    and the exps (one a pair, on the special-function units); `bound_term`
    names it.  The float32 pipe's time for the same products (`fp32` in
    bound_terms_ms, the bound of a design without tensor cores) is reported
    beside them.  With `bf16_probs`, the bf16-P form: held to the plain
    mirror of its key-tile walk by knob_gap_check, not the float32
    kernel's output, timed beside its float32 form in this call; P V at the
    bf16 rate in the bound (`products`); no library call (SDPA on bf16
    inputs rounds q, k and the scores' softmax too and returns bf16, so it
    does not compute this function)."""
    from repro_torch.kernels import common
    from repro_torch.kernels.flash_attn import (attn_mask, flash_attention,
                                                flash_attention_bf16_tiles_ref,
                                                flash_attention_ref)
    from repro_torch.kernels.flash_attn import ops as flash_ops

    B, Sq, Hq, dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    kw = {key: kw[key] for key in ("causal", "window", "softcap")}
    name, other = ("flash_attn_bf16", "flash_attn") if bf16_probs else ("flash_attn",
                                                                        "flash_attn_bf16")
    shape = dict(B=B, Sq=Sq, Skv=Skv, Hq=Hq, Hkv=Hkv, dh=dh, **kw)
    call = lambda: flash_attention(q, k, v, bf16_probs=bf16_probs, **kw)  # noqa: E731
    f32 = lambda: flash_attention(q, k, v, **kw)  # noqa: E731
    plain = lambda: flash_attention_ref(q, k, v, bf16_probs=bf16_probs, **kw)  # noqa: E731
    before = common.launch_counts()
    out = call()
    if not launched_once(before, name, other):
        fail(f"{name}: a call did not launch its kernel once")
    if bf16_probs:
        rows, keys = flash_ops.fwd_tiles(B, Sq, Hq, Hkv)
        errs = knob_gap_check(name, out, flash_attention_bf16_tiles_ref(
            q, k, v, block_rows=rows, key_tile=keys, **kw), plain(),
            flash_attention_ref(q, k, v, **kw), shape)
        errs["tiles"] = dict(rows=rows, keys=keys)
        if torch.equal(out, f32()):
            fail(f"{name}: the output equals the float32 form's at {shape}")
    else:
        ref = plain()
        torch.testing.assert_close(out, ref, **FLASH_TOL)
        errs = dict(max_abs_err=float((out - ref).abs().max()))
        del ref
    mask = attn_mask(Sq, Skv, causal=kw["causal"], window=kw["window"], device=q.device)
    pairs = int(mask.sum()) * B * Hq
    nbytes = 4 * (2 * B * Sq * Hq * dh + 2 * B * Skv * Hkv * dh)

    def terms_of(bf: bool) -> dict:
        pv_s = 2 * dh * pairs / BF16_FLOPS if bf else 3 * 2 * dh * pairs / TF32_FLOPS
        return {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                "products" if bf else "tf32x3": (3 * 2 * dh * pairs / TF32_FLOPS + pv_s) * 1e3,
                "exp": pairs / SFU_EXP_PER_S * 1e3}

    terms = terms_of(bf16_probs)
    term = max(terms, key=terms.get)
    floor = bound_floor(terms, nbytes)
    rec = dict(**errs, ms=median_ms(call, 20),
               **device_ms(call, 20, 1, "flash_attn_kernel", floor_ms=floor),
               plain_ms=median_ms(plain, 5),
               bound_ms=terms[term], bound_by="bytes" if term == "bytes" else "operations",
               bound_term=term, bound_terms_ms=dict(terms, fp32=4 * dh * pairs / FP32_FLOPS * 1e3),
               shape=dict(shape, unmasked_pairs=pairs))
    if bf16_probs:
        rec.update(fp32_form_ms=median_ms(f32, 20), library_ms=None,
                   **device_ms(f32, 20, 1, "flash_attn_kernel", key="fp32_form_device",
                               floor_ms=bound_floor(terms_of(False), nbytes)))
        return rec
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa_mask = None if kw["window"] == 0 and (Sq == Skv or not kw["causal"]) else mask
    sdpa_causal = kw["causal"] and sdpa_mask is None

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=sdpa_mask, is_causal=sdpa_causal, enable_gqa=True)

    rec.update(library_ms=median_ms(sdpa, 20), **device_ms(sdpa, 20, key="library_device"))
    return rec


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


def scan_record(dt, x, Bc, Cc, A, h0) -> dict:
    """ssm_scan (the wrapper) against its plain version on one input: error,
    times (CUDA events around one call, and the mean device time of a launch
    under torch.profiler, with the launches it saw of 20), and
    the bound: the largest of the bytes (dt, x, B, C, A, h0 read once, y and
    h written once), the float32 operations (7 a state element and step) and
    the exps (one a state element and step, on the special-function units);
    `bound_term` names the largest.  With dt, x, B, C in bf16, the bf16 form
    (ssm_bf16_acts): y, h_fin and the tiles' checkpoints bit for bit the
    float32 form's on the inputs widened (its error against the plain
    version reported: the bits are its gate); the SSMScan node saves the
    four as bf16; timed beside the float32 form in this call; the four's
    bytes in bf16 in the bound."""
    from repro_torch.kernels import common
    from repro_torch.kernels.ssm_scan import ops as scan_ops
    from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_batched_ref

    ins = [dt, x, Bc, Cc, A, h0]
    B, L, D = dt.shape
    N = Bc.shape[2]
    bf16 = dt.dtype == torch.bfloat16
    name, other = ("ssm_scan_bf16", "ssm_scan") if bf16 else ("ssm_scan", "ssm_scan_bf16")
    before = common.launch_counts()
    y, h = ssm_scan(*ins)
    if not launched_once(before, name, other):
        fail(f"{name}: a call did not launch its kernel once")
    y_ref, h_ref = ssm_scan_batched_ref(*ins)
    if not bf16:
        torch.testing.assert_close(y, y_ref, **SCAN_TOL)
        torch.testing.assert_close(h, h_ref, **SCAN_TOL)
    rec = dict(max_abs_err=max(float((y - y_ref).abs().max()), float((h - h_ref).abs().max())))
    del y, h, y_ref, h_ref
    wide = [t.float() for t in ins[:4]] + ins[4:]
    if bf16:
        for ckpt in (False, True):
            got = scan_ops._forward(*ins, checkpoints=ckpt)
            want = scan_ops._forward(*wide, checkpoints=ckpt)
            if not all((a is None and b is None) or bits_equal(a, b) for a, b in zip(got, want)):
                fail(f"{name}: not the float32 form's bits on the widened inputs at "
                     f"{B, L, D, N} (checkpoints {ckpt})")
        args = [t.detach().requires_grad_() for t in ins[:4]] + ins[4:]
        y, _ = ssm_scan(*args)
        saved = [str(t.dtype) for t in y.grad_fn.saved_tensors[:4]]
        if saved != ["torch.bfloat16"] * 4:
            fail(f"{name}: SSMScan saved dt, x, B, C as {saved}")
        rec.update(bits_equal_fp32_form_on_widened=True, saved_dtype=saved[0])
        del got, want, args, y
    elems = B * L * D * N

    def terms_of(in_bytes: int) -> tuple[dict, int]:
        nbytes = in_bytes * (2 * B * L * D + 2 * B * L * N) + 4 * (
            B * L * D + D * N + 2 * B * D * N)
        return dict(bytes=nbytes / HBM_BYTES_PER_S * 1e3, fp32=7 * elems / FP32_FLOPS * 1e3,
                    exp=elems / SFU_EXP_PER_S * 1e3), nbytes

    terms, nbytes = terms_of(dt.element_size())
    term = max(terms, key=terms.get)
    floor = bound_floor(terms, nbytes)
    call = lambda: ssm_scan(*ins)  # noqa: E731
    rec.update(ms=median_ms(call, 20),
               **device_ms(call, 20, 1, "ssm_scan_kernel", floor_ms=floor),
               plain_ms=median_ms(lambda: ssm_scan_batched_ref(*ins), 3),
               bound_ms=terms[term], bound_by="bytes" if term == "bytes" else "operations",
               bound_term=term, bound_terms_ms=terms, library_ms=None,
               shape=dict(B=B, L=L, D=D, N=N))
    if bf16:
        f32 = lambda: ssm_scan(*wide)  # noqa: E731
        rec.update(fp32_form_ms=median_ms(f32, 20),
                   **device_ms(f32, 20, 1, "ssm_scan_kernel", key="fp32_form_device",
                               floor_ms=bound_floor(*terms_of(4))))
    return rec


def serve_kernels_vs_plain(serve: dict, launches: dict) -> list:
    """Phase 16: flash_attn and ssm_scan against their plain versions at the
    serving shape (the arguments recorded from one embedded batch) and at
    long shapes (three for flash_attn, two for ssm_scan), timed beside their
    bounds (and SDPA for flash_attn)."""
    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator(device=dev)
    g.manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    (q, k, v), kw = serve["recorded"]["flash_attn"]
    serving = flash_record(q, k, v, dict(kw))
    long = {}
    causal = dict(causal=True, window=0, softcap=0.0)
    # gemma2-9b's heads at a 2,048-token prompt, causal and with gemma2's
    # window and softcap; gemma-2b's heads at a 4,096-token prompt
    for tag, (B, S, Hq, Hkv, dh), kw in (
            ("window 1024, softcap 50", (4, 2048, 16, 8, 256),
             dict(causal=True, window=1024, softcap=50.0)),
            ("causal", (4, 2048, 16, 8, 256), causal),
            ("gemma-2b heads, B 1, S 4096, causal", (1, 4096, 8, 1, 256), causal)):
        q, k, v = randn(B, S, Hq, dh), randn(B, S, Hkv, dh), randn(B, S, Hkv, dh)
        long[tag] = flash_record(q, k, v, kw)
        del q, k, v
        torch.cuda.empty_cache()
    kernels = [dict(
        name="flash_attn", route="cuda", source="src/repro_torch/kernels/csrc/flash_attn.cu",
        replaces="src/repro/kernels/flash_attn/flash_attn.py:88",
        launches=launches["flash_attn"], **serving,
        library_call="scaled_dot_product_attention (same mask, no softcap, enable_gqa)",
        long=long)]

    args, _ = serve["recorded"]["ssm_scan"]
    serving = scan_record(*args)
    long = {}
    D, N = 8192, 16
    for tag, B, L in (("L 2048", 4, 2048), ("B 1, L 4096", 1, 4096)):
        dt = torch.nn.functional.softplus(randn(B, L, D))
        A = -torch.exp(0.5 * randn(D, N))
        long[tag] = scan_record(dt, randn(B, L, D), randn(B, L, N), randn(B, L, N), A,
                                torch.zeros((B, D, N), device=dev))
        del dt, A
    kernels.append(dict(
        name="ssm_scan", route="cuda", source="src/repro_torch/kernels/csrc/ssm_scan.cu",
        replaces="src/repro/kernels/ssm_scan/ssm_scan.py:48",
        launches=launches["ssm_scan"], **serving, long=long))
    emit(phase="kernels_vs_plain", kernels=["flash_attn", "ssm_scan"],
         tolerance=dict(flash_attn=FLASH_TOL, ssm_scan=SCAN_TOL), ok=True)
    return kernels


def run_training(dev) -> dict:
    """Phases train_full, train_mamba (after train_full has freed
    gemma-2b), train_smoke_vs_cpu and train_resume (after the LM phases
    have freed their models); returns the launches of the training
    paths."""
    from repro_torch.kernels import common

    counts = {k: 0 for k in common.LAUNCHES}
    knob_counts = dict(counts)
    full, full_knob = train_full(dev)
    mamba, mamba_knob = train_full(dev, TRAIN_MAMBA_ARCH, TRAIN_MAMBA_LAYERS, "train_mamba")
    for part in (full, mamba, train_smoke_vs_cpu(dev), train_resume(dev)):
        for k in counts:
            counts[k] += part[k]
    for k in knob_counts:
        knob_counts[k] += full_knob[k] + mamba_knob[k]
    return dict(counts=counts, knob_counts=knob_counts)


def train_batch(cfg, step: int, B: int = 4, S: int = 32) -> dict:
    """A smoke training batch: the pipeline's tokens and labels at `step`,
    a mask with the last row dropped, whisper's frames N(0, 1) from a seed."""
    from repro_torch.data import lm_token_batches

    toks, labels = lm_token_batches(cfg.vocab, seed=0)(step, B, S)
    mask = np.ones(toks.shape, np.float32)
    mask[-1] = 0.0
    out = {"tokens": toks, "labels": labels, "mask": mask}
    if cfg.enc_dec:
        out["frames"] = np.random.default_rng(step).normal(
            size=(B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    return out


def train_full(dev, arch: str = TRAIN_ARCH, layers: int | None = None,
               phase: str = "train_full") -> dict:
    """Phase train_full: gemma-2b at full width and depth (18 layers, 2.506 B
    parameters, seed 0) takes TRAIN_STEPS steps of `make_train_step` (bf16
    compute over float32 masters, clip, cosine-scheduled AdamW with float32
    moments) on batches of a `DataPipeline` through the near-dup filter, as
    the Trainer drives them, without the checkpoint (a full-width state is
    30 GB of host disk); phase train_mamba the same for falcon-mamba-7b at
    full width, cut to `layers` layers (TRAIN_MAMBA_LAYERS).  Gates: every
    loss finite, the last below the first, exactly one flash_attn and one
    flash_attn_bwd launch an attention layer and one ssm_scan and one
    ssm_scan_bwd launch a Mamba-1 layer a step and nothing else in a step,
    the filter's circrun and circrun_topk launches; no plain version runs.
    Reports the step times (host clock fenced by the metrics' read),
    tokens/s, peak device memory beside the state's bytes, one profiled
    step (`profile_<phase>_step`), the dropped rows.  Then one step of the
    same state with the model's bf16 knob on (`train_with_knob`, phase
    bf16_knobs).  Returns the launch counts of the steps, and of the knob's
    step."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.data import DataPipeline, lm_token_batches
    from repro_torch.data.dedup import NearDupFilter
    from repro_torch.kernels import common
    from repro_torch.models import param_count
    from repro_torch.optim import cosine_schedule
    from repro_torch.train import init_train_state, make_train_step

    t_phase = time.perf_counter()
    cfg = full = ARCHS[arch]
    if layers is not None:
        cfg = dataclasses.replace(cfg, repeats=layers // len(cfg.pattern), n_layers=layers)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state, init_s = sync_time(lambda: init_train_state(cfg, 0, dev))
    n_params = param_count(state.model)
    dedup = NearDupFilter(threshold=TRAIN["dedup_threshold"], device=dev)
    pipe = DataPipeline(lm_token_batches(cfg.vocab, seed=0), global_batch=TRAIN["global_batch"],
                        seq_len=TRAIN["seq_len"], dedup=dedup)
    step = make_train_step(cfg, lambda s: cosine_schedule(
        s, peak_lr=TRAIN["peak_lr"], warmup=TRAIN["warmup"], total=TRAIN["total"]),
        clip_norm=TRAIN["clip"])
    want = lm_kernel_layers(cfg)[0]
    want.update(flash_attn_bwd=want["flash_attn"], ssm_scan_bwd=want["ssm_scan"])
    history, secs = [], []
    common.reset_launch_counts()
    with plain_versions_refused():
        for i in range(TRAIN_STEPS):
            batch = next(pipe)
            before = common.launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}  # waits for the step
            secs.append(time.perf_counter() - t0)
            after = common.launch_counts()
            got = {k: after[k] - before[k] for k in after}
            if got != want:
                fail(f"{phase}: step {i} launched {got}, expected {want}")
            history.append(dict(step=i + 1, **metrics))
    counts = common.launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    losses = [h["loss"] for h in history]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"{phase}: losses {losses} not finite and falling")
    if counts["circrun"] == 0 or counts["circrun_topk"] == 0:
        fail(f"{phase}: the near-dup filter launched no circrun kernel: {counts}")
    med = statistics.median(secs)
    tokens = TRAIN["global_batch"] * TRAIN["seq_len"]
    gb = 4 * n_params / 1e9
    emit(phase=phase, arch=cfg.name, layers=cfg.n_layers, full_layers=full.n_layers,
         params=n_params, steps=TRAIN_STEPS,
         config=dict(TRAIN, compute_dtype="bfloat16", opt_dtype="float32"), init_s=init_s,
         step_ms_median=med * 1e3, step_ms=[t * 1e3 for t in secs], tokens_per_s=tokens / med,
         losses=losses, history=history, launches=counts, launches_per_step=want,
         dropped_rows=dedup.n_dropped, peak_mem_over_base_bytes=peak,
         state_gb=dict(params_m_v=3 * gb, grads=gb, bf16_copies=gb / 2),
         seconds=time.perf_counter() - t_phase)
    last = next(pipe)
    profile_call(lambda: step(state, last),
                 "profile_train_step" if phase == "train_full" else f"profile_{phase}_step",
                 arch=cfg.name, layers=cfg.n_layers, tokens=tokens)
    knob_counts = train_with_knob(state, cfg, next(pipe), phase)
    del state, pipe, dedup, step, last
    torch.cuda.empty_cache()
    return counts, knob_counts


def train_smoke_vs_cpu(dev) -> dict:
    """Phase train_smoke_vs_cpu: smoke gemma-2b, qwen3-moe (the aux loss),
    whisper-tiny (frames, cross attention) and falcon-mamba-7b (ssm_scan and
    its backward kernel) take TRAIN_SMOKE_STEPS steps in float32 compute on
    the card and on the CPU from the same weights and batches: losses and
    grad norms within TRAIN_SMOKE_RTOL every step, the parameters within
    TRAIN_PARAM_ATOL after the first; each backward kernel launched once a
    layer a step."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import common
    from repro_torch.train import init_train_state, make_train_step

    counts = {k: 0 for k in common.LAUNCHES}
    for arch in TRAIN_SMOKE:
        cfg = ARCHS[arch].smoke()
        cpu = init_train_state(cfg, 0, "cpu")
        card = init_train_state(cfg, 0, dev)
        with torch.no_grad():
            for a, b in zip(card.model.parameters(), cpu.model.parameters()):
                a.copy_(b)
        step = make_train_step(cfg, lambda s: 1e-3, compute_dtype=torch.float32)
        common.reset_launch_counts()
        rows, param_diff = [], None
        for i in range(TRAIN_SMOKE_STEPS):
            batch = train_batch(cfg, i)
            card, mc = step(card, batch)
            cpu, mp = step(cpu, batch)
            mc, mp = ({k: float(v) for k, v in m.items()} for m in (mc, mp))
            rows.append(dict(step=i + 1, card=mc, cpu=mp))
            for key in ("loss", "grad_norm"):
                if abs(mc[key] - mp[key]) > TRAIN_SMOKE_RTOL * abs(mp[key]):
                    fail(f"train_smoke_vs_cpu: {arch} step {i + 1} {key} card {mc[key]} "
                         f"cpu {mp[key]}")
            if i == 0:
                param_diff = max(float((a.detach().cpu() - b.detach()).abs().max())
                                 for a, b in zip(card.model.parameters(),
                                                 cpu.model.parameters()))
                if param_diff > TRAIN_PARAM_ATOL:
                    fail(f"train_smoke_vs_cpu: {arch} parameters {param_diff} apart after "
                         "one step")
        part = common.launch_counts()
        per = lm_kernel_layers(cfg)[0]
        want = {k: TRAIN_SMOKE_STEPS * per[k.removesuffix("_bwd")]
                for k in ("flash_attn", "flash_attn_bwd", "ssm_scan", "ssm_scan_bwd")}
        if any(part[k] != n for k, n in want.items()):
            fail(f"train_smoke_vs_cpu: {arch} launched {part}, expected {want}")
        for k in counts:
            counts[k] += part[k]
        emit(phase="train_smoke_vs_cpu", arch=arch, steps=rows,
             param_max_abs_diff_after_step_1=param_diff, launches=part,
             tolerance=dict(rtol=TRAIN_SMOKE_RTOL, param_atol=TRAIN_PARAM_ATOL))
    return counts


def train_resume(dev) -> dict:
    """Phase train_resume: the Trainer on the card at smoke size on the
    reference test's schedule (6 steps, stop, resume to 12) against an
    uninterrupted 12, losses at steps 9 and 12 within RESUME_RTOL; then one
    run each of `launch.train --smoke --dedup --ckpt-dir D` and
    `launch.serve --smoke --ckpt-dir D`, which must print `restored step`."""
    from repro_torch.configs import ARCHS
    from repro_torch.data import DataPipeline, lm_token_batches
    from repro_torch.kernels import common
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = ARCHS[TRAIN_ARCH].smoke()
    common.reset_launch_counts()
    root = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    with tempfile.TemporaryDirectory() as tmp:
        def trainer(steps, d):
            pipe = DataPipeline(lm_token_batches(cfg.vocab, seed=1), global_batch=4, seq_len=16)
            return Trainer(cfg, pipe, TrainerConfig(steps=steps, total_steps=12, ckpt_every=3,
                                                    ckpt_dir=str(Path(tmp) / d), log_every=3,
                                                    warmup=2), device=dev)

        first = trainer(6, "a").run()
        resumed = trainer(12, "a").run()
        straight = trainer(12, "b").run()
        h_res = {h["step"]: h["loss"] for h in resumed["history"]}
        h_str = {h["step"]: h["loss"] for h in straight["history"]}
        for s in (9, 12):
            if abs(h_res[s] - h_str[s]) > RESUME_RTOL * abs(h_str[s]):
                fail(f"train_resume: step {s} loss {h_res[s]} resumed, {h_str[s]} straight")
        counts = common.launch_counts()
        ck = str(Path(tmp) / "cli")
        cli = {}
        for name, args in (("train", ["repro_torch.launch.train", "--arch", TRAIN_ARCH,
                                      "--smoke", "--dedup", "--steps", "10", "--ckpt-dir", ck]),
                           ("serve", ["repro_torch.launch.serve", "--arch", TRAIN_ARCH,
                                      "--smoke", "--corpus", "64", "--requests", "16", "--m",
                                      "16", "--ckpt-dir", ck])):
            t0 = time.perf_counter()
            out = subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True,
                                 timeout=600, cwd=root, env=env)
            if out.returncode != 0:
                fail(f"train_resume: launch.{name} exit {out.returncode}\n"
                     f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
            cli[name] = dict(seconds=time.perf_counter() - t0,
                             stdout=[ln for ln in out.stdout.splitlines()
                                     if ln.startswith("[")][-3:])
        if "restored step 10" not in out.stdout:
            fail(f"train_resume: launch.serve did not restore the trained step:\n"
                 f"{out.stdout[-2000:]}")
    emit(phase="train_resume", arch=cfg.name, first=first["final_step"],
         resumed=resumed["final_step"], losses_resumed=h_res, losses_straight=h_str,
         rtol=RESUME_RTOL, cli=cli)
    return counts


def flash_bwd_kernels_vs_plain(launches: dict) -> dict:
    """The kernels line's record of flash_attn_bwd: the backward kernel
    against its plain version (flash_attn_bwd_record) at gemma-2b's
    training shape and, under `long`, at the long causal shape, gemma2-9b's
    window with softcap, whisper's cross attention and a shape with rows
    that see no key."""
    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    causal = dict(causal=True, window=0, softcap=0.0)
    shapes = (
        ("gemma-2b training, B 8, S 64, Hq 8 / Hkv 1, dh 256, causal", (8, 64, 64, 8, 1, 256),
         causal),
        ("B 4, S 2048, Hq 16 / Hkv 8, dh 256, causal", (4, 2048, 2048, 16, 8, 256), causal),
        ("gemma2-9b, B 4, S 2048, window 1024, softcap 50", (4, 2048, 2048, 16, 8, 256),
         dict(causal=True, window=1024, softcap=50.0)),
        ("whisper-tiny cross, B 4, Sq 640 over 1,500, 6 heads of 64, not causal",
         (4, 640, 1500, 6, 6, 64), dict(causal=False, window=0, softcap=0.0)),
        ("rows with no key, B 2, Sq 150 > Skv 70, Hq 4 / Hkv 2, dh 64, causal",
         (2, 150, 70, 4, 2, 64), causal))
    recs = {}
    for tag, (B, Sq, Skv, Hq, Hkv, dh), kw in shapes:
        q = torch.randn((B, Sq, Hq, dh), generator=g, device=dev)
        k, v = (torch.randn((B, Skv, Hkv, dh), generator=g, device=dev) for _ in range(2))
        do = torch.randn((B, Sq, Hq, dh), generator=g, device=dev)
        recs[tag] = flash_bwd_record(q, k, v, do, kw)
        del q, k, v, do
        torch.cuda.empty_cache()
    main_tag = shapes[0][0]
    rec = dict(name="flash_attn_bwd", route="cuda",
               source="src/repro_torch/kernels/csrc/flash_attn_bwd.cu",
               replaces="src/repro/models/attention.py:72 (jax.value_and_grad of "
                        "chunked_attention, src/repro/train/step.py:47-53; "
                        "src/repro/kernels/flash_attn/flash_attn.py:88 has no backward)",
               launches=launches["flash_attn_bwd"], **recs.pop(main_tag),
               library_call="autograd of scaled_dot_product_attention, float32 (same mask, "
                            "no softcap, enable_gqa)",
               long=recs)
    emit(phase="kernels_vs_plain", kernels=["flash_attn_bwd"],
         tolerance=dict(flash_attn_bwd=f"{FLASH_BWD_REL_TOL} of each gradient's largest "
                                       "entry; lse within FLASH_TOL; bit-identical reruns"),
         ok=True)
    return rec


def sdpa_backward(q, k, v, do, kw):
    """SDPA's float32 backward on the same inputs (the same mask as
    flash_record's; no softcap), as a timed call, and the name of the first
    backend, in SDPA's order, that runs it."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.flash_attn import attn_mask

    Sq, Skv = q.shape[1], k.shape[1]
    mask = attn_mask(Sq, Skv, causal=kw["causal"], window=kw["window"], device=q.device)
    sdpa_mask = None if kw["window"] == 0 and (Sq == Skv or not kw["causal"]) else mask
    ins = [t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v)]
    dot = do.transpose(1, 2).contiguous()
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                out = torch.nn.functional.scaled_dot_product_attention(
                    *ins, attn_mask=sdpa_mask, is_causal=kw["causal"] and sdpa_mask is None,
                    enable_gqa=True)
                torch.autograd.grad(out, ins, dot, retain_graph=True)
            torch.cuda.synchronize()
        except RuntimeError:
            continue

        def run(out=out):
            return torch.autograd.grad(out, ins, dot, retain_graph=True)

        return run, backend.name
    fail("flash_attn_bwd: no SDPA backend ran the float32 backward")


def flash_bwd_record(q, k, v, do, kw: dict, bf16_probs: bool = False) -> dict:
    """flash_attn_bwd against its plain version on one input: the forward
    kernel's o and lse (written when autograd needs them), then the backward
    kernel twice (bit-identical, or the run fails), against
    flash_attention_bwd_ref on the plain forward's o and lse: each of dq,
    dk, dv within FLASH_BWD_REL_TOL of its largest entry, the lse within
    FLASH_TOL where a row sees a key and +inf where it sees none.  Times:
    CUDA events around one call, the mean device time of a call's kernels
    (`bwd_kernels`: two, or three with the row chunks' reduce) under
    torch.profiler, the plain version's, SDPA's float32
    backward (`sdpa_backward`, its backend named).  Bound: the largest of
    the bytes (q, k, v, o, dO, lse read once, dq, dk, dv written once), the
    five products (2 dh operations each for every unmasked pair: 2.5 times
    the forward's two) at the 3xTF32 rate as the forward's bound takes
    them, and one exp a pair; the float32 pipe's time for the products
    (`fp32`, the bound of the parent design's FMAs) beside them.  With
    `bf16_probs`, the bf16-P form on the bf16-P forward's o and lse (that
    lse bit for bit the float32 form's): each of dq, dk, dv held by
    knob_gap_check to the plain bf16-P backward on the same o and lse (the
    kernel's function; the plain float32 backward on them gives the knob's
    gap), dv not the float32 form's, timed beside the float32 form in this
    call; P^T dO and dO V^T at the bf16 rate in the bound (`products`); no
    library call (as flash_record's)."""
    from repro_torch.kernels import common
    from repro_torch.kernels.flash_attn import (attn_mask, flash_attention_bwd,
                                                flash_attention_bwd_ref, flash_attention_ref)
    from repro_torch.kernels.flash_attn import ops as flash_ops

    B, Sq, Hq, dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    kw = {key: kw[key] for key in ("causal", "window", "softcap")}
    name, other = (("flash_attn_bwd_bf16", "flash_attn_bwd") if bf16_probs
                   else ("flash_attn_bwd", "flash_attn_bwd_bf16"))
    shape = dict(B=B, Sq=Sq, Skv=Skv, Hq=Hq, Hkv=Hkv, dh=dh, **kw)
    mask_kw = (kw["causal"], kw["window"], kw["softcap"])
    o, lse = flash_ops._forward(q, k, v, *mask_kw, True, bf16_probs=bf16_probs)
    chunks = flash_ops.bwd_chunks(B, Sq, Skv, Hq, Hkv, dh)
    n_kernels = flash_ops.bwd_kernels(B, Sq, Skv, Hq, Hkv, dh)
    call = lambda: flash_attention_bwd(q, k, v, o, lse, do, bf16_probs=bf16_probs,  # noqa: E731
                                       **kw)
    before = common.launch_counts()
    got = call()
    again = call()
    torch.cuda.synchronize()
    if not launched_once(before, name, other, times=2):
        fail(f"{name}: a call did not launch its kernels once")
    if not all(bits_equal(a, b) for a, b in zip(got, again)):
        fail(f"{name}: two runs differ at {shape}")
    del again
    o_ref, lse_ref = flash_attention_ref(q, k, v, return_lse=True, **kw)
    finite = torch.isfinite(lse_ref)
    if not torch.equal(torch.isfinite(lse), finite) or not bool(torch.isinf(lse[~finite]).all()):
        fail(f"{name}: the forward's lse is not +inf exactly where a row sees no key")
    torch.testing.assert_close(lse[finite], lse_ref[finite], **FLASH_TOL)
    lse_err = float((lse[finite] - lse_ref[finite]).abs().max())
    if bf16_probs:
        o32, lse32 = flash_ops._forward(q, k, v, *mask_kw, True)
        if not bits_equal(lse, lse32):
            fail(f"{name}: the bf16-P forward's lse is not the float32 form's at {shape}")
        want = flash_attention_bwd_ref(q, k, v, o, lse, do, bf16_probs=True, **kw)
        plain = flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
        errs = {tag: knob_gap_check(f"{name} {tag}", a, w, w, p, shape)
                for tag, a, w, p in zip(("dq", "dk", "dv"), got, want, plain)}
        f32_call = lambda: flash_attention_bwd(q, k, v, o32, lse32, do, **kw)  # noqa: E731
        if torch.equal(got[2], f32_call()[2]):
            fail(f"{name}: dv equals the float32 form's at {shape}")
        del want, plain
    else:
        ref = flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, do, **kw)
        errs = {}
        for tag, a, b in zip(("dq", "dk", "dv"), got, ref):
            scale = max(float(b.abs().max()), 1e-30)
            errs[tag] = dict(max_abs_err=float((a - b).abs().max()), largest=scale)
            if (not bool(torch.isfinite(a).all())
                    or errs[tag]["max_abs_err"] > FLASH_BWD_REL_TOL * scale):
                fail(f"{name}: {tag} off its plain version at {shape}: {errs}")
        del ref
    del o_ref, lse_ref, got
    mask = attn_mask(Sq, Skv, causal=kw["causal"], window=kw["window"], device=q.device)
    pairs = int(mask.sum()) * B * Hq
    nbytes = 4 * (4 * B * Sq * Hq * dh + 4 * B * Skv * Hkv * dh + B * Sq * Hq)

    def terms_of(bf: bool) -> dict:
        products = (3 * 6 * dh * pairs / TF32_FLOPS + 4 * dh * pairs / BF16_FLOPS if bf
                    else 3 * 10 * dh * pairs / TF32_FLOPS)
        return {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                "products" if bf else "tf32x3": products * 1e3,
                "exp": pairs / SFU_EXP_PER_S * 1e3}

    terms = terms_of(bf16_probs)
    term = max(terms, key=terms.get)
    rec = dict(max_abs_err=max(e["max_abs_err"] for e in errs.values()), errors=errs,
               lse_max_abs_err=lse_err, ms=median_ms(call, 10),
               **device_ms(call, 10, n_kernels, "flash_attn_bwd",
                           floor_ms=bound_floor(terms, nbytes)),
               kernels_per_call=n_kernels, row_chunks=chunks,
               plain_ms=median_ms(lambda: flash_attention_bwd_ref(
                   q, k, v, o, lse, do, bf16_probs=bf16_probs, **kw), 3),
               bound_ms=terms[term], bound_by="bytes" if term == "bytes" else "operations",
               bound_term=term, bound_terms_ms=dict(terms, fp32=10 * dh * pairs / FP32_FLOPS * 1e3),
               bit_identical_reruns=True, shape=dict(shape, unmasked_pairs=pairs))
    if bf16_probs:
        rec.update(fp32_form_ms=median_ms(f32_call, 10), library_ms=None,
                   **device_ms(f32_call, 10, n_kernels, "flash_attn_bwd", key="fp32_form_device",
                               floor_ms=bound_floor(terms_of(False), nbytes)))
        return rec
    sdpa, backend = sdpa_backward(q, k, v, do, kw)
    rec.update(library_ms=median_ms(sdpa, 10), **device_ms(sdpa, 10, key="library_device"),
               library_backend=backend)
    return rec


def scan_bwd_kernels_vs_plain(launches: dict) -> dict:
    """The kernels line's record of ssm_scan_bwd: the scan's backward kernel
    against its plain version (scan_bwd_record) at falcon-mamba-7b's
    training shape (B 8, L 64, D 8192, N 16) and, under `long`, at the
    forward's long shapes (B 4, L 2048 and B 1, L 4096)."""
    t0 = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    D, N = 8192, 16
    recs = {}
    for tag, B, L in (("training, B 8, L 64", 8, 64), ("L 2048", 4, 2048),
                      ("B 1, L 4096", 1, 4096)):
        def randn(*shape, s=1.0):
            return s * torch.randn(shape, generator=g, device=dev)

        ins = [torch.nn.functional.softplus(randn(B, L, D)), randn(B, L, D), randn(B, L, N),
               randn(B, L, N), -torch.exp(randn(D, N, s=0.5)), randn(B, D, N)]
        recs[tag] = scan_bwd_record(ins, randn(B, L, D))
        del ins
        torch.cuda.empty_cache()
    rec = dict(name="ssm_scan_bwd", route="cuda",
               source="src/repro_torch/kernels/csrc/ssm_scan_bwd.cu",
               replaces="src/repro/models/ssm.py:103 (jax.value_and_grad through "
                        "_mamba1_fused, src/repro/train/step.py:53; "
                        "src/repro/kernels/ssm_scan/ssm_scan.py:48 has no backward)",
               launches=launches["ssm_scan_bwd"], **recs.pop("training, B 8, L 64"),
               library_call=None, long=recs)
    emit(phase="kernels_vs_plain", kernels=["ssm_scan_bwd"],
         tolerance=dict(ssm_scan_bwd=f"{SCAN_BWD_REL_TOL} of each gradient's largest entry; "
                                     "bit-identical reruns; the forward's y and h_fin bit for "
                                     "bit with and without checkpoints"), ok=True,
         seconds=time.perf_counter() - t0)
    return rec


def scan_bwd_record(ins: list, dy: torch.Tensor) -> dict:
    """ssm_scan_bwd against its plain version on one input, as training
    calls it (no gradient of the final state): the forward with the tiles'
    checkpoints (its y and h_fin bit for bit the forward's without), then
    the backward kernel twice (bit-identical, one counted launch each, or
    the run fails), against ssm_scan_bwd_ref: each of ddt, dx, dB, dC, dA,
    dh0 within SCAN_BWD_REL_TOL of its largest entry.  Times: CUDA events
    around one call, the mean device time of a call's two kernels under
    torch.profiler, and the plain version's one call (the check's, host
    clock fenced by synchronize: a Python loop over the steps, 1.5 s at B
    4, L 2048, so not repeated).  Bound: the largest of the bytes
    (dt, x, dy, B, C, A and the checkpoints read once; ddt, dx, dB, dC, dA,
    dh0 written once), one exp a state and step on the SFUs, and 20 float32
    operations a state and step; `exps_kernel` the exps this design takes
    (SCAN_BWD_SUB: 1.75 a state and step where L is a multiple of 32).
    With dt, x, B, C in bf16, the bf16 form: ddt, dx, dB, dC bit for bit
    the float32 form's on the widened inputs, rounded to bf16, and dA, dh0
    bit for bit (its errors against the plain version reported, not
    gated: a bf16 gradient lies a rounding step from a float32 sum); timed
    beside the float32 form in this call; the four and their gradients'
    bytes in bf16 in the bound."""
    from repro_torch.kernels import common
    from repro_torch.kernels.ssm_scan import ops as scan_ops
    from repro_torch.kernels.ssm_scan import ssm_scan_bwd_ref

    dt, x, Bc, Cc, A, h0 = ins
    B, L, D = dt.shape
    N = Bc.shape[2]
    bf16 = dt.dtype == torch.bfloat16
    name, other = ("ssm_scan_bwd_bf16", "ssm_scan_bwd") if bf16 else ("ssm_scan_bwd",
                                                                      "ssm_scan_bwd_bf16")
    names = ("ddt", "dx", "dB", "dC", "dA", "dh0")
    y0, h_0, _ = scan_ops._forward(*ins, checkpoints=False)
    y1, h_1, ckpt = scan_ops._forward(*ins, checkpoints=True)
    torch.cuda.synchronize()
    if not (bits_equal(y0, y1) and bits_equal(h_0, h_1)):
        fail(f"{name}: the forward's outputs change when it writes checkpoints, {B, L, D, N}")
    del y0, h_0, y1, h_1
    call = lambda: scan_ops.ssm_scan_bwd(*ins, ckpt, dy)  # noqa: E731
    before = common.launch_counts()
    got = call()
    again = call()
    torch.cuda.synchronize()
    if not launched_once(before, name, other, times=2):
        fail(f"{name}: a call did not count one launch")
    if not all(bits_equal(a, b) for a, b in zip(got, again)):
        fail(f"{name}: two runs differ at {B, L, D, N}")
    del again
    wide = [t.float() for t in ins[:4]] + ins[4:]
    if bf16:
        want = scan_ops.ssm_scan_bwd(*wide, ckpt, dy)
        for i, (a, c) in enumerate(zip(got, want)):
            if not bits_equal(a, c.to(torch.bfloat16) if i < 4 else c):
                fail(f"{name}: {names[i]} is not the float32 form's, rounded, at {B, L, D, N}")
        del want
    ref, plain_s = sync_time(lambda: ssm_scan_bwd_ref(*ins, dy))
    errs = {}
    for tag, a, b in zip(names, got, ref):
        a, b = a.float(), b.float()
        scale = max(float(b.abs().max()), 1e-30)
        errs[tag] = dict(max_abs_err=float((a - b).abs().max()), largest=scale)
        if not bf16 and (not bool(torch.isfinite(a).all())
                         or errs[tag]["max_abs_err"] > SCAN_BWD_REL_TOL * scale):
            fail(f"{name}: {tag} off its plain version at {B, L, D, N}: {errs}")
    del got, ref
    T = -(-L // scan_ops.TILE)
    elems = B * L * D * N

    def terms_of(in_bytes: int) -> tuple[dict, int]:
        nbytes = in_bytes * (4 * B * L * D + 4 * B * L * N) + 4 * (
            B * L * D + 2 * D * N + B * T * D * N + B * D * N)
        return dict(bytes=nbytes / HBM_BYTES_PER_S * 1e3, exp=elems / SFU_EXP_PER_S * 1e3,
                    fp32=20 * elems / FP32_FLOPS * 1e3), nbytes

    terms, nbytes = terms_of(dt.element_size())
    term = max(terms, key=terms.get)
    subs = lambda steps: -(-steps // SCAN_BWD_SUB)  # noqa: E731
    rerun = sum(SCAN_BWD_SUB * (subs(min(scan_ops.TILE, L - s0)) - 1)
                for s0 in range(0, L, scan_ops.TILE))
    exps_kernel = (L + rerun) / L * terms["exp"]
    rec = dict(max_abs_err=max(e["max_abs_err"] for e in errs.values()), errors=errs,
               ms=median_ms(call, 20),
               **device_ms(call, 20, 2, "ssm_scan_bwd", floor_ms=bound_floor(terms, nbytes)),
               kernels_per_call=2, plain_ms=plain_s * 1e3,
               bound_ms=terms[term], bound_by="bytes" if term == "bytes" else "operations",
               bound_term=term, bound_terms_ms=dict(terms, exps_kernel=exps_kernel),
               library_ms=None, bit_identical_reruns=True, checkpoints_leave_forward=True,
               shape=dict(B=B, L=L, D=D, N=N, tiles=T, channel_blocks=scan_ops.bwd_blocks(D)))
    if bf16:
        f32 = lambda: scan_ops.ssm_scan_bwd(*wide, ckpt, dy)  # noqa: E731
        rec.update(bits_equal_fp32_form_rounded=True, fp32_form_ms=median_ms(f32, 20),
                   **device_ms(f32, 20, 2, "ssm_scan_bwd", key="fp32_form_device",
                               floor_ms=bound_floor(*terms_of(4))))
    return rec


# -- phase bf16_knobs: the models' bf16 activation knobs -----------------------


def knob_config(cfg):
    """cfg with its bf16 knob on: attn_bf16_probs for an attention model,
    ssm_bf16_acts on the fused Mamba-1 path for falcon-mamba-7b (whose
    config already sets ssm_fused_chunks)."""
    import dataclasses

    if "m1" in cfg.pattern:
        return dataclasses.replace(cfg, ssm_fused_chunks=True, ssm_bf16_acts=True)
    return dataclasses.replace(cfg, attn_bf16_probs=True)


def with_knob(model, cfg_on):
    """An LM of `cfg_on` that holds `model`'s parameter tensors themselves
    (built on the meta device, the parameters assigned): the weights already
    on the card, served or trained with the knob."""
    from repro_torch.models.lm import LM

    params = dict(model.named_parameters())
    # assign=True hands each parameter the meta one's requires_grad: match the model's
    on = LM(cfg_on, device="meta").requires_grad_(next(iter(params.values())).requires_grad)
    on.load_state_dict(model.state_dict(keep_vars=True), assign=True)
    other = [n for n, p in on.named_parameters() if p is not params[n]]
    if other:
        fail(f"bf16_knobs: the knob's model does not hold the weights {other[:3]}")
    return on.train(model.training)


def knob_form_counts(counts: dict) -> dict:
    """The launches of a knob-off path with each float32 form's count moved
    to its bf16 form."""
    out = {k: 0 for k in counts}
    for k, v in counts.items():
        out[BF16_FORM_OF.get(k, k)] += v
    return out


def serve_with_knob(engine, corpus: np.ndarray, n_req: int, off: dict):
    """Phase bf16_knobs, serving: the engine's model with its bf16 knob on,
    the same weights (`with_knob`), serves the static run's request stream
    (`serve_once`: the knob's kernel form once a layer and embedded batch,
    the float32 form never); top-1 self-retrieval equal to the knob-off
    run's `off` (top-k printed beside it); the largest relative gap of one batch's embeddings
    against the knob-off engine's.  The kernel's bf16 arguments are checked
    at the launch (`_forward`'s inputs) and recorded.  Returns the launch
    counts and the recorded ((args), kw) of the wrapper's first call."""
    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.kernels.ssm_scan import ops as scan_ops
    from repro_torch.serve import RetrievalEngine

    cfg = engine.cfg
    kernel = KNOB_KERNEL[cfg.name]
    on = RetrievalEngine(knob_config(cfg), with_knob(engine.model, knob_config(cfg)),
                         m=SERVE_M, metric="angular", max_batch=SERVE_BATCH, device=engine.device)
    with plain_versions_refused():
        counts, got = serve_once(on, corpus, n_req, dynamic=False, kernel=kernel)
    if counts[kernel.replace("_bf16", "")] != 0:
        fail(f"bf16_knobs: {cfg.name} served with the knob launched the float32 form: {counts}")
    batch = corpus[:SERVE_BATCH]
    module, fn = (flash_ops, "flash_attention") if kernel == "flash_attn_bf16" \
        else (scan_ops, "ssm_scan")
    calls, launched = [], []
    with recording(module, fn, calls, keep=1), recording(module, "_forward", launched, keep=1):
        e_on = on.embed(batch)
    e_off = engine.embed(batch)
    (args, kw), (largs, lkw) = calls[0], launched[0]
    if kernel == "ssm_scan_bf16":
        dtypes = [str(t.dtype) for t in largs[:4]]
        if dtypes != ["torch.bfloat16"] * 4:
            fail(f"bf16_knobs: the scan's launch got dt, x, B, C as {dtypes}")
    elif not lkw.get("bf16_probs"):
        fail(f"bf16_knobs: the attention's launch did not take the bf16-P form: {lkw}")
    rel = float((e_on - e_off).abs().max() / e_off.abs().max())
    emit(phase="bf16_knobs", part="serve", arch=cfg.name, kernel=kernel,
         top1_self_retrieval=got["top1"], top1_knob_off=off["top1"],
         self_retrieval=got["self_retrieval"], self_retrieval_knob_off=off["self_retrieval"],
         embedding_max_rel_gap=rel, launches=counts)
    if got["top1"] != off["top1"]:
        fail(f"bf16_knobs: {cfg.name} top-1 self-retrieval with the knob {got['top1']} != "
             f"without {off['top1']}")
    del on
    return counts, (args, kw)


def train_with_knob(state, cfg, batch: dict, phase: str) -> dict:
    """Phase bf16_knobs, training: one step of `state` (train_full's, its
    masters and moments) with the model's bf16 knob on, the same weights
    (`with_knob`), on `batch`, beside the same state's loss with the knob off
    on that batch (the step's bf16 forward without the update).  Gates: the
    loss finite, and for gemma-2b within KNOB_LOSS_REL_TOL of the knob-off
    loss and not equal to it, for falcon-mamba-7b equal to it; the
    knob's forward and backward forms once a layer each, nothing else."""
    from repro_torch.kernels import common
    from repro_torch.train import make_train_step
    from repro_torch.train.step import TrainState, _Loss, cast_names

    cfg_on = knob_config(cfg)
    model = state.model
    cast = cast_names(cfg, model)
    with torch.no_grad():
        args = {f"model.{n}": p.to(torch.bfloat16) if n in cast else p
                for n, p in model.named_parameters()}
        loss_off = float(torch.func.functional_call(_Loss(model), args, (batch,))[0])
    del args
    step = make_train_step(cfg_on, lambda s: TRAIN["peak_lr"], clip_norm=TRAIN["clip"])
    want = lm_kernel_layers(cfg)[0]
    want.update(flash_attn_bwd=want["flash_attn"], ssm_scan_bwd=want["ssm_scan"])
    want = knob_form_counts(want)
    common.reset_launch_counts()
    with plain_versions_refused():
        (_, metrics), secs = sync_time(lambda: step(TrainState(with_knob(model, cfg_on),
                                                               state.opt), batch))
    counts = common.launch_counts()
    loss = float(metrics["loss"])
    rel = abs(loss - loss_off) / abs(loss_off)
    emit(phase="bf16_knobs", part="train", arch=cfg.name, layers=cfg.n_layers, after=phase,
         loss=loss, loss_knob_off=loss_off, loss_rel_gap=rel, tolerance=KNOB_LOSS_REL_TOL,
         grad_norm=float(metrics["grad_norm"]), step_ms=secs * 1e3, launches=counts)
    if counts != want:
        fail(f"bf16_knobs: {cfg.name}'s step with the knob launched {counts}, expected {want}")
    exact = "m1" in cfg.pattern  # the bf16 scan reads the bf16 compute's own values
    if not np.isfinite(loss) or (loss != loss_off if exact
                                 else not 0.0 < rel <= KNOB_LOSS_REL_TOL):
        fail(f"bf16_knobs: {cfg.name}'s loss with the knob {loss} vs {loss_off} without "
             f"({'equal' if exact else f'0 < relative gap <= {KNOB_LOSS_REL_TOL}'} expected)")
    return counts


def knob_gap_check(name: str, got, mirror, plain_on, plain_off, shape) -> dict:
    """A bf16-P output against its plain versions: the mean |got - mirror|
    (`mirror` the plain function of the kernel's own roundings) within
    KNOB_MIRROR_FACTOR of the knob's mean gap (mean |plain_on - plain_off|,
    the plain bf16-P function against the plain float32 one), the largest
    |got - plain_on| within KNOB_GAP_FACTOR of the knob's largest gap, and
    finite, or the run fails."""
    diff = (plain_on - plain_off).abs()
    gap, mean_gap = float(diff.max()), float(diff.mean())
    err = float((got - plain_on).abs().max())
    mean_err = float((got - mirror).abs().mean())
    rec = dict(max_abs_err=err, knob_gap=gap, mean_abs_err_vs_mirror=mean_err,
               knob_mean_gap=mean_gap, mean_share=mean_err / max(mean_gap, 1e-30))
    if (not bool(torch.isfinite(got).all()) or err > KNOB_GAP_FACTOR * gap
            or mean_err > KNOB_MIRROR_FACTOR * mean_gap):
        fail(f"bf16_knobs: {name} off its plain versions at {shape}: {rec}, limits "
             f"{KNOB_MIRROR_FACTOR} x the mean gap, {KNOB_GAP_FACTOR} x the largest")
    return rec


def knob_refusals(dev) -> None:
    """A bf16 scan with a bf16 A, or with x left float32 among the bf16
    four, raises on the card before any launch."""
    from repro_torch.kernels import common
    from repro_torch.kernels.ssm_scan import ssm_scan

    bf = lambda *shape: torch.randn(shape, device=dev).to(torch.bfloat16)  # noqa: E731
    ok = [bf(2, 40, 64), bf(2, 40, 64), bf(2, 40, 16), bf(2, 40, 16),
          -torch.rand((64, 16), device=dev), torch.zeros((2, 64, 16), device=dev)]
    before = common.launch_counts()
    for tag, i, dtype in (("A bf16", 4, torch.bfloat16), ("x float32", 1, torch.float32)):
        args = list(ok)
        args[i] = args[i].to(dtype)
        try:
            ssm_scan(*args)
        except TypeError:
            continue
        fail(f"bf16_knobs: the scan took a mixed set ({tag}) on the card")
    if common.launch_counts() != before:
        fail("bf16_knobs: a refused scan launched a kernel")


def knob_kernels_vs_plain(serve: dict, launches: dict) -> list:
    """Phase bf16_knobs, the kernels: the four bf16 forms against their plain
    versions at the main paths' shapes -- ssm_scan's at falcon-mamba-7b's
    serving batch (recorded from the knob's serving run) and training
    shape, ssm_scan_bwd's at the training shape, flash_attn's at gemma-2b's
    serving batch (recorded) and, under `prefill`, qwen2-7b's prefill,
    gemma3-1b's window 512 and zamba2-7b's dh 112, flash_attn_bwd's at
    gemma-2b's training shape -- each timed beside its float32 form, and
    the refusals.  Returns the four kernel records."""
    t0 = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator(device=dev)
    g.manual_seed(0)

    def randn(*shape, s=1.0):
        return s * torch.randn(shape, generator=g, device=dev)

    knob_refusals(dev)
    (q, k, v), kw = serve["recorded"]["flash_attn_bf16"]
    serving = flash_record(q, k, v, kw, bf16_probs=True)
    prefill = {}
    causal = dict(causal=True, window=0, softcap=0.0)
    for tag, (B, S, Hq, Hkv, dh), mask in (
            ("qwen2-7b prefill, B 4, S 640, Hq 28 / Hkv 4, dh 128", (4, 640, 28, 4, 128), causal),
            ("gemma3-1b local, B 4, S 640, Hq 4 / Hkv 1, dh 256, window 512",
             (4, 640, 4, 1, 256), dict(causal=True, window=512, softcap=0.0)),
            ("zamba2-7b shared, B 4, S 640, Hq 32 / Hkv 32, dh 112", (4, 640, 32, 32, 112),
             causal)):
        prefill[tag] = flash_record(randn(B, S, Hq, dh), randn(B, S, Hkv, dh),
                                    randn(B, S, Hkv, dh), mask, bf16_probs=True)
        torch.cuda.empty_cache()
    lib_note = ("none: scaled_dot_product_attention on bf16 inputs rounds q, k and the "
                "softmax's scores too and returns bf16; this function rounds only P and V "
                "in the P V product")
    recs = [dict(name="flash_attn_bf16", route="cuda",
                 source="src/repro_torch/kernels/csrc/flash_attn.cu",
                 replaces="none on the TPU: the reference's src/repro/models/attention.py:124 "
                          "jnp path (chunked_attention, bf16_probs)",
                 launches=launches["flash_attn_bf16"], **serving, library_call=lib_note,
                 prefill=prefill)]
    B, S = 8, 64
    recs.append(dict(name="flash_attn_bwd_bf16", route="cuda",
                     source="src/repro_torch/kernels/csrc/flash_attn_bwd.cu",
                     replaces="none on the TPU: jax.value_and_grad of the reference's "
                              "src/repro/models/attention.py:124 jnp path",
                     launches=launches["flash_attn_bwd_bf16"],
                     **flash_bwd_record(randn(B, S, 8, 256), randn(B, S, 1, 256),
                                        randn(B, S, 1, 256), randn(B, S, 8, 256), causal,
                                        bf16_probs=True),
                     library_call=lib_note))
    (args, _) = serve["recorded"]["ssm_scan_bf16"]
    D, N = 8192, 16
    bf = lambda t: t.to(torch.bfloat16)  # noqa: E731
    train_ins = [bf(torch.nn.functional.softplus(randn(8, 64, D))), bf(randn(8, 64, D)),
                 bf(randn(8, 64, N)), bf(randn(8, 64, N)), -torch.exp(randn(D, N, s=0.5)),
                 randn(8, D, N)]
    scan_rec = scan_record(*[t.clone() for t in args])  # not the embed's inference tensors
    scan_rec["train"] = {"training, B 8, L 64": scan_record(*train_ins)}
    recs.append(dict(name="ssm_scan_bf16", route="cuda",
                     source="src/repro_torch/kernels/csrc/ssm_scan.cu",
                     replaces="none on the TPU: the reference's src/repro/models/ssm.py:172 jnp "
                              "path (_mamba1_fused, bf16_acts)",
                     launches=launches["ssm_scan_bf16"], **scan_rec))
    recs.append(dict(name="ssm_scan_bwd_bf16", route="cuda",
                     source="src/repro_torch/kernels/csrc/ssm_scan_bwd.cu",
                     replaces="none on the TPU: jax.value_and_grad of the reference's "
                              "src/repro/models/ssm.py:172 jnp path",
                     launches=launches["ssm_scan_bwd_bf16"],
                     **scan_bwd_record(train_ins, randn(8, 64, D))))
    emit(phase="bf16_knobs", part="kernels_vs_plain",
         kernels=[r["name"] for r in recs],
         tolerance=dict(ssm_scan_bf16="bit for bit the float32 form on the widened inputs",
                        ssm_scan_bwd_bf16="bit for bit the float32 form's gradients, rounded",
                        flash_attn_bf16=KNOB_GATE, flash_attn_bwd_bf16=KNOB_GATE),
         ok=True, seconds=time.perf_counter() - t0)
    return recs


if __name__ == "__main__":
    main()

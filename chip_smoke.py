#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--docs N] [--vertices V] [--seed S]

Runs on one CUDA card, from the root of a checkout:

  1. builds the kernel libraries from ``src/repro_torch/kernels/csrc``;
  2. holds every kernel against its plain PyTorch version on the card
     (edge cases, then the main paths' shapes, with kernel, plain and
     library times and the least time the card could take; the fused
     merge on both of its routes at the one-block path's shapes,
     ``ONE_BLOCK_SHAPES``);
  3. drives the one-step path — wordcount's ``Session.run`` then two
     ``update``s, on the MRBG path and on ``auto`` (the accumulator) — at
     vocab 2^18, 64 words a document, 2^20 documents, and checks every
     step against ``np.bincount`` of the updated corpus exactly;
  4. drives the iterative path — PageRank's and SSSP's ``Session.run``
     (prime-loop convergence) then one ``update`` (incremental iterative
     refresh) — on graphs of 2^22 vertices (PageRank's cut to 2^20,
     ``PR_VERTICES``) with 16 out-slots, checking
     PageRank against a float64 power iteration (on the card) within
     bounds derived from ``tol`` and the CPC threshold, and SSSP against
     ``scipy.sparse.csgraph.dijkstra`` (in two processes of their own,
     beside phase 5, checked after it).

  5. drives the LM serving path — Gemma 2 9B at full width (9,241,705,984
     parameters, bf16, random weights from ``--seed``): ``make_prefill_step``
     on 2 requests of 8192 tokens (every attention layer through the flash
     kernel: 42 launches a prefill), then 4 requests decoded through
     ``make_serve_step`` (a 16-token prompt fed one token at a time, then
     24 greedy tokens); one more prefill and 4 more decode steps run under
     ``torch.profiler`` for the device time of the flash kernel, the
     matrix products and the rest, and the device's idle share; then the
     decode-versus-prefill parity of the two paths over 64 tokens, in
     float32 at full width and 4 layers and in bf16 at full depth.
  6. drives the streaming path — ``repro_torch.stream.StreamSession`` on
     phase 3's corpus: (a) the accumulator path through the background
     worker, 16 epochs of 1,024 rewritten documents, its first batch
     building the kernels (marked retraced); (b) the MRBG path step by
     step with an adversarial burst; (c) one batch past the crossover (a
     rerun); (d) snapshots of (a) and (b) restored into fresh sessions,
     bitwise equal to the uninterrupted ones; (e) a PageRank stream on
     2^20 vertices (cut from 2^22) within ``pagerank_bound``; (f) the
     coalescer's device part at 64, 4,096 and 2^20 rows, exactly equal to
     its plain route, timed.  Phase 2 holds the sort and the int32
     segment sum at the coalescer's sizes.
  7. drives the serving tier — ``repro_torch.serve.ServeTier`` over
     wordcount tenants on the MRBG path: (a) ``benchmarks/serve_load.py``'s
     largest throughput cell, 1,000 tenants (vocab 64, 8 documents of 4
     words), 128 a batched launch, 2 warm and 3 timed rounds, batched and
     sequential, plus one profiled sweep; (b) 32 wide tenants of 2^20
     edges each (vocab 2^15, 2^14 documents of 64 words), 3 rounds of 16
     documents a tenant, batched and sequential; (c) one latency tenant
     and 32 best-effort ones open loop at twice the measured capacity for
     15 s; (d) (b)'s fleet under half its store bytes (compaction, then
     spill to the git-ignored ``build/``, then reload); (e)
     ``MultiSessionServer`` (the deprecated shim) is (a)'s sequential leg.
     Every tenant equals ``np.bincount`` of its mirror after every round,
     and batched equals sequential bitwise, tenant by tenant; (a) logs its
     fused merges' one-block launches by (N, key_cap).
  8. drives delta queries — ``repro_torch.dql``: (a) ``wordcount_query``
     on phase 3's corpus and updates, bitwise equal to ``np.bincount``
     and to phase 3's ``apps.wordcount`` Session; (b) ``join_query`` at
     2^22 users, exactly ``join_oracle``; (c) ``windowed_query`` on 2^22
     events, 2^12 keys, 32 windows, within 1e-5 of each window's sum of
     |terms|; (d) ``group_by(agg="min")`` and ``"max"``, exactly; each
     run, updated, then rerun.
  9. drives distributed execution — ``RunConfig(mesh=MeshConfig(
     LocalMesh({"data": 8})))``, 8 logical shards of the card: (a)
     wordcount on phase 3's corpus (``_DistOneStep``), run and phase 3's
     updates, bitwise equal to ``np.bincount`` and to phase 3's MRBG
     session; (b) SSSP on phase 4's graph, run and phase 4's deletion
     update, bitwise equal to phase 4 and within 1e-5 of Dijkstra; (c)
     PageRank on 2^20 vertices (cut from 2^22), run and a 0.1% rewire at
     CPC 1e-3, within ``pagerank_bound``; (d) a (pod 2, data 4) mesh on
     (a)'s run and update (a), bitwise equal to (a); (e) (c)'s rewire
     through ``refresh="warm"`` and past ``pdelta_threshold`` (both
     ``distributed-warm``), within the bound.  Each of (a)-(c) logs its
     seconds beside phases 3-4's, the exchange apart from the rest,
     edges and bytes exchanged, the shuffle capacity and regrows, and one
     profiled no-op refresh of the update's size (device busy, idle).
 10. drives LM training — ``repro_torch.launch.steps.make_train_step`` and
     ``launch.train.train``: (a) the attention gradient
     (``blocks.FlashAttend``: flash forward, the dense formula's autograd
     backward) on the card against the CPU in float32, Gemma 2's softcap
     50 at hd 256 (global and a window) and Qwen3's hd 128, S 512, one
     flash launch a forward; (b) 3 train steps of Qwen3 and Gemma 2 smoke
     configs (float32, remat full, chunked loss) on the card against the
     CPU; (c) Qwen3-1.7B at full width (1,720,574,976 parameters, bf16,
     AdamW moments in float32, remat full, loss_chunk 512), B 2 x S 4096:
     1 warm-up and 4 timed steps (ms a step, tokens/s, peak memory, every
     loss finite, 56 flash launches a step: forward and recompute), one
     more step under ``torch.profiler`` (device ms of flash, the attention
     backward's recompute, the other matrix products and the rest; idle
     share), the model FLOPs' bound at the bf16 peak; (d) ``train(...,
     fail_at=3)`` at ``--preset 100m`` then resumed: the resumed losses
     equal an uninterrupted run's bit for bit.
 11. drives the other attention-only archs at full width, bf16, one model
     on the card at a time, weights from ``parity_model``: (a) Mistral
     NeMo 12B and (b) StableLM 12B (hd 160: flash on the wgmma kernel's
     32-column boxes), two prefills of 2 x 8192 tokens and the decode-versus-
     prefill parity over 2 x 64 tokens (64 timed decode steps) within
     ``parity_bound``; (c) Chameleon 34B (qk-norm, 68.6 GB of weights),
     1 x 4096 and 1 x 16; (d) HuBERT X-Large (hd 80, not causal, frame
     embeddings in): the forward over 2 x 4096 frames in bf16 against
     float32 within ``parity_bound(48)``, the same run causal past that
     bound, 3 train steps through ``launch.train.train`` and its frontend
     stub (losses finite), and its smoke config at hd 80: loss and every
     gradient on the card against the CPU.  Phase 2 also holds flash at
     hd 80 and 160 and times HuBERT's and StableLM's layers beside SDPA.
 12. drives the recurrent archs at full width, bf16, weights from
     ``parity_model``: RecurrentGemma 2B (RG-LRU, local MQA attention at
     hd 256: 8 flash launches a prefill) two prefills of 2 x 8192 tokens,
     xLSTM 125M (mLSTM and sLSTM stepped a token at a time) two of 2 x
     2048, each then phase 5's decode; one more prefill and decode step
     profiled for the kernels each launches; the decode-versus-prefill
     parity in bf16 at full depth within ``parity_bound`` and in float32
     at one cycle plus the remainder within ``REC_F32_BOUND``.  Phase 2
     holds flash at RecurrentGemma's layer (H 10, KH 1, window 2048) and
     times it beside SDPA.
 13. drives the MoE archs at full width, bf16, weights from
     ``parity_model``, each cut in depth only: Llama 4 Scout at 12 of 48
     layers (GQA, 16 experts top 1 and a shared one, all kept; 12 flash
     launches a prefill) two prefills of 2 x 8192 tokens, DeepSeek-V3 at
     5 of 61 (its 3 mla_dense layers and 2 attn_moe, MLA through the flash
     kernel at q.k head dim 192 and v 128, 256 experts top 8 and a shared
     one; 5 launches a prefill) two of 2 x 4096, each then phase 5's
     decode (MLA absorbed over its latent cache; no flash launch) beside
     the least time to read its weights; one more prefill and decode step
     profiled, and the share of (token, k) slots that prefill's capacity
     dropped; the decode-versus-prefill parity in bf16 over 4 x 32 tokens
     within ``parity_bound`` before each request's first routing flip (the
     flips by layer printed, from ``RoutingProbe``), and in float32 at 2
     layers over 2 x 16 within 2e-4.  Phase 2 holds flash at MLA's layer
     (H = KH 128, q.k 192, v 128) and Llama 4's (H 40, KH 8) and times
     them beside SDPA.

 14. runs the dry-run (``repro_torch.launch.dryrun --all``, started in
     the background before phase 3 in two processes at nice 19, waited for
     here): every (arch x shape) cell's step once on ``meta`` tensors under
     ``FlopCounterMode`` and a byte and live-memory count, then prints
     ``launch.roofline --md``'s table against one H100's constants
     (modeled, not measured); then (b) three cells the card runs (phase 10
     (c)'s Qwen3-1.7B train step, phase 5's Gemma 2 9B prefill and decode
     step), each dry-run on ``meta`` and run on the card: the FLOPs equal,
     ``argument_size`` within 0.5% of the device bytes the arguments hold,
     the predicted peak beside ``max_memory_allocated``, the measured
     seconds beside the roofline's, and the measured share of the bound.

 15. runs one process a rank (``RankMesh``, ``launch.ranks.run_ranks``):
     (a) one rank on nccl, wordcount's run and update (a) on phase 3's
     corpus, bitwise equal to phase 3's MRBG session; (b) 4 ranks sharing
     the card on gloo (each rank's kernels on the card, the exchange
     staged through host memory): wordcount (phase 3's corpus, update
     (a)), SSSP (phase 4's graph and update) bitwise, and PageRank on
     2^20 vertices, its run within 1e-5 with equal ``ShuffleStats`` and
     its refresh (64 vertices rewired) in mode distributed-i2, with
     LocalMesh's iterations, within ``RANK_PR_REFRESH_TOL``, against
     ``LocalMesh({"data": 4})`` on the card;
     each rank's seconds, exchange seconds and peak memory; (c) Llama 4
     Scout's MoE layer at full width (d 5120, 16 experts top 1,
     d_ff_expert 8192, shared 8192) on 4 ranks of 4 experts each through
     ``moe_impl="a2a"`` against the single-process ``gather`` layer:
     bf16 over 2 x 2048 tokens within ``MOE_RANK_BF16_REL`` of the
     output's max, float32 over 2 x 256 within ``MOE_F32_BOUND``, expert
     ids and kept slots equal at capacity 16, and the dropped slots of
     each at the config's 1.25; (d) ``compressed_psum`` on 4 ranks bitwise
     equal to the stacked form; (e) Gemma 2 9B at full width served
     tensor-parallel on the 4 ranks (``{"model": 4}``, ``models.shard``)
     against its replicated run on the card, bf16 and float32 at 4
     layers; (f) likewise DeepSeek-V3 at 4 layers (MLA, the MoE, MTP
     held), Llama 4 Scout at 2, RecurrentGemma 2B (RG-LRU) and xLSTM 125M
     (mLSTM, sLSTM) at one cycle (``TP4_RUNS``), the MoE archs' prefill
     held at every position that no routing flip against the replicated
     run reaches, their decode up to its first flip; (g) Qwen3-1.7B at
     full width cut to 2 layers trained on the 4 ranks as {"data": 2,
     "model": 2} (``make_train_step(mesh=)``: the vocab-parallel loss, the
     backward through every collective, the gradients summed over
     "data", AdamW on each rank's shards), 2 steps of 2 x 1024 tokens in
     bf16, against the replicated run of the same draw and batches: each
     step's loss and grad norm and every parameter shard after the steps
     within ``train_tp_bounds``, the same at smoke width in float32 within
     2e-4, each rank's parameter and moment bytes equal to ``meta``'s; a
     rank's step seconds, its seconds and calls inside the gloo
     collectives in the forward, the backward, the gradients' reduction
     and AdamW, its peak memory and flash launches.
 16. trains the MoE and recurrent archs: (a) the attention gradient
     (flash forward, the dense formula's backward) on the card against
     the CPU in float32 at MLA's pairs of head dims, (q.k 96, v 64) on
     DeepSeek-V3 --preset 100m's 12 heads and (192, 128) on 2; (b) 3 train
     steps of DeepSeek-V3 and Llama 4 Scout at --preset 100m cut to 4
     layers (MTP on) and of RecurrentGemma's and xLSTM's smoke configs
     (the mLSTM loop in checkpointed chunks of 16 of S 64), float32,
     remat full, on the card against the CPU within phase 10's bounds
     (but the parameter elements whose Adam step's sign rounding decides,
     held to two steps of lr: ``STEP_ZERO_LEAF``'s note), the MoE layers'
     routing flips between the two printed step by step;
     (c) full width, bf16, AdamW moments float32, remat full, loss_chunk
     512, 1 warm-up and 2 timed steps: Llama 4 Scout at 1 of 48 layers
     (4.27e9 parameters; B 2 x S 4096 where the dry-run on ``meta``
     predicts a peak under 76 GB, AdamW's update of the largest leaves in
     slices), RecurrentGemma 2B B 2 x S 4096, xLSTM 125M B 2 x S 128 (and
     one step with the mLSTM loop whole, for its peak): ms a step,
     tokens/s, peak memory, losses, flash launches, the 6 N_active T
     bound; (d) ``launch.train.train`` of DeepSeek-V3 at --preset 100m
     (flash at (96, 64) in bf16) failed at step 3 and resumed, bitwise.
     DeepSeek-V3 at full width does not fit one card (a ``CUT`` line).
     Phase 2 holds flash at (96, 64) in both dtypes and times
     ``FLASH_MLA_100M`` beside SDPA.

Phases 1-16 print their seconds.  The kernels' launch counts are set to
0 before each path and read after it (phase 15: in each rank, around
each of its jobs).  ``--docs`` may cut the corpus to 2^18 and ``--vertices`` the graphs
to 2^20; each cut is logged as a ``CUT`` line.

Prints the card's name and power limit, then one JSON line of per-kernel
numbers, then, as the last line, ``{"ok": true, "device": {...}}``.  Any
failure raises and exits non-zero without that line.  It imports neither
JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import atexit
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

VOCAB = 2**18            # wordcount shapes: never cut
DOC_LEN = 64
FULL_DOCS = 2**20        # the scale; may be cut only as far as 2^18
MIN_DOCS = 2**18
INT32_MAX = 2**31 - 1
# iterative shapes: graphs of 2^22 vertices (the scale; may be cut only as
# far as 2^20), 16 out-slots, each present with probability 0.5.  The
# engine's Map keys are mk = rid * 16 + slot in int32: SSSP's (2^22 + 1)
# structure rows (the virtual root is row 0) give mk < 2^26 + 32, far
# inside int32.
FULL_VERTICES = 2**22
MIN_VERTICES = 2**20
# phase 4's PageRank, cut to the floor to keep a slow host inside the run's
# time limit: its refresh of 0.1% of the vertices is host work in the MRBG
# store (101.0 s at 2^22 beside an NVIDIA H100 80GB HBM3 at 700 W); SSSP
# keeps --vertices
PR_VERTICES = 2**20
OUT_SLOTS = 16
P_EDGE = 0.5
# PageRank's CPC threshold on the refresh: low enough that the refreshed
# ranks land far closer to the new fixpoint than the run's ranks do (about
# 1/40 of that distance, against about 1/7 at a threshold of 0.01)
PR_CPC = 1e-3
# (N, K, D) of the segment_minmax launch SSSP's refresh makes most often
# (phase 4's launch log: 4 of its 9 launches, NVIDIA H100 80GB HBM3)
SSSP_REFRESH_MINMAX = (2**17, 16384, 1)
# (N, key_cap) of the one-block fused launches of PageRank's refresh
# (phase 4's launch log: 3 of its 5 fused launches; this is the largest)
PR_REFRESH_ONE_BLOCK = (4096, 256)
# The fused merge's one-block shapes, timed on both routes: (label, N,
# key_cap, affected keys, the keys' universe (None: the graph's
# vertices), rows a key, rewrites, tombstones, inserts, mk's range (None:
# 2^26)) as merge_rows takes them.  The serving tier's launches as phase 7
# (a) logs them: sequential, (64, 64) for every tenant (vocab 64, one
# update of one 4-word document: ~8 affected keys, 4 tombstones and 4
# inserts; mk = rid * 4 + slot); batched, (2,048, 1,024) (128 tenants'
# keys side by side: 1,927-1,988 combined rows, 952-985 affected keys).
# PageRank's refresh at PR_REFRESH_ONE_BLOCK, and 8,192 and 16,384 rows
# (PageRank's refresh launches at (8,192, 1,024) and (16,384, 1,024)),
# where the route (fused.SMALL_MAX_ROWS) is set by these times.
ONE_BLOCK_SHAPES = (
    ("tenant", 64, 64, 8, 64, 1, 0, 4, 4, 64),
    ("batched tenants", 2048, 1024, 970, 8192, 1, 0, 490, 490, 64),
    ("PageRank's refresh", 4096, 256, 256, None, 8, 1024, 128, 128, None),
    ("8,192 rows", 8192, 512, 512, None, 8, 2048, 256, 256, None),
    ("16,384 rows", 16384, 1024, 1024, None, 8, 4096, 512, 512, None),
)
# the same shapes on the one-block design before this one (a bitonic
# network in a block of 1,024 threads, atomics into acc and counts zeroed
# by two memsets; route "sort + runs" above 4,096 rows): events ms and
# device us a call of tools/scatter_probes.py --one-block on that package
# and these rows, NVIDIA H100 80GB HBM3, 700.00 W (PERF.md section 6)
ONE_BLOCK_BEFORE = {
    "tenant": "events 0.0908-0.1026 ms, device 10.29-10.33 us, 3 kernels",
    "batched tenants": "events 0.0638-0.0940 ms, device 48.72-49.04 us, "
                       "3 kernels",
    "PageRank's refresh": "events 0.1002-0.1252 ms, device 93.74-94.03 us, "
                          "3 kernels",
    "8,192 rows": "sort + runs: events 0.1213-0.2651 ms, device "
                  "92.68-92.87 us, 21 kernels",
    "16,384 rows": "sort + runs: events 0.1957-0.1960 ms, device "
                   "93.53-93.56 us, 21 kernels",
}
# flash attention, held elementwise: |kernel - plain| <= rel * (|plain| + A)
# with A = sum_j p_j |v_j| (the plain version on |v|), the size every
# rounding of an output is proportional to.  bf16, rel 2^-7: the kernel
# rounds P to bf16 before P.V, which moves each term p_j v_j by at most
# 2^-8 of itself (at most 2^-8 A in all), and the two outputs are rounded
# to bf16 apart (at most 2^-8 |o| each; one step of bf16 is at most
# 2^-7 |o|).  float32, rel 2e-5 times the scores' scale: 2e-5 is the bound
# of the reference's own kernel test (tests/test_kernels.py) at scores of
# unit scale, and float32 rounds each score relative to its size.
FLASH_REL = {"float32": 2e-5, "bfloat16": 2**-7}
# q drawn at std 1 and at std 20 (k and v at 1): scores of std 20 reach
# the softcaps (30, 50), the softmax rests on a few keys, |o| is about 1,
# and dropping the window or the softcap moves most outputs far past the
# bound (the main shape checks that it does)
FLASH_Q_SCALES = (1.0, 20.0)
# the main path's shape: one Gemma 2 9B attention layer of a prefill of
# 2 requests x 8192 tokens
FLASH_MAIN = (2, 16, 8, 8192, 256)           # B, H, KH, S, hd
# Qwen3-1.7B's attention (hd 128, H 16, KH 8, no softcap, global) at the
# same prefill: the other head dim the serving path takes
FLASH_QWEN = (2, 16, 8, 8192, 128)
# the head dims whose bf16 wgmma tiles are narrower TMA boxes (16 and 32
# columns in the 32- and 64-byte swizzles), and their layers: HuBERT
# X-Large at train_4k's sequence (not causal, KH = H) and StableLM 12B at
# phase 11's prefill (causal, GQA); no softcap, no window
FLASH_NEW_HDS = (80, 160)
FLASH_HUBERT = (2, 16, 16, 4096, 80)         # B, H, KH, S, hd
FLASH_STABLELM = (2, 32, 8, 8192, 160)
# the wgmma kernel at phase 11's other layers (hd 128, H / KH = 4 and 8):
# Mistral NeMo 12B at its prefill and Chameleon 34B at its
FLASH_MISTRAL = (2, 32, 8, 8192, 128)
FLASH_CHAMELEON = (1, 64, 8, 4096, 128)
# RecurrentGemma 2B's attn_local layer at phase 12's prefill: MQA (KH 1,
# H / KH = 10), hd 256, causal, window 2048, no softcap; held at q std 1
# and 20, timed beside its plain version and SDPA with the window as a
# boolean mask (the one PyTorch call that computes the same function).
# Bound: 4 B H hd (sum of keys in the window) = 3.01e11 FLOP at 989
# TFLOP/s, 0.304 ms; bytes give 0.055 ms
FLASH_RECURRENTGEMMA = (2, 10, 1, 8192, 256)     # B, H, KH, S, hd
FLASH_RECURRENTGEMMA_WINDOW = 2048
# phase 13's layers, causal, no softcap, held at q std 1 and 20 and timed
# beside their plain version and SDPA: DeepSeek-V3's MLA at its prefill
# (H = KH 128, q.k head dim 192 = 128 + 64 rope columns, v head dim 128;
# bound 2 B H S(S+1)/2 (192 + 128) = 1.375e12 FLOP at 989 TFLOP/s, 1.390
# ms, bytes 0.40 ms) and Llama 4 Scout's (H 40, KH 8: H / KH 5, hd 128;
# 4 B H hd S(S+1)/2, 1.390 ms)
FLASH_MLA = (2, 128, 128, 4096, 192, 128)        # B, H, KH, S, hd, vd
FLASH_LLAMA4 = (2, 40, 8, 8192, 128, 128)
# phase 16 (d)'s layer: DeepSeek-V3 at --preset 100m (H = KH 12, q.k 64 +
# 32 rope columns, v 64), B 8 x S 1024; bound by bytes: 63 MB of q, k, v
# and o, 0.019 ms at 3.35 TB/s (operations 1.6e10 FLOP, 0.016 ms)
FLASH_MLA_100M = (8, 12, 12, 1024, 96, 64)
# label, shape, causal: the layers timed after the main shape
FLASH_LAYERS = (("hd128", FLASH_QWEN, True), ("hd80", FLASH_HUBERT, False),
                ("hd160", FLASH_STABLELM, True),
                ("hd128_mistral", FLASH_MISTRAL, True),
                ("hd128_chameleon", FLASH_CHAMELEON, True))
# LM serving: Gemma 2 9B at full width (arXiv:2408.00118), bf16; prefill
# of 2 requests at its context length, decode as examples/serve_lm.py
LM_ARCH = "gemma2_9b"
LM_PARAMS = 9_241_705_984
PREFILL_BATCH, PREFILL_LEN, PREFILL_CALLS = 2, 8192, 2
DECODE_BATCH, PROMPT_LEN, GEN_LEN = 4, 16, 24
# one more prefill call and this many more decode steps run under
# torch.profiler, for the device time by kind of kernel and the idle share
PROFILE_STEPS = 4
# decode-versus-prefill parity over 64 tokens.  float32 (TF32 off): the
# reference's own bound (tests/test_models.py), at 4 layers.  bf16 at full
# depth: each layer rounds the two paths' activations to 8 bits at
# different places (flash P in bf16 against softmax probabilities in bf16,
# another matmul shape); about 4 such roundings a layer add up like a
# random walk to sqrt(42 * 4) * 2^-8 = 0.05 of the logit scale, and the
# bound allows twice that.  A wrong cache slot or mask moves the logits by
# their whole scale.
PARITY_BATCH, PARITY_LEN, PARITY_F32_LAYERS = 2, 64, 4
PARITY_TOL = {"float32": 2e-4, "bfloat16": 0.1}
# phase 5's prefill seconds and median decode ms, which phase 15 (e) logs
# beside its own
LM_TIMES = {}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean milliseconds of ``fn`` on the card (CUDA events, one warm-up)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: int, ops: float, tensor_cores: bool = False) -> dict:
    """The least time for the work: the larger of bytes (each input read
    once, each output written once) over the memory rate and operations
    over the peak rate for their type (float32 outside the tensor cores
    for the kernels' adds and key compares, bf16 on them for attention's
    two matrix products; ``repro_torch.launch.mesh``), and which of the
    two it is."""
    from repro_torch.launch.mesh import HBM_BW, PEAK_F32_FLOPS, PEAK_FLOPS
    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = ops / (PEAK_FLOPS if tensor_cores else PEAK_F32_FLOPS) * 1e3
    if t_bytes >= t_ops:
        return {"bound_ms": t_bytes, "bound_by": "bytes"}
    return {"bound_ms": t_ops, "bound_by": "operations"}


def ptxas_summary(text: str) -> list:
    """``kernel<hd>: N registers, M bytes spilled`` for every kernel in
    nvcc's -Xptxas -v report (mangled names read by their length
    prefix)."""
    out, name, spill = [], None, "?"
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled, name = m.group(1), m.group(1)
            for d in re.finditer(r"\d+(?=[A-Za-z_])", mangled):
                for i in range(d.start(), d.end()):   # any suffix of digits
                    ident = mangled[d.end():d.end() + int(mangled[i:d.end()])]
                    if re.fullmatch(r"[A-Za-z_]\w*_kernel", ident):
                        rest = mangled[d.end() + len(ident):]
                        arg = re.match(r"I((?:Li\d+E)+)(?:Lb([01])E)?", rest)
                        typed = re.match(r"I([fi])(?:Lb([01])E)?E", rest)
                        if arg:
                            args = re.findall(r"Li(\d+)E", arg.group(1))
                            if arg.group(2) is not None:
                                args.append(("false", "true")[
                                    int(arg.group(2))])
                            name = ident + f"<{', '.join(args)}>"
                        else:
                            name = ident
                        if typed:
                            t = {"f": "float", "i": "int"}[typed.group(1)]
                            name = ident + (
                                f"<{t}>" if typed.group(2) is None else
                                f"<{t}, "
                                f"{('false', 'true')[int(typed.group(2))]}>")
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, {spill} bytes "
                       f"spilled")
            name, spill = None, "?"
    return out


def max_abs_err(got, want) -> float:
    import torch
    if got.numel() == 0:
        return 0.0
    return float((got.to(torch.float64) - want.to(torch.float64)).abs().max())


def require_equal(name, got, want) -> None:
    import torch
    if got.shape != want.shape or got.dtype != want.dtype \
            or not torch.equal(got, want):
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version "
            f"(shape {tuple(got.shape)} vs {tuple(want.shape)}, "
            f"max abs err {max_abs_err(got, want) if got.shape == want.shape else 'n/a'})")


# ---------------------------------------------------------------------------
# phase 2: every kernel against its plain version
# ---------------------------------------------------------------------------

def check_sort(dev, rng) -> None:
    """The sort against its plain version, bit for bit on all three outputs:
    sizes around the kernel's tile and of many tiles, heavy duplicates
    (also 2^24 rows in one bucket: the look-back with every tile feeding
    one digit), INT32_MAX and negative keys, descending keys, and keys
    that differ only in the top or only in the lowest digit (every other
    digit constant, so the kernel skips those passes)."""
    import torch
    from repro_torch.kernels.ref import sort_lex_ref
    from repro_torch.kernels.sort_u32 import TILE_ROWS, sort_lex
    cases = []
    for n in sorted({1, 5, 4095, 4096, 4097, TILE_ROWS - 1, TILE_ROWS,
                     TILE_ROWS + 1, 2 * TILE_ROWS - 1, 2 * TILE_ROWS + 1,
                     37 * TILE_ROWS + 5, 2**20 + 3}):
        cases.append((f"n={n}", rng.integers(0, max(n // 2, 2), n),
                      rng.integers(0, 7, n)))
    n = 100_003
    cases.append(("heavy duplicates", rng.integers(0, 2, n), np.zeros(n)))
    big = 2**24
    cases.append((f"{big} equal rows (one bucket)", np.full(big, 7),
                  np.full(big, -3)))
    lo = np.full(big, 5)
    lo[::2**20] = 6
    cases.append((f"{big} rows, all but 16 in one bucket", np.full(big, -9),
                  lo))
    hi = rng.integers(0, 50, n)
    hi[rng.random(n) < 0.3] = INT32_MAX
    lo = rng.integers(0, 50, n)
    lo[rng.random(n) < 0.3] = INT32_MAX
    cases.append(("INT32_MAX keys", hi, lo))
    cases.append(("negative keys", rng.integers(-2**31, 2**31, n),
                  rng.integers(-2**31, 2**31, n)))
    cases.append(("descending keys", np.arange(n, 0, -1) * 977,
                  -np.arange(n)))
    top = rng.integers(0, 256, n) << 24
    cases.append(("only the top digit differs", (top | 0x5A5A5A) - 2**31,
                  np.full(n, 12345)))
    cases.append(("only the lowest digit differs", np.full(n, -77),
                  (rng.integers(0, 256, n) | 0x3C3C3C00)))
    for label, hi, lo in cases:
        h = torch.as_tensor(np.asarray(hi, np.int64).astype(np.int32), device=dev)
        l = torch.as_tensor(np.asarray(lo, np.int64).astype(np.int32), device=dev)
        got = sort_lex(h, l)
        want = sort_lex_ref(h, l)
        for part, g, w in zip(("hi", "lo", "perm"), got, want):
            require_equal(f"sort_lex {label} {part}", g, w)
        log(f"  sort_lex {label}: equal")


def check_segment_sum(dev, rng) -> None:
    import torch
    from repro_torch.kernels.ref import segment_sum_ref
    from repro_torch.kernels.segment_reduce import SLAB_WORDS, segment_sum
    for k in (1, 2**18 + 1):
        for d in (1, 3, 64):
            n = 20_000 if d == 64 else 200_000
            for dtype in (torch.int32, torch.float32):
                for order in ("unsorted", "sorted"):
                    seg = rng.integers(-2, k + 3, n)        # some ids out of range
                    if order == "sorted":
                        seg = np.sort(seg)
                    s = torch.as_tensor(seg.astype(np.int32), device=dev)
                    v = torch.as_tensor(rng.integers(-50, 50, (n, d)),
                                        device=dev).to(dtype)
                    got = segment_sum(s, v, k, out_dtype=dtype, counts=True)
                    want = segment_sum_ref(s, v, k, out_dtype=dtype,
                                           counts=True)
                    require_equal(f"segment_sum sums k={k} d={d} {dtype}",
                                  got[0], want[0])
                    require_equal(f"segment_sum counts k={k} d={d}",
                                  got[1], want[1])
                    require_equal(f"segment_sum no counts k={k} d={d}",
                                  segment_sum(s, v, k, out_dtype=dtype),
                                  want[0])
            log(f"  segment_sum K={k} D={d}: int32 and integer-valued "
                f"float32, sorted and unsorted ids: equal")
    # the core's variants (csrc/scatter_sum.cuh): a block-private copy of
    # the output up to K (D + counts) = SLAB_WORDS words; above, the direct
    # pass at D = 1 without counts and the partition otherwise; bins of
    # 16384 keys (D = 1, counts) reach 2048 at K = 2^25, and one more key
    # takes two slab windows a bin; D above the slab's words splits into
    # column groups; a seg view off 16-byte alignment takes the scalar
    # loads
    cases = []
    for d in (1, 3, 64):
        for cnt in (True, False):
            kb = SLAB_WORDS // (d + cnt)
            for k in (kb - 1, kb, kb + 1):
                cases.append((f"K={k} D={d} at the private variant's "
                              f"boundary", rng.integers(-2, k + 3, 100_003),
                              d, k, (cnt,)))
    for k in (2**25, 2**25 + 1):
        cases.append((f"K={k} at the slab-window boundary",
                      rng.integers(0, k + 1, 2**20), 1, k, (True,)))
    cases.append((f"D={SLAB_WORDS + 3} (two column groups)",
                  rng.integers(-1, 6, 300), SLAB_WORDS + 3, 5,
                  (True, False)))
    n = 2**24
    cases.append((f"{n} rows on one id, K=2^18+1", np.full(n, 12345), 1,
                   2**18 + 1, (True, False)))
    cases.append((f"{n} rows on one id, K=1", np.zeros(n), 1, 1,
                  (True, False)))
    z = rng.zipf(1.2, 2**22) - 1
    z[z > 2**18] = -1                        # the tail past K dropped
    cases.append(("Zipf(1.2) ids, K=2^18+1", z, 1, 2**18 + 1, (True, False)))
    cases.append(("sorted ids, K=2^20", np.sort(rng.integers(0, 2**20, 2**22)),
                  1, 2**20, (True, False)))
    # the partition sizes its bins (16384 keys at D = 1 with counts) from
    # every 16th run of 128 rows: ids whose bin follows the run make every
    # other bin overflow its room
    run = np.arange(2**21) // 128
    ids = np.where(run % 16 == 0, rng.integers(0, 16384, 2**21),
                   (run % 16) * 16384 + rng.integers(0, 16384, 2**21))
    for d in (1, 3):
        cases.append((f"ids the bin sizing misjudges (rows past their bin's "
                      f"room), D={d}", ids, d, 2**18 + 1, (True, False)))
    live = rng.random(2**24) < 0.5
    cases.append(("K=2^22, half the rows dropped",
                   np.where(live, rng.integers(0, 2**22, 2**24), 2**22), 1,
                   2**22, (True, False)))
    for label, seg, d, k, modes in cases:
        for dtype in (torch.int32, torch.float32):
            s = torch.as_tensor(np.asarray(seg).astype(np.int32), device=dev)
            v = torch.as_tensor(rng.integers(-9, 10, (s.numel(), d)),
                                dtype=torch.int32, device=dev).to(dtype)
            for cnt in modes:
                got = segment_sum(s, v, k, out_dtype=dtype, counts=cnt)
                want = segment_sum_ref(s, v, k, out_dtype=dtype, counts=cnt)
                if cnt:
                    require_equal(f"segment_sum {label} {dtype} counts",
                                  got[1], want[1])
                    got, want = got[0], want[0]
                require_equal(f"segment_sum {label} {dtype} sums", got, want)
            del s, v, got, want
        log(f"  segment_sum {label}: int32 and integer-valued float32, "
            f"counts {' and '.join('on' if c else 'off' for c in modes)}: "
            f"equal")
    s = torch.as_tensor(rng.integers(-1, 300, 50_001).astype(np.int32),
                        device=dev)[1:]
    v = torch.as_tensor(rng.integers(-9, 10, (50_001, 1)), dtype=torch.int32,
                        device=dev).to(torch.float32)[1:]
    for k in (300, 2**18 + 1):
        got = segment_sum(s, v, k, counts=True)
        want = segment_sum_ref(s, v, k, counts=True)
        require_equal(f"segment_sum unaligned views K={k} sums", got[0],
                      want[0])
        require_equal(f"segment_sum unaligned views K={k} counts", got[1],
                      want[1])
        require_equal(f"segment_sum unaligned views K={k} no counts",
                      segment_sum(s, v, k), want[0])
    log("  segment_sum views 4 bytes off 16-byte alignment (scalar loads), "
        "private, direct and partitioned: equal")
    torch.cuda.empty_cache()
    # non-integer floats: atomics add in run-dependent order; allow the
    # reordering error of float32 sums (relative to the sum of |v|)
    n, k = 500_000, 1000
    s = torch.as_tensor(rng.integers(0, k, n).astype(np.int32), device=dev)
    v = torch.as_tensor(rng.normal(0, 1, (n, 3)).astype(np.float32), device=dev)
    err = sum_rel_err("segment_sum float", segment_sum(s, v, k),
                      segment_sum_ref(s, v, k), segment_sum_ref(s, v.abs(), k))
    log(f"  segment_sum non-integer float32: relative error {err:.3g} "
        f"(tolerance 1e-5 of sum|v|: atomic order)")


# the coalescer's sizes (repro_torch.stream.coalesce: cap = next_bucket(n,
# 64)): the sort and the int32 segment sum with counts held bitwise there
SMALL_N = (64, 4096, 8192)


def check_small_sizes(dev, rng) -> dict:
    """The sort and the int32 segment sum with counts at the coalescer's
    sizes, against their plain versions bit for bit, on the coalescer's own
    inputs: record ids with a padded tail of INT32_MAX, lo = the row index;
    ascending segment ids of the signs, the padded tail dropped (id K).
    Returns {n: kernel, plain and library ms and the bound of each}."""
    import torch
    from repro_torch.kernels.ref import segment_sum_ref, sort_lex_ref
    from repro_torch.kernels.segment_reduce import segment_sum
    from repro_torch.kernels.sort_u32 import sort_lex
    out = {}
    for n in SMALL_N:
        live = n - n // 4
        rid = rng.integers(0, max(live // 3, 1), n)
        rid[live:] = INT32_MAX
        hi = torch.as_tensor(rid.astype(np.int32), device=dev)
        lo = torch.arange(n, dtype=torch.int32, device=dev)
        for part, g, w in zip(("hi", "lo", "perm"), sort_lex(hi, lo),
                              sort_lex_ref(hi, lo)):
            require_equal(f"sort_lex n={n} (coalescer) {part}", g, w)
        ids = np.cumsum(rng.random(n) < 0.4) - 1
        ids[live:] = n
        seg = torch.as_tensor(ids.astype(np.int32), device=dev)
        vals = torch.as_tensor(rng.choice(np.int32([-1, 1]), (n, 1)),
                               device=dev)
        got = segment_sum(seg, vals, n, out_dtype=torch.int32, counts=True)
        want = segment_sum_ref(seg, vals, n, out_dtype=torch.int32,
                               counts=True)
        for part, g, w in zip(("sums", "counts"), got, want):
            require_equal(f"segment_sum n={n} int32 counts (coalescer) "
                          f"{part}", g, w)
        # the library calls: torch.sort of the packed (hi, lo) key, stable;
        # index_add_ + bincount on the rows in range (compacted beforehand,
        # untimed), as at the main path's shapes
        packed = (hi.to(torch.int64) << 32) | (lo.to(torch.int64) + 2**31)
        in_range = (seg >= 0) & (seg < n)
        lsid = seg[in_range].to(torch.int64)
        lvals = vals[in_range]

        def library_sum():
            torch.zeros((n, 1), dtype=torch.int32, device=dev).index_add_(
                0, lsid, lvals)
            torch.bincount(lsid, minlength=n)

        t = dict(
            sort_ms=cuda_ms(lambda: sort_lex(hi, lo)),
            sort_plain_ms=cuda_ms(lambda: sort_lex_ref(hi, lo)),
            sort_library_ms=cuda_ms(lambda: torch.sort(packed, stable=True)),
            # the sort: hi, lo read, the three lanes written; n log2 n
            # compares
            sort_bound_ms=bound(n * 8 + n * 12, n * math.log2(n))["bound_ms"],
            sum_ms=cuda_ms(lambda: segment_sum(
                seg, vals, n, out_dtype=torch.int32, counts=True)),
            sum_plain_ms=cuda_ms(lambda: segment_sum_ref(
                seg, vals, n, out_dtype=torch.int32, counts=True)),
            sum_library_ms=cuda_ms(library_sum),
            # seg and vals read, sums and counts written; a value and a
            # count added a row in range
            sum_bound_ms=bound(n * 8 + n * 8, 2 * lsid.numel())["bound_ms"])
        out[n] = t
        log(f"  coalescer sizes n={n}: sort_lex and segment_sum (int32, "
            f"counts) equal to their plain versions; sort {t['sort_ms']:.4f}"
            f" ms (plain {t['sort_plain_ms']:.4f}, torch.sort stable on the "
            f"packed key {t['sort_library_ms']:.4f}, bound "
            f"{t['sort_bound_ms']:.3g}), segment_sum {t['sum_ms']:.4f} ms "
            f"(plain {t['sum_plain_ms']:.4f}, index_add_ + bincount on the "
            f"rows in range {t['sum_library_ms']:.4f}, bound "
            f"{t['sum_bound_ms']:.3g})")
    return out


def fused_rows(dev, rng, n, d, dtype, nkeys, *, absent=0, tomb=0.25,
               hot=False, float_vals=False, routed=1.0, cap=None):
    """Rows with duplicate (k2, mk) runs, tombstones, invalid rows and k2
    values outside the affected set: ``nkeys`` distinct k2 (one key owning
    every row when ``hot``), a share ``tomb`` of tombstones, 10% invalid
    rows; the affected keys are a share ``routed`` of the present k2 plus
    ``absent`` keys with no rows (empty slots), padded with INT32_MAX to a
    power of two, or to ``cap`` slots (a random ``cap`` of them where
    there are more); values integer-valued unless ``float_vals``."""
    import torch
    k2 = np.full(n, 7) if hot else rng.integers(0, nkeys, n)
    mk = rng.integers(0, 8, n).astype(np.int32)
    vals = rng.normal(0, 1, (n, d)) if float_vals \
        else rng.integers(-20, 20, (n, d))
    valid = rng.random(n) < 0.9
    sign = np.where(rng.random(n) < tomb, -1, 1).astype(np.int8)
    present = np.unique(k2[valid])
    aff = np.union1d(present[rng.random(present.size) < routed],
                     nkeys + 3 * np.arange(absent)).astype(np.int32)
    if cap is None:
        cap = 1 << max(int(np.ceil(np.log2(aff.size + 1))), 3)
    elif aff.size > cap:
        aff = np.sort(rng.choice(aff, cap, replace=False))
    keys = np.full(cap, INT32_MAX, np.int32)
    keys[:aff.size] = aff
    t = lambda a: torch.as_tensor(a, device=dev)
    return (t(np.where(valid, k2, INT32_MAX).astype(np.int32)), t(mk),
            t(vals.astype(np.float32)).to(dtype), t(valid), t(sign), t(keys))


def check_fused_runs(dev, rng) -> None:
    """The large path's edges (``csrc/fused.cu``: tiles of 1024 sorted rows
    at D = 1, a warp's 32 at D > 1), bit for bit against the plain version
    and the composed path on integer data: runs longer than a tile that
    cross its edges, one key owning every row, every row tombstoned,
    affected keys with no rows, key_cap 4096 at D = 8.  Then non-integer
    float32, on this path and on the one-block path: acc within 1e-5 of
    the sum of |v|, and equal bit for bit from one call to the next (both
    add in a fixed order)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused import fused_shuffle_reduce
    from repro_torch.kernels.ref import fused_shuffle_reduce_ref
    names = ("k2", "mk", "vals", "live", "perm", "acc", "counts")
    cases = [
        ("runs of ~6,700 rows across tile edges", 20_000, (1, 8), 3, {}),
        ("runs of ~2,048 rows", 2**16 + 5, (1, 8), 32, {}),
        ("one key owning every row", 2**20, (1,), 1, dict(hot=True)),
        ("one key owning every row", 2**16, (8,), 1, dict(hot=True)),
        ("every row a tombstone", 50_000, (1, 8), 500, dict(tomb=1.0)),
        ("500 affected keys with no rows", 50_000, (1, 8), 700,
         dict(absent=500)),
        ("key_cap 4096", 100_000, (1, 8), 4000, dict(absent=90)),
    ]
    for label, n, ds, nkeys, opt in cases:
        for d in ds:
            for dtype in (torch.int32, torch.float32):
                args = fused_rows(dev, rng, n, d, dtype, nkeys, **opt)
                got = fused_shuffle_reduce(*args, out_dtype=dtype)
                want = fused_shuffle_reduce_ref(*args, out_dtype=dtype)
                for name, g, w in zip(names, got, want):
                    require_equal(f"fused {label} n={n} d={d} {dtype} "
                                  f"{name}", g, w)
                k2m, mk, vals, valid, sign, keys = args
                cp = ops.shuffle_reduce("sum", k2m, mk, vals, valid, sign,
                                        keys, fused=False)
                for name, g in zip(names, got):
                    c = getattr(cp, "values" if name == "vals" else name)
                    require_equal(f"fused vs composed {label} d={d} {name}",
                                  g, c)
        log(f"  fused_shuffle_reduce {label} (N={n}, key_cap "
            f"{args[5].numel()}, D in {ds}): int32 and integer-valued "
            f"float32 equal to plain and to composed")
    worst = 0.0
    for label, n, d, nkeys, opt in (
            ("runs across tile edges", 20_000, 1, 3, {}),
            ("one key owning every row", 2**20, 1, 1, dict(hot=True)),
            ("key_cap 4096", 100_000, 8, 4000, {}),
            ("one block, runs across its threads and warps", 4091, 1, 3, {}),
            ("one block, D = 8", 4091, 8, 3, {})):
        args = fused_rows(dev, rng, n, d, torch.float32, nkeys,
                          float_vals=True, **opt)
        got = fused_shuffle_reduce(*args, out_dtype=torch.float32)
        again = fused_shuffle_reduce(*args, out_dtype=torch.float32)
        require_equal(f"fused {label} float acc from one call to the next",
                      got[5], again[5])
        want = fused_shuffle_reduce_ref(*args, out_dtype=torch.float32)
        abs_args = list(args)
        abs_args[2] = args[2].abs()
        worst = max(worst, sum_rel_err(
            f"fused {label} float acc", got[5], want[5],
            fused_shuffle_reduce_ref(*abs_args, out_dtype=torch.float32)[5]))
        for name, g, w in zip(names, got, want):
            if name != "acc":
                require_equal(f"fused {label} float {name}", g, w)
    log(f"  fused_shuffle_reduce non-integer float32 (runs across tiles, "
        f"one hot key, key_cap 4096 at D = 8; the one-block path at 4,091 "
        f"rows, D 1 and 8): acc equal from call to call, relative error "
        f"{worst:.3g} (tolerance 1e-5 of sum|v|)")


def check_fused(dev, rng) -> None:
    """The fused merge on both routes, bit for bit against its plain version
    and the composed path on int32 and integer-valued float32: sizes from
    one row through the serving tier's tenants (12, 40) and the one-block
    limit (``SMALL_MAX_ROWS`` and one row either side) to the large path,
    D 1, 8 and 512 (512 up to one row past the limit); then the one-block
    path's edges at every size up to the limit and one past it: key_cap 8
    (a few of the present keys routed) and 4096, every row a tombstone,
    one key owning every row, affected keys with no rows."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused import SMALL_MAX_ROWS, fused_shuffle_reduce
    from repro_torch.kernels.ref import fused_shuffle_reduce_ref
    names = ("k2", "mk", "vals", "live", "perm", "acc", "counts")
    lim = SMALL_MAX_ROWS

    def check(label, n, d, dtype, nkeys, **opt):
        args = fused_rows(dev, rng, n, d, dtype, nkeys, **opt)
        got = fused_shuffle_reduce(*args, out_dtype=dtype)
        want = fused_shuffle_reduce_ref(*args, out_dtype=dtype)
        for name, g, w in zip(names, got, want):
            require_equal(f"fused {label} n={n} d={d} {dtype} {name}", g, w)
        # the port's composed path on the card gives the same bits
        k2m, mk, vals, valid, sign, keys = args
        fz = ops.shuffle_reduce("sum", k2m, mk, vals, valid, sign, keys,
                                fused=True)
        cp = ops.shuffle_reduce("sum", k2m, mk, vals, valid, sign, keys,
                                fused=False)
        for name in ("k2", "mk", "values", "live", "perm", "acc", "counts"):
            require_equal(f"fused vs composed {label} n={n} d={d} {name}",
                          getattr(fz, name), getattr(cp, name))

    for n in (1, 2, 5, 12, 31, 32, 33, 40, 64, 1000, lim - 1, lim, lim + 1,
              9000, 70_000):
        ds = (1, 8, 512) if n <= lim + 1 else (1, 8)
        for d in ds:
            for dtype in (torch.float32, torch.int32):
                # few distinct keys: long (k2, mk) runs straddle the
                # threads, warps and tiles of the sorted order
                check("", n, d, dtype, max(n // 64, 2), routed=0.8)
        log(f"  fused_shuffle_reduce n={n} "
            f"({'one block' if n <= lim else 'sort + runs'}), "
            f"D in {ds}, int32/float32: equal to plain and to composed")
    for label, opt in (("key_cap 8", dict(cap=8)),
                       ("key_cap 4096", dict(cap=4096)),
                       ("every row a tombstone", dict(tomb=1.0)),
                       ("one key owning every row", dict(hot=True)),
                       ("40 affected keys with no rows", dict(absent=40))):
        for n in (1, 2, 31, 32, 33, 64, 1000, lim, lim + 1):
            for d in (1, 8, 512):
                for dtype in (torch.float32, torch.int32):
                    check(label, n, d, dtype, max(n // 8, 2), **opt)
        log(f"  fused_shuffle_reduce one-block edges, {label}: n 1 to "
            f"{lim + 1}, D 1/8/512, int32/float32: equal to plain and to "
            f"composed")


def check_segment_minmax(dev, rng) -> None:
    import torch
    from repro_torch.kernels.ref import segment_minmax_ref
    from repro_torch.kernels.segment_reduce import SLAB_WORDS, segment_minmax
    # K = 1; K = 5000 over 300 rows (most segments empty: the identity);
    # K = 2^18 + 1 over 2e5 rows; ids from -2 to K + 2 (out of range
    # dropped); negative values; no -0.0 (see csrc/segment_minmax.cu)
    for k, n in ((1, 1000), (5000, 300), (2**18 + 1, 200_000), (7, 0)):
        for d in (1, 3, 64):
            m = n if d < 64 else min(n, 20_000)
            s = torch.as_tensor(rng.integers(-2, k + 3, m).astype(np.int32),
                                device=dev)
            for vals in (rng.integers(-2**31, 2**31, (m, d)).astype(np.int32),
                         rng.normal(0, 100, (m, d)).astype(np.float32)):
                v = torch.as_tensor(vals, device=dev)
                for kind in ("min", "max"):
                    require_equal(f"segment_minmax {kind} k={k} n={m} d={d} "
                                  f"{v.dtype}", segment_minmax(kind, s, v, k),
                                  segment_minmax_ref(kind, s, v, k))
        log(f"  segment_minmax K={k} N={n}: min and max, D in (1, 3, 64), "
            f"int32 and float32 with negatives: equal")
    # the pass's edges (csrc/segment_minmax.cu): K D on either side of
    # SLAB_WORDS (SSSP's refresh buckets); N of 2^17 to 2^22, which launch
    # blocks of 128 to 1,024 threads, and a partial last quad; sorted ids
    # (runs the warp collapses, as SSSP's refresh gives them) and one hot
    # id; values in random, decreasing and increasing order, 5% at +inf and
    # 5% at -inf (float32), 5% at each int32 extreme
    w = SLAB_WORDS
    cases = [(f"K={k} D={d}", rng.integers(-2, k + 3, 200_003), d, k)
             for d in (1, 4) for k in (w // d, w // d + 1)]
    cases += [("sorted ids, K=16384", np.sort(rng.integers(0, 16384, 2**17)),
               1, 16384),
              ("sorted ids, K=2^18+1 (blocks of 256)",
               np.sort(rng.integers(0, 2**18 + 1, 2**19 - 1)), 1, 2**18 + 1),
              ("sorted ids, K=2^18+1 (blocks of 512)",
               np.sort(rng.integers(0, 2**18 + 1, 2**20 - 1)), 1, 2**18 + 1),
              ("sorted ids, K=2^20", np.sort(rng.integers(0, 2**20, 2**22)),
               1, 2**20),
              ("2^22 rows on one id, K=2^18+1", np.full(2**22, 777), 1,
               2**18 + 1),
              ("2^22 rows on one id, K=5", np.full(2**22, 3), 1, 5)]
    for label, seg, d, k in cases:
        s = torch.as_tensor(seg.astype(np.int32), device=dev)
        n = s.numel()
        for order in ("random", "decreasing", "increasing"):
            f = rng.normal(0, 100, (n, d)).astype(np.float32)
            i = rng.integers(-2**31, 2**31, (n, d)).astype(np.int32)
            u = rng.random((n, d))
            f[u < 0.05] = np.inf
            f[u > 0.95] = -np.inf
            i[u < 0.05] = 2**31 - 1
            i[u > 0.95] = -2**31
            if order != "random":
                f, i = np.sort(f, axis=0), np.sort(i, axis=0)
                if order == "decreasing":
                    f, i = f[::-1].copy(), i[::-1].copy()
            for vals in (f, i):
                v = torch.as_tensor(vals, device=dev)
                for kind in ("min", "max"):
                    require_equal(f"segment_minmax {kind} {label} {order} "
                                  f"{v.dtype}", segment_minmax(kind, s, v, k),
                                  segment_minmax_ref(kind, s, v, k))
        log(f"  segment_minmax {label}, N={n}: min and max, int32 and "
            f"float32 with both infinities and both int32 extremes, rows in "
            f"random, decreasing and increasing order: equal")


def check_spmv_ell(dev, rng) -> None:
    import torch
    from repro_torch.kernels.ref import spmv_ell_ref
    from repro_torch.kernels.spmv_ell import spmv_ell
    worst = 0.0
    for s_rows, f, v in ((1000, 4, 50), (2**16, 16, 2**16), (5000, 8, 1)):
        nbrs = rng.integers(0, v + 5, (s_rows, f)).astype(np.int32)  # >= V
        nbrs[rng.random((s_rows, f)) < 0.5] = -1
        nb = torch.as_tensor(nbrs, device=dev)
        ints = torch.as_tensor(rng.integers(-9, 10, (s_rows, f)),
                               device=dev).to(torch.float32)
        require_equal(f"spmv_ell S={s_rows} F={f} V={v} integer-valued",
                      spmv_ell(nb, ints, v), spmv_ell_ref(nb, ints, v))
        c = torch.as_tensor(rng.normal(0, 1, (s_rows, f)).astype(np.float32),
                            device=dev)
        worst = max(worst, sum_rel_err(f"spmv_ell S={s_rows} F={f} V={v}",
                                       spmv_ell(nb, c, v),
                                       spmv_ell_ref(nb, c, v),
                                       spmv_ell_ref(nb, c.abs(), v)))
    # one vertex takes 10% of all in-edges (a hot bin split across blocks)
    s_rows, f, v = 2**18, 16, 2**18
    nbrs = rng.integers(0, v, (s_rows, f)).astype(np.int32)
    nbrs[rng.random((s_rows, f)) < 0.1] = 7
    nbrs[rng.random((s_rows, f)) < 0.3] = -1
    nb = torch.as_tensor(nbrs, device=dev)
    ints = torch.as_tensor(rng.integers(-9, 10, (s_rows, f)),
                           device=dev).to(torch.float32)
    require_equal("spmv_ell hot vertex integer-valued",
                  spmv_ell(nb, ints, v), spmv_ell_ref(nb, ints, v))
    c = torch.as_tensor(rng.normal(0, 1, (s_rows, f)).astype(np.float32),
                        device=dev)
    worst = max(worst, sum_rel_err("spmv_ell hot vertex", spmv_ell(nb, c, v),
                                   spmv_ell_ref(nb, c, v),
                                   spmv_ell_ref(nb, c.abs(), v)))
    log(f"  spmv_ell (also one vertex with 10% of the in-edges): "
        f"integer-valued sums equal; non-integer float32 relative error "
        f"{worst:.3g} (tolerance 1e-5 of sum|contrib|: order of the adds)")


def sum_rel_err(name, got, want, scale) -> float:
    """Error of a float32 sum kernel per output relative to the sum of the
    |terms| that reach it (``scale``); fails above 1e-5, the reordering
    error of float32 sums, since atomics add in run-dependent order."""
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}")
    err = float(((got - want).abs() / scale.clamp_min(1e-30)).max()) \
        if got.numel() else 0.0
    if not err <= 1e-5:
        raise AssertionError(f"{name}: relative error {err} > 1e-5")
    return err


def flash_bound(q, k, v, opt: dict, rel: float):
    """The plain version's output (float32) and the elementwise bound
    ``rel * (|plain| + A)`` the kernel is held to (see FLASH_REL)."""
    from repro_torch.kernels.ref import flash_attention_ref
    want = flash_attention_ref(q, k, v, **opt).float()
    a = flash_attention_ref(q.float(), k.float(), v.float().abs(), **opt)
    return want, a.add_(want.abs()).mul_(rel).clamp_min_(1e-30)


def flash_share(got, want, bound) -> tuple:
    """Max |got - want| and its largest share of the bound (fails above
    1)."""
    d = (got.float() - want).abs_()
    if not d.numel():
        return 0.0, 0.0
    return float(d.max()), float(d.div_(bound).max())


def time_flash_recurrentgemma(dev, gen) -> dict:
    """RecurrentGemma 2B's attn_local layer (``FLASH_RECURRENTGEMMA``, the
    first shape with KH 1 and H / KH 10): held within ``flash_bound`` at q
    std 1 and 20, the window shown to act (the plain version without it
    moves most outputs past the bound), timed beside its plain version
    and SDPA with the window as a boolean mask."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    b, h, kh, s, hd = FLASH_RECURRENTGEMMA
    opt = dict(causal=True, window=FLASH_RECURRENTGEMMA_WINDOW)
    share, err = 0.0, 0.0
    for scale in FLASH_Q_SCALES:
        q, k, v = (torch.randn((b, n, s, hd), generator=gen, device=dev)
                   .mul_(sd).to(torch.bfloat16)
                   for n, sd in ((h, scale), (kh, 1), (kh, 1)))
        want, tol = flash_bound(q, k, v, opt, FLASH_REL["bfloat16"])
        e, sh = flash_share(flash_attention(q, k, v, **opt), want, tol)
        if not sh <= 1:
            raise AssertionError(f"flash_attention RecurrentGemma layer, q "
                                 f"std {scale}: max abs err {e}, {sh:.3g} "
                                 f"of the bound")
        err, share = max(err, e), max(share, sh)
        wrong = flash_attention_ref(q, k, v, causal=True)
        moved = float(((wrong.float() - want).abs_() > tol).float().mean())
        del want, tol, wrong
        torch.cuda.empty_cache()
    if not moved > 0.1:
        raise AssertionError(f"flash_attention RecurrentGemma layer: "
                             f"dropping the window moves only {moved:.3g} "
                             f"of the outputs past the bound")
    i = torch.arange(s, device=dev)
    mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < opt[
        "window"])
    flops = 4 * b * h * hd * keys_in_range(s, opt["window"])
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2
    res = dict(
        max_abs_err=err, share_of_bound=share, moved_if_dropped=moved,
        ms=cuda_ms(lambda: flash_attention(q, k, v, **opt)),
        plain_ms=cuda_ms(lambda: flash_attention_ref(q, k, v, **opt)),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True)),
        **bound(nbytes, flops, tensor_cores=True))
    res["tflops"] = flops / res["ms"] / 1e9
    del q, k, v, mask
    torch.cuda.empty_cache()
    return res


def time_flash_moe(dev, gen, shape) -> dict:
    """Phase 13's layer at ``shape`` (``FLASH_MLA``: q.k head dim 192, v
    128; ``FLASH_LLAMA4``: H / KH 5), or phase 16's (``FLASH_MLA_100M``:
    q.k 96, v 64), bf16, causal: held within
    ``flash_bound`` at q std 1 and 20, timed beside its plain version and
    ``scaled_dot_product_attention`` (which takes a v head dim of its own;
    ``library_ms`` None, and the reason in ``library``, where it
    refuses)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    b, h, kh, s, hd, vd = shape
    share, err = 0.0, 0.0
    for scale in FLASH_Q_SCALES:
        q, k, v = (torch.randn((b, n, s, d), generator=gen, device=dev)
                   .mul_(sd).to(torch.bfloat16)
                   for n, sd, d in ((h, scale, hd), (kh, 1, hd),
                                    (kh, 1, vd)))
        want, tol = flash_bound(q, k, v, {}, FLASH_REL["bfloat16"])
        got = flash_attention(q, k, v)
        e, sh = flash_share(got, want, tol)
        if tuple(got.shape) != (b, h, s, vd) or not sh <= 1:
            raise AssertionError(f"flash_attention {shape}, q std {scale}: "
                                 f"out {tuple(got.shape)}, max abs err {e}, "
                                 f"{sh:.3g} of the bound")
        err, share = max(err, e), max(share, sh)
        del want, tol, got
        torch.cuda.empty_cache()
    flops = 2 * b * h * (hd + vd) * keys_in_range(s, 0)
    nbytes = (q.numel() + k.numel() + v.numel() + b * h * s * vd) * 2
    res = dict(max_abs_err=err, share_of_bound=share,
               ms=cuda_ms(lambda: flash_attention(q, k, v)),
               plain_ms=cuda_ms(lambda: flash_attention_ref(q, k, v)),
               **bound(nbytes, flops, tensor_cores=True))
    try:
        res["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=kh != h))
        res["library"] = "scaled_dot_product_attention(is_causal)"
    except RuntimeError as exc:
        res["library_ms"] = None
        res["library"] = f"none: SDPA refused ({str(exc)[:80]})"
    res["tflops"] = flops / res["ms"] / 1e9
    del q, k, v
    torch.cuda.empty_cache()
    return res


def check_flash_attention(dev, rng) -> None:
    """The flash kernel against its plain version: float32 and bf16, head
    dims 64, 128, 256 and MLA's pairs (q.k 192, v 128; q.k 96, v 64: its
    32-column boxes, V's count of them not Q's); KH = H, H/2, 1; S of
    1, 100 and 333 (no multiple of either dtype's tile); causal and not;
    windows under one tile; softcap on and off; q at std 1 and 20.  Then
    Qwen3-1.7B's heads (hd 128, H 16, KH 8) at S of 1, 127, 128, 129
    (around the bf16 kernel's 128-row q tile and 128-key tile) and 200 (no
    multiple of 64), with windows of 20 and 50 keys (under one key tile)
    besides the options above.  Then HuBERT X-Large's hd 80 and StableLM
    12B's hd 160 (bf16 on the wgmma kernel's 16- and 32-column boxes): KH
    8, 4, 1 of H 8 at S of 1, 63, 64, 65, 100, 127, 128, 129 (around the
    128-row q tile and 128-key tile), 200 and 333, with every option
    above."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    options = (dict(causal=True), dict(causal=True, window=20),
               dict(causal=True, softcap=50.0),
               dict(causal=True, window=20, softcap=50.0),
               dict(causal=False), dict(causal=False, window=100,
                                        softcap=30.0))
    shapes = [(8, hd, kh, s, options)
              for hd in (64, 128, 256, (192, 128), (96, 64))
              for kh in (8, 4, 1) for s in (1, 100, 333)]
    qwen = options + (dict(causal=True, window=50),)
    shapes += [(16, 128, 8, s, qwen) for s in (1, 127, 128, 129, 200)]
    shapes += [(8, hd, kh, s, qwen) for hd in FLASH_NEW_HDS
               for kh in (8, 4, 1)
               for s in (1, 63, 64, 65, 100, 127, 128, 129, 200, 333)]
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        worst, worst_share = 0.0, 0.0
        for scale in FLASH_Q_SCALES:
            rel = FLASH_REL[name] * (scale if dtype == torch.float32 else 1)
            for h, dims, kh, s, opts in shapes:
                hd, vd = dims if isinstance(dims, tuple) else (dims, dims)
                q, k, v = (torch.as_tensor(
                    rng.normal(0, sd, (2, n, s, d)).astype(
                        np.float32), device=dev).to(dtype)
                    for n, sd, d in ((h, scale, hd), (kh, 1, hd),
                                     (kh, 1, vd)))
                for opt in opts:
                    got = flash_attention(q, k, v, **opt)
                    err, share = flash_share(
                        got, *flash_bound(q, k, v, opt, rel))
                    if got.dtype != dtype or got.shape[-1] != vd \
                            or not share <= 1:
                        raise AssertionError(
                            f"flash_attention {dtype} q std {scale} "
                            f"hd={hd} vd={vd} H={h} KH={kh} S={s} {opt}: max "
                            f"abs err {err}, {share:.3g} of the "
                            f"bound {rel} (|plain| + A)")
                    worst = max(worst, err)
                    worst_share = max(worst_share, share)
        log(f"  flash_attention {dtype}: q std 1/20, hd 64/128/256, "
            f"q.k 192 / v 128 and q.k 96 / v 64, KH 8/4/1 "
            f"of H 8, S 1/100/333, causal or not, window 20/100, softcap "
            f"0/30/50; hd 128 H 16 KH 8 at S 1/127/128/129/200, window "
            f"20/50; hd 80/160, KH 8/4/1 of H 8, S 1/63/64/65/100/127/128/129/"
            f"200/333, window 20/50/100: max "
            f"abs err {worst:.3g}, at most {worst_share:.3g} of "
            f"the bound {FLASH_REL[name]:.3g}"
            f"{' x q std' if dtype == torch.float32 else ''} (|plain| + A)")


def keys_in_range(s: int, window: int) -> int:
    """Keys a causal attention of S rows attends, summed over the rows."""
    w = window if window > 0 else s
    return sum(min(i + 1, w) for i in range(s))


def time_flash_attention(dev) -> dict:
    """The flash kernel at the main path's shape, bf16: (a) a local layer
    (window 4096, softcap 50), (b) a global layer (softcap 50), each with
    its plain version; (c) softcap 0, window 0, beside
    ``scaled_dot_product_attention``, the softcap-free yardstick (no one
    PyTorch call computes softcap 50).  q is drawn at std 20, so the
    softcap and the window act; each is shown to move most outputs past
    the bound the kernel is held to (the plain version without it).  Then
    (d) Qwen3-1.7B's heads (``FLASH_QWEN``: hd 128, softcap 0), HuBERT
    X-Large's layer (``FLASH_HUBERT``: hd 80, not causal), StableLM
    12B's (``FLASH_STABLELM``: hd 160), Mistral NeMo 12B's
    (``FLASH_MISTRAL``) and Chameleon 34B's (``FLASH_CHAMELEON``), each
    held within ``flash_bound`` and timed beside its plain version and
    SDPA."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    b, h, kh, s, hd = FLASH_MAIN
    gen = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn((b, n, s, hd), generator=gen, device=dev).mul_(
        sd).to(torch.bfloat16)
        for n, sd in ((h, FLASH_Q_SCALES[-1]), (kh, 1), (kh, 1)))
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2
    res = {}
    for label, window, cap, dropped in (
            ("local", 4096, 50.0, dict(window=0)),
            ("global", 0, 50.0, dict(softcap=0.0)),
            ("softcap0", 0, 0.0, None)):
        opt = dict(window=window, softcap=cap)
        fn = lambda: flash_attention(q, k, v, **opt)
        plain = lambda: flash_attention_ref(q, k, v, **opt)
        want, tol = flash_bound(q, k, v, opt, FLASH_REL["bfloat16"])
        err, share = flash_share(fn(), want, tol)
        if not share <= 1:
            raise AssertionError(f"flash_attention main shape {label}: max "
                                 f"abs err {err}, {share:.3g} of the bound")
        if dropped:
            wrong = flash_attention_ref(q, k, v, **{**opt, **dropped})
            moved = float(((wrong.float() - want).abs_() > tol).float()
                          .mean())
            del wrong
            if not moved > 0.1:
                raise AssertionError(
                    f"flash_attention main shape {label}: dropping "
                    f"{dropped} moves only {moved:.3g} of the outputs past "
                    f"the bound; the check cannot see that option")
        del want, tol
        flops = 4 * b * h * hd * keys_in_range(s, window)
        res[label] = dict(max_abs_err=err, share_of_bound=share,
                          ms=cuda_ms(fn),
                          **bound(nbytes, flops, tensor_cores=True))
        if dropped:
            res[label]["moved_if_dropped"] = moved
        if label == "softcap0":
            res[label]["library_ms"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True))
        else:
            res[label]["plain_ms"] = cuda_ms(plain)
        res[label]["tflops"] = flops / res[label]["ms"] / 1e9
        torch.cuda.empty_cache()
    del q, k, v
    # Qwen3-1.7B's heads, HuBERT's and StableLM's dims and phase 11's hd 128
    # layers, each at its arch's layer, beside their plain version and
    # SDPA (softcap 0, window 0: the layers' own options)
    for label, (b, h, kh, s, hd), causal in FLASH_LAYERS:
        q, k, v = (torch.randn((b, n, s, hd), generator=gen, device=dev)
                   .mul_(sd).to(torch.bfloat16)
                   for n, sd in ((h, FLASH_Q_SCALES[-1]), (kh, 1), (kh, 1)))
        opt = dict(causal=causal)
        fn = lambda: flash_attention(q, k, v, **opt)
        want, tol = flash_bound(q, k, v, opt, FLASH_REL["bfloat16"])
        err, share = flash_share(fn(), want, tol)
        if not share <= 1:
            raise AssertionError(f"flash_attention {label} shape: max abs "
                                 f"err {err}, {share:.3g} of the bound")
        del want, tol
        keys = keys_in_range(s, 0) if causal else s * s
        flops = 4 * b * h * hd * keys
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2
        res[label] = dict(
            max_abs_err=err, share_of_bound=share, ms=cuda_ms(fn),
            plain_ms=cuda_ms(lambda: flash_attention_ref(q, k, v, **opt)),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=kh != h)),
            **bound(nbytes, flops, tensor_cores=True))
        res[label]["tflops"] = flops / res[label]["ms"] / 1e9
        del q, k, v
        torch.cuda.empty_cache()
    res["hd256_recurrentgemma"] = time_flash_recurrentgemma(dev, gen)
    res["mla"] = time_flash_moe(dev, gen, FLASH_MLA)
    res["llama4"] = time_flash_moe(dev, gen, FLASH_LLAMA4)
    res["mla100m"] = time_flash_moe(dev, gen, FLASH_MLA_100M)
    a, g, c = (res[n] for n in ("local", "global", "softcap0"))
    dims = {f"{key}_{label}": res[label][key]
            for label in [lb for lb, _, _ in FLASH_LAYERS]
            + ["hd256_recurrentgemma", "mla", "llama4", "mla100m"]
            for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    return dict(
        shape=("B={} H={} KH={} S={} hd={} bf16, causal, softcap 50, q std "
               "{:g}".format(*FLASH_MAIN, FLASH_Q_SCALES[-1])),
        max_abs_err=max(r["max_abs_err"] for r in res.values()),
        share_of_bound=max(r["share_of_bound"] for r in res.values()),
        moved_without_window=a["moved_if_dropped"],
        moved_without_softcap=g["moved_if_dropped"],
        moved_without_window_recurrentgemma=res["hd256_recurrentgemma"][
            "moved_if_dropped"],
        share_of_bound_recurrentgemma=res["hd256_recurrentgemma"][
            "share_of_bound"],
        share_of_bound_mla=res["mla"]["share_of_bound"],
        share_of_bound_llama4=res["llama4"]["share_of_bound"],
        share_of_bound_mla100m=res["mla100m"]["share_of_bound"],
        library_mla=res["mla"]["library"],
        library_llama4=res["llama4"]["library"],
        library_mla100m=res["mla100m"]["library"],
        bound_by_mla100m=res["mla100m"]["bound_by"],
        ms=g["ms"], plain_ms=g["plain_ms"], bound_ms=g["bound_ms"],
        bound_by=g["bound_by"], library_ms=c["library_ms"],
        ms_local=a["ms"], plain_ms_local=a["plain_ms"],
        bound_ms_local=a["bound_ms"], ms_softcap0=c["ms"],
        bound_ms_softcap0=c["bound_ms"], **dims,
        tflops={n: r["tflops"] for n, r in res.items()},
        note=("ms, plain_ms, bound_ms: a global layer (window 0, softcap "
              "50); *_local: a local layer (window 4096); library_ms: "
              "scaled_dot_product_attention(is_causal, enable_gqa) at "
              "softcap 0, beside ms_softcap0 (the kernel there): no one "
              "PyTorch call computes softcap 50; *_hd128: Qwen3-1.7B's "
              "heads (hd 128, softcap 0) at the same B and S, SDPA beside; "
              "*_hd80: HuBERT X-Large's layer (B 2, H = KH = 16, S 4096, "
              "not causal), *_hd160: StableLM 12B's (B 2, H 32, KH 8, S "
              "8192, causal), both on the wgmma kernel (16- and 32-column "
              "boxes); "
              "*_hd256_recurrentgemma: RecurrentGemma 2B's attn_local "
              "layer (B 2, H 10, KH 1, S 8192, causal, window 2048, no "
              "softcap; held at q std 1 and 20; library: SDPA with the "
              "window as a boolean mask); "
              "*_hd128_mistral: Mistral NeMo 12B's layer (B 2, H 32, KH "
              "8, S 8192, causal), *_hd128_chameleon: Chameleon 34B's (B "
              "1, H 64, KH 8, S 4096, causal); softcap 0, library: SDPA; "
              "*_mla: DeepSeek-V3's MLA layer (B 2, H = KH 128, S 4096, "
              "q.k 192, v 128, causal), *_llama4: Llama 4 Scout's (B 2, H "
              "40, KH 8, S 8192, hd 128, causal), *_mla100m: DeepSeek-V3's "
              "at --preset 100m (B 8, H = KH 12, S 1024, q.k 96, v 64, "
              "causal; bound by bytes), each held at q std 1 and "
              "20, library: SDPA (library_*: which call, or none); "
              "share_of_bound: the largest |kernel - "
              "plain| / (2^-7 "
              "(|plain| + A)); moved_*: share of the outputs the plain "
              "version without that option moves past the bound"))


# ---------------------------------------------------------------------------
# phase 2b: times at the main path's shapes
# ---------------------------------------------------------------------------

def merge_rows(rng, dev, m: int, universe: int, key_cap: int, per_key: int,
               redo: int, tomb: int, new: int, ones: bool = False,
               mk_range=None, key_pad=None):
    """A shuffle-reduce merge's rows as the main paths give it: ``key_cap``
    affected keys (sorted, unique, from [0, universe)) of ``per_key``
    preserved rows each, then a delta of ``redo`` rewrites and ``tomb``
    tombstones of preserved rows and ``new`` rows on affected keys, padded
    to ``m`` rows at k2 = mk = INT32_MAX.  mk (rid * fanout + slot) unique
    in [0, 2^26) for the preserved rows, or drawn from [0, ``mk_range``).
    The keys padded with INT32_MAX to ``key_pad`` slots where given.
    Values of width 1: ones, or uniform in [0, 0.25) float32 (PageRank's
    rank shares).  Returns the six arguments of ``fused_shuffle_reduce``
    and the count of valid rows."""
    import torch
    keys = np.sort(rng.choice(universe, key_cap, replace=False)).astype(
        np.int32)
    pk2 = np.repeat(keys, per_key)
    pmk = rng.choice(2**26, pk2.size, replace=False) if mk_range is None \
        else rng.integers(0, mk_range, pk2.size)
    pick = rng.choice(pk2.size, redo + tomb, replace=False)
    nv = pk2.size + redo + tomb + new
    k2 = np.full(m, INT32_MAX, np.int32)
    k2[:nv] = np.concatenate([pk2, pk2[pick], rng.choice(keys, new)])
    mk = np.full(m, INT32_MAX, np.int32)
    mk[:nv] = np.concatenate([pmk, pmk[pick],
                              rng.integers(0, mk_range or 2**26, new)])
    sign = np.zeros(m, np.int8)
    sign[:nv] = np.concatenate([np.ones(pk2.size + redo), -np.ones(tomb),
                                np.ones(new)])
    vals = (np.ones((m, 1), np.float32) if ones
            else (rng.random((m, 1)) * 0.25).astype(np.float32))
    if key_pad is not None:
        keys = np.concatenate([keys, np.full(key_pad - key_cap, INT32_MAX,
                                             np.int32)])
    t = lambda a: torch.as_tensor(a, device=dev)
    return [t(k2), t(mk), t(vals), t(np.arange(m) < nv), t(sign), t(keys)], nv


def sssp_run_rows(dev, vertices: int):
    """SSSP's run Reduce: (V + 1) * 16 edge rows, half of them padding
    slots, whose id V (= num_state) the kernel drops; D = 1, K = V;
    float32 distances in [0, 30).  Returns seg, vals and the mask of the
    rows in range."""
    import torch
    k = vertices
    n = (vertices + 1) * OUT_SLOTS
    present = torch.rand(n, device=dev) < P_EDGE
    seg = torch.where(present,
                      torch.randint(0, k, (n,), device=dev, dtype=torch.int32),
                      torch.full((n,), k, device=dev, dtype=torch.int32))
    vals = (torch.rand((n, 1), device=dev) * 30).to(torch.float32)
    return seg, vals, present


def sssp_refresh_rows(rng, dev, n: int, k: int):
    """SSSP's refresh Reduce at (N, K = key_cap): the composed merge's rows,
    sorted by key, so the slot ids ascend: 76% of the rows valid, over 73%
    of the slots (~8 rows each), 15% of those not live (id K), the rest
    padding (id K); float32 in [0, 30).  Returns seg, vals and the ids as
    numpy."""
    import torch
    nv = int(n * 0.76)
    ids = np.full(n, k, np.int32)
    ids[:nv] = np.sort(rng.integers(0, int(k * 0.73), nv))
    ids[:nv][rng.random(nv) < 0.15] = k
    vals = torch.as_tensor((rng.random((n, 1)) * 30).astype(np.float32),
                           device=dev)
    return torch.as_tensor(ids, device=dev), vals, ids


def fused_bound(m: int, key_cap: int, nv: int) -> dict:
    """The fused merge's bound at N = m, D = 1: read k2, mk, vals, valid,
    sign and the keys; written k2_s, mk_s, vals_s, perm, live, acc and
    counts; the sort's m log2 m compares, then one value and one count add
    a valid row."""
    read = m * (4 + 4 + 4 + 1 + 1) + key_cap * 4
    written = m * (4 + 4 + 4 + 4 + 1) + key_cap * (4 + 4)
    return bound(read + written, m * math.log2(max(m, 2)) + 2 * nv)


def time_fused(label: str, args, nv: int, dev) -> dict:
    """The fused kernel's time (CUDA events), its plain version's, the port's
    composed path's on the same rows (``ops.shuffle_reduce(..., fused=
    False)``: no one PyTorch call computes this function, so the composed
    path is the yardstick), the bound, and the split of one call by kernel.
    ``args`` are float32 rows of width 1; ``nv`` counts the valid ones."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused import fused_shuffle_reduce
    from repro_torch.kernels.ref import fused_shuffle_reduce_ref
    k2m, mk, vals, valid, sign, keys = args
    m, key_cap = k2m.numel(), keys.numel()
    fn = lambda: fused_shuffle_reduce(*args, out_dtype=torch.float32)
    composed = lambda: ops.shuffle_reduce("sum", k2m, mk, vals, valid, sign,
                                          keys, fused=False)
    res = dict(
        ms=cuda_ms(fn),
        plain_ms=cuda_ms(lambda: fused_shuffle_reduce_ref(
            *args, out_dtype=torch.float32)),
        composed_ms=cuda_ms(composed),
        **fused_bound(m, key_cap, nv))
    log(f"  fused_shuffle_reduce at {label} [N={m} D=1 key_cap={key_cap}, "
        f"{nv} valid rows]: composed path {res['composed_ms']:.3f} ms, bound "
        f"{res['bound_ms']:.4f} ms; kernel "
        + split_line(fn, dev, res["ms"]))
    log(f"    composed path split: " + split_line(composed, dev,
                                                   res["composed_ms"]))
    return res

def time_one_block(dev, rng, vertices: int) -> dict:
    """The fused merge at ONE_BLOCK_SHAPES, float32 rows of width 1 from
    ``merge_rows``, on the route ``SMALL_MAX_ROWS`` picks and, where the
    package exposes both (``fused._fused_cuda``), on each route at the same
    rows.  Each route is held against the plain version (acc within 1e-5
    of the sum of |v|, the rest bit for bit) and timed: events ms (mean of
    20 calls after a warm-up, the wrapper's host work included), device ms
    a call and kernels a call (20 calls under torch.profiler: the union of
    their kernels' intervals, over 20).  Also the plain version's and the
    composed path's events ms and the bound.  Logs each shape beside
    ONE_BLOCK_BEFORE.  Returns {label: {...}}."""
    import torch
    from repro_torch.kernels import fused as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import fused_shuffle_reduce_ref
    names = ("k2", "mk", "vals", "live", "perm", "acc", "counts")
    out = {}
    for (label, m, cap, nkeys, universe, per_key, redo, tomb, new,
         mk_range) in ONE_BLOCK_SHAPES:
        args, nv = merge_rows(rng, dev, m, universe or vertices, nkeys,
                              per_key, redo, tomb, new, mk_range=mk_range,
                              key_pad=cap)
        k2m, mk, vals, valid, sign, keys = args
        want = fused_shuffle_reduce_ref(*args, out_dtype=torch.float32)
        route = "one block" if m <= F.SMALL_MAX_ROWS else "sort + runs"
        routes = {route: lambda: F.fused_shuffle_reduce(
            *args, out_dtype=torch.float32)}
        if hasattr(F, "_fused_cuda"):
            routes = {r: (lambda one: lambda: F._fused_cuda(
                *args, out_dtype=torch.float32, one_block=one))(
                    r == "one block") for r in ("one block", "sort + runs")}
        res = dict(n=m, key_cap=cap, valid_rows=nv, route=route,
                   plain_ms=cuda_ms(lambda: fused_shuffle_reduce_ref(
                       *args, out_dtype=torch.float32), reps=20),
                   composed_ms=cuda_ms(lambda: ops.shuffle_reduce(
                       "sum", k2m, mk, vals, valid, sign, keys, fused=False),
                       reps=20),
                   **fused_bound(m, cap, nv))
        parts = []
        for r, fn in routes.items():
            got = fn()
            for name, g, w in zip(names, got, want):
                if name != "acc":
                    require_equal(f"fused {label} ({r}) {name}", g, w)
            # the values are non-negative: the sums are the sums of |v|
            sum_rel_err(f"fused {label} ({r}) acc", got[5], want[5], want[5])
            p = device_shares(lambda: [fn() for _ in range(20)], dev, top=3)
            res[r] = dict(ms=cuda_ms(fn, reps=20),
                          device_ms=p["busy_ms"] / 20,
                          kernels=p["kernels"] / 20)
            parts.append(f"{r}{' (taken)' if r == route else ''}: events "
                         f"{res[r]['ms']:.4f} ms, device "
                         f"{res[r]['device_ms'] * 1e3:.2f} us and "
                         f"{res[r]['kernels']:g} kernels a call "
                         f"{p['top']}")
        out[label] = res
        log(f"  fused_shuffle_reduce at {label} [N={m} D=1 key_cap={cap}, "
            f"{nv} valid rows]: " + "; ".join(parts) + f"; plain "
            f"{res['plain_ms']:.4f} ms, composed path "
            f"{res['composed_ms']:.4f} ms, bound {res['bound_ms']:.3g} ms "
            f"({res['bound_by']}); the design before: "
            f"{ONE_BLOCK_BEFORE[label]}")
    return out


def time_kernels(dev, rng, n_edges: int, vertices: int) -> dict:
    import torch
    from repro_torch.kernels.fused import fused_shuffle_reduce
    from repro_torch.kernels.ref import (
        fused_shuffle_reduce_ref, segment_minmax_ref, segment_sum_ref,
        sort_lex_ref, spmv_ell_ref,
    )
    from repro_torch.kernels.segment_reduce import segment_minmax, segment_sum
    from repro_torch.kernels.sort_u32 import sort_lex
    from repro_torch.kernels.spmv_ell import spmv_ell
    out = {}

    # shuffle sort of the initial run: k2 = word ids, mk = rid * 64 + slot
    n = n_edges
    hi = torch.randint(0, VOCAB, (n,), device=dev, dtype=torch.int32)
    lo = torch.arange(n, device=dev, dtype=torch.int32)
    got, want = sort_lex(hi, lo), sort_lex_ref(hi, lo)
    err = max(max_abs_err(g, w) for g, w in zip(got, want))
    for part, g, w in zip(("hi", "lo", "perm"), got, want):
        require_equal(f"sort_lex main-path {part}", g, w)
    del got, want
    parts = device_shares(lambda: sort_lex(hi, lo), dev)
    log(f"  sort_lex at N={n}, one call under torch.profiler: device busy "
        f"{parts['busy_ms']:.3f} ms; by kernel (ms, summed over launches: "
        f"one count, then one a pass, the constant digits' passes "
        f"returning at once) {parts['top']}")
    packed = (hi.to(torch.int64) << 32) | (lo.to(torch.int64) + 2**31)
    out["sort_lex"] = dict(
        shape=f"N={n}", max_abs_err=err,
        ms=cuda_ms(lambda: sort_lex(hi, lo)),
        plain_ms=cuda_ms(lambda: sort_lex_ref(hi, lo)),
        library_ms=cuda_ms(lambda: torch.sort(packed, stable=True)),
        # compares: a comparison sort's n log2 n
        **bound(n * (4 + 4) + n * (4 + 4 + 4), n * math.log2(n)))
    del hi, lo, packed

    # Reduce of the initial run: unsorted word ids, D = 1, K = 2^18 + 1
    k = VOCAB + 1
    seg = torch.randint(0, VOCAB, (n,), device=dev, dtype=torch.int32)
    vals = torch.ones((n, 1), device=dev, dtype=torch.float32)
    got = segment_sum(seg, vals, k, counts=True)
    want = segment_sum_ref(seg, vals, k, counts=True)
    require_equal("segment_sum main-path sums", got[0], want[0])
    require_equal("segment_sum main-path counts", got[1], want[1])
    err = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]))
    seg64 = seg.to(torch.int64)

    def library():
        torch.zeros((k, 1), device=dev).index_add_(0, seg64, vals)
        torch.bincount(seg64, minlength=k)

    out["segment_sum"] = dict(
        shape=f"N={n} D=1 K={k} unsorted", max_abs_err=err,
        ms=cuda_ms(lambda: segment_sum(seg, vals, k, counts=True)),
        plain_ms=cuda_ms(lambda: segment_sum_ref(seg, vals, k, counts=True)),
        library_ms=cuda_ms(library),
        # adds: one value and one count per row
        **bound(n * 4 + n * 4 + k * 4 + k * 4, 2 * n))
    parts = device_shares(lambda: segment_sum(seg, vals, k, counts=True), dev)
    log(f"  segment_sum at N={n}, K={k}, one call under torch.profiler: "
        f"device busy {parts['busy_ms']:.3f} ms; by kernel {parts['top']}")
    del seg, vals, seg64, got, want

    # merge of update (a): 2048 affected keys x 256 preserved rows, then
    # 2048 delta rows (tombstones and inserts), padded to 2^20 rows
    m, key_cap = 2**20, 2048
    args, nv = merge_rows(rng, dev, m, VOCAB, key_cap, 256, 0, 1024, 1024,
                          ones=True)
    got = fused_shuffle_reduce(*args, out_dtype=torch.float32)
    want = fused_shuffle_reduce_ref(*args, out_dtype=torch.float32)
    for name, g, w in zip(("k2", "mk", "vals", "live", "perm", "acc",
                           "counts"), got, want):
        require_equal(f"fused main-path {name}", g, w)
    err = max(max_abs_err(g, w) for g, w in zip(got, want))
    out["fused_shuffle_reduce"] = dict(
        shape=f"N={m} D=1 key_cap={key_cap} ({nv} valid rows)",
        max_abs_err=err, library_ms=None,
        **time_fused("wordcount's update (a) merge", args, nv, dev))
    del args, got, want
    torch.cuda.empty_cache()

    # SSSP's run Reduce
    k = vertices
    seg, vals, present = sssp_run_rows(dev, vertices)
    n = seg.numel()
    got = segment_minmax("min", seg, vals, k)
    want = segment_minmax_ref("min", seg, vals, k)
    require_equal("segment_minmax main-path", got, want)
    err = max_abs_err(torch.where(torch.isinf(got), 0.0, got),
                      torch.where(torch.isinf(want), 0.0, want))
    # the library call cannot drop rows: time it on the rows in range
    # (compacted beforehand, untimed)
    live_sid = seg.to(torch.int64)[:, None][present]
    live_vals = vals[present]
    init = torch.full((k, 1), float("inf"), device=dev)
    n_live = int(present.sum())
    out["segment_minmax"] = dict(
        shape=f"N={n} D=1 K={k} ({n_live} rows in range)", max_abs_err=err,
        ms=cuda_ms(lambda: segment_minmax("min", seg, vals, k)),
        plain_ms=cuda_ms(lambda: segment_minmax_ref("min", seg, vals, k)),
        library_ms=cuda_ms(lambda: init.clone().scatter_reduce_(
            0, live_sid, live_vals, "amin")),
        # one compare per row in range
        **bound(n * 4 + n * 4 + k * 4, n_live))
    log(f"  segment_minmax at SSSP's run [N={n} D=1 K={k}, {n_live} rows in "
        f"range]: " + split_line(lambda: segment_minmax("min", seg, vals, k),
                                 dev, out["segment_minmax"]["ms"]))
    del seg, vals, got, want, init, present, live_sid, live_vals

    # SSSP's refresh Reduce at its most frequent launch shape
    # (SSSP_REFRESH_MINMAX)
    rn, rk, _ = SSSP_REFRESH_MINMAX
    seg, vals, ids = sssp_refresh_rows(rng, dev, rn, rk)
    got = segment_minmax("min", seg, vals, rk)
    require_equal("segment_minmax refresh-shape", got,
                  segment_minmax_ref("min", seg, vals, rk))
    live = ids < rk
    live_sid = torch.as_tensor(ids[live].astype(np.int64), device=dev)[:, None]
    live_vals = vals[torch.as_tensor(live, device=dev)]
    init = torch.full((rk, 1), float("inf"), device=dev)
    n_live = int(live.sum())
    fn = lambda: segment_minmax("min", seg, vals, rk)
    refresh = dict(
        ms=cuda_ms(fn),
        plain_ms=cuda_ms(lambda: segment_minmax_ref("min", seg, vals, rk)),
        library_ms=cuda_ms(lambda: init.clone().scatter_reduce_(
            0, live_sid, live_vals, "amin")),
        **bound(rn * 4 + rn * 4 + rk * 4, n_live))
    # the library call's device time: one call under torch.profiler, on a
    # buffer filled beforehand (amin again is the same result)
    buf = init.clone()
    lib = device_shares(lambda: buf.scatter_reduce_(
        0, live_sid, live_vals, "amin"), dev, top=3)
    refresh["library_device_ms"] = lib["busy_ms"]
    out["segment_minmax"].update(
        {f"{name}_refresh": v for name, v in refresh.items()})
    log(f"  segment_minmax at SSSP's refresh [N={rn} D=1 K={rk}, {n_live} rows "
        f"in range, ids ascending]: plain {refresh['plain_ms']:.3f} ms, "
        f"scatter_reduce_ on the rows in range {refresh['library_ms']:.3f} "
        f"ms (one call under torch.profiler: {lib['kernels']} kernels, "
        f"device busy {lib['busy_ms']:.4f} ms; {lib['top']}), bound "
        f"{refresh['bound_ms']:.4f} ms; kernel "
        + split_line(fn, dev, refresh["ms"]))
    del seg, vals, got, init, live_sid, live_vals, buf

    # PageRank's propagation at the same graph: S = V rows of 16 slots
    nbrs = torch.where(torch.rand((k, OUT_SLOTS), device=dev) < P_EDGE,
                       torch.randint(0, k, (k, OUT_SLOTS), device=dev,
                                     dtype=torch.int32),
                       torch.full((k, OUT_SLOTS), -1, device=dev,
                                  dtype=torch.int32))
    deg = (nbrs >= 0).sum(1, keepdim=True).clamp_min(1)
    contrib = (torch.rand((k, 1), device=dev) * 2 / deg).expand(
        k, OUT_SLOTS).contiguous()
    got = spmv_ell(nbrs, contrib, k)
    want = spmv_ell_ref(nbrs, contrib, k)
    err = max_abs_err(got, want)
    sum_rel_err("spmv_ell main-path", got, want,
                spmv_ell_ref(nbrs, contrib.abs(), k))
    flat = nbrs.reshape(-1).to(torch.int64)
    flat_c = contrib.reshape(-1)
    live_sid, live_c = flat[flat >= 0], flat_c[flat >= 0]
    n_live = int((nbrs >= 0).sum())
    out["spmv_ell"] = dict(
        shape=f"S={k} F={OUT_SLOTS} V={k} ({n_live} slots in range)",
        max_abs_err=err,
        ms=cuda_ms(lambda: spmv_ell(nbrs, contrib, k)),
        plain_ms=cuda_ms(lambda: spmv_ell_ref(nbrs, contrib, k)),
        # as for segment_minmax: on the slots in range
        library_ms=cuda_ms(lambda: torch.zeros(k, device=dev).index_add_(
            0, live_sid, live_c)),
        # one add per slot in range
        **bound(k * OUT_SLOTS * (4 + 4) + k * 4, n_live))
    return out


def check_iterative_shapes(dev, rng, vertices: int) -> dict:
    """The slice-1 kernels at the shapes the iterative path gives them,
    against their plain versions: PageRank's Reduce (non-integer float32,
    counts on and off), SSSP's counts-only Reduce, and PageRank's refresh
    merge at the fused path's largest key_cap.  Float sums are held within
    1e-5 of the sum of |v| per output (``sum_rel_err``), everything else
    bit for bit.  Returns segment_sum's times and bounds at the PageRank
    and SSSP shapes (``ms_pagerank``, ``library_ms_pagerank``, ...); the
    fused kernel's are logged."""
    import torch
    from repro_torch.kernels.fused import fused_shuffle_reduce
    from repro_torch.kernels.ref import fused_shuffle_reduce_ref, segment_sum_ref
    from repro_torch.kernels.segment_reduce import segment_sum
    k = vertices

    def edge_ids(n):
        # half the slots are padding, which takes the dropped id V
        present = torch.rand(n, device=dev) < P_EDGE
        return torch.where(present, torch.randint(0, k, (n,), device=dev,
                                                  dtype=torch.int32),
                           torch.full((n,), k, device=dev, dtype=torch.int32))

    # PageRank's Reduce: V * 16 edge rows of rank shares r / deg, D = 1
    n = vertices * OUT_SLOTS
    seg = edge_ids(n)
    vals = torch.rand((n, 1), device=dev) * 2 / 8
    want = segment_sum_ref(seg, vals, k, counts=True)
    scale = segment_sum_ref(seg, vals.abs(), k)
    got = segment_sum(seg, vals, k, counts=True)
    err = sum_rel_err("segment_sum PageRank sums", got[0], want[0], scale)
    require_equal("segment_sum PageRank counts", got[1], want[1])
    err = max(err, sum_rel_err("segment_sum PageRank no counts",
                               segment_sum(seg, vals, k), want[0], scale))
    seg64 = seg.to(torch.int64)
    live = seg64 < k
    lsid, lvals = seg64[live], vals[live]

    def library():
        torch.zeros((k, 1), device=dev).index_add_(0, lsid, lvals)
        torch.bincount(lsid, minlength=k)

    n_live = int(live.sum())
    times = dict(
        ms_pagerank=cuda_ms(lambda: segment_sum(seg, vals, k, counts=True)),
        plain_ms_pagerank=cuda_ms(
            lambda: segment_sum_ref(seg, vals, k, counts=True)),
        library_ms_pagerank=cuda_ms(library),
        # seg and vals read once, sums and counts written once; a value and
        # a count add a row in range
        bound_ms_pagerank=bound(n * 8 + k * 8, 2 * n_live)["bound_ms"])
    parts = device_shares(lambda: segment_sum(seg, vals, k, counts=True),
                          dev)
    log(f"  segment_sum at PageRank's Reduce [N={n} D=1 K={k}, {n_live} rows "
        f"in range, non-integer float32]: relative error {err:.3g} "
        f"(tolerance 1e-5 of sum|v|), counts equal; kernel "
        f"{times['ms_pagerank']:.3f} ms, plain "
        f"{times['plain_ms_pagerank']:.3f} ms, library on the rows in range "
        f"{times['library_ms_pagerank']:.3f} ms, bound "
        f"{times['bound_ms_pagerank']:.3f} ms; one call under torch.profiler:"
        f" device busy {parts['busy_ms']:.3f} ms, by kernel {parts['top']}")
    del seg, vals, want, scale, got, seg64, live, lsid, lvals

    # SSSP's Reduce counts: (V + 1) * 16 edge rows, int32 ones, no sums
    n = (vertices + 1) * OUT_SLOTS
    seg = edge_ids(n)
    ones = torch.ones((n, 1), device=dev, dtype=torch.int32)
    require_equal("segment_sum SSSP counts",
                  segment_sum(seg, ones, k, out_dtype=torch.int32),
                  segment_sum_ref(seg, ones, k, out_dtype=torch.int32))
    n_live = int((seg < k).sum())
    # the library call cannot drop rows: bincount of the ids in range
    # (compacted beforehand, untimed), as segment_minmax's library call
    lsid = seg[seg < k].to(torch.int64)
    times.update(
        ms_sssp_counts=cuda_ms(
            lambda: segment_sum(seg, ones, k, out_dtype=torch.int32)),
        plain_ms_sssp_counts=cuda_ms(
            lambda: segment_sum_ref(seg, ones, k, out_dtype=torch.int32)),
        library_ms_sssp_counts=cuda_ms(
            lambda: torch.bincount(lsid, minlength=k)),
        bound_ms_sssp_counts=bound(n * 8 + k * 4, n_live)["bound_ms"])
    parts = device_shares(
        lambda: segment_sum(seg, ones, k, out_dtype=torch.int32), dev)
    log(f"  segment_sum at SSSP's counts [N={n} D=1 K={k} int32, {n_live} "
        f"rows in range]: equal; kernel {times['ms_sssp_counts']:.3f} ms, "
        f"plain {times['plain_ms_sssp_counts']:.3f} ms, bincount on the ids "
        f"in range {times['library_ms_sssp_counts']:.3f} ms, "
        f"bound {times['bound_ms_sssp_counts']:.3f} ms; profiled: device "
        f"busy {parts['busy_ms']:.3f} ms, by kernel {parts['top']}")
    del seg, ones, lsid
    torch.cuda.empty_cache()

    # PageRank's refresh merge with 4096 affected keys: 8 preserved rank
    # shares each, then the delta of one refresh iteration (8192 shares
    # rewritten, 1024 tombstones, 1024 new edges), padded to 2^16 rows
    m, key_cap = 2**16, 4096
    args, nv = merge_rows(rng, dev, m, vertices, key_cap, 8, 8192, 1024, 1024)
    got = fused_shuffle_reduce(*args, out_dtype=torch.float32)
    want = fused_shuffle_reduce_ref(*args, out_dtype=torch.float32)
    for name, g, w in zip(("k2", "mk", "vals", "live", "perm", "acc",
                           "counts"), got, want):
        if name != "acc":
            require_equal(f"fused PageRank-refresh {name}", g, w)
    abs_args = list(args)
    abs_args[2] = args[2].abs()
    err = sum_rel_err("fused PageRank-refresh acc", got[5], want[5],
                      fused_shuffle_reduce_ref(*abs_args,
                                               out_dtype=torch.float32)[5])
    require_equal("fused PageRank-refresh acc from one call to the next",
                  got[5], fused_shuffle_reduce(*args,
                                               out_dtype=torch.float32)[5])
    log(f"  fused_shuffle_reduce at PageRank's refresh [N={m} D=1 key_cap="
        f"{key_cap}, {nv} valid rows, non-integer float32]: acc relative "
        f"error {err:.3g} (tolerance 1e-5 of sum|v|) and equal from one "
        f"call to the next, the rest equal")
    fused = {f"{n}_pagerank": v for n, v in time_fused(
        "PageRank's refresh", args, nv, dev).items()}

    # the one-block path at the largest of its PageRank-refresh launches:
    # 8 preserved shares a key, 1024 rewritten, 128 tombstones, 128 new
    m, key_cap = PR_REFRESH_ONE_BLOCK
    args, nv = merge_rows(rng, dev, m, vertices, key_cap, 8, 1024, 128, 128)
    got = fused_shuffle_reduce(*args, out_dtype=torch.float32)
    want = fused_shuffle_reduce_ref(*args, out_dtype=torch.float32)
    for name, g, w in zip(("k2", "mk", "vals", "live", "perm"), got, want):
        require_equal(f"fused one-block {name}", g, w)
    require_equal("fused one-block counts", got[6], want[6])
    abs_args = list(args)
    abs_args[2] = args[2].abs()
    sum_rel_err("fused one-block acc", got[5], want[5],
                fused_shuffle_reduce_ref(*abs_args,
                                         out_dtype=torch.float32)[5])
    fused.update({f"{n}_one_block": v for n, v in time_fused(
        "PageRank's refresh, one block", args, nv, dev).items()})
    return times, fused


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def make_deltas(rng, docs: np.ndarray):
    """Update (a): 16 documents rewritten.  Update (b): 0.1% rewritten,
    64 deleted and 64 inserted with record ids past N.  Returns the deltas
    as (record ids, word rows, signs) and the corpus after each."""
    from repro_torch.apps import wordcount as wc
    n = docs.shape[0]
    mut = wc.doc_mutator(VOCAB)
    steps = []
    cur = np.concatenate([docs, np.full((64, DOC_LEN), -1, np.int32)])
    valid = np.concatenate([np.ones(n, bool), np.zeros(64, bool)])

    def rewrite(rows):
        new = mut(rng, rows, {"w": cur[rows]})["w"]
        rid = np.repeat(rows, 2).astype(np.int32)
        words = np.empty((2 * rows.size, DOC_LEN), np.int32)
        words[0::2] = cur[rows]
        words[1::2] = new
        sign = np.tile(np.int8([-1, 1]), rows.size)
        cur[rows] = new
        return rid, words, sign

    rows = rng.choice(n, 16, replace=False)
    steps.append(("update (a): 16 docs rewritten", rewrite(rows),
                  cur.copy(), valid.copy()))

    picked = rng.choice(n, n // 1000 + 64, replace=False)
    rid, words, sign = rewrite(picked[:n // 1000])
    gone = picked[n // 1000:]
    born = np.arange(n, n + 64)
    new = mut(rng, born, {"w": cur[born]})["w"]
    rid = np.concatenate([rid, gone, born]).astype(np.int32)
    words = np.concatenate([words, cur[gone], new])
    sign = np.concatenate([sign, -np.ones(64, np.int8), np.ones(64, np.int8)])
    valid[gone] = False
    valid[born] = True
    cur[born] = new
    steps.append((f"update (b): {n // 1000} docs rewritten, 64 deleted, "
                  f"64 inserted", (rid, words, sign), cur.copy(),
                  valid.copy()))
    return steps


def shapes_line() -> str:
    """The launches by shape of the kernels that keep them, since the last
    reset: segment_minmax by (N, K, D), fused_shuffle_reduce by (N,
    key_cap, D, path)."""
    from repro_torch.kernels import launch_shapes
    return "; ".join(f"{name} {dict(sorted(sh.items()))}"
                     for name, sh in launch_shapes().items() if sh) or "none"


def drive_path(path: str, docs: np.ndarray, steps, keep=None,
               seconds=None) -> dict:
    """Wordcount's Session on ``path``: run, then ``steps``, each checked
    against np.bincount; ``keep`` (a list) receives each step's result and
    ``seconds`` (a list) each step's wall seconds."""
    import torch
    from repro_torch.api import RunConfig, Session, make_delta
    from repro_torch.apps import wordcount as wc
    from repro_torch.kernels import launch_counts, reset_launch_counts

    def check(sess, cur, valid, label):
        want = np.bincount(cur[valid].ravel(), minlength=VOCAB)
        got = sess.result["c"]
        if got.shape != (VOCAB,) or not np.isfinite(got).all() \
                or not np.array_equal(got, want.astype(got.dtype)):
            bad = int(np.sum(got != want))
            raise AssertionError(f"{path} {label}: result differs from "
                                 f"np.bincount at {bad} keys")

    spec, data = wc.make_job(docs, VOCAB)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    sess = Session(spec, RunConfig(onestep_path=path))
    rep = sess.run(data)
    check(sess, docs, np.ones(docs.shape[0], bool), "run")
    if keep is not None:
        keep.append(sess.result["c"].copy())
    if seconds is not None:
        seconds.append(time.perf_counter() - t0)
    log(f"  [{path}] run: {time.perf_counter() - t0:.3f} s, "
        f"{docs.size} edges, mode {rep.mode}, launches {launch_counts()}; "
        f"shapes {shapes_line()}")
    for label, (rid, words, sign), cur, valid in steps:
        t0 = time.perf_counter()
        rep = sess.update(make_delta(rid, {"w": words}, sign))
        dt = time.perf_counter() - t0
        check(sess, cur, valid, label)
        if keep is not None:
            keep.append(sess.result["c"].copy())
        if seconds is not None:
            seconds.append(dt)
        log(f"  [{path}] {label}: {dt:.3f} s, {int((words >= 0).sum())} "
            f"delta edges, affected keys {rep.affected_keys}, mode "
            f"{rep.mode}, launches {launch_counts()}; shapes {shapes_line()}")
    counts = launch_counts()
    log(f"  [{path}] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del sess, data
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 4: the iterative path (PageRank, SSSP)
# ---------------------------------------------------------------------------

def pagerank_fixpoint(nbrs: np.ndarray, r0=None, tol: float = 1e-8,
                      max_iters: int = 1000, dev=None):
    """float64 power iteration of PageRank's semantics until the largest
    change is below ``tol``: on ``dev``'s card where it is one (one
    ``index_add_`` an iteration: at 2^22 vertices about 100 iterations of
    33.5M edges, a second where ``np.bincount`` on the host takes 45), else
    one ``np.bincount`` an iteration.  Independent of the port's engine
    either way.  Returns the ranks (numpy) and that last change."""
    from repro_torch.apps.pagerank import DAMPING
    v, f = nbrs.shape
    ok = nbrs >= 0
    deg = np.maximum(ok.sum(axis=1), 1)
    src = np.nonzero(ok)[0]
    dst = nbrs[ok]
    share = 1.0 / deg[src]
    r = np.ones(v) if r0 is None else np.array(r0, np.float64)
    if dev is not None and dev.type == "cuda":
        import torch
        src_t, dst_t = (torch.from_numpy(a.astype(np.int64)).to(dev)
                        for a in (src, dst))
        share_t = torch.from_numpy(share).to(dev)
        r_t = torch.from_numpy(r).to(dev)
        for _ in range(max_iters):
            new = torch.zeros_like(r_t).index_add_(
                0, dst_t, r_t[src_t] * share_t) * DAMPING + (1 - DAMPING)
            change = float((new - r_t).abs().max())
            r_t = new
            if change < tol:
                out = r_t.cpu().numpy()
                del src_t, dst_t, share_t, r_t, new
                release(dev)
                return out, change
    else:
        for _ in range(max_iters):
            new = DAMPING * np.bincount(dst, weights=r[src] * share,
                                        minlength=v) + (1 - DAMPING)
            change = float(np.abs(new - r).max())
            r = new
            if change < tol:
                return r, change
    raise AssertionError(f"PageRank oracle did not reach {tol} in "
                         f"{max_iters} iterations")


def pagerank_bound(v: int, held: float, oracle_change: float) -> float:
    """L1 distance allowed between the engine's ranks and the fixpoint.

    PageRank's map r -> d A r + (1 - d) contracts the L1 norm by d (A is
    column-stochastic).  If the ranks the engine's preserved edges were
    computed from differ from its final ranks by delta, the final ranks
    satisfy r = d A (r - delta) + (1 - d), so |r - r*|_1 <= d/(1-d)
    |delta|_1; ``held`` bounds |delta|_1.  The oracle is off its own
    fixpoint by at most d/(1-d) V ``oracle_change``.  float32 rounding adds
    at most (F + 2) roundings of 2^-24 of each rank per iteration, which
    the same contraction amplifies by 1/(1-d): V (F + 2) 2^-24 / (1-d) for
    ranks averaging 1.
    """
    from repro_torch.apps.pagerank import DAMPING as d
    return (d / (1 - d) * (held + v * oracle_change)
            + v * (OUT_SLOTS + 2) * 2.0**-24 / (1 - d))


def rewire_delta(rng, nbrs: np.ndarray, frac: float):
    """PageRank's update: ``frac`` of the vertices get new out-edges
    (``pagerank.graph_mutator``).  Returns the delta's arrays and the graph
    after it."""
    from repro_torch.apps import pagerank
    v = nbrs.shape[0]
    rows = np.sort(rng.choice(v, max(int(v * frac), 1), replace=False))
    new = pagerank.graph_mutator(v, P_EDGE)(rng, rows,
                                            {"nbrs": nbrs[rows]})["nbrs"]
    nb = np.empty((2 * rows.size, nbrs.shape[1]), np.int32)
    nb[0::2], nb[1::2] = nbrs[rows], new
    after = nbrs.copy()
    after[rows] = new
    return (np.repeat(rows, 2).astype(np.int32), {"nbrs": nb},
            np.tile(np.int8([-1, 1]), rows.size)), after


def drive_pagerank(dev, rng, vertices: int, keep=None) -> dict:
    """PageRank's run and 0.1% rewire; ``keep`` (a dict) receives the
    run's and the update's wall seconds."""
    import torch
    from repro_torch.api import RunConfig, Session, make_delta
    from repro_torch.apps import pagerank
    from repro_torch.kernels import launch_counts, reset_launch_counts
    nbrs = pagerank.random_graph(vertices, OUT_SLOTS, seed=int(rng.integers(
        2**31)), p_edge=P_EDGE)
    spec, data = pagerank.make_job(nbrs)
    cfg = RunConfig(device=dev.type, cpc_threshold=PR_CPC)
    log(f"  [pagerank] {vertices} vertices, {int((nbrs >= 0).sum())} edges, "
        f"tol {cfg.tol}, cpc_threshold {cfg.cpc_threshold}")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    sess = Session(spec, cfg)
    rep = sess.run(data)
    t_run = time.perf_counter() - t0
    ref, ch = pagerank_fixpoint(nbrs, dev=dev)
    err = float(np.abs(sess.result["r"].astype(np.float64) - ref).sum())
    # the preserved edges hold the ranks of the second-to-last iteration:
    # off the final ranks by at most the last change, at every vertex
    run_change = rep.max_change[-1]
    lim = pagerank_bound(vertices, vertices * run_change, ch)
    log(f"  [pagerank] run: {t_run:.3f} s, mode {rep.mode}, {rep.iters} "
        f"iterations, last change {run_change:.3g}; L1 error "
        f"{err:.6g} <= bound {lim:.6g}; launches {launch_counts()}; shapes "
        f"{shapes_line()}")
    if not (np.isfinite(sess.result["r"]).all() and err <= lim):
        raise AssertionError(f"pagerank run: L1 error {err} > {lim}")

    (rid, vals, sign), after = rewire_delta(rng, nbrs, 0.001)
    t0 = time.perf_counter()
    rep = sess.update(make_delta(rid, vals, sign))
    t_upd = time.perf_counter() - t0
    ref2, ch2 = pagerank_fixpoint(after, r0=ref, dev=dev)
    err = float(np.abs(sess.result["r"].astype(np.float64) - ref2).sum())
    # what a refresh that left the run's ranks in place would score
    stale = float(np.abs(ref - ref2).sum())
    if rep.mode == "i2":
        # a vertex the refresh never touched still holds the run's last
        # change; a touched one at most the CPC threshold it held back,
        # plus the change of an emission the refresh stopped before
        # propagating (< refresh tol: the loop ended before max_iters).
        # Bounded per vertex, so by no count the engine reports.
        if rep.iters >= cfg.refresh_iters_:
            raise AssertionError("pagerank refresh hit max_iters")
        held = vertices * max(run_change,
                              cfg.cpc_threshold + cfg.refresh_tol_)
    else:
        held = vertices * cfg.refresh_tol_
    lim = pagerank_bound(vertices, held, ch2)
    if keep is not None:
        keep.update(run_s=t_run, update_s=t_upd, vertices=vertices)
    log(f"  [pagerank] update ({rid.size // 2} vertices rewired): "
        f"{t_upd:.3f} s, mode {rep.mode}, {rep.iters} iterations, "
        f"L1 error {err:.6g} <= bound {lim:.6g} and < stale error "
        f"{stale:.6g} / 10")
    for l in rep.logs:
        log(f"    {l}")
    if not (np.isfinite(sess.result["r"]).all() and err <= lim):
        raise AssertionError(f"pagerank update: L1 error {err} > {lim}")
    if not err < stale / 10:
        raise AssertionError(f"pagerank update: L1 error {err} is not "
                             f"below a tenth of the stale ranks' {stale}")
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" \
        else float("nan")
    log(f"  [pagerank] launches {counts}; shapes {shapes_line()}; peak "
        f"device memory {peak:.2f} GiB")
    for name in ("sort_lex", "segment_sum"):
        if dev.type == "cuda" and counts[name] == 0:
            raise AssertionError(f"pagerank path launched no {name}")
    del sess, data
    release(dev)
    return counts


def dijkstra(nbrs: np.ndarray, w: np.ndarray, src: int) -> np.ndarray:
    """scipy's Dijkstra on the same directed graph (parallel edges keep
    their lightest weight; the sparse matrix would sum them)."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra as sp_dijkstra
    v = nbrs.shape[0]
    i, f = np.nonzero(nbrs >= 0)
    key = i.astype(np.int64) * v + nbrs[i, f]
    ww = w[i, f].astype(np.float64)
    order = np.lexsort((ww, key))
    key, ww = key[order], ww[order]
    first = np.r_[True, key[1:] != key[:-1]]
    g = csr_matrix((ww[first], (key[first] // v, key[first] % v)),
                   shape=(v, v))
    return sp_dijkstra(g, directed=True, indices=src)


def check_sssp(label: str, d: np.ndarray, want: np.ndarray) -> None:
    """float32 path sums within 1e-5 relative where Dijkstra reaches; at
    least INF / 2 (unreachable) exactly where it gives inf."""
    from repro_torch.apps.sssp import INF
    reach = np.isfinite(want)
    got = d.astype(np.float64)
    bad_far = int(np.sum(~reach & (got < INF / 2)))
    rel = np.abs(got[reach] - want[reach]) / np.maximum(want[reach], 1e-30)
    worst = float(rel.max()) if rel.size else 0.0
    log(f"  [sssp] {label}: {int(reach.sum())} reachable, max relative "
        f"error {worst:.3g} (tolerance 1e-5), {bad_far} unreachable "
        f"vertices below INF/2")
    if bad_far or worst > 1e-5 or not np.all(got[reach] < INF / 2):
        raise AssertionError(f"sssp {label}: disagrees with dijkstra")


class DijkstraBeside:
    """scipy's Dijkstra of each given graph ``(nbrs, w, src)``, each in a
    process of its own (spawned: no CUDA state, no share of this process's
    GIL) at niceness ``DRYRUN_NICE``, as the dry-run's, so that phase 4's
    oracles (about 35 s each at 2^22 vertices) run beside the phases after
    it and yield the host's cores to them: ``join`` waits for them, stops
    the processes and returns the distances, raising what one raised."""

    def __init__(self, graphs):
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        self.t0 = time.perf_counter()
        self.pool = ProcessPoolExecutor(
            len(graphs), mp_context=multiprocessing.get_context("spawn"),
            initializer=os.nice, initargs=(DRYRUN_NICE,))
        atexit.register(self.pool.shutdown, wait=False, cancel_futures=True)
        self.futures = [self.pool.submit(dijkstra, *g) for g in graphs]

    def join(self) -> list:
        try:
            return [f.result() for f in self.futures]
        finally:
            self.pool.shutdown()


def drive_sssp(dev, rng, vertices: int, keep=None, defer: bool = False
               ) -> dict:
    """SSSP's run and deletion update, each checked against Dijkstra;
    ``keep`` (a dict) receives the graph, the delta, both results, both
    Dijkstra distances and both wall seconds (phase 9 replays them).
    The two Dijkstras run in processes of their own from the update on
    (``DijkstraBeside``); ``defer``: they run on beside what follows, and
    ``sssp_oracle_check(keep)`` checks them later."""
    import torch
    from repro_torch.api import RunConfig, Session, make_delta
    from repro_torch.apps import sssp
    from repro_torch.kernels import launch_counts, reset_launch_counts
    keep = {} if keep is None else keep
    nbrs, w = sssp.random_weighted_graph(vertices, OUT_SLOTS,
                                         seed=int(rng.integers(2**31)),
                                         p_edge=P_EDGE)
    spec, data = sssp.make_job(nbrs, w, src=0)
    log(f"  [sssp] {vertices} vertices, {int((nbrs >= 0).sum())} edges, "
        f"source 0")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    sess = Session(spec, RunConfig(device=dev.type))
    rep = sess.run(data)
    t_run = time.perf_counter() - t0
    log(f"  [sssp] run: {t_run:.3f} s, mode {rep.mode}, {rep.iters} "
        f"iterations; launches {launch_counts()}; shapes {shapes_line()}")
    keep.update(nbrs=nbrs.copy(), w=w, run=sess.result["d"].copy(),
                run_s=t_run)

    # the update of benchmarks/fig8_overall.py: 30% of the slots of 0.1%
    # of the rows deleted
    rows = np.sort(rng.choice(vertices, max(vertices // 1000, 1),
                              replace=False))
    new = nbrs[rows].copy()
    new[rng.random(new.shape) < 0.3] = -1
    nb = np.empty((2 * rows.size, OUT_SLOTS), np.int32)
    nb[0::2], nb[1::2] = nbrs[rows], new
    delta = (np.repeat(rows + 1, 2).astype(np.int32),
             {"nbrs": nb, "w": np.repeat(w[rows], 2, axis=0)},
             np.tile(np.int8([-1, 1]), rows.size))
    after = nbrs.copy()
    after[rows] = new
    keep["oracle"] = DijkstraBeside([(keep["nbrs"], w, 0), (after, w, 0)])
    t0 = time.perf_counter()
    rep = sess.update(make_delta(*delta))
    t_upd = time.perf_counter() - t0
    log(f"  [sssp] update ({rows.size} rows, 30% of slots deleted): "
        f"{t_upd:.3f} s, mode {rep.mode}, {rep.iters} iterations")
    for l in rep.logs:
        log(f"    {l}")
    if rep.mode != "i2":
        raise AssertionError(f"sssp update ran in mode {rep.mode}, not i2")
    keep.update(delta=delta, rows=rows, update=sess.result["d"].copy(),
                update_s=t_upd)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" \
        else float("nan")
    log(f"  [sssp] launches {counts}; shapes {shapes_line()}; peak device "
        f"memory {peak:.2f} GiB")
    if dev.type == "cuda" and counts["segment_minmax"] == 0:
        raise AssertionError("sssp path launched no segment_minmax")
    del sess, data
    release(dev)
    if not defer:
        sssp_oracle_check(keep)
    return counts


def sssp_oracle_check(keep: dict) -> None:
    """``drive_sssp``'s run and update against their Dijkstras (waited
    for); the distances go into ``keep`` (``dij_run``, ``dij_update``)."""
    oracle = keep.pop("oracle")
    dij_run, dij_update = oracle.join()
    log(f"  [sssp] Dijkstra of the run's and the update's graphs: "
        f"{time.perf_counter() - oracle.t0:.1f} s after they started")
    check_sssp("run", keep["run"], dij_run)
    check_sssp("update", keep["update"], dij_update)
    keep.update(dij_run=dij_run, dij_update=dij_update)


# ---------------------------------------------------------------------------
# phase 5: LM serving (Gemma 2 9B at full width)
# ---------------------------------------------------------------------------

def parity_model(cfg, gen, dev):
    """Random weights at 1/sqrt(input width) for the parity checks.  The
    reference's draw (``init_params``) scales body matrices by
    1/sqrt(cycles), its stacked axis read as fan-in; at full width that
    saturates the attention softcap and makes the random network chaotic,
    so that any two orders of rounding part ways (see PERF.md).  The input
    width of a matrix is ``launch.ranks.parity_fan_in``'s, which
    ``draw_dense`` reads too (sLSTM's ``r_gates`` by its last axis: the
    first, 4, would drive the recurrence to saturation).  Prefix
    and remainder blocks likewise (the reference draws them at their
    first axis, which is their input width but for ``wo``: DeepSeek-V3's
    MLA prefix layers would add attention outputs sqrt(128) times too
    large, nearly alike for every token of a long prefill, and its router
    would send most tokens to the same experts).  Embedding and norms as
    the reference.  The experts' leaves are drawn an expert at a time into
    the model's dtype (a float32 draw of DeepSeek-V3's [256, 7168, 4096]
    at once would take 30 GB beside the model); every other leaf as
    ``tree_init`` draws it, in plan order."""
    import torch
    from repro_torch.launch.ranks import parity_fan_in
    from repro_torch.models import lm
    from repro_torch.models.common import tree_init
    dtype = cfg.dtype("param")
    tensors = {}
    for name, spec in lm.plan_model(cfg).items():
        experts = ".moe.w_" in name
        if spec.init == "normal" and len(spec.shape) > 1:
            spec = spec._replace(fan_in=parity_fan_in(name, spec.shape))
        if experts and spec.init == "normal":
            t = torch.empty(spec.shape, dtype=dtype, device=dev)
            for e in range(spec.shape[0]):
                t[e] = torch.randn(spec.shape[1:], generator=gen,
                                   device=gen.device).mul_(
                    1.0 / math.sqrt(spec.fan_in or spec.shape[0]))
            tensors[name] = t
        else:
            tensors.update(tree_init({name: spec}, gen, dtype, dev))
    return lm.LM(cfg, tensors)


def decode_vs_prefill(cfg, model, toks, dev) -> float:
    """Largest gap between the per-step decode logits (the cache path, plain
    decode attention) and the teacher-forced logits of one cache-less
    forward over the same tokens (the flash kernel), over the largest
    |logit|; the forward's logits get the logit softcap here, which
    ``serve_step`` applies and the prefill step does not."""
    import torch
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import lm
    from repro_torch.models.common import softcap
    b, s = toks.shape
    with torch.inference_mode():
        hidden, _ = lm.forward(cfg, model, toks)
        full = softcap(lm.logits_fn(cfg, model, hidden).float(),
                       cfg.logit_softcap)
    serve = make_serve_step(cfg, dev)
    caches = lm.init_caches(cfg, b, s, device=dev)
    scale = max(1.0, float(full.abs().max()))
    worst = 0.0
    for t in range(s):
        logits, caches = serve(model, caches, toks[:, t:t + 1])
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{cfg.name}: decode step {t} not finite")
        worst = max(worst, float((logits - full[:, t]).abs().max()) / scale)
    return worst


MATMUL_KERNELS = re.compile(r"gemm|gemv|xmma|nvjet|cutlass|cublas|splitk",
                            re.IGNORECASE)


def device_shares(fn, dev, top: int = 5) -> dict:
    """Runs ``fn`` once under ``torch.profiler`` (device activity only)
    and splits the device time of its kernels into the flash kernel,
    matrix products (cuBLAS's and CUTLASS's kernels) and the rest
    (elementwise passes, reductions, copies, memsets).  ``busy_ms`` is the
    union of the kernels' intervals, ``wall_ms`` the host clock of the
    profiled call (which the profiler slows); ``top`` the ``top`` kernels
    that took the most device time.  The profiler's raw events are read
    (``kineto_results``), not its Python event tree, whose build takes
    tens of seconds for the ~10^5 kernels of a serving sweep.  A short
    spin kernel runs first in the window and is left out: in a process
    that has profiled before, the profiler can drop the window's first
    device event (one call of a one-kernel path then read as 0 kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    sync(dev)
    acts = [ProfilerActivity.CUDA if dev.type == "cuda"
            else ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        if dev.type == "cuda":
            torch.cuda._sleep(1000)
            sync(dev)
        t0 = time.perf_counter()
        fn()
        sync(dev)
        wall = time.perf_counter() - t0
    ms = {"flash": 0.0, "matmul": 0.0, "other": 0.0}
    spans, by_name = [], {}
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda or "spin_kernel" in e.name():
            continue
        lo = e.start_ns()
        hi = lo + e.duration_ns()
        name = e.name()
        spans.append((lo, hi))
        kind = "flash" if "flash" in name else \
            "matmul" if MATMUL_KERNELS.search(name) else "other"
        ms[kind] += (hi - lo) / 1e6
        by_name[name] = by_name.get(name, 0.0) + (hi - lo) / 1e6
    busy, end = 0.0, -math.inf
    for lo, hi in sorted(spans):
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return dict(kernels=len(spans), busy_ms=busy / 1e6, wall_ms=wall * 1e3,
                top=[(n[:60], round(t, 3)) for n, t in ranked], **ms)


def split_line(fn, dev, ms: float) -> str:
    """The device-side split of one call of ``fn`` (``device_shares``)
    beside ``ms``, its time by CUDA events: kernels launched, device busy
    ms, the profiled call's host-clock ms, and the time of each kernel."""
    p = device_shares(fn, dev, top=10)
    return (f"events {ms:.3f} ms; one call under torch.profiler: "
            f"{p['kernels']} kernels, device busy {p['busy_ms']:.3f} ms, "
            f"host clock {p['wall_ms']:.3f} ms; by kernel {p['top']}")


def log_shares(label: str, p: dict, wall_ms: float) -> None:
    """One line of a profile: device time by kind as shares of the busy
    time, and the device's idle share of the unprofiled host-clock time
    ``wall_ms`` of the same work (and of the profiled one)."""
    if not p["kernels"]:
        log(f"  [lm] profile, {label}: the profiler saw no device kernels; "
            f"shares not measured")
        return
    busy = p["busy_ms"]
    log(f"  [lm] profile, {label}: {p['kernels']} kernels, device busy "
        f"{p['busy_ms']:.3f} ms: flash {p['flash']:.3f} ms "
        f"({p['flash'] / busy:.1%}), matmul {p['matmul']:.3f} ms "
        f"({p['matmul'] / busy:.1%}), other {p['other']:.3f} ms "
        f"({p['other'] / busy:.1%}); device idle {1 - p['busy_ms'] / wall_ms:.1%}"
        f" of the unprofiled {wall_ms:.3f} ms ({1 - p['busy_ms'] / p['wall_ms']:.1%}"
        f" of the profiled {p['wall_ms']:.3f} ms); top {p['top']}")


def drive_lm(dev, seed: int) -> dict:
    import torch
    import repro_torch.configs as C
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import lm
    cfg = C.get(LM_ARCH)
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    model = lm.init_params(cfg, gen, device=dev)
    sync(dev)
    n_params = lm.count_params(model)
    log(f"  [lm] {cfg.name}: {n_params} parameters ({cfg.n_layers} layers "
        f"{cfg.layer_kinds[:2]} x {cfg.cycles}, d {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads} x {cfg.head_dim}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab}), {cfg.param_dtype}, drawn in "
        f"{time.perf_counter() - t0:.3f} s; {memory_gib(dev):.2f} GiB")
    if n_params != LM_PARAMS:
        raise AssertionError(f"{cfg.name}: {n_params} parameters, not the "
                             f"published {LM_PARAMS}")

    # the main path: prefill, then decode
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    prefill = make_prefill_step(cfg, dev)
    toks = torch.randint(0, cfg.vocab, (PREFILL_BATCH, PREFILL_LEN),
                         generator=gen, device=dev, dtype=torch.int32)
    secs = []
    for _ in range(PREFILL_CALLS):
        t0 = time.perf_counter()
        logits = prefill(model, {"inputs": toks})
        sync(dev)
        secs.append(time.perf_counter() - t0)
        if tuple(logits.shape) != (PREFILL_BATCH, 1, cfg.vocab) \
                or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"prefill logits {tuple(logits.shape)}: "
                                 f"not [{PREFILL_BATCH}, 1, {cfg.vocab}] "
                                 f"finite values")
    peak = memory_gib(dev, peak=True)
    tokens = PREFILL_BATCH * PREFILL_LEN
    prof = device_shares(lambda: prefill(model, {"inputs": toks}), dev)
    n_flash = launch_counts()["flash_attention"]
    log(f"  [lm] prefill {PREFILL_BATCH} x {PREFILL_LEN} tokens: "
        + ", ".join(f"{t:.3f} s ({tokens / t:.0f} tokens/s)" for t in secs)
        + f"; flash launches {n_flash} (one more call profiled); peak "
        f"device memory {peak:.2f} GiB")
    log_shares("one prefill", prof, secs[-1] * 1e3)
    if dev.type == "cuda" and n_flash != cfg.n_layers * (PREFILL_CALLS + 1):
        raise AssertionError(f"prefill launched the flash kernel {n_flash} "
                             f"times, not {cfg.n_layers} x "
                             f"{PREFILL_CALLS + 1}")
    del logits
    release(dev)

    serve = make_serve_step(cfg, dev)
    caches = lm.init_caches(cfg, DECODE_BATCH,
                            PROMPT_LEN + GEN_LEN + PROFILE_STEPS, device=dev)
    prompts = torch.randint(0, cfg.vocab, (DECODE_BATCH, PROMPT_LEN),
                            generator=gen, device=dev, dtype=torch.int32)
    t0 = time.perf_counter()
    for t in range(PROMPT_LEN):
        logits, caches = serve(model, caches, prompts[:, t:t + 1])
    sync(dev)
    t_prompt = time.perf_counter() - t0
    step_secs, out = [], []
    tok = logits.argmax(-1, keepdim=True).to(torch.int32)
    for _ in range(GEN_LEN):
        out.append(tok)
        t0 = time.perf_counter()
        logits, caches = serve(model, caches, tok)
        tok = logits.argmax(-1, keepdim=True).to(torch.int32)
        sync(dev)
        step_secs.append(time.perf_counter() - t0)
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("decode logits not finite")
    gen_toks = torch.cat(out, dim=1).cpu().numpy()
    steps = np.array(step_secs)
    LM_TIMES.update(prefill_s=[round(t, 4) for t in secs],
                    decode_ms=round(float(np.median(steps)) * 1e3, 2))
    log(f"  [lm] decode {DECODE_BATCH} requests: prompt of {PROMPT_LEN} "
        f"tokens stepped in {t_prompt:.3f} s, {GEN_LEN} greedy steps: "
        f"median {np.median(steps) * 1e3:.2f} ms a step (min "
        f"{steps.min() * 1e3:.2f}, max {steps.max() * 1e3:.2f}), "
        f"{DECODE_BATCH / np.median(steps):.1f} tokens/s; cache at "
        f"position {int(caches['pos'])}; first request's tokens "
        f"{gen_toks[0, :8].tolist()}...")
    if int(caches["pos"]) != PROMPT_LEN + GEN_LEN or gen_toks.shape != (
            DECODE_BATCH, GEN_LEN) or gen_toks.min() < 0 \
            or gen_toks.max() >= cfg.vocab:
        raise AssertionError("decode produced no valid tokens")

    def decode_steps():
        nonlocal caches, tok
        for _ in range(PROFILE_STEPS):
            logits, caches = serve(model, caches, tok)
            tok = logits.argmax(-1, keepdim=True).to(torch.int32)
    log_shares(f"{PROFILE_STEPS} decode steps",
               device_shares(decode_steps, dev),
               np.median(steps) * 1e3 * PROFILE_STEPS)
    counts = launch_counts()
    log(f"  [lm] launches {counts}")
    del model, caches, logits
    release(dev)

    # the two paths against each other, on weights at 1/sqrt(input width)
    ptoks = torch.randint(0, cfg.vocab, (PARITY_BATCH, PARITY_LEN),
                          generator=gen, device=dev, dtype=torch.int32)
    cfg32 = cfg.replace(n_layers=PARITY_F32_LAYERS, param_dtype="float32",
                        compute_dtype="float32")
    for pcfg, tol, label in (
            (cfg32, PARITY_TOL["float32"],
             f"float32, {PARITY_F32_LAYERS} layers at full width"),
            (cfg, PARITY_TOL["bfloat16"], f"bf16, {cfg.n_layers} layers")):
        model = parity_model(pcfg, gen, dev)
        err = decode_vs_prefill(pcfg, model, ptoks, dev)
        log(f"  [lm] decode vs prefill over {PARITY_BATCH} x {PARITY_LEN} "
            f"tokens, {label}: max |gap| / max |logit| {err:.3g} "
            f"(bound {tol})")
        if not err <= tol:
            raise AssertionError(f"decode vs prefill ({label}): {err} > "
                                 f"{tol}")
        del model
        release(dev)
    return counts


# ---------------------------------------------------------------------------
# phase 10: LM training (attention gradient, steps against the CPU, Qwen3-1.7B
# at full width, restart)
# ---------------------------------------------------------------------------

# (a) the attention gradient (``blocks.FlashAttend``: flash forward, the
# dense formula's autograd backward) on the card against the CPU, float32
# (the flash kernel's FMA path, TF32 off), B 1, H 16, KH 8, S 512; q at std
# 8, k and v at 1, so that the scores reach Gemma 2's softcap.  Gemma 2's
# window (4096) is cut to 128 so that it acts within 512 positions.  The
# gradient does not read the forward's output: both sides run the same
# formula, float32 products summed in another order (cuBLAS, the CPU's
# BLAS), gaps near 1e-6 of the largest gradient; the bound allows 100x.
GRAD_CASES = (("gemma2 global, softcap 50, hd 256", "gemma2_9b", 0),
              ("gemma2 window 128, softcap 50, hd 256", "gemma2_9b", 128),
              ("qwen3 hd 128", "qwen3_1_7b", 0))
GRAD_SHAPE = (1, 512)                 # B, S
GRAD_Q_STD = 8.0
GRAD_REL = 1e-4
# (b) train steps on the card against the CPU: smoke configs in float32,
# remat full, loss_chunk 16 of S 64, B 2, 3 steps of AdamW at lr 3e-4 from
# step 1.  The losses within 1e-5 and the grad norm within 1e-5 of itself
# (tests/test_torch_train.py's train-step bounds; measured under 1e-6).
# The parameters within a tenth of one step, lr / 10: AdamW scales each
# element's step to about lr whatever its gradient's size, so an element
# whose gradient sits near the rounding floor of its sum steps a little
# differently on two devices (measured 9.6e-6 for Gemma 2, NVIDIA H100
# 80GB HBM3, 700 W); the losses of steps 2 and 3 read the updated
# parameters, and a wrong update moves them far past 1e-5.
STEP_SHAPE, STEP_CHUNK, STEP_COUNT = (2, 64), 16, 3
STEP_OPT = dict(lr=3e-4, warmup=1, total_steps=10)
STEP_TOL = 1e-5
STEP_PARAM_TOL = STEP_OPT["lr"] / 10
# Phase 16 (b): at --preset 100m (vocab 32,768, d 768) enough elements sit
# at that floor that some step opposite ways on two summation orders of
# one device: two CPU runs of DeepSeek-V3's 3 steps, 1 and 7 BLAS threads,
# part by 2.3e-4 (Llama 4 Scout's by 7.9e-5: its top-1 gate is p / p = 1,
# so its router's whole gradient is rounding; tools/train_probes.py
# spread).  There an element is
# undecided where the CPU's gradient in some step is within STEP_TOL of
# its leaf's largest (the grad norm's own bound), or its whole leaf is
# below STEP_ZERO_LEAF of the model's largest gradient: its Adam step's
# sign is rounding's.  Decided elements are held to STEP_PARAM_TOL
# (measured 1.6e-5 and 2.4e-6 between those CPU runs), undecided ones to
# two steps of lr a step, the most two runs of Adam can part.
STEP_ZERO_LEAF = 1e-7
# (c) Qwen3-1.7B at full width (configs/qwen3_1_7b.py), bf16, remat full,
# loss_chunk 512, B 2 x S 4096 (8,192 tokens a step): 1 warm-up step, 4
# timed, 1 profiled
TRAIN_ARCH = "qwen3_1_7b"
TRAIN_PARAMS = 1_720_574_976
TRAIN_BATCH, TRAIN_LEN = 2, 4096
TRAIN_WARMUP, TRAIN_TIMED = 1, 4
# (d) restart at --preset 100m (launch/train.py's default batch and
# length): 6 steps uninterrupted, then failed before step 3 with a
# checkpoint every 2 steps, then resumed; the resumed losses (steps 2-5)
# must equal the uninterrupted ones bit for bit
RESTART = dict(steps=6, global_batch=8, seq_len=256, log_every=1)
RESTART_FAIL_AT, RESTART_EVERY = 3, 2


def attn_grad_check(dev, rng, tag: str, label: str, cfg, h: int, kh: int,
                    hd: int, vd: int, window: int = 0) -> float:
    """q [B, S, h, hd], k [B, S, kh, hd], v [B, S, kh, vd] gradients through
    ``blocks.attend`` (``cfg``'s mask and softcap) on the card and on the
    CPU, within ``GRAD_REL`` of each one's largest value on the CPU; flash
    launches rise by one a forward on the card.  Returns the largest of
    the three errors."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import blocks
    b, s = GRAD_SHAPE
    host = [torch.from_numpy(rng.normal(0, std, (b, s, n, d)).astype(
        np.float32)) for std, n, d in ((GRAD_Q_STD, h, hd), (1.0, kh, hd),
                                       (1.0, kh, vd), (1.0, h, vd))]
    grads = {}
    for where in (dev, torch.device("cpu")):
        q, k, v = (t.to(where).requires_grad_() for t in host[:3])
        before = flash_attention.launches
        o = blocks.attend(cfg, q, k, v, window)
        launched = flash_attention.launches - before
        grads[where.type] = torch.autograd.grad(o, (q, k, v),
                                                host[3].to(where))
        if launched != (1 if where.type == "cuda" else 0):
            raise AssertionError(f"{label}: {launched} flash launches for "
                                 f"one forward on {where}")
    errs = []
    for name, got, want in zip("qkv", grads[dev.type], grads["cpu"]):
        err = float((got.cpu() - want).abs().max()) / float(want.abs().max())
        errs.append(err)
        if not err <= GRAD_REL:
            raise AssertionError(f"{label}: d{name} on the card {err:.3g} of "
                                 f"its max from the CPU's (bound "
                                 f"{GRAD_REL})")
    log(f"  [{tag}] (a) attention gradient, {label}, B {b} S {s} H "
        f"{h}/{kh}: max |card - cpu| / max |cpu| dq {errs[0]:.3g}, dk "
        f"{errs[1]:.3g}, dv {errs[2]:.3g} (bound {GRAD_REL}); one flash "
        f"launch a forward, none in the backward")
    return max(errs)


def grad_check(dev, rng) -> list:
    """(a): ``attn_grad_check`` at each of ``GRAD_CASES``."""
    import repro_torch.configs as C
    out = []
    for label, arch, window in GRAD_CASES:
        cfg = C.get(arch).replace(param_dtype="float32",
                                  compute_dtype="float32")
        out.append(attn_grad_check(
            dev, rng, "train", label, cfg, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.head_dim, window))
    return out


class UndecidedProbe:
    """While open, marks the parameter elements whose Adam step direction
    rounding decides (``STEP_ZERO_LEAF``'s note): it wraps
    ``launch.steps.adamw_update`` (looked up by name at each train step)
    and ORs into ``mask`` (bool, by parameter name, on the CPU) each
    step's elements whose gradient is within ``STEP_TOL`` of its leaf's
    largest |value|, or all of a leaf below ``STEP_ZERO_LEAF`` of the
    step's largest gradient; ``nonzero()`` counts the elements so marked
    in a step where their gradient was not exactly 0."""

    def __enter__(self):
        import torch
        from repro_torch.launch import steps
        self.mask, self.live, self._update = {}, {}, steps.adamw_update

        def update(grads, *args, **kw):
            top = max(float(g.abs().max()) for g in grads.values())
            for n, g in grads.items():
                a = g.detach().abs().cpu()
                big = float(a.max())
                und = (a <= STEP_TOL * big) if big > STEP_ZERO_LEAF * top \
                    else torch.ones_like(a, dtype=torch.bool)
                live = und & (a > 0)
                if n in self.mask:
                    und, live = und | self.mask[n], live | self.live[n]
                self.mask[n], self.live[n] = und, live
            return self._update(grads, *args, **kw)
        steps.adamw_update = update
        return self

    def __exit__(self, *exc):
        from repro_torch.launch import steps
        steps.adamw_update = self._update

    def nonzero(self) -> int:
        return sum(int(m.sum()) for m in self.live.values())


class GradMaxProbe:
    """While open, records each train step's largest |gradient| of each
    leaf (``steps``: a dict by parameter name a step, floats), wrapping
    ``launch.steps.adamw_update`` as ``UndecidedProbe`` does."""

    def __enter__(self):
        from repro_torch.launch import steps
        self.steps, self._update = [], steps.adamw_update

        def update(grads, *args, **kw):
            self.steps.append({n: float(g.detach().abs().max())
                               for n, g in grads.items()})
            return self._update(grads, *args, **kw)
        steps.adamw_update = update
        return self

    def __exit__(self, *exc):
        from repro_torch.launch import steps
        steps.adamw_update = self._update


def steps_vs_cpu(dev, seed: int, tag: str, label: str, cfg, host,
                 undecided: bool = False) -> None:
    """``STEP_COUNT`` train steps of ``cfg`` (float32, remat full,
    ``STEP_CHUNK``) from the weights of ``host`` (an ``LM`` on the CPU) on
    the card and on the CPU, on the same batches of ``STEP_SHAPE``: the
    losses and grad norms within ``STEP_TOL``, the parameters within
    ``STEP_PARAM_TOL``, or it raises.  With ``undecided``, the elements
    whose step direction rounding decides on the CPU (``UndecidedProbe``)
    are held instead to two steps of lr a step.  An MoE config's routing
    is recorded on both (``RoutingProbe``: each MoE layer in the forward
    and again in the remat recompute) and the tokens whose experts differ
    between card and CPU are printed step by step (a flip, reported, not
    bounded)."""
    import contextlib
    import torch
    from repro_torch.launch.ranks import RoutingProbe
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init, cosine_schedule
    cpu = torch.device("cpu")
    b, s = STEP_SHAPE
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(STEP_COUNT):
        toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
        batches.append({"inputs": toks[:, :-1], "targets": toks[:, 1:],
                        "mask": rng.random((b, s)) < 0.9})
    runs = {}
    for where in (dev, cpu):
        model = lm.LM(cfg, {n: p.detach().to(where).clone() for n, p in
                            host.named_parameters()}, trainable=True)
        opt_cfg = AdamWConfig(**STEP_OPT)
        opt = adamw_init(dict(model.named_parameters()), opt_cfg)
        step = make_train_step(cfg, opt_cfg, where)
        metrics, routes = [], []
        with (UndecidedProbe() if undecided and where == cpu
              else contextlib.nullcontext()) as und:
            for batch in batches:
                with RoutingProbe() as probe:
                    model, opt, m = step(model, opt, batch)
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
                routes.append([e.sort(dim=-1).values.cpu()
                               for e in probe.eids])
        runs[where.type] = (metrics, {n: p.detach().cpu() for n, p in
                                      model.named_parameters()}, routes)
    (got, gp, gr), (want, wp, wr) = runs[dev.type], runs["cpu"]
    loss_gap = max(abs(g[0] - w[0]) for g, w in zip(got, want))
    norm_gap = max(abs(g[1] - w[1]) / w[1] for g, w in zip(got, want))
    gaps = {n: (gp[n] - wp[n]).abs() for n in wp}
    param_gap = max(float(d.max()) for d in gaps.values())
    split = ""
    if undecided:
        opt_cfg = AdamWConfig(**STEP_OPT)
        und_tol = 2 * sum(float(cosine_schedule(opt_cfg, i + 1))
                          for i in range(STEP_COUNT))
        def most(parts):
            return max((float(d.max()) for d in parts if d.numel()),
                       default=0.0)
        param_gap = most(d[~und.mask[n]] for n, d in gaps.items())
        und_gap = most(d[und.mask[n]] for n, d in gaps.items())
        total = sum(d.numel() for d in gaps.values())
        split = (f"; {und.nonzero()} elements of {total} undecided (a nonzero "
                 f"gradient within {STEP_TOL} of its leaf's max, or a leaf "
                 f"of rounding), their gap {und_gap:.3g} (bound "
                 f"{und_tol:.3g})")
        if not und_gap <= und_tol:
            raise AssertionError(f"{label}: undecided parameters on the "
                                 f"card {und_gap} from the CPU's, past "
                                 f"{und_tol}")
    flips = ""
    if cfg.moe is not None:
        if [len(r) for r in gr] != [len(r) for r in wr] or not gr[0]:
            raise AssertionError(f"{label}: the card routed "
                                 f"{[len(r) for r in gr]} times a step, the "
                                 f"CPU {[len(r) for r in wr]}")
        flips = "; routing flips card vs cpu by step " + str([
            sum(int((g != w).any(-1).sum()) for g, w in zip(gs, ws))
            for gs, ws in zip(gr, wr)]) + (
            f" (of {sum(e.shape[0] for e in gr[0])} token rows a step, "
            f"{len(gr[0])} routings: forward and remat recompute)")
    log(f"  [{tag}] (b) {label}, float32, remat full, loss_chunk "
        f"{cfg.loss_chunk} of S {s}, {STEP_COUNT} steps: losses card "
        f"{[round(g[0], 6) for g in got]} cpu "
        f"{[round(w[0], 6) for w in want]}; max |loss gap| {loss_gap:.3g}, "
        f"grad norm {norm_gap:.3g} of itself, params {param_gap:.3g} (bounds "
        f"{STEP_TOL}, {STEP_TOL}, {STEP_PARAM_TOL:.3g}){split}{flips}")
    if not (loss_gap <= STEP_TOL and norm_gap <= STEP_TOL
            and param_gap <= STEP_PARAM_TOL):
        raise AssertionError(f"{label}: train steps on the card differ from "
                             f"the CPU's past the bounds")


def step_check(dev, seed: int) -> None:
    """(b): ``steps_vs_cpu`` for the Qwen3 and Gemma 2 smoke configs (Gemma
    2's weights at 1/sqrt(input width), ``parity_model``: its reference
    draw makes the smoke network chaotic)."""
    import torch
    import repro_torch.configs as C
    from repro_torch.models import lm
    from repro_torch.models.config import smoke_config
    cpu = torch.device("cpu")
    for arch in ("qwen3_1_7b", "gemma2_9b"):
        cfg = smoke_config(C.get(arch)).replace(
            param_dtype="float32", compute_dtype="float32", remat="full",
            loss_chunk=STEP_CHUNK)
        gen = torch.Generator().manual_seed(seed)
        host = (parity_model(cfg, gen, cpu) if arch == "gemma2_9b" else
                lm.init_params(cfg, gen, cpu))
        steps_vs_cpu(dev, seed, "train", f"{cfg.name} smoke", cfg, host)


def train_shares(fn, dev) -> dict:
    """Runs ``fn`` once under ``torch.profiler`` (host and device) and
    splits the device time of its kernels into the flash kernel, the
    attention backward's recompute (every kernel launched inside
    ``blocks.ATTN_BWD_RANGE``, its products included), the other matrix
    products, and the rest; ``busy_ms`` is the union of the kernels'
    intervals, ``wall_ms`` the profiled call's host clock."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.blocks import ATTN_BWD_RANGE
    sync(dev)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync(dev)
        wall = time.perf_counter() - t0
    events = list(prof.profiler.kineto_results.events())
    cuda = torch.autograd.DeviceType.CUDA
    ranges = {}
    for e in events:
        if e.device_type() != cuda and e.name() == ATTN_BWD_RANGE:
            ranges.setdefault(e.start_thread_id(), []).append(
                (e.start_ns(), e.end_ns()))
    inside = set()
    for e in events:
        if e.device_type() == cuda or not e.correlation_id():
            continue
        for lo, hi in ranges.get(e.start_thread_id(), ()):
            if lo <= e.start_ns() <= hi:
                inside.add(e.correlation_id())
                break
    ms = {"flash": 0.0, "recompute": 0.0, "matmul": 0.0, "other": 0.0}
    spans = []
    for e in events:
        # the profiler mirrors the record_function range on the device
        # timeline as a span over its kernels: not a kernel
        if e.device_type() != cuda or e.name() == ATTN_BWD_RANGE:
            continue
        lo = e.start_ns()
        hi = lo + e.duration_ns()
        spans.append((lo, hi))
        name = e.name()
        kind = "flash" if "flash" in name else \
            "recompute" if e.correlation_id() in inside else \
            "matmul" if MATMUL_KERNELS.search(name) else "other"
        ms[kind] += (hi - lo) / 1e6
    busy, end = 0.0, -math.inf
    for lo, hi in sorted(spans):
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    return dict(kernels=len(spans), ranges=sum(map(len, ranges.values())),
                busy_ms=busy / 1e6, wall_ms=wall * 1e3, **ms)


def train_flash_check(cfg, dev, seed: int) -> dict:
    """(c) first: the flash kernel at the training step's own shape (B 2,
    S 4096, Qwen3-1.7B's heads: H 16, KH 8, hd 128; bf16, causal, no
    window, no softcap), called as the step calls it, ``blocks.attend`` on
    [B, S, H, hd] tensors, against its plain version on the same inputs
    within ``flash_bound`` at FLASH_REL["bfloat16"]; q at each of
    FLASH_Q_SCALES.  These launches precede the main path's counts."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.blocks import attend
    b, s, h, kh, hd = (TRAIN_BATCH, TRAIN_LEN, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim)
    opt = dict(causal=cfg.causal, window=0, softcap=cfg.attn_softcap)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    errs, shares = [], []
    for sd in FLASH_Q_SCALES:
        q, k, v = (torch.randn((b, s, n, hd), generator=gen, device=dev)
                   .mul_(scale).to(cfg.dtype("compute"))
                   for n, scale in ((h, sd), (kh, 1), (kh, 1)))
        before = flash_attention.launches
        with torch.no_grad():
            got = attend(cfg, q, k, v).transpose(1, 2)
        if flash_attention.launches != before + (dev.type == "cuda"):
            raise AssertionError("blocks.attend did not launch the flash "
                                 "kernel once")
        want, tol = flash_bound(*(t.transpose(1, 2) for t in (q, k, v)), opt,
                                FLASH_REL["bfloat16"])
        err, share = flash_share(got, want, tol)
        del q, k, v, got, want, tol
        if not share <= 1:
            raise AssertionError(f"flash_attention at the training shape, q "
                                 f"std {sd:g}: max abs err {err}, "
                                 f"{share:.3g} of the bound")
        errs.append(err)
        shares.append(share)
    release(dev)
    log(f"  [train] (c) flash at the step's shape (B {b}, H {h}/{kh}, S {s},"
        f" hd {hd}, {cfg.compute_dtype}, causal, softcap "
        f"{cfg.attn_softcap:g}) through blocks.attend against its plain "
        f"version: max abs err {errs} at q std {list(FLASH_Q_SCALES)}, "
        f"{max(shares):.3g} of the bound (rel {FLASH_REL['bfloat16']:g})")
    return dict(max_abs_err=max(errs), share_of_bound=max(shares))


def train_full(dev, seed: int) -> tuple:
    """(c): Qwen3-1.7B at full width, the main path of the phase: the
    launch counts are set to 0 before its steps and read after them.
    Returns the counts and ``train_flash_check``'s result."""
    import torch
    import repro_torch.configs as C
    from repro_torch.data import LMDataConfig, lm_batch_at_step
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import PEAK_FLOPS
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init
    cfg = C.get(TRAIN_ARCH).replace(remat="full", loss_chunk=512)
    flash = train_flash_check(cfg, dev, seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = lm.init_params(cfg, gen, dev, trainable=True)
    n_params = lm.count_params(model)
    if n_params != TRAIN_PARAMS:
        raise AssertionError(f"{cfg.name}: {n_params} parameters, not "
                             f"{TRAIN_PARAMS}")
    opt_cfg = AdamWConfig()
    opt = adamw_init(dict(model.named_parameters()), opt_cfg)
    step = make_train_step(cfg, opt_cfg, dev)
    data = LMDataConfig(vocab=cfg.vocab, seq_len=TRAIN_LEN,
                        global_batch=TRAIN_BATCH, seed=seed)
    log(f"  [train] (c) {cfg.name}: {n_params} parameters ({cfg.n_layers} "
        f"layers, d {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} x "
        f"{cfg.head_dim}, vocab {cfg.vocab}, tied), {cfg.param_dtype}, "
        f"AdamW moments {opt_cfg.opt_dtype}; remat {cfg.remat}, loss_chunk "
        f"{cfg.loss_chunk}; B {TRAIN_BATCH} x S {TRAIN_LEN}; state "
        f"{memory_gib(dev):.2f} GiB")
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    losses, secs = [], []
    for i in range(TRAIN_WARMUP + TRAIN_TIMED):
        batch = lm_batch_at_step(data, i)
        t0 = time.perf_counter()
        model, opt, m = step(model, opt, batch)
        losses.append(float(m["loss"]))
        secs.append(time.perf_counter() - t0)
    counts = launch_counts()
    peak = memory_gib(dev, peak=True)
    n_steps = TRAIN_WARMUP + TRAIN_TIMED
    want_flash = n_steps * 2 * cfg.n_layers      # forward + remat recompute
    if dev.type == "cuda" and counts["flash_attention"] != want_flash:
        raise AssertionError(f"{n_steps} steps launched the flash kernel "
                             f"{counts['flash_attention']} times, not "
                             f"{want_flash}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"losses not finite: {losses}")
    timed = np.array(secs[TRAIN_WARMUP:])
    tokens = TRAIN_BATCH * TRAIN_LEN
    flops = 6 * n_params * tokens + 6 * cfg.n_layers * TRAIN_BATCH \
        * TRAIN_LEN ** 2 * cfg.n_heads * cfg.head_dim
    bound_s = flops / PEAK_FLOPS
    mean = float(timed.mean())
    log(f"  [train] (c) losses {losses}; warm-up step {secs[0]:.3f} s, "
        f"timed steps {[round(float(x) * 1e3, 1) for x in timed]} ms: mean "
        f"{mean * 1e3:.1f} ms a step, {tokens / mean:.0f} tokens/s; peak "
        f"device memory {peak:.2f} GiB; flash launches {want_flash} "
        f"({2 * cfg.n_layers} a step: forward + remat recompute)")
    log(f"  [train] (c) model FLOPs a step 6*N*T + 6*L*B*S^2*H*hd = "
        f"{flops:.4g}; bound at {PEAK_FLOPS / 1e12:.0f} TFLOP/s "
        f"bf16 {bound_s * 1e3:.1f} ms; share of it reached "
        f"{bound_s / mean:.1%} ({flops / mean / 1e12:.1f} TFLOP/s)")
    batch = lm_batch_at_step(data, n_steps)
    p = train_shares(lambda: step(model, opt, batch), dev)
    if not p["kernels"]:
        log("  [train] (c) profile: the profiler saw no device kernels; "
            "split not measured")
    else:
        busy = p["busy_ms"]
        log(f"  [train] (c) profile of one more step: {p['kernels']} "
            f"kernels, device busy {busy:.1f} ms: flash {p['flash']:.1f} ms "
            f"({p['flash'] / busy:.1%}), attention backward recompute "
            f"{p['recompute']:.1f} ms ({p['recompute'] / busy:.1%}, "
            f"{p['ranges']} ranges), other matrix products "
            f"{p['matmul']:.1f} ms ({p['matmul'] / busy:.1%}), rest "
            f"{p['other']:.1f} ms ({p['other'] / busy:.1%}); device idle "
            f"{1 - busy / (mean * 1e3):.1%} of the unprofiled {mean * 1e3:.1f}"
            f" ms ({1 - busy / p['wall_ms']:.1%} of the profiled "
            f"{p['wall_ms']:.1f} ms)")
    del model, opt
    release(dev)
    return counts, flash


def restart_check(dev, seed: int, arch: str = TRAIN_ARCH,
                  tag: str = "train") -> None:
    """(d): ``train(..., fail_at=k)`` of ``arch`` at ``--preset 100m``, then
    the same run again resumes from its checkpoint; the resumed losses
    equal an uninterrupted run's bit for bit.  Checkpoints go under the
    git-ignored ``build/`` and are removed."""
    import contextlib
    import io
    import repro_torch.configs as C
    from repro_torch.launch.train import preset_config, train
    cfg = preset_config(C.get(arch), "100m")
    root = ROOT / "build" / f"train-{os.getpid()}"
    try:
        t0 = time.perf_counter()
        whole = train(cfg, out=str(root / "whole"), ckpt_every=10**9,
                      seed=seed, device=dev, **RESTART)
        t_whole = time.perf_counter() - t0
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            try:
                train(cfg, out=str(root / "failed"), ckpt_every=RESTART_EVERY,
                      fail_at=RESTART_FAIL_AT, seed=seed, device=dev,
                      **RESTART)
            except RuntimeError as e:
                if "injected failure" not in str(e):
                    raise
            else:
                raise AssertionError("fail_at did not stop the run")
            rest = train(cfg, out=str(root / "failed"),
                         ckpt_every=RESTART_EVERY, seed=seed, device=dev,
                         **RESTART)
        resumed = [ln for ln in printed.getvalue().splitlines()
                   if "resumed" in ln]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    start = RESTART["steps"] - len(rest)
    log(f"  [{tag}] (d) {cfg.name} --preset 100m, {RESTART['steps']} steps "
        f"of {RESTART['global_batch']} x {RESTART['seq_len']} "
        f"({t_whole:.1f} s uninterrupted): failed before step "
        f"{RESTART_FAIL_AT}, {resumed}; losses from step {start}: resumed "
        f"{rest}, uninterrupted {whole[start:]}")
    if rest != whole[start:] or start != RESTART_FAIL_AT \
            - RESTART_FAIL_AT % RESTART_EVERY:
        raise AssertionError("the resumed trajectory is not the "
                             "uninterrupted one bit for bit")


def drive_train(dev, rng, seed: int) -> dict:
    errs = grad_check(dev, rng)
    step_check(dev, seed)
    counts, flash = train_full(dev, seed)
    restart_check(dev, seed)
    return counts, max(errs), flash


# ---------------------------------------------------------------------------
# phase 11: the other attention-only archs at full width (Mistral NeMo 12B,
# StableLM 12B, Chameleon 34B, HuBERT X-Large)
# ---------------------------------------------------------------------------

# (a)-(c): arch, prefill (B, S), decode-versus-prefill parity (B, tokens:
# one decode step a token).  Cuts: Mistral NeMo's 128k context and the
# prefill_32k cell's 32,768 to 8,192 (phase 5's prefill); Chameleon's
# weights (68.6 GB in bf16) leave about 10 GB of the card, so its prefill
# is cut to 1 x 4,096 and its parity to 1 x 16 tokens.  The timed decode
# is phase 5's (DECODE_BATCH requests, a PROMPT_LEN prompt stepped into the
# cache, GEN_LEN greedy steps): decode_32k's batch of 128 and cache of
# 32,768 cut to 4 and 40.
ARCH_RUNS = (("mistral_nemo_12b", (2, 8192), (2, 64)),
             ("stablelm_12b", (2, 8192), (2, 64)),
             ("chameleon_34b", (1, 4096), (1, 16)))
ARCH_PREFILL_CALLS = 2
# (d) HuBERT X-Large: the forward over frame embeddings at train_4k's
# sequence, its global batch of 256 cut to 2; 3 train steps at the same
# shape through ``launch.train.train`` and its frontend stub; the gradient
# of its smoke config at hd 80 (S 64) on the card against the CPU
HUBERT_SHAPE = (2, 4096)
HUBERT_TRAIN_STEPS = 3
HUBERT_GRAD_SHAPE = (2, 64)


def parity_bound(n_layers: int, n_rec: int = 0, n_mla: int = 0) -> float:
    """Phase 5's bf16 bound at ``n_layers``: about 4 roundings to 8 bits a
    layer in which two paths differ, adding up like a random walk to
    sqrt(4 L) 2^-8 of the logit scale; twice that (0.099 at 40 layers,
    0.108 at 48).  A wrong cache slot or mask moves the logits by their
    whole scale.

    ``n_rec`` RG-LRU layers add 2 roundings each: decode rounds the
    recurrence's state h to bf16 every step (the cache's dtype, as the
    reference's ``apply_rglru``), where prefill keeps it in float32.  Each
    step's h carries the roundings of the steps before it, decayed by a:
    sum_k a^(2k) = 1 / (1 - a^2) roundings' worth of variance.  On
    ``parity_model``'s draw the gate's pre-activation is about N(0, 1), so
    a = exp(-8 softplus(1) sigmoid(.)) <= 0.59 for all but 0.2% of the
    channels (1 / (1 - a^2) <= 1.54); 2 allows for the rest.  The xLSTM
    cells keep their states in float32 on both paths and add nothing.
    RecurrentGemma 2B (26 layers, 18 rec): 2 sqrt(104 + 36) 2^-8 = 0.092;
    xLSTM 125M (12 layers): 0.054.

    ``n_mla`` MLA layers add 2 roundings each: decode attends absorbed,
    rounding q_nope's product with ``wk_b`` (q_lat) and the context's with
    ``wv_b`` to bf16, where prefill rounds the expanded keys k_nope and
    values v; the float32 scores and probabilities of the absorbed path
    against flash's bf16 P are the attention's own rounding, counted in
    the 4.  An MoE layer rounds as a dense FFN does while both paths choose
    the same experts, and adds nothing; past a routing flip (a near tie of
    two experts' scores that the paths' roundings order differently) a
    token runs another expert, and no rounding bound holds.  DeepSeek-V3
    at 5 layers (all MLA): 2 sqrt(20 + 10) 2^-8 = 0.043; Llama 4 Scout at
    12 (GQA): 0.054."""
    return 2 * math.sqrt(4 * n_layers + 2 * n_rec + 2 * n_mla) * 2.0**-8


def moe_decode_vs_prefill(cfg, model, toks, dev) -> dict:
    """``decode_vs_prefill`` for an MoE model, with each layer's chosen
    experts recorded on both paths (``RoutingProbe``).  A (request,
    position) diverges where a decode step's expert set differs from the
    forward's at that position in any layer (a routing flip), or where the
    forward dropped one of its slots (a decode step of B tokens never
    drops: its capacity is at least B).  The gap is taken over each
    request's positions before its first divergence, where both paths ran
    the same experts: ``err`` its largest share of the largest |logit|,
    ``held`` the positions it covers, ``err_all`` the gap over every
    position; ``flips`` by MoE layer, ``first`` each request's first
    divergence (the tokens, where none)."""
    import torch
    from repro_torch.launch.ranks import RoutingProbe
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import lm
    from repro_torch.models.common import softcap
    b, s = toks.shape
    with torch.inference_mode(), RoutingProbe() as pre:
        hidden, _ = lm.forward(cfg, model, toks)
        full = softcap(lm.logits_fn(cfg, model, hidden).float(),
                       cfg.logit_softcap)
    from repro_torch.models import blocks
    cap = blocks.moe_capacity(cfg, b * s)
    want = [e.sort(dim=-1).values.view(b, s, -1) for e in pre.eids]
    lost = np.zeros((b, s), bool)
    for e in pre.eids:
        pos = blocks.moe_slots(e, cfg.moe.num_experts).view(b, s, -1)
        lost |= (pos >= cap).any(-1).cpu().numpy()
    serve = make_serve_step(cfg, dev)
    caches = lm.init_caches(cfg, b, s, device=dev)
    scale = max(1.0, float(full.abs().max()))
    flips = np.zeros((len(want), b, s), bool)
    gaps = np.zeros((b, s))
    for t in range(s):
        with RoutingProbe() as step:
            logits, caches = serve(model, caches, toks[:, t:t + 1])
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{cfg.name}: decode step {t} not finite")
        for layer, e in enumerate(step.eids):
            flips[layer, :, t] = (e.sort(dim=-1).values != want[layer][:, t]
                                  ).any(-1).cpu().numpy()
        gaps[:, t] = ((logits - full[:, t]).abs().amax(-1) / scale
                      ).cpu().numpy()
    diverged = flips.any(0) | lost
    first = [int(row.argmax()) if row.any() else s for row in diverged]
    held = [gaps[i, :first[i]] for i in range(b)]
    return dict(err=max((float(h.max()) for h in held if h.size),
                        default=0.0),
                err_all=float(gaps.max()), held=sum(first), first=first,
                flips=flips.sum((1, 2)).tolist(), lost=int(lost.sum()))


def arch_decoder(dev, gen, arch: str, prefill_shape, parity_shape,
                 profile_len: int = 0, cfg=None) -> dict:
    """(a)-(c), phases 12 and 13: one decoder at full width (``cfg``, or
    the arch's config), bf16, weights from ``parity_model``.  The main
    path, with the counts set to 0 before it and read after it:
    ``make_prefill_step`` twice on random tokens (one flash launch a layer
    with attention, MLA's included), then phase 5's decode (a prompt
    stepped into the cache, greedy steps timed; no flash launch).  With
    ``profile_len``, one more prefill (of the first ``profile_len``
    positions) and one more decode step under ``torch.profiler``: the
    kernels each launches and its device busy time; for an MoE model the
    prefill's routing is recorded (``RoutingProbe``) for the share of
    slots the capacity dropped.  Then the decode-versus-prefill parity
    within ``parity_bound``, a check whose forward's flash launches are
    not counted; for an MoE model over the positions before each
    request's first routing flip (``moe_decode_vs_prefill``), the flips
    printed.  An MoE model's decode step is printed beside the least time
    to read the weights it reads (all but the embedding table and MTP:
    every expert is multiplied every step)."""
    import contextlib
    import torch
    from repro_torch.launch.ranks import RoutingProbe, dropped_slots
    import repro_torch.configs as C
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import HBM_BW
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import lm
    cfg = cfg or C.get(arch)
    n_attn = sum(lm.PARTS[k][0] == "attn" for k in cfg.layer_kinds)
    t0 = time.perf_counter()
    model = parity_model(cfg, gen, dev)
    sync(dev)
    log(f"  [arch] {cfg.name}: {lm.count_params(model)} parameters "
        f"({cfg.n_layers} layers {cfg.block_pattern} x {cfg.cycles} + "
        f"{cfg.remainder_blocks}, d {cfg.d_model}, heads {cfg.n_heads}/"
        f"{cfg.n_kv_heads} x {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}, qk-norm {cfg.qk_norm}, rope theta "
        f"{cfg.rope_theta:g}), {cfg.param_dtype}, drawn in "
        f"{time.perf_counter() - t0:.3f} s; {memory_gib(dev):.2f} GiB")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    b, s = prefill_shape
    prefill = make_prefill_step(cfg, dev)
    toks = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev,
                         dtype=torch.int32)
    secs = []
    for _ in range(ARCH_PREFILL_CALLS):
        t0 = time.perf_counter()
        logits = prefill(model, {"inputs": toks})
        sync(dev)
        secs.append(time.perf_counter() - t0)
        if tuple(logits.shape) != (b, 1, cfg.vocab) \
                or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{cfg.name} prefill logits "
                                 f"{tuple(logits.shape)}: not [{b}, 1, "
                                 f"{cfg.vocab}] finite values")
    n_flash = launch_counts()["flash_attention"]
    del logits
    serve = make_serve_step(cfg, dev)
    caches = lm.init_caches(cfg, DECODE_BATCH,
                            PROMPT_LEN + GEN_LEN + bool(profile_len),
                            device=dev)
    prompts = torch.randint(0, cfg.vocab, (DECODE_BATCH, PROMPT_LEN),
                            generator=gen, device=dev, dtype=torch.int32)
    for t in range(PROMPT_LEN):
        logits, caches = serve(model, caches, prompts[:, t:t + 1])
    steps = []
    for _ in range(GEN_LEN):
        tok = logits.argmax(-1, keepdim=True).to(torch.int32)
        t0 = time.perf_counter()
        logits, caches = serve(model, caches, tok)
        sync(dev)
        steps.append(time.perf_counter() - t0)
    if int(caches["pos"]) != PROMPT_LEN + GEN_LEN \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{cfg.name} decode: cache at "
                             f"{int(caches['pos'])}, logits not finite")
    counts = launch_counts()
    peak = memory_gib(dev, peak=True)
    steps = np.array(steps)
    moe_lines = ""
    if profile_len:
        tok = logits.argmax(-1, keepdim=True).to(torch.int32)
        d = device_shares(lambda: serve(model, caches, tok), dev)
        probe = RoutingProbe() if cfg.moe else contextlib.nullcontext()
        with probe:
            p = device_shares(lambda: prefill(
                model, {"inputs": toks[:, :profile_len]}), dev)
        if cfg.moe:
            drop, slots = dropped_slots(cfg, probe.eids)
            moe_lines += (f"; the capacity ({cfg.moe.capacity_factor} x "
                          f"the mean load) dropped {drop} of {slots} "
                          f"(token, k) slots of the profiled prefill "
                          f"({drop / slots:.3%})")
        idle = f"idle {1 - p['busy_ms'] / (secs[-1] * 1e3):.1%} of the " \
            f"unprofiled {secs[-1] * 1e3:.3f} ms" if profile_len == s \
            else "idle not measured at this length"
        log(f"  [arch] {cfg.name} launches: a prefill of {b} x "
            f"{profile_len} {p['kernels']} kernels "
            f"({p['kernels'] / profile_len:.1f} a position), device busy "
            f"{p['busy_ms']:.3f} ms of its profiled {p['wall_ms']:.3f} ms, "
            f"{idle}; a decode step of {DECODE_BATCH} "
            f"requests {d['kernels']} kernels, device busy "
            f"{d['busy_ms']:.3f} ms, idle "
            f"{1 - d['busy_ms'] / (np.median(steps) * 1e3):.1%} of the "
            f"unprofiled median {np.median(steps) * 1e3:.3f} ms; top of the "
            f"prefill {p['top']}")
    del caches, logits, toks
    if cfg.moe:
        read = sum(t.numel() * t.element_size() for n, t in
                   model.named_parameters()
                   if n != "embed" and not n.startswith("mtp"))
        moe_lines += (f"; decode median {np.median(steps) * 1e3:.2f} ms "
                      f"against {read / HBM_BW * 1e3:.2f} ms to "
                      f"read the {read / 1e9:.1f} GB of weights a step "
                      f"reads")
    pb, pn = parity_shape
    ptoks = torch.randint(0, cfg.vocab, (pb, pn), generator=gen, device=dev,
                          dtype=torch.int32)
    n_mla = sum(lm.is_mla(cfg, k) for k in cfg.layer_kinds)
    tol = parity_bound(cfg.n_layers, cfg.layer_kinds.count("rec"), n_mla)
    if cfg.moe:
        par = moe_decode_vs_prefill(cfg, model, ptoks, dev)
        err = par["err"]
        moe_lines += (f"; bf16 routing: flips by MoE layer {par['flips']}, "
                      f"slots the forward dropped at {par['lost']} "
                      f"positions, first divergence by request "
                      f"{par['first']}: the gap held over {par['held']} of "
                      f"{pb * pn} positions (over all {par['err_all']:.3g})")
        if not par["held"]:
            raise AssertionError(f"{cfg.name}: every request's routing "
                                 f"diverged at its first position; no "
                                 f"position to hold the parity over")
    else:
        err = decode_vs_prefill(cfg, model, ptoks, dev)
    log(f"  [arch] {cfg.name} prefill {b} x {s}: "
        + ", ".join(f"{t:.3f} s ({b * s / t:.0f} tokens/s)" for t in secs)
        + f"; flash launches {n_flash} ({n_attn} a prefill); decode "
        f"{DECODE_BATCH} requests, prompt of {PROMPT_LEN} tokens, "
        f"{GEN_LEN} greedy steps (cache at {PROMPT_LEN + 1}-"
        f"{PROMPT_LEN + GEN_LEN}): median {np.median(steps) * 1e3:.2f} ms a "
        f"step (min {steps.min() * 1e3:.2f}, max {steps.max() * 1e3:.2f});"
        f" peak device memory {peak:.2f} GiB; launches {counts}; decode vs "
        f"prefill over {pb} x {pn} tokens, bf16, {cfg.n_layers} layers: "
        f"max |gap| / max |logit| {err:.3g} (bound {tol:.3g})" + moe_lines)
    if dev.type == "cuda" and (n_flash != n_attn * ARCH_PREFILL_CALLS or
                               counts["flash_attention"] != n_flash):
        raise AssertionError(f"{cfg.name}: {ARCH_PREFILL_CALLS} prefills "
                             f"launched the flash kernel {n_flash} times "
                             f"({n_attn} attention layers), the decode "
                             f"{counts['flash_attention'] - n_flash}")
    if not err <= tol:
        raise AssertionError(f"{cfg.name} decode vs prefill: {err} > {tol}")
    del model
    release(dev)
    return counts


def hubert_grad_check(dev, seed: int) -> float:
    """(d) last: HuBERT's smoke config at its hd 80, float32, remat full:
    the loss and every parameter's gradient on the card against the CPU
    from the same weights (``parity_model``) and frame embeddings; two
    flash launches a layer on the card (forward and recompute)."""
    import torch
    import repro_torch.configs as C
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import lm
    from repro_torch.models.config import smoke_config
    cpu = torch.device("cpu")
    cfg = smoke_config(C.get("hubert_xlarge")).replace(
        head_dim=80, param_dtype="float32", compute_dtype="float32",
        remat="full")
    host = parity_model(cfg, torch.Generator().manual_seed(seed), cpu)
    rng = np.random.default_rng(seed)
    b, s = HUBERT_GRAD_SHAPE
    batch = {"inputs": rng.normal(0, 1, (b, s, cfg.d_model)).astype(
        np.float32), "targets": rng.integers(0, cfg.vocab, (b, s)),
        "mask": rng.random((b, s)) < 0.3}
    out = {}
    for where in (dev, cpu):
        model = lm.LM(cfg, {n: p.detach().to(where).clone() for n, p in
                            host.named_parameters()}, trainable=True)
        before = flash_attention.launches
        loss = lm.lm_loss(cfg, model, {k: torch.as_tensor(v, device=where)
                                       for k, v in batch.items()})
        loss.backward()
        launched = flash_attention.launches - before
        if launched != (2 * cfg.n_layers if where.type == "cuda" else 0):
            raise AssertionError(f"hubert gradient: {launched} flash "
                                 f"launches on {where}")
        out[where.type] = (float(loss.detach()), {
            n: p.grad.cpu() for n, p in model.named_parameters()})
    (gl, gg), (wl, wg) = out[dev.type], out["cpu"]
    worst = max(float((gg[n] - wg[n]).abs().max())
                / max(float(wg[n].abs().max()), 1e-30) for n in wg)
    log(f"  [arch] (d) hubert smoke at hd 80 ({cfg.n_layers} layers, d "
        f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}), float32, "
        f"B {b} x S {s}: loss card {gl:.6f} cpu {wl:.6f} (gap "
        f"{abs(gl - wl):.3g}, bound {STEP_TOL}); gradients, largest gap "
        f"over a leaf's max {worst:.3g} (bound {GRAD_REL}); "
        f"{2 * cfg.n_layers} flash launches on the card")
    if not (abs(gl - wl) <= STEP_TOL and worst <= GRAD_REL):
        raise AssertionError("hubert gradients on the card differ from "
                             "the CPU's past the bounds")
    return worst


def arch_hubert(dev, gen, seed: int) -> dict:
    """(d): HuBERT X-Large at full width: the forward over random frame
    embeddings [2, 4096, 1280] in float32 (TF32 off) and in bf16 from the
    same weights (``parity_model``, bf16 rounded from float32), the bf16
    logits within ``parity_bound(48)`` of the float32 ones; the same bf16
    weights run causal must move them past that bound.  Then 3 train
    steps through ``launch.train.train`` (its frontend stub, masked-frame
    targets, bf16, remat full), losses finite.  The main path is the bf16
    forwards and the train steps: the counts are set to 0 before each and
    read after each, so the float32 reference and the causal run (checks)
    are not counted."""
    import torch
    import repro_torch.configs as C
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.train import train
    from repro_torch.models import lm
    cfg = C.get("hubert_xlarge")
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    t0 = time.perf_counter()
    m32 = parity_model(cfg32, gen, dev)
    m16 = lm.LM(cfg, {n: p.detach().to(torch.bfloat16)
                      for n, p in m32.named_parameters()})
    sync(dev)
    log(f"  [arch] {cfg.name}: {lm.count_params(m16)} parameters "
        f"({cfg.n_layers} layers, d {cfg.d_model}, heads {cfg.n_heads}/"
        f"{cfg.n_kv_heads} x {cfg.head_dim}, d_ff {cfg.d_ff} "
        f"{cfg.ffn_kind}, vocab {cfg.vocab}, causal {cfg.causal}, embedded "
        f"inputs), float32 and bf16 copies drawn in "
        f"{time.perf_counter() - t0:.3f} s; {memory_gib(dev):.2f} GiB")
    b, s = HUBERT_SHAPE
    x = torch.randn((b, s, cfg.d_model), generator=gen, device=dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    def logits(c, model):
        with torch.inference_mode():
            return lm.logits_fn(c, model, lm.forward(c, model, x)[0]).float()

    want = logits(cfg32, m32)
    reset_launch_counts()
    secs = []
    for _ in range(ARCH_PREFILL_CALLS):
        t0 = time.perf_counter()
        got = logits(cfg, m16)
        sync(dev)
        secs.append(time.perf_counter() - t0)
    counts = launch_counts()
    n_flash = counts["flash_attention"]
    causal = logits(cfg.replace(causal=True), m16)
    scale = float(want.abs().max())
    err = float((got - want).abs().max()) / scale
    moved = float((causal - want).abs().max()) / scale
    tol = parity_bound(cfg.n_layers)
    log(f"  [arch] {cfg.name} forward {b} x {s} frames: bf16 "
        + ", ".join(f"{t:.3f} s ({b * s / t:.0f} frames/s)" for t in secs)
        + f"; flash launches {n_flash}; bf16 against float32 (TF32 off): "
        f"max |gap| / max |logit| {err:.3g} (bound {tol:.3g}); run causal: "
        f"{moved:.3g}, {moved / tol:.1f}x the bound")
    if not bool(torch.isfinite(got).all()) or tuple(got.shape) != (
            b, s, cfg.vocab):
        raise AssertionError(f"{cfg.name} logits {tuple(got.shape)}: not "
                             f"[{b}, {s}, {cfg.vocab}] finite values")
    if not err <= tol:
        raise AssertionError(f"{cfg.name}: bf16 {err} of the float32 "
                             f"logits > {tol}")
    if not moved > tol:
        raise AssertionError(f"{cfg.name}: a causal mask moves the logits "
                             f"only {moved} <= {tol}; the check cannot see "
                             f"the mask")
    if dev.type == "cuda" and n_flash != cfg.n_layers * ARCH_PREFILL_CALLS:
        raise AssertionError(f"{cfg.name}: {n_flash} flash launches for "
                             f"{ARCH_PREFILL_CALLS} forwards")
    del m32, m16, x, want, got, causal
    release(dev)

    root = ROOT / "build" / f"arch-train-{os.getpid()}"
    reset_launch_counts()
    try:
        t0 = time.perf_counter()
        losses = train(cfg, steps=HUBERT_TRAIN_STEPS, global_batch=b,
                       seq_len=s, out=str(root), ckpt_every=10**9,
                       log_every=1, seed=seed, device=dev)
        t_train = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    trained = launch_counts()
    both = {k: v + trained[k] for k, v in counts.items()}
    peak = memory_gib(dev, peak=True)
    log(f"  [arch] {cfg.name} train, {HUBERT_TRAIN_STEPS} steps of {b} x "
        f"{s} frames (frontend stub, mask 0.3, bf16, remat {cfg.remat}): "
        f"losses {losses}, {t_train:.3f} s with the first step's set-up; "
        f"flash launches {trained['flash_attention']}; peak device memory "
        f"{peak:.2f} GiB; launches (forwards and train) {both}")
    if not all(math.isfinite(v) for v in losses) \
            or len(losses) != HUBERT_TRAIN_STEPS:
        raise AssertionError(f"{cfg.name} train losses {losses}")
    if dev.type == "cuda" and trained["flash_attention"] != \
            2 * cfg.n_layers * HUBERT_TRAIN_STEPS:
        raise AssertionError(f"{cfg.name}: {trained['flash_attention']} "
                             f"flash launches in {HUBERT_TRAIN_STEPS} train "
                             f"steps")
    release(dev)
    return both


def drive_archs(dev, seed: int) -> tuple:
    """Phase 11: (a)-(c) the decoders, (d) HuBERT, one model on the card
    at a time; returns the launch counts of the four main paths added up
    and the HuBERT gradient's gap."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    for arch, (b, s), (pb, pn) in ARCH_RUNS:
        log(f"  CUT: {arch} prefill {b} x {s} (prefill_32k: 32 x 32768), "
            f"decode {DECODE_BATCH} requests, cache {PROMPT_LEN} + "
            f"{GEN_LEN} (decode_32k: 128 x 32768), parity {pb} x {pn}")
    log(f"  CUT: hubert_xlarge {HUBERT_SHAPE[0]} x {HUBERT_SHAPE[1]} frames "
        f"(train_4k: 256 x 4096), {HUBERT_TRAIN_STEPS} train steps")
    total = {}
    for arch, prefill_shape, parity_shape in ARCH_RUNS:
        c = arch_decoder(dev, gen, arch, prefill_shape, parity_shape)
        total = {k: total.get(k, 0) + v for k, v in c.items()}
    c = arch_hubert(dev, gen, seed)
    total = {k: total.get(k, 0) + v for k, v in c.items()}
    grad_err = hubert_grad_check(dev, seed)
    return total, grad_err


# ---------------------------------------------------------------------------
# phase 12: the recurrent archs at full width (RecurrentGemma 2B, xLSTM 125M)
# ---------------------------------------------------------------------------

# arch, prefill (B, S), decode-versus-prefill parity (B, tokens), the
# positions of the profiled prefill, as phase 11's (a)-(c) through
# ``arch_decoder``, bf16, weights from ``parity_model``.  Cuts: the
# prefill_32k cell's 32 x 32,768 to 2 x 8,192 for RecurrentGemma (phase
# 5's prefill) and 2 x 2,048 for xLSTM, whose mLSTM and sLSTM step through
# the tokens in Python (about 40 kernels a token and layer pair, ~5 x 10^5
# launches a prefill; it was 2 x 4,096 until phase 16 needed the seconds:
# 20-26 s a prefill there on a slow host); decode_32k's 128
# requests and long_500k's 524,288
# positions to phase 5's decode (4 requests, a cache of 16 + 24 tokens: a
# recurrent state has the same size at any position, RecurrentGemma's
# local layers hold 2,048 slots).  xLSTM's prefill is profiled at 512
# positions: it launches the same kernels every token (983,965 at 4,096,
# 240.2 a position, NVIDIA H100 80GB HBM3, 700.00 W), and the profiler's
# processing of a million events took ~80 s.
REC_RUNS = (("recurrentgemma_2b", (2, 8192), (2, 64), 8192),
            ("xlstm_125m", (2, 2048), (2, 64), 512))
# float32 decode vs prefill (TF32 off) at full width, the depth cut to one
# cycle of the pattern plus RecurrentGemma's remainder (5 and 2 layers):
# the reference's own bound for the hybrid and xlstm families
# (tests/test_models.py)
REC_F32_BOUND = 1e-3


def drive_recurrent(dev, seed: int) -> dict:
    """Phase 12: each arch's main path and bf16 parity at full depth
    (``arch_decoder`` with the launches of one prefill and one decode step
    profiled), then its float32 parity at one cycle plus the remainder;
    returns the launch counts of the two main paths added up."""
    import torch
    import repro_torch.configs as C
    gen = torch.Generator(device=dev).manual_seed(seed + 12)
    for arch, (b, s), (pb, pn), _ in REC_RUNS:
        log(f"  CUT: {arch} prefill {b} x {s} (prefill_32k: 32 x 32768), "
            f"decode {DECODE_BATCH} requests, cache {PROMPT_LEN} + "
            f"{GEN_LEN} (decode_32k: 128 x 32768; long_500k: 1 x 524288), "
            f"parity {pb} x {pn}")
    total = {}
    for arch, prefill_shape, parity_shape, profile_len in REC_RUNS:
        t0 = time.perf_counter()
        c = arch_decoder(dev, gen, arch, prefill_shape, parity_shape,
                         profile_len)
        total = {k: total.get(k, 0) + v for k, v in c.items()}
        cfg = C.get(arch)
        cfg32 = cfg.replace(
            n_layers=len(cfg.block_pattern) + len(cfg.remainder_blocks),
            param_dtype="float32", compute_dtype="float32")
        model = parity_model(cfg32, gen, dev)
        pb, pn = parity_shape
        ptoks = torch.randint(0, cfg.vocab, (pb, pn), generator=gen,
                              device=dev, dtype=torch.int32)
        err = decode_vs_prefill(cfg32, model, ptoks, dev)
        log(f"  [rec] {cfg.name} decode vs prefill over {pb} x {pn} tokens, "
            f"float32, {cfg32.n_layers} layers {cfg32.layer_kinds} at full "
            f"width: max |gap| / max |logit| {err:.3g} (bound "
            f"{REC_F32_BOUND}); {time.perf_counter() - t0:.1f} s with the "
            f"bf16 runs")
        if not err <= REC_F32_BOUND:
            raise AssertionError(f"{cfg.name} float32 decode vs prefill: "
                                 f"{err} > {REC_F32_BOUND}")
        del model
        release(dev)
    return total


# ---------------------------------------------------------------------------
# phase 13: the MoE archs at full width (Llama 4 Scout, DeepSeek-V3)
# ---------------------------------------------------------------------------

# arch, its config's changes on the card (the depth cut: every width and
# every expert kept), prefill (B, S), bf16 parity (B, tokens), float32
# parity's changes, as phase 12's runs through ``arch_decoder``.  Neither
# fits one card whole (107.8e9 and 671.6e9 parameters, 216 and 1,343 GB
# in bf16).  Llama 4 Scout at 12 of 48 layers: 56.9 GB (an attn_moe layer
# 4.40 GB with its 16 experts, embedding and head 4.14).  DeepSeek-V3 at 5
# of 61: its 3 mla_dense prefix layers and 2 attn_moe layers (23.0 GB each
# with 256 experts; a third would need 77.5 GB), 54.5 GB with MTP.
# Prefill 2 x 8192 and 2 x 4096 (prefill_32k: 32 x 32,768); phase 5's
# decode (decode_32k: 128 x 32,768).  The bf16 parity runs 4 requests of
# 32 tokens, held before each request's first routing flip; float32
# (TF32 off) runs 2 x 16 tokens, under the capacity's floor of min(N, 32)
# slots an expert on both paths, within the reference's 2e-4
# (tests/test_models.py), at 2 layers (~26 and ~58 GB in float32).
MOE_RUNS = (("llama4_scout_17b_a16e", dict(n_layers=12), (2, 8192), (4, 32),
             dict(n_layers=2)),
            ("deepseek_v3_671b", dict(n_layers=5), (2, 4096), (4, 32),
             dict(prefix_blocks=("mla_dense",), n_layers=2)))
MOE_F32_SHAPE = (2, 16)
MOE_F32_BOUND = 2e-4


def drive_moe(dev, seed: int) -> dict:
    """Phase 13: each arch's main path and bf16 parity at its cut depth
    (``arch_decoder``, one prefill and one decode step profiled, the
    profiled prefill's dropped slots), then its float32 parity at 2 layers
    (``moe_decode_vs_prefill``: every position held, the flips printed);
    one model on the card at a time.  Returns the launch counts of the two
    main paths added up."""
    import torch
    import repro_torch.configs as C
    gen = torch.Generator(device=dev).manual_seed(seed + 13)
    for arch, cut, (b, s), (pb, pn), _ in MOE_RUNS:
        full = C.get(arch)
        log(f"  CUT: {arch} {cut['n_layers']} of {full.n_layers} layers "
            f"(every width, all {full.moe.num_experts} experts), prefill "
            f"{b} x {s} (prefill_32k: 32 x 32768), decode {DECODE_BATCH} "
            f"requests, cache {PROMPT_LEN} + {GEN_LEN} (decode_32k: 128 x "
            f"32768), parity {pb} x {pn}")
    total = {}
    for arch, cut, prefill_shape, parity_shape, f32 in MOE_RUNS:
        t0 = time.perf_counter()
        cfg = C.get(arch).replace(**cut)
        c = arch_decoder(dev, gen, arch, prefill_shape, parity_shape,
                         prefill_shape[1], cfg=cfg)
        total = {k: total.get(k, 0) + v for k, v in c.items()}
        cfg32 = C.get(arch).replace(param_dtype="float32",
                                    compute_dtype="float32", **f32)
        model = parity_model(cfg32, gen, dev)
        pb, pn = MOE_F32_SHAPE
        ptoks = torch.randint(0, cfg.vocab, (pb, pn), generator=gen,
                              device=dev, dtype=torch.int32)
        par = moe_decode_vs_prefill(cfg32, model, ptoks, dev)
        log(f"  [moe] {cfg.name} decode vs prefill over {pb} x {pn} tokens, "
            f"float32, {cfg32.n_layers} layers {cfg32.layer_kinds} at full "
            f"width: max |gap| / max |logit| {par['err_all']:.3g} (bound "
            f"{MOE_F32_BOUND}); routing flips by MoE layer {par['flips']}, "
            f"slots dropped at {par['lost']} positions; "
            f"{time.perf_counter() - t0:.1f} s with the bf16 runs")
        if not par["err_all"] <= MOE_F32_BOUND or par["lost"]:
            raise AssertionError(f"{cfg.name} float32 decode vs prefill: "
                                 f"{par['err_all']} > {MOE_F32_BOUND}, or "
                                 f"{par['lost']} positions dropped a slot")
        del model
        release(dev)
    return total


# ---------------------------------------------------------------------------
# phase 14: the dry-run on meta (launch.dryrun, launch.roofline), checked on
# the card
# ---------------------------------------------------------------------------

# (b) the cells the card already runs, at their shapes there: Qwen3-1.7B's
# train step as phase 10 (c) (its config's own remat full and loss_chunk
# 512), Gemma 2 9B's prefill and its decode step as phase 5 (4 requests, a
# cache of phase 5's prompt, greedy and profiled tokens): (label, arch,
# kind, B, S)
DRYRUN_CHECKS = (
    ("phase 10 (c)", TRAIN_ARCH, "train", TRAIN_BATCH, TRAIN_LEN),
    ("phase 5", LM_ARCH, "prefill", PREFILL_BATCH, PREFILL_LEN),
    ("phase 5", LM_ARCH, "decode", DECODE_BATCH,
     PROMPT_LEN + GEN_LEN + PROFILE_STEPS),
)
# argument_size within this share of the device bytes the arguments hold
# (the caching allocator rounds each block up to 512 bytes)
DRYRUN_ARG_REL = 0.005
DRYRUN_TIMED = 2              # timed calls after the counted one
DRYRUN_ALL_S = 600             # (a)'s time limit
# (a) runs in the background from phase 3 on, in this many processes at
# this niceness, so that it takes idle cores and yields to the phases on
# the card: its critical path is DeepSeek-V3's train_4k (110-145 s in one
# process), the other 30 cells about 330 s of one core in all
DRYRUN_JOBS = 2
DRYRUN_NICE = 19


class DryrunAll:
    """(a): ``python -m repro_torch.launch.dryrun --all`` on ``meta``,
    started by ``start()`` in a process group of its own (``DRYRUN_JOBS``
    processes at niceness ``DRYRUN_NICE``, its output to a file under the
    git-ignored ``build/``) and waited for by ``finish()``, which kills the
    group past ``DRYRUN_ALL_S`` from the start and raises; ``kill()`` stops
    a group still running (the script stops every process it starts)."""

    def start(self) -> "DryrunAll":
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        self.log = ROOT / "build" / f"dryrun-all-{os.getpid()}.log"
        self.log.parent.mkdir(parents=True, exist_ok=True)
        with open(self.log, "w") as out:
            self.proc = subprocess.Popen(
                ["nice", "-n", str(DRYRUN_NICE), sys.executable, "-m",
                 "repro_torch.launch.dryrun", "--all", "--jobs",
                 str(DRYRUN_JOBS)], cwd=ROOT, env=env, stdout=out,
                stderr=subprocess.STDOUT, start_new_session=True)
        self.t0 = time.perf_counter()
        return self

    def kill(self) -> None:
        import signal
        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.wait()
        self.log.unlink(missing_ok=True)

    def finish(self) -> float:
        """The seconds of each cell and ``launch.roofline --md``'s table: a
        record of every (arch x shape) cell and no ``ERR`` row, or it
        raises.  Returns the background run's seconds."""
        import repro_torch.configs as C
        from repro_torch.launch import roofline
        left = DRYRUN_ALL_S - (time.perf_counter() - self.t0)
        waited = time.perf_counter()
        try:
            self.proc.wait(timeout=max(left, 0))
        except subprocess.TimeoutExpired:
            self.kill()
            raise AssertionError(f"dryrun --all ran past {DRYRUN_ALL_S} s")
        waited = time.perf_counter() - waited
        secs = time.perf_counter() - self.t0
        for line in self.log.read_text().splitlines():
            log(f"  [dryrun] {line}")
        self.log.unlink()
        if self.proc.returncode != 0:
            raise AssertionError(f"dryrun --all failed (rc "
                                 f"{self.proc.returncode})")
        recs = roofline.load_all("baseline")
        for line in roofline.markdown_table(recs).splitlines():
            log(f"  [dryrun] {line}")
        cells = {(r["arch"], r["shape"]) for r in recs}
        bad = [(r["arch"], r["shape"]) for r in recs
               if "error" in r["analysis"]]
        if cells != set(C.all_cells()) or len(recs) != len(cells) or bad:
            raise AssertionError(f"dryrun --all: {len(recs)} records for "
                                 f"{len(C.all_cells())} cells, errors {bad}")
        log(f"  [dryrun] (a) {len(recs)} cells on meta, in the background "
            f"since phase 3 ({DRYRUN_JOBS} processes at nice {DRYRUN_NICE}):"
            f" done {secs:.1f} s after its start; this phase waited "
            f"{waited:.1f} s for it")
        return secs


def dryrun_check(dev, seed: int, label: str, arch: str, kind: str, b: int,
                 s: int) -> None:
    """(b) one cell: its dry-run on ``meta``, then the same step on the
    card, once under ``FlopCounterMode`` and ``DRYRUN_TIMED`` times timed
    (peak memory from the last); the FLOPs must be equal and
    ``argument_size`` within ``DRYRUN_ARG_REL`` of the device bytes the
    arguments hold."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    import repro_torch.configs as C
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS
    from repro_torch.launch.steps import input_specs
    from repro_torch.models.config import ShapeCell
    cfg = C.get(arch)
    cell = ShapeCell(f"{kind}_{b}x{s}", s, b, kind)
    rec = dryrun.dryrun(cfg, cell, tag="card", arch=arch)
    a = roofline.analyze(rec)
    mem = rec["full"]["memory"]
    release(dev)
    cuda = dev.type == "cuda"
    before = torch.cuda.memory_allocated(dev) if cuda else 0
    gen = torch.Generator(device=dev).manual_seed(seed + 14)
    step, args = input_specs(cfg, cell, device=dev, generator=gen)
    sync(dev)
    held = torch.cuda.memory_allocated(dev) - before if cuda \
        else dryrun.storage_bytes(args)
    with FlopCounterMode(display=False) as fc:
        out = step(*args)
        sync(dev)
    del out
    secs = []
    for _ in range(DRYRUN_TIMED):
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = step(*args)
        sync(dev)
        secs.append(time.perf_counter() - t0)
        del out
    peak = torch.cuda.max_memory_allocated(dev) - before if cuda \
        else float("nan")
    card_flops = fc.get_total_flops()
    predicted = mem["argument_size"] + mem["output_size"] + mem["temp_size"]
    t = secs[-1]
    if kind == "decode":
        share = roofline.useful_decode_bytes(arch, cell) / (t * HBM_BW)
        what = "useful_decode_bytes / (s x 3.35 TB/s)"
    else:
        share = roofline.model_flops(arch, cell) / (t * PEAK_FLOPS)
        what = "model_flops / (s x 989 TFLOP/s)"
    rel = abs(mem["argument_size"] - held) / max(held, 1)
    log(f"  [dryrun] (b) {cfg.name} {kind} {b} x {s} ({label}): meta "
        f"{rec['full']['trace_s']:.2f} s; FLOPs meta {rec['full']['flops']:.6g}"
        f", card {card_flops:.6g}; argument_size {mem['argument_size']} "
        f"against {held} device bytes ({rel:.3%}); predicted peak "
        f"{predicted / 2**30:.2f} GiB against max_memory_allocated "
        f"{peak / 2**30:.2f} GiB; measured {', '.join(f'{x:.4f}' for x in secs)}"
        f" s against analyze's t_step {a['t_step_s']:.4f} s ({a['dominant']}:"
        f" compute {a['t_compute_s']:.4f}, memory {a['t_memory_s']:.4f}); "
        f"share of the bound {share:.2%} ({what})")
    del args, step
    release(dev)
    if rec["full"]["flops"] != card_flops:
        raise AssertionError(f"{cfg.name} {kind}: the dry-run counts "
                             f"{rec['full']['flops']} FLOPs, the card "
                             f"{card_flops}")
    if not rel <= DRYRUN_ARG_REL:
        raise AssertionError(f"{cfg.name} {kind}: argument_size "
                             f"{mem['argument_size']} is {rel:.3%} off the "
                             f"{held} device bytes the arguments hold")


def drive_dryrun(dev, seed: int, background: DryrunAll) -> dict:
    """Phase 14: (a) every cell on ``meta`` (``background``, started
    before phase 3), then (b) ``DRYRUN_CHECKS`` on the card, the main path
    of the phase: the launch counts are set to 0 before (b) and read after
    it."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    background.finish()
    reset_launch_counts()
    for check in DRYRUN_CHECKS:
        dryrun_check(dev, seed, *check)
    return launch_counts()


# ---------------------------------------------------------------------------
# phase 6: the streaming refresh path (repro_torch.stream.StreamSession)
# ---------------------------------------------------------------------------

STREAM_FRAC = 2**-10          # (a): 1,024 of 2^20 documents an epoch
STREAM_EPOCHS = 16            # (a): snapshot (d) after half of them
STREAM_BATCH_ROWS = 4096      # (a), (e): max_batch_records
MRBG_EPOCHS, MRBG_DOCS = 8, 16            # (b): snapshot (d) after half
BURST_RECORDS, BURST_REWRITES = 256, 8    # (b): the adversarial burst
CROSSOVER_FRAC = 0.3          # (c): one batch rewriting 30% of the corpus
# (e): PageRank's stream, cut from the scale's 2^22 vertices: a refresh
# took 67-91 s there, more than this run's time limit leaves
STREAM_VERTICES = 2**20
STREAM_PR_FRAC, STREAM_PR_EPOCHS = 1e-3, 2
COALESCE_SIZES = (64, 4096, 2**20)        # (f)


def stream_check(label: str, got: np.ndarray, cur: np.ndarray) -> None:
    want = np.bincount(cur.ravel(), minlength=VOCAB)
    if got.shape != (VOCAB,) or not np.isfinite(got).all() \
            or not np.array_equal(got, want.astype(got.dtype)):
        bad = int(np.sum(got != want)) if got.shape == want.shape else -1
        raise AssertionError(f"stream {label}: result differs from "
                             f"np.bincount at {bad} keys")


def rewrite_record(rng, cur: np.ndarray, rows: np.ndarray, epoch: int,
                   times: int = 1):
    """One DeltaRecord rewriting ``rows`` of the corpus ``times`` times in
    a row ('-' old, '+' new each time), and ``cur`` updated in place."""
    from repro_torch.apps import wordcount as wc
    from repro_torch.stream import DeltaRecord
    mut = wc.doc_mutator(VOCAB)
    rid, words = [], []
    for _ in range(times):
        new = mut(rng, rows, {"w": cur[rows]})["w"]
        w = np.empty((2 * rows.size, DOC_LEN), np.int32)
        w[0::2], w[1::2] = cur[rows], new
        cur[rows] = new
        rid.append(np.repeat(rows, 2))
        words.append(w)
    return DeltaRecord(np.concatenate(rid).astype(np.int32),
                       {"w": np.concatenate(words)},
                       np.tile(np.int8([-1, 1]), rows.size * times),
                       epoch=epoch)


def restore_stream(spec, mirror, path, cfg, scfg, source=None, name="r"):
    """A fresh StreamSession on ``mirror`` whose engine is restored from
    ``path`` (``Session.restore``)."""
    from repro_torch.api import Session
    from repro_torch.stream import StreamSession
    ss = StreamSession(spec, mirror, source=source, config=cfg,
                       stream=scfg, name=name)
    ss.session = Session.restore(spec, str(path), cfg)
    return ss


def log_split(label: str, ss) -> None:
    sp = ss.last_split
    log(f"  [{label}] batch split: coalesce {sp['coalesce']:.4f} s, mirror "
        f"update {sp['mirror']:.4f} s, refresh {sp['refresh']:.4f} s")


def require_same(label: str, got: np.ndarray, want: np.ndarray) -> None:
    if got.dtype != want.dtype or not np.array_equal(got, want):
        raise AssertionError(f"{label}: restored session differs from the "
                             f"uninterrupted one")


def stream_accumulator(dev, rng, docs: np.ndarray, seed: int, root: Path):
    """(a) the accumulator path through the background worker, its first
    batch building the kernels; (d) snapshot after half the epochs and
    restore; (c) one batch past the crossover."""
    from repro_torch.api import RunConfig
    from repro_torch.apps import wordcount as wc
    from repro_torch.kernels import _build, jitcache
    from repro_torch.stream import StreamConfig, StreamSession
    cfg = RunConfig(device=dev.type, onestep_path="auto")
    scfg = StreamConfig(policy="paper", max_batch_records=STREAM_BATCH_ROWS)
    spec, data, source = wc.make_stream(docs, VOCAB, frac=STREAM_FRAC,
                                        seed=seed, epochs=STREAM_EPOCHS // 2)
    ss = StreamSession(spec, data, source=source, config=cfg, stream=scfg,
                       name="acc")
    t0 = time.perf_counter()
    ss.start(background=False)
    t_run = time.perf_counter() - t0
    log(f"  [acc] initial run {t_run:.3f} s ({docs.size} edges)")
    if dev.type == "cuda":
        # a serving node whose kernel build was wiped: the worker's first
        # batch builds every kernel (into an empty directory) and loads
        # the coalescer's and the refresh's
        _build.reset(_build.BUILD_DIR / f"stream-{os.getpid()}")
    g0 = jitcache.snapshot()
    t0 = time.perf_counter()
    with ss:
        ss.drain(timeout=900)
    t_half = time.perf_counter() - t0
    mirror = ss.mirror_kv()
    ss.snapshot(str(root / "acc"))
    source.epochs = STREAM_EPOCHS
    t0 = time.perf_counter()
    with ss:
        ss.drain(timeout=900)
    t_drain = t_half + time.perf_counter() - t0
    g1 = jitcache.snapshot()
    stream_check("acc (a)", ss.result["c"], source.values["w"])
    m = ss.metrics.snapshot()
    lat, ref = ss.metrics._latencies, ss.metrics._refresh_seconds
    rows = 2 * int(len(docs) * STREAM_FRAC)
    log(f"  [acc] (a) {STREAM_EPOCHS} epochs of {rows} rows in "
        f"{m['batches']} batches through the worker: drain "
        f"{t_drain:.3f} s, equal to np.bincount; updates/s "
        f"{m['updates_per_sec']:.1f}, refresh p50 {m['refresh_p50_ms']:.3f}"
        f" ms, p95 {m['refresh_p95_ms']:.3f} ms, latency p50 "
        f"{m['latency_p50_ms']:.3f} ms, p95 {m['latency_p95_ms']:.3f} ms; "
        f"retrace_batches {m['retrace_batches']}, refreshes "
        f"{m['refreshes']}; first batch latency {lat[0]:.3f} s (refresh "
        f"{ref[0]:.4f} s); jitcache traces +{g1['traces'] - g0['traces']}, "
        f"compiles +{g1['compiles'] - g0['compiles']} in "
        f"{g1['compile_seconds'] - g0['compile_seconds']:.3f} s")
    log_split("acc", ss)
    if dev.type == "cuda" and m["retrace_batches"] != 1:
        raise AssertionError(f"stream (a): {m['retrace_batches']} batches "
                             f"marked retraced, not the one that built")

    # (d) the snapshot restored into a fresh StreamSession on the device
    _, _, src2 = wc.make_stream(docs, VOCAB, frac=STREAM_FRAC, seed=seed,
                                epochs=STREAM_EPOCHS)
    for _ in range(STREAM_EPOCHS // 2):
        src2.poll(1)                      # the epochs before the snapshot
    rs = restore_stream(spec, mirror, root / "acc", cfg, scfg, src2)
    t0 = time.perf_counter()
    with rs:
        rs.drain(timeout=900)
    require_same("stream (d) acc", rs.result["c"], ss.result["c"])
    log(f"  [acc] (d) restored at epoch {STREAM_EPOCHS // 2} into a fresh "
        f"StreamSession on {dev.type}, {STREAM_EPOCHS // 2} more epochs in "
        f"{time.perf_counter() - t0:.3f} s: bitwise equal to the "
        f"uninterrupted session")
    del rs

    # (c) one batch past the crossover: a rerun
    cur = source.values["w"].copy()
    rows = np.sort(rng.choice(len(docs), int(CROSSOVER_FRAC * len(docs)),
                              replace=False))
    rec = rewrite_record(rng, cur, rows, STREAM_EPOCHS)
    e0 = ss.session.epoch
    t0 = time.perf_counter()
    ss.submit_record(rec)
    ss.drain(timeout=900)
    t_c = time.perf_counter() - t0
    dec = ss.scheduler.decisions[-1]
    rep = ss.session.history[-1]
    if dec.action != "rerun" or ss.session.epoch != e0 + 1 \
            or rep.mode != "onestep":
        raise AssertionError(f"stream (c): action {dec.action}, epoch "
                             f"{ss.session.epoch} (was {e0}), mode "
                             f"{rep.mode}; a rerun was due")
    stream_check("acc (c)", ss.result["c"], cur)
    log(f"  [acc] (c) {rows.size} documents rewritten in one batch "
        f"({rec.n_rows} rows): {dec.reason}; action rerun, epoch {e0} -> "
        f"{ss.session.epoch}, {t_c:.3f} s, equal to np.bincount")
    log_split("acc (c)", ss)
    return dict(run_s=t_run, drain_s=t_drain, crossover_s=t_c,
                first_batch_s=lat[0], metrics=m)


def stream_mrbg(dev, rng, docs: np.ndarray, root: Path):
    """(b) the MRBG path, step by step, with an adversarial burst; (d)
    snapshot after half the epochs and restore."""
    from repro_torch.api import RunConfig
    from repro_torch.apps import wordcount as wc
    from repro_torch.stream import StreamConfig, StreamSession
    cfg = RunConfig(device=dev.type, onestep_path="mrbg")
    scfg = StreamConfig(policy="paper", max_batch_records=2**22)
    spec, data = wc.make_job(docs, VOCAB)
    ss = StreamSession(spec, data, config=cfg, stream=scfg, name="mrbg")
    t0 = time.perf_counter()
    ss.start(background=False)
    t_run = time.perf_counter() - t0
    log(f"  [mrbg] initial run {t_run:.3f} s")
    cur = docs.copy()
    after = []                            # records after the snapshot
    t_steps = []
    for e in range(MRBG_EPOCHS):
        rec = rewrite_record(rng, cur, np.sort(rng.choice(
            len(docs), MRBG_DOCS, replace=False)), e)
        t0 = time.perf_counter()
        ss.submit_record(rec)
        ss.drain(timeout=900)
        t_steps.append(time.perf_counter() - t0)
        stream_check(f"mrbg (b) epoch {e}", ss.result["c"], cur)
        if e == MRBG_EPOCHS // 2 - 1:
            mirror = ss.mirror_kv()
            t0 = time.perf_counter()
            ss.snapshot(str(root / "mrbg"))
            t_snap = time.perf_counter() - t0
        elif e >= MRBG_EPOCHS // 2:
            after.append(rec)
    log(f"  [mrbg] (b) {MRBG_EPOCHS} epochs of {MRBG_DOCS} documents, each "
        f"equal to np.bincount: {', '.join(f'{t:.3f}' for t in t_steps)} s; "
        f"snapshot at epoch {MRBG_EPOCHS // 2} {t_snap:.3f} s")
    log_split("mrbg", ss)
    rows = np.sort(rng.choice(len(docs), BURST_RECORDS, replace=False))
    rec = rewrite_record(rng, cur, rows, MRBG_EPOCHS, times=BURST_REWRITES)
    after.append(rec)
    t0 = time.perf_counter()
    ss.submit_record(rec)
    ss.drain(timeout=900)
    t_burst = time.perf_counter() - t0
    stream_check("mrbg (b) burst", ss.result["c"], cur)
    co = ss.session.history[-1].coalesce
    if (co["n_in"], co["n_out"]) != (rec.n_rows, 2 * BURST_RECORDS):
        raise AssertionError(f"stream (b) burst: coalescer {co}")
    sb, lb = ss.store_bytes(), ss.session.store_live_bytes()
    reclaimed = ss.compact_store()
    log(f"  [mrbg] (b) burst of {BURST_RECORDS} records rewritten "
        f"{BURST_REWRITES} times: coalescer n_in {co['n_in']} -> n_out "
        f"{co['n_out']} ({co['n_cancelled']} cancelled), {t_burst:.3f} s, "
        f"equal to np.bincount; store_bytes {sb}, store_live_bytes {lb}, "
        f"compact_store reclaimed {reclaimed} bytes (now {ss.store_bytes()})")
    log_split("mrbg burst", ss)

    t0 = time.perf_counter()
    rs = restore_stream(spec, mirror, root / "mrbg", cfg, scfg, name="rmrbg")
    t_restore = time.perf_counter() - t0
    rs.start(background=False)
    for rec in after:
        rs.submit_record(rec)
        rs.drain(timeout=900)
    require_same("stream (d) mrbg", rs.result["c"], ss.result["c"])
    log(f"  [mrbg] (d) restored at epoch {MRBG_EPOCHS // 2} "
        f"({t_restore:.3f} s), {len(after)} more batches: bitwise equal to "
        f"the uninterrupted session")
    return dict(run_s=t_run, steps_s=t_steps, burst_s=t_burst,
                snapshot_s=t_snap, restore_s=t_restore)


def stream_pagerank(dev, rng, vertices: int):
    """(e) PageRank's stream, checked against the float64 fixpoint of the
    final graph within ``pagerank_bound``."""
    from repro_torch.api import RunConfig
    from repro_torch.apps import pagerank
    from repro_torch.stream import StreamConfig, StreamSession
    nbrs = pagerank.random_graph(vertices, OUT_SLOTS, seed=int(
        rng.integers(2**31)), p_edge=P_EDGE)
    spec, struct, source = pagerank.make_stream(
        nbrs, frac=STREAM_PR_FRAC, seed=int(rng.integers(2**31)),
        epochs=STREAM_PR_EPOCHS, p_edge=P_EDGE)
    cfg = RunConfig(device=dev.type, cpc_threshold=PR_CPC)
    scfg = StreamConfig(policy="paper", max_batch_records=STREAM_BATCH_ROWS)
    ss = StreamSession(spec, struct, source=source, config=cfg, stream=scfg,
                       name="pagerank")
    t0 = time.perf_counter()
    ss.start(background=False)
    t_run = time.perf_counter() - t0
    run_change = ss.session.history[0].max_change[-1]
    t0 = time.perf_counter()
    with ss:
        ss.drain(timeout=1800)
    t_drain = time.perf_counter() - t0
    reps = ss.session.history[1:]
    if any(r.iters >= cfg.refresh_iters_ for r in reps):
        raise AssertionError("stream (e): a refresh hit max_iters")
    want, ch = pagerank_fixpoint(source.values["nbrs"], dev=dev)
    got = ss.result["r"]
    err = float(np.abs(got.astype(np.float64) - want).sum())
    # as phase 4: a vertex no refresh touched holds the run's last change,
    # a touched one at most the CPC threshold plus the refresh tolerance
    held = vertices * max(run_change, cfg.cpc_threshold + cfg.refresh_tol_)
    lim = pagerank_bound(vertices, held, ch)
    batches = ", ".join(f"{r.mode} {r.iters} it {r.seconds:.3f} s"
                        for r in reps)
    log(f"  [pagerank] (e) {vertices} vertices (CUT from {FULL_VERTICES}), "
        f"{STREAM_PR_EPOCHS} epochs rewiring {STREAM_PR_FRAC:g} of them: run "
        f"{t_run:.3f} s, drain {t_drain:.3f} s in {len(reps)} batches "
        f"({batches}); L1 error {err:.6g} <= bound {lim:.6g}")
    log_split("pagerank", ss)
    if not (np.isfinite(got).all() and err <= lim):
        raise AssertionError(f"stream (e): L1 error {err} > {lim}")
    return dict(run_s=t_run, drain_s=t_drain)


def time_coalescer(dev, rng) -> dict:
    """(f) the coalescer's device part alone, against the CPU tensors'
    route (the plain versions) moved back to the card: perm, keep, firsts,
    net and counts exactly equal; CUDA-event ms, one profiled call, and
    the whole ``coalesce_rows`` (host compaction included)."""
    import torch
    from repro_torch.stream.coalesce import (
        _coalesce_kernel, coalesce_rows, pad_rows,
    )
    out = {}
    for n in COALESCE_SIZES:
        m = n // 2
        rid = np.repeat(rng.permutation(m), 2).astype(np.int32)
        cancel = np.repeat(rng.random(m) < 1 / 3, 2)  # '+' then '-'
        sign = np.where(cancel, np.tile(np.int8([1, -1]), m),
                        np.tile(np.int8([-1, 1]), m)).astype(np.int8)
        inputs = pad_rows(rid, sign, n, dev)
        got = _coalesce_kernel(*inputs)
        t0 = time.perf_counter()
        want = _coalesce_kernel(*(t.cpu() for t in inputs))
        plain_s = time.perf_counter() - t0
        for part, g, w in zip(("perm", "keep", "firsts", "net", "counts"),
                              got, want):
            require_equal(f"coalesce n={n} {part}", g, w.to(dev))
        fn = lambda: _coalesce_kernel(*inputs)
        ms = cuda_ms(fn)
        vals = {"w": np.zeros((n, 1), np.int32)}
        coalesce_rows(rid, vals, sign, device=dev)
        t0 = time.perf_counter()
        res = coalesce_rows(rid, vals, sign, device=dev)
        host_s = time.perf_counter() - t0
        out[n] = dict(ms=ms, coalesce_rows_s=host_s, plain_s=plain_s)
        log(f"  coalesce n={n} ({int(cancel.sum()) // 2} of {m} records "
            f"cancel; n_out {res.n_out}): device part equal to the CPU "
            f"route; coalesce_rows {host_s * 1e3:.3f} ms on the host clock, "
            f"CPU route {plain_s * 1e3:.3f} ms; device part "
            + split_line(fn, dev, ms))
    return out


def drive_stream(dev, rng, docs: np.ndarray, seed: int, vertices: int):
    import shutil
    from repro_torch.kernels import launch_counts, reset_launch_counts
    root = ROOT / "build" / f"stream-ckpt-{os.getpid()}"
    reset_launch_counts()
    parts = {}
    try:
        t0 = time.perf_counter()
        parts["acc"] = stream_accumulator(dev, rng, docs, seed, root)
        a = launch_counts()
        log(f"  [acc] (a)+(c)+(d) {time.perf_counter() - t0:.1f} s; "
            f"launches {a}")
        t0 = time.perf_counter()
        parts["mrbg"] = stream_mrbg(dev, rng, docs, root)
        b = launch_counts()
        log(f"  [mrbg] (b)+(d) {time.perf_counter() - t0:.1f} s; launches "
            f"{ {k: b[k] - a[k] for k in b} }")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    release(dev)
    t0 = time.perf_counter()
    parts["pagerank"] = stream_pagerank(dev, rng, min(STREAM_VERTICES,
                                                      vertices))
    counts = launch_counts()
    log(f"  [pagerank] (e) {time.perf_counter() - t0:.1f} s; launches "
        f"{ {k: counts[k] - b[k] for k in counts} }")
    for name in ("sort_lex", "segment_sum", "fused_shuffle_reduce"):
        if dev.type == "cuda" and counts[name] == 0:
            raise AssertionError(f"stream path launched no {name}")
    release(dev)
    parts["coalesce"] = time_coalescer(dev, rng)
    return counts, parts


# ---------------------------------------------------------------------------
# phase 7: the serving tier (repro_torch.serve)
# ---------------------------------------------------------------------------

# (a) benchmarks/serve_load.py's largest throughput cell
FLEET_TENANTS, FLEET_VOCAB, FLEET_DOCS, FLEET_DOC_LEN = 1000, 64, 8, 4
FLEET_BATCH = 128                 # max_batch_tenants
FLEET_WARM, FLEET_ROUNDS = 2, 3
# (b) wide tenants: 2^20 edges each, 2^25 in the fleet (half phase 3's
# corpus: cut from 64 tenants to keep a slow host inside the run's time
# limit)
WIDE_TENANTS, WIDE_VOCAB, WIDE_DOCS, WIDE_DOC_LEN = 32, 2**15, 2**14, 64
WIDE_ROWS, WIDE_ROUNDS = 16, 3    # documents rewritten a tenant a round
# (c) serve_load.py's overload cell
OVER_BEST_EFFORT, OVER_VOCAB, OVER_DOCS, OVER_DOC_LEN = 32, 512, 64, 128
OVER_ROWS, OVER_SECONDS, OVER_P95_MS = 8, 15.0, 500.0


def serve_check(label: str, tier, mirrors: dict, vocab: int) -> None:
    """Every tenant's counts equal np.bincount of its mirror exactly."""
    for name, docs in mirrors.items():
        got = tier[name].result["c"]
        want = np.bincount(docs[docs >= 0].ravel(), minlength=vocab)
        if got.shape != (vocab,) or not np.isfinite(got).all() \
                or not np.array_equal(got, want.astype(got.dtype)):
            raise AssertionError(f"serve {label}: tenant {name} differs "
                                 f"from np.bincount")


def serve_same(label: str, got: dict, want: dict) -> None:
    """Batched and sequential results bitwise equal, tenant by tenant."""
    for name, w in want.items():
        g = got[name]
        if g.dtype != w.dtype or not np.array_equal(g, w):
            raise AssertionError(f"serve {label}: tenant {name} batched "
                                 f"differs from sequential")


def fused_paths() -> dict:
    """Fused merge launches by path since the last reset."""
    from repro_torch.kernels import launch_shapes
    out = {}
    for (_, _, _, path), k in launch_shapes()["fused_shuffle_reduce"].items():
        out[path] = out.get(path, 0) + k
    return out


def one_block_line() -> str:
    """The one-block fused launches since the last reset by (N, key_cap):
    their count, N's range and median, the launches at each key_cap and
    the commonest shapes."""
    from collections import Counter
    from repro_torch.kernels import launch_shapes
    by, caps = Counter(), Counter()
    for (n, cap, _, path), k in launch_shapes()[
            "fused_shuffle_reduce"].items():
        if path == "one block":
            by[(n, cap)] += k
            caps[cap] += k
    if not by:
        return "no one-block launches"
    ns = np.repeat([n for n, _ in by], list(by.values()))
    return (f"{ns.size} one-block launches, N {ns.min()}-{ns.max()} (median "
            f"{np.median(ns):g}), by key_cap {dict(sorted(caps.items()))}, "
            f"commonest (N, key_cap) {by.most_common(10)}")


def profiled_round(tier, mirrors: dict, dev, vocab: int, seed: int,
                   rows: int = 1) -> dict:
    """One more round (one update a tenant), its sweep under
    ``torch.profiler`` (``device_shares``)."""
    from repro_torch.serve import loadgen
    rng = np.random.default_rng(seed)
    for name in mirrors:
        loadgen.submit_update(tier, mirrors, name, rng, vocab, rows)
    return device_shares(lambda: tier.drain(timeout=1800), dev, top=8)


def fleet_cell(dev, mode: str):
    """(a) 1,000 small tenants: 2 warm rounds, 3 timed, one profiled.  The
    sequential leg runs through MultiSessionServer, which is (e)."""
    import warnings
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import ServeTier, SLOClass, loadgen
    if mode == "batched":
        tier = ServeTier(max_batch_tenants=FLEET_BATCH)
    else:
        from repro_torch.stream import MultiSessionServer
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            tier = MultiSessionServer()
        if not any(issubclass(w.category, DeprecationWarning)
                   for w in caught):
            raise AssertionError("serve (e): MultiSessionServer did not "
                                 "warn DeprecationWarning")
        if not isinstance(tier, ServeTier) or tier.batch_refresh:
            raise AssertionError("serve (e): the shim is not a per-tenant "
                                 "ServeTier")
    t0 = time.perf_counter()
    # throughput class: never shed, so both legs refresh the same updates
    mirrors = loadgen.make_fleet(
        tier, FLEET_TENANTS, vocab=FLEET_VOCAB, n_docs=FLEET_DOCS,
        doc_len=FLEET_DOC_LEN, seed=FLEET_TENANTS, device=dev.type,
        slo_of=lambda i: SLOClass.throughput())
    t_admit = time.perf_counter() - t0
    t0 = time.perf_counter()
    loadgen.run_rounds(tier, mirrors, FLEET_WARM, vocab=FLEET_VOCAB)
    t_warm = time.perf_counter() - t0
    reset_launch_counts()
    n_log = len(tier.launch_log)
    res = loadgen.run_rounds(tier, mirrors, FLEET_ROUNDS, vocab=FLEET_VOCAB,
                             seed=9)
    counts, paths, one_block = launch_counts(), fused_paths(), \
        one_block_line()
    serve_check(f"(a) {mode}", tier, mirrors, FLEET_VOCAB)
    stats = tier.stats()
    p95 = float(np.median([t["latency_p95_ms"]
                           for t in stats["tenants"].values()]))
    launches = [(e["tenants"], e["combined"], e["affected"], e["key_cap"])
                for e in list(tier.launch_log)[n_log:]]
    t0 = time.perf_counter()
    p = profiled_round(tier, mirrors, dev, FLEET_VOCAB, 10)
    t_prof = time.perf_counter() - t0
    serve_check(f"(a) {mode}, profiled round", tier, mirrors, FLEET_VOCAB)
    round_ms = res["wall_s"] / FLEET_ROUNDS * 1e3
    log(f"  [serve] (a) {mode}: {FLEET_TENANTS} tenants admitted in "
        f"{t_admit:.3f} s; {FLEET_WARM} warm rounds {t_warm:.3f} s; "
        f"{FLEET_ROUNDS} rounds {res['wall_s']:.3f} s, "
        f"{res['updates_per_sec']:.1f} updates/s; batched launches "
        f"{stats['batched_launches']}, refreshes "
        f"{stats['batched_refreshes']}; median p95 latency {p95:.3f} ms; "
        f"retrace batches {stats['retrace_batches']}; launches {counts}; "
        f"fused paths {paths}; timed batched launches (tenants, combined "
        f"rows, affected keys, key_cap) "
        f"{launches}")
    log(f"  [serve] (a) {mode}, the timed rounds' fused merges: "
        f"{one_block}")
    log(f"  [serve] (a) {mode}, one profiled sweep ({t_prof:.3f} s with "
        f"the profile's processing): {p['kernels']} kernels, "
        f"device busy {p['busy_ms']:.3f} ms of {p['wall_ms']:.3f} ms "
        f"profiled (idle {1 - p['busy_ms'] / p['wall_ms']:.1%}; "
        f"{1 - p['busy_ms'] / round_ms:.1%} of an unprofiled round's "
        f"{round_ms:.3f} ms); by kernel {p['top']}")
    out = {n: tier[n].result["c"].copy() for n in mirrors}
    return out, res["updates_per_sec"], counts


def wide_cell(dev, mode: str, spill_dir: Path):
    """(b) WIDE_TENANTS tenants of 2^20 edges: 3 timed rounds of 16
    documents a tenant, one profiled; (d), batched only: the store
    budget."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import ServeTier, SLOClass, loadgen
    tier = ServeTier(batch_refresh=(mode == "batched"),
                     max_batch_tenants=WIDE_TENANTS,
                     spill_dir=spill_dir if mode == "batched" else None)
    t0 = time.perf_counter()
    mirrors = loadgen.make_fleet(
        tier, WIDE_TENANTS, vocab=WIDE_VOCAB, n_docs=WIDE_DOCS,
        doc_len=WIDE_DOC_LEN, seed=WIDE_TENANTS, device=dev.type,
        slo_of=lambda i: SLOClass.throughput())
    log(f"  [serve] (b) {mode}: {WIDE_TENANTS} tenants x "
        f"{WIDE_DOCS * WIDE_DOC_LEN} edges admitted in "
        f"{time.perf_counter() - t0:.3f} s; store "
        f"{tier.total_store_bytes()} bytes")
    reset_launch_counts()
    rounds = []
    for r in range(WIDE_ROUNDS):
        n_log = len(tier.launch_log)
        res = loadgen.run_rounds(tier, mirrors, 1, vocab=WIDE_VOCAB,
                                 seed=100 + r, rows_per_update=WIDE_ROWS)
        rounds.append(res["wall_s"])
        sizes = [(e["tenants"], e["combined"], e["affected"], e["key_cap"])
                 for e in list(tier.launch_log)[n_log:]]
        log(f"  [serve] (b) {mode} round {r}: {res['wall_s']:.3f} s; "
            f"batched launches (tenants, combined rows, affected keys, "
            f"key_cap) {sizes}")
    counts, paths = launch_counts(), fused_paths()
    serve_check(f"(b) {mode}", tier, mirrors, WIDE_VOCAB)
    p = profiled_round(tier, mirrors, dev, WIDE_VOCAB, 200, WIDE_ROWS)
    serve_check(f"(b) {mode}, profiled round", tier, mirrors, WIDE_VOCAB)
    stats = tier.stats()
    log(f"  [serve] (b) {mode}: {np.mean(rounds):.3f} s a round "
        f"({', '.join(f'{s:.3f}' for s in rounds)}); merge paths "
        f"{paths}; launches {counts}; retrace batches "
        f"{stats['retrace_batches']}; one profiled round: {p['kernels']} "
        f"kernels, device busy {p['busy_ms']:.3f} ms of "
        f"{p['wall_ms']:.3f} ms profiled (idle "
        f"{1 - p['busy_ms'] / p['wall_ms']:.1%}); by kernel {p['top']}")
    out = {n: tier[n].result["c"].copy() for n in mirrors}
    if mode == "batched":
        budget_cell(tier, mirrors, spill_dir)
    return out, float(np.mean(rounds)), counts


def budget_cell(tier, mirrors: dict, spill_dir: Path) -> None:
    """(d) half the fleet's store bytes as the budget: every tenant
    compacted first, then the least recently active spilled until the
    fleet fits; the next round reloads them, still exact."""
    from repro_torch.serve import loadgen
    total = tier.total_store_bytes()
    obsolete = {n: h.ss.session.store_obsolete_bytes()
                for n, h in tier.handles.items()}
    tier.store_budget_bytes = total // 2
    t0 = time.perf_counter()
    tier.sweep()                   # nothing due: the sweep enforces
    t_enforce = time.perf_counter() - t0
    stats = tier.stats()
    spilled = [n for n, h in tier.handles.items() if h.spilled]
    left = {n: h.ss.session.store_obsolete_bytes()
            for n, h in tier.handles.items() if not h.spilled}
    if any(left.values()) or not spilled or stats["over_budget"]:
        raise AssertionError(f"serve (d): compaction then spill did not "
                             f"bring {total} bytes under {total // 2}")
    if sum(stats["reclaimed_bytes"].values()) != sum(obsolete.values()):
        raise AssertionError("serve (d): compaction did not reclaim every "
                             "tenant's obsolete bytes first")
    t0 = time.perf_counter()
    loadgen.run_rounds(tier, mirrors, 1, vocab=WIDE_VOCAB, seed=300,
                       rows_per_update=WIDE_ROWS)
    t_round = time.perf_counter() - t0
    snap = tier.stats()["spill"]
    serve_check("(d) after reload", tier, mirrors, WIDE_VOCAB)
    if snap["reloads"] < len(spilled):
        raise AssertionError("serve (d): spilled tenants did not reload")
    log(f"  [serve] (d) budget {total // 2} of {total} bytes: compacted "
        f"{sum(obsolete.values())} obsolete bytes, then spilled "
        f"{len(spilled)} tenants ({snap['bytes_spilled']} bytes) in "
        f"{t_enforce:.3f} s; the next round reloaded {snap['reloads']} in "
        f"{t_round:.3f} s, every tenant equal to np.bincount; spills "
        f"{snap['spills']} in all")
    tier.store_budget_bytes = None
    for h in list(tier.handles.values()):
        if h.spilled:
            tier.spill.reload(h)
    shutil.rmtree(spill_dir, ignore_errors=True)


def overload_cell(dev) -> None:
    """(c) one latency tenant among 32 best-effort ones, open loop at twice
    the measured capacity for 15 s, through the tier's own thread."""
    from repro_torch.serve import ServeTier, SLOClass, loadgen
    lat_slo = SLOClass.latency(target_p95_ms=OVER_P95_MS,
                               deadline_ms=OVER_P95_MS)
    tier = ServeTier()
    mirrors = loadgen.make_fleet(
        tier, OVER_BEST_EFFORT + 1, vocab=OVER_VOCAB, n_docs=OVER_DOCS,
        doc_len=OVER_DOC_LEN, seed=7, device=dev.type,
        slo_of=lambda i: lat_slo if i == 0 else SLOClass.best_effort(),
        group_of=lambda i: "latency" if i == 0 else None)
    lat = "t0000"
    kw = dict(vocab=OVER_VOCAB, rows_per_update=OVER_ROWS)
    with tier:                                   # the sweep thread runs
        loadgen.run_rounds(tier, mirrors, 2, **kw)
        loadgen.open_loop_rate(tier, mirrors,
                               updates=8 * (OVER_BEST_EFFORT + 1), **kw)
        capacity = loadgen.open_loop_rate(
            tier, mirrors, updates=8 * (OVER_BEST_EFFORT + 1), seed=4, **kw)
        for h in tier.handles.values():
            h.reset_window()
        res = loadgen.overload_run(
            tier, mirrors, latency_tenant=lat, duration_s=OVER_SECONDS,
            offered_per_sec=2.0 * capacity, **kw)
    stats = tier.stats()
    serve_check("(c)", tier, mirrors, OVER_VOCAB)
    c = stats["classes"][lat]
    be_shed = sum(v["shed_submits"] for n, v in stats["classes"].items()
                  if n != lat)
    log(f"  [serve] (c) capacity {capacity:.1f} updates/s, offered "
        f"{2 * capacity:.1f}/s for {res['duration_s']:.3f} s: "
        f"{res['offered']} offered, {res['admitted']} admitted, shed "
        f"fraction {res['shed_fraction']:.4f}; latency tenant: "
        f"{res['latency_updates']} updates, {c['shed_submits']} shed, p95 "
        f"{c['latency_p95_ms']} ms (target {OVER_P95_MS}), breach rate "
        f"{c['breach_rate']:.4f} over {c['observed']} refreshes; batched "
        f"launches {stats['batched_launches']}")
    if c["shed_submits"] != 0:
        raise AssertionError("serve (c): a latency-class submit was shed")
    if be_shed == 0:
        raise AssertionError("serve (c): no best-effort submit was shed at "
                             "twice the capacity")


def drive_serve(dev, root: Path) -> dict:
    from repro_torch.kernels import launch_counts
    counts = {k: 0 for k in launch_counts()}

    def add(c):
        for k, v in c.items():
            counts[k] += v
    t0 = time.perf_counter()
    got, batched, c = fleet_cell(dev, "batched")
    add(c)
    release(dev)
    want, seq, c = fleet_cell(dev, "sequential")
    add(c)
    serve_same("(a)", got, want)
    log(f"  [serve] (a)+(e) {time.perf_counter() - t0:.1f} s: batched "
        f"{batched:.1f} updates/s against sequential (MultiSessionServer) "
        f"{seq:.1f}, {batched / seq:.3f}x; every tenant bitwise equal")
    del got, want
    release(dev)
    t0 = time.perf_counter()
    got, wb, c = wide_cell(dev, "batched", root / "spill")
    add(c)
    release(dev)
    want, ws, c = wide_cell(dev, "sequential", root / "spill")
    add(c)
    serve_same("(b)", got, want)
    log(f"  [serve] (b)+(d) {time.perf_counter() - t0:.1f} s: batched "
        f"{wb:.3f} s a round against sequential {ws:.3f}; every tenant "
        f"bitwise equal")
    del got, want
    release(dev)
    t0 = time.perf_counter()
    overload_cell(dev)
    log(f"  [serve] (c) {time.perf_counter() - t0:.1f} s")
    for name in ("sort_lex", "segment_sum", "fused_shuffle_reduce"):
        if dev.type == "cuda" and counts[name] == 0:
            raise AssertionError(f"serve path launched no {name}")
    return counts


# ---------------------------------------------------------------------------
# phase 8: delta queries (repro_torch.dql)
# ---------------------------------------------------------------------------

JOIN_USERS, JOIN_FRAC = 2**22, 0.005
WIN_EVENTS, WIN_KEYS, WIN_COUNT, WIN_SLIDE, WIN_SIZE = 2**22, 2**12, 32, 4, 8
WIN_FRAC = 0.005
MINMAX_ROWS, MINMAX_KEYS, MINMAX_CHANGED = 2**22, 2**20, 2**12


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def mutated(datas: dict, deltas: dict) -> dict:
    """Host copies of the sources with their deltas applied."""
    from repro_torch.core.incremental import apply_delta_host
    from repro_torch.core.kvstore import make_kv
    out = {}
    for name, kv in datas.items():
        k, ok = kv.keys.numpy().copy(), kv.valid.numpy().copy()
        v = {c: a.numpy().copy() for c, a in kv.values.items()}
        if name in deltas:
            apply_delta_host(k, v, ok, deltas[name])
        out[name] = make_kv(k, v, ok)
    return out


def dql_wordcount(dev, docs: np.ndarray, steps, app_results: list) -> str:
    """(a) wordcount_query on phase 3's corpus and updates: bitwise equal
    to np.bincount and to phase 3's apps.wordcount Session (auto)."""
    from repro_torch.api import RunConfig, make_delta
    from repro_torch.apps import wordcount as wc
    from repro_torch.dql import workloads as wl
    q = wl.wordcount_query(VOCAB).compile(RunConfig(device=dev.type))
    rep, t_run = timed(lambda: q.run(wc.make_input(np.arange(len(docs)),
                                                   docs)))
    got = [q.result["c"].copy()]
    times = []
    for _, (rid, words, sign), cur, valid in steps:
        _, dt = timed(lambda: q.update(make_delta(rid, {"w": words}, sign)))
        times.append(dt)
        got.append(q.result["c"].copy())
        want = np.bincount(cur[valid].ravel(), minlength=VOCAB)
        if not np.array_equal(got[-1], want.astype(got[-1].dtype)):
            raise AssertionError("dql (a): differs from np.bincount")
    for i, (g, a) in enumerate(zip(got, app_results)):
        if g.dtype != a.dtype or not np.array_equal(g, a):
            raise AssertionError(f"dql (a): step {i} differs from "
                                 f"apps.wordcount's Session")
    _, t_rerun = timed(q.rerun)
    if not np.array_equal(q.result["c"], got[-1]):
        raise AssertionError("dql (a): rerun differs from the refresh")
    return (f"(a) wordcount_query ({rep.mode}, {docs.size} edges): run "
            f"{t_run:.3f} s; update (a) {times[0]:.3f} s, update (b) "
            f"{times[1]:.3f} s against rerun {t_rerun:.3f} s; bitwise equal "
            f"to np.bincount and to apps.wordcount")


def relation_equal(label: str, got, want) -> None:
    (vals, ok), (wvals, wok) = got, want
    if not np.array_equal(ok, wok):
        raise AssertionError(f"dql {label}: relation rows differ")
    for c in wvals:
        if not np.array_equal(np.where(ok, vals[c], 0), wvals[c]):
            raise AssertionError(f"dql {label}: column {c} differs")


def dql_join(dev) -> str:
    """(b) join_query at 2^22 users, update at frac 0.005: exactly
    join_oracle of the mirrored sources."""
    from repro_torch.api import RunConfig
    from repro_torch.dql import workloads as wl
    datas = wl.join_data(JOIN_USERS, seed=11)
    q = wl.join_query(JOIN_USERS).compile(RunConfig(device=dev.type))
    _, t_run = timed(lambda: q.run(datas))
    relation_equal("(b) run", q.relation(), wl.join_oracle(datas))
    d = wl.join_delta(datas, JOIN_FRAC, seed=12)
    rep, t_up = timed(lambda: q.update(d))
    relation_equal("(b) update", q.relation(),
                   wl.join_oracle(mutated(datas, d)))
    _, t_rerun = timed(q.rerun)
    relation_equal("(b) rerun", q.relation(),
                   wl.join_oracle(mutated(datas, d)))
    return (f"(b) join_query, {JOIN_USERS} users ({rep.mode}, affected "
            f"keys {rep.affected_keys}): run {t_run:.3f} s; update of "
            f"{JOIN_FRAC:g} {t_up:.3f} s against rerun {t_rerun:.3f} s; "
            f"exactly join_oracle")


def windowed_check(label: str, got: np.ndarray, kv, oracle) -> float:
    """|got - oracle| within 1e-5 of each cell's sum of |terms|."""
    from repro_torch.dql import workloads as wl
    terms = wl.windowed_oracle(
        kv._replace(values={**kv.values, "v": kv.values["v"].abs()}),
        WIN_KEYS, size=WIN_SIZE, slide=WIN_SLIDE, num_windows=WIN_COUNT)
    err = np.abs(got.astype(np.float64) - oracle)
    if not (np.isfinite(got).all() and (err <= 1e-5 * terms).all()):
        raise AssertionError(f"dql {label}: a window's sum is off by more "
                             f"than 1e-5 of its sum of |terms|")
    return float((err / np.maximum(terms, 1e-30)).max())


def dql_windowed(dev) -> str:
    """(c) windowed_query: 2^22 events, 2^12 keys, 32 windows (slide 4,
    size 8), update at frac 0.005, against the vectorised oracle."""
    from repro_torch.api import RunConfig
    from repro_torch.dql import workloads as wl
    t_max = WIN_COUNT * WIN_SLIDE
    kw = dict(size=WIN_SIZE, slide=WIN_SLIDE, num_windows=WIN_COUNT)
    kv = wl.events_data(WIN_EVENTS, WIN_KEYS, t_max=t_max, seed=13)
    q = wl.windowed_query(WIN_KEYS, **kw).compile(RunConfig(device=dev.type))
    rep, t_run = timed(lambda: q.run(kv))
    e0 = windowed_check("(c) run", q.result["v"].ravel(), kv,
                        wl.windowed_oracle(kv, WIN_KEYS, **kw))
    d = wl.events_delta(kv, WIN_FRAC, t_max=t_max, seed=14)
    rep, t_up = timed(lambda: q.update(d))
    kv2 = mutated({"e": kv}, {"e": d})["e"]
    e1 = windowed_check("(c) update", q.result["v"].ravel(), kv2,
                        wl.windowed_oracle(kv2, WIN_KEYS, **kw))
    _, t_rerun = timed(q.rerun)
    windowed_check("(c) rerun", q.result["v"].ravel(), kv2,
                   wl.windowed_oracle(kv2, WIN_KEYS, **kw))
    return (f"(c) windowed_query, {WIN_EVENTS} events, {WIN_KEYS} keys x "
            f"{WIN_COUNT} windows ({rep.mode}): run {t_run:.3f} s; update "
            f"of {WIN_FRAC:g} {t_up:.3f} s against rerun {t_rerun:.3f} s; "
            f"largest error / sum|terms| {e0:.3g} (run), {e1:.3g} (update)")


def dql_minmax(dev, rng, agg: str) -> str:
    """(d) group_by(agg=min|max) over 2^22 rows and 2^20 keys, 4,096 rows
    rewritten: exactly np.minimum.at / np.maximum.at."""
    from repro_torch import dql
    from repro_torch.api import RunConfig, make_delta
    from repro_torch.core.kvstore import make_kv
    k = rng.integers(0, MINMAX_KEYS, MINMAX_ROWS).astype(np.int32)
    v = rng.normal(size=MINMAX_ROWS).astype(np.float32)
    kv = make_kv(np.arange(MINMAX_ROWS, dtype=np.int32), {"k": k, "v": v})
    q = (dql.scan("x").group_by("k", num_keys=MINMAX_KEYS, value="v",
                                agg=agg)
         .compile(RunConfig(device=dev.type)))
    ufunc = np.minimum if agg == "min" else np.maximum

    def check(label, k, v):
        fill = np.inf if agg == "min" else -np.inf
        want = np.full(MINMAX_KEYS, fill, np.float32)
        ufunc.at(want, k, v)
        hit = np.bincount(k, minlength=MINMAX_KEYS) > 0
        got = q.result["v"].ravel()
        if not np.array_equal(got, np.where(hit, want, 0)):
            raise AssertionError(f"dql (d) {agg} {label}: differs from "
                                 f"np.{ufunc.__name__}.at")
    rep, t_run = timed(lambda: q.run(kv))
    check("run", k, v)
    rows = rng.choice(MINMAX_ROWS, MINMAX_CHANGED, replace=False)
    new = rng.normal(size=MINMAX_CHANGED).astype(np.float32) * 4
    vb = np.empty(2 * MINMAX_CHANGED, np.float32)
    vb[0::2], vb[1::2] = v[rows], new
    d = make_delta(np.repeat(rows, 2).astype(np.int32),
                   {"k": np.repeat(k[rows], 2), "v": vb},
                   np.tile(np.int8([-1, 1]), MINMAX_CHANGED))
    v[rows] = new
    rep, t_up = timed(lambda: q.update(d))
    check("update", k, v)
    _, t_rerun = timed(q.rerun)
    check("rerun", k, v)
    return (f"(d) group_by(agg={agg!r}), {MINMAX_ROWS} rows, {MINMAX_KEYS} "
            f"keys ({rep.mode}, affected keys {rep.affected_keys}): run "
            f"{t_run:.3f} s; update of {MINMAX_CHANGED} rows {t_up:.3f} s "
            f"against rerun {t_rerun:.3f} s; exactly np.{ufunc.__name__}.at")


def drive_dql(dev, rng, docs: np.ndarray, steps, app_results: list):
    from repro_torch.kernels import launch_counts, reset_launch_counts
    counts = {k: 0 for k in launch_counts()}
    parts = [lambda: dql_wordcount(dev, docs, steps, app_results),
             lambda: dql_join(dev), lambda: dql_windowed(dev),
             lambda: dql_minmax(dev, rng, "min"),
             lambda: dql_minmax(dev, rng, "max")]
    for part in parts:
        reset_launch_counts()
        line, dt = timed(part)
        c = launch_counts()
        for k, v in c.items():
            counts[k] += v
        log(f"  [dql] {line} ({dt:.1f} s; launches {c}; shapes "
            f"{shapes_line()})")
        release(dev)
    for name in ("sort_lex", "segment_sum", "segment_minmax"):
        if dev.type == "cuda" and counts[name] == 0:
            raise AssertionError(f"dql path launched no {name}")
    return counts


# ---------------------------------------------------------------------------
# phase 9: distributed execution on 8 logical shards (core.distributed)
# ---------------------------------------------------------------------------

MESH_SHARDS = 8
# (c), (e): PageRank's graph, cut from the scale's 2^22 vertices: a
# single-device refresh there takes 69-91 s (ROADMAP item 18)
DIST_PR_VERTICES = 2**20
# (e): a threshold the 0.1% rewire's first iteration already trips
PDELTA_TRIP = 1e-6


def mesh_config(**kw):
    from repro_torch.api import LocalMesh, MeshConfig
    shape = kw.pop("shape", {"data": MESH_SHARDS})
    return MeshConfig(LocalMesh(shape), **kw)


def shuffle_line(rep) -> str:
    """An epoch's exchange telemetry, and its seconds apart from it (the
    partitioning, the host copies and the per-shard merges)."""
    sh = rep.shuffle
    ex = sum(sh.exchange_seconds)
    return (f"{rep.seconds:.3f} s (exchange {ex:.3f} s in "
            f"{len(sh.exchange_seconds)} steps, the rest {rep.seconds - ex:.3f}"
            f" s), edges_exchanged {sh.edges_exchanged}, bytes_moved "
            f"{sh.bytes_moved}, shuffle_cap {sh.shuffle_cap}, regrows "
            f"{sh.regrows}")


def noop_rows(rid: np.ndarray, sign: np.ndarray, valid: np.ndarray):
    """The records an update rewrote that are valid now (each record's
    '-' and '+' rows), for a no-op delta of the same size."""
    rows = np.unique(rid[sign > 0])
    return rows[valid[rows]]


def noop_delta(rows: np.ndarray, values: dict, keys=None):
    """'-' then '+' of each row's current value: a refresh of the same size
    as an update, which leaves every result as it is."""
    from repro_torch.api import make_delta
    rid = np.repeat(rows, 2).astype(np.int32)
    vals = {n: np.repeat(a[rows], 2, axis=0) for n, a in values.items()}
    k = None if keys is None else np.repeat(keys[rows], 2).astype(np.int32)
    return make_delta(rid, vals, np.tile(np.int8([-1, 1]), rows.size),
                      keys=k)


def profiled_noop(label: str, sess, delta, dev) -> None:
    """One no-op refresh under ``torch.profiler``: device busy time and
    the device's idle share of the profiled call."""
    box = {}
    p = device_shares(lambda: box.update(rep=sess.update(delta)), dev,
                      top=6)
    idle = (1 - p["busy_ms"] / p["wall_ms"]) if p["wall_ms"] else 0.0
    log(f"  [{label}] profiled no-op refresh ({delta.capacity} delta rows): "
        f"mode {box['rep'].mode}, {p['kernels']} kernels, device busy "
        f"{p['busy_ms']:.3f} ms of {p['wall_ms']:.3f} ms, device idle "
        f"{idle:.1%}; exchange {sum(box['rep'].shuffle.exchange_seconds):.3f}"
        f" s; top {p['top']}")


def dist_wordcount(dev, docs, steps, want: list, single_s: list,
                   shape: dict, only_first: bool = False):
    """(a) / (d): wordcount through ``_DistOneStep``: run, then phase 3's
    updates, each equal to np.bincount and to phase 3's MRBG session."""
    import torch
    from repro_torch.api import RunConfig, Session, make_delta
    from repro_torch.apps import wordcount as wc
    from repro_torch.kernels import launch_counts, reset_launch_counts
    tag = "dist-wc" if "pod" not in shape else "dist-wc-pod"
    kw = {"pod_axis": "pod"} if "pod" in shape else {}
    spec, data = wc.make_job(docs, VOCAB)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    sess = Session(spec, RunConfig(device=dev.type,
                                   mesh=mesh_config(shape=shape, **kw)))
    todo = steps[:1] if only_first else steps
    results = []
    for i, step in enumerate([None] + list(todo)):
        if step is None:
            rep = sess.run(data)
            label, cur, valid = "run", docs, np.ones(docs.shape[0], bool)
        else:
            label, (rid, words, sign), cur, valid = step
            rep = sess.update(make_delta(rid, {"w": words}, sign))
        got = sess.result["c"]
        oracle = np.bincount(cur[valid].ravel(), minlength=VOCAB)
        if not (got.shape == (VOCAB,) and np.array_equal(got, oracle)
                and np.array_equal(got, want[i])):
            raise AssertionError(f"{tag} {label}: differs from np.bincount "
                                 f"or phase 3's mrbg session")
        results.append(got.copy())
        log(f"  [{tag}] {label}: mode {rep.mode}, {shuffle_line(rep)}; "
            f"single device (phase 3, mrbg) {single_s[i]:.3f} s; equal to "
            f"np.bincount and to phase 3 bitwise; launches {launch_counts()}")
    counts = launch_counts()
    if not only_first:
        label, (rid, words, sign), cur, valid = steps[-1]
        rows = noop_rows(rid, sign, valid)
        profiled_noop(tag, sess, noop_delta(rows, {"w": cur}), dev)
        if not np.array_equal(sess.result["c"], results[-1]):
            raise AssertionError(f"{tag}: the no-op refresh changed counts")
    log(f"  [{tag}] peak device memory {memory_gib(dev, peak=True):.2f} GiB, "
        f"{len(sess.stores)} shard stores, {sess.store_bytes()} bytes")
    del sess, data
    release(dev)
    return counts, results


def dist_sssp(dev, kept: dict):
    """(b) SSSP at phase 4's size: run and phase 4's deletion update,
    equal to phase 4's single-device results bitwise and to Dijkstra."""
    import torch
    from repro_torch.api import RunConfig, Session, make_delta
    from repro_torch.apps import sssp
    from repro_torch.kernels import launch_counts, reset_launch_counts
    spec, data = sssp.make_job(kept["nbrs"], kept["w"], src=0)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    sess = Session(spec, RunConfig(device=dev.type, mesh=mesh_config()))
    for label in ("run", "update"):
        rep = sess.run(data) if label == "run" else \
            sess.update(make_delta(*kept["delta"]))
        d = sess.result["d"]
        check_sssp(f"distributed {label}", d, kept[f"dij_{label}"])
        if not np.array_equal(d, kept[label]):
            raise AssertionError(f"dist-sssp {label}: differs from phase "
                                 f"4's single-device result")
        log(f"  [dist-sssp] {label}: mode {rep.mode}, {rep.iters} "
            f"iterations, {shuffle_line(rep)}; single device (phase 4) "
            f"{kept[f'{label}_s']:.3f} s; equal to phase 4 bitwise; "
            f"launches {launch_counts()}")
    if rep.mode != "distributed-i2":
        raise AssertionError(f"dist-sssp update ran in mode {rep.mode}")
    counts = launch_counts()
    after = kept["nbrs"].copy()
    after[kept["rows"]] = kept["delta"][1]["nbrs"][1::2]
    rows = kept["rows"] + 1
    values = {"nbrs": np.concatenate([np.zeros((1, OUT_SLOTS), np.int32),
                                      after]),
              "w": np.concatenate([np.zeros((1, OUT_SLOTS), np.float32),
                                   kept["w"]])}
    profiled_noop("dist-sssp", sess, noop_delta(rows, values), dev)
    check_sssp("distributed no-op refresh", sess.result["d"],
               kept["dij_update"])
    log(f"  [dist-sssp] peak device memory {memory_gib(dev, peak=True):.2f} "
        f"GiB")
    del sess, data
    release(dev)
    return counts


def check_pagerank(label: str, r: np.ndarray, ref: np.ndarray, held: float,
                   oracle_change: float) -> str:
    v = ref.shape[0]
    err = float(np.abs(r.astype(np.float64) - ref).sum())
    lim = pagerank_bound(v, held, oracle_change)
    if not (np.isfinite(r).all() and err <= lim):
        raise AssertionError(f"dist-pagerank {label}: L1 error {err} > {lim}")
    return f"L1 error {err:.6g} <= bound {lim:.6g}"


def dist_pagerank(dev, rng, vertices: int, single: dict):
    """(c) PageRank run and a 0.1% rewire at CPC 1e-3, then (e) the same
    rewire through refresh="warm" and past ``pdelta_threshold``."""
    import torch
    from repro_torch.api import RunConfig, Session, make_delta
    from repro_torch.apps import pagerank
    from repro_torch.kernels import launch_counts, reset_launch_counts
    nbrs = pagerank.random_graph(vertices, OUT_SLOTS, seed=int(rng.integers(
        2**31)), p_edge=P_EDGE)
    spec, data = pagerank.make_job(nbrs)
    cfg = RunConfig(device=dev.type, cpc_threshold=PR_CPC,
                    mesh=mesh_config())
    ref, ch = pagerank_fixpoint(nbrs, dev=dev)
    (rid, vals, sign), after = rewire_delta(rng, nbrs, 0.001)
    ref2, ch2 = pagerank_fixpoint(after, r0=ref, dev=dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    sess = Session(spec, cfg)
    rep = sess.run(data)
    run_change = rep.max_change[-1]
    line = check_pagerank("run", sess.result["r"], ref,
                          vertices * run_change, ch)
    log(f"  [dist-pagerank] {vertices} vertices (CUT from {FULL_VERTICES}): "
        f"run: mode {rep.mode}, {rep.iters} iterations, {shuffle_line(rep)};"
        f" {line}; single device (phase 4, {single['vertices']} vertices) "
        f"{single['run_s']:.3f} s; launches {launch_counts()}")
    rep = sess.update(make_delta(rid, vals, sign))
    if rep.mode != "distributed-i2" or rep.iters >= cfg.refresh_iters_:
        raise AssertionError(f"dist-pagerank update: mode {rep.mode}, "
                             f"{rep.iters} iterations")
    held = vertices * max(run_change, cfg.cpc_threshold + cfg.refresh_tol_)
    line = check_pagerank("update", sess.result["r"], ref2, held, ch2)
    stale = float(np.abs(ref - ref2).sum())
    err = float(np.abs(sess.result["r"].astype(np.float64) - ref2).sum())
    if not err < stale / 10:
        raise AssertionError(f"dist-pagerank update: L1 error {err} is not "
                             f"below a tenth of the stale ranks' {stale}")
    log(f"  [dist-pagerank] update ({rid.size // 2} vertices rewired): mode "
        f"{rep.mode}, {rep.iters} iterations, {shuffle_line(rep)}; {line}; "
        f"single device (phase 4, {single['vertices']} vertices) "
        f"{single['update_s']:.3f} s; launches {launch_counts()}")
    counts = launch_counts()
    profiled_noop("dist-pagerank", sess,
                  noop_delta(np.unique(rid), {"nbrs": after}), dev)
    check_pagerank("no-op refresh", sess.result["r"], ref2, held, ch2)
    del sess
    release(dev)

    # (e) the same rewire, warm and past the P_delta threshold
    for label, mc, extra in (
            ("warm", mesh_config(refresh="warm"), {}),
            ("pdelta", mesh_config(), {"pdelta_threshold": PDELTA_TRIP})):
        reset_launch_counts()
        s = Session(spec, cfg.replace(mesh=mc, **extra))
        s.run(data)
        rep = s.update(make_delta(rid, vals, sign))
        if rep.mode != "distributed-warm":
            raise AssertionError(f"dist-pagerank {label}: mode {rep.mode}")
        line = check_pagerank(label, s.result["r"], ref2,
                              vertices * cfg.refresh_tol_, ch2)
        log(f"  [dist-pagerank] (e) {label} update: mode {rep.mode}, "
            f"{rep.iters} iterations, {shuffle_line(rep)}; {line}; "
            f"launches {launch_counts()}")
        counts = {n: counts[n] + k for n, k in launch_counts().items()}
        del s
        release(dev)
    log(f"  [dist-pagerank] peak device memory "
        f"{memory_gib(dev, peak=True):.2f} GiB")
    return counts


def drive_distributed(dev, rng, docs, steps, mrbg_results, mrbg_s,
                      sssp_kept, pr_single):
    """Phase 9: (a) wordcount, (b) SSSP, (c) PageRank on 8 shards, (d) a
    (pod 2, data 4) mesh on (a)'s update (a), (e) PageRank warm and past
    ``pdelta_threshold``.  Returns the launches of all of it."""
    a, a_res = dist_wordcount(dev, docs, steps, mrbg_results, mrbg_s,
                              {"data": MESH_SHARDS})
    d, d_res = dist_wordcount(dev, docs, steps, mrbg_results, mrbg_s,
                              {"pod": 2, "data": MESH_SHARDS // 2},
                              only_first=True)
    for x, y in zip(d_res, a_res):
        if not np.array_equal(x, y):
            raise AssertionError("(d): the pod mesh differs from (a)")
    log("  [dist-wc-pod] (d) run and update (a) bitwise equal to (a)")
    b = dist_sssp(dev, sssp_kept)
    c = dist_pagerank(dev, rng, DIST_PR_VERTICES, pr_single)
    counts = {n: a[n] + b[n] + c[n] + d[n] for n in a}
    for name in ("sort_lex", "segment_sum", "segment_minmax",
                 "fused_shuffle_reduce"):
        if counts[name] == 0:
            raise AssertionError(f"phase 9 launched no {name}")
    return counts


# ---------------------------------------------------------------------------
# phase 15: one process a rank (RankMesh, launch.ranks.run_ranks)
# ---------------------------------------------------------------------------

RANK_SHARDS = 4
RANK_TIMEOUT = 300            # each launch's limit, seconds
# (b) PageRank's graph: phase 9 (c)'s size, cut from phase 4's 2^22
RANK_PR_VERTICES = 2**20
RANK_PR_TOL = 1e-5            # (b): the card's float adds are atomic
# (b) PageRank's refresh: 64 of its 2^20 vertices rewired (phase 9 (c)
# rewires 0.1%, a refresh of 19-27 s on LocalMesh)
RANK_PR_REWIRE = 2**-14
# (b) the refresh against LocalMesh's, max |ranks - LocalMesh|: at CPC
# PR_CPC a DK whose accumulated change lies within the adds' rounding of
# the threshold is emitted on one run and withheld on the other (the
# card's float adds are atomic, so two LocalMesh runs part too); the
# withheld change, below PR_CPC, moves each of its ~8 targets by d / 8 of
# it (1.06e-4; two LocalMesh refreshes parted by 1.08e-4 and 1.2e-4 in
# PR 27's chip runs), and a target of a one-edge vertex by d of it, so
# PR_CPC covers a few such flips.  A refresh that changed nothing would
# miss the rewire's d / 8 ~ 0.1 at a rewired vertex's targets: the phase
# checks that the refresh moves LocalMesh's ranks by at least
# RANK_PR_SEEN times the tolerance, so that the check can see it.
RANK_PR_REFRESH_TOL = PR_CPC
RANK_PR_SEEN = 10
# (c) Llama 4 Scout's MoE layer at full width, one layer (depth cut from
# 48), B x S tokens drawn from --seed, capacity 16 (nothing drops on
# either path) and the config's own 1.25 for the dropped slots
MOE_RANK_ARCH = "llama4_scout_17b_a16e"
MOE_RANK_MESH = {"data": 1, "model": RANK_SHARDS}
MOE_RANK_SHAPE = (2, 2048)
MOE_RANK_F32_SHAPE = (2, 256)
MOE_RANK_CF = 16.0
MOE_RANK_SMOKE = False        # True: smoke width (a CPU rehearsal)
# bf16 a2a against gather: the two run the experts' products on buffers
# of other shapes (a capacity buffer masked to each expert, against one
# batched product), which may round to bf16 (2^-8 of a value) apart; the
# issue's 2^-8 of max |y| tightened to 2^-10: PR 27's chip call 2 found
# the two bitwise equal (cuBLAS took the same path at both shapes)
MOE_RANK_BF16_REL = 2**-10
# (e) Gemma 2 9B at full width served tensor-parallel on the 4 ranks,
# {"model": 4}: each rank holds 4 of the 16 heads and 2 of the 8 kv heads
# (flash at H 4, KH 2, hd 256), a quarter of d_ff and of the vocabulary.
# The weights from draw_dense (1/sqrt of each matrix's input width, as
# parity_model: the reference's draw makes the random network chaotic);
# prefill 1 x 2048, then 8 tokens decoded.  bf16 against the replicated
# run on the card within PARITY_TOL["bfloat16"] of the largest |logit|
# (each layer's two partial sums add in float32 and round once, against
# one bf16 product: a few roundings a layer, as phase 5's parity); float32
# (TF32 off) at PARITY_F32_LAYERS layers within PARITY_TOL["float32"].
TP_ARCH = "gemma2_9b"
TP_MESH = {"model": RANK_SHARDS}
TP_SHAPE = (1, 2048)
TP_STEPS = 8
TP_SMOKE = False              # True: smoke width (a CPU rehearsal)
# (f) the other block kinds served tensor-parallel on the same 4 ranks,
# {"model": 4}, at full width, bf16, weights from draw_dense (only a rank's
# experts drawn): (arch, the bf16 run's depth, its prefill B x S, the
# float32 run's config).  DeepSeek-V3 at 4 of 61 layers (3 mla_dense, 1
# attn_moe, MTP held; MLA 32 of 128 heads, 64 of 256 experts a rank: 31
# GB replicated, 8 a rank), float32 at its MoE layer alone (56 GB
# replicated); Llama 4 Scout at 2 of 48 (10 of 40 heads, 2 of 8 kv, 4 of
# 16 experts), float32 at 1; RecurrentGemma 2B one cycle (rec, rec,
# attn_local: 640 of 2,560 RG-LRU columns; its 10 heads and 1 kv head
# replicated: no reduction), float32 too; xLSTM 125M one cycle (mlstm,
# slstm: 384 of 1,536 columns; the cells whole), prefill at 512 (its
# cells step a token at a time on every rank).  TP4_STEPS tokens decoded.
# bf16 against the replicated run within parity_bound, float32 within
# MOE_F32_BOUND (2e-4), the MoE archs where no routing flip reaches (the
# prefill at every position held_positions gives, the decode up to its
# first flip; the flips printed): a rank-order float32 sum in a reduction
# can order two experts' near-equal scores the other way.
TP4_RUNS = (
    ("deepseek_v3_671b", dict(n_layers=4), (1, 1024),
     dict(prefix_blocks=[], n_layers=1)),
    ("llama4_scout_17b_a16e", dict(n_layers=2), (1, 1024),
     dict(n_layers=1)),
    ("recurrentgemma_2b", dict(n_layers=3), (1, 1024), dict(n_layers=3)),
    ("xlstm_125m", dict(n_layers=2), (1, 512), dict(n_layers=2)),
)
TP4_STEPS = 8
TP4_F32_SHAPE = (1, 64)
# (g) sharded training (make_train_step(mesh=), models.shard): Qwen3-1.7B
# at full width (phase 10 (c)'s arch: bf16, remat full, loss_chunk 512),
# cut in depth to TRAIN_TP_LAYERS of its 28 layers, trained on the 4 ranks
# as {"data": 2, "model": 2} (each rank 8 of the 16 heads, 4 of the 8 kv
# heads, half of d_ff and of the tied vocabulary, one of the two rows) for
# TRAIN_TP_SHAPE = (steps, B, S) ids drawn from the seed, AdamW by
# STEP_OPT (lr 3e-4 from step 1), weights from draw_dense, against the
# replicated run of the same draw and batches on the card.  Then the same
# at smoke width in float32 (TF32 off), TRAIN_TP_F32_SHAPE, held within
# MOE_F32_BOUND; its AdamW eps at 1 keeps each update smooth in the
# gradient (at 1e-8 a first step is lr times the gradient's sign, which
# rounding decides where the gradient is near 0), so the parameters are
# held to the gradients' bound, of each leaf's largest |update|; lr 1e-2
# keeps the updates (about 1e-3) far above the float32 rounding of the
# parameters (7e-9 at 0.1).  The bf16 bounds, derived before the first run
# (:func:`train_tp_bounds`); the first moments' (:func:`moment_bound`) hold
# the update itself in both, where the bf16 parameters' bound is past it.
TRAIN_TP_ARCH = "qwen3_1_7b"
TRAIN_TP_MESH = {"data": 2, "model": 2}
TRAIN_TP_LAYERS = 2
TRAIN_TP_SHAPE = (2, 2, 1024)
TRAIN_TP_F32_SHAPE = (2, 2, 64)
TRAIN_TP_F32_OPT = dict(STEP_OPT, lr=1e-2, eps=1.0)
TRAIN_TP_SMOKE = False        # True: smoke width (a CPU rehearsal)


def rank_jobs_file(work: Path, jobs: list) -> str:
    path = work / f"spec-{len(list(work.glob('spec-*')))}.json"
    path.write_text(json.dumps({"jobs": jobs, "out": str(work)}))
    return str(path)


def launch_ranks(dev, work: Path, n: int, backend: str, jobs: list) -> list:
    """``n`` ranks on ``dev``'s card (all on cuda:0), or on the CPU in a
    rehearsal, through ``run_ranks`` under ``RANK_TIMEOUT``."""
    from repro_torch.launch.ranks import run_ranks
    return run_ranks("repro_torch.launch.ranks", n, backend=backend,
                     device="cuda:0" if dev.type == "cuda" else "cpu",
                     timeout=RANK_TIMEOUT,
                     args=[rank_jobs_file(work, jobs)])


def rank_lines(tag: str, name: str, outs: list) -> dict:
    """Each rank's seconds, exchange seconds and peak memory of a job;
    returns the launches of all ranks added up."""
    total = {}
    for r, out in enumerate(outs):
        o = out[name]
        log(f"  [{tag}] rank {r}: epochs "
            f"{', '.join(f'{s:.3f}' for s in o['seconds'])} s (exchange "
            f"{', '.join(f'{s:.3f}' for s in o['exchange_seconds'])} s), "
            f"job {o['job_seconds']:.1f} s, peak device memory "
            f"{o['peak_gib']:.2f} GiB, launches {o['launches']}")
        total = {k: total.get(k, 0) + v for k, v in o["launches"].items()}
    return total


def check_ranks_equal(tag: str, name: str, outs: list, want: list,
                      got: dict, results: list, tol: float = 0.0,
                      epochs=None) -> list:
    """Every rank's reports equal ``want`` (LocalMesh's summaries, but
    for the seconds) and rank 0's results ``results``, bitwise; with
    ``tol``, the results within it and the reports' mode, iterations,
    ShuffleStats and stores equal.  ``epochs``: the epochs held (all by
    default).  Returns what differs."""
    idx = list(range(len(results))) if epochs is None else list(epochs)
    bad = []
    for i in idx:
        g, r = got[f"r{i}"], results[i]
        if tol:
            err = float(np.abs(g.astype(np.float64) - r).max())
            ok = g.shape == r.shape and np.isfinite(g).all() and err <= tol
        else:                                    # SSSP holds inf
            err, ok = "not bitwise", np.array_equal(g, r)
        if not ok:
            bad.append(f"{tag} epoch {i}: ranks differ from LocalMesh "
                       f"({err}, tolerance {tol})")
    # PageRank: the results within ``tol``, and what steers the loop (mode,
    # iterations, ShuffleStats, stores) equal
    fields = ("mode", "iters", "shuffle", "store", "mrbg_on")
    keep = lambda e: {k: v for k, v in e.items() if k != "result"
                      and (not tol or k in fields)}
    wanted = [keep(want[i]) for i in idx]
    for r, out in enumerate(outs):
        epochs = [keep(out[name]["epochs"][i]) for i in idx]
        if epochs != wanted:
            diff = [(i, k, g.get(k), w.get(k))
                    for i, g, w in zip(idx, epochs, wanted)
                    for k in sorted(set(g) | set(w)) if g.get(k) != w.get(k)]
            bad.append(f"{tag}: rank {r}'s reports differ from LocalMesh's:"
                       f" (epoch, field, rank, LocalMesh) {diff[:6]}")
    if not bad:
        how = f"within {tol}" if tol else "bitwise"
        log(f"  [{tag}] epochs {idx} equal to LocalMesh({{'data': "
            f"{RANK_SHARDS}}}) on the card ({how}; every rank's reports, "
            f"ShuffleStats {[want[i]['shuffle'] for i in idx]})")
    return bad


def local_mesh_run(dev, job: str, z, cfg_kw: dict) -> tuple:
    """LocalMesh({"data": 4}) on the card: the job's run and deltas;
    ``(reports as report_summary, results, seconds)`` (a summary taken
    at once: a report's counts are the live view's)."""
    from repro_torch.api import LocalMesh, MeshConfig, RunConfig, Session, \
        make_delta
    from repro_torch.launch.ranks import deltas_of, make_app, report_summary
    app, data, key = make_app(job, z)
    sess = Session(app, RunConfig(device=dev.type, mesh=MeshConfig(
        LocalMesh({"data": RANK_SHARDS})), **cfg_kw))
    reps, results, secs = [], [], []
    for d in [None] + deltas_of(z):
        t0 = time.perf_counter()
        reps.append(report_summary(sess.run(data) if d is None
                                   else sess.update(make_delta(*d))))
        secs.append(time.perf_counter() - t0)
        results.append(sess.result[key])
    del sess, data
    release(dev)
    return reps, results, secs


def moe_gather_want(dev, spec: dict) -> dict:
    """The single-process ``gather`` layer on the card on a ``moe`` job's
    weights and x (drawn alike from its seed): y, the expert ids
    (``RoutingProbe``) and the kept slots."""
    import torch
    from repro_torch.launch.ranks import RoutingProbe, moe_config, \
        moe_inputs
    from repro_torch.models import blocks
    cfg = moe_config(spec).replace(moe_impl="gather")
    w, x = moe_inputs(cfg, spec, dev)
    with RoutingProbe() as probe, torch.no_grad():
        y = blocks.apply_moe(cfg, blocks.Params(w), x)
    eid = probe.eids[-1]
    kept = blocks.moe_slots(eid, cfg.moe.num_experts) < \
        blocks.moe_capacity(cfg, eid.shape[0])
    out = {"y": y.cpu(), "eid": eid.cpu(), "kept": kept.cpu()}
    del w, x, y
    release(dev)
    return out


def tp_specs(seed: int) -> dict:
    """(e)'s two ``lm_tp`` jobs: bf16 at full depth, float32 at
    PARITY_F32_LAYERS layers."""
    base = dict(job="lm_tp", arch=TP_ARCH, mesh=TP_MESH, seed=seed + 16,
                shape=list(TP_SHAPE), steps=TP_STEPS, smoke=TP_SMOKE)
    return {"tp-bf16": dict(base, name="tp-bf16"),
            "tp-f32": dict(base, name="tp-f32", layers=PARITY_F32_LAYERS,
                           replace={"param_dtype": "float32",
                                    "compute_dtype": "float32"})}


def tp4_specs(seed: int) -> dict:
    """(f)'s ``lm_tp`` jobs, two an arch of TP4_RUNS: bf16 at the cut
    depth, float32 at the float32 config; each with its parity bound
    (``bound``) and, for the MoE archs, the experts recorded
    (``routes``)."""
    import repro_torch.configs as C
    from repro_torch.models import lm
    specs = {}
    for i, (arch, cut, shape, f32) in enumerate(TP4_RUNS):
        cfg = C.get(arch).replace(**cut)
        kinds = cfg.layer_kinds
        n_mla = sum(lm.is_mla(cfg, k) for k in kinds)
        base = dict(job="lm_tp", arch=arch, mesh=TP_MESH, seed=seed + 17 + i,
                    steps=TP4_STEPS, smoke=TP_SMOKE,
                    routes=cfg.moe is not None)
        tag = arch.split("_")[0]
        specs[f"tp4-{tag}-bf16"] = dict(
            base, name=f"tp4-{tag}-bf16", shape=list(shape),
            replace=dict(cut), bound=parity_bound(
                len(kinds), kinds.count("rec"), n_mla))
        specs[f"tp4-{tag}-f32"] = dict(
            base, name=f"tp4-{tag}-f32", shape=list(TP4_F32_SHAPE),
            replace=dict(f32, param_dtype="float32",
                         compute_dtype="float32"), bound=MOE_F32_BOUND)
    return specs


def tp_replicated(dev, spec: dict) -> dict:
    """(e)'s and (f)'s replicated run on the card: the job's draw and ids
    through ``launch.ranks.serve_lm`` without a mesh (the experts
    recorded where the job records them); the model freed after."""
    import torch
    from repro_torch.launch.ranks import lm_config, lm_tp_inputs, serve_lm
    t0 = time.perf_counter()
    cfg = lm_config(spec)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    model, toks = lm_tp_inputs(cfg, spec, dev)
    out = serve_lm(cfg, model, toks, spec["steps"], dev,
                   routes=bool(spec.get("routes")))
    out["param_bytes"] = sum(p.nbytes for p in model.parameters())
    out["peak_gib"] = memory_gib(dev, peak=True)
    del model, toks, out["caches"]
    release(dev)
    out["seconds"] = time.perf_counter() - t0
    return out


def route_flips(got: dict, want: dict, n: int) -> dict:
    """Where the experts two runs chose part (``serve_lm``'s ``routes`` of
    one request, B 1): ``prefill`` the prefill's positions at which any
    MoE layer's expert set differs, ``decode`` the first decode step at
    which one does (``n``, the steps, where none), ``short`` whether the
    decode's differ from the short prefill's at any position (the decode
    against the prefill of the decoded tokens)."""
    def sets(layers):
        return [e.sort(dim=-1).values for e in layers]

    def diff(a, b):
        return [bool((x != y).any()) for x, y in zip(sets(a), sets(b))]
    pre = [p for p in range(got["prefill"][0].shape[0]) if any(
        bool((x[p] != y[p]).any()) for x, y in zip(sets(got["prefill"]),
                                                     sets(want["prefill"])))]
    steps = [any(diff(g, w)) for g, w in zip(got["decode"], want["decode"])]
    first = steps.index(True) if any(steps) else n
    short = sets(got["prefill_short"])
    moved = any(bool((e.sort(dim=-1).values != short[layer][t]).any())
                for t, step in enumerate(got["decode"])
                for layer, e in enumerate(step))
    return {"prefill": pre, "decode": first, "short": moved}


def held_positions(cfg, got: list, want: list, b: int) -> tuple:
    """The prefill positions at which two runs' logits are held although
    their routes part somewhere (``serve_lm``'s ``routes["prefill"]``: one
    [B S, K] a MoE layer, in layer order), [B, S] bool: where every MoE
    layer chose the same experts on both runs and kept the same of their
    slots (a slot's place in its expert's buffer counts the earlier
    tokens' choices), and no MoE layer but the model's last one parted at
    an earlier position of the request (the next layers' attention or
    recurrence mixes it into the later positions; after the last layer's
    FFN the logits are position-wise).  Also returns each request's
    positions before its first parting in any layer (the rule of
    ``moe_decode_vs_prefill``), [B]."""
    import torch
    from repro_torch.models import blocks
    moe_at = [i for i, k in enumerate(cfg.layer_kinds) if k == "attn_moe"]
    e = cfg.moe.num_experts
    held = before = None
    for layer, g, w in zip(moe_at, got, want):
        cap = blocks.moe_capacity(cfg, g.shape[0])
        kept = [(blocks.moe_slots(x, e) < cap).gather(-1, x.argsort(-1))
                for x in (g, w)]
        same = ((g.sort(-1).values == w.sort(-1).values).all(-1)
                & (kept[0] == kept[1]).all(-1)).view(b, -1)
        prefix = same.int().cumprod(-1).bool()
        ok = same if layer == cfg.n_layers - 1 else prefix
        held = ok if held is None else held & ok
        before = prefix if before is None else before & prefix
    return held, before.sum(-1)


def tp_rank_bytes(spec: dict) -> list:
    """Each rank's parameter bytes as ``meta`` counts them: the model of
    ``MetaMesh(TP_MESH, rank=r)`` (``lm.init_params(..., mesh=)``)."""
    from repro_torch.launch.mesh import MetaMesh
    from repro_torch.launch.ranks import lm_config
    from repro_torch.models import lm
    cfg = lm_config(spec)
    return [sum(p.nbytes for p in lm.init_params(
        cfg, None, "meta", mesh=MetaMesh(TP_MESH, rank=r)).parameters())
        for r in range(RANK_SHARDS)]


def check_tp(work: Path, outs: list, specs: dict, want: dict) -> list:
    """(e) and (f): the ranks' logits against the replicated run's, decode
    against prefill, each rank's parameter bytes against ``meta``'s count;
    logs the flash launches, seconds and peaks.  A job's bound is its
    ``bound`` ((f)) or PARITY_TOL ((e)); where the job recorded the
    experts (the MoE archs), the prefill's logits at every position are
    held where no routing flip can reach them (:func:`held_positions`;
    how many positions, and how many before the first flip, printed), the
    decode up to the first step where one parts the two runs, decode
    against prefill only where the decode's experts are the short
    prefill's (the flips printed).  Returns what failed."""
    import torch
    from repro_torch.launch.ranks import lm_config
    from repro_torch.models.common import softcap
    bad = []

    def gap(a, b):
        return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
    for n, spec in specs.items():
        cfg = lm_config(spec)
        f32 = cfg.compute_dtype == "float32"
        tol = spec.get("bound", PARITY_TOL["float32" if f32 else "bfloat16"])
        got, rep = torch.load(work / f"{n}.pt"), want[n]["logits"]
        errs = {k: gap(got[k], rep[k]) for k in ("prefill", "decode")}
        last = softcap(got["prefill_short"][:, 0], cfg.logit_softcap)
        errs["decode_vs_prefill"] = gap(got["decode"][-1], last)
        held, flips = dict(errs), None
        if "routes" in got:
            flips = route_flips(got["routes"], rep["routes"], spec["steps"])
            mask, before = held_positions(cfg, got["routes"]["prefill"],
                                          rep["routes"]["prefill"],
                                          got["prefill_every"].shape[0])
            a, w = (x["prefill_every"].float() for x in (got, rep))
            scale = max(1.0, float(w.abs().max()))
            flips["held"] = (int(mask.sum()), mask.numel(), before.tolist())
            held["prefill"] = float((a - w)[mask].abs().max()) / scale \
                if bool(mask.any()) else 0.0
            errs["prefill_every"] = float((a - w).abs().max()) / scale
            held["decode"] = gap(got["decode"][:flips["decode"]],
                                 rep["decode"][:flips["decode"]]) \
                if flips["decode"] else 0.0
            if flips["short"]:
                held.pop("decode_vs_prefill")
        finite = all(bool(got[k].isfinite().all()) for k in
                     ("prefill", "prefill_short", "decode"))
        meta = tp_rank_bytes(spec)
        o = [out[n] for out in outs]
        held_bytes = [x["param_bytes"] for x in o]
        s = spec.get("shape") or list(TP_SHAPE)
        log(f"  [ranks-tp] {n}: {spec['arch']} "
            f"{cfg.n_layers} layers {cfg.layer_kinds} on {RANK_SHARDS} ranks "
            f"{spec['mesh']}, prefill {s[0]} x {s[1]}, {spec['steps']} decode "
            f"steps: max |ranks - replicated| / max |logit| prefill "
            f"{errs['prefill']:.3g}, decode {errs['decode']:.3g}; decode vs "
            f"prefill {errs['decode_vs_prefill']:.3g}; held "
            f"{ {k: float(f'{v:.3g}') for k, v in held.items()} } (bound "
            f"{tol:.3g})"
            + (f"; routing flips against the replicated run: prefill "
               f"positions {flips['prefill'][:8]} ({len(flips['prefill'])}), "
               f"first decode step {flips['decode']} of {spec['steps']}, "
               f"decode's experts off the short prefill's {flips['short']}; "
               f"prefill held at {flips['held'][0]} of {flips['held'][1]} "
               f"positions ({flips['held'][2]} before the first flip; every "
               f"position {errs['prefill_every']:.3g})"
               if flips is not None else "")
            + f"; flash launches a rank {[x['flash'] for x in o]}; a rank "
            f"holds (heads, experts, columns) {o[0]['heads']}, "
            f"{o[0]['experts']}, {o[0]['columns']}; parameter bytes a rank "
            f"{held_bytes} (meta {meta}; replicated "
            f"{want[n]['param_bytes']})")
        share = [x["prefill_comm"]["psum_s"] / x["prefill_s"] for x in o]
        log(f"  [ranks-tp] {n}: prefill s a rank "
            f"{[round(x['prefill_s'], 4) for x in o]} (replicated "
            f"{want[n]['prefill_s']:.4f} s), decode ms a step (median) "
            f"{[round(float(np.median(x['decode_s'])) * 1e3, 2) for x in o]}"
            f" (replicated "
            f"{float(np.median(want[n]['decode_s'])) * 1e3:.2f} ms; phase "
            f"5: {LM_TIMES}); inside the gloo reductions, prefill "
            f"{[round(x['prefill_comm']['psum_s'], 4) for x in o]} s "
            f"({o[0]['prefill_comm']['psum_calls']} psums, "
            f"{[round(v, 3) for v in share]} of the prefill) and gathers "
            f"{[round(x['prefill_comm']['gather_s'], 4) for x in o]} s "
            f"({o[0]['prefill_comm']['gather_calls']}), "
            f"decode {[round(x['decode_comm']['psum_s'], 4) for x in o]} s "
            f"({o[0]['decode_comm']['psum_calls']} psums); peak device "
            f"memory a rank {[round(x['peak_gib'], 2) for x in o]} GiB "
            f"(replicated {want[n]['peak_gib']:.2f} GiB); the job "
            f"{[round(x['job_seconds'], 2) for x in o]} s a rank, the "
            f"replicated run {want[n]['seconds']:.2f} s")
        if not (finite and max(held.values()) <= tol and held_bytes == meta
                and (flips is None or flips["decode"] > 0)):
            bad.append(f"{n}: held errors {held} over {tol}, finite "
                       f"{finite}, parameter bytes {held_bytes} != meta's "
                       f"{meta}, or a routing flip at the first decode "
                       f"step ({flips})")
    return bad


def train_tp_specs(seed: int) -> dict:
    """(g)'s two ``lm_train`` jobs: bf16 at full width and the cut depth,
    float32 at smoke width; each rank dumps its parameters after the
    steps."""
    base = dict(job="lm_train", arch=TRAIN_TP_ARCH, mesh=TRAIN_TP_MESH,
                seed=seed + 21, dump="params")
    return {
        "tp-train-bf16": dict(base, name="tp-train-bf16",
                              layers=TRAIN_TP_LAYERS, smoke=TRAIN_TP_SMOKE,
                              shape=list(TRAIN_TP_SHAPE), opt=STEP_OPT),
        "tp-train-f32": dict(base, name="tp-train-f32", smoke=True,
                             shape=list(TRAIN_TP_F32_SHAPE),
                             opt=TRAIN_TP_F32_OPT,
                             replace={"param_dtype": "float32",
                                      "compute_dtype": "float32"})}


def train_tp_replicated(dev, spec: dict) -> dict:
    """(g)'s replicated run on the card: the job's draw and batches
    through ``launch.ranks.train_lm`` without a mesh; the parameters and
    AdamW's first moments after the steps (and the parameters before, in
    float32) kept on the card for the check, each step's largest
    |gradient| of each leaf (``GradMaxProbe``: the moments' bound), and
    the largest |logit| of a prefill of the first batch (the bf16 bounds'
    scale)."""
    import torch
    from repro_torch.launch.ranks import lm_config, lm_train_inputs, \
        train_lm
    from repro_torch.models import lm
    t0 = time.perf_counter()
    cfg = lm_config(spec)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    model, batches = lm_train_inputs(cfg, spec, dev)
    before = {n: p.detach().clone() for n, p in model.named_parameters()} \
        if cfg.param_dtype == "float32" else None
    with torch.inference_mode():
        logit_max = float(lm.prefill(cfg, model, batches[0]["inputs"],
                                     every=True).abs().max())
    with GradMaxProbe() as probe:
        out, state = train_lm(cfg, model, batches, dev, None, spec["opt"])
    out.update(before=before, logit_max=logit_max, m=state["m"],
               grad_max=probe.steps,
               peak_gib=memory_gib(dev, peak=True),
               params={n: p.detach()
                       for n, p in model.named_parameters()})
    del model, batches
    release(dev)
    out["seconds"] = time.perf_counter() - t0
    return out


def train_tp_bounds(cfg, opt: dict, steps: int, logit_max: float) -> dict:
    """(g)'s bf16 bounds, ranks against the replicated run, derived before
    the first run.  ``loss``: a step's loss is a mean of logsumexp minus
    the gold logit, each of which moves by at most the logits' error,
    which ``parity_bound`` holds to a share of the largest |logit| (a
    forward's roundings; the ranks' reductions add their partials in
    float32 and round once, against one bf16 product): twice it, of
    ``logit_max`` (at least 1).  The second step reads weights that part
    where Adam's step follows rounding (gradients within rounding of 0,
    along which the loss is flat), which adds no more.  ``grad_norm``:
    relative, twice ``parity_bound``: the backward passes through as many
    roundings a layer as the forward (each reduction's adjoint is the
    identity or a sum of as many partials).  ``param(max_p)``: a leaf's
    largest |difference| after the steps, with ``max_p`` its largest
    |parameter|: each step moves an element by at most lr_t (1.001 + wd
    |p|) (Adam's |m^ / sqrt(v^)| is at most 1 at step 1 and 1.0004 at step
    2 with the reference's betas), and two runs can step opposite ways,
    so 2 sum_t lr_t (1.001 + wd max_p); each step rounds to bf16 once (8
    bits: at most 2^-7 max_p apart), 2^-6 max_p over two steps.  This
    bounds rounding and opposite steps only: it is past any one update,
    so a skipped or reversed update passes it, and ``moment_bound`` holds
    the update instead."""
    from repro_torch.optim import AdamWConfig, cosine_schedule
    ocfg = AdamWConfig(**opt)
    lrs = [float(cosine_schedule(ocfg, t)) for t in range(1, steps + 1)]
    pb = parity_bound(cfg.n_layers)
    return {"loss": 2 * pb * max(1.0, logit_max), "grad_norm": 2 * pb,
            "param": lambda max_p: 2.0**-6 * max_p + 2 * sum(lrs) * (
                1.001 + ocfg.weight_decay * max_p)}


def moment_bound(opt: dict, rel: float, grad_norms, grad_max) -> float:
    """(g)'s bound on a leaf's largest |difference| of AdamW's first moment
    m after the steps, ranks against the replicated run, derived before
    the first run that holds it.  m after T steps is sum_t w_t s_t g_t,
    with w_t = (1 - b1) b1^(T - t) and s_t = min(1, clip / |g_t|) the
    clip's scale, in float32 (no rounding of its own to speak of).  Each
    gradient element is within ``rel`` of its leaf's largest |gradient|
    G_t (the grad norm's bound, elementwise: ``train_tp_bounds``' 2
    ``parity_bound`` in bf16, MOE_F32_BOUND in float32), and the scale
    within ``rel`` of itself (the grad norm's), so |s' g' - s g| <= 2 rel
    s G_t: in all, 2 rel sum_t w_t s_t G_t, with ``grad_norms`` (the
    replicated run's |g_t|) and ``grad_max`` (its G_t) by step.  A rank
    whose update is skipped holds m = 0, and one whose gradient is summed
    wrongly (a slice on another leaf, a reduction missing) another m: each
    far past this (1 / (2 rel) of it where a leaf's largest gradients
    fall on one element in both steps, 11 in bf16 at 2 layers)."""
    from repro_torch.optim import AdamWConfig
    ocfg = AdamWConfig(**opt)
    steps = len(grad_max)
    total = 0.0
    for t, (norm, top) in enumerate(zip(grad_norms, grad_max)):
        scale = min(1.0, ocfg.clip_norm / max(norm, 1e-9)) \
            if ocfg.clip_norm > 0 else 1.0
        total += (1 - ocfg.b1) * ocfg.b1**(steps - 1 - t) * scale * top
    return 2 * rel * total


def train_tp_meta_bytes(spec: dict) -> list:
    """Each rank's (parameter, moment) bytes as the dry-run on ``meta``
    counts them: ``input_specs`` of the job's train cell under
    ``MetaMesh(TRAIN_TP_MESH, rank=r)``, ``storage_bytes`` of the model
    and of AdamW's ``m`` and ``v``."""
    from repro_torch.launch.dryrun import storage_bytes
    from repro_torch.launch.mesh import MetaMesh
    from repro_torch.launch.ranks import lm_config
    from repro_torch.launch.steps import input_specs
    from repro_torch.models.config import ShapeCell
    cfg = lm_config(spec)
    _, b, s = spec["shape"]
    out = []
    for r in range(RANK_SHARDS):
        _, args = input_specs(cfg, ShapeCell("train", s, b, "train"),
                              mesh=MetaMesh(TRAIN_TP_MESH, rank=r))
        out.append([storage_bytes(args[0]),
                    storage_bytes([args[1]["m"], args[1]["v"]])])
    return out


def check_train_tp(work: Path, outs: list, specs: dict, want: dict) -> list:
    """(g): each rank's losses, grad norms, parameter shards and AdamW's
    first moments after the steps against the replicated run's (bf16
    within :func:`train_tp_bounds`, float32 within MOE_F32_BOUND: the
    losses and grad norms relative, the parameters of a leaf's largest
    |update|; the moments within :func:`moment_bound` in both),
    each rank's parameter and moment bytes against ``meta``'s; logs the
    step seconds, the seconds and calls inside the gloo collectives by
    phase, peaks and flash launches.  Returns what failed."""
    import torch
    from repro_torch.core.distributed import coords_of
    from repro_torch.launch.ranks import lm_config
    from repro_torch.models import lm
    from repro_torch.models.shard import Layout
    bad = []
    for n, spec in specs.items():
        cfg, w = lm_config(spec), want[n]
        f32 = cfg.param_dtype == "float32"
        steps = spec["shape"][0]
        bounds = train_tp_bounds(cfg, spec["opt"], steps, w["logit_max"])
        plan = lm.plan_model(cfg)
        o = [out[n] for out in outs]
        errs = {"loss": 0.0, "grad_norm": 0.0, "param": 0.0}
        for x in o:
            for k in ("loss", "grad_norm"):
                e = max(abs(a - b) / (max(1.0, abs(b)) if k == "loss" else
                                      abs(b)) for a, b in zip(x[k], w[k]))
                errs[k] = max(errs[k], e)
        worst = worst_m = (0.0, None)
        rel = MOE_F32_BOUND if f32 else bounds["grad_norm"]
        for r in range(RANK_SHARDS):
            layout = Layout(cfg, TRAIN_TP_MESH, coords_of(TRAIN_TP_MESH, r))
            dump = torch.load(work / f"{n}_r{r}.pt", map_location=next(
                iter(w["params"].values())).device)
            got = dump["params"]
            for leaf, m in dump["m"].items():
                ref = layout.take(leaf, plan[leaf], w["m"][leaf])
                diff = float((m - ref).abs().max())
                tol = moment_bound(spec["opt"], rel, w["grad_norm"],
                                   [g[leaf] for g in w["grad_max"]])
                share = diff / max(tol, 1e-30)
                if share > worst_m[0] or worst_m[1] is None:
                    worst_m = (share, f"rank {r} {leaf}: {diff:.3g} of "
                                      f"{tol:.3g}")
            for leaf, p in got.items():
                ref = layout.take(leaf, plan[leaf], w["params"][leaf])
                diff = float((p.float() - ref.float()).abs().max())
                if f32:
                    old = layout.take(leaf, plan[leaf], w["before"][leaf])
                    tol = MOE_F32_BOUND * float((ref - old).abs().max())
                else:
                    tol = bounds["param"](float(w["params"][leaf].float()
                                                .abs().max()))
                share = diff / max(tol, 1e-30)
                if share > worst[0]:
                    worst = (share, f"rank {r} {leaf}: {diff:.3g} of "
                                    f"{tol:.3g}")
            del got, dump
        errs["param"] = worst[0]
        tol = ({"loss": MOE_F32_BOUND, "grad_norm": MOE_F32_BOUND} if f32
               else {k: bounds[k] for k in ("loss", "grad_norm")})
        meta = train_tp_meta_bytes(spec)
        held = [[x["param_bytes"], x["opt_bytes"]] for x in o]
        finite = all(np.isfinite(x["loss"]).all()
                     and np.isfinite(x["grad_norm"]).all() for x in o)
        _, b, s = spec["shape"]
        phase_line = "; ".join(
            f"{ph} " + ", ".join(
                f"psum {c[ph]['psum_s']:.3f} s ({c[ph]['psum_calls']}) "
                f"gather {c[ph]['gather_s']:.3f} s "
                f"({c[ph]['gather_calls']})" for c in o[0]["comm"])
            for ph in ("forward", "backward", "grads", "update"))
        log(f"  [ranks-train] {n}: {spec['arch']} {cfg.n_layers} layers "
            f"d {cfg.d_model} vocab {cfg.vocab} {cfg.param_dtype} on "
            f"{RANK_SHARDS} ranks {TRAIN_TP_MESH}, {steps} steps of {b} x "
            f"{s}: losses ranks {o[0]['loss']} replicated {w['loss']}; grad "
            f"norms {o[0]['grad_norm']} / {w['grad_norm']}; largest gap "
            f"(all ranks) loss {errs['loss']:.3g} (bound {tol['loss']:.3g}"
            f"), grad norm {errs['grad_norm']:.3g} (bound "
            f"{tol['grad_norm']:.3g}), parameters at most {worst[0]:.3g} of "
            f"their bound ({worst[1]}), first moments at most "
            f"{worst_m[0]:.3g} of theirs ({worst_m[1]}); max |logit| "
            f"{w['logit_max']:.4g}; "
            f"parameter and moment bytes a rank {held} (meta {meta})")
        log(f"  [ranks-train] {n}: step s a rank "
            f"{[[round(t, 3) for t in x['step_s']] for x in o]} "
            f"(replicated {[round(t, 3) for t in w['step_s']]}); rank 0 "
            f"inside the gloo collectives by step: {phase_line}; peak "
            f"device memory a rank {[round(x['peak_gib'], 2) for x in o]} "
            f"GiB (replicated {w['peak_gib']:.2f}); flash launches a rank "
            f"a step {[x['flash'] for x in o]} (replicated {w['flash']}); "
            f"the job {[round(x['job_seconds'], 2) for x in o]} s a rank, "
            f"the replicated run {w['seconds']:.2f} s")
        if not (finite and errs["loss"] <= tol["loss"]
                and errs["grad_norm"] <= tol["grad_norm"]
                and worst[0] <= 1.0 and worst_m[0] <= 1.0
                and held == meta):
            bad.append(f"{n}: loss {errs['loss']} / {tol['loss']}, grad "
                       f"norm {errs['grad_norm']} / {tol['grad_norm']}, "
                       f"parameters {worst}, first moments {worst_m}, "
                       f"finite {finite}, bytes {held} != meta's {meta}")
    return bad


def drive_ranks(dev, rng, docs, steps, mrbg_results, sssp_kept,
                seed: int) -> dict:
    """Phase 15: (a) one rank on nccl, (b) 4 ranks sharing the card on
    gloo (wordcount, SSSP, PageRank), (c) Llama 4 Scout's MoE layer on 4
    ranks, (d) ``compressed_psum`` on 4 ranks, (e) Gemma 2 9B served
    tensor-parallel on the 4 ranks, (f) the MoE, MLA and recurrent archs
    likewise, (g) Qwen3-1.7B trained over (data 2, model 2).  Returns the
    ranks' launches of (a), (b), (e), (f) and (g) added up."""
    import torch
    from repro_torch.apps import pagerank
    from repro_torch.launch.ranks import moe_config, save_deltas
    from repro_torch.optim.compress import compressed_psum
    work = ROOT / "build" / f"ranks-{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    try:
        # inputs: phase 3's corpus and update (a), phase 4's SSSP graph and
        # update, a PageRank graph of phase 9 (c)'s size and 64 of its
        # vertices rewired (RANK_PR_REWIRE)
        label, (rid, words, sign), _, _ = steps[0]
        np.savez(work / "in_wordcount.npz", **save_deltas(
            {"docs": docs, "vocab": VOCAB}, [(rid, {"w": words}, sign)]))
        np.savez(work / "in_sssp.npz", **save_deltas(
            {"nbrs": sssp_kept["nbrs"], "w": sssp_kept["w"], "src": 0},
            [sssp_kept["delta"]]))
        nbrs = pagerank.random_graph(RANK_PR_VERTICES, OUT_SLOTS, seed=int(
            rng.integers(2**31)), p_edge=P_EDGE)
        delta, after = rewire_delta(rng, nbrs, RANK_PR_REWIRE)
        np.savez(work / "in_pagerank.npz",
                 **save_deltas({"nbrs": nbrs}, [delta]))
        pr_ref, pr_ch = pagerank_fixpoint(nbrs, dev=dev)
        pr_ref2, pr_ch2 = pagerank_fixpoint(after, r0=pr_ref, dev=dev)
        del nbrs, after
        failures = []

        # (a) one rank on nccl
        log(f"  (a) 1 rank, nccl, cuda:0, RankMesh({{'data': 1}}): "
            f"wordcount run and {label}")
        t0 = time.perf_counter()
        # (a CPU rehearsal has no nccl: it runs gloo)
        outs = launch_ranks(dev, work, 1,
                            "nccl" if dev.type == "cuda" else "gloo", [{
            "job": "wordcount", "name": "a", "mesh": {"data": 1},
            "data": str(work / "in_wordcount.npz")}])
        got = np.load(work / "a.npz")
        same = [np.array_equal(got[f"r{i}"], mrbg_results[i])
                for i in range(2)]
        if not all(same):
            failures.append(f"(a): run, update (a) equal to phase 3's "
                            f"mrbg session: {same}")
        launches = rank_lines("ranks-nccl", "a", outs)
        log(f"  [ranks-nccl] run and update (a) bitwise equal to phase 3's "
            f"mrbg session: {same}; modes "
            f"{[e['mode'] for e in outs[0]['a']['epochs']]}; "
            f"{time.perf_counter() - t0:.1f} s with the process's start")

        # the references of (b), (c), (d), before the ranks take the card
        t0 = time.perf_counter()
        kw = {"wordcount": {}, "sssp": {},
              "pagerank": {"cpc_threshold": PR_CPC}}
        local = {job: local_mesh_run(dev, job, np.load(
            work / f"in_{job}.npz"), kw[job]) for job in kw}
        # a second LocalMesh PageRank: how far two runs of the same
        # session part on the card, whose float adds are atomic
        local["pagerank-again"] = local_mesh_run(
            dev, "pagerank", np.load(work / "in_pagerank.npz"),
            kw["pagerank"])
        for job, (reps, _, secs) in local.items():
            log(f"  [ranks-local] {job} LocalMesh({{'data': "
                f"{RANK_SHARDS}}}) on the card: "
                f"{', '.join(f'{s:.3f}' for s in secs)} s, modes "
                f"{[r['mode'] for r in reps]}")
        moe = {
            "moe-bf16": dict(shape=MOE_RANK_SHAPE,
                             capacity_factor=MOE_RANK_CF),
            "moe-f32": dict(shape=MOE_RANK_F32_SHAPE,
                            capacity_factor=MOE_RANK_CF,
                            replace={"param_dtype": "float32",
                                     "compute_dtype": "float32"}),
            "moe-cf": dict(shape=MOE_RANK_SHAPE)}
        moe = {n: dict(s, job="moe", name=n, arch=MOE_RANK_ARCH,
                       mesh=MOE_RANK_MESH, seed=seed + 15,
                       smoke=MOE_RANK_SMOKE)
               for n, s in moe.items()}
        want = {n: moe_gather_want(dev, s) for n, s in moe.items()}
        x = torch.randn((RANK_SHARDS, 4096, 512), generator=torch.Generator(
            device=dev).manual_seed(seed + 15), device=dev)
        x *= torch.logspace(-2, 2, RANK_SHARDS, device=dev)[:, None, None]
        err = torch.zeros_like(x).normal_(0, 1e-3)
        np.savez(work / "in_compress.npz", x=x.cpu().numpy(),
                 err=err.cpu().numpy())
        cmean, cerr = compressed_psum(x, err)
        cmean, cerr = cmean.cpu().numpy(), cerr.cpu().numpy()
        del x, err
        release(dev)
        tp = tp_specs(seed)
        tp_want = {n: tp_replicated(dev, spec) for n, spec in tp.items()}
        log(f"  references (LocalMesh, the gather layer, the stacked "
            f"compressed_psum, (e)'s replicated runs) "
            f"{time.perf_counter() - t0:.1f} s")
        t_f = time.perf_counter()
        tp4 = tp4_specs(seed)
        for n, spec in tp4.items():
            tp_want[n] = tp_replicated(dev, spec)
        t_f = time.perf_counter() - t_f
        log(f"  (f)'s replicated runs {t_f:.1f} s")
        t_g = time.perf_counter()
        trn = train_tp_specs(seed)
        trn_want = {n: train_tp_replicated(dev, spec)
                    for n, spec in trn.items()}
        t_g = time.perf_counter() - t_g
        log(f"  (g)'s replicated runs {t_g:.1f} s")

        # (b) + (c) + (d): one launch of 4 ranks sharing the card on gloo
        t0 = time.perf_counter()
        jobs = [{"job": job, "name": f"b-{job}", "mesh": {"data": RANK_SHARDS},
                 "data": str(work / f"in_{job}.npz"), "config": kw[job]}
                for job in kw]
        jobs += list(moe.values())
        jobs.append({"job": "compress", "name": "d",
                     "data": str(work / "in_compress.npz")})
        jobs += list(tp.values()) + list(tp4.values()) + list(trn.values())
        log(f"  (b)-(g) {RANK_SHARDS} ranks, gloo (host staging), all on "
            f"cuda:0: {[j['name'] for j in jobs]}")
        outs = launch_ranks(dev, work, RANK_SHARDS, "gloo", jobs)
        log(f"  [ranks-gloo] the launch: {time.perf_counter() - t0:.1f} s "
            f"with the processes' start")
        for job in kw:
            reps, results, secs = local[job]
            n = f"b-{job}"
            got = np.load(work / f"{n}.npz")
            if job != "pagerank":
                failures += check_ranks_equal(f"ranks-{job}", n, outs, reps,
                                              got, results)
            else:
                # the run within RANK_PR_TOL, its reports equal; the
                # refresh (CPC 1e-3: a DK whose accumulated change lies
                # within the adds' rounding of the threshold is emitted
                # on one run and not the other) in LocalMesh's mode and
                # iterations on every rank, within RANK_PR_REFRESH_TOL of
                # LocalMesh's, and within phase 9's bound of the float64
                # fixpoint, beside a second LocalMesh run
                failures += check_ranks_equal(
                    f"ranks-{job}", n, outs, reps, got, results,
                    RANK_PR_TOL, epochs=[0])
                again = local["pagerank-again"]
                gap = lambda a, b: float(np.abs(
                    a.astype(np.float64) - b).max())
                moved = gap(results[1], results[0])
                to_local = gap(got["r1"], results[1])
                to_again = gap(again[1][1], results[1])
                steer = ("dropped", "shuffle_cap", "regrows", "steps")
                for r, out in enumerate(outs):
                    e = out[n]["epochs"][1]
                    if e["mode"] != "distributed-i2" or \
                            e["iters"] != reps[1]["iters"] or \
                            any(e["shuffle"][k] != reps[1]["shuffle"][k]
                                for k in steer):
                        failures.append(
                            f"(b) PageRank refresh, rank {r}: mode "
                            f"{e['mode']}, iterations {e['iters']}, "
                            f"ShuffleStats {e['shuffle']}; LocalMesh "
                            f"distributed-i2 wanted, {reps[1]['mode']}, "
                            f"{reps[1]['iters']}, {reps[1]['shuffle']}")
                for what, g in (("ranks", to_local),
                                ("LocalMesh again", to_again)):
                    if not np.isfinite(g) or g > RANK_PR_REFRESH_TOL:
                        failures.append(
                            f"(b) PageRank refresh: max |{what} - "
                            f"LocalMesh| {g:.4g} > RANK_PR_REFRESH_TOL "
                            f"{RANK_PR_REFRESH_TOL:g}")
                if not moved >= RANK_PR_SEEN * RANK_PR_REFRESH_TOL:
                    failures.append(
                        f"(b) PageRank refresh: it moves LocalMesh's ranks "
                        f"by {moved:.4g}, under {RANK_PR_SEEN} x "
                        f"RANK_PR_REFRESH_TOL: the check could not see a "
                        f"refresh that did nothing")
                from repro_torch.api import RunConfig
                held = RANK_PR_VERTICES * max(
                    reps[0]["max_change"][-1], PR_CPC + RunConfig(
                        device=dev.type, **kw[job]).refresh_tol_)
                for label, r in (("ranks", got["r1"]),
                                 ("LocalMesh", results[1]),
                                 ("LocalMesh again", again[1][1])):
                    try:
                        line = check_pagerank(f"phase 15 {label} refresh",
                                              r, pr_ref2, held, pr_ch2)
                        log(f"  [ranks-pagerank] refresh, {label}: {line}")
                    except AssertionError as e:
                        failures.append(str(e))
                log(f"  [ranks-pagerank] refresh: max |ranks - LocalMesh| "
                    f"{to_local:.4g}, max |LocalMesh - LocalMesh again| "
                    f"{to_again:.4g} (tolerance {RANK_PR_REFRESH_TOL:g}); "
                    f"max |refresh - run| of LocalMesh {moved:.4g} (at "
                    f"least {RANK_PR_SEEN * RANK_PR_REFRESH_TOL:g}); modes "
                    f"ranks {[o[n]['epochs'][1]['mode'] for o in outs]}, "
                    f"LocalMesh {reps[1]['mode']}, again {again[0][1]['mode']}"
                    f"; iterations "
                    f"{[o[n]['epochs'][1]['iters'] for o in outs]}, "
                    f"{reps[1]['iters']}, {again[0][1]['iters']}; "
                    f"ShuffleStats ranks "
                    f"{outs[0][n]['epochs'][1]['shuffle']}, LocalMesh "
                    f"{reps[1]['shuffle']}, again {again[0][1]['shuffle']}")
            c = rank_lines(f"ranks-{job}", n, outs)
            launches = {k: launches.get(k, 0) + v for k, v in c.items()}

        # (c) the MoE layer
        for n, spec in moe.items():
            got, w = torch.load(work / f"{n}.pt"), want[n]
            yw, yg = w["y"].float(), got["y"].float()
            scale = float(yw.abs().max())
            err = float((yg - yw).abs().max())
            same = torch.equal(got["eid"], w["eid"])
            kept = torch.equal(got["kept"], w["kept"])
            o = outs[0][n]
            drops = (int((~got["kept"]).sum()), int((~w["kept"]).sum()))
            mo = moe_config(spec).moe
            log(f"  [ranks-moe] {n}: {MOE_RANK_ARCH} one MoE layer (d "
                f"{moe_config(spec).d_model}, {mo.num_experts} experts top "
                f"{mo.top_k}, d_ff_expert {mo.d_ff_expert}, shared "
                f"{mo.d_ff_shared}; {o['experts']} experts a rank), "
                f"{spec['shape'][0]} x "
                f"{spec['shape'][1]} tokens, capacity_factor "
                f"{spec.get('capacity_factor', 1.25)}, "
                f"{spec.get('replace', {}).get('compute_dtype', 'bfloat16')}"
                f": a2a on {RANK_SHARDS} ranks against the gather path: "
                f"max abs err {err:.4g} of max |y| {scale:.4g} "
                f"({err / scale:.3g} of it); expert ids equal {same}, kept "
                f"slots equal {kept}; dropped slots a2a {drops[0]}, gather "
                f"{drops[1]} of {o['slots']}; a2a "
                + ", ".join(f"rank {r} {out[n]['seconds'] * 1e3:.1f} ms "
                            f"peak {out[n]['peak_gib']:.2f} GiB"
                            for r, out in enumerate(outs)))
            if n == "moe-cf":
                continue
            bound = (MOE_RANK_BF16_REL if n == "moe-bf16"
                     else MOE_F32_BOUND) * scale
            if not (same and kept and err <= bound and drops == (0, 0)
                    and bool(torch.isfinite(yg).all())):
                failures.append(
                    f"(c) {n}: a2a against gather: ids {same}, kept {kept},"
                    f" err {err} > {bound}, or dropped {drops}")

        # (d) compressed_psum
        same = []
        for r in range(RANK_SHARDS):
            got = np.load(work / f"d_r{r}.npz")
            same.append(bool(np.array_equal(got["mean"], cmean[r])
                             and np.array_equal(got["err"], cerr[r])))
        if not all(same):
            failures.append(f"(d): compressed_psum on ranks equal to the "
                            f"stacked form: {same}")
        log(f"  [ranks-compress] (d) compressed_psum on {RANK_SHARDS} ranks "
            f"bitwise equal to the stacked form, rank by rank: {same}")

        # (e) the dense LM tensor-parallel, (f) the other block kinds
        failures += [f"(e) {f}" for f in check_tp(work, outs, tp, tp_want)]
        failures += [f"(f) {f}" for f in check_tp(work, outs, tp4, tp_want)]
        flash = sum(out[n]["flash"] for out in outs for n in tp)
        flash4 = sum(out[n]["flash"] for out in outs for n in tp4)
        jobs_f = [outs[0][n]["job_seconds"] for n in tp4]
        log(f"  [ranks-tp] (f) {t_f + sum(jobs_f):.1f} s: the replicated "
            f"runs {t_f:.1f} s and rank 0's jobs "
            f"{[round(x, 1) for x in jobs_f]} s; "
            f"flash launches (e) {flash}, (f) {flash4}, all ranks")
        if dev.type == "cuda" and flash4 == 0:
            failures.append("(f) launched no flash_attention")

        # (g) the LM trained over (data 2, model 2)
        failures += [f"(g) {f}" for f in check_train_tp(work, outs, trn,
                                                        trn_want)]
        flash_g = sum(sum(out[n]["flash"]) for out in outs for n in trn)
        jobs_g = [outs[0][n]["job_seconds"] for n in trn]
        log(f"  [ranks-train] (g) {t_g + sum(jobs_g):.1f} s: the replicated "
            f"runs {t_g:.1f} s and rank 0's jobs "
            f"{[round(x, 1) for x in jobs_g]} s; flash launches {flash_g}, "
            f"all ranks")
        if dev.type == "cuda" and flash_g == 0:
            failures.append("(g) launched no flash_attention")
        launches["flash_attention"] = launches.get("flash_attention",
                                                   0) + flash + flash4 + \
            flash_g
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if failures:
        raise AssertionError("phase 15: " + "; ".join(failures))
    for name in ("sort_lex", "segment_sum", "segment_minmax",
                 "fused_shuffle_reduce", "flash_attention"):
        if launches.get(name, 0) == 0:
            raise AssertionError(f"phase 15's ranks launched no {name}")
    return launches


# ---------------------------------------------------------------------------
# phase 16: training the MoE and recurrent archs (DeepSeek-V3, Llama 4
# Scout, RecurrentGemma 2B, xLSTM 125M)
# ---------------------------------------------------------------------------

# (a) the attention gradient at MLA's pairs of head dims, as phase 10 (a)
# (GRAD_SHAPE, GRAD_Q_STD, GRAD_REL; float32 on the FMA route): (label,
# DeepSeek-V3's preset, heads).  MLA expands its latent to every head, so
# KH = H; the 100m preset's 12 heads at (96, 64), full width's pair on 2.
MLA_GRAD_CASES = (("MLA q.k 96 / v 64 (--preset 100m)", "100m", 12),
                  ("MLA q.k 192 / v 128 (full width)", "full", 2))
# (b) phase 10 (b)'s steps (STEP_SHAPE, STEP_CHUNK, STEP_OPT, STEP_TOL,
# STEP_PARAM_TOL): the MoE archs at --preset 100m cut to STEP_LAYERS
# layers (DeepSeek-V3: its 3 mla_dense and one attn_moe, MTP on, flash at
# (96, 64); Llama 4 Scout: 4 attn_moe of 8 experts top 1), the recurrent
# archs' smoke configs (RecurrentGemma 2B at 3 layers, xLSTM 125M at 2),
# xLSTM's mLSTM loop in chunks of STEP_MLSTM_CHUNK of S 64 so that the
# chunked recompute acts
MOE_REC_STEPS = (("deepseek_v3_671b", "100m"),
                 ("llama4_scout_17b_a16e", "100m"),
                 ("recurrentgemma_2b", "smoke"), ("xlstm_125m", "smoke"))
STEP_LAYERS = 4
STEP_MLSTM_CHUNK = 16
# (c) full width, bf16, AdamW moments float32, remat full, loss_chunk 512,
# FULL_TRAIN_WARMUP + FULL_TRAIN_TIMED steps: (arch, layers (None: all),
# B (None: 2 if the dry-run on meta predicts a peak under
# FULL_TRAIN_PEAK_GB, else 1), S).  Cuts: Llama 4 Scout to 1 of 48 layers
# (4.27e9 parameters, 51 GB of weights, gradients and moments); train_4k's
# batch of 256 to 2; xLSTM's S to 128: its token loop steps a token at a
# time in Python, and a train step at S 512 took 26 s on the card, 13-15 s
# at 256 (NVIDIA H100 80GB HBM3, 700 W; about 50 ms a position, the loop
# run forward three times under remat and the chunks' recompute, and back
# once), too long for the script's time limit; at 128 the chunks of 64
# still act.
# DeepSeek-V3 does not fit: the experts of one attn_moe layer are 11.3e9
# parameters, about 136 GB at 12 bytes a parameter.
FULL_TRAIN_RUNS = (("llama4_scout_17b_a16e", 1, None, 4096),
                   ("recurrentgemma_2b", None, 2, 4096),
                   ("xlstm_125m", None, 2, 128))
FULL_TRAIN_WARMUP, FULL_TRAIN_TIMED = 1, 2
FULL_TRAIN_PEAK_GB = 76
# (d) phase 10 (d)'s restart (RESTART) through launch.train.train
RESTART_ARCH = "deepseek_v3_671b"


def attn_layers(cfg) -> int:
    """Layers whose attention runs the flash kernel without a cache (every
    kind but the recurrent ones)."""
    return sum(k not in ("rec", "mlstm", "slstm") for k in cfg.layer_kinds)


def moe_rec_grads(dev, rng) -> list:
    """(a): ``attn_grad_check`` at ``MLA_GRAD_CASES``."""
    import repro_torch.configs as C
    from repro_torch.launch.train import preset_config
    out = []
    for label, preset, h in MLA_GRAD_CASES:
        cfg = preset_config(C.get("deepseek_v3_671b"), preset).replace(
            param_dtype="float32", compute_dtype="float32")
        m = cfg.mla
        out.append(attn_grad_check(
            dev, rng, "moe-train", label, cfg, h, h,
            m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim))
    return out


def moe_rec_steps(dev, seed: int) -> None:
    """(b): ``steps_vs_cpu`` for each of ``MOE_REC_STEPS``, weights from
    ``parity_model`` (the reference's draw saturates the recurrent smoke
    nets and sends most tokens to one expert)."""
    import torch
    import repro_torch.configs as C
    from repro_torch.launch.train import preset_config
    from repro_torch.models import blocks
    cpu = torch.device("cpu")
    for arch, preset in MOE_REC_STEPS:
        cfg = preset_config(C.get(arch), preset)
        if preset == "100m":
            cfg = cfg.replace(n_layers=STEP_LAYERS)
        cfg = cfg.replace(param_dtype="float32", compute_dtype="float32",
                          remat="full", loss_chunk=STEP_CHUNK)
        host = parity_model(cfg, torch.Generator().manual_seed(seed), cpu)
        label = f"{cfg.name} --preset {preset}, {cfg.n_layers} layers " \
            f"{list(cfg.layer_kinds)}{', MTP' if cfg.mtp else ''}"
        chunk = blocks.MLSTM_CHUNK
        if "mlstm" in cfg.layer_kinds:
            blocks.MLSTM_CHUNK = STEP_MLSTM_CHUNK
            label += f", mLSTM in chunks of {STEP_MLSTM_CHUNK}"
        try:
            steps_vs_cpu(dev, seed, "moe-train", label, cfg, host,
                         undecided=True)
        finally:
            blocks.MLSTM_CHUNK = chunk


def train_batch_for(cfg, s: int) -> tuple:
    """Llama 4 Scout's batch in (c): 2 where ``launch.dryrun`` on ``meta``
    predicts the step's peak (arguments, output and temporaries) under
    ``FULL_TRAIN_PEAK_GB``, else 1.  Returns (B, the predicted peak in
    bytes)."""
    from repro_torch.launch import dryrun
    from repro_torch.models.config import ShapeCell
    mem = dryrun.dryrun(cfg, ShapeCell(f"train_2x{s}", s, 2, "train"))[
        "full"]["memory"]
    peak = sum(mem.values())
    return (2 if peak <= FULL_TRAIN_PEAK_GB * 1e9 else 1), peak


def train_arch_full(dev, seed: int, arch: str, layers, b, s: int) -> None:
    """(c) one arch at full width: ``FULL_TRAIN_WARMUP`` +
    ``FULL_TRAIN_TIMED`` steps of ``make_train_step`` (bf16, AdamW moments
    float32, remat full, loss_chunk 512) on weights from ``parity_model``:
    ms a step, tokens/s, peak memory, losses (finite), flash launches a
    step (forward and remat recompute of each attention layer), and the
    reference's model FLOPs (6 N_active T) against the bf16 peak.  For a
    config with mLSTM layers, one more step with the loop whole
    (``MLSTM_CHUNK`` at S) for its peak beside the chunked one's."""
    import torch
    import repro_torch.configs as C
    from repro_torch.data import LMDataConfig, lm_batch_at_step
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.mesh import PEAK_FLOPS
    from repro_torch.launch.roofline import active_params
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import blocks, lm
    from repro_torch.optim import AdamWConfig, adamw_init
    full = C.get(arch)
    cfg = full.replace(remat="full", loss_chunk=512,
                       **({"n_layers": layers} if layers else {}))
    predicted = None
    if b is None:
        b, predicted = train_batch_for(cfg, s)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed + 16)
    host = parity_model(cfg, gen, dev)
    model = lm.LM(cfg, {n: p.detach() for n, p in host.named_parameters()},
                  trainable=True)
    del host
    n_params, n_active = lm.count_params(model), active_params(cfg)
    opt_cfg = AdamWConfig()
    opt = adamw_init(dict(model.named_parameters()), opt_cfg)
    step = make_train_step(cfg, opt_cfg, dev)
    data = LMDataConfig(vocab=cfg.vocab, seq_len=s, global_batch=b,
                        seed=seed)
    sync(dev)
    t_init = time.perf_counter() - t0
    log(f"  [moe-train] (c) {cfg.name}: {cfg.n_layers} of {full.n_layers} "
        f"layers {sorted(set(cfg.layer_kinds))}, {n_params} parameters "
        f"({n_active} active), {cfg.param_dtype}, AdamW moments "
        f"{opt_cfg.opt_dtype}, remat {cfg.remat}, loss_chunk "
        f"{cfg.loss_chunk}; B {b} x S {s}"
        + (f" (the dry-run on meta predicts {predicted / 1e9:.2f} GB at B "
           f"2)" if predicted is not None else "")
        + f"; state {memory_gib(dev):.2f} GiB, built in {t_init:.1f} s")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses, secs = [], []
    before = flash_attention.launches
    n_steps = FULL_TRAIN_WARMUP + FULL_TRAIN_TIMED
    for i in range(n_steps):
        batch = lm_batch_at_step(data, i)
        t0 = time.perf_counter()
        model, opt, m = step(model, opt, batch)
        losses.append(float(m["loss"]))
        secs.append(time.perf_counter() - t0)
    launched = flash_attention.launches - before
    peak = memory_gib(dev, peak=True)
    want = n_steps * 2 * attn_layers(cfg) if dev.type == "cuda" else 0
    if launched != want:
        raise AssertionError(f"{cfg.name}: {n_steps} steps launched the "
                             f"flash kernel {launched} times, not {want}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{cfg.name}: losses not finite: {losses}")
    mean = float(np.mean(secs[FULL_TRAIN_WARMUP:]))
    tokens = b * s
    flops = 6 * n_active * tokens
    log(f"  [moe-train] (c) {cfg.name} losses {losses}; warm-up step "
        f"{secs[0]:.3f} s, timed steps "
        f"{[round(x * 1e3, 1) for x in secs[FULL_TRAIN_WARMUP:]]} ms: mean "
        f"{mean * 1e3:.1f} ms a step, {tokens / mean:.0f} tokens/s; peak "
        f"device memory {peak:.2f} GiB"
        + (f" (predicted {predicted / 2**30:.2f} GiB)"
           if predicted is not None and b == 2 else "")
        + f"; flash launches {launched} ({launched // n_steps} a step); "
        f"6 N_active T = {flops:.4g} FLOPs, bound at "
        f"{PEAK_FLOPS / 1e12:.0f} TFLOP/s bf16 {flops / PEAK_FLOPS * 1e3:.1f}"
        f" ms, share reached {flops / PEAK_FLOPS / mean:.1%}")
    if "mlstm" in cfg.layer_kinds:
        chunk = blocks.MLSTM_CHUNK
        blocks.MLSTM_CHUNK = s
        try:
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            model, opt, m = step(model, opt, lm_batch_at_step(data, n_steps))
            loss = float(m["loss"])
            whole_s = time.perf_counter() - t0
        finally:
            blocks.MLSTM_CHUNK = chunk
        log(f"  [moe-train] (c) {cfg.name} the mLSTM loop whole "
            f"(MLSTM_CHUNK = S {s}): one step {whole_s * 1e3:.1f} ms, loss "
            f"{loss}, peak device memory "
            f"{memory_gib(dev, peak=True):.2f} GiB against {peak:.2f} GiB "
            f"in chunks of {chunk}")
    del model, opt, step
    release(dev)


def drive_moe_rec_train(dev, rng, seed: int) -> tuple:
    """Phase 16: (a) the attention gradient at MLA's pairs, card against
    CPU; (b) 3 float32 train steps of each arch, card against CPU; then
    the main path, the launch counts set to 0 before it and read after
    it: (c) the full-width steps (``FULL_TRAIN_RUNS``), (d)
    ``launch.train.train`` of DeepSeek-V3 at --preset 100m failed and
    resumed bitwise.  Returns the counts and (a)'s largest error."""
    import repro_torch.configs as C
    from repro_torch.kernels import launch_counts, reset_launch_counts
    ds = C.get("deepseek_v3_671b")
    experts = 3 * (ds.moe.num_experts + ds.moe.num_shared) * ds.d_model \
        * ds.moe.d_ff_expert
    log(f"  CUT: deepseek_v3_671b trains only at --preset 100m on one card "
        f"(the experts of one attn_moe layer at full width are "
        f"{experts / 1e9:.1f}e9 parameters, about {12 * experts / 1e9:.0f}"
        f" GB at 12 bytes a parameter); full width waits for four cards")
    for arch, layers, b, s in FULL_TRAIN_RUNS:
        full = C.get(arch)
        cuts = ([f"{layers} of {full.n_layers} layers"] if layers else []) \
            + [f"B {b or 'from the dry-run'} (train_4k: 256)"] \
            + ([f"S {s} (train_4k: 4096)"] if s != 4096 else [])
        log(f"  CUT: {arch} training: {', '.join(cuts)}")
    t0 = time.perf_counter()
    err = max(moe_rec_grads(dev, rng))
    moe_rec_steps(dev, seed)
    log(f"  [moe-train] (a)-(b) {time.perf_counter() - t0:.1f} s")
    reset_launch_counts()
    for arch, layers, b, s in FULL_TRAIN_RUNS:
        t0 = time.perf_counter()
        train_arch_full(dev, seed, arch, layers, b, s)
        log(f"  [moe-train] (c) {arch} {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    restart_check(dev, seed, RESTART_ARCH, "moe-train")
    log(f"  [moe-train] (d) {time.perf_counter() - t0:.1f} s")
    return launch_counts(), err


def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def memory_gib(dev, peak: bool = False) -> float:
    """Device memory allocated now (or at its peak), in GiB; nan off the
    card."""
    import torch
    if dev.type != "cuda":
        return float("nan")
    return (torch.cuda.max_memory_allocated(dev) if peak
            else torch.cuda.memory_allocated(dev)) / 2**30


def release(dev) -> None:
    import torch
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--docs", type=int, default=FULL_DOCS,
                    help="documents in the corpus (the scale; >= 2^18)")
    ap.add_argument("--vertices", type=int, default=FULL_VERTICES,
                    help="vertices of the iterative graphs (the scale; "
                         ">= 2^20)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the data and of phase 5's random weights")
    args = ap.parse_args(argv)

    # cuBLAS's deterministic workspace, for the train steps' deterministic
    # algorithms (phase 10 (d)); read when cuBLAS first runs
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "runs on a CUDA card", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    if args.docs < MIN_DOCS:
        raise SystemExit(f"--docs {args.docs} is below the floor 2^18")
    if args.vertices < MIN_VERTICES:
        raise SystemExit(f"--vertices {args.vertices} is below the floor "
                         f"2^20")
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build, launch_counts

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(args.seed)
    t_all = time.perf_counter()

    log("phase 1: build")
    t1 = time.perf_counter()
    secs = _build.build_all()
    log(f"  built {', '.join(_build.SOURCES)} in {secs:.2f} s "
        f"into {_build.BUILD_DIR}")
    for lib in sorted(_build.BUILD_DIR.glob(f"*-{_build._digest()}.log")):
        log(f"  {lib.name}: " + "; ".join(ptxas_summary(lib.read_text())))
    log(f"  phase 1 {time.perf_counter() - t1:.1f} s")

    log("phase 2: kernels against their plain versions")
    t2 = time.perf_counter()
    check_sort(dev, rng)
    check_segment_sum(dev, rng)
    small = check_small_sizes(dev, rng)
    check_fused(dev, rng)
    check_fused_runs(dev, rng)
    check_segment_minmax(dev, rng)
    check_spmv_ell(dev, rng)
    check_flash_attention(dev, rng)
    timed = time_kernels(dev, rng, args.docs * DOC_LEN, args.vertices)
    torch.cuda.empty_cache()
    timed["flash_attention"] = time_flash_attention(dev)
    for name, t in timed.items():
        lib = "n/a" if t["library_ms"] is None \
            else f"{t['library_ms']:.3f} ms"
        log(f"  {name} [{t['shape']}]: kernel {t['ms']:.3f} ms, plain "
            f"{t['plain_ms']:.3f} ms, library {lib}, "
            f"bound {t['bound_ms']:.3f} ms ({t['bound_by']})")
    t = timed["flash_attention"]
    log(f"  flash_attention local layer (window 4096): kernel "
        f"{t['ms_local']:.3f} ms, plain {t['plain_ms_local']:.3f} ms, bound "
        f"{t['bound_ms_local']:.3f} ms; softcap 0: kernel "
        f"{t['ms_softcap0']:.3f} ms, scaled_dot_product_attention "
        f"{t['library_ms']:.3f} ms, bound {t['bound_ms_softcap0']:.3f} ms"
        f"; hd 128 (Qwen3-1.7B heads, softcap 0): kernel "
        f"{t['ms_hd128']:.3f} ms, plain {t['plain_ms_hd128']:.3f} ms, "
        f"scaled_dot_product_attention "
        f"{t['library_ms_hd128']:.3f} ms, bound {t['bound_ms_hd128']:.3f} ms"
        f"; hd 80 (HuBERT X-Large's layer, not causal, wgmma, 16-column "
        f"boxes): kernel "
        f"{t['ms_hd80']:.3f} ms, plain {t['plain_ms_hd80']:.3f} ms, SDPA "
        f"{t['library_ms_hd80']:.3f} ms, bound {t['bound_ms_hd80']:.3f} ms"
        f"; hd 160 (StableLM 12B's, causal, wgmma, 32-column boxes): kernel "
        f"{t['ms_hd160']:.3f} ms, plain {t['plain_ms_hd160']:.3f} ms, SDPA "
        f"{t['library_ms_hd160']:.3f} ms, bound {t['bound_ms_hd160']:.3f} ms"
        f"; TFLOP/s {', '.join(f'{n} {v:.1f}' for n, v in t['tflops'].items())}"
        f"; hd 256 MQA (RecurrentGemma 2B's attn_local, H 10, KH 1, window "
        f"2048, q std 1 and 20: at most "
        f"{t['share_of_bound_recurrentgemma']:.3g} of the bound, without "
        f"the window {t['moved_without_window_recurrentgemma']:.3g} move "
        f"past it): kernel {t['ms_hd256_recurrentgemma']:.3f} ms, plain "
        f"{t['plain_ms_hd256_recurrentgemma']:.3f} ms, SDPA (mask) "
        f"{t['library_ms_hd256_recurrentgemma']:.3f} ms, bound "
        f"{t['bound_ms_hd256_recurrentgemma']:.3f} ms"
        + "".join(
            f"; {label} (q std 1 and 20: at most "
            f"{t['share_of_bound_' + key]:.3g} of the bound): kernel "
            f"{t['ms_' + key]:.3f} ms, plain {t['plain_ms_' + key]:.3f} ms, "
            + (f"SDPA {t['library_ms_' + key]:.3f} ms"
               if t['library_ms_' + key] is not None
               else t['library_' + key])
            + f", bound {t['bound_ms_' + key]:.3f} ms"
            for key, label in (
                ("mla", "MLA q.k 192 / v 128 (DeepSeek-V3's layer, H = KH "
                        "128, S 4096)"),
                ("llama4", "hd 128, H 40, KH 8 (Llama 4 Scout's layer, S "
                           "8192)"),
                ("mla100m", "MLA q.k 96 / v 64 (DeepSeek-V3 --preset "
                            "100m's layer, B 8, H = KH 12, S 1024; bound "
                            f"by {t['bound_by_mla100m']})")))
        + f"; q std {FLASH_Q_SCALES[-1]:g}: at most {t['share_of_bound']:.3g} "
        f"of the bound; without the window {t['moved_without_window']:.3g}, "
        f"without the softcap {t['moved_without_softcap']:.3g} of the "
        f"outputs move past it")
    sums, fused = check_iterative_shapes(dev, rng, args.vertices)
    timed["segment_sum"].update(sums)
    timed["fused_shuffle_reduce"].update(fused)
    timed["fused_shuffle_reduce"]["one_block_shapes"] = time_one_block(
        dev, rng, args.vertices)
    torch.cuda.empty_cache()
    log(f"  phase 2 {time.perf_counter() - t2:.1f} s")

    # phase 14 (a), on meta, in the background from here on; stopped at
    # exit whatever the outcome
    dry = DryrunAll().start()
    atexit.register(dry.kill)

    log("phase 3: main path (wordcount, one-step incremental)")
    t3 = time.perf_counter()
    if args.docs != FULL_DOCS:
        log(f"  CUT: {args.docs} documents instead of {FULL_DOCS}")
    log(f"  vocab {VOCAB}, {DOC_LEN} words a document, {args.docs} "
        f"documents, {args.docs * DOC_LEN} intermediate edges")
    docs = rng.integers(0, VOCAB, (args.docs, DOC_LEN)).astype(np.int32)
    steps = make_deltas(rng, docs)
    mrbg_results, mrbg_s = [], []   # phase 9 (a) holds its runs to them
    mrbg = drive_path("mrbg", docs, steps, mrbg_results, mrbg_s)
    acc_results = []                 # phase 8 (a) holds its query to them
    acc = drive_path("auto", docs, steps, acc_results)
    for name in ("sort_lex", "segment_sum", "fused_shuffle_reduce"):
        if mrbg[name] == 0:
            raise AssertionError(f"mrbg path launched no {name}")
    if acc["segment_sum"] == 0:
        raise AssertionError("accumulator path launched no segment_sum")
    log(f"  phase 3 {time.perf_counter() - t3:.1f} s")

    log("phase 4: iterative path (PageRank, SSSP: run, then incremental "
        "iterative update)")
    t4 = time.perf_counter()
    if args.vertices != FULL_VERTICES:
        log(f"  CUT: {args.vertices} vertices instead of {FULL_VERTICES}")
    pr_single, sssp_kept = {}, {}    # phase 9 replays and compares
    pr_vertices = min(args.vertices, PR_VERTICES)
    if pr_vertices != args.vertices:
        log(f"  CUT: PageRank on {pr_vertices} vertices instead of "
            f"{args.vertices} (PR_VERTICES)")
    pr = drive_pagerank(dev, rng, pr_vertices, pr_single)
    log(f"  phase 4 PageRank {time.perf_counter() - t4:.1f} s")
    sp = drive_sssp(dev, rng, args.vertices, sssp_kept, defer=True)
    log(f"  phase 4 {time.perf_counter() - t4:.1f} s (SSSP's Dijkstra "
        f"oracles run on, beside phase 5, and are checked after it)")

    log("phase 5: LM serving (Gemma 2 9B at full width: prefill, decode, "
        "decode-versus-prefill parity)")
    t5 = time.perf_counter()
    lmc = drive_lm(dev, args.seed)
    log(f"  phase 5 {time.perf_counter() - t5:.1f} s")
    t = time.perf_counter()
    sssp_oracle_check(sssp_kept)
    log(f"  phase 4's SSSP checks, after phase 5: waited "
        f"{time.perf_counter() - t:.1f} s")

    log("phase 6: streaming (StreamSession on phase 3's corpus and a "
        "PageRank stream)")
    t6 = time.perf_counter()
    st, stream_parts = drive_stream(dev, rng, docs, args.seed, args.vertices)
    log(f"  phase 6 {time.perf_counter() - t6:.1f} s; launches {st}")

    log("phase 7: the serving tier (ServeTier: 1,000 small tenants, 64 "
        "wide ones, a budget, overload; MultiSessionServer)")
    t7 = time.perf_counter()
    root = ROOT / "build" / f"serve-{os.getpid()}"
    try:
        sv = drive_serve(dev, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"  phase 7 {time.perf_counter() - t7:.1f} s; launches {sv}")

    log("phase 8: delta queries (dql: wordcount, join, windowed, min/max)")
    t8 = time.perf_counter()
    dq = drive_dql(dev, rng, docs, steps, acc_results)
    log(f"  phase 8 {time.perf_counter() - t8:.1f} s; launches {dq}")

    log(f"phase 9: distributed execution ({MESH_SHARDS} logical shards of "
        f"one card: wordcount, SSSP, PageRank; a (pod, data) mesh; warm and "
        f"MRBG-off refresh)")
    t9 = time.perf_counter()
    ds = drive_distributed(dev, rng, docs, steps, mrbg_results, mrbg_s,
                           sssp_kept, pr_single)
    log(f"  phase 9 {time.perf_counter() - t9:.1f} s; launches {ds}")

    log("phase 10: LM training (attention gradient and train steps against "
        "the CPU; Qwen3-1.7B at full width; restart at --preset 100m)")
    t10 = time.perf_counter()
    tr, grad_err, train_flash = drive_train(dev, rng, args.seed)
    log(f"  phase 10 {time.perf_counter() - t10:.1f} s; launches {tr}")

    log("phase 11: the other attention-only archs at full width (Mistral "
        "NeMo 12B, StableLM 12B, Chameleon 34B: prefill, decode, parity; "
        "HuBERT X-Large: forward, mask, train steps, gradient)")
    t11 = time.perf_counter()
    ar, hubert_grad = drive_archs(dev, args.seed)
    log(f"  phase 11 {time.perf_counter() - t11:.1f} s; launches {ar}")
    if ar["flash_attention"] == 0:
        raise AssertionError("phase 11 launched no flash_attention")

    log("phase 12: the recurrent archs at full width (RecurrentGemma 2B, "
        "xLSTM 125M: prefill, decode, launches a call, parity in bf16 and "
        "float32)")
    t12 = time.perf_counter()
    rc = drive_recurrent(dev, args.seed)
    log(f"  phase 12 {time.perf_counter() - t12:.1f} s; launches {rc}")
    if rc["flash_attention"] == 0:
        raise AssertionError("phase 12 launched no flash_attention")

    log("phase 13: the MoE archs at full width (Llama 4 Scout at 12 layers, "
        "DeepSeek-V3 at 5: prefill, decode, launches a call, dropped "
        "slots, parity in bf16 with its routing flips and in float32)")
    t13 = time.perf_counter()
    mo = drive_moe(dev, args.seed)
    log(f"  phase 13 {time.perf_counter() - t13:.1f} s; launches {mo}")
    if mo["flash_attention"] == 0:
        raise AssertionError("phase 13 launched no flash_attention")

    log("phase 14: the dry-run on meta (31 cells against one H100's "
        "constants), checked on the card (Qwen3-1.7B's train step, Gemma 2 "
        "9B's prefill and decode step)")
    t14 = time.perf_counter()
    dr = drive_dryrun(dev, args.seed, dry)
    log(f"  phase 14 {time.perf_counter() - t14:.1f} s; launches {dr}")
    if dr["flash_attention"] == 0:
        raise AssertionError("phase 14 launched no flash_attention")

    log(f"phase 15: one process a rank (RankMesh): 1 rank on nccl; "
        f"{RANK_SHARDS} ranks sharing the card on gloo (wordcount, SSSP, "
        f"PageRank against LocalMesh; Llama 4 Scout's MoE layer, a2a "
        f"against gather; compressed_psum; Gemma 2 9B, then DeepSeek-V3, "
        f"Llama 4 Scout, RecurrentGemma 2B and xLSTM 125M tensor-parallel, "
        f"{TP_MESH}, against their replicated runs; Qwen3-1.7B trained over "
        f"{TRAIN_TP_MESH} against its replicated run)")
    t15 = time.perf_counter()
    rk = drive_ranks(dev, rng, docs, steps, mrbg_results, sssp_kept,
                     args.seed)
    log(f"  phase 15 {time.perf_counter() - t15:.1f} s; launches {rk}")

    log("phase 16: training the MoE and recurrent archs (the attention "
        "gradient at MLA's pairs and train steps against the CPU; Llama 4 "
        "Scout at 1 layer, RecurrentGemma 2B, xLSTM 125M at full width; "
        "DeepSeek-V3 --preset 100m failed and resumed)")
    t16 = time.perf_counter()
    mt, moe_grad = drive_moe_rec_train(dev, rng, args.seed)
    log(f"  phase 16 {time.perf_counter() - t16:.1f} s; launches {mt}")
    if mt["flash_attention"] == 0:
        raise AssertionError("phase 16 launched no flash_attention")
    paths = (mrbg, acc, pr, sp, lmc, st, sv, dq, ds, tr, ar, rc, mo, dr, rk,
             mt)

    sources = {
        "sort_lex": ("src/repro_torch/kernels/csrc/sort.cu",
                     "src/repro/kernels/sort_u32.py:250"),
        "segment_sum": ("src/repro_torch/kernels/csrc/segment_sum.cu",
                        "src/repro/kernels/segment_reduce.py:211"),
        "fused_shuffle_reduce": ("src/repro_torch/kernels/csrc/fused.cu",
                                 "src/repro/kernels/fused.py:149"),
        "segment_minmax": ("src/repro_torch/kernels/csrc/segment_minmax.cu",
                           "src/repro/kernels/segment_reduce.py:255"),
        "spmv_ell": ("src/repro_torch/kernels/csrc/spmv_ell.cu",
                     "src/repro/kernels/spmv_ell.py:51"),
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:82"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        t = timed[name]
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(p.get(name, 0) for p in paths),
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]}
        if name in ("sort_lex", "segment_sum"):
            key = "sort" if name == "sort_lex" else "sum"
            for part in ("", "plain_", "library_", "bound_"):
                entry[f"{part}ms_coalescer"] = {
                    n: small[n][f"{key}_{part}ms"] for n in small}
            entry["note_coalescer"] = (
                "*ms_coalescer: by N at the stream coalescer's sizes (phase "
                "2: sort by (record id, row), library torch.sort stable on "
                "the packed key; int32 sum of the signs with counts, library "
                "index_add_ + bincount on the rows in range)")
        if name == "segment_sum":
            entry.update({n: t[n] for n in (
                "shape", "ms_pagerank", "plain_ms_pagerank",
                "library_ms_pagerank", "bound_ms_pagerank", "ms_sssp_counts",
                "plain_ms_sssp_counts", "library_ms_sssp_counts",
                "bound_ms_sssp_counts")})
            entry["note"] = (
                "ms, plain_ms, library_ms, bound_ms: wordcount's Reduce; "
                "*_pagerank: PageRank's Reduce (N 2^26, K 2^22, half the "
                "rows dropped, counts on; library: index_add_ + bincount on "
                "the rows in range); *_sssp_counts: SSSP's counts (int32 "
                "ones, counts off; library: bincount of the ids in range)")
        if name == "fused_shuffle_reduce":
            entry.update({n: t[n] for n in (
                "shape", "composed_ms", "ms_pagerank", "plain_ms_pagerank",
                "composed_ms_pagerank", "bound_ms_pagerank", "ms_one_block",
                "plain_ms_one_block", "composed_ms_one_block",
                "bound_ms_one_block", "one_block_shapes")})
            entry["note"] = (
                "ms, plain_ms, bound_ms: wordcount's update (a) merge; "
                "*_pagerank: PageRank's refresh merge (N 2^16, key_cap "
                "4096); *_one_block: the one-block path at PageRank's "
                "refresh (N 4096, key_cap 256); composed_ms*: the port's "
                "composed path (shuffle_reduce(fused=False)) on the same "
                "rows, the yardstick, since no one PyTorch call computes "
                "the function (library_ms null); one_block_shapes: "
                "ONE_BLOCK_SHAPES on each route (events ms, device ms and "
                "kernels a call over 20 profiled calls), route: the one "
                "SMALL_MAX_ROWS takes")
        if name == "segment_minmax":
            entry.update({n: t[n] for n in (
                "shape", "ms_refresh", "plain_ms_refresh",
                "library_ms_refresh", "library_device_ms_refresh",
                "bound_ms_refresh")})
            entry["note"] = (
                "ms, plain_ms, library_ms, bound_ms: SSSP's run (K 2^22, "
                "one pass); *_refresh: SSSP's refresh at N 2^17, K "
                "16384, ids ascending; library: "
                "scatter_reduce_(amin) on the rows in range (CUDA events; "
                "library_device_ms_refresh: its device busy time in one "
                "call under torch.profiler)")
        if name == "spmv_ell":
            entry["note"] = ("no engine path calls it (nor the JAX "
                             "package's); held against its plain version "
                             "at PageRank's shapes")
        if name == "flash_attention":
            entry["grad_rel_err_train"] = grad_err
            entry["grad_rel_err_mla"] = moe_grad
            entry["grad_rel_err_hubert"] = hubert_grad
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       train_flash["max_abs_err"])
            entry["max_abs_err_train"] = train_flash["max_abs_err"]
            entry["share_of_bound_train"] = train_flash["share_of_bound"]
            entry.update({n: t[n] for n in (
                "shape", "share_of_bound", "moved_without_window",
                "moved_without_softcap", "ms_local", "plain_ms_local",
                "bound_ms_local", "ms_softcap0", "bound_ms_softcap0",
                "ms_hd128", "plain_ms_hd128", "library_ms_hd128",
                "bound_ms_hd128", "ms_hd80",
                "plain_ms_hd80", "library_ms_hd80", "bound_ms_hd80",
                "ms_hd160", "plain_ms_hd160", "library_ms_hd160",
                "bound_ms_hd160", "tflops", "note",
                "share_of_bound_recurrentgemma",
                "moved_without_window_recurrentgemma",
                "share_of_bound_mla", "share_of_bound_llama4", "library_mla",
                "library_llama4", "share_of_bound_mla100m",
                "library_mla100m")})
            entry.update({f"{key}_{label}": t[f"{key}_{label}"]
                          for label in ("hd128_mistral", "hd128_chameleon",
                                        "hd256_recurrentgemma", "mla",
                                        "llama4", "mla100m")
                          for key in ("ms", "plain_ms", "library_ms",
                                      "bound_ms")})
            entry["note"] += (
                "; *_train: phase 10 (c), the train step's own shape (B 2, "
                "S 4096, H 16/8, hd 128, bf16, causal) through "
                "blocks.attend, q std 1 and 20; max_abs_err: the largest of "
                "phase 2's and these; grad_rel_err_hubert: phase 11 (d), "
                "HuBERT's smoke config at hd 80, every gradient card vs "
                "CPU over its leaf's max; grad_rel_err_mla: phase 16 (a), "
                "dq, dk, dv at MLA's (96, 64) and (192, 128), card vs CPU "
                "over their max")
        kernels.append(entry)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"  total {time.perf_counter() - t_all:.1f} s; launches mrbg {mrbg}, "
        f"auto {acc}, pagerank {pr}, sssp {sp}, lm {lmc}, stream {st}, "
        f"serve {sv}, dql {dq}, distributed {ds}, train {tr}, archs {ar}, "
        f"recurrent {rc}, moe {mo}, dryrun {dr}, ranks {rk}, moe/rec "
        f"train {mt}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100 (sm_90).

    python3 chip_smoke.py [--profile]
    python3 chip_smoke.py --ssd-bwd-phases   # phase 1, then only where an SSD
                                             # backward block's time goes
    python3 chip_smoke.py --adam-slices      # phase 1, then only Adam's update
                                             # at each slice size, in phase H's
                                             # and phase U's steps
    python3 chip_smoke.py --moe-only         # phases 1 and 2, then only
                                             # phase M
    python3 chip_smoke.py --serve-only       # phases 1 and 2, then only
                                             # phase S
    python3 chip_smoke.py --multi-serve-only # phases 1 and 2, then only
                                             # phase V

Drives the port (``src/repro_torch``) only; imports nothing of JAX or of
the JAX package.  Phases, in order; any failure raises and the script exits
non-zero (no phase catches another's exception):

1. Device and build: a CUDA card of compute capability 9.0, its name and
   power limit (nvidia-smi), and the build of the hand-written kernels from
   the checkout's CUDA sources.
2. Each kernel against its plain PyTorch version on the card, at the
   main paths' shapes and at the edges of the kernels' tiles: flash
   attention (hd 128 for granite, hd 80 for zamba2; every head dim with Sq
   off the 128-row query block, Sk shorter than one K/V tile, Sq = 1,
   causal with Sq > Sk, non-causal with a ragged last K/V tile), RMSNorm
   (d 4096 and 2560 at the prefill and decode shapes and one row, d 5120
   at zamba2's decode gated norm, the
   generic kernel's widths 8192, 1001 and 1000, mixed x/scale types, rows
   not 16-byte aligned), the SSD scan, y and the final state (zamba2's
   serving shape in bf16, a smaller f32 shape, S < chunk, a chunk no
   64-row tile divides in f32 and bf16; in bf16 also G = 2 groups, S =
   chunk, a 16-link chain of states (S 4096 at chunk 256), chunk 512, a
   chunk no 16-row tile divides, P = N = 48, and two calls at the serving
   shape that must agree bit for bit).  Then the backward kernels: flash
   attention's dq/dk/dv, per element and in relative error per 128-row
   tile (granite's training shape, with a second call that must agree bit
   for bit and a planted late-tile fault the rule must reject; every head
   dim with Sq off the query tile, Sk shorter than one key tile, H = KV,
   causal with Sq > Sk, non-causal with a ragged last tile; B 2, S 1024,
   whose second call must agree bit for bit too; then the training shape
   again, right after that other shape, against its plain version) and
   RMSNorm's dx/dscale (4096 x 4096 and d 2560 bf16, f32 d 4096 and 2560,
   mixed x/scale types and 3 rows, all on the ring route; the generic
   widths 1001 and 8192; at the training shape a second call, made right
   after another shape, must agree with its plain version and bit for bit
   with the first, and a planted fault, a dscale that leaves out one
   block's band of rows, must fail the dscale check).  Phase 1 logs the
   backward kernels' registers and spills per instance from ptxas.
3. Full-width granite-3-8b (all 40 layers, bf16, random weights from a
   seed): prefill logits with the kernels against the same model with the
   plain versions; ``generate(gen=32)`` with the launch counters checked
   exactly; and the reduced config against the CPU plain path.
4. Granite timings with CUDA events: kernel, plain version, one library
   call as a yardstick, data-sheet bound.  Kernel and library are timed
   three ways: as a caller meets one call (host and device, ``ms``), the
   device work alone (each call enqueued behind a spin kernel,
   ``device_ms``), and the device work after 256 MB of scratch writes
   empty the L2 (``cold_ms``, held against the bound).  Then the serve
   loop's prefill / decode times, tokens per second and peak memory.  Then
   granite's weights are freed and the peak-memory statistics reset.
T. Training granite-3-8b at its published widths, its depth cut from 40 to
   8 layers (f32 master, mu and nu of all 40 would not fit one card), with
   a plan of ckpt 6 (3 of them offloading their inputs), WO = OO = 0.5,
   grad_accum 2, seq 4096: ``adam_update`` with WO = OO = 0.5 against 0 on
   the reduced config (bitwise); the launcher (``launch.train.main
   --layers 8 --plan-json``, two steps, the four launch counts checked
   exactly); at Adam lr 1e-6 (T_LR), one micro-batch's loss and every
   gradient with the kernels and with the plain versions, held to the
   plain versions in f32; one step with the plain versions and one with
   the kernels from the same state and batch (loss and grad norm agree);
   five steps with the kernels on one batch (the loss falls over the
   first three and overall), each with the four launch counts checked
   exactly; the reduced config's loss and gradients on the card against
   the CPU; the step's time, tokens/s, model FLOP/s, peak memory and
   pinned host bytes; the backward kernels' times at the training shapes.
   Then its state is freed.
L. The training loop (``training/loop.py``) and its checkpointer on the
   main path's train step: granite-3-8b at its published widths, depth
   cut to 2 layers (599.8 M params, a checkpoint of ~8.4 GB), seq 4096,
   micro-batch 1, G 2, CKPT 1 of 2 with AO 0.5, WO = OO = 0.5, Adam at
   T_LR, checkpoints under ``build/phase_l`` (keep 2, removed at the end;
   the phase fails if the disk has less than three checkpoints' worth
   free).  (a) 7 steps with a checkpoint every 3; (b) the same with a
   fault at step 5 (one restart from the step-3 checkpoint); (c) with
   ``embed/w`` poisoned with NaN before step 4 (one rollback to the
   snapshot taken before step 3); (d) ``TrainLoop.resume`` of (a)'s step-6
   checkpoint into a fresh state, then one step -- every loss, and every
   leaf of the final state, bit for bit (a)'s; (e) one step on a
   ``PackedCorpus`` batch (a finite loss).  Launch counts exact per
   executed step, replays and the poisoned step included; the final
   states compared on the card.  Printed: bytes per checkpoint, each of
   (a)'s saves (the blocking snapshot, the background write in s and
   GB/s), the restore in place of (d), (a)'s steps with a write in flight
   against those without, the rollback snapshots.  With two or more cards, the reduced
   config saved at dp 2 ZeRO 1 through NCCL and restored at tp 2 with SP
   (four: also S 2 x dp 2 -> dp 4 ZeRO 2), one step each, the loss within
   1e-2 of one card's; with one, ``multi_card: not run (1 visible)``.
   Then the launcher's first step taken apart in a fresh process at phase
   T's plan, its depth cut to phase L's 2 layers: CUDA context, state init
   with its pinned host parts, a pinned allocation of those bytes, the
   rollback snapshot, the kernel
   library's load, cuBLAS's first GEMM, the import of ``torch._dynamo``
   (which ``torch.utils.checkpoint``'s first call makes), and four steps
   (the last after ``empty_cache``).
U. Tune then execute: the tuner's H100 spec beside the card's memory; the
   stage cost model's memory and time tapes of granite-3-8b on numpy and
   as float64 torch ops on the card, 2^10 to 2^20 rows (every output
   bitwise equal; rows per second of both and the crossover), and a tape
   of the ops those lack (sqrt, max/min on signed zeros); the port's tuner
   for granite-3-8b cut to 8 layers, seq 4096, global batch 2, one H100,
   with the numpy and the torch tape backend (the same plan, tape runs on
   the card), at 40 layers (infeasible), and for 8 devices with two
   forked workers after CUDA is up (the serial plan); the tuned plan,
   with the flash-attention kernel in place of its ``naive`` attention,
   through the launcher for 3 steps (exact launch counts, a finite loss;
   predicted against measured step time and peak memory); ``serve
   --tune`` for full-width granite (dp = tp = 1, phase 3's launch counts).
C. Calibration: ``launch.train.main --calibrate`` for granite-3-8b at the
   training widths (8 layers, seq 4096) measures the two one-card cells
   with flash attention, ``dp1_z0`` (micro-batch 1, G 2, no recompute)
   and ``dp1_z2_ckpt`` (recompute on all 8 layers), each for C_WARMUP + C_STEPS
   steps with exact launch counts per cell (16 / 16 / 34 / 34 and 32 / 16
   / 66 / 34 a step); no cell may be skipped and the fitted error may not
   exceed the uncalibrated one.  The written cuda profile must
   round-trip; the tuner re-tunes granite for one H100 with it, and its
   plan runs through the launcher for 3 steps (exact counts, a finite
   loss), its measured step beside ``estimate_plan`` with and without
   the profile, its predicted memory equal to its lowered report's (and
   the allocator's peak beside both).
K. The tuner's kernel dimension (the Hopper tile menu, ``kernels/tiles.py``):
   (a, b) each menu entry -- flash forward and backward at K/V tiles of 64
   and 128 keys at granite's and zamba2's training shapes and the tp-8
   stage rank's (B 2, H 4, KV 1), RMSNorm at its 8 rows a block at d
   4096 and 2560, the SSD forward and backward at chunks 64, 128 and 256 at
   zamba2's -- against its plain version, one launch a call at its tile,
   timed three ways beside its bound and the library call; ``bench_config``
   over the legal grids; (c) ``calibrate_kernels`` on the card, finite
   positive scales; (d) granite at T_LAYERS tuned for one H100 with
   ``kernel_tune=True``, and a tuple other than the default (the sweep's
   choice, or where it keeps the default, the grid's best other tuple):
   ``verify_config`` on the card, TUNED_STEPS steps through the launcher with exact launch
   counts, its predicted kernel delta beside the measured step and phase
   U's; (e) the default tuple and the tuple naming its Hopper tiles give
   the same launches and bitwise the same step.
D. Multi-device plans.  D1: phase U's tuned plan, its depth cut from 8
   to 2 layers, through the launcher on one device and with ``--nproc 1``
   (a spawned rank of a world of one, NCCL, every collective running on
   groups of one): the three losses and
   every param after three steps bit for bit, exact launch counts per
   step.  D2: granite-3-8b at full depth and width tuned by the launcher
   for four H100s (``--tune --devices 4``, seq 4096, global batch 8) and
   trained as rank 0 of 4 in a child process under torch's ``fake``
   process group (its collectives move nothing -- its gathers are filled
   with the rank's own data, so the loss is finite -- and the loss is not
   checked): exact launch counts per step, this rank's allocator peak
   beside the plan's predicted bytes per device (at most 1.02x), split by
   term (the
   state's own bytes, and the allocator's bytes at the boundaries of each
   micro-batch's forward and backward and around the update), and the
   step time of one rank's compute without communication.  With two or
   more cards visible, the reduced config at dp 2 ZeRO 3 and at tp 2 with
   sequence parallelism through NCCL, its losses within 1e-2 of one
   card's, and with four or more the reduced config's pipelines (S 2 x dp
   2 at ZeRO 1, S 4) through NCCL against one card and D2's plan on four
   cards through NCCL (launch counts, finite losses, the step time with
   communication); with one, it prints ``multi_card: not run (1
   visible)``.  Phase 2 holds the flash kernels at the tp-4 rank's shape
   (B 4, S 4096, H 8, KV 2, hd 128) against their plain versions, and
   phase 4's timings add that shape.
P. Pipelined plans: granite-3-8b at full depth and width tuned for 16
   H100s (seq 4096, global batch 32); the tuner picks one stage there, so
   the ``uniform`` space at S = 2 gives the plan (20 + 20 layers, tp 8
   with SP, micro-batch 2, G 16), and both plans are printed.  Each
   stage's depth is then cut to 4 layers (the stage's plan otherwise as
   tuned), and the first stage's rank 0 and the last stage's first rank,
   each through the launcher (``--plan-json``) in a child process under
   the ``fake`` group (sends, receives and collectives move nothing):
   exact launch counts per step (that stage's layers, the final norm on the last), the allocator's
   peak beside the stage's predicted bytes, one rank's compute per step.
   Phase 2 holds the flash kernels at the stage rank's shape (B 2, S 4096,
   H 4, KV 1, hd 128), and the kernels line adds that shape.
5. Phases 3 and 4 for full-width zamba2-2.7b (all 54 Mamba2 layers in 9
   groups, one shared attention block, bf16): logits kernels vs plain
   (both held against the plain versions in f32, see ACCURACY_ROOM),
   ``generate(gen=32)`` with exactly 9 flash, 4010 RMSNorm and 54 SSD
   launches, the reduced config card vs CPU, and the timings (SSD, flash
   at hd 80, RMSNorm at d 2560, the serve loop).
H. Hybrid training.  (a) The SSD backward kernel against ``ssd_bwd_plain``
   on the card (SSD_BWD_TOL) at zamba2's training shape (B 1, S 4096, H
   80, P = N = 64, G 1, chunk 256, bf16, through the SSD autograd
   Function), with a second call bit for bit, and at S < chunk, S =
   chunk, ragged 16-row blocks (chunks 40 and 96), G = 2, f32, and dt and a
   x 50 (finite), all on the tensor-core kernel but the f32 case; and at
   the heads of a rank of a tp-4 and a tp-8 plan (B 2, S 4096, H 20 and
   10: clusters of 4 and 2 heads), each with a second call bit for bit.
   (b) The reduced zamba2 (CKPT over one of its two groups, AO over that
   group, WO = OO = 0.5, SSD chunk 16): loss and every gradient on the
   card against the CPU under the CPU tests' rule, and one train step's
   loss and grad norm.  (c) Full-width zamba2-2.7b, all 54 layers, on one
   card: micro-batch 1 x 4096, G 2, CKPT 54 (9 groups), AO 6 (1 group),
   WO = OO = 0, Adam at T_LR, H_STEPS steps on one batch; the loss finite
   and falling, the six launch counts exact per step (``_hybrid_launches``:
   145 / 73 RMSNorm, 18 / 9 flash and 108 / 54 SSD per micro-batch); the
   step time and the allocator's peak of these steps, run with no hooks,
   the peak held within H_PEAK_BOUND of the memory report's; then one
   more step with ``_MEMORY_SPLIT``'s hooks in this process, only to split
   the peak by term.  (d) Timings: the SSD backward at the training shape
   (call, device and cold-L2 times, its bound; no library call computes
   it; its kernels' ptxas registers and spills, shared memory, clusters
   resident, f32 parts of dB / dC, device time by kernel), the flash backward at hd 80 beside SDPA's backward, the RMSNorm
   backward at 4096 x 2560 beside ``F.rms_norm``'s.
Z. A rank of a multi-device zamba2 plan: zamba2-2.7b at full width and
   depth, tp 4 with sequence parallelism, micro-batch 2 x 4096, G 2, CKPT
   54, trained as rank 0 of 4 through the launcher (``--plan-json``) in a
   child process under the ``fake`` group, as D2 runs granite's rank: its
   Mamba mixers run 20 of the 80 SSD heads (the fused ``in_proj``'s
   products gathered over tp, docs/port.md), its shared block 8 of the 32
   attention heads.  Exact launch counts per step (phase H's rule for the
   same G and CKPT), the state term of the rank's peak split equal to the
   memory report's state bytes, the allocator's peak within Z_PEAK_BOUND
   of the memory report's peak, one rank's compute per step.  Phase 2 holds the SSD forward (H 20), flash (H = KV = 8, hd 80)
   and RMSNorm (2048 x 2560) at the rank's shapes against their plain
   versions, phase H (a) the SSD backward, and the kernels line adds the
   SSD forward and backward and flash forward and backward there.  With
   two or more cards, ``_multi_card`` also runs the reduced zamba2 at dp 2
   ZeRO 3 and tp 2 with SP through NCCL against one card.
M. The MoE family, qwen2-moe-a2.7b (24 layers, d 2048, 16 heads of 128 with
   QKV biases, 60 routed experts top-4 of 1408 and 4 shared, 14.316 B
   params).  (a) Served at full width and depth in bf16 through
   ``phase_full_width_serve`` (its kernels under the ACCURACY_ROOM rule
   against the plain versions in f32, the bf16 weights waiting on the host
   while the f32 copy runs; exact counts: 24 flash, 49 RMSNorm a forward),
   then the reduced config on the card against the CPU.  (b) Trained on one
   card at full width, depth cut to 4, through the launcher in this
   process: the written plan (micro-batch 1 x 4096, G 2, CKPT 4, WO = OO =
   0, lr 1e-6), 5 steps, exact counts, a falling loss, step ms, and the
   allocator's peak beside the memory report (split by term, not gated);
   then the tuner's plan for the same 4 layers on one H100, run 2 steps
   through the launcher when the tuner finds one.  (c) Rank 0 of a tp-4 +
   SP plan (expert parallelism: 15 experts a rank), depth cut to 8, under
   the ``fake`` group in a child process: exact counts, the rank's state
   bytes equal to the report's state term, its peak beside the report.
   (d) Flash forward at the serving shape, flash forward and backward at
   the training shape, RMSNorm forward and backward at 4096 x 2048 (phase
   2 holds each, and the tp-4 rank's shapes, against its plain version).
S. The continuous-batching engine (``serving/``) at full width and depth,
   in bf16, weights from seed 0: granite-3-8b (40 layers, 8 requests),
   zamba2-2.7b (54 layers, 6 requests; only the 9 shared-block attention
   caches are paged, the conv and SSM state stay in their slots) and
   qwen2-moe-a2.7b (24 layers, 6 requests), S_SLOTS = 4 slots, max_len
   1056, prompts of 64-1024 tokens and output budgets of 4-32 from numpy
   seed 0, the page size the serve tuner picks for 4 x 1056 over
   page_grid (0, 16) (the plan printed).  Every launch counter set to 0
   just before the engine's run and checked exactly just after: each
   admission's batch-1 prefill launches flash once per attention layer
   (and the hybrid's SSD once per Mamba2 layer), each prefill and decode
   step one RMSNorm per norm of a forward (a hybrid's decode step also one
   per Mamba2 layer's gated norm).  Every request's tokens against
   the batch-1 static decode at max_len 1056, bitwise; where they differ,
   the first differing token's logits at M = 1 and M = 4 decide: if the
   engine's row equals the batch-4 static decode's (the request in its
   slot, zero rows elsewhere) bitwise, and a weight product of the decode
   step gives a row another value at M = 4 than at M = 1 (the GEMMs),
   every request is held to that comparator and both results are printed;
   any other difference fails (``tools/decode_rows_by_m.py`` finds the op).
   ``memory_bytes()`` equal to ``concrete_paged_cache_bytes``, bitwise.
   Granite also runs with ``kv_cache_dtype="int8"``: the same checks, the
   pools' codes int8 and scales f32 after decode, and the int8 static
   decode teacher-forced beside the bf16 one under the reference's rule
   (argmax equal wherever the bf16 top-2 margin exceeds twice the largest
   int8-bf16 logit difference, printed).  Printed per model: the engine's
   wall time and tokens per second, admissions and decode steps, the
   pool's pages and bytes, the gathered view's bytes, the peak, and the
   paged step (split into gather + mask, decode and scatter) against the
   contiguous step at batch 4 and the same max_len, all beside the card's
   name and power limit.
V. Multi-device serving, each rank in a child process joined to torch's
   ``fake`` process group of 4 ranks as rank 0 (its collectives move
   nothing; its gathers are filled with its own data).  (a) qwen2-72b (80
   layers, d 8192, 64 heads of 128 over 8 KV heads, d_ff 29568, vocab
   152064, QKV biases; 72.7 B params, which no one card holds) tuned by the
   serve tuner for 4 H100s at batch 4 x 1056 over pages {0, 16}: the plan
   must be tp 4.  Rank 0 at full width and depth draws its params (a
   quarter of each split weight), runs ``generate(gen=32)`` on 4 prompts of
   1024 with exact counts (80 flash, 5152 RMSNorm), its prefill and each
   decode step timed, then the engine (4 slots, max_len 1056, the plan's
   pages) with exact counts; its param bytes, static cache bytes and pools
   equal the memory report's terms bitwise, its peak at most H_PEAK_BOUND
   x the report's.  Its values are meaningless under ``fake`` and not
   compared.  (b) granite-3-8b's tuned dp-4 plan, rank 0 (one row): a data
   rank decodes with no collective, so its tokens must equal the one-card
   batch-1 decode of its row bitwise.  (c) With four cards: qwen2-72b cut
   to 8 layers at tp 4 through NCCL, teacher-forced logits against one
   card running the same layers whole (within LOGIT_REL_TOL of the largest
   logit), and ``serve --tune --nproc 4`` at full depth, its tokens per
   second; with one card it logs that it was skipped.  Phase 2 holds flash
   at the rank's shape (B 4, S 1024, H 16, KV 2, hd 128) and RMSNorm at d
   8192 against their plain versions; the kernels line adds flash and
   RMSNorm at the prefill's 4096 x 8192 and at the decode's 4 x 8192, each
   with the launches ``generate`` made at its shape.
6. With ``--profile`` only: a ``torch.profiler`` window over one prefill
   and over three decode steps of each model, and over one train step of
   each trained model (granite in phase T, zamba2 in phase H) --
   device busy time, idle share and the kernels that take the most device
   time -- written as one JSON line each (the Chrome traces go to
   ``build/profile/``).
7. The ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line.

Without a CUDA device it exits with code 2 and prints no result.
"""
from __future__ import annotations

import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"

# H100 SXM data sheet (dense, 700 W): bf16 tensor-core rate, f32 rate
# outside the tensor cores, HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# serving path shapes: a batch of 4 prompts of 1024 tokens, 32 generated
BATCH, PROMPT_LEN, GEN = 4, 1024, 32
# granite-3-8b
N_LAYERS, N_HEADS, N_KV, HEAD_DIM, D_MODEL = 40, 32, 8, 128, 4096
# zamba2-2.7b: 54 Mamba2 layers in 9 groups of 6, one shared attention
# block of 32 heads of 80; the SSD runs 80 heads of 64 with state 64 and one
# B/C group over chunks of 256, x/B/C as views of the conv output (rows of
# 80 * 64 + 2 * 64 = 5248)
Z_LAYERS, Z_GROUPS, Z_D_MODEL, Z_HEADS, Z_HEAD_DIM = 54, 9, 2560, 32, 80
SSD_HEADS, SSD_P, SSD_N, SSD_G, SSD_CHUNK = 80, 64, 64, 1, 256

# kernel-vs-plain tolerances (the reference's bf16 / f32 kernel-test
# tolerances; the lse is f32 in both versions)
BF16_TOL = dict(atol=2e-2, rtol=3e-2)
F32_TOL = dict(atol=2e-5, rtol=2e-5)
LSE_TOL = dict(atol=1e-3, rtol=1e-3)
# full-width prefill logits, kernels vs plain versions, both bf16.  The two
# round differently inside attention (the kernel's P goes to bf16 from
# register accumulators summed in another order) and every layer's output
# is rounded to bf16 again; the reference's own bf16 Pallas-vs-naive logits
# differ by ~1.2% of their size after 4 layers.  Allowed here: 5% of the
# largest logit, for the 40-layer stack.
LOGIT_REL_TOL = 5e-2
# reduced config, card (kernels) vs CPU (plain versions), teacher-forced:
# the tolerance the CPU parity tests hold the port to against the reference
REDUCED_LOGIT_ATOL = 3e-2
# zamba2 at random init amplifies bf16 rounding through its residual stream
# (hidden states grow with depth): on an H100 80GB HBM3 (700 W) this script
# measured the plain versions' own bf16 prefill logits at 1.36 (max, mean
# 0.18) from the same model in f32, of a largest logit of 5.1, and the
# reduced config's CPU bf16 logits at 0.50 (mean 0.06) of 4.3.  No fixed
# share of the largest logit separates a fault from that noise, so
# zamba2's kernels are held against the f32 run of the plain versions (the
# exact function of the same weights): their bf16 error may be at most
# ACCURACY_ROOM times the plain versions' bf16 error, in max and in mean.
ACCURACY_ROOM = 1.5
# the SSD scan in f32 (y of f32 inputs, and the f32 final state of any
# input): the reference's own tolerance for its kernel against the
# sequential oracle (tests/test_kernels.py); the in-chunk cumsum and the
# products sum in another order than the plain version
SSD_F32_TOL = dict(atol=2e-4, rtol=2e-4)
# the backward kernels.  flash dq/dk/dv (bf16) against the plain version run
# in f32: the reference's own bf16 tolerance for its blocked backward
# (tests/test_kernels.py:59-62).  RMSNorm's f32 dscale: a sum over the rows
# that the kernel takes in another order (per-block partials, then across
# blocks) than the plain version.
FLASH_BWD_TOL = dict(atol=5e-2, rtol=5e-2)
# ... and, since at S 4096 that per-element rule is as large as most of the
# values it compares (dq of row i spreads as ~1/sqrt(i)), each of dq/dk/dv
# is also held to a relative error: ||got - want|| / ||want|| in every
# (batch, 128-row tile, head), and max |got - want| / max |want|.  The
# plain version run with bf16 inputs (the kernel's roundings: bf16 P, dS
# and outputs) reads 2.4e-3-3.0e-3 on both at S 1024 on the CPU; a tile
# whose dq is 0.8x its value reads 0.2.
FLASH_BWD_REL = 1e-2
FLASH_BWD_TILE = 128
DSCALE_F32_TOL = dict(atol=1e-3, rtol=1e-5)

# training: granite-3-8b at its published widths, depth cut to 8 layers;
# one sequence of 4096 per micro-batch, 2 micro-batches a step
T_LAYERS, T_SEQ, T_MICRO, T_ACCUM, T_CKPT = 8, 4096, 1, 2, 6
T_STEPS = 5
# the learning rate of the training phase.  Adam's first steps move every
# weight by about lr along its gradient's sign, so a layer's output shifts
# by about fan-in x lr: at the reference's lr 3e-4 (no warmup) that is
# several times the output at d_ff 12800, and on this random init the loss
# rose from 11.22 to 18.89 after one step; at 1e-5 it fell once and then
# oscillated with a growing grad norm (runs of this script, H100 80GB HBM3,
# 700 W).  Runs at this width warm the rate up; with no warmup, 1e-6 (about
# 1% of a layer's output per step) keeps the check in the regime where each
# step on the same batch lowers the loss.  The first step's loss and grad
# norm, which the kernels-vs-plain check compares, come before any update.
T_LR = 1e-6
# kernels vs plain versions from the same state and batch, one step: bf16
# runs that round differently inside attention and the norms.  Readings
# (this script, H100 80GB HBM3, 700 W): the step's loss 1.3e-5 and grad norm
# 1.2e-4 relative, micro-batch 0's loss 2.5e-5.  Allowed: 4-8x the
# readings.  Every gradient is also held leaf by leaf (_grads_close).
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL = 1e-4, 1e-3
# the reduced config, card kernels vs CPU plain: the CPU parity tests' bf16
# loss tolerance (tests/test_torch_train.py)
REDUCED_LOSS_RTOL = 1e-2
# steps of the launcher's run (Adam's default lr), which prints its losses
# to 3 decimals: its first is this phase's first within half a unit of the
# last place
LAUNCHER_STEPS, LAUNCHER_LOSS_ATOL = 2, 5e-4 + 1e-6
# tune then execute: the stage cost model's tapes run on numpy and on the
# card at these grid sizes (rows of candidate configurations); the tuned
# plan trains this many steps through the launcher
TAPE_ROWS = tuple(1 << k for k in range(10, 21, 2))
TUNED_STEPS = 3
# phase C: calibration cells of granite-3-8b at the training widths (8
# layers, seq 4096), each run for C_WARMUP discarded and C_STEPS timed
# steps (measure_cells' default warm-up)
C_STEPS, C_WARMUP = 4, 2
# phase D: multi-device plans.  Steps per launcher run; the tp-4 plan's
# rank (granite-3-8b at full depth tuned for four H100s, seq 4096, global
# batch 8): its flash attention sees micro-batch 4, 32 / 4 query heads and
# 8 / 4 kv heads
D_STEPS = 3
# D1 runs phase U's tuned plan with its depth cut from 8 to D1_LAYERS layers
# (the bitwise check does not need the depth; the cut pays for phase Z)
D1_LAYERS = 2
D2_DEVICES, D2_GBS = 4, 8
# D2's allocator peak over its predicted bytes per device, at most (read
# 0.958 on an H100 80GB HBM3 at 700 W, PERF.md)
D2_PEAK_ROOM = 1.02
R_BATCH, R_HEADS, R_KV = 4, N_HEADS // D2_DEVICES, N_KV // D2_DEVICES
# phase P: pipelined plans.  granite-3-8b at full depth and width tuned for
# sixteen H100s (two HGX hosts), seq 4096, global batch 32; a stage's rank
# of the tp-8 plan runs flash attention at micro-batch 2, 32 / 8 query
# heads and 8 / 8 kv heads
P_DEVICES, P_GBS, P_TP = 16, 32, 8
P_BATCH, P_HEADS, P_KV = 2, N_HEADS // P_TP, N_KV // P_TP
# ... each stage's depth cut to P_STAGE_LAYERS when its ranks run (the plan
# is tuned at full depth; the cut pays for phase Z's time)
P_STAGE_LAYERS = 4
# phase H: hybrid training.  zamba2-2.7b at its published widths and full
# depth (2.541 B params: 5.1 GB of bf16 params, 30.5 GB of f32 master, mu
# and nu and 10.2 GB of f32 gradient sums before activations, so the depth
# is not cut), micro-batch 1 x 4096, G 2, CKPT over all 54 layers (9
# groups), AO 6 layers (1 group), WO = OO = 0, Adam at T_LR, H_STEPS steps
# on one batch
H_SEQ, H_MICRO, H_ACCUM, H_CKPT, H_AO_LAYERS, H_STEPS = 4096, 1, 2, 54, 6, 4
# phase Z: a rank of a multi-device zamba2 plan.  zamba2-2.7b at full width
# and depth, tp 4 with SP, micro-batch 2 x 4096, G 2, CKPT 54, rank 0 of 4
# under the fake group: its SSD runs 80 / 4 = 20 heads (clusters of 4 in the
# backward), its flash 32 / 4 = 8 heads, its norms 2 x 4096 / 4 rows
Z_TP, Z_MICRO = 4, 2
ZR_SSD_HEADS, ZR_HEADS = SSD_HEADS // Z_TP, Z_HEADS // Z_TP
# the SSD backward kernel against ssd_bwd_plain on the same inputs (both
# sum in f32, in other orders): per tensor, max |got - want| <= tol * max
# |want|, by the tensor's dtype -- dx, dB and dC are rounded once to bf16
# (2^-8 of a value), ddt and da stay f32 (docs/port.md)
SSD_BWD_TOL = {torch.bfloat16: 1e-2, torch.float32: 2e-4}
# the allocator's peak over the memory report's (the tuner's fit test):
# phase Z's rank is held within Z_PEAK_BOUND and phase H's one-card run
# within H_PEAK_BOUND, as phase D holds D2 within 1.02; the term above the
# bound is named where a peak is over
Z_PEAK_BOUND, H_PEAK_BOUND = 1.05, 1.10
# phase M: qwen2-moe-a2.7b (MHA, 16 heads of 128, d 2048).  (b) one card,
# depth cut to M_T_LAYERS, micro-batch 1 x 4096, G 2, CKPT over every layer,
# M_STEPS steps at T_LR; the tuner's plan for the same depth runs
# M_TUNED_STEPS.  (c) rank 0 of a tp-M_TP plan with SP at M_R_LAYERS layers
M_LAYERS, M_D_MODEL, M_HEADS, M_EXPERTS = 24, 2048, 16, 60
M_T_LAYERS, M_STEPS, M_TUNED_STEPS = 4, 5, 2
M_TP, M_R_LAYERS = 4, 8
# phase S: the continuous-batching engine (serving/) at full width and
# depth: S_SLOTS decode slots over a horizon of S_MAX_LEN rows (the longest
# prompt plus the largest budget), S_REQUESTS requests a model with prompts
# of S_PLENS tokens and output budgets of S_GENS drawn from numpy seed 0,
# pages of the size the serve tuner picks over page_grid (0, S_PAGE); the
# paged and contiguous steps and the paged step's parts timed in turns,
# S_STEP_REPS rounds
S_SLOTS, S_PAGE, S_PLENS, S_GENS = 4, 16, (64, 1024), (4, 32)
S_MAX_LEN = S_PLENS[1] + S_GENS[1]
S_REQUESTS = {"granite-3-8b": 8, "zamba2-2.7b": 6, "qwen2-moe-a2.7b": 6}
S_STEP_REPS = 12
# phase V: multi-device serving.  qwen2-72b (80 layers, d 8192, 64 heads of
# 128 over 8 KV heads, d_ff 29568, vocab 152064 untied, QKV biases; 72.7 B
# params, 145 GB in bf16: no one card holds it) tuned for V_DEVICES H100s at
# BATCH x V_MAX_LEN over page_grid (0, S_PAGE): its tp-4 rank runs 64 / 4
# query heads over 8 / 4 KV heads; granite-3-8b tuned the same way (dp 4)
V_DEVICES, V_MAX_LEN = 4, PROMPT_LEN + GEN
V_D_MODEL, V_HEADS, V_KV, V_TP = 8192, 64, 8, 4
V_R_HEADS, V_R_KV = V_HEADS // V_TP, V_KV // V_TP
# (c), four cards: qwen2-72b cut to V_CUT_LAYERS layers at tp 4 through
# NCCL, V_FORCED teacher-forced decode steps after the prefill, against one
# card running the same layers whole
V_CUT_LAYERS, V_FORCED = 8, 8


def log(msg: str) -> None:
    print(msg, flush=True)


def sync():
    torch.cuda.synchronize()


def close(got, want, atol, rtol):
    """(ok, max_abs_err) of |got - want| <= atol + rtol * |want|, finite."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    ok = bool(((err <= atol + rtol * want.abs()) & torch.isfinite(got)).all())
    return ok, float(err.max())


# bytes written between timed launches when L2 must start cold: past the
# H100's 50 MB L2 several times over
L2_FLUSH_BYTES = 256 * 2**20
_l2_flush = None
# a device-side spin ahead of each timed call (~0.5 ms at the H100's
# clocks), longer than the host takes to enqueue a kernel's call
SPIN_CYCLES = 1_000_000


def time_ms(fn, reps: int = 20, warmup: int = 3, cold: bool = False,
            device_only: bool = False) -> float:
    """Median of per-call CUDA-event times, after a warm-up.

    By default the events bracket one call as its caller meets it on an
    idle device: the host's part (Python, checks, the launch) and the
    device's.  ``device_only`` enqueues each call behind a spin kernel, so
    the events bracket the device work alone.  ``cold`` writes
    L2_FLUSH_BYTES of scratch before each timed call, outside the events,
    so that the call finds none of its inputs in L2."""
    global _l2_flush
    if cold and _l2_flush is None:
        _l2_flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8,
                                device=DEVICE)
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if cold:
            _l2_flush.zero_()
        if device_only:
            torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------


def phase_device_and_build():
    from repro_torch.kernels import _build

    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f"needs an sm_90 card; {torch.cuda.get_device_name(0)}"
                           f" is {cap}")
    log(f"# device: {torch.cuda.get_device_name(0)} cc {cap}, "
        f"{torch.cuda.device_count()} visible; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(smi_line())
    t0 = time.perf_counter()
    _build.load_library()
    log(f"# kernels built and loaded in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.BUILD_SECONDS if _build.BUILD_SECONDS is not None else 'cached'})")
    for line in _build.BUILD_LOG.splitlines():
        if any(w in line for w in ("registers", "spill", "Compiling",
                                   "wgmma", "arning")):
            log(f"#   ptxas: {line.strip()}")
    for kernel in ("flash_bwd_kernel", "rmsnorm_bwd_ring_kernel",
                   "rmsnorm_bwd_kernel"):
        for fn, args, regs, stores, loads in ptxas_report(_build.BUILD_LOG,
                                                          kernel):
            log(f"# ptxas {fn}<{args}>: {regs} registers, {stores} bytes "
                f"spill stores, {loads} bytes spill loads")


# the mangled names of the kernels' template types
_MANGLED_TYPES = (("13__nv_bfloat16", "bf16"), ("f", "f32"))


def template_args(mangled: str) -> str:
    """'13__nv_bfloat16S1_Li8EE...' -> 'bf16, bf16, 8': the template
    arguments that open a mangled kernel name's tail (a substitution
    ``S..._`` repeats the type before it)."""
    out = []
    while mangled and not mangled.startswith("E"):
        m = re.match(r"Li(\d+)E", mangled)
        if m:
            out.append(m.group(1))
            mangled = mangled[m.end():]
            continue
        m = re.match(r"S\d*_", mangled)
        if m and out:
            out.append(out[-1])
            mangled = mangled[m.end():]
            continue
        for code, name in _MANGLED_TYPES:
            if mangled.startswith(code):
                out.append(name)
                mangled = mangled[len(code):]
                break
        else:
            break
    return ", ".join(out)


def ptxas_report(build_log: str, kernel: str):
    """[(kernel, template arguments, registers, spill store bytes, spill
    load bytes)] of each instance of ``kernel`` in nvcc's ``-Xptxas -v``
    output (empty when the library was already built)."""
    out, cur = [], None
    for line in build_log.splitlines():
        m = re.search(rf"Compiling entry function "
                      rf"'\S*?\d{kernel}(?:I(\S+)|E\S*)'", line)
        if m:
            cur = [kernel, template_args(m.group(1) or ""), None, None,
                   None]
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur[3], cur[4] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur[2] = int(m.group(1))
            out.append(tuple(cur))
            cur = None
    return out


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------


def _qkv(b, sq, sk, h, kv, hd, seed):
    g = torch.Generator(DEVICE).manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=g, device=DEVICE,  # noqa: E731
                                dtype=torch.float32).to(torch.bfloat16)
    return mk(b, sq, h, hd), mk(b, sk, kv, hd), mk(b, sk, kv, hd)


def _ssd_inputs(b, s, h, p, n, g, dtype, seed):
    """SSD inputs laid out as the model gives them: x (B,S,H,P) and B/C
    (B,S,G,N) are views of one (B, S, H*P + 2*G*N) buffer, like the conv
    output; dt = softplus(.) f32, a = -exp(.) f32 (a near -1, as at init)."""
    gen = torch.Generator(DEVICE).manual_seed(seed)
    row = h * p + 2 * g * n
    buf = torch.randn((b, s, row), generator=gen, device=DEVICE).to(dtype)
    x = buf[..., :h * p].reshape(b, s, h, p)
    bb = buf[..., h * p:h * p + g * n].reshape(b, s, g, n)
    cc = buf[..., h * p + g * n:].reshape(b, s, g, n)
    dt = F.softplus(torch.randn((b, s, h), generator=gen, device=DEVICE))
    a = -torch.exp(0.5 * torch.randn((h,), generator=gen, device=DEVICE))
    return x, dt, a, bb, cc


def phase_kernels_vs_plain():
    """Returns {kernel@shape: max_abs_err at the path shapes}."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.kernels import ssd_scan as SS

    errs = {}
    cases = [  # (B, Sq, Sk, H, KV, hd, causal)
        (BATCH, PROMPT_LEN, PROMPT_LEN, N_HEADS, N_KV, HEAD_DIM, True),
        (BATCH, PROMPT_LEN, PROMPT_LEN, Z_HEADS, Z_HEADS, Z_HEAD_DIM, True),
        (BATCH, 1000, 1000, N_HEADS, N_KV, HEAD_DIM, True),
        (BATCH, 77, 300, N_HEADS, N_KV, HEAD_DIM, False),
        (2, 130, 70, Z_HEADS, Z_HEADS, Z_HEAD_DIM, True),
        (2, 40, 40, 4, 1, 32, True),      # the reduced configs' heads
        (2, 130, 70, 8, 2, 64, False),
        # every head dim with Sq not a multiple of the 128-row query block
        (2, 200, 200, 8, 2, 32, True),
        (2, 300, 300, 8, 2, 64, True),
        (2, 250, 250, 8, 8, 80, True),
        (2, 330, 330, 8, 2, 128, True),
        # Sk shorter than one K/V tile
        (2, 200, 50, 8, 2, 128, False),
        (2, 40, 30, 8, 8, 80, True),
        # one query row
        (BATCH, 1, 1000, N_HEADS, N_KV, HEAD_DIM, False),
        (BATCH, 1, 1000, Z_HEADS, Z_HEADS, Z_HEAD_DIM, True),
        # causal with Sq > Sk
        (2, 300, 100, 16, 4, 64, True),
        (2, 520, 130, 8, 2, 128, True),
        # non-causal with Sk not a multiple of the K/V tile
        (2, 256, 333, Z_HEADS, Z_HEADS, Z_HEAD_DIM, False),
        (2, 129, 200, 8, 2, 32, False),
        # the prefill of qwen2-72b's tp-4 rank (phase V)
        (BATCH, PROMPT_LEN, PROMPT_LEN, V_R_HEADS, V_R_KV, HEAD_DIM, True),
        # qwen2-moe (phase M): serving, one card's training micro-batch,
        # its tp-4 rank's
        (BATCH, PROMPT_LEN, PROMPT_LEN, M_HEADS, M_HEADS, HEAD_DIM, True),
        (T_MICRO, T_SEQ, T_SEQ, M_HEADS, M_HEADS, HEAD_DIM, True),
        (T_MICRO, T_SEQ, T_SEQ, M_HEADS // M_TP, M_HEADS // M_TP, HEAD_DIM,
         True),
        # a rank of the tp-4 plan (phase D)
        (R_BATCH, T_SEQ, T_SEQ, R_HEADS, R_KV, HEAD_DIM, True),
        # a pipeline stage's rank of the tp-8 plan (phase P)
        (P_BATCH, T_SEQ, T_SEQ, P_HEADS, P_KV, HEAD_DIM, True),
        # a rank of zamba2's tp-4 plan (phase Z)
        (Z_MICRO, H_SEQ, H_SEQ, ZR_HEADS, ZR_HEADS, Z_HEAD_DIM, True),
    ]
    rank_cases = {len(cases) - 7: "qwen2_72b_tp4",
                  len(cases) - 6: "qwen2_moe",
                  len(cases) - 5: "qwen2_moe_train",
                  len(cases) - 4: "qwen2_moe_tp4", len(cases) - 3: "tp4",
                  len(cases) - 2: "tp8", len(cases) - 1: "zamba2_tp4"}
    for i, (b, sq, sk, h, kv, hd, causal) in enumerate(cases):
        q, k, v = _qkv(b, sq, sk, h, kv, hd, seed=10 + i)
        o, lse = FA.flash_attention(q, k, v, causal=causal)
        sync()
        o_ref, lse_ref = FA.flash_attention(q.float(), k.float(), v.float(),
                                            causal=causal, impl="plain")
        sync()
        ok_o, err_o = close(o, o_ref, **BF16_TOL)
        ok_l, err_l = close(lse, lse_ref, **LSE_TOL)
        log(f"# flash B{b} Sq{sq} Sk{sk} H{h} KV{kv} hd{hd} causal={causal}: "
            f"o max err {err_o:.3e}, lse max err {err_l:.3e}")
        if not (ok_o and ok_l):
            raise AssertionError("flash attention kernel disagrees with its "
                                 f"plain version (case {i})")
        if i < 2:
            errs[f"flash_attention_fwd@hd{hd}"] = err_o
        if i in rank_cases:
            errs[f"flash_attention_fwd@{rank_cases[i]}"] = err_o

    rn_cases = [  # (rows, d, x dtype, scale dtype, aligned)
        (BATCH * PROMPT_LEN, D_MODEL, None, None, True),
        (BATCH, D_MODEL, None, None, True),
        (BATCH * PROMPT_LEN, Z_D_MODEL, None, None, True),
        (BATCH, Z_D_MODEL, None, None, True),
        (Z_MICRO * H_SEQ // Z_TP, Z_D_MODEL, None, None, True),  # Z's rank
        (1, D_MODEL, None, None, True),          # one row
        (1, Z_D_MODEL, None, None, True),
        # qwen2-72b (phase V): the generic kernel at its prefill and decode
        (BATCH * PROMPT_LEN, V_D_MODEL, None, None, True),
        (BATCH, V_D_MODEL, None, None, True),
        (33, 8192, None, None, True),            # generic kernel widths
        (5, 1001, None, None, True),
        (3, 1000, None, None, True),
        (300, D_MODEL, torch.float32, torch.bfloat16, True),  # mixed types
        (300, Z_D_MODEL, torch.float32, torch.bfloat16, True),
        (300, D_MODEL, torch.bfloat16, torch.float32, True),
        (7, D_MODEL, None, None, False),         # rows not 16-byte aligned
        # qwen2-moe (phase M): serving, decode, its tp-4 rank's rows, one row
        (BATCH * PROMPT_LEN, M_D_MODEL, None, None, True),
        (BATCH, M_D_MODEL, None, None, True),
        (T_SEQ // M_TP, M_D_MODEL, None, None, True),
        (1, M_D_MODEL, None, None, True),
        # zamba2's decode gated norm over d_inner (phases 5 and S): a decode
        # step of the batch, of the engine's slots, and of one row
        (BATCH, 2 * Z_D_MODEL, None, None, True),
        (1, 2 * Z_D_MODEL, None, None, True),
    ]
    for rows, d, xdt, sdt, aligned in rn_cases:
        for dtype in ((xdt,) if xdt else (torch.bfloat16, torch.float32)):
            tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
            g = torch.Generator(DEVICE).manual_seed(rows + d)
            x = torch.randn((rows, d), generator=g, device=DEVICE).to(dtype)
            if not aligned:  # the same values one element into a buffer
                buf = torch.empty(rows * d + 1, dtype=dtype, device=DEVICE)
                buf[1:] = x.reshape(-1)
                x = buf[1:].view(rows, d)
            scale = (1 + 0.1 * torch.randn((d,), generator=g, device=DEVICE)
                     ).to(sdt or dtype)
            y = RN.rmsnorm(x, scale)
            sync()
            ok, err = close(y, RN.rmsnorm(x, scale, impl="plain"), **tol)
            sync()
            log(f"# rmsnorm rows {rows} d {d} x {dtype} scale {scale.dtype}"
                f"{'' if aligned else ' unaligned'}: max err {err:.3e}")
            if not ok:
                raise AssertionError("rmsnorm kernel disagrees with its "
                                     f"plain version ({rows}x{d} {dtype})")
            if (rows == BATCH * PROMPT_LEN and dtype == torch.bfloat16
                    and xdt is None):
                errs[f"rmsnorm@d{d}"] = err

    bf16 = torch.bfloat16
    ssd_cases = [  # (B, S, H, P, N, G, chunk, dtype)
        (BATCH, PROMPT_LEN, SSD_HEADS, SSD_P, SSD_N, SSD_G, SSD_CHUNK,
         bf16),                                         # zamba2 serving
        (2, 512, 8, 64, 64, 8, 128, torch.float32),     # f32, G = H
        (BATCH, 64, 16, 16, 16, 1, SSD_CHUNK, bf16),    # S < chunk
        (2, 192, 4, 32, 16, 2, 96, torch.float32),      # ragged 64-row tile
        # the bf16 kernel's edges
        (2, 512, 8, 64, 64, 2, 256, bf16),              # G = 2 groups
        (BATCH, 256, SSD_HEADS, 64, 64, 1, 256, bf16),  # S = chunk: one link
        (1, 4096, 8, 64, 64, 1, 256, bf16),             # a 16-link chain
        (2, 192, 4, 32, 16, 2, 96, bf16),               # ragged 64-row tile
        (2, 40, 4, 32, 16, 1, SSD_CHUNK, bf16),         # ragged 16-row tile
        (2, 1024, 16, 64, 64, 1, 512, bf16),            # chunk 512
        (2, 288, 4, 48, 48, 1, 96, bf16),               # P = N = 48
        # a rank of zamba2's tp-4 plan (phase Z): its 20 heads, x/B/C views
        # of its conv output (rows of 20 * 64 + 2 * 64)
        (Z_MICRO, H_SEQ, ZR_SSD_HEADS, SSD_P, SSD_N, SSD_G, SSD_CHUNK, bf16),
    ]
    for i, (b, s, h, p, n, g, chunk, dtype) in enumerate(ssd_cases):
        x, dt, a, bb, cc = _ssd_inputs(b, s, h, p, n, g, dtype, seed=40 + i)
        y, hT = SS.ssd_scan(x, dt, a, bb, cc, chunk=chunk)
        sync()
        y_ref, hT_ref = SS.ssd_scan(x, dt, a, bb, cc, chunk=chunk,
                                    impl="plain")
        sync()
        ok_y, err_y = close(y, y_ref, **(BF16_TOL if dtype == torch.bfloat16
                                         else SSD_F32_TOL))
        ok_h, err_h = close(hT, hT_ref, **SSD_F32_TOL)
        log(f"# ssd B{b} S{s} H{h} P{p} N{n} G{g} chunk {chunk} {dtype}: "
            f"y max err {err_y:.3e} (max |y| {float(y_ref.abs().max()):.1f})"
            f", hT max err {err_h:.3e} "
            f"(max |hT| {float(hT_ref.abs().max()):.1f})")
        if not (ok_y and ok_h):
            raise AssertionError("ssd scan kernel disagrees with its plain "
                                 f"version (case {i})")
        if i == len(ssd_cases) - 1:
            errs["ssd_scan@zamba2_tp4"] = err_y
        if i == 0:
            errs["ssd_scan"] = err_y
            # the ticket order of the bf16 kernel's items must not change
            # any sum: a second call agrees bit for bit
            y2, hT2 = SS.ssd_scan(x, dt, a, bb, cc, chunk=chunk)
            sync()
            same = torch.equal(y, y2) and torch.equal(hT, hT2)
            log(f"# ssd serving shape, second call bitwise equal: {same}")
            if not same:
                raise AssertionError("ssd scan kernel: two calls differ")
    errs.update(_backward_kernels_vs_plain())
    return errs


def tile_rel_err(got, want, tile=FLASH_BWD_TILE):
    """Relative errors of a (B, S, heads, hd) gradient: the largest
    ||got - want|| / ||want|| over its (batch, tile of S rows, head) blocks,
    and max |got - want| / max |want|."""
    got, want = got.float(), want.float()
    b, s, h, _ = want.shape
    pad = (-s) % tile

    def block_sq(x):   # squared norms per (batch, tile, head)
        x = F.pad(x.square().sum(-1), (0, 0, 0, pad))
        return x.view(b, (s + pad) // tile, tile, h).sum(2)

    err_sq, want_sq = block_sq(got - want), block_sq(want)
    rel = (err_sq / want_sq.clamp_min(1e-30)).sqrt()
    worst = float(rel.max()) if bool(torch.isfinite(got).all()) else math.inf
    return worst, float((got - want).abs().max() / want.abs().max())


def flash_bwd_close(got, want):
    """(ok, max_abs_err, tile rel, max rel) of one flash gradient under
    FLASH_BWD_TOL and FLASH_BWD_REL."""
    ok, err = close(got, want, **FLASH_BWD_TOL)
    tile, top = tile_rel_err(got, want)
    return (ok and tile <= FLASH_BWD_REL and top <= FLASH_BWD_REL,
            err, tile, top)


def _backward_kernels_vs_plain():
    """The backward kernels against their plain versions; returns their
    max errors at the training shapes."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN

    errs = {}
    cases = [  # (B, Sq, Sk, H, KV, hd, causal)
        (T_MICRO, T_SEQ, T_SEQ, N_HEADS, N_KV, HEAD_DIM, True),  # training
        (2, 40, 40, 4, 1, 32, True),        # the reduced config's heads
        # every head dim with Sq not a multiple of a query tile
        (2, 200, 200, 8, 2, 32, True),
        (2, 300, 300, 8, 2, 64, True),
        (2, 250, 250, 8, 8, 80, True),
        (2, 330, 330, 8, 2, 128, True),
        # Sk shorter than one key tile
        (2, 200, 50, 8, 2, 128, False),
        (2, 40, 30, 8, 8, 80, True),
        # H = KV (no grouping), zamba2's shared block
        (2, 256, 256, Z_HEADS, Z_HEADS, Z_HEAD_DIM, True),
        # causal with Sq > Sk
        (2, 300, 100, 16, 4, 64, True),
        # non-causal with a ragged last key tile
        (2, 129, 200, 8, 2, 32, False),
        (2, 256, 333, 8, 8, 80, False),
        # qwen2-moe's training shape (phase M (b)) and its tp-4 rank's (c)
        (T_MICRO, T_SEQ, T_SEQ, M_HEADS, M_HEADS, HEAD_DIM, True),
        (T_MICRO, T_SEQ, T_SEQ, M_HEADS // M_TP, M_HEADS // M_TP, HEAD_DIM,
         True),
        (R_BATCH, T_SEQ, T_SEQ, R_HEADS, R_KV, HEAD_DIM, True),  # tp-4 rank
        (P_BATCH, T_SEQ, T_SEQ, P_HEADS, P_KV, HEAD_DIM, True),  # tp-8 stage
        # zamba2's shared block in training (phase H)
        (H_MICRO, H_SEQ, H_SEQ, Z_HEADS, Z_HEADS, Z_HEAD_DIM, True),
        # ... and on a rank of its tp-4 plan (phase Z)
        (Z_MICRO, H_SEQ, H_SEQ, ZR_HEADS, ZR_HEADS, Z_HEAD_DIM, True),
    ]
    rank_cases = {len(cases) - 6: "qwen2_moe",
                  len(cases) - 5: "qwen2_moe_tp4", len(cases) - 4: "tp4",
                  len(cases) - 3: "tp8", len(cases) - 2: f"hd{Z_HEAD_DIM}",
                  len(cases) - 1: "zamba2_tp4"}
    def check(what, got, want):
        res = [flash_bwd_close(g, w) for g, w in zip(got, want)]
        log(f"# flash bwd {what}: dq/dk/dv max err "
            f"{'/'.join(f'{r[1]:.3e}' for r in res)} (max |ref| "
            f"{'/'.join(f'{float(w.abs().max()):.2f}' for w in want)}); "
            f"relative, worst tile "
            f"{'/'.join(f'{r[2]:.3e}' for r in res)}, max err / max |ref| "
            f"{'/'.join(f'{r[3]:.3e}' for r in res)}")
        if not all(r[0] for r in res):
            raise AssertionError("flash attention backward kernel disagrees "
                                 f"with its plain version ({what})")
        return res

    def inputs(b, sq, sk, h, kv, hd, causal, seed):
        q, k, v = _qkv(b, sq, sk, h, kv, hd, seed=seed)
        dout = _qkv(b, sq, 1, h, 1, hd, seed=seed + 20)[0]
        o, lse = FA.flash_attention(q, k, v, causal=causal)
        return q, k, v, o, lse, dout

    def plain(q, k, v, o, lse, dout, causal):
        want = FA.flash_attention_bwd(q.float(), k.float(), v.float(),
                                      o.float(), lse, dout.float(),
                                      causal=causal, impl="plain")
        sync()
        return want

    for i, (b, sq, sk, h, kv, hd, causal) in enumerate(cases):
        q, k, v, o, lse, dout = inputs(b, sq, sk, h, kv, hd, causal, 70 + i)
        got = FA.flash_attention_bwd(q, k, v, o, lse, dout, causal=causal)
        sync()
        want = plain(q, k, v, o, lse, dout, causal)
        res = check(f"B{b} Sq{sq} Sk{sk} H{h} KV{kv} hd{hd} causal={causal}",
                    got, want)
        if i in rank_cases:
            errs[f"flash_attention_bwd@{rank_cases[i]}"] = max(
                r[1] for r in res)
        if i == 0:
            train = (q, k, v, o, lse, dout), want
            errs["flash_attention_bwd"] = max(r[1] for r in res)
            # the rule must see a fault confined to late tiles: the late
            # half of dq (or of dk) at 0.8x its value fails it
            for j, name in ((0, "dq"), (1, "dk")):
                bad = got[j].clone()
                bad[:, bad.shape[1] // 2:] *= 0.8
                ok, _, tile, _ = flash_bwd_close(bad, want[j])
                log(f"# flash bwd training shape, planted fault (late half "
                    f"of {name} x 0.8): worst tile {tile:.3e}, rejected "
                    f"{not ok}")
                if ok:
                    raise AssertionError("the flash backward rule passes a "
                                         "planted fault")
            # deterministic (no atomics): a second call agrees bit for bit
            again = FA.flash_attention_bwd(q, k, v, o, lse, dout,
                                           causal=causal)
            sync()
            same = all(torch.equal(a, b_) for a, b_ in zip(got, again))
            log(f"# flash bwd training shape, second call bitwise equal: "
                f"{same}")
            if not same:
                raise AssertionError("flash backward kernel: two calls "
                                     "differ")
    # the dQ parts add in a fixed order per (batch, head, query tile): two
    # calls agree bit for bit where the ordered adds cross batches and heads
    args = inputs(2, 1024, 1024, N_HEADS, N_KV, HEAD_DIM, True, 60)
    got = FA.flash_attention_bwd(*args, causal=True)
    again = FA.flash_attention_bwd(*args, causal=True)
    sync()
    check(f"B2 Sq1024 Sk1024 H{N_HEADS} KV{N_KV} hd{HEAD_DIM} causal=True",
          got, plain(*args, True))
    same = all(torch.equal(a, b_) for a, b_ in zip(got, again))
    log(f"# flash bwd B2 S1024, second call bitwise equal: {same}")
    if not same:
        raise AssertionError("flash backward kernel: two calls differ at "
                             "B 2, S 1024")
    # the scratch (dq_accum, the ticket and the counters) is set up by each
    # call: the training shape right after another shape still agrees with
    # its plain version
    (q, k, v, o, lse, dout), want = train
    got = FA.flash_attention_bwd(q, k, v, o, lse, dout, causal=True)
    sync()
    check("training shape again, after B2 S1024", got, want)
    del train, args, got, again, want

    bf16, f32 = torch.bfloat16, torch.float32
    rn_cases = [  # (rows, d, x dtype, scale dtype)
        (T_MICRO * T_SEQ, D_MODEL, bf16, bf16),   # the training shape
        (BATCH * PROMPT_LEN, Z_D_MODEL, bf16, bf16),
        (Z_MICRO * H_SEQ // Z_TP, Z_D_MODEL, bf16, bf16),  # phase Z's rank
        (33, 8192, bf16, bf16),                   # generic kernel widths
        (5, 1001, bf16, bf16),
        (300, D_MODEL, f32, f32),
        (7, 1001, f32, f32),
        (300, D_MODEL, f32, bf16),                # mixed types
        (300, D_MODEL, bf16, f32),
        (300, Z_D_MODEL, f32, f32),               # the ring's other cases:
        (3, D_MODEL, bf16, bf16),                 # f32 d 2560, 3 blocks
        (T_MICRO * T_SEQ, M_D_MODEL, bf16, bf16),  # qwen2-moe training
        (T_SEQ // M_TP, M_D_MODEL, bf16, bf16),   # ... its tp-4 rank
        (300, M_D_MODEL, f32, f32),
    ]

    def rn_inputs(rows, d, xdt, sdt):
        g = torch.Generator(DEVICE).manual_seed(rows + d + 1)
        x = torch.randn((rows, d), generator=g, device=DEVICE).to(xdt)
        dy = torch.randn((rows, d), generator=g, device=DEVICE).to(xdt)
        scale = (1 + 0.1 * torch.randn((d,), generator=g, device=DEVICE)
                 ).to(sdt)
        return x, scale, dy

    def rn_close(got, want, xdt, sdt):
        return (close(got[0], want[0], **(BF16_TOL if xdt == bf16
                                           else F32_TOL)),
                close(got[1], want[1], **(BF16_TOL if sdt == bf16
                                           else DSCALE_F32_TOL)))

    for rows, d, xdt, sdt in rn_cases:
        x, scale, dy = rn_inputs(rows, d, xdt, sdt)
        # the route the kernel's dispatch takes (mirrored by the wrapper)
        esize = x.element_size()
        route = RN.bwd_vectors_per_thread(
            d, esize, x.data_ptr() % 16 == 0 and dy.data_ptr() % 16 == 0
            and d * esize % 16 == 0)
        got = RN.rmsnorm_bwd(x, scale, dy)
        sync()
        want = RN.rmsnorm_bwd(x, scale, dy, impl="plain")
        sync()
        (ok_x, err_x), (ok_s, err_s) = rn_close(got, want, xdt, sdt)
        log(f"# rmsnorm bwd rows {rows} d {d} x {xdt} scale {sdt} ("
            f"{f'ring, {route} vectors a thread' if route else 'generic'}"
            f"): dx max err {err_x:.3e}, dscale max err {err_s:.3e} (max "
            f"|dscale| {float(want[1].float().abs().max()):.1f})")
        if not (ok_x and ok_s):
            raise AssertionError("rmsnorm backward kernel disagrees with "
                                 f"its plain version ({rows}x{d})")
        if bool(route) != (d in (D_MODEL, Z_D_MODEL, M_D_MODEL)):
            raise AssertionError(f"rmsnorm backward at d {d}: route "
                                 f"{route or 'generic'}")
        if rows == T_MICRO * T_SEQ and d == D_MODEL:
            errs["rmsnorm_bwd"] = err_x
            train = (x, scale, dy), got, want
        if rows == H_MICRO * H_SEQ and d == Z_D_MODEL and xdt == bf16:
            errs[f"rmsnorm_bwd@d{Z_D_MODEL}"] = err_x
        if rows == T_MICRO * T_SEQ and d == M_D_MODEL:
            errs[f"rmsnorm_bwd@d{M_D_MODEL}"] = err_x
    # the training shape again, right after another shape (other grid, other
    # route): it agrees with its plain version, and bit for bit with the
    # first call (the dscale partials add in a fixed order)
    (x, scale, dy), first, want = train
    RN.rmsnorm_bwd(*rn_inputs(5, 1001, bf16, bf16))
    again = RN.rmsnorm_bwd(x, scale, dy)
    sync()
    (ok_x, err_x), (ok_s, err_s) = rn_close(again, want, bf16, bf16)
    same = all(torch.equal(a, b_) for a, b_ in zip(first, again))
    log(f"# rmsnorm bwd training shape again, after 5 x 1001: dx max err "
        f"{err_x:.3e}, dscale max err {err_s:.3e}; bitwise equal to the "
        f"first call: {same}")
    if not (ok_x and ok_s):
        raise AssertionError("rmsnorm backward kernel disagrees with its "
                             "plain version after another shape")
    if not same:
        raise AssertionError("rmsnorm backward kernel: two calls differ")
    # the dscale check must see one block's band of rows left out
    rows = x.shape[0]
    blocks = RN.bwd_blocks(rows, torch.cuda.get_device_properties(
        DEVICE).multi_processor_count)
    lo, hi = RN.bwd_bands(rows, blocks)[blocks // 2]
    keep = torch.ones(rows, dtype=torch.bool, device=DEVICE)
    keep[lo:hi] = False
    bad = RN.rmsnorm_bwd(x[keep], scale, dy[keep], impl="plain")[1]
    ok, err = close(bad, want[1], **BF16_TOL)
    log(f"# rmsnorm bwd training shape, planted fault (dscale without rows "
        f"{lo}-{hi - 1}, block {blocks // 2} of {blocks}): max err "
        f"{err:.3e}, rejected {not ok}")
    if ok:
        raise AssertionError("the rmsnorm backward's dscale check passes a "
                             "planted fault")
    del train, first, again, want, bad
    return errs


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------


def _plan(num_layers):
    from repro_torch.core.plan import single_stage_plan
    return single_stage_plan(num_layers, dp=1, tp=1, micro_batch=1,
                             grad_accum=1, zero=0, ckpt_layers=0,
                             attn_impl="pallas", use_pallas=True)


def _counters():
    """Each kernel's launch counter: (module, attribute)."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.kernels import ssd_scan as SS
    return {"flash_attention_fwd": (FA, "LAUNCHES"),
            "flash_attention_bwd": (FA, "BWD_LAUNCHES"),
            "rmsnorm": (RN, "LAUNCHES"), "rmsnorm_bwd": (RN, "BWD_LAUNCHES"),
            "ssd_scan": (SS, "LAUNCHES"), "ssd_scan_bwd": (SS, "BWD_LAUNCHES")}


def _reset_counts():
    for mod, attr in _counters().values():
        setattr(mod, attr, 0)


def _read_counts():
    return {name: getattr(mod, attr)
            for name, (mod, attr) in _counters().items()}


def _as_accurate(got, base, truth, what):
    """Raise unless ``got`` (bf16, kernels) is finite and its error against
    ``truth`` (f32) is at most ACCURACY_ROOM times ``base``'s (bf16, plain
    versions), in max and in mean."""
    e, e0 = (got - truth).abs(), (base - truth).abs()
    agree = float((got.argmax(-1) == truth.argmax(-1)).float().mean())
    agree0 = float((base.argmax(-1) == truth.argmax(-1)).float().mean())
    log(f"# {what} against the f32 plain run (max |logit| "
        f"{float(truth.abs().max()):.4f}): kernels max {float(e.max()):.4e} "
        f"mean {float(e.mean()):.4e} argmax agreement {agree}; plain bf16 "
        f"max {float(e0.max()):.4e} mean {float(e0.mean()):.4e} argmax "
        f"agreement {agree0}")
    if not (torch.isfinite(got).all()
            and e.max() <= ACCURACY_ROOM * e0.max()
            and e.mean() <= ACCURACY_ROOM * e0.mean()):
        raise AssertionError(f"{what}: the kernels' bf16 error exceeds "
                             f"{ACCURACY_ROOM}x the plain versions'")


def phase_full_width_serve(arch, dims, want_launches, f32_truth=False):
    """Full-width ``arch`` (bf16, random weights from seed 0): prefill logits
    with the kernels against the plain versions -- within LOGIT_REL_TOL of
    the largest logit, or with ``f32_truth`` under the ACCURACY_ROOM rule
    against the plain versions in f32 -- then ``generate(gen=32)`` with
    every launch counter set to 0 just before and checked exactly just
    after.  ``dims`` are the config fields to assert; ``want_launches`` maps
    the config to the expected counts.  Returns (model, params, prompts,
    plan, launches, peak memory)."""
    from repro_torch.configs.base import get_arch
    from repro_torch.launch.serve import generate
    from repro_torch.lowering import serve_exec_cfg
    from repro_torch.models.zoo import build_model
    from repro_torch.training.step import make_prefill_step

    cfg = get_arch(arch)
    got_dims = {k: getattr(cfg, k) for k in dims}
    assert got_dims == dims, (got_dims, dims)
    model = build_model(cfg, DEVICE)
    t0 = time.perf_counter()
    params, _ = model.init(torch.Generator(DEVICE).manual_seed(0))
    sync()
    n_params = sum(p.numel() for p in params.values())
    log(f"# {arch} full width, {cfg.num_layers} layers: "
        f"{n_params / 1e9:.3f} B params (bf16) initialised in "
        f"{time.perf_counter() - t0:.1f} s")
    plan = _plan(cfg.num_layers)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT_LEN),
                            generator=torch.Generator(DEVICE).manual_seed(1),
                            device=DEVICE, dtype=torch.int32)

    # prefill logits: kernels vs the plain versions (the impl= test hook)
    batch = {"tokens": prompts}
    got = make_prefill_step(model, plan).fn(params, batch)
    want = make_prefill_step(model, plan, kernel_impl="plain").fn(params, batch)
    sync()
    assert got.shape == want.shape == (BATCH, 1, cfg.vocab_size)
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    log(f"# {arch} prefill logits, kernels vs plain: max abs diff {err:.4e}, "
        f"max |logit| {scale:.4f}, mean abs diff "
        f"{float((got - want).abs().mean()):.4e}, argmax agreement {agree}")
    if f32_truth:
        ec = serve_exec_cfg(plan).replace(kernel_impl="plain",
                                          compute_dtype=torch.float32)
        # the f32 copy beside the bf16 weights takes 3x their bytes; where
        # the card cannot hold that (qwen2-moe's 28.6 GB of bf16), the bf16
        # weights wait on the host meanwhile
        host = None
        if 3 * 2 * n_params > 0.8 * torch.cuda.get_device_properties(
                DEVICE).total_memory:
            host = {n: t.cpu() for n, t in params.items()}
            params = None
            torch.cuda.empty_cache()
        p32 = {n: t.to(DEVICE).float() for n, t in
               (host or params).items()}
        with torch.inference_mode():
            truth = model.prefill_fn(p32, batch, ec)
        del p32
        torch.cuda.empty_cache()
        if host is not None:
            params = {n: t.to(DEVICE) for n, t in host.items()}
            del host
        _as_accurate(got, want, truth, f"{arch} prefill logits")
    elif not (torch.isfinite(got).all() and err <= LOGIT_REL_TOL * scale):
        raise AssertionError(f"prefill logits: kernels vs plain {err} > "
                             f"{LOGIT_REL_TOL} * {scale}")

    # the main path, counted: every count set to 0 just before, read after
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    toks = generate(model, params, prompts, GEN, plan)
    sync()
    launches = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"# {arch} generate(gen={GEN}) launches: {launches}; peak memory "
        f"{peak / 2**30:.2f} GiB")
    if launches != want_launches(cfg):
        raise AssertionError(f"launch counts {launches} != "
                             f"{want_launches(cfg)}")
    assert toks.shape == (BATCH, GEN) and toks.dtype == torch.int32
    assert bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
    log(f"# first row: {toks[0].tolist()}")
    return model, params, prompts, plan, launches, peak


def _granite_launches(cfg):
    return {"flash_attention_fwd": cfg.num_layers, "flash_attention_bwd": 0,
            "rmsnorm": (2 * cfg.num_layers + 1) * GEN, "rmsnorm_bwd": 0,
            "ssd_scan": 0, "ssd_scan_bwd": 0}


def _zamba2_launches(cfg):
    groups = cfg.num_layers // cfg.shared_attn_every
    # prefill: one flash per shared-block application and one SSD per
    # Mamba2 layer; every forward: 2 norms per application, 1 per Mamba2
    # layer and the final norm (73 at full width), and each decode step the
    # gated norm of every Mamba2 layer too (127)
    return {"flash_attention_fwd": groups, "flash_attention_bwd": 0,
            "rmsnorm": (2 * groups + cfg.num_layers + 1) * GEN
            + cfg.num_layers * (GEN - 1),
            "rmsnorm_bwd": 0, "ssd_scan": cfg.num_layers, "ssd_scan_bwd": 0}


def _teacher_forced(cfg, params, toks, plen, dev, dtype=torch.bfloat16):
    """(B, steps, V) logits on ``dev`` in ``dtype``: prefill over
    toks[:, :plen], then decode of the rest one token at a time, with the
    kernels' plan (kernels on the card, plain versions on the CPU)."""
    from repro_torch.lowering import serve_exec_cfg
    from repro_torch.models.zoo import build_model, pad_caches

    model = build_model(cfg, dev)
    ec = serve_exec_cfg(_plan(cfg.num_layers)).replace(compute_dtype=dtype)
    p = {n: t.to(dev, dtype) for n, t in params.items()}
    t = toks.to(dev)
    with torch.inference_mode():
        logits, caches = model.prefill_fn(p, {"tokens": t[:, :plen]}, ec,
                                          True)
        caches = pad_caches(caches, toks.shape[1] - plen)
        rows = [logits[:, -1]]
        for i in range(plen, toks.shape[1]):
            logits, caches = model.decode_fn(p, t[:, i:i + 1], caches, ec)
            rows.append(logits[:, -1])
    return torch.stack(rows, 1).float().cpu()


class _PinnedRouting:
    """The MoE blocks' routing pinned to a recorded run's: ``record`` keeps
    each call's experts and slots (in call order: layer by layer, prefill
    then each decode step), ``replay`` routes every call to them, the gates
    taken from the run's own probabilities at those experts.  A bf16 run's
    rounding moves some router logits across near-ties, and a flipped
    choice moves its token's output by a whole expert's: pinned, the runs
    differ only by their arithmetic, which the ACCURACY_ROOM rule holds."""

    def __init__(self):
        from repro_torch.models import moe as MOE
        self.mod, self.real, self.book, self.at = MOE, MOE.route, [], None

    def __enter__(self):
        self.mod.route = self._route
        return self

    def __exit__(self, *exc):
        self.mod.route = self.real

    def replay(self):
        self.at = 0

    def _route(self, logits, cfg, ec):
        import dataclasses
        r = self.real(logits, cfg, ec)
        if self.at is None:
            self.book.append((r.idx.cpu(), r.pos.cpu()))
            return r
        idx, pos = (t.to(logits.device) for t in self.book[self.at])
        self.at += 1
        probs = torch.softmax(logits.reshape(idx.shape[0], idx.shape[1], -1),
                              -1)
        gates = probs.gather(-1, idx)
        gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
        return dataclasses.replace(r, gates=gates, idx=idx, pos=pos,
                                   keep=pos < r.cap)


def phase_reduced_vs_cpu(arch, f32_truth=False):
    """The reduced config with the kernels on the card against the plain
    versions on the CPU, same weights, teacher-forced, bf16: within
    REDUCED_LOGIT_ATOL, or with ``f32_truth`` under the ACCURACY_ROOM rule
    against the CPU run in f32 (the exact function of these weights).  An
    MoE config routes both bf16 runs as the f32 run routed
    (``_PinnedRouting``)."""
    import contextlib

    from repro_torch.configs.base import get_arch
    from repro_torch.models.zoo import build_model

    cfg = get_arch(arch).reduced()
    b, plen, steps = 4, 64, 3
    toks = torch.randint(0, cfg.vocab_size, (b, plen + steps),
                         generator=torch.Generator().manual_seed(2),
                         dtype=torch.int32)
    params, _ = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    pinned = cfg.is_moe and f32_truth
    pin = _PinnedRouting() if pinned else contextlib.nullcontext()
    with pin:
        if f32_truth:
            truth = _teacher_forced(cfg, params, toks, plen, "cpu",
                                    torch.float32)
        if pinned:
            pin.replay()
        card = _teacher_forced(cfg, params, toks, plen, DEVICE)
        if pinned:
            pin.replay()
        cpu = _teacher_forced(cfg, params, toks, plen, "cpu")
    err = float((card - cpu).abs().max())
    log(f"# {arch} reduced config, card kernels vs CPU plain, teacher-forced "
        f"logits{', routing pinned to the f32 run' if pinned else ''}: "
        f"max abs diff {err:.4e} (max |logit| {float(cpu.abs().max()):.4f})")
    if f32_truth:
        _as_accurate(card, cpu, truth, f"{arch} reduced config")
    elif not (torch.isfinite(card).all() and err <= REDUCED_LOGIT_ATOL):
        raise AssertionError(f"reduced config: {err} > {REDUCED_LOGIT_ATOL}")


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------


def flash_bound(b, sq, sk, h, kv, hd, causal):
    """(bound_ms, bound_by, arithmetic) for one flash-attention forward."""
    pairs = sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk
    flops = 4 * b * h * hd * pairs             # QK^T and PV, 2 flop per MAC
    nbytes = 2 * (2 * b * sq * h * hd + 2 * b * sk * kv * hd) + 4 * b * h * sq
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    how = (f"{flops / 1e9:.2f} GFLOP / 989 TFLOP/s = {t_ops * 1e6:.1f} us; "
           f"{nbytes / 1e6:.1f} MB (q,k,v,o bf16 + lse f32) / 3.35 TB/s = "
           f"{t_bytes * 1e6:.1f} us")
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes", how


def rmsnorm_bound(rows, d, esize):
    flops = 4 * rows * d                       # square, add, 2 multiplies
    nbytes = 2 * rows * d * esize + d * esize  # x read, y written, scale
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    how = (f"{nbytes / 1e6:.1f} MB / 3.35 TB/s = {t_bytes * 1e6:.1f} us; "
           f"{flops / 1e6:.1f} MFLOP f32 / 67 TFLOP/s = {t_ops * 1e6:.2f} us")
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops > t_bytes else "bytes", how


def ssd_bound(b, s, h, p, n, g, q, esize):
    """(bound_ms, bound_by, arithmetic) for one SSD chunk scan.  Operations:
    per (batch, head) and chunk, C B^T and scores x over the causal
    (t >= s) pairs only, the state update, and C h for every chunk after the
    first (the entering state of the first is 0), 2 flop per MAC, at the
    bf16 tensor-core rate for bf16 inputs (f32 rate for f32).  Bytes: x, B/C
    (once per group), dt, a read once; y and the f32 final state written
    once."""
    nc, pairs = s // q, q * (q + 1) // 2
    flops = b * h * (nc * 2 * pairs * (n + p) + nc * 2 * q * n * p
                     + (nc - 1) * 2 * q * n * p)
    nbytes = (2 * b * s * h * p + 2 * b * s * g * n) * esize \
        + 4 * (b * s * h + h + b * h * p * n)
    peak, rate = (PEAK_BF16_FLOPS, "989 TFLOP/s bf16") if esize == 2 \
        else (PEAK_F32_FLOPS, "67 TFLOP/s f32")
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    how = (f"{flops / 1e9:.2f} GFLOP / {rate} = {t_ops * 1e6:.1f} us "
           f"(at 67 TFLOP/s f32: {flops / PEAK_F32_FLOPS * 1e6:.1f} us); "
           f"{nbytes / 1e6:.1f} MB / 3.35 TB/s = {t_bytes * 1e6:.1f} us")
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes", how


def _time_flash(model_name, b, s, h, kv, hd, launches, err):
    """The flash entry of the kernels line at one prefill shape, with
    ``scaled_dot_product_attention`` on K/V expanded to H heads as the
    library yardstick."""
    from repro_torch.kernels import flash_attention as FA

    q, k, v = _qkv(b, s, s, h, kv, hd, seed=99)
    qh = q.transpose(1, 2).contiguous()
    kh = k.repeat_interleave(h // kv, dim=2).transpose(1, 2).contiguous()
    vh = v.repeat_interleave(h // kv, dim=2).transpose(1, 2).contiguous()
    kernel = lambda: FA.flash_attention(q, k, v, causal=True)  # noqa: E731
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qh, kh, vh, is_causal=True)
    ms, lib = time_ms(kernel), time_ms(sdpa)
    dev = time_ms(kernel, device_only=True)
    lib_dev = time_ms(sdpa, device_only=True)
    cold = time_ms(kernel, cold=True, device_only=True)
    lib_cold = time_ms(sdpa, cold=True, device_only=True)
    plain = time_ms(lambda: FA.flash_attention(q, k, v, causal=True,
                                               impl="plain"), reps=5)
    bound, by, how = flash_bound(b, s, s, h, kv, hd, True)
    log(f"# flash hd {hd}: kernel {ms:.4f} ms (device {dev:.4f}, cold L2 "
        f"{cold:.4f}), plain {plain:.4f} ms, SDPA {lib:.4f} ms (device "
        f"{lib_dev:.4f}, cold {lib_cold:.4f}); kernel / SDPA {ms / lib:.3f} "
        f"(device {dev / lib_dev:.3f}, cold {cold / lib_cold:.3f}); bound: "
        f"{how} -> {bound * 1e3:.1f} us ({by}), {bound / cold:.1%} of it "
        f"cold")
    return dict(
        name="flash_attention_fwd", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:25",
        launches=launches, max_abs_err=err, ms=ms, plain_ms=plain,
        bound_ms=bound, bound_by=by, library_ms=lib, device_ms=dev,
        library_device_ms=lib_dev, cold_ms=cold, library_cold_ms=lib_cold,
        model=model_name, shape=f"B{b} S{s} H{h} KV{kv} hd{hd} causal bf16")


def _time_rmsnorm(model_name, d, launches, err, decode_launches=None):
    """The RMSNorm entries: the prefill shape's (BATCH * PROMPT_LEN rows),
    and the decode shape's (BATCH rows) printed.  With ``decode_launches``
    (of the ``launches``, those at the decode shape) the decode shape gets
    an entry of its own with them, and the prefill's keeps the rest."""
    from repro_torch.kernels import rmsnorm as RN

    entries = []
    for rows in (BATCH * PROMPT_LEN, BATCH):
        g = torch.Generator(DEVICE).manual_seed(rows)
        x = torch.randn((rows, d), generator=g, device=DEVICE
                        ).to(torch.bfloat16)
        sc = torch.ones(d, device=DEVICE, dtype=torch.bfloat16)
        kernel = lambda: RN.rmsnorm(x, sc)  # noqa: E731
        lib = lambda: F.rms_norm(x, (d,), weight=sc, eps=1e-6)  # noqa: E731
        r_ms, r_lib = time_ms(kernel, reps=50), time_ms(lib, reps=50)
        r_dev = time_ms(kernel, reps=50, device_only=True)
        r_lib_dev = time_ms(lib, reps=50, device_only=True)
        r_cold = time_ms(kernel, reps=50, cold=True, device_only=True)
        r_lib_cold = time_ms(lib, reps=50, cold=True, device_only=True)
        r_plain = time_ms(lambda: RN.rmsnorm(x, sc, impl="plain"), reps=50)
        r_bound, r_by, how = rmsnorm_bound(rows, d, 2)
        log(f"# rmsnorm {rows}x{d} bf16: kernel {r_ms:.4f} ms (device "
            f"{r_dev:.4f}, cold L2 {r_cold:.4f}), plain {r_plain:.4f} ms, "
            f"F.rms_norm {r_lib:.4f} ms (device {r_lib_dev:.4f}, cold "
            f"{r_lib_cold:.4f}); kernel - F.rms_norm "
            f"{(r_ms - r_lib) * 1e3:.2f} us (device "
            f"{(r_dev - r_lib_dev) * 1e3:.2f}, cold "
            f"{(r_cold - r_lib_cold) * 1e3:.2f}); bound {how}; "
            f"{r_bound / r_cold:.1%} of it cold")
        if rows == BATCH * PROMPT_LEN:
            n = launches - (decode_launches or 0)
        elif decode_launches is not None:
            n = decode_launches
        else:
            continue
        entries.append(dict(
            name="rmsnorm", route="cuda",
            source="src/repro_torch/kernels/csrc/rmsnorm.cu",
            replaces="src/repro/kernels/rmsnorm.py:16",
            launches=n, max_abs_err=err, ms=r_ms,
            plain_ms=r_plain, bound_ms=r_bound, bound_by=r_by,
            library_ms=r_lib, device_ms=r_dev, library_device_ms=r_lib_dev,
            cold_ms=r_cold, library_cold_ms=r_lib_cold, model=model_name,
            shape=f"{rows}x{d} bf16"))
    return entries


def _time_ssd(launches, err, shape=(BATCH, PROMPT_LEN, SSD_HEADS),
              model="zamba2-2.7b"):
    """The SSD entry at one (B, S, H) of zamba2's (its prefill shape by
    default), inputs laid out as the model gives them.  No single PyTorch
    call computes the SSD scan, so there is no library yardstick."""
    from repro_torch.kernels import ssd_scan as SS

    (b, s, h), p, n, g, q = shape, SSD_P, SSD_N, SSD_G, SSD_CHUNK
    x, dt, a, bb, cc = _ssd_inputs(b, s, h, p, n, g, torch.bfloat16,
                                   seed=98)
    kernel = lambda: SS.ssd_scan(x, dt, a, bb, cc, chunk=q)  # noqa: E731
    ms = time_ms(kernel)
    dev = time_ms(kernel, device_only=True)
    cold = time_ms(kernel, cold=True, device_only=True)
    plain = time_ms(lambda: SS.ssd_scan(x, dt, a, bb, cc, chunk=q,
                                        impl="plain"), reps=5)
    bound, by, how = ssd_bound(b, s, h, p, n, g, q, 2)
    states = 4 * math.prod(SS.state_scratch_shape(b, h, s // q, p, n))
    log(f"# ssd B{b} H{h}: kernel {ms:.4f} ms (device {dev:.4f}, cold L2 "
        f"{cold:.4f}), "
        f"plain {plain:.4f} ms; bound: {how} -> {bound * 1e3:.1f} us ({by}), "
        f"{bound / cold:.1%} of it cold; beyond the bound's bytes the chain "
        f"writes and reads {states / 1e6:.1f} MB "
        f"of f32 states; {SS.smem_bytes(q, p, n)} B of shared memory a block")
    if shape == (BATCH, PROMPT_LEN, SSD_HEADS):
        k512 = lambda: SS.ssd_scan(x, dt, a, bb, cc, chunk=512)  # noqa: E731
        log(f"# ssd at chunk 512 (one block per SM): cold L2 "
            f"{time_ms(k512, cold=True, device_only=True):.4f} ms")
    return dict(
        name="ssd_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan.py:20",
        launches=launches, max_abs_err=err, ms=ms, plain_ms=plain,
        bound_ms=bound, bound_by=by, library_ms=None, device_ms=dev,
        library_device_ms=None, cold_ms=cold, library_cold_ms=None,
        model=model, shape=f"B{b} S{s} H{h} P{p} N{n} G{g} chunk {q} bf16")


def kernel_split_us(fn, reps: int = 10) -> dict:
    """Device microseconds per launch of each CUDA kernel that ``fn``
    launches (a torch.profiler window over ``reps`` calls)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        sync()
    out = {}
    for ev in prof.key_averages():
        dev = getattr(ev, "device_time_total", 0) or \
            getattr(ev, "cuda_time_total", 0)
        if dev and ev.count and \
                ev.device_type == torch.autograd.DeviceType.CUDA:
            # "void (anonymous namespace)::name<128>(args)" -> "name"
            name = ev.key.replace("(anonymous namespace)::", "")
            name = re.split(r"[(<]", name.removeprefix("void "))[0]
            out[name] = out.get(name, 0.0) + dev / ev.count
    return out


def flash_bwd_bound(b, sq, sk, h, kv, hd, causal):
    """(bound_ms, bound_by, arithmetic) for one flash-attention backward:
    five products (S, dP, dV, dK, dQ) over the causal pairs, 2 flop per
    MAC; q, k, v, o, dO and lse read once, dq, dk, dv written once."""
    pairs = sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk
    flops = 5 * 2 * b * h * hd * pairs
    nbytes = 2 * (4 * b * sq * h * hd + 4 * b * sk * kv * hd) + 4 * b * h * sq
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    how = (f"{flops / 1e9:.2f} GFLOP / 989 TFLOP/s = {t_ops * 1e6:.1f} us; "
           f"{nbytes / 1e6:.1f} MB / 3.35 TB/s = {t_bytes * 1e6:.1f} us")
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes", how


def rmsnorm_bwd_bound(rows, d, esize):
    """x and dy read, dx written (scale read and dscale written: d each);
    ~12 f32 flop per element."""
    flops = 12 * rows * d
    nbytes = 3 * rows * d * esize + 2 * d * esize
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    how = (f"{nbytes / 1e6:.1f} MB / 3.35 TB/s = {t_bytes * 1e6:.1f} us; "
           f"{flops / 1e6:.1f} MFLOP f32 / 67 TFLOP/s = {t_ops * 1e6:.2f} us")
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops > t_bytes else "bytes", how


def _time_flash_bwd(launches, err, shape=(T_MICRO, T_SEQ, N_HEADS, N_KV,
                                          HEAD_DIM),
                    model="granite-3-8b (training)"):
    """The flash backward entry at one training shape (granite's one-card
    shape by default), with the backward of
    ``scaled_dot_product_attention`` (causal, GQA) through
    ``torch.autograd.grad`` as the library yardstick."""
    from repro_torch.kernels import flash_attention as FA

    b, s, h, kv, hd = shape
    q, k, v = _qkv(b, s, s, h, kv, hd, seed=97)
    dout = _qkv(b, s, 1, h, 1, hd, seed=96)[0]
    o, lse = FA.flash_attention(q, k, v, causal=True)
    kernel = lambda: FA.flash_attention_bwd(  # noqa: E731
        q, k, v, o, lse, dout, causal=True)
    qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    oh = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                        enable_gqa=True)
    doh = dout.transpose(1, 2)
    lib = lambda: torch.autograd.grad(  # noqa: E731
        oh, (qh, kh, vh), doh, retain_graph=True)
    ms, lib_ms = time_ms(kernel), time_ms(lib)
    dev = time_ms(kernel, device_only=True)
    lib_dev = time_ms(lib, device_only=True)
    cold = time_ms(kernel, cold=True, device_only=True)
    lib_cold = time_ms(lib, cold=True, device_only=True)
    plain = time_ms(lambda: FA.flash_attention_bwd(
        q, k, v, o, lse, dout, causal=True, impl="plain"), reps=3, warmup=1)
    parts = kernel_split_us(kernel)
    log("# flash bwd, device us per call by kernel (torch.profiler): "
        + ", ".join(f"{name} {us:.1f}" for name, us in parts.items()))
    bound, by, how = flash_bwd_bound(b, s, s, h, kv, hd, True)
    log(f"# flash bwd B{b} H{h} KV{kv}: kernel {ms:.4f} ms (device "
        f"{dev:.4f}, cold L2 "
        f"{cold:.4f}), plain {plain:.4f} ms, SDPA backward {lib_ms:.4f} ms "
        f"(device {lib_dev:.4f}, cold {lib_cold:.4f}); kernel / SDPA "
        f"{ms / lib_ms:.3f} (device {dev / lib_dev:.3f}, cold "
        f"{cold / lib_cold:.3f}); bound: {how} -> {bound * 1e3:.1f} us "
        f"({by}), {bound / cold:.1%} of it cold")
    return dict(
        name="flash_attention_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        replaces="src/repro/kernels/ops.py:75",
        launches=launches, max_abs_err=err, ms=ms, plain_ms=plain,
        bound_ms=bound, bound_by=by, library_ms=lib_ms, device_ms=dev,
        library_device_ms=lib_dev, cold_ms=cold, library_cold_ms=lib_cold,
        parts_us=parts, model=model,
        shape=f"B{b} S{s} H{h} KV{kv} hd{hd} causal bf16")


def _time_rmsnorm_bwd(launches, err, d=D_MODEL,
                      model="granite-3-8b (training)"):
    """The RMSNorm backward entry at a training shape (one micro-batch's
    4096 rows of ``d``, granite's 4096 by default), with the backward of
    ``F.rms_norm`` through ``torch.autograd.grad`` as the library
    yardstick."""
    from repro_torch.kernels import rmsnorm as RN

    rows = T_MICRO * T_SEQ
    g = torch.Generator(DEVICE).manual_seed(95)
    x = torch.randn((rows, d), generator=g, device=DEVICE).to(torch.bfloat16)
    dy = torch.randn((rows, d), generator=g, device=DEVICE).to(torch.bfloat16)
    sc = (1 + 0.1 * torch.randn((d,), generator=g, device=DEVICE)
          ).to(torch.bfloat16)
    kernel = lambda: RN.rmsnorm_bwd(x, sc, dy)  # noqa: E731
    xr, sr = x.detach().requires_grad_(True), sc.detach().requires_grad_(True)
    yr = F.rms_norm(xr, (d,), weight=sr, eps=1e-6)
    lib = lambda: torch.autograd.grad(  # noqa: E731
        yr, (xr, sr), dy, retain_graph=True)
    ms, lib_ms = time_ms(kernel, reps=50), time_ms(lib, reps=50)
    dev = time_ms(kernel, reps=50, device_only=True)
    lib_dev = time_ms(lib, reps=50, device_only=True)
    cold = time_ms(kernel, reps=50, cold=True, device_only=True)
    lib_cold = time_ms(lib, reps=50, cold=True, device_only=True)
    plain = time_ms(lambda: RN.rmsnorm_bwd(x, sc, dy, impl="plain"), reps=20)
    parts = kernel_split_us(kernel)
    log("# rmsnorm bwd, device us per call by kernel (torch.profiler): "
        + ", ".join(f"{name} {us:.2f}" for name, us in parts.items()))
    bound, by, how = rmsnorm_bwd_bound(rows, d, 2)
    log(f"# rmsnorm bwd {rows}x{d} bf16: kernel {ms:.4f} ms (device "
        f"{dev:.4f}, cold L2 {cold:.4f}), plain {plain:.4f} ms, F.rms_norm "
        f"backward {lib_ms:.4f} ms (device {lib_dev:.4f}, cold "
        f"{lib_cold:.4f}); bound {how}; {bound / cold:.1%} of it cold")
    return dict(
        name="rmsnorm_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/rmsnorm.cu",
        replaces="src/repro/models/layers.py:30",
        launches=launches, max_abs_err=err, ms=ms, plain_ms=plain,
        bound_ms=bound, bound_by=by, library_ms=lib_ms, device_ms=dev,
        library_device_ms=lib_dev, cold_ms=cold, library_cold_ms=lib_cold,
        parts_us=parts, model=model, shape=f"{rows}x{d} bf16")


# ---------------------------------------------------------------------------
# phase T: training
# ---------------------------------------------------------------------------


def _train_launches(layers, ckpt, accum):
    """Launches per train step, from the code: per micro-batch each layer
    runs one flash forward and two norms, plus the final norm; a remat'd
    layer runs its forward again in the backward (non-reentrant checkpoint
    recomputes up to the layer's last saved tensor, its MLP's down
    projection, so both norms and the attention rerun); and each forward
    of the saved graph has one backward."""
    return {"flash_attention_fwd": accum * (layers + ckpt),
            "flash_attention_bwd": accum * layers,
            "rmsnorm": accum * (2 * layers + 1 + 2 * ckpt),
            "rmsnorm_bwd": accum * (2 * layers + 1), "ssd_scan": 0,
            "ssd_scan_bwd": 0}


def _grads_as_accurate(got, want, truth, what):
    """``got`` finite, and its error against the f32 gradient ``truth`` at
    most ACCURACY_ROOM times ``want``'s (the CPU bf16 run's), in max and in
    mean; returns the max ratio."""
    e, e0 = (got - truth).abs(), (want - truth).abs()
    if not (bool(torch.isfinite(got).all())
            and float(e.max()) <= ACCURACY_ROOM * float(e0.max())
            and float(e.mean()) <= ACCURACY_ROOM * float(e0.mean())):
        raise AssertionError(
            f"{what}: card gradient less accurate than the CPU's (vs f32 max "
            f"{float(e.max()):.3e} / {float(e0.max()):.3e}, mean "
            f"{float(e.mean()):.3e} / {float(e0.mean()):.3e})")
    return float(e.max() / e0.max())


def _grads_close(got, want, truth, what):
    """The CPU parity tests' bf16 rule (tests/test_torch_train.py): mean
    difference within 3e-2 of the mean magnitude, and
    ``_grads_as_accurate``."""
    diff = float((got - want).abs().mean())
    if diff > 3e-2 * float(want.abs().mean()):
        raise AssertionError(f"{what}: card gradient off the CPU's (mean "
                             f"diff {diff:.3e})")
    return _grads_as_accurate(got, want, truth, what)


def _train_reduced_vs_cpu():
    """The reduced config, one micro-batch's loss and gradients with the
    kernels on the card against the plain versions on the CPU (same bf16
    weights), under the CPU parity tests' tolerance."""
    from repro_torch.configs.base import get_arch
    from repro_torch.core.plan import single_stage_plan
    from repro_torch.lowering import train_exec_cfg
    from repro_torch.models.zoo import build_model
    from repro_torch.training.data import BatchSpec, SyntheticLM

    cfg = get_arch("granite-3-8b").reduced()
    plan = single_stage_plan(cfg.num_layers, dp=1, tp=1, micro_batch=2,
                             grad_accum=1, ckpt_layers=2, ao=0.5,
                             attn_impl="pallas", use_pallas=True)
    params, _ = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    batch = SyntheticLM(BatchSpec(global_batch=2, seq_len=64,
                                  vocab_size=cfg.vocab_size), seed=1).batch(0)

    def loss_and_grads(dev, dtype):
        p = {n: t.to(dev, dtype).requires_grad_(True)
             for n, t in params.items()}
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        ec = train_exec_cfg(plan).replace(compute_dtype=dtype)
        loss = build_model(cfg, dev).loss_fn(p, b, ec)
        grads = torch.autograd.grad(loss, list(p.values()))
        return float(loss.detach()), {n: g.float().cpu()
                                      for n, g in zip(p, grads)}

    card_loss, card = loss_and_grads(DEVICE, torch.bfloat16)
    cpu_loss, cpu = loss_and_grads("cpu", torch.bfloat16)
    _, truth = loss_and_grads("cpu", torch.float32)
    ratio = max(_grads_close(card[n], cpu[n], truth[n], n) for n in card)
    log(f"# training, reduced config card kernels vs CPU plain: loss "
        f"{card_loss:.5f} vs {cpu_loss:.5f}; every gradient within the CPU "
        f"rule (largest error vs f32 at {ratio:.2f}x the CPU bf16 run's)")
    if abs(card_loss - cpu_loss) > REDUCED_LOSS_RTOL * abs(cpu_loss):
        raise AssertionError(f"reduced loss {card_loss} vs {cpu_loss}")


def _adam_splits_on_card():
    """adam_update on the card with WO = OO = 0.5 (host parts pinned,
    staged through the device and copied back) against WO = OO = 0, three
    steps on the same f32 gradients from the same start: the arithmetic is
    the same per element, so params, master, mu and nu (host and device
    parts joined) must be equal bit for bit."""
    import numpy as np
    from repro_torch.bridge import train_state_to_numpy
    from repro_torch.configs.base import get_arch
    from repro_torch.core.plan import single_stage_plan
    from repro_torch.models.zoo import build_model
    from repro_torch.training.optimizer import AdamConfig, adam_update, \
        is_split
    from repro_torch.training.step import init_train_state

    cfg = get_arch("granite-3-8b").reduced()
    model = build_model(cfg, DEVICE)
    states = []
    for ratio in (0.5, 0.0):
        plan = single_stage_plan(cfg.num_layers, dp=1, tp=1, micro_batch=1,
                                 grad_accum=1, wo=ratio, oo=ratio)
        states.append(init_train_state(
            model, plan, torch.Generator(DEVICE).manual_seed(0)))
    g = torch.Generator(DEVICE).manual_seed(3)
    grads = {n: torch.randn(p.shape, generator=g, device=DEVICE)
             for n, p in states[0]["params"].items()}
    hosts = [x["host"] for e in ("master", "mu", "nu")
             for x in states[0][e].values() if is_split(x)]
    if not hosts or not all(h.is_pinned() for h in hosts):
        raise AssertionError("WO/OO 0.5: no split leaf, or an unpinned host "
                             "part")
    for state in states:
        for _ in range(3):
            adam_update(state, grads, AdamConfig())
    split, whole = (train_state_to_numpy(st) for st in states)

    def joined(x):
        return np.concatenate([x["host"], x["dev"]]) if isinstance(x, dict) \
            else x

    n_leaves = 0
    for e in ("params", "master", "mu", "nu"):
        for n, want in whole[e].items():
            n_leaves += 1
            if not np.array_equal(joined(split[e][n]), want):
                raise AssertionError(f"adam_update with WO/OO 0.5 differs "
                                     f"from 0 at {e}/{n}")
    log(f"# adam_update on the card, WO = OO = 0.5 ({len(hosts)} pinned host "
        f"parts) vs 0, 3 steps: {n_leaves} leaves bitwise equal")


def _launcher_run(plan, steps=LAUNCHER_STEPS):
    """The training entry point as a user runs it: ``launch.train.main``
    with ``--layers`` and ``--plan-json``; every count set to 0 just before
    and read just after.  Returns (counts, first and last loss printed,
    the step times in ms it printed)."""
    import contextlib
    import io
    import re

    from repro_torch.launch import train as launch_train

    plan_json = ROOT / "build" / "train_plan.json"
    plan_json.parent.mkdir(parents=True, exist_ok=True)
    plan_json.write_text(plan.to_json())
    argv = ["--arch", "granite-3-8b", "--layers", str(T_LAYERS),
            "--plan-json", str(plan_json), "--steps", str(steps),
            "--seq", str(T_SEQ), "--global-batch", str(T_MICRO * T_ACCUM)]
    out = io.StringIO()
    _reset_counts()
    with contextlib.redirect_stdout(out):
        rc = launch_train.main(argv)
    sync()
    counts = _read_counts()
    text = out.getvalue().strip()
    log(f"# python -m repro_torch.launch.train {' '.join(argv)}: "
        + text.replace("\n", "; "))
    m = re.search(r"loss (\S+) -> (\S+)", text)
    ms = re.search(r"# step ms: (.*)", text)
    if rc != 0 or m is None or ms is None:
        raise AssertionError(f"the training launcher failed: rc {rc}")
    gc.collect()
    torch.cuda.empty_cache()
    return (counts, float(m.group(1)), float(m.group(2)),
            [float(x) for x in ms.group(1).split()])


def _full_width_grads(model, params, micro, ec):
    """One micro-batch's loss and every gradient at full width: the
    kernels (bf16) against the plain versions in bf16, both held leaf by
    leaf to the plain versions in f32 on the same weights (_grads_close).
    Returns the largest ratio of max errors and the largest per-leaf
    ||kernels - plain|| / ||plain||."""
    def loss_and_grads(dtype, impl):
        p = {n: t.detach().to(dtype).requires_grad_(True)
             for n, t in params.items()}
        loss = model.loss_fn(p, micro, ec.replace(compute_dtype=dtype,
                                                  kernel_impl=impl))
        grads = torch.autograd.grad(loss, list(p.values()))
        return float(loss.detach()), dict(zip(p, grads))

    k_loss, kern = loss_and_grads(torch.bfloat16, "kernel")
    p_loss, plain = loss_and_grads(torch.bfloat16, "plain")
    t_loss, truth = loss_and_grads(torch.float32, "plain")
    ratio = rel = 0.0
    for n in kern:
        got, want = kern[n].float(), plain[n].float()
        ratio = max(ratio, _grads_close(got, want, truth[n], n))
        rel = max(rel, float((got - want).norm() / want.norm()))
    log(f"# training, full width, micro-batch 0: loss kernels {k_loss:.6f}, "
        f"plain {p_loss:.6f}, f32 {t_loss:.6f}; {len(kern)} gradients "
        f"within the rule (largest error vs f32 at {ratio:.3f}x the plain "
        f"bf16 run's; largest ||kernels - plain|| / ||plain|| {rel:.3e})")
    if abs(k_loss - p_loss) > TRAIN_LOSS_RTOL * abs(p_loss):
        raise AssertionError(f"micro-batch 0 loss {k_loss} vs {p_loss}")
    return ratio, rel


def phase_train(profile=False):
    """Training granite-3-8b at full width, 8 layers; returns the launch
    counts of one step.  With ``profile``, one more step runs under a
    torch.profiler window (device busy time, idle share, top kernels)."""
    from repro_torch.configs.base import get_arch
    from repro_torch.core.plan import single_stage_plan
    from repro_torch.models.zoo import build_model
    from repro_torch.training.data import BatchSpec, SyntheticLM
    from repro_torch.training.optimizer import AdamConfig, is_split
    from repro_torch.training.step import init_train_state, make_train_step

    full = get_arch("granite-3-8b")
    dims = dict(num_layers=N_LAYERS, d_model=D_MODEL, num_heads=N_HEADS,
                num_kv_heads=N_KV, head_dim=HEAD_DIM, d_ff=12800,
                vocab_size=49155, tie_embeddings=True)
    assert {k: getattr(full, k) for k in dims} == dims
    cfg = full.replace(num_layers=T_LAYERS)
    model = build_model(cfg, DEVICE)
    plan = single_stage_plan(T_LAYERS, dp=1, tp=1, micro_batch=T_MICRO,
                             grad_accum=T_ACCUM, zero=1, ckpt_layers=T_CKPT,
                             wo=0.5, oo=0.5, ao=0.5, attn_impl="pallas",
                             use_pallas=True, remat_policy="full")
    want = _train_launches(T_LAYERS, T_CKPT, T_ACCUM)
    _adam_splits_on_card()

    # the main path: the launcher, at Adam's default lr
    counts, cli_first, cli_last, _ = _launcher_run(plan)
    if counts != {k: LAUNCHER_STEPS * n for k, n in want.items()}:
        raise AssertionError(f"launcher launch counts {counts} != "
                             f"{LAUNCHER_STEPS} x {want}")

    data = SyntheticLM(BatchSpec(global_batch=T_MICRO * T_ACCUM,
                                 seq_len=T_SEQ, vocab_size=cfg.vocab_size))
    batch = {k: torch.from_numpy(v).to(DEVICE)
             for k, v in data.batch(0).items()}
    tokens = batch["tokens"].numel()

    def fresh_state():
        return init_train_state(model, plan,
                                torch.Generator(DEVICE).manual_seed(0))

    # one step with the plain versions, from the state and batch the
    # kernels' first step starts from
    t0 = time.perf_counter()
    state = fresh_state()
    sync()
    params = state["params"]
    n_params = sum(p.numel() for p in params.values())
    n_matmul = sum(p.numel() for n, p in params.items()
                   if not n.endswith("/scale"))
    host_bytes = sum(x["host"].numel() * x["host"].element_size()
                     for e in ("master", "mu", "nu")
                     for x in state[e].values() if is_split(x))
    ec = make_train_step(model, plan).exec_cfg
    log(f"# training granite-3-8b at full width, {T_LAYERS} of {N_LAYERS} "
        f"layers: {n_params / 1e9:.3f} B params; plan ckpt "
        f"{ec.ckpt_layers} (offload {ec.offload_layers}), WO/OO 0.5, "
        f"grad_accum {T_ACCUM} x {T_MICRO} x {T_SEQ}; pinned host state "
        f"{host_bytes / 1e9:.2f} GB; state initialised in "
        f"{time.perf_counter() - t0:.1f} s")
    micro = {k: v[:T_MICRO] for k, v in batch.items()}
    grad_ratio, grad_rel = _full_width_grads(model, params, micro, ec)
    gc.collect()
    torch.cuda.empty_cache()
    adam = AdamConfig(lr=T_LR)
    state, m = make_train_step(model, plan, adam, kernel_impl="plain").fn(
        state, batch)
    plain = {k: float(m[k]) for k in ("loss", "grad_norm")}
    del state, params, m
    gc.collect()
    torch.cuda.empty_cache()

    # the main path, counted step by step: every count set to 0 just
    # before each step and read just after
    state = fresh_state()
    step = make_train_step(model, plan, adam)
    losses, gnorms, times = [], [], []
    sync()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(T_STEPS):
        _reset_counts()
        t0 = time.perf_counter()
        state, m = step.fn(state, batch)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
        launches = _read_counts()
        if launches != want:
            raise AssertionError(f"train step launch counts {launches} != "
                                 f"{want}")
    peak = torch.cuda.max_memory_allocated()
    if profile:
        report = _device_window(lambda: step.fn(state, batch),
                                ROOT / "build" / "profile" / "train" /
                                "trace_step.json")
        log(json.dumps({"profile": {"train_step": report},
                        "model": "granite-3-8b (training)"}))
    log(f"# train steps on one batch: losses {losses}, grad norms {gnorms}; "
        f"plain versions' first step: {plain}; launches per step {launches}")
    del state, m
    gc.collect()
    torch.cuda.empty_cache()

    step_ms = statistics.median(times[1:])
    pairs = T_SEQ * (T_SEQ + 1) // 2
    flops = 6 * n_matmul * tokens \
        + 12 * T_LAYERS * T_MICRO * T_ACCUM * N_HEADS * HEAD_DIM * pairs
    tflops = flops / (step_ms / 1e3) / 1e12
    log(json.dumps({"train": dict(
        model="granite-3-8b", layers=T_LAYERS,
        reduced=f"layers {N_LAYERS} -> {T_LAYERS}",
        tokens_per_step=tokens, step_ms=step_ms, step_ms_all=times,
        tokens_per_s=tokens / (step_ms / 1e3), model_tflops=tflops,
        mfu_989=tflops / 989.0,
        flops_counted="6 * N_matmul * tokens + 12 * L * sequences * H * hd "
                      "* causal pairs (remat recompute not counted)",
        n_params=n_params, n_matmul_params=n_matmul,
        max_memory_allocated=peak, pinned_host_bytes=host_bytes,
        lr=T_LR, losses=losses, grad_norms=gnorms, plain_first_step=plain,
        grads_vs_f32_max_ratio=grad_ratio, grads_rel_vs_plain=grad_rel,
        launcher_losses=[cli_first, cli_last])}))
    if not all(math.isfinite(x) for x in losses + gnorms + [cli_last]):
        raise AssertionError("non-finite loss or grad norm")
    # the launcher's first step starts from the same state and batch
    if abs(cli_first - losses[0]) > LAUNCHER_LOSS_ATOL:
        raise AssertionError(f"launcher's first loss {cli_first} vs "
                             f"{losses[0]}")
    if abs(losses[0] - plain["loss"]) > TRAIN_LOSS_RTOL * abs(plain["loss"]) \
            or abs(gnorms[0] - plain["grad_norm"]) > \
            TRAIN_GNORM_RTOL * plain["grad_norm"]:
        raise AssertionError("first step: kernels vs plain versions differ")
    if not (losses[1] < losses[0] and losses[2] < losses[1]
            and losses[-1] < losses[0]):
        raise AssertionError(f"the loss does not fall: {losses}")

    _train_reduced_vs_cpu()
    return launches


# ---------------------------------------------------------------------------
# phase L: the training loop and its checkpoints
# ---------------------------------------------------------------------------

# granite-3-8b at its published widths, depth cut to 2 layers (599.8 M
# params: a checkpoint of bf16 params and f32 master, mu and nu is ~8.4 GB,
# 2.39 GB of it the pinned host parts), seq 4096, micro-batch 1, G 2, CKPT
# 1 of 2 with AO 0.5, WO = OO = 0.5, Adam at T_LR.  The uninterrupted loop
# runs L_STEPS steps with a checkpoint every L_EVERY (keep 2); the fault
# run fails once at L_FAULT_AT, the NaN run poisons embed/w before
# L_POISON_AT once.  Each check is exact: losses and every leaf of the
# final state bit for bit.
L_LAYERS, L_CKPT, L_STEPS, L_EVERY = 2, 1, 7, 3
L_FAULT_AT, L_POISON_AT = 5, 4


def _l_setup(layers=L_LAYERS):
    from repro_torch.configs.base import get_arch
    from repro_torch.core.plan import single_stage_plan
    from repro_torch.models.zoo import build_model
    from repro_torch.training.checkpoint import StatePlacement
    from repro_torch.training.data import BatchSpec, SyntheticLM
    from repro_torch.training.optimizer import AdamConfig
    from repro_torch.training.step import make_train_step

    cfg = get_arch("granite-3-8b").replace(num_layers=layers)
    model = build_model(cfg, DEVICE)
    plan = single_stage_plan(layers, dp=1, tp=1, micro_batch=T_MICRO,
                             grad_accum=T_ACCUM, zero=1, ckpt_layers=L_CKPT,
                             ao=0.5, wo=0.5, oo=0.5, attn_impl="pallas",
                             use_pallas=True, remat_policy="full")
    step = make_train_step(model, plan, AdamConfig(lr=T_LR))
    data = SyntheticLM(BatchSpec(global_batch=T_MICRO * T_ACCUM,
                                 seq_len=T_SEQ, vocab_size=cfg.vocab_size))
    return cfg, model, plan, step, data, StatePlacement(cfg, plan, None,
                                                        DEVICE)


def _l_fresh(model, plan, seed=0):
    from repro_torch.training.step import init_train_state
    return init_train_state(model, plan,
                            torch.Generator(DEVICE).manual_seed(seed))


def _l_batch(data, i):
    return {k: torch.from_numpy(v).to(DEVICE)
            for k, v in data.batch(i).items()}


def _l_same(got, want) -> list:
    """The leaves of two states (device tensors and pinned host parts)
    that differ in any bit."""
    from repro_torch.training.checkpoint import _flatten
    a, b = _flatten(got), _flatten(want)
    if a.keys() != b.keys():
        return ["<tree>"]
    return [k for k in b if a[k].dtype != b[k].dtype
            or not torch.equal(a[k], b[k])]


def _l_loop(ckdir, setup, per_step, fault_at=None, poison_at=None,
            state=None, start=0):
    """``TrainLoop`` over the main path's step, every count set to 0 just
    before ``run`` and read just after, held to ``per_step`` times the
    steps executed (replays and the poisoned step included).  Returns the
    loop's stats, [(step, loss, start, end)] per executed step (host
    clock), its checkpointer (``saves`` records each save) and the final
    (live) state."""
    from repro_torch.training.loop import LoopConfig, TrainLoop

    cfg, model, plan, step, data, place = setup
    cur, seen, hits = {}, [], []

    def batches(i):
        cur["i"] = i
        return _l_batch(data, i)

    def fn(state, batch):
        t0 = time.perf_counter()
        if cur["i"] == poison_at and not hits:
            hits.append(cur["i"])
            state["params"]["embed/w"].fill_(float("nan"))
        state, m = step.fn(state, batch)
        seen.append((cur["i"], float(m["loss"]), t0, time.perf_counter()))
        return state, m

    def fault(i):
        if i == fault_at and not hits:
            hits.append(i)
            raise RuntimeError("simulated node failure")

    loop = TrainLoop(fn, _l_fresh(model, plan) if state is None else state,
                     batches, ckpt_dir=str(ckdir), place=place,
                     fault_hook=fault, meta={"arch": cfg.name,
                                             "plan": plan.to_json()},
                     cfg=LoopConfig(total_steps=L_STEPS,
                                    ckpt_every=L_EVERY, keep_ckpts=2))
    loop._step = start
    _reset_counts()
    stats = loop.run()
    sync()
    counts = _read_counts()
    want = {k: len(seen) * n for k, n in per_step.items()}
    if counts != want:
        raise AssertionError(f"loop launch counts {counts} != {want} "
                             f"({len(seen)} steps)")
    return stats, seen, loop.ckpt, loop.state


def _l_packed(setup, per_step):
    """One step on a ``PackedCorpus`` batch (documents of 16-4095 tokens
    drawn from seed 0): a finite loss, exact launch counts."""
    import numpy as np

    from repro_torch.training.data import BatchSpec, PackedCorpus

    cfg, model, plan, step, _, _ = setup
    rng = np.random.default_rng(0)
    docs = [rng.integers(1, cfg.vocab_size, size=int(rng.integers(16, 4096)))
            for _ in range(64)]
    corpus = PackedCorpus(docs, BatchSpec(T_MICRO * T_ACCUM, T_SEQ,
                                          cfg.vocab_size), seed=0)
    batch = {k: torch.from_numpy(v).to(DEVICE)
             for k, v in corpus.batch(0).items()}
    state = _l_fresh(model, plan)
    _reset_counts()
    state, m = step.fn(state, batch)
    loss = float(m["loss"])
    sync()
    counts = _read_counts()
    if counts != per_step or not math.isfinite(loss):
        raise AssertionError(f"PackedCorpus step: loss {loss}, counts "
                             f"{counts} != {per_step}")
    return dict(loss=loss, mask_tokens=int(batch["loss_mask"].sum()),
                tokens=batch["tokens"].numel())


def _l_check(name, got, want_losses, want_final, seen, steps, **counts):
    """A run's executed steps, their losses (each equal bit for bit to
    the uninterrupted run's at that step; a NaN allowed only where
    ``counts`` names a rollback) and its final state against (a)'s."""
    stats, final = got
    ran = [i for i, *_ in seen]
    differ = _l_same(final, want_final)
    bad = [(i, x) for i, x, *_ in seen
           if x != want_losses[i] and not (counts.get("rollbacks") and
                                           math.isnan(x))]
    nans = sum(math.isnan(x) for _, x, *_ in seen)
    if ran != steps or differ or bad or any(
            getattr(stats, k) != v for k, v in counts.items()) or \
            nans != counts.get("rollbacks", 0):
        raise AssertionError(f"({name}): steps {ran}, losses off (a)'s "
                             f"{bad}, leaves differ {differ}, stats "
                             f"{stats}")


def phase_loop():
    """Phase L: ``TrainLoop`` with its checkpointer on the main path's
    step (module docstring)."""
    import shutil

    from repro_torch.training.checkpoint import Checkpointer
    from repro_torch.training.loop import TrainLoop

    t_phase = time.perf_counter()
    setup = _l_setup()
    cfg, model, plan, step, data, place = setup
    per_step = _train_launches(L_LAYERS, L_CKPT, T_ACCUM)
    root = ROOT / "build" / "phase_l"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    from repro_torch.core.costmodel_params import meta_params
    n_params = sum(p.numel() for p in meta_params(cfg)[0].values())
    # bf16 params, f32 master, mu and nu, the int32 step
    ck_bytes = n_params * (2 + 3 * 4) + 4
    free = shutil.disk_usage(root).free
    if free < 3 * ck_bytes:
        raise AssertionError(f"phase L needs three checkpoints' worth of "
                             f"disk ({3 * ck_bytes} B) under {root}; "
                             f"{free} B free")
    secs = {}
    replayed = [0, 1, 2, 3, 4, 3, 4, 5, 6]
    try:
        # (a) uninterrupted
        t0 = time.perf_counter()
        a_stats, a_seen, ck, a_final = _l_loop(root / "a", setup, per_step)
        a_saves = list(ck.saves)
        secs["a"] = time.perf_counter() - t0
        losses = {i: x for i, x, *_ in a_seen}
        if [i for i, *_ in a_seen] != list(range(L_STEPS)) or not all(
                math.isfinite(x) for x in losses.values()):
            raise AssertionError(f"(a): steps and losses {a_seen}")
        if Checkpointer(root / "a").all_steps() != [3, 6]:
            raise AssertionError("(a) did not keep the step-3 and step-6 "
                                 "checkpoints")
        on_disk = sum(p.stat().st_size
                      for p in (root / "a" / "step_000000006").iterdir())

        # (d) resume the step-6 checkpoint into a fresh state, one step
        t0 = time.perf_counter()
        live = _l_fresh(model, plan, seed=1)
        at, state, _ = TrainLoop.resume(root / "a", place, into=live)
        sync()
        secs["d_restore"] = time.perf_counter() - t0
        if at != 6 or state is not live:
            raise AssertionError(f"(d): resumed at {at}")
        _reset_counts()
        state, m = step.fn(state, _l_batch(data, 6))
        d_loss = float(m["loss"])
        sync()
        d_counts = _read_counts()
        differ = _l_same(state, a_final)
        if d_loss != losses[6] or differ or d_counts != per_step:
            raise AssertionError(f"(d): loss {d_loss} vs {losses[6]}, "
                                 f"leaves differ {differ}, counts "
                                 f"{d_counts}")
        # a step while a save's background write is in flight, against
        # one after it ((a)'s writes may end inside a rollback snapshot),
        # with (a)'s checkpointer, whose snapshot buffer is warm
        batch = _l_batch(data, 6)
        ck.save_async(100, state, place=place)
        t0 = time.perf_counter()
        state, m = step.fn(state, batch)
        float(m["loss"])
        t1 = time.perf_counter()
        ck.wait()
        sv = ck.saves[-1]
        extra = dict(snapshot_s=sv["snapshot_s"],
                     write_s=sv["write_end"] - sv["write_start"],
                     step_ms=(t1 - t0) * 1e3,
                     step_inside_write=sv["write_start"] <= t0
                     and t1 <= sv["write_end"])
        t0 = time.perf_counter()
        state, m = step.fn(state, batch)
        float(m["loss"])
        extra["step_ms_after"] = (time.perf_counter() - t0) * 1e3
        del state, live, m, ck
        shutil.rmtree(root / "a")
        gc.collect()
        torch.cuda.empty_cache()

        # (b) a fault at step 5: restart from the step-3 checkpoint
        t0 = time.perf_counter()
        b_stats, b_seen, _, b_final = _l_loop(root / "b", setup, per_step,
                                              fault_at=L_FAULT_AT)
        secs["b"] = time.perf_counter() - t0
        shutil.rmtree(root / "b")
        _l_check("b", (b_stats, b_final), losses, a_final, b_seen,
                 replayed, restarts=1, rollbacks=0)
        del b_final
        gc.collect()
        torch.cuda.empty_cache()

        # (c) embed/w poisoned with NaN before step 4: roll back to the
        # snapshot taken before step 3
        t0 = time.perf_counter()
        c_stats, c_seen, _, c_final = _l_loop(root / "c", setup, per_step,
                                              poison_at=L_POISON_AT)
        secs["c"] = time.perf_counter() - t0
        shutil.rmtree(root / "c")
        _l_check("c", (c_stats, c_final), losses, a_final, c_seen,
                 replayed, rollbacks=1, restarts=0)
        if not math.isnan(c_seen[4][1]):
            raise AssertionError(f"(c): step 4 ran from a clean state")
        del c_final, a_final
        gc.collect()
        torch.cuda.empty_cache()

        # (e) a PackedCorpus batch
        packed = _l_packed(setup, per_step)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    secs["phase"] = time.perf_counter() - t_phase

    # (a)'s costs: each save's blocking snapshot and background write;
    # the steps that ran while a write was in flight against those with
    # neither a write nor a rollback snapshot
    def in_flight(t0, t1):
        return any(sv["write_start"] <= t0 and t1 <= sv["write_end"]
                   for sv in a_saves)

    snapped = {i for i in range(L_STEPS) if i % L_EVERY == 0}
    during = [(t1 - t0) * 1e3 for i, _, t0, t1 in a_seen
              if i not in snapped and in_flight(t0, t1)]
    clear = [(t1 - t0) * 1e3 for i, _, t0, t1 in a_seen
             if i not in snapped and not in_flight(t0, t1)]
    saves = [dict(step=sv["step"], snapshot_s=sv["snapshot_s"],
                  write_s=sv["write_end"] - sv["write_start"],
                  write_gb_per_s=sv["bytes"] / (sv["write_end"]
                                                - sv["write_start"]) / 1e9)
             for sv in a_saves]
    log(json.dumps({"loop": dict(
        model="granite-3-8b", layers=L_LAYERS,
        reduced=f"layers {N_LAYERS} -> {L_LAYERS}", n_params=n_params,
        plan=json.loads(plan.to_json()), steps=L_STEPS, ckpt_every=L_EVERY,
        launches_per_step=per_step, checkpoint_bytes=ck_bytes,
        checkpoint_bytes_on_disk=on_disk, disk_free_bytes=free,
        saves=saves, save_beside_a_step=extra,
        restore_in_place_s=secs["d_restore"],
        step_ms_with_write_in_flight=during,
        step_ms_without_write_or_snapshot=clear,
        rollback_snapshot_s=a_stats.snapshot_times,
        rollback_snapshot_bytes=a_stats.snapshot_bytes,
        a_step_ms=[x * 1e3 for x in a_stats.step_times],
        a_losses=[losses[i] for i in range(L_STEPS)],
        a_straggler_events=a_stats.straggler_events,
        b=dict(restarts=b_stats.restarts, steps=[i for i, *_ in b_seen]),
        c=dict(rollbacks=c_stats.rollbacks, steps=[i for i, *_ in c_seen]),
        d=dict(resumed_at=at, loss=d_loss), e_packed=packed, seconds=secs,
        smi=smi_line())}))
    _loop_multi_card()
    _first_step_split(L_LAYERS)


# the elastic restore through NCCL, one process per rank (argv: src, the
# case, the checkpoint directory, the device type): the reduced config
# saved under one plan, restored into a fresh state of another on the same
# world, then one step; rank 0 prints the loss
_L_ELASTIC = r"""
import json
import sys
sys.path.insert(0, sys.argv[1])
import torch
import torch.distributed as dist
from repro_torch.configs.base import get_arch
from repro_torch.core.plan import Plan, StageConfig, single_stage_plan
from repro_torch.launch.mesh import init_distributed, make_plan_mesh
from repro_torch.models.zoo import build_model
from repro_torch.training.checkpoint import Checkpointer, StatePlacement
from repro_torch.training.data import BatchSpec, SyntheticLM
from repro_torch.training.loop import TrainLoop
from repro_torch.training.step import init_sharded_state, make_train_step

case, ckdir, kind = sys.argv[2], sys.argv[3], sys.argv[4]
rank, world, dev = init_distributed(kind)
cfg = get_arch("granite-3-8b").reduced()
model = build_model(cfg, dev)
GBS = 8


def single(dp, tp, zero=1, sp=False):
    return single_stage_plan(cfg.num_layers, dp=dp, tp=tp,
                             micro_batch=GBS // (2 * dp), grad_accum=2,
                             zero=zero, attn_impl="pallas", use_pallas=True,
                             sequence_parallel=sp)


def piped(S, dp):
    return Plan(grad_accum=2, attn_impl="pallas", use_pallas=True,
                stages=tuple(StageConfig(layers=cfg.num_layers // S,
                                         micro_batch=GBS // (2 * dp), dp=dp,
                                         tp=1, zero=1, ckpt_layers=0)
                             for _ in range(S)))


PLANS = {"dp2_z1": single(2, 1), "tp2_sp": single(1, 2, sp=True),
         "s2_dp2": piped(2, 2), "dp4_z2": single(4, 1, zero=2),
         "one": single(1, 1)}
src, dst = case.split("->")


def mesh_of(plan):
    st = plan.stages[0]
    return make_plan_mesh(st.dp, st.tp, kind, plan.num_stages)


def step_of(plan, mesh):
    if plan.num_stages > 1:
        from repro_torch.parallel.pipeline import make_pipeline_train_step
        return make_pipeline_train_step(model, plan, mesh).fn
    return make_train_step(model, plan, mesh=mesh).fn


data = SyntheticLM(BatchSpec(GBS, 128, cfg.vocab_size))
batch = [{k: torch.from_numpy(v).to(dev) for k, v in data.batch(i).items()}
         for i in range(2)]
losses = []
for name, i in ((src, 0), (dst, 1)):
    plan = PLANS[name]
    mesh = mesh_of(plan)
    place = StatePlacement(cfg, plan, mesh, dev)
    gen = torch.Generator(dev).manual_seed(i)
    state = init_sharded_state(model, plan, mesh, gen)
    if i == 1:
        at, state, _ = TrainLoop.resume(ckdir, place, into=state)
        assert at == 1, at
    state, m = step_of(plan, mesh)(state, batch[i])
    losses.append(float(m["loss"]))
    if i == 0:
        Checkpointer(ckdir).save(1, state, place=place)
        dist.barrier()
if rank == 0:
    print(json.dumps({"elastic": case, "losses": losses}), flush=True)
dist.destroy_process_group()
"""


def _l_elastic(case, world, kind="cuda"):
    """``_L_ELASTIC`` on ``world`` ranks (one process each, as torchrun
    starts them); returns rank 0's losses (saved plan's step, restored
    plan's step)."""
    import shutil
    import socket
    ckdir = ROOT / "build" / "phase_l_elastic"
    shutil.rmtree(ckdir, ignore_errors=True)
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    procs = []
    for r in range(world):
        env = {**os.environ, "RANK": str(r), "WORLD_SIZE": str(world),
               "LOCAL_RANK": str(r), "MASTER_ADDR": "localhost",
               "MASTER_PORT": str(port)}
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _L_ELASTIC, str(ROOT / "src"), case,
             str(ckdir), kind], env=env, cwd=ROOT, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    shutil.rmtree(ckdir, ignore_errors=True)
    if any(p.returncode for p in procs):
        raise AssertionError(f"elastic {case}: a rank failed:\n"
                             + "\n".join(e[-3000:] for _, e in outs))
    line = [x for x in outs[0][0].splitlines() if x.startswith('{"elastic"')]
    return json.loads(line[-1])["losses"]


def _loop_multi_card(kind="cuda"):
    """With two or more cards: the reduced config saved at dp 2 ZeRO 1
    through NCCL and restored at tp 2 with SP, one step, its loss within
    REDUCED_LOSS_RTOL of one card's (the same save and restore on a world
    of one); with four or more, also S 2 x dp 2 -> dp 4 ZeRO 2."""
    n = torch.cuda.device_count() if kind == "cuda" else 4
    if n < 2:
        log(f"multi_card: not run ({n} visible)")
        return
    want = _l_elastic("one->one", 1, kind)
    cases = [("dp2_z1->tp2_sp", 2)] + ([("s2_dp2->dp4_z2", 4)]
                                       if n >= 4 else [])
    for case, world in cases:
        got = _l_elastic(case, world, kind)
        ok = all(abs(a - b) <= REDUCED_LOSS_RTOL * abs(b)
                 for a, b in zip(got, want))
        log(json.dumps({"multi_card": dict(phase="L", case=case,
                                           losses=got, one_card=want,
                                           ok=ok)}))
        if not ok:
            raise AssertionError(f"multi_card {case}: losses off one "
                                 "card's")
    if n < 4:
        log(f"multi_card: S 2 x dp 2 -> dp 4 ZeRO 2 not run ({n} visible)")


# the launcher's first step, taken apart in a fresh process (argv: src,
# layers, seq): each set-up the launcher's first step meets is done and
# timed on its own, at phase T's plan; then four steps
_FIRST_STEP = r"""
import json
import sys
import time
t0 = time.perf_counter()
sys.path.insert(0, sys.argv[1])
import torch
from repro_torch.configs.base import get_arch
from repro_torch.core.plan import single_stage_plan
from repro_torch.models.zoo import build_model
from repro_torch.training.checkpoint import host_snapshot
from repro_torch.training.data import BatchSpec, SyntheticLM
from repro_torch.training.optimizer import is_split
from repro_torch.training.step import init_train_state, make_train_step
out = {"import_s": time.perf_counter() - t0}


def timed(name, fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    out[name] = time.perf_counter() - t
    return r


layers, seq = int(sys.argv[2]), int(sys.argv[3])
timed("cuda_context_s", lambda: torch.zeros(1, device="cuda"))
cfg = get_arch("granite-3-8b").replace(num_layers=layers)
model = build_model(cfg, "cuda")
plan = single_stage_plan(layers, dp=1, tp=1, micro_batch=1, grad_accum=2,
                         zero=1, ckpt_layers=min(6, layers), ao=0.5, wo=0.5,
                         oo=0.5, attn_impl="pallas", use_pallas=True,
                         remat_policy="full")
state = timed("init_state_s", lambda: init_train_state(
    model, plan, torch.Generator("cuda").manual_seed(0)))
host = sum(x["host"].numel() * 4 for e in ("master", "mu", "nu")
           for x in state[e].values() if is_split(x))
out["pinned_host_bytes"] = host
pinned = timed("pinned_alloc_s", lambda: torch.empty(host // 4,
                                                     pin_memory=True))
del pinned
snap = timed("rollback_snapshot_s", lambda: host_snapshot(state))
del snap
from repro_torch.kernels import _build
timed("kernel_library_load_s", _build.load_library)
a = torch.randn(4096, 4096, dtype=torch.bfloat16, device="cuda")
timed("cublas_first_gemm_s", lambda: a @ a)
timed("cublas_second_gemm_s", lambda: a @ a)
del a
# torch.utils.checkpoint's first call imports torch._dynamo (through its
# disable-dynamo wrapper), ~830 modules
import importlib
timed("torch_dynamo_import_s", lambda: importlib.import_module("torch._dynamo"))
step = make_train_step(model, plan)
data = SyntheticLM(BatchSpec(2, seq, cfg.vocab_size))
batch = {k: torch.from_numpy(v).cuda() for k, v in data.batch(0).items()}
steps = []
for i in range(4):
    if i == 3:
        torch.cuda.empty_cache()
    state, m = timed("step", lambda: step.fn(state, batch))
    steps.append(out.pop("step"))
out["steps_s"] = steps
out["note"] = "steps 1-3 in a row; step 4 after empty_cache"
print(json.dumps({"first_step_split": out}), flush=True)
"""


def _first_step_split(layers):
    """``_FIRST_STEP`` in a fresh process at phase T's plan, its depth cut to
    ``layers``: what the launcher's first step pays once, split."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", _FIRST_STEP, str(ROOT / "src"),
                        str(layers), str(T_SEQ)], capture_output=True,
                       text=True, timeout=600, cwd=ROOT)
    if r.returncode != 0:
        raise AssertionError(f"first-step split failed:\n{r.stderr[-3000:]}")
    line = [x for x in r.stdout.splitlines()
            if x.startswith('{"first_step_split"')][-1]
    rep = json.loads(line)
    rep["first_step_split"].update(layers=layers, seq=T_SEQ,
                                   process_s=time.perf_counter() - t0,
                                   smi=smi_line())
    log(json.dumps(rep))


# ---------------------------------------------------------------------------
# phase U: tune then execute
# ---------------------------------------------------------------------------


def _tape_grid(rows, seed=0):
    """A seeded grid of stage-model candidates (every symbol bound)."""
    import numpy as np
    rng = np.random.default_rng(seed)

    def pick(vals):
        return np.asarray(rng.choice(vals, rows), np.float64)
    ratios = [i / 8 for i in range(9)]
    return {"b": pick([1, 2, 4, 8]), "dp": pick([1, 2, 4, 8]),
            "tp": pick([1, 2, 4, 8]), "zero": pick([0, 1, 2, 3]),
            "ckpt": pick(range(T_LAYERS + 1)), "wo": pick(ratios),
            "go": pick(ratios), "oo": pick(ratios), "ao": pick(ratios),
            "L": float(T_LAYERS), "G": 2.0, "inflight": 1.0}


def _bitwise(got, want) -> bool:
    """float64 bits equal (NaN positions equal; NaN payloads not compared)."""
    import numpy as np
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        return False
    ng, nw = np.isnan(got), np.isnan(want)
    return bool(np.array_equal(ng, nw)) and bool(np.array_equal(
        got[~ng].view(np.int64), want[~nw].view(np.int64)))


def _tape_differential():
    """The stage cost model's memory and time tapes (granite-3-8b, seq
    T_SEQ) on numpy and as float64 torch ops on the card, TAPE_ROWS rows
    each: every output bitwise equal; rows per second of both (the card's
    including the copies in and out, as the backend runs them).  Also a
    tape of the ops the stage tapes lack (sqrt, max/min on signed zeros,
    rint on halves).  Returns the smallest row count at which the card
    was faster (the "auto" crossover), or None."""
    import numpy as np
    from repro_torch.configs.base import get_arch
    from repro_torch.core import symbolic as S
    from repro_torch.core.costmodel import StageCostModel

    rng = np.random.default_rng(7)
    x = rng.uniform(-8, 8, 1 << 20)
    x[::5] = np.round(x[::5] * 2) / 2
    x[::9] = -0.0
    y = np.where(np.arange(x.size) % 3 == 0, 0.0, rng.uniform(-8, 8, x.size))
    a, b = S.Sym("x"), S.Sym("y")
    odd = S.compile_tape({
        "sqrt": S.UnOp("sqrt", S.UnOp("abs", a)), "max": S.smax(a, b),
        "min": S.smin(b, a), "rint": S.rint(a), "div": a / (b + 0.25),
        "floor": S.UnOp("floor", a * 3.0), "cmp": (a >= b) * S.ceil(a)})
    want = odd.run({"x": x, "y": y})
    got = odd.lower_torch(DEVICE)({"x": x, "y": y})
    bad = [k for k in want if not _bitwise(got[k].cpu().numpy(), want[k])]
    if bad:
        raise AssertionError(f"torch tape ops on the card differ from "
                             f"numpy: {bad}")
    log(f"# tape ops on the card (sqrt, max/min with signed zeros, rint, "
        f"div, floor, compare) over {x.size} rows: bitwise equal to numpy")

    scm = StageCostModel(get_arch("granite-3-8b"), T_SEQ)
    rows_out, crossover = [], None
    for rows in TAPE_ROWS:
        e = scm._env(_tape_grid(rows))
        t_np = t_card = 0.0
        for tape in (scm.tape_mem, scm.tape_time):
            run = tape.lower_torch(DEVICE)
            run(e)                                     # warm-up
            sync()
            best_np = best_card = float("inf")
            for _ in range(2):
                t0 = time.perf_counter()
                want = tape.run(e, scm._scratch[id(tape)])
                best_np = min(best_np, time.perf_counter() - t0)
                t0 = time.perf_counter()
                got = {k: v.cpu().numpy() for k, v in run(e).items()}
                best_card = min(best_card, time.perf_counter() - t0)
            bad = [k for k in want if not _bitwise(got[k], want[k])]
            if bad:
                raise AssertionError(f"{rows} rows: card tape outputs "
                                     f"differ from numpy: {bad}")
            t_np += best_np
            t_card += best_card
        rows_out.append(dict(rows=rows, numpy_rows_per_s=rows / t_np,
                             card_rows_per_s=rows / t_card,
                             numpy_ms=t_np * 1e3, card_ms=t_card * 1e3))
        if crossover is None and t_card < t_np:
            crossover = rows
    log(json.dumps({"tape_backends": dict(
        model="granite-3-8b", seq=T_SEQ,
        tapes={"memory": len(scm.tape_mem), "time": len(scm.tape_time)},
        rows=rows_out, crossover_rows=crossover,
        bitwise_equal=True)}))
    return crossover


def _serve_tuned():
    """``launch.serve --tune`` for granite-3-8b at full width (BATCH
    prompts of PROMPT_LEN, GEN tokens): the tuned plan must be dp = tp = 1
    and ``generate`` must launch exactly phase 3's counts."""
    import contextlib
    import io

    from repro_torch.configs.base import get_arch
    from repro_torch.launch import serve as launch_serve

    argv = ["--arch", "granite-3-8b", "--tune", "--batch", str(BATCH),
            "--prompt-len", str(PROMPT_LEN), "--gen", str(GEN)]
    out = io.StringIO()
    _reset_counts()
    with contextlib.redirect_stdout(out):
        rc = launch_serve.main(argv)
    sync()
    counts = _read_counts()
    text = out.getvalue()
    plan = json.loads(text[text.index("\n{") + 1:text.index("\n}\n") + 2])
    log(f"# python -m repro_torch.launch.serve {' '.join(argv)}: "
        + " ".join(ln for ln in text.splitlines() if ln.startswith(
            ("#", "generated"))) + f"; launches {counts}")
    gc.collect()
    torch.cuda.empty_cache()
    if rc != 0:
        raise AssertionError(f"serve --tune failed: rc {rc}")
    if "(bitwise=True)" not in text:
        raise AssertionError("serve --tune: predicted serve memory != "
                             "lowered")
    if [(s["dp"], s["tp"]) for s in plan["stages"]] != [(1, 1)]:
        raise AssertionError(f"tuned serve plan is not dp = tp = 1: {plan}")
    want = _granite_launches(get_arch("granite-3-8b"))
    if counts != want:
        raise AssertionError(f"serve --tune launch counts {counts} != "
                             f"{want}")
    return plan


def phase_tune_then_execute():
    """The main path's first half on the card: the port's tuner for one
    H100 (the tapes on numpy and on the card, bitwise), the tuned plan
    trained through the launcher with exact launch counts, and
    ``serve --tune``."""
    import dataclasses

    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.core import costmodel as CM
    from repro_torch.core.hardware import H100
    from repro_torch.core.tuner import MistTuner, TuneSpec
    from repro_torch.lowering import check_train_plan

    t_phase = time.perf_counter()
    total = torch.cuda.get_device_properties(0).total_memory
    log(json.dumps({"tuner_hw": dataclasses.asdict(H100),
                    "device_total_memory": total, "smi": smi_line()}))
    crossover = _tape_differential()
    log(f"# tape backends: the card overtakes numpy at {crossover} rows; "
        f"the port's auto threshold is {CM.TORCH_AUTO_THRESHOLD}")

    full = get_arch("granite-3-8b")
    cfg = full.replace(num_layers=T_LAYERS)
    spec = TuneSpec(arch=cfg, seq_len=T_SEQ, global_batch=T_MICRO * T_ACCUM,
                    n_devices=1, space="mist")
    reps, secs, runs = {}, {}, {}
    for backend in ("numpy", "torch"):
        CM.TAPE_RUNS.update(numpy=0, torch=0)
        t0 = time.perf_counter()
        reps[backend] = MistTuner(dataclasses.replace(
            spec, backend=backend)).tune()
        secs[backend] = time.perf_counter() - t0
        runs[backend] = dict(CM.TAPE_RUNS)
        log(f"# tune granite-3-8b, {T_LAYERS} layers, seq {T_SEQ}, global "
            f"batch {spec.global_batch}, 1 H100, backend {backend}: "
            f"{secs[backend]:.3f} s, tape runs {runs[backend]}")
    rep, rep_t = reps["numpy"], reps["torch"]
    if rep.plan is None:
        raise AssertionError(f"{T_LAYERS} layers infeasible on one H100")
    if runs["torch"]["torch"] == 0 or runs["torch"]["numpy"] \
            or rep_t.plan.to_json() != rep.plan.to_json() \
            or rep_t.objective != rep.objective:
        raise AssertionError("backend torch: no tape ran on the card, or "
                             "its plan differs from numpy's")
    t0 = time.perf_counter()
    rep40 = MistTuner(dataclasses.replace(spec, arch=full)).tune()
    secs["40_layers"] = time.perf_counter() - t0
    if not rep40.infeasible:
        raise AssertionError("40 layers should not fit one H100")
    # the fork pool after CUDA is initialised: a multi-unit workload (8
    # devices, S in {1, 2}) at one and two workers
    multi = TuneSpec(arch=full, seq_len=2048, global_batch=16, n_devices=8,
                     stage_counts=(1, 2), grad_accums=(2, 4))
    t0 = time.perf_counter()
    serial = MistTuner(multi).tune()
    forked = MistTuner(dataclasses.replace(multi, workers=2)).tune()
    secs["8_devices_w1_w2"] = time.perf_counter() - t0
    if forked.workers != 2 or forked.plan.to_json() != serial.plan.to_json():
        raise AssertionError("the fork pool's plan differs, or no fork")
    log(f"# 40 layers on one H100: infeasible ({secs['40_layers']:.3f} s); "
        f"8 H100s, 2 forked workers after CUDA init: the serial plan "
        f"({secs['8_devices_w1_w2']:.3f} s for both)")
    log(rep.plan.to_json().replace("\n", " "))

    # execute the tuned knobs with the attention the cost model priced
    plan = rep.plan.replace(attn_impl="pallas", use_pallas=True)
    check_train_plan(plan)
    st = plan.stages[0]
    log(f"# the tuned plan reads attn_impl {rep.plan.attn_impl!r}: the "
        f"tuner switches it only for non-default kernel tiles, while its "
        f"activation term prices flash attention (O(1) softmax stats, no "
        f"S x S scores); the phase runs attn_impl 'pallas', the attention "
        f"that was priced")
    want = _train_launches(T_LAYERS, min(st.ckpt_layers, T_LAYERS),
                           plan.grad_accum)
    if st.micro_batch * plan.grad_accum != T_MICRO * T_ACCUM:
        raise AssertionError("the tuned plan's global batch differs")
    torch.cuda.reset_peak_memory_stats()
    counts, first, last, step_ms = _launcher_run(plan, TUNED_STEPS)
    peak = torch.cuda.max_memory_allocated()
    if counts != {k: TUNED_STEPS * n for k, n in want.items()}:
        raise AssertionError(f"tuned plan launch counts {counts} != "
                             f"{TUNED_STEPS} x {want}")
    if not (math.isfinite(first) and math.isfinite(last)):
        raise AssertionError(f"tuned plan loss not finite: {first}, {last}")
    est = CM.estimate_plan(cfg, ShapeConfig("t", T_SEQ, spec.global_batch,
                                            "train"), rep.plan)
    measured = statistics.median(step_ms[1:])
    U_STEP_MS["default"] = measured
    t0 = time.perf_counter()
    plan_s = _serve_tuned()
    secs["serve_tune_and_generate"] = time.perf_counter() - t0
    secs["phase"] = time.perf_counter() - t_phase
    log(json.dumps({"tune_then_execute": dict(
        model="granite-3-8b", layers=T_LAYERS, seq=T_SEQ,
        global_batch=spec.global_batch, hw=H100.name,
        seconds=secs, plan=json.loads(rep.plan.to_json()),
        executed_attn_impl=plan.attn_impl, launches=counts,
        predicted_step_s=rep.objective, measured_step_ms=measured,
        measured_step_ms_all=step_ms, predicted_peak_bytes=est[
            "mem_peak_max"], max_memory_allocated=peak,
        predicted_over_measured_step=rep.objective * 1e3 / measured,
        predicted_over_measured_peak=est["mem_peak_max"] / peak,
        losses=[first, last], serve_plan=plan_s)}))
    return plan


# ---------------------------------------------------------------------------
# phase C: calibration
# ---------------------------------------------------------------------------


def _calibrate_through_launcher(profile_path):
    """``launch.train.main --calibrate`` for granite-3-8b at the training
    widths: returns (exit code, printed table, ``run_calibration``'s
    report, launch counts per cell).  Each cell's counts are set to 0 just
    before the cell runs and read just after (a spy around
    ``measure_plan``, which ``measure_cells`` calls once per cell); the
    report is ``run_calibration``'s return value (a spy around it)."""
    import contextlib
    import io

    from repro_torch.calibration import driver as DRV
    from repro_torch.calibration import measure as MEAS
    from repro_torch.launch import train as launch_train

    argv = ["--arch", "granite-3-8b", "--calibrate", "--layers",
            str(T_LAYERS), "--seq", str(T_SEQ), "--steps", str(C_STEPS),
            "--calibration-out", str(profile_path)]
    cell_counts, reports = {}, []
    real_measure, real_run = MEAS.measure_plan, DRV.run_calibration

    def measure_spy(cfg, shape, plan, **kw):
        _reset_counts()
        try:
            return real_measure(cfg, shape, plan, **kw)
        finally:
            sync()
            cell_counts[shape.name] = _read_counts()

    def run_spy(**kw):
        reports.append(real_run(**kw))
        return reports[-1]

    MEAS.measure_plan, DRV.run_calibration = measure_spy, run_spy
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = launch_train.main(argv)
    finally:
        MEAS.measure_plan, DRV.run_calibration = real_measure, real_run
    text = out.getvalue().strip()
    log(f"# python -m repro_torch.launch.train {' '.join(argv)}:\n{text}")
    gc.collect()
    torch.cuda.empty_cache()
    if len(reports) != 1:
        raise AssertionError("the launcher did not run run_calibration "
                             "once")
    return rc, text, reports[0], cell_counts


def phase_calibrate():
    """The reference's calibration loop on the card: measure granite's
    cells through ``train --calibrate``, fit a cuda profile, re-tune with
    it and run the tuned plan; the plan's predicted memory against its
    lowering and the allocator."""
    import dataclasses

    from repro_torch.calibration.profile import CalibrationProfile
    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.core import costmodel as CM
    from repro_torch.core.tuner import MistTuner, TuneSpec
    from repro_torch.lowering import memory_consistency

    t_phase = time.perf_counter()
    secs = {}
    profile_path = ROOT / "build" / "calibration" / "phase_c_cuda.json"
    if profile_path.exists():
        profile_path.unlink()
    t0 = time.perf_counter()
    rc, text, report, cell_counts = _calibrate_through_launcher(profile_path)
    secs["calibrate"] = time.perf_counter() - t0
    if rc != 0 or report.get("error"):
        raise AssertionError(f"train --calibrate failed: rc {rc}, "
                             f"{report.get('error')}")
    if report["skipped_cells"]:
        raise AssertionError(f"calibration cells skipped: "
                             f"{report['skipped_cells']}")
    labels = [c["label"] for c in report["measured_cells"]]
    if labels != ["granite-3-8b/dp1_z0", "granite-3-8b/dp1_z2_ckpt"]:
        raise AssertionError(f"calibration cells {labels}")
    runs = C_WARMUP + C_STEPS
    cells = []
    for doc, row in zip(report["measured_cells"], report["cells"]):
        plan = doc["plan"]
        st = plan["stages"][0]
        if plan["attn_impl"] != "pallas" or st["layers"] != T_LAYERS:
            raise AssertionError(f"{doc['label']}: plan {plan}")
        want = _train_launches(T_LAYERS, min(st["ckpt_layers"], T_LAYERS),
                               plan["grad_accum"])
        got = cell_counts[doc["label"].split("/")[1]]
        if got != {k: runs * n for k, n in want.items()}:
            raise AssertionError(f"{doc['label']}: launch counts {got} != "
                                 f"{runs} x {want}")
        mem = doc["memory"]
        cells.append(dict(
            label=doc["label"], launches_per_step=want,
            measured_step_ms=doc["t_measured"] * 1e3,
            step_ms_all=[t * 1e3 for t in doc["step_seconds"]],
            predicted_uncalibrated_ms=row["t_pred_uncalibrated"] * 1e3,
            predicted_fitted_ms=row["t_pred_fitted"] * 1e3,
            err_uncalibrated=row["err_uncalibrated"],
            err_fitted=row["err_fitted"],
            modeled_peak_bytes=mem["modeled_peak_bytes"],
            allocator_peak_bytes=mem["allocator_peak_bytes"],
            allocator_over_modeled=(mem["allocator_peak_bytes"]
                                    / mem["modeled_peak_bytes"])))
    if not report["mean_err_fitted"] <= report["mean_err_uncalibrated"]:
        raise AssertionError("the fitted profile predicts worse than the "
                             "uncalibrated model")

    # the written profile: a cuda profile that round-trips
    prof = CalibrationProfile.load(profile_path)
    if prof.platform != "cuda" or prof.to_doc() != report["profile"] or \
            CalibrationProfile.from_json(prof.to_json()) != prof:
        raise AssertionError(f"the written profile does not round-trip: "
                             f"{prof.to_doc()} vs {report['profile']}")

    # re-tune with the profile and run the tuned plan (as phase U)
    cfg = get_arch("granite-3-8b").replace(num_layers=T_LAYERS)
    gbs = T_MICRO * T_ACCUM
    shape = ShapeConfig("t", T_SEQ, gbs, "train")
    spec = TuneSpec(arch=cfg, seq_len=T_SEQ, global_batch=gbs, n_devices=1,
                    space="mist", profile=prof)
    t0 = time.perf_counter()
    rep = MistTuner(spec).tune()
    uncal = MistTuner(dataclasses.replace(spec, profile=None)).tune()
    secs["tune_with_and_without"] = time.perf_counter() - t0
    if rep.plan is None:
        raise AssertionError("no feasible plan with the fitted profile")
    plan = rep.plan.replace(attn_impl="pallas", use_pallas=True)
    st = plan.stages[0]
    if st.micro_batch * plan.grad_accum != gbs:
        raise AssertionError("the tuned plan's global batch differs")
    want = _train_launches(T_LAYERS, min(st.ckpt_layers, T_LAYERS),
                           plan.grad_accum)
    torch.cuda.reset_peak_memory_stats()
    counts, first, last, step_ms = _launcher_run(plan, TUNED_STEPS)
    peak = torch.cuda.max_memory_allocated()
    if counts != {k: TUNED_STEPS * n for k, n in want.items()}:
        raise AssertionError(f"calibrated plan launch counts {counts} != "
                             f"{TUNED_STEPS} x {want}")
    if not (math.isfinite(first) and math.isfinite(last)):
        raise AssertionError(f"calibrated plan loss not finite: {first}, "
                             f"{last}")
    measured = statistics.median(step_ms[1:])
    t_cal = CM.estimate_plan(cfg, shape, rep.plan, profile=prof)["t_step"]
    t_uncal = CM.estimate_plan(cfg, shape, rep.plan)["t_step"]
    mc = memory_consistency(cfg, shape, rep.plan)
    if mc["predicted_bytes"] != mc["lowered_bytes"]:
        raise AssertionError(f"predicted memory {mc['predicted_bytes']} != "
                             f"lowered {mc['lowered_bytes']}")
    log(f"# memory of the calibrated plan: predicted "
        f"{mc['predicted_bytes'] / 2**30:.2f} GiB, lowered "
        f"{mc['lowered_bytes'] / 2**30:.2f} GiB (bitwise equal), allocator "
        f"peak {peak / 2**30:.2f} GiB")
    secs["phase"] = time.perf_counter() - t_phase
    log(json.dumps({"calibration": dict(
        model="granite-3-8b", layers=T_LAYERS, seq=T_SEQ, smi=smi_line(),
        seconds=secs, cells=cells, scales=report["scales"],
        interference_refit=report["interference_refit"],
        interference_samples=report["interference_samples"],
        mean_err_uncalibrated=report["mean_err_uncalibrated"],
        mean_err_fitted=report["mean_err_fitted"],
        skipped_cells=report["skipped_cells"], profile=report["profile"],
        tuned_plan=json.loads(rep.plan.to_json()),
        uncalibrated_tuned_plan=json.loads(uncal.plan.to_json()),
        launches=counts, measured_step_ms=measured,
        measured_step_ms_all=step_ms,
        predicted_calibrated_s=t_cal, predicted_uncalibrated_s=t_uncal,
        calibrated_over_measured=t_cal * 1e3 / measured,
        uncalibrated_over_measured=t_uncal * 1e3 / measured,
        predicted_peak_bytes=mc["predicted_bytes"],
        lowered_peak_bytes=mc["lowered_bytes"],
        max_memory_allocated=peak, losses=[first, last])}))


# ---------------------------------------------------------------------------
# phase K: the Hopper tile menu
# ---------------------------------------------------------------------------

# phase U's measured step (ms, median after the first) of the tuned plan at
# the default kernel tuple: phase K's launched tuple runs beside it
U_STEP_MS = {}

# phase K's shapes: granite's one-card training shape (hd 128), zamba2's
# (hd 80; its SSD at H 80, P = N = 64), the tp-8 pipeline stage rank's (B 2,
# H 4, KV 1: the shape where the flash backward loses to SDPA)
K_FLASH_SHAPES = (
    ("granite-3-8b (training)", (T_MICRO, T_SEQ, N_HEADS, N_KV, HEAD_DIM)),
    ("zamba2-2.7b (training)", (H_MICRO, H_SEQ, Z_HEADS, Z_HEADS,
                                Z_HEAD_DIM)),
    ("granite-3-8b (tp-8 pipeline stage rank, training)",
     (P_BATCH, T_SEQ, P_HEADS, P_KV, HEAD_DIM)))
K_RMS_WIDTHS = ((T_MICRO * T_SEQ, D_MODEL), (H_MICRO * H_SEQ, Z_D_MODEL))
K_SSD_SHAPE = (H_MICRO, H_SEQ, SSD_HEADS, SSD_P, SSD_N, SSD_G)
K_REPS = 10


def _k_times(kernel, prefix=""):
    """A call's ms three ways (``time_ms``: as its caller meets it, device
    only, device only with a cold L2), under keys led by ``prefix``."""
    return {f"{prefix}ms": time_ms(kernel, reps=K_REPS),
            f"{prefix}device_ms": time_ms(kernel, reps=K_REPS,
                                          device_only=True),
            f"{prefix}cold_ms": time_ms(kernel, reps=K_REPS, cold=True,
                                        device_only=True)}


def _k_counts(module):
    """A kernel module's (forward, backward) launch counts."""
    return module.LAUNCHES, module.BWD_LAUNCHES


def _k_launched(module, before, fwd, bwd=0):
    """Raise unless the module's counts moved by exactly (fwd, bwd) since
    ``before``."""
    now = _k_counts(module)
    if (now[0] - before[0], now[1] - before[1]) != (fwd, bwd):
        raise AssertionError(f"{module.__name__}: {now} launches after "
                             f"{before}, want {(fwd, bwd)} more")


def _k_menu_rows():
    """Phase K (a) and (b): every menu entry of the flash forward and
    backward, RMSNorm's forward and the SSD forward and backward at phase
    K's shapes, each held to its plain version (the tolerances of phases 2
    and H), launched at that tile (its wrapper's count moves by one a
    call), then timed three ways beside its bound and the library call."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.kernels import tiles

    rows = []
    for model, (b, s, h, kv, hd) in K_FLASH_SHAPES:
        q, k, v = _qkv(b, s, s, h, kv, hd, seed=31)
        dout = _qkv(b, s, 1, h, 1, hd, seed=32)[0]
        o_ref, lse_ref = FA.flash_attention(q.float(), k.float(), v.float(),
                                            causal=True, impl="plain")
        qh = q.transpose(1, 2).detach().requires_grad_(True)
        kh = k.transpose(1, 2).detach().requires_grad_(True)
        vh = v.transpose(1, 2).detach().requires_grad_(True)
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qh, kh, vh, is_causal=True, enable_gqa=True)
        oh = sdpa()
        sdpa_bwd = lambda: torch.autograd.grad(  # noqa: E731
            oh, (qh, kh, vh), dout.transpose(1, 2), retain_graph=True)
        lib_f = _k_times(sdpa, "library_")
        lib_b = _k_times(sdpa_bwd, "library_")
        want = None
        for kvb in tiles.MENU["attn_kv_block"]:
            before = _k_counts(FA)
            o, lse = FA.flash_attention(q, k, v, causal=True, kv_block=kvb)
            got = FA.flash_attention_bwd(q, k, v, o, lse, dout, causal=True,
                                         kv_block=kvb)
            sync()
            _k_launched(FA, before, 1, 1)
            if want is None:
                want = FA.flash_attention_bwd(
                    q.float(), k.float(), v.float(), o.float(), lse,
                    dout.float(), causal=True, impl="plain")
            ok_o, err_o = close(o, o_ref, **BF16_TOL)
            ok_l, _ = close(lse, lse_ref, **LSE_TOL)
            res = [flash_bwd_close(g, w) for g, w in zip(got, want)]
            if not (ok_o and ok_l and all(r[0] for r in res)):
                raise AssertionError(f"flash at {kvb} keys a tile disagrees "
                                     f"with its plain version ({model})")
            shape = f"B{b} S{s} H{h} KV{kv} hd{hd} causal bf16"
            for name, fn, bound, err, lib in (
                    ("flash_attention_fwd",
                     lambda: FA.flash_attention(q, k, v, causal=True,
                                                kv_block=kvb),
                     flash_bound(b, s, s, h, kv, hd, True), err_o, lib_f),
                    ("flash_attention_bwd",
                     lambda: FA.flash_attention_bwd(
                         q, k, v, o, lse, dout, causal=True, kv_block=kvb),
                     flash_bwd_bound(b, s, s, h, kv, hd, True),
                     max(r[1] for r in res), lib_b)):
                t = _k_times(fn)
                rows.append(dict(name=name, model=model, shape=shape,
                                 tile=dict(attn_kv_block=kvb),
                                 max_abs_err=err, bound_ms=bound[0],
                                 bound_by=bound[1],
                                 share_of_bound_cold=bound[0] / t["cold_ms"],
                                 **t, **lib))
        del q, k, v, dout, o_ref, lse_ref, want, qh, kh, vh, oh
    for n_rows, d in K_RMS_WIDTHS:
        g = torch.Generator(DEVICE).manual_seed(d)
        x = torch.randn((n_rows, d), generator=g, device=DEVICE
                        ).to(torch.bfloat16)
        sc = (1 + 0.1 * torch.randn((d,), generator=g, device=DEVICE)
              ).to(torch.bfloat16)
        ref = RN.rmsnorm(x, sc, impl="plain")
        lib = _k_times(lambda: F.rms_norm(x, (d,), weight=sc, eps=1e-6),
                       "library_")
        for blk in tiles.MENU["rmsnorm_block"]:
            before = _k_counts(RN)
            y = RN.rmsnorm(x, sc, block=blk)
            sync()
            _k_launched(RN, before, 1)
            ok, err = close(y, ref, **BF16_TOL)
            if not ok:
                raise AssertionError(f"rmsnorm at {blk} rows a block "
                                     f"disagrees (d {d})")
            bound = rmsnorm_bound(n_rows, d, 2)
            t = _k_times(lambda: RN.rmsnorm(x, sc, block=blk))
            rows.append(dict(name="rmsnorm", shape=f"{n_rows}x{d} bf16",
                             tile=dict(rmsnorm_block=blk), max_abs_err=err,
                             bound_ms=bound[0], bound_by=bound[1],
                             share_of_bound_cold=bound[0] / t["cold_ms"],
                             **t, **lib))
    b, s, h, p, n, g_ = K_SSD_SHAPE
    x, dt, a, bb, cc = _ssd_inputs(b, s, h, p, n, g_, torch.bfloat16,
                                   seed=33)
    dy = torch.randn((b, s, h, p), generator=torch.Generator(
        DEVICE).manual_seed(34), device=DEVICE).to(torch.bfloat16)
    for q in tiles.ssd_chunk_menu(p, n):
        before = _k_counts(SS)
        y, hT = SS.ssd_scan(x, dt, a, bb, cc, chunk=q)
        grads = _ssd_bwd_grads(x, dt, a, bb, cc, dy, q)[0]
        _k_launched(SS, before, 2, 1)
        y_ref, hT_ref = SS.ssd_scan(x, dt, a, bb, cc, chunk=q, impl="plain")
        want = SS.ssd_bwd_plain(x, dt, a, bb, cc, dy, q)
        sync()
        ok_y, err_y = close(y, y_ref, **BF16_TOL)
        ok_h, _ = close(hT, hT_ref, **SSD_F32_TOL)
        res = ssd_bwd_close(grads, want)
        if not (ok_y and ok_h and all(r[1] for r in res)):
            raise AssertionError(f"ssd at chunk {q} disagrees with its "
                                 f"plain version")
        _, _, states = SS._launch(x, dt, a, bb, cc, q)
        shape = f"B{b} S{s} H{h} P{p} N{n} G{g_} chunk {q} bf16"
        for name, fn, bound, err in (
                ("ssd_scan", lambda: SS.ssd_scan(x, dt, a, bb, cc, chunk=q),
                 ssd_bound(b, s, h, p, n, g_, q, 2), err_y),
                ("ssd_scan_bwd",
                 lambda: SS._launch_bwd(x, dt, a, bb, cc, dy, states, q),
                 ssd_bwd_bound(b, s, h, p, n, g_, q, 2),
                 max(r[2] for r in res))):
            t = _k_times(fn)
            rows.append(dict(name=name, model="zamba2-2.7b (training)",
                             shape=shape, tile=dict(ssd_chunk=q),
                             max_abs_err=err, bound_ms=bound[0],
                             bound_by=bound[1],
                             share_of_bound_cold=bound[0] / t["cold_ms"],
                             library_ms=None, **t))
    for r in rows:
        log(f"# phase K {r['name']} {r['shape']} {r['tile']}: "
            f"{r['ms']:.4f} ms (device {r['device_ms']:.4f}, cold "
            f"{r['cold_ms']:.4f}), bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}, {r['share_of_bound_cold']:.1%} of it cold)"
            + (f", library {r['library_ms']:.4f} ms (cold "
               f"{r['library_cold_ms']:.4f})" if r.get("library_ms")
               else ""))
    return rows


def _k_default_is_the_old_launch():
    """Phase K (e): two layers of granite trained one step with no kernel
    tuple in the plan, and with the tuple that names the Hopper tiles the
    default runs at (128, 128, 8, 256): the same launch counts, and the
    loss, grad norm and every param bit for bit."""
    from repro_torch.configs.base import get_arch
    from repro_torch.core.plan import KernelConfig, single_stage_plan
    from repro_torch.models.zoo import build_model
    from repro_torch.training.data import BatchSpec, SyntheticLM
    from repro_torch.training.optimizer import AdamConfig
    from repro_torch.training.step import init_train_state, make_train_step

    cfg = get_arch("granite-3-8b").replace(num_layers=2)
    model = build_model(cfg, DEVICE)
    data = SyntheticLM(BatchSpec(global_batch=T_MICRO * T_ACCUM,
                                 seq_len=T_SEQ, vocab_size=cfg.vocab_size))
    batch = {k: torch.from_numpy(v).to(DEVICE)
             for k, v in data.batch(0).items()}
    base = single_stage_plan(2, dp=1, tp=1, micro_batch=T_MICRO,
                             grad_accum=T_ACCUM, zero=0, ckpt_layers=1,
                             attn_impl="pallas", use_pallas=True)
    runs = {}
    for name, plan in (("no kernel in the plan", base),
                       ("(128, 128, 8, 256)", base.replace(
                           kernel=KernelConfig(128, 128, 8, 256)))):
        step = make_train_step(model, plan, AdamConfig(lr=T_LR))
        state = init_train_state(model, plan,
                                 torch.Generator(DEVICE).manual_seed(0))
        _reset_counts()
        state, m = step.fn(state, batch)
        sync()
        runs[name] = (_read_counts(), float(m["loss"]),
                      float(m["grad_norm"]),
                      {k: v.clone() for k, v in state["params"].items()})
        del state, step
    (c0, l0, g0, p0), (c1, l1, g1, p1) = runs.values()
    same = c0 == c1 and l0 == l1 and g0 == g1 and all(
        torch.equal(p0[k], p1[k]) for k in p0)
    log(json.dumps({"phase_k_default_tuple": dict(
        launches=c0, loss=l0, grad_norm=g0, bitwise_equal=same)}))
    if not same:
        raise AssertionError("the default tuple does not run the kernels at "
                             "the tiles it names")


def phase_kernel_menu():
    """Phase K: the tuner's kernel dimension on the card.  (a, b) every
    menu entry against its plain version and timed (``_k_menu_rows``);
    ``bench_config`` over the legal grids; (c) ``calibrate_kernels`` on
    the card; (d) granite at T_LAYERS tuned for one H100 with
    ``kernel_tune=True``; the chosen tuple and a tuple other than the
    default (the chosen one, or where the sweep kept the default, the
    grid's best other) through ``verify_config``, then TUNED_STEPS steps through the launcher with
    exact launch counts, beside phase U's default-tuple plan; (e) the default tuple launches as
    before (``_k_default_is_the_old_launch``)."""
    import dataclasses

    from repro_torch.calibration.fit import calibrate_kernels
    from repro_torch.configs.base import get_arch
    from repro_torch.core.plan import DEFAULT_KERNEL_CONFIG, KernelConfig
    from repro_torch.core.tuner import MistTuner, TuneSpec
    from repro_torch.kernels import autotune, tiles

    t_phase = time.perf_counter()
    secs = {}
    t0 = time.perf_counter()
    rows = _k_menu_rows()
    secs["menu_rows"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cache = ROOT / "build" / "phase_k_bench.json"
    cache.unlink(missing_ok=True)
    bench = {}
    for name in ("granite-3-8b", "zamba2-2.7b"):
        cfg = get_arch(name)
        for tup in autotune.legal_kernel_grid(cfg, seq_len=T_SEQ):
            bench[f"{name} {tup}"] = autotune.bench_config(
                cfg, seq_len=T_SEQ, config=KernelConfig(*tup),
                cache_path=cache, device="cuda")
    secs["bench_config"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    kc = calibrate_kernels(("granite-3-8b", "zamba2-2.7b"), device="cuda",
                           cache_path=cache)
    secs["calibrate_kernels"] = time.perf_counter() - t0
    scales = {f: getattr(kc, f) for f in ("attn_scale", "rms_scale",
                                          "ssd_scale")}
    if not all(math.isfinite(v) and v > 0 for v in scales.values()):
        raise AssertionError(f"calibrate_kernels: scales {scales}")

    t0 = time.perf_counter()
    cfg = get_arch("granite-3-8b").replace(num_layers=T_LAYERS)
    spec = TuneSpec(arch=cfg, seq_len=T_SEQ, global_batch=T_MICRO * T_ACCUM,
                    n_devices=1, space="mist")
    base = MistTuner(spec).tune()
    tuner = MistTuner(dataclasses.replace(spec, kernel_tune=True))
    tuned = tuner.tune()
    grid = tuner.kernel_grid()
    # the launcher runs a tuple other than the default: the sweep's choice,
    # or where it kept the default, the grid's best other tuple (the plan
    # tuned with the grid pinned to it)
    rep = tuned
    if tuned.plan.kernel == DEFAULT_KERNEL_CONFIG:
        others = [t for t in grid if t != DEFAULT_KERNEL_CONFIG.astuple()]
        if not others:
            raise AssertionError(f"granite's kernel grid {grid} holds no "
                                 f"tuple but the default")
        rep = MistTuner(dataclasses.replace(
            spec, kernel_grid=(others[0],))).tune()
    secs["tune"] = time.perf_counter() - t0
    kcfg = rep.plan.kernel
    errs = {}
    t0 = time.perf_counter()
    for verified in dict.fromkeys((tuned.plan.kernel, kcfg)):
        autotune.verify_config(cfg, seq_len=T_SEQ, config=verified,
                               device="cuda", report=errs)
    secs["verify_config"] = time.perf_counter() - t0
    st = rep.plan.stages[0]
    want = _train_launches(T_LAYERS, min(st.ckpt_layers, T_LAYERS),
                           rep.plan.grad_accum)
    t0 = time.perf_counter()
    counts, first, last, step_ms = _launcher_run(rep.plan, TUNED_STEPS)
    secs["launcher"] = time.perf_counter() - t0
    if counts != {k: TUNED_STEPS * n for k, n in want.items()}:
        raise AssertionError(f"tuned-tuple plan launch counts {counts} != "
                             f"{TUNED_STEPS} x {want}")
    if not (math.isfinite(first) and math.isfinite(last)):
        raise AssertionError(f"tuned-tuple plan loss not finite: {first}, "
                             f"{last}")
    measured = statistics.median(step_ms[1:])

    t0 = time.perf_counter()
    _k_default_is_the_old_launch()
    secs["default_tuple"] = time.perf_counter() - t0
    secs["phase"] = time.perf_counter() - t_phase
    log(json.dumps({"phase_k": dict(
        menu=dict(tiles.MENU, ssd_chunk=tiles.ssd_chunk_menu(SSD_P, SSD_N)),
        rows=rows, bench_config=bench, calibrated_kernels=scales,
        grid=grid, chosen_tuple=tuned.plan.kernel.astuple(),
        predicted_step_s_chosen=tuned.objective,
        launched_tuple=kcfg.astuple(),
        launched_hopper_tiles=tiles.hopper_tiles(kcfg),
        launched_plan=json.loads(rep.plan.to_json()),
        predicted_step_s=rep.objective,
        predicted_step_s_default_tuple=base.objective,
        predicted_kernel_delta_s=rep.objective - base.objective,
        measured_step_ms=measured, measured_step_ms_all=step_ms,
        measured_step_ms_default_tuple_phase_u=U_STEP_MS.get("default"),
        verify_config_max_err=errs, launches=counts, losses=[first, last],
        seconds=secs, smi=smi_line())}))


# ---------------------------------------------------------------------------
# phase D: multi-device plans
# ---------------------------------------------------------------------------


def _launcher_lines(text):
    """The launcher's step times, losses (in full), launch counts and the
    peak-memory line's two numbers (allocator, predicted)."""
    ms = re.search(r"# step ms: (.*)", text)
    losses = re.search(r"# losses: (.*)", text)
    counts = re.search(r"# launches: (.*)", text)
    peak = re.search(r"max_memory_allocated (\d+) B .*predicted (\d+) B",
                     text)
    if not (ms and losses and counts and peak):
        raise AssertionError("the launcher's output lacks its lines")
    return ([float(x) for x in ms.group(1).split()],
            [float(x) for x in losses.group(1).split()],
            json.loads(counts.group(1)), int(peak.group(1)),
            int(peak.group(2)))


def _launcher_process(args, timeout=600, code=None):
    """The launcher in a process of its own: ``python -m
    repro_torch.launch.train args`` (or ``python -c code src args``).
    Returns its output; it must exit 0."""
    cmd = [sys.executable] + (["-c", code, str(ROOT / "src")] if code
                              else ["-m", "repro_torch.launch.train"])
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run(cmd + list(args), capture_output=True, text=True,
                       timeout=timeout, env=env, cwd=ROOT)
    log(f"# launcher process {' '.join(args)}: exit {r.returncode}\n"
        + r.stdout.strip())
    if r.returncode != 0:
        raise AssertionError(f"the launcher process failed:\n"
                             f"{r.stderr[-3000:]}")
    return r.stdout


def _per_step(counts, want_one_step, steps, what):
    want = {k: steps * want_one_step[k] for k in counts}
    if counts != want:
        raise AssertionError(f"{what}: launch counts {counts} != {want}")
    return {k: v // steps for k, v in counts.items()}


def _d1_world_size_one(plan):
    """The tuned one-card plan, its depth cut to D1_LAYERS, through the
    launcher twice: on one device, and with ``--nproc 1`` (a spawned rank
    of a world of one, NCCL, every collective on groups of one).  Losses
    and every param after D_STEPS steps bit for bit; exact launch counts
    per step."""
    import contextlib
    import io

    import numpy as np

    from repro_torch.launch import train as launch_train

    t0 = time.perf_counter()
    build = ROOT / "build"
    build.mkdir(parents=True, exist_ok=True)
    plan_json = build / "d1_plan.json"
    plan = plan.replace(stages=tuple(
        st.replace(layers=D1_LAYERS,
                   ckpt_layers=min(st.ckpt_layers, D1_LAYERS))
        for st in plan.stages))
    plan_json.write_text(plan.to_json())
    argv = ["--arch", "granite-3-8b", "--layers", str(D1_LAYERS),
            "--plan-json", str(plan_json), "--steps", str(D_STEPS),
            "--seq", str(T_SEQ), "--global-batch",
            str(plan.global_batch())]
    one, ws1 = build / "d1_one.npz", build / "d1_nproc1.npz"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = launch_train.main(argv + ["--save-params", str(one)])
    log(f"# train {' '.join(argv)} (one device): exit {rc}\n"
        + out.getvalue().strip())
    if rc:
        raise AssertionError("the one-device launcher failed")
    gc.collect()
    torch.cuda.empty_cache()
    secs = {"one_device": time.perf_counter() - t0}
    t0 = time.perf_counter()
    text = _launcher_process(argv + ["--nproc", "1", "--save-params",
                                     str(ws1)])
    secs["nproc_1_process"] = time.perf_counter() - t0
    st = plan.stages[0]
    rule = _train_launches(D1_LAYERS, min(st.ckpt_layers, D1_LAYERS),
                           plan.grad_accum)
    res = {}
    for name, t in (("one_device", out.getvalue()), ("nproc_1", text)):
        ms, losses, counts, peak, pred = _launcher_lines(t)
        res[name] = dict(step_ms=ms, losses=losses, max_memory_allocated=peak,
                         predicted_peak_bytes=pred,
                         launches_per_step=_per_step(counts, rule, D_STEPS,
                                                     name))
    with np.load(one) as a, np.load(ws1) as b:
        names = sorted(a.files)
        if sorted(b.files) != names:
            raise AssertionError("the two runs saved other params")
        differ = [n for n in names if not np.array_equal(a[n], b[n])]
    log(json.dumps({"d1_world_size_one": dict(
        plan=json.loads(plan.to_json()), steps=D_STEPS, seconds=secs,
        leaves_compared=len(names), differ=differ, **res)}))
    if differ:
        raise AssertionError(f"world size 1 through NCCL differs from one "
                             f"device in {differ}")


# one rank of a multi-device plan on this one card: the process joins a
# "fake" process group of the plan's world size (argv 2) as the given rank
# (argv 3), whose collectives, sends and receives return at once and move
# nothing; HOOK runs before the launcher
_FAKE_RANK = r"""
import json
import sys
sys.path.insert(0, sys.argv[1])
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
torch.cuda.set_device(0)
dist.init_process_group("fake", store=FakeStore(), rank=int(sys.argv[3]),
                        world_size=int(sys.argv[2]))
# the fake group's gathers, reduce-scatters and receives return without
# writing their outputs.  A gather's output is a fresh block of the caching
# allocator, whose old bits may read as NaN, and a pipeline stage's
# received activations stay zero, through which each RMSNorm's backward
# scales the gradient by rsqrt(eps) = 1000 until it overflows in 20
# layers.  Fill them as if every rank held this rank's data and the
# stage before sent unit-scale activations (and the stage after unit-scale
# gradients), so that the loss stays finite: the training loop stops on a
# non-finite loss it cannot roll back
_gather, _scatter = dist.all_gather_into_tensor, dist.reduce_scatter_tensor
_p2p = dist.batch_isend_irecv
_sent = torch.Generator("cuda").manual_seed(0)


def _filled_gather(out, inp, *a, **k):
    work = _gather(out, inp, *a, **k)
    out.view((-1,) + tuple(inp.shape)).copy_(inp)
    return work


def _filled_scatter(out, inp, *a, **k):
    work = _scatter(out, inp, *a, **k)
    out.copy_(inp.view((-1,) + tuple(out.shape))[0])
    return work


def _filled_p2p(ops):
    works = _p2p(ops)
    for op in ops:
        if op.op is dist.irecv:
            op.tensor.normal_(generator=_sent)
    return works


dist.all_gather_into_tensor = _filled_gather
dist.reduce_scatter_tensor = _filled_scatter
dist.batch_isend_irecv = _filled_p2p
split = []
HOOK
from repro_torch.launch import train
rc = train.main(sys.argv[4:])
if split:
    print("# memory split: " + json.dumps(split))
dist.destroy_process_group()
raise SystemExit(rc)
"""

# the allocator's bytes at the boundaries of each micro-batch's forward and
# backward and around the optimizer step, and the state's own bytes: a
# rank's peak split by term (run in the fake-rank child, before the
# launcher).  Each phase's peak is read and the peak statistic reset; the
# launcher's own max_memory_allocated then reads the largest of them.
_MEMORY_SPLIT = r"""
from repro_torch.training import optimizer as OPT
from repro_torch.training import step as ST
top = [0]
real_max = torch.cuda.max_memory_allocated


def phase_peak():
    p = real_max()
    top[0] = max(top[0], p)
    torch.cuda.reset_peak_memory_stats()
    return p


torch.cuda.max_memory_allocated = lambda *a, **k: max(top[0], real_max())


def micro_steps(model, params, micros, ec, sink):
    run_ec = ec.replace(compute_dtype=params["embed/w"].dtype, sink=sink)
    losses = []
    for micro in micros:
        phase_peak()
        before = torch.cuda.memory_allocated()
        loss = model.loss_fn(params, micro, run_ec)
        fwd_peak, after_fwd = phase_peak(), torch.cuda.memory_allocated()
        loss.backward()
        split.append(dict(before_fwd=before, fwd_peak=fwd_peak,
                          after_fwd=after_fwd, bwd_peak=phase_peak(),
                          after_bwd=torch.cuda.memory_allocated()))
        losses.append(loss.detach())
        del loss
    return losses


real_adam = OPT.adam_update


def on_card(v):
    parts = v.values() if isinstance(v, dict) else (v,)
    return sum(t.numel() * t.element_size() for t in parts if t.is_cuda)


def adam_update(state, grads, *a):
    phase_peak()
    before = torch.cuda.memory_allocated()
    held = {e: sum(on_card(v) for v in state[e].values())
            for e in ("params", "master", "mu", "nu")}
    held["grad_sums"] = sum(on_card(g) for g in grads.values())
    out = real_adam(state, grads, *a)
    split.append(dict(adam_before=before, adam_peak=phase_peak(),
                      state_bytes=held))
    return out


ST.micro_steps = micro_steps
OPT.adam_update = adam_update
"""


def _split_terms(text, accum):
    """The last step's readings of ``_MEMORY_SPLIT`` printed by a child
    (``# memory split:``) as terms (``_terms_of_split``)."""
    got = json.loads(re.search(r"# memory split: (.*)", text).group(1))
    return _terms_of_split(got, accum)


def _split_in_process():
    """``_MEMORY_SPLIT``'s hooks in this process: returns the list its
    readings go to and a function that takes the hooks out again (read the
    allocator's peak before calling it)."""
    from repro_torch.training import optimizer as OPT
    from repro_torch.training import step as ST

    saved = (ST.micro_steps, OPT.adam_update,
             torch.cuda.max_memory_allocated)
    ns = {"torch": torch, "split": []}
    exec(_MEMORY_SPLIT, ns)

    def restore():
        (ST.micro_steps, OPT.adam_update,
         torch.cuda.max_memory_allocated) = saved
    return ns["split"], restore


def _terms_of_split(got, accum):
    """The last step's readings of ``_MEMORY_SPLIT`` as terms: the state
    (bf16 weights, master, mu and nu on the card), the f32 gradient sums,
    the activations one micro-batch's forward leaves for its backward, and
    the transients above them in the forward, the backward and the update
    (bytes)."""
    *micro, adam = got[-(accum + 1):]
    held = adam["state_bytes"]
    acts = max(m["after_fwd"] - m["before_fwd"] for m in micro)
    return {
        "weights_bf16": held["params"],
        "master_mu_nu": held["master"] + held["mu"] + held["nu"],
        "grad_sums_f32": held["grad_sums"],
        "saved_activations_one_micro_batch": acts,
        "forward_transient": max(m["fwd_peak"] - m["after_fwd"]
                                 for m in micro),
        "backward_transient_over_saved": max(m["bwd_peak"] - m["after_fwd"]
                                             for m in micro),
        "update_transient": adam["adam_peak"] - adam["adam_before"],
        "phase_peaks": [max(m["fwd_peak"], m["bwd_peak"]) for m in micro]
        + [adam["adam_peak"]]}


def _d2_rank0_of_four():
    """granite-3-8b at full depth and width, tuned for four H100s by the
    launcher (``--tune --devices 4``), run as rank 0 of 4 under the fake
    backend: exact launch counts per step, this rank's allocator peak
    beside the plan's predicted bytes per device, and the step time of one
    rank's compute with no communication.  The collectives move nothing
    (the gathers are filled with this rank's data, ``_FAKE_RANK``), so the
    loss is not checked."""
    args = [str(D2_DEVICES), "0", "--arch", "granite-3-8b", "--tune",
            "--devices", str(D2_DEVICES), "--steps", str(D_STEPS), "--seq",
            str(T_SEQ), "--global-batch", str(D2_GBS)]
    t0 = time.perf_counter()
    text = _launcher_process(
        args, code=_FAKE_RANK.replace("HOOK", _MEMORY_SPLIT), timeout=900)
    secs = time.perf_counter() - t0
    plan = _tuned_plan(text)
    split = _split_terms(text, plan.grad_accum)
    st = plan.stages[0]
    if st.dp * st.tp != D2_DEVICES:
        raise AssertionError(f"the tuned plan is not for {D2_DEVICES} ranks")
    ms, _, counts, peak, pred = _launcher_lines(text)
    rule = _train_launches(N_LAYERS, min(st.ckpt_layers, N_LAYERS),
                           plan.grad_accum)
    per_step = _per_step(counts, rule, D_STEPS, "rank 0 of the tp plan")
    rank_shape = (st.micro_batch, T_SEQ, N_HEADS // st.tp,
                  N_KV // st.tp if N_KV % st.tp == 0 else None)
    log(json.dumps({"d2_rank0_of_4": dict(
        model="granite-3-8b", layers=N_LAYERS, seq=T_SEQ,
        global_batch=D2_GBS, plan=json.loads(plan.to_json()),
        rank_flash_shape_B_S_H_KV=rank_shape,
        launches_per_step=per_step, max_memory_allocated=peak,
        predicted_peak_bytes_per_device=pred,
        allocator_over_predicted=peak / pred,
        peak_split_by_term=split,
        step_ms_compute_of_one_rank_no_communication=ms,
        median_step_ms_after_first=statistics.median(ms[1:]),
        process_seconds=secs, smi=smi_line())}))
    # the memory report sizes the plans: the rank's peak may not run past
    # its predicted bytes by more than 2%
    if peak > D2_PEAK_ROOM * pred:
        raise AssertionError(f"rank 0 of the tp plan peaks at {peak} B, over "
                             f"{D2_PEAK_ROOM} x its predicted {pred} B")
    # the kernel rows of phases 2 and 4 pair these counts with this shape
    if rank_shape != (R_BATCH, T_SEQ, R_HEADS, R_KV):
        raise AssertionError(f"the tuned plan's rank runs flash attention at "
                             f"B, S, H, KV = {rank_shape}; phases 2 and 4 "
                             f"time {(R_BATCH, T_SEQ, R_HEADS, R_KV)}")
    return per_step


def _two_card_cases(archs=(("granite-3-8b", 4), ("zamba2-2.7b", 8))):
    """The reduced configs (granite: 4 layers; zamba2: 8 layers in 2
    groups), each with remat on half its layers, at dp 2 ZeRO 3 and at tp
    2 with sequence parallelism through NCCL (``--nproc 2``), their losses
    held to the same plan at dp = tp = 1 on one card."""
    from repro_torch.core.plan import single_stage_plan
    build = ROOT / "build"
    build.mkdir(parents=True, exist_ok=True)
    for arch, layers in archs:
        for name, dp, tp, zero in (("dp2_z3", 2, 1, 3), ("tp2_sp", 1, 2, 1)):
            runs = {}
            for world in (2, 1):
                plan = single_stage_plan(
                    layers, dp=dp if world == 2 else 1,
                    tp=tp if world == 2 else 1,
                    micro_batch=8 // (2 * (dp if world == 2 else 1)),
                    grad_accum=2, zero=zero, ckpt_layers=layers // 2,
                    attn_impl="pallas", use_pallas=True,
                    sequence_parallel=True)
                path = build / f"multi_{arch}_{name}_{world}.json"
                path.write_text(plan.to_json())
                args = ["--arch", arch, "--smoke", "--steps", str(D_STEPS),
                        "--plan-json", str(path)]
                if world == 2:
                    args += ["--nproc", "2"]
                runs[world] = _launcher_lines(_launcher_process(args))[1]
            ok = all(abs(a - b) <= REDUCED_LOSS_RTOL * abs(b)
                     for a, b in zip(runs[2], runs[1]))
            log(json.dumps({"multi_card": dict(
                arch=arch, case=name, losses_2_cards=runs[2],
                losses_1_card=runs[1], ok=ok)}))
            if not ok:
                raise AssertionError(f"multi_card {arch} {name}: losses off "
                                     "one card's")


def _multi_card():
    """With two or more cards visible: ``_two_card_cases``.  With four or
    more, also the reduced granite's pipelines and D2's tuned plan on four
    cards (``--tune --devices 4 --nproc 4``): exact launch counts, finite
    losses, and the step time with its communication beside the tuner's
    prediction."""
    n = torch.cuda.device_count()
    if n < 2:
        log(f"multi_card: not run ({n} visible)")
        return
    _two_card_cases()
    build = ROOT / "build"
    base = ["--arch", "granite-3-8b", "--smoke", "--steps", str(D_STEPS)]
    if n < D2_DEVICES:
        log(f"multi_card: the pipelines and D2 on {D2_DEVICES} cards not "
            f"run ({n} visible)")
        return
    # pipelined plans of the reduced config on four cards through NCCL (1F1B
    # hand-offs over NVLink), their losses held to one card's
    from repro_torch.core.plan import Plan, StageConfig, single_stage_plan
    one = single_stage_plan(4, dp=1, tp=1, micro_batch=4, grad_accum=2,
                            zero=1, ckpt_layers=0, attn_impl="pallas",
                            use_pallas=True)
    path = build / "multi_pipe_1.json"
    path.write_text(one.to_json())
    want = _launcher_lines(_launcher_process(
        base + ["--plan-json", str(path)]))[1]
    for name, S, dp in (("s2_dp2_z1", 2, 2), ("s4", 4, 1)):
        plan = Plan(grad_accum=2, attn_impl="pallas", use_pallas=True,
                    stages=tuple(StageConfig(
                        layers=4 // S, micro_batch=4 // dp, dp=dp, tp=1,
                        zero=1, ckpt_layers=0) for _ in range(S)))
        path = build / f"multi_pipe_{name}.json"
        path.write_text(plan.to_json())
        text = _launcher_process(base + ["--plan-json", str(path),
                                         "--nproc", "4"])
        losses = [float(x) for x in
                  re.search(r"# losses: (.*)", text).group(1).split()]
        ok = all(abs(a - b) <= REDUCED_LOSS_RTOL * abs(b)
                 for a, b in zip(losses, want)) and len(losses) == len(want)
        log(json.dumps({"multi_card": dict(case=name, losses_4_cards=losses,
                                           losses_1_card=want, ok=ok)}))
        if not ok:
            raise AssertionError(f"multi_card {name}: losses off one card's")
    t0 = time.perf_counter()
    text = _launcher_process(
        ["--arch", "granite-3-8b", "--tune", "--devices", str(D2_DEVICES),
         "--nproc", str(D2_DEVICES), "--steps", str(D_STEPS + 2), "--seq",
         str(T_SEQ), "--global-batch", str(D2_GBS)], timeout=900)
    plan = _tuned_plan(text)
    st = plan.stages[0]
    ms, losses, counts, peak, pred = _launcher_lines(text)
    rule = _train_launches(N_LAYERS, min(st.ckpt_layers, N_LAYERS),
                           plan.grad_accum)
    per_step = _per_step(counts, rule, D_STEPS + 2, "D2 on four cards")
    predicted = float(re.search(r"predicted step (\S+)s", text).group(1))
    log(json.dumps({"d2_on_4_cards": dict(
        model="granite-3-8b", layers=N_LAYERS, seq=T_SEQ,
        global_batch=D2_GBS, plan=json.loads(plan.to_json()),
        launches_per_step_rank_0=per_step, step_ms=ms,
        median_step_ms_after_first=statistics.median(ms[1:]),
        predicted_step_s=predicted, losses=losses,
        max_memory_allocated_rank_0=peak,
        predicted_peak_bytes_per_device=pred,
        process_seconds=time.perf_counter() - t0, smi=smi_line())}))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"D2 on four cards: losses {losses}")


# ---------------------------------------------------------------------------
# phase P: pipelined plans
# ---------------------------------------------------------------------------


def _pipeline_plan():
    """granite-3-8b at full depth tuned for P_DEVICES H100s; when that plan
    has one stage, or stages that differ in (dp, tp), the uniform space's
    plan at S = 2 too, which phase P then runs (with the flash-attention
    kernel the cost model priced)."""
    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.core.tuner import tune
    cfg = get_arch("granite-3-8b")
    shape = ShapeConfig("p", T_SEQ, P_GBS, "train")
    reps = {"mist": tune(cfg, shape, P_DEVICES)}
    plan = reps["mist"].plan
    if plan.num_stages == 1 or len({(st.dp, st.tp)
                                    for st in plan.stages}) > 1:
        reps["uniform_s2"] = tune(cfg, shape, P_DEVICES, space="uniform",
                                  stage_counts=(2,))
        plan = reps["uniform_s2"].plan
    log(json.dumps({"p_tuned": {k: dict(
        plan=json.loads(r.plan.to_json()), predicted_step_s=r.objective,
        tune_seconds=r.tune_seconds) for k, r in reps.items()}}))
    return plan.replace(attn_impl="pallas", use_pallas=True)


def _stage_launches(layers, ckpt, accum, last):
    """``_train_launches`` of one pipeline stage: its layers, and the final
    norm on the last stage only."""
    want = _train_launches(layers, ckpt, accum)
    if not last:
        want["rmsnorm"] -= accum
        want["rmsnorm_bwd"] -= accum
    return want


def _stage_lines(text, stage):
    """A stage rank's step times, launch counts and peak-memory numbers
    (allocator, predicted), from the launcher's ``(stage s)`` lines."""
    tag = re.escape(f"(stage {stage})")
    ms = re.search(rf"# step ms {tag}: (.*)", text)
    counts = re.search(rf"# launches {tag}: (.*)", text)
    peak = re.search(rf"# peak memory {tag}: max_memory_allocated (\d+) B "
                     r".*predicted (\d+) B", text)
    if not (ms and counts and peak):
        raise AssertionError(f"the launcher's output lacks stage {stage}'s "
                             "lines")
    return ([float(x) for x in ms.group(1).split()],
            json.loads(counts.group(1)), int(peak.group(1)),
            int(peak.group(2)))


def phase_pipeline():
    """The first stage's rank 0 and the last stage's first rank of
    granite's pipelined plan for P_DEVICES H100s, each through the
    launcher (``--plan-json``) in a child process under the ``fake``
    group (its sends, receives and collectives move nothing, so the loss
    is not checked): exact launch counts per step, the allocator's peak
    beside the stage's predicted bytes per device, one rank's compute per
    step.  Returns the first stage rank's launches per step."""
    t0 = time.perf_counter()
    plan = _pipeline_plan()
    S, st = plan.num_stages, plan.stages[0]
    if S < 2 or len({(x.dp, x.tp) for x in plan.stages}) > 1:
        raise AssertionError("phase P has no pipelined plan to run")
    shape = (st.micro_batch, T_SEQ, N_HEADS // st.tp,
             N_KV // st.tp if N_KV % st.tp == 0 else None)
    if shape != (P_BATCH, T_SEQ, P_HEADS, P_KV):
        raise AssertionError(f"the pipelined plan's ranks run flash attention "
                             f"at B, S, H, KV = {shape}; phases 2 and 4 time "
                             f"{(P_BATCH, T_SEQ, P_HEADS, P_KV)}")
    build = ROOT / "build"
    build.mkdir(parents=True, exist_ok=True)
    path = build / "p_plan.json"
    full_layers = [x.layers for x in plan.stages]
    plan = plan.replace(stages=tuple(
        x.replace(layers=P_STAGE_LAYERS,
                  ckpt_layers=min(x.ckpt_layers, P_STAGE_LAYERS))
        for x in plan.stages))
    path.write_text(plan.to_json())
    out = {}
    for s in (0, S - 1):
        rank = s * st.dp * st.tp
        t1 = time.perf_counter()
        text = _launcher_process(
            [str(plan.devices), str(rank), "--arch", "granite-3-8b",
             "--layers", str(P_STAGE_LAYERS * S), "--plan-json", str(path),
             "--steps", str(D_STEPS), "--seq", str(T_SEQ), "--global-batch",
             str(P_GBS)], code=_FAKE_RANK.replace("HOOK", ""), timeout=900)
        ms, counts, peak, pred = _stage_lines(text, s)
        sc = plan.stages[s]
        rule = _stage_launches(sc.layers, min(sc.ckpt_layers, sc.layers),
                               plan.grad_accum, s == S - 1)
        per_step = _per_step(counts, rule, D_STEPS, f"stage {s}'s rank")
        out[s] = per_step
        log(json.dumps({"p_stage_rank": dict(
            model="granite-3-8b", layers=sc.layers,
            tuned_layers=full_layers[s], stage=s, stages=S,
            rank=rank, world=plan.devices, seq=T_SEQ, global_batch=P_GBS,
            plan=json.loads(plan.to_json()), rank_flash_shape_B_S_H_KV=shape,
            launches_per_step=per_step, max_memory_allocated=peak,
            predicted_peak_bytes_of_stage=pred,
            allocator_over_predicted=peak / pred,
            step_ms_compute_of_one_rank_no_communication=ms,
            median_step_ms_after_first=statistics.median(ms[1:]),
            process_seconds=time.perf_counter() - t1, smi=smi_line())}))
    log(f"# phase P: {time.perf_counter() - t0:.1f} s")
    return out[0]


def _tuned_plan(text):
    """The plan the launcher printed after ``--tune``."""
    from repro_torch.core.plan import Plan
    return Plan.from_json(text[text.index("{"):text.index("# memory")])


def phase_multi_device(plan):
    """D1, D2 and the multi-card cases; returns D2's launches per step."""
    t0 = time.perf_counter()
    _d1_world_size_one(plan)
    gc.collect()
    torch.cuda.empty_cache()
    per_step = _d2_rank0_of_four()
    _multi_card()
    log(f"# phase D: {time.perf_counter() - t0:.1f} s")
    return per_step


# ---------------------------------------------------------------------------
# phase H: hybrid training
# ---------------------------------------------------------------------------


def ssd_bwd_close(got, want):
    """[(name, ok, max err, max |want|)] of dx, ddt, da, dB, dC under
    SSD_BWD_TOL (each tensor's own dtype)."""
    out = []
    for name, g, w in zip(("dx", "ddt", "da", "dB", "dC"), got, want):
        err = float((g.float() - w.float()).abs().max())
        scale = float(w.float().abs().max())
        out.append((name, bool(torch.isfinite(g).all())
                    and err <= SSD_BWD_TOL[w.dtype] * scale, err, scale))
    return out


def _ssd_bwd_grads(x, dt, a, bb, cc, dy, q, calls=1):
    """The kernels' gradients of y through the SSD autograd Function (the
    forward kernel keeps its states, the backward kernel reads them),
    ``calls`` times from one forward."""
    from repro_torch.kernels.ssd_scan import SSDScan
    leaves = [t.detach().requires_grad_(True) for t in (x, dt, a, bb, cc)]
    y, _ = SSDScan.apply(*leaves, q, "kernel")
    out = [torch.autograd.grad(y, leaves, dy, retain_graph=i < calls - 1)
           for i in range(calls)]
    sync()
    return out


def _ssd_bwd_vs_plain():
    """Phase H (a): the SSD backward kernel against ``ssd_bwd_plain`` on the
    card at zamba2's training shape, at the heads of a rank of its tp-4 and
    tp-8 plans (H 20 and 10: clusters of 4 and 2 heads), and the forward's
    edge cases (S < chunk, S = chunk, ragged tiles, G > 1, f32); two calls
    at the training and the rank shapes bit for bit; a large |dt a|
    finite.  Returns the largest error at the training shape and at phase
    Z's rank shape."""
    from repro_torch.kernels import ssd_scan as SS

    bf16 = torch.bfloat16
    cases = [  # (B, S, H, P, N, G, chunk, dtype, dt and a scale)
        (H_MICRO, H_SEQ, SSD_HEADS, SSD_P, SSD_N, SSD_G, SSD_CHUNK, bf16,
         1.0),                                          # zamba2 training
        (BATCH, 64, 16, 16, 16, 1, SSD_CHUNK, bf16, 1.0),   # S < chunk
        (BATCH, 256, SSD_HEADS, 64, 64, 1, 256, bf16, 1.0),  # S = chunk
        (2, 40, 4, 32, 16, 1, SSD_CHUNK, bf16, 1.0),    # ragged 16-row block
        (2, 192, 4, 32, 16, 2, 96, bf16, 1.0),          # ragged, 2 chunks
        (2, 512, 8, 64, 64, 2, 256, bf16, 1.0),         # G = 2 groups
        (2, 192, 4, 32, 16, 2, 96, torch.float32, 1.0),  # f32
        (1, 512, 8, 64, 64, 1, 256, bf16, 50.0),        # large |dt a|
        # a rank of zamba2's tp-4 plan (phase Z) and of a tp-8 plan
        (Z_MICRO, H_SEQ, ZR_SSD_HEADS, SSD_P, SSD_N, SSD_G, SSD_CHUNK, bf16,
         1.0),
        (Z_MICRO, H_SEQ, SSD_HEADS // 8, SSD_P, SSD_N, SSD_G, SSD_CHUNK,
         bf16, 1.0),
    ]
    twice = {0: "training shape", len(cases) - 2: "tp-4 rank",
             len(cases) - 1: "tp-8 rank"}
    errs = {}
    for i, (b, s, h, p, n, g, q, dtype, big) in enumerate(cases):
        x, dt, a, bb, cc = _ssd_inputs(b, s, h, p, n, g, dtype, seed=120 + i)
        dt, a = dt * big, a * big
        dy = torch.randn((b, s, h, p), generator=torch.Generator(
            DEVICE).manual_seed(140 + i), device=DEVICE).to(dtype)
        runs = _ssd_bwd_grads(x, dt, a, bb, cc, dy, q,
                              calls=2 if i in twice else 1)
        want = SS.ssd_bwd_plain(x, dt, a, bb, cc, dy, q)
        sync()
        res = ssd_bwd_close(runs[0], want)
        log(f"# ssd bwd B{b} S{s} H{h} P{p} N{n} G{g} chunk {q} {dtype}"
            f"{f' dt, a x {big:g}' if big != 1 else ''} (clusters of "
            f"{SS.bwd_cluster(h, g)}): max err (max |ref|) "
            + ", ".join(f"{nm} {e:.3e} ({m:.3g})" for nm, _, e, m in res))
        if not all(ok for _, ok, _, _ in res):
            raise AssertionError("ssd backward kernel disagrees with its "
                                 f"plain version (case {i})")
        if i in twice:
            errs[twice[i]] = max(e for _, _, e, _ in res)
            same = all(torch.equal(u, v) for u, v in zip(*runs))
            log(f"# ssd bwd {twice[i]}, second call bitwise equal: {same}")
            if not same:
                raise AssertionError(f"ssd backward kernel: two calls differ "
                                     f"({twice[i]})")
    return errs["training shape"], errs["tp-4 rank"]


def _hybrid_launches(cfg, ckpt_layers, accum):
    """Launches per train step of the hybrid, from the code: per micro-batch
    each group runs its shared block (two norms, one flash attention) and
    ``per`` Mamba layers (a norm and an SSD scan each), then the final
    norm; a remat'd group (CKPT counted in groups) runs its forward again
    in the backward, to its last Mamba layer's saved tensors, so its norms,
    its attention and its SSD scans rerun; each forward of the saved graph
    has one backward."""
    per = cfg.shared_attn_every
    ng, cg = cfg.num_layers // per, -(-ckpt_layers // per)
    return {"flash_attention_fwd": accum * (ng + cg),
            "flash_attention_bwd": accum * ng,
            "rmsnorm": accum * (2 * ng + cfg.num_layers + 1
                                + cg * (2 + per)),
            "rmsnorm_bwd": accum * (2 * ng + cfg.num_layers + 1),
            "ssd_scan": accum * (cfg.num_layers + cg * per),
            "ssd_scan_bwd": accum * cfg.num_layers}


def _hybrid_reduced_vs_cpu():
    """Phase H (b): the reduced zamba2 (8 layers, 2 groups), CKPT over one
    of its groups, AO over that group, WO = OO = 0.5, SSD chunk 16 (4
    chunks of 64 tokens): one micro-batch's loss and every gradient with
    the kernels on the card against the plain versions on the CPU (same
    bf16 weights), then one train step of the plan on each: the losses
    compared, the grad norms finite.  The gradients are held by
    ``_grads_as_accurate`` alone: this hybrid's bf16 gradients sit 25-47%
    (mean) from its f32 ones, and two bf16 routes on the CPU (the SSD plain
    version and the chunked algebra) differ by 7-9% of the mean magnitude,
    so granite's 3e-2 mean-difference share cannot hold (as for zamba2's
    logits).  The grad norm carries the same noise (card 73.20 against the
    CPU's 76.82 on an H100 80GB HBM3 at 700 W; the f32 gradients' norm sits
    4.5% from the bf16 ones' on the CPU), and the per-tensor rule already
    holds what it sums."""
    from repro_torch.configs.base import get_arch
    from repro_torch.core.plan import KernelConfig, single_stage_plan
    from repro_torch.lowering import train_exec_cfg
    from repro_torch.models.zoo import build_model
    from repro_torch.training.data import BatchSpec, SyntheticLM
    from repro_torch.training.optimizer import init_state
    from repro_torch.training.step import make_train_step

    cfg = get_arch("zamba2-2.7b").reduced()
    plan = single_stage_plan(cfg.num_layers, dp=1, tp=1, micro_batch=2,
                             grad_accum=1, ckpt_layers=3, ao=1 / 3, wo=0.5,
                             oo=0.5, attn_impl="pallas", use_pallas=True,
                             kernel=KernelConfig(ssd_chunk=16))
    ec = train_exec_cfg(plan)
    assert (ec.ckpt_layers, ec.offload_layers, ec.ssd_chunk) == (3, 1, 16)
    params, axes = build_model(cfg, "cpu").init(
        torch.Generator().manual_seed(0))
    batch = SyntheticLM(BatchSpec(global_batch=2, seq_len=64,
                                  vocab_size=cfg.vocab_size), seed=1).batch(0)

    def loss_and_grads(dev, dtype):
        p = {n: t.to(dev, dtype).requires_grad_(True)
             for n, t in params.items()}
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        loss = build_model(cfg, dev).loss_fn(
            p, b, ec.replace(compute_dtype=dtype))
        grads = torch.autograd.grad(loss, list(p.values()))
        return float(loss.detach()), {n: g.float().cpu()
                                      for n, g in zip(p, grads)}

    card_loss, card = loss_and_grads(DEVICE, torch.bfloat16)
    cpu_loss, cpu = loss_and_grads("cpu", torch.bfloat16)
    _, truth = loss_and_grads("cpu", torch.float32)
    ratio = max(_grads_as_accurate(card[n], cpu[n], truth[n], n)
                for n in card)

    def one_step(dev):
        state = init_state({n: t.to(dev, copy=True)
                            for n, t in params.items()}, axes, plan.stages[0])
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        _, m = make_train_step(build_model(cfg, dev), plan).fn(state, b)
        return float(m["loss"]), float(m["grad_norm"])

    card_step, cpu_step = one_step(DEVICE), one_step("cpu")
    log(f"# hybrid training, reduced zamba2 card kernels vs CPU plain: loss "
        f"{card_loss:.5f} vs {cpu_loss:.5f}; every gradient within the CPU "
        f"rule (largest error vs f32 at {ratio:.2f}x the CPU bf16 run's); "
        f"one step at WO = OO = 0.5, (loss, grad norm) {card_step} vs "
        f"{cpu_step}")
    if abs(card_loss - cpu_loss) > REDUCED_LOSS_RTOL * abs(cpu_loss) or \
            abs(card_step[0] - cpu_step[0]) > \
            REDUCED_LOSS_RTOL * abs(cpu_step[0]) or \
            not all(math.isfinite(x) for x in card_step + cpu_step):
        raise AssertionError(f"reduced hybrid: card {card_loss} "
                             f"{card_step} vs CPU {cpu_loss} {cpu_step}")


def phase_hybrid_train(profile=False):
    """Phase H (c): zamba2-2.7b trained at full width and depth on one card
    (module docstring); returns the launch counts of one step."""
    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.core.plan import single_stage_plan
    from repro_torch.lowering import memory_consistency
    from repro_torch.models.zoo import build_model
    from repro_torch.training.data import BatchSpec, SyntheticLM
    from repro_torch.training.optimizer import AdamConfig
    from repro_torch.training.step import init_train_state, make_train_step

    cfg = get_arch("zamba2-2.7b")
    dims = dict(num_layers=Z_LAYERS, d_model=Z_D_MODEL, num_heads=Z_HEADS,
                head_dim=Z_HEAD_DIM, ssm_state=SSD_N, ssm_head_dim=SSD_P,
                ssm_groups=SSD_G, shared_attn_every=Z_LAYERS // Z_GROUPS,
                vocab_size=32000, tie_embeddings=False)
    assert {k: getattr(cfg, k) for k in dims} == dims
    model = build_model(cfg, DEVICE)
    plan = single_stage_plan(Z_LAYERS, dp=1, tp=1, micro_batch=H_MICRO,
                             grad_accum=H_ACCUM, zero=0, ckpt_layers=H_CKPT,
                             ao=H_AO_LAYERS / H_CKPT, attn_impl="pallas",
                             use_pallas=True, remat_policy="full")
    step = make_train_step(model, plan, AdamConfig(lr=T_LR))
    ec = step.exec_cfg
    assert (ec.ckpt_layers, ec.offload_layers) == (H_CKPT, H_AO_LAYERS)
    want = _hybrid_launches(cfg, ec.ckpt_layers, H_ACCUM)
    data = SyntheticLM(BatchSpec(global_batch=H_MICRO * H_ACCUM,
                                 seq_len=H_SEQ, vocab_size=cfg.vocab_size))
    batch = {k: torch.from_numpy(v).to(DEVICE)
             for k, v in data.batch(0).items()}
    t0 = time.perf_counter()
    state = init_train_state(model, plan,
                             torch.Generator(DEVICE).manual_seed(0))
    sync()
    n_params = sum(p.numel() for p in state["params"].values())
    log(f"# training zamba2-2.7b at full width, {Z_LAYERS} layers: "
        f"{n_params / 1e9:.3f} B params; ckpt {ec.ckpt_layers} layers "
        f"({-(-ec.ckpt_layers // cfg.shared_attn_every)} groups, offload "
        f"{ec.offload_layers}), "
        f"grad_accum {H_ACCUM} x {H_MICRO} x {H_SEQ}; state initialised in "
        f"{time.perf_counter() - t0:.1f} s")

    # the main path, counted and timed step by step, with no hooks
    losses, gnorms, times = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(H_STEPS):
        _reset_counts()
        t0 = time.perf_counter()
        state, m = step.fn(state, batch)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
        launches = _read_counts()
        if launches != want:
            raise AssertionError(f"hybrid train step launch counts "
                                 f"{launches} != {want}")
    peak = torch.cuda.max_memory_allocated()
    # one more step, with _MEMORY_SPLIT's hooks, only to split the peak by
    # term; the peak held to the report is the unhooked steps'
    split, unhook = _split_in_process()
    try:
        state, _ = step.fn(state, batch)
        sync()
    finally:
        unhook()
    mc = memory_consistency(cfg, ShapeConfig("h", H_SEQ, H_MICRO * H_ACCUM,
                                             "train"), plan)
    terms = _terms_of_split(split, H_ACCUM)
    peak_split = _peak_against_report(
        "phase H", cfg, plan, H_SEQ, H_MICRO * H_ACCUM, peak, terms,
        H_PEAK_BOUND, gate=True)
    if profile:
        report = _device_window(lambda: step.fn(state, batch),
                                ROOT / "build" / "profile" / "train_hybrid" /
                                "trace_step.json")
        log(json.dumps({"profile": {"train_step": report},
                        "model": "zamba2-2.7b (training)"}))
    del state, m
    gc.collect()
    torch.cuda.empty_cache()
    step_ms = statistics.median(times[1:])
    tokens = H_MICRO * H_ACCUM * H_SEQ
    log(json.dumps({"train_hybrid": dict(
        model="zamba2-2.7b", layers=Z_LAYERS, tokens_per_step=tokens,
        step_ms=step_ms, step_ms_all=times,
        tokens_per_s=tokens / (step_ms / 1e3), n_params=n_params,
        max_memory_allocated=peak,
        memory_report_predicted_bytes=mc["predicted_bytes"],
        memory_report_lowered_bytes=mc["lowered_bytes"],
        peak_against_memory_report=peak_split, lr=T_LR,
        losses=losses, grad_norms=gnorms, launches_per_step=launches,
        smi=smi_line())}))
    if not all(math.isfinite(x) for x in losses + gnorms):
        raise AssertionError("hybrid training: non-finite loss or grad norm")
    if not (losses[1] < losses[0] and losses[-1] < losses[0]):
        raise AssertionError(f"hybrid training: the loss does not fall: "
                             f"{losses}")
    return launches


# --adam-slices: the slice sizes of Adam's update (training/optimizer.py's
# SLICE_ELEMS) timed against each other; 0 is one slice a leaf, the
# whole-leaf update the optimizer ran before it was sliced
ADAM_SLICES = (0, 1 << 24, 1 << 26, 1 << 27)
ADAM_SLICE_STEPS = 3


def _slice_cell(name, model, plan, batch):
    """One model's step at each of ADAM_SLICES, in that order and then
    reversed (the whole-leaf update first and last), ADAM_SLICE_STEPS steps
    each after one warm-up step: the step's wall ms, the update's ms
    (``adam_update``, the norm included) between CUDA events, and the
    allocator's peak."""
    from repro_torch.training import optimizer as OPT
    from repro_torch.training.optimizer import AdamConfig
    from repro_torch.training.step import init_train_state, make_train_step

    step = make_train_step(model, plan, AdamConfig(lr=T_LR))
    state = init_train_state(model, plan,
                             torch.Generator(DEVICE).manual_seed(0))
    real_adam, saved = OPT.adam_update, OPT.SLICE_ELEMS
    events = []

    def timed_adam(*a, **k):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = real_adam(*a, **k)
        ev[1].record()
        events.append(ev)
        return out

    runs = []
    OPT.adam_update = timed_adam
    try:
        state, _ = step.fn(state, batch)
        sync()
        for size in ADAM_SLICES + ADAM_SLICES[::-1]:
            OPT.SLICE_ELEMS = size or (1 << 62)
            torch.cuda.reset_peak_memory_stats()
            events.clear()
            wall = []
            for _ in range(ADAM_SLICE_STEPS):
                t0 = time.perf_counter()
                state, m = step.fn(state, batch)
                sync()
                wall.append((time.perf_counter() - t0) * 1e3)
            runs.append(dict(
                slice_elems=size, step_ms=wall,
                update_ms=[a.elapsed_time(b) for a, b in events],
                peak=torch.cuda.max_memory_allocated(),
                loss=float(m["loss"])))
    finally:
        OPT.adam_update, OPT.SLICE_ELEMS = real_adam, saved
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    for r in runs:
        log(f"# adam slices, {name}, {r['slice_elems'] or 'whole leaf'}: "
            f"step ms {r['step_ms']}, update ms {r['update_ms']}, peak "
            f"{r['peak']} B")
    return runs


def adam_slices():
    """``--adam-slices``: Adam's update at each of ADAM_SLICES, in this
    process, in phase H's zamba2 step (all 54 layers on one card) and in
    phase U's granite step (the plan the tuner picks for one H100 at
    T_LAYERS) (``_slice_cell``); one JSON line."""
    from repro_torch.configs.base import get_arch
    from repro_torch.core.plan import single_stage_plan
    from repro_torch.core.tuner import MistTuner, TuneSpec
    from repro_torch.models.zoo import build_model
    from repro_torch.training.data import BatchSpec, SyntheticLM

    def batch_of(cfg, gbs, seq):
        data = SyntheticLM(BatchSpec(global_batch=gbs, seq_len=seq,
                                     vocab_size=cfg.vocab_size))
        return {k: torch.from_numpy(v).to(DEVICE)
                for k, v in data.batch(0).items()}

    out = {}
    cfg = get_arch("granite-3-8b").replace(num_layers=T_LAYERS)
    rep = MistTuner(TuneSpec(arch=cfg, seq_len=T_SEQ,
                             global_batch=T_MICRO * T_ACCUM, n_devices=1,
                             space="mist")).tune()
    plan = rep.plan.replace(attn_impl="pallas", use_pallas=True)
    out["granite-3-8b phase U plan"] = dict(
        plan=json.loads(plan.to_json()), runs=_slice_cell(
            "granite", build_model(cfg, DEVICE), plan,
            batch_of(cfg, T_MICRO * T_ACCUM, T_SEQ)))
    cfg = get_arch("zamba2-2.7b")
    plan = single_stage_plan(Z_LAYERS, dp=1, tp=1, micro_batch=H_MICRO,
                             grad_accum=H_ACCUM, zero=0, ckpt_layers=H_CKPT,
                             ao=H_AO_LAYERS / H_CKPT, attn_impl="pallas",
                             use_pallas=True, remat_policy="full")
    out["zamba2-2.7b phase H plan"] = dict(
        plan=json.loads(plan.to_json()), runs=_slice_cell(
            "zamba2", build_model(cfg, DEVICE), plan,
            batch_of(cfg, H_MICRO * H_ACCUM, H_SEQ)))
    log(json.dumps({"adam_slices": out, "smi": smi_line()}))


def phase_zamba2_rank():
    """Phase Z: zamba2-2.7b at full width and depth as rank 0 of a tp-4 plan
    with sequence parallelism (micro-batch Z_MICRO x 4096, G 2, CKPT 54),
    through the launcher (``--plan-json``) in a child process under the
    ``fake`` group, as phase D2 runs granite's rank: its Mamba mixers run
    20 of the 80 SSD heads, its shared block 8 of the 32 attention heads.
    Exact launch counts per step (phase H's rule for the same G and CKPT),
    the state term of the rank's peak split equal to the memory report's
    state bytes, the allocator's peak within Z_PEAK_BOUND of the memory
    report's peak, and the step time of one rank's
    compute without communication.  Returns the launches per step."""
    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.core.plan import single_stage_plan
    from repro_torch.lowering import lower_plan, plan_mesh

    cfg = get_arch("zamba2-2.7b")
    plan = single_stage_plan(Z_LAYERS, dp=1, tp=Z_TP, micro_batch=Z_MICRO,
                             grad_accum=H_ACCUM, zero=1, ckpt_layers=H_CKPT,
                             attn_impl="pallas", use_pallas=True,
                             remat_policy="full", sequence_parallel=True)
    gbs = Z_MICRO * H_ACCUM
    build = ROOT / "build"
    build.mkdir(parents=True, exist_ok=True)
    path = build / "z_plan.json"
    path.write_text(plan.to_json())
    t0 = time.perf_counter()
    text = _launcher_process(
        [str(Z_TP), "0", "--arch", "zamba2-2.7b", "--plan-json", str(path),
         "--steps", str(D_STEPS), "--seq", str(H_SEQ), "--global-batch",
         str(gbs)], code=_FAKE_RANK.replace("HOOK", _MEMORY_SPLIT),
        timeout=900)
    secs = time.perf_counter() - t0
    ms, _, counts, peak, pred = _launcher_lines(text)
    rule = _hybrid_launches(cfg, H_CKPT, H_ACCUM)
    per_step = _per_step(counts, rule, D_STEPS, "rank 0 of zamba2's tp plan")
    split = _split_terms(text, plan.grad_accum)
    rep = lower_plan(cfg, ShapeConfig("z", H_SEQ, gbs, "train"), plan,
                     plan_mesh(plan)).memory_report()
    st = rep.stages[0]
    state = split["weights_bf16"] + split["master_mu_nu"] \
        + split["grad_sums_f32"]
    log(json.dumps({"z_rank0_of_4": dict(
        model="zamba2-2.7b", layers=Z_LAYERS, seq=H_SEQ, global_batch=gbs,
        plan=json.loads(plan.to_json()),
        rank_ssd_shape_B_S_H=(Z_MICRO, H_SEQ, ZR_SSD_HEADS),
        rank_flash_shape_B_S_H_KV=(Z_MICRO, H_SEQ, ZR_HEADS, ZR_HEADS),
        launches_per_step=per_step, max_memory_allocated=peak,
        memory_report_peak_bytes=rep.peak_bytes,
        allocator_over_memory_report=peak / rep.peak_bytes,
        memory_report_terms=dict(state=st.state_bytes, act=st.act_bytes,
                                 transient=st.transient_bytes,
                                 logits=st.logits_bytes),
        launcher_predicted_peak_bytes=pred, peak_split_by_term=split,
        state_term_of_split=state,
        step_ms_compute_of_one_rank_no_communication=ms,
        median_step_ms_after_first=statistics.median(ms[1:]),
        process_seconds=secs, smi=smi_line())}))
    # the rank holds exactly the state the spec tables cut for it
    if state != st.state_bytes:
        raise AssertionError(f"zamba2's tp-4 rank holds {state} B of state; "
                             f"the memory report charges {st.state_bytes}")
    _peak_against_report("phase Z", cfg, plan, H_SEQ, gbs, peak, split,
                         Z_PEAK_BOUND, gate=True)
    return per_step


def _peak_against_report(what, cfg, plan, seq, gbs, peak, terms, bound,
                         gate):
    """The allocator's peak against the memory report's, with the phase
    that set it and that phase's term above the state: logged, and with
    ``gate`` raised over ``bound`` x the report.  Returns the record."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.lowering import lower_plan, plan_mesh

    rep = lower_plan(cfg, ShapeConfig("p", seq, gbs, "train"), plan,
                     plan_mesh(plan)).memory_report()
    st = rep.stages[0]
    state = terms["weights_bf16"] + terms["master_mu_nu"] \
        + terms["grad_sums_f32"]
    phases = [f"micro-batch {i} forward/backward"
              for i in range(len(terms["phase_peaks"]) - 1)] + ["update"]
    top = max(range(len(phases)), key=lambda i: terms["phase_peaks"][i])
    held = ("update_transient" if phases[top] == "update" else
            "saved_activations_one_micro_batch + "
            "backward_transient_over_saved")
    above = terms["phase_peaks"][top] - state
    rec = dict(max_memory_allocated=peak,
               memory_report_peak_bytes=rep.peak_bytes,
               allocator_over_memory_report=peak / rep.peak_bytes,
               bound=bound, state_of_split=state,
               memory_report_terms=dict(state=st.state_bytes,
                                        act=st.act_bytes,
                                        transient=st.transient_bytes,
                                        logits=st.logits_bytes),
               peak_phase=phases[top], held_by=held,
               bytes_above_state=above, split=terms)
    log(f"# {what}: allocator peak {peak} B, memory report {rep.peak_bytes}"
        f" B ({peak / rep.peak_bytes:.4f}x, bound {bound}x); the peak is "
        f"set in the {phases[top]}, {above} B above the state ({held}); "
        f"the report charges act {st.act_bytes} + transient "
        f"{st.transient_bytes} + logits {st.logits_bytes} B above its "
        f"state {st.state_bytes} B")
    if peak > bound * rep.peak_bytes:
        log(f"# {what}: the peak is over {bound}x the memory report, held "
            f"there by {held}: {above} B above the state")
        if gate:
            raise AssertionError(f"{what}: allocator peak {peak} B is over "
                                 f"{bound} x the memory report's "
                                 f"{rep.peak_bytes} B")
    return rec


def ssd_bwd_bound(b, s, h, p, n, g, q, esize):
    """(bound_ms, bound_by, arithmetic) for one SSD backward.  Operations:
    per (batch, head) and chunk, five products over the causal pairs (C
    B^T and dy x^T, then dx, dB and dC from them: 3 of width N, 2 of width
    P), and the Q x N x P state products this call's chunks need (the
    chunk's part of dH_in and C's carried-state term for every chunk but
    the first, dx's and dB's leaving-state terms for every chunk but the
    last), 2 flop per MAC at the bf16 tensor-core rate (f32 rate for f32).
    Bytes: x, dy, B/C (once per group), dt, a and the forward's f32 states
    read once; dx, dB, dC, ddt and da written once."""
    nc, pairs = s // q, q * (q + 1) // 2
    flops = b * h * (nc * 2 * pairs * (3 * n + 2 * p)
                     + (nc - 1) * 4 * 2 * q * n * p)
    nbytes = (3 * b * s * h * p + 4 * b * s * g * n) * esize \
        + 4 * (2 * b * s * h + 2 * h + (nc - 1) * b * h * n * p)
    peak, rate = (PEAK_BF16_FLOPS, "989 TFLOP/s bf16") if esize == 2 \
        else (PEAK_F32_FLOPS, "67 TFLOP/s f32")
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    how = (f"{flops / 1e9:.2f} GFLOP / {rate} = {t_ops * 1e6:.1f} us "
           f"(at 67 TFLOP/s f32: {flops / PEAK_F32_FLOPS * 1e6:.1f} us); "
           f"{nbytes / 1e6:.1f} MB / 3.35 TB/s = {t_bytes * 1e6:.1f} us")
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes", how


def _time_ssd_bwd(launches, err, shape=(H_MICRO, H_SEQ, SSD_HEADS),
                  model="zamba2-2.7b (training)"):
    """Phase H (d): the SSD backward entry at one (B, S, H) of zamba2's (its
    training shape by default), x/B/C laid out as the model gives them;
    its kernels' ptxas registers and spills (when this process built the
    library), shared memory, how many of its clusters the card holds at
    once, its f32 parts of dB and dC (written by the main kernel and read
    by the second), and the device time split by kernel.  No single
    PyTorch call computes the SSD scan's gradient, so there is no library
    yardstick."""
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_scan as SS

    (b, s, h), p, n, g, q = shape, SSD_P, SSD_N, SSD_G, SSD_CHUNK
    for kernel in ("ssd_bwd_tc_kernel", "ssd_bwd_f32_kernel"):
        for fn, args, regs, stores, loads in ptxas_report(_build.BUILD_LOG,
                                                          kernel):
            if args in ("", f"{p}, {n}") and h == SSD_HEADS:
                log(f"# ptxas {fn}<{args}>: {regs} registers, {stores} "
                    f"bytes spill stores, {loads} bytes spill loads")
    clusters = ctypes.c_int(0)
    _build.check(_build.load_library().mist_ssd_scan_bwd_occupancy(
        b, s, h, g, p, n, q, ctypes.byref(clusters)), "ssd bwd occupancy")
    cl = SS.bwd_cluster(h, g)
    parts_mb = 4 * math.prod(SS.bwd_parts_shape(b, s, h, g, n)) / 1e6
    log(f"# ssd bwd B{b} H{h}: {SS.bwd_smem_bytes(q, p, n)} B of shared "
        f"memory a block ({SS.BWD_TC_WARPS} warps), clusters of {cl} heads, "
        f"{clusters.value} clusters ({clusters.value * cl} blocks) resident "
        f"at once; f32 dB / dC parts {parts_mb:.1f} MB written and read "
        f"({2 * parts_mb:.1f} MB of traffic)")
    x, dt, a, bb, cc = _ssd_inputs(b, s, h, p, n, g, torch.bfloat16,
                                   seed=99)
    dy = torch.randn((b, s, h, p), generator=torch.Generator(
        DEVICE).manual_seed(98), device=DEVICE).to(torch.bfloat16)
    _, _, states = SS._launch(x, dt, a, bb, cc, q)
    kernel = lambda: SS._launch_bwd(  # noqa: E731
        x, dt, a, bb, cc, dy, states, q)
    ms = time_ms(kernel, reps=10)
    dev = time_ms(kernel, reps=10, device_only=True)
    cold = time_ms(kernel, reps=10, cold=True, device_only=True)
    plain = time_ms(lambda: SS.ssd_bwd_plain(x, dt, a, bb, cc, dy, q),
                    reps=3, warmup=1)
    parts = kernel_split_us(kernel, reps=3)
    log("# ssd bwd, device us per call by kernel (torch.profiler): "
        + ", ".join(f"{name} {us:.1f}" for name, us in parts.items()))
    bound, by, how = ssd_bwd_bound(b, s, h, p, n, g, q, 2)
    log(f"# ssd bwd B{b} H{h}: kernel {ms:.4f} ms (device {dev:.4f}, cold "
        f"L2 {cold:.4f}), plain {plain:.4f} ms; bound: {how} -> "
        f"{bound * 1e3:.1f} us ({by}), {bound / cold:.1%} of it cold")
    return dict(
        name="ssd_scan_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
        replaces="none: the gradient of src/repro/kernels/ssd_scan.py:20, "
                 "which the reference takes only through its jnp "
                 "src/repro/models/ssm.py:57",
        launches=launches, max_abs_err=err, ms=ms, plain_ms=plain,
        bound_ms=bound, bound_by=by, library_ms=None, device_ms=dev,
        library_device_ms=None, cold_ms=cold, library_cold_ms=None,
        parts_us=parts, model=model,
        shape=f"B{b} S{s} H{h} P{p} N{n} G{g} chunk {q} bf16")


# where an SSD backward block's time goes (``--ssd-bwd-phases``): a stamp
# goes in before the first line of each step of csrc/ssd_scan_bwd.cu's
# bf16 kernel; a step is named by the stamp that ends it
_SSD_BWD_STAMPS = (
    ("start", "  const int nc = S / Q, BH = args.B * H, HC = H / CL, BHC"),
    ("ticket", "  const int grp = h / (H / args.G);"),
    ("loads", "  // 2. cum = inclusive"),
    ("cumsum", "  // 3. this chunk's part of dH_in"),
    ("own part", "  // the chain: wait for dH"),
    ("chain wait", "  const float dec = expf(cum_last);"),
    ("publish", "  // warp w owns rows [16 w"),
    ("pass B", "  // 5. pass A: the block as queries"),
    ("pass A", "  // 6. this head's f32 dB"),
    ("staging", "  cluster.sync();  // every block's staging is written"),
    ("barrier", "  // 7. dcum, its reverse cumsum"),
    ("scan", "  cluster.sync();  // no block leaves"),
)


def ssd_bwd_phases():
    """``--ssd-bwd-phases``: at zamba2's training shape, the mean time of
    each step of an SSD backward block (thread 0's view: warp 0 runs the
    scan at the end while the other warps sum the cluster's dB and dC),
    from a copy of the source with a ``%globaltimer`` stamp before each
    step, built beside the library (``build/ssd_bwd_phases/``)."""
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_scan as SS

    src = (_build.CSRC / "ssd_scan_bwd.cu").read_text()
    a = src.index("ssd_bwd_tc_kernel(const BwdArgs args) {")
    z = src.index("// f32 route: the port's first backward kernel")
    body = src[a:z].replace(
        "  const int bh = b * H + h;\n",
        "  const int bh = b * H + h;\n  const int pid = ticket * CL + rank;\n"
        "  if (tid == 0) g_phases[pid][0] = t_start;\n", 1)
    for k, (_, line) in enumerate(_SSD_BWD_STAMPS):
        if body.count(line) != 1:
            raise RuntimeError(f"ssd bwd phases: {line.strip()!r} is not "
                               f"one line of the kernel")
        stamp = ("  const unsigned long long t_start = stamp_now();\n"
                 if k == 0 else
                 f"  if (tid == 0) g_phases[pid][{k}] = stamp_now();\n")
        body = body.replace(line, stamp + line)
    head = ("__device__ unsigned long long g_phases[65536][16];\n"
            "__device__ __forceinline__ unsigned long long stamp_now() {\n"
            "  unsigned long long t;\n"
            "  asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t));\n"
            "  return t;\n}\n")
    src = src[:a] + body + src[z:]
    src = src.replace("namespace cg = cooperative_groups;\n",
                      "namespace cg = cooperative_groups;\n" + head, 1)
    src += ("\nextern \"C\" int mist_ssd_bwd_phases(void* dst, int n) {\n"
            "  return (int)cudaMemcpyFromSymbol(dst, g_phases, "
            "(size_t)n * 16 * 8);\n}\n")
    out = ROOT / "build" / "ssd_bwd_phases"
    out.mkdir(parents=True, exist_ok=True)
    (out / "ssd_scan_bwd.cu").write_text(src)
    nvcc = _build.find_nvcc()
    objs = []
    for f in (_build.CSRC / "common.cu", _build.CSRC / "ssd_scan.cu",
              out / "ssd_scan_bwd.cu"):
        objs.append(out / f"{f.stem}.o")
        subprocess.run([nvcc, *_build.NVCC_FLAGS, "-c", str(f), "-o",
                        str(objs[-1])], check=True, capture_output=True)
    subprocess.run([nvcc, *_build.ARCH_FLAGS, "-shared", "-o",
                    str(out / "lib.so"), *map(str, objs)], check=True)
    lib = ctypes.CDLL(str(out / "lib.so"))
    p_, i_, ll_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mist_ssd_scan.argtypes = [p_] * 9 + [i_] * 8 + [ll_] * 12 + [p_]
    lib.mist_ssd_scan_bwd.argtypes = [p_] * 16 + [i_] * 8 + [ll_] * 12 + [p_]
    lib.mist_error_string.argtypes = [i_]
    lib.mist_error_string.restype = ctypes.c_char_p
    lib.mist_ssd_bwd_phases.argtypes = [p_, i_]
    built, _build._lib = _build._lib, lib
    try:
        b, s, h, p, n, g, q = (H_MICRO, H_SEQ, SSD_HEADS, SSD_P, SSD_N,
                               SSD_G, SSD_CHUNK)
        x, dt, a, bb, cc = _ssd_inputs(b, s, h, p, n, g, torch.bfloat16,
                                       seed=99)
        dy = torch.randn((b, s, h, p), generator=torch.Generator(
            DEVICE).manual_seed(98), device=DEVICE).to(torch.bfloat16)
        _, _, states = SS._launch(x, dt, a, bb, cc, q)
        for _ in range(2):
            SS._launch_bwd(x, dt, a, bb, cc, dy, states, q)
        sync()
        items = b * h * (s // q)
        t = torch.zeros((items, 16), dtype=torch.int64)
        _build.check(lib.mist_ssd_bwd_phases(t.data_ptr(), items),
                     "ssd bwd phases")
    finally:
        _build._lib = built
    t = t[:, :len(_SSD_BWD_STAMPS)].double() / 1e3  # us
    steps = t[:, 1:] - t[:, :-1]
    log(f"# ssd bwd phases, us a block (mean of {items}): " + ", ".join(
        f"{nm} {float(steps[:, k].mean()):.2f}"
        for k, (nm, _) in enumerate(_SSD_BWD_STAMPS[1:])) +
        f"; to its last barrier {float((t[:, -1] - t[:, 0]).mean()):.2f}, "
        f"kernel span {float(t[:, -1].max() - t[:, 0].min()):.1f}")


def _time_serve(arch, model, params, prompts, plan, peak):
    """The serve loop: prefill, decode per step, whole generate()."""
    from repro_torch.launch.serve import generate
    from repro_torch.models.zoo import pad_caches
    from repro_torch.training.step import make_prefill_step, make_serve_step

    max_len = PROMPT_LEN + GEN
    prefill = make_prefill_step(model, plan, return_cache=True)
    serve = make_serve_step(model, plan, batch=BATCH, max_len=max_len)
    batch = {"tokens": prompts}
    prefill_ms = time_ms(lambda: prefill.fn(params, batch), reps=3,
                         warmup=1)
    logits, caches = prefill.fn(params, batch)
    caches = pad_caches(caches, GEN)
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    sync()
    t0 = time.perf_counter()
    for _ in range(GEN - 1):
        logits, caches = serve.fn(params, tok, caches)
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    sync()
    decode_ms = (time.perf_counter() - t0) * 1e3 / (GEN - 1)
    t0 = time.perf_counter()
    generate(model, params, prompts, GEN, plan)
    sync()
    gen_s = time.perf_counter() - t0
    weight_bytes = sum(p.numel() * p.element_size() for p in params.values())
    serve_numbers = dict(
        model=arch, prefill_ms=prefill_ms, decode_ms_per_step=decode_ms,
        generate_s=gen_s, generated_tok_per_s=BATCH * GEN / gen_s,
        max_memory_allocated=peak,
        decode_bound_ms=weight_bytes / PEAK_BYTES * 1e3,
        decode_bound="weights read once per step: "
                     f"{weight_bytes / 1e9:.2f} GB / 3.35 TB/s")
    log(json.dumps({"serve": serve_numbers}))


def _device_window(fn, trace: Path):
    """Profile one call of ``fn``: wall time, device busy time (the union of
    the CUDA kernel and memcpy intervals), idle share, top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        tot, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + (b - a), n + 1)
    if not spans:
        raise RuntimeError("the profiler recorded no device activity")
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    groups = {}
    for n, (t, _) in by_name.items():
        g = next((label for label, keys in _KERNEL_GROUPS
                  if any(k in n for k in keys)), "other")
        groups[g] = groups.get(g, 0.0) + t / 1e3
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / wall_us, "device_events": len(spans),
            "groups_ms": groups,
            "top": [{"name": n[:90], "ms": t / 1e3, "count": c}
                    for n, (t, c) in top]}


# device time by kind in a profile window: the first group whose keys occur
# in a kernel's name takes it
_KERNEL_GROUPS = (
    ("memcpy/memset", ("Memcpy", "Memset")),
    ("flash (port)", ("flash_fwd", "flash_bwd", "fa_bwd")),
    ("rmsnorm (port)", ("rmsnorm",)),
    ("ssd (port)", ("ssd_scan",)),
    ("ssd bwd (port)", ("ssd_bwd",)),
    ("gemm (cuBLAS)", ("gemm", "xmma", "nvjet", "cutlass", "Kernel2")),
)


def phase_profile(arch, model, params, prompts, plan):
    from repro_torch.models.zoo import pad_caches
    from repro_torch.training.step import make_prefill_step, make_serve_step

    out_dir = ROOT / "build" / "profile" / arch
    prefill = make_prefill_step(model, plan, return_cache=True)
    serve = make_serve_step(model, plan, batch=BATCH,
                            max_len=PROMPT_LEN + GEN)
    batch = {"tokens": prompts}
    state = {}

    def run_prefill():
        state["logits"], state["caches"] = prefill.fn(params, batch)

    def run_decode(steps=3):
        tok = state["tok"]
        for _ in range(steps):
            logits, state["caches"] = serve.fn(params, tok, state["caches"])
            tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]

    report = {"prefill": _device_window(run_prefill,
                                        out_dir / "trace_prefill.json")}
    state["caches"] = pad_caches(state["caches"], GEN)
    state["tok"] = state["logits"][:, -1].argmax(-1).to(torch.int32)[:, None]
    run_decode(1)  # warm
    report["decode_3_steps"] = _device_window(
        run_decode, out_dir / "trace_decode.json")
    log(json.dumps({"profile": report, "model": arch}))


# ---------------------------------------------------------------------------
# phase M: the MoE family (qwen2-moe-a2.7b)
# ---------------------------------------------------------------------------


def _moe_train_plan(layers, tp=1):
    from repro_torch.core.plan import single_stage_plan
    return single_stage_plan(layers, dp=1, tp=tp, micro_batch=T_MICRO,
                             grad_accum=T_ACCUM, zero=0 if tp == 1 else 1,
                             ckpt_layers=layers, attn_impl="pallas",
                             use_pallas=True, remat_policy="full",
                             sequence_parallel=tp > 1)


def _moe_launcher_in_process(plan, layers, steps, tag):
    """``launch.train.main`` in this process on ``plan`` at ``layers``
    layers of qwen2-moe (Adam at T_LR), with ``_MEMORY_SPLIT``'s hooks;
    every count set to 0 just before and read just after.  Returns (the
    launcher's output, counts per step, its lines, the split's terms)."""
    import contextlib
    import io

    from repro_torch.launch import train as launch_train

    path = ROOT / "build" / f"m_plan_{tag}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(plan.to_json())
    argv = ["--arch", "qwen2-moe-a2.7b", "--layers", str(layers),
            "--plan-json", str(path), "--steps", str(steps), "--seq",
            str(T_SEQ), "--global-batch", str(T_MICRO * T_ACCUM), "--lr",
            str(T_LR)]
    out = io.StringIO()
    split, unhook = _split_in_process()
    _reset_counts()
    try:
        with contextlib.redirect_stdout(out):
            rc = launch_train.main(argv)
        sync()
    finally:
        unhook()
    counts = _read_counts()
    text = out.getvalue()
    log(f"# python -m repro_torch.launch.train {' '.join(argv)}: exit {rc}\n"
        + text.strip())
    if rc != 0:
        raise AssertionError(f"the training launcher failed ({tag})")
    lines = _launcher_lines(text)
    st = plan.stages[0]
    per_step = _per_step(counts, _train_launches(
        layers, min(st.ckpt_layers, layers), plan.grad_accum), steps,
        f"qwen2-moe {tag}")
    terms = _terms_of_split(split, plan.grad_accum)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return text, per_step, lines, terms


def _moe_train_one_card():
    """Phase M (b): the written plan at M_T_LAYERS layers, then the tuner's
    plan for the same depth on one H100.  Returns the written plan's
    launches per step."""
    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.core.tuner import tune

    cfg = get_arch("qwen2-moe-a2.7b")
    plan = _moe_train_plan(M_T_LAYERS)
    gbs = T_MICRO * T_ACCUM
    _, per_step, (ms, losses, _, peak, pred), terms = \
        _moe_launcher_in_process(plan, M_T_LAYERS, M_STEPS, "written")
    rec = _peak_against_report("phase M (b)", cfg.replace(
        num_layers=M_T_LAYERS), plan, T_SEQ, gbs, peak, terms, H_PEAK_BOUND,
        gate=False)
    log(json.dumps({"train_moe": dict(
        model="qwen2-moe-a2.7b", layers=M_T_LAYERS, seq=T_SEQ,
        global_batch=gbs, plan=json.loads(plan.to_json()), lr=T_LR,
        losses=losses, step_ms=ms, median_step_ms_after_first=
        statistics.median(ms[1:]), tokens_per_s=gbs * T_SEQ /
        (statistics.median(ms[1:]) / 1e3), launches_per_step=per_step,
        launcher_predicted_peak_bytes=pred,
        peak_against_memory_report=rec, smi=smi_line())}))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("qwen2-moe training: a non-finite loss")
    # the launcher draws a new batch each step, so the loss need not fall
    # at every step: it must over the run
    if not losses[-1] < losses[0]:
        raise AssertionError(f"qwen2-moe training: the loss does not fall: "
                             f"{losses}")

    # the tuner's plan for the same depth on one H100
    cfg4 = cfg.replace(num_layers=M_T_LAYERS)
    t0 = time.perf_counter()
    rep = tune(cfg4, ShapeConfig("m", T_SEQ, gbs, "train"), n_devices=1)
    log(f"# phase M (b): the tuner for qwen2-moe at {M_T_LAYERS} layers on "
        f"one H100 ({time.perf_counter() - t0:.1f} s): "
        + (f"predicted step {rep.objective:.4f} s, plan "
           f"{rep.plan.to_json()}" if rep.plan is not None
           else f"no feasible plan of {rep.n_swept} swept"))
    if rep.plan is None:
        raise AssertionError("the tuner finds no plan for qwen2-moe at "
                             f"{M_T_LAYERS} layers on one H100")
    tplan = rep.plan.replace(attn_impl="pallas", use_pallas=True)
    _, t_step, (t_ms, t_losses, _, t_peak, t_pred), t_terms = \
        _moe_launcher_in_process(tplan, M_T_LAYERS, M_TUNED_STEPS, "tuned")
    t_rec = _peak_against_report(
        "phase M (b), tuned plan", cfg4, tplan, T_SEQ, gbs, t_peak, t_terms,
        H_PEAK_BOUND, gate=False)
    log(json.dumps({"train_moe_tuned": dict(
        plan=json.loads(tplan.to_json()), predicted_step_s=rep.objective,
        step_ms=t_ms, losses=t_losses, launches_per_step=t_step,
        launcher_predicted_peak_bytes=t_pred,
        peak_against_memory_report=t_rec, smi=smi_line())}))
    if not all(math.isfinite(x) for x in t_losses):
        raise AssertionError("qwen2-moe, the tuned plan: a non-finite loss")
    return per_step


def _moe_rank_of_tp4():
    """Phase M (c): rank 0 of a tp-4 + SP plan of qwen2-moe at M_R_LAYERS
    layers (15 experts a rank) under the ``fake`` group in a child process.
    Returns its launches per step."""
    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.lowering import lower_plan, plan_mesh

    cfg = get_arch("qwen2-moe-a2.7b").replace(num_layers=M_R_LAYERS)
    plan = _moe_train_plan(M_R_LAYERS, tp=M_TP)
    gbs = T_MICRO * T_ACCUM
    path = ROOT / "build" / "m_rank_plan.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(plan.to_json())
    t0 = time.perf_counter()
    text = _launcher_process(
        [str(M_TP), "0", "--arch", "qwen2-moe-a2.7b", "--layers",
         str(M_R_LAYERS), "--plan-json", str(path), "--steps", str(D_STEPS),
         "--seq", str(T_SEQ), "--global-batch", str(gbs), "--lr",
         str(T_LR)], code=_FAKE_RANK.replace("HOOK", _MEMORY_SPLIT),
        timeout=600)
    secs = time.perf_counter() - t0
    ms, _, counts, peak, pred = _launcher_lines(text)
    per_step = _per_step(counts, _train_launches(M_R_LAYERS, M_R_LAYERS,
                                                 T_ACCUM),
                         D_STEPS, "rank 0 of qwen2-moe's tp-4 plan")
    split = _split_terms(text, plan.grad_accum)
    st = lower_plan(cfg, ShapeConfig("m", T_SEQ, gbs, "train"), plan,
                    plan_mesh(plan)).memory_report().stages[0]
    state = split["weights_bf16"] + split["master_mu_nu"] \
        + split["grad_sums_f32"]
    rec = _peak_against_report("phase M (c)", cfg, plan, T_SEQ, gbs, peak,
                               split, H_PEAK_BOUND, gate=False)
    log(json.dumps({"m_rank0_of_4": dict(
        model="qwen2-moe-a2.7b", layers=M_R_LAYERS, seq=T_SEQ,
        global_batch=gbs, plan=json.loads(plan.to_json()),
        experts_per_rank=M_EXPERTS // M_TP, launches_per_step=per_step,
        state_term_of_split=state, memory_report_state_bytes=st.state_bytes,
        launcher_predicted_peak_bytes=pred, peak_against_memory_report=rec,
        step_ms_compute_of_one_rank_no_communication=ms,
        process_seconds=secs, smi=smi_line())}))
    if state != st.state_bytes:
        raise AssertionError(f"qwen2-moe's tp-4 rank holds {state} B of "
                             f"state; the memory report charges "
                             f"{st.state_bytes}")
    return per_step


def phase_moe(errs, profile=False):
    """Phase M (module docstring).  Returns its entries of the kernels
    line."""
    model, params, prompts, plan, launches, peak = phase_full_width_serve(
        "qwen2-moe-a2.7b", dict(num_layers=M_LAYERS, d_model=M_D_MODEL,
                                num_heads=M_HEADS, num_kv_heads=M_HEADS,
                                head_dim=HEAD_DIM, num_experts=M_EXPERTS,
                                num_experts_per_tok=4, num_shared_experts=4,
                                moe_d_ff=1408, qkv_bias=True),
        _granite_launches, f32_truth=True)
    phase_reduced_vs_cpu("qwen2-moe-a2.7b", f32_truth=True)
    kernels = [
        _time_flash("qwen2-moe-a2.7b", BATCH, PROMPT_LEN, M_HEADS, M_HEADS,
                    HEAD_DIM, launches["flash_attention_fwd"],
                    errs["flash_attention_fwd@qwen2_moe"]),
        *_time_rmsnorm("qwen2-moe-a2.7b", M_D_MODEL, launches["rmsnorm"],
                      errs[f"rmsnorm@d{M_D_MODEL}"])]
    _time_serve("qwen2-moe-a2.7b", model, params, prompts, plan, peak)
    if profile:
        phase_profile("qwen2-moe-a2.7b", model, params, prompts, plan)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    train = _moe_train_one_card()
    shape = (T_MICRO, T_SEQ, M_HEADS, M_HEADS, HEAD_DIM)
    what = "qwen2-moe-a2.7b (training)"
    kernels += [
        _time_flash(what, *shape, train["flash_attention_fwd"],
                    errs["flash_attention_fwd@qwen2_moe_train"]),
        _time_flash_bwd(train["flash_attention_bwd"],
                        errs["flash_attention_bwd@qwen2_moe"], shape, what),
        _time_rmsnorm_bwd(train["rmsnorm_bwd"],
                          errs[f"rmsnorm_bwd@d{M_D_MODEL}"], M_D_MODEL, what)]
    _moe_rank_of_tp4()
    return kernels


# ---------------------------------------------------------------------------
# phase S: the continuous-batching engine (serving/)
# ---------------------------------------------------------------------------


def _s_requests(cfg, n, chunk=None):
    """``n`` requests from numpy seed 0: prompts of S_PLENS tokens, output
    budgets of S_GENS.  With ``chunk`` (the hybrid's SSD chunk) a prompt
    at least a chunk long is cut to a whole number of chunks: the SSD
    prefill takes S below the chunk or a multiple of it, as the
    reference's (``ssd_scan.chunk_len``)."""
    import numpy as np
    rng = np.random.default_rng(0)
    plens = rng.integers(S_PLENS[0], S_PLENS[1] + 1, n)
    gens = rng.integers(S_GENS[0], S_GENS[1] + 1, n)
    if chunk:
        plens = np.where(plens < chunk, plens, plens - plens % chunk)
    return [(torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, int(p)),
                                           dtype=np.int32)).to(DEVICE),
             int(g)) for p, g in zip(plens, gens)]


def _s_launches(cfg, admissions, steps):
    """Exact counts of the engine's run: each admission's batch-1 prefill
    and each decode step launch one RMSNorm kernel per norm of a forward
    (a hybrid's decode step also one per Mamba2 layer's gated norm); each
    prefill launches flash (and the hybrid's SSD) once per attention
    (Mamba2) layer, and a decode step neither."""
    if cfg.family == "hybrid":
        groups = cfg.num_layers // cfg.shared_attn_every
        flash, ssd, norms = groups, cfg.num_layers, \
            2 * groups + cfg.num_layers + 1
        gated = cfg.num_layers
    else:
        flash, ssd, norms = cfg.num_layers, 0, 2 * cfg.num_layers + 1
        gated = 0
    return {"flash_attention_fwd": admissions * flash,
            "flash_attention_bwd": 0,
            "rmsnorm": (admissions + steps) * norms + steps * gated,
            "rmsnorm_bwd": 0, "ssd_scan": admissions * ssd,
            "ssd_scan_bwd": 0}


def _s_static(model, params, plan, prompt, gen, slots=1, row=0,
              forced=None):
    """One request through the contiguous static decode at S_MAX_LEN:
    batch 1 (``generate``'s path), or batch ``slots`` with the request in
    row ``row`` and zero rows elsewhere (token 0, zero caches: the engine's
    M).  ``forced``: feed these tokens instead of the greedy ones.  Returns
    (tokens, each token's logits row, f32)."""
    from repro_torch.models.zoo import pad_caches, quantize_caches
    from repro_torch.serving.pages import classify_cache_tree, tree_get
    from repro_torch.training.step import make_prefill_step, make_serve_step

    kv8 = plan.kv_cache_dtype == "int8"
    prefill = make_prefill_step(model, plan, return_cache=True)
    serve = make_serve_step(model, plan, batch=slots, max_len=S_MAX_LEN)
    with torch.inference_mode():
        logits, caches = prefill.fn(params, {"tokens": prompt})
        if kv8:
            caches = quantize_caches(caches)
        caches = pad_caches(caches, S_MAX_LEN - prompt.shape[1])
        if slots > 1:
            full = model.init_caches(
                slots, S_MAX_LEN, torch.int8 if kv8 else torch.bfloat16)
            for sp in classify_cache_tree(model.cfg, slots, S_MAX_LEN,
                                          plan.kv_cache_dtype):
                dst, src = tree_get(full, sp.path), tree_get(caches, sp.path)
                if sp.bdim is None:
                    dst.copy_(src)                          # pos
                else:
                    dst.select(sp.bdim, row).copy_(src.select(sp.bdim, 0))
            caches = full
        rows = [logits[0, -1].float()]
        toks = [int(rows[0].argmax())]
        tok = torch.zeros((slots, 1), dtype=torch.int32, device=DEVICE)
        for i in range(1, gen):
            tok[row, 0] = toks[-1] if forced is None else forced[i - 1]
            logits, caches = serve.fn(params, tok, caches)
            rows.append(logits[row, -1].float())
            toks.append(int(rows[-1].argmax()))
    return toks, rows


def _s_engine(model, params, plan, reqs, page_size):
    """The engine over ``reqs``, every launch counter set to 0 just before
    and read just after.  Returns (results, engine, launches, wall s, peak
    bytes, trace): the trace has each decode step's logits and each active
    request's (slot, tokens emitted before the step)."""
    from repro_torch.serving import ContinuousBatchingEngine

    eng = ContinuousBatchingEngine(model, params, plan, slots=S_SLOTS,
                                   max_len=S_MAX_LEN, page_size=page_size)
    trace = []
    step = eng._step.fn

    def traced(p, tokens, state, bt):
        who = {st.rid: (slot, st.emitted)
               for slot, st in eng.sched.active.items()}
        logits, state = step(p, tokens, state, bt)
        trace.append((who, logits[:, -1].float()))
        return logits, state
    eng._step.fn = traced
    for i, (prompt, gen) in enumerate(reqs):
        eng.submit({"tokens": prompt}, gen, rid=i)
    sync()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    res = eng.run()
    sync()
    wall = time.perf_counter() - t0
    launches = _read_counts()
    return res, eng, launches, wall, torch.cuda.max_memory_allocated(), trace


def _s_check_tokens(what, model, params, plan, reqs, res, trace):
    """Every request's tokens against the batch-1 static decode, bitwise.
    Where they differ, the first differing token's logits are compared at M
    = 1 and M = S_SLOTS; if the engine's row equals the batch-S_SLOTS static
    decode's bitwise there (the row's result depends on M, not on the
    engine), every request is held to that comparator instead.  Any other
    difference raises.  Returns (comparator, batch-1 tokens)."""
    import numpy as np
    one = [_s_static(model, params, plan, p, g) for p, g in reqs]
    bad = [i for i, (t, _) in enumerate(one)
           if not np.array_equal(res[i], t)]
    log(f"# {what}: tokens == batch-1 static decode at max_len {S_MAX_LEN}"
        f" for {len(reqs) - len(bad)} of {len(reqs)} requests")
    if not bad:
        return "batch-1", [t for t, _ in one]
    rid = bad[0]
    d = int(np.argmax(np.asarray(res[rid]) != np.asarray(one[rid][0])))
    if d == 0:
        raise AssertionError(f"{what}: request {rid}'s prefill token "
                             "differs from the static path's")
    who, lg = next((w, lg) for w, lg in trace if w.get(rid, (0, -1))[1]
                   == d)
    slot = who[rid][0]
    wide_toks, wide = _s_static(model, params, plan, *reqs[rid],
                                slots=S_SLOTS, row=slot)
    eng_row = lg[slot]
    log(f"# {what}: request {rid} first differs at token {d} (slot {slot}):"
        f" engine vs batch-1 logits max |diff| "
        f"{float((eng_row - one[rid][1][d]).abs().max()):.4e}, engine vs "
        f"batch-{S_SLOTS} static (row {slot}) bitwise "
        f"{torch.equal(eng_row, wide[d])}")
    if not torch.equal(eng_row, wide[d]):
        raise AssertionError(f"{what}: the engine's row differs from the "
                             "static decode at the same M: a fault of the "
                             "port, not the GEMMs'")
    if not _s_gemm_rows(what, model, params, plan, slot):
        raise AssertionError(f"{what}: the row depends on M, but no GEMM of "
                             "the decode step does")
    same = 0
    for i, (p, g) in enumerate(reqs):
        t = wide_toks if i == rid else _s_static(
            model, params, plan, p, g, slots=S_SLOTS,
            row=next(w[i][0] for w, _ in trace if i in w))[0]
        if not np.array_equal(res[i], t):
            raise AssertionError(f"{what}: request {i} differs from the "
                                 f"batch-{S_SLOTS} static decode too")
        same += 1
    log(f"# {what}: tokens == batch-{S_SLOTS} static decode (the request in "
        f"its engine slot, zero rows elsewhere) for {same} of {len(reqs)} "
        f"requests; batch-1: {len(reqs) - len(bad)} of {len(reqs)}")
    return f"batch-{S_SLOTS}", [t for t, _ in one]


def _s_gemm_rows(what, model, params, plan, row):
    """Every product of an activation by a 2-D weight (``aten.matmul``,
    ``mm`` / ``addmm``) in one contiguous decode step at batch S_SLOTS, run
    again on row ``row`` of its left operand alone (M = 1): logs the
    products whose row differs bitwise from the batch's, by shape, and
    returns their number."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.training.step import make_serve_step

    mm, addmm = torch.ops.aten.mm.default, torch.ops.aten.addmm.default
    gemms = (torch.ops.aten.matmul.default, mm, addmm)
    seen = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func in gemms:
                seen.append((func, args, kwargs or {}, out))
            return out

    serve = make_serve_step(model, plan, batch=S_SLOTS, max_len=S_MAX_LEN)
    caches = model.init_caches(
        S_SLOTS, S_MAX_LEN,
        torch.int8 if plan.kv_cache_dtype == "int8" else torch.bfloat16)
    tok = torch.randint(0, model.cfg.vocab_size, (S_SLOTS, 1),
                        generator=torch.Generator(DEVICE).manual_seed(0),
                        device=DEVICE, dtype=torch.int32)
    with torch.inference_mode():
        with Record():
            serve.fn(params, tok, caches)
        differ = {}
        for func, args, kwargs, out in seen:
            a, w = args[-2:] if func is addmm else args[:2]
            if a.shape[0] != S_SLOTS or w.dim() != 2:
                continue
            one = a[row:row + 1]
            alone = torch.addmm(args[0], one, w, **kwargs) \
                if func is addmm else func(one, w)
            key = f"{tuple(a.shape)} x {tuple(w.shape)}"
            n, bad = differ.get(key, (0, 0))
            differ[key] = (n + 1, bad + int(not torch.equal(alone[0],
                                                            out[row])))
    n_bad = sum(b for _, b in differ.values())
    log(f"# {what}: the decode step's weight products at M = {S_SLOTS}, row "
        f"{row} run alone (M = 1): {n_bad} of "
        f"{sum(n for n, _ in differ.values())} differ bitwise; by shape "
        f"(products, differing): {differ}")
    return n_bad


def _alternating_ms(fns, reps):
    """Median CUDA-event ms of each call in ``fns`` ({name: fn}), timed in
    turns (each name once a round, the order reversed every other round)
    after two warm-up calls each."""
    for fn in fns.values():
        fn()
        fn()
    times = {k: [] for k in fns}
    order = list(fns)
    for i in range(reps):
        for k in (order if i % 2 == 0 else order[::-1]):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fns[k]()
            b.record()
            b.synchronize()
            times[k].append(a.elapsed_time(b))
    return {k: statistics.median(v) for k, v in times.items()}


def _s_step_ms(eng, model, params, plan):
    """The paged step against the contiguous step at batch S_SLOTS and the
    same max_len, every slot active near the horizon; the paged step split
    into gather + mask, decode and scatter."""
    from repro_torch.serving.pages import tree_get
    from repro_torch.training.step import make_serve_step

    step, npp = eng._step, eng.npp
    pos = S_MAX_LEN - 1 - S_GENS[1] - torch.arange(S_SLOTS, device=DEVICE,
                                                   dtype=torch.int32)
    bt = torch.arange(S_SLOTS * npp, dtype=torch.int32,
                      device=DEVICE).view(S_SLOTS, npp)
    tokens = torch.ones((S_SLOTS, 1), dtype=torch.int32, device=DEVICE)
    with torch.inference_mode():
        for sp in eng.specs:
            if sp.is_pos:
                tree_get(eng.state, sp.path).copy_(
                    pos.expand(sp.shape + (S_SLOTS,)))
        state = eng.state
        dense = step.gather(state, bt)
        serve = make_serve_step(model, plan, batch=S_SLOTS,
                                max_len=S_MAX_LEN)
        caches = model.init_caches(
            S_SLOTS, S_MAX_LEN,
            torch.int8 if plan.kv_cache_dtype == "int8" else torch.bfloat16)
        for sp in eng.specs:
            if sp.is_pos:
                tree_get(caches, sp.path).fill_(int(pos[0]))
        ms = _alternating_ms(dict(
            paged=lambda: step.fn(params, tokens, state, bt),
            contiguous=lambda: serve.fn(params, tokens, caches),
            gather_mask=lambda: step.gather(state, bt),
            decode=lambda: step.decode(params, tokens, dense),
            scatter=lambda: step.scatter(state, dense, bt, pos)),
            S_STEP_REPS)
        del dense, caches
    return ms


def _s_int8_tracks_bf16(model, params, plan, plan8, req, toks16):
    """The reference's rule on one request, teacher-forced on the bf16
    static decode's tokens: the int8 static decode's argmax equals the
    bf16 one's wherever the bf16 top-2 margin exceeds twice the largest
    int8-bf16 logit difference.  Returns that difference."""
    _, lg16 = _s_static(model, params, plan, *req, forced=toks16)
    _, lg8 = _s_static(model, params, plan8, *req, forced=toks16)
    a16, a8 = torch.stack(lg16), torch.stack(lg8)
    err = float((a16 - a8).abs().max())
    top2 = a16.topk(2, dim=-1).values
    decisive = (top2[:, 0] - top2[:, 1]) > 2 * err
    agree = a16.argmax(-1) == a8.argmax(-1)
    log(f"# int8 vs bf16 static decode, teacher-forced ({len(lg16)} "
        f"tokens): max |logit diff| {err:.4e}, max |logit| "
        f"{float(a16.abs().max()):.4f}, decisive steps "
        f"{int(decisive.sum())}, argmax agreement "
        f"{float(agree.float().mean())}")
    if not (torch.isfinite(a8).all() and bool(agree[decisive].all())):
        raise AssertionError("int8 decode: argmax moved where the bf16 "
                             "margin exceeds twice the int8 error")
    return err


def _s_model(arch, dims, int8=False):
    """Phase S for one model (module docstring)."""
    from repro_torch.configs.base import get_arch
    from repro_torch.launch.serve import tuned_serve_plan
    from repro_torch.lowering import serve_exec_cfg
    from repro_torch.lowering.cache_layout import concrete_paged_cache_bytes
    from repro_torch.models.zoo import build_model
    from repro_torch.serving.pages import tree_get

    t_start = time.perf_counter()
    cfg = get_arch(arch)
    got_dims = {k: getattr(cfg, k) for k in dims}
    assert got_dims == dims, (got_dims, dims)
    model = build_model(cfg, DEVICE)
    params, _ = model.init(torch.Generator(DEVICE).manual_seed(0))
    plan, report = tuned_serve_plan(cfg, batch=S_SLOTS, max_len=S_MAX_LEN,
                                    page_grid=(0, S_PAGE))
    st = plan.stages[0]
    log(f"# {arch}: tuned serve plan for {S_SLOTS} x {S_MAX_LEN}: dp={st.dp} "
        f"tp={st.tp} zero={st.zero} kv={plan.kv_cache_dtype} page_size="
        f"{plan.page_size} (objective {report.objective:.6f} s)")
    # the cost model prices flash attention: serve with its kernel, as the
    # launcher does
    plan = plan.replace(attn_impl="pallas", use_pallas=True)
    page = plan.page_size or S_PAGE
    reqs = _s_requests(cfg, S_REQUESTS[arch], serve_exec_cfg(plan).ssd_chunk
                       if cfg.family == "hybrid" else None)
    log(f"# {arch}: {len(reqs)} requests, prompts "
        f"{[int(p.shape[1]) for p, _ in reqs]}, budgets "
        f"{[g for _, g in reqs]}")
    out = []
    for kv in ("bf16", "int8") if int8 else ("bf16",):
        p = plan.replace(kv_cache_dtype=kv)
        what = f"{arch} ({kv})"
        res, eng, launches, wall, peak, trace = _s_engine(model, params, p,
                                                          reqs, page)
        want = _s_launches(cfg, eng.admissions, eng.steps_run)
        log(f"# {what}: engine launches {launches}; admissions "
            f"{eng.admissions}, decode steps {eng.steps_run}")
        if launches != want:
            raise AssertionError(f"{what}: launch counts {launches} != "
                                 f"{want}")
        comparator, toks1 = _s_check_tokens(what, model, params, p, reqs,
                                            res, trace)
        if kv == "bf16":
            toks16 = toks1
        else:
            attn = eng.state.get("attn", eng.state)
            if not (attn["k"].dtype == attn["v"].dtype == torch.int8 and
                    attn["k_scale"].dtype == attn["v_scale"].dtype
                    == torch.float32):
                raise AssertionError(f"{what}: pool dtypes "
                                     f"{[(k, t.dtype) for k, t in attn.items()]}")
            err8 = _s_int8_tracks_bf16(model, params, plan, p, reqs[0],
                                       toks16[0])
        bytes_ = eng.memory_bytes()
        derived = int(concrete_paged_cache_bytes(cfg, S_SLOTS, S_MAX_LEN,
                                                 page, kv, dp_size=1,
                                                 tp_size=1))
        if bytes_ != derived:
            raise AssertionError(f"{what}: engine bytes {bytes_} != "
                                 f"derived {derived}")
        pools = {sp.key: tree_get(eng.state, sp.path) for sp in eng.specs
                 if sp.paged}
        view = sum(t.numel() // t.shape[1] * S_SLOTS * eng.npp
                   * t.element_size() for t in pools.values())
        for rid, toks in res.items():
            if not ((toks >= 0) & (toks < cfg.vocab_size)).all():
                raise AssertionError(f"{what}: request {rid} tokens {toks}")
        ms = _s_step_ms(eng, model, params, p)
        total = sum(g for _, g in reqs)
        rec = dict(
            model=arch, kv_cache_dtype=kv, slots=S_SLOTS,
            max_len=S_MAX_LEN, page_size=page, requests=len(reqs),
            tokens=total, admissions=eng.admissions,
            decode_steps=eng.steps_run, engine_s=wall,
            tokens_per_s=total / wall, comparator=comparator,
            memory_bytes=bytes_, derived_bytes=derived,
            pool_pages=eng.n_data_pages + 1,
            pool_bytes=sum(t.nbytes for t in pools.values()),
            gathered_view_bytes=view, peak_bytes=peak,
            paged_step_ms=ms["paged"], gather_mask_ms=ms["gather_mask"],
            decode_ms=ms["decode"], scatter_ms=ms["scatter"],
            contiguous_step_ms=ms["contiguous"], card=smi_line())
        if kv == "int8":
            rec["int8_vs_bf16_max_logit_diff"] = err8
        log(json.dumps({"serve_engine": rec}))
        out.append(rec)
        del eng, res, trace
        gc.collect()
        torch.cuda.empty_cache()
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log(f"# phase S, {arch}: {time.perf_counter() - t_start:.1f} s")
    return out


def phase_serving():
    """Phase S (module docstring): the continuous-batching engine at full
    width and depth for granite-3-8b (bf16 and int8), zamba2-2.7b and
    qwen2-moe-a2.7b."""
    log(f"# phase S on {smi_line()}")
    _s_model("granite-3-8b", dict(num_layers=N_LAYERS, d_model=D_MODEL,
                                  num_heads=N_HEADS, num_kv_heads=N_KV,
                                  head_dim=HEAD_DIM), int8=True)
    _s_model("zamba2-2.7b", dict(num_layers=Z_LAYERS, d_model=Z_D_MODEL,
                                 num_heads=Z_HEADS, head_dim=Z_HEAD_DIM,
                                 shared_attn_every=Z_LAYERS // Z_GROUPS))
    _s_model("qwen2-moe-a2.7b", dict(num_layers=M_LAYERS,
                                     d_model=M_D_MODEL, num_heads=M_HEADS,
                                     num_experts=M_EXPERTS))



# one rank of a multi-device serving plan on this one card: _FAKE_RANK's
# process group and filled gathers, then ``_v_rank`` of this module (argv 4
# the model, argv 5 the JSON file it writes)
_V_RANK = _FAKE_RANK[:_FAKE_RANK.index("split = []")] + r"""
import chip_smoke
raise SystemExit(chip_smoke._v_rank(sys.argv[4], sys.argv[5]))
"""


def _v_rank(arch, out):
    """Phase V (a) and (b), in a child process joined to the ``fake`` group
    of V_DEVICES ranks as rank 0: ``arch`` tuned for V_DEVICES H100s, this
    rank's params drawn from seed 0 (``init_rank_params``), then
    ``generate(gen=GEN)`` on BATCH prompts of PROMPT_LEN with the launch
    counters set to 0 just before and read just after, the rank's prefill
    and decode steps timed, its bytes against the memory report.  qwen2-72b
    (tp 4): the engine too (slots S_SLOTS, max_len V_MAX_LEN, the plan's
    pages), its counts and bytes; its values are meaningless under the fake
    group and not compared.  granite (dp 4): a data rank decodes its row
    with no collective, so its tokens are compared with the one-card
    batch-1 decode of that row, bitwise.  Writes the record to ``out``;
    returns 1 where a check failed."""
    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.launch.mesh import make_plan_mesh
    from repro_torch.launch.serve import generate, tuned_serve_plan
    from repro_torch.lowering import lower_plan, plan_mesh
    from repro_torch.lowering.cache_layout import (concrete_cache_bytes,
                                                   concrete_paged_cache_bytes)
    from repro_torch.models.zoo import build_model, pad_caches
    from repro_torch.serving import ContinuousBatchingEngine
    from repro_torch.training.step import (init_rank_params,
                                           make_prefill_step,
                                           make_serve_step)

    cfg = get_arch(arch)
    bad = []
    t0 = time.perf_counter()
    plan, report = tuned_serve_plan(cfg, batch=BATCH, max_len=V_MAX_LEN,
                                    n_devices=V_DEVICES,
                                    page_grid=(0, S_PAGE))
    st = plan.stages[0]
    rec = dict(model=arch, layers=cfg.num_layers, plan=json.loads(
        plan.to_json()), tune_s=time.perf_counter() - t0,
        predicted=dict(objective_s=report.objective,
                       tokens_per_s=report.throughput_tokens))
    want = (1, V_TP) if arch == "qwen2-72b" else (V_DEVICES, 1)

    def done():
        rec["failed"] = bad
        rec["smi"] = smi_line()
        Path(out).write_text(json.dumps(rec))
        return 1 if bad else 0

    if (st.dp, st.tp) != want:
        bad.append(f"the tuner's plan for {V_DEVICES} H100s is dp {st.dp} x "
                   f"tp {st.tp}, not dp {want[0]} x tp {want[1]}")
        return done()
    # the attention the cost model prices (launch/serve.py --tune)
    plan = plan.replace(attn_impl="pallas", use_pallas=True)
    mesh = make_plan_mesh(st.dp, st.tp, DEVICE)
    model = build_model(cfg, DEVICE)
    t0 = time.perf_counter()
    params, _ = init_rank_params(model, plan, mesh,
                                 torch.Generator(DEVICE).manual_seed(0))
    sync()
    rec["init_s"] = time.perf_counter() - t0
    shape = ShapeConfig("v", V_MAX_LEN, BATCH, "decode")
    rep = lower_plan(cfg, shape, plan, plan_mesh(plan)).memory_report()
    sm = rep.stages[0]
    rec["param_bytes"] = sum(p.nbytes for p in params.values())
    rec["report"] = dict(weight_bytes=sm.weight_bytes,
                         cache_bytes=sm.cache_bytes,
                         transient_bytes=sm.transient_bytes,
                         reserved_bytes=sm.reserved_bytes,
                         peak_bytes=rep.peak_bytes)
    if rec["param_bytes"] != sm.weight_bytes:
        bad.append(f"the rank holds {rec['param_bytes']} B of params; the "
                   f"memory report charges {sm.weight_bytes}")
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT_LEN),
                            generator=torch.Generator(DEVICE).manual_seed(1),
                            device=DEVICE, dtype=torch.int32)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # the main path, counted: generate() on the rank
    sync()
    _reset_counts()
    t0 = time.perf_counter()
    toks = generate(model, params, prompts, GEN, plan, mesh=mesh)
    sync()
    wall = time.perf_counter() - t0
    counts = _read_counts()
    # one prefill (of the whole batch) and GEN - 1 decode steps
    want_counts = _s_launches(cfg, 1, GEN - 1)
    rec["generate"] = dict(launches=counts, want=want_counts, wall_s=wall,
                           rank_rows=BATCH // st.dp,
                           tokens_per_s_of_the_rank=BATCH // st.dp * GEN
                           / wall)
    if counts != want_counts:
        bad.append(f"generate launched {counts}, not {want_counts}")

    # the same steps, timed: the prefill, then each decode step
    prefill = make_prefill_step(model, plan, return_cache=True, mesh=mesh,
                                batch=BATCH)
    serve = make_serve_step(model, plan, batch=BATCH, max_len=V_MAX_LEN,
                            mesh=mesh)
    with torch.inference_mode():
        sync()
        t0 = time.perf_counter()
        logits, caches = prefill.fn(params, {"tokens": prompts})
        sync()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        caches = serve.place(pad_caches(caches, V_MAX_LEN - PROMPT_LEN))
        rec["cache_bytes"] = sum(x.nbytes for x in caches.values())
        rec["cache_bytes_want"] = concrete_cache_bytes(
            cfg, BATCH, V_MAX_LEN, plan.kv_cache_dtype, dp_size=st.dp,
            tp_size=st.tp)
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        # each step's wall time, and the host thread's CPU time in it (the
        # step is launch-bound: where CPU time falls short of the wall, the
        # thread waited or was not scheduled)
        steps, cpu = [], []
        for _ in range(GEN - 1):
            sync()
            t0, c0 = time.perf_counter(), time.thread_time()
            logits, caches = serve.fn(params, tok, caches)
            sync()
            steps.append((time.perf_counter() - t0) * 1e3)
            cpu.append((time.thread_time() - c0) * 1e3)
            tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    del caches, logits
    rec.update(prefill_ms=prefill_ms, decode_ms=steps,
               decode_ms_median=statistics.median(steps),
               decode_cpu_ms_median=statistics.median(cpu),
               cache_update=serve.exec_cfg.cache_update)
    if rec["cache_bytes"] != rec["cache_bytes_want"]:
        bad.append(f"the rank's cache holds {rec['cache_bytes']} B; "
                   f"concrete_cache_bytes gives {rec['cache_bytes_want']}")

    if st.tp > 1:
        # the engine on the rank, every tp rank with one schedule
        ps = plan.page_size or S_PAGE
        eng = ContinuousBatchingEngine(model, params, plan, slots=S_SLOTS,
                                       max_len=V_MAX_LEN, page_size=ps,
                                       mesh=mesh)
        for i in range(BATCH):
            eng.submit({"tokens": prompts[i:i + 1]}, GEN, rid=i)
        sync()
        _reset_counts()
        t0 = time.perf_counter()
        eng.run()
        sync()
        wall = time.perf_counter() - t0
        counts = _read_counts()
        want_counts = _s_launches(cfg, eng.admissions, eng.steps_run)
        got = eng.memory_bytes()
        paged = concrete_paged_cache_bytes(cfg, S_SLOTS, V_MAX_LEN, ps,
                                           plan.kv_cache_dtype, dp_size=1,
                                           tp_size=st.tp)
        rec["engine"] = dict(launches=counts, want=want_counts, wall_s=wall,
                             admissions=eng.admissions, steps=eng.steps_run,
                             page_size=ps, memory_bytes=got,
                             concrete_paged_cache_bytes=paged,
                             tokens_per_s_of_the_rank=BATCH * GEN / wall)
        if counts != want_counts:
            bad.append(f"the engine launched {counts}, not {want_counts}")
        if got != paged or (ps == plan.page_size and got != sm.cache_bytes):
            bad.append(f"the engine's pools hold {got} B; the layout gives "
                       f"{paged}, the report {sm.cache_bytes}")
        del eng
    peak = torch.cuda.max_memory_allocated()
    rec.update(max_memory_allocated=peak,
               allocator_over_memory_report=peak / rep.peak_bytes,
               bound=H_PEAK_BOUND)
    if peak > H_PEAK_BOUND * rep.peak_bytes:
        bad.append(f"allocator peak {peak} B over {H_PEAK_BOUND} x the "
                   f"memory report's {rep.peak_bytes} B")

    if st.dp > 1:
        # this data rank's rows (the fake group's gather fills the others
        # with them) against one card decoding the first row alone
        mine = toks[:BATCH // st.dp].cpu()
        one = plan.replace(stages=(st.replace(dp=1, tp=1),))
        ref = generate(model, params, prompts[:1], GEN, one).cpu()
        rec["tokens"] = dict(rank=mine.tolist(), one_card_batch_1=ref.tolist(),
                             bitwise=bool(torch.equal(mine[:1], ref)))
        if not rec["tokens"]["bitwise"]:
            bad.append("the data rank's tokens differ from the one-card "
                       "batch-1 decode of its row")
    return done()


def _v_rank_process(arch):
    """``_v_rank(arch)`` in a child process; returns its record."""
    out = ROOT / "build" / f"v_{arch}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.unlink(missing_ok=True)
    t0 = time.perf_counter()
    cmd = [sys.executable, "-c", _V_RANK, str(ROOT / "src"),
           str(V_DEVICES), "0", arch, str(out)]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=900,
                       env=env, cwd=ROOT)
    rec = json.loads(out.read_text()) if out.exists() else {}
    rec["process_s"] = time.perf_counter() - t0
    log(json.dumps({f"v_rank0_of_{V_DEVICES}": rec}))
    if r.returncode != 0:
        raise AssertionError(f"phase V, {arch}'s rank: exit {r.returncode}, "
                             f"{rec.get('failed')}\n{r.stderr[-3000:]}")
    return rec


def _v_cut_rank(out, kind="cuda"):
    """Phase V (c)'s tp-4 rank over NCCL (gloo with ``kind="cpu"``;
    ``torchrun``'s variables): qwen2-72b cut to V_CUT_LAYERS layers, the
    prefill's logits and V_FORCED teacher-forced decode steps'; rank 0
    saves them."""
    import numpy as np
    from repro_torch.launch.mesh import init_distributed, make_plan_mesh
    from repro_torch.training.step import init_rank_params
    rank, _, dev = init_distributed(kind)
    model, plan, prompts, forced = _v_cut_setup(dev)
    plan = plan.replace(stages=(plan.stages[0].replace(tp=V_TP),))
    mesh = make_plan_mesh(1, V_TP, dev)
    params, _ = init_rank_params(model, plan, mesh,
                                 torch.Generator(dev).manual_seed(0))
    rows = _v_forced(model, params, plan, prompts, forced, mesh)
    if rank == 0:
        np.save(out, rows)
    torch.distributed.destroy_process_group()


def _v_cut_setup(dev):
    from repro_torch.configs.base import get_arch
    from repro_torch.core.plan import single_stage_plan
    from repro_torch.models.zoo import build_model
    cfg = get_arch("qwen2-72b").replace(num_layers=V_CUT_LAYERS)
    plan = single_stage_plan(V_CUT_LAYERS, dp=1, tp=1, micro_batch=BATCH,
                             grad_accum=1, zero=0, ckpt_layers=0,
                             attn_impl="pallas", use_pallas=True)
    g = torch.Generator(dev).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT_LEN),
                            generator=g, device=dev, dtype=torch.int32)
    forced = torch.randint(0, cfg.vocab_size, (BATCH, V_FORCED),
                           generator=g, device=dev, dtype=torch.int32)
    return build_model(cfg, dev), plan, prompts, forced


def _v_forced(model, params, plan, prompts, forced, mesh=None):
    """The prefill's last logits and those of V_FORCED decode steps fed
    ``forced``, f32 on the host: (V_FORCED + 1, BATCH, vocab)."""
    from repro_torch.models.zoo import pad_caches
    from repro_torch.training.step import make_prefill_step, make_serve_step
    max_len = PROMPT_LEN + V_FORCED
    prefill = make_prefill_step(model, plan, return_cache=True, mesh=mesh,
                                batch=BATCH)
    serve = make_serve_step(model, plan, batch=BATCH, max_len=max_len,
                            mesh=mesh)
    with torch.inference_mode():
        logits, caches = prefill.fn(params, {"tokens": prompts})
        caches = serve.place(pad_caches(caches, V_FORCED))
        rows = [logits[:, -1].float().cpu()]
        for i in range(V_FORCED):
            logits, caches = serve.fn(params, forced[:, i:i + 1], caches)
            rows.append(logits[:, -1].float().cpu())
    return torch.stack(rows).numpy()


def _v_cut_against_one_card(kind="cuda"):
    """Phase V (c)'s first part: the V_CUT_LAYERS-layer tp-4 ranks in four
    processes, then the same layers whole on this process's card (the CPU
    over gloo with ``kind="cpu"``).  Returns the record and whether the
    logits agree (module docstring of ``_v_four_cards``)."""
    import numpy as np
    t0 = time.perf_counter()
    out = ROOT / "build" / "v_cut_tp4.npy"
    out.parent.mkdir(parents=True, exist_ok=True)
    port = _free_port()
    code = (f"import sys; sys.path[:0] = [{str(ROOT / 'src')!r}, "
            f"{str(ROOT)!r}]; import chip_smoke as C; "
            f"C._v_cut_rank({str(out)!r}, {kind!r})")
    procs = []
    for r in range(V_DEVICES):
        env = {**os.environ, "RANK": str(r), "WORLD_SIZE": str(V_DEVICES),
               "LOCAL_RANK": str(r), "MASTER_ADDR": "localhost",
               "MASTER_PORT": str(port), "PYTHONPATH": str(ROOT / "src")}
        procs.append(subprocess.Popen([sys.executable, "-c", code], env=env,
                                      cwd=ROOT, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate(timeout=900)[0] for p in procs]
    if any(p.returncode for p in procs):
        raise AssertionError("phase V (c): a tp-4 rank failed\n"
                             + "\n".join(logs)[-3000:])
    got = np.load(out)
    dev = torch.device(kind)
    model, plan, prompts, forced = _v_cut_setup(dev)
    params, _ = model.init(torch.Generator(dev).manual_seed(0))
    want = _v_forced(model, params, plan, prompts, forced)
    del params
    gc.collect()
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    agree = float((got.argmax(-1) == want.argmax(-1)).mean())
    return dict(layers=V_CUT_LAYERS, cut="depth 80 -> 8", max_abs_diff=err,
                max_abs_logit=scale, tol=LOGIT_REL_TOL * scale,
                argmax_agreement=agree, seconds=time.perf_counter() - t0), \
        err <= LOGIT_REL_TOL * scale


def _v_four_cards():
    """Phase V (c): with four cards, qwen2-72b at tp 4 through NCCL -- its
    depth cut to V_CUT_LAYERS, teacher-forced logits against one card
    running the same layers whole (within LOGIT_REL_TOL of the largest
    logit: each tp rank rounds its part of every row-parallel product to
    bf16 before NCCL sums four of them, against one rounding of the whole
    product on one card, two more roundings a layer on the residual, the
    kind of difference LOGIT_REL_TOL allows phase 3's 40 layers of kernels
    against plain versions); then ``serve --tune --nproc 4`` at full depth
    and width, its tokens per second.  With fewer cards it logs that it was
    skipped."""
    n = torch.cuda.device_count()
    if n < V_DEVICES:
        log(json.dumps({"v_four_cards": f"skipped ({n} visible)"}))
        return None
    cut, agree = _v_cut_against_one_card()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen2-72b", "--tune", "--nproc", str(V_DEVICES), "--batch",
         str(BATCH), "--prompt-len", str(PROMPT_LEN), "--gen", str(GEN)],
        capture_output=True, text=True, timeout=900, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    line = re.search(r"generated (\d+) tokens in ([\d.]+)s \(([\d.]+) tok/s\)",
                     r.stdout)
    full = dict(exit=r.returncode, seconds=time.perf_counter() - t0,
                line=line.group(0) if line else None,
                tokens_per_s=float(line.group(3)) if line else None)
    log(json.dumps({"v_four_cards": dict(cut_tp4_vs_one_card=cut,
                                         full_depth_tp4=full,
                                         smi=smi_line())}))
    if not agree:
        raise AssertionError(f"phase V (c): tp-4 logits {cut['max_abs_diff']}"
                             f" from one card's, over {cut['tol']}")
    if r.returncode or not line:
        raise AssertionError(f"phase V (c): serve --nproc 4 failed\n"
                             f"{r.stdout[-2000:]}\n{r.stderr[-2000:]}")
    return full


def _free_port():
    import socket
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def phase_multi_serve(errs):
    """Phase V (module docstring).  Returns its entries of the kernels
    line."""
    log(f"# phase V on {smi_line()}")
    from repro_torch.configs.base import get_arch

    a = _v_rank_process("qwen2-72b")
    _v_rank_process("granite-3-8b")
    _v_four_cards()
    rank = "qwen2-72b (tp-4 rank, serving)"
    norms = a["generate"]["launches"]["rmsnorm"]
    # generate's one prefill at BATCH x PROMPT_LEN rows, the rest decode
    # steps at BATCH rows
    prefill = _s_launches(get_arch("qwen2-72b"), 1, 0)["rmsnorm"]
    return [_time_flash(rank, BATCH, PROMPT_LEN, V_R_HEADS, V_R_KV, HEAD_DIM,
                        a["generate"]["launches"]["flash_attention_fwd"],
                        errs["flash_attention_fwd@qwen2_72b_tp4"]),
            *_time_rmsnorm(rank, V_D_MODEL, norms,
                           errs[f"rmsnorm@d{V_D_MODEL}"],
                           decode_launches=norms - prefill)]




def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    profile = "--profile" in sys.argv[1:]
    t_start = time.perf_counter()

    def mark(what):     # where the script's time goes, phase by phase
        log(f"# {what} done at {time.perf_counter() - t_start:.1f} s")

    phase_device_and_build()
    if "--ssd-bwd-phases" in sys.argv[1:]:
        ssd_bwd_phases()
        return 0
    if "--adam-slices" in sys.argv[1:]:
        adam_slices()
        return 0
    errs = phase_kernels_vs_plain()
    mark("phases 1-2")
    if "--moe-only" in sys.argv[1:]:
        kernels = phase_moe(errs, profile)
        mark("phase M")
        print(json.dumps({"kernels": kernels}))
        return 0
    if "--multi-serve-only" in sys.argv[1:]:
        kernels = phase_multi_serve(errs)
        mark("phase V")
        print(smi_line())
        print(json.dumps({"kernels": kernels}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if "--serve-only" in sys.argv[1:]:
        phase_serving()
        mark("phase S")
        print(smi_line())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    # granite-3-8b
    model, params, prompts, plan, launches, peak = phase_full_width_serve(
        "granite-3-8b", dict(num_layers=N_LAYERS, d_model=D_MODEL,
                             num_heads=N_HEADS, num_kv_heads=N_KV,
                             head_dim=HEAD_DIM), _granite_launches)
    phase_reduced_vs_cpu("granite-3-8b")
    mark("phase 3")
    kernels = [
        _time_flash("granite-3-8b", BATCH, PROMPT_LEN, N_HEADS, N_KV,
                    HEAD_DIM, launches["flash_attention_fwd"],
                    errs[f"flash_attention_fwd@hd{HEAD_DIM}"]),
        *_time_rmsnorm("granite-3-8b", D_MODEL, launches["rmsnorm"],
                      errs[f"rmsnorm@d{D_MODEL}"])]
    _time_serve("granite-3-8b", model, params, prompts, plan, peak)
    if profile:
        phase_profile("granite-3-8b", model, params, prompts, plan)
    # free granite's weights so that training's and zamba2's peak memory
    # are their own
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # training granite-3-8b (8 layers)
    train_launches = phase_train(profile)
    mark("phase T")
    kernels += [
        _time_flash_bwd(train_launches["flash_attention_bwd"],
                        errs["flash_attention_bwd"]),
        _time_rmsnorm_bwd(train_launches["rmsnorm_bwd"],
                          errs["rmsnorm_bwd"])]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # the training loop: checkpoints, restart, rollback, resume
    phase_loop()
    mark("phase L")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # tune then execute (the tuner for one H100, its plan on the card)
    tuned = phase_tune_then_execute()
    mark("phase U")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # calibrate on the card, re-tune with the profile, execute
    phase_calibrate()
    mark("phase C")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # the tuner's kernel dimension: the Hopper tile menu on the card
    phase_kernel_menu()
    mark("phase K")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # multi-device plans: world size 1 through NCCL, rank 0 of the tuned
    # tp-4 plan, and more than one card where there is
    rank_launches = phase_multi_device(tuned)
    mark("phase D")
    kernels += [
        _time_flash("granite-3-8b (tp-4 rank, training)", R_BATCH, T_SEQ,
                    R_HEADS, R_KV, HEAD_DIM,
                    rank_launches["flash_attention_fwd"],
                    errs["flash_attention_fwd@tp4"]),
        _time_flash_bwd(rank_launches["flash_attention_bwd"],
                        errs["flash_attention_bwd@tp4"],
                        (R_BATCH, T_SEQ, R_HEADS, R_KV, HEAD_DIM),
                        "granite-3-8b (tp-4 rank, training)")]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # pipelined plans: two stage ranks of granite's plan for 16 H100s
    stage_launches = phase_pipeline()
    mark("phase P")
    kernels += [
        _time_flash("granite-3-8b (tp-8 pipeline stage rank, training)",
                    P_BATCH, T_SEQ, P_HEADS, P_KV, HEAD_DIM,
                    stage_launches["flash_attention_fwd"],
                    errs["flash_attention_fwd@tp8"]),
        _time_flash_bwd(stage_launches["flash_attention_bwd"],
                        errs["flash_attention_bwd@tp8"],
                        (P_BATCH, T_SEQ, P_HEADS, P_KV, HEAD_DIM),
                        "granite-3-8b (tp-8 pipeline stage rank, training)")]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # zamba2-2.7b
    model, params, prompts, plan, launches, peak = phase_full_width_serve(
        "zamba2-2.7b", dict(num_layers=Z_LAYERS, d_model=Z_D_MODEL,
                            num_heads=Z_HEADS, num_kv_heads=Z_HEADS,
                            head_dim=Z_HEAD_DIM, ssm_state=SSD_N,
                            ssm_head_dim=SSD_P, ssm_groups=SSD_G,
                            shared_attn_every=Z_LAYERS // Z_GROUPS),
        _zamba2_launches, f32_truth=True)
    phase_reduced_vs_cpu("zamba2-2.7b", f32_truth=True)
    mark("phase 5")
    kernels += [
        _time_ssd(launches["ssd_scan"], errs["ssd_scan"]),
        _time_flash("zamba2-2.7b", BATCH, PROMPT_LEN, Z_HEADS, Z_HEADS,
                    Z_HEAD_DIM, launches["flash_attention_fwd"],
                    errs[f"flash_attention_fwd@hd{Z_HEAD_DIM}"]),
        *_time_rmsnorm("zamba2-2.7b", Z_D_MODEL, launches["rmsnorm"],
                      errs[f"rmsnorm@d{Z_D_MODEL}"])]
    _time_serve("zamba2-2.7b", model, params, prompts, plan, peak)
    if profile:
        phase_profile("zamba2-2.7b", model, params, prompts, plan)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # hybrid training: the SSD backward kernel, the reduced config card vs
    # CPU, full-width zamba2-2.7b on one card, the new shapes' timings
    t_h = time.perf_counter()
    ssd_bwd_err, ssd_bwd_rank_err = _ssd_bwd_vs_plain()
    _hybrid_reduced_vs_cpu()
    hybrid_launches = phase_hybrid_train(profile)
    kernels += [
        _time_ssd_bwd(hybrid_launches["ssd_scan_bwd"], ssd_bwd_err),
        _time_flash_bwd(hybrid_launches["flash_attention_bwd"],
                        errs[f"flash_attention_bwd@hd{Z_HEAD_DIM}"],
                        (H_MICRO, H_SEQ, Z_HEADS, Z_HEADS, Z_HEAD_DIM),
                        "zamba2-2.7b (training)"),
        _time_rmsnorm_bwd(hybrid_launches["rmsnorm_bwd"],
                          errs[f"rmsnorm_bwd@d{Z_D_MODEL}"], Z_D_MODEL,
                          "zamba2-2.7b (training)")]
    log(f"# phase H: {time.perf_counter() - t_h:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # a rank of zamba2's tp-4 plan, and its kernels' shapes
    t_z = time.perf_counter()
    rank_launches = phase_zamba2_rank()
    rank = "zamba2-2.7b (tp-4 rank, training)"
    kernels += [
        _time_ssd(rank_launches["ssd_scan"], errs["ssd_scan@zamba2_tp4"],
                  (Z_MICRO, H_SEQ, ZR_SSD_HEADS), rank),
        _time_ssd_bwd(rank_launches["ssd_scan_bwd"], ssd_bwd_rank_err,
                      (Z_MICRO, H_SEQ, ZR_SSD_HEADS), rank),
        _time_flash(rank, Z_MICRO, H_SEQ, ZR_HEADS, ZR_HEADS, Z_HEAD_DIM,
                    rank_launches["flash_attention_fwd"],
                    errs["flash_attention_fwd@zamba2_tp4"]),
        _time_flash_bwd(rank_launches["flash_attention_bwd"],
                        errs["flash_attention_bwd@zamba2_tp4"],
                        (Z_MICRO, H_SEQ, ZR_HEADS, ZR_HEADS, Z_HEAD_DIM),
                        rank)]
    log(f"# phase Z: {time.perf_counter() - t_z:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # the MoE family: qwen2-moe-a2.7b served, trained on one card and on a
    # rank of a tp-4 plan
    kernels += phase_moe(errs, profile)
    mark("phase M")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # the continuous-batching engine: the three models served through
    # the paged KV cache, token for token with the static decode
    phase_serving()
    mark("phase S")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # multi-device serving: a rank of qwen2-72b's tp-4 plan and of
    # granite's dp-4 plan on this card, the tp-4 plan on four cards where
    # there are four
    kernels += phase_multi_serve(errs)
    mark("phase V")

    log(f"# total {time.perf_counter() - t_start:.1f} s")
    # every entry ran at the tiles the plan's default tuple runs
    # (kernels/tiles.py; phase K's line has the other menu entries)
    from repro_torch.kernels.tiles import HOPPER_DEFAULT
    fields = {"flash_attention_fwd": ("attn_q_block", "attn_kv_block"),
              "flash_attention_bwd": ("attn_kv_block",),
              "rmsnorm": ("rmsnorm_block",), "rmsnorm_bwd": (),
              "ssd_scan": ("ssd_chunk",), "ssd_scan_bwd": ("ssd_chunk",)}
    for k in kernels:
        k["tile"] = {f: HOPPER_DEFAULT[f] for f in fields[k["name"]]}
    print(smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

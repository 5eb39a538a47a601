#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (`src/repro_torch`) runs on
the GPU: builds its CUDA kernels, holds each against its plain PyTorch
version on the card, drives the serving and the training slices, the
paper's baseline comparison, the robustness slice (churn, Byzantine
defenses, crash-resume, the leakage audit), the scheduler with the
observability layer (telemetry, spans, the profiler's device busy share)
and learner-sharded training and serving (one rank per process, over
nccl and gloo) at full Foursquare scale and
million-user tiled serving at the reference's million configuration, the
LM stack's prefill and cached decode for every architecture family
(qwen1.5-4b at full width and depth) and its training half (qwen1.5-4b
trained at full width and depth, gossip across learners), and times each
kernel beside its bound.

    python3 chip_smoke.py                 # needs one CUDA card, no arguments
    python3 chip_smoke.py --parent DIR    # also hold kernels 9, 5 (in place,
                                          # against the parent's gathers +
                                          # kernel 1), 1, 3, 6, 7, 8 and the
                                          # noise stream against the build of
                                          # the checkout unpacked in DIR, bit
                                          # for bit, and time both builds
    python3 chip_smoke.py --obs-detail    # phase 3f also times tracing (the 1x
                                          # stream in turns, an empty span) and
                                          # profiles a DP and a screened epoch
    python3 chip_smoke.py --e2e-turns DIR # only: phase 3a's pruned serving and
                                          # DP, `nan` + screen and screen + trim
                                          # epochs, the checkout in DIR and this
                                          # one in alternating processes

Phases (any failure raises and exits non-zero; nothing is caught):

1. Build the kernels from ``src/repro_torch/kernels/csrc`` (nvcc, sm_90a).
2. Hold each kernel against its plain version on the same CUDA tensors,
   at the slices' shapes, on seeded inputs with exact ties, -1 padding,
   all-seen rows and rows with fewer candidates than k. Values agree
   within 1e-5; an index may differ only where the plain version scores
   the two items within that tolerance. The DP kernels: the noise
   stream's hash words exactly and its draws within 1e-6 and bit for bit
   those of the clip + noise kernel on zero messages (seeds 0, 7, 2^31-1
   at 10, 1 and 256 columns; rids 0..29,999 and around 2^23), the clip +
   noise kernel within
   1e-6 (bit for bit with clip=inf and noise 0), the fused DP step's
   deltas within 1e-5 (B 256/100/1, clip inf/0.5/1e-3, noise zero and not,
   a zero-norm row). The slab serving kernel (kernel 5) and the int8/bf16
   window kernel (kernel 6, with an all-zero int8 request) within 1e-5,
   and bit for bit against the fp32 window kernel (kernel 1) on the
   windows gathered from the same rows, resp. on the dequantized windows;
   kernel 6 reading a store in place (user ids with repeats, a bucket of
   padding only, an all-seen and an all-zero user) within 1e-5 and bit for
   bit against the pre-gathered kernel 6 on the gathered windows. Kernel 5
   reading a serving state in place (on V and through P and Q; ids
   repeated, odd and unsorted, a bucket of padding only, an all-seen and an
   all-zero user, k above three live candidates) within 1e-5 and bit for
   bit against kernel 1 on the gathered windows.
   Kernel 2 also reading its rows in place (``rows`` repeated, odd and
   unsorted, with and without Q, and slices of P and Q at an odd start),
   bit for bit against the call on the materialized rows.
   The shared-V top-k (kernel 4) at `tests/test_kernels.py`'s shapes and
   on all-zero users (each slate the lowest unmasked ids); the gradients
   (kernel 9) at B 64/256/300/1024 × K 5/10/15/128 and at B=2048, K=16
   within 2e-5 abs + rel
   plus the bound on two fp32 orders of the residual's dot; the walk
   mixing (kernel 10) at (128,128), (200,333), (512,64), (77,1000) and
   with bf16 inputs, within 1e-5 + 1e-5·(|M| @ |X|) elementwise; on
   walk-like sparse M its sparse route equal to its dense route bit for
   bit (512×1,024, 77×1,000, 130×1, 2,048×300, the last routed sparse by
   the wrapper itself), and X holding NaN and ±Inf routed dense with the
   plain product's NaN/Inf pattern. The fused steps also at B 1,000 and
   5,000 (several blocks, one launch), and at K 8 and 16 (K fixed at run
   time; rows too wide to stage).
3. The main paths at the paper's primary configuration, full Table-1
   scale (`dmf_foursquare` on `foursquare_like(reduced=False, seed=0)`),
   and the LM stack's, each with every launch count set to 0 just before
   it and read just after. The LM phases h and i run first, right after
   phase 2, in a child process of this script (``--lm-phases``), while the
   card holds nothing else: i takes ~69 GB of the card's 85, and phases
   a-g keep ~16 GB of state for phase 4's timing; and their profiler
   sessions stay out of this process, whose first session is f's.
   a. serving: ingest the train check-ins (kernel 3), recommend pruned
      (kernel 5 reading the engine's state in place) and dense (kernel 2),
      ingest the test check-ins, recommend again; 256 served slates of
      each kind are held against the plain versions, and every served
      pruned slate bit for bit against kernel 1 on its gathered window.
      Then, as the reference's serving bench does,
      kernel 5 on 64 served requests' whole (64, 3,197, 10) item rows
      against kernel 1 on their windows, and a `TiledFactorStore` built
      from the ingested state, served in fp32, against
      `ServingEngine.recommend` pruned on 4,096 users: both bit for bit;
   b. training: `fit` 20 epochs with DP off (kernel 3) and with σ=1,
      C=0.5 (kernel 7 and the noise stream, the accountant), `evaluate`
      of each over all users (kernel 2) unchunked and in 1,024-user chunks
      (identical floats), a DP online refresh of the DP-trained model
      (kernels 3 and 8), and the `dmf_train` CLI in process (``--full``,
      3 DP epochs). Trained P@10 must beat untrained P@10. Then, outside
      the counted run, 2 DP epochs on the card are held against the same
      2 epochs on the CPU (losses within 1e-4 relative, factors within
      1e-5 absolute), the same 2 epochs of `fit` DP off and on and of
      `fit_mf` and `fit_bpr` run twice on the card (bitwise-equal factors:
      the scatters are deterministic), and kernel 8 on one batch's raw
      message against kernel 7's message (within 1e-6). The training line
      also prints the device memory `evaluate` (unchunked and chunked)
      and the materializing sequence (V = P + Q, then kernel 2) allocate
      above the resident state at R=6,524.
   c. tiled: the reference's million configuration
      (`benchmarks/serving_bench.py` `million_section`: 1,000,000 users,
      100,000 POIs, 1,024 cities, K=8, cell cap 128, microbatch 128, k=10,
      seed 0; nothing cut): world, hierarchical index, store on the card,
      int8 and bf16 quantization, 16,384 requests of random users in each
      of fp32 (kernel 1 on gathered windows), int8 and bf16 (kernel 6
      reading the store in place, no gathers) after one warm-up
      dispatch each; 256 served slates per mode held against the plain
      versions; fp32 on 32 sampled users bit for bit against a
      `ServingEngine` on their dense rows, int8 and bf16 within the
      analytic score bound; `shard_rows(4)` bit for bit on 1,024 users.
   d. baselines, the paper's comparison (Table 2 at K=10): `fit_mf` and
      `fit_bpr` for 20 epochs and `evaluate_mf`, GDMF and LDMF through
      `dmf.fit` and `evaluate`, beside the DMF DP-off numbers of b;
      trained P@10 must beat untrained for MF and BPR, and "DMF R@10 >
      MF R@10" (claim C1) is printed, not asserted. Kernel 4 on the MF
      and BPR states at full width: its ids give `evaluate_mf`'s
      metrics, except for users whose k-th and (k+1)-th scores tie
      (counted). Kernel 4 on 256 DMF users one request at a time (the
      reference's per-request loop), held against kernel 2 on the same
      rows (within 1e-6; whether bit for bit is printed). Kernel 9 on a
      training minibatch (B=256, K=10) and at B=2048, K=16: against its
      plain version, gp against kernel 3's (bit for bit, asserted),
      −θ·gu and −θ·gq within 1 ulp of kernel 3's du and dq. Kernel 10 on
      the dense walk matrix times every learner's P (6,524 × 6,524 @
      6,524 × 31,970): against the plain product and the neighbor-table
      gather, within 1e-5 + 1e-5·(|M| @ |X|).
   e. robustness and audit, in five parts, each counted on its own: the
      trivial churn plan with an inactive `DefenseConfig()` for 3 epochs
      against plain `fit`, DP off and σ=0.5, C=0.25 (bit for bit); churn
      (dropout 0.2, delay classes 0-2, late joiners 0.1, seed 17; the
      reference churn bench's resume configuration) with that DP for 4
      epochs, snapshots every 2 into a temporary directory under the
      git-ignored ``build/``, resumed from step_2 (losses, factors and privacy
      bit for bit), one learner's U, P and Q rows bit-frozen across an
      epoch it is offline, a snapshot's bytes and save/load seconds;
      Byzantine (the reference bench's headline: τ = 1.5 × the 99.9th
      percentile of one audited epoch's honest norms, 20% malicious, 10
      epochs each, halting on divergence): fault-free, `norm_inflate`
      λ=100 undefended and under screen + trim 0.25, `nan` under screen
      (the defended runs must stay finite); `run_audit` for one epoch at
      σ 0 and 1.0, C=0.25 (the DP advantage must be the lower); the CLI
      in process (3 DP epochs with churn, screening, trimmed aggregation
      and a snapshot every epoch, then resumed from step_2: the same last
      epoch's loss and report). Kernels 3, 7, 8 and 8a must launch.
   f. scheduling and observability, in two counted parts, into a metrics
      registry of their own. The scheduler on a pruned engine over b's
      DP-off state (microbatch 64, k=10): capacity from 5 back-to-back
      full microbatches; the reference scheduler bench's single-shard
      grid at full size (1,024 requests, Poisson arrivals, power-law users
      with zipf 1.1, SLO 50 ms, loads 0.5/1/2 × capacity, seeds 100 + i),
      `Scheduler` and `simulate_lockstep` on each stream, plus one on/off
      stream at 1× (burst 4, duty 0.2, period 50 ms); every scheduled and
      lockstep dispatch one launch of kernel 5 in place, each ingest
      batch one of kernel 3 (held per run); at 1× every served slate bit
      for bit a fresh engine's `recommend`; the bench's ingest interleave
      (two bursts of 48 around a 5 s gap, 32 held-out check-ins: the
      window inside the gap, the slates on each side bit for bit the
      matching snapshot's); the 1× stream again with span tracing on under
      `Tracer.torch_profiler`, whose trace must hold a kernel event for
      every dispatch (the device's busy share is the union of its kernel,
      memcpy and memset intervals over the profiled window, a lower bound
      since the profiler slows the host; beside it, the profiled device
      time a dispatch over the unprofiled 1× run's host seconds).
      Telemetry: `fit` 3 DP epochs (σ=1, C=0.5) and 2 epochs of e's
      attacked run under screen + trim at its τ, telemetry off and on, bit
      for bit. The engine's `EngineStats.publish` and the 1× report's
      `SchedulerReport.publish` go into the registry, which `write_jsonl`
      writes under build/; `device_memory_snapshot` must show allocated
      bytes. The ``scheduler`` and ``obs`` lines print before phase 4.
   g. sharded training and serving (learner sharding over
      `torch.distributed`, one rank per process, started by
      `launch.mesh.spawn_ranks` after phase 1's build), counted as one
      path summed over the ranks: D=1 over nccl and D=2 over gloo (two
      ranks on the one card), one spawn each. For DP off and σ=1,
      C=0.5: the unsharded `fit` (rank 0 alone) and the
      sharded `fit`, 5 epochs each, in turns (unsharded, sharded, sharded,
      unsharded; the sharded repeat by hand, its losses bit for bit the
      first's), losses and factors within 1e-5; `evaluate(n_shards=D)`
      equal to the unsharded `evaluate`.
      At D=1 (`fit` is the unsharded path there, as in the reference) the
      sharded side is the sharded epoch driven by hand over nccl
      (`train_epoch_sharded`, `evaluate_sharded`). At D=2: the trivial
      churn plan with an inactive defense for 3 epochs (losses bit for bit
      the plain sharded run's), screen + trim 0.25 under e's λ=100 attack
      at its τ for 3 epochs within 1e-6 (losses) and 1e-5 (factors) of the
      unsharded run, and 3 epochs by hand with every collective timed
      between two device synchronisations (the exchange's wall share).
      Kernels 2, 3, 7 and 8a must launch. Then, in the same spawns, the
      serving half (`sharded_serving`), counted on its own: the sharded
      `ServingEngine` on the DP-off state (microbatch 64, k=10) serves
      phase 3a's 4,096 pruned and 1,024 dense requests, ingests its test
      check-ins and serves them again, every slate bit for bit the
      one-device engine's (built on rank 0), and every rank's U, P, Q
      after the ingest equal (digests, all-gathered). At D=2 also phase
      3f's 1x Poisson stream through `Scheduler` (one broadcast a
      dispatch; run twice, the broadcast off the clock as in the
      reference and then charged to it) and `simulate_lockstep` (waves),
      with no clock on the group: every rank's report equal, the served
      slates `recommend`'s bit for bit, one launch of kernel 5 a scheduled
      dispatch and one a rank a wave. At D=1 the engine runs on a one-rank
      nccl group. Kernels 5, 2 and 3 must launch. The ``sharded`` and
      ``sharded_serving`` lines (waves, their p50/p99, lockstep
      requests/s, goodput of scheduler both ways and lockstep, the
      collectives' wall share, the broadcasts' seconds, device memory a
      rank) print
      before phase 4; a rank that fails, times out or misses a hold fails
      the script.
   h. LM serving (`launch/serve.py` `make_prefill_step` /
      `make_decode_step` over `models/transformer.py`), which runs none of
      the port's kernels (every count must stay 0): qwen1.5-4b at its
      published width and depth (40 layers, fp32 parameters initialised on
      the card from the seed), bf16 compute as published: the prefill of
      4 × 4,096 tokens (4 q-chunks × 2 kv-chunks a layer), timed twice,
      its caches spliced into a decode cache of 4,160 positions and 64
      greedy decode steps timed with CUDA events; then fp32 compute on the
      same weights: prefill 504 tokens, 8 teacher-forced decode steps,
      their logits held against `forward` over the 512 tokens within the
      reference's decode-vs-forward tolerance (rtol 5e-2, atol 5e-3). The
      other nine configs of `ARCH_IDS` and yi-34b-swa at their published
      widths, one period of depth (`reduced()` where one period of fp32
      parameters exceeds 30 GB: Jamba), fp32, MoE capacity factor
      n_experts/top_k (a forward drops routes that a one-token step
      keeps): prefill 56, 8 teacher-forced steps held against `forward`;
      yi-34b-swa prefills 8,192 and decodes to position 10,239 through its
      ring, its last step held against `forward` over 10,240 tokens.
      Zero- and one-initialised parameters (norms, biases, the cross gate)
      are randomised first. Then all eleven at `reduced()` in fp32, the
      same numpy weights on the card and on the CPU: prefill logits, 4
      decode steps and every cache leaf within 1e-4 × the CPU tensor's
      largest magnitude. The ``lm_serving`` line prints before phase 4
      (prefill tokens/s, decode ms/step p50/p99 and tokens/s, peak GB
      above the parameters, the meta device's parameter bytes, one
      prefill and 4 decode steps again under `torch.profiler` with the
      device's busy share and the kernels with the most time, each hold's
      deviation, the cuts under ``reduced``).
   i. LM training (`launch/train.py` `make_train_step` over
      `transformer.loss_fn`, remat and the in-place AdamW), which runs
      none of the port's kernels either (every count must stay 0), after
      3h's model and caches are freed: qwen1.5-4b at its published width
      and depth (40 layers, fp32 parameters from the seed, bf16 compute,
      remat on, as published) trained by the ``allreduce`` step with
      `examples/train_lm.py`'s AdamW (linear warmup to 3e-3 over 20 steps
      then cosine, weight decay 0.01, clip 1.0) applied in place, on one
      fixed `SyntheticLM` batch of 1 × 4,096 tokens at the model's vocab
      (train_4k's sequence; its global batch of 256 cut to 1): one
      warm-up step, 8 steps timed with CUDA events, 2 under
      `torch.profiler`. Every loss finite, and the loss after the warm-up
      and timed steps below the first by more than 1 nat. Before it, at 2
      layers of the same width, `loss_fn` and its gradients with remat on
      and off, bit for bit. Then the reference's
      `test_gossip_training_converges_small_lm` on the card (its reduced
      qwen, 4 learners, D=2, adamw(6e-3), 60 steps, its assertions: the
      last loss below the first minus 0.3, the consensus error below 0.5).
      Then the ten `ARCH_IDS` at `reduced()` in fp32, the same numpy
      weights and batch on the card and on the CPU: the loss, every
      gradient and every parameter after one AdamW step (eps=1e-3) within
      1e-4 × the CPU leaf's largest magnitude. The ``lm_training`` line
      prints before phase 4: step s p50/p99, tokens/s, the model FLOPs
      6·N·T and `mfu` against the dense bf16 peak, peak GB split into the
      state (parameters, gradients, both moments) and the rest, the
      profiled busy share and top kernels, the holds, the cuts under
      ``reduced``.
4. Time each kernel, its plain version and one library call on the main
   paths' own inputs (kernel 10's rows also name the route taken, as
   ``mix_route``, and at the walk shape time the route's count with its
   host readback and its fill and product alone), and a one-element
   ``fill_`` as the launch floor. Kernel 2's row adds the serving
   microbatch read in place, evaluate on V, through P and Q and on one
   1,024-user chunk, and the callers' old sequences (the gathers then the
   kernel; P + Q then the kernel). Kernel 6's rows: int8 and bf16 on the
   tiled microbatch pre-gathered, in place on the store (the
   ``serve_topk_tiled_quant`` row, the tiled dispatch's), and the
   earlier sequence (six gathers, then the pre-gathered kernel). Kernel
   5's in-place row (``serve_topk_rows``): the serving microbatch on the
   engine's V and through P and Q, each beside the parent's sequence (the
   gathers, the add, kernel 1). Then the ``forms`` line: kernels 1, 2, 4,
   5 (in place, with its P and Q, pre-gathered and kernel 1 forms), 6 and
   9 (16/32/64/128 rows a block) at their main shapes
   (kernel 1
   serving R=64 Cw=384 and tiled R=128 Cw=128; kernel 2 at R=64, a
   1,024-user chunk and R=6,524; kernel 4 on the MF state R=6,524 and one
   DMF request R=1; kernel 6 in place at R=128 Cw=128, int8 and bf16, and
   its pre-gathered form) in the wrapper's layout, in other layouts (each
   held against the wrapper's slate bit for bit first) and scoring without
   the merge, timed in turns, every form down the list and back up. With
   ``--parent DIR``, build the checkout in DIR (the commit before kernel 9
   took 32 rows a block and kernel 5 read the engine's state in place) and
   hold against it, bit for bit: kernel 5 in place against the parent's
   gathers + kernel 1 (phase 2's states and the serving microbatch, V and P + Q, k
   1/10/16) and every served pruned request of phase 3a; kernels 1 and 5
   pre-gathered at their main shapes; kernel 6 pre-gathered and in place
   (phase 2's stores and the tiled microbatch, k 1/10/16, int8 and bf16);
   kernel 9 and kernels 3 and 7 (B 1 to 5,000, K 5/8/10/16/128, clip
   inf/0.5); the noise stream at N 1 to 300,000 rows, n_cols
   1/8/10/16/256, seeds 0/7/2^31-1, rids from below 2^23 to 2^31-1;
   kernel 8 on 20 batches (B 1 to 5,000, K 8/10/16, clip inf/0.5, noise
   0/1, zero and NaN rows). Both builds are timed in turns (parent, this,
   this, parent) on the ``parent build`` line, the parent with its gathers
   where this build reads the engine's state in place. Last, print the
   ``{"kernels": [...]}`` line.

The last line is ``{"ok": true, "device": {...}}``. Imports nothing of
JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import io
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
SEED = 0
TOL = 1e-5
DRAW_TOL = 1e-6               # noise draws and clipped/noised messages
LOSS_REL_TOL = 1e-4           # card vs CPU epoch losses
STATE_TOL = 1e-5              # card vs CPU factors (fp32 order of the scatters and sums)
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12      # H100 SXM data sheet, fp32 outside the tensor cores
MICROBATCH, K_TOP = 64, 10
N_PRUNED, N_DENSE, N_CHECK = 4096, 1024, 256
N_SLAB = 64                   # served requests held on kernel 5 vs kernel 1
# the reference's million configuration (serving_bench.py million_section)
M_USERS, M_ITEMS, M_CITIES, M_DIM, M_CELL_CAP, M_MICROBATCH = 1_000_000, 100_000, 1024, 8, 128, 128
N_TILED, N_ORACLE, N_SHARD_USERS, N_SHARDS = 16_384, 32, 1024, 4
N_REF_REQUESTS = 2048         # million_section's requests: its draws fix the oracle sample
TILED_MODES = ("fp32", "int8", "bf16")
EPOCHS, HOLD_EPOCHS, EVAL_CHUNK = 20, 2, 1024
CLI_ARGS = ["--full", "--epochs", "3", "--dp-sigma", "1", "--dp-clip", "0.5"]
DP = dict(dp_sigma=1.0, dp_clip=0.5, dp_seed=0)
SERVING_KERNELS = ("serve_topk_rows", "recommend_topk_peruser", "dmf_fused_step",
                   "serve_topk", "serve_topk_window")
TILED_KERNELS = ("serve_topk_window", "serve_topk_tiled_quant")
TRAINING_KERNELS = ("recommend_topk_peruser", "dmf_fused_step", "dmf_fused_step_dp",
                    "dp_clip_noise", "gauss_counter")
BASELINE_KERNELS = ("recommend_topk", "dmf_grads", "gossip_mix_op")
GRAD_TOL = 2e-5               # kernel 9 vs plain, abs + rel (plus the dot-order bound)
N_PER_REQUEST = 256           # DMF users served one request at a time (kernel 4, R=1)
MIX_TIMED = 20                # kernel 10 calls per timed run at the Foursquare shape
MIX_PLAIN_TIMED = 3           # its plain and library products (~50 ms each) per timed run
# the paper's tuned per-model hyperparameters (benchmarks/paper_tables.py:19-22)
DMF_MODES = {"GDMF": dict(mode="gdmf", beta=0.1, gamma=0.0),
             "LDMF": dict(mode="ldmf", beta=0.0, gamma=0.01)}
# phase 3e: the reference's churn bench resume configuration
# (benchmarks/churn_bench.py:121-133, late joiners added) and its
# Byzantine bench headline (benchmarks/byzantine_bench.py:124-158)
ROBUST_DP = dict(dp_sigma=0.5, dp_clip=0.25, dp_seed=0)
ROBUST_CHURN = dict(dropout=0.2, delay_classes=(0, 1, 2), late_frac=0.1, seed=17)
TRIVIAL_EPOCHS, CHURN_EPOCHS, BYZ_EPOCHS = 3, 4, 10
BYZ_FRAC, BYZ_SCALE = 0.2, 100.0
AUDIT_SIGMAS, AUDIT_CLIP = (0.0, 1.0), 0.25
ROBUST_CLI = ["--full", "--epochs", "3", "--dp-sigma", "0.5", "--dp-clip", "0.25",
              "--churn-dropout", "0.2", "--churn-delay", "2", "--screen", "--aggregation", "trim",
              "--checkpoint-every", "1"]
ROBUST_PARTS = {"trivial": ("dmf_fused_step", "dmf_fused_step_dp", "gauss_counter"),
                "churn": ("dmf_fused_step_dp", "gauss_counter"),
                "byzantine": ("dmf_fused_step",),
                "audit": ("dmf_fused_step", "dp_clip_noise"),
                "cli": ("dmf_fused_step_dp", "gauss_counter")}
# phase 3f: the reference scheduler bench's single-shard grid at full size
# (benchmarks/scheduler_bench.py:158-215 with full=True: 1,024 requests,
# Poisson arrivals, power-law users, SLO 50 ms, loads 0.5/1/2 × the
# measured capacity, seeds 100 + i), one on/off stream at 1×, its ingest
# interleave (:84-130), and telemetry on the DP and the screened fits
SCHED_REQUESTS, SCHED_SLO_MS, SCHED_LOADS, SCHED_ZIPF = 1024, 50.0, (0.5, 1.0, 2.0), 1.1
SCHED_ONOFF = dict(process="onoff", burst_factor=4.0, duty_cycle=0.2, period_s=0.05)
SCHED_CAPACITY_REPS, SCHED_INGEST_EVENTS, SCHED_HALF, SCHED_GAP_S = 5, 32, 48, 5.0
TELE_DP_EPOCHS, TELE_BYZ_EPOCHS = 3, 2
# phase 3g: learner-sharded training at full width, one spawn per group
SHARD_GROUPS = (("nccl", 1), ("gloo", 2))
SHARD_EPOCHS, SHARD_SHORT_EPOCHS = 5, 3
SHARD_TIMEOUT_S = 300.0
BYZ_LOSS_TOL = 1e-6           # the reference's cross-shard bar for defended runs
SHARDED_KERNELS = ("recommend_topk_peruser", "dmf_fused_step", "dmf_fused_step_dp",
                   "gauss_counter")
# phase 3g's serving half: the sharded engine on the DP-off state, phase
# 3a's requests and test check-ins, phase 3f's 1x Poisson stream
SHARDED_SERVING_KERNELS = ("serve_topk_rows", "recommend_topk_peruser", "dmf_fused_step")
SCHED_1X_SEED = 100 + SCHED_LOADS.index(1.0)
# --obs-detail only: what tracing and telemetry cost, where an epoch's time goes
SCHED_TRACE_TURNS = 2          # (plain, tracing, tracing, plain) repeats of the 1x stream
SPAN_COST_N, SPAN_COST_DISPATCHES = 5000, 50   # empty spans; back-to-back dispatches a turn
PROFILED_TELEMETRY = {"dp": ("off",), "screen_trim": ("off", "on")}   # one epoch each
# --e2e-turns: one process a turn, the other checkout and this one alternating
E2E_ORDER = ("other", "this", "this", "other") * 3
E2E_SERVES, E2E_DP_EPOCHS = 3, 4
SCHED_KERNELS = ("serve_topk_rows", "dmf_fused_step")
TELE_KERNELS = ("dmf_fused_step_dp", "gauss_counter", "dmf_fused_step")
# phase 3h: the LM stack's serving path, no kernel of the port on it
LM_QWEN, LM_SWA = "qwen1.5-4b", "yi-34b-swa"
LM_BATCH, LM_PROMPT, LM_DECODE = 4, 4096, 64        # bf16 prefill B x S, greedy decode steps
LM_CACHE = LM_PROMPT + LM_DECODE                    # 4,160 decode cache positions
LM_HOLD_PROMPT, LM_HOLD_STEPS = 504, 8              # fp32 hold: prefill, teacher-forced steps
LM_HOLD_RTOL, LM_HOLD_ATOL = 5e-2, 5e-3             # tests/test_models_smoke.py decode vs forward
LM_PROMPT_OTHER = 56                                # the other configs' prefill (+8 steps = 64)
LM_PERIOD_CAP_BYTES = 30e9                          # one period above this runs at reduced()
LM_SWA_PROMPT, LM_SWA_TOKENS = 8192, 10_240         # the ring of 8,192 wraps at position 8,192
LM_CPU_PREFILL, LM_CPU_STEPS = 8, 4                 # card vs CPU at reduced()
LM_CARD_CPU_REL = 1e-4
LM_PROFILED = 4                                     # decode steps under the profiler
# phase 3i: the LM stack's training half, no kernel of the port on it either
LM_TRAIN_BATCH, LM_TRAIN_SEQ = 1, 4096              # train_4k's sequence; its batch 256 cut to 1
LM_TRAIN_WARMUP, LM_TRAIN_TIMED, LM_TRAIN_PROFILED = 1, 8, 2
LM_TRAIN_PEAK_LR, LM_TRAIN_WARMUP_STEPS = 3e-3, 20  # examples/train_lm.py's schedule and decay
LM_TRAIN_WD = 0.01
LM_TRAIN_DROP = 1.0                                 # nats the loss must fall over the timed steps
LM_REMAT_LAYERS = 2                                 # remat on vs off, full width, bit for bit
# the reference's test_gossip_training_converges_small_lm (tests/test_gossip.py:84-111)
LM_GOSSIP = dict(n_kv_heads=4, vocab_size=256, d_model=128, d_ff=256, n_heads=4, head_dim=32)
LM_GOSSIP_LEARNERS, LM_GOSSIP_WALK, LM_GOSSIP_LR, LM_GOSSIP_STEPS = 4, 2, 6e-3, 60
LM_TRAIN_CPU_BATCH, LM_TRAIN_CPU_SEQ = 2, 32        # card vs CPU at reduced()
BF16_FLOPS_PER_S = 989e12     # H100 SXM data sheet, dense bf16 tensor cores


def log(*parts) -> None:
    print(*parts, flush=True)


# --------------------------------------------------------------------- inputs
def window_inputs(rng, R, Cw, J, K, dev):
    """Seeded serve-window inputs with exact ties and padding."""
    U = rng.normal(0, 1, (R, K)).astype(np.float32)
    U[1] = 0.0
    Vw = rng.normal(0, 1, (R, Cw, K)).astype(np.float32)
    Vw[2, ::3] = 0.0
    Vw[3, 10:40] = Vw[3, 5]
    n_valid = rng.integers(Cw // 2, Cw + 1, R)
    n_valid[4], n_valid[5] = 3, 0
    cand = np.full((R, Cw), -1, np.int32)
    for r in range(R):
        cand[r, : n_valid[r]] = np.sort(rng.choice(J, n_valid[r], replace=False))
    seen = (rng.random((R, Cw)) < 0.05).astype(np.int8)
    seen[6], seen[4] = 1, 0
    return tuple(torch.as_tensor(x, device=dev) for x in (U, Vw, cand, seen))


def slab_inputs(rng, R, Cw, J, K, dev):
    """Whole (R, J, K) item slabs and (R, J) seen rows that hold
    `window_inputs`' windows and seen bits at the candidate ids, random
    elsewhere."""
    U, Vw, cand, seen_w = window_inputs(rng, R, Cw, J, K, dev)
    V = torch.as_tensor(rng.normal(0, 1, (R, J, K)).astype(np.float32), device=dev)
    seen = torch.as_tensor((rng.random((R, J)) < 0.05).astype(np.int8), device=dev)
    r, c = torch.nonzero(cand >= 0, as_tuple=True)
    V[r, cand[r, c].long()] = Vw[r, c]
    seen[r, cand[r, c].long()] = seen_w[r, c]
    return U, V, cand, seen


def gather_windows(V, seen, cand):
    """The (R, Cw, K) windows and (R, Cw) seen bits of whole slabs at the
    candidate ids, as the engines gather them."""
    rows = torch.arange(cand.shape[0], device=cand.device)[:, None]
    safe = cand.clamp_min(0).long()
    return V[rows, safe], seen[rows, safe]


def quant_forms(Vw):
    """[(form, Vq, scale)]: int8 codes with per-request scales, as the
    tiled store quantizes, and bf16 with scale 1."""
    from repro_torch.serving.store import int8_rows
    codes, scale = int8_rows(Vw)
    return [("int8", codes, scale),
            ("bf16", Vw.to(torch.bfloat16), torch.ones(Vw.shape[0], device=Vw.device))]


def dense_inputs(rng, R, J, K, dev):
    U = rng.normal(0, 1, (R, K)).astype(np.float32)
    U[0] = 0.0
    V = rng.normal(0, 1, (R, J, K)).astype(np.float32)
    V[2, 50:] = 0.0
    V[3, 100:200] = V[3, 7]
    mask = (rng.random((R, J)) < 0.01).astype(np.int8)
    mask[4] = 1
    mask[5] = 1
    mask[5, [11, 2000, J - 1]] = 0
    return tuple(torch.as_tensor(x, device=dev) for x in (U, V, mask))


def step_inputs(rng, B, K, dev):
    u, p, q = (rng.normal(0, 0.5, (B, K)).astype(np.float32) for _ in range(3))
    p[:7] = 0.0
    r = (rng.random(B) < 0.25).astype(np.float32)
    conf = np.where(r > 0, 1.0, 1.0 / 3).astype(np.float32)
    return tuple(torch.as_tensor(x, device=dev) for x in (u, p, q, r, conf))


# ------------------------------------------------------------------ holding
def window_scores(U, Vw, cand, seen):
    """Plain masked scores of each window position, on the host."""
    from repro_torch.kernels import ref
    s = (U[:, None, :] * Vw).sum(-1).masked_fill((cand < 0) | (seen != 0), ref.NEG_INF)
    return s.cpu().numpy(), cand.cpu().numpy()


def hold_topk(name, got, plain, score_of) -> float:
    """Hold a kernel's top-k against the plain version's: values within
    TOL, dead slots identical, and an index may differ only where the plain
    scores of the two items are within TOL. Returns the max value error."""
    gv, gi = (np.asarray(x.cpu() if torch.is_tensor(x) else x) for x in got)
    pv, pi = (np.asarray(x.cpu() if torch.is_tensor(x) else x) for x in plain)
    assert gv.shape == pv.shape and gi.shape == pi.shape, (name, gv.shape, pv.shape)
    assert np.isfinite(gv).all(), f"{name}: non-finite values"
    np.testing.assert_array_equal(gi < 0, pi < 0, err_msg=f"{name}: dead slots differ")
    err = float(np.abs(gv - pv).max()) if gv.size else 0.0
    assert err <= TOL, f"{name}: max |value diff| {err} > {TOL}"
    for r, s in np.argwhere(gi != pi):
        chosen = score_of(r, int(gi[r, s]))
        assert abs(chosen - float(pv[r, s])) <= TOL, (
            f"{name}: row {r} slot {s} holds item {gi[r, s]} scoring {chosen}, "
            f"plain holds {pi[r, s]} at {pv[r, s]}")
    for row in gi:
        live = row[row >= 0]
        assert len(np.unique(live)) == len(live), f"{name}: repeated item in {row}"
    return err


def hold_window(name, got, U, Vw, cand, seen, k) -> float:
    from repro_torch.kernels import ref
    plain = ref.serve_topk_window_ref(U, Vw, cand, seen, k)
    scores, ids = window_scores(U, Vw, cand, seen)

    def score_of(r, item):
        pos = np.flatnonzero(ids[r] == item)
        assert len(pos) == 1, f"{name}: row {r} returned item {item} not in its window"
        return float(scores[r, pos[0]])
    return hold_topk(name, got, plain, score_of)


def hold_dense(name, got, U, V, mask, k) -> float:
    from repro_torch.kernels import ref
    plain = ref.topk_scores_peruser_ref(U, V, mask, k)
    scores = (U[:, None, :] * V).sum(-1).masked_fill(mask != 0, ref.NEG_INF).cpu().numpy()
    return hold_topk(name, got, plain, lambda r, item: float(scores[r, item]))


def hold_slab(name, got, U, V, cand, seen, k) -> float:
    from repro_torch.kernels import ref
    plain = ref.serve_topk_ref(U, V, cand, seen, k)
    elig = torch.zeros(seen.shape, dtype=torch.bool, device=seen.device)
    r, c = torch.nonzero(cand >= 0, as_tuple=True)
    elig[r, cand[r, c].long()] = True
    scores = (U[:, None, :] * V).sum(-1).masked_fill(~elig | (seen != 0), ref.NEG_INF)
    scores = scores.cpu().numpy()
    return hold_topk(name, got, plain, lambda r, item: float(scores[r, item]))


def hold_quant(name, got, U, Vq, scale, cand, seen_w, k) -> float:
    """The quant kernel against its plain version, which is the window
    version on the dequantized windows."""
    return hold_window(name, got, U, Vq.float() * scale[:, None, None], cand, seen_w, k)


def same_bits(name, got, want) -> None:
    for a, b in zip(got, want):
        assert torch.equal(a, b), f"{name}: not equal bit for bit"


def hold_step(got, plain) -> float:
    err = max(float((a - b).abs().max()) for a, b in zip(got[:3], plain[:3]))
    assert err <= TOL, f"dmf_fused_step: max |delta diff| {err} > {TOL}"
    loss_rel = abs(float(got[3]) - float(plain[3])) / max(abs(float(plain[3])), 1e-30)
    assert loss_rel <= TOL, f"dmf_fused_step: loss rel diff {loss_rel} > {TOL}"
    return err


def check_kernels(dev, J: int) -> dict[str, float]:
    """Phase 2: each kernel against its plain version at the slice shapes."""
    from repro_torch.kernels import ops, ref
    rng = np.random.default_rng(SEED)
    errs = {}
    U, Vw, cand, seen = window_inputs(rng, MICROBATCH, 384, J, 10, dev)
    errs["serve_topk_window"] = max(
        hold_window(f"serve_topk_window k={k}", ops.serve_topk_window(U, Vw, cand, seen, k),
                    U, Vw, cand, seen, k) for k in (1, K_TOP, 16))
    sync(dev)
    U, V, mask = dense_inputs(rng, MICROBATCH, J, 10, dev)
    errs["recommend_topk_peruser"] = max(
        hold_dense(f"recommend_topk_peruser k={k}", ops.recommend_topk_peruser(U, V, mask, k),
                   U, V, mask, k) for k in (1, K_TOP, 16))
    errs["recommend_topk_peruser"] = max(errs["recommend_topk_peruser"],
                                         check_peruser_rows(dev, J))
    sync(dev)
    hp = dict(theta=0.1, alpha=0.1, beta=0.1, gamma=0.01)
    errs["dmf_fused_step"] = max(
        hold_step(ops.dmf_fused_step(*x, **hp), ref.dmf_fused_step_ref(*x, *hp.values()))
        for x in (step_inputs(rng, B, 10, dev) for B in (256, 100, 1, 1000, 5000)))
    # other widths: K=8 staged through shared memory at run-time K, K=16 read
    # in place (too wide to stage)
    krng = np.random.default_rng(SEED + 3)
    errs["dmf_fused_step"] = max(errs["dmf_fused_step"], *(
        hold_step(ops.dmf_fused_step(*x, **hp), ref.dmf_fused_step_ref(*x, *hp.values()))
        for x in (step_inputs(krng, B, K, dev) for K in (8, 16) for B in (256, 1000))))
    sync(dev)
    U, V, cand, seen = slab_inputs(rng, MICROBATCH, 384, J, 10, dev)
    vw, sw = gather_windows(V, seen, cand)
    errs["serve_topk"] = max(
        hold_slab(f"serve_topk k={k}", ops.serve_topk(U, V, cand, seen, k), U, V, cand, seen, k)
        for k in (1, K_TOP, 16))
    for k in (1, K_TOP, 16):
        same_bits(f"serve_topk vs serve_topk_window k={k}", ops.serve_topk(U, V, cand, seen, k),
                  ops.serve_topk_window(U, vw, cand, sw, k))
    sync(dev)
    errs["serve_topk_rows"] = check_rows(dev, J)
    errs["serve_topk_window_quant"], errs["serve_topk_tiled_quant"] = check_quant(rng, dev, J)
    errs["gauss_counter"] = check_stream(dev)
    errs["dp_clip_noise"] = check_clip_noise(rng, dev)
    errs["dmf_fused_step_dp"] = max(check_step_dp(rng, dev, hp),
                                    *(check_step_dp(krng, dev, hp, K) for K in (8, 16)))
    errs["recommend_topk"] = check_topk_shared(dev)
    errs["dmf_grads"] = check_grads(dev)
    errs["gossip_mix_op"] = check_mix(dev)
    sync(dev)
    return errs


def rows_inputs(rng, N, J, K, dev):
    """Kernel 2's row sources: U (N, K), P and Q (N, J, K) and a mask
    (N, J), with exact ties (a zero user, v = 0 items, repeated items), an
    all-masked row and a row with three unmasked items."""
    U, P, mask = (x.cpu().numpy() for x in dense_inputs(rng, N, J, K, dev))
    Q = rng.normal(0, 1, (N, J, K)).astype(np.float32)
    P[1, ::3] = -Q[1, ::3]                  # v = p + q = 0 exactly
    Q[3, 100:200] = Q[3, 7]                 # with P's repeated items: repeated v
    return tuple(torch.as_tensor(x, device=dev) for x in (U, P, Q, mask))


def peruser_row_cases(dev, J: int) -> list:
    """[(name, U, V, mask, k, Q, rows)] of kernel 2 reading rows in place:
    rows repeated, unsorted, odd (8 bytes off a 16-byte boundary at K=10),
    with and without Q, and slices of P and Q at an odd start, each at k
    1/10/16. The materialized equivalent of each is
    `materialize`'s."""
    rng = np.random.default_rng(SEED + 5)
    U, P, Q, mask = rows_inputs(rng, MICROBATCH + 9, J, 10, dev)
    rows = torch.as_tensor(rng.permutation(MICROBATCH + 9)[:MICROBATCH], device=dev)
    rows[1], rows[2], rows[3] = rows[0], 1, 4           # repeated, odd, the all-masked row
    Ur = U[:MICROBATCH].contiguous()
    cases = []
    for k in (1, K_TOP, 16):
        cases += [(f"rows k={k}", Ur, P, mask, k, None, rows),
                  (f"rows+Q k={k}", Ur, P, mask, k, Q, rows),
                  (f"slice [1:65]+Q k={k}", U[1:1 + MICROBATCH], P[1:1 + MICROBATCH],
                   mask[1:1 + MICROBATCH], k, Q[1:1 + MICROBATCH], None)]
    return cases


def materialize(V, mask, Q, rows):
    """The V rows and mask rows a rows/Q call of kernel 2 reads."""
    if rows is not None:
        V, mask, Q = V[rows], mask[rows], None if Q is None else Q[rows]
    return (V if Q is None else V + Q).contiguous(), mask.contiguous()


def check_peruser_rows(dev, J: int) -> float:
    """Kernel 2 on rows in place (`peruser_row_cases`): against its plain
    version, and bit for bit against the kernel on the materialized rows."""
    from repro_torch.kernels import ops
    err = 0.0
    for name, U, V, mask, k, Q, rows in peruser_row_cases(dev, J):
        got = ops.recommend_topk_peruser(U, V, mask, k, Q=Q, rows=rows)
        Vm, Mm = materialize(V, mask, Q, rows)
        err = max(err, hold_dense(f"recommend_topk_peruser {name}", got, U, Vm, Mm, k))
        same_bits(f"recommend_topk_peruser {name} vs materialized rows", got,
                  ops.recommend_topk_peruser(U, Vm, Mm, k))
    sync(dev)
    return err


def hold_shared(name, got, U, V, mask, k) -> float:
    """Kernel 4 against its plain version on a shared (J, K) V."""
    from repro_torch.kernels import ref
    plain = ref.topk_scores_ref(U, V, mask, k)
    with ref.fp32_matmul():
        scores = (U @ V.T).masked_fill(mask != 0, ref.NEG_INF).cpu().numpy()
    return hold_topk(name, got, plain, lambda r, item: float(scores[r, item]))


SHARED_SHAPES = ((128, 256, 8, 5), (150, 500, 12, 10), (64, 1000, 15, 16), (256, 256, 5, 1))


def shared_inputs(seed, R, J, K, dev):
    """Kernel 4's seeded (U, V, mask) at `tests/test_kernels.py`'s draws."""
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.normal(size=(R, K)).astype(np.float32), device=dev),
            torch.as_tensor(rng.normal(size=(J, K)).astype(np.float32), device=dev),
            torch.as_tensor(rng.random((R, J)) < 0.1, device=dev))


def zero_user_inputs(dev):
    """The tie-heavy case: 64 all-zero users over J=3,197 (one all masked),
    whose slates are the lowest unmasked ids."""
    U, V, mask = shared_inputs(3, 64, 3197, 10, dev)
    U.zero_()
    mask[1] = True
    return U, V, mask


def check_topk_shared(dev) -> float:
    """Kernel 4 at `tests/test_kernels.py`'s shapes, and a tie-heavy case:
    all-zero users score every item 0, so each slate is the lowest
    unmasked ids."""
    from repro_torch.kernels import ops
    err = 0.0
    for R, J, K, k in SHARED_SHAPES:
        U, V, mask = shared_inputs(R + J + k, R, J, K, dev)
        err = max(err, hold_shared(f"recommend_topk R={R} J={J} k={k}",
                                   ops.recommend_topk(U, V, mask, k), U, V, mask, k))
    U, V, mask = zero_user_inputs(dev)
    got = ops.recommend_topk(U, V, mask, 16)
    err = max(err, hold_shared("recommend_topk all-zero users", got, U, V, mask, 16))
    for r, m in enumerate(mask.cpu().numpy()):
        want = np.full(16, -1)
        lowest = np.flatnonzero(~m)[:16]
        want[:len(lowest)] = lowest
        assert got[1][r].tolist() == want.tolist(), f"recommend_topk: tie order, row {r}"
    sync(dev)
    return err


def grads_inputs(rng, B, K, dev):
    """`tests/test_kernels.py`'s gradient inputs: u/p/q normal, r/conf uniform."""
    x = [rng.normal(size=(B, K)).astype(np.float32) for _ in range(3)]
    x += [rng.random(B).astype(np.float32) for _ in range(2)]
    return tuple(torch.as_tensor(a, device=dev) for a in x)


def hold_grads(got, sx, hp) -> float:
    """Kernel 9 against its plain version: each gradient within GRAD_TOL
    abs + rel, plus the bound on two fp32 orders of the residual's K-term
    dot (2·K·2⁻²⁴·c·Σ|u·v|) times the residual's factor (|v| for gu, |u|
    for gp and gq). Returns the max abs error."""
    from repro_torch.kernels import ref
    u, p, q, r, c = sx
    K = u.shape[1]
    v = p + q
    dot_err = (2 * K * 2.0**-24 * c * (u * v).abs().sum(-1))[:, None]
    err = 0.0
    for g, w, factor in zip(got, ref.dmf_grads_ref(*sx, *hp.values()), (v.abs(), u.abs(), u.abs())):
        diff = (g - w).abs()
        assert bool((diff <= GRAD_TOL * (1 + w.abs()) + dot_err * factor).all()), (
            f"dmf_grads: |diff| {float(diff.max())} over its bound")
        err = max(err, float(diff.max()))
    return err


GRAD_SHAPES = tuple((B, K) for B in (64, 256, 300, 1024) for K in (5, 10, 15, 128)) + ((2048, 16),)


def check_grads(dev) -> float:
    """Kernel 9 at `tests/test_kernels.py`'s shapes and at the micro-bench
    shape (B=2048, K=16)."""
    from repro_torch.kernels import ops
    hp = dict(alpha=0.1, beta=0.01, gamma=0.02)
    err = 0.0
    for B, K in GRAD_SHAPES:
        sx = grads_inputs(np.random.default_rng(B * K), B, K, dev)
        err = max(err, hold_grads(ops.dmf_grads(*sx, **hp), sx, hp))
    sync(dev)
    return err


def hold_mix(name, Y, M, X) -> float:
    """Kernel 10 against the fp32 product, elementwise within
    1e-5 + 1e-5·(|M| @ |X|). Returns the max abs error."""
    from repro_torch.kernels import ref
    M, X = M.float(), X.float()
    want = ref.gossip_mix_ref(M, X)
    bound = ref.gossip_mix_ref(M.abs(), X.abs()).mul_(TOL).add_(TOL)
    diff = (Y - want).abs_()
    assert Y.shape == want.shape and Y.dtype == torch.float32, (name, Y.shape, Y.dtype)
    assert bool(torch.isfinite(Y).all()), f"{name}: non-finite values"
    assert bool((diff <= bound).all()), f"{name}: |diff| {float(diff.max())} over its bound"
    return float(diff.max())


def check_mix(dev) -> float:
    """Kernel 10 at `tests/test_kernels.py`'s shapes and with bf16 inputs."""
    from repro_torch.kernels import ops
    err = 0.0
    for I, F in ((128, 128), (200, 333), (512, 64), (77, 1000)):
        rng = np.random.default_rng(I + F)
        M = torch.as_tensor(rng.normal(size=(I, I)).astype(np.float32), device=dev)
        X = torch.as_tensor(rng.normal(size=(I, F)).astype(np.float32), device=dev)
        err = max(err, hold_mix(f"gossip_mix_op I={I} F={F}", ops.gossip_mix_op(M, X), M, X))
    rng = np.random.default_rng(0)
    M = torch.as_tensor(rng.normal(size=(64, 64)), device=dev).bfloat16()
    X = torch.as_tensor(rng.normal(size=(64, 32)), device=dev).bfloat16()
    err = max(err, hold_mix("gossip_mix_op bf16", ops.gossip_mix_op(M, X), M, X))
    err = max(err, check_mix_routes(dev))
    sync(dev)
    return err


def walk_like(rng, I, per_row=10) -> np.ndarray:
    """A sparse M like the walk matrix: 1 on the diagonal and per_row
    small positive weights a row, zeros elsewhere."""
    M = np.zeros((I, I), np.float32)
    for i in range(I):
        M[i, rng.choice(I, per_row, replace=False)] = rng.random(per_row) / per_row
        M[i, i] = 1.0
    return M


def hold_mix_nonfinite(name, Y, M, X) -> float:
    """Kernel 10 on non-finite X: NaN and ±Inf exactly where the plain
    product has them, the finite entries within 1e-5 + 1e-5·(|M| @ |X|)
    (the non-finite X entries counted as 0 in the bound)."""
    from repro_torch.kernels import ref
    want = ref.gossip_mix_ref(M, X)
    assert torch.equal(torch.isnan(Y), torch.isnan(want)), f"{name}: NaN pattern differs"
    assert torch.equal(torch.isinf(Y) & (Y > 0), torch.isinf(want) & (want > 0)), name
    assert torch.equal(torch.isinf(Y) & (Y < 0), torch.isinf(want) & (want < 0)), name
    fin = torch.isfinite(want)
    bound = ref.gossip_mix_ref(M.abs(), torch.where(torch.isfinite(X), X.abs(), 0.0))
    diff = (Y - want).abs()[fin]
    assert bool((diff <= TOL + TOL * bound[fin]).all()), f"{name}: |diff| {float(diff.max())}"
    return float(diff.max()) if diff.numel() else 0.0


def check_mix_routes(dev) -> float:
    """Kernel 10's two routes on walk-like M: for finite X the sparse
    route equals the dense route bit for bit (sub-wave, ragged and one
    column shapes; at 2,048 × 300 the wrapper itself picks the sparse
    route); for X holding NaN and ±Inf the wrapper takes the dense route
    and gives the plain product's NaN pattern."""
    from repro_torch.kernels import gossip_mix, ops
    err = 0.0
    for I, F in ((512, 1024), (77, 1000), (130, 1), (2048, 300)):
        rng = np.random.default_rng(I * F)
        M = torch.as_tensor(walk_like(rng, I, min(10, I)), device=dev)
        X = torch.as_tensor(rng.normal(size=(I, F)).astype(np.float32), device=dev)
        sparse = gossip_mix.mix_on_route(M, X, "sparse")
        same_bits(f"gossip_mix_op sparse vs dense route I={I} F={F}", (sparse,),
                  (gossip_mix.mix_on_route(M, X, "dense"),))
        err = max(err, hold_mix(f"gossip_mix_op sparse route I={I} F={F}", sparse, M, X))
        if gossip_mix.counts_needed(I, F):
            Y = ops.gossip_mix_op(M, X)
            assert ops.gossip_mix_op.last_route == "sparse", ops.gossip_mix_op.last_route
            same_bits(f"gossip_mix_op I={I} F={F}", (Y,), (sparse,))
        X[3, 0] = float("inf")
        X[I - 1, F - 1] = float("-inf")
        X[I // 2, F // 2] = float("nan")
        Y = ops.gossip_mix_op(M, X)
        assert ops.gossip_mix_op.last_route == "dense", ops.gossip_mix_op.last_route
        err = max(err, hold_mix_nonfinite(f"gossip_mix_op non-finite X I={I} F={F}", Y, M, X))
    sync(dev)
    return err


def rows_state(rng, I, R, J, Cw, K, dev) -> dict:
    """A serving engine's resident state for kernel 5 in place: U (I, K)
    with an all-zero user (3); P and Q (I, J, K) with repeated rows (user
    5), V = P + Q; seen (I, J) with an all-seen user (2); 7 buckets of
    ascending ids (0 full, 1 padding only, 2 three ids: user 4's, unseen);
    R user ids, unsorted, with repeats and odd ids (rows 8 bytes off a
    16-byte boundary at K=10). Returns [(form, (ids, U, V, seen,
    user_bucket, bucket_items), Q)] on V and on P and Q."""
    n_buckets = 7
    bucket_items = np.full((n_buckets, Cw), -1, np.int32)
    for b in range(n_buckets):
        n = (Cw, 0, 3)[b] if b < 3 else int(rng.integers(Cw // 2, Cw + 1))
        bucket_items[b, :n] = np.sort(rng.choice(J, n, replace=False))
    user_bucket = rng.integers(0, n_buckets, I).astype(np.int64)
    user_bucket[:5] = (0, 1, 0, 0, 2)
    U = rng.normal(0, 1, (I, K)).astype(np.float32)
    U[3] = 0.0
    P, Q = (rng.normal(0, 1, (I, J, K)).astype(np.float32) for _ in range(2))
    P[5, ::2], Q[5, ::2] = P[5, -1], Q[5, -1]
    seen = (rng.random((I, J)) < 0.05).astype(np.int8)
    seen[2] = 1
    seen[4, bucket_items[2, :3]] = 0
    ids = rng.permutation(I)[:R].astype(np.int64)
    ids[:9] = (4, 0, 1, 2, 3, 5, 7, 7, 9)
    U, P, Q, seen, bucket_items, user_bucket, ids = (
        torch.as_tensor(x, device=dev)
        for x in (U, P, Q, seen, bucket_items, user_bucket, ids))
    rest = (seen, user_bucket, bucket_items)
    return [("V", (ids, U, P + Q, *rest), None), ("P+Q", (ids, U, P, *rest), Q)]


def gathered_rows(ids, U, V, seen, user_bucket, bucket_items, Q=None):
    """Kernel 1's inputs (u, windows, cand, seen windows) for kernel 5 in
    place: the gathers (and, with Q, the add) the pruned dispatch made
    before it read the engine's state in place."""
    cand = bucket_items[user_bucket[ids]]
    safe = cand.clamp_min(0).long()
    rows = ids[:, None]
    win = V[rows, safe] if Q is None else V[rows, safe] + Q[rows, safe]
    return U[ids], win, cand, seen[rows, safe]


def check_rows(dev, J: int) -> float:
    """Kernel 5 reading a serving state in place (`rows_state`, at the
    serving shape and a smaller one at K=8), on V and through P and Q, k
    1/10/16: against its plain version, and bit for bit against kernel 1 on
    the gathered windows; at the serving shape a bucket of padding only and
    an all-seen user serve nothing, an all-zero user the lowest unseen ids,
    three candidates under k fill three slots. Returns the max value
    error."""
    from repro_torch.kernels import ops
    rng = np.random.default_rng(SEED + 23)
    err = 0.0
    for I, R, n_items, Cw, K in ((200, MICROBATCH, J, 384, 10), (90, 37, 500, 128, 8)):
        for form, args, Q in rows_state(rng, I, R, n_items, Cw, K, dev):
            window = gathered_rows(*args, Q=Q)
            for k in (1, K_TOP, 16):
                got = ops.serve_topk_rows(*args, k, Q=Q)
                err = max(err, hold_window(f"serve_topk_rows {form} R={R} k={k}", got, *window, k))
                same_bits(f"serve_topk_rows {form} R={R} k={k} vs kernel 1 on the gathered "
                          "windows", got, ops.serve_topk_window(*window, k))
            if R == MICROBATCH:
                vals, idx = got
                live = [c for c in args[5][0].tolist() if c >= 0 and not args[3][3, c]]
                assert (idx[2:4] == -1).all(), f"serve_topk_rows {form}: empty bucket or all seen"
                assert int((idx[0] >= 0).sum()) == 3, f"serve_topk_rows {form}: k above 3 live"
                assert idx[4].tolist() == live[:16] and bool((vals[4] == 0).all()), (
                    f"serve_topk_rows {form}: the all-zero user's slate")
    sync(dev)
    return err


def check_quant(rng, dev, J: int) -> tuple[float, float]:
    """Kernel 6 in both forms at the serving and the million shape, with an
    all-zero int8 request (scale 1e-12): pre-gathered against its plain
    version and bit for bit against kernel 1 on the dequantized windows;
    reading a store in place (`tiled_inputs`) against its plain version
    and bit for bit against the pre-gathered form on the gathered windows.
    Returns the two forms' max value errors."""
    from repro_torch.kernels import ops
    err = tiled_err = 0.0
    for R, Cw, n_items, K in ((MICROBATCH, 384, J, 10), (M_MICROBATCH, M_CELL_CAP, M_ITEMS, M_DIM)):
        U, Vw, cand, seen = window_inputs(rng, R, Cw, n_items, K, dev)
        Vw[7] = 0.0
        for form, Vq, scale in quant_forms(Vw):
            if form == "int8":
                assert float(scale[7]) == np.float32(1e-12) and not Vq[7].any()
            deq = Vq.float() * scale[:, None, None]
            for k in (1, K_TOP, 16):
                got = ops.serve_topk_window_quant(U, Vq, scale, cand, seen, k)
                err = max(err, hold_quant(f"serve_topk_window_quant {form} R={R} k={k}", got,
                                          U, Vq, scale, cand, seen, k))
                same_bits(f"serve_topk_window_quant {form} vs serve_topk_window k={k}", got,
                          ops.serve_topk_window(U, deq, cand, seen, k))
        store = tiled_inputs(rng, R, Cw, n_items, K, dev)
        for form, args in store["forms"]:
            for k in (1, K_TOP, 16):
                got = ops.serve_topk_tiled_quant(*args, k)
                tiled_err = max(tiled_err, hold_quant(
                    f"serve_topk_tiled_quant {form} R={R} k={k}", got, *gathered(*args), k))
                same_bits(f"serve_topk_tiled_quant {form} vs serve_topk_window_quant k={k}", got,
                          ops.serve_topk_window_quant(*gathered(*args), k))
    sync(dev)
    return err, tiled_err


def tiled_inputs(rng, R, cap, n_items, K, dev) -> dict:
    """A tiled store's resident tensors for R requests of cap candidates:
    3·R users (a zero user, an all-seen user, an all-zero int8 user),
    R // 4 + 2 buckets of ascending ids (one all padding, one full), and R
    user ids with repeats. ``forms``: [(form, (ids, U, Vq, scale,
    user_bucket, bucket_items, seen))] for int8 (scale per user) and bf16
    (no scale)."""
    from repro_torch.serving.store import int8_rows
    I, n_buckets = 3 * R, R // 4 + 2
    bucket_items = np.full((n_buckets, cap), -1, np.int32)
    for b in range(n_buckets):
        n = (cap, 0)[b] if b < 2 else int(rng.integers(cap // 2, cap + 1))
        bucket_items[b, :n] = np.sort(rng.choice(n_items, n, replace=False))
    user_bucket = rng.integers(0, n_buckets, I).astype(np.int64)
    U = rng.normal(0, 1, (I, K)).astype(np.float32)
    U[1] = 0.0
    V = rng.normal(0, 1, (I, cap, K)).astype(np.float32)
    V[2] = 0.0
    V[3, 10:40] = V[3, 5]
    seen = (rng.random((I, cap)) < 0.05).astype(np.int8)
    seen[4] = 1
    ids = rng.integers(0, I, R).astype(np.int64)
    ids[:5] = np.arange(5)
    ids[6] = ids[5]
    U, V, seen, bucket_items, user_bucket, ids = (
        torch.as_tensor(x, device=dev) for x in (U, V, seen, bucket_items, user_bucket, ids))
    codes, scale = int8_rows(V)
    rest = (user_bucket, bucket_items, seen)
    return {"forms": [("int8", (ids, U, codes, scale, *rest)),
                      ("bf16", (ids, U, V.to(torch.bfloat16), None, *rest))]}


def gathered(ids, U, Vq, scale, user_bucket, bucket_items, seen):
    """The pre-gathered kernel 6's inputs (U, Vq, scale, cand, seen) for
    the in-place form's: the six gathers the tiled dispatch made before it
    read the store in place."""
    sc = (torch.ones(ids.shape[0], dtype=torch.float32, device=ids.device) if scale is None
          else scale[ids])
    return U[ids], Vq[ids], sc, bucket_items[user_bucket[ids]], seen[ids]


def stream_rids(dev) -> torch.Tensor:
    """Rids 0..29,999 and the 128 around 2^23, where the high bits start
    folding into the row key."""
    rid = np.concatenate([np.arange(30_000), np.arange((1 << 23) - 64, (1 << 23) + 64)])
    return torch.as_tensor(rid.astype(np.int32), device=dev)


def check_stream(dev) -> float:
    """The noise stream at 1, 10 and 256 columns: hash words exact, draws
    within DRAW_TOL, and bit for bit those of the clip + noise kernel (one
    thread an element through the same device function) on zero messages
    with noise 1."""
    from repro_torch.kernels import dp_noise, ops
    rid = stream_rids(dev)
    err = 0.0
    for seed, K in ((0, 10), (7, 1), (2**31 - 1, 256)):
        for got, plain in zip(dp_noise.counter_words(seed, rid, K),
                              dp_noise.counter_words_ref(seed, rid, K)):
            assert torch.equal(got, plain), f"gauss_counter: hash words differ at seed {seed}"
        draws = ops.gauss_counter(seed, rid, K)
        err = max(err, float((draws - dp_noise.gauss_counter_ref(seed, rid, K)).abs().max()))
        msgs = ops.dp_clip_noise(torch.zeros_like(draws), rid, seed, clip=float("inf"),
                                 noise_std=1.0)
        same_bits(f"gauss_counter vs dp_clip_noise's draws, {K} columns", (draws + 0.0,), (msgs,))
    assert err <= DRAW_TOL, f"gauss_counter: max |draw diff| {err} > {DRAW_TOL}"
    return err


def clip_noise_inputs(rng, B, K, dev):
    """Messages with a zero-norm row and a tiny one; rids around 2^23."""
    g = rng.normal(0, 1, (B, K)).astype(np.float32)
    g[0] = 0.0
    g[1:2] *= 1e-3
    rid = ((1 << 23) - B // 2 + np.arange(B)).astype(np.int32)
    return torch.as_tensor(g, device=dev), torch.as_tensor(rid, device=dev)


def check_clip_noise(rng, dev, K: int = 10) -> float:
    from repro_torch.kernels import ops, ref
    err = 0.0
    for B in (256, 100, 1):
        g, rid = clip_noise_inputs(rng, B, K, dev)
        for clip in (float("inf"), 0.5, 1e-3):
            for std in (0.0, 0.7):
                got = ops.dp_clip_noise(g, rid, 7, clip=clip, noise_std=std)
                err = max(err, float((got - ref.dp_clip_noise_ref(g, rid, 7, clip, std))
                                     .abs().max()))
                if clip == float("inf") and std == 0.0:
                    assert torch.equal(got, g), "dp_clip_noise: disabled mechanism is not identity"
    assert err <= DRAW_TOL, f"dp_clip_noise: max |diff| {err} > {DRAW_TOL}"
    return err


def check_step_dp(rng, dev, hp, K: int = 10) -> float:
    from repro_torch.kernels import ops, ref
    err = 0.0
    for B in (256, 100, 1, 5000):
        u, p, q, r, conf = step_inputs(rng, B, K, dev)
        u[0] = 0.0                      # with p[0] = 0: a zero-norm message row
        for clip in (float("inf"), 0.5, 1e-3):
            for zs in (0.0, 0.5):
                z = torch.as_tensor((zs * rng.normal(0, 1, (B, K))).astype(np.float32),
                                    device=dev)
                err = max(err, hold_step(
                    ops.dmf_fused_step_dp(u, p, q, r, conf, z, **hp, clip=clip),
                    ref.dmf_fused_step_dp_ref(u, p, q, r, conf, z, *hp.values(), clip)))
    return err


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ---------------------------------------------------------------- main path
def build_world(ds, dev):
    """The neighbor table, the dense (I, I) walk matrix it was cut from
    (host numpy, for kernel 10), the candidate index and the config."""
    from repro_torch.configs import dmf_foursquare as fsq
    from repro_torch.core import graph
    from repro_torch.serving import index_from_dataset
    W = graph.build_adjacency(ds.user_coords, ds.user_city, fsq.GRAPH)
    M = graph.walk_propagation_matrix(W, fsq.GRAPH)
    nbr = graph.neighbor_table_from_dense(M, device=dev)
    return nbr, M, index_from_dataset(ds), fsq.dmf_config(ds.n_users, ds.n_items)


def drive_main_path(ds, nbr, index, cfg, dev) -> dict:
    """Phase 3 through the entry points a user calls. Returns what the
    checks and the report need."""
    from repro_torch.core import dmf, metrics
    from repro_torch.serving import OnlineConfig, ServingConfig, ServingEngine
    rng = np.random.default_rng(SEED)
    out = {}
    state = dmf.init_state(cfg, device=dev)
    eng = ServingEngine(state, index, ServingConfig(microbatch=MICROBATCH, k=K_TOP),
                        train=ds.train, nbr=nbr, dmf_cfg=cfg, device=dev)
    del state
    if dev.type == "cuda":
        out["resident_gb"] = torch.cuda.memory_allocated(dev) / 1e9
    t0 = time.perf_counter()
    warm = eng.ingest(ds.train, OnlineConfig())
    sync(dev)
    out["warm_ingest_s"] = time.perf_counter() - t0
    out["warm_batches"] = warm.n_batches
    assert np.isfinite(warm.losses).all(), "non-finite refresh loss"
    out["warm_loss_first_last"] = (warm.losses[0], warm.losses[-1])
    out["test_loss"] = dmf.test_loss(eng.state, ds.test)

    test_users = np.unique(ds.test[:, 0])
    _, rec, _ = eng.recommend(test_users, return_flags=True)
    test_mask = metrics.masks_from_interactions(ds.n_users, ds.n_items, ds.test)[test_users]
    out["P@10"], out["R@10"] = metrics.precision_recall_from_topk(rec, test_mask, K_TOP)

    def serve_round(tag, pruned_ids, dense_ids):
        eng.stats.reset()
        res = eng.recommend(pruned_ids, return_flags=True)
        out[f"{tag}_pruned"] = (pruned_ids, *res)
        out[f"{tag}_pruned_rps"] = eng.requests_per_sec
        out[f"{tag}_pruned_dispatch"] = eng.stats.dispatch_latency_percentiles()
        dense = ServingEngine(eng.state, index,
                              ServingConfig(microbatch=MICROBATCH, k=K_TOP, prune=False),
                              seen=eng.seen.cpu().numpy(), device=dev)
        res = dense.recommend(dense_ids, return_flags=True)
        out[f"{tag}_dense"] = (dense_ids, *res)
        out[f"{tag}_dense_rps"] = dense.requests_per_sec
        out[f"{tag}_dense_dispatch"] = dense.stats.dispatch_latency_percentiles()
        return dense

    pruned_ids = rng.integers(0, ds.n_users, N_PRUNED)
    dense_ids = rng.integers(0, ds.n_users, N_DENSE)
    serve_round("before", pruned_ids, dense_ids)
    report = eng.ingest(ds.test, OnlineConfig())
    assert np.isfinite(report.losses).all(), "non-finite refresh loss"
    out["test_ingest"] = (report.n_events, report.n_batches, len(report.touched_users))
    dense = serve_round("after", pruned_ids, dense_ids)
    out["engine"], out["dense_engine"], out["test_events"] = eng, dense, ds.test
    out.update(serve_staging_and_tiled(eng, index, pruned_ids, dev))
    if dev.type == "cuda":
        out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return out


def serve_staging_and_tiled(eng, index, pruned_ids, dev) -> dict:
    """The two checks of the reference's serving bench on the ingested
    state: kernel 5 on N_SLAB served requests' whole item rows beside
    kernel 1 on their windows (`serving_bench.py:327-346`), and the tiled
    store built from the state, served in fp32, beside `ServingEngine`
    pruned (`tests/test_serving_tiled.py:227-242`). The engine is built
    fresh on the same seen mask, so both sides count popularity alike."""
    from repro_torch.kernels import ops
    from repro_torch.serving import (ServingConfig, ServingEngine, TiledFactorStore,
                                     TiledServingEngine)
    uids = torch.as_tensor(pruned_ids[:N_SLAB], device=dev)
    cand = eng._bucket_items[eng._user_bucket[uids]]
    vw, sw = gather_windows(eng.V[uids], eng.seen[uids], cand)
    u = eng.state.U[uids]
    out = {"slab_vs_window": (ops.serve_topk(u, eng.V[uids], cand, eng.seen[uids], K_TOP),
                              ops.serve_topk_window(u, vw, cand, sw, K_TOP))}
    cfg = ServingConfig(microbatch=MICROBATCH, k=K_TOP)
    seen = eng.seen.cpu().numpy()
    fresh = ServingEngine(eng.state, index, cfg, seen=seen, device=dev)
    want = fresh.recommend(pruned_ids, return_flags=True)
    del fresh
    tiled = TiledServingEngine(TiledFactorStore.from_state(eng.state, index, seen), cfg)
    out["tiled_vs_engine"] = (tiled.recommend(pruned_ids, return_flags=True), want)
    out["tiled_fsq_rps"] = tiled.requests_per_sec
    return out


def check_staging_and_tiled(run) -> dict:
    """Both checks of `serve_staging_and_tiled`, bit for bit."""
    same_bits("served requests: serve_topk vs serve_topk_window", *run["slab_vs_window"])
    got, want = run["tiled_vs_engine"]
    for name, a, b in zip(("values", "ids", "flags"), got, want):
        np.testing.assert_array_equal(a, b, err_msg=f"tiled fp32 vs ServingEngine: {name}")
    return {"slab_vs_window_bitwise": True, "tiled_fp32_vs_engine_bitwise": True,
            "requests": len(got[0]), "fallbacks": int(got[2].sum()),
            "tiled_requests_per_s": run["tiled_fsq_rps"]}


def served_windows(eng, ids) -> tuple:
    """Kernel 1's inputs for the engine's requests ``ids`` (host ints): the
    windows the pruned dispatch gathered before it read the state in
    place."""
    uids = torch.as_tensor(np.asarray(ids, np.int64), device=eng.device)
    return gathered_rows(uids, eng.state.U, eng.V, eng.seen, eng._user_bucket, eng._bucket_items)


def check_slates(run, dev) -> dict[str, float]:
    """Hold N_CHECK served slates of each kind (fallback rows excluded)
    against the plain versions on the engine's own state; every served
    pruned slate bit for bit against kernel 1 on its gathered window."""
    from repro_torch.kernels import ops
    errs = {}
    for kind, eng in (("pruned", run["engine"]), ("dense", run["dense_engine"])):
        ids, vals, idx, flags = run[f"after_{kind}"]
        assert vals.shape == (len(ids), K_TOP) and np.isfinite(vals).all()
        assert ((idx >= -1) & (idx < eng.index.n_items)).all()
        keep = np.flatnonzero(~flags)[:N_CHECK]
        assert len(keep) == N_CHECK, f"only {len(keep)} unflagged {kind} rows"
        uids = torch.as_tensor(ids[keep], device=dev)
        got = (vals[keep], idx[keep])
        st = eng.state
        if kind == "pruned":
            window = gathered_rows(uids, st.U, eng.V, eng.seen, eng._user_bucket,
                                   eng._bucket_items)
            errs[kind] = hold_window("served pruned slates", got, *window, K_TOP)
            # every served request (fallbacks excluded): kernel 5 in place
            # served kernel 1's slate on the gathered windows, bit for bit
            live = np.flatnonzero(~flags)
            want = ops.serve_topk_window(*served_windows(eng, ids[live]), K_TOP)
            same_bits("served pruned slates vs kernel 1 on the gathered windows",
                      (torch.as_tensor(vals[live]), torch.as_tensor(idx[live])),
                      tuple(x.cpu() for x in want))
            errs["pruned_requests_bitwise"] = len(live)
        else:
            errs[kind] = hold_dense("served dense slates", got, st.U[uids], eng.V[uids],
                                    eng.seen[uids], K_TOP)
    return errs


def serving_summary(run) -> dict:
    """The end-to-end numbers of phase 3, unrounded."""
    out = {f"{tag}_ingest_{kind}": {
        "requests_per_s": run[f"{tag}_{kind}_rps"],
        "dispatch_p50_ms": run[f"{tag}_{kind}_dispatch"]["p50_ms"],
        "dispatch_p99_ms": run[f"{tag}_{kind}_dispatch"]["p99_ms"],
        "requests": len(run[f"{tag}_{kind}"][0]),
        "fallbacks": int(run[f"{tag}_{kind}"][3].sum())}
        for tag in ("before", "after") for kind in ("pruned", "dense")}
    out.update({key: run[key] for key in (
        "warm_ingest_s", "warm_batches", "warm_loss_first_last", "test_ingest",
        "resident_gb", "peak_gb", "test_loss", "P@10", "R@10")})
    return out


def drive_tiled(dev) -> dict:
    """Phase 3c through the entry points a user calls, at the reference's
    million configuration with its seeds (`million_section`,
    `serving_bench.py:129-235`): build, quantize, serve N_TILED requests
    per mode, then the exactness block and the row-sharding check.
    Returns what the checks, the timing and the report need."""
    from repro_torch.core import dmf
    from repro_torch.serving import (ServingConfig, ServingEngine, SyntheticFactors,
                                     TiledFactorStore, TiledServingEngine,
                                     build_hierarchical_index, synthetic_world)
    rng = np.random.default_rng(SEED)
    out = {"build_s": {}}
    on_card = dev.type == "cuda"
    base_bytes = torch.cuda.memory_allocated(dev) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    uc, ic, ucoord, icoord = synthetic_world(M_USERS, M_ITEMS, M_CITIES, seed=SEED)
    out["build_s"]["world"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hier = build_hierarchical_index(ic, uc, icoord, ucoord, cell_cap=M_CELL_CAP)
    out["build_s"]["index"] = time.perf_counter() - t0
    out["flat_city_cap_would_be"] = int(np.bincount(ic, minlength=M_CITIES).max())
    t0 = time.perf_counter()
    synth = SyntheticFactors.create(M_USERS, M_ITEMS, M_DIM, seed=SEED + 1)
    store = TiledFactorStore.synthetic(synth, hier.flat, seen_per_user=2, seed=SEED + 2,
                                       device=dev)
    sync(dev)
    out["build_s"]["store"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    store.quantize_int8()
    store.quantize_bf16()
    sync(dev)
    out["build_s"]["quantize"] = time.perf_counter() - t0
    out["store_gb"] = (torch.cuda.memory_allocated(dev) - base_bytes) / 1e9 if on_card else None

    users = np.random.default_rng(SEED).integers(0, M_USERS, N_TILED)
    rng.integers(0, M_USERS, N_REF_REQUESTS)   # the reference's draw, so its sample follows
    cfg = ServingConfig(microbatch=M_MICROBATCH, k=K_TOP)
    engines = {}
    for mode in TILED_MODES:
        eng = engines[mode] = TiledServingEngine(store, cfg, mode=mode)
        eng.recommend(users[:M_MICROBATCH])              # one warm-up dispatch
        eng.stats.reset()
        out[mode] = (users, *eng.recommend(users, return_flags=True))
        out[f"{mode}_rps"] = eng.requests_per_sec
        out[f"{mode}_dispatch"] = eng.stats.dispatch_latency_percentiles()

    # exactness: a dense sub-engine on the reference's sampled users, on
    # the same floats (P = the generator's dense rows, Q = 0; seen from the
    # store windows)
    pool = np.flatnonzero(~store.cold & (hier.flat.bucket_size[hier.flat.user_bucket] > 0))
    sample = rng.choice(pool, size=min(N_ORACLE, len(pool)), replace=False)
    n = len(sample)
    dense = synth.dense_rows(sample, device=dev)
    sub_state = dmf.DMFState(U=store.U[torch.as_tensor(sample, device=dev)], P=dense,
                             Q=torch.zeros_like(dense))
    cand_s = hier.flat.bucket_items[hier.flat.user_bucket[sample]]
    seen_s = store.seen[torch.as_tensor(sample, device=dev)].cpu().numpy()
    seen_sub = np.zeros((n, M_ITEMS), bool)
    for r in range(n):
        m = (cand_s[r] >= 0) & (seen_s[r] != 0)
        seen_sub[r, cand_s[r][m]] = True
    sub_index = dataclasses.replace(hier.flat, user_bucket=hier.flat.user_bucket[sample])
    sub_eng = ServingEngine(sub_state, sub_index,
                            ServingConfig(microbatch=min(M_MICROBATCH, n), k=K_TOP),
                            seen=seen_sub, device=dev)
    v_ref, i_ref, f_ref = sub_eng.recommend(np.arange(n), return_flags=True)
    del sub_eng, sub_state, dense
    v_t, i_t, f_t = engines["fp32"].recommend(sample, return_flags=True)
    assert not f_ref.any() and not f_t.any()
    exact = {"n_oracle_users": n,
             "fp32_bitwise_vs_dense_engine": bool((i_ref == i_t).all() and (v_ref == v_t).all())}
    slab_s = store.slab[torch.as_tensor(sample, device=dev)].cpu().numpy()
    u_s = store.U[torch.as_tensor(sample, device=dev)].cpu().numpy()
    for mode, bound in (("int8", store.int8_score_bound(sample)),
                        ("bf16", store.bf16_score_bound(sample))):
        vq, iq, fq = engines[mode].recommend(sample, return_flags=True)
        overlap = np.fromiter((len(set(a[a >= 0]) & set(b[b >= 0])) / max((a >= 0).sum(), 1)
                               for a, b in zip(i_t, iq)), np.float64, n)
        worst = 0.0
        for r in range(n):
            sc = slab_s[r] @ u_s[r]
            for slot in range(K_TOP):
                if iq[r, slot] >= 0:
                    pos = int(np.flatnonzero(cand_s[r] == iq[r, slot])[0])
                    worst = max(worst, abs(float(vq[r, slot]) - float(sc[pos])))
        exact[mode] = {"topk_overlap_vs_fp32": float(overlap.mean()),
                       "max_abs_score_delta": worst, "analytic_bound_max": float(bound.max())}
    out["exact"] = exact

    # row sharding: shard-local engines against the whole store
    from repro_torch.sharding.dmf import rows_per_shard
    shard_users = rng.choice(M_USERS, N_SHARD_USERS, replace=False)
    rows = rows_per_shard(M_USERS, N_SHARDS)
    shard_ok = {}
    for mode in TILED_MODES:
        whole = engines[mode].recommend(shard_users, return_flags=True)
        ok = True
        for start, sub in store.shard_rows(N_SHARDS):
            mine = np.flatnonzero(shard_users // rows == start // rows)
            got = TiledServingEngine(sub, cfg, mode=mode).recommend(
                shard_users[mine] - start, return_flags=True)
            ok &= all(np.array_equal(a, b[mine]) for a, b in zip(got, whole))
            ok &= sub.slab.untyped_storage().data_ptr() == store.slab.untyped_storage().data_ptr()
        shard_ok[mode] = bool(ok)
    out["shard_rows_bitwise"] = shard_ok
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9 if on_card else None
    out.update(store=store, hier=hier)
    return out


def check_tiled(tl) -> dict[str, float]:
    """Hold N_CHECK served slates per mode (fallback rows excluded)
    against the plain versions on the store's own windows; the exactness
    block and the row sharding must hold."""
    st = tl["store"]
    ex = tl["exact"]
    assert ex["fp32_bitwise_vs_dense_engine"], "tiled fp32 diverged from the dense sub-engine"
    for mode in ("int8", "bf16"):
        assert ex[mode]["max_abs_score_delta"] <= ex[mode]["analytic_bound_max"] + 1e-6, (mode, ex)
    assert all(tl["shard_rows_bitwise"].values()), tl["shard_rows_bitwise"]
    errs = {}
    for mode in TILED_MODES:
        ids, vals, idx, flags = tl[mode]
        assert vals.shape == (len(ids), K_TOP) and np.isfinite(vals).all()
        assert ((idx >= -1) & (idx < M_ITEMS)).all()
        keep = np.flatnonzero(~flags)[:N_CHECK]
        assert len(keep) == N_CHECK, f"only {len(keep)} unflagged {mode} rows"
        uids = torch.as_tensor(ids[keep], device=st.device)
        cand = torch.as_tensor(st.index.bucket_items, device=st.device)[
            torch.as_tensor(st.index.user_bucket, device=st.device).long()[uids]]
        u, sw, got = st.U[uids], st.seen[uids], (vals[keep], idx[keep])
        if mode == "fp32":
            errs[mode] = hold_window("served tiled fp32 slates", got, u, st.slab[uids], cand, sw,
                                     K_TOP)
        else:
            Vq, scale = ((st.q_codes[uids], st.q_scale[uids]) if mode == "int8" else
                         (st.slab_bf16[uids], torch.ones(len(keep), device=st.device)))
            errs[mode] = hold_quant(f"served tiled {mode} slates", got, u, Vq, scale, cand, sw,
                                    K_TOP)
    return errs


def tiled_summary(tl) -> dict:
    """The end-to-end numbers of phase 3c, unrounded."""
    hier, st = tl["hier"], tl["store"]
    return {
        "config": {"n_users": M_USERS, "n_items": M_ITEMS, "n_cities": M_CITIES, "dim": M_DIM,
                   "cell_cap": M_CELL_CAP, "microbatch": M_MICROBATCH, "k": K_TOP,
                   "n_requests": N_TILED},
        "index": {"n_cells": hier.n_cells, "cap": hier.flat.cap, "max_depth": hier.max_depth,
                  "flat_city_cap_would_be": tl["flat_city_cap_would_be"]},
        "build_s": tl["build_s"],
        "resident_gb": {key: v / 1e9 for key, v in st.nbytes().items()},
        "store_gb_on_card": tl["store_gb"], "peak_gb": tl["peak_gb"],
        "requests_per_s": {m: tl[f"{m}_rps"] for m in TILED_MODES},
        "dispatch_p50_ms": {m: tl[f"{m}_dispatch"]["p50_ms"] for m in TILED_MODES},
        "dispatch_p99_ms": {m: tl[f"{m}_dispatch"]["p99_ms"] for m in TILED_MODES},
        "fallback_frac": float(tl["fp32"][3].mean()),
        "exact": tl["exact"], "shard_rows_bitwise": tl["shard_rows_bitwise"],
    }


def drive_training(ds, nbr, index, cfg, dev) -> dict:
    """Phase 3b through the entry points a user calls: `fit` with DP off
    and on, `evaluate` unchunked and chunked, a DP online refresh of the
    DP-trained model, and the `dmf_train` CLI. Returns what the checks,
    the timing and the report need."""
    from repro_torch.core import dmf
    from repro_torch.launch import dmf_train
    from repro_torch.privacy import GaussianAccountant
    from repro_torch.serving import OnlineConfig, ServingConfig, ServingEngine

    def evaluate(state, **kw):
        return dmf.evaluate(state, ds.train, ds.test, ds.n_users, ds.n_items, device=dev, **kw)

    out = {"untrained": evaluate(dmf.init_state(cfg, device=dev))}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for tag, c in (("dp_off", cfg), ("dp_on", dataclasses.replace(cfg, **DP))):
        stamps = [time.perf_counter()]
        res = dmf.fit(c, ds.train, nbr, epochs=EPOCHS, device=dev,
                      callback=lambda t, state, loss: stamps.append(time.perf_counter()))
        assert np.isfinite(res.train_losses).all(), f"{tag}: non-finite training loss"
        sync(dev)
        t0 = time.perf_counter()
        metrics = evaluate(res.state)
        eval_s = time.perf_counter() - t0
        chunked = evaluate(res.state, chunk_users=EVAL_CHUNK)
        assert chunked == metrics, f"{tag}: chunked evaluate {chunked} != {metrics}"
        out[tag] = dict(fit=res, cfg=c, metrics=metrics, eval_s=eval_s,
                        epoch_s=np.diff(stamps).tolist(),
                        test_loss=dmf.test_loss(res.state, ds.test))
    if dev.type == "cuda":
        out["resident_gb"] = torch.cuda.memory_allocated(dev) / 1e9
    # the host half of a DP epoch: the accountant on one epoch's stream
    c = out["dp_on"]["cfg"]
    ui = dmf.sample_epoch(ds.train, c, np.random.default_rng(SEED + 1))[0]
    nb = len(ui) // c.batch_size
    acc = GaussianAccountant(n_users=c.n_users, sigma=c.dp_sigma)
    t0 = time.perf_counter()
    acc.observe_epoch(ui[:nb * c.batch_size].reshape(nb, c.batch_size))
    out["accountant_s"] = time.perf_counter() - t0
    eng = ServingEngine(out["dp_on"]["fit"].state, index,
                        ServingConfig(microbatch=MICROBATCH, k=K_TOP), train=ds.train,
                        nbr=nbr, dmf_cfg=out["dp_on"]["cfg"], device=dev)
    t0 = time.perf_counter()
    report = eng.ingest(ds.test, OnlineConfig())
    sync(dev)
    assert np.isfinite(report.losses).all(), "non-finite DP refresh loss"
    out["dp_ingest"] = dict(batches=report.n_batches, seconds=time.perf_counter() - t0,
                            touched=len(report.touched_users))
    del eng
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out["cli"] = dmf_train.main(CLI_ARGS)
    out["cli_lines"] = buf.getvalue().splitlines()
    if dev.type == "cuda":
        out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return out


def evaluate_peaks(ds, tr, dev) -> dict:
    """Device memory `evaluate` allocates above what is resident, at
    R=6,524 on the DP-off trained state: the peak reset just before the
    call and read just after. Beside it the same for the materializing
    sequence (V = P + Q, then kernel 2 on V)."""
    from repro_torch.core import dmf, metrics
    from repro_torch.kernels import ops
    st = tr["dp_off"]["fit"].state

    def peak_above(fn) -> float:
        sync(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        fn()
        sync(dev)
        return (torch.cuda.max_memory_allocated(dev) - base) / 1e9

    mask = torch.as_tensor(metrics.masks_from_interactions(ds.n_users, ds.n_items, ds.train),
                           device=dev)
    return {"evaluate_gb": peak_above(lambda: dmf.evaluate(
                st, ds.train, ds.test, ds.n_users, ds.n_items, device=dev)),
            "evaluate_chunked_gb": peak_above(lambda: dmf.evaluate(
                st, ds.train, ds.test, ds.n_users, ds.n_items, chunk_users=EVAL_CHUNK,
                device=dev)),
            "materialized_v_then_kernel_gb": peak_above(lambda: ops.recommend_topk_peruser(
                st.U, st.P + st.Q, mask, K_TOP))}


def check_training(tr) -> None:
    for tag in ("dp_off", "dp_on"):
        got, base = tr[tag]["metrics"]["P@10"], tr["untrained"]["P@10"]
        assert got > base, f"{tag}: trained P@10 {got} does not beat untrained {base}"
    assert tr["dp_on"]["fit"].privacy is not None and tr["dp_off"]["fit"].privacy is None
    assert any(line.startswith("privacy {") for line in tr["cli_lines"]), tr["cli_lines"]
    assert set(tr["cli"]) == {"P@5", "R@5", "P@10", "R@10"}, tr["cli"]


def hold_card_vs_cpu(ds, nbr, cfg, dev) -> dict:
    """HOLD_EPOCHS DP epochs on the card against the same epochs of the
    port on the CPU (the plain versions). Factors differ by fp32 rounding
    order: the scatters sum duplicates in another fixed order on each
    device, and a kernel may fuse a multiply-add its plain version rounds
    twice."""
    from repro_torch.core import dmf, graph
    dp_cfg = dataclasses.replace(cfg, **DP)
    card = dmf.fit(dp_cfg, ds.train, nbr, epochs=HOLD_EPOCHS, device=dev)
    host = dmf.fit(dp_cfg, ds.train, graph.NeighborTable(nbr.idx.cpu(), nbr.wgt.cpu()),
                   epochs=HOLD_EPOCHS, device="cpu")
    a, b = np.asarray(card.train_losses), np.asarray(host.train_losses)
    out = {"loss_rel": float((np.abs(a - b) / np.abs(b)).max()),
           "state_abs": max(float((getattr(card.state, n).cpu() - getattr(host.state, n))
                                  .abs().max()) for n in "UPQ"),
           "card_losses": card.train_losses, "cpu_losses": host.train_losses}
    log(f"  card vs cpu, {HOLD_EPOCHS} DP epochs: {json.dumps(out)}")
    assert out["loss_rel"] <= LOSS_REL_TOL, out
    assert out["state_abs"] <= STATE_TOL, out
    return out


def hold_repeat_runs(ds, nbr, cfg, dev) -> dict:
    """The port's accumulating scatters are deterministic: HOLD_EPOCHS of
    `fit` with DP off and on, and of `fit_mf` and `fit_bpr`, run twice from
    the same seed on the card, give the same losses and bitwise-equal
    factors."""
    from repro_torch.core import baselines, dmf
    out = {}
    for tag, c in (("dmf_dp_off", cfg), ("dmf_dp_on", dataclasses.replace(cfg, **DP))):
        a, b = (dmf.fit(c, ds.train, nbr, epochs=HOLD_EPOCHS, device=dev) for _ in range(2))
        out[tag] = (a.train_losses == b.train_losses
                    and all(torch.equal(getattr(a.state, n), getattr(b.state, n)) for n in "UPQ"))
        del a, b
    common = dict(n_users=ds.n_users, n_items=ds.n_items, dim=cfg.dim)
    for tag, c, fit in (("mf", baselines.MFConfig(**common), baselines.fit_mf),
                        ("bpr", baselines.BPRConfig(**common), baselines.fit_bpr)):
        (sa, la), (sb, lb) = (fit(c, ds.train, epochs=HOLD_EPOCHS, device=dev) for _ in range(2))
        out[tag] = la == lb and torch.equal(sa.U, sb.U) and torch.equal(sa.V, sb.V)
    log(f"  determinism, two runs of {HOLD_EPOCHS} epochs bitwise equal: {json.dumps(out)}")
    assert all(out.values()), out
    return out


def mechanism_batch(ds, state, dp_cfg, dev) -> dict:
    """One batch of epoch 0's DP stream (fit's own rng draws: U, the
    sample, the seed) gathered from ``state``: the inputs of kernels 7 and
    8 and the epoch's noise block."""
    from repro_torch.core import dmf
    rng = np.random.default_rng(dp_cfg.seed)
    rng.normal(0, dp_cfg.init_scale, (dp_cfg.n_users, dp_cfg.dim))    # init_state's draw
    ui, vj, r, conf = dmf.sample_epoch(ds.train, dp_cfg, rng)
    B = dp_cfg.batch_size
    n = (len(ui) // B) * B
    _, seed = dmf.epoch_dp_inputs(dp_cfg, rng, n)
    rid = torch.arange(n, dtype=torch.int32, device=dev)
    block = dmf._dp_noise_rows(rid, seed, dp_cfg, dp_cfg.dim)
    ui, vj = (torch.as_tensor(x[:B], device=dev) for x in (ui, vj))
    sx = (state.U[ui], state.P[ui, vj], state.Q[ui, vj],
          torch.as_tensor(r[:B], device=dev), torch.as_tensor(conf[:B], device=dev))
    return dict(sx=sx, z=block[:B], rid=rid, seed=seed, cfg=dp_cfg)


def hold_mechanism(mb) -> float:
    """Kernel 8 on the batch's raw message (kernel 3) with the epoch's seed
    and rids against kernel 7's message for the same batch."""
    from repro_torch.kernels import ops
    c = mb["cfg"]
    hp = dict(theta=c.lr, alpha=c.alpha, beta=c.beta, gamma=c.gamma)
    B = mb["z"].shape[0]
    raw = ops.dmf_fused_step(*mb["sx"], **hp)[1]
    msg8 = ops.dp_clip_noise(raw, mb["rid"][:B], mb["seed"], clip=c.dp_clip,
                             noise_std=c.dp_sigma * c.dp_clip)
    msg7 = ops.dmf_fused_step_dp(*mb["sx"], mb["z"], **hp, clip=c.dp_clip)[1]
    err = float((msg8 - msg7).abs().max())
    assert err <= DRAW_TOL, f"kernel 8 vs kernel 7 message: {err} > {DRAW_TOL}"
    return err


def training_summary(tr) -> dict:
    """The end-to-end numbers of phase 3b, unrounded."""
    nb = tr["batches_per_epoch"]
    out = {}
    for tag in ("dp_off", "dp_on"):
        f, ep = tr[tag]["fit"], tr[tag]["epoch_s"]
        med = float(np.median(ep))
        out[tag] = {"epoch_s_first": ep[0], "epoch_s_median": med,
                    "batches_per_s": nb / med, "evaluate_s": tr[tag]["eval_s"],
                    "train_loss_first_last": (f.train_losses[0], f.train_losses[-1]),
                    "test_loss": tr[tag]["test_loss"], "trained": tr[tag]["metrics"]}
    priv = tr["dp_on"]["fit"].privacy
    out["privacy"] = {"eps_max": priv["eps_max"], "eps_median": priv["eps_median_active"],
                      "sigma": priv["sigma"], "delta": priv["delta"]}
    out["untrained"] = tr["untrained"]
    out["batches_per_epoch"] = nb
    out["dp_on"]["accountant_s_per_epoch"] = tr["accountant_s"]
    out["dp_ingest"] = tr["dp_ingest"]
    out["cli"] = tr["cli"]
    out.update({key: tr.get(key) for key in ("resident_gb", "peak_gb")})
    return out


def drive_baselines(ds, M, nbr, tr, cfg, dev) -> dict:
    """Phase 3d, the paper's comparison, through the entry points a user
    calls: `fit_mf` and `fit_bpr` and `evaluate_mf` at K=10 for the DMF
    path's epochs, GDMF and LDMF through `dmf.fit` and `evaluate`; kernel 4
    on both baselines at full width and one DMF request at a time, kernel 9
    on a training minibatch and at the micro-bench shape, kernel 10 on the
    walk matrix times every learner's P. Returns what the checks, the
    timing and the report need; nothing here is held yet."""
    from repro_torch.core import baselines, dmf, metrics
    from repro_torch.kernels import ops
    out = {"fit_s": {}, "metrics": {}, "losses": {}}
    common = dict(n_users=ds.n_users, n_items=ds.n_items, dim=cfg.dim)
    train_mask = torch.as_tensor(metrics.masks_from_interactions(ds.n_users, ds.n_items,
                                                                 ds.train), device=dev)
    out["train_mask"] = train_mask
    untrained = baselines.init_mf(baselines.MFConfig(**common), device=dev)
    out["untrained"] = baselines.evaluate_mf(untrained, ds.train, ds.test, ds.n_users,
                                             ds.n_items, device=dev)
    for name, c, fit in (("MF", baselines.MFConfig(**common), baselines.fit_mf),
                         ("BPR", baselines.BPRConfig(**common), baselines.fit_bpr)):
        t0 = time.perf_counter()
        state, losses = fit(c, ds.train, epochs=EPOCHS, device=dev)
        sync(dev)
        out["fit_s"][name] = time.perf_counter() - t0
        assert np.isfinite(losses).all(), f"{name}: non-finite training loss"
        out["losses"][name] = (losses[0], losses[-1])
        out["metrics"][name] = baselines.evaluate_mf(state, ds.train, ds.test, ds.n_users,
                                                     ds.n_items, device=dev)
        out[name] = state
        out[f"{name}_topk"] = ops.recommend_topk(state.U, state.V, train_mask, K_TOP)
    for name, hp in DMF_MODES.items():
        c = dataclasses.replace(cfg, **hp)
        t0 = time.perf_counter()
        res = dmf.fit(c, ds.train, nbr, epochs=EPOCHS, device=dev)
        sync(dev)
        out["fit_s"][name] = time.perf_counter() - t0
        out["metrics"][name] = dmf.evaluate(res.state, ds.train, ds.test, ds.n_users,
                                            ds.n_items, device=dev)
        del res
    out["metrics"]["DMF"] = tr["dp_off"]["metrics"]

    # kernel 4, one request at a time on the trained DMF state: the
    # reference's per-request seed loop (serving_bench._loop_per_request)
    st = tr["dp_off"]["fit"].state
    users = np.random.default_rng(SEED + 3).choice(ds.n_users, N_PER_REQUEST, replace=False)
    u0 = int(users[0])
    ops.recommend_topk(st.U[u0][None], st.P[u0] + st.Q[u0], train_mask[u0][None], K_TOP)
    sync(dev)
    slates = []
    t0 = time.perf_counter()
    for u in users.tolist():
        v, i = ops.recommend_topk(st.U[u][None], st.P[u] + st.Q[u], train_mask[u][None], K_TOP)
        slates.append((v.cpu(), i.cpu()))
    out["per_request_rps"] = N_PER_REQUEST / (time.perf_counter() - t0)
    out["per_request"] = (users, torch.cat([v for v, _ in slates]),
                          torch.cat([i for _, i in slates]))
    out["dmf_state"] = st

    # kernel 9 on the first minibatch of a DP-off epoch (fit's own draws:
    # U, then the sample) gathered from the trained state, and at the
    # micro-bench shape (kernels_bench.py: B=2048, K=16)
    rng = np.random.default_rng(cfg.seed)
    rng.normal(0, cfg.init_scale, (cfg.n_users, cfg.dim))          # init_state's draw
    ui, vj, r, conf = dmf.sample_epoch(ds.train, cfg, rng)
    B = cfg.batch_size
    ui, vj = (torch.as_tensor(x[:B], device=dev) for x in (ui, vj))
    sx = (st.U[ui], st.P[ui, vj], st.Q[ui, vj],
          torch.as_tensor(r[:B], device=dev), torch.as_tensor(conf[:B], device=dev))
    hp = dict(alpha=cfg.alpha, beta=cfg.beta, gamma=cfg.gamma)
    bench = grads_inputs(np.random.default_rng(0), 2048, 16, dev)
    bench_hp = dict(alpha=0.1, beta=0.01, gamma=0.01)
    out["grads"] = [(sx, hp, ops.dmf_grads(*sx, **hp)),
                    (bench, bench_hp, ops.dmf_grads(*bench, **bench_hp))]
    out["lr"] = cfg.lr

    # kernel 10: the dense walk matrix times every learner's P, flattened
    # (gossip_mix.py:3-6, Alg. 1 lines 13-15 over all learners at once)
    Md = torch.as_tensor(M, device=dev)
    X = st.P.reshape(ds.n_users, -1)
    out["mix_in"] = (Md, X)
    out["mix_out"] = ops.gossip_mix_op(Md, X)
    sync(dev)
    return out


def boundary_ties(scores: torch.Tensor, train_mask: torch.Tensor, ks=(5, 10)) -> dict:
    """Per user, whether the k-th and (k+1)-th best unmasked scores tie
    exactly, or lie within 1e-6 relative, at each k of ``ks``."""
    top = torch.topk(scores.masked_fill(train_mask, float("-inf")), max(ks) + 1, dim=1)[0]
    out = {}
    for k in ks:
        a, b = top[:, k - 1], top[:, k]
        out[k] = ((a == b).cpu().numpy(),
                  ((a - b).abs() <= 1e-6 * a.abs().clamp_min(1.0)).cpu().numpy())
    return out


def check_baselines(ds, bl, nbr, run_rps: float, dev) -> tuple[dict, dict]:
    """The holds of phase 3d: trained beats untrained; kernel 4's ids give
    `evaluate_mf`'s metrics (users whose k-th and (k+1)-th scores tie are
    counted); kernel 4 per request against kernel 2 on the same rows;
    kernel 9 against its plain version and kernel 3; kernel 10 against the
    plain product and the neighbor-table gather. Frees kernel 10's output."""
    from repro_torch.core import baselines, metrics
    from repro_torch.kernels import ops, ref
    test_mask = metrics.masks_from_interactions(ds.n_users, ds.n_items, ds.test)
    train_mask = bl["train_mask"]
    out = {"metrics": bl["metrics"], "untrained": bl["untrained"], "fit_s": bl["fit_s"],
           "loss_first_last": bl["losses"]}
    errs = {}
    for name in ("MF", "BPR"):
        got, base = bl["metrics"][name]["P@10"], bl["untrained"]["P@10"]
        assert got > base, f"{name}: trained P@10 {got} does not beat untrained {base}"
        vals, idx = bl[f"{name}_topk"]
        st = bl[name]
        errs[name] = hold_shared(f"recommend_topk {name}", (vals, idx), st.U, st.V, train_mask,
                                 K_TOP)
        from_kernel = metrics.evaluate_ranking_from_topk(idx.cpu().numpy(), test_mask)
        ties = boundary_ties(baselines.mf_scores(st), train_mask)
        rec = metrics.topk_recommend(baselines.mf_scores(st), train_mask, K_TOP).cpu().numpy()
        differ = np.zeros(ds.n_users, bool)
        for k in (5, 10):
            at_k = (metrics.topk_hits(idx.cpu().numpy(), test_mask, k)
                    != metrics.topk_hits(rec, test_mask, k))
            assert not (at_k & ~ties[k][1]).any(), (
                f"{name}: kernel 4 hits differ from evaluate_mf's for users "
                f"{np.flatnonzero(at_k & ~ties[k][1])[:10]} without a tie at k={k}")
            differ |= at_k
        if not differ.any():
            assert from_kernel == bl["metrics"][name], (from_kernel, bl["metrics"][name])
        out[f"{name}_kernel4"] = {
            "metrics_equal_evaluate_mf": from_kernel == bl["metrics"][name],
            "users_hits_differ": int(differ.sum()),
            **{f"users_exact_tie_at_{k}": int(ties[k][0].sum()) for k in (5, 10)},
            **{f"users_within_1e-6_at_{k}": int(ties[k][1].sum()) for k in (5, 10)}}

    users, pv, pi = bl["per_request"]
    st = bl["dmf_state"]
    uid = torch.as_tensor(users, device=dev)
    kv, ki = ops.recommend_topk_peruser(st.U[uid], st.P, train_mask, K_TOP, Q=st.Q, rows=uid)
    scores = (st.U[uid][:, None, :] * (st.P[uid] + st.Q[uid])).sum(-1)
    scores = scores.masked_fill(train_mask[uid], ref.NEG_INF).cpu().numpy()
    hold_topk("recommend_topk per request vs kernel 2", (pv, pi), (kv, ki),
              lambda r, item: float(scores[r, item]))
    kv, ki = kv.cpu(), ki.cpu()
    per_err = float((pv - kv).abs().max())
    assert per_err <= DRAW_TOL, f"per request vs kernel 2: {per_err} > {DRAW_TOL}"
    out["per_request"] = {"requests": len(users), "requests_per_s": bl["per_request_rps"],
                          "engine_pruned_requests_per_s": run_rps,
                          "vs_kernel2_bitwise": bool(torch.equal(pv, kv) and torch.equal(pi, ki)),
                          "vs_kernel2_max_abs": per_err}

    grads = []
    for sx, hp, got in bl["grads"]:
        err = hold_grads(got, sx, hp)
        theta = bl["lr"]
        du, gp3, dq, _ = ops.dmf_fused_step(*sx, theta=theta, **hp)
        within_ulp = []
        for a, b in ((-theta * got[0], du), (-theta * got[2], dq)):
            ulp = (torch.nextafter(b, torch.full_like(b, float("inf"))) - b).abs()
            within_ulp.append(bool(((a - b).abs() <= ulp).all()))
        assert all(within_ulp), "dmf_grads: -θ·gu / -θ·gq not within 1 ulp of kernel 3's du / dq"
        assert torch.equal(got[1], gp3), "dmf_grads: gp is not kernel 3's gp bit for bit"
        grads.append({"shape": f"B={sx[0].shape[0]} K={sx[0].shape[1]}", "max_abs_err": err,
                      "gp_vs_kernel3_bitwise": bool(torch.equal(got[1], gp3)),
                      "gp_vs_kernel3_max_abs": float((got[1] - gp3).abs().max())})
    errs["grads"] = max(g["max_abs_err"] for g in grads)
    out["dmf_grads"] = grads

    (Md, X), Y = bl["mix_in"], bl.pop("mix_out")
    errs["mix"] = hold_mix("gossip_mix_op Foursquare", Y, Md, X)
    I = Md.shape[0]
    rebuilt = torch.zeros_like(Md)
    rebuilt.index_put_((torch.arange(I, device=dev)[:, None].expand_as(nbr.idx), nbr.idx),
                       nbr.wgt, accumulate=True)
    assert torch.equal(rebuilt, Md), "a nonzero of M is missing from the neighbor table"
    gathered = torch.zeros_like(Y)
    for s in range(nbr.idx.shape[1]):
        gathered.addcmul_(nbr.wgt[:, s, None], X[nbr.idx[:, s]])
    bound = ref.gossip_mix_ref(Md.abs(), X.abs()).mul_(TOL).add_(TOL)
    gather_err = (Y - gathered).abs_()
    assert bool((gather_err <= bound).all()), f"kernel 10 vs gather: {float(gather_err.max())}"
    out["gossip_mix"] = {"shape": f"I={I} F={X.shape[1]}", "max_abs_vs_plain": errs["mix"],
                         "max_abs_vs_gather": float(gather_err.max()),
                         "nnz_per_row_max": int((Md != 0).sum(1).max()),
                         "nnz": int((Md != 0).sum())}
    del Y, gathered, bound, gather_err, rebuilt
    torch.cuda.empty_cache()
    dmf_r10, mf_r10 = bl["metrics"]["DMF"]["R@10"], bl["metrics"]["MF"]["R@10"]
    out["C1_dmf_R@10_beats_mf"] = bool(dmf_r10 > mf_r10)
    return out, errs


# ------------------------------------------------------------ robustness
def stamped_fit(fit, *args, **kw):
    """``fit`` with the host time of each epoch (an epoch's interval runs
    from the previous epoch's callback, or the call, to its own; a
    snapshot written after an epoch falls in the next one's interval)."""
    stamps = [time.perf_counter()]
    user_cb = kw.pop("callback", None)

    def cb(t, state, loss):
        if user_cb is not None:
            user_cb(t, state, loss)
        stamps.append(time.perf_counter())

    res = fit(*args, callback=cb, **kw)
    return res, np.diff(stamps).tolist()


def same_run(a, b) -> bool:
    """Two `FitResult`s with equal losses, privacy summaries and factor
    bits."""
    return (a.train_losses == b.train_losses and a.privacy == b.privacy
            and all(torch.equal(getattr(a.state, n), getattr(b.state, n)) for n in "UPQ"))


def tree_bytes(path: pathlib.Path) -> int:
    return sum(p.stat().st_size for p in path.rglob("*") if p.is_file())


def robust_trivial(ds, nbr, cfg, dev) -> dict:
    """Phase 3e, first part: the trivial churn plan with an inactive
    `DefenseConfig()` against plain `fit`, DP off and on, bit for bit."""
    from repro_torch.core import dmf
    from repro_torch.robustness import ChurnConfig, DefenseConfig
    out = {}
    for tag, c in (("dp_off", cfg), ("dp_on", dataclasses.replace(cfg, **ROBUST_DP))):
        plain, plain_s = stamped_fit(dmf.fit, c, ds.train, nbr, epochs=TRIVIAL_EPOCHS, device=dev)
        got, got_s = stamped_fit(dmf.fit, c, ds.train, nbr, epochs=TRIVIAL_EPOCHS,
                                 churn=ChurnConfig(), defense=DefenseConfig(), device=dev)
        out[tag] = {"bitexact": same_run(got, plain), "plain_epoch_s": plain_s,
                    "trivial_plan_epoch_s": got_s, "losses": got.train_losses}
        assert out[tag]["bitexact"], f"{tag}: the trivial plan is not bit-exact with plain fit"
        del plain, got
    return out


def robust_churn(ds, nbr, cfg, dev) -> dict:
    """Phase 3e, second part: churn with DP (the reference churn bench's
    resume configuration) for CHURN_EPOCHS epochs with snapshots every 2,
    then resumed from step_2: losses, factors and privacy bit for bit; one
    offline learner's U, P and Q rows bit-frozen across an epoch it is
    offline; the snapshot's bytes and seconds."""
    import tempfile

    from repro_torch.core import dmf
    from repro_torch.robustness import ChurnConfig, recovery
    c = dataclasses.replace(cfg, **ROBUST_DP)
    churn = ChurnConfig(**ROBUST_CHURN)
    plan = churn.compile(ds.n_users, CHURN_EPOCHS)
    t_off = 1
    user = int(np.flatnonzero(plan.online[t_off - 1] & ~plan.online[t_off])[0])
    rows = {}

    def keep_rows(t, state, loss):
        if t in (t_off - 1, t_off):
            rows[t] = [x[user].clone() for x in (state.U, state.P, state.Q)]

    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as td:
        td = pathlib.Path(td)
        full, full_s = stamped_fit(dmf.fit, c, ds.train, nbr, epochs=CHURN_EPOCHS, churn=churn,
                                   checkpoint_dir=td / "run", checkpoint_every=2,
                                   callback=keep_rows, device=dev)
        snap_bytes = tree_bytes(td / "run" / "step_2")
        sync(dev)
        t0 = time.perf_counter()
        resumed, resumed_s = stamped_fit(dmf.fit, c, ds.train, nbr, epochs=CHURN_EPOCHS,
                                         churn=churn, resume_from=td / "run" / "step_2",
                                         device=dev)
        resume_call_s = time.perf_counter() - t0
        sync(dev)
        t0 = time.perf_counter()
        recovery.save_training(td / "timed", CHURN_EPOCHS, resumed.state,
                               np.random.default_rng(0), train_losses=resumed.train_losses)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = recovery.load_training(td / "timed", resumed.state, device=dev)[0]
        sync(dev)
        load_s = time.perf_counter() - t0
        restored_bitwise = all(torch.equal(getattr(back, n), getattr(resumed.state, n))
                               for n in "UPQ")
        del back
    frozen = all(torch.equal(a, b) for a, b in zip(rows[t_off - 1], rows[t_off]))
    out = {"participation": plan.participation_rate, "k_max": plan.k_max,
           "epoch_s": full_s, "resumed_epoch_s": resumed_s, "resume_call_s": resume_call_s,
           "losses": full.train_losses, "privacy_eps_max": full.privacy["eps_max"],
           "resume_bit_identical": same_run(full, resumed),
           "offline_rows_frozen": {"user": user, "epoch": t_off, "bitwise": frozen},
           "snapshot": {"bytes": snap_bytes, "save_s": save_s, "load_s": load_s,
                        "restored_bitwise": restored_bitwise}}
    assert out["resume_bit_identical"], "resume from step_2 is not bit-identical"
    assert frozen, f"learner {user}, offline in epoch {t_off}, moved"
    assert restored_bitwise, "a snapshot does not restore its own bits"
    return out


def robust_byzantine(ds, nbr, cfg, dev) -> dict:
    """Phase 3e, third part (`benchmarks/byzantine_bench.py`'s headline):
    τ = 1.5 × the 99.9th percentile of one audited epoch's honest message
    norms; BYZ_FRAC of the learners malicious, BYZ_EPOCHS epochs each, the
    divergence sentinel halting: the fault-free run, `norm_inflate` at
    λ=100 undefended and under screen + trim 0.25, `nan` under screen."""
    from repro_torch.core import dmf
    from repro_torch.privacy import audit
    from repro_torch.robustness import AttackConfig, DefenseConfig
    log = audit.observe_messages(cfg, ds.train, nbr, epochs=1, seed=0, device=dev)
    tau = float(np.quantile(np.linalg.norm(log.gp, axis=1), 0.999) * 1.5)
    inflate = AttackConfig(family="norm_inflate", frac=BYZ_FRAC, scale=BYZ_SCALE, seed=0)
    runs = {"fault_free": {},
            "undefended": dict(attack=inflate),
            "screen_trim": dict(attack=inflate, defense=DefenseConfig(
                screen=True, norm_cap=tau, aggregation="trim", trim_frac=0.25)),
            "nan_screen": dict(attack=AttackConfig(family="nan", frac=BYZ_FRAC, seed=0),
                               defense=DefenseConfig(screen=True, norm_cap=tau))}
    out = {"tau": tau, "audited_messages": int(len(log.gp)), "runs": {}}
    for tag, kw in runs.items():
        res, ep = stamped_fit(dmf.fit, cfg, ds.train, nbr, epochs=BYZ_EPOCHS,
                              on_nonfinite="halt", device=dev, **kw)
        last = float(res.train_losses[-1])
        nonfinite = not np.isfinite(last) or res.diverged_at is not None
        out["runs"][tag] = {"final_train_loss": None if nonfinite else last,
                            "nonfinite": nonfinite, "halted_at": res.diverged_at,
                            "epoch_s": ep, "finite_factors": all(
                                bool(torch.isfinite(getattr(res.state, n)).all())
                                for n in "UPQ")}
        del res
    base = out["runs"]["fault_free"]["final_train_loss"]
    for r in out["runs"].values():
        r["loss_ratio_vs_faultfree"] = (None if r["nonfinite"]
                                        else r["final_train_loss"] / base)
    und, dfd = out["runs"]["undefended"], out["runs"]["screen_trim"]
    out["headline"] = {
        "undefended_collapse_ratio": und["loss_ratio_vs_faultfree"],
        "undefended_collapsed": bool(und["nonfinite"] or und["loss_ratio_vs_faultfree"] >= 5.0),
        "defended_ratio": dfd["loss_ratio_vs_faultfree"],
        "defended_within_1p5x": bool(not dfd["nonfinite"]
                                     and dfd["loss_ratio_vs_faultfree"] <= 1.5)}
    out["epoch_s_median"] = {tag: float(np.median(out["runs"][tag]["epoch_s"][1:]))
                             for tag in ("fault_free", "nan_screen", "screen_trim")}
    for tag in ("screen_trim", "nan_screen"):
        r = out["runs"][tag]
        assert not r["nonfinite"] and r["finite_factors"], f"defended run {tag} went non-finite"
    return out


def robust_audit(ds, nbr, cfg, dev) -> dict:
    """Phase 3e, fourth part: `run_audit` for one epoch at σ 0 and 1.0,
    C=0.25 (kernel 3 for the step, kernel 8 for the clip and the noise
    drawn by row id); the DP advantage must be the lower."""
    from repro_torch.privacy import audit
    out = {}
    for sigma in AUDIT_SIGMAS:
        c = dataclasses.replace(cfg, dp_sigma=sigma, dp_clip=AUDIT_CLIP, dp_seed=0)
        t0 = time.perf_counter()
        rep = audit.run_audit(c, ds.train, nbr, ds.n_users, ds.n_items, epochs=1, device=dev)
        rep["seconds"] = time.perf_counter() - t0
        out[f"sigma_{sigma}"] = rep
    lo, hi = (out[f"sigma_{s}"]["rating_inversion_advantage"] for s in AUDIT_SIGMAS[::-1])
    assert lo < hi, f"DP advantage {lo} is not below the sigma=0 one {hi}"
    return out


def robust_cli(dev) -> dict:
    """Phase 3e, last part: the CLI in process with churn, DP, screening,
    trimmed aggregation and a snapshot every epoch, then again resumed from
    step_2 (snapshotting its last epoch too, whose sidecar holds its
    losses): the same last epoch's loss, privacy line and metrics."""
    import shutil
    import tempfile

    from repro_torch.launch import dmf_train
    from repro_torch.robustness import recovery
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)

    def last_losses(step_dir):
        return json.loads((step_dir / recovery.SIDECAR).read_text())["train_losses"]

    with tempfile.TemporaryDirectory(dir=out_dir) as td:
        td = pathlib.Path(td)
        lines = {}
        for tag, extra in (("whole", ["--checkpoint-dir", str(td / "a")]),
                           ("resumed", ["--checkpoint-dir", str(td / "b"),
                                        "--resume-from", str(td / "a" / "step_2")])):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                dmf_train.main(ROBUST_CLI + extra)
            lines[tag] = buf.getvalue().splitlines()
            if tag == "whole":
                whole = last_losses(td / "a" / "step_3")
                shutil.rmtree(td / "a" / "step_1")
                shutil.rmtree(td / "a" / "step_3")
        resumed = last_losses(td / "b" / "step_3")
    keep = [ln for ln in lines["whole"] if not ln.startswith("epoch ")]
    out = {"lines": lines["whole"], "last_loss": whole[-1],
           "same_last_loss": whole[-1] == resumed[-1],
           "same_report": keep == [ln for ln in lines["resumed"] if not ln.startswith("epoch ")]}
    assert out["same_last_loss"], (whole, resumed)
    assert out["same_report"], (lines["whole"], lines["resumed"])
    assert any(ln.startswith("churn ") for ln in keep), keep
    return out


# ------------------------------------------------------- scheduling and obs
def serving_engine(ds, nbr, index, cfg, state, dev, warm: bool = True):
    """A pruned `ServingEngine` on ``state`` (microbatch 64, k=10); with
    ``warm``, one full microbatch dispatched and the stats reset, as the
    reference bench's `_build_engine` does, so the first measured dispatch
    is no launch's first."""
    from repro_torch.serving import ServingConfig, ServingEngine
    eng = ServingEngine(state, index, ServingConfig(microbatch=MICROBATCH, k=K_TOP),
                        train=ds.train, nbr=nbr, dmf_cfg=cfg, device=dev)
    if warm:
        eng.serve_microbatch(np.arange(MICROBATCH, dtype=np.int64))
        eng.stats.reset()
    return eng


def scheduled(eng, reqs, lockstep: bool = False, **run_kw):
    """`Scheduler(eng).run(reqs)` (or `simulate_lockstep`), holding that
    every dispatch was one launch of kernel 5 in place (`serve_topk_rows`)
    and every ingest batch, and the refresh warm-up's step, one of kernel 3
    (`dmf_fused_step`)."""
    from repro_torch.kernels import ops
    from repro_torch.scheduling import Scheduler, simulate_lockstep
    k5, k3 = ops.serve_topk_rows.launches, ops.dmf_fused_step.launches
    rep = simulate_lockstep(eng, reqs) if lockstep else Scheduler(eng).run(reqs, **run_kw)
    n_disp = sum(rep.n_dispatches_per_shard)
    n_batches = sum(r.n_batches for r in rep.ingest_reports) + bool(rep.ingest_reports)
    assert ops.serve_topk_rows.launches - k5 == n_disp, (ops.serve_topk_rows.launches - k5, n_disp)
    assert ops.dmf_fused_step.launches - k3 == n_batches, (
        ops.dmf_fused_step.launches - k3, n_batches)
    return rep


def same_as_direct(eng_factory, served) -> bool:
    """Every served slate (and fallback flag) equals a fresh engine's
    direct `recommend` of the same users, bit for bit."""
    vals, idx, flags = eng_factory().recommend([r.user for r in served], return_flags=True)
    return bool(len(served) > 0 and all(
        np.array_equal(r.vals, vals[j]) and np.array_equal(r.idx, idx[j])
        and r.fallback == bool(flags[j]) for j, r in enumerate(served)))


def sched_row(rep) -> dict:
    s = rep.summary(slo_ms=SCHED_SLO_MS)
    return {"goodput_rps": s["goodput_rps"], "slo_attainment": s["slo_attainment"],
            "p50_ms": s["latency_ms"]["p50_ms"], "p99_ms": s["latency_ms"]["p99_ms"],
            "p99_slo_met": s["p99_slo_met"], "dispatches": sum(rep.n_dispatches_per_shard),
            "summary": s}


def ingest_interleave(make, ds) -> dict:
    """`scheduler_bench.py:84-130` on the card: two bursts of SCHED_HALF
    requests with an idle gap of SCHED_GAP_S s and one ingest window of
    held-out check-ins; the refresh must run inside the gap, and the
    slates before and after it must equal a no-ingest engine's and an
    ingested engine's, bit for bit."""
    from repro_torch.scheduling.workload import make_requests
    rng = np.random.default_rng(3)
    users = rng.integers(0, ds.n_users, 2 * SCHED_HALF)
    t1 = np.sort(rng.uniform(0.0, 0.02, SCHED_HALF))
    t2 = SCHED_GAP_S + np.sort(rng.uniform(0.0, 0.02, SCHED_HALF))
    reqs = make_requests(np.concatenate([t1, t2]), users, SCHED_SLO_MS)
    events = ds.test[:SCHED_INGEST_EVENTS].astype(np.int64)
    eng = make()
    rep = scheduled(eng, reqs, ingest_events=[events])
    del eng
    served = rep.served()
    pre = [r for r in served if r.ingest_epoch == 0]
    post = [r for r in served if r.ingest_epoch == 1]

    def ingested():
        e = make(warm=False)
        e.ingest(events)
        return e
    out = {"n_windows_run": rep.n_ingest_windows, "n_pre_ingest_served": len(pre),
           "n_post_ingest_served": len(post),
           "ingest_interval_s": list(rep.ingest_intervals[0]) if rep.ingest_intervals else None,
           "ingest_ran_in_idle_gap": bool(rep.ingest_intervals) and all(
               float(t1[-1]) <= s and e <= SCHED_GAP_S for s, e in rep.ingest_intervals),
           "pre_ingest_bit_identical_to_no_ingest": same_as_direct(
               lambda: make(warm=False), pre),
           "post_ingest_bit_identical_to_ingested_snapshot": same_as_direct(ingested, post)}
    for key in ("ingest_ran_in_idle_gap", "pre_ingest_bit_identical_to_no_ingest",
                "post_ingest_bit_identical_to_ingested_snapshot"):
        assert out[key], f"ingest interleave: {key} is false ({out})"
    assert out["n_windows_run"] == 1 and len(pre) + len(post) == 2 * SCHED_HALF, out
    return out


def kernel_time_by_name(doc: dict, top: int = 6) -> list:
    """A profiler trace's kernels summed by name (µs), the largest
    first."""
    tot: dict[str, list] = {}
    for e in doc["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            t = tot.setdefault(e["name"], [0, 0.0])
            t[0] += 1
            t[1] += float(e["dur"])
    rows = sorted(tot.items(), key=lambda kv: -kv[1][1])[:top]
    return [{"name": n[:96], "count": c, "total_us": us} for n, (c, us) in rows]


def drive_scheduling(ds, nbr, index, cfg, state, dev, detail: bool = False) -> dict:
    """Phase 3f, the scheduler: capacity from back-to-back full
    microbatches, the grid (scheduler and lockstep at each load, one on/off
    stream; the scheduler's host seconds each), the 1× run's slates against
    `recommend`, the ingest interleave, and the 1× run again with tracing
    on under the profiler. The profiler slows the host, so the profiled
    window's busy share is a lower bound; beside it stands the profiled
    device time a dispatch times the unprofiled 1× run's dispatches over
    that run's host seconds. With ``detail``, first the 1× stream in turns
    with tracing off and on, and `span_cost`."""
    from repro_torch.obs import trace as trace_lib
    from repro_torch.scheduling import WorkloadConfig, generate

    def make(warm=True):
        return serving_engine(ds, nbr, index, cfg, state, dev, warm)

    eng = make()
    rng = np.random.default_rng(7)
    dts = [eng.serve_microbatch(rng.integers(0, ds.n_users, MICROBATCH))[-1]
           for _ in range(SCHED_CAPACITY_REPS)]
    capacity = MICROBATCH / float(np.median(dts))
    out = {"capacity_rps": capacity, "capacity_dispatch_s": dts, "microbatch": MICROBATCH,
           "n_requests": SCHED_REQUESTS, "slo_ms": SCHED_SLO_MS, "loads": []}
    streams = [(f, dict(users="powerlaw", zipf_s=SCHED_ZIPF, seed=100 + i))
               for i, f in enumerate(SCHED_LOADS)]
    streams.append((1.0, dict(users="powerlaw", zipf_s=SCHED_ZIPF, seed=100 + len(SCHED_LOADS),
                              **SCHED_ONOFF)))
    for frac, kw in streams:
        reqs = generate(WorkloadConfig(n_requests=SCHED_REQUESTS, rate_rps=frac * capacity,
                                       slo_ms=SCHED_SLO_MS, **kw), ds.n_users)
        t0 = time.perf_counter()
        rep_s = scheduled(eng, reqs)
        wall_s = time.perf_counter() - t0
        rep_l = scheduled(eng, reqs, lockstep=True)
        row = {"process": kw.get("process", "poisson"), "offered_frac_of_capacity": frac,
               "offered_load_rps": frac * capacity, "seed": kw["seed"],
               "scheduler": dict(sched_row(rep_s), host_s=wall_s), "lockstep": sched_row(rep_l)}
        if frac == 1.0 and "process" not in kw:
            mid_reqs, mid_row = reqs, row["scheduler"]
            row["bit_identical_vs_direct"] = same_as_direct(make, rep_s.served())
            assert row["bit_identical_vs_direct"], "scheduled slates differ from recommend"
            assert same_as_direct(make, rep_l.served()), "lockstep slates differ from recommend"
        out["loads"].append(row)
    out["ingest_interleave"] = ingest_interleave(make, ds)
    if detail:
        out.update(tracing_detail(eng, mid_reqs, ds.n_users))
    saved = trace_lib.get_tracer()
    try:
        tracer = trace_lib.set_tracer(trace_lib.Tracer(enabled=True))
        sync(dev)
        with tracer.torch_profiler(ROOT / "build" / "profile", device=dev) as prof:
            rep_p = scheduled(eng, mid_reqs)
        assert prof is not None
        spans = tracer.span_stats()
    finally:
        trace_lib.set_tracer(saved)
    doc = json.loads(tracer.profiler_traces[-1].read_text())
    busy = trace_lib.device_busy(doc)
    n_disp = sum(rep_p.n_dispatches_per_shard)
    assert busy["n_kernel"] >= n_disp, (busy, n_disp)
    assert spans["scheduler.dispatch"]["count"] == n_disp == spans["engine.serve_microbatch"][
        "count"], spans
    per_dispatch_ms = busy["busy_ms"] / n_disp
    out["profiled_1x"] = {
        "device_busy": busy, "dispatches": n_disp, "trace": str(tracer.profiler_traces[-1]),
        "kernels_by_device_time": kernel_time_by_name(doc),
        "run": sched_row(rep_p), "span_stats": spans,
        # the same device work a dispatch over the host seconds of the 1x
        # run without the profiler (and without tracing)
        "device_ms_per_dispatch": per_dispatch_ms,
        "busy_share_unprofiled_estimate": (per_dispatch_ms * mid_row["dispatches"]
                                           / (1e3 * mid_row["host_s"]))}
    del out["profiled_1x"]["run"]["summary"]
    out["engine"], out["report_1x"] = eng, rep_p
    return out


def tracing_detail(eng, reqs, n_users: int) -> dict:
    """With ``--obs-detail``: the 1× stream ``reqs`` in turns with span
    tracing off and on (what tracing costs; the host clock spreads, hence
    several turns), and `span_cost`."""
    from repro_torch.obs import trace as trace_lib
    saved = trace_lib.get_tracer()
    turns = {"plain": [], "tracing": []}
    try:
        tracer = trace_lib.set_tracer(trace_lib.Tracer(enabled=False))
        for turn in ("plain", "tracing", "tracing", "plain") * SCHED_TRACE_TURNS:
            tracer.enabled = turn == "tracing"
            n0 = len(eng.stats.dispatch_seconds)
            row = sched_row(scheduled(eng, reqs))
            row["dispatch_ms_median"] = 1e3 * float(np.median(eng.stats.dispatch_seconds[n0:]))
            turns[turn].append({k: row[k] for k in ("goodput_rps", "slo_attainment", "p50_ms",
                                                    "p99_ms", "dispatch_ms_median")})
        spans = tracer.span_stats()
    finally:
        trace_lib.set_tracer(saved)
    return {"tracing_cost_1x_in_turns": {
                "runs": turns,
                "median": {t: {k: float(np.median([r[k] for r in rows])) for k in rows[0]}
                           for t, rows in turns.items()}},
            "span_stats_tracing_only": spans, "span_cost": span_cost(eng, n_users)}


def span_cost(eng, n_users: int) -> dict:
    """What a span costs on this host: SPAN_COST_N empty spans of the
    global tracer enabled and disabled (µs each), and the median seconds
    of SPAN_COST_DISPATCHES back-to-back `serve_microbatch` calls (two
    spans each with the scheduler's) with tracing off, on, on, off."""
    from repro_torch.obs import trace as trace_lib
    saved = trace_lib.get_tracer()
    out = {"empty_span_us": {}, "dispatch_ms_median": {"off": [], "on": []}}
    ids = np.random.default_rng(11).integers(0, n_users, (SPAN_COST_DISPATCHES, MICROBATCH))
    try:
        tracer = trace_lib.set_tracer(trace_lib.Tracer())
        for on in (False, True):
            tracer.enabled = on
            t0 = time.perf_counter()
            for _ in range(SPAN_COST_N):
                with trace_lib.span("empty", n=1):
                    pass
            out["empty_span_us"]["on" if on else "off"] = (
                (time.perf_counter() - t0) / SPAN_COST_N * 1e6)
            tracer.clear()
        for on in (False, True, True, False):
            tracer.enabled = on
            dts = []
            for row in ids:
                with trace_lib.span("scheduler.dispatch", shard=0, n=MICROBATCH):
                    dts.append(eng.serve_microbatch(row)[-1])
            out["dispatch_ms_median"]["on" if on else "off"].append(1e3 * float(np.median(dts)))
    finally:
        trace_lib.set_tracer(saved)
    return out


def profiled_fit(c, kw, ds, nbr, dev, tele: bool) -> dict:
    """One epoch of `fit` under the profiler: the device's busy share,
    kernels by device time, and the host's PyTorch ops (calls, self
    milliseconds, the costliest by name); the rest of the window is
    Python and numpy (the accountant, `group_messages`)."""
    from repro_torch.core import dmf
    from repro_torch.obs import trace as trace_lib
    tracer = trace_lib.Tracer(enabled=True)
    sync(dev)
    with tracer.torch_profiler(ROOT / "build" / "profile", device=dev) as prof:
        dmf.fit(c, ds.train, nbr, telemetry=tele, device=dev, **dict(kw, epochs=1))
        sync(dev)
    path = tracer.profiler_traces[-1]
    doc = json.loads(path.read_text())
    ops_ = [e for e in prof.key_averages() if e.key.startswith("aten::")]
    top = sorted(ops_, key=lambda e: -e.self_cpu_time_total)[:6]
    out = {"device_busy": trace_lib.device_busy(doc),
           "kernels_by_device_time": kernel_time_by_name(doc, 4),
           "host_aten_calls": sum(e.count for e in ops_),
           "host_aten_self_ms": sum(e.self_cpu_time_total for e in ops_) / 1e3,
           "top_host_ops": [{"op": e.key, "calls": e.count, "self_ms": e.self_cpu_time_total / 1e3}
                            for e in top]}
    path.unlink()      # tens of MB each; the numbers above are what is kept
    return out


def drive_telemetry(ds, nbr, cfg, tau, dev, detail: bool = False) -> dict:
    """Phase 3f, telemetry: `fit` TELE_DP_EPOCHS DP epochs (σ=1, C=0.5)
    and TELE_BYZ_EPOCHS epochs of the attacked run under screen + trim
    (phase 3e's λ=100 `norm_inflate` at τ), in turns with telemetry off,
    on, on, off: the same losses, privacy and factor bits every time, and
    epoch seconds each way. With ``detail``, then one epoch of each under
    the profiler with telemetry off (where a DP and a screened epoch's time
    goes), and of the screened one with telemetry on (the ops it adds)."""
    from repro_torch.core import dmf
    from repro_torch.robustness import AttackConfig, DefenseConfig
    runs = {"dp": (dataclasses.replace(cfg, **DP), dict(epochs=TELE_DP_EPOCHS)),
            "screen_trim": (cfg, dict(
                epochs=TELE_BYZ_EPOCHS,
                attack=AttackConfig(family="norm_inflate", frac=BYZ_FRAC, scale=BYZ_SCALE, seed=0),
                defense=DefenseConfig(screen=True, norm_cap=tau, aggregation="trim",
                                      trim_frac=0.25)))}
    out = {}
    for tag, (c, kw) in runs.items():
        first, secs, same = None, {False: [], True: []}, []
        for tele in (False, True, True, False):
            res, s = stamped_fit(dmf.fit, c, ds.train, nbr, telemetry=tele, device=dev, **kw)
            secs[tele] += s
            if first is None:
                first = res
            else:
                same.append(same_run(res, first))
            if tele:
                events = res.telemetry
                assert len(events) == kw["epochs"], events
            else:
                assert res.telemetry is None
            del res
        del first
        off, on = (float(np.median(secs[t])) for t in (False, True))
        out[tag] = {"bitexact": all(same), "epoch_s_off": secs[False], "epoch_s_on": secs[True],
                    "median_off": off, "median_on": on, "on_over_off": on / off - 1.0,
                    "events": events}
        if detail:
            out[tag]["profiled_epoch"] = {t: profiled_fit(c, kw, ds, nbr, dev, t == "on")
                                          for t in PROFILED_TELEMETRY[tag]}
        assert out[tag]["bitexact"], f"{tag}: telemetry on is not bit for bit telemetry off"
    assert all(ev["screen_reject"] > 0 for ev in out["screen_trim"]["events"]), out
    assert all(ev["dp_eps"] > 0 for ev in out["dp"]["events"]), out
    return out


def obs_snapshot(sched) -> dict:
    """The serving engine's and the 1× report's `publish` into the phase's
    registry (which the telemetry fits published into too), written with
    `write_jsonl` under build/; the card's memory snapshot."""
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import trace as trace_lib
    reg = obs_metrics.get_registry()
    sched["engine"].stats.publish(reg)
    sched["report_1x"].publish(reg, slo_ms=SCHED_SLO_MS)
    path = ROOT / "build" / "phase3f_metrics.jsonl"
    path.parent.mkdir(exist_ok=True)
    path.unlink(missing_ok=True)
    snap = reg.write_jsonl(path, event="chip_smoke_phase3f")
    back = json.loads(path.read_text().splitlines()[-1])["metrics"]
    assert back == json.loads(json.dumps(snap)), "the JSONL line is not the snapshot"
    mem = trace_lib.device_memory_snapshot()
    alloc = mem[0]["memory_stats"].get("allocated_bytes.all.current", 0)
    assert mem[0]["platform"] == "gpu" and alloc > 0, mem
    return {"metrics_path": str(path), "metrics": sorted(snap), "n_metrics": len(snap),
            "serving_n_requests": snap["serving_n_requests"]["values"][""],
            "scheduler_goodput_rps": snap["scheduler_goodput_rps"]["values"][""],
            "train_epochs_total": snap["train_epochs_total"]["values"][""],
            "device_memory": {"device": mem[0]["device"], "allocated_bytes": alloc,
                              "peak_bytes": mem[0]["memory_stats"].get(
                                  "allocated_bytes.all.peak", 0)}}


# ------------------------------------------------------------ sharded training
def sharded_rank(rank: int, D: int, tables: dict, cfg, tau: float, capacity: float,
                 device: str) -> dict:
    """Phase 3g on one rank of D (spawned by `launch.mesh.spawn_ranks`).

    For DP off and on: the unsharded `fit` on rank 0 alone (the others wait
    at a barrier) and the sharded run on every rank, in turns (unsharded,
    sharded, sharded, unsharded); the first sharded run held within 1e-5 of
    the first unsharded one (losses and factors) and its losses repeated
    bit for bit. The first sharded run is `fit` at D>1; at D=1, where `fit`
    is the unsharded path as in the reference, and for the repeat, the
    sharded epoch is driven by hand through `train_epoch_sharded` (with an
    accountant, as `fit` keeps one).
    `evaluate_sharded` of the DP-off state equal to the unsharded
    `evaluate`. At D>1 also the trivial churn plan with an inactive
    defense (losses bit for bit those of the plain sharded run), a screen
    + trim run under phase 3e's λ=100 attack within 1e-6 (losses) and 1e-5
    (factors) of the unsharded one, and the exchange's wall share of three
    DP-off epochs by hand. Launch counts are taken only around the sharded
    runs and summed over the ranks."""
    import torch.distributed as dist

    from repro_torch import device as device_lib
    from repro_torch.core import dmf, graph
    from repro_torch.kernels import ops
    from repro_torch.privacy import GaussianAccountant
    from repro_torch.robustness import AttackConfig, ChurnConfig, DefenseConfig
    from repro_torch.sharding import dmf as sharded_dmf
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = device_lib.resolve(device)
    train, test = tables["train"], tables["test"]
    I, J = cfg.n_users, cfg.n_items
    nbr = graph.NeighborTable(*(torch.as_tensor(tables[k], device=dev) for k in ("idx", "wgt")))
    group = sharded_dmf.learner_group(D, dev)
    counts = np.zeros(len(ops.KERNELS), np.int64)

    def counted(fn):
        for kern in ops.KERNELS:
            kern.launches = 0
        out = fn()
        counts[:] += [kern.launches for kern in ops.KERNELS]
        return out

    def gap(a, b) -> dict:
        return {"loss": float(np.abs(np.subtract(a.train_losses, b.train_losses)).max()),
                "state": max(float((getattr(a.state, n) - getattr(b.state, n)).abs().max())
                             for n in "UPQ")}

    def hold(name, g, loss_tol, state_tol=STATE_TOL):
        assert g["loss"] <= loss_tol and g["state"] <= state_tol, f"phase 3g {name} at D={D}: {g}"
        return g

    def by_hand(cs, epochs: int, plan=None, clock=None):
        """The sharded epoch driven by hand (`train_epoch_sharded`), each
        epoch timed on the host (it ends in the loss read), and the exchange
        seconds an epoch when ``clock`` times the plan's collectives."""
        plan = plan or sharded_dmf.make_shard_plan(nbr, cs, dev)
        rng = np.random.default_rng(cs.seed)
        st = sharded_dmf.init_local_state(cs, rng, plan)
        acc = (GaussianAccountant(n_users=I, sigma=cs.dp_sigma, delta=1e-5)
               if cs.dp and cs.dp_sigma > 0 else None)      # as `fit` keeps one
        losses, secs, xs = [], [], []
        for _ in range(epochs):
            t0, x0 = time.perf_counter(), clock.seconds if clock else 0.0
            losses.append(sharded_dmf.train_epoch_sharded(st, plan, train, cs, rng,
                                                          accountant=acc, device=dev)[1])
            secs.append(time.perf_counter() - t0)
            xs.append(clock.seconds - x0 if clock else 0.0)
        return dmf.FitResult(st, losses, []), secs, xs, plan

    def sharded_run(cs, first: bool):
        """(the run with its full state, or only its losses when not
        ``first``; its epoch seconds): `fit` at D > 1 first; by hand at D=1,
        where `fit` is the unsharded path as in the reference, and for the
        repeat, which needs no gather of the state."""
        if D > 1 and first:
            return stamped_fit(dmf.fit, cs, train, nbr, epochs=SHARD_EPOCHS, device=dev)
        res, secs, _, plan = by_hand(cs, SHARD_EPOCHS)
        res.state = sharded_dmf.unpad_state(res.state, plan, I) if first else None
        return res, secs

    out = {"ranks": D, "backend": group.backend, "epoch_s": {}, "holds": {}}
    kept = {}
    for name, c in (("dp_off", cfg), ("dp_on", dataclasses.replace(cfg, **DP))):
        cs = dataclasses.replace(c, n_shards=D)
        turns = {"unsharded": [], "sharded": []}
        ref = first = None
        for who in ("unsharded", "sharded", "sharded", "unsharded"):
            if who == "unsharded":
                if rank == 0:
                    res, ep = stamped_fit(dmf.fit, c, train, nbr, epochs=SHARD_EPOCHS, device=dev)
                    turns[who].append(ep)
                    if ref is None:
                        ref = res
                group.barrier()
                continue
            res, ep = counted(lambda: sharded_run(cs, first is None))
            turns[who].append(ep)
            if first is None:
                first = res
            else:
                assert res.train_losses == first.train_losses, f"phase 3g {name}: repeat differs"
            del res
        if rank == 0:
            out["holds"][name] = hold(name, gap(first, ref), TOL)
        out["epoch_s"][name] = {who: [float(np.median(ep[1:])) for ep in eps]
                                for who, eps in turns.items()}
        if name == "dp_off":
            kept["losses"], kept["state"] = first.train_losses, first.state
            ev = counted(lambda: sharded_dmf.evaluate_sharded(first.state, train, test, I, J, D,
                                                              device=dev))
            if rank == 0:
                plain = dmf.evaluate(first.state, train, test, I, J, device=dev)
                assert ev == plain, f"phase 3g evaluate at D={D}: {ev} != {plain}"
                out["evaluate"] = ev
        del ref, first
    if D > 1:
        cs = dataclasses.replace(cfg, n_shards=D)
        triv = counted(lambda: dmf.fit(cs, train, nbr, epochs=SHARD_SHORT_EPOCHS,
                                       churn=ChurnConfig(), defense=DefenseConfig(), device=dev))
        assert triv.train_losses == kept["losses"][:SHARD_SHORT_EPOCHS], "phase 3g trivial plan"
        out["holds"]["trivial_plan_bitexact"] = True
        del triv
        kw = dict(epochs=SHARD_SHORT_EPOCHS, on_nonfinite="halt", device=dev,
                  attack=AttackConfig(family="norm_inflate", frac=BYZ_FRAC, scale=BYZ_SCALE,
                                      seed=0),
                  defense=DefenseConfig(screen=True, norm_cap=tau, aggregation="trim",
                                        trim_frac=0.25))
        trim, out["epoch_s"]["screen_trim"] = counted(
            lambda: stamped_fit(dmf.fit, cs, train, nbr, **kw))
        if rank == 0:
            plain = dmf.fit(cfg, train, nbr, **kw)
            out["holds"]["screen_trim"] = hold("screen_trim", gap(trim, plain), BYZ_LOSS_TOL)
            del plain
        group.barrier()
        del trim
        clock = sharded_dmf.ExchangeClock()
        timed = sharded_dmf.make_shard_plan(nbr, cs, dev, clock)
        _, secs, xs, _ = counted(lambda: by_hand(cs, SHARD_SHORT_EPOCHS, timed, clock))
        out["exchange"] = {"collectives": clock.calls, "epoch_s": secs, "exchange_s": xs,
                           "share": [x / t for x, t in zip(xs, secs)]}
    total = torch.as_tensor(counts, device=dev)
    dist.all_reduce(total)
    out["launches"] = {kern.__name__: int(c) for kern, c in zip(ops.KERNELS, total.tolist())}
    out["serving"] = sharded_serving(rank, D, group, kept.pop("state"), tables, nbr, cfg,
                                     capacity, dev)
    return out


class BroadcastCharged:
    """A sharded engine whose per-shard dispatch charges its broadcast to
    the scheduler's clock as well: the seconds `serve_microbatch` returns
    plus the slowest rank's wall time of its broadcast (agreed by one
    `all_reduce` MAX, itself not charged), so that a scheduled dispatch
    pays for its exchange as a lockstep wave pays for its collectives."""

    def __init__(self, engine):
        self.engine = engine

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def serve_microbatch(self, user_ids, return_flags: bool = False):
        *out, dt = self.engine.serve_microbatch(user_ids, return_flags)
        return (*out, dt + self.engine.agreed_seconds(self.engine.broadcast_seconds[-1]))


def sharded_serving(rank: int, D: int, group, state, tables: dict, nbr, cfg, capacity: float,
                    dev) -> dict:
    """Phase 3g's serving half on one rank of D: the learner-sharded
    `ServingEngine` on the DP-off state at full width (microbatch 64,
    k=10). Phase 3a's requests (4,096 pruned, 1,024 dense), then its test
    check-ins ingested, then the requests again: every slate, value and id,
    equal to the one-device engine's built on rank 0 from the same state,
    bit for bit, and every rank's full U, P, Q after the ingest equal (a
    digest a rank, all-gathered). The engines' group has a clock for
    these drains (the collectives' wall share). At D > 1 also phase 3f's
    1x Poisson stream, on the group without a clock, through `Scheduler`
    twice (a dispatch's seconds alone, the reference's clock, then with
    its broadcast charged, `BroadcastCharged`) and `simulate_lockstep`:
    every rank's report equal (digests), the served slates `recommend`'s
    bit for bit, each scheduled dispatch one launch of kernel 5 on its
    home rank and each wave one on every rank. At D = 1 the engine runs
    on a one-rank group (``group=``), so that a wave's collectives run
    over nccl. Launch counts are summed over the ranks, and only the
    sharded engines' calls are counted."""
    import hashlib

    from repro_torch.kernels import ops
    from repro_torch.scheduling import Scheduler, WorkloadConfig, generate, simulate_lockstep
    from repro_torch.serving import ServingConfig, ServingEngine
    from repro_torch.sharding import dmf as sharded_dmf
    index, train, test = tables["index"], tables["train"], tables["test"]
    I = cfg.n_users
    rng = np.random.default_rng(SEED)          # phase 3a's request set
    ids = {"pruned": rng.integers(0, I, N_PRUNED), "dense": rng.integers(0, I, N_DENSE)}
    counts = np.zeros(len(ops.KERNELS), np.int64)

    def summed(x) -> list:
        t = torch.as_tensor(np.asarray(x, np.int64), device=dev)
        return group.all_reduce(t).tolist()

    def counted(fn):
        before = [kern.launches for kern in ops.KERNELS]
        out = fn()
        counts[:] += [kern.launches - b for kern, b in zip(ops.KERNELS, before)]
        return out

    def gathered(values, dtype=np.float64) -> list:
        """Every rank's ``values``, rank after rank."""
        t = torch.as_tensor(np.asarray(values, dtype), device=dev)
        return group.all_gather(t).reshape(-1).tolist()

    def digest(obj) -> int:
        return int.from_bytes(hashlib.sha256(obj).digest()[:8], "little", signed=True)

    def state_digest(st) -> int:
        h = hashlib.sha256()
        for x in (st.U, st.P, st.Q):
            h.update(x.cpu().numpy())
        return int.from_bytes(h.digest()[:8], "little", signed=True)

    def report_digest(rep) -> int:
        recs = [(r.rid, r.shard, r.status, r.dispatch_start, r.completion, r.fallback,
                 r.ingest_epoch, None if r.vals is None else (r.vals.tolist(), r.idx.tolist()))
                for r in rep.records]
        gauges = [(g.t, g.shard, g.depth, g.oldest_age, g.batch_occupancy) for g in rep.gauges]
        return digest(json.dumps([recs, gauges, rep.n_dispatches_per_shard]).encode())

    def config(prune: bool, shards: int) -> ServingConfig:
        return ServingConfig(microbatch=MICROBATCH, k=K_TOP, prune=prune, n_shards=shards)

    def dense_of(eng, shards: int):
        return ServingEngine(eng.state, index, config(False, shards),
                             seen=eng.seen.cpu().numpy(), group=eng.group, device=dev)

    def equal(tag: str, got, want) -> None:
        for part, a, b in zip(("values", "ids", "flags"), got, want):
            np.testing.assert_array_equal(a, b, err_msg=f"phase 3g sharded {tag} at D={D}: {part}")

    def waves(eng, dense) -> dict:
        """Phase 3a's requests through the sharded engines, the pruned drain
        timed: its waves, their agreed seconds, the exchange's wall share.
        One wave first, off the clock: a group's first collective sets up
        its communicator (~0.1-0.2 s)."""
        eng.serve_wave(np.zeros((group.size, MICROBATCH), np.int64))
        eng.stats.reset()
        sync(dev)
        x0, t0 = eng.exchange.seconds, time.perf_counter()
        pruned = counted(lambda: eng.recommend(ids["pruned"], return_flags=True))
        wall = time.perf_counter() - t0
        share = (eng.exchange.seconds - x0) / wall
        lat = eng.stats.dispatch_latency_percentiles((50, 99))
        row = {"waves": eng.stats.n_dispatches, "wave_p50_ms": lat["p50_ms"],
               "wave_p99_ms": lat["p99_ms"], "requests_per_s": eng.requests_per_sec,
               "collectives_wall_share_by_rank": gathered([share])}
        return row, {"pruned": pruned,
                     "dense": counted(lambda: dense.recommend(ids["dense"], return_flags=True))}

    t_start = time.perf_counter()
    out = {"ranks": D, "backend": group.backend}
    one = (ServingEngine(state, index, config(True, 1), train=train, nbr=nbr, dmf_cfg=cfg,
                         device=dev) if rank == 0 or D == 1 else None)
    want = {}
    if one is not None:
        want["before"] = {"pruned": one.recommend(ids["pruned"], return_flags=True),
                          "dense": dense_of(one, 1).recommend(ids["dense"], return_flags=True)}
    # the sharded engines on a group whose clock times every collective
    # between two device synchronisations (at D = 1 a one-rank group, so
    # that a wave's collectives run over nccl)
    clocked = sharded_dmf.learner_group(D, dev, sharded_dmf.ExchangeClock())
    eng = ServingEngine(state, index, config(True, D), train=train, nbr=nbr, dmf_cfg=cfg,
                        group=clocked, device=dev)
    dense = dense_of(eng, D)
    del state
    out["before_ingest"], got = waves(eng, dense)
    if rank == 0:
        for kind in got:
            equal(f"{kind} before ingest", got[kind], want["before"][kind])
    out["slates_bitwise_vs_one_device"] = {"before_ingest": N_PRUNED + N_DENSE}
    if D > 1:
        if rank == 0:
            one.ingest(test)
            want["after"] = {"pruned": one.recommend(ids["pruned"], return_flags=True),
                             "dense": dense_of(one, 1).recommend(ids["dense"],
                                                                 return_flags=True)}
            one_digest = state_digest(one.state)
            del one
        group.barrier()
        t0 = time.perf_counter()
        rep = counted(lambda: eng.ingest(test))
        out["ingest"] = {"events": rep.n_events, "batches": rep.n_batches,
                         "touched_users": len(rep.touched_users),
                         "seconds_by_rank": gathered([time.perf_counter() - t0])}
        digests = gathered([state_digest(eng.state)], np.int64)
        assert len(set(digests)) == 1, f"phase 3g: the ranks' states split after ingest {digests}"
        if rank == 0:
            assert digests[0] == one_digest, "phase 3g: sharded ingest != one-device ingest"
        out["ingest"]["states_bitwise_equal_across_ranks_and_one_device"] = True
        del dense
        dense = dense_of(eng, D)
        out["after_ingest"], got = waves(eng, dense)
        del dense
        if rank == 0:
            for kind in got:
                equal(f"{kind} after ingest", got[kind], want["after"][kind])
        out["slates_bitwise_vs_one_device"]["after_ingest"] = N_PRUNED + N_DENSE
        reqs = generate(WorkloadConfig(n_requests=SCHED_REQUESTS, rate_rps=capacity,
                                       slo_ms=SCHED_SLO_MS, users="powerlaw", zipf_s=SCHED_ZIPF,
                                       seed=SCHED_1X_SEED), I)
        k5 = ops.KERNELS.index(ops.serve_topk_rows)
        eng.group = group     # the same ranks, no clock: nothing synchronises around a collective
        for run in ("scheduler", "scheduler_broadcast_charged", "lockstep"):
            n0, b0 = counts[k5], len(eng.broadcast_seconds)
            t0 = time.perf_counter()
            rep = counted(lambda: simulate_lockstep(eng, reqs) if run == "lockstep"
                          else Scheduler(eng if run == "scheduler" else BroadcastCharged(eng)
                                         ).run(reqs))
            wall = time.perf_counter() - t0
            launched = summed([counts[k5] - n0])[0]
            n_disp = sum(rep.n_dispatches_per_shard)
            n_waves = len({r.dispatch_start for r in rep.served()})
            assert launched == (D * n_waves if run == "lockstep" else n_disp), (run, launched)
            digests = gathered([report_digest(rep)], np.int64)
            assert len(set(digests)) == 1, f"phase 3g {run}: the ranks' reports differ"
            served = rep.served()
            vals, idx, flags = eng.recommend([r.user for r in served], return_flags=True)
            assert all(np.array_equal(r.vals, vals[j]) and np.array_equal(r.idx, idx[j])
                       and r.fallback == bool(flags[j]) for j, r in enumerate(served)), run
            row = sched_row(rep)
            del row["summary"]
            row.update(host_s=wall, launches_kernel5=launched, reports_equal_across_ranks=True,
                       slates_bitwise_vs_recommend=len(served))
            if run == "lockstep":
                row["waves"] = n_waves
            else:
                bc = eng.broadcast_seconds[b0:]
                row["broadcasts"] = len(bc)
                row["broadcast_s"] = {"sum": float(np.sum(bc)), "p50": float(np.median(bc)),
                                      "p99": float(np.percentile(bc, 99))}
            out[run] = row
        out["goodput_scheduler_over_lockstep"] = {
            how: out[run]["goodput_rps"] / out["lockstep"]["goodput_rps"]
            for how, run in (("dispatch_alone", "scheduler"),
                             ("broadcast_charged", "scheduler_broadcast_charged"))}
        out["stream"] = {"n_requests": SCHED_REQUESTS, "rate_rps": capacity,
                         "slo_ms": SCHED_SLO_MS, "seed": SCHED_1X_SEED}
    del eng
    if dev.type == "cuda":
        out["device_memory_by_rank"] = {
            "allocated_gb": gathered([torch.cuda.memory_allocated(dev) / 1e9]),
            "peak_gb": gathered([torch.cuda.max_memory_allocated(dev) / 1e9])}
    out["launches"] = {kern.__name__: int(c) for kern, c in zip(ops.KERNELS, summed(counts))}
    group.barrier()
    out["seconds"] = time.perf_counter() - t_start
    return out


def drive_sharded(ds, nbr, index, cfg, tau: float, capacity: float) -> dict:
    """Phase 3g: `sharded_rank` at D=1 over nccl and at D=2 over gloo (two
    ranks on the one card), each in one spawn; the kernels are built
    already (phase 1). ``capacity`` is phase 3f's, the 1x stream's rate."""
    from repro_torch.launch.mesh import spawn_ranks
    tables = {"train": ds.train, "test": ds.test, "idx": nbr.idx.cpu().numpy(),
              "wgt": nbr.wgt.cpu().numpy(), "index": index}
    out = {}
    for backend, D in SHARD_GROUPS:
        t0 = time.perf_counter()
        out[f"D{D}"] = spawn_ranks(sharded_rank, D, backend=backend, device="cuda",
                                   timeout_s=SHARD_TIMEOUT_S,
                                   args=(D, tables, cfg, tau, capacity, "cuda"))
        out[f"D{D}"]["spawn_s"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------- LM serving
def lm_inputs(cfg, B: int, S: int, gen, dev):
    """Seeded token ids (B, S) or (B, S, n_q), and media for vision models."""
    shape = (B, S, cfg.n_codebooks) if cfg.n_codebooks else (B, S)
    tokens = torch.randint(0, cfg.vocab_size, shape, generator=gen, device=dev)
    media = (torch.randn((B, cfg.n_image_tokens, cfg.d_model), generator=gen, device=dev) * 0.5
             if cfg.n_image_tokens else None)
    return tokens, media


def lm_randomize_constants(model, gen) -> int:
    """Adds N(0, 0.3²) draws to every small parameter that is all zeros or
    all ones at init (norm scales, qkv biases, the cross gate, `conv_b`,
    `D`), so that the holds hold them to something; returns their count."""
    n = 0
    with torch.no_grad():
        for p in model.parameters():
            if p.numel() <= 1 << 20 and (bool((p == 0).all()) or bool((p == 1).all())):
                p.add_(torch.randn(p.shape, generator=gen, device=p.device) * 0.3)
                n += 1
    return n


def lm_decode_vs_forward(model, prompt: int, steps: int, dev, gen, last_only: bool = False) -> dict:
    """Prefill ``prompt`` tokens, splice the caches into a cache of prompt +
    steps positions, decode the next ``steps`` tokens teacher-forced, and
    hold the decoded logits against `forward` over all prompt + steps
    tokens at the same positions (every step, or the last with
    ``last_only``), within the reference's decode-vs-forward tolerance."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    cfg = model.cfg
    tokens, media = lm_inputs(cfg, 1, prompt + steps, gen, dev)
    batch = {"tokens": tokens[:, :prompt]}
    if media is not None:
        batch["media"] = media
    sync(dev)
    t0 = time.perf_counter()
    _, pcache = serve.make_prefill_step(cfg, device=dev)(model, batch)
    cache = serve.cache_from_prefill(cfg, pcache, prompt + steps, device=dev)
    del pcache
    step = serve.make_decode_step(cfg, device=dev)
    decoded = []
    for t in range(prompt, prompt + steps):
        logits, cache = step(model, cache, tokens[:, t:t + 1], t)
        if not last_only or t == prompt + steps - 1:
            decoded.append(logits[:, 0])
    sync(dev)
    served_s = time.perf_counter() - t0
    del cache
    t0 = time.perf_counter()
    with torch.inference_mode():
        h, _, _ = transformer.forward(model, tokens, media=media)
        full = transformer.logits_of(model, h[:, -len(decoded):])
        del h
    sync(dev)
    forward_s = time.perf_counter() - t0
    got = torch.stack(decoded, 1)
    dev_abs = (got - full).abs()
    ratio = float((dev_abs / (LM_HOLD_ATOL + LM_HOLD_RTOL * full.abs())).max())
    out = {"prompt": prompt, "steps": steps, "held_positions": len(decoded),
           "max_abs_dev": float(dev_abs.max()), "max_abs_logit": float(full.abs().max()),
           "worst_over_tolerance": ratio, "finite": bool(torch.isfinite(got).all()),
           "prefill_and_decode_s": served_s, "forward_s": forward_s}
    assert out["finite"] and ratio <= 1.0, f"phase 3h {cfg.name}: decode != forward {out}"
    return out


def lm_profile(fn) -> dict:
    """One call of ``fn`` under `torch.profiler` (CPU and CUDA activity):
    the device's busy share over the window (`obs.trace.device_busy`) and
    the kernels with the most device time."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.obs import trace as obs_trace
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        path = pathlib.Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        doc = json.loads(path.read_text())
    return {"device_busy": obs_trace.device_busy(doc), "kernels": kernel_time_by_name(doc, top=8)}


def lm_qwen(dev) -> dict:
    """qwen1.5-4b at its published width and depth: the bf16 prefill of
    LM_BATCH × LM_PROMPT tokens (twice: the first call pays the libraries'
    first use), its caches spliced into a decode cache of LM_CACHE
    positions, LM_DECODE greedy steps timed with CUDA events; then, fp32
    compute on the same weights, the decode-vs-forward hold."""
    from repro_torch.configs import registry
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    from repro_torch.utils import tree
    cfg = registry.get_config(LM_QWEN)
    param_bytes = tree.tree_bytes(transformer.abstract_params(cfg))
    sync(dev)
    t0 = time.perf_counter()
    model = transformer.init_params(cfg, seed=SEED, device=dev)
    sync(dev)
    init_s = time.perf_counter() - t0
    resident = torch.cuda.memory_allocated(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    randomized = lm_randomize_constants(model, gen)
    tokens, _ = lm_inputs(cfg, LM_BATCH, LM_PROMPT, gen, dev)
    prefill = serve.make_prefill_step(cfg, device=dev)
    decode = serve.make_decode_step(cfg, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    prefill_s = []
    for _ in range(2):
        logits = pcache = None
        sync(dev)
        t0 = time.perf_counter()
        logits, pcache = prefill(model, {"tokens": tokens})
        sync(dev)
        prefill_s.append(time.perf_counter() - t0)
    prefill_peak = torch.cuda.max_memory_allocated(dev) - resident
    cache = serve.cache_from_prefill(cfg, pcache, LM_CACHE, device=dev)
    del pcache
    tok = logits.argmax(-1)                                   # (B, 1) greedy
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(LM_DECODE)]
    fed = []
    sync(dev)
    t0 = time.perf_counter()
    for i, (start, end) in enumerate(events):
        start.record()
        fed.append(tok)
        logits, cache = decode(model, cache, tok, LM_PROMPT + i)
        tok = logits.argmax(-1)
        end.record()
    sync(dev)
    decode_wall_s = time.perf_counter() - t0
    step_ms = sorted(s.elapsed_time(e) for s, e in events)
    assert bool(torch.isfinite(logits).all()), "phase 3h: non-finite decode logits"
    peak = torch.cuda.max_memory_allocated(dev) - resident
    # where a step's time goes: the last LM_PROFILED steps again (the same
    # tokens at the same positions rewrite the same cache entries)
    last = range(LM_CACHE - LM_PROFILED, LM_CACHE)
    decode_profile = lm_profile(lambda: [decode(model, cache, fed[t - LM_PROMPT], t) for t in last])
    decode_profile["steps"] = LM_PROFILED
    prefill_profile = lm_profile(lambda: prefill(model, {"tokens": tokens}))
    cache_bytes = sum(v.numel() * v.element_size() for c in cache.values() for v in c.values())
    del cache, logits
    model.cfg = dataclasses.replace(cfg, compute_dtype="float32")   # the same weights
    hold = lm_decode_vs_forward(model, LM_HOLD_PROMPT, LM_HOLD_STEPS, dev, gen)
    del model
    torch.cuda.empty_cache()
    decode_s = sum(step_ms) / 1e3
    return {
        "config": {"n_layers": cfg.n_layers, "d_model": cfg.d_model, "n_heads": cfg.n_heads,
                   "head_dim": cfg.head_dim, "d_ff": cfg.d_ff, "vocab_size": cfg.vocab_size,
                   "qkv_bias": cfg.qkv_bias, "compute_dtype": cfg.compute_dtype},
        "param_bytes_meta": param_bytes, "allocated_after_init": resident, "init_s": init_s,
        "randomized_constant_leaves": randomized,
        "prefill": {"batch": LM_BATCH, "tokens": LM_PROMPT, "s": prefill_s,
                    "tokens_per_s": LM_BATCH * LM_PROMPT / prefill_s[-1],
                    "peak_gb_above_params": prefill_peak / 1e9},
        "decode": {"steps": LM_DECODE, "cache_positions": LM_CACHE,
                   "ms_p50": float(np.percentile(step_ms, 50)),
                   "ms_p99": float(np.percentile(step_ms, 99)),
                   "ms_min": step_ms[0], "ms_max": step_ms[-1],
                   "tokens_per_s": LM_BATCH * LM_DECODE / decode_s, "wall_s": decode_wall_s,
                   "cache_gb": cache_bytes / 1e9},
        "peak_gb_above_params": peak / 1e9,
        "profiled": {"decode": decode_profile, "prefill": prefill_profile},
        "hold_fp32": hold,
    }


def lm_other_config(arch: str, dev) -> dict:
    """One config at its published width, cut to one period of depth (to
    `reduced()` where one period of fp32 parameters exceeds
    LM_PERIOD_CAP_BYTES), fp32 compute, MoE without capacity drops: the
    decode-vs-forward hold (yi-34b-swa past its ring's wrap)."""
    from repro_torch.configs import registry
    from repro_torch.models import config as mc
    from repro_torch.models import transformer
    from repro_torch.utils import tree
    full = registry.get_config(arch)
    one = dataclasses.replace(full, n_layers=len(full.period), compute_dtype="float32")
    one_bytes = tree.tree_bytes(transformer.abstract_params(one))
    if one_bytes > LM_PERIOD_CAP_BYTES:
        cfg, cut = mc.reduced(full), (f"reduced(): one period of fp32 parameters is "
                                      f"{one_bytes / 1e9:.1f} GB > {LM_PERIOD_CAP_BYTES / 1e9:.0f} GB")
    else:
        cfg, cut = one, f"one period: {len(full.period)} of {full.n_layers} layers"
    if cfg.n_routed_experts:
        # a forward drops routes a one-token decode step keeps; the hold
        # compares the two only without drops
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_routed_experts / cfg.moe_top_k)
        cut += "; capacity_factor n_experts/top_k (no route dropped)"
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    model = transformer.init_params(cfg, seed=SEED, device=dev)
    sync(dev)
    init_s = time.perf_counter() - t0
    randomized = lm_randomize_constants(model, gen)
    if arch == LM_SWA:
        held = lm_decode_vs_forward(model, LM_SWA_PROMPT, LM_SWA_TOKENS - LM_SWA_PROMPT, dev,
                                    gen, last_only=True)
        held["ring_slots"] = min(LM_SWA_TOKENS, cfg.period[0].sliding_window)
    else:
        held = lm_decode_vs_forward(model, LM_PROMPT_OTHER, LM_HOLD_STEPS, dev, gen)
    del model
    torch.cuda.empty_cache()
    return {"cut": cut, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "param_bytes": tree.tree_bytes(transformer.abstract_params(cfg)), "init_s": init_s,
            "randomized_constant_leaves": randomized, **held}


def lm_card_vs_cpu(arch: str, dev) -> dict:
    """`reduced()` width, fp32: the same numpy weights carried to the card
    and to the CPU; prefill logits, LM_CPU_STEPS decode steps' logits and
    every cache leaf within LM_CARD_CPU_REL × the CPU tensor's largest
    magnitude."""
    from repro_torch.configs import registry
    from repro_torch.launch import serve
    from repro_torch.models import config as mc
    from repro_torch.models import transformer
    cfg = mc.reduced(registry.get_config(arch))
    tree = transformer.params_to_numpy(transformer.init_params(cfg, seed=SEED, device="cpu"))
    gen = torch.Generator().manual_seed(SEED)
    tokens, media = lm_inputs(cfg, 2, LM_CPU_PREFILL + LM_CPU_STEPS, gen, "cpu")
    runs = {}
    for where in ("cpu", dev):
        model = transformer.params_from_numpy(tree, cfg, device=where)
        batch = {"tokens": tokens[:, :LM_CPU_PREFILL].to(where)}
        if media is not None:
            batch["media"] = media.to(where)
        logits, pcache = serve.make_prefill_step(cfg, device=where)(model, batch)
        cache = serve.cache_from_prefill(cfg, pcache, LM_CPU_PREFILL + LM_CPU_STEPS, device=where)
        step = serve.make_decode_step(cfg, device=where)
        outs = [logits.cpu()]
        for t in range(LM_CPU_PREFILL, LM_CPU_PREFILL + LM_CPU_STEPS):
            logits, cache = step(model, cache, tokens[:, t:t + 1].to(where), t)
            outs.append(logits.cpu())
        runs[where == "cpu"] = (outs, {f"{p}/{n}": v.cpu() for p, c in cache.items()
                                       for n, v in c.items()})
    (card_logits, card_cache), (cpu_logits, cpu_cache) = runs[False], runs[True]
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
    out = {"logits_rel": max(rel(a, b) for a, b in zip(card_logits, cpu_logits)),
           "cache_rel": max(rel(card_cache[n], cpu_cache[n]) for n in cpu_cache),
           "cache_leaves": len(cpu_cache)}
    assert out["logits_rel"] <= LM_CARD_CPU_REL and out["cache_rel"] <= LM_CARD_CPU_REL, (
        f"phase 3h card vs CPU {arch}: {out}")
    return out


def drive_lm_serving(dev) -> dict:
    """Phase 3h: the LM stack's serving path (`launch/serve.py` over
    `models/transformer.py`) on the card; see the module docstring, h."""
    from repro_torch.configs import registry
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = {"qwen1.5-4b": lm_qwen(dev)}
    out["qwen1.5-4b"]["s"] = time.perf_counter() - t0
    configs = {}
    for arch in [a for a in registry.ARCH_IDS if a != LM_QWEN] + [LM_SWA]:
        t0 = time.perf_counter()
        configs[arch] = lm_other_config(arch, dev)
        configs[arch]["s"] = time.perf_counter() - t0
    out["configs"] = configs
    out["reduced"] = {"qwen1.5-4b": "none: 40 of 40 layers (bf16 timing; fp32 hold)",
                      **{a: c["cut"] for a, c in configs.items()}}
    t0 = time.perf_counter()
    out["card_vs_cpu"] = {a: lm_card_vs_cpu(a, dev) for a in registry.ARCH_IDS + [LM_SWA]}
    out["card_vs_cpu_s"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------- LM training
def lm_train_batch(cfg, B: int, S: int, seed: int, dev) -> dict:
    """One `SyntheticLM` batch at the model's vocab, uploaded once."""
    from repro_torch.data.lm_pipeline import LMDataConfig, SyntheticLM
    data = SyntheticLM(LMDataConfig(vocab_size=cfg.vocab_size, seq_len=S, batch_size=B, seed=seed))
    return {k: torch.as_tensor(v, device=dev)
            for k, v in data.batch(0, n_codebooks=cfg.n_codebooks).items()}


def lm_loss_and_grads(model, batch) -> tuple:
    """`loss_fn`'s loss and the gradient of every parameter (by name)."""
    from repro_torch.models import transformer
    model.zero_grad(set_to_none=True)
    loss = transformer.loss_fn(model, batch)
    loss.backward()
    grads = {name: torch.zeros_like(p) if p.grad is None else p.grad
             for name, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.detach(), grads


def lm_remat_hold(cfg, batch, dev) -> dict:
    """qwen1.5-4b at full width, LM_REMAT_LAYERS layers: `loss_fn` and its
    gradients with remat off and on, the same weights: equal bit for bit."""
    from repro_torch.models import transformer
    small = dataclasses.replace(cfg, n_layers=LM_REMAT_LAYERS)
    model = transformer.init_params(small, seed=SEED, device=dev)
    runs = []
    for remat in (False, True):
        model.cfg = dataclasses.replace(small, remat=remat)
        runs.append(lm_loss_and_grads(model, batch))
    (l0, g0), (l1, g1) = runs
    out = {"n_layers": LM_REMAT_LAYERS, "loss": float(l0), "loss_equal": bool(torch.equal(l0, l1)),
           "grad_leaves": len(g0),
           "grads_equal": all(bool(torch.equal(g0[n], g1[n])) for n in g0)}
    del model, runs, g0, g1
    torch.cuda.empty_cache()
    assert out["loss_equal"] and out["grads_equal"], f"phase 3i remat on != off: {out}"
    return out


def lm_train_qwen(dev) -> dict:
    """qwen1.5-4b at its published width and depth (fp32 parameters, bf16
    compute, remat as published) trained by the ``allreduce`` step with
    `train_lm`'s AdamW: one warm-up step, LM_TRAIN_TIMED steps timed with
    CUDA events, LM_TRAIN_PROFILED under `torch.profiler`, all on one fixed
    batch of LM_TRAIN_BATCH × LM_TRAIN_SEQ tokens."""
    from repro_torch import optim
    from repro_torch.configs import registry
    from repro_torch.launch import train
    from repro_torch.models import transformer
    from repro_torch.utils import tree
    cfg = registry.get_config(LM_QWEN)
    batch = lm_train_batch(cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ, SEED, dev)
    t0 = time.perf_counter()
    remat = lm_remat_hold(cfg, batch, dev)
    remat["s"] = time.perf_counter() - t0
    meta = transformer.abstract_params(cfg)
    n_params = tree.tree_size(meta)
    param_bytes = tree.tree_bytes(meta)
    n_steps = LM_TRAIN_WARMUP + LM_TRAIN_TIMED + LM_TRAIN_PROFILED
    opt = optim.adamw(optim.linear_warmup_cosine(LM_TRAIN_PEAK_LR, LM_TRAIN_WARMUP_STEPS, n_steps),
                      weight_decay=LM_TRAIN_WD)
    step, init_fn = train.make_train_step(cfg, opt, device=dev)
    sync(dev)
    t0 = time.perf_counter()
    state = init_fn(SEED)
    sync(dev)
    init_s = time.perf_counter() - t0
    resident = torch.cuda.memory_allocated(dev)      # parameters and both moments
    losses = []
    sync(dev)
    t0 = time.perf_counter()
    state, m = step(state, batch)                    # warm-up: the libraries' first use
    losses.append(m["loss"])
    sync(dev)
    warmup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(LM_TRAIN_TIMED)]
    t0 = time.perf_counter()
    for start, end in events:
        start.record()
        state, m = step(state, batch)
        end.record()
        losses.append(m["loss"])
    sync(dev)
    timed_wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    step_s = sorted(s.elapsed_time(e) / 1e3 for s, e in events)

    def profiled():
        nonlocal state
        for _ in range(LM_TRAIN_PROFILED):
            state, m = step(state, batch)
            losses.append(m["loss"])

    profile = lm_profile(profiled)
    profile["steps"] = LM_TRAIN_PROFILED
    # the profiler slows the host, so its busy share is a lower bound; the
    # profiled device time a step over the unprofiled step time estimates it
    profile["busy_share_unprofiled_estimate"] = (
        profile["device_busy"]["busy_ms"] / 1e3 / LM_TRAIN_PROFILED
        / float(np.percentile(step_s, 50)))
    losses = [float(x) for x in losses]
    assert all(np.isfinite(losses)), f"phase 3i: non-finite loss {losses}"
    after = losses[LM_TRAIN_WARMUP + LM_TRAIN_TIMED]   # after the warm-up and the timed steps
    assert after < losses[0] - LM_TRAIN_DROP, f"phase 3i: loss {losses[0]} -> {after}"
    assert [int(x) for x in state.opt_state.step.reshape(-1).tolist()] == [n_steps]
    del state, m, step
    torch.cuda.empty_cache()
    p50 = float(np.percentile(step_s, 50))
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    flops = 6.0 * n_params * tokens
    state_bytes = 4 * param_bytes                     # parameters, gradients, mu, nu (all fp32)
    return {
        "config": {"n_layers": cfg.n_layers, "d_model": cfg.d_model, "n_heads": cfg.n_heads,
                   "head_dim": cfg.head_dim, "d_ff": cfg.d_ff, "vocab_size": cfg.vocab_size,
                   "qkv_bias": cfg.qkv_bias, "compute_dtype": cfg.compute_dtype,
                   "remat": cfg.remat, "attn_chunk": cfg.attn_chunk,
                   "loss_chunk": cfg.loss_chunk},
        "optimizer": {"adamw": {"lr": f"linear_warmup_cosine({LM_TRAIN_PEAK_LR}, "
                                      f"{LM_TRAIN_WARMUP_STEPS}, {n_steps})",
                                "weight_decay": LM_TRAIN_WD, "grad_clip_norm": 1.0,
                                "applied": "in place (Optimizer.update_)"}},
        "batch": LM_TRAIN_BATCH, "seq": LM_TRAIN_SEQ, "tokens_per_step": tokens,
        "n_params": n_params, "param_bytes": param_bytes,
        "n_params_without_input_embedding": n_params - cfg.vocab_size * cfg.d_model,
        "init_s": init_s, "warmup_step_s": warmup_s,
        "losses": losses, "loss_drop": losses[0] - after, "loss_drop_margin": LM_TRAIN_DROP,
        "step_s": {"p50": p50, "p99": float(np.percentile(step_s, 99)), "min": step_s[0],
                   "max": step_s[-1], "timed": LM_TRAIN_TIMED, "wall_s": timed_wall_s},
        "tokens_per_s": tokens / p50,
        "model_flops_per_step": flops,
        "model_flops": "6*N*T, N every parameter (input embedding included), T tokens a step",
        "mfu": flops / p50 / BF16_FLOPS_PER_S,
        "mfu_peak": "989 TFLOP/s, H100 SXM dense bf16 (data sheet, 700 W)",
        "peak_gb": peak / 1e9, "resident_gb_after_init": resident / 1e9,
        "state_gb": state_bytes / 1e9, "rest_gb": (peak - state_bytes) / 1e9,
        "profiled": profile, "remat_hold": remat,
    }


def lm_train_gossip(dev) -> dict:
    """The reference's `test_gossip_training_converges_small_lm` on the
    card: its config, L learners, D rounds, ``adamw(6e-3)``, its 60 steps
    and its assertions; each step timed with CUDA events."""
    from repro_torch import optim
    from repro_torch.configs import registry
    from repro_torch.core import gossip
    from repro_torch.data.lm_pipeline import LMDataConfig, SyntheticLM
    from repro_torch.launch import train
    from repro_torch.models import config as mc
    cfg = mc.reduced(registry.get_config(LM_QWEN), **LM_GOSSIP)
    step, init_fn = train.make_train_step(
        cfg, optim.adamw(LM_GOSSIP_LR), sync="gossip",
        gossip=gossip.GossipConfig(learner_axis="data", walk_length=LM_GOSSIP_WALK),
        n_learners=LM_GOSSIP_LEARNERS, device=dev)
    data = SyntheticLM(LMDataConfig(vocab_size=256, seq_len=64, batch_size=16, seed=0))
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in data.batch(i).items()}
               for i in range(LM_GOSSIP_STEPS)]
    state = init_fn(SEED)
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(LM_GOSSIP_STEPS)]
    losses, cons = [], None
    sync(dev)
    t0 = time.perf_counter()
    for b, (start, end) in zip(batches, events):
        start.record()
        state, m = step(state, b)
        end.record()
        losses.append(m["loss"])
        cons = m["consensus_err"]
    sync(dev)
    wall_s = time.perf_counter() - t0
    losses = [float(x) for x in losses]
    step_ms = sorted(s.elapsed_time(e) for s, e in events)
    out = {"learners": LM_GOSSIP_LEARNERS, "walk_length": LM_GOSSIP_WALK, "steps": LM_GOSSIP_STEPS,
           "first_loss": losses[0], "last_loss": losses[-1], "consensus_err": float(cons),
           "step_ms_p50": float(np.percentile(step_ms, 50)),
           "step_ms_p99": float(np.percentile(step_ms, 99)), "wall_s": wall_s}
    assert losses[-1] < losses[0] - 0.3 and out["consensus_err"] < 0.5, f"phase 3i gossip: {out}"
    return out


def lm_train_card_vs_cpu(arch: str, dev) -> dict:
    """`reduced()` width, fp32: the same numpy weights and batch on the card
    and on the CPU; `loss_fn`'s gradients, then one ``allreduce`` AdamW
    step (eps=1e-3: at 1e-8 a first step moves a near-zero-gradient
    element by ±lr on the last bit of its gradient). The loss, every
    gradient and every updated parameter within LM_CARD_CPU_REL × the CPU
    leaf's largest magnitude."""
    from repro_torch import optim
    from repro_torch.configs import registry
    from repro_torch.launch import train
    from repro_torch.models import config as mc
    from repro_torch.models import transformer
    from repro_torch.utils import tree as tree_lib
    cfg = mc.reduced(registry.get_config(arch))
    tree = transformer.params_to_numpy(transformer.init_params(cfg, seed=SEED, device="cpu"))
    batch = lm_train_batch(cfg, LM_TRAIN_CPU_BATCH, LM_TRAIN_CPU_SEQ, SEED, "cpu")
    if cfg.n_image_tokens:
        gen = torch.Generator().manual_seed(SEED)
        batch["media"] = torch.randn((LM_TRAIN_CPU_BATCH, cfg.n_image_tokens, cfg.d_model),
                                     generator=gen) * 0.5
    opt = optim.adamw(optim.linear_warmup_cosine(LM_TRAIN_PEAK_LR, 2, 10), weight_decay=LM_TRAIN_WD,
                      eps=1e-3)
    runs = {}
    for where in ("cpu", dev):
        state = train.train_state_from_numpy(cfg, opt, tree, device=where)
        b = {k: v.to(where) for k, v in batch.items()}
        _, grads = lm_loss_and_grads(state.params, b)
        grads = {n: g.cpu() for n, g in grads.items()}
        step, _ = train.make_train_step(cfg, opt, device=where)
        state, m = step(state, b)
        runs[where == "cpu"] = (m["loss"].cpu(), grads, transformer.params_to_numpy(state.params))
    (card_loss, card_g, card_p), (cpu_loss, cpu_g, cpu_p) = runs[False], runs[True]
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
    cpu_leaves, card_leaves = dict(tree_lib.tree_paths(cpu_p)), dict(tree_lib.tree_paths(card_p))
    out = {"loss_rel": rel(card_loss, cpu_loss),
           "grad_rel": max(rel(card_g[n], cpu_g[n]) for n in cpu_g),
           "param_rel": max(rel(torch.from_numpy(card_leaves[k]), torch.from_numpy(v))
                            for k, v in cpu_leaves.items()),
           "leaves": len(cpu_leaves)}
    assert max(out["loss_rel"], out["grad_rel"], out["param_rel"]) <= LM_CARD_CPU_REL, (
        f"phase 3i card vs CPU {arch}: {out}")
    return out


def drive_lm_training(dev) -> dict:
    """Phase 3i: the LM stack's training half (`launch/train.py` over
    `loss_fn`, remat and the in-place AdamW) on the card; see the module
    docstring, i."""
    from repro_torch.configs import registry
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = {LM_QWEN: lm_train_qwen(dev)}
    out[LM_QWEN]["s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["gossip"] = lm_train_gossip(dev)
    out["gossip"]["s"] = time.perf_counter() - t0
    out["reduced"] = {
        LM_QWEN: (f"none of width or depth (40 of 40 layers); batch {LM_TRAIN_BATCH} x "
                  f"{LM_TRAIN_SEQ} tokens, train_4k's global batch of 256 cut to "
                  f"{LM_TRAIN_BATCH}; {LM_TRAIN_WARMUP + LM_TRAIN_TIMED + LM_TRAIN_PROFILED} steps"),
        "gossip": "none: the reference test's reduced() config",
        "card_vs_cpu": "reduced()"}
    t0 = time.perf_counter()
    out["card_vs_cpu"] = {a: lm_train_card_vs_cpu(a, dev) for a in registry.ARCH_IDS}
    out["card_vs_cpu_s"] = time.perf_counter() - t0
    return out


def lm_phases() -> int:
    """``--lm-phases``: phases 3h and 3i, each with every launch count set
    to 0 just before it and read just after (none of the port's kernels
    runs on the LM paths); prints their lines."""
    from repro_torch import device as device_lib
    from repro_torch.kernels import ops
    dev = device_lib.resolve("cuda")
    for phase, name, title, drive in (("3h", "lm_serving", "LM serving", drive_lm_serving),
                                      ("3i", "lm_training", "LM training", drive_lm_training)):
        t0 = time.perf_counter()
        for kern in ops.KERNELS:
            kern.launches = 0
        out = drive(dev)
        out["kernel_launches"] = sum(kern.launches for kern in ops.KERNELS)
        assert out["kernel_launches"] == 0, f"phase {phase} launched one of the port's kernels"
        out["s"] = time.perf_counter() - t0
        log(f"phase {phase} {title}: {out['s']} s")
        log(name, json.dumps(out))
        del out
        torch.cuda.empty_cache()
    return 0


def lm_phases_in_child() -> None:
    """Phases 3h and 3i in a child process, right after phase 2, while this
    process holds almost nothing on the card: phase 3i takes ~69 GB of the
    card's 85, and phases 3a-3g keep ~16 GB for phase 4's timing. The
    child's own profiler sessions (3h's, and 3i's of ~100,000 kernels)
    leave this process's first one to phase 3f, whose trace must hold a
    kernel event for every dispatch. The child's lines are relayed; its
    failure fails the script."""
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--lm-phases"],
                         capture_output=True, text=True, timeout=900)
    for line in res.stdout.splitlines():
        log(line)
    assert res.returncode == 0, f"phases 3h/3i failed:\n{res.stderr[-6000:]}"


# ------------------------------------------------------------- e2e turns
def e2e_probe(root: pathlib.Path) -> dict:
    """One turn of ``--e2e-turns`` on the `repro_torch` of the checkout in
    ``root``, with tracing and telemetry off: phase 3a's pruned serving
    after the ingests (requests/s over N_PRUNED requests, the median of
    E2E_SERVES after a warm one), and the median epoch seconds, the first
    epoch left out, of a DP `fit` (σ=1, C=0.5) and of phase 3e's `nan` +
    screen and screen + trim runs."""
    sys.path.insert(0, str(root / "src"))
    import repro_torch
    assert pathlib.Path(repro_torch.__file__).resolve().is_relative_to(root), repro_torch.__file__
    from repro_torch.core import dmf
    from repro_torch.data import synthetic_poi
    from repro_torch.privacy import audit
    from repro_torch.robustness import AttackConfig, DefenseConfig
    from repro_torch.serving import OnlineConfig, ServingConfig, ServingEngine
    dev = torch.device("cuda")
    ds = synthetic_poi.foursquare_like(reduced=False, seed=SEED)
    nbr, _, index, cfg = build_world(ds, dev)
    eng = ServingEngine(dmf.init_state(cfg, device=dev), index,
                        ServingConfig(microbatch=MICROBATCH, k=K_TOP),
                        train=ds.train, nbr=nbr, dmf_cfg=cfg, device=dev)
    eng.ingest(ds.train, OnlineConfig())
    eng.ingest(ds.test, OnlineConfig())
    ids = np.random.default_rng(SEED).integers(0, ds.n_users, N_PRUNED)
    rps = []
    for _ in range(E2E_SERVES + 1):
        eng.stats.reset()
        eng.recommend(ids)
        rps.append(eng.requests_per_sec)
    del eng
    out = {"pruned_rps": float(np.median(rps[1:]))}
    log_ = audit.observe_messages(cfg, ds.train, nbr, epochs=1, seed=0, device=dev)
    tau = float(np.quantile(np.linalg.norm(log_.gp, axis=1), 0.999) * 1.5)
    runs = {"dp": (dataclasses.replace(cfg, **DP), dict(epochs=E2E_DP_EPOCHS)),
            "nan_screen": (cfg, dict(
                epochs=BYZ_EPOCHS, attack=AttackConfig(family="nan", frac=BYZ_FRAC, seed=0),
                defense=DefenseConfig(screen=True, norm_cap=tau))),
            "screen_trim": (cfg, dict(
                epochs=BYZ_EPOCHS,
                attack=AttackConfig(family="norm_inflate", frac=BYZ_FRAC, scale=BYZ_SCALE, seed=0),
                defense=DefenseConfig(screen=True, norm_cap=tau, aggregation="trim",
                                      trim_frac=0.25)))}
    for tag, (c, kw) in runs.items():
        _, ep = stamped_fit(dmf.fit, c, ds.train, nbr, on_nonfinite="halt", device=dev, **kw)
        out[f"{tag}_epoch_s"] = float(np.median(ep[1:]))
    return out


def e2e_turns(other: pathlib.Path) -> dict:
    """``--e2e-turns DIR``: `e2e_probe` in a process of its own a turn,
    on the checkout in DIR and on this one in the order E2E_ORDER, so that
    the host clock's drift falls on both; each turn's numbers and each
    side's medians."""
    runs: dict[str, list] = {"other": [], "this": []}
    for who in E2E_ORDER:
        root = other if who == "other" else ROOT
        res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--e2e-probe",
                              str(root)], capture_output=True, text=True, timeout=900)
        assert res.returncode == 0, f"e2e probe on {root} failed:\n{res.stderr[-4000:]}"
        runs[who].append(json.loads(res.stdout.strip().splitlines()[-1]))
    return {"other": str(other), "order": E2E_ORDER, "runs": runs,
            "median": {who: {k: float(np.median([r[k] for r in rows])) for k in rows[0]}
                       for who, rows in runs.items()}}


# ------------------------------------------------------------------- timing
def device_ms(fn, n: int) -> float:
    """Device milliseconds per call, back to back: the stream is held by a
    sleep kernel while the host queues all n calls, so host launch gaps do
    not count."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(4e9 * host_s) + 2_000_000)   # ≥ 2x the enqueue time at ≤2 GHz
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def call_ms(fn, n: int) -> float:
    """Milliseconds per call as a caller sees it, launch overhead included."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_b, t_f = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def main_shapes(run, tl, bl, tr) -> dict:
    """The main paths' inputs of the top-k kernels at their timed shapes:
    kernel 1 on one serving microbatch of pruned requests (R=64, Cw=384,
    K=10) and one tiled microbatch (the million shape, R=128, Cw=128, K=8);
    kernel 4 on the trained MF state (R=6,524) and on one DMF request (R=1);
    kernel 2 on the serving microbatch's whole rows (and their ids) and at
    the evaluate shape (every user of the DP-trained state: on V = P + Q,
    on P and Q, and the second 1,024-user chunk of P and Q); kernel 5 on the
    serving microbatch's slabs and reading the engine's state in place (V,
    and P and Q); kernel 6 on the tiled microbatch; kernel 9 on its two
    shapes."""
    eng = run["engine"]
    dev = eng.device
    uids = torch.as_tensor(run["after_pruned"][0][:MICROBATCH], device=dev)
    rows = uids[:, None]
    cand = eng._bucket_items[eng._user_bucket[uids]]
    safe = cand.clamp_min(0).long()
    st = tl["store"]
    ids = torch.as_tensor(tl["int8"][0][:M_MICROBATCH], device=st.device)
    mcand = torch.as_tensor(st.index.bucket_items, device=st.device)[
        torch.as_tensor(st.index.user_bucket, device=st.device).long()[ids]]
    mask, mf, dmf_st = bl["train_mask"], bl["MF"], bl["dmf_state"]
    u0 = int(bl["per_request"][0][0])
    dp = tr["dp_on"]["fit"].state
    u = eng.state.U[uids]
    return {"serving": (u, eng.V[rows, safe], cand, eng.seen[rows, safe]),
            "tiled": (st.U[ids], st.slab[ids], mcand, st.seen[ids]),
            "MF": (mf.U, mf.V, mask),
            "per_request": (dmf_st.U[u0][None], (dmf_st.P[u0] + dmf_st.Q[u0]).contiguous(),
                            mask[u0][None]),
            "dense": (u, eng.V[uids], eng.seen[uids]), "serving_uids": uids,
            "evaluate": (dp.U, dp.P + dp.Q, mask),
            "evaluate_pq": (dp.U, dp.P, mask, dp.Q),
            "chunk": tuple(x[EVAL_CHUNK:2 * EVAL_CHUNK] for x in (dp.U, dp.P, mask, dp.Q)),
            "slab": (u, eng.V[uids], cand, eng.seen[uids]),
            "rows": {form: ((uids, eng.state.U, V, eng.seen, eng._user_bucket, eng._bucket_items), Q)
                     for form, V, Q in (("V", eng.V, None),
                                        ("P+Q", eng.state.P, eng.state.Q))},
            "grads": [(sx, hp) for sx, hp, _ in bl["grads"]],
            "tiled_store": tiled_store_args(st, ids)}


def tiled_store_args(st, ids) -> dict:
    """{form: (ids, U, Vq, scale, user_bucket, bucket_items, seen)}: the
    in-place kernel 6's inputs on the store for user ids ``ids``, as the
    tiled engine passes them."""
    dev = st.device
    rest = (torch.as_tensor(st.index.user_bucket, dtype=torch.int64, device=dev),
            torch.as_tensor(st.index.bucket_items, dtype=torch.int32, device=dev), st.seen)
    return {"int8": (ids, st.U, st.q_codes, st.q_scale, *rest),
            "bf16": (ids, st.U, st.slab_bf16, None, *rest)}


def serving_specs(run, shapes) -> list[dict]:
    """Phase 4 rows of kernels 1-3 on one microbatch of the serving path's
    own inputs."""
    from repro_torch.core import dmf
    from repro_torch.kernels import ops, ref
    eng = run["engine"]
    st, dev = eng.state, eng.device
    u = shapes["dense"][0]
    uids = shapes["serving_uids"]
    # one refresh batch of the main path: test check-ins + their negatives
    ui, vj, r, conf = dmf.sample_with_negatives(
        run["test_events"], eng.index.n_items, 3, np.random.default_rng(SEED + 1))
    ui, vj = (torch.as_tensor(x[:256], device=dev) for x in (ui, vj))
    sx = (st.U[ui], st.P[ui, vj], st.Q[ui, vj],
          torch.as_tensor(r[:256], device=dev), torch.as_tensor(conf[:256], device=dev))
    cfg = eng.dmf_cfg
    hp = dict(theta=cfg.lr, alpha=cfg.alpha, beta=cfg.beta, gamma=cfg.gamma)
    K = u.shape[1]
    return [
        window_spec(*shapes["serving"], "serving microbatch"),
        dense_spec(*shapes["dense"], "serving microbatch, gathered V rows"),
        dict(dense_spec(u, eng.V, eng.seen, "serving microbatch, V rows in place",
                        rows=uids), variant="serving_rows"),
        dict(dense_spec(*shapes["dense"], "serving microbatch, today's sequence: the "
                        "gathers of U, V, seen rows, then the kernel",
                        call=lambda: ops.recommend_topk_peruser(st.U[uids], eng.V[uids],
                                                                eng.seen[uids], K_TOP)),
             variant="serving_caller_sequence"),
        dict(name="dmf_fused_step", src="dmf_update.cu",
             replaces="src/repro/kernels/dmf_update.py:61",
             kern=lambda: ops.dmf_fused_step(*sx, **hp),
             plain=lambda: ref.dmf_fused_step_ref(*sx, *hp.values()), lib=None,
             hold=lambda got: hold_step(got, ref.dmf_fused_step_ref(*sx, *hp.values())),
             nbytes=sum(x.nbytes for x in sx) + 3 * sx[0].nbytes + 4,
             flops=256 * (12 * K + 5), shape=f"B=256 K={K}"),
    ]


def window_spec(u, vw, cand, seen_w, where: str) -> dict:
    """Kernel 1's row on (R, Cw, K) fp32 windows."""
    from repro_torch.kernels import ops, ref
    R, K = u.shape

    def einsum_topk_window():
        s = torch.einsum("rk,rck->rc", u, vw).masked_fill((cand < 0) | (seen_w != 0), ref.NEG_INF)
        return torch.topk(s, K_TOP, dim=1)

    live_w = int(((cand >= 0) & (seen_w == 0)).sum())
    return dict(name="serve_topk_window", src="serve_topk.cu",
                replaces="src/repro/kernels/serve_topk.py:122",
                kern=lambda: ops.serve_topk_window(u, vw, cand, seen_w, K_TOP),
                plain=lambda: ref.serve_topk_window_ref(u, vw, cand, seen_w, K_TOP),
                lib=einsum_topk_window,
                hold=lambda got: hold_window("serve_topk_window", got, u, vw, cand, seen_w, K_TOP),
                nbytes=u.nbytes + cand.nbytes + seen_w.nbytes + live_w * K * 4 + R * K_TOP * 8,
                flops=2 * live_w * K, shape=f"{where}: R={R} Cw={cand.shape[1]} K={K} k={K_TOP}")


def dense_spec(u, V, mask, where: str, Q=None, rows=None, call=None) -> dict:
    """Kernel 2's row: U (R, K) over per-user item rows V (R, J, K), or
    reading rows ``rows`` of V (and of Q: v = p + q) and of the mask in
    place. The bound counts the rows read once (P and Q both, through Q),
    the library call one `einsum` + `topk` on the same rows (the gather and
    the add included). ``call`` times a caller's whole sequence instead of
    the kernel (same function, same bound)."""
    from repro_torch.kernels import ops, ref
    R, K = u.shape
    idx = rows.long() if rows is not None else slice(None)

    def rows_of():
        return (V[idx] if Q is None else V[idx] + Q[idx]), mask[idx]

    def einsum_topk_dense():
        v, m = rows_of()
        s = torch.einsum("rk,rjk->rj", u, v).masked_fill(m != 0, ref.NEG_INF)
        return torch.topk(s, K_TOP, dim=1)

    live_d = int((mask[idx] == 0).sum())
    return dict(name="recommend_topk_peruser", src="topk_scores.cu",
                replaces="src/repro/kernels/topk_scores.py:68",
                kern=call or (lambda: ops.recommend_topk_peruser(u, V, mask, K_TOP, Q=Q,
                                                                rows=rows)),
                plain=lambda: ref.topk_scores_peruser_ref(u, *rows_of(), K_TOP),
                lib=einsum_topk_dense,
                hold=lambda got: hold_dense("recommend_topk_peruser", got, u, *rows_of(), K_TOP),
                nbytes=(u.nbytes + R * V.shape[1] + live_d * K * 4 * (1 if Q is None else 2)
                        + (0 if rows is None else rows.nbytes) + R * K_TOP * 8),
                flops=live_d * K * (2 if Q is None else 3),
                shape=f"{where}: R={R} J={V.shape[1]} K={K} k={K_TOP}")


def tiled_specs(tl, shapes) -> list[dict]:
    """Phase 4 rows of kernel 5 on one microbatch of the serving path's
    pruned requests (their whole (64, 3,197, 10) item rows) and of kernel 6
    in both forms on one microbatch of the tiled path's requests (the
    million shape, R=128, Cw=128, K=8)."""
    from repro_torch.kernels import ops, ref
    u, v_rows, cand, seen = shapes["slab"]
    rows = torch.arange(MICROBATCH, device=u.device)[:, None]
    safe = cand.clamp_min(0).long()
    R, J, K = v_rows.shape

    def gather_einsum_topk():
        s = torch.einsum("rk,rck->rc", u, v_rows[rows, safe])
        s = s.masked_fill((cand < 0) | (seen[rows, safe] != 0), ref.NEG_INF)
        return torch.topk(s, K_TOP, dim=1)

    valid = int((cand >= 0).sum())
    live = int(((cand >= 0) & (seen[rows, safe] == 0)).sum())
    specs = [dict(name="serve_topk", src="serve_topk.cu",
                  replaces="src/repro/kernels/serve_topk.py:64",
                  kern=lambda: ops.serve_topk(u, v_rows, cand, seen, K_TOP),
                  plain=lambda: ref.serve_topk_ref(u, v_rows, cand, seen, K_TOP),
                  lib=gather_einsum_topk,
                  hold=lambda got: hold_slab("serve_topk", got, u, v_rows, cand, seen, K_TOP),
                  nbytes=u.nbytes + cand.nbytes + valid + live * K * 4 + R * K_TOP * 8,
                  flops=2 * live * K,
                  shape=f"R={R} J={J} Cw={cand.shape[1]} K={K} k={K_TOP}")]

    specs.append(dict(window_spec(*shapes["tiled"], "tiled fp32"), variant="tiled_shape"))
    return specs + rows_specs(shapes) + quant_specs(shapes)


def rows_specs(shapes) -> list[dict]:
    """Phase 4 rows of kernel 5 reading the serving engine's state in place
    at the serving microbatch (R=64, Cw=384, K=10): on V (the pruned
    dispatch's) and through P and Q (`serve_microbatch`'s), each beside the
    parent's sequence (the gathers, with Q the add, then kernel 1). Bounds
    count what the function must read: the ids, and once for each distinct
    user of the microbatch its u, bucket entry, the seen bits of its valid
    candidates and its live rows (of V, or of P and Q), and once for each
    distinct bucket its row of ids; the library call gathers, adds and
    runs one `einsum` + `topk` on the engine's rows."""
    from repro_torch.kernels import ops, ref
    specs = []
    for form, (args, Q) in shapes["rows"].items():
        ids, U, V, seen, user_bucket, bucket_items = args
        u, win, cand, sw = gathered_rows(*args, Q=Q)
        R, Cw = cand.shape
        K = U.shape[1]
        live = int(((cand >= 0) & (sw == 0)).sum())
        users = torch.unique(ids)
        buckets = torch.unique(user_bucket[users])
        _, _, ucand, usw = gathered_rows(users, *args[1:])
        per_row = K * 4 * (1 if Q is None else 2)
        nbytes = (ids.nbytes + users.numel() * (K * 4 + 8) + int((ucand >= 0).sum())
                  + int(((ucand >= 0) & (usw == 0)).sum()) * per_row
                  + buckets.numel() * Cw * 4 + R * K_TOP * 8)
        flops = live * K * (2 if Q is None else 3)

        def gather_einsum_topk(args=args, Q=Q):
            u_, w, c, s_ = gathered_rows(*args, Q=Q)
            sc = torch.einsum("rk,rck->rc", u_, w).masked_fill((c < 0) | (s_ != 0), ref.NEG_INF)
            return torch.topk(sc, K_TOP, dim=1)

        where = f"R={R} Cw={Cw} K={K} k={K_TOP}"
        common = dict(name="serve_topk_rows", src="serve_topk.cu",
                      replaces="src/repro/kernels/serve_topk.py:64",
                      plain=functools.partial(ref.serve_topk_rows_ref, *args, K_TOP, Q=Q),
                      lib=gather_einsum_topk,
                      hold=functools.partial(hold_window, f"kernel 5 in place, {form}", U=u,
                                             Vw=win, cand=cand, seen=sw, k=K_TOP),
                      nbytes=nbytes, flops=flops)
        what = "the engine's V" if Q is None else "the engine's P and Q"
        tag = "" if Q is None else "pq_"
        specs.append(dict(common, variant=form,
                          kern=functools.partial(ops.serve_topk_rows, *args, K_TOP, Q=Q),
                          shape=f"in place on {what}, {where}"))
        specs.append(dict(common, variant=f"{tag}parent_sequence",
                          kern=lambda args=args, Q=Q: ops.serve_topk_window(
                              *gathered_rows(*args, Q=Q), K_TOP),
                          shape=f"the parent's sequence on {what}: the gathers"
                                f"{'' if Q is None else ', the add'}, then kernel 1, {where}"))
    specs[0].pop("variant")
    return specs


def quant_specs(shapes) -> list[dict]:
    """Phase 4 rows of kernel 6 on one microbatch of the tiled path's
    requests (the million shape, R=128, Cw=128, K=8), int8 and bf16: the
    pre-gathered form on the gathered windows, the in-place form on the
    store (the tiled dispatch's), and the parent's sequence, the six
    gathers then the pre-gathered kernel. Bounds count what each form must
    read: the gathered windows' live rows, resp. the ids, and once for
    each distinct user or bucket of the microbatch the user's u, scale,
    bucket entry, seen row and live code rows and the bucket's row."""
    from repro_torch.kernels import ops, ref
    specs = []
    for form, args in shapes["tiled_store"].items():
        ids, U, Vq, scale = args[:4]
        gu, gq, gs, gc, gsw = gathered(*args)
        R, Cw = gc.shape
        K = gu.shape[1]
        live = int(((gc >= 0) & (gsw == 0)).sum())
        rows = live * K * Vq.element_size()
        out = R * K_TOP * 8

        def dequant_einsum_topk(gu=gu, gq=gq, gs=gs, gc=gc, gsw=gsw):
            sc = torch.einsum("rk,rck->rc", gu, gq.float() * gs[:, None, None])
            return torch.topk(sc.masked_fill((gc < 0) | (gsw != 0), ref.NEG_INF), K_TOP, dim=1)

        def gather_dequant_einsum_topk(args=args):
            return dequant_einsum_topk(*gathered(*args))

        where = f"{form}: R={R} Cw={Cw} K={K} k={K_TOP}"
        hold = functools.partial(hold_quant, f"kernel 6 {form}", U=gu, Vq=gq, scale=gs, cand=gc,
                                 seen_w=gsw, k=K_TOP)
        specs.append(dict(
            name="serve_topk_window_quant", src="serve_topk.cu", variant=form,
            replaces="src/repro/kernels/serve_topk.py:184",
            kern=functools.partial(ops.serve_topk_window_quant, gu, gq, gs, gc, gsw, K_TOP),
            plain=functools.partial(ref.serve_topk_window_quant_ref, gu, gq, gs, gc, gsw, K_TOP),
            lib=dequant_einsum_topk, hold=hold,
            nbytes=gu.nbytes + gc.nbytes + gsw.nbytes + gs.nbytes + rows + out,
            flops=3 * live * K,                        # dequantizing multiply, then FMA
            shape=f"pre-gathered windows, {where}"))
        # in place, requests of one user share its rows and users of one
        # bucket its candidate ids: each distinct row is read once
        users = torch.unique(ids)
        buckets = torch.unique(args[4][users])
        _, _, _, uc, usw = gathered(users, *args[1:])
        users_live = int(((uc >= 0) & (usw == 0)).sum())
        in_place = (ids.nbytes + buckets.numel() * Cw * 4 + out
                    + users_live * K * Vq.element_size()
                    + users.numel() * (K * 4 + 8 + Cw + (0 if scale is None else 4)))
        for variant, call, what in (
                (form, functools.partial(ops.serve_topk_tiled_quant, *args, K_TOP),
                 "the store read in place"),
                (f"{form}_parent_sequence",
                 lambda args=args: ops.serve_topk_window_quant(*gathered(*args), K_TOP),
                 "the parent's sequence: six gathers, then the pre-gathered kernel")):
            specs.append(dict(
                name="serve_topk_tiled_quant", src="serve_topk.cu", variant=variant,
                replaces="src/repro/kernels/serve_topk.py:184",
                kern=call,
                plain=functools.partial(ref.serve_topk_tiled_quant_ref, *args, K_TOP),
                lib=gather_dequant_einsum_topk, hold=hold, nbytes=in_place, flops=3 * live * K,
                shape=f"{what}, {where}"))
    return specs


def training_specs(tr, mb, shapes) -> list[dict]:
    """Phase 4 rows of kernels 7 and 8, the noise stream and kernel 2 at
    the evaluate shape, on the training path's own inputs: one DP batch of
    epoch 0's stream gathered from the DP-trained state, its raw message,
    the epoch's (nb·B, K) noise block and all users of that state."""
    from repro_torch.kernels import dp_noise, ops, ref
    c, sx, z, seed = mb["cfg"], mb["sx"], mb["z"], mb["seed"]
    hp = dict(theta=c.lr, alpha=c.alpha, beta=c.beta, gamma=c.gamma)
    std = c.dp_sigma * c.dp_clip
    B, K = z.shape
    rid_b = mb["rid"][:B]
    raw = ops.dmf_fused_step(*sx, **hp)[1]
    block_rid = mb["rid"]
    N = block_rid.shape[0]

    def hold_draws(got):
        err = float((got - dp_noise.gauss_counter_ref(seed, block_rid, K)).abs().max())
        assert err <= DRAW_TOL, f"gauss_counter: {err} > {DRAW_TOL}"
        return err

    def hold_msgs(got):
        err = float((got - ref.dp_clip_noise_ref(raw, rid_b, seed, c.dp_clip, std)).abs().max())
        assert err <= DRAW_TOL, f"dp_clip_noise: {err} > {DRAW_TOL}"
        return err

    draw_ops = 60     # two lowbias32 words, two uniforms, log, cos, sqrt, products
    return [
        dict(name="dmf_fused_step_dp", src="dmf_update.cu",
             replaces="src/repro/kernels/dmf_update.py:92",
             kern=lambda: ops.dmf_fused_step_dp(*sx, z, **hp, clip=c.dp_clip),
             plain=lambda: ref.dmf_fused_step_dp_ref(*sx, z, *hp.values(), c.dp_clip),
             lib=None,
             hold=lambda got: hold_step(got, ref.dmf_fused_step_dp_ref(*sx, z, *hp.values(),
                                                                       c.dp_clip)),
             nbytes=sum(x.nbytes for x in sx) + z.nbytes + 3 * z.nbytes + 4,
             flops=B * (15 * K + 8), shape=f"B={B} K={K}"),
        dict(name="dp_clip_noise", src="dp_noise.cu",
             replaces="src/repro/kernels/dp_noise.py:98",
             kern=lambda: ops.dp_clip_noise(raw, rid_b, seed, clip=c.dp_clip, noise_std=std),
             plain=lambda: ref.dp_clip_noise_ref(raw, rid_b, seed, c.dp_clip, std),
             lib=None, hold=hold_msgs,
             nbytes=raw.nbytes + rid_b.nbytes + raw.nbytes, flops=B * K * (draw_ops + 6),
             shape=f"B={B} K={K}"),
        dict(name="gauss_counter", src="dp_noise.cu",
             replaces="src/repro/kernels/dp_noise.py:56 (the stream of :98)",
             kern=lambda: ops.gauss_counter(seed, block_rid, K),
             plain=lambda: dp_noise.gauss_counter_ref(seed, block_rid, K),
             lib=None, hold=hold_draws,
             nbytes=block_rid.nbytes + N * K * 4, flops=N * K * draw_ops,
             shape=f"N={N} n_cols={K}"),
        dict(dense_spec(*shapes["evaluate"], "evaluate, on V"), variant="evaluate_shape"),
        dict(evaluate_pq_spec(*shapes["evaluate_pq"], "evaluate, P and Q in place"),
             variant="evaluate_pq"),
        dict(evaluate_pq_spec(*shapes["chunk"], "evaluate, a 1,024-user chunk of P and Q"),
             variant="evaluate_chunk"),
        dict(evaluate_pq_spec(*shapes["evaluate_pq"], "evaluate, today's sequence: P + Q, "
                              "then the kernel", sequence=True),
             variant="evaluate_caller_sequence"),
    ]


def evaluate_pq_spec(U, P, mask, Q, where: str, sequence: bool = False) -> dict:
    """Kernel 2 at the evaluate shape through P and Q (the bound counts the
    P and Q rows), or, with ``sequence``, the materializing caller's
    ``P + Q`` then the kernel on V."""
    from repro_torch.kernels import ops
    call = (lambda: ops.recommend_topk_peruser(U, P + Q, mask, K_TOP)) if sequence else None
    return dense_spec(U, P, mask, where, Q=Q, call=call)


def baseline_specs(bl, shapes) -> list[dict]:
    """Phase 4 rows of kernels 4, 9 and 10 on the baselines path's own
    inputs: kernel 4 on the trained MF state at full width (R=6,524) and on
    one DMF request (R=1); kernel 9 on the training minibatch (B=256, K=10)
    and at the micro-bench shape (B=2048, K=16); kernel 10 on the walk
    matrix times every learner's P (I=6,524, F=31,970; MIX_TIMED kernel
    calls and MIX_PLAIN_TIMED plain and library products a timed run) and
    at the micro-bench shape
    (512 × 512 @ 512 × 1024)."""
    from repro_torch.kernels import gossip_mix, ops, ref

    def topk_spec(U, V, m, where):
        R, K = U.shape
        live = int((m == 0).sum())

        def matmul_topk():
            return torch.topk((U @ V.T).masked_fill(m, ref.NEG_INF), K_TOP, dim=1)

        return dict(name="recommend_topk", src="topk_scores.cu",
                    replaces="src/repro/kernels/topk_scores.py:51",
                    kern=lambda: ops.recommend_topk(U, V, m, K_TOP),
                    plain=lambda: ref.topk_scores_ref(U, V, m, K_TOP), lib=matmul_topk,
                    hold=lambda got: hold_shared("recommend_topk", got, U, V, m, K_TOP),
                    nbytes=U.nbytes + V.nbytes + m.nbytes + R * K_TOP * 8, flops=2 * live * K,
                    shape=f"{where}: R={R} J={V.shape[0]} K={K} k={K_TOP}")

    def grads_spec(sx, hp, where):
        B, K = sx[0].shape
        return dict(name="dmf_grads", src="dmf_update.cu",
                    replaces="src/repro/kernels/dmf_update.py:22",
                    kern=lambda: ops.dmf_grads(*sx, **hp),
                    plain=lambda: ref.dmf_grads_ref(*sx, *hp.values()), lib=None,
                    hold=lambda got: hold_grads(got, sx, hp),
                    nbytes=sum(x.nbytes for x in sx) + 3 * sx[0].nbytes, flops=B * (12 * K + 2),
                    shape=f"{where}: B={B} K={K}")

    def mix_spec(M, X, where, n, plain_n):
        I, F = X.shape
        nnz = int((M != 0).sum())
        sparse_ms, sparse_by = bound(nnz * 12 + 2 * X.nbytes, 2 * nnz * F)
        timed_extra = {}
        if gossip_mix.counts_needed(I, F):
            # the count with its readback, and the sparse route's CSR fill and
            # product alone: a call of the wrapper blocks the host on the
            # readback, so its `ms` holds that host round trip too
            _, _, row_ptr = gossip_mix._count("gossip_mix_op", M, X)
            Y = torch.empty_like(X)
            timed_extra = {
                "count_ms": lambda: gossip_mix._count("gossip_mix_op", M, X),
                "fill_product_ms": lambda: gossip_mix._sparse_product(
                    "gossip_mix_op", M, X, Y, nnz, row_ptr)}
        return dict(name="gossip_mix_op", src="gossip_mix.cu",
                    replaces="src/repro/kernels/gossip_mix.py:22",
                    kern=lambda: ops.gossip_mix_op(M, X),
                    plain=lambda: ref.gossip_mix_ref(M, X), lib=lambda: torch.matmul(M, X),
                    hold=lambda got: hold_mix("gossip_mix_op", got, M, X),
                    # the products this M needs (its nonzeros'); M, X read and Y written once
                    nbytes=M.nbytes + 2 * X.nbytes, flops=2 * nnz * F, n=n, plain_n=plain_n,
                    shape=f"{where}: I={I} F={F}",
                    extra={"nnz_M": nnz, "dense_product_bound_ms": bound(0, 2 * I * I * F)[0],
                           "sparse_product_bound_ms": sparse_ms,
                           "sparse_product_bound_by": sparse_by},
                    mix_route=lambda: ops.gossip_mix_op.last_route, timed_extra=timed_extra)

    Md, X = bl["mix_in"]
    rng = np.random.default_rng(0)
    bm = torch.as_tensor(rng.normal(size=(512, 512)).astype(np.float32), device=Md.device)
    bx = torch.as_tensor(rng.normal(size=(512, 1024)).astype(np.float32), device=Md.device)
    (sx, hp, _), (bsx, bhp, _) = bl["grads"]
    return [
        topk_spec(*shapes["MF"], "MF, all users"),
        dict(topk_spec(*shapes["per_request"], "one DMF request"), variant="per_request"),
        grads_spec(sx, hp, "training minibatch"),
        dict(grads_spec(bsx, bhp, "micro-bench"), variant="bench_shape"),
        mix_spec(Md, X, "walk matrix x every learner's P", MIX_TIMED, MIX_PLAIN_TIMED),
        dict(mix_spec(bm, bx, "micro-bench", 200, 30), variant="bench_shape"),
    ]


def time_spec(spec, errs, launches) -> dict:
    """One row of the kernels line: hold the kernel on these inputs, then
    time it, its plain version and the library call (``n`` calls a timed
    run for the kernel, ``plain_n`` for the others; 200 and 30 unless the
    spec says)."""
    name, lib = spec["name"], spec["lib"]
    n, plain_n = spec.get("n", 200), spec.get("plain_n", 30)
    errs[name] = max(errs.get(name, 0.0), spec["hold"](spec["kern"]()))
    if "mix_route" in spec:          # the route kernel 10's wrapper took on these inputs
        spec.setdefault("extra", {})["mix_route"] = spec["mix_route"]()
        spec["extra"]["ms_holds_host_readback"] = "count_ms" in spec.get("timed_extra", {})
    for key, fn in spec.get("timed_extra", {}).items():   # a part of the call, timed alone
        spec.setdefault("extra", {})[key] = device_ms(fn, n)
    bound_ms, bound_by = bound(spec["nbytes"], spec["flops"])
    by_path = {path: counts.get(name, 0) for path, counts in launches.items()}
    return {
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{spec['src']}", "replaces": spec["replaces"],
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": errs[name], "shape": spec["shape"],
        "ms": (ms := device_ms(spec["kern"], n)), "kernel_ms": ms,
        "call_ms": call_ms(spec["kern"], n), "plain_ms": device_ms(spec["plain"], plain_n),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": device_ms(lib, plain_n) if lib is not None else None,
        "bytes": int(spec["nbytes"]), "flops": int(spec["flops"]), "timed_calls": n,
        **spec.get("extra", {}),
    }


def brief(layout: dict) -> str:
    keys = ("many", "cluster", "threads", "blocks", "warps", "stages", "rpb", "slots", "tile",
            "rows")
    return " ".join(f"{k}={layout[k]}" for k in keys if k in layout)


def peruser_layouts(R: int, J: int, K: int, fused: bool, n_sms: int) -> list:
    """[(name, layout)] of kernel 2 at R requests: the wrapper's choice,
    the few-users form on clusters of 1, 2 and 4 blocks (16 warps a user)
    and the many-users form (a block of 4 warps a user)."""
    from repro_torch.kernels import topk_scores
    out = [("wrapper", topk_scores.peruser_layout(R, J, K, K_TOP, n_sms, fused))]
    for cluster in (1, 2, 4):
        out.append((f"few users, cluster {cluster}", topk_scores.rows_layout(
            J, K, K_TOP, cluster, 16 // cluster, topk_scores.RING_STAGES, fused, R)))
    out.append(("many users", topk_scores.peruser_layout(R, J, K, K_TOP, 1, fused)))
    return out


def kernel_forms(shapes) -> dict[str, list]:
    """[(form, call)] at the main shapes of kernels 1, 2, 4, 5 (in place), 6
    and 9: the wrapper's layout first, then other layouts (and for kernel
    5 the P and Q, pre-gathered and kernel 1 forms of the same slates),
    then the wrapper's layout scoring without merging (its outputs are
    list checksums, not a slate). Every other form gives the wrapper's
    result bit for bit."""
    from repro_torch.kernels import dmf_update, ops, serve_topk, topk_scores
    out = {}
    for key, (U, V, m, Q) in (("kernel 2 R=64", (*shapes["dense"], None)),
                              ("kernel 2 R=1,024 P+Q", shapes["chunk"]),
                              ("kernel 2 R=6,524", (*shapes["evaluate"], None)),
                              ("kernel 2 R=6,524 P+Q", shapes["evaluate_pq"])):
        R, K = U.shape
        layouts = peruser_layouts(R, V.shape[1], K, Q is not None,
                                  topk_scores._n_sms(U.device.index))
        out[key] = [(f"{name} ({brief(lay)})", functools.partial(
            topk_scores.peruser_on_layout, U, V, m, K_TOP, lay, Q=Q)) for name, lay in layouts]
        out[key].append(("wrapper, score only", functools.partial(
            topk_scores.peruser_on_layout, U, V, m, K_TOP, layouts[0][1], Q=Q, merge=False)))
    for key in ("MF", "per_request"):
        U, V, m = shapes[key]
        R, K = U.shape
        J = V.shape[0]
        n_sms = topk_scores._n_sms(U.device.index)
        own = topk_scores.shared_layout(R, J, K, K_TOP, n_sms)
        layouts = [("wrapper", own)]
        if own["many"]:
            layouts.append(("few users", topk_scores.shared_layout(R, J, K, K_TOP, n_sms=10**9)))
        else:
            for name, lay in peruser_layouts(R, J, K, False, n_sms)[1:4]:
                layouts.append((name, dict(many=False, threads=lay["threads"],
                                           blocks=lay["blocks"], slots=lay["slots"],
                                           tile=lay["stages"], cluster=lay["cluster"])))
            layouts.append(("many users", topk_scores.shared_layout(R, J, K, K_TOP, n_sms=1)))
        out[key] = [(f"{name} ({brief(lay)})", functools.partial(
            topk_scores.shared_on_layout, U, V, m, K_TOP, lay)) for name, lay in layouts]
        out[key].append(("wrapper, score only", functools.partial(
            topk_scores.shared_on_layout, U, V, m, K_TOP, own, merge=False)))
    for key, extra in (("serving", ((1, 1), (1, 4), (6, 1), (12, 1))),
                       ("tiled", ((1, 1), (1, 8), (2, 1), (4, 1)))):
        u, vw, cand, seen_w = shapes[key]
        R, Cw = cand.shape
        own = serve_topk.window_layout(R, Cw, K_TOP)
        layouts = [("wrapper", own)] + [
            (f"{w} warps x {rpb} requests a block",
             dict(warps=w, rpb=rpb, slots=serve_topk.slots_for(K_TOP, -(-Cw // (32 * w)))))
            for w, rpb in extra]
        out[key] = [(f"{name} ({brief(lay)})", functools.partial(
            serve_topk.window_on_layout, u, vw, cand, seen_w, K_TOP, lay)) for name, lay in layouts]
        out[key].append(("wrapper, score only", functools.partial(
            serve_topk.window_on_layout, u, vw, cand, seen_w, K_TOP, own, merge=False)))
    args, _ = shapes["rows"]["V"]
    pq_args, Q = shapes["rows"]["P+Q"]
    R, Cw = args[0].shape[0], args[5].shape[1]
    own = serve_topk.window_layout(R, Cw, K_TOP)
    layouts = [("wrapper", own)] + [
        (f"{w} warps x {rpb} requests a block",
         dict(warps=w, rpb=rpb, slots=serve_topk.slots_for(K_TOP, -(-Cw // (32 * w)))))
        for w, rpb in ((1, 1), (1, 4), (6, 1), (12, 1))]
    key = "kernel 5 in place R=64"
    out[key] = [(f"{name} ({brief(lay)})", functools.partial(
        serve_topk.rows_on_layout, *args, K_TOP, lay)) for name, lay in layouts]
    out[key] += [
        ("through P and Q", functools.partial(ops.serve_topk_rows, *pq_args, K_TOP, Q=Q)),
        ("pre-gathered slab form on the requests' slabs",
         functools.partial(ops.serve_topk, *shapes["slab"], K_TOP)),
        ("kernel 1 on the gathered windows",
         functools.partial(ops.serve_topk_window, *shapes["serving"], K_TOP)),
        ("wrapper, score only", functools.partial(serve_topk.rows_on_layout, *args, K_TOP, own,
                                                  merge=False))]
    for sx, hp in shapes["grads"]:
        B, K = sx[0].shape
        own = dmf_update.grads_layout(B, K)
        layouts = [("wrapper", own)] + [(f"{rows} rows a block", dict(rows=rows))
                                        for rows in (16, 64, 128) if rows != own["rows"]]
        out[f"kernel 9 B={B} K={K}"] = [(f"{name} ({brief(lay)})", functools.partial(
            dmf_update.grads_on_layout, *sx, *hp.values(), lay)) for name, lay in layouts]
    for form, args in shapes["tiled_store"].items():
        R, Cw = args[0].shape[0], args[5].shape[1]
        own = serve_topk.window_layout(R, Cw, K_TOP)
        layouts = [("wrapper", own)] + [
            (f"{w} warps x {rpb} requests a block",
             dict(warps=w, rpb=rpb, slots=serve_topk.slots_for(K_TOP, -(-Cw // (32 * w)))))
            for w, rpb in ((1, 1), (1, 8), (2, 1), (4, 1))]
        key = f"kernel 6 tiled {form}"
        out[key] = [(f"{name} ({brief(lay)})", functools.partial(
            serve_topk.tiled_quant_on_layout, *args, K_TOP, lay)) for name, lay in layouts]
        out[key].append(("pre-gathered form on the gathered windows", functools.partial(
            ops.serve_topk_window_quant, *gathered(*args), K_TOP)))
        out[key].append(("wrapper, score only", functools.partial(
            serve_topk.tiled_quant_on_layout, *args, K_TOP, own, merge=False)))
    return out


def time_forms(shapes) -> dict:
    """Each form of `kernel_forms`, held against the wrapper's form, then
    timed in turns in one call: every form once down the list and once back
    up (device ms a call; 200 calls a timed run, 40 at R=6,524)."""
    result = {}
    for key, forms in kernel_forms(shapes).items():
        want = forms[0][1]()
        for name, call in forms[1:]:
            if "score only" not in name:
                same_bits(f"{key} form {name} vs the wrapper's", call(), want)
        n = 40 if "6,524" in key or key == "MF" else 200
        times = {name: [] for name, _ in forms}
        for name, call in forms + forms[::-1]:
            times[name].append(device_ms(call, n))
        result[key] = times
    return result


def load_parent(parent: pathlib.Path) -> dict:
    """Build the kernel library of the checkout unpacked in ``parent`` (the
    commit before kernel 9 took 32 rows a block and kernel 5 read the
    engine's state in place; its C launches of kernels 1, 3, 5, 6 (both
    sources), 7, 8, 9 and the stream take the arguments below) and return
    callables of those kernels, each launching on this build's inputs with
    the layout the parent's wrappers chose."""
    import ctypes
    import importlib.util

    from repro_torch.kernels import build
    src = parent / "src/repro_torch/kernels"
    lib = ctypes.CDLL(str(build.build(build.BUILD_ROOT / "parent", src / "csrc")))
    def module(name):
        spec = importlib.util.spec_from_file_location(f"parent_{name}", src / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    layouts, noise = module("serve_topk"), module("dp_noise")
    ptr, i32, u32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float

    def declare(fn, argtypes):
        f = getattr(lib, fn)
        f.argtypes, f.restype = argtypes, i32
        return f
    window = declare("serve_topk_window_launch", [ptr] * 6 + [i32] * 8 + [ptr])
    slab = declare("serve_topk_launch", [ptr] * 6 + [i32] * 9 + [ptr])
    quant = declare("serve_topk_window_quant_launch", [ptr] * 7 + [i32] * 9 + [ptr])
    tiled = declare("serve_topk_tiled_quant_launch", [ptr] * 9 + [i32] * 11 + [ptr])
    stream_fn = declare("gauss_counter_launch", [ptr] * 2 + [i32] * 2 + [u32] + [i32] * 2 + [ptr])
    clip = declare("dp_clip_noise_launch", [ptr] * 3 + [i32] * 2 + [u32] + [f32] * 2 + [ptr])
    grads = declare("dmf_grads_launch", [ptr] * 8 + [i32] * 2 + [f32] * 3 + [ptr])
    step = declare("dmf_fused_step_launch", [ptr] * 10 + [i32] * 2 + [f32] * 4 + [ptr])
    step_dp = declare("dmf_fused_step_dp_launch", [ptr] * 11 + [i32] * 2 + [f32] * 5 + [ptr])
    scratch_floats = declare("dmf_step_scratch", [i32])
    stream = torch.cuda.current_stream().cuda_stream
    scratch = {}     # the parent's own step scratch, zeroed once, by batch size

    def outputs(R, k, dev):
        return (torch.empty((R, k), dtype=torch.float32, device=dev),
                torch.empty((R, k), dtype=torch.int32, device=dev))

    def lay(R, Cw, k):
        w = layouts.window_layout(R, Cw, k)
        return w["warps"], w["rpb"], w["slots"], 1

    def ok(err, what):
        assert err == 0, f"parent build: {what} launch error {err}"

    def kernel1(U, Vw, cand, seen, k):
        (R, K), Cw = U.shape, cand.shape[1]
        vals, idx = outputs(R, k, U.device)
        ok(window(U.data_ptr(), Vw.data_ptr(), cand.data_ptr(), seen.data_ptr(),
                  vals.data_ptr(), idx.data_ptr(), R, Cw, K, k, *lay(R, Cw, k), stream),
           "kernel 1")
        return vals, idx

    def kernel5(U, V, cand, seen, k):
        (R, K), J, Cw = U.shape, V.shape[1], cand.shape[1]
        vals, idx = outputs(R, k, U.device)
        ok(slab(U.data_ptr(), V.data_ptr(), cand.data_ptr(), seen.data_ptr(),
                vals.data_ptr(), idx.data_ptr(), R, J, Cw, K, k, *lay(R, Cw, k), stream),
           "kernel 5")
        return vals, idx

    def kernel6(U, Vq, scale, cand, seen, k):
        (R, K), Cw = U.shape, cand.shape[1]
        vals, idx = outputs(R, k, U.device)
        ok(quant(U.data_ptr(), Vq.data_ptr(), scale.data_ptr(), cand.data_ptr(),
                 seen.data_ptr(), vals.data_ptr(), idx.data_ptr(), R, Cw, K, k,
                 int(Vq.dtype == torch.bfloat16), *lay(R, Cw, k), stream), "kernel 6")
        return vals, idx

    def kernel6_in_place(ids, U, Vq, scale, user_bucket, bucket_items, seen, k):
        R, (I, K), cap = ids.shape[0], U.shape, bucket_items.shape[1]
        vals, idx = outputs(R, k, U.device)
        ok(tiled(ids.data_ptr(), U.data_ptr(), Vq.data_ptr(),
                 0 if scale is None else scale.data_ptr(), seen.data_ptr(),
                 user_bucket.data_ptr(), bucket_items.data_ptr(), vals.data_ptr(),
                 idx.data_ptr(), R, I, bucket_items.shape[0], cap, K, k,
                 int(Vq.dtype == torch.bfloat16), *lay(R, cap, k), stream), "kernel 6 in place")
        return vals, idx

    def kernel8a(seed, rid, n_cols):
        out = torch.empty((rid.shape[0], n_cols), dtype=torch.float32, device=rid.device)
        lay = noise.stream_layout(n_cols)
        ok(stream_fn(rid.data_ptr(), out.data_ptr(), rid.shape[0], n_cols,
                     int(seed) & 0xFFFFFFFF, lay["per"], lay["rows"], stream), "noise stream")
        return out

    def kernel8(g, rid, seed, clip_, noise_std):
        out = torch.empty_like(g)
        ok(clip(g.data_ptr(), rid.data_ptr(), out.data_ptr(), g.shape[0], g.shape[1],
                int(seed) & 0xFFFFFFFF, clip_, noise_std, stream), "kernel 8")
        return out

    def kernel9(u, p, q, r, conf, alpha, beta, gamma):
        B, K = u.shape
        gu, gp, gq = (torch.empty_like(u) for _ in range(3))
        ok(grads(u.data_ptr(), p.data_ptr(), q.data_ptr(), r.data_ptr(), conf.data_ptr(),
                 gu.data_ptr(), gp.data_ptr(), gq.data_ptr(), B, K, alpha, beta, gamma, stream),
           "kernel 9")
        return gu, gp, gq

    def kernel37(u, p, q, r, conf, theta, alpha, beta, gamma, z=None, clip_=None):
        B, K = u.shape
        du, gp, dq = (torch.empty_like(u) for _ in range(3))
        loss = torch.empty((), dtype=torch.float32, device=u.device)
        need = scratch_floats(B)
        if need and (B not in scratch):
            scratch[B] = torch.zeros(need, dtype=torch.float32, device=u.device)
        sp = scratch[B].data_ptr() if need else None
        head = (u.data_ptr(), p.data_ptr(), q.data_ptr(), r.data_ptr(), conf.data_ptr())
        tail = (du.data_ptr(), gp.data_ptr(), dq.data_ptr(), sp, loss.data_ptr(), B, K, theta,
                alpha, beta, gamma)
        if z is None:
            ok(step(*head, *tail, stream), "kernel 3")
        else:
            ok(step_dp(*head, z.data_ptr(), *tail, clip_, stream), "kernel 7")
        return du, gp, dq, loss

    return {"kernel1": kernel1, "kernel5": kernel5, "kernel6": kernel6,
            "kernel6_in_place": kernel6_in_place, "kernel8a": kernel8a, "kernel8": kernel8,
            "kernel9": kernel9, "kernel37": kernel37}


def same_bits_nan(name, got, want) -> None:
    """Equal bit for bit, NaN payloads included."""
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (
        f"{name}: not equal bit for bit")


def parent_stream_cases(dev) -> list:
    """The noise stream's cases for the parent hold, (seed, rid, n_cols):
    rids from below 2^23 to beyond (and 2^31 - 1), n_cols 1, 8, 10, 16 and
    256, N 1, 33, 28,160 (the epoch's block) and 300,000 (more rows than
    one wave of blocks covers), seeds 0, 7 and 2^31 - 1."""
    cases = []
    for N in (1, 33, 28_160, 300_000):
        rid = ((1 << 23) - N // 2 + np.arange(N)).astype(np.int32)
        rid[-1] = 2**31 - 1
        rid = torch.as_tensor(rid, device=dev)
        cases += [(seed, rid, n) for n in (1, 8, 10, 16, 256) for seed in (0, 7, 2**31 - 1)]
    return cases


def parent_quant_cases(dev, J: int) -> list:
    """Kernel 6's stores for the parent hold: phase 2's, at the serving and
    the million shape, [(form, in-place args)]."""
    rng = np.random.default_rng(SEED + 19)
    cases = []
    for R, Cw, n_items, K in ((MICROBATCH, 384, J, 10), (M_MICROBATCH, M_CELL_CAP, M_ITEMS, M_DIM)):
        cases += tiled_inputs(rng, R, Cw, n_items, K, dev)["forms"]
    return cases


def parent_step_cases() -> list:
    """Kernels 3, 7 and 9's batches for the parent hold, [(B, K)]: one
    block and several (ragged), at K 10 and 16 (fixed at build time), 8
    and 5 (at run time), 128 (too wide to stage)."""
    return [(1, 10), (100, 10), (256, 10), (300, 5), (1000, 10), (5000, 10), (256, 8),
            (1000, 16), (2048, 16), (64, 128)]


def hold_parent_build(parent: pathlib.Path, shapes, clip_cases, mb, run) -> dict:
    """Hold this build against the parent build's (`load_parent`), bit for
    bit: kernel 5 in place (on V and through P and Q, k 1/10/16, phase 2's
    states and the serving microbatch) against the parent's pruned
    dispatch (the gathers, the add, kernel 1), and every served pruned
    request of phase 3a against the parent's kernel 1 on its gathered
    window; kernels 1 and 5 pre-gathered at their main shapes; kernel 6
    pre-gathered and in place against the parent's (int8, bf16; k
    1/10/16) on phase 2's stores and the tiled microbatch; kernel 9 (its
    main shapes and `parent_step_cases`) and kernels 3 and 7 (the same
    cases, clip inf and 0.5); the noise stream on every
    `parent_stream_cases` case; kernel 8 on each clip case (g, rid, seed,
    clip, noise_std). Then time both builds in turns (parent, this, this,
    parent), the parent with its gathers where this build reads the
    engine's state in place. Returns the numbers of cases held and the
    times."""
    from repro_torch.kernels import ops
    theirs = load_parent(parent)
    dev = shapes["dense"][0].device
    J = shapes["dense"][1].shape[1]
    held = {"kernel5_in_place": 0, "kernel6": 0, "kernel9": 0, "kernels3_7": 0}
    rng = np.random.default_rng(SEED + 29)
    rows_cases = [c for I, R, n_items, Cw, K in ((200, MICROBATCH, J, 384, 10),
                                                (90, 37, 500, 128, 8))
                  for c in rows_state(rng, I, R, n_items, Cw, K, dev)]
    rows_cases += [(form, args, Q) for form, (args, Q) in shapes["rows"].items()]
    for n, (form, args, Q) in enumerate(rows_cases):
        for k in (1, K_TOP, 16):
            same_bits(f"kernel 5 in place {form} case {n} k={k}: this build vs the parent's "
                      "gathers + kernel 1", ops.serve_topk_rows(*args, k, Q=Q),
                      theirs["kernel1"](*gathered_rows(*args, Q=Q), k))
            held["kernel5_in_place"] += 1
    eng = run["engine"]
    ids, vals, idx, flags = run["after_pruned"]
    live = np.flatnonzero(~flags)
    same_bits("served pruned slates vs the parent's gathers + kernel 1",
              (torch.as_tensor(vals[live]), torch.as_tensor(idx[live])),
              tuple(x.cpu() for x in theirs["kernel1"](*served_windows(eng, ids[live]), K_TOP)))
    held["served_pruned_requests"] = len(live)
    for key in ("serving", "tiled"):
        same_bits(f"kernel 1 {key}: this build vs the parent's",
                  ops.serve_topk_window(*shapes[key], K_TOP),
                  theirs["kernel1"](*shapes[key], K_TOP))
    same_bits("kernel 5 pre-gathered, serving: this build vs the parent's",
              ops.serve_topk(*shapes["slab"], K_TOP), theirs["kernel5"](*shapes["slab"], K_TOP))
    cases = parent_quant_cases(dev, J) + list(shapes["tiled_store"].items())
    for n, (form, args) in enumerate(cases):
        g = gathered(*args)
        for k in (1, K_TOP, 16):
            same_bits(f"kernel 6 {form} case {n} k={k}, pre-gathered: this build vs the parent's",
                      ops.serve_topk_window_quant(*g, k), theirs["kernel6"](*g, k))
            same_bits(f"kernel 6 {form} case {n} k={k}, in place: this build vs the parent's",
                      ops.serve_topk_tiled_quant(*args, k), theirs["kernel6_in_place"](*args, k))
            held["kernel6"] += 2
    sync(dev)
    step_hp = dict(theta=0.1, alpha=0.1, beta=0.1, gamma=0.01)
    grads_hp = dict(alpha=0.1, beta=0.01, gamma=0.02)
    grads_cases = [(sx, hp) for sx, hp in shapes["grads"]]
    for B, K in parent_step_cases():
        srng = np.random.default_rng(B * 131 + K)
        grads_cases.append((grads_inputs(srng, B, K, dev), grads_hp))
        x = step_inputs(srng, B, K, dev)
        z = torch.as_tensor((0.5 * srng.normal(0, 1, (B, K))).astype(np.float32), device=dev)
        same_bits(f"kernel 3 B={B} K={K}: this build vs the parent's",
                  ops.dmf_fused_step(*x, **step_hp), theirs["kernel37"](*x, *step_hp.values()))
        for clip in (float("inf"), 0.5):
            same_bits(f"kernel 7 B={B} K={K} clip={clip}: this build vs the parent's",
                      ops.dmf_fused_step_dp(*x, z, **step_hp, clip=clip),
                      theirs["kernel37"](*x, *step_hp.values(), z=z, clip_=clip))
        held["kernels3_7"] += 3
    for sx, hp in grads_cases:
        B, K = sx[0].shape
        same_bits(f"kernel 9 B={B} K={K}: this build vs the parent's",
                  ops.dmf_grads(*sx, **hp), theirs["kernel9"](*sx, *hp.values()))
        held["kernel9"] += 1
    sync(dev)
    stream_cases = parent_stream_cases(dev)
    for seed, rid, n_cols in stream_cases:
        same_bits_nan(f"noise stream: this build vs the parent's (N={rid.shape[0]} "
                      f"n_cols={n_cols} seed={seed})", ops.gauss_counter(seed, rid, n_cols),
                      theirs["kernel8a"](seed, rid, n_cols))
    for n, (g, rid, seed, clip, std) in enumerate(clip_cases):
        same_bits_nan(f"kernel 8: this build vs the parent's, case {n} (B={g.shape[0]} "
                      f"K={g.shape[1]} clip={clip} noise={std})",
                      ops.dp_clip_noise(g, rid, seed, clip=clip, noise_std=std),
                      theirs["kernel8"](g, rid, seed, clip, std))
    held["stream_cases"], held["kernel8_cases"] = len(stream_cases), len(clip_cases)
    sync(dev)

    c = mb["cfg"]
    hp = dict(theta=c.lr, alpha=c.alpha, beta=c.beta, gamma=c.gamma)
    raw = ops.dmf_fused_step(*mb["sx"], **hp)[1]
    rid_b = mb["rid"][:raw.shape[0]]
    std = c.dp_sigma * c.dp_clip
    K = mb["z"].shape[1]
    pairs = {}
    for sx, ghp in shapes["grads"]:
        pairs[f"kernel 9 B={sx[0].shape[0]} K={sx[0].shape[1]}"] = (
            functools.partial(theirs["kernel9"], *sx, *ghp.values()),
            functools.partial(ops.dmf_grads, *sx, **ghp))
    for form, (args, Q) in shapes["rows"].items():
        pairs[f"kernel 5 {form}: parent gathers + kernel 1; this reads the state in place"] = (
            lambda args=args, Q=Q: theirs["kernel1"](*gathered_rows(*args, Q=Q), K_TOP),
            functools.partial(ops.serve_topk_rows, *args, K_TOP, Q=Q))
    pairs["kernel 5 pre-gathered slab R=64"] = (
        functools.partial(theirs["kernel5"], *shapes["slab"], K_TOP),
        functools.partial(ops.serve_topk, *shapes["slab"], K_TOP))
    for key, what in (("serving", "serving R=64"), ("tiled", "tiled R=128")):
        pairs[f"kernel 1 {what}"] = (functools.partial(theirs["kernel1"], *shapes[key], K_TOP),
                                     functools.partial(ops.serve_topk_window, *shapes[key], K_TOP))
    for form, args in shapes["tiled_store"].items():
        g = gathered(*args)
        pairs[f"kernel 6 {form}, pre-gathered windows"] = (
            functools.partial(theirs["kernel6"], *g, K_TOP),
            functools.partial(ops.serve_topk_window_quant, *g, K_TOP))
        pairs[f"kernel 6 {form}, in place"] = (
            functools.partial(theirs["kernel6_in_place"], *args, K_TOP),
            functools.partial(ops.serve_topk_tiled_quant, *args, K_TOP))
    pairs.update({
        "kernel 3 B=256 K=10": (
            lambda: theirs["kernel37"](*mb["sx"], *hp.values()),
            lambda: ops.dmf_fused_step(*mb["sx"], **hp)),
        "kernel 7 B=256 K=10": (
            lambda: theirs["kernel37"](*mb["sx"], *hp.values(), z=mb["z"], clip_=c.dp_clip),
            lambda: ops.dmf_fused_step_dp(*mb["sx"], mb["z"], **hp, clip=c.dp_clip)),
        "noise stream, the epoch's block": (
            lambda: theirs["kernel8a"](mb["seed"], mb["rid"], K),
            lambda: ops.gauss_counter(mb["seed"], mb["rid"], K)),
        "kernel 8 B=256 K=10": (
            lambda: theirs["kernel8"](raw, rid_b, mb["seed"], c.dp_clip, std),
            lambda: ops.dp_clip_noise(raw, rid_b, mb["seed"], clip=c.dp_clip, noise_std=std)),
    })
    times = {}
    for key, (parent_call, this_call) in pairs.items():
        t = {"parent": [], "this": []}
        for who in ("parent", "this", "this", "parent"):
            t[who].append(device_ms(parent_call if who == "parent" else this_call, 200))
        times[key] = t
    return {**held, "device_ms": times}


def parent_clip_cases(dev) -> list:
    """Kernel 8's 20 batches for the parent hold: B 1, 33, 256, 1,000 and
    5,000, each at four of K 8/10/16 × clip inf/0.5 × noise 0/1, with a
    zero row and (from B=33) a NaN row."""
    rng = np.random.default_rng(SEED + 17)
    cases = []
    for i, B in enumerate((1, 33, 256, 1000, 5000)):
        for j in range(4):
            K = (8, 10, 16)[(i + j) % 3]
            g = rng.normal(0, 1, (B, K)).astype(np.float32)
            g[0] = 0.0
            if B > 2:
                g[2, K // 2] = np.nan
            rid = ((1 << 23) - B // 2 + np.arange(B)).astype(np.int32)
            cases.append((torch.as_tensor(g, device=dev), torch.as_tensor(rid, device=dev),
                          7 + i, (float("inf"), 0.5)[j % 2], (0.0, 1.0)[j // 2]))
    return cases


def ptxas_summary(build_log: str) -> list[str]:
    """One line per compiled kernel from the build's ``-Xptxas -v`` output:
    its name with its template arguments (mangled), registers, spills."""
    import re
    out, name, spill = [], None, ""
    for line in build_log.splitlines():
        if "error" in line.lower():
            out.append(line.strip())
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            name = re.sub(r"^_ZN\w*?_GLOBAL__N__\w+?_cu_\w{8}\d+", "", m.group(1))
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and name:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
            spill = ""
    return out


# --------------------------------------------------------------------- main
def gpu_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="The port's proof on one CUDA card.")
    ap.add_argument("--parent", type=pathlib.Path, metavar="DIR")
    ap.add_argument("--obs-detail", action="store_true")
    ap.add_argument("--e2e-turns", type=pathlib.Path, metavar="DIR")
    ap.add_argument("--e2e-probe", type=pathlib.Path, help=argparse.SUPPRESS)
    ap.add_argument("--lm-phases", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    parent = args.parent.resolve() if args.parent else None
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.e2e_probe:
        print(json.dumps(e2e_probe(args.e2e_probe.resolve())))
        return 0
    if args.e2e_turns:
        log(gpu_line())
        log("e2e turns", json.dumps(e2e_turns(args.e2e_turns.resolve())))
        return 0
    sys.path.insert(0, str(ROOT / "src"))
    if args.lm_phases:
        return lm_phases()
    from repro_torch import device as device_lib
    from repro_torch.data import synthetic_poi
    from repro_torch.kernels import build, ops

    dev = device_lib.resolve("cuda")
    t_start = time.perf_counter()
    log("torch", torch.__version__, "cuda", torch.version.cuda, "python", sys.version.split()[0])
    log(gpu_line())

    t0 = time.perf_counter()
    build.load()
    log(f"phase 1 build: {time.perf_counter() - t0} s (source hash {build.source_hash()})")
    for line in ptxas_summary(build.build_log()):
        log("  ptxas", line)

    t0 = time.perf_counter()
    J = 3197
    errs = check_kernels(dev, J)
    log(f"phase 2 kernels vs plain: {json.dumps(errs)} ({time.perf_counter() - t0} s)")

    # phases 3h and 3i first, in a process of their own (`lm_phases`)
    lm_phases_in_child()

    t0 = time.perf_counter()
    ds = synthetic_poi.foursquare_like(reduced=False, seed=SEED)
    nbr, M, index, cfg = build_world(ds, dev)
    log(f"phase 3 data: users={ds.n_users} items={ds.n_items} train={len(ds.train)} "
        f"test={len(ds.test)} buckets={index.n_buckets} cap={index.cap} S={nbr.idx.shape[1]} "
        f"({time.perf_counter() - t0} s host)")
    assert ds.n_items == J

    def counted(path: str, kernels, drive):
        """Drive one main path with every launch count set to 0 just
        before and read just after; every kernel of the path must launch."""
        for kern in ops.KERNELS:
            kern.launches = 0
        t0 = time.perf_counter()
        out = drive()
        counts = {kern.__name__: kern.launches for kern in ops.KERNELS}
        log(f"phase 3 {path} path: {time.perf_counter() - t0} s, launches {json.dumps(counts)}")
        for name in kernels:
            assert counts[name] > 0, f"kernel {name} was not launched on the {path} path"
        return out, counts

    launches = {}
    run, launches["serving"] = counted("serving", SERVING_KERNELS,
                                       lambda: drive_main_path(ds, nbr, index, cfg, dev))
    slate_errs = check_slates(run, dev)
    log(f"phase 3 served slates vs plain: {json.dumps(slate_errs)}")
    summary = serving_summary(run)
    summary["staging_and_tiled"] = check_staging_and_tiled(run)
    log("serving", json.dumps(summary))
    errs["serve_topk_rows"] = max(errs["serve_topk_rows"], slate_errs["pruned"])
    errs["recommend_topk_peruser"] = max(errs["recommend_topk_peruser"], slate_errs["dense"])

    tr, launches["training"] = counted("training", TRAINING_KERNELS,
                                       lambda: drive_training(ds, nbr, index, cfg, dev))
    tr["batches_per_epoch"] = len(ds.train) * (1 + cfg.neg_samples) // cfg.batch_size
    check_training(tr)
    for line in tr["cli_lines"]:
        log("  cli |", line)
    t0 = time.perf_counter()
    tr["card_vs_cpu"] = hold_card_vs_cpu(ds, nbr, cfg, dev)
    tr["determinism"] = hold_repeat_runs(ds, nbr, cfg, dev)
    mb = mechanism_batch(ds, tr["dp_on"]["fit"].state, tr["dp_on"]["cfg"], dev)
    errs["dp_clip_noise"] = max(errs["dp_clip_noise"], hold_mechanism(mb))
    log(f"phase 3 training holds: {time.perf_counter() - t0} s, kernel 8 vs kernel 7 "
        f"message {errs['dp_clip_noise']}")
    summary = training_summary(tr)
    summary["card_vs_cpu"] = {k: tr["card_vs_cpu"][k] for k in ("loss_rel", "state_abs")}
    summary["determinism_bitwise"] = tr["determinism"]
    summary["peak_above_resident"] = evaluate_peaks(ds, tr, dev)
    log("training", json.dumps(summary))

    tl, launches["tiled"] = counted("tiled", TILED_KERNELS, lambda: drive_tiled(dev))
    tiled_errs = check_tiled(tl)
    log(f"phase 3 tiled slates vs plain: {json.dumps(tiled_errs)}")
    log("tiled", json.dumps(tiled_summary(tl)))
    errs["serve_topk_window"] = max(errs["serve_topk_window"], tiled_errs["fp32"])
    errs["serve_topk_tiled_quant"] = max(errs["serve_topk_tiled_quant"], tiled_errs["int8"],
                                         tiled_errs["bf16"])

    bl, launches["baselines"] = counted("baselines", BASELINE_KERNELS,
                                        lambda: drive_baselines(ds, M, nbr, tr, cfg, dev))
    t0 = time.perf_counter()
    bl_summary, bl_errs = check_baselines(ds, bl, nbr, run["after_pruned_rps"], dev)
    log(f"phase 3 baselines holds: {time.perf_counter() - t0} s")
    log("baselines", json.dumps(bl_summary))
    errs["recommend_topk"] = max(errs["recommend_topk"], bl_errs["MF"], bl_errs["BPR"])
    errs["dmf_grads"] = max(errs["dmf_grads"], bl_errs["grads"])
    errs["gossip_mix_op"] = max(errs["gossip_mix_op"], bl_errs["mix"])

    robust, robust_counts = {}, {}
    for part, drive in (("trivial", lambda: robust_trivial(ds, nbr, cfg, dev)),
                        ("churn", lambda: robust_churn(ds, nbr, cfg, dev)),
                        ("byzantine", lambda: robust_byzantine(ds, nbr, cfg, dev)),
                        ("audit", lambda: robust_audit(ds, nbr, cfg, dev)),
                        ("cli", lambda: robust_cli(dev))):
        robust[part], launches[f"robustness_{part}"] = counted(
            f"robustness {part}", ROBUST_PARTS[part], drive)
        robust_counts[part] = {k: launches[f"robustness_{part}"][k] for k in (
            "dmf_fused_step", "dmf_fused_step_dp", "dp_clip_noise", "gauss_counter")}
    for line in robust["cli"].pop("lines"):
        log("  cli |", line)
    robust["launches"] = robust_counts
    assert all(sum(c[k] for c in robust_counts.values()) > 0 for k in robust_counts["trivial"])
    log("robustness", json.dumps(robust))

    from repro_torch.obs import metrics as obs_metrics
    obs_metrics.set_registry(obs_metrics.MetricsRegistry())   # phase 3f's own
    t3f = time.perf_counter()
    sched, launches["scheduling"] = counted(
        "scheduling", SCHED_KERNELS,
        lambda: drive_scheduling(ds, nbr, index, cfg, tr["dp_off"]["fit"].state, dev,
                                 args.obs_detail))
    tele, launches["telemetry"] = counted(
        "telemetry", TELE_KERNELS,
        lambda: drive_telemetry(ds, nbr, cfg, robust["byzantine"]["tau"], dev, args.obs_detail))
    obs = obs_snapshot(sched)
    del sched["engine"], sched["report_1x"]
    sched["launches"] = {k: launches["scheduling"][k] for k in SCHED_KERNELS}
    log("scheduler", json.dumps(sched))
    obs["telemetry"] = tele
    obs["launches"] = {k: launches["telemetry"][k] for k in TELE_KERNELS}
    log("obs", json.dumps(obs))
    log(f"phase 3f scheduling and observability: {time.perf_counter() - t3f} s")

    t0 = time.perf_counter()
    for kern in ops.KERNELS:
        kern.launches = 0
    sharded = drive_sharded(ds, nbr, index, cfg, robust["byzantine"]["tau"],
                            sched["capacity_rps"])
    served = {d: run.pop("serving") for d, run in sharded.items()}
    launches["sharded"] = {kern.__name__: kern.launches + sum(
        run["launches"][kern.__name__] for run in sharded.values()) for kern in ops.KERNELS}
    launches["sharded_serving"] = {kern.__name__: sum(
        run["launches"][kern.__name__] for run in served.values()) for kern in ops.KERNELS}
    log(f"phase 3 sharded path: {time.perf_counter() - t0} s, launches "
        f"{json.dumps(launches['sharded'])}; serving half "
        f"{json.dumps(launches['sharded_serving'])}")
    for name in SHARDED_KERNELS:
        assert launches["sharded"][name] > 0, f"kernel {name} was not launched on the sharded path"
    for name in SHARDED_SERVING_KERNELS:
        assert launches["sharded_serving"][name] > 0, (
            f"kernel {name} was not launched on the sharded serving path")
    log("sharded", json.dumps(sharded))
    log("sharded_serving", json.dumps(served))

    t0 = time.perf_counter()
    rows: dict[str, dict] = {}
    shapes = main_shapes(run, tl, bl, tr)
    for spec in (serving_specs(run, shapes) + training_specs(tr, mb, shapes)
                 + tiled_specs(tl, shapes) + baseline_specs(bl, shapes)):
        row = time_spec(spec, errs, launches)
        if spec["name"] in rows:     # a second shape or form of a kernel
            first = rows[spec["name"]]
            first["max_abs_err"] = row["max_abs_err"]
            first[spec["variant"]] = {k: row[k] for k in (
                "shape", "ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "bytes", "flops", "timed_calls", *spec.get("extra", {}))}
        else:
            rows[spec["name"]] = row
    one = torch.empty(1, device=dev)
    floor_ms = device_ms(lambda: one.fill_(1.0), 200)   # one tiny launch, back to back
    log(f"phase 4 timing: {time.perf_counter() - t0} s; total {time.perf_counter() - t_start} s; "
        f"launch floor (a one-element fill_) {floor_ms} ms")
    t0 = time.perf_counter()
    log("forms", json.dumps(time_forms(shapes)))
    log(f"phase 4 forms: {time.perf_counter() - t0} s")
    if parent is not None:
        t0 = time.perf_counter()
        held = hold_parent_build(parent, shapes, parent_clip_cases(dev), mb, run)
        times = held.pop("device_ms")
        log(f"parent build: equal bit for bit {json.dumps(held)} "
            f"({time.perf_counter() - t0} s); device ms in turns {json.dumps(times)}")
    assert len(rows) == len(ops.KERNELS), sorted(rows)
    log(json.dumps({"kernels": list(rows.values())}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

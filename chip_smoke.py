#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from src/repro_torch/kernels/csrc (into
build/kernels/ at first use) and lists each kernel's registers and spills
(a spill in the attention, LinUCB or SSD kernels fails the run, except
in the scoring kernel's autotune candidates, linucb_score_kernel<DP,
ROWS> with ROWS other than the main path's 128, which are listed), then:

  1. prints the card, its power limit and the torch / CUDA versions, and
     turns TF32 off for matrix products and convolutions;
  2. holds each kernel against its plain PyTorch version on the card at
     the main path's shapes and at the largest supported shape (K = 8,
     d = 128), and times kernel, plain version and (for the scoring
     kernel) the library forms computing the same scores: CUDA events
     around one call, the kernels' own device time under torch.profiler
     (device_ms) and a CUDA graph of 20 calls (graph_ms); each step check
     names its route (one launch for B = 1, score + update chained by
     programmatic dependent launch above) and its busiest arm;
  3. drives the main path at the paper's configuration: make_benchmark
     (1,824 test prompts), fitted priors, RouterConfig() (d = 26, 8 slots,
     3 active, backend "fused"), 20 seeds, n_eff = 1164, evaluate.run at
     budgets 3.0e-4 and 6.6e-4 with blocks of 256 and request by request
     (compliance within (0.9, 1.10) at 3.0e-4 request by request), then
     select-only serving of a 256-request block through the scoring
     kernel; the kernels' launch counters are zeroed just before and read
     just after, and each kernel, and each route of linucb_step, must
     have been launched;
  4. runs both block runs and the per-request run at 3.0e-4 on the
     "torch" oracle backend: arm agreement >= 0.99 and mean reward within
     1e-3;
  5. checks the served scores against the oracle's within 1e-4.

  6. holds the two attention kernels (flash_attention, decode_attention)
     against their plain versions at the served shapes first (olmo-1b's
     and deepseek-67b's 32-token prefills and their decode tokens at
     W = 40), then at longer ones (bf16), at ragged f32 shapes and (decode)
     a row with no valid slot, whose output is the mean of V, and times
     kernel, plain version and torch's scaled_dot_product_attention on the
     same inputs (CUDA events around one call, device_ms and graph_ms);
     then the
     SSD scan (ssd_scan) at mamba2-370m's served shapes (the 24 requests'
     prompts pad to 32 tokens, one chunk of 32 rows; the longest prompt
     the server keeps is 128, one full chunk), at 16 chunks (bf16) and at
     a ragged f32 shape, kernel and plain version (no single library call
     computes the scan), each check naming the route its plan took
     (one_chunk and chunked on the tensor cores, fma on FP32 FMAs) and
     its bound at that route's peak; last, phase 13's shapes: flash at hd
     80 (zamba2-2.7b), 608 rows at hd 96 (phi-3-vision's image and
     prompt), whisper-medium's full-mode encoder at T = 1,500 and its
     cross-attention (32 queries against 1,500 frames); decode at hd
     80 / 96 / 64 with G = 1 and at hd 128 with G = 6 (dbrx-132b) and
     G = 5 (llama4-maverick); ssd_scan at zamba2's H 80, P 64, N 64;
  7. drives the served path at full width: a PortfolioServer of the JAX
     driver's trio, olmo-1b (16 layers), mamba2-370m (48 layers, nothing
     cut) and deepseek-67b at full width with its depth cut to 4 layers,
     bf16 weights from seeds, each priced from its FULL config; the
     served kernels' counters are zeroed, each arm generates once, then
     24 requests are served in windows of 8 with deferred feedback
     (budget 6.6e-4, 8 new tokens); each served kernel must have been
     launched, and the launches of the 24 requests must equal what the
     printed traffic implies (flash one per attention layer per request,
     decode one per layer per token, ssd_scan one per mamba2 layer per
     request), every flash launch must have taken the tensor cores and
     every ssd_scan launch the one-chunk tensor-core route;
  8. teacher-forces one prompt and 8 fixed tokens per arm through the
     kernel route and the plain route: logits within the bf16 tolerance;
  9. traces one request per arm: host ms of prefill and of a decode
     token, device busy ms and idle share, the ported kernels' share and
     their launches and ms by kernel;
 10. runs the scenario engine (evaluate.run_scenario) on the fused
     backend: (a) the paper-claims twin's drift, regression and
     onboarding protocols as specs (6 seeds, phases of 304, request by
     request) held to the twin's bars, drift and good_cheap onboarding
     also against the twin's hand-rolled phase loops, arm for arm; (b) the
     benchmarks' protocols at half their phase (3 x 304 requests, 20
     seeds, fitted
     priors, alpha 0.01, gamma 0.997): silent and recalibrated drift, the
     0.75 regression and good_cheap onboarding in blocks of 256 and the
     silent drift also request by request, each run held to the "torch"
     oracle per segment (arm agreement >= 0.99, mean reward within 1e-3);
     (c) a silent drift under
     Timeline((256, 512), horizon=768) on a padded horizon of 1024,
     identical to the retimed spec's run in blocks of 256 and request by
     request. linucb_step's counters are zeroed before the phase; its
     launches by route must equal what the specs imply (ceil(L / B)
     blocks a segment, padded steps included);
 11. runs the sweep fabric (core/sweep.py, montecarlo.run_monte_carlo)
     at the JAX benchmarks' grids on the first 512 requests of each
     split: (a) Fig. 1's seven ceilings plus 1.0 x
     20 seeds as one stack of 160 states (alpha 0.01, gamma 0.997, fitted
     priors, the test split), per request (condition 1.0e-4 identical to
     a looped evaluate.run call) and in blocks of 256 (conditions 1.0e-4,
     6.6e-4 and 1.0 identical to their looped runs; chunk_size=40 and a
     split over devices [cuda:0, cuda:0] identical to the whole stack);
     (b) the knee grid, 28 (alpha, gamma) cells x 5 budgets x 10 seeds =
     1,400 states per request on the val split with per-cell n_eff, one
     condition inside the stack identical to its looped run, each cell's
     AUC; (c) the timeline Monte Carlo, 1,024 sampled timelines of a
     240-step spec as one stack, 4 probes identical to run_scenario on
     their retimed specs, a resampled set through the same cached runner,
     the bands.
     Each grid and its looped runs print wall s and decisions/s;
     linucb_step's counters are zeroed before the phase and its launches
     by route must equal what the grids imply (one single launch per
     step per sub-stack, ceil(T / 256) pdl launches per run in blocks);
 12. runs the tenant plane (core/tenancy.py through evaluate, sweep, the
     gateway and snapshot persistence) on the test bed of the JAX
     package's benchmarks/bench_tenants.py (its smoke size for the
     compliance gate, shorter streams for the identities): prices of
     1e-4 / 3e-4 / 1e-3 per request, fitted priors, alpha 0.01, gamma
     0.997, no forced pulls, the "torch" backend (tenant mode refuses
     the kernels, as the JAX package's Pallas kernels do), blocks of 64
     under the flash-crowd mix: (a) fold identity at T = 8 and T = 64
     (n 1,024, seeds 0 and 1), every (seed, tenant) row's lam, c_ema,
     pulls and spend equal bit for bit to the grouped single-tenant
     fold; (b) T = 4 compliance (n 32,768, 8 seeds), every tenant's
     steady-state deviation <= 0.004; (c) a fleet grid of 3 tables x 4
     seeds (n 1,024) as one run_grid call, identical to the three looped
     evaluate.run calls, both walls printed; (d) a tenanted gateway (T =
     4, 32 windows of 16, feedback and learning), saved and restored
     with elapsed 50: the restored state equals decay_on_restore of the
     saved one within 1e-6, each tenant's lam decays toward 0 and c_ema
     toward its budget. The LinUCB kernels' counters are zeroed before
     the phase and must read 0 after it; a tenant block on "fused" must
     raise NotImplementedError;
 13. serves the rest of the model zoo at full width, phase 7's portfolio
     released first: (a) a PortfolioServer of zamba2-2.7b (54 layers,
     nothing cut), phi-3-vision-4.2b (32 layers, text path) and dbrx-132b
     at full width with its depth cut to 4 of 40 layers, bf16 weights
     from seeds, each priced from its FULL config, a first generate per
     arm, then 24 requests in windows of 8 as in phase 7; (b)
     llama4-maverick at full width, 2 of 48 layers (one dense, one MoE),
     with the card to itself: two generates; (c) whisper-medium whole:
     prefill_forward on (1, 1,500, 80) frames from a seed and a 32-token
     prompt, then 8 decode steps; (d) phi-3-vision's image path: 576
     patch embeddings (width 1,024) from a seed before the prompt, then
     8 tokens. The served kernels' counters are zeroed before each
     sub-phase's generates and read after them: the launches must equal
     the per-family count (flash once per attention layer per prefill,
     the hybrid's shared block once per application, whisper's 24
     encoder + 24 self + 24 cross layers; decode once per attention
     layer per token; ssd_scan once per Mamba2 layer), every flash
     launch on the tensor cores, every ssd_scan launch on one_chunk.
     Each arm's teacher-forced logits as in phase 8 (f32 held to its
     bar; bf16 to 2x the plain routes' difference, except the MoE arms,
     whose bf16 ratio is printed beside the count of (token, layer)
     top-k choices that differ between the routes), its trace as in
     phase 9, and each sub-phase's wall and peak memory;
 14. trains (forward_train, make_train_step, AdamW, launch.train) on the
     chunked route, as the JAX package's train step does: (a) a SMOKE
     config of each family (dense, ssm, hybrid, MoE with moe_every 1 and
     2, VLM with its frontend, whisper with its frames) in f32 on the
     card against the CPU, two steps; (b) olmo-1b FULL in bf16 on one
     fixed batch of 8 x 128 tokens, 10 steps whose loss must fall by 1
     nat, every gradient leaf finite and nonzero; (c) its first step with
     per-layer remat; (d) mamba2-370m FULL in bf16, 5 steps; (e)
     launch.train.main at SMOKE with a checkpoint loaded back. The five
     kernels' counters are zeroed before the phase and must read 0 after
     it (see train_phase for the bars and what is printed);
 15. runs fp8 KV caches and the one-device dry run: (a) decode_attention
     on float8_e4m3fn / e5m2 caches (olmo-1b's token, W 4,096 at 32
     splits, hd 80 and 96, an f32 query, a row with no valid slot), each
     equal bit for bit to the kernel on the cache cast to q's dtype and
     within phase 6's bars of the plain version, timed with the bound at
     1-byte K / V and, as the library column, the cast plus SDPA; (b)
     olmo-1b FULL in bf16 with float8_e4m3fn caches: 8 prompts of the
     stream prefilled token by token and decoded 8 tokens each, the
     decode kernel's launches (zeroed just before) equal to tokens x
     layers, every one on an fp8 cache; one prompt teacher-forced through
     the kernel and the two plain decode routes on fp8 caches (the kernel
     within 2x of what the plain routes differ by) and the kernel route on
     bf16 caches (max |d logit|, top-1 agreement printed); mamba2-370m's
     decode on an fp8 conv state raises ValueError, as the JAX package's
     does; (c) launch/dryrun's step_cost (the one-device trace) for the
     trio at decode_32k with and without fp8 caches and olmo-1b at
     train_4k, then the dry run of
     olmo-1b FULL bf16 held against the card: a decode step at B 8, W
     4,096 on fp8 caches and prefill_forward at (1, 2,048), the arguments'
     bytes equal to the real ones, the predicted peak within 2x of the
     measured, the least of 5 times at least 0.95 of the bound;
 16. runs the autotune, Eq. 9 and the port's lint suite: (a)
     kernels/tune.py's autotune_block_r at PERF.md's two linucb_score
     shapes, each rows-per-block candidate (32, 64, 128, 256) equal bit
     for bit to the 128-row launch, which meets EQUIV_TOL = 1e-4 against
     the plain version, its table of graph_ms printed; the scoring
     kernel's counter is zeroed before and read after (launches_tune);
     and phase 2's (20, 256, 8, 26) linucb_step block run again on the
     pdl route, equal to phase 2's result bit for bit; (b)
     linucb.ucb_variance on the card against the CPU within 1e-6
     relative; (c) python -m repro_torch.analysis, which must exit 0
     against analysis_baseline_torch.json.
 17. runs the placement rules (launch/sharding.py, models/pspec.py,
     launch/mesh.py's production mesh): (a) on an nccl world of one rank
     with a (1, 1) ("data", "model") mesh on the card, shard_tree places
     phase 15's olmo-1b FULL bf16 parameters, a TrainState on them (mu
     and nu drawn at random, under the parameter shardings; step
     replicated) and bf16 decode caches at B 8, W 4,096 (random) as
     DTensors: each local tensor equal bit for bit to its source, each
     placement what the rules give; then pspec.hint redistributes an
     activation on the card; (b) fake worlds of 256 and then 512 ranks:
     make_production_mesh with multi_pod off and on, and the rules for
     olmo-1b, deepseek-67b and dbrx-132b FULL (meta tensors) under tp /
     fsdp / dp, every leaf's shard shape times its placements' mesh
     sizes equal to its global shape, with each one's f32 parameter bytes
     per device printed; and where fsdp's embed keeps ("data", "model")
     (deepseek-67b, dbrx-132b), every rank's local shape and offset as
     this torch's DTensor computes them equal to the (data, model) index
     flattened major to minor, as JAX flattens the tuple. (a) shows that
     the rules can be applied on the card; (b)'s offsets are the check of
     their multi-axis semantics. Each process group is destroyed before
     the next.
 18. runs the dry run on the production mesh with the collective
     estimate (launch/dryrun.py's default, JAX's) on meta tensors, in the
     fake world of 512 ranks it starts and destroys itself (MESH_DRYRUN):
     olmo-1b and mamba2-370m x decode_32k on 16 x 16 (tp), dbrx-132b x
     decode_32k on 2 x 16 x 16 with the experts on 'data' and on 16 x 16,
     llama4 x decode_32k on 16 x 16; mamba2-370m and olmo-1b x
     prefill_32k, olmo-1b x prefill_32k on 2 x 16 x 16, olmo-1b and
     dbrx-132b x train_4k on 16 x 16 (the lookup's backward; the MoE
     dispatch's), at 1,024 tokens (the shapes' batches, so the rules shard
     what they shard at full size). Each one's per-device argument bytes,
     read from the local shards of this torch's DTensor trace, must equal
     the shard-shape sum of its placed arguments, and olmo-1b's and
     mamba2-370m's decode XLA's (2,441,674,788 and 365,081,764); the
     collective counter must meet no op it has no kind for (it raises);
     the wire bytes per device, five kinds, must equal the CPU's pin
     (MESH_WIRE_BYTES) to the byte, and olmo-1b's and mamba2-370m's
     decode be within WIRE_FACTOR of XLA's. Prints the trace seconds and
     the temp bytes (`[mesh]`) and the phase's seconds, at most
     MESH_PHASE_S; the five kernels' counters are zeroed before the phase
     and must read 0 after it.

Prints the script's wall, the kernels JSON line, then the nvidia-smi
line, and last ``{"ok": true, "device": {...}}``. Any failed check raises, so the exit
code is non-zero and no result line is printed. Without a CUDA device,
or run from a directory without the repository's src/, it exits 2.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bandwidth and FP32
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# Dense bf16 on the tensor cores: the least time for bf16 attention work.
BF16_FLOP_PER_S = 989e12

# The attention kernels' tolerances (tests/test_kernels.py): (rtol, atol).
ATTN_TOL = {"float32": (2e-4, 2e-5), "bfloat16": (5e-2, 5e-2)}
# Random q, k, v give outputs far below the absolute tolerance at long
# S or W (a row's RMS is about 1 / sqrt(keys it sees)), so each attention
# check also holds every output row's max error to a share of that row's
# RMS. A bf16 kernel that is right reads about 0.03 there (output
# rounding and P in bf16); one that drops a 64-key tile or a decode split
# reads more than three times the bound
# (tests/test_torch_attention.py::test_row_rel_check_catches_a_dropped_tile).
ATTN_ROW_REL_TOL = {"float32": 1e-3, "bfloat16": 0.1}
# The bf16 teacher-forced logits: the kernel route may differ from the
# chunked plain route by at most this multiple of what two plain routes
# (naive and chunked prefill) differ by.
TEACHER_BF16_FACTOR = 2.0
# The SSD scan's (tests/test_kernels.py's SSD tests): f32 and bf16 inputs.
SSD_TOL = {"float32": 2e-4, "bfloat16": 0.08}
# The SSD kernels (csrc/ssd_scan.cu), whose spills fail the run too.
SSD_KERNELS = ("ssd_chunk_mma_kernel", "ssd_chunk_fma_kernel",
               "ssd_state_pass_kernel")

SEEDS = tuple(range(20))
N_EFF = 1164.0
BUDGETS = (3.0e-4, 6.6e-4)

# The scenario phase's protocols, copied from the JAX package's benchmarks
# (the card's machine has no JAX): benchmarks/bench_cost_drift.py:32-34
# (PHASE, GEMINI, PRICE_MULT), bench_degradation.py:30 (MISTRAL),
# bench_onboarding.py:24-26 (phase 1 of 608, FLASH), benchmarks/common.py:27
# (PARETO_CFG: alpha 0.01, gamma 0.997) and src/repro/core/costs.py:67-68
# (the tight and moderate budgets). The paper-claims twin's protocols
# (tests/test_torch_paper_claims.py) run 6 seeds with phases of 304.
PHASE = 608
GEMINI, MISTRAL, FLASH = 2, 1, 3
PRICE_MULT = (0.10 / 1e3) / 5.6e-3
BUDGET_TIGHT, BUDGET_MODERATE = 3.0e-4, 6.6e-4
PARETO_HYPER = dict(alpha=0.01, gamma=0.997)
TWIN_SEEDS, TWIN_PHASE = tuple(range(6)), 304
SCENARIO_BLOCK = 256
# The oracle protocols (b) and the timeline identity (c) run at half the
# benchmarks' phase, to keep the script inside its time limit: 304 = 256
# + 48 still gives every segment a whole block and a ragged one, and
# neither the oracle's agreement nor the identity depends on the length.
SCENARIO_PHASE = PHASE // 2

# The sweep phase's grids, copied from the JAX package's benchmarks:
# bench_pareto.py:20,36 (seven ceilings plus the unconstrained 1.0, 20
# seeds), bench_knee.py:45-52,86-135 (the (alpha, gamma) cells, the AUC
# budgets, 10 seeds, the val split, n_eff from T_adapt = 500 by Eq. 13)
# and bench_scenarios.py:320-333,357-359 (the Monte Carlo spec at T = 240,
# 1,024 timelines drawn with seed 11, horizons (180, 240), seeds (0,)).
# The benchmark probes 16 timelines against their retimed specs; the
# script probes 4, one from each quarter of the stack, and one condition
# of each grid per request, to stay inside its time limit. The Fig. 1
# and knee grids run on the first SWEEP_N requests of their splits: a
# grid equals its looped runs at any length.
BUDGET_SWEEP = (1.0e-4, 2.3e-4, 3.0e-4, 6.6e-4, 1.0e-3, 1.9e-3, 4.0e-3)
KNEE_ALPHAS = (0.005, 0.01, 0.05, 0.1)
KNEE_GAMMAS = (0.994, 0.995, 0.996, 0.997, 0.998, 0.999, 1.0)
KNEE_BUDGETS = (1.0e-4, 3.0e-4, 6.6e-4, 1.9e-3, 6.0e-3)
KNEE_SEEDS, KNEE_T_ADAPT = tuple(range(10)), 500.0
MC_T, MC_N, MC_SEED, MC_PROBE = 240, 1024, 11, 4
SWEEP_N = 512

# The tenant phase's test bed, copied from the JAX package's
# benchmarks/bench_tenants.py:50-53 (CFG, PRICES_PER_REQ, BUDGETS_T4,
# COMPLIANCE_LINE), :57-66 (make_benchmark(seed=0) at the 10x price
# spread, splits 8374 / 1785 / n, fitted priors), :69-76 (the log-uniform
# budgets of larger fleets), :79-84 (the flash-crowd mix), :87-96
# (blocks of 64, n_eff 1164) and its smoke sizes (:98, :172, :182-184,
# :209, :225-227).
TENANT_PRICES = (1e-4, 3e-4, 1e-3)
TENANT_BUDGETS_T4 = (1.8e-4, 2.1e-4, 2.4e-4, 2.8e-4)
TENANT_BAND = (1.8e-4, 2.8e-4)
COMPLIANCE_LINE = 0.004
TENANT_BLOCK = 64
TENANT_SCALES = (1.0, 1.25, 1.5)
# The fold identity's and the fleet grid's stream: an eighth of
# bench_tenants.py's smoke size (8,192), to keep the script inside its
# time limit; neither identity depends on n. The T = 4 compliance gate
# keeps the smoke size (32,768): its steady state needs the length.
TENANT_N = 1024
GATEWAY_WINDOWS, GATEWAY_WINDOW, RESTORE_ELAPSED = 32, 16, 50
RESTORE_TOL = 1e-6


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` calls, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = 10):
    """Device time of one call of ``fn``: the durations of the CUDA
    kernels it launches, summed under torch.profiler over ``reps`` calls
    (after one warm-up call) and divided by ``reps``. Unlike CUDA events
    around one call, it leaves out the host's launch time. A profile that
    comes back without device events (CUPTI now and then delivers none)
    is taken again, up to three times; after that the time is not
    measured (None). CUPTI on the card's machine also undercounts some
    long kernels at times (PERF.md §7), so ``graph_ms`` stands beside
    it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels:
            return sum(e.time_range.elapsed_us() for e in kernels) / reps / 1e3
    print("[profile] three profiles without device events: device_ms not "
          "measured", file=sys.stderr)
    return None


def graph_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """Time of one call of ``fn`` on the device, without CUPTI: ``calls``
    calls captured in one CUDA graph, replayed ``replays`` times between
    two CUDA events, divided by calls x replays. The host launches one
    graph, so this is the device's time for the calls back to back
    (with the gaps between graph nodes), a check on ``device_ms``."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def host_ms(fns, reps: int = 3):
    """Least host-clock time (ms, synchronised) of each of ``fns``, taken
    in turns so that drift hits them alike."""
    import torch

    best = [float("inf")] * len(fns)
    for fn in fns:
        fn()
    for _ in range(reps):
        for i, fn in enumerate(fns):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best[i] = min(best[i], (time.perf_counter() - t) * 1e3)
    return best


def device_profile(fn):
    """(device busy ms, device kernels, ms of linucb_step's kernels: its
    scoring launch and its update launch) of one call of ``fn`` under
    torch.profiler: the sum of every CUDA kernel's duration on the
    device."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert kernels, "the profiler recorded no device kernel"
    us = lambda es: sum(e.time_range.elapsed_us() for e in es)  # noqa: E731
    ours = [e for e in kernels
            if "linucb_score_kernel" in e.name
            or "linucb_update_kernel" in e.name]
    return us(kernels) / 1e3, len(kernels), us(ours) / 1e3


def bound(nbytes: float, flops: float, peak: float = FP32_FLOP_PER_S):
    """(least time in ms, what bounds it) on the H100's published peaks:
    bytes over the HBM rate, operations over ``peak``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def spd_inverses(rng, S, K, d):
    import numpy as np

    M = rng.standard_normal((S, K, d, d)) * 0.1
    A = np.einsum("skij,sklj->skil", M, M) + np.eye(d) * 1.2
    return A, np.linalg.inv(A)


_MANGLED_TYPES = {"13__nv_bfloat16": "bf16", "13__nv_fp8_e4m3": "e4m3",
                  "13__nv_fp8_e5m2": "e5m2"}


def template_args(mangled: str) -> list:
    """The template arguments of an Itanium-mangled kernel name from its
    'I' up to the matching 'E': f (f32), <length><type name>, S<n>_ (a
    type named before, taken as the last one) and Li<n>E (an int)."""
    import re

    args, i = [], 0
    while i < len(mangled) and mangled[i] != "E":
        if mangled[i] == "f":
            args.append("f32")
            i += 1
        elif mangled[i].isdigit():
            n = re.match(r"\d+", mangled[i:]).group(0)
            j = i + len(n) + int(n)
            args.append(_MANGLED_TYPES.get(mangled[i:j], mangled[i:j]))
            i = j
        elif mangled[i] == "S":
            args.append(args[-1] if args else "?")
            i = mangled.index("_", i) + 1
        elif mangled.startswith("Li", i):
            j = mangled.index("E", i)
            args.append(int(mangled[i + 2:j]))
            i = j + 1
        else:
            break
    return args


def build_report(log: str):
    """Prints each kernel's registers and spills from the build log
    (``-Xptxas -v``) and returns the kernels that spill."""
    import re

    name, spills = "?", []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            mangled = m.group(1)
            name = next((k for k in KERNEL_NAMES if k in mangled), mangled)
            # <q dtype, K / V dtype, path> of decode_split_kernel, <q, K /
            # V> of decode_combine_kernel, <dtype> of the others, <DP> of
            # linucb_score_kernel, <threads, lanes per row> of
            # linucb_update_kernel.
            at = mangled.find(name + "I")
            if at >= 0:
                args = template_args(mangled[at + len(name) + 1:])
                if name == "decode_split_kernel" and args:
                    args[-1] = ("fma", "mma")[args[-1]]
                name += "<" + ", ".join(map(str, args)) + ">"
        elif "registers" in line:
            print(f"[build]   {name}: {line.split(':', 1)[1].strip()}")
        elif "spill" in line:
            print(f"[build]   {name}: {line.strip()}")
            if re.search(r"[1-9]\d* bytes spill", line):
                spills.append(name)
    return spills


# Every kernel the library holds, by the name in its source.
KERNEL_NAMES = ("linucb_score_kernel", "linucb_update_kernel",
                "flash_wgmma_kernel", "flash_kernel", "decode_split_kernel",
                "decode_combine_kernel") + SSD_KERNELS


def check_score(rng, S, R, K, d):
    """linucb_score against its plain version at (S, R, K, d)."""
    import numpy as np
    import torch

    from repro_torch.kernels.linucb_score import ops
    from repro_torch.kernels.linucb_score.kernel import linucb_score_blocked
    from repro_torch.kernels.linucb_score.ref import linucb_score_ref

    f = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,  # noqa: E731
                                  device="cuda").contiguous()
    _, ainv = spd_inverses(rng, S, K, d)
    x = f(rng.standard_normal((S, R, d)))
    theta = f(rng.standard_normal((S, K, d)) * 0.1)
    ainv = f(ainv)
    pen = f(rng.uniform(0, 1, (S, K)))
    infl = f(rng.uniform(0.005, 1.0, (S, K)))
    alpha = f(rng.uniform(0.01, 0.1, S))
    args = (x, theta, ainv, pen, infl, alpha)
    got = ops.linucb_score(*args)
    want = linucb_score_ref(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    tol_ok = bool(((got - want).abs() <= 2e-5 + 2e-4 * want.abs()).all())
    assert tol_ok and torch.isfinite(got).all(), (
        f"linucb_score disagrees at {(S, R, K, d)}: max abs err {err}")
    out = torch.empty_like(got)
    ms = cuda_ms(lambda: linucb_score_blocked(*args, out))
    plain_ms = cuda_ms(lambda: linucb_score_ref(*args))

    # Library yardstick: the fastest of three library formulations of the
    # same scores (a 3-operand einsum, the plain version's two einsums,
    # and one cuBLAS bmm over the (K*d, d) rows of the inverses).
    def tail(q):
        return (torch.einsum("srd,skd->srk", x, theta)
                + alpha[:, None, None] * torch.sqrt(q.clamp_min(0) / infl[:, None])
                - pen[:, None])

    forms = {
        "einsum3": lambda: tail(torch.einsum("srd,skde,sre->srk", x, ainv, x)),
        "einsum2": lambda: tail(torch.einsum(
            "srke,sre->srk", torch.einsum("srd,skde->srke", x, ainv), x)),
        "bmm": lambda: tail(torch.einsum(
            "skdr,srd->srk",
            torch.bmm(ainv.view(S, K * d, d), x.transpose(1, 2)).view(
                S, K, d, R), x)),
    }
    library = {}
    for name, fn in forms.items():
        assert float((fn() - want).abs().max()) <= 1e-4, name
        library[name] = cuda_ms(fn)
    library_form = min(library, key=library.get)
    library_ms = library[library_form]
    dev_ms = device_ms(lambda: linucb_score_blocked(*args, out))
    g_ms = graph_ms(lambda: linucb_score_blocked(*args, out))
    library_dev = {name: device_ms(fn) for name, fn in forms.items()}
    measured = {k: v for k, v in library_dev.items() if v is not None}
    library_dev_form = min(measured, key=measured.get) if measured else None
    library_graph = {name: graph_ms(fn) for name, fn in forms.items()}
    nbytes = 4 * (S * R * d + S * K * d + S * K * d * d + 2 * S * K + S
                  + S * R * K)
    flops = 2 * S * R * K * d * d + 2 * S * R * K * d
    bms, by = bound(nbytes, flops)
    return dict(shape=dict(S=S, R=R, K=K, d=d), max_abs_err=err, ms=ms,
                device_ms=dev_ms, graph_ms=g_ms, plain_ms=plain_ms,
                library_ms=library_ms, library_form=library_form,
                library_all_ms=library,
                library_device_ms=measured.get(library_dev_form),
                library_device_form=library_dev_form,
                library_all_device_ms=library_dev,
                library_graph_ms=min(library_graph.values()),
                library_all_graph_ms=library_graph, bound_ms=bms, bound_by=by)


# Phase 2's step checks by (S, B, K, d): (operands, the kernel's outputs),
# for phase 16 to run again.
STEP_RESULTS = {}


def check_step(rng, S, B, K, d):
    """linucb_step against its plain version at (S, B, K, d): arms and
    last_upd identical, statistics / theta / (r, c) within 1e-4 abs +
    1e-4 rel, and the pacer's lam and c_ema within 1e-4 relative. The
    pacer inputs make the budget bind: c_ema starts and stays above each
    state's budget, and eta is small enough that lam climbs without
    reaching either clip (0 or lambda_bar), which the check asserts."""
    import numpy as np
    import torch

    from repro_torch.kernels.linucb_step import ops
    from repro_torch.kernels.linucb_step.kernel import (
        linucb_step_blocked, route, scores_workspace,
    )
    from repro_torch.kernels.linucb_step.ref import linucb_step_ref

    dev = "cuda"
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,  # noqa: E731
                                  device=dev).contiguous()
    i32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32,  # noqa: E731
                                    device=dev).contiguous()
    A, Ainv = spd_inverses(rng, S, K, d)
    b = rng.standard_normal((S, K, d)) * 0.1
    vec = lambda v: f(np.full(S, v))  # noqa: E731
    cand = rng.uniform(0, 1, (S, K)) > 0.2
    cand[:, 0] = True
    lam0, cema0, lbar = 0.2, 1.2e-3, 5.0
    args = dict(
        A=f(A), A_inv=f(Ainv), b=f(b),
        theta=f(np.einsum("skij,skj->ski", Ainv, b)),
        last_upd=i32(rng.integers(0, 50, (S, K))),
        X=f(rng.standard_normal((S, B, d))),
        rewards=f(rng.uniform(0, 1, (S, B, K))),
        costs=f(rng.uniform(5e-4, 2e-3, (S, B, K))),
        noise=f(rng.uniform(0, 1e-7, (S, B, K))),
        cand=torch.as_tensor(cand, device=dev),
        pen=f(rng.uniform(0, 0.5, (S, K))),
        infl=f(rng.uniform(0.01, 1.0, (S, K))),
        alpha=vec(0.05), gamma=f(rng.uniform(0.99, 1.0, S)), eta=vec(0.005),
        alpha_ema=vec(0.05), lambda_bar=vec(lbar),
        lam=vec(lam0), c_ema=vec(cema0), budget=f(rng.uniform(5e-4, 9e-4, S)),
        t_sel=i32(np.full(S, 300)),
        force_arm=i32(rng.integers(0, K, S)),
        forced=(torch.arange(B, device=dev) < min(3, B - 1))[None]
        .expand(S, B).contiguous(),
    )
    assert tuple(args) == ops.OPERANDS
    ins = tuple(args.values())
    got = ops.linucb_step(*ins)
    want = ops.linucb_step(*(v.cpu() for v in ins))
    torch.cuda.synchronize()
    STEP_RESULTS[(S, B, K, d)] = (ins, tuple(t.clone() for t in got))
    names = ("A", "A_inv", "b", "theta", "last_upd", "arms", "r", "c",
             "lam", "c_ema")
    err = 0.0
    for n, g, w in zip(names, got, want):
        g = g.cpu()
        if n in ("last_upd", "arms"):
            assert torch.equal(g, w), f"linucb_step {n} differs at {(S, B, K, d)}"
            continue
        assert torch.isfinite(g).all(), n
        diff = (g.double() - w.double()).abs()
        atol = 0.0 if n in ("lam", "c_ema") else 1e-4
        assert bool((diff <= atol + 1e-4 * w.double().abs()).all()), (
            f"linucb_step {n} differs at {(S, B, K, d)}: {float(diff.max())}")
        err = max(err, float(diff.max()))
    busiest = max(int(torch.bincount(a, minlength=K).max())
                  for a in want[5].long())
    lam, c_ema = want[8], want[9]
    assert bool(((lam > lam0) & (lam < lbar)).all()), (
        f"lam left (lam0, lambda_bar) or did not move: {lam}")
    assert bool((c_ema > args["budget"].cpu()).all()
                and (c_ema != cema0).all()), f"c_ema did not bind: {c_ema}"
    # Time the kernel alone into the outputs just checked, and the plain
    # version on the same operands on the card.
    ws = scores_workspace(S, B, K, dev)
    run = lambda: linucb_step_blocked(ins, got, ws, num_valid=B,  # noqa: E731
                                      dt_max=4096)
    ms = cuda_ms(run)
    dev_ms = device_ms(run)
    g_ms = graph_ms(run)
    plain_ms = cuda_ms(lambda: linucb_step_ref(*ins, num_valid=B,
                                               dt_max=4096), reps=5)
    # Bytes: each operand read once, each output written once (f32 / i32
    # 4 bytes, the two bool masks 1 byte).
    stats = S * K * (2 * d * d + 2 * d + 1)        # A, A_inv, b, theta, lu
    block_in = S * B * (d + 3 * K) + 2 * S * K + 10 * S
    block_out = 3 * S * B + 2 * S                  # arms, r, c, lam, c_ema
    nbytes = 4 * (2 * stats + block_in + block_out) + S * K + S * B
    # score 2BKd² + per request: matvec 2d², A_inv update 4d², A update
    # 3d², b 3d; theta refresh 2Kd².
    flops = S * (2 * B * K * d * d + B * (9 * d * d + 3 * d)
                 + 2 * K * d * d)
    bms, by = bound(nbytes, flops)
    return dict(shape=dict(S=S, B=B, K=K, d=d), route=route(B),
                busiest_arm=busiest, max_abs_err=err, lam=[float(lam.min()), float(lam.max())],
                ms=ms, device_ms=dev_ms, graph_ms=g_ms, plain_ms=plain_ms,
                library_ms=None,
                bound_ms=bms, bound_by=by)


def _attn_err(got, want, dtype_name):
    """Max abs error and whether ``got`` is within the attention
    tolerance of ``want`` (|g - w| <= atol + rtol |w|)."""
    rtol, atol = ATTN_TOL[dtype_name]
    diff = (got.float() - want.float()).abs()
    ok = bool((diff <= atol + rtol * want.float().abs()).all()
              and got.float().isfinite().all())
    return float(diff.max()), ok


def _row_rel_err(got, want, dtype_name):
    """The largest max |got - want| over an output row (the last axis)
    divided by that row's RMS in ``want``, and whether it is within
    ATTN_ROW_REL_TOL."""
    diff = (got.float() - want.float()).abs().amax(-1)
    rms = want.float().pow(2).mean(-1).sqrt()
    rel = float((diff / rms).max())
    return rel, rel <= ATTN_ROW_REL_TOL[dtype_name]


def check_flash(gen, B, S, H, KV, hd, dtype, mode, window=0, T=None):
    """flash_attention against its plain version on q (B, S, H, hd) and
    k / v (B, T, KV, hd), T = S unless given (cross-attention); the
    library yardstick is one scaled_dot_product_attention call."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.kernel import flash_attention_bshd
    from repro_torch.kernels.flash_attention.kernel import route as flash_route
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    mk = lambda *shape: torch.randn(shape, generator=gen, device="cuda",  # noqa: E731
                                    dtype=dtype)
    T = T or S
    q, k, v = mk(B, S, H, hd), mk(B, T, KV, hd), mk(B, T, KV, hd)
    name = str(dtype).split(".")[1]
    got = ops.flash_attention(q, k, v, mode=mode, window=window)
    want = flash_attention_ref(q, k, v, mode=mode, window=window)
    route = flash_route(dtype, hd)
    torch.cuda.synchronize()
    err, ok = _attn_err(got, want, name)
    rel, rel_ok = _row_rel_err(got, want, name)
    assert ok and rel_ok, (f"flash_attention disagrees at "
                           f"{(B, S, T, H, KV, hd, name, mode)}: max abs {err}, "
                           f"row-relative {rel}")
    out = torch.empty_like(q)
    scale = 1.0 / hd ** 0.5
    ms = cuda_ms(lambda: flash_attention_bshd(q, k, v, out, mode=mode,
                                              window=window, scale=scale))
    plain_ms = cuda_ms(lambda: flash_attention_ref(q, k, v, mode=mode,
                                                   window=window), reps=5)
    # Library: one SDPA call on (B, H, S, hd) views of the same tensors.
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = None
    if mode == "sliding":
        d = (torch.arange(S, device="cuda")[:, None]
             - torch.arange(S, device="cuda")[None, :])
        mask = (d >= 0) & (d < window)
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=mask, is_causal=mode == "causal",
        enable_gqa=True)
    lib_err, lib_ok = _attn_err(lib().transpose(1, 2), want, name)
    assert lib_ok, f"library attention disagrees: {lib_err}"
    library_ms = cuda_ms(lib)
    dev_ms = device_ms(lambda: flash_attention_bshd(
        q, k, v, out, mode=mode, window=window, scale=scale))
    g_ms = graph_ms(lambda: flash_attention_bshd(
        q, k, v, out, mode=mode, window=window, scale=scale))
    library_dev_ms = device_ms(lib)
    library_g_ms = graph_ms(lib)
    # Operations over the (q, k) pairs the mask keeps (positions 0..S-1
    # against 0..T-1): whatever tiles a kernel visits, these inputs need
    # no more.
    if mode == "full":
        pairs = S * T
    else:
        reach = S if mode == "causal" else window
        pairs = sum(min(i + 1, reach) for i in range(S))
    flops = 4 * B * H * hd * pairs
    nbytes = q.element_size() * (2 * B * S * H * hd + 2 * B * T * KV * hd)
    peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
    bms, by = bound(nbytes, flops, peak)
    return dict(shape=dict(B=B, S=S, T=T, H=H, KV=KV, hd=hd, dtype=name,
                           mode=mode, window=window),
                route=route, max_abs_err=err, row_rel_err=rel, ms=ms,
                device_ms=dev_ms, graph_ms=g_ms,
                library_device_ms=library_dev_ms,
                library_graph_ms=library_g_ms, plain_ms=plain_ms,
                library_ms=library_ms, library_err=lib_err, bound_ms=bms,
                bound_by=by, flops=flops, bytes=nbytes,
                peak="bf16 tensor cores" if peak == BF16_FLOP_PER_S
                else "fp32")


def check_decode(gen, B, W, H, KV, hd, dtype, pos, window=0, kv_dtype=None):
    """decode_attention against its plain version: one token at absolute
    position ``pos`` against a W-slot ring (wrapped once pos >= W, and
    inside ``window`` when given). ``pos=None`` makes a row with no valid
    slot, whose output is the mean of V (the plain version, as JAX's
    reference); SDPA has no such answer, so that check times no library
    call. With ``kv_dtype`` (fp8) the cache is stored in it, and the
    kernel on it must equal the kernel on the cache cast to q's dtype bit
    for bit; the bound counts its 1-byte K / V, and the library time is
    the cast plus SDPA on the cast cache."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models.layers import astype

    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_bkv, sm_count, split_plan,
    )
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.models.attention import ring_valid

    mk = lambda *shape: torch.randn(shape, generator=gen, device="cuda",  # noqa: E731
                                    dtype=dtype)
    q, kc, vc = mk(B, 1, H, hd), mk(B, W, KV, hd), mk(B, W, KV, hd)
    if kv_dtype is not None:
        kc, vc = (astype(torch.randn((B, W, KV, hd), generator=gen,
                                     device="cuda") * 2, kv_dtype)
                  for _ in range(2))
    valid = (torch.zeros(W, dtype=torch.bool, device="cuda") if pos is None
             else ring_valid(pos, W, window, "cuda"))
    nv = int(valid.sum())
    name = str(dtype).split(".")[1]
    got = ops.decode_attention(q, kc, vc, valid)
    want = decode_attention_ref(q, kc, vc, valid)
    bitwise = None
    if kv_dtype is not None:
        up = ops.decode_attention(q, kc.to(dtype), vc.to(dtype), valid)
        bitwise = bool(torch.equal(got, up))
        assert bitwise, (f"decode_attention on the {kv_dtype} cache differs "
                         f"from the kernel on its cast to {dtype} at "
                         f"{(B, W, H, KV, hd)}")
    torch.cuda.synchronize()
    err, ok = _attn_err(got, want, name)
    rel, rel_ok = _row_rel_err(got, want, name)
    assert ok and rel_ok, (f"decode_attention disagrees at "
                           f"{(B, W, H, KV, hd, name, kv_dtype)}: max abs "
                           f"{err}, row-relative {rel}")
    out = torch.empty_like(q)
    n_split, per = split_plan(B, W, KV, sm_count(0))
    ws = (None, None)
    if n_split > 1:
        ws = (torch.empty((B, KV, n_split, H // KV, hd), device="cuda"),
              torch.empty((B, KV, n_split, H // KV, 2), device="cuda"))
    ms = cuda_ms(lambda: decode_attention_bkv(
        q, kc, vc, valid, out, *ws, n_split=n_split, tiles_per_split=per,
        scale=1.0 / hd ** 0.5))
    plain_ms = cuda_ms(lambda: decode_attention_ref(q, kc, vc, valid))
    dev_ms = device_ms(lambda: decode_attention_bkv(
        q, kc, vc, valid, out, *ws, n_split=n_split, tiles_per_split=per,
        scale=1.0 / hd ** 0.5))
    g_ms = graph_ms(lambda: decode_attention_bkv(
        q, kc, vc, valid, out, *ws, n_split=n_split, tiles_per_split=per,
        scale=1.0 / hd ** 0.5))
    library_ms = library_dev_ms = lib_err = None
    if nv:
        qt = q.transpose(1, 2)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kc.to(dtype).transpose(1, 2), vc.to(dtype).transpose(1, 2),
            attn_mask=valid.view(1, 1, 1, W), enable_gqa=True)
        lib_err, lib_ok = _attn_err(lib().transpose(1, 2), want, name)
        assert lib_ok, f"library attention disagrees: {lib_err}"
        library_ms = cuda_ms(lib)
        library_dev_ms = device_ms(lib)
    # What this run's data needs: the valid slots' K and V once, q, o and
    # the (W,) mask; 4 operations per (head, valid slot, hd). A row with
    # no valid slot needs V once and one addition per element of it.
    es, es_kv = q.element_size(), kc.element_size()
    nbytes = es_kv * 2 * B * nv * KV * hd + es * 2 * B * H * hd + W
    flops = 4 * B * H * nv * hd
    if not nv:
        nbytes += es_kv * B * W * KV * hd
        flops = B * W * KV * hd
    peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
    bms, by = bound(nbytes, flops, peak)
    return dict(shape=dict(B=B, W=W, H=H, KV=KV, hd=hd, dtype=name, pos=pos,
                           window=window, valid=nv,
                           kv_dtype=str(kc.dtype).split(".")[1]),
                bitwise_vs_upcast=bitwise, library=(
                    "cast to q's dtype + SDPA" if kv_dtype is not None
                    else "SDPA"),
                n_split=n_split, tiles_per_split=per, blocks=n_split * B * KV,
                device_ms=dev_ms, graph_ms=g_ms,
                library_device_ms=library_dev_ms,
                max_abs_err=err, row_rel_err=rel, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, library_err=lib_err, bound_ms=bms,
                bound_by=by, flops=flops, bytes=nbytes)


def check_ssd(gen, B, L, H, P, N, dtype, chunk=128):
    """ssd_scan against its plain version on the model's layout: x, B and
    C are views of one (B, L, H P + 2 N) projection, as mamba2_forward
    passes them; y and h_final are both held to the SSD tolerance. The
    timed calls run the op's plan (``ssd_plan``) into the checked outputs;
    the bound takes the peak of the route that ran (bf16 tensor cores for
    one_chunk / chunked, FP32 for fma), with the FP32 one beside it."""
    import torch

    from repro_torch.kernels.decode_attention.kernel import sm_count
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.kernel import (
        ssd_plan, ssd_scan_bhp, tensor_core_aligned, workspace,
    )
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    xBC = torch.randn((B, L, H * P + 2 * N), generator=gen, device="cuda",
                      dtype=dtype)
    xs, Bi, Ci = torch.split(xBC, [H * P, N, N], dim=-1)
    x = xs.reshape(B, L, H, P)
    dt = torch.rand((B, L, H), generator=gen, device="cuda") * 0.099 + 0.001
    A = -(torch.rand((H,), generator=gen, device="cuda") * 3.5 + 0.5)
    D = torch.randn((H,), generator=gen, device="cuda")
    args = (x, dt, A, Bi, Ci, D)
    name = str(dtype).split(".")[1]
    tol = SSD_TOL[name]
    chunk = min(chunk, L)          # what ops.ssd_scan launches
    plan = ssd_plan(B, L, H, P, N, chunk, dtype,
                    tensor_core_aligned(x, Bi, Ci), n_sm=sm_count(0))
    n_route = ops.ROUTE_LAUNCHES[plan["route"]]
    got = ops.ssd_scan(*args, chunk=chunk)
    assert ops.ROUTE_LAUNCHES[plan["route"]] == n_route + 1
    want = ssd_scan_ref(*args, chunk=chunk)
    torch.cuda.synchronize()
    errs = []
    for g, w in zip(got, want):
        diff = (g.float() - w.float()).abs()
        errs.append(float(diff.max()))
        assert bool((diff <= tol + tol * w.float().abs()).all()
                    and g.float().isfinite().all()), (
            f"ssd_scan disagrees at {(B, L, H, P, N, name, chunk)}: "
            f"max abs err {errs[-1]}")
    y, h = got
    ws = workspace(plan, B, H, N, P, "cuda")
    run = lambda: ssd_scan_bhp(*args, y, h, *ws, plan=plan)  # noqa: E731
    ms = cuda_ms(run)
    dev_ms = device_ms(run)
    g_ms = graph_ms(run)
    plain_ms = cuda_ms(lambda: ssd_scan_ref(*args, chunk=chunk),
                       reps=5 if L > 512 else 20)
    # Bytes: x, B, C, y in the input dtype, dt, A, D and h_final in f32,
    # each once. Operations, per batch row and chunk of q rows inside L:
    # C B^T over the lower triangle once (B and C are shared by the
    # heads), then per head the masked M x, the state's B^T (w x) and,
    # after the first chunk (h = 0 before it), its C h: 2 per FMA.
    es = x.element_size()
    nbytes = (es * (2 * B * L * H * P + 2 * B * L * N)
              + 4 * (B * L * H + 2 * H + B * H * N * P))
    flops = 0
    for c0 in range(0, L, chunk):
        q = min(chunk, L - c0)
        per_head = q * (q + 1) * P + 2 * q * N * P * (2 if c0 else 1)
        flops += B * (q * (q + 1) * N + H * per_head)
    peak = BF16_FLOP_PER_S if plan["tensor_cores"] else FP32_FLOP_PER_S
    bms, by = bound(nbytes, flops, peak)
    bms32, by32 = bound(nbytes, flops)
    return dict(shape=dict(B=B, L=L, H=H, P=P, N=N, dtype=name,
                           chunk=chunk),
                route=plan["route"], heads_per_block=plan["heads_per_block"],
                p_tile=plan["p_tile"], launches_per_call=plan["launches"],
                max_abs_err=max(errs), max_abs_err_y=errs[0],
                max_abs_err_h=errs[1], ms=ms, device_ms=dev_ms, graph_ms=g_ms,
                plain_ms=plain_ms,
                library_ms=None, bound_ms=bms, bound_by=by,
                peak="bf16 tensor cores" if plan["tensor_cores"] else "fp32",
                bound_ms_fp32=bms32, bound_by_fp32=by32, flops=flops,
                bytes=nbytes)


# The served portfolio, the JAX driver's default trio: (arch, tier,
# layers kept of the FULL config).
ARMS = (("olmo-1b", "budget", None), ("mamba2-370m", "mid", None),
        ("deepseek-67b", "frontier", 4))
SERVE_BUDGET = 6.6e-4
SERVE_NEW_TOKENS = 8


def init_arm(i, arch, tier, layers, tag="serve"):
    """A ServedModel of ``arch``'s FULL config on the card, its depth cut
    to ``layers`` when given, bf16 weights from seed ``i``, priced from
    the FULL config."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.core.costs import price_from_active_params
    from repro_torch.serving import ServedModel

    full = configs.get_config(arch)
    cfg = full
    if layers is not None:
        cfg = dataclasses.replace(full, num_layers=layers)
        print(f"[{tag}] reduced: {arch} depth {full.num_layers} -> "
              f"{layers} layers at full width (d_model {full.d_model}, "
              f"{full.num_heads} heads, {full.num_kv_heads} kv heads, "
              f"d_ff {full.d_ff}, vocab {full.vocab_size}): "
              f"{full.total_params() * 2 / 1e9:.0f} GB of bf16 weights "
              "do not fit one card")
    pricing = price_from_active_params(arch, full.active_params(),
                                       mean_req_tokens=600)
    torch.cuda.synchronize()
    t0, mem0 = time.perf_counter(), torch.cuda.memory_allocated()
    model = ServedModel.init(cfg, pricing, tier, seed=i, device="cuda")
    torch.cuda.synchronize()
    gb = (torch.cuda.memory_allocated() - mem0) / 1e9
    print(f"[{tag}] arm {i}: {arch} {cfg.num_layers} layers, "
          f"{cfg.total_params() / 1e9:.3f} B params in {cfg.dtype}, "
          f"{gb:.2f} GB on the card, ${pricing.price_per_1k:.3e}/1k tok "
          f"({tier}), init {time.perf_counter() - t0:.2f} s")
    return model


def build_portfolio(arms=ARMS, tag="serve"):
    """The PortfolioServer of ``arms`` at full width on the card."""
    from repro_torch.core.features import fit_pca_whitener, hash_encode_batch
    from repro_torch.core.types import RouterConfig
    from repro_torch.data import make_request_stream
    from repro_torch.serving import PortfolioServer

    models = [init_arm(i, *arm, tag=tag) for i, arm in enumerate(arms)]
    corpus = [r["prompt"] for r in make_request_stream(400, seed=7)]
    whitener = fit_pca_whitener(hash_encode_batch(corpus), device="cuda")
    return PortfolioServer(models, whitener, budget=SERVE_BUDGET,
                           router_cfg=RouterConfig(max_arms=8),
                           max_new_tokens=SERVE_NEW_TOKENS, device="cuda")


def launches_per_request(cfg, new_tokens=SERVE_NEW_TOKENS):
    """The served kernels' launches for one request (a prefill, then
    ``new_tokens`` decode steps) of a model of ``cfg``: flash once per
    attention layer in prefill (the hybrid's shared block once per
    application; whisper's encoder layers and its decoder's cross-
    attention too), decode once per attention layer per token (whisper's
    cross-attention is an einsum), ssd_scan once per Mamba2 layer."""
    attn = cfg.num_layers
    if cfg.arch_type == "ssm":
        attn = 0
    elif cfg.arch_type == "hybrid":
        attn = cfg.num_layers // cfg.shared_attn_every
    cross = cfg.encoder_layers + cfg.num_layers if cfg.is_encdec else 0
    ssd = cfg.num_layers if cfg.arch_type in ("ssm", "hybrid") else 0
    return {"flash_attention": attn + cross,
            "decode_attention": attn * new_tokens, "ssd_scan": ssd}


def expected_launches(models, counts):
    """The served kernels' launches for ``counts[model name]`` requests of
    each of ``models``."""
    want = {"flash_attention": 0, "decode_attention": 0, "ssd_scan": 0}
    for model in models:
        for k, n in launches_per_request(model.cfg).items():
            want[k] += counts.get(model.name, 0) * n
    return want


def serve_requests(server, stream, window=8):
    """serve_batch in windows with deferred feedback, one learner tick per
    window (launch/serve.py's loop at publish cadence 1)."""
    import numpy as np

    results = []
    for i in range(0, len(stream), window):
        served = server.serve_batch(stream[i:i + window], defer_feedback=True)
        server.feedback_batch([r.request_id for r in served],
                              np.asarray([r.arm for r in served]),
                              np.asarray([r.reward for r in served]),
                              np.asarray([r.cost for r in served]))
        results.extend(served)
    return results


def _prompt(model, text):
    """A prompt as ServedModel.generate pads it: (1, S) on the card."""
    import numpy as np
    import torch

    from repro_torch.serving.tokenizer import HashTokenizer

    ids = HashTokenizer(model.cfg.vocab_size).encode(text)
    pad = (-len(ids)) % model.PROMPT_BUCKET
    toks = np.concatenate([np.ones(pad, np.int32), ids])[
        -4 * model.PROMPT_BUCKET:]
    return torch.as_tensor(toks[None], device="cuda")


def _seq_len(toks, extra):
    """Positions a prefill of ``toks`` fills: the text, after the VLM's
    frontend embeddings when given."""
    fe = (extra or {}).get("frontend")
    return toks.shape[1] + (0 if fe is None else fe.shape[1])


@contextlib.contextmanager
def top_k_choices():
    """Records the experts every MoE layer chooses (each call's (N, K)
    ids, in call order) while the context is open."""
    from repro_torch.models import moe

    inner, seen = moe._top_k, []

    def spy(probs, k):
        out = inner(probs, k)
        seen.append(out[1])
        return out
    moe._top_k = spy
    try:
        yield seen
    finally:
        moe._top_k = inner


def teacher_forced(model, text, dtype, n_tokens=SERVE_NEW_TOKENS,
                   extra=None):
    """One prompt (after ``extra``'s frontend embeddings or with its
    encoder frames) and ``n_tokens`` fixed tokens through the kernel route
    and the plain route with activations in ``dtype`` (the served bf16
    weights cast at use): (max abs logit difference, within the bf16
    tolerance, within the f32 tolerance, greedy-token agreement over the
    1 + n_tokens positions, the max abs difference between two plain
    routes that differ only in the prefill's summation order: naive and
    chunked, and for an MoE model the (token, layer) top-k choices that
    differ between the kernel and the plain route and their count, else
    None)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.models import decode_step, prefill_forward

    cfg = dataclasses.replace(model.cfg, dtype=dtype)
    extra = extra or {}
    toks = _prompt(model, text)
    fixed = np.random.default_rng(5).integers(2, cfg.vocab_size, n_tokens)
    runs, choices = {}, {}
    for prefill_impl, decode_impl in (("cuda", "cuda"),
                                      ("chunked", "chunked"),
                                      ("naive", "chunked")):
        with top_k_choices() as seen:
            logits, caches = prefill_forward(
                model.params, cfg, toks,
                cache_len=_seq_len(toks, extra) + n_tokens,
                impl=prefill_impl, **extra)
            out = [logits]
            for t in fixed:
                cur = torch.full((1, 1), int(t), device="cuda")
                logits, caches = decode_step(model.params, cfg, cur, caches,
                                             decode_impl)
                out.append(logits)
        runs[prefill_impl] = torch.stack(out)
        choices[prefill_impl] = seen
    err, ok = _attn_err(runs["cuda"], runs["chunked"], "bfloat16")
    _, ok32 = _attn_err(runs["cuda"], runs["chunked"], "float32")
    agree = float((runs["cuda"].argmax(-1) == runs["chunked"].argmax(-1))
                  .float().mean())
    plain_err, _ = _attn_err(runs["naive"], runs["chunked"], "bfloat16")
    moe_diff = None
    if cfg.is_moe:
        pairs = list(zip(choices["cuda"], choices["chunked"]))
        moe_diff = (sum(int((a != b).any(-1).sum()) for a, b in pairs),
                    sum(a.shape[0] for a, _ in pairs))
    return err, ok, ok32, agree, plain_err, moe_diff


def generate_greedy(model, toks, extra, n=SERVE_NEW_TOKENS):
    """``ServedModel.generate``'s greedy loop with ``extra`` inputs to the
    prefill (the VLM's frontend embeddings, whisper's encoder frames),
    which ``generate`` does not take: the n generated ids."""
    import numpy as np

    from repro_torch.models import decode_step, prefill_forward

    logits, caches = prefill_forward(model.params, model.cfg, toks,
                                     cache_len=_seq_len(toks, extra) + n,
                                     **extra)
    out = []
    cur = logits.argmax(-1)[:, None]
    for _ in range(n):
        out.append(int(cur[0, 0]))
        logits, caches = decode_step(model.params, model.cfg, cur, caches)
        cur = logits.argmax(-1)[:, None]
    return np.asarray(out, np.int32)


# The served kernels' names (csrc/flash_attention.cu, decode_attention.cu,
# ssd_scan.cu), as the profiler reports them.
PORTED_KERNELS = ("flash_wgmma_kernel", "flash_kernel", "decode_split_kernel",
                  "decode_combine_kernel") + SSD_KERNELS


def trace_request(model, text, extra=None):
    """Host ms of prefill, of one decode token and of one whole request
    (prefill + 8 tokens; ``generate``, or ``generate_greedy`` with
    ``extra`` prefill inputs), each the least of 3 synchronised calls;
    then the request once under torch.profiler for its device busy ms and
    the ported kernels' share of device time (flash_attention,
    decode_attention, ssd_scan). The idle share is 1 - busy / the
    unprofiled request time (the profiler slows the host)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import decode_step, prefill_forward

    toks = _prompt(model, text)
    W = _seq_len(toks, extra) + SERVE_NEW_TOKENS
    extra = extra or {}
    _, caches = prefill_forward(model.params, model.cfg, toks, cache_len=W,
                                **extra)
    cur = torch.full((1, 1), 7, device="cuda")
    # decode_step writes its token's K/V at the same slot on every call
    # with these caches, so repeated calls time the same step (an SSM's
    # state moves on, at the same cost).
    ids = toks[0].cpu().numpy()
    request = lambda: model.generate(ids, SERVE_NEW_TOKENS)  # noqa: E731
    if extra:
        request = lambda: generate_greedy(model, toks, extra)  # noqa: E731
    prefill_ms, token_ms, wall_ms = host_ms([
        lambda: prefill_forward(model.params, model.cfg, toks, cache_len=W,
                                **extra),
        lambda: decode_step(model.params, model.cfg, cur, caches), request])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        request()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert kernels, "the profiler recorded no device kernel"
    us = lambda es: sum(e.time_range.elapsed_us() for e in es)  # noqa: E731
    busy = us(kernels) / 1e3
    by_name = {}
    for e in kernels:
        name = next((k for k in PORTED_KERNELS if k in e.name), None)
        if name:
            n, t = by_name.get(name, (0, 0.0))
            by_name[name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    ours = sum(t for _, t in by_name.values())
    return dict(prefill_ms=prefill_ms, token_ms=token_ms,
                request_ms=wall_ms, busy_ms=busy, idle_share=1 - busy / wall_ms,
                kernels=len(kernels), ported_ms=ours,
                ported_share=ours / busy,
                ported_by_kernel={k: dict(launches=n, ms=round(t, 4))
                                  for k, (n, t) in by_name.items()})


def step_launches(seg_lens, batch_size):
    """linucb_step's launches by route for a run of segments of
    ``seg_lens`` requests: ceil(L / B) blocks each, a trailing partial
    block run as one smaller block; a block of one takes ``single``."""
    B = batch_size or 1
    out = {"single": 0, "pdl": 0}
    for L in seg_lens:
        sizes = [B] * (L // B) + ([L % B] if L % B else [])
        for n in sizes:
            out["single" if n <= 1 else "pdl"] += 1
    return out


def scenario_phase(bench, priors):
    """Phase 10: the scenario engine (evaluate.run_scenario) on the card.
    Returns linucb_step's launches by route in this phase and what the
    specs imply."""
    import numpy as np
    import torch

    from repro_torch.core import evaluate, registry, simulator
    from repro_torch.core.scenario import (
        AddArm, PriceChange, QualityShift, ScenarioSpec, Timeline, retime,
    )
    from repro_torch.core.types import HyperParams, RouterConfig

    expect = {"single": 0, "pdl": 0}

    def count(seg_lens, bs):
        for r, n in step_launches(seg_lens, bs).items():
            expect[r] += n

    def run(cfg, spec, env, budget, seeds, bs, pri, label, timeline=None,
            fused=True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = evaluate.run_scenario(cfg, spec, env, budget, seeds=seeds,
                                    priors=pri, n_eff=N_EFF, batch_size=bs,
                                    timeline=timeline)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        h = (spec if timeline is None else retime(spec, timeline)).horizon
        assert res.arms.shape == (len(seeds), h)
        assert np.isfinite(res.rewards).all() and np.isfinite(res.costs).all()
        if fused:
            count([spec.horizon] if timeline is not None
                  else [b - a for a, b in spec.segments], bs)
        segs = [res.segment(j) for j in range(res.n_segments)]
        print(f"[scenario] {label} batch_size={bs} budget={budget}: mean "
              f"reward by segment {[round(x.mean_reward, 6) for x in segs]}, "
              f"compliance {[round(x.compliance(budget), 6) for x in segs]}, "
              f"allocation "
              f"{[x.allocation(env.k).round(4).tolist() for x in segs]}, "
              f"wall {secs:.3f} s, decisions/s {res.arms.size / secs:.1f}")
        return res

    def same_arms(a, b, what):
        assert np.array_equal(a, b), f"{what}: arms differ"

    # (a) The paper-claims protocols as specs, request by request.
    cfg = RouterConfig()
    pri3, pri4 = list(priors), list(priors) + [None]
    test = bench.test
    drift = run(cfg, ScenarioSpec(horizon=3 * TWIN_PHASE, events=(
        PriceChange(TWIN_PHASE, GEMINI, 1 / 56),
        PriceChange(2 * TWIN_PHASE, GEMINI, 1.0)), stream_seed_base=100,
        replay=((2, 0),)), test, BUDGET_TIGHT, TWIN_SEEDS, None, pri3,
        "twin drift")
    lift = drift.segment(1).mean_reward - drift.segment(0).mean_reward
    comp3 = drift.segment(2).compliance(BUDGET_TIGHT)
    print(f"[scenario] twin drift: reward lift {lift:.6f} (bar 0.02), phase-3 "
          f"compliance {comp3:.6f} (bar (0.85, 1.15))")
    assert lift > 0.02 and 0.85 < comp3 < 1.15
    envs = [simulator.three_phase_stream(
        test, lambda e: simulator.with_price_multiplier(e, GEMINI, 1 / 56),
        np.random.default_rng(100 + s), phase_len=TWIN_PHASE)
        for s in TWIN_SEEDS]
    hand = evaluate.run(cfg, envs, BUDGET_TIGHT, seeds=TWIN_SEEDS,
                        priors=pri3, n_eff=N_EFF, shuffle=False)
    count([3 * TWIN_PHASE], None)
    same_arms(hand.arms, drift.arms, "twin drift against its hand-rolled loop")

    reg = run(cfg, ScenarioSpec(horizon=3 * TWIN_PHASE, events=(
        QualityShift(TWIN_PHASE, MISTRAL, 0.75),
        QualityShift(2 * TWIN_PHASE, MISTRAL, None)), stream_seed_base=200,
        replay=((2, 0),)), test, BUDGET_MODERATE, TWIN_SEEDS, None, pri3,
        "twin regression")
    m1 = reg.segment(0).allocation(3)[MISTRAL]
    m2 = reg.phase(3 * TWIN_PHASE // 2, 2 * TWIN_PHASE).allocation(3)[MISTRAL]
    rec = reg.segment(2).mean_reward / reg.segment(0).mean_reward
    comp = reg.compliance(BUDGET_MODERATE)
    print(f"[scenario] twin regression: mistral share {m1:.4f} -> {m2:.4f} "
          f"(bar < 0.65x), recovery {rec:.6f} (bar 0.93), compliance "
          f"{comp:.6f} (bar (0.8, 1.1))")
    assert m2 < 0.65 * m1 and rec > 0.93 and 0.8 < comp < 1.1

    onboard = ScenarioSpec(horizon=3 * TWIN_PHASE,
                           events=(AddArm(TWIN_PHASE, FLASH),),
                           segment_seeds=(300, 400), init_active=3)
    for name in ("good_cheap", "bad_cheap"):
        env4 = simulator.extend_with_flash(test, name)
        res = run(cfg, onboard, env4, BUDGET_MODERATE, TWIN_SEEDS, None, pri4,
                  f"twin onboarding {name}")
        tail = float((res.phase(2 * TWIN_PHASE, 3 * TWIN_PHASE).arms
                      == FLASH).mean())
        burn = res.segment(1).arms
        bar = "> 0.02" if name == "good_cheap" else "< 0.02"
        print(f"[scenario] twin onboarding {name}: newcomer share in the last "
              f"{TWIN_PHASE} steps {tail:.4f} (bar {bar})")
        if name == "good_cheap":
            assert tail > 0.02
            s1 = [env4.repeat_to(TWIN_PHASE, np.random.default_rng(300 + s))
                  for s in TWIN_SEEDS]
            s2 = [env4.repeat_to(2 * TWIN_PHASE,
                                 np.random.default_rng(400 + s))
                  for s in TWIN_SEEDS]
            st = evaluate.make_states(cfg, env4, BUDGET_MODERATE, TWIN_SEEDS,
                                      priors=pri4, n_eff=N_EFF, active_arms=3)
            h1, st = evaluate.run(cfg, s1, BUDGET_MODERATE, seeds=TWIN_SEEDS,
                                  states=st, shuffle=False, return_states=True)
            st = registry.add_arm(
                cfg, st, FLASH, float(env4.prices_per_req[FLASH]),
                float(env4.prices_per_1k[FLASH]), forced_exploration=True)
            h2 = evaluate.run(cfg, s2, BUDGET_MODERATE, seeds=TWIN_SEEDS,
                              states=st, shuffle=False)
            count([TWIN_PHASE, 2 * TWIN_PHASE], None)
            same_arms(np.concatenate([h1.arms, h2.arms], 1), res.arms,
                      "twin onboarding against its hand-rolled loop")
        else:
            assert tail < 0.02
            assert (burn[:, :cfg.forced_pulls] == FLASH).all()
            assert not (burn[:, cfg.forced_pulls:40] == FLASH).all()
    print("[scenario] twin bars met; drift and good_cheap onboarding equal "
          "their hand-rolled loops arm for arm")

    # (b) The benchmarks' protocols at SCENARIO_PHASE against the oracle.
    pareto = RouterConfig(hyper=HyperParams(**PARETO_HYPER))
    oracle = RouterConfig(backend="torch", hyper=HyperParams(**PARETO_HYPER))
    drift_spec = lambda recal: ScenarioSpec(  # noqa: E731
        horizon=3 * SCENARIO_PHASE, events=(
            PriceChange(SCENARIO_PHASE, GEMINI, PRICE_MULT,
                        recalibrate=recal),
            PriceChange(2 * SCENARIO_PHASE, GEMINI, 1.0, recalibrate=recal)),
        stream_seed_base=1000, replay=((2, 0),))
    protocols = [
        ("drift silent", drift_spec(False), test, BUDGET_TIGHT, pri3),
        ("drift recalibrated", drift_spec(True), test, BUDGET_TIGHT, pri3),
        ("regression 0.75", ScenarioSpec(
            horizon=3 * SCENARIO_PHASE, events=(
                QualityShift(SCENARIO_PHASE, MISTRAL, 0.75),
                QualityShift(2 * SCENARIO_PHASE, MISTRAL, None)),
            stream_seed_base=2000,
            replay=((2, 0),)), test, BUDGET_MODERATE, pri3),
        ("onboarding good_cheap", ScenarioSpec(
            horizon=3 * SCENARIO_PHASE,
            events=(AddArm(SCENARIO_PHASE, FLASH),),
            segment_seeds=(3000, 4000), init_active=3),
         simulator.extend_with_flash(test, "good_cheap"), BUDGET_MODERATE,
         pri4),
    ]
    for label, spec, env, budget, pri in protocols:
        sizes = ((None, SCENARIO_BLOCK) if label == "drift silent"
                 else (SCENARIO_BLOCK,))
        for bs in sizes:
            got = run(pareto, spec, env, budget, SEEDS, bs, pri, label)
            ref = run(oracle, spec, env, budget, SEEDS, bs, pri,
                      f"{label} (oracle)", fused=False)
            for j in range(got.n_segments):
                a, b = got.segment(j), ref.segment(j)
                agree = float((a.arms == b.arms).mean())
                dr = abs(a.mean_reward - b.mean_reward)
                print(f"[scenario] {label} batch_size={bs} segment {j}: arm "
                      f"agreement with the oracle {agree:.6f}, "
                      f"|d mean reward| {dr:.3e}")
                assert agree >= 0.99 and dr <= 1e-3, (label, bs, j)

    # (c) Timeline identity: the masked runner against the retimed spec.
    spec = ScenarioSpec(horizon=4 * SCENARIO_BLOCK, events=(
        PriceChange(SCENARIO_PHASE, GEMINI, PRICE_MULT),
        PriceChange(2 * SCENARIO_PHASE, GEMINI, 1.0)), stream_seed_base=1000)
    tl = Timeline((SCENARIO_BLOCK, 2 * SCENARIO_BLOCK),
                  horizon=3 * SCENARIO_BLOCK)
    for bs in (SCENARIO_BLOCK, None):
        masked = run(pareto, spec, test, BUDGET_TIGHT, SEEDS, bs, pri3,
                     "timeline", timeline=tl)
        base = run(pareto, retime(spec, tl), test, BUDGET_TIGHT, SEEDS, bs,
                   pri3, "timeline's retimed spec")
        for f in ("arms", "rewards", "costs", "lams"):
            assert np.array_equal(getattr(masked, f),
                                  getattr(base, f)), (bs, f)
        assert masked.bounds == base.bounds
        print(f"[scenario] timeline batch_size={bs}: identical to the retimed "
              f"spec on the {tl.horizon} live steps (arms, rewards, costs, "
              f"lams); bounds {masked.bounds}")
    return expect


def _identical(got, want, what):
    """Arms, rewards, costs and lams equal bit for bit."""
    import numpy as np

    for f in ("arms", "rewards", "costs", "lams"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), (what, f)


def _timed(fn):
    """(result, wall s) of ``fn()`` between two synchronisations."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _wall(label, secs, decisions):
    print(f"[sweep] {label}: wall {secs:.3f} s, decisions/s "
          f"{decisions / secs:.1f}")


def sweep_pareto(bench, priors, expect):
    """Phase 11 (a): Fig. 1's eight conditions x 20 seeds as one stack of
    160 states, per request and in blocks of 256, against looped
    evaluate.run calls; chunked and split stacks against the whole."""
    import numpy as np

    from repro_torch.core import evaluate, sweep
    from repro_torch.core.types import HyperParams, RouterConfig

    cfg = RouterConfig(hyper=HyperParams(**PARETO_HYPER))
    assert cfg.backend == "fused"
    test = bench.test.subset(np.arange(SWEEP_N))
    budgets = BUDGET_SWEEP + (1.0,)
    C, T = len(budgets), test.n
    kw = dict(seeds=SEEDS, priors=priors, n_eff=N_EFF)

    def launches(n_stacks, bs):
        for r, n in step_launches([T], bs).items():
            expect[r] += n * n_stacks

    grid, secs = _timed(lambda: sweep.run_grid(cfg, test, budgets, **kw))
    launches(1, None)
    _wall(f"pareto grid {C} x {len(SEEDS)} per request", secs, grid.arms.size)
    for i, b in enumerate(budgets):
        res = grid.condition(i)
        assert np.isfinite(res.rewards).all() and np.isfinite(res.costs).all()
        print(f"[sweep] pareto budget {b}: compliance "
              f"{res.compliance(b):.6f}, mean reward {res.mean_reward:.6f}")
    b = BUDGET_SWEEP[0]
    ref, secs = _timed(lambda: evaluate.run(cfg, test, b, **kw))
    launches(1, None)
    _identical(grid.condition(0), ref, ("per request", b))
    _wall(f"pareto looped evaluate.run per request at {b}", secs,
          ref.arms.size)
    print(f"[sweep] pareto per request: condition {b} identical to its "
          f"looped run")

    bs = SCENARIO_BLOCK
    grid, secs = _timed(lambda: sweep.run_grid(cfg, test, budgets,
                                               batch_size=bs, **kw))
    launches(1, bs)
    _wall(f"pareto grid {C} x {len(SEEDS)} in blocks of {bs}", secs,
          grid.arms.size)
    looped, probe = 0.0, (0, 3, C - 1)
    for i in probe:
        ref, secs = _timed(lambda: evaluate.run(cfg, test, budgets[i],
                                                batch_size=bs, **kw))
        launches(1, bs)
        looped += secs
        _identical(grid.condition(i), ref, ("blocks", budgets[i]))
    _wall(f"pareto looped evaluate.run in blocks of {bs}, conditions "
          f"{[budgets[i] for i in probe]}", looped,
          len(probe) * ref.arms.size)
    chunked, secs = _timed(lambda: sweep.run_grid(
        cfg, test, budgets, batch_size=bs, chunk_size=40, **kw))
    launches(C * len(SEEDS) // 40, bs)
    _identical(chunked, grid, "chunk_size=40")
    _wall(f"pareto grid in blocks of {bs}, chunk_size=40", secs,
          grid.arms.size)
    split, secs = _timed(lambda: sweep.run_grid(
        cfg, test, budgets, batch_size=bs, devices=["cuda:0", "cuda:0"], **kw))
    launches(2, bs)
    _identical(split, grid, "devices=[cuda:0, cuda:0]")
    _wall(f"pareto grid in blocks of {bs}, split over [cuda:0, cuda:0]", secs,
          grid.arms.size)
    print(f"[sweep] pareto blocks of {bs}: {len(probe)} conditions identical "
          f"to their looped runs; chunk_size=40 and the two-part split "
          f"identical to the whole stack")


def sweep_knee(bench, priors, expect):
    """Phase 11 (b): the knee grid, 28 (alpha, gamma) cells x 5 budgets x
    10 seeds = 1,400 states per request on the val split, cells as (C,)
    HyperParams leaves with per-cell n_eff; three conditions against
    looped evaluate.run calls; each cell's AUC."""
    import numpy as np

    from repro_torch.core import evaluate, knee, sweep, warmup
    from repro_torch.core.types import HyperParams, RouterConfig

    cfg, val = RouterConfig(), bench.val.subset(np.arange(SWEEP_N))
    cells = [(a, g) for a in KNEE_ALPHAS for g in KNEE_GAMMAS]
    nb = len(KNEE_BUDGETS)
    n_effs = [warmup.t_adapt_to_n_eff(KNEE_T_ADAPT, g) for _, g in cells]
    budgets = [b for _ in cells for b in KNEE_BUDGETS]
    hyper = HyperParams(
        alpha=np.asarray([a for a, _ in cells for _ in range(nb)], np.float32),
        gamma=np.asarray([g for _, g in cells for _ in range(nb)], np.float32))
    grid, secs = _timed(lambda: sweep.run_grid(
        cfg, val, budgets, seeds=KNEE_SEEDS, priors=priors, hyper=hyper,
        n_eff=np.repeat(n_effs, nb)))
    for r, n in step_launches([val.n], None).items():
        expect[r] += n
    assert grid.arms.shape == (len(budgets), len(KNEE_SEEDS), val.n)
    _wall(f"knee grid {len(budgets)} x {len(KNEE_SEEDS)} = "
          f"{len(budgets) * len(KNEE_SEEDS)} states per request", secs,
          grid.arms.size)
    # One cell inside the stack, with another alpha, gamma, budget and
    # n_eff than its neighbours.
    i = 7 * nb + 2
    a, g = cells[i // nb]
    ref, secs = _timed(lambda: evaluate.run(
        RouterConfig(hyper=HyperParams(alpha=a, gamma=g)), val,
        budgets[i], seeds=KNEE_SEEDS, priors=priors, n_eff=n_effs[i // nb]))
    for r, n in step_launches([val.n], None).items():
        expect[r] += n
    _identical(grid.condition(i), ref, ("knee", a, g, budgets[i]))
    _wall(f"knee looped evaluate.run alpha={a} gamma={g} "
          f"budget={budgets[i]}", secs, ref.arms.size)
    print(f"[sweep] knee: condition {i} identical to its looped run")
    aucs = {}
    for c, (a, g) in enumerate(cells):
        runs = [grid.condition(c * nb + j) for j in range(nb)]
        costs = np.asarray([max(r.mean_cost, 1e-7) for r in runs])
        auc = knee.auc_of_frontier(costs, np.asarray([r.mean_reward
                                                      for r in runs]))
        assert np.isfinite(auc)
        aucs[f"{a}/{g}"] = round(float(auc), 6)
    print(f"[sweep] knee AUC by alpha/gamma: {json.dumps(aucs)}")


def sweep_monte_carlo(bench, expect):
    """Phase 11 (c): the timeline Monte Carlo, 1,024 sampled timelines of
    a 240-step drift / regression / budget spec as one stack, 16 probes
    against run_scenario on their retimed specs, a resampled set through
    the same cached runner."""
    import numpy as np

    from repro_torch.core import evaluate, montecarlo, scenario
    from repro_torch.core.scenario import (
        BudgetChange, PriceChange, QualityShift, ScenarioSpec, retime,
    )
    from repro_torch.core.types import HyperParams, RouterConfig

    cfg = RouterConfig(hyper=HyperParams(**PARETO_HYPER))
    test, T = bench.test, MC_T
    spec = ScenarioSpec(horizon=T, events=(
        PriceChange(T // 3, GEMINI, 1 / 56), QualityShift(T // 2, MISTRAL, 0.70),
        BudgetChange(2 * T // 3, BUDGET_TIGHT)), stream_seed_base=7200)
    horizons = (3 * T // 4, T)
    tls = montecarlo.sample_timelines(spec, MC_N, seed=MC_SEED,
                                      horizons=horizons)
    kw = dict(seeds=(0,), n_eff=N_EFF)
    mc, secs = _timed(lambda: montecarlo.run_monte_carlo(
        cfg, spec, test, BUDGET_MODERATE, tls, **kw))
    expect["single"] += T
    live = sum(tl.horizon for tl in tls)
    _wall(f"monte carlo {MC_N} timelines x {T} steps (padded), "
          f"{live} live decisions", secs, live)
    runner = scenario.compiled_timeline_runner(cfg, spec, test, None)
    looped = 0.0
    for i in np.linspace(0, MC_N - 1, MC_PROBE).astype(int):
        rspec = retime(spec, tls[i])
        ref, secs = _timed(lambda: evaluate.run_scenario(
            cfg, rspec, test, BUDGET_MODERATE, **kw))
        expect["single"] += rspec.horizon
        looped += secs
        _identical(mc.grid.condition(int(i)), ref, ("timeline", int(i)))
        assert mc.grid.condition(int(i)).bounds == ref.bounds
    print(f"[sweep] monte carlo: {MC_PROBE} probe timelines identical to "
          f"run_scenario on their retimed specs; looped wall of the "
          f"{MC_PROBE} {looped:.3f} s ({looped / MC_PROBE:.3f} s each)")
    n_cached = len(scenario._RUNNER_CACHE)
    again = montecarlo.sample_timelines(spec, MC_N, seed=MC_SEED + 1,
                                        horizons=horizons)
    mc2, secs = _timed(lambda: montecarlo.run_monte_carlo(
        cfg, spec, test, BUDGET_MODERATE, again, **kw))
    expect["single"] += T
    assert len(scenario._RUNNER_CACHE) == n_cached
    assert scenario.compiled_timeline_runner(cfg, spec, test, None) is runner
    _wall(f"monte carlo resampled (seed {MC_SEED + 1}), same cached runner",
          secs, sum(tl.horizon for tl in again))
    for name, m in (("seed 11", mc), ("seed 12", mc2)):
        assert np.isfinite(m.lags).all() and np.isfinite(m.lifts).all()
        assert np.isfinite(m.compliance).all() and (m.compliance > 0).all()
        print(f"[sweep] monte carlo bands ({name}): "
              f"{json.dumps(m.bands())}")


def sweep_phase(bench, priors):
    """Phase 11: the sweep fabric on the card. Returns linucb_step's
    launches by route that its runs imply."""
    expect = {"single": 0, "pdl": 0}
    sweep_pareto(bench, priors, expect)
    sweep_knee(bench, priors, expect)
    sweep_monte_carlo(bench, expect)
    return expect


def tenant_cfg(backend="torch"):
    from repro_torch.core.types import HyperParams, RouterConfig

    return RouterConfig(hyper=HyperParams(**PARETO_HYPER), forced_pulls=0,
                        backend=backend)


_TESTBEDS = {}


def tenant_testbed(n):
    """The 10x-spread benchmark with n test prompts and its priors."""
    import numpy as np

    from repro_torch.core import evaluate, simulator

    if n not in _TESTBEDS:
        p1k = np.asarray(TENANT_PRICES) * 1e3 / simulator.MEAN_REQ_TOKENS
        b = simulator.make_benchmark(
            seed=0, prices_per_1k=p1k,
            splits={"train": 8374, "val": 1785, "test": n})
        priors = evaluate.fit_warmup_priors(tenant_cfg(), b.train)
        _TESTBEDS[n] = (b.test, list(priors)[: b.test.k])
    return _TESTBEDS[n]


def tenant_budgets(T):
    import numpy as np

    if T == 4:
        return np.asarray(TENANT_BUDGETS_T4, np.float32)
    rng = np.random.default_rng(0)
    lo, hi = np.log(TENANT_BAND[0]), np.log(TENANT_BAND[1])
    return np.exp(rng.uniform(lo, hi, T)).astype(np.float32)


def flash_mix(n, T):
    from repro_torch.data import synthetic

    return synthetic.flash_crowd_tenant_stream(
        n, T, hot=min(3, T - 1), start=n // 4, stop=n // 2, boost=8.0,
        seed=7)


def run_fleet(n, T, seeds):
    """One tenant fleet through evaluate.run: (res, finals, budgets, tids,
    wall s)."""
    import numpy as np

    from repro_torch.core import evaluate, tenancy

    env, priors = tenant_testbed(n)
    budgets, tids = tenant_budgets(T), flash_mix(n, T)
    (res, finals), secs = _timed(lambda: evaluate.run(
        tenant_cfg(), env, 1.0, seeds, batch_size=TENANT_BLOCK,
        priors=priors, n_eff=N_EFF, tenants=tenancy.make_table(budgets),
        tenant_ids=tids, return_states=True))
    assert res.arms.shape == (len(seeds), n)
    assert np.isfinite(res.costs).all() and np.isfinite(res.lams).all()
    return res, finals, budgets, tids, secs


def _tenant_wall(label, secs, decisions):
    print(f"[tenants] {label}: wall {secs:.3f} s, decisions/s "
          f"{decisions / secs:.1f}")


def tenant_fold_identity(T, n=TENANT_N, seeds=(0, 1)):
    """Phase 12 (a): every (seed, tenant) row of the fleet's final table
    equals folding that tenant's cost subsequence through the
    single-tenant pacer_update_batch on the card, bit for bit; spend the
    arrival-order f32 sum."""
    import numpy as np
    import torch

    from repro_torch.core import pacer
    from repro_torch.core.types import PacerState

    res, finals, budgets, tids, secs = run_fleet(n, T, seeds)
    _tenant_wall(f"fold identity T={T} n={n} seeds={len(seeds)}", secs,
                 res.arms.size)
    tab = finals.tenants
    dev = tab.lam.device
    hp = tenant_cfg().hyper.as_leaves(1, dev)
    got = {k: getattr(tab, k).cpu().numpy()
           for k in ("lam", "c_ema", "pulls", "spend")}
    for s in range(len(seeds)):
        for j in range(T):
            cs = np.asarray(res.costs[s][tids == j], np.float32)
            b = torch.full((1,), float(budgets[j]), device=dev)
            p0 = PacerState(lam=torch.zeros(1, device=dev), c_ema=b.clone(),
                            budget=b, enabled=torch.ones(1, dtype=torch.bool,
                                                         device=dev))
            pf = pacer.pacer_update_batch(
                hp, p0, torch.as_tensor(cs, device=dev)[None])
            assert got["lam"][s, j] == pf.lam.item(), (T, s, j, "lam")
            assert got["c_ema"][s, j] == pf.c_ema.item(), (T, s, j, "c_ema")
            assert int(got["pulls"][s, j]) == len(cs), (T, s, j, "pulls")
            spend = np.float32(0.0)
            for c in cs:                 # the same arrival-order f32 adds
                spend = np.float32(spend + c)
            assert got["spend"][s, j] == spend, (T, s, j, "spend")
    print(f"[tenants] fold identity T={T}: {len(seeds) * T} (seed, tenant) "
          f"rows, lam / c_ema / pulls / spend equal bit for bit to the "
          f"grouped single-tenant folds; lam range "
          f"[{got['lam'].min():.6f}, {got['lam'].max():.6f}]")
    return res.arms.size, secs


def tenant_compliance(n=32768, T=4, seeds=tuple(range(8))):
    """Phase 12 (b): per-tenant |steady-state mean cost / ceiling - 1|
    over the second half of the stream, seeds pooled."""
    import numpy as np

    res, _finals, budgets, tids, secs = run_fleet(n, T, seeds)
    _tenant_wall(f"compliance T={T} n={n} seeds={len(seeds)}", secs,
                 res.arms.size)
    costs = np.asarray(res.costs, np.float64)
    window = np.arange(n) >= n // 2
    devs = [abs(float(costs[:, (tids == j) & window].mean() / budgets[j])
                - 1.0) for j in range(T)]
    print(f"[tenants] compliance T={T}: per-tenant deviation "
          f"{[round(d, 6) for d in devs]}, max {max(devs):.6f} (gate <= "
          f"{COMPLIANCE_LINE})")
    assert max(devs) <= COMPLIANCE_LINE, f"T={T} compliance breached: {devs}"
    return res.arms.size, secs


def tenant_fleet_grid(n=TENANT_N, seeds=tuple(range(4))):
    """Phase 12 (c): a (tenant-table x seed) fleet grid as one run_grid
    call against the looped evaluate.run calls: identical, both walls."""
    import numpy as np

    from repro_torch.core import evaluate, sweep, tenancy

    env, priors = tenant_testbed(n)
    tids = flash_mix(n, 4)
    tables = [tenancy.make_table(tenant_budgets(4) * np.float32(f))
              for f in TENANT_SCALES]
    kw = dict(priors=priors, n_eff=N_EFF, batch_size=TENANT_BLOCK)
    C = len(TENANT_SCALES)
    grid, grid_s = _timed(lambda: sweep.run_grid(
        tenant_cfg(), env, [1.0] * C, seeds,
        tenant_tables=tenancy.stack_tables(tables), tenant_ids=tids, **kw))
    runs, looped_s = _timed(lambda: [evaluate.run(
        tenant_cfg(), env, 1.0, seeds, tenants=t, tenant_ids=tids, **kw)
        for t in tables])
    for i in range(C):
        _identical(grid.condition(i), runs[i], ("fleet grid", i))
    _tenant_wall(f"fleet grid {C} tables x {len(seeds)} seeds n={n}, one "
                 f"run_grid call", grid_s, grid.arms.size)
    _tenant_wall(f"fleet looped evaluate.run x {C}", looped_s, grid.arms.size)
    print(f"[tenants] fleet grid: all {C} conditions identical to their "
          f"looped runs; looped / grid wall {looped_s / grid_s:.3f}")
    return 2 * grid.arms.size, grid_s + looped_s


def tenant_gateway():
    """Phase 12 (d): a tenanted gateway under the flash mix, then save and
    restore(elapsed=50) against decay_on_restore of the saved state."""
    import shutil

    import numpy as np
    import torch

    from repro_torch import interop
    from repro_torch.core import evaluate, statehandle, tenancy
    from repro_torch.serving.gateway import MicroBatcher, RouterGateway

    n = GATEWAY_WINDOWS * GATEWAY_WINDOW
    env, priors = tenant_testbed(TENANT_N)
    cfg = tenant_cfg()
    state = evaluate.make_states(
        cfg, env, 1.0, (0,), priors=priors, n_eff=N_EFF,
        tenants=tenancy.make_table(tenant_budgets(4)))
    gw = RouterGateway(cfg, state, batcher=MicroBatcher(
        max_batch=GATEWAY_WINDOW), tenant_names=["a", "b", "c", "d"])
    tids = flash_mix(n, 4)
    X = env.contexts[:n].astype(np.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for w in range(GATEWAY_WINDOWS):
        rows = range(w * GATEWAY_WINDOW, (w + 1) * GATEWAY_WINDOW)
        out = [gw.submit(i, X[i], tenant=int(tids[i])) for i in rows]
        res = out[-1]
        assert res is not None and all(o is None for o in out[:-1])
        arms = np.asarray(res.arms)
        idx = np.asarray(list(rows))
        assert gw.enqueue_feedback(list(rows), arms, env.rewards[idx, arms],
                                   env.costs[idx, arms]) == GATEWAY_WINDOW
        assert gw.learn_tick() is not None
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    tab = gw.live_state.tenants
    assert tab.pulls[0].tolist() == np.bincount(tids, minlength=4).tolist()
    m = gw.metrics()
    lams = [round(m[f"tenant_lam_{j}"], 6) for j in range(4)]
    comp = [round(m[f"tenant_compliance_{j}"], 4) for j in range(4)]
    print(f"[tenants] gateway: {GATEWAY_WINDOWS} windows of {GATEWAY_WINDOW} "
          f"routed, fed back and learned in {secs:.3f} s ({n / secs:.1f} "
          f"decisions/s); tenant lam {lams}, compliance {comp}")
    snap_dir = os.path.join(ROOT, "build", "tenant_snapshot")
    os.makedirs(snap_dir, exist_ok=True)
    try:
        path = os.path.join(snap_dir, "router")
        saved = gw.save(path).state
        gw.restore(path, elapsed=RESTORE_ELAPSED)
    finally:
        shutil.rmtree(snap_dir, ignore_errors=True)
    want = interop.state_to_numpy(
        statehandle.decay_on_restore(cfg, saved, RESTORE_ELAPSED))
    got = interop.state_to_numpy(gw.live_state)
    worst = 0.0
    for k, v in want.items():
        for name, w_ in (v.items() if isinstance(v, dict) else [(k, v)]):
            g_ = got[k][name] if isinstance(v, dict) else got[k]
            err = float(np.max(np.abs(g_.astype(np.float64)
                                      - w_.astype(np.float64))))
            assert err <= RESTORE_TOL * (1 + float(np.max(np.abs(w_)))), (
                k, name, err)
            worst = max(worst, err)
    now, before = gw.live_state.tenants, saved.tenants
    assert bool((now.lam <= before.lam).all())
    assert bool((now.lam < before.lam)[before.lam > 0].all())
    assert bool(((now.c_ema - now.budget).abs()
                 <= (before.c_ema - before.budget).abs()).all())
    assert torch.equal(now.pulls, before.pulls)
    print(f"[tenants] gateway restore(elapsed={RESTORE_ELAPSED}): every leaf "
          f"within {RESTORE_TOL} of decay_on_restore of the saved state "
          f"(max |diff| {worst:.3e}); lam {before.lam[0].tolist()} -> "
          f"{now.lam[0].tolist()}, c_ema {before.c_ema[0].tolist()} -> "
          f"{now.c_ema[0].tolist()}")
    return n, secs


def tenant_phase():
    """Phase 12: the tenant plane on the card. Returns the phase's
    decisions and wall s by sub-phase."""
    import torch

    from repro_torch.core import evaluate, router, tenancy

    walls = {}
    for T in (8, 64):
        walls[f"fold_T{T}"] = tenant_fold_identity(T)
    walls["compliance_T4"] = tenant_compliance()
    walls["fleet"] = tenant_fleet_grid()
    walls["gateway"] = tenant_gateway()
    # The kernels take one dual per state: a tenant block on "fused" is
    # refused before it launches anything, as in the JAX package.
    env, _priors = tenant_testbed(TENANT_N)
    st = evaluate.make_states(tenant_cfg("fused"), env, 1.0, (0,),
                              tenants=tenancy.make_table(tenant_budgets(4)))
    X = torch.as_tensor(env.contexts[None, :8], dtype=torch.float32,
                        device=st.A.device)
    try:
        router.select_batch(tenant_cfg("fused"), st, X,
                            tenant_ids=torch.zeros((1, 8), dtype=torch.long))
    except NotImplementedError as e:
        print(f"[tenants] fused backend refuses tenant mode: {e}")
    else:
        raise AssertionError("tenant mode on 'fused' did not raise")
    return walls


# Phase 13, the rest of the model zoo at full width: (arch, tier, layers
# kept of the FULL config). The portfolio holds zamba2-2.7b and
# phi-3-vision-4.2b whole and dbrx-132b at 4 of its 40 layers (~41 GB of
# bf16 weights at once); llama4-maverick then has the card to itself at 2
# of its 48 layers (one dense and one MoE layer, ~37 GB); whisper-medium
# runs whole. Seeds follow the arms' order.
ZOO_ARMS = (("zamba2-2.7b", "budget", None),
            ("phi-3-vision-4.2b", "mid", None),
            ("dbrx-132b", "frontier", 4))
ZOO_LLAMA4 = ("llama4-maverick-400b-a17b", "frontier", 2)
ZOO_WHISPER = ("whisper-medium", "mid", None)
ZOO_REQUESTS = 24


def zoo_phase(stream):
    """Phase 13: the hybrid, MoE, VLM and encoder-decoder families on the
    card at full width. The served kernels' counters are zeroed just
    before each sub-phase's generates and read just after them; the
    launches must equal the per-family count (``launches_per_request``),
    every flash launch on the tensor cores, every ssd_scan launch on
    one_chunk. Then each arm's teacher-forced logits (kernel route
    against plain route) and its trace. Returns the served kernels'
    launches summed over the sub-phases."""
    import numpy as np
    import torch

    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.serving.tokenizer import HashTokenizer

    ops = {"flash_attention": flash_ops, "decode_attention": decode_ops,
           "ssd_scan": ssd_ops}
    total = dict.fromkeys(ops, 0)
    missed = []

    def zero():
        for mod in ops.values():
            mod.LAUNCHES[0] = 0
        for routes in (flash_ops.ROUTE_LAUNCHES, ssd_ops.ROUTE_LAUNCHES):
            for r in routes:
                routes[r] = 0

    def read(label, want):
        got = {k: mod.LAUNCHES[0] for k, mod in ops.items()}
        flash_routes = dict(flash_ops.ROUTE_LAUNCHES)
        ssd_routes = dict(ssd_ops.ROUTE_LAUNCHES)
        print(f"[zoo] {label}: served-kernel launches {got}, expected from "
              f"the families {want}; flash_attention by route "
              f"{flash_routes}, ssd_scan by route {ssd_routes}")
        assert got == want, (label, got, want)
        assert flash_routes["tensor_cores"] == got["flash_attention"], (
            flash_routes)
        assert ssd_routes["one_chunk"] == got["ssd_scan"], ssd_routes
        for k in total:
            total[k] += got[k]

    def check(model, label, extra=None):
        """Teacher-forced logits in bf16 and f32 and the trace of one
        request. f32 is held to phase 8's bar; bf16 to 2x what two plain
        routes differ by, but for MoE arms, where a one-ulp change can
        send a token to another expert, the bf16 ratio is printed beside
        the count of (token, layer) choices that differ."""
        for dtype in ("bfloat16", "float32"):
            err, ok, ok32, agree, plain_err, moe_diff = teacher_forced(
                model, stream[0]["prompt"], dtype, extra=extra)
            diff = ("" if moe_diff is None else
                    f"; MoE top-k choices that differ between the routes "
                    f"{moe_diff[0]} of {moe_diff[1]} (token, layer) rows")
            print(f"[zoo] teacher-forced {label} {dtype} activations: max "
                  f"|logit diff| {err:.4e} (bf16 tolerance "
                  f"{'met' if ok else 'missed'}, f32 tolerance "
                  f"{'met' if ok32 else 'missed'}), greedy-token agreement "
                  f"{agree:.4f}; two plain routes differ by {plain_err:.4e}"
                  f" (kernel route / that "
                  f"{err / plain_err if plain_err else float('nan'):.3f})"
                  f"{diff}")
            if dtype == "float32" and not ok:
                missed.append(f"{label} f32")
            if (dtype == "bfloat16" and moe_diff is None
                    and err > TEACHER_BF16_FACTOR * plain_err):
                missed.append(f"{label} bf16: {err:.4e} > "
                              f"{TEACHER_BF16_FACTOR} x {plain_err:.4e}")
        t = trace_request(model, stream[0]["prompt"], extra)
        print(f"[zoo] trace {label} one request: prefill "
              f"{t['prefill_ms']:.3f} ms host clock, one decode token "
              f"{t['token_ms']:.3f} ms; whole request (prefill + "
              f"{SERVE_NEW_TOKENS} tokens) {t['request_ms']:.3f} ms, device "
              f"busy {t['busy_ms']:.3f} ms in {t['kernels']} kernels (idle "
              f"share {t['idle_share']:.4f}), ported kernels "
              f"{t['ported_ms']:.3f} ms ({t['ported_share']:.4f} of "
              f"device time): {json.dumps(t['ported_by_kernel'])}")

    def wall(label, t0):
        torch.cuda.synchronize()
        print(f"[zoo] {label} wall {time.perf_counter() - t0:.1f} s; peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated")
        torch.cuda.reset_peak_memory_stats()

    def frames(shape, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return torch.randn(shape, generator=g, device="cuda")

    # (a) A portfolio of zamba2-2.7b, phi-3-vision (text) and dbrx-132b.
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    server = build_portfolio(ZOO_ARMS, tag="zoo")
    arms = server.models[:len(ZOO_ARMS)]
    print(f"[zoo] (a) portfolio on the card: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    zero()
    for model in arms:
        t1 = time.perf_counter()
        out = model.generate(
            server._tokenizer(model).encode(stream[0]["prompt"]),
            SERVE_NEW_TOKENS)
        torch.cuda.synchronize()
        assert out.shape == (SERVE_NEW_TOKENS,)
        assert ((0 <= out) & (out < model.cfg.vocab_size)).all()
        print(f"[zoo] {model.name} first generate {out.tolist()} in "
              f"{time.perf_counter() - t1:.3f} s")
    t1 = time.perf_counter()
    results = serve_requests(server, stream[:ZOO_REQUESTS])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t1
    traffic = {m.name: 0 for m in arms}
    for r in results:
        traffic[r.model] += 1
        assert r.tokens_out == SERVE_NEW_TOKENS
    reward = float(np.mean([r.reward for r in results]))
    cost = float(np.mean([r.cost for r in results]))
    assert len(results) == ZOO_REQUESTS and np.isfinite([reward, cost]).all()
    print(f"[zoo] (a) served {len(results)} requests in {secs:.3f} s: "
          f"reward {reward:.4f}, cost {cost:.4e}/req, traffic {traffic}, "
          f"lambda {float(server.state.pacer.lam[0]):.6f}")
    read("(a) first generates + the requests", expected_launches(
        arms, {m.name: traffic[m.name] + 1 for m in arms}))
    for model in arms:
        check(model, model.name)
    del server, arms, model, results
    torch.cuda.empty_cache()
    wall("(a)", t0)

    # (b) llama4-maverick, the card to itself: two generates.
    t0 = time.perf_counter()
    model = init_arm(len(ZOO_ARMS), *ZOO_LLAMA4, tag="zoo")
    zero()
    for req in stream[:2]:
        ids = HashTokenizer(model.cfg.vocab_size).encode(req["prompt"])
        out = model.generate(ids, SERVE_NEW_TOKENS)
        assert ((0 <= out) & (out < model.cfg.vocab_size)).all()
        print(f"[zoo] {model.name} generate {out.tolist()}")
    read("(b) two generates", expected_launches([model], {model.name: 2}))
    check(model, model.name)
    del model
    torch.cuda.empty_cache()
    wall("(b)", t0)

    # (c) whisper-medium on (1, 1,500, 80) frames and a 32-token prompt.
    t0 = time.perf_counter()
    model = init_arm(len(ZOO_ARMS) + 1, *ZOO_WHISPER, tag="zoo")
    cfg = model.cfg
    extra = {"encoder_frames": frames((1, cfg.encoder_seq, cfg.frontend_dim),
                                      11)}
    zero()
    out = generate_greedy(model, _prompt(model, stream[0]["prompt"]), extra)
    assert ((0 <= out) & (out < cfg.vocab_size)).all()
    print(f"[zoo] {model.name} prefill_forward + {SERVE_NEW_TOKENS} "
          f"decode_steps {out.tolist()}")
    read("(c) one request", expected_launches([model], {model.name: 1}))
    check(model, model.name, extra)
    del model, extra
    torch.cuda.empty_cache()
    wall("(c)", t0)

    # (d) phi-3-vision's image path: 576 patch embeddings (width 1,024)
    # before the prompt.
    t0 = time.perf_counter()
    model = init_arm(1, *ZOO_ARMS[1], tag="zoo")
    cfg = model.cfg
    extra = {"frontend": frames((1, cfg.frontend_tokens, cfg.frontend_dim),
                                12)}
    zero()
    out = generate_greedy(model, _prompt(model, stream[0]["prompt"]), extra)
    assert ((0 <= out) & (out < cfg.vocab_size)).all()
    print(f"[zoo] {model.name} with its image: prefill_forward + "
          f"{SERVE_NEW_TOKENS} decode_steps {out.tolist()}")
    read("(d) one request with the image",
         expected_launches([model], {model.name: 1}))
    check(model, f"{model.name} image", extra)
    del model, extra
    torch.cuda.empty_cache()
    wall("(d)", t0)
    assert not missed, f"kernel route and plain route disagree: {missed}"
    return total


# Phase 14's configs: (a) one SMOKE config of each family, card against
# CPU; (b)-(c) olmo-1b FULL in bf16 at launch/train.py's batch (8 x 128);
# (d) mamba2-370m FULL in bf16. The 10-step bar on one fixed batch: the
# loss must fall by TRAIN_DROP nats.
TRAIN_FAMILIES = (("dense", "olmo-1b"), ("ssm", "mamba2-370m"),
                  ("hybrid", "zamba2-2.7b"), ("moe", "dbrx-132b"),
                  ("moe-every2", "llama4-maverick-400b-a17b"),
                  ("vlm", "phi-3-vision-4.2b"), ("audio", "whisper-medium"))
TRAIN_BATCH, TRAIN_SEQ = 8, 128
TRAIN_LR = 1e-3
TRAIN_STEPS = 10
TRAIN_DROP = 1.0
# bf16 on the tensor cores (989 TFLOP/s) is the MFU's yardstick.
TRAIN_PEAK = BF16_FLOP_PER_S


def train_phase():
    """Phase 14: the training path on the card. (a) Each family's SMOKE
    config in f32 (TF32 off) on the card against the same weights and
    batch on the CPU: step 1's loss within 1e-4 relative, each gradient
    leaf's max |diff| within 1e-3 of its max |g|, step 2's loss within
    1e-4 relative; (b) olmo-1b FULL in bf16, remat off, on one fixed
    SyntheticLMDataset batch (8 x 128): every gradient leaf finite and
    nonzero after step 1, the loss down by TRAIN_DROP nats over 10 steps;
    (c) the same first step with per-layer remat: loss within 1e-2
    relative, each gradient leaf within 5e-2 of (b)'s max |g|; (d)
    mamba2-370m FULL in bf16, 5 steps on the stream, every loss finite;
    (e) launch.train.main at SMOKE on the card with --ckpt, loaded back
    into a template, every leaf equal. Prints host ms per step (least of
    5 synchronised steps), tokens/s, peak memory with and without remat,
    model FLOP/s (6 N tokens / step time) and its share of the bf16
    peak, and where olmo-1b's step goes: loss + gradients, the AdamW
    update, one step's device busy time and idle share."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch import configs, tree
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch import train as launch_train
    from repro_torch.models import forward_train, init_model
    from repro_torch.optim import adamw_update
    from repro_torch.training import (load_checkpoint, make_train_step,
                                      train_state_init)

    def grads_of(params, cfg, batch, remat=False):
        """forward_train's loss and every gradient leaf, the params
        untouched (the train step's own autograd)."""
        p = tree.map_tree(lambda t: t.detach().requires_grad_(), params)
        loss, _ = forward_train(p, cfg, batch, remat=remat)
        return loss.detach(), torch.autograd.grad(
            loss, list(tree.leaves(p)), materialize_grads=True)

    def on(batch, device):
        return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}

    def sync_s(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # (a) SMOKE parity, card against CPU.
    missed = []
    for family, arch in TRAIN_FAMILIES:
        cfg = configs.get_smoke(arch)
        rng = np.random.default_rng(14)
        batch = next(iter(SyntheticLMDataset(vocab_size=cfg.vocab_size,
                                             seq_len=32, batch_size=2)))
        if cfg.frontend_tokens:
            batch["frontend"] = rng.standard_normal(
                (2, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
        if cfg.is_encdec:
            batch["encoder_frames"] = rng.standard_normal(
                (2, cfg.encoder_seq, cfg.frontend_dim)).astype(np.float32)
        p_cpu = init_model(cfg, seed=0, device="cpu")
        runs = {}
        for dev in ("cpu", "cuda"):
            params = tree.map_tree(lambda t: t.to(dev), p_cpu)
            b = on(batch, dev)
            _, grads = grads_of(params, cfg, b)
            step = make_train_step(cfg, peak_lr=1e-2, warmup_steps=1,
                                   total_steps=10, remat=False)
            state, m1 = step(train_state_init(params), b)
            _, m2 = step(state, b)
            runs[dev] = ([g.cpu() for g in grads], float(m1["loss"]),
                         float(m2["loss"]))
        (g0, l0, b0), (g1, l1, b1) = runs["cpu"], runs["cuda"]
        rel1 = abs(l1 - l0) / abs(l0)
        rel2 = abs(b1 - b0) / abs(b0)
        worst = max(float((x - y).abs().max()) / max(float(y.abs().max()),
                                                     1e-30)
                    for x, y in zip(g1, g0))
        print(f"[train] (a) {family} {cfg.name}: step-1 loss card "
              f"{l1:.6f} cpu {l0:.6f} (rel {rel1:.2e}, bar 1e-4); "
              f"{len(g0)} gradient leaves, worst max|diff| / max|g| "
              f"{worst:.2e} (bar 1e-3); step-2 loss card {b1:.6f} cpu "
              f"{b0:.6f} (rel {rel2:.2e}, bar 1e-4)")
        if not (rel1 <= 1e-4 and worst <= 1e-3 and rel2 <= 1e-4):
            missed.append(family)
    assert not missed, f"card and CPU training disagree: {missed}"

    # (b) olmo-1b FULL in bf16, remat off, one fixed batch.
    cfg = configs.get_config("olmo-1b")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_model(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    n_params = sum(t.numel() for t in tree.leaves(params))
    batch = on(next(iter(SyntheticLMDataset(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        batch_size=TRAIN_BATCH))), "cuda")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    (loss_b, grads_b), _ = sync_s(lambda: grads_of(params, cfg, batch))
    bad = [i for i, g in enumerate(grads_b)
           if not (bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0)]
    print(f"[train] (b) {cfg.name} FULL bf16: {n_params:,} parameters, "
          f"step-1 loss {float(loss_b):.4f}; {len(grads_b)} gradient leaves, "
          f"{len(bad)} not finite or all zero; max|g| per leaf "
          f"{[float(g.abs().max()) for g in grads_b]}")
    assert not bad, f"gradient leaves not finite or zero: {bad}"
    step = make_train_step(cfg, peak_lr=TRAIN_LR, warmup_steps=1,
                           total_steps=TRAIN_STEPS, remat=False)
    state = train_state_init(params)
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    for _ in range(TRAIN_STEPS):
        (state, m), s = sync_s(lambda: step(state, batch))
        losses.append(float(m["loss"]))
        secs.append(s)
    peak_plain = torch.cuda.max_memory_allocated()
    step_s = min(secs[-5:])
    print(f"[train] (b) {TRAIN_STEPS} steps on one batch, peak lr "
          f"{TRAIN_LR}: losses {[round(x, 4) for x in losses]}; drop "
          f"{losses[0] - losses[-1]:.4f} nats (bar {TRAIN_DROP}); host ms "
          f"per step {step_s * 1e3:.3f} (least of the last 5), "
          f"{tokens / step_s:.1f} tokens/s, model FLOP/s (6 N tokens / "
          f"step) {6 * n_params * tokens / step_s:.4e} = "
          f"{6 * n_params * tokens / step_s / TRAIN_PEAK:.4f} of the bf16 "
          f"peak; peak memory {peak_plain / 1e9:.2f} GB allocated")
    assert all(np.isfinite(losses))
    assert losses[0] - losses[-1] >= TRAIN_DROP, losses
    # Where a step's time goes: loss + gradients, the AdamW update, and
    # one profiled step's device busy time.
    grads = tree.unflatten(state.params, grads_b)
    lr = torch.tensor(TRAIN_LR, device="cuda")
    fb_ms, adam_ms = host_ms([
        lambda: grads_of(state.params, cfg, batch),
        lambda: adamw_update(state.params, grads, state.opt, lr)], reps=2)
    busy_ms, n_kernels, _ = device_profile(lambda: step(state, batch))
    print(f"[train] (b) trace: loss + gradients {fb_ms:.3f} ms, AdamW "
          f"update {adam_ms:.3f} ms host clock; one step's device busy "
          f"{busy_ms:.3f} ms in {n_kernels} kernels (idle share "
          f"{1 - busy_ms / (step_s * 1e3):.4f} of the step's "
          f"{step_s * 1e3:.3f} ms)")
    del state, m, grads

    # (c) the first step again with per-layer remat: each route's peak
    # memory above the weights and (b)'s gradients, then their times.
    torch.cuda.empty_cache()
    peaks = []
    for remat in (True, False):
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = grads_of(params, cfg, batch, remat=remat)
        peaks.append(torch.cuda.max_memory_allocated() - base)
        if remat:
            loss_c, grads_c = out
        del out
    peak_remat, peak_no_remat = peaks
    s_c, s_b = (t / 1e3 for t in host_ms([
        lambda: grads_of(params, cfg, batch, remat=True),
        lambda: grads_of(params, cfg, batch)], reps=2))
    rel = abs(float(loss_c) - float(loss_b)) / abs(float(loss_b))
    worst = max(float((c - b).abs().max()) / float(b.abs().max())
                for c, b in zip(grads_c, grads_b))
    print(f"[train] (c) remat: step-1 loss {float(loss_c):.4f} (rel "
          f"{rel:.2e}, bar 1e-2); worst gradient leaf max|diff| / max|g| "
          f"{worst:.2e} (bar 5e-2); loss + gradients {s_c * 1e3:.3f} ms "
          f"with remat, {s_b * 1e3:.3f} without; peak memory above the "
          f"weights and kept gradients {peak_remat / 1e9:.2f} GB with "
          f"remat, {peak_no_remat / 1e9:.2f} GB without")
    assert rel <= 1e-2 and worst <= 5e-2
    del params, grads_b, grads_c, batch
    torch.cuda.empty_cache()

    # (d) mamba2-370m FULL in bf16: 5 steps on the stream.
    cfg = configs.get_config("mamba2-370m")
    torch.cuda.reset_peak_memory_stats()
    params = init_model(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    n_params = sum(t.numel() for t in tree.leaves(params))
    state = train_state_init(params)
    step = make_train_step(cfg, peak_lr=TRAIN_LR, warmup_steps=1,
                           total_steps=5, remat=False)
    losses, secs = [], []
    for _, b in zip(range(5), SyntheticLMDataset(
            vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
            batch_size=TRAIN_BATCH)):
        b = on(b, "cuda")
        (state, m), s = sync_s(lambda: step(state, b))
        losses.append(float(m["loss"]))
        secs.append(s)
    step_s = min(secs)
    print(f"[train] (d) {cfg.name} FULL bf16: {n_params:,} parameters, 5 "
          f"steps on the stream: losses {[round(x, 4) for x in losses]}; "
          f"host ms per step {step_s * 1e3:.3f} (least of 5), "
          f"{tokens / step_s:.1f} tokens/s, model FLOP/s "
          f"{6 * n_params * tokens / step_s:.4e} = "
          f"{6 * n_params * tokens / step_s / TRAIN_PEAK:.4f} of the bf16 "
          f"peak; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated")
    assert all(np.isfinite(losses)), losses
    del params, state, m
    torch.cuda.empty_cache()

    # (e) launch.train.main at SMOKE on the card, its checkpoint loaded back.
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ckpt.npz")
        final = launch_train.main(["--arch", "olmo-1b", "--steps", "3",
                                   "--device", "cuda", "--ckpt", path])
        back = load_checkpoint(path, train_state_init(
            tree.map_tree(torch.zeros_like, final.params)))
    pairs = list(zip(
        tree.leaves({"p": back.params, "m": back.opt.mu, "v": back.opt.nu}),
        tree.leaves({"p": final.params, "m": final.opt.mu,
                     "v": final.opt.nu})))
    same = all(torch.equal(a, b) for a, b in pairs)
    print(f"[train] (e) launch.train.main olmo-1b SMOKE, 3 steps on cuda, "
          f"--ckpt: {len(pairs)} leaves and the step "
          f"{int(back.opt.step)} loaded back, all equal: {same}")
    assert same and int(back.opt.step) == int(final.opt.step) == 3


# Phase 15: fp8 KV caches and the one-device dry run. olmo-1b FULL in bf16
# with float8_e4m3fn caches: FP8_PROMPTS prompts of the request stream,
# each prefilled token by token and decoded FP8_NEW_TOKENS tokens.
FP8_PROMPTS = 8
FP8_NEW_TOKENS = 8
# The dry run held against the card: a decode step at (B, W) with fp8
# caches and prefill_forward at (1, S), olmo-1b FULL in bf16.
DRY_DECODE = (8, 4096)
DRY_PREFILL = 2048
DRY_TIME_FLOOR = 0.95      # measured time / bound_s below this fails
DRY_PEAK_FACTOR = 2.0      # predicted / measured peak outside 1/2..2 fails


def fp8_kernel_checks(gen):
    """Phase 15 (a): decode_attention on fp8 caches at the served and the
    long shapes, zamba2's and phi-3's head dims, an f32 query (the FMA
    path), e5m2, and a row with no valid slot."""
    import torch

    bf16, f32 = torch.bfloat16, torch.float32
    e4m3, e5m2 = torch.float8_e4m3fn, torch.float8_e5m2
    return [
        check_decode(gen, 1, 40, 16, 16, 128, bf16, pos=39, kv_dtype=e4m3),
        check_decode(gen, 1, 4096, 64, 8, 128, bf16, pos=5000, window=3000,
                     kv_dtype=e4m3),
        check_decode(gen, 1, 40, 32, 32, 80, bf16, pos=39, kv_dtype=e4m3),
        check_decode(gen, 1, 616, 32, 32, 96, bf16, pos=615, kv_dtype=e4m3),
        check_decode(gen, 2, 40, 8, 2, 32, f32, pos=35, kv_dtype=e4m3),
        check_decode(gen, 1, 136, 16, 16, 128, bf16, pos=130, kv_dtype=e5m2),
        check_decode(gen, 1, 1024, 16, 2, 128, bf16, pos=None, kv_dtype=e4m3),
    ]


def _forced(params, cfg, toks, fixed, impl):
    """Logits (1 + len(fixed), V) of ``toks`` prefilled token by token and
    the ``fixed`` tokens decoded after it, on route ``impl``."""
    import torch

    from repro_torch.models import decode_step, prefill

    logits, caches = prefill(params, cfg, toks,
                             cache_len=toks.shape[1] + len(fixed), impl=impl)
    out = [logits[0]]
    for t in fixed:
        logits, caches = decode_step(
            params, cfg, torch.full((1, 1), t, device="cuda"), caches, impl)
        out.append(logits[0])
    return torch.stack(out).float(), caches


def fp8_path(stream):
    """Phase 15 (b): the slice's path at full width. Returns (the
    parameters, for (c), and decode_attention's launches on the path)."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.models import decode_step, init_caches, init_model
    from repro_torch.models import prefill
    from repro_torch.serving.tokenizer import HashTokenizer

    cfg = dataclasses.replace(configs.get_config("olmo-1b"),
                              kv_dtype="float8_e4m3fn")
    params = init_model(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    tok = HashTokenizer(cfg.vocab_size)
    prompts = [torch.as_tensor(tok.encode(r["prompt"])[None], device="cuda")
               for r in stream[:FP8_PROMPTS]]
    # The path's run: the counters are zeroed just before it and read just
    # after it.
    decode_ops.LAUNCHES[0] = 0
    for k in decode_ops.KV_DTYPE_LAUNCHES:
        decode_ops.KV_DTYPE_LAUNCHES[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    generated = []
    for toks in prompts:
        logits, caches = prefill(params, cfg, toks,
                                 cache_len=toks.shape[1] + FP8_NEW_TOKENS)
        assert caches.k.dtype == caches.v.dtype == torch.float8_e4m3fn
        ids, cur = [], logits.argmax(-1)[:, None]
        for _ in range(FP8_NEW_TOKENS):
            ids.append(int(cur[0, 0]))
            logits, caches = decode_step(params, cfg, cur, caches)
            cur = logits.argmax(-1)[:, None]
        generated.append(ids)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = decode_ops.LAUNCHES[0]
    by_dtype = {k: n for k, n in decode_ops.KV_DTYPE_LAUNCHES.items() if n}
    tokens = sum(t.shape[1] + FP8_NEW_TOKENS for t in prompts)
    want = tokens * cfg.num_layers
    print(f"[fp8] olmo-1b FULL bf16, float8_e4m3fn caches: {len(prompts)} "
          f"prompts of {[t.shape[1] for t in prompts]} tokens prefilled "
          f"token by token + {FP8_NEW_TOKENS} decoded each in {secs:.3f} s; "
          f"decode_attention launches {launches} by cache dtype {by_dtype}, "
          f"expected {tokens} tokens x {cfg.num_layers} layers = {want}; "
          f"first generate {generated[0]}")
    assert launches == want and by_dtype == {"float8_e4m3fn": want}, (
        launches, by_dtype, want)

    # Teacher-forced: prompt 0 and its 8 generated tokens through the
    # kernel route and the two plain decode routes on fp8 caches, and the
    # kernel route on bf16 caches.
    runs = {}
    for name, kv, impl in (("cuda", "float8_e4m3fn", "cuda"),
                           ("chunked", "float8_e4m3fn", "chunked"),
                           ("einsum", "float8_e4m3fn", "einsum"),
                           ("bf16", "", "cuda")):
        runs[name], _ = _forced(params, dataclasses.replace(cfg, kv_dtype=kv),
                                prompts[0], generated[0], impl)
    err = float((runs["cuda"] - runs["chunked"]).abs().max())
    plain = float((runs["einsum"] - runs["chunked"]).abs().max())
    d_bf16 = float((runs["cuda"] - runs["bf16"]).abs().max())
    top1 = float((runs["cuda"].argmax(-1) == runs["bf16"].argmax(-1))
                 .float().mean())
    print(f"[fp8] teacher-forced olmo-1b ({prompts[0].shape[1]} + "
          f"{FP8_NEW_TOKENS} positions): kernel vs chunked route on fp8 "
          f"caches max |d logit| {err:.4e}, two plain routes (einsum vs "
          f"chunked) {plain:.4e} (ratio {err / plain:.3f}, bar "
          f"{TEACHER_BF16_FACTOR}); fp8 vs bf16 caches (kernel route) max "
          f"|d logit| {d_bf16:.4e}, top-1 agreement {top1:.4f}")
    assert torch.isfinite(runs["cuda"]).all()
    assert err <= TEACHER_BF16_FACTOR * plain, (err, plain)

    # mamba2-370m's fp8 conv state raises where the JAX package does.
    mcfg = dataclasses.replace(configs.get_config("mamba2-370m"),
                               kv_dtype="float8_e4m3fn")
    mparams = init_model(mcfg, seed=1, device="cuda", dtype=torch.bfloat16)
    try:
        decode_step(mparams, mcfg, torch.ones((1, 1), dtype=torch.int32,
                                              device="cuda"),
                    init_caches(mcfg, 1, 8, device="cuda"))
    except ValueError as e:
        print(f"[fp8] mamba2-370m decode_step on fp8 caches raises "
              f"ValueError, as the JAX package does: {e}")
    else:
        raise AssertionError("mamba2-370m decode on an fp8 conv state ran")
    del mparams
    torch.cuda.empty_cache()
    return params, launches


def _dry_line(arch, shape_name, kv_dtype=""):
    """One ``[dryrun]`` line: ``step_cost``'s trace of the FULL config on
    one device (the numbers phase 15 holds against the card), with its
    roofline terms on one H100."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.configs.shapes import INPUT_SHAPES, variant_for_shape
    from repro_torch.launch import dryrun
    from repro_torch.launch import roofline as rl

    shape = INPUT_SHAPES[shape_name]
    cfg = variant_for_shape(configs.get_config(arch), shape)
    if kv_dtype:
        cfg = dataclasses.replace(cfg, kv_dtype=kv_dtype)
    t0 = time.perf_counter()
    c = dryrun.step_cost(cfg, shape)
    trace_s = time.perf_counter() - t0
    terms = rl.roofline_terms(c.flops, c.hbm_bytes, 0.0)
    return json.dumps({
        "arch": arch, "shape": shape_name, "kv_dtype": kv_dtype,
        "flops": c.flops, "matmul_flops": c.dot_flops,
        "flop_counter": c.flop_counter, "hbm_bytes": c.hbm_bytes,
        "compute_s": terms["compute_s"], "memory_s": terms["memory_s"],
        "dominant": terms["dominant"], "bound_s": terms["bound_s"],
        "argument_bytes": c.argument_bytes, "temp_bytes": c.temp_bytes,
        "peak_bytes": c.argument_bytes + c.output_bytes + c.temp_bytes,
        "useful_flops_ratio": rl.model_flops(cfg, shape) / max(c.flops, 1.0),
        "trace_s": round(trace_s, 3)})


def _held(label, fn, args, pred, smi):
    """Runs ``fn(*args)`` on the card against the dry run's prediction
    ``pred`` (a Cost): the arguments' bytes exactly, the peak within
    DRY_PEAK_FACTOR, the least of 5 synchronised host-clock times at
    least DRY_TIME_FLOOR of the bound."""
    import torch

    from repro_torch.launch import costmodel
    from repro_torch.launch import roofline as rl

    arg_bytes = sum(costmodel.nbytes(t) for t in costmodel.tensors(args))
    assert arg_bytes == pred.argument_bytes, (label, arg_bytes,
                                              pred.argument_bytes)
    fn(*args)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn(*args)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - before
    (ms,) = host_ms([lambda: fn(*args)], reps=5)
    terms = rl.roofline_terms(pred.flops, pred.hbm_bytes, 0.0)
    ratio = ms / 1e3 / terms["bound_s"]
    peak = pred.argument_bytes + pred.output_bytes + pred.temp_bytes
    measured = arg_bytes + rise
    print(f"[dryrun] {label} on the card ({smi}): least of 5 {ms:.3f} ms, "
          f"bound {terms['bound_s'] * 1e3:.3f} ms ({terms['dominant']}), "
          f"time / bound {ratio:.3f}; arguments {arg_bytes} bytes = "
          f"predicted; peak predicted {peak / 1e9:.3f} GB vs measured "
          f"(arguments + max_memory_allocated rise) {measured / 1e9:.3f} GB "
          f"(ratio {peak / measured:.3f}); the call's own predicted "
          f"output + temp {(peak - arg_bytes) / 1e9:.3f} GB vs rise "
          f"{rise / 1e9:.3f} GB")
    assert ratio >= DRY_TIME_FLOOR, (label, ms, terms["bound_s"])
    assert 1 / DRY_PEAK_FACTOR <= peak / measured <= DRY_PEAK_FACTOR, (
        label, peak, measured)
    return dict(ms=ms, bound_ms=terms["bound_s"] * 1e3, ratio=ratio,
                peak_pred=peak, peak_measured=measured)


def dryrun_phase(params, smi):
    """Phase 15 (c): the dry run on the card's machine (the JAX driver's
    trio at decode_32k with and without fp8 caches, olmo-1b at train_4k),
    then the dry run held against real runs of olmo-1b FULL in bf16."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.models import decode_step, init_caches, prefill_forward

    for arch in ("olmo-1b", "mamba2-370m", "deepseek-67b"):
        for kv in ("", "float8_e4m3fn"):
            try:
                line = _dry_line(arch, "decode_32k", kv)
            except ValueError as e:
                # An fp8 conv state: the JAX dry run raises here too.
                assert kv and configs.get_config(arch).arch_type in (
                    "ssm", "hybrid"), e
                print(f"[dryrun] {arch} decode_32k {kv}: ValueError, as the "
                      f"JAX dry run's TypePromotionError: {e}")
                continue
            print(f"[dryrun] {line}")
    print(f"[dryrun] {_dry_line('olmo-1b', 'train_4k')}")

    cfg = dataclasses.replace(configs.get_config("olmo-1b"),
                              kv_dtype="float8_e4m3fn")
    B, W = DRY_DECODE
    pred = dryrun.step_cost(cfg, InputShape("decode", W, B, "decode"),
                            infer_dtype="bfloat16")
    token = torch.ones((B, 1), dtype=torch.int32, device="cuda")
    caches = init_caches(cfg, B, W, device="cuda")._replace(pos=W - 1)
    out = {"decode": _held(
        f"olmo-1b decode_step B {B} W {W} float8_e4m3fn caches (einsum)",
        lambda p, t, c: decode_step(p, cfg, t, c, impl="einsum"),
        (params, token, caches), pred, smi)}
    del caches
    torch.cuda.empty_cache()
    S = DRY_PREFILL
    pred = dryrun.step_cost(cfg, InputShape("prefill", S, 1, "prefill"),
                            infer_dtype="bfloat16")
    tokens = torch.ones((1, S), dtype=torch.int32, device="cuda")
    out["prefill"] = _held(
        f"olmo-1b prefill_forward (1, {S}) (chunked)",
        lambda p, b: prefill_forward(p, cfg, b["tokens"], impl="chunked"),
        (params, {"tokens": tokens}), pred, smi)
    return out


def tune_phase(smi):
    """Phase 16: the autotune at both linucb_score shapes (every candidate
    bit for bit against the 128-row launch), phase 2's pdl step block
    again, Eq. 9 on the card against the CPU, and the port's lint suite.
    Returns (the scoring kernel's launches in the phase, the candidate
    tables in ms by shape)."""
    import torch

    from repro_torch.core import linucb
    from repro_torch.core.backend import EQUIV_TOL
    from repro_torch.core.types import RouterConfig
    from repro_torch.kernels import tune
    from repro_torch.kernels.linucb_score import ops as score_ops
    from repro_torch.kernels.linucb_score.ref import linucb_score_ref
    from repro_torch.kernels.linucb_step import ops as step_ops

    # (a) every candidate at both shapes, then the autotune's table.
    score_ops.LAUNCHES[0] = 0
    tables = {}
    for S, R, K, d in tune.SHAPES:
        args = tune.operands(S, R, K, d, "cuda")
        base = score_ops.linucb_score(*args)
        err = float((base - linucb_score_ref(*args)).abs().max())
        assert err <= EQUIV_TOL, f"linucb_score at {(S, R, K, d)}: {err}"
        same = {br: torch.equal(score_ops.linucb_score(*args, block_r=br),
                                base) for br in tune.BLOCK_R_CANDIDATES}
        assert all(same.values()), f"candidates not bit for bit: {same}"
        best, table = tune.autotune_block_r(R, d, K, S=S)
        key = f"S{S}_R{R}_K{K}_d{d}"
        tables[key] = {br: secs * 1e3 for br, secs in table.items()}
        print("[tune] " + json.dumps(dict(
            shape=dict(S=S, R=R, K=K, d=d), max_abs_err_128_vs_plain=err,
            bitwise_vs_128=same, graph_ms=tables[key], best=best,
            card=smi)))
    launches = score_ops.LAUNCHES[0]
    ins, want = STEP_RESULTS[(20, 256, 8, 26)]
    got = step_ops.linucb_step(*ins)
    same = [torch.equal(g, w) for g, w in zip(got, want)]
    print(f"[tune] linucb_step pdl block (20, 256, 8, 26) again: bit for bit "
          f"with phase 2 {all(same)}")
    assert all(same), same

    # (b) Eq. 9 on the card against the CPU.
    S, d = 20, 26
    gen = torch.Generator().manual_seed(16)
    M = torch.randn((S, d, d), generator=gen, dtype=torch.float64)
    A_inv = torch.linalg.inv(M @ M.transpose(-1, -2) / d
                             + torch.eye(d, dtype=torch.float64)).float()
    x = torch.randn((S, d), generator=gen)
    dt = torch.randint(0, 5000, (S,), generator=gen, dtype=torch.int32)
    cfg = RouterConfig()
    v = {dev: linucb.ucb_variance(cfg, cfg.hyper.as_leaves(S, dev),
                                  A_inv.to(dev), x.to(dev), dt.to(dev)).cpu()
         for dev in ("cuda", "cpu")}
    rel = float(((v["cuda"] - v["cpu"]).abs() / v["cpu"].abs()).max())
    print(f"[tune] ucb_variance S={S} d={d}: card vs CPU max rel diff {rel:.3e}")
    assert rel <= 1e-6 and torch.isfinite(v["cuda"]).all(), rel

    # (c) the port's lint suite against its committed baseline.
    lint = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis"], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=SRC), capture_output=True, text=True)
    print(f"[tune] python -m repro_torch.analysis: exit {lint.returncode}, "
          f"{lint.stdout.strip().splitlines()[-1]}")
    assert lint.returncode == 0, lint.stdout + lint.stderr
    return launches, tables


def _same_bits(got, want) -> bool:
    """Equal dtype, shape and bits (a float read as the integer of its
    width, so -0.0 and 0.0 differ)."""
    import torch

    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    if got.is_floating_point():
        got = got.contiguous().view(ints[got.element_size()])
        want = want.contiguous().view(ints[want.element_size()])
    return torch.equal(got, want)


def _placed_bit_for_bit(placed, source, shardings, what):
    """Every tensor leaf of ``placed`` (a tree as shard_tree gives) a
    DTensor with its sharding's placements whose local tensor is
    ``source``'s bit for bit; returns the leaves checked."""
    from torch.distributed.tensor import DTensor

    from repro_torch import tree

    n = 0
    for p, s, ns in zip(tree.leaves(placed), tree.leaves(source),
                        tree.leaves(shardings)):
        assert isinstance(p, DTensor), what
        assert p.placements == ns.placements, (what, p.placements,
                                               ns.placements)
        assert _same_bits(p.to_local(), s), what
        n += 1
    return n


def _embed_offsets_major_to_minor(mesh, ns, shape, arch) -> int:
    """Where fsdp's embed keeps P(("data", "model"), None): every rank's
    local shape and global offset under its placements, as this torch's
    DTensor computes them, equal to the rules' shard shape and to the
    offset of the rank's (data, model) index flattened major to minor,
    as JAX flattens the tuple (a pod index leaves it unchanged). Returns
    the ranks checked, 0 where the vocabulary does not divide."""
    import itertools

    from torch.distributed.tensor._utils import (
        _compute_local_shape_and_global_offset,
    )

    if ns.spec != (("data", "model"), None):
        return 0
    names = tuple(mesh.mesh_dim_names)
    di, mi = names.index("data"), names.index("model")
    n_model = mesh.shape[mi]
    local = ns.shard_shape(shape)
    n = 0
    for coord in itertools.product(*(range(k) for k in mesh.shape)):
        got = _compute_local_shape_and_global_offset(
            tuple(shape), tuple(mesh.shape), list(coord), ns.placements)
        want = (tuple(local),
                ((coord[di] * n_model + coord[mi]) * local[0], 0))
        assert tuple(map(tuple, got)) == want, (arch, coord, got, want)
        n += 1
    return n


def placement_phase(params, smi):
    """Phase 17: the placement rules. (a) olmo-1b FULL's bf16 parameters,
    a TrainState on them and decode caches placed as DTensors on a one-rank
    nccl world's (1, 1) mesh on the card, and pspec.hint there; (b) the
    production meshes on fake worlds of 256 and 512 ranks, the rules for
    three architectures under each profile, every shard shape tiling its
    global shape."""
    import math

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch import configs, tree
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding
    from repro_torch.models import init_caches, init_model, pspec
    from repro_torch.training.train_step import train_state_init

    # (a) A one-rank nccl world on the card.
    t0 = time.perf_counter()
    cfg = configs.get_config("olmo-1b")
    gen = torch.Generator(device="cuda").manual_seed(17)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        sh = sharding.tree_param_shardings(mesh, params)
        n_params = _placed_bit_for_bit(
            sharding.shard_tree(params, sh), params, sh, "params")
        assert n_params == len(list(tree.leaves(params)))
        assert sh["blocks"]["attn"]["w_q"].placements == (Replicate(),
                                                          Shard(2))

        state = train_state_init(params)
        for m in (state.opt.mu, state.opt.nu):
            for leaf in tree.leaves(m):
                leaf.normal_(generator=gen)
        state_sh = dryrun._state_shardings(mesh, sh)
        placed = sharding.shard_tree(state, state_sh)
        assert placed.opt.step.placements == (Replicate(), Replicate())
        assert _same_bits(placed.opt.step.to_local(), state.opt.step)
        n_state = sum(_placed_bit_for_bit(getattr(placed.opt, k),
                                          getattr(state.opt, k), sh, k)
                      for k in ("mu", "nu"))
        del placed, state

        caches = init_caches(cfg, 8, 4096, device="cuda")
        for v in caches:
            if isinstance(v, torch.Tensor):
                v.copy_(torch.randn(v.shape, generator=gen, device="cuda"))
        token = torch.randint(0, cfg.vocab_size, (8, 1), generator=gen,
                              device="cuda", dtype=torch.int32)
        tok_s, caches_s = sharding.cache_shardings(mesh, cfg, token, caches)
        placed = sharding.shard_tree(caches, caches_s)
        assert placed.pos == caches.pos
        n_caches = _placed_bit_for_bit(
            {"k": placed.k, "v": placed.v}, {"k": caches.k, "v": caches.v},
            {"k": caches_s.k, "v": caches_s.v}, "caches")
        n_caches += _placed_bit_for_bit(
            {"t": sharding.shard_tree(token, tok_s)}, {"t": token},
            {"t": tok_s}, "token")
        assert caches_s.k.placements == (Shard(1), Shard(2))
        del placed, caches

        pspec.set_mesh(mesh, sharding.activation_hint_specs(mesh))
        try:
            h = torch.randn((8, 16, cfg.d_model), generator=gen,
                            device="cuda", dtype=torch.bfloat16)
            y = pspec.hint(distribute_tensor(h, mesh, [Replicate()] * 2),
                           "logits")
            assert isinstance(y, DTensor)
            assert y.placements == (Shard(0), Shard(2)), y.placements
            assert _same_bits(y.to_local(), h)
        finally:
            pspec.set_mesh(None)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    print(f"[place] (a) nccl world of 1, (1, 1) mesh on cuda: olmo-1b FULL "
          f"bf16 {n_params} parameter leaves, {n_state} moment leaves (step "
          f"replicated), {n_caches} cache / token leaves at B 8 W 4096 "
          f"placed bit for bit with the rules' placements; pspec.hint "
          f"logits -> {y.placements}; {time.perf_counter() - t0:.1f} s")

    # (b) The production meshes on fake worlds, the rules at full width.
    t0 = time.perf_counter()
    n_ranks = 0
    for multi_pod, world in ((False, 256), (True, 512)):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
        try:
            mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
            assert math.prod(mesh.shape) == world, mesh
            for arch in ("olmo-1b", "deepseek-67b", "dbrx-132b"):
                meta = init_model(configs.get_config(arch), device="meta")
                total = sum(t.numel() * t.element_size()
                            for t in tree.leaves(meta))
                for profile in ("tp", "fsdp", "dp"):
                    per_device = 0
                    shard = sharding.tree_param_shardings(mesh, meta, profile)
                    for (path, ns), t in zip(tree.leaves_with_path(shard),
                                             tree.leaves(meta)):
                        parts = [1] * t.dim()
                        for size, pl in zip(mesh.shape, ns.placements):
                            if isinstance(pl, Shard):
                                parts[pl.dim] *= size
                        local = ns.shard_shape(t.shape)
                        assert tuple(n * k for n, k in zip(local, parts)) \
                            == tuple(t.shape), (arch, profile, path)
                        per_device += math.prod(local) * t.element_size()
                    if profile == "fsdp":
                        n_ranks += _embed_offsets_major_to_minor(
                            mesh, shard["embed"], meta["embed"].shape, arch)
                    print("[place] " + json.dumps(dict(
                        mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)),
                        arch=arch, profile=profile,
                        f32_param_bytes_per_device=per_device,
                        f32_param_bytes=total, card=smi)))
        finally:
            dist.destroy_process_group()
    # deepseek-67b's and dbrx-132b's vocabularies divide 256, so their
    # fsdp embeds keep ("data", "model") on both meshes: 2 x (256 + 512).
    assert n_ranks == 2 * (256 + 512), n_ranks
    print(f"[place] (b) fake worlds of 256 and 512: every shard shape tiles "
          f"its global shape; fsdp's (\"data\", \"model\") embed at "
          f"{n_ranks} (arch, rank) pairs, each rank's local shape and offset "
          f"as the axes flatten major to minor; "
          f"{time.perf_counter() - t0:.1f} s")


# Phase 18's combos: (arch, shape, multi_pod, profile, ep_axis, seq_len),
# seq_len 0 the shape's own; a cut sequence keeps the shape's batch, so
# the rules shard the same dimensions as at full size. The decode combos:
# olmo-1b's and mamba2-370m's, which the JAX reference compiles here and
# whose XLA argument bytes per device (its dry run's memory_analysis() on
# JAX 0.9.0's CPU) the port must give exactly, mamba2-370m's through the
# SSM decode's skip term; the MoE dispatch on its shards, with the
# experts on 'data' on the multi-pod mesh and on 'model' (dbrx-132b's
# top-4, llama4's top-1). The prefill and train combos reach the sites
# torch 2.11 could not trace or counted otherwise: the SSM conv
# (mamba2-370m), the dense prefill's vocabulary-parallel lookup
# (olmo-1b), the lookup with ids on ('pod', 'data'), and the lookup's
# backward in a train step.
MESH_DRYRUN = (("olmo-1b", "decode_32k", False, "tp", "model", 0),
               ("mamba2-370m", "decode_32k", False, "tp", "model", 0),
               ("dbrx-132b", "decode_32k", True, "tp", "data", 0),
               ("dbrx-132b", "decode_32k", False, "tp", "model", 0),
               ("llama4-maverick-400b-a17b", "decode_32k", False, "tp",
                "model", 0),
               ("mamba2-370m", "prefill_32k", False, "tp", "model", 1024),
               ("olmo-1b", "prefill_32k", False, "tp", "model", 1024),
               ("olmo-1b", "prefill_32k", True, "tp", "model", 1024),
               ("olmo-1b", "train_4k", False, "tp", "model", 1024),
               ("dbrx-132b", "train_4k", False, "tp", "model", 1024))
# XLA's argument_size_in_bytes of the JAX dry run of the decode combos
# on the 16 x 16 mesh (JAX 0.9.0 on the CPU, --skip-collectives).
XLA_ARGUMENT_BYTES = {("olmo-1b", "decode_32k"): 2_441_674_788,
                      ("mamba2-370m", "decode_32k"): 365_081_764}
# The collective estimate's wire bytes per device of each combo, as the
# CPU's torch counts them (tests/test_torch_dryrun_mesh.py holds the CPU
# to these); the card's torch must count the same, to the byte. XLA's,
# where JAX compiles the combo (JAX 0.9.0 on the CPU, with collectives):
# 9,000,960 and 7,412,544.
MESH_WIRE_BYTES = dict(zip(MESH_DRYRUN, (
    8_786_400.0, 9_311_520.0, 188_898_416.0, 79_405_920.0, 70_971_360.0,
    767_520_000.0, 519_045_120.0, 259_522_560.0, 10_870_333_455.0,
    371_078_496_015.0)))
XLA_WIRE_BYTES = {("olmo-1b", "decode_32k"): 9_000_960.0,
                  ("mamba2-370m", "decode_32k"): 7_412_544.0}
# How far the port's wire bytes may be from XLA's, either way.
WIRE_FACTOR = 3.0
# The phase's budget, seconds.
MESH_PHASE_S = 60.0


def mesh_dryrun_phase(smi):
    """Phase 18: the dry run on the production mesh with the collective
    estimate, in the fake world of 512 ranks it starts itself: each
    combo's per-device argument bytes, read from the DTensor trace's
    local shards on this torch, must equal the shard-shape sum of its
    placed arguments (and, for olmo-1b's and mamba2-370m's decode, XLA's);
    the counter must meet no collective it has no kind for (it raises);
    the wire bytes per device must equal the CPU's pin to the byte, and
    olmo-1b's and mamba2-370m's decode be within WIRE_FACTOR of XLA's.
    Returns the results."""
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.configs.shapes import INPUT_SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    assert not dist.is_initialized(), "phase 17 left a process group"
    out = []
    for combo in MESH_DRYRUN:
        arch, shape, multi_pod, profile, ep_axis, seq_len = combo
        r = dryrun.lower_combo(arch, shape, multi_pod=multi_pod,
                               profile=profile, ep_axis=ep_axis,
                               seq_len=seq_len, verbose=False)
        assert not dist.is_initialized(), "the dry run left its world"
        full = INPUT_SHAPES[shape]
        cut = dataclasses.replace(full, seq_len=seq_len or full.seq_len)
        with dryrun._world(dryrun.FAKE_WORLD):
            mesh = make_production_mesh(multi_pod=multi_pod)
            want = dryrun.argument_bytes(configs.get_config(arch), cut, mesh,
                                         profile=profile, ep_axis=ep_axis)
        m = r["memory"]
        assert m["argument_bytes"] == want, (combo, m["argument_bytes"],
                                             want)
        if not multi_pod and (arch, shape) in XLA_ARGUMENT_BYTES:
            assert want == XLA_ARGUMENT_BYTES[arch, shape], (combo, want)
        wire = r["wire_bytes_per_device"]
        assert wire > 0 and len(r["collectives"]) == 5, r["collectives"]
        xla = XLA_WIRE_BYTES.get((arch, shape)) if not multi_pod else None
        if xla:
            assert 1 / WIRE_FACTOR <= wire / xla <= WIRE_FACTOR, (combo, wire)
        assert wire == MESH_WIRE_BYTES[combo], (combo, wire,
                                                MESH_WIRE_BYTES[combo])
        print("[mesh] " + json.dumps(dict(
            arch=arch, shape=shape, seq_len=cut.seq_len, mesh=r["mesh"],
            n_chips=r["n_chips"], profile=profile, ep_axis=ep_axis,
            argument_bytes=m["argument_bytes"], shard_sum=want,
            output_bytes=m["output_bytes"], temp_bytes=m["temp_bytes"],
            flops_per_device=r["flops_per_device"],
            wire_bytes_per_device=wire, cpu_pin=MESH_WIRE_BYTES[combo],
            equal_cpu_pin=wire == MESH_WIRE_BYTES[combo],
            xla_wire_bytes=xla, ratio_to_xla=(wire / xla if xla else None),
            collectives={k: [c["count"], c["wire_bytes"]]
                         for k, c in r["collectives"].items()},
            collective_s=r["collective_s"], dominant=r["dominant"],
            trace_s=round(r["trace_s"], 3),
            mesh_trace_s=round(r["mesh_trace_s"], 3), card=smi)))
        out.append(r)
    assert not dist.is_initialized()
    return out


def main() -> int:
    start = time.perf_counter()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from the "
              "repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    import numpy as np

    def mark(phases):
        print(f"[wall] phases {phases} done at "
              f"{time.perf_counter() - start:.1f} s")

    from repro_torch.core import evaluate, router, simulator
    from repro_torch.core.types import RouterConfig
    from repro_torch.kernels import build
    from repro_torch.kernels.linucb_score import ops as score_ops
    from repro_torch.kernels.linucb_step import ops as step_ops

    # Phase 1: the card.
    smi = nvidia_smi()
    print(f"[device] {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    lib = build.build()
    print(f"[build] {lib.parent.name} in {time.perf_counter() - t0:.1f} s")
    spills = [k for k in build_report(build.build_log())
              if k.startswith(("flash_wgmma", "decode_split", "decode_comb",
                               "linucb_", "ssd_"))]
    # The autotune's other rows-per-block candidates may spill: they run
    # only when a caller asks for them, and their times are recorded.
    candidates = [k for k in spills if k.startswith("linucb_score_kernel<")
                  and not k.endswith(", 128>")]
    if candidates:
        print(f"[build] autotune candidates that spill (timed in phase 16): "
              f"{candidates}")
    spills = [k for k in spills if k not in candidates]
    assert not spills, f"register spills in {spills}"

    # Phase 2: each kernel against its plain version on the card.
    rng = np.random.default_rng(0)
    score_checks = [check_score(rng, 20, 256, 8, 26),
                    check_score(rng, 1, 4096, 8, 128)]
    step_checks = [check_step(rng, 20, 256, 8, 26),
                   check_step(rng, 20, 1, 8, 26),
                   check_step(rng, 20, 13, 8, 26),
                   check_step(rng, 8, 256, 8, 128)]
    for c in score_checks + step_checks:
        print(f"[kernel] {json.dumps(c)}")
    mark("1-2")

    # Phase 3: the main path at the paper's configuration.
    cfg = RouterConfig()
    assert cfg.backend == "fused"
    t0 = time.perf_counter()
    bench = simulator.make_benchmark(seed=0)
    priors = evaluate.fit_warmup_priors(cfg, bench.train)
    torch.cuda.synchronize()
    print(f"[setup] benchmark + priors in {time.perf_counter() - t0:.2f} s; "
          f"test prompts {bench.test.n}, d {bench.test.contexts.shape[1]}")
    assert bench.test.n == 1824

    score_ops.LAUNCHES[0] = 0
    step_ops.LAUNCHES[0] = 0
    for r in step_ops.ROUTE_LAUNCHES:
        step_ops.ROUTE_LAUNCHES[r] = 0
    runs = {}
    for bs in (256, None):
        for budget in BUDGETS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res, finals = evaluate.run(
                cfg, bench.test, budget, seeds=SEEDS, priors=priors,
                n_eff=N_EFF, batch_size=bs, return_states=True)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            assert res.arms.shape == (len(SEEDS), 1824)
            assert np.isfinite(res.rewards).all() and np.isfinite(res.costs).all()
            runs[(bs, budget)] = (res, finals)
            print(f"[main] batch_size={bs} budget={budget}: mean reward "
                  f"{res.mean_reward:.6f} compliance "
                  f"{res.compliance(budget):.6f} wall {secs:.3f} s "
                  f"decisions/s {res.arms.size / secs:.1f} "
                  f"(step launches so far {step_ops.LAUNCHES[0]})")
    # The paper's compliance band (tests/test_paper_claims.py) is a claim
    # of the per-request loop: with blocks of 256 the first block of the
    # 1,824-request stream routes at lambda = 0, as in the JAX package.
    comp = runs[(None, 3.0e-4)][0].compliance(3.0e-4)
    assert 0.9 < comp < 1.10, f"compliance {comp} outside (0.9, 1.10)"

    # Select-only serving: a 256-request block from the warmed state.
    warm = runs[(256, 6.6e-4)][1]
    xs, _, _, _ = evaluate.build_run_streams(cfg, bench.val, SEEDS)
    X = xs[:, :256].contiguous()
    serve_cfg = RouterConfig(backend="score")
    dec, _ = router.select_batch(serve_cfg, warm, X)
    torch.cuda.synchronize()
    launches = {"linucb_score": score_ops.LAUNCHES[0],
                "linucb_step": step_ops.LAUNCHES[0]}
    print(f"[main] kernel launches on the main path: {launches}; "
          f"linucb_step by route: {step_ops.ROUTE_LAUNCHES}")
    for name, n in launches.items():
        assert n > 0, f"{name} was not launched on the main path"
    # Blocks of 256 take the chained route, the per-request runs the
    # single launch.
    step_routes = dict(step_ops.ROUTE_LAUNCHES)
    assert sum(step_routes.values()) == launches["linucb_step"]
    for r, n in step_routes.items():
        assert n > 0, f"linucb_step's {r} route was not taken"

    # Phase 4: the oracle on the card, for both block runs and for the
    # per-request run at the tight budget.
    oracle_cfg = RouterConfig(backend="torch")
    for bs, budget in ((256, 3.0e-4), (256, 6.6e-4), (None, 3.0e-4)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = evaluate.run(oracle_cfg, bench.test, budget, seeds=SEEDS,
                           priors=priors, n_eff=N_EFF, batch_size=bs)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = runs[(bs, budget)][0]
        agree = float((ref.arms == got.arms).mean())
        dr = abs(ref.mean_reward - got.mean_reward)
        print(f"[oracle] batch_size={bs} budget={budget}: arm agreement "
              f"{agree:.6f} |d mean reward| {dr:.3e} compliance "
              f"{ref.compliance(budget):.6f} oracle wall {secs:.3f} s")
        assert agree >= 0.99 and dr < 1e-3

    # Phase 5: served scores against the oracle's.
    dec_t, _ = router.select_batch(RouterConfig(backend="torch"), warm, X)
    sdiff = float((dec.scores - dec_t.scores).abs().max())
    print(f"[serve] select_batch S={len(SEEDS)} B=256 on 'score': max score "
          f"diff vs 'torch' {sdiff:.3e}, arm agreement "
          f"{float((dec.arms == dec_t.arms).float().mean()):.6f}")
    assert sdiff <= 1e-4

    # Where a block's time goes (S = 20): host clock of a fused block and
    # of its PRNG chain alone, then a profiled block's device kernels.
    st = runs[(256, 6.6e-4)][1]
    xs, rm, cm, _ = evaluate.build_run_streams(cfg, bench.test, SEEDS)
    for B in (256, 1):
        blk = [a[:, :B].contiguous() for a in (xs, rm, cm)]
        block = lambda: router.step_batch(cfg, st, *blk)  # noqa: E731
        chain = lambda: router._tiebreak_noise(  # noqa: E731
            cfg, st.hyper, st.key, B)
        block_ms, chain_ms = host_ms([block, chain])
        busy_ms, n_kernels, ours_ms = device_profile(block)
        print(f"[trace] S=20 B={B} fused block: {block_ms:.3f} ms host clock, "
              f"PRNG chain alone {chain_ms:.3f} ms "
              f"({chain_ms / block_ms:.3f} of the block); device busy "
              f"{busy_ms:.3f} ms in {n_kernels} kernels (idle share "
              f"{1 - busy_ms / block_ms:.4f}), linucb_step's kernels "
              f"{ours_ms:.3f} ms")
    mark("3-5")

    # Phase 6: the served models' kernels against their plain versions.
    from repro_torch.data import make_request_stream
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    flash_checks = [
        # the served prefills: olmo-1b, deepseek-67b (prompts pad to 32)
        check_flash(gen, 1, 32, 16, 16, 128, bf16, "causal"),
        check_flash(gen, 1, 32, 64, 8, 128, bf16, "causal"),
        check_flash(gen, 1, 128, 16, 16, 128, bf16, "causal"),
        check_flash(gen, 1, 2048, 64, 8, 128, bf16, "causal"),
        check_flash(gen, 1, 2048, 64, 8, 128, bf16, "sliding", 512),
        check_flash(gen, 1, 2048, 64, 8, 128, bf16, "full"),
        check_flash(gen, 2, 40, 8, 2, 32, f32, "causal"),
        # phase 13's prefills: zamba2-2.7b's shared block (hd 80),
        # phi-3-vision's 576 patches + 32 tokens (hd 96), whisper-medium's
        # encoder (full, T = 1,500: a ragged last key tile) and its
        # cross-attention (32 queries against the 1,500 frames)
        check_flash(gen, 1, 32, 32, 32, 80, bf16, "causal"),
        check_flash(gen, 1, 608, 32, 32, 96, bf16, "causal"),
        check_flash(gen, 1, 1500, 16, 16, 64, bf16, "full"),
        check_flash(gen, 1, 32, 16, 16, 64, bf16, "full", T=1500),
    ]
    decode_checks = [
        # the served tokens: a 32-token prompt + 8 new ones, W = 40
        check_decode(gen, 1, 40, 16, 16, 128, bf16, pos=39),
        check_decode(gen, 1, 40, 64, 8, 128, bf16, pos=39),
        check_decode(gen, 1, 136, 16, 16, 128, bf16, pos=130),
        check_decode(gen, 1, 4096, 64, 8, 128, bf16, pos=5000, window=3000),
        check_decode(gen, 2, 40, 8, 2, 32, f32, pos=35),
        # a row with no valid slot: the mean of V, through the combine
        check_decode(gen, 1, 1024, 16, 2, 128, bf16, pos=None),
        # phase 13's tokens: zamba2-2.7b (hd 80), phi-3-vision after its
        # image (W = 616, hd 96), whisper-medium (hd 64), all G = 1;
        # dbrx-132b (G = 6) and llama4-maverick (G = 5) at hd 128
        check_decode(gen, 1, 40, 32, 32, 80, bf16, pos=39),
        check_decode(gen, 1, 616, 32, 32, 96, bf16, pos=615),
        check_decode(gen, 1, 40, 16, 16, 64, bf16, pos=39),
        check_decode(gen, 1, 40, 48, 8, 128, bf16, pos=39),
        check_decode(gen, 1, 40, 40, 8, 128, bf16, pos=39),
    ]
    ssd_checks = [
        check_ssd(gen, 1, 32, 32, 64, 128, bf16),      # the served prompts
        check_ssd(gen, 1, 128, 32, 64, 128, bf16),     # the longest prompt
        check_ssd(gen, 1, 2048, 32, 64, 128, bf16),    # 16 chunks
        check_ssd(gen, 2, 40, 4, 8, 16, f32, chunk=16),  # ragged L
        check_ssd(gen, 1, 32, 80, 64, 64, bf16),       # zamba2-2.7b's
    ]
    for c in flash_checks + decode_checks + ssd_checks:
        print(f"[kernel] {json.dumps(c)}")
    mark("6")

    # Phase 7: the served path at full width. The served kernels' counters
    # are zeroed before the first generate of each arm.
    server = build_portfolio()
    arms = server.models[:len(ARMS)]
    stream = make_request_stream(24, seed=11)
    served_ops = {"flash_attention": flash_ops,
                  "decode_attention": decode_ops, "ssd_scan": ssd_ops}

    for mod in served_ops.values():
        mod.LAUNCHES[0] = 0
    for routes in (flash_ops.ROUTE_LAUNCHES, ssd_ops.ROUTE_LAUNCHES):
        for r in routes:
            routes[r] = 0
    for model in arms:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model.generate(
            server._tokenizer(model).encode(stream[0]["prompt"]),
            SERVE_NEW_TOKENS)
        torch.cuda.synchronize()
        assert out.shape == (SERVE_NEW_TOKENS,)
        assert ((0 <= out) & (out < model.cfg.vocab_size)).all()
        print(f"[serve] {model.name} first generate {out.tolist()} in "
              f"{time.perf_counter() - t0:.3f} s")
    first = {k: mod.LAUNCHES[0] for k, mod in served_ops.items()}
    assert first == expected_launches(arms, {m.name: 1 for m in arms}), first
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = serve_requests(server, stream)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches.update({k: mod.LAUNCHES[0] for k, mod in served_ops.items()})
    traffic = {m.name: 0 for m in arms}
    for r in results:
        traffic[r.model] += 1
        assert r.tokens_out == SERVE_NEW_TOKENS
    reward = float(np.mean([r.reward for r in results]))
    cost = float(np.mean([r.cost for r in results]))
    lam = float(server.state.pacer.lam[0])
    m = server.metrics()
    assert len(results) == 24 and np.isfinite([reward, cost, lam]).all()
    assert m["decisions_total"] == 24 and m["publishes_total"] >= 3
    print(f"[serve] served {len(results)} requests in {secs:.3f} s: reward "
          f"{reward:.4f}, cost {cost:.4e}/req ({cost / SERVE_BUDGET:.4f} of "
          f"the ceiling), traffic {traffic}, lambda {lam:.6f}, route p50 "
          f"{m['route_p50_us']:.1f} us/decision")
    served_launches = {k: launches[k] - first[k] for k in served_ops}
    print(f"[serve] served-kernel launches: first generates {first}; the "
          f"24 requests {served_launches}, expected from the traffic "
          f"{expected_launches(arms, traffic)}")
    assert served_launches == expected_launches(arms, traffic), (
        served_launches)
    for name in served_ops:
        assert launches[name] > 0, f"{name} was not launched on the path"
    # The served models are bf16 with hd = 128: every prefill must have
    # run on the tensor cores.
    flash_routes = dict(flash_ops.ROUTE_LAUNCHES)
    print(f"[serve] flash_attention launches by route: {flash_routes}")
    assert flash_routes["tensor_cores"] == launches["flash_attention"], (
        flash_routes)
    # Every served prompt is one chunk (at most 128 tokens) of bf16 with
    # N = 128 and P = 64: every ssd_scan launch took one_chunk.
    ssd_routes = dict(ssd_ops.ROUTE_LAUNCHES)
    print(f"[serve] ssd_scan launches by route: {ssd_routes}")
    assert ssd_routes["one_chunk"] == launches["ssd_scan"], ssd_routes
    mark("7")

    # Phase 8: teacher-forced logits, kernel route against plain route.
    # In bf16, as served, the two routes' kernel outputs differ by a bf16
    # ulp here and there (summation order) and random-weight layers
    # amplify that with depth, so the bf16 run is held to
    # TEACHER_BF16_FACTOR times what two plain routes differ by; this is
    # the check of the kernels the served path runs (flash on the tensor
    # cores, decode's mma.sync path). The f32 run (weights cast at use)
    # goes through the FP32-FMA routes and is held to the bf16 tolerance.
    # Every arm is reported before a miss fails the run.
    missed = []
    for model in arms:
        for dtype in ("bfloat16", "float32"):
            err, ok, ok32, agree, plain_err, _ = teacher_forced(
                model, stream[0]["prompt"], dtype)
            print(f"[serve] teacher-forced {model.name} {dtype} "
                  f"activations: max |logit diff| {err:.4e} (bf16 tolerance "
                  f"{'met' if ok else 'missed'}, f32 tolerance "
                  f"{'met' if ok32 else 'missed'}), greedy-token agreement "
                  f"{agree:.4f}; two plain routes (naive vs chunked "
                  f"prefill) differ by {plain_err:.4e} (kernel route / that "
                  f"{err / plain_err:.3f})")
            if dtype == "float32" and not ok:
                missed.append(f"{model.name} f32")
            if dtype == "bfloat16" and err > TEACHER_BF16_FACTOR * plain_err:
                missed.append(f"{model.name} bf16: {err:.4e} > "
                              f"{TEACHER_BF16_FACTOR} x {plain_err:.4e}")
    assert not missed, f"kernel route and plain route disagree: {missed}"
    mark("8")

    # Phase 9: where one served request's time goes, per arm.
    for model in arms:
        t = trace_request(model, stream[0]["prompt"])
        print(f"[trace] {model.name} one request: prefill "
              f"{t['prefill_ms']:.3f} ms host clock, one decode token "
              f"{t['token_ms']:.3f} ms; whole request (prefill + "
              f"{SERVE_NEW_TOKENS} tokens) {t['request_ms']:.3f} ms, device "
              f"busy {t['busy_ms']:.3f} ms in {t['kernels']} kernels (idle "
              f"share {t['idle_share']:.4f}), ported kernels "
              f"{t['ported_ms']:.3f} ms ({t['ported_share']:.4f} of "
              f"device time): {json.dumps(t['ported_by_kernel'])}")
    mark("9")

    # Phase 10: the scenario engine. linucb_step's counters are zeroed
    # just before the phase and read just after.
    step_ops.LAUNCHES[0] = 0
    for r in step_ops.ROUTE_LAUNCHES:
        step_ops.ROUTE_LAUNCHES[r] = 0
    t0 = time.perf_counter()
    want_routes = scenario_phase(bench, priors)
    scenario_routes = dict(step_ops.ROUTE_LAUNCHES)
    print(f"[scenario] phase wall {time.perf_counter() - t0:.1f} s; "
          f"linucb_step launches {step_ops.LAUNCHES[0]} by route "
          f"{scenario_routes}, expected from the specs {want_routes}")
    assert scenario_routes == want_routes, (scenario_routes, want_routes)
    assert step_ops.LAUNCHES[0] == sum(want_routes.values())

    # Phase 11: the sweep fabric. linucb_step's counters are zeroed just
    # before the phase and read just after.
    step_ops.LAUNCHES[0] = 0
    for r in step_ops.ROUTE_LAUNCHES:
        step_ops.ROUTE_LAUNCHES[r] = 0
    t0 = time.perf_counter()
    want_routes = sweep_phase(bench, priors)
    sweep_routes = dict(step_ops.ROUTE_LAUNCHES)
    print(f"[sweep] phase wall {time.perf_counter() - t0:.1f} s; "
          f"linucb_step launches {step_ops.LAUNCHES[0]} by route "
          f"{sweep_routes}, expected from the grids {want_routes}")
    assert sweep_routes == want_routes, (sweep_routes, want_routes)
    assert step_ops.LAUNCHES[0] == sum(want_routes.values())

    # Phase 12: the tenant plane. The LinUCB kernels' counters are zeroed
    # just before the phase and read just after: tenant mode runs on the
    # "torch" backend, so both must read 0.
    score_ops.LAUNCHES[0] = 0
    step_ops.LAUNCHES[0] = 0
    for r in step_ops.ROUTE_LAUNCHES:
        step_ops.ROUTE_LAUNCHES[r] = 0
    t0 = time.perf_counter()
    walls = tenant_phase()
    tenant_launches = {"linucb_score": score_ops.LAUNCHES[0],
                       "linucb_step": step_ops.LAUNCHES[0]}
    print(f"[tenants] phase wall {time.perf_counter() - t0:.1f} s; "
          f"decisions / wall s by sub-phase "
          f"{json.dumps({k: [n, round(t, 3)] for k, (n, t) in walls.items()})}"
          f"; LinUCB kernel launches {tenant_launches} (the reference's route: "
          f"tenant mode runs no kernel)")
    assert tenant_launches == {"linucb_score": 0, "linucb_step": 0}

    # Phase 13: the rest of the model zoo at full width, after phase 7's
    # portfolio has left the card.
    del server, arms, model, results
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    zoo_launches = zoo_phase(stream)
    print(f"[zoo] phase wall {time.perf_counter() - t0:.1f} s; served-kernel "
          f"launches {zoo_launches}")

    # Phase 14: the training path. The five kernels' counters are zeroed
    # just before the phase and read just after: training runs the
    # chunked route, as the JAX package's train step does, so every
    # counter must read 0.
    train_ops = {"linucb_score": score_ops, "linucb_step": step_ops,
                 "flash_attention": flash_ops,
                 "decode_attention": decode_ops, "ssd_scan": ssd_ops}
    for mod in train_ops.values():
        mod.LAUNCHES[0] = 0
    t0 = time.perf_counter()
    train_phase()
    train_launches = {k: mod.LAUNCHES[0] for k, mod in train_ops.items()}
    print(f"[train] phase wall {time.perf_counter() - t0:.1f} s; kernel "
          f"launches {train_launches} (the reference's route: training "
          f"runs no kernel)")
    assert not any(train_launches.values()), train_launches

    # Phase 15: fp8 KV caches through the decode kernel, and the one-device
    # dry run held against the card. decode_attention's counters are
    # zeroed inside fp8_path just before the path's run.
    t0 = time.perf_counter()
    fp8_checks = fp8_kernel_checks(gen)
    for c in fp8_checks:
        print(f"[kernel] {json.dumps(c)}")
    fp8_params, fp8_launches = fp8_path(stream)
    dryrun_phase(fp8_params, smi)
    torch.cuda.empty_cache()
    print(f"[fp8] phase wall {time.perf_counter() - t0:.1f} s")

    # Phase 16: the autotune, Eq. 9 and the port's lint suite. The
    # scoring kernel's counter is zeroed inside tune_phase just before the
    # candidates run.
    t0 = time.perf_counter()
    tune_launches, tune_tables = tune_phase(smi)
    print(f"[tune] phase wall {time.perf_counter() - t0:.1f} s")

    # Phase 17: the placement rules, on phase 15's parameters. They launch
    # none of the five kernels.
    t0 = time.perf_counter()
    placement_phase(fp8_params, smi)
    del fp8_params
    torch.cuda.empty_cache()
    print(f"[place] phase wall {time.perf_counter() - t0:.1f} s")

    # Phase 18: the dry run on the production mesh, on meta tensors. The
    # five kernels' counters are zeroed just before it and read just
    # after: the dry run launches none.
    for mod in train_ops.values():
        mod.LAUNCHES[0] = 0
    t0 = time.perf_counter()
    mesh_dryrun_phase(smi)
    mesh_launches = {k: mod.LAUNCHES[0] for k, mod in train_ops.items()}
    mesh_wall = time.perf_counter() - t0
    print(f"[mesh] phase wall {mesh_wall:.1f} s; kernel launches "
          f"{mesh_launches}")
    assert not any(mesh_launches.values()), mesh_launches
    assert mesh_wall <= MESH_PHASE_S, mesh_wall

    def entry(name, source, replaces, checks, n):
        main = checks[0]
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=n,
                    max_abs_err=max(c["max_abs_err"] for c in checks),
                    ms=main["ms"], plain_ms=main["plain_ms"],
                    bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                    library_ms=main["library_ms"], checks=checks)

    kernels = [
        entry("linucb_score", "src/repro_torch/kernels/csrc/linucb_score.cu",
              "src/repro/kernels/linucb_score/kernel.py:24", score_checks,
              launches["linucb_score"]),
        entry("linucb_step", "src/repro_torch/kernels/csrc/linucb_step.cu",
              "src/repro/kernels/linucb_step/kernel.py:70", step_checks,
              launches["linucb_step"]),
        entry("flash_attention",
              "src/repro_torch/kernels/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention/kernel.py:23", flash_checks,
              launches["flash_attention"]),
        entry("decode_attention",
              "src/repro_torch/kernels/csrc/decode_attention.cu",
              "src/repro/kernels/decode_attention/kernel.py:23",
              decode_checks + fp8_checks, launches["decode_attention"]),
        entry("ssd_scan", "src/repro_torch/kernels/csrc/ssd_scan.cu",
              "src/repro/kernels/ssd_scan/kernel.py:21", ssd_checks,
              launches["ssd_scan"]),
    ]
    for k in kernels:
        if k["name"] in served_launches:
            k["launches_served"] = served_launches[k["name"]]
            k["launches_zoo"] = zoo_launches[k["name"]]
    kernels[1]["launches_by_route"] = step_routes
    kernels[1]["launches_scenario_by_route"] = scenario_routes
    kernels[1]["launches_sweep_by_route"] = sweep_routes
    for k in kernels[:2]:
        k["launches_tenants"] = tenant_launches[k["name"]]
    for k in kernels:
        k["launches_train"] = train_launches[k["name"]]
        k["launches_mesh_dryrun"] = mesh_launches[k["name"]]
    kernels[3]["launches_fp8"] = fp8_launches
    kernels[0]["launches_tune"] = tune_launches
    kernels[0]["tune_graph_ms"] = tune_tables
    kernels[2]["launches_by_route"] = flash_routes
    kernels[4]["launches_by_route"] = ssd_routes
    print(f"[wall] chip_smoke.py {time.perf_counter() - start:.1f} s, the "
          f"kernels' build included")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from src/repro_torch/kernels/csrc (into
build/kernels/ at first use) and lists each kernel's registers and spills
(a spill in the attention, LinUCB or SSD kernels fails the run), then:

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
     its bound at that route's peak;
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
     benchmarks' protocols at full size (1,824 requests, 20 seeds, fitted
     priors, alpha 0.01, gamma 0.997): silent and recalibrated drift, the
     0.75 regression and good_cheap onboarding, request by request and in
     blocks of 256, each block run (and the silent drift request by
     request) held to the "torch" oracle per segment (arm agreement >=
     0.99, mean reward within 1e-3); (c) a silent drift under
     Timeline((512, 1280), horizon=1792) on a padded horizon of 2048,
     identical to the retimed spec's run in blocks of 256 and request by
     request. linucb_step's counters are zeroed before the phase; its
     launches by route must equal what the specs imply (ceil(L / B)
     blocks a segment, padded steps included).

Prints the kernels JSON line, then the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Any failed check raises, so the exit
code is non-zero and no result line is printed. Without a CUDA device,
or run from a directory without the repository's src/, it exits 2.
"""
from __future__ import annotations

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


def host_ms(fns, reps: int = 7):
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
            # <dtype> and, for decode_split_kernel, <dtype, path>.
            t = re.search(name + r"I(f|13__nv_bfloat16)(?:Li(\d)E)?", mangled)
            if t:
                args = [{"f": "f32", "13__nv_bfloat16": "bf16"}[t.group(1)]]
                if t.group(2):
                    args.append(("fma", "mma")[int(t.group(2))])
                name += "<" + ", ".join(args) + ">"
            # <DP> of linucb_score_kernel, <threads, lanes per row> of
            # linucb_update_kernel.
            t = re.search(name + r"I((?:Li\d+E)+)E", mangled)
            if t:
                name += "<" + ", ".join(re.findall(r"\d+", t.group(1))) + ">"
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


def check_flash(gen, B, S, H, KV, hd, dtype, mode, window=0):
    """flash_attention against its plain version on (B, S, H, KV, hd); the
    library yardstick is one scaled_dot_product_attention call."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.kernel import flash_attention_bshd
    from repro_torch.kernels.flash_attention.kernel import route as flash_route
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    mk = lambda *shape: torch.randn(shape, generator=gen, device="cuda",  # noqa: E731
                                    dtype=dtype)
    q, k, v = mk(B, S, H, hd), mk(B, S, KV, hd), mk(B, S, KV, hd)
    name = str(dtype).split(".")[1]
    got = ops.flash_attention(q, k, v, mode=mode, window=window)
    want = flash_attention_ref(q, k, v, mode=mode, window=window)
    route = flash_route(dtype, hd)
    torch.cuda.synchronize()
    err, ok = _attn_err(got, want, name)
    rel, rel_ok = _row_rel_err(got, want, name)
    assert ok and rel_ok, (f"flash_attention disagrees at "
                           f"{(B, S, H, KV, hd, name, mode)}: max abs {err}, "
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
    # against 0..S-1): whatever tiles a kernel visits, these inputs need
    # no more.
    if mode == "full":
        pairs = S * S
    else:
        reach = S if mode == "causal" else window
        pairs = sum(min(i + 1, reach) for i in range(S))
    flops = 4 * B * H * hd * pairs
    nbytes = q.element_size() * (2 * B * S * H * hd + 2 * B * S * KV * hd)
    peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
    bms, by = bound(nbytes, flops, peak)
    return dict(shape=dict(B=B, S=S, H=H, KV=KV, hd=hd, dtype=name,
                           mode=mode, window=window),
                route=route, max_abs_err=err, row_rel_err=rel, ms=ms,
                device_ms=dev_ms, graph_ms=g_ms,
                library_device_ms=library_dev_ms,
                library_graph_ms=library_g_ms, plain_ms=plain_ms,
                library_ms=library_ms, library_err=lib_err, bound_ms=bms,
                bound_by=by, flops=flops, bytes=nbytes,
                peak="bf16 tensor cores" if peak == BF16_FLOP_PER_S
                else "fp32")


def check_decode(gen, B, W, H, KV, hd, dtype, pos, window=0):
    """decode_attention against its plain version: one token at absolute
    position ``pos`` against a W-slot ring (wrapped once pos >= W, and
    inside ``window`` when given). ``pos=None`` makes a row with no valid
    slot, whose output is the mean of V (the plain version, as JAX's
    reference); SDPA has no such answer, so that check times no library
    call."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_bkv, sm_count, split_plan,
    )
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.models.attention import ring_valid

    mk = lambda *shape: torch.randn(shape, generator=gen, device="cuda",  # noqa: E731
                                    dtype=dtype)
    q, kc, vc = mk(B, 1, H, hd), mk(B, W, KV, hd), mk(B, W, KV, hd)
    valid = (torch.zeros(W, dtype=torch.bool, device="cuda") if pos is None
             else ring_valid(pos, W, window, "cuda"))
    nv = int(valid.sum())
    name = str(dtype).split(".")[1]
    got = ops.decode_attention(q, kc, vc, valid)
    want = decode_attention_ref(q, kc, vc, valid)
    torch.cuda.synchronize()
    err, ok = _attn_err(got, want, name)
    rel, rel_ok = _row_rel_err(got, want, name)
    assert ok and rel_ok, (f"decode_attention disagrees at "
                           f"{(B, W, H, KV, hd, name)}: max abs {err}, "
                           f"row-relative {rel}")
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
        qt, kt, vt = (t.transpose(1, 2) for t in (q, kc, vc))
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=valid.view(1, 1, 1, W), enable_gqa=True)
        lib_err, lib_ok = _attn_err(lib().transpose(1, 2), want, name)
        assert lib_ok, f"library attention disagrees: {lib_err}"
        library_ms = cuda_ms(lib)
        library_dev_ms = device_ms(lib)
    # What this run's data needs: the valid slots' K and V once, q, o and
    # the (W,) mask; 4 operations per (head, valid slot, hd). A row with
    # no valid slot needs V once and one addition per element of it.
    es = q.element_size()
    nbytes = es * (2 * B * nv * KV * hd + 2 * B * H * hd) + W
    flops = 4 * B * H * nv * hd
    if not nv:
        nbytes += es * B * W * KV * hd
        flops = B * W * KV * hd
    peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
    bms, by = bound(nbytes, flops, peak)
    return dict(shape=dict(B=B, W=W, H=H, KV=KV, hd=hd, dtype=name, pos=pos,
                           window=window, valid=nv),
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


def build_portfolio():
    """The PortfolioServer of ARMS at full width on the card."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.core.costs import price_from_active_params
    from repro_torch.core.features import fit_pca_whitener, hash_encode_batch
    from repro_torch.core.types import RouterConfig
    from repro_torch.data import make_request_stream
    from repro_torch.serving import PortfolioServer, ServedModel

    models = []
    for i, (arch, tier, layers) in enumerate(ARMS):
        full = configs.get_config(arch)
        cfg = full
        if layers is not None:
            cfg = dataclasses.replace(full, num_layers=layers)
            print(f"[serve] reduced: {arch} depth {full.num_layers} -> "
                  f"{layers} layers at full width (d_model {full.d_model}, "
                  f"{full.num_heads} heads, {full.num_kv_heads} kv heads, "
                  f"d_ff {full.d_ff}, vocab {full.vocab_size}): "
                  f"{full.active_params() * 2 / 1e9:.0f} GB of bf16 weights "
                  "do not fit one card")
        pricing = price_from_active_params(arch, full.active_params(),
                                           mean_req_tokens=600)
        torch.cuda.synchronize()
        t0, mem0 = time.perf_counter(), torch.cuda.memory_allocated()
        models.append(ServedModel.init(cfg, pricing, tier, seed=i,
                                       device="cuda"))
        torch.cuda.synchronize()
        gb = (torch.cuda.memory_allocated() - mem0) / 1e9
        print(f"[serve] arm {i}: {arch} {cfg.num_layers} layers, "
              f"{cfg.active_params() / 1e9:.3f} B params in {cfg.dtype}, "
              f"{gb:.2f} GB on the card, ${pricing.price_per_1k:.3e}/1k tok "
              f"({tier}), init {time.perf_counter() - t0:.2f} s")
    corpus = [r["prompt"] for r in make_request_stream(400, seed=7)]
    whitener = fit_pca_whitener(hash_encode_batch(corpus), device="cuda")
    return PortfolioServer(models, whitener, budget=SERVE_BUDGET,
                           router_cfg=RouterConfig(max_arms=8),
                           max_new_tokens=SERVE_NEW_TOKENS, device="cuda")


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


def teacher_forced(model, text, dtype, n_tokens=SERVE_NEW_TOKENS):
    """One prompt and ``n_tokens`` fixed tokens through the kernel route
    and the plain route with activations in ``dtype`` (the served bf16
    weights cast at use): (max abs logit difference, within the bf16
    tolerance, within the f32 tolerance, greedy-token agreement over the
    1 + n_tokens positions, and the max abs difference between two plain
    routes that differ only in the prefill's summation order: naive and
    chunked)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.models import decode_step, prefill_forward

    cfg = dataclasses.replace(model.cfg, dtype=dtype)
    toks = _prompt(model, text)
    fixed = np.random.default_rng(5).integers(2, cfg.vocab_size, n_tokens)
    runs = {}
    for prefill_impl, decode_impl in (("cuda", "cuda"),
                                      ("chunked", "chunked"),
                                      ("naive", "chunked")):
        logits, caches = prefill_forward(model.params, cfg, toks,
                                         cache_len=toks.shape[1] + n_tokens,
                                         impl=prefill_impl)
        out = [logits]
        for t in fixed:
            cur = torch.full((1, 1), int(t), device="cuda")
            logits, caches = decode_step(model.params, cfg, cur, caches,
                                         decode_impl)
            out.append(logits)
        runs[prefill_impl] = torch.stack(out)
    err, ok = _attn_err(runs["cuda"], runs["chunked"], "bfloat16")
    _, ok32 = _attn_err(runs["cuda"], runs["chunked"], "float32")
    agree = float((runs["cuda"].argmax(-1) == runs["chunked"].argmax(-1))
                  .float().mean())
    plain_err, _ = _attn_err(runs["naive"], runs["chunked"], "bfloat16")
    return err, ok, ok32, agree, plain_err


# The served kernels' names (csrc/flash_attention.cu, decode_attention.cu,
# ssd_scan.cu), as the profiler reports them.
PORTED_KERNELS = ("flash_wgmma_kernel", "flash_kernel", "decode_split_kernel",
                  "decode_combine_kernel") + SSD_KERNELS


def trace_request(model, text):
    """Host ms of prefill, of one decode token and of one whole request
    (prefill + 8 tokens), each the least of 7 synchronised calls; then the
    request once under torch.profiler for its device busy ms and the
    ported kernels' share of device time (flash_attention,
    decode_attention, ssd_scan). The idle share is 1 - busy / the
    unprofiled request time (the profiler slows the host)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import decode_step, prefill_forward

    toks = _prompt(model, text)
    W = toks.shape[1] + SERVE_NEW_TOKENS
    _, caches = prefill_forward(model.params, model.cfg, toks, cache_len=W)
    cur = torch.full((1, 1), 7, device="cuda")
    # decode_step writes its token's K/V at the same slot on every call
    # with these caches, so repeated calls time the same step (an SSM's
    # state moves on, at the same cost).
    ids = toks[0].cpu().numpy()
    request = lambda: model.generate(ids, SERVE_NEW_TOKENS)  # noqa: E731
    prefill_ms, token_ms, wall_ms = host_ms([
        lambda: prefill_forward(model.params, model.cfg, toks, cache_len=W),
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

    # (b) The benchmarks' protocols at full size against the oracle.
    pareto = RouterConfig(hyper=HyperParams(**PARETO_HYPER))
    oracle = RouterConfig(backend="torch", hyper=HyperParams(**PARETO_HYPER))
    drift_spec = lambda recal: ScenarioSpec(  # noqa: E731
        horizon=3 * PHASE, events=(
            PriceChange(PHASE, GEMINI, PRICE_MULT, recalibrate=recal),
            PriceChange(2 * PHASE, GEMINI, 1.0, recalibrate=recal)),
        stream_seed_base=1000, replay=((2, 0),))
    protocols = [
        ("drift silent", drift_spec(False), test, BUDGET_TIGHT, pri3),
        ("drift recalibrated", drift_spec(True), test, BUDGET_TIGHT, pri3),
        ("regression 0.75", ScenarioSpec(horizon=3 * PHASE, events=(
            QualityShift(PHASE, MISTRAL, 0.75),
            QualityShift(2 * PHASE, MISTRAL, None)), stream_seed_base=2000,
            replay=((2, 0),)), test, BUDGET_MODERATE, pri3),
        ("onboarding good_cheap", ScenarioSpec(
            horizon=3 * PHASE, events=(AddArm(PHASE, FLASH),),
            segment_seeds=(3000, 4000), init_active=3),
         simulator.extend_with_flash(test, "good_cheap"), BUDGET_MODERATE,
         pri4),
    ]
    for label, spec, env, budget, pri in protocols:
        for bs in (None, SCENARIO_BLOCK):
            got = run(pareto, spec, env, budget, SEEDS, bs, pri, label)
            if bs is None and label != "drift silent":
                continue
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
    spec = ScenarioSpec(horizon=8 * SCENARIO_BLOCK, events=(
        PriceChange(PHASE, GEMINI, PRICE_MULT),
        PriceChange(2 * PHASE, GEMINI, 1.0)), stream_seed_base=1000)
    tl = Timeline((2 * SCENARIO_BLOCK, 5 * SCENARIO_BLOCK),
                  horizon=7 * SCENARIO_BLOCK)
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


def main() -> int:
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
    ]
    ssd_checks = [
        check_ssd(gen, 1, 32, 32, 64, 128, bf16),      # the served prompts
        check_ssd(gen, 1, 128, 32, 64, 128, bf16),     # the longest prompt
        check_ssd(gen, 1, 2048, 32, 64, 128, bf16),    # 16 chunks
        check_ssd(gen, 2, 40, 4, 8, 16, f32, chunk=16),  # ragged L
    ]
    for c in flash_checks + decode_checks + ssd_checks:
        print(f"[kernel] {json.dumps(c)}")

    # Phase 7: the served path at full width. The served kernels' counters
    # are zeroed before the first generate of each arm.
    server = build_portfolio()
    arms = server.models[:len(ARMS)]
    stream = make_request_stream(24, seed=11)
    served_ops = {"flash_attention": flash_ops,
                  "decode_attention": decode_ops, "ssd_scan": ssd_ops}

    def expected(counts):
        """Launches of the served kernels for ``counts[arm name]``
        requests: flash once per attention layer per request, decode once
        per attention layer per generated token, ssd_scan once per mamba2
        layer per request."""
        want = dict.fromkeys(served_ops, 0)
        for model in arms:
            n, L = counts.get(model.name, 0), model.cfg.num_layers
            if model.cfg.arch_type == "ssm":
                want["ssd_scan"] += n * L
            else:
                want["flash_attention"] += n * L
                want["decode_attention"] += n * L * SERVE_NEW_TOKENS
        return want

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
    assert first == expected({m.name: 1 for m in arms}), first
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
          f"{expected(traffic)}")
    assert served_launches == expected(traffic), served_launches
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
            err, ok, ok32, agree, plain_err = teacher_forced(
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
              decode_checks, launches["decode_attention"]),
        entry("ssd_scan", "src/repro_torch/kernels/csrc/ssd_scan.cu",
              "src/repro/kernels/ssd_scan/kernel.py:21", ssd_checks,
              launches["ssd_scan"]),
    ]
    for k in kernels:
        if k["name"] in served_launches:
            k["launches_served"] = served_launches[k["name"]]
    kernels[1]["launches_by_route"] = step_routes
    kernels[1]["launches_scenario_by_route"] = scenario_routes
    kernels[2]["launches_by_route"] = flash_routes
    kernels[4]["launches_by_route"] = ssd_routes
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

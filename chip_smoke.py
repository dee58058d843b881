#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from src/repro_torch/kernels/csrc (into
build/kernels/ at first use), then:

  1. prints the card, its power limit and the torch / CUDA versions, and
     turns TF32 off for matrix products and convolutions;
  2. holds each kernel against its plain PyTorch version on the card at
     the main path's shapes and at the largest supported shape (K = 8,
     d = 128), and times kernel, plain version and (for the scoring
     kernel) one einsum expression computing the same scores;
  3. drives the main path at the paper's configuration: make_benchmark
     (1,824 test prompts), fitted priors, RouterConfig() (d = 26, 8 slots,
     3 active, backend "fused"), 20 seeds, n_eff = 1164, evaluate.run at
     budgets 3.0e-4 and 6.6e-4 with blocks of 256 and request by request
     (compliance within (0.9, 1.10) at 3.0e-4 request by request), then
     select-only serving of a 256-request block through the scoring
     kernel; the kernels' launch counters are zeroed just before and read
     just after, and each kernel must have been launched;
  4. runs both block runs and the per-request run at 3.0e-4 on the
     "torch" oracle backend: arm agreement >= 0.99 and mean reward within
     1e-3;
  5. checks the served scores against the oracle's within 1e-4.

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

SEEDS = tuple(range(20))
N_EFF = 1164.0
BUDGETS = (3.0e-4, 6.6e-4)


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
    """(device busy ms, device kernels, ms of linucb_step's kernels) of
    one call of ``fn`` under torch.profiler: the sum of every CUDA kernel's
    duration on the device."""
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
            if "select_kernel" in e.name or "update_kernel" in e.name]
    return us(kernels) / 1e3, len(kernels), us(ours) / 1e3


def bound(nbytes: float, flops: float):
    """(least time in ms, what bounds it) on the H100's published peaks."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def spd_inverses(rng, S, K, d):
    import numpy as np

    M = rng.standard_normal((S, K, d, d)) * 0.1
    A = np.einsum("skij,sklj->skil", M, M) + np.eye(d) * 1.2
    return A, np.linalg.inv(A)


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
    nbytes = 4 * (S * R * d + S * K * d + S * K * d * d + 2 * S * K + S
                  + S * R * K)
    flops = 2 * S * R * K * d * d + 2 * S * R * K * d
    bms, by = bound(nbytes, flops)
    return dict(shape=dict(S=S, R=R, K=K, d=d), max_abs_err=err, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms,
                library_form=library_form, library_all_ms=library,
                bound_ms=bms, bound_by=by)


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
    from repro_torch.kernels.linucb_step.kernel import linucb_step_blocked
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
    lam, c_ema = want[8], want[9]
    assert bool(((lam > lam0) & (lam < lbar)).all()), (
        f"lam left (lam0, lambda_bar) or did not move: {lam}")
    assert bool((c_ema > args["budget"].cpu()).all()
                and (c_ema != cema0).all()), f"c_ema did not bind: {c_ema}"
    # Time the kernel alone into the outputs just checked, and the plain
    # version on the same operands on the card.
    ms = cuda_ms(lambda: linucb_step_blocked(ins, got, num_valid=B,
                                             dt_max=4096))
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
    return dict(shape=dict(S=S, B=B, K=K, d=d), max_abs_err=err,
                lam=[float(lam.min()), float(lam.max())], ms=ms,
                plain_ms=plain_ms, library_ms=None, bound_ms=bms,
                bound_by=by)


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
    for line in build.build_log().splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build]   {line.strip()}")

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
    print(f"[main] kernel launches on the main path: {launches}")
    for name, n in launches.items():
        assert n > 0, f"{name} was not launched on the main path"

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
              f"{1 - busy_ms / block_ms:.4f}), linucb_step's two kernels "
              f"{ours_ms:.3f} ms")

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
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

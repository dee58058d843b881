"""The port's CUDA kernels on the card: each against its plain version,
the fused closed loop against the torch oracle, and the served
portfolio. Marked ``cuda``; without a GPU every test skips (the decision
is taken inside the fixture, never at import). On a machine with a card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import evaluate, router, simulator  # noqa: E402
from repro_torch.core.types import RouterConfig  # noqa: E402
from repro_torch.kernels.linucb_score import ops as score_ops  # noqa: E402
from repro_torch.kernels.linucb_score.ref import linucb_score_ref  # noqa: E402
from repro_torch.kernels.linucb_step import ops as step_ops  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inv(rng, S, K, d):
    M = rng.standard_normal((S, K, d, d)) * 0.1
    return np.linalg.inv(np.einsum("skij,sklj->skil", M, M) + np.eye(d) * 1.2)


@pytest.mark.parametrize("S,R,K,d", [
    (1, 1, 1, 2), (3, 33, 3, 26), (2, 300, 8, 128), (4, 7, 5, 13),
    # every built width (DP 32 / 64 / 128) and its edges, K 1 / 3 / 8,
    # R not a multiple of the 128-row tile, S > 1
    (20, 256, 8, 26), (1, 4096, 8, 128), (2, 129, 1, 32), (3, 200, 3, 100),
    (2, 130, 8, 33), (3, 127, 8, 64), (2, 257, 3, 65), (1, 1000, 1, 128)])
def test_score_kernel_matches_plain(dev, S, R, K, d):
    rng = np.random.default_rng(S * R + d)
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,  # noqa: E731
                                  device=dev)
    args = (f(rng.standard_normal((S, R, d))),
            f(rng.standard_normal((S, K, d)) * 0.1), f(_inv(rng, S, K, d)),
            f(rng.uniform(0, 1, (S, K))), f(rng.uniform(0.005, 1, (S, K))),
            f(rng.uniform(0.01, 0.1, S)))
    n = score_ops.LAUNCHES[0]
    got = score_ops.linucb_score(*args)
    assert score_ops.LAUNCHES[0] == n + 1
    torch.testing.assert_close(got, linucb_score_ref(*args), rtol=2e-4,
                               atol=2e-5)


@pytest.mark.parametrize("one_arm", [False, True])
@pytest.mark.parametrize("S,B,K,d", [
    (1, 1, 3, 8), (3, 13, 4, 26), (2, 64, 8, 128),
    # B = 1 (the single launch) and B > 1 (score + update chained), both
    # update layouts (one warp at d <= 32, 256 threads above), B past the
    # 32- and 256-row request chunks
    (20, 1, 8, 26), (4, 1, 8, 128), (5, 256, 8, 26), (2, 256, 8, 128),
    (3, 300, 8, 26), (2, 300, 4, 128), (2, 40, 3, 33)])
def test_step_kernel_matches_plain(dev, S, B, K, d, one_arm):
    """Arms and last_upd exact, everything else within 1e-4, on each
    route; with ``one_arm`` every request chooses arm 1 (the only
    candidate), so the busiest arm takes the whole block's chain."""
    from repro_torch.kernels.linucb_step.kernel import route

    rng = np.random.default_rng(B + d)
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,  # noqa: E731
                                  device=dev)
    Ainv = _inv(rng, S, K, d)
    b = rng.standard_normal((S, K, d)) * 0.1
    vec = lambda v: f(np.full(S, v))  # noqa: E731
    args = [f(np.linalg.inv(Ainv)), f(Ainv), f(b),
            f(np.einsum("skij,skj->ski", Ainv, b)),
            torch.as_tensor(rng.integers(0, 50, (S, K)), dtype=torch.int32,
                            device=dev),
            f(rng.standard_normal((S, B, d))), f(rng.uniform(0, 1, (S, B, K))),
            f(rng.uniform(0, 1e-3, (S, B, K))),
            f(rng.uniform(0, 1e-7, (S, B, K))),
            torch.ones((S, K), dtype=torch.bool, device=dev)
            if not one_arm else
            (torch.arange(K, device=dev) == min(1, K - 1))[None]
            .expand(S, K).contiguous(),
            f(rng.uniform(0, 0.5, (S, K))), f(rng.uniform(0.01, 1, (S, K))),
            vec(0.05), vec(0.997), vec(0.05), vec(0.05), vec(5.0),
            vec(0.2), vec(5e-4), vec(6.6e-4),
            torch.full((S,), 60, dtype=torch.int32, device=dev),
            torch.full((S,), min(1, K - 1), dtype=torch.int32, device=dev),
            (torch.arange(B, device=dev) < 2)[None].expand(S, B).contiguous()]
    n, which = step_ops.LAUNCHES[0], route(B)
    n_route = step_ops.ROUTE_LAUNCHES[which]
    got = step_ops.linucb_step(*args)
    assert step_ops.LAUNCHES[0] == n + 1
    assert step_ops.ROUTE_LAUNCHES[which] == n_route + 1
    want = step_ops.linucb_step(*(a.cpu() for a in args))
    if one_arm:
        assert bool((want[5] == min(1, K - 1)).all())
    for g, w in zip(got, want):
        if g.dtype == torch.int32:
            assert torch.equal(g.cpu(), w)
        else:
            torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("batch_size", [None, 16])
def test_fused_run_matches_oracle(dev, batch_size):
    b = simulator.make_benchmark(
        seed=0, splits={"train": 256, "val": 16, "test": 128}, device=dev)
    priors = evaluate.fit_warmup_priors(RouterConfig(), b.train)
    res = {}
    for bk in ("torch", "fused"):
        res[bk] = evaluate.run(RouterConfig(backend=bk), b.test, 6.6e-4,
                               seeds=(0, 1, 2), priors=priors, n_eff=1164.0,
                               batch_size=batch_size)
    assert (res["torch"].arms == res["fused"].arms).mean() >= 0.99
    assert abs(res["torch"].mean_reward - res["fused"].mean_reward) < 1e-3


def test_select_batch_score_backend_on_card(dev):
    b = simulator.make_benchmark(
        seed=1, splits={"train": 256, "val": 64, "test": 64}, device=dev)
    cfg = RouterConfig()
    _, st = evaluate.run(cfg, b.test, 6.6e-4, seeds=(0, 1), batch_size=16,
                         priors=evaluate.fit_warmup_priors(cfg, b.train),
                         n_eff=1164.0, return_states=True)
    xs, _, _, _ = evaluate.build_run_streams(cfg, b.val, (0, 1))
    dec, _ = router.select_batch(RouterConfig(backend="score"), st, xs)
    ref, _ = router.select_batch(RouterConfig(backend="torch"), st, xs)
    assert (dec.scores - ref.scores).abs().max() <= 1e-4


def _scenario_bench(dev):
    b = simulator.make_benchmark(
        seed=0, splits={"train": 256, "val": 16, "test": 128}, device=dev)
    env4 = simulator.extend_with_flash(b.test, "good_cheap")
    return env4, evaluate.fit_warmup_priors(RouterConfig(), b.train) + [None]


@pytest.mark.parametrize("batch_size", [None, 16])
def test_scenario_on_card_matches_cpu_plain(dev, batch_size):
    """A multi-event scenario through the step kernel on the card against
    the same run through its plain version on the CPU."""
    from repro_torch.core.scenario import (
        AddArm, BudgetChange, HyperShift, PriceChange, QualityShift,
        ScenarioSpec,
    )
    env4, priors = _scenario_bench(dev)
    spec = ScenarioSpec(horizon=192, events=(
        AddArm(32, 3), PriceChange(64, 2, 1 / 56, recalibrate=True),
        QualityShift(96, 1, 0.7), BudgetChange(128, 3.0e-4),
        HyperShift(160, gamma=0.99)), stream_seed_base=50, init_active=3)
    cpu_priors = [None if p is None else type(p)(p.A_off.cpu(), p.b_off.cpu())
                  for p in priors]
    n = step_ops.LAUNCHES[0]
    got = evaluate.run_scenario(RouterConfig(), spec, env4, 6.6e-4,
                                seeds=(0, 1, 2), priors=priors, n_eff=1164.0,
                                batch_size=batch_size)
    assert step_ops.LAUNCHES[0] > n
    want = evaluate.run_scenario(RouterConfig(), spec, env4, 6.6e-4,
                                 seeds=(0, 1, 2), priors=cpu_priors,
                                 n_eff=1164.0, batch_size=batch_size,
                                 device="cpu")
    assert got.bounds == want.bounds
    assert (got.arms == want.arms).mean() >= 0.99
    assert abs(got.mean_reward - want.mean_reward) < 1e-3


@pytest.mark.parametrize("batch_size", [None, 16])
def test_timeline_identity_on_card(dev, batch_size):
    """On the card too, a timeline run is identical to the concrete
    retimed spec's run on its live steps."""
    from repro_torch.core.scenario import (
        AddArm, BudgetChange, PriceChange, ScenarioSpec, Timeline, retime,
    )
    env4, priors = _scenario_bench(dev)
    spec = ScenarioSpec(horizon=192, events=(
        PriceChange(48, 2, 0.1), AddArm(96, 3), BudgetChange(144, 3.0e-4)),
        stream_seed_base=51, init_active=3)
    tl = Timeline((32, 80, 112), horizon=160)
    kw = dict(seeds=(0, 1, 2), priors=priors, n_eff=1164.0,
              batch_size=batch_size)
    base = evaluate.run_scenario(RouterConfig(), retime(spec, tl), env4,
                                 6.6e-4, **kw)
    masked = evaluate.run_scenario(RouterConfig(), spec, env4, 6.6e-4,
                                   timeline=tl, **kw)
    for f in ("arms", "rewards", "costs", "lams"):
        np.testing.assert_array_equal(getattr(masked, f), getattr(base, f))
    assert masked.bounds == base.bounds


def test_tenant_fold_equals_grouped_fold_on_card(dev):
    """DESIGN.md §15 on the card: the interleaved tenant fold equals each
    (state, tenant) group folded through ``pacer_update_batch``, bit for
    bit, and spend the arrival-order f32 sum."""
    from repro_torch.core import pacer, tenancy
    from repro_torch.core.types import HyperParams

    rng = np.random.default_rng(19)
    S, B, T = 4, 256, 8
    costs = rng.uniform(1e-5, 8e-4, (S, B)).astype(np.float32)
    tids = rng.integers(0, T, (S, B))
    budgets = rng.uniform(1.8e-4, 2.8e-4, T).astype(np.float32)
    hp = HyperParams().as_leaves(S, dev)
    tab = tenancy.expand(tenancy.make_table(budgets, device=dev), S)
    out = tenancy.tenant_fold(hp, tab, torch.as_tensor(tids, device=dev),
                              torch.as_tensor(costs, device=dev))
    hp1 = HyperParams().as_leaves(1, dev)
    for s in range(S):
        for j in range(T):
            cs = costs[s][tids[s] == j]
            row = tenancy.table_row(tab, j)
            row = type(row)(*(getattr(row, f)[s:s + 1] for f in
                              ("lam", "c_ema", "budget", "enabled")))
            ref = pacer.pacer_update_batch(
                hp1, row, torch.as_tensor(cs, device=dev)[None])
            assert out.lam[s, j].item() == ref.lam.item(), (s, j)
            assert out.c_ema[s, j].item() == ref.c_ema.item(), (s, j)
            assert int(out.pulls[s, j]) == len(cs)
            spend = np.float32(0.0)
            for c in cs:
                spend = np.float32(spend + c)
            assert out.spend[s, j].item() == spend, (s, j)


def _tenant_bench(dev):
    b = simulator.make_benchmark(
        seed=0, splits={"train": 256, "val": 16, "test": 256}, device=dev)
    priors = evaluate.fit_warmup_priors(RouterConfig(), b.train)
    tids = np.random.default_rng(4).integers(0, 4, 256).astype(np.int32)
    return b, priors, tids


def test_tenant_run_on_card_matches_cpu(dev):
    """A tenanted evaluate.run (the ``torch`` backend, blocks of 32) on
    the card chooses the same arms as on the CPU, with the final tables
    within 1e-4; it launches no LinUCB kernel."""
    from repro_torch.core import tenancy

    b, priors, tids = _tenant_bench(dev)
    cfg = RouterConfig(backend="torch", forced_pulls=0)
    budgets = (2.0e-4, 3.0e-4, 4.5e-4, 6.0e-4)
    n = (score_ops.LAUNCHES[0], step_ops.LAUNCHES[0])
    kw = dict(seeds=(0, 1), n_eff=1164.0, batch_size=32, tenant_ids=tids,
              return_states=True)
    got, gfin = evaluate.run(cfg, b.test, 1.0, priors=priors,
                             tenants=tenancy.make_table(budgets), **kw)
    assert (score_ops.LAUNCHES[0], step_ops.LAUNCHES[0]) == n
    cpu_priors = [type(p)(p.A_off.cpu(), p.b_off.cpu()) for p in priors]
    want, wfin = evaluate.run(
        cfg, b.test, 1.0, priors=cpu_priors, device="cpu",
        tenants=tenancy.make_table(budgets, device="cpu"), **kw)
    np.testing.assert_array_equal(got.arms, want.arms)
    for f in ("lam", "c_ema"):
        torch.testing.assert_close(getattr(gfin.tenants, f).cpu(),
                                   getattr(wfin.tenants, f), rtol=1e-4,
                                   atol=1e-4)
    assert torch.equal(gfin.tenants.pulls.cpu(), wfin.tenants.pulls)


def test_tenant_gateway_round_trip_on_card(dev, tmp_path):
    """The tenanted gateway on the card: save -> restore(elapsed) equals
    ``decay_on_restore`` of the saved state within 1e-6."""
    from repro_torch import interop
    from repro_torch.core import statehandle, tenancy
    from repro_torch.serving.gateway import MicroBatcher, RouterGateway

    b, priors, tids = _tenant_bench(dev)
    cfg = RouterConfig(backend="torch", forced_pulls=0)
    st = evaluate.make_states(cfg, b.test, 1.0, (0,), priors=priors,
                              n_eff=1164.0, tenants=tenancy.make_table(
                                  (2.0e-4, 3.0e-4, 4.5e-4, 6.0e-4)))
    gw = RouterGateway(cfg, st, batcher=MicroBatcher(max_batch=16))
    X = b.test.contexts.astype(np.float32)
    for w in range(8):
        rows = np.arange(w * 16, (w + 1) * 16)
        res = gw.route_block(rows.tolist(), X[rows], tenant_ids=tids[rows])
        gw.enqueue_feedback(rows.tolist(), res.arms,
                            b.test.rewards[rows, res.arms],
                            b.test.costs[rows, res.arms])
        gw.learn_tick()
    path = str(tmp_path / "snap")
    saved = gw.save(path).state
    gw.restore(path, elapsed=40)
    want = interop.state_to_numpy(
        statehandle.decay_on_restore(cfg, saved, 40))
    got = interop.state_to_numpy(gw.live_state)
    for k, v in want.items():
        for name, w_ in (v.items() if isinstance(v, dict) else [(k, v)]):
            g_ = got[k][name] if isinstance(v, dict) else got[k]
            np.testing.assert_allclose(g_, w_, rtol=1e-6, atol=1e-6,
                                       err_msg=f"{k}/{name}")
    assert gw.live_state.A.device.type == "cuda"


def _bitwise(a, b):
    for f in ("arms", "rewards", "costs", "lams"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


@pytest.fixture
def warm_grid(dev):
    """A warm 3-budget x 4-seed grid in blocks of 16 on the card."""
    from repro_torch.core import sweep

    b = simulator.make_benchmark(
        seed=0, splits={"train": 256, "val": 16, "test": 128}, device=dev)
    kw = dict(seeds=(0, 1, 2, 3), priors=evaluate.fit_warmup_priors(
        RouterConfig(), b.train), n_eff=1164.0, batch_size=16)
    budgets = (1.0e-4, 6.6e-4, 1.9e-3)
    n = step_ops.LAUNCHES[0]
    grid = sweep.run_grid(RouterConfig(), b.test, budgets, **kw)
    assert step_ops.LAUNCHES[0] == n + 8     # 128 requests, blocks of 16
    return b.test, budgets, kw, grid


def test_sweep_grid_equals_looped_runs_on_card(warm_grid):
    env, budgets, kw, grid = warm_grid
    for i, budget in enumerate(budgets):
        _bitwise(grid.condition(i), evaluate.run(RouterConfig(), env, budget,
                                                 **kw))


@pytest.mark.parametrize("split", [dict(chunk_size=1),
                                   dict(devices=["cuda:0", "cuda:0"])])
def test_sweep_sub_stacks_equal_whole_on_card(warm_grid, split):
    from repro_torch.core import sweep

    env, budgets, kw, grid = warm_grid
    _bitwise(sweep.run_grid(RouterConfig(), env, budgets, **split, **kw),
             grid)


@pytest.mark.parametrize("n", [1, 7, 20, 1400])
def test_warm_start_bits_do_not_depend_on_the_stack(dev, n):
    """Seed 0's warm start in an n-state stack equals it in a 160-state
    stack (the batched product A^-1 b takes other routes at 1, 2-160 and
    1,400 systems on the H100; ``warmup.ridge_solve`` does not)."""
    b = simulator.make_benchmark(
        seed=0, splits={"train": 256, "val": 16, "test": 16}, device=dev)
    priors = evaluate.fit_warmup_priors(RouterConfig(), b.train)
    kw = dict(priors=priors, n_eff=1164.0)
    small = evaluate.make_states(RouterConfig(), b.test, 6.6e-4,
                                 tuple(range(n)), **kw)
    big = evaluate.make_states(RouterConfig(), b.test, 6.6e-4,
                               tuple(range(160)), **kw)
    for name in ("A", "A_inv", "b", "theta"):
        assert torch.equal(getattr(small, name)[0], getattr(big, name)[0])


@pytest.mark.parametrize("B", [1, 3])
def test_linucb_kernels_above_the_grid_limit(dev, B):
    """A stack of 65,537 states (above the grid's 65,535) at K 8, d 4: the
    wrappers launch in slices, and the step (``single`` at B = 1, ``pdl``
    above) and the scores equal the same stack run as two sub-stacks bit
    for bit."""
    from repro_torch.kernels import checks
    from repro_torch.kernels.linucb_step.kernel import route

    S, K, d = checks.MAX_STATES + 2, 8, 4
    gen = torch.Generator(device=dev).manual_seed(B)
    f = lambda *shape: torch.rand(shape, generator=gen,  # noqa: E731
                                  device=dev)
    M = f(S, K, d, d) * 0.3
    A = M @ M.transpose(-1, -2) + torch.eye(d, device=dev)
    Ainv = torch.linalg.inv(A).contiguous()
    b = f(S, K, d) - 0.5
    vec = lambda v: torch.full((S,), v, device=dev)  # noqa: E731
    args = [A, Ainv, b, (Ainv @ b[..., None])[..., 0],
            torch.randint(0, 50, (S, K), generator=gen, device=dev,
                          dtype=torch.int32),
            f(S, B, d) - 0.5, f(S, B, K), f(S, B, K) * 1e-3,
            f(S, B, K) * 1e-7, torch.ones((S, K), dtype=torch.bool,
                                          device=dev),
            f(S, K) * 0.5, f(S, K) + 0.01, vec(0.05), vec(0.997), vec(0.05),
            vec(0.05), vec(5.0), vec(0.2), vec(5e-4), vec(6.6e-4),
            torch.full((S,), 60, dtype=torch.int32, device=dev),
            torch.full((S,), 1, dtype=torch.int32, device=dev),
            torch.zeros((S, B), dtype=torch.bool, device=dev)]
    n, n_route = step_ops.LAUNCHES[0], step_ops.ROUTE_LAUNCHES[route(B)]
    whole = step_ops.linucb_step(*args)
    assert step_ops.LAUNCHES[0] == n + 2
    assert step_ops.ROUTE_LAUNCHES[route(B)] == n_route + 2
    cut = 40_000
    parts = [step_ops.linucb_step(*(a[sl].contiguous() for a in args))
             for sl in (slice(0, cut), slice(cut, S))]
    for i, w in enumerate(whole):
        assert torch.equal(w, torch.cat([p[i] for p in parts])), i
    sargs = (args[5], args[3], Ainv, args[10], args[11], args[12])
    n = score_ops.LAUNCHES[0]
    scores = score_ops.linucb_score(*sargs)
    assert score_ops.LAUNCHES[0] == n + 2
    assert torch.equal(scores, torch.cat([
        score_ops.linucb_score(*(a[sl].contiguous() for a in sargs))
        for sl in (slice(0, cut), slice(cut, S))]))


ATTN_TOL ={torch.float32: dict(rtol=2e-4, atol=2e-5),
            torch.bfloat16: dict(rtol=5e-2, atol=5e-2)}
# Each output row's max error against that row's RMS (chip_smoke.py's
# ATTN_ROW_REL_TOL): random inputs give long rows an RMS below the
# absolute tolerance, where a dropped tile or split would still pass it.
ATTN_ROW_REL_TOL = {torch.float32: 1e-3, torch.bfloat16: 0.1}


def assert_attn_close(got, want, dtype):
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL[dtype])
    diff = (got.float() - want.float()).abs().amax(-1)
    rel = diff / want.float().pow(2).mean(-1).sqrt()
    assert float(rel.max()) <= ATTN_ROW_REL_TOL[dtype], float(rel.max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,hd,mode,window", [
    (1, 33, 4, 4, 64, "causal", 0), (2, 100, 8, 2, 32, "sliding", 17),
    (1, 64, 8, 1, 128, "full", 0), (2, 130, 6, 3, 48, "causal", 0),
    # the served prefills (olmo-1b, deepseek-67b: G = 8 on KV = 8)
    (1, 32, 16, 16, 128, "causal", 0), (1, 32, 64, 8, 128, "causal", 0),
    # ragged query tiles around the 128-row tile, hd 48 / 64 / 128
    (1, 1, 8, 8, 128, "causal", 0), (1, 127, 16, 16, 64, "causal", 0),
    (1, 128, 8, 2, 48, "causal", 0), (2, 129, 8, 8, 128, "causal", 0),
    (1, 300, 64, 8, 128, "causal", 0),
    # windows that cross tile edges
    (1, 300, 8, 2, 64, "sliding", 1), (1, 300, 8, 2, 128, "sliding", 63),
    (2, 300, 8, 2, 128, "sliding", 130),
    # full mode, T not a multiple of the 64-key tile
    (1, 100, 4, 2, 48, "full", 0), (2, 129, 8, 8, 128, "full", 0),
    # hd % 8 != 0: bf16 takes the FP32 FMA route
    (1, 40, 4, 2, 36, "causal", 0)])
def test_flash_kernel_matches_plain(dev, dtype, B, S, H, KV, hd, mode,
                                    window):
    """Each route against the plain version; bf16 with hd % 8 == 0 must
    take the tensor cores, everything else the FP32 FMA kernel."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.kernel import route
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    g = torch.Generator(device=dev).manual_seed(S + hd)
    q, k, v = (torch.randn(s, generator=g, device=dev, dtype=dtype)
               for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    which = route(dtype, hd)
    assert (which == "tensor_cores") == (dtype == torch.bfloat16
                                         and hd % 8 == 0)
    n, n_route = fa_ops.LAUNCHES[0], fa_ops.ROUTE_LAUNCHES[which]
    got = fa_ops.flash_attention(q, k, v, mode=mode, window=window)
    assert fa_ops.LAUNCHES[0] == n + 1
    assert fa_ops.ROUTE_LAUNCHES[which] == n_route + 1
    want = flash_attention_ref(q, k, v, mode=mode, window=window)
    assert_attn_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,W,H,KV,hd,pos,window", [
    (1, 40, 4, 4, 64, 33, 0), (2, 136, 8, 2, 128, 130, 0),
    (1, 300, 16, 2, 32, 1000, 100),
    # the served tokens: olmo-1b G = 1, deepseek-67b G = 8
    (1, 40, 16, 16, 128, 39, 0), (1, 40, 64, 8, 128, 39, 0),
    # whole splits invalid next to valid ones
    (1, 4096, 64, 8, 128, 5000, 3000),
    (3, 200, 6, 3, 48, 150, 0),
    # bf16 off the tensor cores (hd % 16 != 0): rows that are not 16-byte
    # multiples (hd 36) and rows that are (hd 24)
    (1, 40, 4, 2, 36, 33, 0), (2, 100, 8, 4, 24, 90, 0)])
def test_decode_kernel_matches_plain(dev, dtype, B, W, H, KV, hd, pos,
                                     window):
    """The op (its own split plan) and the kernels at n_split = 1, 2 and
    one split per tile, against the plain version, on both of the split
    kernel's paths (bf16 with hd % 16 == 0 on the tensor cores, K / V
    staged by cp.async; everything else element by element on FP32
    FMAs)."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention.kernel import (
        TILE, decode_attention_bkv, sm_count, split_plan,
    )
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.models.attention import ring_valid

    g = torch.Generator(device=dev).manual_seed(W + hd)
    q, kc, vc = (torch.randn(s, generator=g, device=dev, dtype=dtype)
                 for s in ((B, 1, H, hd), (B, W, KV, hd), (B, W, KV, hd)))
    valid = ring_valid(pos, W, window, dev)
    n = da_ops.LAUNCHES[0]
    got = da_ops.decode_attention(q, kc, vc, valid)
    assert da_ops.LAUNCHES[0] == n + 1
    want = decode_attention_ref(q, kc, vc, valid)
    assert_attn_close(got, want, dtype)
    tiles = -(-W // TILE)
    plans = {split_plan(B, W, KV, sm_count(dev.index or 0)), (1, tiles),
             (tiles, 1), (-(-tiles // -(-tiles // 2)), -(-tiles // 2))}
    G = H // KV
    for n_split, per in sorted(plans):
        ws = (None, None)
        if n_split > 1:
            ws = (torch.empty((B, KV, n_split, G, hd), device=dev),
                  torch.empty((B, KV, n_split, G, 2), device=dev))
        out = torch.empty_like(q)
        decode_attention_bkv(q, kc, vc, valid, out, *ws, n_split=n_split,
                             tiles_per_split=per, scale=1.0 / hd ** 0.5)
        assert_attn_close(out, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,W,H,KV,hd", [(1, 1024, 16, 2, 128),
                                         (2, 300, 8, 4, 24)])
def test_decode_kernel_without_valid_slot(dev, dtype, B, W, H, KV, hd):
    """A row with no valid slot gives the mean of V over the W slots of
    its kv head, as the plain version and JAX's reference do: through
    the op (several splits, so the combine takes it), and at n_split = 1
    (the split kernel's epilogue) and one split per tile."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention.kernel import (
        TILE, decode_attention_bkv, sm_count, split_plan,
    )
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    g = torch.Generator(device=dev).manual_seed(W + hd)
    q, kc, vc = (torch.randn(s, generator=g, device=dev, dtype=dtype)
                 for s in ((B, 1, H, hd), (B, W, KV, hd), (B, W, KV, hd)))
    valid = torch.zeros(W, dtype=torch.bool, device=dev)
    want = decode_attention_ref(q, kc, vc, valid)
    mean = vc.float().mean(1).repeat_interleave(H // KV, dim=1)[:, None]
    torch.testing.assert_close(want.float(), mean, **ATTN_TOL[dtype])
    assert split_plan(B, W, KV, sm_count(dev.index or 0))[0] > 1
    assert_attn_close(da_ops.decode_attention(q, kc, vc, valid), want, dtype)
    tiles = -(-W // TILE)
    G = H // KV
    for n_split, per in ((1, tiles), (tiles, 1)):
        ws = (None, None)
        if n_split > 1:
            ws = (torch.empty((B, KV, n_split, G, hd), device=dev),
                  torch.empty((B, KV, n_split, G, 2), device=dev))
        out = torch.empty_like(q)
        decode_attention_bkv(q, kc, vc, valid, out, *ws, n_split=n_split,
                             tiles_per_split=per, scale=1.0 / hd ** 0.5)
        assert_attn_close(out, want, dtype)


BF16, F32 = torch.bfloat16, torch.float32
E4M3, E5M2 = torch.float8_e4m3fn, torch.float8_e5m2
SSD_TOL = {BF16: 0.08, F32: 2e-4}   # the JAX SSD tests' bars


def _ssd_inputs(dev, B, L, H, P, N, dtype, offset=0):
    """The SSD operands on the model's layout: x, B and C as views of one
    (B, L, offset + H P + 2 N) projection, as mamba2_forward passes them
    (``offset`` leading columns shift the views off 16-byte
    boundaries)."""
    g = torch.Generator(device=dev).manual_seed(L + P + N)
    xBC = torch.randn((B, L, offset + H * P + 2 * N), generator=g,
                      device=dev, dtype=dtype)[..., offset:]
    xs, Bi, Ci = torch.split(xBC, [H * P, N, N], dim=-1)
    dt = torch.rand((B, L, H), generator=g, device=dev) * 0.099 + 0.001
    A = -(torch.rand((H,), generator=g, device=dev) * 3.5 + 0.5)
    D = torch.randn((H,), generator=g, device=dev)
    return xs.reshape(B, L, H, P), dt, A, Bi, Ci, D


def _assert_ssd_close(got, want, dtype):
    y, h = got
    assert y.dtype == dtype and h.dtype == torch.float32
    tol = SSD_TOL[dtype]
    torch.testing.assert_close(y.float(), want[0].float(), rtol=tol,
                               atol=tol)
    torch.testing.assert_close(h, want[1], rtol=tol, atol=tol)


@pytest.mark.parametrize("B,L,H,P,N,chunk,dtype,route", [
    # the served prompts (pad to 32, kept up to 128): one chunk
    (1, 32, 32, 64, 128, 128, BF16, "one_chunk"),
    (1, 64, 32, 64, 128, 128, BF16, "one_chunk"),
    (1, 96, 32, 64, 128, 128, BF16, "one_chunk"),
    (1, 128, 32, 64, 128, 128, BF16, "one_chunk"),
    (1, 1, 8, 64, 128, 128, BF16, "one_chunk"),
    # long prompts: the chunk-parallel route, ragged last chunks
    (1, 2048, 32, 64, 128, 128, BF16, "chunked"),
    (1, 129, 8, 64, 128, 128, BF16, "chunked"),
    (1, 256, 8, 64, 128, 128, BF16, "chunked"),
    (1, 300, 8, 64, 128, 128, BF16, "chunked"),
    (1, 300, 3, 64, 128, 128, BF16, "chunked"),
    # chunks that are not 16-row multiples, and small ones
    (1, 100, 4, 64, 128, 40, BF16, "chunked"),
    (1, 50, 4, 64, 128, 8, BF16, "chunked"),
    # other widths, B = 2
    (2, 100, 4, 24, 64, 32, BF16, "chunked"),
    (2, 40, 4, 24, 16, 16, BF16, "chunked"),
    (2, 20, 4, 32, 16, 128, BF16, "one_chunk"),
    # N % 16 != 0: bf16 on the FP32-FMA route
    (1, 40, 4, 24, 24, 16, BF16, "fma"),
    (1, 24, 4, 32, 24, 128, BF16, "fma"),
    # f32 takes the FP32-FMA route
    (2, 40, 4, 8, 16, 16, F32, "fma"),
    (1, 32, 32, 64, 128, 128, F32, "fma"),
    (1, 300, 4, 64, 128, 128, F32, "fma"),
])
def test_ssd_kernel_matches_plain(dev, B, L, H, P, N, chunk, dtype, route):
    """The op against its plain version on the model's layout, on the
    route its plan picks (asserted through the route counter).
    Tolerance: the JAX SSD tests' 2e-4 (f32) and 0.08 (bf16 inputs), on y
    and on the final state."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    args = _ssd_inputs(dev, B, L, H, P, N, dtype)
    n, n_route = ssd_ops.LAUNCHES[0], ssd_ops.ROUTE_LAUNCHES[route]
    got = ssd_ops.ssd_scan(*args, chunk=chunk)
    assert ssd_ops.LAUNCHES[0] == n + 1
    assert ssd_ops.ROUTE_LAUNCHES[route] == n_route + 1
    _assert_ssd_close(got, ssd_scan_ref(*args, chunk=min(chunk, L)), dtype)


@pytest.mark.parametrize("L,chunk", [(32, 128), (300, 128)])
def test_ssd_kernel_misaligned_view(dev, L, chunk):
    """bf16 views whose data is off 16-byte boundaries cannot be staged by
    16-byte copies: the plan sends them to the FP32-FMA route."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    args = _ssd_inputs(dev, 1, L, 4, 64, 128, BF16, offset=1)
    assert args[0].data_ptr() % 16
    n = ssd_ops.ROUTE_LAUNCHES["fma"]
    got = ssd_ops.ssd_scan(*args, chunk=chunk)
    assert ssd_ops.ROUTE_LAUNCHES["fma"] == n + 1
    _assert_ssd_close(got, ssd_scan_ref(*args, chunk=min(chunk, L)), BF16)


@pytest.mark.parametrize("G,TP", [(1, 8), (2, 64), (3, 32), (4, 16)])
@pytest.mark.parametrize("B,L,H,P,N,chunk", [
    (1, 300, 3, 64, 128, 128), (2, 32, 5, 32, 64, 32),
    (1, 70, 9, 64, 32, 48)])
def test_ssd_kernel_plans_match_plain(dev, G, TP, B, L, H, P, N, chunk):
    """The tensor-core kernels under plans the heuristic may not pick:
    heads per block that do not divide H, P tiles from 8 columns to wider
    than P (the tile's columns past P are masked), several chunks and
    one."""
    from repro_torch.kernels.ssd_scan.kernel import (
        ssd_plan, ssd_scan_bhp, workspace,
    )
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    args = _ssd_inputs(dev, B, L, H, P, N, BF16)
    chunk = min(chunk, L)
    plan = dict(ssd_plan(B, L, H, P, N, chunk, BF16, True),
                heads_per_block=G, p_tile=TP)
    assert plan["tensor_cores"]
    y = torch.empty_like(args[0])
    h = torch.empty((B, H, N, P), device=dev)
    ssd_scan_bhp(*args, y, h, *workspace(plan, B, H, N, P, dev), plan=plan)
    _assert_ssd_close((y, h), ssd_scan_ref(*args, chunk=chunk), BF16)


def test_portfolio_serves_on_card(dev):
    """The JAX driver's trio as a SMOKE portfolio served on the card
    through the kernels: every request generates, both attention kernels
    and the SSD scan launch, and the kernel route's prefill logits agree
    with the plain route's."""
    from repro_torch import configs
    from repro_torch.core.costs import price_from_active_params
    from repro_torch.core.features import fit_pca_whitener, hash_encode_batch
    from repro_torch.data import make_request_stream
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.serving import PortfolioServer, ServedModel

    arms = ("olmo-1b", "mamba2-370m", "deepseek-67b")
    models = [ServedModel.init(
        configs.get_smoke(a),
        price_from_active_params(a, configs.get_config(a).active_params(),
                                 mean_req_tokens=600),
        tier, seed=i, device=dev)
        for i, (a, tier) in enumerate(zip(arms, ("budget", "mid",
                                                 "frontier")))]
    corpus = [r["prompt"] for r in make_request_stream(200, seed=7)]
    srv = PortfolioServer(models, fit_pca_whitener(hash_encode_batch(corpus),
                                                   device=dev),
                          budget=6.6e-4, max_new_tokens=4, device=dev)
    fa0, da0, ssd0 = (fa_ops.LAUNCHES[0], da_ops.LAUNCHES[0],
                      ssd_ops.LAUNCHES[0])
    res = srv.serve_batch(make_request_stream(8, seed=11))
    assert len(res) == 8 and all(r.tokens_out == 4 for r in res)
    assert fa_ops.LAUNCHES[0] > fa0 and da_ops.LAUNCHES[0] > da0
    assert ssd_ops.LAUNCHES[0] > ssd0
    from repro_torch.models import prefill_forward

    toks = torch.arange(2, 34, device=dev)[None]
    for m in models:
        got, _ = prefill_forward(m.params, m.cfg, toks, impl="cuda")
        want, _ = prefill_forward(m.params, m.cfg, toks, impl="chunked")
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the rest of the model zoo: its kernel shapes, MoE, a model of each family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,T,H,KV,hd,mode", [
    (1, 32, 32, 32, 32, 80, "causal"),     # zamba2's shared block
    (1, 608, 608, 32, 32, 96, "causal"),   # phi-3-vision: 576 patches + 32
    (1, 1500, 1500, 16, 16, 64, "full"),   # whisper's encoder: ragged tile
    (1, 32, 1500, 16, 16, 64, "full"),     # whisper's cross-attention
    (2, 40, 100, 8, 2, 48, "full")])       # cross-attention with GQA
def test_flash_kernel_zoo_shapes(dev, dtype, B, S, T, H, KV, hd, mode):
    """The zoo's prefill shapes, S != T among them, on the route
    ``kernel.route`` names, against the plain version."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.kernel import route
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    g = torch.Generator(device=dev).manual_seed(S + T + hd)
    q, k, v = (torch.randn(s, generator=g, device=dev, dtype=dtype)
               for s in ((B, S, H, hd), (B, T, KV, hd), (B, T, KV, hd)))
    which = route(dtype, hd)
    n = fa_ops.ROUTE_LAUNCHES[which]
    got = fa_ops.flash_attention(q, k, v, mode=mode)
    assert fa_ops.ROUTE_LAUNCHES[which] == n + 1
    assert_attn_close(got, flash_attention_ref(q, k, v, mode=mode), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,W,H,KV,hd,pos", [
    (1, 40, 32, 32, 80, 39), (1, 616, 32, 32, 96, 615),
    (1, 40, 16, 16, 64, 39),
    (1, 40, 48, 8, 128, 39), (1, 40, 40, 8, 128, 39)])   # G = 6, G = 5
def test_decode_kernel_zoo_shapes(dev, dtype, B, W, H, KV, hd, pos):
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.models.attention import ring_valid

    g = torch.Generator(device=dev).manual_seed(W + H + hd)
    q, kc, vc = (torch.randn(s, generator=g, device=dev, dtype=dtype)
                 for s in ((B, 1, H, hd), (B, W, KV, hd), (B, W, KV, hd)))
    valid = ring_valid(pos, W, 0, dev)
    assert_attn_close(da_ops.decode_attention(q, kc, vc, valid),
                      decode_attention_ref(q, kc, vc, valid), dtype)


def test_ssd_kernel_zamba2_shape(dev):
    """zamba2-2.7b's served scan: H 80, P 64, N 64, one 32-row chunk, x /
    B / C views of its 5,248-wide projection: the one-chunk tensor-core
    route."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    args = _ssd_inputs(dev, 1, 32, 80, 64, 64, BF16)
    n = ssd_ops.ROUTE_LAUNCHES["one_chunk"]
    got = ssd_ops.ssd_scan(*args, chunk=128)
    assert ssd_ops.ROUTE_LAUNCHES["one_chunk"] == n + 1
    _assert_ssd_close(got, ssd_scan_ref(*args, chunk=32), BF16)


@pytest.mark.parametrize("cf,G", [(8.0, 1), (0.1, 1), (0.1, 4)])
def test_apply_moe_on_card_matches_cpu(dev, cf, G):
    """The MoE layer on the card (f32, TF32 off) against the CPU's: the
    same experts, kept and dropped copies, so outputs within 1e-4."""
    from repro_torch.models import moe
    from repro_torch.models.config import ModelConfig

    cfg = ModelConfig(name="tiny-moe", arch_type="moe", num_layers=2,
                      d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                      vocab_size=64, num_experts=8, experts_per_token=2,
                      capacity_factor=cf, moe_dispatch_groups=G,
                      dtype="float32")
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg, device="cpu")
    x = torch.randn((2, 48, 64), generator=torch.Generator().manual_seed(1))
    want, want_aux = moe.apply_moe(p, cfg, x)
    got, aux = moe.apply_moe({k: v.to(dev) for k, v in p.items()}, cfg,
                             x.to(dev))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(aux.cpu(), want_aux, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "dbrx-132b",
                                  "llama4-maverick-400b-a17b",
                                  "phi-3-vision-4.2b", "whisper-medium"])
def test_zoo_model_on_card_matches_cpu(dev, arch):
    """Each new family's SMOKE model (f32) on the card through the kernels
    against the same weights on the CPU's plain route: prefill logits
    (with the VLM's image, the whisper encoder's frames) and 3 decode
    steps, within 1e-4."""
    from repro_torch import configs
    from repro_torch.models import decode_step, init_model, prefill_forward

    cfg = configs.get_smoke(arch)
    p = init_model(cfg, seed=0, device="cpu")
    pc = torch.utils._pytree.tree_map(lambda t: t.to(dev), p)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(2, cfg.vocab_size, (1, 32), generator=g)
    extra = {}
    if cfg.frontend_tokens:
        extra["frontend"] = torch.randn(
            (1, cfg.frontend_tokens, cfg.frontend_dim), generator=g)
    if cfg.is_encdec:
        extra["encoder_frames"] = torch.randn(
            (1, cfg.encoder_seq, cfg.frontend_dim), generator=g)
    runs = []
    for d, params in (("cpu", p), (dev, pc)):
        logits, c = prefill_forward(params, cfg, toks.to(d), cache_len=64,
                                    **{k: v.to(d) for k, v in extra.items()})
        out = [logits.cpu()]
        for t in (5, 9, 11):
            logits, c = decode_step(params, cfg,
                                    torch.full((1, 1), t, device=d), c)
            out.append(logits.cpu())
        runs.append(torch.stack(out))
    torch.testing.assert_close(runs[1], runs[0], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-370m"])
def test_train_step_on_card_matches_cpu(dev, arch):
    """A SMOKE train step (f32, TF32 off) on the card against the same
    weights and batch on the CPU: forward_train's loss within 1e-4
    relative and each gradient leaf within 1e-3 of its max |g|, then one
    make_train_step step's loss and grad norm within 1e-4 relative. The
    training route launches none of the kernels."""
    from repro_torch import configs, tree
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import forward_train, init_model
    from repro_torch.training import make_train_step, train_state_init

    cfg = configs.get_smoke(arch)
    p = init_model(cfg, seed=0, device="cpu")
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 33), generator=g)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    before = (flash_ops.LAUNCHES[0], ssd_ops.LAUNCHES[0])
    runs = []
    for d in ("cpu", dev):
        pd = tree.map_tree(lambda t: t.to(d).requires_grad_(), p)
        bd = {k: v.to(d) for k, v in batch.items()}
        loss, _ = forward_train(pd, cfg, bd)
        grads = torch.autograd.grad(loss, list(tree.leaves(pd)),
                                    materialize_grads=True)
        _, m = make_train_step(cfg, total_steps=10)(
            train_state_init(tree.map_tree(lambda t: t.to(d), p)), bd)
        runs.append((loss.detach().cpu(), [x.cpu() for x in grads],
                     {k: v.cpu() for k, v in m.items()}))
    (l0, g0, m0), (l1, g1, m1) = runs
    torch.testing.assert_close(l1, l0, rtol=1e-4, atol=0)
    for a, w in zip(g1, g0):
        assert float((a - w).abs().max()) <= 1e-3 * float(w.abs().max())
    for k in ("loss", "grad_norm"):
        torch.testing.assert_close(m1[k], m0[k], rtol=1e-4, atol=0)
    assert (flash_ops.LAUNCHES[0], ssd_ops.LAUNCHES[0]) == before


def test_train_refuses_kernel_route_on_card(dev):
    """impl="cuda" under autograd raises before any kernel launches."""
    from repro_torch import configs, tree
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models import forward_train, init_model

    cfg = configs.get_smoke("olmo-1b")
    p = tree.map_tree(lambda t: t.requires_grad_(),
                      init_model(cfg, seed=0, device=dev))
    toks = torch.zeros((1, 32), dtype=torch.int32, device=dev)
    n = flash_ops.LAUNCHES[0]
    with pytest.raises(NotImplementedError, match="no backward"):
        forward_train(p, cfg, {"tokens": toks, "labels": toks}, impl="cuda")
    assert flash_ops.LAUNCHES[0] == n


# The fp8 cases of chip_smoke.py phase 15 (a): (B, W, H, KV, hd, q dtype,
# cache dtype, pos, window); pos None is a row with no valid slot.
FP8_DECODE_CASES = [
    (1, 40, 16, 16, 128, BF16, E4M3, 39, 0),        # olmo-1b's token
    (1, 4096, 64, 8, 128, BF16, E4M3, 5000, 3000),  # 32 splits
    (1, 40, 32, 32, 80, BF16, E4M3, 39, 0),         # zamba2-2.7b's hd
    (1, 616, 32, 32, 96, BF16, E4M3, 615, 0),       # phi-3-vision's hd
    (2, 40, 8, 2, 32, torch.float32, E4M3, 35, 0),  # f32 q: the FMA path
    (2, 136, 8, 2, 128, BF16, E5M2, 130, 0),
    (1, 40, 4, 2, 36, BF16, E4M3, 33, 0),           # bf16 off the mma path
    (1, 1024, 16, 2, 128, BF16, E4M3, None, 0),     # no valid slot
]


@pytest.mark.parametrize("B,W,H,KV,hd,dtype,kv_dtype,pos,window",
                         FP8_DECODE_CASES)
def test_decode_kernel_reads_fp8_cache(dev, B, W, H, KV, hd, dtype, kv_dtype,
                                       pos, window):
    """The kernels on an fp8 cache: bit for bit what they give on the cache
    cast to q's dtype (the widening is exact), through the op and at one
    split and one split per tile, and within the attention bar of the
    plain version; the launch reaches the kernel with the fp8 cache."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention.kernel import (
        TILE, decode_attention_bkv,
    )
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.models.attention import ring_valid
    from repro_torch.models.layers import astype

    g = torch.Generator(device=dev).manual_seed(W + hd)
    q = torch.randn((B, 1, H, hd), generator=g, device=dev, dtype=dtype)
    kc, vc = (astype(torch.randn((B, W, KV, hd), generator=g, device=dev)
                     * 2, kv_dtype) for _ in range(2))
    valid = (torch.zeros(W, dtype=torch.bool, device=dev) if pos is None
             else ring_valid(pos, W, window, dev))
    n = da_ops.LAUNCHES[0]
    got = da_ops.decode_attention(q, kc, vc, valid)
    up = da_ops.decode_attention(q, kc.to(dtype), vc.to(dtype), valid)
    assert da_ops.LAUNCHES[0] == n + 2
    assert torch.equal(got, up)
    assert_attn_close(got, decode_attention_ref(q, kc, vc, valid), dtype)
    tiles = -(-W // TILE)
    G = H // KV
    for n_split, per in ((1, tiles), (tiles, 1)):
        ws = (None, None)
        if n_split > 1:
            ws = (torch.empty((B, KV, n_split, G, hd), device=dev),
                  torch.empty((B, KV, n_split, G, 2), device=dev))
        outs = []
        for k, v in ((kc, vc), (kc.to(dtype), vc.to(dtype))):
            out = torch.empty_like(q)
            decode_attention_bkv(q, k, v, valid, out, *ws, n_split=n_split,
                                 tiles_per_split=per, scale=1.0 / hd ** 0.5)
            outs.append(out)
        assert torch.equal(outs[0], outs[1])


def test_decode_kernel_refuses_mixed_cache(dev):
    from repro_torch.kernels.decode_attention import ops as da_ops

    q = torch.zeros((1, 1, 4, 64), device=dev, dtype=BF16)
    kc = torch.zeros((1, 8, 4, 64), device=dev)
    with pytest.raises(TypeError, match="cache"):
        da_ops.decode_attention(q, kc, kc, torch.ones(8, dtype=torch.bool,
                                                      device=dev))


@pytest.mark.parametrize("arch,kv_dtype", [("olmo-1b", "float8_e4m3fn"),
                                           ("dbrx-132b", "float8_e5m2")])
def test_fp8_decode_on_card_matches_cpu(dev, arch, kv_dtype):
    """An fp8-cache SMOKE model (f32) on the card through the kernels
    against the CPU's plain route: token-by-token prefill and 3 decode
    steps, logits within 1e-4 and the fp8 caches within one fp8 step."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import decode_step, init_model, prefill

    cfg = dataclasses.replace(configs.get_smoke(arch), kv_dtype=kv_dtype)
    p = init_model(cfg, seed=0, device="cpu")
    pc = torch.utils._pytree.tree_map(lambda t: t.to(dev), p)
    toks = torch.randint(2, cfg.vocab_size, (1, 12),
                         generator=torch.Generator().manual_seed(1))
    runs = []
    for d, params in (("cpu", p), (dev, pc)):
        logits, c = prefill(params, cfg, toks.to(d), cache_len=16)
        assert c.k.dtype == getattr(torch, kv_dtype)
        out = [logits.cpu()]
        for t in (5, 9, 11):
            logits, c = decode_step(params, cfg,
                                    torch.full((1, 1), t, device=d), c)
            out.append(logits.cpu())
        runs.append((torch.stack(out), c.k.cpu().view(torch.uint8)))
    torch.testing.assert_close(runs[1][0], runs[0][0], rtol=1e-4, atol=1e-4)
    assert int((runs[1][1].int() - runs[0][1].int()).abs().max()) <= 1

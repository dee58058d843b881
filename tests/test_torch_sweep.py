"""The port's grid-sweep fabric (``repro_torch.core.sweep``) and
``montecarlo.run_monte_carlo`` on the CPU: against the JAX package's
(backend ``jnp``) on one small benchmark, arms identical, rewards and
costs identical (read from the same matrices), lams within ``EQUIV_TOL``
= 1e-4 and Monte Carlo metrics within 1e-6; inside the port bit for bit:
grid against looped runs, chunked against whole, split over devices
against one device, condition edits against stacked leaves, timeline
grids against retimed specs; and the grid guards. The JAX grids are
built once per module."""
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import evaluate as jev  # noqa: E402
from repro.core import montecarlo as jmc  # noqa: E402
from repro.core import scenario as jsc  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro.core import sweep as jsweep  # noqa: E402
from repro.core.types import RouterConfig as JConfig  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import evaluate, montecarlo, scenario, sweep  # noqa: E402
from repro_torch.core import tenancy  # noqa: E402
from repro_torch.core import types as types_lib  # noqa: E402
from repro_torch.core.backend import EQUIV_TOL  # noqa: E402
from repro_torch.core.types import HyperParams, RouterConfig  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402

SPLITS = {"train": 64, "val": 16, "test": 96}
SEEDS, N_EFF = (0, 1), 1164.0
BUDGETS = (1.0e-4, 6.6e-4, 1.9e-3)
MULTS = (0.1, 0.5, 2.0)
CFG, JCFG = RouterConfig(max_arms=4), JConfig(max_arms=4)
GEMINI, MISTRAL = 2, 1
MC_TOL = 1e-6
# As many timelines as budgets: the JAX Monte Carlo grid has the timeline
# grid's shapes and reuses its compiled program.
MC_N = len(BUDGETS)


def _param_spec(m, mult):
    """A recalibrated price change whose multiplier is ``mult`` (a number
    or a ``Param``) and a quality regression, in module ``m``."""
    return m.ScenarioSpec(horizon=96, events=(
        m.PriceChange(32, GEMINI, mult, recalibrate=True),
        m.QualityShift(64, MISTRAL, 0.7)), stream_seed_base=42)


def _timeline_spec(m):
    return m.ScenarioSpec(horizon=96, events=(
        m.PriceChange(32, GEMINI, 1 / 56), m.QualityShift(48, MISTRAL, 0.7),
        m.BudgetChange(64, 3.0e-4)), stream_seed_base=43)


TIMELINES = ((8, 40, 56, None), (16, 64, 24, 80), (48, 32, 40, 72))


def _timelines(m):
    return tuple(m.Timeline(t[:3], horizon=t[3]) for t in TIMELINES)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The grids here are a few states wide: intra-op threads only
    contend with the other test workers. Restored after the module."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def bench():
    b = jsim.make_benchmark(seed=0, splits=SPLITS)
    jpriors = jev.fit_warmup_priors(JCFG, b.train)
    return dict(jenv=b.test, jpriors=jpriors,
                env=interop.env_from_numpy(b.test),
                priors=[interop.prior_from_numpy(p, "cpu") for p in jpriors])


def _jax_grids(b):
    out = {}
    for bs in (None, 16):
        out["grid", bs] = jsweep.run_grid(
            JCFG, b["jenv"], BUDGETS, seeds=SEEDS, priors=b["jpriors"],
            n_eff=N_EFF, batch_size=bs)
    out["scenario"] = jsweep.run_scenario_grid(
        JCFG, _param_spec(jsc, jsc.Param("mult")), b["jenv"], BUDGETS,
        seeds=SEEDS, priors=b["jpriors"], n_eff=N_EFF,
        scenario_params=jsc.ScenarioParams(
            mult=np.asarray(MULTS, np.float32)))
    out["timeline"] = jsweep.run_scenario_grid(
        JCFG, _timeline_spec(jsc), b["jenv"], BUDGETS, seeds=SEEDS,
        timelines=_timelines(jsc))
    tls = jmc.sample_timelines(_timeline_spec(jsc), MC_N, seed=5,
                               horizons=(72, 96))
    out["mc"] = jmc.run_monte_carlo(JCFG, _timeline_spec(jsc), b["jenv"],
                                    6.6e-4, tls, seeds=SEEDS)
    return out


def _port_grids(b):
    out = {}
    for bs in (None, 16):
        out["grid", bs] = sweep.run_grid(
            CFG, b["env"], BUDGETS, seeds=SEEDS, priors=b["priors"],
            n_eff=N_EFF, batch_size=bs, device="cpu")
    out["scenario"] = sweep.run_scenario_grid(
        CFG, _param_spec(scenario, scenario.Param("mult")), b["env"],
        BUDGETS, seeds=SEEDS, priors=b["priors"], n_eff=N_EFF,
        scenario_params=scenario.ScenarioParams(
            mult=np.asarray(MULTS, np.float32)), device="cpu")
    out["timeline"] = sweep.run_scenario_grid(
        CFG, _timeline_spec(scenario), b["env"], BUDGETS, seeds=SEEDS,
        timelines=_timelines(scenario), device="cpu")
    tls = montecarlo.sample_timelines(_timeline_spec(scenario), MC_N,
                                      seed=5, horizons=(72, 96))
    out["mc"] = montecarlo.run_monte_carlo(
        CFG, _timeline_spec(scenario), b["env"], 6.6e-4, tls, seeds=SEEDS,
        device="cpu")
    return out


@pytest.fixture(scope="module")
def grids(bench):
    """Every grid of the JAX comparisons, built once in each package."""
    return _jax_grids(bench), _port_grids(bench)


def _bitwise(a, b):
    for f in ("arms", "rewards", "costs", "lams"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def _matches_jax(got, want):
    """Arms identical, rewards and costs identical, lams within
    EQUIV_TOL."""
    assert got.arms.shape == want.arms.shape
    np.testing.assert_array_equal(got.arms, np.asarray(want.arms))
    np.testing.assert_array_equal(got.rewards, np.asarray(want.rewards))
    np.testing.assert_array_equal(got.costs, np.asarray(want.costs))
    np.testing.assert_allclose(got.lams, np.asarray(want.lams), rtol=0,
                               atol=EQUIV_TOL)


# --- against the JAX package -------------------------------------------------

@pytest.mark.parametrize("name", ["grid-request", "grid-blocks16",
                                  "scenario", "timeline"])
def test_grid_matches_jax(grids, name):
    key = {"grid-request": ("grid", None),
           "grid-blocks16": ("grid", 16)}.get(name, name)
    want, got = grids[0][key], grids[1][key]
    _matches_jax(got, want)
    assert got.budgets == tuple(want.budgets) and got.seeds == want.seeds
    assert got.bounds == want.bounds
    assert got.cond_bounds == want.cond_bounds
    assert got.horizons == want.horizons
    assert (got.params is None) == (want.params is None)
    if got.params is not None:
        np.testing.assert_array_equal(got.params["mult"],
                                      np.asarray(want.params["mult"]))
    for i in range(len(got)):
        assert got.condition(i).bounds == want.condition(i).bounds
        assert got.condition(i).arms.shape == want.condition(i).arms.shape


def test_monte_carlo_matches_jax(grids):
    want, got = grids[0]["mc"], grids[1]["mc"]
    assert got.timelines == tuple(scenario.Timeline(t.event_ts, t.horizon)
                                  for t in want.timelines)
    _matches_jax(got.grid, want.grid)
    for f in ("lags", "lifts", "compliance"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=0, atol=MC_TOL, err_msg=f)
    gb, wb = got.bands((5, 50, 95)), want.bands((5, 50, 95))
    assert gb["n_timelines"] == wb["n_timelines"] == MC_N
    for k in ("adaptation_lag", "quality_lift", "budget_compliance"):
        for q in ("p5", "p50", "p95"):
            np.testing.assert_allclose(gb[k][q], wb[k][q], rtol=0,
                                       atol=MC_TOL)


# --- inside the port, bit for bit --------------------------------------------

@pytest.mark.parametrize("batch_size", [None, 16])
def test_grid_equals_looped_runs(bench, grids, batch_size):
    grid = grids[1]["grid", batch_size]
    for i, b in enumerate(BUDGETS):
        _bitwise(grid.condition(i), evaluate.run(
            CFG, bench["env"], b, seeds=SEEDS, priors=bench["priors"],
            n_eff=N_EFF, batch_size=batch_size, device="cpu"))


@pytest.mark.parametrize("batch_size", [None, 16])
def test_scenario_grid_equals_looped_runs(bench, grids, batch_size):
    """The (C,) Param multiplier grid against run_scenario on each
    condition's concrete spec."""
    grid = grids[1]["scenario"]
    if batch_size is not None:
        grid = sweep.run_scenario_grid(
            CFG, _param_spec(scenario, scenario.Param("mult")), bench["env"],
            BUDGETS, seeds=SEEDS, priors=bench["priors"], n_eff=N_EFF,
            batch_size=batch_size, scenario_params=scenario.ScenarioParams(
                mult=np.asarray(MULTS, np.float32)), device="cpu")
    assert grid.bounds == (0, 32, 64, 96)
    for i, (b, m) in enumerate(zip(BUDGETS, MULTS)):
        res = evaluate.run_scenario(
            CFG, _param_spec(scenario, float(np.float32(m))), bench["env"],
            b, seeds=SEEDS, priors=bench["priors"], n_eff=N_EFF,
            batch_size=batch_size, device="cpu")
        _bitwise(grid.condition(i), res)
        assert grid.condition(i).bounds == res.bounds


def test_timeline_grid_conditions_equal_retimed_specs(bench, grids):
    grid = grids[1]["timeline"]
    spec = _timeline_spec(scenario)
    for i, (b, tl) in enumerate(zip(BUDGETS, _timelines(scenario))):
        res = evaluate.run_scenario(CFG, scenario.retime(spec, tl),
                                    bench["env"], b, seeds=SEEDS,
                                    device="cpu")
        _bitwise(grid.condition(i), res)
        assert grid.condition(i).bounds == res.bounds


def test_per_element_timelines_equal_retimed_specs(bench):
    """(C*S,) timelines: element c*S + s follows its own timeline."""
    spec = _timeline_spec(scenario)
    tls = montecarlo.sample_timelines(spec, 4, seed=9, align=16,
                                      horizons=(64, 96))
    grid = sweep.run_scenario_grid(CFG, spec, bench["env"], BUDGETS[:2],
                                   seeds=SEEDS, timelines=tls, batch_size=16,
                                   device="cpu")
    assert grid.horizons is None and grid.bounds is None
    for e, tl in enumerate(tls):
        c, s = divmod(e, len(SEEDS))
        res = evaluate.run_scenario(CFG, scenario.retime(spec, tl),
                                    bench["env"], BUDGETS[c],
                                    seeds=(SEEDS[s],), batch_size=16,
                                    device="cpu")
        h = tl.horizon
        for f in ("arms", "rewards", "costs", "lams"):
            np.testing.assert_array_equal(getattr(grid, f)[c, s, :h],
                                          getattr(res, f)[0])


def test_monte_carlo_grid_equals_retimed_specs(bench, grids):
    mc = grids[1]["mc"]
    spec = _timeline_spec(scenario)
    for i in (0, MC_N - 1):
        res = evaluate.run_scenario(
            CFG, scenario.retime(spec, mc.timelines[i]), bench["env"], 6.6e-4,
            seeds=SEEDS, device="cpu")
        _bitwise(mc.grid.condition(i), res)


@pytest.mark.parametrize("chunk_size", [1, 3, 6])
def test_chunked_equals_whole(bench, grids, chunk_size):
    got = sweep.run_grid(
        CFG, bench["env"], BUDGETS, seeds=SEEDS, priors=bench["priors"],
        n_eff=N_EFF, batch_size=16, chunk_size=chunk_size, device="cpu")
    _bitwise(got, grids[1]["grid", 16])


@pytest.mark.parametrize("how", ["chunk_size", "devices"])
def test_sub_stacks_keep_final_states(bench, how):
    """The final stack of a grid run in sub-stacks of three states equals
    the whole stack's, every leaf. (Sub-stacks of one state are left out:
    on the CPU the step's plain version multiplies a lone state's A^-1 x
    through another BLAS route than a stack's, which can move the last
    bit of its statistics; the card's kernel gives every (arm, state)
    its own block.)"""
    kw = dict(seeds=SEEDS, priors=bench["priors"], n_eff=N_EFF,
              batch_size=16, return_states=True, device="cpu")
    split = (dict(chunk_size=3) if how == "chunk_size"
             else dict(devices=["cpu", "cpu"]))
    _, got = sweep.run_grid(CFG, bench["env"], BUDGETS, **split, **kw)
    _, whole = sweep.run_grid(CFG, bench["env"], BUDGETS, **kw)
    for a, b in zip(_leaves(got), _leaves(whole)):
        assert torch.equal(a, b)


def test_chunked_scenario_grids_equal_whole(bench, grids):
    got = sweep.run_scenario_grid(
        CFG, _param_spec(scenario, scenario.Param("mult")), bench["env"],
        BUDGETS, seeds=SEEDS, priors=bench["priors"], n_eff=N_EFF,
        scenario_params=scenario.ScenarioParams(
            mult=np.asarray(MULTS, np.float32)), chunk_size=2, device="cpu")
    _bitwise(got, grids[1]["scenario"])
    got = sweep.run_scenario_grid(
        CFG, _timeline_spec(scenario), bench["env"], BUDGETS, seeds=SEEDS,
        timelines=_timelines(scenario), chunk_size=3, device="cpu")
    _bitwise(got, grids[1]["timeline"])
    assert got.horizons == grids[1]["timeline"].horizons


@pytest.mark.parametrize("n_devices,parts", [(2, 2), (4, 3)])
def test_split_equals_one_device(bench, grids, n_devices, parts):
    """The grid mesh takes the largest device count dividing C*S = 6."""
    assert len(mesh.make_grid_mesh(6, ["cpu"] * n_devices)) == parts
    got = sweep.run_grid(CFG, bench["env"], BUDGETS, seeds=SEEDS,
                         priors=bench["priors"], n_eff=N_EFF, batch_size=16,
                         devices=["cpu"] * n_devices)
    _bitwise(got, grids[1]["grid", 16])


def test_split_under_thread_pressure(bench, grids):
    """Six parts of one state each from six threads, with the interpreter
    switching threads as often as it can: the bits of one device."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        got = sweep.run_grid(CFG, bench["env"], BUDGETS, seeds=SEEDS,
                             priors=bench["priors"], n_eff=N_EFF,
                             batch_size=16, devices=["cpu"] * 6)
    finally:
        sys.setswitchinterval(old)
    _bitwise(got, grids[1]["grid", 16])


def test_split_scenario_grid_equals_one_device(bench, grids):
    got = sweep.run_scenario_grid(
        CFG, _timeline_spec(scenario), bench["env"], BUDGETS, seeds=SEEDS,
        timelines=_timelines(scenario), devices=["cpu"] * 3)
    _bitwise(got, grids[1]["timeline"])
    assert got.horizons == grids[1]["timeline"].horizons


@pytest.mark.parametrize("streams", ["per_seed_envs", "shared"])
def test_list_and_shared_streams_equal_looped(bench, streams):
    """Per-seed environments (tiled C times) and one stream shared by
    every seed (expanded, not copied) against looped runs."""
    env = bench["env"]
    envs = ([env.subset(np.random.default_rng(s).permutation(env.n)[:64])
             for s in SEEDS] if streams == "per_seed_envs" else env)
    grid = sweep.run_grid(CFG, envs, BUDGETS[:2], seeds=SEEDS, shuffle=False,
                          batch_size=16, device="cpu")
    for i, b in enumerate(BUDGETS[:2]):
        _bitwise(grid.condition(i), evaluate.run(
            CFG, envs, b, seeds=SEEDS, shuffle=False, batch_size=16,
            device="cpu"))


def _edit_pair(bench, kind):
    """(edited grid, the same grid from stacked leaves)."""
    env, pri = bench["env"], bench["priors"]
    kw = dict(seeds=SEEDS, batch_size=16, device="cpu")
    alphas, n_effs = (0.005, 0.05, 0.2), (300.0, 1164.0, 4000.0)
    if kind == "hyper":
        return (sweep.run_grid(CFG, env, BUDGETS, condition_edits=[
                    sweep.hyper_edit(alpha=a, gamma=0.99) for a in alphas],
                    **kw),
                sweep.run_grid(CFG, env, BUDGETS, hyper=HyperParams(
                    alpha=np.asarray(alphas, np.float32), gamma=0.99), **kw))
    if kind == "warmup":
        return (sweep.run_grid(CFG, env, BUDGETS, condition_edits=[
                    sweep.warmup_edit(CFG, pri, n) for n in n_effs], **kw),
                sweep.run_grid(CFG, env, BUDGETS, priors=pri,
                               n_eff=np.asarray(n_effs), **kw))
    spec = _param_spec(scenario, scenario.Param("mult"))
    stacked = scenario.ScenarioParams(mult=np.asarray(MULTS, np.float32))
    if kind == "param":
        edits = [sweep.param_edit(mult=m) for m in MULTS]
        hyper = None
    else:
        edits = [sweep.chain_edits(sweep.hyper_edit(alpha=a), None,
                                   sweep.param_edit(mult=m))
                 for a, m in zip(alphas, MULTS)]
        hyper = HyperParams(alpha=np.asarray(alphas, np.float32))
    return (sweep.run_scenario_grid(CFG, spec, env, BUDGETS,
                                    condition_edits=edits, **kw),
            sweep.run_scenario_grid(CFG, spec, env, BUDGETS, hyper=hyper,
                                    scenario_params=stacked, **kw))


@pytest.mark.parametrize("kind", ["hyper", "warmup", "param", "chain"])
def test_condition_edits_equal_stacked_leaves(bench, kind):
    edited, stacked = _edit_pair(bench, kind)
    _bitwise(edited, stacked)


def test_partial_param_edit_falls_back_to_base(bench):
    spec = _param_spec(scenario, scenario.Param("mult"))
    grid = sweep.run_scenario_grid(
        CFG, spec, bench["env"], (6.6e-4, 6.6e-4), seeds=SEEDS,
        scenario_params=scenario.ScenarioParams(mult=0.3), batch_size=16,
        condition_edits=[sweep.param_edit(mult=2.0), None], device="cpu")
    for i, m in enumerate((2.0, 0.3)):
        _bitwise(grid.condition(i), evaluate.run_scenario(
            CFG, _param_spec(scenario, m), bench["env"], 6.6e-4, seeds=SEEDS,
            batch_size=16, device="cpu"))


@pytest.mark.parametrize("n_small", [1, 7])
def test_one_seed_bits_do_not_depend_on_the_stack(bench, n_small):
    """Seed 3 warm-started inside a 1-state (or 7-state) stack and inside
    an 8-state stack: the same A, A^-1, b and theta bit for bit
    (``warmup.ridge_solve``), and the same trace."""
    seeds_a = (3,) if n_small == 1 else tuple(range(n_small))
    seeds_b, ia = tuple(range(8)), seeds_a.index(3)
    kw = dict(priors=bench["priors"], n_eff=N_EFF, device="cpu")
    sa = evaluate.make_states(CFG, bench["env"], 6.6e-4, seeds_a, **kw)
    sb = evaluate.make_states(CFG, bench["env"], 6.6e-4, seeds_b, **kw)
    for n in ("A", "A_inv", "b", "theta"):
        assert torch.equal(getattr(sa, n)[ia], getattr(sb, n)[3]), n
    ra = evaluate.run(CFG, bench["env"], 6.6e-4, seeds=seeds_a,
                      batch_size=16, **kw)
    rb = evaluate.run(CFG, bench["env"], 6.6e-4, seeds=seeds_b,
                      batch_size=16, **kw)
    for f in ("arms", "rewards", "costs", "lams"):
        np.testing.assert_array_equal(getattr(ra, f)[ia], getattr(rb, f)[3])


@pytest.mark.parametrize("n", [1, 5, 64])
def test_stacked_prior_theta_off_does_not_depend_on_the_stack(n):
    """A per-state prior stack's theta_off is solved one system at a time
    (``warmup.ridge_solve``): state 0's bits in an n-state stack equal
    its bits alone, and every state is its own (d, d) solve within 1e-5."""
    rng = np.random.default_rng(n)
    d = 26
    M = rng.standard_normal((n, 40, d))
    A = torch.as_tensor(np.einsum("sni,snj->sij", M, M) + 0.5 * np.eye(d),
                        dtype=torch.float32)
    b = torch.as_tensor(rng.standard_normal((n, d)), dtype=torch.float32)
    theta = types_lib.ArmPrior(A_off=A, b_off=b).theta_off
    assert theta.shape == (n, d)
    alone = types_lib.ArmPrior(A_off=A[:1], b_off=b[:1]).theta_off
    assert torch.equal(theta[0], alone[0])
    for i in range(n):
        one = types_lib.ArmPrior(A_off=A[i], b_off=b[i]).theta_off
        torch.testing.assert_close(theta[i], one, rtol=1e-5, atol=1e-5)


def test_state_slice_and_concat(bench):
    st = evaluate.make_states(CFG, bench["env"], BUDGETS, (0, 1, 2),
                              priors=bench["priors"], n_eff=N_EFF,
                              hyper=HyperParams(alpha=np.float32([1, 2, 3])),
                              device="cpu")
    parts = [types_lib.state_slice(st, 0, 1), types_lib.state_slice(st, 1, 3)]
    assert parts[1].num_states == 2
    np.testing.assert_array_equal(parts[1].hyper.alpha.numpy(), [2, 3])
    np.testing.assert_array_equal(parts[1].pacer.budget.numpy(),
                                  np.float32(BUDGETS[1:]))
    joined = types_lib.state_concat(parts)
    for a, b in zip(_leaves(joined), _leaves(st), strict=True):
        assert torch.equal(a, b)


def _leaves(st):
    """Every tensor leaf of a state, in field order."""
    out = []
    types_lib.map_leaves(out.append, st)
    return out


# --- guards -------------------------------------------------------------------

def _guard_calls(env):
    spec = _param_spec(scenario, scenario.Param("mult"))
    plain = scenario.ScenarioSpec(horizon=60, events=(
        scenario.QualityShift(30, MISTRAL, 0.7),), stream_seed_base=52)
    kw = dict(device="cpu")
    return {
        "empty_budgets_grid": (ValueError, "budgets is empty", lambda: (
            sweep.run_grid(CFG, env, (), seeds=SEEDS, **kw))),
        "empty_budgets_scenario": (ValueError, "budgets is empty", lambda: (
            sweep.run_scenario_grid(CFG, plain, env, (), seeds=SEEDS, **kw))),
        "empty_seeds_grid": (ValueError, "seeds is empty", lambda: (
            sweep.run_grid(CFG, env, BUDGETS, seeds=(), **kw))),
        "empty_seeds_scenario": (ValueError, "seeds is empty", lambda: (
            sweep.run_scenario_grid(CFG, plain, env, BUDGETS, seeds=(),
                                    **kw))),
        "edits_grid": (ValueError, "condition_edits", lambda: (
            sweep.run_grid(CFG, env, BUDGETS, seeds=SEEDS,
                           condition_edits=[None], **kw))),
        "edits_scenario": (ValueError, "condition_edits", lambda: (
            sweep.run_scenario_grid(CFG, plain, env, BUDGETS, seeds=SEEDS,
                                    condition_edits=[None, None], **kw))),
        "param_edit_plain_grid": (ValueError, "run_scenario_grid", lambda: (
            sweep.run_grid(CFG, env, (6.6e-4,), seeds=SEEDS,
                           condition_edits=[sweep.param_edit(mult=0.5)],
                           **kw))),
        "partial_param_edit": (ValueError, "no base value", lambda: (
            sweep.run_scenario_grid(
                CFG, spec, env, (6.6e-4, 6.6e-4), seeds=SEEDS,
                condition_edits=[sweep.param_edit(mult=0.5), None], **kw))),
        "chunk_not_divisor": (ValueError, "divisor", lambda: (
            sweep.run_grid(CFG, env, BUDGETS, seeds=SEEDS, chunk_size=4,
                           **kw))),
        "chunk_zero": (ValueError, "divisor", lambda: (
            sweep.run_grid(CFG, env, BUDGETS, seeds=SEEDS, chunk_size=0,
                           **kw))),
        "timeline_count": (ValueError, "per condition", lambda: (
            sweep.run_scenario_grid(
                CFG, plain, env, BUDGETS, seeds=SEEDS,
                timelines=(scenario.Timeline((10,)),) * 2, **kw))),
        "tenant_tables": (ValueError, "together", lambda: (
            sweep.run_grid(CFG, env, BUDGETS, seeds=SEEDS,
                           tenant_tables=tenancy.make_table(
                               [1e-3, 2e-3], device="cpu"), **kw))),
        "tenant_ids": (ValueError, "together", lambda: (
            sweep.run_grid(CFG, env, BUDGETS, seeds=SEEDS,
                           tenant_ids=np.zeros(96, np.int32), **kw))),
        "tenant_batch_size": (ValueError, "batch_size", lambda: (
            sweep.run_grid(CFG, env, BUDGETS, seeds=SEEDS,
                           tenant_tables=tenancy.make_table(
                               [1e-3, 2e-3], device="cpu"),
                           tenant_ids=np.zeros(96, np.int32), **kw))),
    }


GUARDS = sorted(_guard_calls(None))


@pytest.mark.parametrize("case", GUARDS)
def test_grid_guards(bench, case):
    exc, match, call = _guard_calls(bench["env"])[case]
    with pytest.raises(exc, match=match):
        call()


@pytest.mark.parametrize("case", ["empty_budgets", "empty_seeds", "edits",
                                  "chunk"])
def test_guard_messages_match_jax(bench, case):
    args = {"empty_budgets": dict(budgets=()),
            "empty_seeds": dict(seeds=()),
            "edits": dict(condition_edits=[None]),
            "chunk": dict(chunk_size=4)}[case]
    kw = dict(budgets=BUDGETS, seeds=SEEDS) | args
    with pytest.raises(ValueError) as want:
        jsweep.run_grid(JCFG, bench["jenv"], **kw)
    with pytest.raises(ValueError) as got:
        sweep.run_grid(CFG, bench["env"], device="cpu", **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n,chunk,want", [(720, 100, 90), (9, 4, 3),
                                          (9, 100, 9), (7, 3, 1),
                                          (12, 12, 12), (1400, 65535, 1400)])
def test_fit_chunk(n, chunk, want):
    assert sweep.fit_chunk(n, chunk) == want
    if n < 1000:
        assert jsweep.fit_chunk(n, chunk) == want


@pytest.mark.parametrize("n,devices,parts", [(6, 1, 1), (6, 4, 3),
                                             (7, 4, 1), (1, 3, 1)])
def test_grid_mesh_divisor_selection(n, devices, parts):
    got = mesh.make_grid_mesh(n, ["cpu"] * devices)
    assert len(got) == parts and n % len(got) == 0
    bounds = mesh.part_bounds(n, got)
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))

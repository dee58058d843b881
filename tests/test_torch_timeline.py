"""The port's masked timeline runner (timelines as data, DESIGN.md §12)
and its Monte Carlo host statistics, on the CPU: inside the port, a
timeline run is identical to the concrete retimed spec's run at every
event type and timing edge, in both planes, with per-state timelines
blended state by state; against the JAX package, the timeline runs, the
cross-timeline stream stacks, ``sample_timelines`` and
``adaptation_lag``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import evaluate as jev  # noqa: E402
from repro.core import montecarlo as jmc  # noqa: E402
from repro.core import scenario as jsc  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro.core.types import RouterConfig as JConfig  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import evaluate, montecarlo, scenario  # noqa: E402
from repro_torch.core.scenario import (  # noqa: E402
    AddArm, BudgetChange, DeleteArm, HyperShift, Param, PriceChange,
    QualityShift, ScenarioParams, ScenarioSpec, Timeline, TrafficMixShift,
    retime,
)
from repro_torch.core.types import RouterConfig  # noqa: E402

SPLITS = {"train": 64, "val": 16, "test": 96}
SEEDS = (0, 1)
CFG, JCFG = RouterConfig(max_arms=4), JConfig(max_arms=4)
GEMINI, MISTRAL = 2, 1
MIX = tuple(3.0 if f == 1 else 0.25 for f in range(9))


@pytest.fixture(scope="module")
def bench():
    b = jsim.make_benchmark(seed=0, splits=SPLITS)
    jenv4 = jsim.extend_with_flash(b.test, "good_cheap")
    return dict(jenv=b.test, jenv4=jenv4, env=interop.env_from_numpy(b.test),
                env4=interop.env_from_numpy(jenv4))


def _bitwise(a, b):
    for f in ("arms", "rewards", "costs", "lams"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def _check(env, spec, budget, tl, batch_size=None, **kw):
    """The timeline run equals the concrete retimed spec's run bit for
    bit, with the retimed spec's bounds."""
    base = evaluate.run_scenario(CFG, retime(spec, tl), env, budget,
                                 seeds=SEEDS, batch_size=batch_size,
                                 device="cpu", **kw)
    masked = evaluate.run_scenario(CFG, spec, env, budget, seeds=SEEDS,
                                   batch_size=batch_size, timeline=tl,
                                   device="cpu", **kw)
    _bitwise(base, masked)
    assert masked.bounds == base.bounds
    return masked


# (spec, 4-arm env, budget, timeline, batch size): every event type, the
# timing edges and rng modes of tests/test_timeline.py, and the block plane.
CASES = {
    "silent_price_and_quality": (ScenarioSpec(horizon=96, events=(
        PriceChange(32, GEMINI, 1 / 56), QualityShift(64, MISTRAL, 0.72)),
        stream_seed_base=910), False, 6.6e-4, Timeline((20, 56)), None),
    "recalibrated_price": (ScenarioSpec(horizon=96, events=(
        PriceChange(32, GEMINI, 0.3, recalibrate=True),),
        stream_seed_base=911), False, 6.6e-4, Timeline((52,)), None),
    "budget_change": (ScenarioSpec(horizon=96, events=(
        BudgetChange(32, 3.0e-4),), stream_seed_base=912), False, 1.9e-3,
        Timeline((72,)), None),
    "hyper_shift": (ScenarioSpec(horizon=96, events=(
        HyperShift(48, gamma=0.9),), stream_seed_base=913), False, 1.9e-3,
        Timeline((16,)), None),
    "add_arm": (ScenarioSpec(horizon=96, events=(AddArm(32, 3),),
                             stream_seed_base=914, init_active=3), True,
                6.6e-4, Timeline((58,)), None),
    "delete_arm": (ScenarioSpec(horizon=96, events=(
        DeleteArm(40, MISTRAL),), stream_seed_base=915), False, 1.0,
        Timeline((24,)), None),
    "traffic_mix": (ScenarioSpec(horizon=120, events=(
        TrafficMixShift(60, MIX),), stream_seed_base=916), False, 6.6e-4,
        Timeline((36,)), None),
    "add_arm_after_reprice": (ScenarioSpec(horizon=112, events=(
        DeleteArm(8, 3), PriceChange(32, 3, 0.1), AddArm(64, 3)),
        stream_seed_base=917), True, 6.6e-4, Timeline((8, 32, 64)), None),
    "add_arm_before_reprice": (ScenarioSpec(horizon=112, events=(
        DeleteArm(8, 3), PriceChange(32, 3, 0.1), AddArm(64, 3)),
        stream_seed_base=917), True, 6.6e-4, Timeline((8, 72, 40)), None),
    "event_at_t0": (ScenarioSpec(horizon=80, events=(
        QualityShift(32, MISTRAL, 0.7),), stream_seed_base=918), False,
        6.6e-4, Timeline((0,)), None),
    "adjacent_steps": (ScenarioSpec(horizon=80, events=(
        PriceChange(24, GEMINI, 0.2), BudgetChange(48, 3.0e-4)),
        stream_seed_base=919), False, 1.9e-3, Timeline((40, 41)), None),
    "coincident_listed_order": (ScenarioSpec(horizon=80, events=(
        PriceChange(24, GEMINI, 0.5), PriceChange(48, GEMINI, 0.05)),
        stream_seed_base=920), False, 6.6e-4, Timeline((36, 36)), None),
    "reordered_times": (ScenarioSpec(horizon=96, events=(
        PriceChange(32, GEMINI, 0.1), QualityShift(64, MISTRAL, 0.7)),
        stream_seed_base=921), False, 6.6e-4, Timeline((64, 24)), None),
    "shrunken_horizon": (ScenarioSpec(horizon=128, events=(
        QualityShift(64, MISTRAL, 0.7),), stream_seed_base=922), False,
        6.6e-4, Timeline((32,), horizon=80), None),
    "horizon_only": (ScenarioSpec(horizon=96, stream_seed_base=923),
                     False, 6.6e-4, Timeline((), horizon=72), None),
    "segment_seeds": (ScenarioSpec(horizon=96, events=(
        QualityShift(48, MISTRAL, 0.7),), segment_seeds=(300, 400),
        stream_seed_base=0), False, 6.6e-4, Timeline((28,)), None),
    "replay": (ScenarioSpec(horizon=144, events=(
        QualityShift(48, MISTRAL, 0.7), QualityShift(96, MISTRAL, None)),
        stream_seed_base=924, replay=((2, 0),)), False, 6.6e-4,
        Timeline((32, 64), horizon=96), None),
    "blocks": (ScenarioSpec(horizon=128, events=(
        PriceChange(32, GEMINI, 0.1), BudgetChange(64, 3.0e-4)),
        stream_seed_base=925), False, 1.9e-3,
        Timeline((48, 96), horizon=112), 16),
    "blocks_add_arm": (ScenarioSpec(horizon=96, events=(
        AddArm(32, 3), PriceChange(48, GEMINI, 1 / 56, recalibrate=True)),
        stream_seed_base=926, init_active=3), True, 6.6e-4,
        Timeline((64, 16), horizon=80), 8),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_timeline_matches_retimed_spec(bench, case):
    spec, four, budget, tl, bs = CASES[case]
    res = _check(bench["env4" if four else "env"], spec, budget, tl, bs)
    h = tl.horizon or spec.horizon
    assert res.arms.shape == (len(SEEDS), h)
    if case == "add_arm":
        assert (res.segment(1).arms[:, :CFG.forced_pulls] == 3).all()
    if case == "delete_arm":
        assert not np.any(res.segment(1).arms == MISTRAL)


@pytest.mark.parametrize("batch_size", [None, 8])
def test_timeline_param_payloads(bench, batch_size):
    """Stream and operand payloads as Params under a timeline: the
    in-force windows of the stream transforms and the auto-lifted
    operands give the concrete retimed run's bits."""
    mk = lambda m, q, b: ScenarioSpec(horizon=96, events=(  # noqa: E731
        PriceChange(32, GEMINI, m), QualityShift(48, MISTRAL, q),
        PriceChange(64, GEMINI, 1.0), BudgetChange(72, b)),
        stream_seed_base=927)
    tl = Timeline((16, 40, 56, 24), horizon=88)
    params = ScenarioParams(m=0.05, q=0.6, b=3.0e-4)
    concrete = evaluate.run_scenario(
        CFG, retime(mk(0.05, 0.6, 3.0e-4), tl), bench["env"], 1.9e-3,
        seeds=SEEDS, batch_size=batch_size, device="cpu")
    masked = evaluate.run_scenario(
        CFG, mk(Param("m"), Param("q"), Param("b")), bench["env"], 1.9e-3,
        seeds=SEEDS, batch_size=batch_size, timeline=tl,
        scenario_params=params, device="cpu")
    _bitwise(concrete, masked)


def test_per_state_timelines_blend_state_by_state(bench):
    """One runner call whose states follow different timelines (event
    times and horizons per state): each state's live steps equal its own
    concrete retimed run, so the fired edits, the per-state in-force
    price of the AddArm and the frozen padding all act state by state."""
    env4 = bench["env4"]
    spec = ScenarioSpec(horizon=96, events=(
        DeleteArm(8, 3), PriceChange(24, 3, Param("m")), AddArm(48, 3),
        BudgetChange(64, 3.0e-4), QualityShift(72, MISTRAL, Param("q"))),
        stream_seed_base=928)
    tls = [Timeline((8, 24, 48, 64, 72)),
           Timeline((4, 60, 40, 20, 30), horizon=80)]
    seeds = (0, 1)
    params = ScenarioParams(m=np.asarray([0.1, 0.5], np.float32),
                            q=np.asarray([0.6, 0.7], np.float32))
    rspecs = [retime(spec, tl) for tl in tls]
    xs, rm, cm = scenario.build_timeline_streams(
        CFG, spec, env4, rspecs, [(s,) for s in seeds], pad_to=spec.horizon,
        device="cpu")
    states = evaluate.make_states(CFG, env4, 6.6e-4, seeds, device="cpu")
    full = params.updated(**scenario.auto_param_values(spec))
    run = scenario.compiled_timeline_runner(CFG, spec, env4)
    _, (arms, r, c, lam) = run(
        states, xs, rm, cm, scenario.broadcast_params(full, 2, "cpu"),
        np.asarray([tl.event_ts for tl in tls]),
        np.asarray([r_.horizon for r_ in rspecs]))
    for i, (seed, r_) in enumerate(zip(seeds, rspecs)):
        alone = evaluate.run_scenario(
            CFG, r_, env4, 6.6e-4, seeds=(seed,), device="cpu",
            scenario_params=ScenarioParams(m=float(params.get("m")[i]),
                                           q=float(params.get("q")[i])))
        h = r_.horizon
        for got, want in zip((arms, r, c, lam), (alone.arms, alone.rewards,
                                                 alone.costs, alone.lams)):
            np.testing.assert_array_equal(got[i, :h].numpy(), want[0])
        assert (arms[i, h:] == -1).all() and (r[i, h:] == 0).all()


def test_misaligned_timeline_rejected(bench):
    spec = ScenarioSpec(horizon=128, events=(PriceChange(32, GEMINI, 0.1),),
                        stream_seed_base=929)
    for tl in (Timeline((40,)), Timeline((32,), horizon=100)):
        with pytest.raises(ValueError, match="aligned") as got:
            evaluate.run_scenario(CFG, spec, bench["env"], 6.6e-4,
                                  seeds=(0,), batch_size=16, timeline=tl,
                                  device="cpu")
        jspec = jsc.ScenarioSpec(horizon=128, events=(
            jsc.PriceChange(32, GEMINI, 0.1),), stream_seed_base=929)
        with pytest.raises(ValueError) as want:
            jsc.validate_timeline_alignment(
                jsc.retime(jspec, jsc.Timeline(tl.event_ts, tl.horizon)),
                16, 128)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("batch_size", [None, 8])
def test_timeline_run_matches_jax(bench, batch_size):
    """A multi-event timeline run against JAX's masked runner: arm
    agreement >= 0.99, mean reward within 1e-3, final PRNG keys exact."""
    def mk(m):
        return m.ScenarioSpec(horizon=96, events=(
            m.PriceChange(32, GEMINI, 1 / 56), m.AddArm(16, 3),
            m.BudgetChange(48, 3.0e-4), m.QualityShift(64, MISTRAL, 0.7)),
            stream_seed_base=930, init_active=3)
    ts, h = (40, 8, 24, 56), 88
    jres, jst = jev.run_scenario(
        JCFG, mk(jsc), bench["jenv4"], 1.9e-3, seeds=SEEDS,
        batch_size=batch_size, timeline=jsc.Timeline(ts, h),
        return_states=True)
    res, st = evaluate.run_scenario(
        CFG, mk(scenario), bench["env4"], 1.9e-3, seeds=SEEDS,
        batch_size=batch_size, timeline=Timeline(ts, h), return_states=True,
        device="cpu")
    assert res.bounds == jres.bounds and res.arms.shape == jres.arms.shape
    assert (res.arms == jres.arms).mean() >= 0.99
    assert abs(res.mean_reward - jres.mean_reward) < 1e-3
    assert np.array_equal(interop.state_to_numpy(st)["key"],
                          np.asarray(jst.key))


# --- cross-timeline stream stacks -------------------------------------------

def _stack_spec(m):
    return m.ScenarioSpec(horizon=128, events=(
        m.QualityShift(48, MISTRAL, 0.7), m.PriceChange(80, GEMINI, 0.1)),
        stream_seed_base=940)


STACK_TLS = [((48, 80), None), ((80, 16), None), ((8, 24), 80),
             ((32, 32), 96), ((0, 120), None)]
STACK_CASES = {
    # (spec maker, 4-arm env, timelines (event times, horizon), seeds)
    "fast_shared_seeds": (_stack_spec, False, STACK_TLS, [SEEDS] * 5),
    "fast_per_element_seeds": (_stack_spec, False, STACK_TLS,
                               [(i + 5,) for i in range(5)]),
    "fast_arm_growth": (lambda m: m.ScenarioSpec(horizon=112, events=(
        m.QualityShift(48, MISTRAL, 0.8), m.AddArm(72, 3)),
        stream_seed_base=941, init_active=3), True,
        [((48, 72), None), ((80, 96), 104)], [SEEDS] * 2),
    "fallback_mix": (lambda m: m.ScenarioSpec(horizon=128, events=(
        m.TrafficMixShift(64, MIX),), stream_seed_base=945), False,
        [((64,), None), ((24,), 80)], [SEEDS] * 2),
}


@pytest.mark.parametrize("case", sorted(STACK_CASES))
def test_build_timeline_streams_match_jax(bench, case):
    build, four, tls, groups = STACK_CASES[case]
    jspec, spec = build(jsc), build(scenario)
    assert (scenario.timeline_streams_vectorizable(spec)
            == jsc.timeline_streams_vectorizable(jspec))
    jenv = bench["jenv4" if four else "jenv"]
    env = bench["env4" if four else "env"]
    jr = [jsc.retime(jspec, jsc.Timeline(*t)) for t in tls]
    rs = [retime(spec, Timeline(*t)) for t in tls]
    want = jsc.build_timeline_streams(JCFG, jspec, jenv, jr, groups,
                                      pad_to=jspec.horizon)
    got = scenario.build_timeline_streams(CFG, spec, env, rs, groups,
                                          pad_to=spec.horizon, device="cpu")
    loop = [scenario.build_streams(CFG, r_, env, tuple(g),
                                   pad_to=spec.horizon, device="cpu")
            for r_, g in zip(rs, groups)]
    for j, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(g.numpy(), np.asarray(w))
        assert torch.equal(g, torch.cat([p[j] for p in loop]))


def test_vectorizable_detection_matches_jax():
    def specs(m):
        qs = (m.QualityShift(60, MISTRAL, 0.7),)
        return (
            m.ScenarioSpec(horizon=180, events=qs + (
                m.QualityShift(120, MISTRAL, None),), replay=((2, 0),)),
            m.ScenarioSpec(horizon=120, events=qs, segment_seeds=(3, 4)),
            m.ScenarioSpec(horizon=120, events=qs, mode="permutation"),
            m.ScenarioSpec(horizon=120, events=(m.TrafficMixShift(60, MIX),)),
            m.ScenarioSpec(horizon=120, events=qs))
    got = [scenario.timeline_streams_vectorizable(s) for s in specs(scenario)]
    want = [jsc.timeline_streams_vectorizable(s) for s in specs(jsc)]
    assert got == want == [False, False, False, False, True]


RETIME_ERRORS = {
    "event_count": (lambda m: m.ScenarioSpec(horizon=100, events=(
        m.QualityShift(50, 1, 0.7),)), ((10, 20), None), ValueError),
    "horizon_zero": (lambda m: m.ScenarioSpec(horizon=100), ((), 0),
                     ValueError),
    "horizon_over": (lambda m: m.ScenarioSpec(horizon=100), ((), 101),
                     ValueError),
    "time_at_horizon": (lambda m: m.ScenarioSpec(horizon=100, events=(
        m.QualityShift(50, 1, 0.7),)), ((100,), None), AssertionError),
}


@pytest.mark.parametrize("case", sorted(RETIME_ERRORS))
def test_retime_errors_match_jax(case):
    build, (ts, h), err = RETIME_ERRORS[case]
    with pytest.raises(err) as want:
        jsc.retime(build(jsc), jsc.Timeline(ts, horizon=h))
    with pytest.raises(err) as got:
        retime(build(scenario), Timeline(ts, horizon=h))
    assert str(got.value) == str(want.value)


# --- Monte Carlo host statistics ---------------------------------------------

MC_DRAWS = {
    "plain": dict(n=12, seed=3),
    "aligned_horizons": dict(n=16, seed=7, align=4, horizons=(80, 120)),
    "windows": dict(n=8, seed=1, t_lo=(10, 60), t_hi=(50, 119)),
}


@pytest.mark.parametrize("case", sorted(MC_DRAWS))
def test_sample_timelines_match_jax(case):
    def mk(m):
        return m.ScenarioSpec(horizon=120, events=(
            m.PriceChange(40, GEMINI, 1 / 56),
            m.QualityShift(80, MISTRAL, 0.72)), stream_seed_base=932)
    got = montecarlo.sample_timelines(mk(scenario), **MC_DRAWS[case])
    want = jmc.sample_timelines(mk(jsc), **MC_DRAWS[case])
    assert [(t.event_ts, t.horizon) for t in got] == [
        (t.event_ts, t.horizon) for t in want]
    assert montecarlo._align_down(7, 4) == jmc._align_down(7, 4) == 4


def test_impossible_window_raises_as_jax():
    kw = dict(t_lo=(100, 100), t_hi=(119, 119), horizons=(40, 60))
    with pytest.raises(ValueError, match="valid timeline") as got:
        montecarlo.sample_timelines(ScenarioSpec(horizon=120, events=(
            PriceChange(40, GEMINI, 0.5), QualityShift(80, 1, 0.7))), 1,
            **kw)
    with pytest.raises(ValueError) as want:
        jmc.sample_timelines(jsc.ScenarioSpec(horizon=120, events=(
            jsc.PriceChange(40, GEMINI, 0.5),
            jsc.QualityShift(80, 1, 0.7))), 1, **kw)
    assert (str(got.value).split(" within ")[1]
            == str(want.value).split(" within ")[1])


@pytest.mark.parametrize("boundary,window,frac", [
    (40, 32, 0.95), (10, 8, 0.99), (150, 32, 0.95), (0, 16, 0.5)])
def test_adaptation_lag_matches_jax(boundary, window, frac):
    rng = np.random.default_rng(boundary + window)
    rewards = np.clip(np.linspace(0.3, 0.9, 160)[None]
                      + 0.1 * rng.standard_normal((3, 160)), 0, 1)
    res = evaluate.RunResult(arms=np.zeros((3, 160), np.int32),
                             rewards=rewards.astype(np.float32),
                             costs=np.zeros((3, 160), np.float32),
                             lams=np.zeros((3, 160), np.float32))
    jres = jev.RunResult(arms=res.arms, rewards=res.rewards,
                         costs=res.costs, lams=res.lams)
    assert (montecarlo.adaptation_lag(res, boundary, window, frac)
            == jmc.adaptation_lag(jres, boundary, window, frac))

"""The port's scenario engine (``repro_torch.core.scenario`` and
``evaluate.run_scenario``) against the JAX package's on one small
benchmark, on the CPU: host stream compilation equal array for array,
scenario runs of every state and stream event type in both data planes
within the bars of ``test_evaluate_run_matches_jax``, and inside the
port bit for bit: concrete against ``Param`` payloads, per-seed payload
stacks against single-seed runs, and the hand-rolled phase loops the
engine replaces. The JAX runs are shared through module fixtures."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import evaluate as jev  # noqa: E402
from repro.core import scenario as jsc  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro.core.types import RouterConfig as JConfig  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import evaluate, pacer, registry, scenario  # noqa: E402
from repro_torch.core import simulator, types  # noqa: E402
from repro_torch.core.types import RouterConfig  # noqa: E402

SPLITS = {"train": 64, "val": 16, "test": 96}
SEEDS, N_EFF, BUDGET = (0, 1), 1164.0, 6.6e-4
CFG, JCFG = RouterConfig(max_arms=4), JConfig(max_arms=4)
GEMINI, MISTRAL = 2, 1
MIX = tuple(3.0 if f == 1 else 0.25 for f in range(9))


def both(build):
    """``build(module)`` for the JAX package's scenario module and the
    port's: the same spec in each."""
    return build(jsc), build(scenario)


@pytest.fixture(scope="module")
def bench():
    b = jsim.make_benchmark(seed=0, splits=SPLITS)
    jenv4 = jsim.extend_with_flash(b.test, "good_cheap")
    jpriors = jev.fit_warmup_priors(JCFG, b.train)
    return dict(
        jenv=b.test, jenv4=jenv4, jpriors=jpriors,
        env=interop.env_from_numpy(b.test),
        env4=interop.env_from_numpy(jenv4),
        priors=[interop.prior_from_numpy(p, "cpu") for p in jpriors])


# --- specs covering every non-tenant event type ----------------------------

def _spec_state(m):
    """State events (and a quality regression) on the 3-arm env."""
    return m.ScenarioSpec(horizon=96, events=(
        m.PriceChange(16, GEMINI, 0.1, recalibrate=True),
        m.QualityShift(32, MISTRAL, 0.7),
        m.BudgetChange(40, 3.0e-4),
        m.HyperShift(56, gamma=0.9, alpha=0.02),
        m.PriceChange(72, GEMINI, 1.0, recalibrate=True),
        m.QualityShift(80, MISTRAL, None)), stream_seed_base=500)


def _spec_arms(m):
    """Arm hot-swap, silent drift and traffic mix on the 4-arm env."""
    return m.ScenarioSpec(horizon=96, events=(
        m.AddArm(24, 3),
        m.PriceChange(40, GEMINI, 1 / 56),
        m.TrafficMixShift(48, MIX),
        m.DeleteArm(64, MISTRAL),
        m.PriceChange(80, GEMINI, 1.0)),
        stream_seed_base=600, init_active=3)


SPECS = {"state": _spec_state, "arms": _spec_arms}


@pytest.fixture(scope="module")
def jax_runs(bench):
    """JAX's run of each spec in each plane, with its final states."""
    out = {}
    for name, build in SPECS.items():
        jenv = bench["jenv4"] if name == "arms" else bench["jenv"]
        jpri = bench["jpriors"] + ([None] if name == "arms" else [])
        for bs in (None, 8):
            out[name, bs] = jev.run_scenario(
                JCFG, build(jsc), jenv, BUDGET, seeds=SEEDS, priors=jpri,
                n_eff=N_EFF, batch_size=bs, return_states=True)
    return out


@pytest.mark.parametrize("batch_size", [None, 8])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_run_scenario_matches_jax(bench, jax_runs, name, batch_size):
    """Arm agreement >= 0.99, mean reward within 1e-3, compliance of each
    segment within 1e-3 relative, final statistics within 1e-4 and PRNG
    keys exact."""
    jres, jst = jax_runs[name, batch_size]
    env = bench["env4"] if name == "arms" else bench["env"]
    priors = bench["priors"] + ([None] if name == "arms" else [])
    res, st = evaluate.run_scenario(
        CFG, SPECS[name](scenario), env, BUDGET, seeds=SEEDS, priors=priors,
        n_eff=N_EFF, batch_size=batch_size, return_states=True,
        device="cpu")
    assert res.bounds == jres.bounds
    assert res.arms.shape == jres.arms.shape == (len(SEEDS), 96)
    assert (res.arms == jres.arms).mean() >= 0.99
    assert abs(res.mean_reward - jres.mean_reward) < 1e-3
    for j in range(res.n_segments):
        got, want = res.segment(j), jres.segment(j)
        assert abs(got.compliance(BUDGET) / want.compliance(BUDGET) - 1) < 1e-3
    leaves = interop.state_to_numpy(st)
    assert np.array_equal(leaves["key"], np.asarray(jst.key))
    for n in ("A_inv", "theta"):
        np.testing.assert_allclose(leaves[n], np.asarray(getattr(jst, n)),
                                   atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(leaves["active"], np.asarray(jst.active))
    for n in ("price", "c_tilde"):
        np.testing.assert_allclose(leaves[n], np.asarray(getattr(jst, n)),
                                   rtol=1e-6)
    np.testing.assert_array_equal(leaves["pacer"]["budget"],
                                  np.asarray(jst.pacer.budget))
    for n in ("gamma", "alpha"):
        np.testing.assert_array_equal(leaves["hyper"][n],
                                      np.asarray(getattr(jst.hyper, n)))


# --- host stream compilation, array for array -------------------------------

INDEX_SPECS = {
    "sequential_replay": lambda m: m.ScenarioSpec(
        horizon=90, events=(m.QualityShift(30, MISTRAL, 0.7),
                            m.QualityShift(60, MISTRAL, None)),
        stream_seed_base=77, replay=((2, 0),)),
    "segment_seeds": lambda m: m.ScenarioSpec(
        horizon=100, events=(m.QualityShift(40, 1, 0.7),),
        segment_seeds=(300, 400)),
    "permutation": lambda m: m.ScenarioSpec(
        horizon=96, events=(m.PriceChange(50, GEMINI, 0.5),),
        stream_seed_base=3, mode="permutation"),
    "mix": lambda m: m.ScenarioSpec(
        horizon=120, events=(m.TrafficMixShift(40, MIX),
                             m.TrafficMixShift(80, None)),
        stream_seed_base=11),
}


@pytest.mark.parametrize("name", sorted(INDEX_SPECS))
def test_compile_indices_match_jax(bench, name):
    jspec, spec = both(INDEX_SPECS[name])
    for seed in (0, 5):
        want = jsc.compile_indices(jspec, bench["jenv"], seed)
        got = scenario.compile_indices(spec, bench["env"], seed)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert np.array_equal(g, w)


STREAM_CASES = {
    # (spec maker, 4-arm env, max_arms, pad_to, scenario params)
    "slot_padding": (INDEX_SPECS["sequential_replay"], False, 8, None, None),
    "pad_to": (lambda m: m.ScenarioSpec(
        horizon=80, events=(m.PriceChange(20, GEMINI, 0.1),
                            m.QualityShift(50, MISTRAL, 0.72)),
        stream_seed_base=9), False, 4, 112, None),
    "mix_param": (lambda m: m.ScenarioSpec(
        horizon=100, events=(m.TrafficMixShift(50, m.Param("mix")),),
        stream_seed_base=12), False, 4, None,
        dict(mix=np.asarray(MIX, np.float32))),
    "stream_params": (lambda m: m.ScenarioSpec(
        horizon=90, events=(m.PriceChange(30, GEMINI, m.Param("mult")),
                            m.QualityShift(60, MISTRAL, m.Param("q"))),
        stream_seed_base=13), False, 4, None, dict(mult=0.2, q=0.6)),
    "four_arms": (lambda m: m.ScenarioSpec(
        horizon=70, events=(m.AddArm(35, 3),), segment_seeds=(1, 2),
        init_active=3), True, 8, 96, None),
}


@pytest.mark.parametrize("name", sorted(STREAM_CASES))
def test_build_streams_match_jax(bench, name):
    build, four, K, pad_to, pv = STREAM_CASES[name]
    jspec, spec = both(build)
    jenv = bench["jenv4"] if four else bench["jenv"]
    env = bench["env4"] if four else bench["env"]
    jp = None if pv is None else jsc.ScenarioParams(**pv)
    p = None if pv is None else scenario.ScenarioParams(**pv)
    want = jsc.build_streams(JConfig(max_arms=K), jspec, jenv, SEEDS,
                             params=jp, pad_to=pad_to)
    got = scenario.build_streams(RouterConfig(max_arms=K), spec, env, SEEDS,
                                 params=p, pad_to=pad_to, device="cpu")
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.device.type == "cpu"
        assert np.array_equal(g.numpy(), np.asarray(w))


# --- inside the port: concrete against Param payloads, bit for bit ----------

def _bitwise(a, b):
    for f in ("arms", "rewards", "costs", "lams"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def _run(env, spec, budget=BUDGET, seeds=SEEDS, **kw):
    return evaluate.run_scenario(CFG, spec, env, budget, seeds=seeds,
                                 device="cpu", **kw)


PARAM_CASES = {
    # (spec of the payloads, concrete payloads, 4-arm env)
    "stream": (lambda a, b: scenario.ScenarioSpec(horizon=96, events=(
        scenario.PriceChange(32, GEMINI, a),
        scenario.QualityShift(64, MISTRAL, b)), stream_seed_base=900),
        (1 / 56, 0.72), False),
    "recalibrate": (lambda a: scenario.ScenarioSpec(horizon=96, events=(
        scenario.PriceChange(40, GEMINI, a, recalibrate=True),),
        stream_seed_base=902), (0.3,), False),
    "budget": (lambda a: scenario.ScenarioSpec(horizon=96, events=(
        scenario.BudgetChange(40, a),), stream_seed_base=921),
        (3.0e-4,), False),
    "hyper": (lambda a: scenario.ScenarioSpec(horizon=96, events=(
        scenario.HyperShift(48, gamma=a),), stream_seed_base=901),
        (0.9,), False),
    "add_arm": (lambda a, b: scenario.ScenarioSpec(horizon=96, events=(
        scenario.AddArm(40, 3, n_eff=a, bias_reward=b),),
        stream_seed_base=903, init_active=3), (130.0, 0.5), True),
}


@pytest.mark.parametrize("batch_size", [None, 8])
@pytest.mark.parametrize("name", sorted(PARAM_CASES))
def test_param_payloads_match_concrete_bitwise(bench, name, batch_size):
    build, vals, four = PARAM_CASES[name]
    env = bench["env4"] if four else bench["env"]
    names = [f"p{i}" for i in range(len(vals))]
    concrete = _run(env, build(*vals), batch_size=batch_size)
    param = _run(env, build(*map(scenario.Param, names)),
                 batch_size=batch_size,
                 scenario_params=scenario.ScenarioParams(
                     **dict(zip(names, vals))))
    _bitwise(concrete, param)


def test_packed_prior_param_matches_concrete_bitwise(bench):
    prior = evaluate.fit_warmup_priors(CFG, bench["env4"], device="cpu")[3]
    mk = lambda p: scenario.ScenarioSpec(  # noqa: E731
        horizon=96, events=(scenario.AddArm(40, 3, prior=p, n_eff=100.0),),
        stream_seed_base=904, init_active=3)
    concrete = _run(bench["env4"], mk(prior))
    param = _run(bench["env4"], mk(scenario.Param("prior")),
                 scenario_params=scenario.ScenarioParams(prior=prior))
    _bitwise(concrete, param)
    assert (param.segment(1).arms[:, :CFG.forced_pulls] == 3).all()


@pytest.mark.parametrize("batch_size", [None, 8])
def test_stacked_params_match_single_seed_runs(bench, batch_size):
    """(S,) payload stacks, one value per seed, give each seed the run it
    gets alone with its own value, bit for bit."""
    spec = scenario.ScenarioSpec(horizon=96, events=(
        scenario.PriceChange(24, GEMINI, scenario.Param("m"),
                             recalibrate=True),
        scenario.QualityShift(48, MISTRAL, scenario.Param("q")),
        scenario.BudgetChange(64, scenario.Param("b")),
        scenario.HyperShift(72, alpha=scenario.Param("a"))),
        stream_seed_base=930)
    vals = dict(m=[0.1, 0.5], q=[0.6, 0.8], b=[3.0e-4, 1.9e-3],
                a=[0.02, 0.05])
    stacked = _run(bench["env"], spec, batch_size=batch_size,
                   scenario_params=scenario.ScenarioParams(
                       **{k: np.asarray(v, np.float32)
                          for k, v in vals.items()}))
    for i, seed in enumerate(SEEDS):
        alone = _run(bench["env"], spec, seeds=(seed,),
                     batch_size=batch_size,
                     scenario_params=scenario.ScenarioParams(
                         **{k: v[i] for k, v in vals.items()}))
        for f in ("arms", "rewards", "costs", "lams"):
            np.testing.assert_array_equal(getattr(stacked, f)[i],
                                          getattr(alone, f)[0], err_msg=f)


def test_param_multiplier_is_not_the_restore(bench):
    base = _run(bench["env"], scenario.ScenarioSpec(horizon=90, events=(
        scenario.PriceChange(30, GEMINI, 1.0),), stream_seed_base=909))
    param = _run(bench["env"], scenario.ScenarioSpec(horizon=90, events=(
        scenario.PriceChange(30, GEMINI, scenario.Param("m")),),
        stream_seed_base=909),
        scenario_params=scenario.ScenarioParams(m=1.0))
    _bitwise(base, param)


# --- inside the port: the hand-rolled phase loops, bit for bit --------------

def _segments(env, base, lens, transform=None):
    """Per-seed phase environments drawn as the engine draws them: one
    generator ``default_rng(base + s)`` consumed phase after phase."""
    out = [[] for _ in lens]
    for s in SEEDS:
        rng = np.random.default_rng(base + s)
        for j, L in enumerate(lens):
            e = env if j == 0 or transform is None else transform(env)
            out[j].append(e.subset(rng.integers(0, env.n, L)))
    return out


def _phases(env, states, segs, edit, budget):
    res1, states = evaluate.run(CFG, segs[0], budget, seeds=SEEDS,
                                states=states, shuffle=False,
                                return_states=True)
    res2 = evaluate.run(CFG, segs[1], budget, seeds=SEEDS,
                        states=edit(states), shuffle=False)
    return evaluate.RunResult.concat([res1, res2])


def test_three_phase_quality_shift_matches_hand_rolled(bench):
    env, phase = bench["env"], 32
    envs = [simulator.three_phase_stream(
        env, lambda e: simulator.with_quality_shift(e, MISTRAL, 0.7),
        np.random.default_rng(2000 + s), phase_len=phase) for s in SEEDS]
    old = evaluate.run(CFG, envs, BUDGET, seeds=SEEDS, shuffle=False,
                       device="cpu")
    new = _run(env, scenario.ScenarioSpec(horizon=3 * phase, events=(
        scenario.QualityShift(phase, MISTRAL, 0.7),
        scenario.QualityShift(2 * phase, MISTRAL, None)),
        stream_seed_base=2000, replay=((2, 0),)))
    _bitwise(old, new)


def test_recalibrated_price_drift_matches_hand_rolled(bench):
    env, mult = bench["env"], 1 / 56
    segs = _segments(env, 1000, (40, 56), lambda e: (
        simulator.with_price_multiplier(e, GEMINI, mult)))
    states = evaluate.make_states(CFG, env, BUDGET, SEEDS,
                                  pacer_enabled=False, device="cpu")
    old = _phases(env, states, segs, lambda st: registry.set_price(
        CFG, st, GEMINI, float(env.prices_per_req[GEMINI]) * mult,
        float(env.prices_per_1k[GEMINI]) * mult), BUDGET)
    new = _run(env, scenario.ScenarioSpec(horizon=96, events=(
        scenario.PriceChange(40, GEMINI, mult, recalibrate=True),),
        stream_seed_base=1000), pacer_enabled=False)
    np.testing.assert_array_equal(old.arms, new.arms)
    np.testing.assert_allclose(old.costs, new.costs, atol=1e-9)


def test_onboarding_matches_hand_rolled(bench):
    env4 = bench["env4"]
    s1 = [env4.repeat_to(40, np.random.default_rng(300 + s)) for s in SEEDS]
    s2 = [env4.repeat_to(56, np.random.default_rng(400 + s)) for s in SEEDS]
    states = evaluate.make_states(CFG, env4, BUDGET, SEEDS, active_arms=3,
                                  device="cpu")
    old = _phases(env4, states, (s1, s2), lambda st: registry.add_arm(
        CFG, st, 3, float(env4.prices_per_req[3]),
        float(env4.prices_per_1k[3]), forced_exploration=True), BUDGET)
    new = _run(env4, scenario.ScenarioSpec(
        horizon=96, events=(scenario.AddArm(40, 3),),
        segment_seeds=(300, 400), init_active=3))
    _bitwise(old, new)
    assert (new.segment(1).arms[:, :CFG.forced_pulls] == 3).all()


def test_budget_change_matches_hand_rolled(bench):
    env = bench["env"]
    segs = _segments(env, 500, (40, 56))
    states = evaluate.make_states(CFG, env, 1.9e-3, SEEDS, device="cpu")
    old = _phases(env, states, segs, lambda st: dataclasses.replace(
        st, pacer=pacer.set_budget(st.pacer, 3.0e-4)), 1.9e-3)
    new = _run(env, scenario.ScenarioSpec(horizon=96, events=(
        scenario.BudgetChange(40, 3.0e-4),), stream_seed_base=500),
        budget=1.9e-3)
    _bitwise(old, new)


# --- the state edits' tensor payloads ----------------------------------------

def test_state_where_blends_every_leaf(bench):
    """Per state, every leaf of the new state (pacer and hyper leaves
    included) where the mask is set, the old one elsewhere."""
    old = evaluate.make_states(CFG, bench["env"], BUDGET, SEEDS,
                               device="cpu")
    new = dataclasses.replace(
        registry.delete_arm(CFG, old, MISTRAL),
        pacer=pacer.set_budget(old.pacer, [1e-4, 2e-4]))
    new = types.with_hyperparams(new, alpha=torch.tensor([0.5, 0.6]))
    got = types.state_where(torch.tensor([True, False]), new, old)
    for s, want in ((0, new), (1, old)):
        for n in ("A", "active", "key", "force_arm"):
            assert torch.equal(getattr(got, n)[s], getattr(want, n)[s]), n
        assert got.pacer.budget[s] == want.pacer.budget[s]
        assert got.hyper.alpha[s] == want.hyper.alpha[s]


def test_hyper_and_budget_validation_matches_jax(bench):
    """Numbers are checked on the host as the JAX package checks them;
    (S,) tensors pass unchecked, as its traced values do."""
    from repro.core.types import HyperParams as JHyper
    for kw in (dict(gamma=1.5), dict(c_floor=0.2, c_ceil=0.1),
               dict(v_max=0.5), dict(nope=1.0)):
        with pytest.raises((TypeError, ValueError)) as want:
            JHyper.validate_fields(**kw)
        with pytest.raises(want.type) as got:
            types.HyperParams.validate_fields(**kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError):
        types.HyperParams().updated(alpha=-1.0)
    assert types.HyperParams().updated(alpha=0.2).alpha == 0.2
    st = evaluate.make_states(CFG, bench["env"], BUDGET, SEEDS, device="cpu")
    with pytest.raises(ValueError):
        types.with_hyperparams(st, c_ceil=1e-5)   # below the state's floor
    stacked = types.with_hyperparams(st, gamma=torch.tensor([0.9, 1.5]))
    assert stacked.hyper.gamma.tolist() == pytest.approx([0.9, 1.5])
    with pytest.raises(ValueError):
        pacer.set_budget(st.pacer, [1e-3, 0.0])
    assert pacer.set_budget(st.pacer, torch.tensor([0.0, 1e-3])).budget[0] == 0


def test_add_arm_tensor_payloads_match_numbers(bench):
    """(S,) tensor prices, n_eff and bias give each state what the same
    numbers give it; a tensor n_eff takes the heuristic branch."""
    st = evaluate.make_states(CFG, bench["env4"], BUDGET, SEEDS,
                              active_arms=3, device="cpu")
    got = registry.add_arm(CFG, st, 3, torch.tensor([2e-3, 3e-3]),
                           torch.tensor([1.4e-3, 2e-3]),
                           n_eff=torch.tensor([130.0, 26.0]),
                           bias_reward=torch.tensor([0.5, 0.25]))
    for s, (preq, p1k, ne, br) in enumerate(((2e-3, 1.4e-3, 130.0, 0.5),
                                             (3e-3, 2e-3, 26.0, 0.25))):
        want = registry.add_arm(CFG, st, 3, preq, p1k, n_eff=ne,
                                bias_reward=br)
        for n in ("A", "A_inv", "b", "theta", "price", "c_tilde"):
            assert torch.equal(getattr(got, n)[s], getattr(want, n)[s]), n
    cold = registry.add_arm(CFG, st, 3, 2e-3, 1.4e-3,
                            n_eff=torch.zeros(2))
    assert torch.equal(cold.A, registry.add_arm(CFG, st, 3, 2e-3, 1.4e-3).A)


# --- validation, caches, tenants ---------------------------------------------

def _bad_spec(m, case):
    if case == "beyond_horizon":
        return m.ScenarioSpec(horizon=100,
                              events=(m.QualityShift(100, 1, 0.7),))
    if case == "replay":
        return m.ScenarioSpec(horizon=200,
                              events=(m.QualityShift(100, 1, 0.7),),
                              replay=((0, 1),))
    if case == "segment_seeds":
        return m.ScenarioSpec(horizon=200,
                              events=(m.QualityShift(100, 1, 0.7),),
                              segment_seeds=(1,))
    return m.ScenarioSpec(horizon=100, events=(
        m.TrafficMixShift(50, MIX),), mode="permutation")


@pytest.mark.parametrize("case", ["beyond_horizon", "replay",
                                  "segment_seeds", "mix_permutation"])
def test_spec_validation_matches_jax(case):
    with pytest.raises(AssertionError) as want:
        _bad_spec(jsc, case)
    with pytest.raises(AssertionError) as got:
        _bad_spec(scenario, case)
    assert str(got.value) == str(want.value)


RUN_ERRORS = {
    # (spec maker, 4-arm env, scenario params, error)
    "add_active_slot": (lambda m: m.ScenarioSpec(
        horizon=60, events=(m.AddArm(30, 3),)), True, None, AssertionError),
    "delete_inactive": (lambda m: m.ScenarioSpec(
        horizon=60, events=(m.DeleteArm(30, 3),), init_active=3), True,
        None, AssertionError),
    "missing_param": (lambda m: m.ScenarioSpec(horizon=60, events=(
        m.PriceChange(30, GEMINI, m.Param("mult")),)), False, {},
        ValueError),
    "extra_param": (lambda m: m.ScenarioSpec(horizon=60, events=(
        m.PriceChange(30, GEMINI, m.Param("mult")),)), False,
        dict(mult=0.1, typo=1.0), ValueError),
    "reserved_prefix": (lambda m: m.ScenarioSpec(horizon=60, events=(
        m.BudgetChange(30, m.Param("__auto0")),)), False,
        dict(__auto0=3.0e-4), ValueError),
    "stacked_mix": (lambda m: m.ScenarioSpec(horizon=60, events=(
        m.TrafficMixShift(30, m.Param("mix")),)), False,
        dict(mix=np.ones((2, 9), np.float32)), ValueError),
    "bad_hyper": (lambda m: m.ScenarioSpec(horizon=60, events=(
        m.HyperShift(30, gamma=1.5),)), False, None, ValueError),
}


@pytest.mark.parametrize("case", sorted(RUN_ERRORS))
def test_run_errors_match_jax(bench, case):
    build, four, pv, err = RUN_ERRORS[case]
    jspec, spec = both(build)
    key = "env4" if four else "env"
    with pytest.raises(err) as want:
        jev.run_scenario(
            JCFG, jspec, bench["j" + key], BUDGET, seeds=SEEDS,
            scenario_params=None if pv is None else jsc.ScenarioParams(**pv))
    with pytest.raises(err) as got:
        _run(bench[key], spec, scenario_params=None if pv is None
             else scenario.ScenarioParams(**pv))
    assert str(got.value) == str(want.value)


def test_runner_cache_keys(bench):
    """Runners are cached per (statics, spec structure, env, block size):
    concrete operand payloads are masked from the key, the block size is
    not, and hyper-parameters are state data."""
    env = bench["env"]
    mk = lambda b: scenario.ScenarioSpec(horizon=60, events=(  # noqa: E731
        scenario.BudgetChange(30, b),), stream_seed_base=7)
    a = scenario.compiled_runner(CFG, mk(3.0e-4), env)
    assert scenario.compiled_runner(CFG, mk(1.0e-4), env) is a
    assert scenario.compiled_runner(
        dataclasses.replace(CFG, hyper=CFG.hyper.updated(alpha=0.5)),
        mk(3.0e-4), env) is a
    assert scenario.compiled_runner(CFG, mk(3.0e-4), env, 8) is not a
    tl = scenario.compiled_timeline_runner(CFG, mk(3.0e-4), env)
    assert scenario.compiled_timeline_runner(
        CFG, scenario.retime(mk(1.0e-4), scenario.Timeline((10,))), env) is tl


def test_stream_cache_is_per_device(bench):
    spec = scenario.ScenarioSpec(horizon=40, stream_seed_base=5)
    a = scenario.build_streams(CFG, spec, bench["env"], SEEDS, device="cpu")
    assert scenario.build_streams(CFG, spec, bench["env"], SEEDS,
                                  device="cpu") is a
    assert any(k[-1] == "cpu" for k in scenario._STREAM_CACHE)


def test_spec_key_takes_tensor_priors(bench):
    priors = bench["priors"]
    mk = lambda p: scenario.ScenarioSpec(  # noqa: E731
        horizon=60, events=(scenario.AddArm(30, 2, prior=p, n_eff=50.0),),
        init_active=2)
    assert scenario.spec_key(mk(priors[2])) == scenario.spec_key(
        mk(interop.prior_from_numpy(interop.prior_to_numpy(priors[2]),
                                    "cpu")))
    assert scenario.spec_key(mk(priors[2])) != scenario.spec_key(
        mk(priors[1]))


def test_tenant_scenarios_not_ported(bench):
    """Tenant scenarios are not ported to the kernels (the ``fused``
    default raises, as JAX's Pallas kernels do) nor to the masked
    timeline runner (as in JAX); on ``torch`` a spec with both tenant
    events matches JAX's run: arms, rewards and costs identical, lams and
    the final table within 1e-4, the edited budget in place."""
    from repro.core import tenancy as jten
    from repro.data import synthetic as jsyn
    from repro_torch.core import tenancy
    from repro_torch.data import synthetic

    jspec, spec = both(lambda m: m.ScenarioSpec(horizon=96, events=(
        m.TenantMixShift(24, (3, 1, 1)),
        m.TenantBudgetChange(48, 0, 3.0e-4)), stream_seed_base=510))
    tids = synthetic.tenant_stream_for_spec(spec, 3, seed=2)
    assert np.array_equal(tids, jsyn.tenant_stream_for_spec(jspec, 3, seed=2))
    budgets = (5e-4, 6.6e-4, 9e-4)
    kw = dict(batch_size=8, tenant_ids=tids)
    table = tenancy.make_table(budgets, device="cpu")
    with pytest.raises(NotImplementedError):
        _run(bench["env"], spec, tenants=table, **kw)
    tcfg = dataclasses.replace(CFG, backend="torch")
    with pytest.raises(NotImplementedError):
        evaluate.run_scenario(tcfg, spec, bench["env"], BUDGET, SEEDS,
                              timeline=scenario.Timeline((24, 48)),
                              tenants=table, device="cpu", **kw)
    res, finals = evaluate.run_scenario(
        tcfg, spec, bench["env"], BUDGET, SEEDS, priors=bench["priors"],
        n_eff=N_EFF, tenants=table, return_states=True, device="cpu", **kw)
    jres, jfinals = jev.run_scenario(
        JCFG, jspec, bench["jenv"], BUDGET, SEEDS, priors=bench["jpriors"],
        n_eff=N_EFF, tenants=jten.make_table(budgets), return_states=True,
        **kw)
    for f in ("arms", "rewards", "costs"):
        assert np.array_equal(getattr(res, f), np.asarray(getattr(jres, f)))
    np.testing.assert_allclose(res.lams, np.asarray(jres.lams), atol=1e-4)
    for n in ("lam", "c_ema"):
        np.testing.assert_allclose(getattr(finals.tenants, n).numpy(),
                                   np.asarray(getattr(jfinals.tenants, n)),
                                   atol=1e-4)
    assert np.array_equal(finals.tenants.pulls.numpy(),
                          np.asarray(jfinals.tenants.pulls))
    assert np.allclose(finals.tenants.budget[:, 0].numpy(), 3.0e-4)

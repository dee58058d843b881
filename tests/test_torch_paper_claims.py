"""The paper's headline claims on the PyTorch port, on the card: the twin
of tests/test_paper_claims.py (same seeds, streams and thresholds),
driving ``repro_torch`` with its default backend, the fused step
kernel. Marked ``cuda``; without a GPU every test skips (decided inside
the fixture). On a machine with a card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_paper_claims.py -q
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import evaluate, registry, simulator  # noqa: E402
from repro_torch.core.types import RouterConfig  # noqa: E402

pytestmark = pytest.mark.cuda

SEEDS = tuple(range(6))
CFG = RouterConfig()          # paper knee-point: alpha=0.01, gamma=0.997
N_EFF = 1164.0


@pytest.fixture(scope="module")
def bench():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return simulator.make_benchmark(seed=0)


@pytest.fixture(scope="module")
def priors(bench):
    return evaluate.fit_warmup_priors(CFG, bench.train)


class TestStationaryPacing:
    def test_tight_budget_compliance(self, bench, priors):
        res = evaluate.run(CFG, bench.test, 3.0e-4, seeds=SEEDS,
                           priors=priors, n_eff=N_EFF)
        assert 0.9 < res.compliance(3.0e-4) < 1.10

    def test_unconstrained_near_oracle(self, bench, priors):
        res = evaluate.run(CFG, bench.test, 1.0, seeds=SEEDS,
                           priors=priors, n_eff=N_EFF)
        assert res.mean_reward / simulator.oracle_reward(bench.test) > 0.94

    def test_quality_monotone_in_budget(self, bench, priors):
        rewards = [evaluate.run(CFG, bench.test, b, seeds=SEEDS,
                                priors=priors, n_eff=N_EFF).mean_reward
                   for b in (1.0e-4, 6.6e-4, 4.0e-3)]
        assert rewards[0] < rewards[1] < rewards[2]

    def test_budget_dial_beats_fixed_llama(self, bench, priors):
        res = evaluate.run(CFG, bench.test, 2.3e-4, seeds=SEEDS,
                           priors=priors, n_eff=N_EFF)
        llama_only = bench.test.rewards[:, 0].mean()
        print(f"budget 2.3e-4: mean reward {res.mean_reward:.6f}, "
              f"llama-only {float(llama_only):.6f}")
        assert res.mean_reward > llama_only + 0.02


class TestCostDrift:
    def test_price_drop_reward_lift_and_recovery(self, bench, priors):
        envs = [simulator.three_phase_stream(
            bench.test,
            lambda e: simulator.with_price_multiplier(e, 2, 1 / 56),
            np.random.default_rng(100 + s), phase_len=304) for s in SEEDS]
        res = evaluate.run(CFG, envs, 3.0e-4, seeds=SEEDS, priors=priors,
                           n_eff=N_EFF, shuffle=False)
        assert res.phase(304, 608).mean_reward > (
            res.phase(0, 304).mean_reward + 0.02)
        assert 0.85 < res.phase(608, 912).compliance(3.0e-4) < 1.15

    def test_no_pacer_ablation_overshoots(self, bench, priors):
        res = evaluate.run(CFG, bench.test, 3.0e-4, seeds=SEEDS,
                           priors=priors, n_eff=N_EFF, pacer_enabled=False)
        assert res.compliance(3.0e-4) > 2.0


class TestQualityDegradation:
    def test_detects_and_reroutes(self, bench, priors):
        envs = [simulator.three_phase_stream(
            bench.test, lambda e: simulator.with_quality_shift(e, 1, 0.75),
            np.random.default_rng(200 + s), phase_len=304) for s in SEEDS]
        res = evaluate.run(CFG, envs, 6.6e-4, seeds=SEEDS, priors=priors,
                           n_eff=N_EFF, shuffle=False)
        m1 = res.phase(0, 304).allocation(3)[1]
        assert res.phase(456, 608).allocation(3)[1] < 0.65 * m1
        r1 = res.phase(0, 304).mean_reward
        assert res.phase(608, 912).mean_reward / r1 > 0.93
        assert 0.8 < res.compliance(6.6e-4) < 1.1


class TestOnboarding:
    def _run(self, bench, priors, scenario, budget):
        env4 = simulator.extend_with_flash(bench.test, scenario)
        s1 = [env4.repeat_to(304, np.random.default_rng(300 + s))
              for s in SEEDS]
        s2 = [env4.repeat_to(608, np.random.default_rng(400 + s))
              for s in SEEDS]
        states = evaluate.make_states(CFG, env4, budget, SEEDS,
                                      priors=list(priors) + [None],
                                      n_eff=N_EFF, active_arms=3)
        _, states = evaluate.run(CFG, s1, budget, seeds=SEEDS, states=states,
                                 shuffle=False, return_states=True)
        states = registry.add_arm(
            CFG, states, 3, float(env4.prices_per_req[3]),
            float(env4.prices_per_1k[3]), forced_exploration=True)
        return evaluate.run(CFG, s2, budget, seeds=SEEDS, states=states,
                            shuffle=False)

    def test_good_cheap_adopted(self, bench, priors):
        res2 = self._run(bench, priors, "good_cheap", 6.6e-4)
        assert (res2.arms[:, 304:] == 3).mean() > 0.02

    def test_bad_cheap_rejected_and_forced_bounded(self, bench, priors):
        res2 = self._run(bench, priors, "bad_cheap", 6.6e-4)
        assert (res2.arms[:, 304:] == 3).mean() < 0.02
        assert (res2.arms[:, :CFG.forced_pulls] == 3).all()
        assert not (res2.arms[:, CFG.forced_pulls:40] == 3).all()

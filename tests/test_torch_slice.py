"""The slice as a whole: ``evaluate.run`` of the port against the JAX
package on one benchmark, the port's simulator against JAX's, hot-swap
onboarding with forced exploration, and the package's isolation from
JAX (checked on the source, not by running it)."""
import ast
import functools
import pathlib

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import evaluate as jev  # noqa: E402
from repro.core import registry as jreg  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro.core.types import RouterConfig as JConfig  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import evaluate, features, registry, simulator  # noqa: E402
from repro_torch.core.types import RouterConfig  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
SPLITS = {"train": 64, "val": 16, "test": 96}
BUDGET, N_EFF, SEEDS = 6.6e-4, 1164.0, (0, 1)


@pytest.fixture(scope="module")
def bench():
    b = jsim.make_benchmark(seed=0, splits=SPLITS)
    priors = jev.fit_warmup_priors(JConfig(), b.train)
    return b, priors


@pytest.mark.parametrize("batch_size", [None, 8])
def test_evaluate_run_matches_jax(bench, batch_size):
    """Arm agreement >= 0.99, mean reward within 1e-3 and compliance
    within 1e-3 relative (the bar of tests/test_kernels.py's fused
    end-to-end run), final statistics within 1e-4 and PRNG keys exact."""
    b, jpriors = bench
    jres, jst = jev.run(JConfig(), b.test, BUDGET, seeds=SEEDS,
                        priors=jpriors, n_eff=N_EFF, batch_size=batch_size,
                        return_states=True)
    env = interop.env_from_numpy(b.test)
    priors = [interop.prior_from_numpy(p, "cpu") for p in jpriors]
    res, st = evaluate.run(RouterConfig(), env, BUDGET, seeds=SEEDS,
                           priors=priors, n_eff=N_EFF, batch_size=batch_size,
                           return_states=True, device="cpu")
    assert res.arms.shape == jres.arms.shape == (2, 96)
    assert (res.arms == jres.arms).mean() >= 0.99
    assert abs(res.mean_reward - jres.mean_reward) < 1e-3
    assert abs(res.compliance(BUDGET) / jres.compliance(BUDGET) - 1) < 1e-3
    got = interop.state_to_numpy(st)
    assert np.array_equal(got["key"], np.asarray(jst.key))
    for n in ("A_inv", "theta"):
        np.testing.assert_allclose(got[n], np.asarray(getattr(jst, n)),
                                   atol=1e-4, rtol=1e-4)


def test_block_runs_full_split_match_jax():
    """Blocks of 256 on the full 1,824-prompt test split, 2 seeds, at both
    paper budgets: the port's fused path (plain versions on the CPU)
    routes as the JAX package does, with equal compliance. It also pins
    why compliance at that block size is far above the budget in both
    packages: the pacer's lam is read once per block, and the block-entry
    lam alternates 0, lambda_bar, 0, ... (a block at lam = 0 has no
    ceiling and overspends, driving lam to lambda_bar within the block;
    the next block under the ceiling c_max / (1 + lambda_bar) underspends
    it back to 0). The ceiling depends on lam and prices, not on the
    budget, so both budgets route alike."""
    b = jsim.make_benchmark(seed=0)
    assert b.test.n == 1824
    jpriors = jev.fit_warmup_priors(JConfig(), b.train)
    env = interop.env_from_numpy(b.test)
    priors = [interop.prior_from_numpy(p, "cpu") for p in jpriors]
    lbar = float(RouterConfig().hyper.lambda_bar)
    arms = []
    for budget in (3.0e-4, 6.6e-4):
        jres = jev.run(JConfig(), b.test, budget, seeds=SEEDS,
                       priors=jpriors, n_eff=N_EFF, batch_size=256)
        res = evaluate.run(RouterConfig(), env, budget, seeds=SEEDS,
                           priors=priors, n_eff=N_EFF, batch_size=256,
                           device="cpu")
        assert (res.arms == jres.arms).mean() >= 0.99
        assert abs(res.mean_reward - jres.mean_reward) < 1e-3
        assert abs(res.compliance(budget) / jres.compliance(budget) - 1) < 1e-3
        entry = np.asarray(res.lams)[:, ::256]
        np.testing.assert_array_equal(entry, np.asarray(jres.lams)[:, ::256])
        np.testing.assert_array_equal(
            entry, np.tile([0.0, lbar], (2, 4)).astype(entry.dtype))
        arms.append(res.arms)
    assert np.array_equal(arms[0], arms[1])


def test_port_priors_match_jax(bench):
    b, jpriors = bench
    priors = evaluate.fit_warmup_priors(
        RouterConfig(), interop.env_from_numpy(b.train), device="cpu")
    for p, jp in zip(priors, jpriors):
        got = interop.prior_to_numpy(p)
        np.testing.assert_allclose(got["A_off"], np.asarray(jp.A_off),
                                   rtol=1e-5)
        np.testing.assert_allclose(got["b_off"], np.asarray(jp.b_off),
                                   rtol=1e-4, atol=1e-4)


def test_simulator_matches_jax(bench):
    """numpy draws are shared, so rewards / costs / prices are equal. The
    whitener's mean and scales agree to 1e-5; applying JAX's fitted
    whitener through the port reproduces JAX's contexts to 1e-5. The
    port's own contexts agree up to each PCA column's sign (SVD sign
    freedom) to 2e-3 only: the two f32 SVDs' right singular vectors
    differ at that level (ROADMAP.md, faults found in the port)."""
    jb = bench[0]
    tb = simulator.make_benchmark(seed=0, splits=SPLITS, device="cpu")
    jw, tw = jb.whitener, tb.whitener
    np.testing.assert_allclose(tw.mean.numpy(), np.asarray(jw.mean),
                               atol=1e-5)
    np.testing.assert_allclose(tw.scale.numpy(), np.asarray(jw.scale),
                               rtol=1e-5)
    carried = features.PCAWhitener(
        *(torch.as_tensor(np.array(a))
          for a in (jw.mean, jw.components, jw.scale)))
    for split in ("train", "val", "test"):
        je, te = getattr(jb, split), getattr(tb, split)
        for n in ("rewards", "costs", "families", "prices_per_req",
                  "prices_per_1k"):
            assert np.array_equal(getattr(te, n), getattr(je, n)), n
        jc, tc = np.asarray(je.contexts), te.contexts
        sign = np.sign((jc * tc).sum(0))
        np.testing.assert_allclose(tc * sign, jc, atol=2e-3)
    raw = np.random.default_rng(1).standard_normal((8, features.RAW_DIM))
    np.testing.assert_allclose(carried(raw).numpy(),
                               np.asarray(jw(raw.astype(np.float32))),
                               atol=1e-5)
    env = simulator.with_price_multiplier(tb.test, 2, 0.1)
    want = jsim.with_price_multiplier(jb.test, 2, 0.1)
    assert np.array_equal(env.costs, want.costs)
    assert simulator.oracle_reward(tb.test) == jsim.oracle_reward(jb.test)


def test_features_and_run_result_match_jax(bench):
    """The hash encoder and the RunResult reductions are host code shared
    verbatim; environments round-trip through interop unchanged."""
    from repro.core import evaluate as jevaluate
    from repro.core import features as jfeatures
    texts = ["solve 2x + 3 = 7 for x", "write a haiku about the sea", ""]
    assert np.array_equal(features.hash_encode_batch(texts),
                          jfeatures.hash_encode_batch(texts))
    rng = np.random.default_rng(3)
    parts = [dict(arms=rng.integers(0, 3, (2, n)),
                  rewards=rng.uniform(0, 1, (2, n)),
                  costs=rng.uniform(0, 1e-3, (2, n)),
                  lams=rng.uniform(0, 1, (2, n))) for n in (5, 7)]
    got = evaluate.RunResult.concat([evaluate.RunResult(**p) for p in parts])
    want = jevaluate.RunResult.concat([jevaluate.RunResult(**p)
                                       for p in parts])
    assert got.bounds == want.bounds == (0, 5, 12)
    for r, w in ((got, want), (got.segment(1), want.segment(1)),
                 (got.phase(3, 9), want.phase(3, 9))):
        assert r.bounds == w.bounds
        assert r.mean_reward == w.mean_reward
        assert r.compliance(6.6e-4) == w.compliance(6.6e-4)
        assert np.array_equal(r.allocation(3), w.allocation(3))
    env = bench[0].test
    back = interop.env_to_numpy(interop.env_from_numpy(env))
    for n, v in back.items():
        assert np.array_equal(np.asarray(v), np.asarray(getattr(env, n))), n


def test_onboarding_forced_exploration(bench):
    """Hot-swap a 4th arm (bad_cheap Flash) into slot 3 mid-run: exactly
    the first ``forced_pulls`` requests go to the newcomer, as in
    tests/test_paper_claims.py, and the arms match JAX."""
    b, jpriors = bench
    env4 = jsim.extend_with_flash(b.test, "bad_cheap", seed=0)
    s1, s2 = env4.subset(np.arange(48)), env4.subset(np.arange(48, 96))
    jcfg = JConfig()
    jst = jev.make_states(jcfg, env4, BUDGET, SEEDS, priors=jpriors + [None],
                          n_eff=N_EFF, active_arms=3)
    _, jst = jev.run(jcfg, s1, BUDGET, seeds=SEEDS, states=jst,
                     shuffle=False, return_states=True)
    add = functools.partial(
        jreg.add_arm, jcfg, slot=3,
        price_per_req=float(env4.prices_per_req[3]),
        price_per_1k=float(env4.prices_per_1k[3]),
        n_eff=None, forced_exploration=True)
    jst = jax.vmap(add)(jst)
    jres = jev.run(jcfg, s2, BUDGET, seeds=SEEDS, states=jst, shuffle=False)

    cfg = RouterConfig()
    t1, t2 = interop.env_from_numpy(s1), interop.env_from_numpy(s2)
    priors = [interop.prior_from_numpy(p, "cpu") for p in jpriors] + [None]
    st = evaluate.make_states(cfg, interop.env_from_numpy(env4), BUDGET,
                              SEEDS, priors=priors, n_eff=N_EFF,
                              active_arms=3, device="cpu")
    _, st = evaluate.run(cfg, t1, BUDGET, seeds=SEEDS, states=st,
                         shuffle=False, return_states=True)
    assert registry.free_slot(st) == 3
    st = registry.add_arm(cfg, st, 3, float(env4.prices_per_req[3]),
                          float(env4.prices_per_1k[3]),
                          forced_exploration=True)
    res = evaluate.run(cfg, t2, BUDGET, seeds=SEEDS, states=st,
                       shuffle=False)
    assert (res.arms[:, :cfg.forced_pulls] == 3).all()
    assert not (res.arms[:, cfg.forced_pulls:40] == 3).all()
    assert (res.arms == jres.arms).mean() >= 0.99


def test_run_raises_without_gpu(bench, monkeypatch):
    """Entry points run on the card unless asked for the CPU: with no
    GPU and no ``device=``, they raise instead of falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    env = interop.env_from_numpy(bench[0].test)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate.run(RouterConfig(), env, BUDGET, seeds=SEEDS)
    with pytest.raises(RuntimeError):
        evaluate.make_states(RouterConfig(), env, BUDGET, SEEDS)
    with pytest.raises(RuntimeError):
        simulator.make_benchmark(seed=0, splits=SPLITS)


def test_tenant_runs_not_ported(bench):
    """Tenant runs are not ported to the kernels: on the default
    ``fused`` backend they raise, as JAX's Pallas kernels do. On
    ``torch`` the slice's tenant run matches JAX's ``jnp`` one: arms,
    rewards and costs identical, lams and the final table within 1e-4,
    pulls equal."""
    from repro.core import tenancy as jten
    from repro_torch.core import tenancy

    env = interop.env_from_numpy(bench[0].test)
    tids = np.random.default_rng(3).integers(0, 3, env.n).astype(np.int32)
    budgets = (3.0e-4, 6.6e-4, 1.0e-3)
    table = tenancy.make_table(budgets, device="cpu")
    with pytest.raises(NotImplementedError):
        evaluate.run(RouterConfig(), env, BUDGET, seeds=SEEDS,
                     batch_size=8, tenants=table, tenant_ids=tids,
                     device="cpu")
    res, st = evaluate.run(RouterConfig(backend="torch"), env, BUDGET,
                           seeds=SEEDS, batch_size=8, tenants=table,
                           tenant_ids=tids, return_states=True, device="cpu")
    jres, jst = jev.run(JConfig(), bench[0].test, BUDGET, seeds=SEEDS,
                        batch_size=8, tenants=jten.make_table(budgets),
                        tenant_ids=tids, return_states=True)
    for f in ("arms", "rewards", "costs"):
        assert np.array_equal(getattr(res, f), np.asarray(getattr(jres, f)))
    np.testing.assert_allclose(res.lams, np.asarray(jres.lams), atol=1e-4)
    for n in ("lam", "c_ema"):
        np.testing.assert_allclose(getattr(st.tenants, n).numpy(),
                                   np.asarray(getattr(jst.tenants, n)),
                                   atol=1e-4)
    assert np.array_equal(st.tenants.pulls.numpy(),
                          np.asarray(jst.tenants.pulls))


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)

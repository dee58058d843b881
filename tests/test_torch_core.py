"""The port's linucb / pacer / warmup / registry / types against the JAX
package, function by function, on a stack of states: floats within
``EQUIV_TOL = 1e-4``, masks and integers exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import linucb as jlin  # noqa: E402
from repro.core import pacer as jpacer  # noqa: E402
from repro.core import registry as jreg  # noqa: E402
from repro.core import warmup as jwarm  # noqa: E402
from repro.core.types import (  # noqa: E402
    HyperParams as JHyper, PacerState as JPacer,
    RouterConfig as JConfig, init_state as jinit,
)
from repro_torch import interop  # noqa: E402
from repro_torch.core import linucb, pacer, registry, types, warmup  # noqa: E402
from repro_torch.core.types import HyperParams, PacerState, RouterConfig  # noqa: E402

TOL = 1e-4
S, K, D = 3, 4, 6
GAMMAS = (0.997, 0.9, 1.0)


def _cfgs(**kw):
    return RouterConfig(d=D, max_arms=K, **kw), JConfig(d=D, max_arms=K, **kw)


def _hyper(gammas=GAMMAS):
    """Per-state hyper leaves: the port's (S,) and JAX's per state."""
    port = HyperParams(gamma=torch.tensor(gammas)).as_leaves(S, "cpu")
    return port, [JHyper(gamma=g).as_leaves() for g in gammas]


def _spd(rng, *lead, d=D):
    M = rng.standard_normal(lead + (d, d)) * 0.2
    A = np.einsum("...ij,...kj->...ik", M, M) + np.eye(d) * 1.3
    return A.astype(np.float32), np.linalg.inv(A).astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=tol, rtol=tol)


class TestLinUCB:
    def test_forgetting_and_inflation(self):
        tcfg, jcfg = _cfgs(dt_max=100)
        hp, jhp = _hyper()
        dt = np.array([[0, 1, 50, 4000]] * S, np.int32)
        dt[1] = [-3, 7, 100, 101]
        got_g = linucb.forgetting_factor(tcfg, hp, _t(dt, torch.int32))
        got_i = linucb.staleness_inflation(tcfg, hp, _t(dt, torch.int32))
        for s in range(S):
            _close(got_g[s], jlin.forgetting_factor(jcfg, jhp[s], dt[s]))
            _close(got_i[s], jlin.staleness_inflation(jcfg, jhp[s], dt[s]))
        assert torch.all(got_g[:, 0][dt[:, 0] == 0] == 1.0)   # g(0) == 1 exactly

    def test_rank1_update(self):
        tcfg, jcfg = _cfgs()
        hp, jhp = _hyper()
        rng = np.random.default_rng(1)
        A, A_inv = _spd(rng, S)
        b = rng.standard_normal((S, D)).astype(np.float32)
        x = rng.standard_normal((S, D)).astype(np.float32)
        r = rng.uniform(0, 1, S).astype(np.float32)
        dt = np.array([0, 5, 9000], np.int32)
        got = linucb.rank1_update(tcfg, hp, _t(A), _t(A_inv), _t(b), _t(x),
                                  _t(r), _t(dt, torch.int32))
        for s in range(S):
            want = jlin.rank1_update(jcfg, jhp[s], A[s], A_inv[s], b[s], x[s],
                                     r[s], dt[s])
            for g, w in zip(got, want):
                _close(g[s], w)
        _close(linucb.sherman_morrison(_t(A_inv), _t(x))[0],
               jlin.sherman_morrison(A_inv[0], x[0]))

    def test_ucb_scores(self):
        tcfg, jcfg = _cfgs()
        hp, jhp = _hyper()
        rng = np.random.default_rng(2)
        _, A_inv = _spd(rng, S, K)
        theta = (rng.standard_normal((S, K, D)) * 0.3).astype(np.float32)
        c_tilde = rng.uniform(0, 1, (S, K)).astype(np.float32)
        X = rng.standard_normal((S, 5, D)).astype(np.float32)
        dt = rng.integers(0, 300, (S, K)).astype(np.int32)
        lam = np.array([0.0, 0.4, 2.0], np.float32)
        got = linucb.ucb_scores_batch(tcfg, hp, _t(theta), _t(A_inv),
                                      _t(c_tilde), _t(X),
                                      _t(dt, torch.int32), _t(lam))
        one = linucb.ucb_scores(tcfg, hp, _t(theta), _t(A_inv), _t(c_tilde),
                                _t(X[:, 0]), _t(dt, torch.int32), _t(lam))
        for s in range(S):
            _close(got[s], jlin.ucb_scores_batch(
                jcfg, jhp[s], theta[s], A_inv[s], c_tilde[s], X[s], dt[s],
                lam[s]))
            _close(one[s], jlin.ucb_scores(
                jcfg, jhp[s], theta[s], A_inv[s], c_tilde[s], X[s, 0], dt[s],
                lam[s]))


def _pacers(lam, c_ema, budget, enabled):
    port = PacerState(lam=_t(lam), c_ema=_t(c_ema), budget=_t(budget),
                      enabled=_t(enabled, torch.bool))
    jax_ = [JPacer(lam=jnp.float32(lam[s]), c_ema=jnp.float32(c_ema[s]),
                   budget=jnp.float32(budget[s]),
                   enabled=jnp.asarray(enabled[s])) for s in range(S)]
    return port, jax_


class TestPacer:
    def test_update_and_block_fold(self):
        hp, jhp = _hyper()
        p, jp = _pacers([0.0, 0.3, 4.99], [6e-4, 1e-3, 5e-3],
                        [6.6e-4, 3e-4, 1e-3], [True, True, False])
        rng = np.random.default_rng(3)
        costs = rng.uniform(0, 4e-3, (S, 40)).astype(np.float32)
        one = pacer.pacer_update(hp, p, _t(costs[:, 0]))
        got = pacer.pacer_update_batch(hp, p, _t(costs))
        for s in range(S):
            w1 = jpacer.pacer_update(jhp[s], jp[s], costs[s, 0])
            w = jpacer.pacer_update_batch(jhp[s], jp[s], costs[s])
            _close(one.lam[s], w1.lam, 1e-6)
            _close(got.lam[s], w.lam, 1e-6)
            _close(got.c_ema[s], w.c_ema, 1e-9)
        assert got.lam[2] == p.lam[2] and got.c_ema[2] == p.c_ema[2]

    def test_fold_is_sequential_not_associative(self):
        """The block fold equals the step-by-step loop, and differs from
        summing the block's dual gradients before one clip: lambda sits
        on its floor through the cheap half, so the per-step clip is not
        associative."""
        hp, _ = _hyper()
        p, _ = _pacers([0.0] * S, [1e-3] * S, [1e-3] * S, [True] * S)
        costs = _t(np.tile(np.r_[np.zeros(40), np.full(20, 5e-3)], (S, 1)))
        seq, grads = p, []
        for i in range(costs.shape[1]):
            seq = pacer.pacer_update(hp, seq, costs[:, i])
            grads.append(hp.eta * (seq.c_ema / seq.budget - 1.0))
        got = pacer.pacer_update_batch(hp, p, costs)
        assert torch.equal(got.lam, seq.lam)
        assert torch.equal(got.c_ema, seq.c_ema)
        one_clip = torch.clamp(p.lam + sum(grads), 0.0, 5.0)
        assert torch.all((one_clip - got.lam).abs() > 0.5)

    @pytest.mark.parametrize("case", ["open", "ceiling", "empty", "disabled"])
    def test_hard_ceiling_mask(self, case):
        price = np.array([[1e-5, 5e-4, 1.5e-2, 1e9]] * S, np.float32)
        active = np.array([[1, 1, 1, 0]] * S, bool)
        lam = {"open": [0.0] * S, "ceiling": [0.5, 2.0, 5.0],
               "empty": [0.5, 2.0, 5.0], "disabled": [3.0] * S}[case]
        if case == "empty":     # every active arm above its ceiling
            price = np.array([[2e-2, 2.1e-2, 2.2e-2, 1e9],
                              [3e-2, 3e-2, 3e-2, 1e9],     # tie: lowest slot
                              [5e-2, 4e-2, 4.5e-2, 1e9]], np.float32)
        enabled = [case != "disabled"] * S
        p, jp = _pacers(lam, [0.0] * S, [1.0] * S, enabled)
        got = pacer.hard_ceiling_mask(p, _t(price), _t(active, torch.bool))
        for s in range(S):
            want = jpacer.hard_ceiling_mask(jp[s], price[s], active[s])
            assert np.array_equal(got[s].numpy(), np.asarray(want))
        if case == "empty":
            assert got.sum(-1).tolist() == [1, 1, 1]

    def test_budget_validation(self):
        p, _ = _pacers([0.0] * S, [1e-3] * S, [1e-3] * S, [True] * S)
        with pytest.raises(ValueError):
            pacer.set_budget(p, 0.0)
        assert torch.all(pacer.set_budget(p, 2e-3).budget == 2e-3)


def _jax_prior(rng, n=40):
    xs = rng.standard_normal((n, D)).astype(np.float32)
    xs[:, -1] = 1.0
    rs = rng.uniform(0, 1, n).astype(np.float32)
    return xs, rs


class TestWarmupRegistry:
    def test_fit_scale_apply(self):
        tcfg, jcfg = _cfgs()
        rng = np.random.default_rng(4)
        xs, rs = _jax_prior(rng)
        jp = jwarm.fit_offline_prior(jnp.asarray(xs), jnp.asarray(rs))
        tp = warmup.fit_offline_prior(_t(xs), _t(rs))
        _close(tp.A_off, jp.A_off)
        _close(tp.b_off, jp.b_off)
        hp, jhp = _hyper()
        A, b = warmup.scale_prior(tcfg, hp, tp, 300.0)
        prices = np.linspace(1e-4, 1e-2, K).astype(np.float32)
        st = types.init_state(tcfg, prices, prices, 1e-3, num_states=S,
                              hyper=HyperParams(gamma=torch.tensor(GAMMAS)),
                              device="cpu")
        st = warmup.apply_warmup(tcfg, st, [tp, None, tp], 300.0)
        for s in range(S):
            jA, jb = jwarm.scale_prior(jcfg, jhp[s], jp, 300.0)
            _close(A[s], jA)
            _close(b[s], jb)
            js = jwarm.apply_warmup(
                jcfg, jinit(jcfg, prices, prices, 1e-3, hyper=JHyper(
                    gamma=GAMMAS[s])), [jp, None, jp], 300.0)
            for n in ("A", "A_inv", "b", "theta"):
                _close(getattr(st, n)[s], getattr(js, n))
        for g in (0.9, 0.997, 1.0):
            assert warmup.t_adapt_to_n_eff(500, g) == jwarm.t_adapt_to_n_eff(500, g)
            assert warmup.n_eff_to_t_adapt(900, g) == jwarm.n_eff_to_t_adapt(900, g)

    @pytest.mark.parametrize("init", ["cold", "heuristic", "prior"])
    def test_add_delete_set_price(self, init):
        tcfg, jcfg = _cfgs()
        rng = np.random.default_rng(5)
        xs, rs = _jax_prior(rng)
        jp = jwarm.fit_offline_prior(jnp.asarray(xs), jnp.asarray(rs))
        kw = {"cold": dict(), "heuristic": dict(n_eff=50.0, bias_reward=0.7),
              "prior": dict(n_eff=80.0)}[init]
        prices = np.linspace(1e-4, 1e-2, K).astype(np.float32)
        active = np.array([1, 1, 0, 0], bool)
        js = jinit(jcfg, prices, prices, 1e-3, active=active)
        js = dataclasses.replace(js, t=jnp.int32(17))
        ts = interop.state_from_numpy(js, "cpu")
        jprior = jp if init == "prior" else None
        tprior = (interop.prior_from_numpy(jp, "cpu")
                  if init == "prior" else None)
        assert registry.free_slot(ts) == jreg.free_slot(js) == 2
        js = jreg.add_arm(jcfg, js, 2, 2e-3, 1.4e-3, prior=jprior, **kw)
        ts = registry.add_arm(tcfg, ts, 2, 2e-3, 1.4e-3, prior=tprior, **kw)
        js = jreg.set_price(jcfg, js, 1, 7e-4, 9e-4)
        ts = registry.set_price(tcfg, ts, 1, 7e-4, 9e-4)
        _check_state(ts, js)
        assert int(registry.num_active(ts)[0]) == jreg.num_active(js) == 3
        js = jreg.delete_arm(jcfg, js, 2)
        ts = registry.delete_arm(tcfg, ts, 2)
        _check_state(ts, js)


EXACT = ("last_upd", "last_play", "active", "t", "force_arm", "force_left",
         "key")


def _check_state(ts, js, tol=TOL):
    """Port state (S = 1 or the stack of a seed-stacked JAX state) against
    the JAX state: integer leaves exact, floats within ``tol``."""
    got = interop.state_to_numpy(ts, stacked=np.asarray(js.A).ndim == 4)
    for n in EXACT:
        assert np.array_equal(got[n], np.asarray(getattr(js, n))), n
    for n in ("A", "A_inv", "b", "theta", "price", "c_tilde"):
        _close(got[n], getattr(js, n), tol)
    for n in ("lam", "c_ema", "budget"):
        _close(got["pacer"][n], getattr(js.pacer, n), tol)
    assert np.array_equal(got["pacer"]["enabled"], np.asarray(js.pacer.enabled))


class TestTypes:
    def test_init_state_matches(self):
        tcfg, jcfg = _cfgs()
        prices = np.array([1e-5, 5e-4, 1.5e-2, 1e9], np.float32)
        js = jinit(jcfg, prices, prices * 2, 6.6e-4,
                   active=np.array([1, 1, 1, 0], bool),
                   key=jax.random.PRNGKey(9), pacer_enabled=False)
        from repro_torch.core import prng
        ts = types.init_state(tcfg, prices, prices * 2, 6.6e-4,
                              active=np.array([1, 1, 1, 0], bool),
                              key=prng.PRNGKey(9)[None], pacer_enabled=False,
                              device="cpu")
        _check_state(ts, js)
        rt = interop.state_from_numpy(interop.state_to_numpy(ts), "cpu")
        _check_state(rt, js, 0.0)

    def test_validation_and_partition(self):
        types.validate_leaf_partition()
        with pytest.raises(ValueError):
            RouterConfig(backend="jnp")
        with pytest.raises(ValueError):
            RouterConfig(hyper=HyperParams(gamma=1.5))
        with pytest.raises(ValueError):
            HyperParams(c_floor=0.2, c_ceil=0.1).validate()
        assert RouterConfig().backend == "fused"

    def test_entry_points_raise_without_gpu(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            types.resolve_device(None)
        with pytest.raises(RuntimeError):
            types.init_state(RouterConfig(d=3, max_arms=2), [1.0, 2.0],
                             [1.0, 2.0], 1.0)
        assert types.resolve_device("cpu").type == "cpu"


def test_knee_matches_jax_package():
    from repro.core import knee as jknee
    from repro_torch.core import knee
    rng = np.random.default_rng(6)
    for _ in range(5):
        pts = rng.uniform(0, 1, (12, 2))
        assert knee.knee_point(pts) == jknee.knee_point(pts)
        assert np.array_equal(knee.pareto_frontier(pts),
                              jknee.pareto_frontier(pts))
        c, q = rng.uniform(1e-4, 1e-2, 7), rng.uniform(0.7, 0.95, 7)
        assert knee.auc_of_frontier(c, q) == jknee.auc_of_frontier(c, q)

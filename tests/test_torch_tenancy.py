"""The port's tenant plane (``repro_torch.core.tenancy`` and DESIGN.md
§15 through the router, evaluate, scenario, sweep, the gateway and
snapshot persistence) against the JAX package's ``jnp`` tenant path on
the CPU, class by class the twin of ``tests/test_tenancy.py``.

Bars: arms, rewards and costs identical to JAX's; tenant ``lam`` /
``c_ema`` within ``EQUIV_TOL`` = 1e-4 and ``pulls`` equal; inside the
port bit for bit: the fold against the grouped single-tenant folds,
``spend`` against arrival-order numpy f32 adds, per-row scores against
whole-block scores, a tenant grid against its looped runs (chunked and
split over devices too); the four tenant streams bitwise equal to JAX's;
decay composition and save -> restore within 1e-6; snapshots cross-load
between the packages. The JAX runs are shared through module fixtures.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import evaluate as jev  # noqa: E402
from repro.core import router as jrouter  # noqa: E402
from repro.core import scenario as jsc  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro.core import statehandle as jsh  # noqa: E402
from repro.core import sweep as jsweep  # noqa: E402
from repro.core import tenancy as jten  # noqa: E402
from repro.core.types import HyperParams as JHyper  # noqa: E402
from repro.core.types import RouterConfig as JConfig  # noqa: E402
from repro.core.types import init_state as jinit  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.serving.gateway import MicroBatcher as JBatcher  # noqa: E402
from repro.serving.gateway import RouterGateway as JGateway  # noqa: E402
from repro.serving.telemetry import Telemetry as JTelemetry  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import evaluate, linucb, pacer, router  # noqa: E402
from repro_torch.core import scenario, statehandle, sweep, tenancy  # noqa: E402
from repro_torch.core import types as types_lib  # noqa: E402
from repro_torch.core.backend import EQUIV_TOL  # noqa: E402
from repro_torch.core.types import HyperParams, RouterConfig  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.serving.gateway import MicroBatcher, RouterGateway  # noqa: E402
from repro_torch.serving.telemetry import Telemetry  # noqa: E402

# The router-level twin of tests/test_tenancy.py (d 8, 4 slots, 3 active).
D, K = 8, 4
CFG = RouterConfig(d=D, max_arms=K, forced_pulls=0, backend="torch")
JCFG = JConfig(d=D, max_arms=K, forced_pulls=0)
PRICES = (1e-4, 3e-4, 1e-3, 1e9)
ACTIVE = (1, 1, 1, 0)
BUDGETS = (2.0e-4, 3.0e-4, 4.5e-4, 6.0e-4)
ROUND_TRIP_TOL = 1e-6

# The closed-loop runs: bench_tenants.py's test bed (its 10x price
# spread, alpha 0.01, gamma 0.997, no forced pulls, fitted priors, its
# flash-crowd mix) cut to 256 requests, 2 seeds and blocks of 32, with
# the T = 4 budgets scaled x3 so the short stream still paces.
SPLITS = {"train": 64, "val": 16, "test": 256}
SEEDS, N_EFF, L, BS, T4 = (0, 1), 1164.0, 256, 32, 4
RUN_BUDGETS = np.array([1.8e-4, 2.1e-4, 2.4e-4, 2.8e-4], np.float32) * 3
SCALES = (1.0, 1.25, 1.5)
HYPER = dict(alpha=0.01, gamma=0.997)
RCFG = RouterConfig(max_arms=4, forced_pulls=0, backend="torch",
                    hyper=HyperParams(**HYPER))
JRCFG = JConfig(max_arms=4, forced_pulls=0, hyper=JHyper(**HYPER))


def _f32(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def mk_jstate(tenants=None, seed=0):
    prices = jnp.asarray(PRICES, jnp.float32)
    return jinit(JCFG, prices, prices, 1.0,
                 active=jnp.asarray(ACTIVE, bool),
                 key=jax.random.PRNGKey(seed), tenants=tenants)


def mk_state(tenants=None, seed=0, num_states=1, budget=1.0):
    from repro_torch.core import prng

    return types_lib.init_state(
        CFG, np.asarray(PRICES, np.float32), np.asarray(PRICES, np.float32),
        budget, active=np.asarray(ACTIVE, bool), num_states=num_states,
        key=prng.PRNGKey(seed, device="cpu").expand(num_states, 2),
        tenants=tenants, device="cpu")


def mk_table(budgets=BUDGETS):
    return tenancy.make_table(budgets, device="cpu")


def rand_block(B, d=D, seed=0, T=4):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((B, d)).astype(np.float32)
    r = rng.uniform(0.2, 0.9, B).astype(np.float32)
    c = rng.uniform(1e-5, 8e-4, B).astype(np.float32)
    tids = rng.integers(0, T, B).astype(np.int32)
    return X, r, c, tids


def _table_np(tab):
    """A port or JAX table's leaves as numpy."""
    return {n: np.asarray(getattr(tab, n)) for n in tenancy.LEAVES}


def _check_table(got, want, tol=EQUIV_TOL):
    """Tenant lam / c_ema within ``tol``, pulls and budgets equal, spend
    within ``tol``."""
    g, w = _table_np(got), _table_np(want)
    for n in ("lam", "c_ema", "spend"):
        np.testing.assert_allclose(g[n], w[n], atol=tol, rtol=tol,
                                   err_msg=n)
    for n in ("pulls", "budget", "enabled"):
        assert np.array_equal(g[n], w[n]), n


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


class TestTenantTable:
    def test_make_table_shapes_and_init(self):
        tab = mk_table()
        assert tenancy.num_tenants(tab) == 4
        want = _table_np(jten.make_table(BUDGETS))
        got = _table_np(tab)
        for n in tenancy.LEAVES:
            assert got[n].dtype == want[n].dtype, n
            assert np.array_equal(got[n], want[n]), n

    @pytest.mark.parametrize("budgets", [[1e-4, 0.0, 2e-4], [1e-4, -3.0],
                                         [[1e-4]], []])
    def test_make_table_rejects_like_jax(self, budgets):
        with pytest.raises(ValueError) as jerr:
            jten.make_table(budgets)
        with pytest.raises(ValueError) as err:
            tenancy.make_table(budgets, device="cpu")
        assert str(err.value) == str(jerr.value)

    def test_set_tenant_budget_validates(self):
        tab = mk_table()
        tab2 = tenancy.set_tenant_budget(tab, 1, 9e-4)
        assert float(tab2.budget[1]) == np.float32(9e-4)
        assert float(tab.budget[1]) == np.float32(BUDGETS[1])
        with pytest.raises(ValueError):
            tenancy.set_tenant_budget(tab, 1, 0.0)

    def test_stack_tables_requires_equal_T(self):
        with pytest.raises(ValueError):
            tenancy.stack_tables([mk_table(), mk_table(BUDGETS[:3])])
        st = tenancy.stack_tables([mk_table(), mk_table()])
        assert all(getattr(st, n).shape == (2, 4) for n in tenancy.LEAVES)

    def test_init_state_stacks_the_table(self):
        """A (T,) table is copied into every state, an (S, T) one is
        taken row per state; both leave the portfolio pacer alone."""
        shared = mk_state(mk_table(), num_states=3)
        per = mk_state(tenancy.stack_tables([mk_table(), mk_table()]),
                       num_states=2)
        assert shared.tenants.lam.shape == (3, 4)
        assert per.tenants.budget.shape == (2, 4)
        assert float(shared.pacer.budget[0]) == 1.0
        with pytest.raises(ValueError, match="per-state"):
            mk_state(tenancy.stack_tables([mk_table()] * 2), num_states=3)

    def test_leaf_planes_carry_the_table(self):
        types_lib.validate_leaf_partition()
        assert "tenants" in types_lib.LEARN_LEAVES
        a = mk_state(mk_table(), num_states=2)
        b = dataclasses.replace(a, tenants=dataclasses.replace(
            a.tenants, pulls=a.tenants.pulls + 5))
        assert types_lib.merge_learn_leaves(a, b).tenants is b.tenants
        mixed = types_lib.state_where(torch.tensor([True, False]), b, a)
        assert mixed.tenants.pulls[:, 0].tolist() == [5, 0]
        cat = types_lib.state_concat([types_lib.state_slice(b, 1, 2),
                                      types_lib.state_slice(a, 0, 1)])
        assert cat.tenants.pulls[:, 0].tolist() == [5, 0]
        plain = mk_state()
        assert types_lib.state_slice(plain, 0, 1).tenants is None

    def test_interop_carries_the_table(self):
        js = mk_jstate(jten.make_table(BUDGETS))
        st = interop.state_from_numpy(js, "cpu")
        assert st.tenants.pulls.dtype == torch.int32
        back = interop.state_to_numpy(st, stacked=False)
        for n in tenancy.LEAVES:
            want = np.asarray(getattr(js.tenants, n))
            assert back["tenants"][n].dtype == want.dtype, n
            assert np.array_equal(back["tenants"][n], want), n
        assert "tenants" not in interop.state_to_numpy(mk_state())


class TestFoldAndGather:
    def test_tenant_fold_matches_grouped_single_tenant_folds(self):
        """The §15 contract in the port, S = 2 states with their own
        streams: the interleaved fold == grouping each state's block by
        tenant and folding each group through ``pacer_update_batch`` in
        arrival order, bit for bit; spend == the arrival-order f32 adds."""
        hp = HyperParams().as_leaves(2, "cpu")
        tab = tenancy.expand(mk_table(), 2)
        blocks = [rand_block(96, seed=3 + s) for s in range(2)]
        costs = np.stack([b[2] for b in blocks])
        tids = np.stack([b[3] for b in blocks])
        out = tenancy.tenant_fold(hp, tab, torch.as_tensor(tids),
                                  _f32(costs))
        for s in range(2):
            hp1 = HyperParams().as_leaves(1, "cpu")
            for j in range(4):
                cs = costs[s][tids[s] == j]
                row = tenancy.table_row(types_lib.map_leaves(
                    lambda a: a[s:s + 1], tab), j)
                ref = pacer.pacer_update_batch(hp1, row, _f32(cs)[None])
                assert out.lam[s, j].item() == ref.lam.item(), (s, j)
                assert out.c_ema[s, j].item() == ref.c_ema.item(), (s, j)
                assert int(out.pulls[s, j]) == len(cs)
                spend = np.float32(0.0)
                for c in cs:
                    spend = np.float32(spend + c)
                assert out.spend[s, j].item() == spend, (s, j)

    def test_tenant_fold_matches_jax(self):
        hp = HyperParams()
        _X, _r, costs, tids = rand_block(96, seed=3)
        want = jten.tenant_fold(JHyper(), jten.make_table(BUDGETS),
                                jnp.asarray(tids), jnp.asarray(costs))
        got = tenancy.tenant_fold(hp.as_leaves(1, "cpu"),
                                  tenancy.expand(mk_table(), 1),
                                  torch.as_tensor(tids)[None],
                                  _f32(costs)[None])
        _check_table(types_lib.map_leaves(lambda a: a[0], got), want)

    def test_gather_rows_views(self):
        tab = tenancy.expand(mk_table(), 2)
        rows = tenancy.gather_rows(tab, torch.tensor([[2, 0, 2], [1, 1, 3]]))
        assert rows.budget.shape == (2, 3)
        np.testing.assert_array_equal(
            rows.budget[0].numpy(),
            np.asarray([BUDGETS[2], BUDGETS[0], BUDGETS[2]], np.float32))

    def test_per_row_scores_equal_whole_block_scores(self):
        """Row b under per-row duals == the whole block scored under
        ``lam[:, b]``, bit for bit."""
        rng = np.random.default_rng(5)
        S, B = 2, 6
        hp = HyperParams().as_leaves(S, "cpu")
        theta = _f32(rng.standard_normal((S, K, D)) * 0.1)
        M = rng.standard_normal((S, K, D, D)) * 0.1
        A_inv = _f32(np.linalg.inv(
            np.einsum("skij,sklj->skil", M, M) + np.eye(D)))
        c_tilde = _f32(rng.uniform(0, 1, (S, K)))
        X = _f32(rng.standard_normal((S, B, D)))
        dt = torch.as_tensor(rng.integers(0, 9, (S, K)), dtype=torch.int32)
        lams = _f32(rng.uniform(0, 2, (S, B)))
        rows = linucb.ucb_scores_batch(CFG, hp, theta, A_inv, c_tilde, X,
                                       dt, lams)
        for b in range(B):
            whole = linucb.ucb_scores_batch(CFG, hp, theta, A_inv, c_tilde,
                                            X, dt, lams[:, b])
            assert torch.equal(rows[:, b], whole[:, b]), b

    def test_single_tenant_mode_matches_scalar_path_arms(self):
        """All rows on tenant 0 with row 0 mirroring the portfolio pacer
        => identical arm choices to the scalar (non-tenant) path."""
        budget = 3.0e-4
        st_t = mk_state(mk_table((budget,) * 4), budget=budget)
        st_s = mk_state(budget=budget)
        X, _r, _c, _t = rand_block(32, seed=9)
        dec_t, _ = router.select_batch(CFG, st_t, _f32(X)[None],
                                       torch.zeros((1, 32), dtype=torch.long))
        dec_s, _ = router.select_batch(CFG, st_s, _f32(X)[None])
        assert torch.equal(dec_t.arms, dec_s.arms)
        assert dec_t.row_lams is not None and dec_s.row_lams is None
        assert dec_t.candidates.shape == (1, 32, K)

    def test_update_batch_folds_only_tenant_table(self):
        st = mk_state(mk_table())
        X, r, c, tids = rand_block(16, seed=1)
        out = router.update_batch(
            CFG, st, torch.zeros((1, 16), dtype=torch.int32), _f32(X)[None],
            _f32(r)[None], _f32(c)[None], torch.as_tensor(tids)[None])
        assert torch.equal(out.pacer.lam, st.pacer.lam)
        assert torch.equal(out.pacer.c_ema, st.pacer.c_ema)
        assert int(out.tenants.pulls.sum()) == 16

    def test_tenant_mode_requires_table_and_torch_backend(self):
        """No table: JAX's ValueError. A kernel backend: JAX's
        NotImplementedError, on every entry point of the block."""
        X, r, c, tids = rand_block(8)
        Xt, tt = _f32(X)[None], torch.as_tensor(tids)[None]
        with pytest.raises(ValueError, match="tenant"):
            router.select_batch(CFG, mk_state(), Xt, tt)
        st = mk_state(mk_table())
        R = _f32(np.tile(r[:, None], (1, K)))[None]
        C = _f32(np.tile(c[:, None], (1, K)))[None]
        for backend in ("score", "fused"):
            cfg = dataclasses.replace(CFG, backend=backend)
            with pytest.raises(NotImplementedError, match="backend='torch'"):
                router.select_batch(cfg, st, Xt, tt)
            with pytest.raises(NotImplementedError, match="tenant"):
                router.step_batch(cfg, st, Xt, R, C, tt)
            with pytest.raises(NotImplementedError, match="tenant"):
                router.update_batch(cfg, st, torch.zeros_like(tt), Xt,
                                    R[..., 0], C[..., 0], tt)

    def test_select_and_update_blocks_match_jax(self):
        """Three blocks of select + feedback through both packages' tenant
        paths from one state: arms identical, the table within 1e-4."""
        js = mk_jstate(jten.make_table(BUDGETS))
        st = interop.state_from_numpy(js, "cpu")
        for i in range(3):
            X, r, c, tids = rand_block(16, seed=20 + i)
            jdec, js = jrouter.select_batch(JCFG, js, jnp.asarray(X),
                                            jnp.asarray(tids))
            dec, st = router.select_batch(CFG, st, _f32(X)[None],
                                          torch.as_tensor(tids)[None])
            assert dec.arms[0].tolist() == np.asarray(jdec.arms).tolist()
            np.testing.assert_allclose(dec.row_lams[0].numpy(),
                                       np.asarray(jdec.row_lams),
                                       atol=EQUIV_TOL)
            js = jrouter.update_batch(JCFG, js, jdec.arms, jnp.asarray(X),
                                      jnp.asarray(r), jnp.asarray(c),
                                      jnp.asarray(tids))
            st = router.update_batch(CFG, st, dec.arms, _f32(X)[None],
                                     _f32(r)[None], _f32(c)[None],
                                     torch.as_tensor(tids)[None])
        _check_table(types_lib.map_leaves(lambda a: a[0], st.tenants),
                     js.tenants)
        assert float(st.pacer.lam[0]) == float(js.pacer.lam)


class TestDecayTable:
    def _folded(self):
        hp = HyperParams().as_leaves(1, "cpu")
        _X, _r, c, tids = rand_block(64, seed=4)
        return hp, tenancy.tenant_fold(hp, tenancy.expand(mk_table(), 1),
                                       torch.as_tensor(tids)[None],
                                       _f32(c)[None])

    def test_two_stage_composition_matches_one_stage(self):
        hp, tab = self._folded()
        one = tenancy.decay_table(CFG, hp, tab, 30)
        two = tenancy.decay_table(
            CFG, hp, tenancy.decay_table(CFG, hp, tab, 10), 20)
        for n in ("lam", "c_ema"):
            torch.testing.assert_close(getattr(one, n), getattr(two, n),
                                       rtol=ROUND_TRIP_TOL,
                                       atol=ROUND_TRIP_TOL)

    def test_matches_jax(self):
        hp, tab = self._folded()
        jtab = jten.TenantTable(**{n: jnp.asarray(getattr(tab, n)[0].numpy())
                                   for n in tenancy.LEAVES})
        for elapsed in (1, 40, 10_000):
            got = tenancy.decay_table(CFG, hp, tab, elapsed)
            want = jten.decay_table(JCFG.statics, JHyper(), jtab, elapsed)
            _check_table(types_lib.map_leaves(lambda a: a[0], got), want,
                         tol=ROUND_TRIP_TOL)

    def test_identity_and_validation(self):
        hp, tab = self._folded()
        assert tenancy.decay_table(CFG, hp, tab, 0) is tab
        with pytest.raises(ValueError):
            tenancy.decay_table(CFG, hp, tab, -1)

    def test_relaxes_toward_budget_anchor(self):
        hp = HyperParams().as_leaves(1, "cpu")
        tab = tenancy.expand(mk_table(), 1)
        tab = dataclasses.replace(tab, lam=torch.full((1, 4), 2.0),
                                  c_ema=tab.budget * 3.0)
        aged = tenancy.decay_table(CFG, hp, tab, 10_000)
        assert bool((aged.lam < 0.1).all())
        torch.testing.assert_close(aged.c_ema, tab.budget, rtol=1e-3,
                                   atol=0.0)


def _drive(gw, n_blocks=3, B=16, first_id=0, seed=10):
    """``n_blocks`` routed, fed back and learned blocks; returns the arms
    of every block."""
    arms = []
    for i in range(n_blocks):
        X, r, c, tids = rand_block(B, seed=seed + i)
        ids = list(range(first_id + i * B, first_id + (i + 1) * B))
        res = gw.route_block(ids, X, tenant_ids=tids)
        gw.enqueue_feedback(ids, res.arms, r, c)
        gw.learn_tick()
        arms.append(np.asarray(res.arms).tolist())
    return arms


class TestSnapshotRoundTrip:
    def _warm_gateway(self):
        gw = RouterGateway(CFG, mk_state(mk_table()),
                           batcher=MicroBatcher(max_batch=16))
        _drive(gw)
        return gw

    def test_gateway_matches_jax(self):
        """The same tenant blocks through both gateways: arms identical,
        the table within 1e-4, the telemetry's tenant series equal."""
        jgw = JGateway(JCFG, mk_jstate(jten.make_table(BUDGETS)),
                       batcher=JBatcher(max_batch=16))
        gw = RouterGateway(CFG, interop.state_from_numpy(
            jgw.live_state, "cpu"), batcher=MicroBatcher(max_batch=16))
        assert _drive(gw) == _drive(jgw)
        _check_table(types_lib.map_leaves(lambda a: a[0],
                                          gw.live_state.tenants),
                     jgw.live_state.tenants)
        m, jm = gw.metrics(), jgw.metrics()
        for k in jm:
            if k.startswith("tenant_"):
                assert m[k] == pytest.approx(jm[k], rel=EQUIV_TOL,
                                             abs=EQUIV_TOL), k

    def test_submit_tags_tenants_in_the_window(self):
        gw = RouterGateway(CFG, mk_state(mk_table()),
                           batcher=MicroBatcher(max_batch=4))
        X, r, c, tids = rand_block(4, seed=3)
        out = [gw.submit(i, X[i], tenant=int(tids[i])) for i in range(4)]
        res = out[-1]
        assert res is not None and all(o is None for o in out[:-1])
        gw.enqueue_feedback(list(range(4)), res.arms, r, c)
        gw.learn_tick()
        want = np.bincount(tids, minlength=4)
        assert gw.live_state.tenants.pulls[0].tolist() == want.tolist()
        assert gw.metrics()["tenant_pulls_1"] == float(want[1])

    def test_round_trip_preserves_table(self, tmp_path):
        gw = self._warm_gateway()
        tab = gw.live_state.tenants
        assert int(tab.pulls.sum()) == 48
        path = str(tmp_path / "snap")
        saved = gw.save(path)
        gw2 = RouterGateway(CFG, mk_state(mk_table(), seed=9))
        restored = gw2.restore(path)
        assert restored.version == saved.version
        for leaf in tenancy.LEAVES:
            assert torch.equal(getattr(gw2.live_state.tenants, leaf),
                               getattr(tab, leaf)), leaf
        assert torch.equal(gw2.live_state.key, gw.live_state.key)

    def test_restore_with_elapsed_matches_decay_on_restore_1e6(self,
                                                               tmp_path):
        """save -> restore(elapsed) equals ``decay_on_restore`` of the
        saved state within 1e-6, every leaf; the table's lam decays toward
        0 and c_ema toward its budget; pulls and spend survive."""
        gw = self._warm_gateway()
        elapsed = 40
        path = str(tmp_path / "snap")
        saved = gw.save(path).state
        gw2 = RouterGateway(CFG, mk_state(mk_table(), seed=9))
        gw2.restore(path, elapsed=elapsed)
        want = interop.state_to_numpy(
            statehandle.decay_on_restore(CFG, saved, elapsed))
        got = interop.state_to_numpy(gw2.live_state)
        for n, v in want.items():
            sub = v if isinstance(v, dict) else {n: v}
            gsub = got[n] if isinstance(v, dict) else {n: got[n]}
            for k, w in sub.items():
                np.testing.assert_allclose(gsub[k], w, rtol=ROUND_TRIP_TOL,
                                           atol=ROUND_TRIP_TOL,
                                           err_msg=f"{n}/{k}")
        now, before = gw2.live_state.tenants, saved.tenants
        assert bool((now.lam <= before.lam).all())
        assert bool(((now.c_ema - now.budget).abs()
                     <= (before.c_ema - before.budget).abs()).all())
        assert torch.equal(now.pulls, before.pulls)
        assert int(gw2.live_state.t[0]) == int(saved.t[0]) + elapsed

    def test_pre_restore_feedback_resolves_with_drop_semantics(
            self, tmp_path):
        gw = self._warm_gateway()
        X, r, c, tids = rand_block(16, seed=44)
        ids = list(range(1000, 1016))
        res = gw.route_block(ids, X, tenant_ids=tids)
        path = str(tmp_path / "snap")
        gw.save(path)
        gw.restore(path, elapsed=5)
        assert gw.enqueue_feedback(ids, res.arms, r, c) == 16
        assert gw.learn_tick() is not None
        before = gw.telemetry.counter("dropped_feedback")
        assert gw.enqueue_feedback(ids, res.arms, r, c) == 0
        assert gw.enqueue_feedback([777777], None, [0.5], [1e-4]) == 0
        assert gw.telemetry.counter("dropped_feedback") == before + 17

    def test_restore_matches_jax(self, tmp_path):
        """Both gateways warmed alike, saved and restored with elapsed
        40: the restored states agree within 1e-4 (the table within 1e-6
        of each package's own decay of the saved one)."""
        jgw = JGateway(JCFG, mk_jstate(jten.make_table(BUDGETS)),
                       batcher=JBatcher(max_batch=16))
        gw = RouterGateway(CFG, interop.state_from_numpy(
            jgw.live_state, "cpu"), batcher=MicroBatcher(max_batch=16))
        _drive(jgw), _drive(gw)
        for g, name in ((jgw, "j"), (gw, "t")):
            g.save(str(tmp_path / name))
            g.restore(str(tmp_path / name), elapsed=40)
        got = interop.state_to_numpy(gw.live_state, stacked=False)
        js = jgw.live_state
        for n in ("A", "A_inv", "b", "theta"):
            np.testing.assert_allclose(got[n], np.asarray(getattr(js, n)),
                                       atol=EQUIV_TOL, rtol=EQUIV_TOL,
                                       err_msg=n)
        for n in ("t", "last_upd", "last_play", "key"):
            assert np.array_equal(got[n], np.asarray(getattr(js, n))), n
        _check_table(types_lib.map_leaves(lambda a: a[0],
                                          gw.live_state.tenants),
                     js.tenants)

    def test_snapshots_cross_load(self, tmp_path):
        """A snapshot saved by JAX's ``save_snapshot`` loads in the port,
        and the port's in JAX's: same keys, shapes, dtypes and values."""
        jgw = JGateway(JCFG, mk_jstate(jten.make_table(BUDGETS)),
                       batcher=JBatcher(max_batch=16))
        _drive(jgw)
        jsnap = jgw.handle.read()
        jpath = str(tmp_path / "from_jax")
        jsh.save_snapshot(jpath, jsnap)
        snap = statehandle.load_snapshot(jpath, mk_state(mk_table()))
        assert snap.version == jsnap.version and snap.step == jsnap.step
        want = interop.state_to_numpy(interop.state_from_numpy(
            jsnap.state, "cpu"))
        got = interop.state_to_numpy(snap.state)
        assert got.keys() == want.keys()
        for n in want:
            np.testing.assert_equal(got[n], want[n], err_msg=n)

        tpath = str(tmp_path / "from_port")
        statehandle.save_snapshot(tpath, snap)
        with open(tpath + ".manifest.json") as f, \
                open(jpath + ".manifest.json") as jf:
            assert f.read() == jf.read()
        back = jsh.load_snapshot(tpath, mk_jstate(jten.make_table(BUDGETS)))
        assert back.version == jsnap.version
        for (p, a), (_, b) in zip(
                jax.tree_util.tree_flatten_with_path(back.state)[0],
                jax.tree_util.tree_flatten_with_path(jsnap.state)[0]):
            assert np.asarray(a).dtype == np.asarray(b).dtype, p
            assert np.array_equal(np.asarray(a), np.asarray(b)), p


@pytest.fixture(scope="module")
def bench():
    b = jsim.make_benchmark(seed=0, splits=SPLITS)
    jpriors = jev.fit_warmup_priors(JRCFG, b.train)
    return dict(jenv=b.test, jpriors=jpriors,
                env=interop.env_from_numpy(b.test),
                priors=[interop.prior_from_numpy(p, "cpu") for p in jpriors],
                tids=jsyn.flash_crowd_tenant_stream(
                    L, T4, hot=3, start=L // 4, stop=L // 2, boost=8.0,
                    seed=7))


def _tspec(m):
    return m.ScenarioSpec(horizon=L, events=(
        m.TenantMixShift(64, (1, 1, 4, 1)),
        m.TenantBudgetChange(128, 1, 1.5e-3),
        m.TenantMixShift(192, None)), stream_seed_base=77)


@pytest.fixture(scope="module")
def jax_runs(bench):
    """JAX's tenant runs on the test bed: evaluate.run with a shared and
    with a per-seed table, the scenario and the fleet grid."""
    kw = dict(priors=bench["jpriors"], n_eff=N_EFF, batch_size=BS,
              return_states=True)
    per_seed = jten.stack_tables([jten.make_table(RUN_BUDGETS),
                                  jten.make_table(RUN_BUDGETS * 1.5)])
    tids2 = np.stack([bench["tids"], bench["tids"][::-1]])
    spec = _tspec(jsc)
    stids = jsyn.tenant_stream_for_spec(spec, T4, seed=3)
    tables = jten.stack_tables([jten.make_table(RUN_BUDGETS * np.float32(f))
                                for f in SCALES])
    return {
        "shared": jev.run(JRCFG, bench["jenv"], 1.0, SEEDS,
                          tenants=jten.make_table(RUN_BUDGETS),
                          tenant_ids=bench["tids"], **kw),
        "per_seed": jev.run(JRCFG, bench["jenv"], 1.0, SEEDS,
                            tenants=per_seed, tenant_ids=tids2, **kw),
        "scenario": jev.run_scenario(
            JRCFG, spec, bench["jenv"], 1.0, SEEDS,
            tenants=jten.make_table(RUN_BUDGETS), tenant_ids=stids, **kw),
        "grid": jsweep.run_grid(
            JRCFG, bench["jenv"], [1.0] * len(SCALES), SEEDS,
            priors=bench["jpriors"], n_eff=N_EFF, batch_size=BS,
            tenant_tables=tables, tenant_ids=bench["tids"]),
    }


def _check_run(res, jres, finals=None, jfinals=None):
    assert np.array_equal(res.arms, np.asarray(jres.arms))
    assert np.array_equal(res.rewards, np.asarray(jres.rewards))
    assert np.array_equal(res.costs, np.asarray(jres.costs))
    np.testing.assert_allclose(res.lams, np.asarray(jres.lams),
                               atol=EQUIV_TOL)
    if finals is not None:
        _check_table(finals.tenants, jfinals.tenants)


def _trun(bench, **kw):
    return evaluate.run(RCFG, bench["env"], 1.0, SEEDS,
                        priors=bench["priors"], n_eff=N_EFF, batch_size=BS,
                        return_states=True, device="cpu", **kw)


class TestEvaluate:
    def test_shared_table_run_matches_jax(self, bench, jax_runs):
        res, finals = _trun(bench, tenants=mk_table(RUN_BUDGETS),
                            tenant_ids=bench["tids"])
        jres, jfinals = jax_runs["shared"]
        _check_run(res, jres, finals, jfinals)
        # the run's own fold contract, per (seed, tenant), bit for bit
        hp = RCFG.hyper.as_leaves(1, "cpu")
        for s in range(len(SEEDS)):
            for j in range(T4):
                cs = res.costs[s][bench["tids"] == j]
                p0 = tenancy.table_row(tenancy.expand(
                    mk_table(RUN_BUDGETS), 1), j)
                pf = pacer.pacer_update_batch(hp, p0, _f32(cs)[None])
                assert finals.tenants.lam[s, j].item() == pf.lam.item()
                assert finals.tenants.c_ema[s, j].item() == pf.c_ema.item()
                assert int(finals.tenants.pulls[s, j]) == len(cs)

    def test_per_seed_table_and_ids_match_jax(self, bench, jax_runs):
        per_seed = tenancy.stack_tables([mk_table(RUN_BUDGETS),
                                         mk_table(RUN_BUDGETS * 1.5)])
        tids2 = np.stack([bench["tids"], bench["tids"][::-1]])
        res, finals = _trun(bench, tenants=per_seed, tenant_ids=tids2)
        _check_run(res, jax_runs["per_seed"][0], finals,
                   jax_runs["per_seed"][1])

    def test_tenants_and_ids_go_together(self, bench):
        with pytest.raises(ValueError, match="together"):
            evaluate.run(RCFG, bench["env"], 1e-3, (0,), device="cpu",
                         tenants=mk_table([1e-3] * 2))
        with pytest.raises(ValueError, match="batch_size"):
            evaluate.run(RCFG, bench["env"], 1e-3, (0,), device="cpu",
                         tenants=mk_table([1e-3] * 2),
                         tenant_ids=np.zeros(L, np.int32))
        with pytest.raises(ValueError, match="per-state"):
            evaluate.run(RCFG, bench["env"], 1e-3, (0,), device="cpu",
                         batch_size=BS, tenants=mk_table([1e-3] * 2),
                         tenant_ids=np.zeros((3, L), np.int32))


class TestScenarioTenantEvents:
    def test_tenant_scenario_matches_jax(self, bench, jax_runs):
        spec = _tspec(scenario)
        stids = synthetic.tenant_stream_for_spec(spec, T4, seed=3)
        res, finals = evaluate.run_scenario(
            RCFG, spec, bench["env"], 1.0, SEEDS, priors=bench["priors"],
            n_eff=N_EFF, batch_size=BS, tenants=mk_table(RUN_BUDGETS),
            tenant_ids=stids, return_states=True, device="cpu")
        jres, jfinals = jax_runs["scenario"]
        assert res.bounds == jres.bounds
        _check_run(res, jres, finals, jfinals)
        assert np.allclose(finals.tenants.budget[:, 1].numpy(), 1.5e-3)
        assert np.allclose(finals.tenants.budget[:, 0].numpy(),
                           RUN_BUDGETS[0])

    def test_tenant_budget_change_on_tenantless_run_raises(self, bench):
        spec = scenario.ScenarioSpec(horizon=L, events=(
            scenario.TenantBudgetChange(t=128, tenant=1, budget=0.02),))
        with pytest.raises(ValueError, match="tenant"):
            evaluate.run_scenario(RCFG, spec, bench["env"], 0.01, (0,),
                                  batch_size=BS, device="cpu")

    def test_tenant_scenario_guards(self, bench):
        spec = scenario.ScenarioSpec(horizon=L)
        kw = dict(tenants=mk_table(RUN_BUDGETS),
                  tenant_ids=np.zeros(L, np.int32), device="cpu")
        with pytest.raises(ValueError, match="batch_size > 1"):
            evaluate.run_scenario(RCFG, spec, bench["env"], 1.0, (0,), **kw)
        with pytest.raises(NotImplementedError, match="timeline"):
            evaluate.run_scenario(RCFG, spec, bench["env"], 1.0, (0,),
                                  batch_size=BS,
                                  timeline=scenario.Timeline(()), **kw)
        with pytest.raises(ValueError, match="together"):
            evaluate.run_scenario(RCFG, spec, bench["env"], 1.0, (0,),
                                  batch_size=BS, tenants=kw["tenants"],
                                  device="cpu")


class TestSweep:
    def _grid(self, bench, **kw):
        tables = tenancy.stack_tables([mk_table(RUN_BUDGETS * np.float32(f))
                                       for f in SCALES])
        return sweep.run_grid(
            RCFG, bench["env"], [1.0] * len(SCALES), SEEDS,
            priors=bench["priors"], n_eff=N_EFF, batch_size=BS,
            tenant_tables=tables, tenant_ids=bench["tids"], device="cpu",
            return_states=True, **kw)

    def test_grid_matches_jax_and_looped_runs(self, bench, jax_runs):
        grid, finals = self._grid(bench)
        jgrid = jax_runs["grid"]
        for i, f in enumerate(SCALES):
            cond = grid.condition(i)
            _check_run(cond, jgrid.condition(i))
            ref, rfin = _trun(bench, tenants=mk_table(
                RUN_BUDGETS * np.float32(f)), tenant_ids=bench["tids"])
            for n in ("arms", "rewards", "costs", "lams"):
                assert np.array_equal(getattr(cond, n), getattr(ref, n)), n
            part = types_lib.state_slice(finals, i * len(SEEDS),
                                         (i + 1) * len(SEEDS))
            for n in tenancy.LEAVES:
                assert torch.equal(getattr(part.tenants, n),
                                   getattr(rfin.tenants, n)), (i, n)

    @pytest.mark.parametrize("split", [dict(chunk_size=2),
                                       dict(devices=["cpu", "cpu"])])
    def test_sub_stacks_equal_whole(self, bench, split):
        whole, wfin = self._grid(bench)
        part, pfin = self._grid(bench, **split)
        for n in ("arms", "rewards", "costs", "lams"):
            assert np.array_equal(getattr(part, n), getattr(whole, n)), n
        for n in tenancy.LEAVES:
            assert torch.equal(getattr(pfin.tenants, n),
                               getattr(wfin.tenants, n)), n

    @pytest.mark.parametrize("tables,ids,match", [
        ("flat", "per_element", None),
        ("bad", "shared", "pre-flattened"),
        ("flat", "bad", "per-element"),
    ])
    def test_table_and_id_layouts(self, bench, tables, ids, match):
        C, S = len(SCALES), len(SEEDS)
        tab = {"flat": tenancy.stack_tables([mk_table(RUN_BUDGETS)] * (C * S)),
               "bad": tenancy.stack_tables([mk_table(RUN_BUDGETS)] * 5)}
        tid = {"shared": bench["tids"],
               "per_element": np.tile(bench["tids"], (C * S, 1)),
               "bad": np.zeros((5, L), np.int32)}
        call = lambda: sweep.run_grid(  # noqa: E731
            RCFG, bench["env"], [1.0] * C, SEEDS, batch_size=BS,
            tenant_tables=tab[tables], tenant_ids=tid[ids], device="cpu")
        if match is not None:
            with pytest.raises(ValueError, match=match):
                call()
            return
        grid = call()
        ref = evaluate.run(RCFG, bench["env"], 1.0, SEEDS, batch_size=BS,
                           tenants=mk_table(RUN_BUDGETS),
                           tenant_ids=bench["tids"], device="cpu")
        for i in range(C):
            assert np.array_equal(grid.condition(i).arms, ref.arms)


STREAMS = {
    "mix": lambda m: m.tenant_mix_stream(4096, 3, weights=(0, 1, 1), seed=0),
    "mix_uniform": lambda m: m.tenant_mix_stream(512, 5, seed=4),
    "diurnal": lambda m: m.diurnal_tenant_stream(2048, 4, period=512,
                                                 sharpness=8.0, seed=1),
    "flash": lambda m: m.flash_crowd_tenant_stream(
        8192, 4, hot=2, start=2048, stop=4096, boost=8.0, seed=0),
    "flash_base": lambda m: m.flash_crowd_tenant_stream(
        1000, 3, hot=0, start=100, base_weights=(1, 2, 3), seed=2),
}


class TestStreams:
    @pytest.mark.parametrize("name", sorted(STREAMS))
    def test_streams_equal_jax(self, name):
        got, want = STREAMS[name](synthetic), STREAMS[name](jsyn)
        assert got.dtype == want.dtype == np.int32
        assert np.array_equal(got, want)

    @pytest.mark.parametrize("weights", [None, (1, 2, 3)])
    def test_stream_for_spec_equals_jax(self, weights):
        def spec(m):
            return m.ScenarioSpec(horizon=1024, events=(
                m.TenantMixShift(t=256, weights=(0, 0, 1)),
                m.TenantMixShift(t=512, weights=None),))
        got = synthetic.tenant_stream_for_spec(spec(scenario), 3, seed=0,
                                               weights=weights)
        want = jsyn.tenant_stream_for_spec(spec(jsc), 3, seed=0,
                                           weights=weights)
        assert np.array_equal(got, want)
        assert (got[256:512] == 2).all()

    @pytest.mark.parametrize("call", [
        lambda m: m.tenant_mix_stream(8, 3, weights=(1, 1)),
        lambda m: m.tenant_mix_stream(8, 3, weights=(-1, 1, 1)),
        lambda m: m.flash_crowd_tenant_stream(8, 4, hot=4),
        lambda m: m.flash_crowd_tenant_stream(8, 4, start=6, stop=2),
        lambda m: m.diurnal_tenant_stream(8, 4, period=0),
    ])
    def test_stream_guards_match_jax(self, call):
        with pytest.raises(ValueError) as jerr:
            call(jsyn)
        with pytest.raises(ValueError) as err:
            call(synthetic)
        assert str(err.value) == str(jerr.value)


class TestTelemetry:
    def test_tenant_series_match_jax(self):
        names = ["ok", 'ev"il\n\\co']
        tel, jtel = Telemetry(4, tenant_names=names), JTelemetry(
            4, tenant_names=names)
        for t in (tel, jtel):
            t.record_tenants([1.0, 2.0], [3, 4], [0.1, 0.2], [0.5, 0.5])
        assert tel.prometheus_text() == jtel.prometheus_text()
        assert tel.metrics() == jtel.metrics()
        with pytest.raises(ValueError):
            tel.record_tenants([1.0], [1, 2], [0.1], [0.5])

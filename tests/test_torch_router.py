"""The port's router against the JAX router from one shared state.

Two JAX states (seeds 0 and 1) are warmed with a few oracle blocks and
carried across with ``interop`` as one S = 2 stack. Each block then runs
through JAX ``step_batch`` on ``jnp`` and ``pallas_fused`` (interpret
mode) and through the port on ``torch`` and ``fused`` (the fused wrapper
runs its plain version on CPU tensors): arms, ``last_upd``,
``last_play``, ``t`` and ``key`` exact; statistics and pacer within
1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import router as jrouter  # noqa: E402
from repro.core.types import (  # noqa: E402
    HyperParams as JHyper, RouterConfig as JConfig, init_state as jinit,
)
from repro_torch import interop  # noqa: E402
from repro_torch.core import backend as backend_lib  # noqa: E402
from repro_torch.core import router  # noqa: E402
from repro_torch.core.types import HyperParams, RouterConfig  # noqa: E402

D, K = 12, 4
SEEDS = (0, 1)
TOL = 1e-4


def _jcfg(backend):
    return JConfig(d=D, max_arms=K, backend=backend,
                   hyper=JHyper(alpha=0.05))


def _tcfg(backend):
    return RouterConfig(d=D, max_arms=K, backend=backend,
                        hyper=HyperParams(alpha=0.05))


def _block(rng, B):
    X = rng.standard_normal((B, D)).astype(np.float32)
    R = rng.uniform(0.5, 1.0, (B, K)).astype(np.float32)
    C = rng.uniform(1e-5, 1e-3, (B, K)).astype(np.float32)
    return X, R, C


def _warmed(seed, blocks=3, B=16):
    rng = np.random.default_rng(seed)
    cfg = _jcfg("jnp")
    prices = jnp.asarray(np.linspace(1e-4, 5.6e-3, K), jnp.float32)
    st = jinit(cfg, prices, prices, budget=6.6e-4,
               key=jax.random.PRNGKey(3 + seed))
    for _ in range(blocks):
        st, _ = jrouter.step_batch(cfg, st, *map(jnp.asarray, _block(rng, B)))
    return st, rng


def _stack(states):
    return jax.tree.map(lambda *a: np.stack([np.asarray(x) for x in a]),
                        *states)


@pytest.fixture(scope="module")
def warmed():
    return [_warmed(s) for s in SEEDS]


def _blocks(warmed, B):
    return [_block(np.random.default_rng(100 + B + i), B)
            for i in range(len(warmed))]


def _check(ts, jstates, tol=TOL):
    got = interop.state_to_numpy(ts)
    for s, js in enumerate(jstates):
        for n in ("last_upd", "last_play", "t", "key", "force_left"):
            assert np.array_equal(got[n][s], np.asarray(getattr(js, n))), n
        for n in ("A", "A_inv", "b", "theta"):
            np.testing.assert_allclose(got[n][s], np.asarray(getattr(js, n)),
                                       atol=tol, rtol=tol, err_msg=n)
        for n in ("lam", "c_ema"):
            assert abs(got["pacer"][n][s] - float(getattr(js.pacer, n))) <= tol


@pytest.mark.parametrize("B", [1, 13, 64])
def test_step_batch_matches_jax(warmed, B):
    states = [st for st, _ in warmed]
    blocks = _blocks(warmed, B)
    jout = {}
    for bk in ("jnp", "pallas_fused"):
        jout[bk] = [jrouter.step_batch(_jcfg(bk), st, *map(jnp.asarray, blk))
                    for st, blk in zip(states, blocks)]
    ts0 = interop.state_from_numpy(_stack(states), "cpu")
    X, R, C = (torch.as_tensor(np.stack(a)) for a in zip(*blocks))
    for bk in ("torch", "fused"):
        ts, (arms, r, c, lam) = router.step_batch(_tcfg(bk), ts0, X, R, C)
        for jbk, outs in jout.items():
            _check(ts, [o[0] for o in outs])
            for s, (_, (ja, jr, jc, jl)) in enumerate(outs):
                assert np.array_equal(arms[s].numpy(), np.asarray(ja)), jbk
                assert np.array_equal(r[s].numpy(), np.asarray(jr))
                assert np.array_equal(c[s].numpy(), np.asarray(jc))
                np.testing.assert_allclose(lam[s].numpy(), np.asarray(jl),
                                           atol=TOL)


def test_scalar_step_is_the_b1_block(warmed):
    """``step`` (one request per state) == JAX's scalar ``step``."""
    states = [st for st, _ in warmed]
    ts = interop.state_from_numpy(_stack(states), "cpu")
    rng = np.random.default_rng(5)
    for _ in range(4):
        X, R, C = _block(rng, 1)
        outs = [jrouter.step(_jcfg("jnp"), st, *map(jnp.asarray,
                                                     (X[0], R[0], C[0])))
                for st in states]
        states = [o[0] for o in outs]
        ts, (arm, _, _, _) = router.step(
            _tcfg("fused"), ts, *(torch.as_tensor(np.stack([a[0]] * 2))
                                  for a in (X, R, C)))
        assert arm.tolist() == [int(o[1][0]) for o in outs]
    _check(ts, states)


def test_select_batch_score_backend(warmed):
    """Select-only serving through the scoring kernel's path ("score")
    against JAX "pallas" (interpret): scores within 1e-4, arms and the
    select-plane bookkeeping exact; the statistics are untouched."""
    states = [st for st, _ in warmed]
    blocks = _blocks(warmed, 32)
    ts0 = interop.state_from_numpy(_stack(states), "cpu")
    X = torch.as_tensor(np.stack([b[0] for b in blocks]))
    dec, ts = router.select_batch(_tcfg("score"), ts0, X)
    dec_t, _ = router.select_batch(_tcfg("torch"), ts0, X)
    assert (dec.scores - dec_t.scores).abs().max() <= backend_lib.EQUIV_TOL
    dt = ts0.t[:, None] - torch.maximum(ts0.last_upd, ts0.last_play)
    assert backend_lib.score_divergence(
        _tcfg("score"), ts0.hyper, ts0.theta, ts0.A_inv, ts0.c_tilde, X, dt,
        ts0.pacer.lam) <= backend_lib.EQUIV_TOL
    for s, st in enumerate(states):
        jdec, jst = jrouter.select_batch(_jcfg("pallas"), st,
                                         jnp.asarray(blocks[s][0]))
        assert np.array_equal(dec.arms[s].numpy(), np.asarray(jdec.arms))
        np.testing.assert_allclose(dec.scores[s].numpy(),
                                   np.asarray(jdec.scores), atol=TOL)
        for n in ("t", "last_play", "key", "force_left"):
            assert np.array_equal(getattr(ts, n)[s].numpy(),
                                  np.asarray(getattr(jst, n))), n
    assert ts.A_inv is ts0.A_inv


@pytest.mark.parametrize("backend", ["torch", "fused"])
def test_forced_burnin_and_frozen_pacer(warmed, backend):
    """The first force_left requests go to the forced arm; a disabled
    pacer keeps (lam, c_ema) frozen — as in JAX, on both paths."""
    st = dataclasses.replace(
        warmed[0][0], force_arm=jnp.int32(2), force_left=jnp.int32(5),
        pacer=dataclasses.replace(warmed[0][0].pacer,
                                  enabled=jnp.asarray(False)))
    X, R, C = _block(np.random.default_rng(9), 16)
    js, (ja, _, _, _) = jrouter.step_batch(
        _jcfg("jnp"), st, *map(jnp.asarray, (X, R, C)))
    ts, (arms, _, _, _) = router.step_batch(
        _tcfg(backend), interop.state_from_numpy(st, "cpu"),
        *(torch.as_tensor(a)[None] for a in (X, R, C)))
    assert torch.all(arms[0, :5] == 2)
    assert arms[0].tolist() == np.asarray(ja).tolist()
    assert int(ts.force_left[0]) == 0
    assert float(ts.pacer.lam[0]) == float(st.pacer.lam)
    assert float(ts.pacer.c_ema[0]) == float(st.pacer.c_ema)
    _check(ts, [js])


def test_tenant_mode_not_ported(warmed):
    """Tenant mode is not ported to the kernels, as the JAX package's
    Pallas kernels refuse it: ``score`` and ``fused`` raise
    ``NotImplementedError`` and a state without a table ``ValueError``;
    on ``torch`` a tenant block from the warmed S = 2 stack matches JAX's
    ``jnp`` tenant path (arms exact, the table within 1e-4, the
    portfolio pacer untouched)."""
    from repro.core import tenancy as jten

    budgets = np.linspace(2e-4, 8e-4, 3).astype(np.float32)
    jstates = [dataclasses.replace(st, tenants=jten.make_table(budgets))
               for st, _ in warmed]
    ts = interop.state_from_numpy(_stack(jstates), "cpu")
    X, R, C = _blocks(warmed, 16)[0]
    tids = np.random.default_rng(7).integers(0, 3, 16).astype(np.int32)
    args = (torch.as_tensor(X)[None].expand(2, -1, -1),
            torch.as_tensor(R)[None].expand(2, -1, -1),
            torch.as_tensor(C)[None].expand(2, -1, -1))
    tt = torch.as_tensor(tids)[None].expand(2, -1)
    for backend in ("score", "fused"):
        with pytest.raises(NotImplementedError):
            router.select_batch(_tcfg(backend), ts, args[0], tenant_ids=tt)
        with pytest.raises(NotImplementedError):
            router.step_batch(_tcfg(backend), ts, *args, tenant_ids=tt)
    plain = interop.state_from_numpy(warmed[0][0], "cpu")
    with pytest.raises(ValueError, match="tenant"):
        router.select_batch(_tcfg("torch"), plain, args[0][:1],
                            tenant_ids=tt[:1])
    out, (arms, _, _, lam) = router.step_batch(_tcfg("torch"), ts, *args,
                                               tenant_ids=tt)
    for s, js in enumerate(jstates):
        js, (ja, _, _, jl) = jrouter.step_batch(
            _jcfg("jnp"), js, *map(jnp.asarray, (X, R, C)),
            jnp.asarray(tids))
        assert arms[s].tolist() == np.asarray(ja).tolist()
        np.testing.assert_allclose(lam[s].numpy(), np.asarray(jl), atol=TOL)
        for n in ("lam", "c_ema", "spend"):
            np.testing.assert_allclose(
                getattr(out.tenants, n)[s].numpy(),
                np.asarray(getattr(js.tenants, n)), atol=TOL, err_msg=n)
        assert out.tenants.pulls[s].tolist() == np.asarray(
            js.tenants.pulls).tolist()
        assert float(out.pacer.lam[s]) == float(js.pacer.lam)

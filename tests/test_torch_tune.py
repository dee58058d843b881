"""The port's ``linucb.ucb_variance`` and the scoring kernel's
rows-per-block knob against the JAX package: ``ucb_variance`` per state
against JAX's per-arm value (1e-6) and bit for bit against
``ucb_scores_batch``'s variance term; ``linucb_score(..., block_r)`` on
the CPU against JAX's op in interpret mode at every candidate (1e-4);
the autotune's table, winner and memo on the CPU; and ``score_plan`` for
every (DP, rows) the kernel is built for, its shared memory held to
``csrc/linucb_common.cuh``'s formula. The kernel itself at every
candidate is held on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 16)."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import linucb as jlin  # noqa: E402
from repro.core.types import HyperParams as JHyper  # noqa: E402
from repro.core.types import RouterConfig as JConfig  # noqa: E402
from repro.kernels.linucb_score.ops import linucb_score as jscore  # noqa: E402
from repro.kernels.tune import BLOCK_R_CANDIDATES as JAX_CANDIDATES  # noqa: E402
from repro_torch.core import linucb  # noqa: E402
from repro_torch.core.types import HyperParams, RouterConfig  # noqa: E402
from repro_torch.kernels import tune  # noqa: E402
from repro_torch.kernels.linucb_score import ops as score_ops  # noqa: E402
from repro_torch.kernels.linucb_score.kernel import (  # noqa: E402
    BLOCK_ROWS, TILE_ROWS, WIDTHS, score_plan,
)

CUH = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels"
       / "csrc" / "linucb_common.cuh")


def _spd_inv(rng, lead, d):
    M = rng.standard_normal(lead + (d, d))
    return np.linalg.inv(np.einsum("...ij,...kj->...ik", M, M) / d
                         + np.eye(d)).astype(np.float32)


def _variance_inputs(S, d, seed):
    rng = np.random.default_rng(seed)
    return (_spd_inv(rng, (S,), d),
            rng.standard_normal((S, d)).astype(np.float32))


def _port_variance(gamma, v_max, A_inv, x, dt):
    cfg = RouterConfig(d=x.shape[-1], max_arms=2,
                       hyper=HyperParams(gamma=gamma, v_max=v_max))
    hp = cfg.hyper.as_leaves(x.shape[0], "cpu")
    return linucb.ucb_variance(cfg, hp, torch.as_tensor(A_inv),
                               torch.as_tensor(x),
                               torch.as_tensor(dt, dtype=torch.int32))


def _jax_variance(gamma, v_max, A_inv, x, dt):
    cfg = JConfig(d=x.shape[-1], max_arms=2,
                  hyper=JHyper(gamma=gamma, v_max=v_max))
    return np.array([float(jlin.ucb_variance(
        cfg, cfg.hyper, jnp.asarray(A_inv[s]), jnp.asarray(x[s]),
        jnp.int32(dt[s]))) for s in range(x.shape[0])])


@pytest.mark.parametrize("gamma,v_max,d", [(0.9, 50.0, 6), (0.997, 200.0, 26),
                                           (1.0, 200.0, 5)])
def test_ucb_variance_matches_jax(gamma, v_max, d):
    """Per state against JAX's per-arm Eq. 9, staleness from fresh to far
    past the V_max cap."""
    A_inv, x = _variance_inputs(6, d, seed=d)
    dt = np.array([0, 1, 10, 500, 10_000, 100_000])
    got = _port_variance(gamma, v_max, A_inv, x, dt)
    assert got.shape == (6,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _jax_variance(
        gamma, v_max, A_inv, x, dt), rtol=1e-6, atol=0)


def test_staleness_inflation_capped():
    """Twin of tests/test_core_router.py's: a stale arm's variance is
    inflated, but by at most V_max."""
    A_inv = np.broadcast_to(np.eye(6, dtype=np.float32), (4, 6, 6)).copy()
    _, x = _variance_inputs(4, 6, seed=1)
    fresh = _port_variance(0.9, 50.0, A_inv, x, np.zeros(4, int))
    stale = _port_variance(0.9, 50.0, A_inv, x, np.full(4, 10_000))
    assert bool((stale <= 50.0 * fresh + 1e-4).all())
    assert bool((stale > fresh).all())


def test_variance_inflation_bounded():
    """Twin of tests/test_properties.py's hypothesis property: the
    inflation lies in [1, V_max] for any staleness, and each value is
    JAX's within 1e-6."""
    hypothesis = pytest.importorskip("hypothesis")
    st = hypothesis.strategies

    A_inv = np.eye(4, dtype=np.float32)[None] * 0.7
    x = np.asarray([[1.0, -0.5, 0.2, 1.0]], np.float32)
    v0 = float(_port_variance(0.99, 100.0, A_inv, x, [0])[0])

    @hypothesis.given(dt=st.integers(0, 100_000))
    @hypothesis.settings(max_examples=30, deadline=None)
    def prop(dt):
        v = _port_variance(0.99, 100.0, A_inv, x, [dt])
        assert float(v[0]) <= v0 * 100.0 * (1 + 1e-5)
        assert float(v[0]) >= v0 * (1 - 1e-5)
        np.testing.assert_allclose(v.numpy(), _jax_variance(
            0.99, 100.0, A_inv, x, [dt]), rtol=1e-6, atol=0)

    prop()


def test_ucb_variance_is_the_scores_variance_term():
    """With theta = 0, no cost penalty and alpha = 1, ucb_scores_batch on
    one context and one arm is sqrt of its variance term: it equals
    sqrt(ucb_variance) bit for bit. Against the term of a whole (S, B, K)
    block (other shapes, other summation blocking) within 1e-6."""
    S, B, K, d = 3, 5, 4, 26
    rng = np.random.default_rng(3)
    A_inv = torch.as_tensor(_spd_inv(rng, (S, K), d))
    X = torch.as_tensor(rng.standard_normal((S, B, d)).astype(np.float32))
    dt = torch.as_tensor(rng.integers(0, 3000, (S, K)), dtype=torch.int32)
    cfg = RouterConfig(d=d, max_arms=K, hyper=HyperParams(
        alpha=1.0, lambda_c=0.0, gamma=0.99, v_max=50.0))
    hp = cfg.hyper.as_leaves(S, "cpu")
    zeros = torch.zeros(S)
    quad = torch.clamp_min(torch.einsum(
        "sbke,sbe->sbk", torch.einsum("sbd,skde->sbke", X, A_inv), X), 0.0)
    block = quad / linucb.staleness_inflation(cfg, hp, dt)[:, None, :]
    for b in range(B):
        for k in range(K):
            v = linucb.ucb_variance(cfg, hp, A_inv[:, k], X[:, b], dt[:, k])
            one = linucb.ucb_scores_batch(
                cfg, hp, torch.zeros(S, 1, d), A_inv[:, k:k + 1],
                torch.zeros(S, 1), X[:, b:b + 1], dt[:, k:k + 1], zeros)
            assert torch.equal(one[:, 0, 0], torch.sqrt(v))
            torch.testing.assert_close(v, block[:, b, k], rtol=1e-6, atol=0)


@pytest.mark.parametrize("block_r", BLOCK_ROWS)
def test_score_block_r_matches_jax(block_r):
    """Every candidate on the CPU (the plain version, which ignores the
    knob) against JAX's op in interpret mode at that block_r; R = 100
    leaves a ragged last tile at every candidate."""
    S, R, K, d = 2, 100, 4, 26
    rng = np.random.default_rng(block_r)
    x = rng.standard_normal((S, R, d)).astype(np.float32)
    theta = (rng.standard_normal((S, K, d)) * 0.1).astype(np.float32)
    ainv = _spd_inv(rng, (S, K), d)
    pen = rng.uniform(0, 1, (S, K)).astype(np.float32)
    infl = rng.uniform(0.005, 1.0, (S, K)).astype(np.float32)
    alpha = rng.uniform(0.01, 0.1, S).astype(np.float32)
    t = torch.as_tensor
    got = score_ops.linucb_score(t(x), t(theta), t(ainv), t(pen), t(infl),
                                 t(alpha), block_r=block_r)
    assert torch.equal(got, score_ops.linucb_score(
        t(x), t(theta), t(ainv), t(pen), t(infl), t(alpha)))
    for s in range(S):
        want = jscore(x[s], theta[s], ainv[s], pen[s], infl[s],
                      alpha=alpha[s], block_r=block_r, interpret=True)
        np.testing.assert_allclose(got[s].numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


def test_autotune_on_cpu():
    """The table has JAX's candidates as keys; the winner is one of them;
    the plain version launches nothing."""
    assert tune.BLOCK_R_CANDIDATES == JAX_CANDIDATES == BLOCK_ROWS
    before = score_ops.LAUNCHES[0]
    best, table = tune.autotune_block_r(64, 26, 8, S=2, device="cpu",
                                        repeats=1)
    assert tuple(table) == JAX_CANDIDATES
    assert best in JAX_CANDIDATES and table[best] == min(table.values())
    assert all(s > 0 for s in table.values())
    assert score_ops.LAUNCHES[0] == before


def test_best_block_r_is_memoised(monkeypatch):
    calls = []

    def fake(R, d, K, *, S=1, device=None):
        calls.append((S, R, d, K, device))
        return 64, {}

    monkeypatch.setattr(tune, "autotune_block_r", fake)
    tune.best_block_r.cache_clear()
    try:
        assert tune.best_block_r(256, 26, 8, S=20, device="cpu") == 64
        assert tune.best_block_r(256, 26, 8, S=20, device="cpu") == 64
        assert tune.best_block_r(4096, 128, 8, device="cpu") == 64
        assert calls == [(20, 256, 26, 8, "cpu"), (1, 4096, 128, 8, "cpu")]
    finally:
        tune.best_block_r.cache_clear()


def test_operands_are_seeded():
    a = tune.operands(2, 16, 3, 8, "cpu")
    b = tune.operands(2, 16, 3, 8, "cpu")
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert [tuple(t.shape) for t in a] == [(2, 16, 8), (2, 3, 8),
                                           (2, 3, 8, 8), (2, 3), (2, 3), (2,)]
    ainv = a[2].double()
    assert torch.allclose(ainv, ainv.transpose(-1, -2))
    assert bool((torch.linalg.eigvalsh(ainv) >= 1 - 1e-5).all())


def _cuh_smem():
    """score_smem_bytes(dp, rows) as written in linucb_common.cuh, as a
    Python function (its body with the C++ casts taken out)."""
    src = CUH.read_text()
    ldx = re.search(r"score_ldx\(int dp\) \{ return ([^;]+); \}", src)
    threads = re.search(r"score_threads\(int rows\) \{ return ([^;]+); \}",
                        src)
    body = re.search(r"score_smem_bytes\(int dp, int rows\) \{\s*return "
                     r"([^;]+);", src)
    expr = re.sub(r"static_cast<size_t>\((\w+)\)", r"\1", body.group(1))
    expr = expr.replace("sizeof(float)", "4").replace(
        "score_ldx(dp)", f"({ldx.group(1)})")
    return (lambda dp, rows: eval(expr, {}, dict(dp=dp, rows=rows)),
            lambda rows: eval(threads.group(1), {}, dict(rows=rows)))


def test_kernel_is_built_for_every_rows_and_width():
    src = CUH.read_text()
    cu = (CUH.parent / "linucb_score.cu").read_text()
    assert sorted(int(r) for r in re.findall(
        r"case (\d+): return linucb::launch_score<", cu)) == list(BLOCK_ROWS)
    assert sorted({int(w) for w in re.findall(
        r"case (\d+): return launch_score_dp<", src)}) == list(WIDTHS)
    assert f"kTileRows = {TILE_ROWS};" in src
    # the step kernel's chained route calls launch_score at the default
    assert "template <int ROWS = kTileRows>\nint launch_score(" in src


@pytest.mark.parametrize("block_r", BLOCK_ROWS)
@pytest.mark.parametrize("S,R,K,d,dp", [
    (20, 256, 8, 26, 32), (1, 4096, 8, 128, 128), (2, 300, 3, 64, 64),
    (1, 1, 1, 1, 32)])
def test_score_plan_every_candidate(S, R, K, d, dp, block_r):
    """Grid (ceil(R / rows), K, S), 2 x rows threads tiling the block's
    rows and DP columns in (DP / 16) x 8 micro-tiles, and the shared
    memory of the header's formula, within the 227 KB a block may opt
    into."""
    smem, threads = _cuh_smem()
    plan = score_plan(S, R, K, d, block_r)
    assert plan["dp"] == dp and plan["block_r"] == block_r
    assert plan["grid"] == (-(-R // block_r), K, S)
    assert plan["threads"] == threads(block_r) == 2 * block_r
    assert (block_r // plan["rows_per_thread"]) * (dp // 8) == plan["threads"]
    assert plan["smem_bytes"] == smem(dp, block_r) <= 232448
    assert score_plan(S, R, K, d) == score_plan(S, R, K, d, TILE_ROWS)


def test_score_plan_refuses_other_rows():
    with pytest.raises(ValueError, match="block_r"):
        score_plan(1, 8, 1, 8, 48)

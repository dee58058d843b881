"""The plain versions of the port's two kernels against the JAX kernels,
with a leading state axis S in {1, 3}: ``linucb_score`` against
``repro.kernels.linucb_score.ops.linucb_score`` in interpret mode,
``linucb_step`` against the jitted ``linucb_step_ref`` (bitwise to the
Pallas kernel in interpret mode). On these CPU tensors the wrappers run
the plain versions; the CUDA kernels are held against them on the card
(``chip_smoke.py``, ``tests/test_torch_cuda.py``)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.linucb_score.ops import linucb_score as jscore  # noqa: E402
from repro.kernels.linucb_step.ref import linucb_step_ref as jstep_ref  # noqa: E402
from repro_torch.kernels import checks  # noqa: E402
from repro_torch.kernels.linucb_score import ops as score_ops  # noqa: E402
from repro_torch.kernels.linucb_step import ops as step_ops  # noqa: E402
from repro_torch.kernels.linucb_score.kernel import (  # noqa: E402
    TILE_ROWS, WIDTHS, score_plan,
)
from repro_torch.kernels.linucb_score.ref import linucb_score_ref  # noqa: E402
from repro_torch.kernels.linucb_step.kernel import route  # noqa: E402
from repro_torch.kernels.linucb_step.ref import (  # noqa: E402
    linucb_step_per_arm_ref, linucb_step_ref,
)


def _spd_inv(rng, lead, d):
    M = rng.standard_normal(lead + (d, d)) * 0.1
    A = np.einsum("...ij,...kj->...ik", M, M) + np.eye(d) * 1.2
    return A, np.linalg.inv(A)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("R,K,d", [(32, 3, 26), (100, 4, 26), (7, 8, 13)])
def test_score_ref_vs_jax(S, R, K, d):
    """Ragged R (100, 7) included: the JAX op pads rows to its block."""
    rng = np.random.default_rng(R + K + d + S)
    x = rng.standard_normal((S, R, d)).astype(np.float32)
    theta = (rng.standard_normal((S, K, d)) * 0.1).astype(np.float32)
    _, ainv = _spd_inv(rng, (S, K), d)
    ainv = ainv.astype(np.float32)
    pen = rng.uniform(0, 1, (S, K)).astype(np.float32)
    infl = rng.uniform(0.005, 1.0, (S, K)).astype(np.float32)
    alpha = rng.uniform(0.01, 0.1, S).astype(np.float32)
    score_ops.LAUNCHES[0] = 0
    got = score_ops.linucb_score(_t(x), _t(theta), _t(ainv), _t(pen),
                                 _t(infl), _t(alpha))
    assert score_ops.LAUNCHES[0] == 0          # CPU tensors: plain version
    assert got.shape == (S, R, K)
    for s in range(S):
        want = jscore(x[s], theta[s], ainv[s], pen[s], infl[s],
                      alpha=alpha[s], block_r=32, interpret=True)
        np.testing.assert_allclose(got[s].numpy(), np.asarray(want),
                                   rtol=2e-4, atol=2e-5)


def _step_operands(S, B=24, K=3, d=10, seed=7):
    """The JAX op's packed operands (hyper, clock and pacer rows, masks as
    i32 / f32) with a state axis, each state its own draw."""
    rng = np.random.default_rng(seed)
    _, A_inv = _spd_inv(rng, (S, K), d)
    A = np.linalg.inv(A_inv)
    b = rng.standard_normal((S, K, d)) * 0.1
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    hypf = np.tile([0.05, 0.997, 0.05, 0.05, 5.0, 0.0, 0.0, 0.0], (S, 1))
    hypf[:, 1] = rng.uniform(0.95, 1.0, S)
    return dict(
        A=f32(A), A_inv=f32(A_inv), b=f32(b),
        theta=f32(np.einsum("skij,skj->ski", A_inv, b)),
        last_upd=rng.integers(0, 50, (S, K)).astype(np.int32),
        x=f32(rng.standard_normal((S, B, d))),
        rewards=f32(rng.uniform(0, 1, (S, B, K))),
        costs=f32(rng.uniform(0, 1e-3, (S, B, K))),
        noise=f32(rng.uniform(0, 1e-7, (S, B, K))),
        forced=np.tile((np.arange(B) < 3).astype(np.int32), (S, 1)),
        cand=f32(rng.uniform(0, 1, (S, K)) > 0.2),
        pen=f32(rng.uniform(0, 0.5, (S, K))),
        infl=f32(rng.uniform(0.01, 1.0, (S, K))),
        hypf=f32(hypf),
        ints=np.stack([np.full(S, 60), rng.integers(0, K, S)],
                      1).astype(np.int32),
        pacer=f32(np.tile([0.2, 5e-4, 6.6e-4, 0.0], (S, 1))),
    )


def _port_operands(ops):
    """The port's operands (``ops.OPERANDS`` order) from the JAX op's
    packed ones: each packed column becomes its (S,) leaf, masks bool."""
    t = {k: _t(v, torch.int32 if v.dtype == np.int32 else torch.float32)
         for k, v in ops.items()}
    return (t["A"], t["A_inv"], t["b"], t["theta"], t["last_upd"], t["x"],
            t["rewards"], t["costs"], t["noise"], t["cand"] > 0, t["pen"],
            t["infl"], *t["hypf"][:, :5].unbind(1),
            *t["pacer"][:, :3].unbind(1), t["ints"][:, 0], t["ints"][:, 1],
            t["forced"] > 0)


def _jax_step(ops, s, num_valid, dt_max=4096):
    """The jitted JAX ref on state ``s`` of the packed operands: (A',
    A_inv', b', theta', last_upd', arms, r, c, lam', c_ema') unpacked."""
    one = {k: v[s] for k, v in ops.items()}
    for k in ("last_upd", "cand", "pen", "infl", "hypf", "ints", "pacer"):
        one[k] = one[k][None]
    one["forced"] = one["forced"][:, None]
    ref = jax.jit(functools.partial(jstep_ref, num_valid=num_valid,
                                    dt_max=dt_max))
    A, Ainv, b, theta, lu, arms, rc, pacer = (
        np.asarray(w) for w in ref(*(jnp.asarray(v) for v in one.values())))
    return (A, Ainv, b, theta, lu[0], arms[:, 0], rc[:, 0], rc[:, 1],
            pacer[0, 0], pacer[0, 1])


_STEP_OUT = ("A", "A_inv", "b", "theta", "last_upd", "arms", "r", "c", "lam",
             "c_ema")


@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("num_valid", [20, 24])
def test_step_ref_vs_jax(S, num_valid):
    """Arms and last_upd exact; stats, theta and pacer within 1e-4 (the
    contract of tests/test_kernels.py's fused-step checks)."""
    ops = _step_operands(S)
    got = linucb_step_ref(*_port_operands(ops), num_valid=num_valid,
                          dt_max=4096)
    for s in range(S):
        want = _jax_step(ops, s, num_valid)
        for n, g, w in zip(_STEP_OUT, got, want):
            g = g[s].numpy()
            if n in ("last_upd", "arms"):
                assert np.array_equal(g, w), n
            else:
                np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4,
                                           err_msg=n)


def test_step_op_packs_like_the_jax_op():
    """ops.linucb_step (the wrapper the router calls) on CPU tensors takes
    each of the JAX op's packed hyper / clock / pacer columns as its own
    (S,) leaf and the masks as bool, runs the plain version on them, and
    launches nothing; with every row valid it agrees with the JAX op."""
    S, B, K, d = 2, 9, 4, 6
    ops = _step_operands(S, B=B, K=K, d=d, seed=3)
    args = _port_operands(ops)
    assert len(args) == len(step_ops.OPERANDS)
    step_ops.LAUNCHES[0] = 0
    out = step_ops.linucb_step(*args, dt_max=4096)
    ref = linucb_step_ref(*args, num_valid=B, dt_max=4096)
    assert step_ops.LAUNCHES[0] == 0
    for g, w in zip(out, ref):
        assert torch.equal(g, w)
    for s in range(S):
        for n, g, w in zip(_STEP_OUT, out, _jax_step(ops, s, B)):
            np.testing.assert_allclose(g[s].numpy(), w, atol=1e-4,
                                       rtol=1e-4, err_msg=n)


def test_wrappers_refuse_mixed_or_bad_operands():
    with pytest.raises(ValueError):
        checks.on_cpu(torch.zeros(1), torch.zeros(1, device="meta"))
    with pytest.raises(ValueError):
        checks.cuda_operands("k", (1, 2, 200), x=(torch.zeros(1), (1,)))
    with pytest.raises(TypeError):
        checks.cuda_operands("k", (1, 2, 3), x=(torch.zeros(2, 3).double(),
                                                (2, 3)))
    with pytest.raises(ValueError):
        checks.cuda_operands("k", (1, 2, 3), x=(torch.zeros(3, 2).T, (2, 3)))


# Operand edits for the per-arm plain version: (name, B, dt_max, edit).
def _one_arm(ops):            # only arm 2 is a candidate: every row picks it
    ops["cand"][:] = 0.0
    ops["cand"][:, 2] = 1.0
    ops["forced"][:] = 0


def _never_chosen(ops):       # the last arm is never a candidate nor forced
    ops["cand"][:, -1] = 0.0
    ops["ints"][:, 1] = 0


_PER_ARM_CASES = {
    "one_arm": (24, 4096, _one_arm),
    "never_chosen": (24, 4096, _never_chosen),
    "forced_rows": (24, 4096, None),
    "dt_clipped": (24, 5, None),
    "one_row": (1, 4096, None),
}


@pytest.mark.parametrize("case", sorted(_PER_ARM_CASES))
def test_step_per_arm_ref(case):
    """The CUDA kernel's order in plain PyTorch (arm by arm in block
    order, the pacer folded apart) equals the serial plain version bit for
    bit, and JAX's ``linucb_step_ref`` within the 1e-4 contract (arms and
    last_upd exact)."""
    B, dt_max, edit = _PER_ARM_CASES[case]
    S, K = 3, 4
    ops = _step_operands(S, B=B, K=K, seed=11)
    if edit is not None:
        edit(ops)
    args = _port_operands(ops)
    got = linucb_step_per_arm_ref(*args, num_valid=B, dt_max=dt_max)
    serial = linucb_step_ref(*args, num_valid=B, dt_max=dt_max)
    for n, g, w in zip(_STEP_OUT, got, serial):
        assert torch.equal(g, w), n
    arms = got[5]
    if case == "one_arm":
        assert bool((arms == 2).all())
    if case == "never_chosen":
        assert not bool((arms == K - 1).any())
        assert torch.equal(got[4][:, K - 1], args[4][:, K - 1])
    if case == "forced_rows":
        assert bool((arms[:, :3] == args[21][:, None]).all())
    if case == "dt_clipped":
        assert bool(((args[20][:, None] - args[4]) > dt_max).any())
    for s in range(S):
        want = _jax_step(ops, s, B, dt_max)
        for n, g, w in zip(_STEP_OUT, got, want):
            g = g[s].numpy()
            if n in ("last_upd", "arms"):
                assert np.array_equal(g, w), n
            else:
                np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4,
                                           err_msg=n)


@pytest.mark.parametrize("S,R,K,d,dp,grid", [
    (20, 256, 8, 26, 32, (2, 8, 20)),      # the main path's served block
    (1, 4096, 8, 128, 128, (32, 8, 1)),    # the largest supported shape
    (3, 33, 3, 32, 32, (1, 3, 3)),
    (2, 300, 1, 33, 64, (3, 1, 2)),
    (1, 128, 5, 64, 64, (1, 5, 1)),
    (4, 129, 64, 100, 128, (2, 64, 4)),
    (1, 1, 1, 1, 32, (1, 1, 1)),
])
def test_score_plan(S, R, K, d, dp, grid):
    """DP is the smallest built width that holds d; the grid covers every
    row once with one block per (128-row tile, arm, state); the threads
    tile the block's rows and DP columns; a block fits in the 227 KB of
    shared memory a Hopper block may use."""
    plan = score_plan(S, R, K, d)
    assert plan["dp"] == dp and plan["grid"] == grid
    assert plan["dp"] in WIDTHS and d <= plan["dp"]
    assert all(w < d for w in WIDTHS if w < plan["dp"])
    # one thread per (DP / 16) x 8 micro-tile of the 128-row tile
    assert (TILE_ROWS // plan["rows_per_thread"]) * (plan["dp"] // 8) \
        == plan["threads"] == 256
    assert (grid[0] - 1) * TILE_ROWS < R <= grid[0] * TILE_ROWS
    assert plan["smem_bytes"] <= 232448


def test_step_route():
    """One launch for a single request (and an empty block), two chained
    launches for B > 1; the CPU path launches nothing on either."""
    assert [route(B) for B in (0, 1, 2, 13, 256)] == [
        "single", "single", "pdl", "pdl", "pdl"]
    before = dict(step_ops.ROUTE_LAUNCHES)
    step_ops.linucb_step(*_port_operands(_step_operands(1, B=1)))
    assert step_ops.ROUTE_LAUNCHES == before


@pytest.mark.parametrize("S,n", [(1, 1), (checks.MAX_STATES, 1),
                                 (checks.MAX_STATES + 1, 2), (200_000, 4)])
def test_state_slices(S, n):
    """The LinUCB kernels' launch plan: slices of at most MAX_STATES
    states (the grid's state axis), in order, covering the stack."""
    sl = checks.state_slices(S)
    assert len(sl) == n and sl[0][0] == 0 and sl[-1][1] == S
    assert all(a < z <= a + checks.MAX_STATES for a, z in sl)
    assert all(z == a2 for (_, z), (a2, _) in zip(sl, sl[1:]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.bool])
def test_state_ptr(dtype):
    """The address a slice's launch passes: that of state ``start``."""
    from repro_torch.kernels.linucb_score.kernel import state_ptr

    t = torch.zeros((5, 3, 2), dtype=dtype)
    for start in (0, 1, 4):
        assert state_ptr(t, start) == t[start].data_ptr()


@pytest.mark.parametrize("B", [1, 13])
def test_step_launch_in_slices_equals_whole(monkeypatch, B):
    """``_launch``'s slicing, on the CPU with slices of 3 states and the
    plain version in the kernel's place on each slice's states (the
    scores workspace allocated on ``pdl`` only): one launch is counted
    per slice, and the whole equals the unsliced plain run bit for
    bit."""
    monkeypatch.setattr(checks, "MAX_STATES", 3)
    seen = []

    def fake(ins, outs, scores, *, num_valid, dt_max, states):
        a, z = states
        seen.append((z - a, scores is None))
        ref = linucb_step_ref(*(t[a:z] for t in ins), num_valid=num_valid,
                              dt_max=dt_max)
        for o, w in zip(outs, ref):
            o[a:z] = w

    monkeypatch.setattr(step_ops, "linucb_step_blocked", fake)
    args = [a.contiguous() for a in _port_operands(_step_operands(6, B=B))]
    before, n_route = step_ops.LAUNCHES[0], step_ops.ROUTE_LAUNCHES[route(B)]
    got = step_ops._launch(args, 4096)
    assert seen == [(3, B == 1)] * 2
    assert step_ops.LAUNCHES[0] == before + 2
    assert step_ops.ROUTE_LAUNCHES[route(B)] == n_route + 2
    for g, w in zip(got, linucb_step_ref(*args, num_valid=B, dt_max=4096)):
        assert torch.equal(g, w)


def test_score_launch_in_slices_equals_whole(monkeypatch):
    monkeypatch.setattr(checks, "MAX_STATES", 3)
    seen = []

    def fake(x, theta, ainv, pen, infl, alpha, out, states, block_r):
        a, z = states
        assert block_r == TILE_ROWS
        seen.append(z - a)
        out[a:z] = linucb_score_ref(*(t[a:z] for t in (x, theta, ainv, pen,
                                                        infl, alpha)))

    monkeypatch.setattr(score_ops, "linucb_score_blocked", fake)
    rng = np.random.default_rng(0)
    S, R, K, d = 6, 20, 3, 10
    args = (_t(rng.standard_normal((S, R, d))),
            _t(rng.standard_normal((S, K, d))),
            _t(_spd_inv(rng, (S, K), d)[1]), _t(rng.uniform(0, 1, (S, K))),
            _t(rng.uniform(0.01, 1, (S, K))), _t(rng.uniform(0.01, 0.1, S)))
    before = score_ops.LAUNCHES[0]
    got = score_ops._launch(*args)
    assert seen == [3, 3] and score_ops.LAUNCHES[0] == before + 2
    assert torch.equal(got, linucb_score_ref(*args))

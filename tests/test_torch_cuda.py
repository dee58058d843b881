"""The port's CUDA kernels on the card: each against its plain version,
the fused closed loop against the torch oracle, and the served
portfolio. Marked ``cuda``; without a GPU every test skips (the decision
is taken inside the fixture, never at import). On a machine with a card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import evaluate, router, simulator  # noqa: E402
from repro_torch.core.types import RouterConfig  # noqa: E402
from repro_torch.kernels.linucb_score import ops as score_ops  # noqa: E402
from repro_torch.kernels.linucb_score.ref import linucb_score_ref  # noqa: E402
from repro_torch.kernels.linucb_step import ops as step_ops  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inv(rng, S, K, d):
    M = rng.standard_normal((S, K, d, d)) * 0.1
    return np.linalg.inv(np.einsum("skij,sklj->skil", M, M) + np.eye(d) * 1.2)


@pytest.mark.parametrize("S,R,K,d", [
    (1, 1, 1, 2), (3, 33, 3, 26), (2, 300, 8, 128), (4, 7, 5, 13),
    # every built width (DP 32 / 64 / 128) and its edges, K 1 / 3 / 8,
    # R not a multiple of the 128-row tile, S > 1
    (20, 256, 8, 26), (1, 4096, 8, 128), (2, 129, 1, 32), (3, 200, 3, 100),
    (2, 130, 8, 33), (3, 127, 8, 64), (2, 257, 3, 65), (1, 1000, 1, 128)])
def test_score_kernel_matches_plain(dev, S, R, K, d):
    rng = np.random.default_rng(S * R + d)
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,  # noqa: E731
                                  device=dev)
    args = (f(rng.standard_normal((S, R, d))),
            f(rng.standard_normal((S, K, d)) * 0.1), f(_inv(rng, S, K, d)),
            f(rng.uniform(0, 1, (S, K))), f(rng.uniform(0.005, 1, (S, K))),
            f(rng.uniform(0.01, 0.1, S)))
    n = score_ops.LAUNCHES[0]
    got = score_ops.linucb_score(*args)
    assert score_ops.LAUNCHES[0] == n + 1
    torch.testing.assert_close(got, linucb_score_ref(*args), rtol=2e-4,
                               atol=2e-5)


@pytest.mark.parametrize("one_arm", [False, True])
@pytest.mark.parametrize("S,B,K,d", [
    (1, 1, 3, 8), (3, 13, 4, 26), (2, 64, 8, 128),
    # B = 1 (the single launch) and B > 1 (score + update chained), both
    # update layouts (one warp at d <= 32, 256 threads above), B past the
    # 32- and 256-row request chunks
    (20, 1, 8, 26), (4, 1, 8, 128), (5, 256, 8, 26), (2, 256, 8, 128),
    (3, 300, 8, 26), (2, 300, 4, 128), (2, 40, 3, 33)])
def test_step_kernel_matches_plain(dev, S, B, K, d, one_arm):
    """Arms and last_upd exact, everything else within 1e-4, on each
    route; with ``one_arm`` every request chooses arm 1 (the only
    candidate), so the busiest arm takes the whole block's chain."""
    from repro_torch.kernels.linucb_step.kernel import route

    rng = np.random.default_rng(B + d)
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,  # noqa: E731
                                  device=dev)
    Ainv = _inv(rng, S, K, d)
    b = rng.standard_normal((S, K, d)) * 0.1
    vec = lambda v: f(np.full(S, v))  # noqa: E731
    args = [f(np.linalg.inv(Ainv)), f(Ainv), f(b),
            f(np.einsum("skij,skj->ski", Ainv, b)),
            torch.as_tensor(rng.integers(0, 50, (S, K)), dtype=torch.int32,
                            device=dev),
            f(rng.standard_normal((S, B, d))), f(rng.uniform(0, 1, (S, B, K))),
            f(rng.uniform(0, 1e-3, (S, B, K))),
            f(rng.uniform(0, 1e-7, (S, B, K))),
            torch.ones((S, K), dtype=torch.bool, device=dev)
            if not one_arm else
            (torch.arange(K, device=dev) == min(1, K - 1))[None]
            .expand(S, K).contiguous(),
            f(rng.uniform(0, 0.5, (S, K))), f(rng.uniform(0.01, 1, (S, K))),
            vec(0.05), vec(0.997), vec(0.05), vec(0.05), vec(5.0),
            vec(0.2), vec(5e-4), vec(6.6e-4),
            torch.full((S,), 60, dtype=torch.int32, device=dev),
            torch.full((S,), min(1, K - 1), dtype=torch.int32, device=dev),
            (torch.arange(B, device=dev) < 2)[None].expand(S, B).contiguous()]
    n, which = step_ops.LAUNCHES[0], route(B)
    n_route = step_ops.ROUTE_LAUNCHES[which]
    got = step_ops.linucb_step(*args)
    assert step_ops.LAUNCHES[0] == n + 1
    assert step_ops.ROUTE_LAUNCHES[which] == n_route + 1
    want = step_ops.linucb_step(*(a.cpu() for a in args))
    if one_arm:
        assert bool((want[5] == min(1, K - 1)).all())
    for g, w in zip(got, want):
        if g.dtype == torch.int32:
            assert torch.equal(g.cpu(), w)
        else:
            torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("batch_size", [None, 16])
def test_fused_run_matches_oracle(dev, batch_size):
    b = simulator.make_benchmark(
        seed=0, splits={"train": 256, "val": 16, "test": 128}, device=dev)
    priors = evaluate.fit_warmup_priors(RouterConfig(), b.train)
    res = {}
    for bk in ("torch", "fused"):
        res[bk] = evaluate.run(RouterConfig(backend=bk), b.test, 6.6e-4,
                               seeds=(0, 1, 2), priors=priors, n_eff=1164.0,
                               batch_size=batch_size)
    assert (res["torch"].arms == res["fused"].arms).mean() >= 0.99
    assert abs(res["torch"].mean_reward - res["fused"].mean_reward) < 1e-3


def test_select_batch_score_backend_on_card(dev):
    b = simulator.make_benchmark(
        seed=1, splits={"train": 256, "val": 64, "test": 64}, device=dev)
    cfg = RouterConfig()
    _, st = evaluate.run(cfg, b.test, 6.6e-4, seeds=(0, 1), batch_size=16,
                         priors=evaluate.fit_warmup_priors(cfg, b.train),
                         n_eff=1164.0, return_states=True)
    xs, _, _, _ = evaluate.build_run_streams(cfg, b.val, (0, 1))
    dec, _ = router.select_batch(RouterConfig(backend="score"), st, xs)
    ref, _ = router.select_batch(RouterConfig(backend="torch"), st, xs)
    assert (dec.scores - ref.scores).abs().max() <= 1e-4


def _scenario_bench(dev):
    b = simulator.make_benchmark(
        seed=0, splits={"train": 256, "val": 16, "test": 128}, device=dev)
    env4 = simulator.extend_with_flash(b.test, "good_cheap")
    return env4, evaluate.fit_warmup_priors(RouterConfig(), b.train) + [None]


@pytest.mark.parametrize("batch_size", [None, 16])
def test_scenario_on_card_matches_cpu_plain(dev, batch_size):
    """A multi-event scenario through the step kernel on the card against
    the same run through its plain version on the CPU."""
    from repro_torch.core.scenario import (
        AddArm, BudgetChange, HyperShift, PriceChange, QualityShift,
        ScenarioSpec,
    )
    env4, priors = _scenario_bench(dev)
    spec = ScenarioSpec(horizon=192, events=(
        AddArm(32, 3), PriceChange(64, 2, 1 / 56, recalibrate=True),
        QualityShift(96, 1, 0.7), BudgetChange(128, 3.0e-4),
        HyperShift(160, gamma=0.99)), stream_seed_base=50, init_active=3)
    cpu_priors = [None if p is None else type(p)(p.A_off.cpu(), p.b_off.cpu())
                  for p in priors]
    n = step_ops.LAUNCHES[0]
    got = evaluate.run_scenario(RouterConfig(), spec, env4, 6.6e-4,
                                seeds=(0, 1, 2), priors=priors, n_eff=1164.0,
                                batch_size=batch_size)
    assert step_ops.LAUNCHES[0] > n
    want = evaluate.run_scenario(RouterConfig(), spec, env4, 6.6e-4,
                                 seeds=(0, 1, 2), priors=cpu_priors,
                                 n_eff=1164.0, batch_size=batch_size,
                                 device="cpu")
    assert got.bounds == want.bounds
    assert (got.arms == want.arms).mean() >= 0.99
    assert abs(got.mean_reward - want.mean_reward) < 1e-3


@pytest.mark.parametrize("batch_size", [None, 16])
def test_timeline_identity_on_card(dev, batch_size):
    """On the card too, a timeline run is identical to the concrete
    retimed spec's run on its live steps."""
    from repro_torch.core.scenario import (
        AddArm, BudgetChange, PriceChange, ScenarioSpec, Timeline, retime,
    )
    env4, priors = _scenario_bench(dev)
    spec = ScenarioSpec(horizon=192, events=(
        PriceChange(48, 2, 0.1), AddArm(96, 3), BudgetChange(144, 3.0e-4)),
        stream_seed_base=51, init_active=3)
    tl = Timeline((32, 80, 112), horizon=160)
    kw = dict(seeds=(0, 1, 2), priors=priors, n_eff=1164.0,
              batch_size=batch_size)
    base = evaluate.run_scenario(RouterConfig(), retime(spec, tl), env4,
                                 6.6e-4, **kw)
    masked = evaluate.run_scenario(RouterConfig(), spec, env4, 6.6e-4,
                                   timeline=tl, **kw)
    for f in ("arms", "rewards", "costs", "lams"):
        np.testing.assert_array_equal(getattr(masked, f), getattr(base, f))
    assert masked.bounds == base.bounds


ATTN_TOL ={torch.float32: dict(rtol=2e-4, atol=2e-5),
            torch.bfloat16: dict(rtol=5e-2, atol=5e-2)}
# Each output row's max error against that row's RMS (chip_smoke.py's
# ATTN_ROW_REL_TOL): random inputs give long rows an RMS below the
# absolute tolerance, where a dropped tile or split would still pass it.
ATTN_ROW_REL_TOL = {torch.float32: 1e-3, torch.bfloat16: 0.1}


def assert_attn_close(got, want, dtype):
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL[dtype])
    diff = (got.float() - want.float()).abs().amax(-1)
    rel = diff / want.float().pow(2).mean(-1).sqrt()
    assert float(rel.max()) <= ATTN_ROW_REL_TOL[dtype], float(rel.max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,hd,mode,window", [
    (1, 33, 4, 4, 64, "causal", 0), (2, 100, 8, 2, 32, "sliding", 17),
    (1, 64, 8, 1, 128, "full", 0), (2, 130, 6, 3, 48, "causal", 0),
    # the served prefills (olmo-1b, deepseek-67b: G = 8 on KV = 8)
    (1, 32, 16, 16, 128, "causal", 0), (1, 32, 64, 8, 128, "causal", 0),
    # ragged query tiles around the 128-row tile, hd 48 / 64 / 128
    (1, 1, 8, 8, 128, "causal", 0), (1, 127, 16, 16, 64, "causal", 0),
    (1, 128, 8, 2, 48, "causal", 0), (2, 129, 8, 8, 128, "causal", 0),
    (1, 300, 64, 8, 128, "causal", 0),
    # windows that cross tile edges
    (1, 300, 8, 2, 64, "sliding", 1), (1, 300, 8, 2, 128, "sliding", 63),
    (2, 300, 8, 2, 128, "sliding", 130),
    # full mode, T not a multiple of the 64-key tile
    (1, 100, 4, 2, 48, "full", 0), (2, 129, 8, 8, 128, "full", 0),
    # hd % 8 != 0: bf16 takes the FP32 FMA route
    (1, 40, 4, 2, 36, "causal", 0)])
def test_flash_kernel_matches_plain(dev, dtype, B, S, H, KV, hd, mode,
                                    window):
    """Each route against the plain version; bf16 with hd % 8 == 0 must
    take the tensor cores, everything else the FP32 FMA kernel."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.kernel import route
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    g = torch.Generator(device=dev).manual_seed(S + hd)
    q, k, v = (torch.randn(s, generator=g, device=dev, dtype=dtype)
               for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    which = route(dtype, hd)
    assert (which == "tensor_cores") == (dtype == torch.bfloat16
                                         and hd % 8 == 0)
    n, n_route = fa_ops.LAUNCHES[0], fa_ops.ROUTE_LAUNCHES[which]
    got = fa_ops.flash_attention(q, k, v, mode=mode, window=window)
    assert fa_ops.LAUNCHES[0] == n + 1
    assert fa_ops.ROUTE_LAUNCHES[which] == n_route + 1
    want = flash_attention_ref(q, k, v, mode=mode, window=window)
    assert_attn_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,W,H,KV,hd,pos,window", [
    (1, 40, 4, 4, 64, 33, 0), (2, 136, 8, 2, 128, 130, 0),
    (1, 300, 16, 2, 32, 1000, 100),
    # the served tokens: olmo-1b G = 1, deepseek-67b G = 8
    (1, 40, 16, 16, 128, 39, 0), (1, 40, 64, 8, 128, 39, 0),
    # whole splits invalid next to valid ones
    (1, 4096, 64, 8, 128, 5000, 3000),
    (3, 200, 6, 3, 48, 150, 0),
    # bf16 off the tensor cores (hd % 16 != 0): rows that are not 16-byte
    # multiples (hd 36) and rows that are (hd 24)
    (1, 40, 4, 2, 36, 33, 0), (2, 100, 8, 4, 24, 90, 0)])
def test_decode_kernel_matches_plain(dev, dtype, B, W, H, KV, hd, pos,
                                     window):
    """The op (its own split plan) and the kernels at n_split = 1, 2 and
    one split per tile, against the plain version, on both of the split
    kernel's paths (bf16 with hd % 16 == 0 on the tensor cores, K / V
    staged by cp.async; everything else element by element on FP32
    FMAs)."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention.kernel import (
        TILE, decode_attention_bkv, sm_count, split_plan,
    )
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.models.attention import ring_valid

    g = torch.Generator(device=dev).manual_seed(W + hd)
    q, kc, vc = (torch.randn(s, generator=g, device=dev, dtype=dtype)
                 for s in ((B, 1, H, hd), (B, W, KV, hd), (B, W, KV, hd)))
    valid = ring_valid(pos, W, window, dev)
    n = da_ops.LAUNCHES[0]
    got = da_ops.decode_attention(q, kc, vc, valid)
    assert da_ops.LAUNCHES[0] == n + 1
    want = decode_attention_ref(q, kc, vc, valid)
    assert_attn_close(got, want, dtype)
    tiles = -(-W // TILE)
    plans = {split_plan(B, W, KV, sm_count(dev.index or 0)), (1, tiles),
             (tiles, 1), (-(-tiles // -(-tiles // 2)), -(-tiles // 2))}
    G = H // KV
    for n_split, per in sorted(plans):
        ws = (None, None)
        if n_split > 1:
            ws = (torch.empty((B, KV, n_split, G, hd), device=dev),
                  torch.empty((B, KV, n_split, G, 2), device=dev))
        out = torch.empty_like(q)
        decode_attention_bkv(q, kc, vc, valid, out, *ws, n_split=n_split,
                             tiles_per_split=per, scale=1.0 / hd ** 0.5)
        assert_attn_close(out, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,W,H,KV,hd", [(1, 1024, 16, 2, 128),
                                         (2, 300, 8, 4, 24)])
def test_decode_kernel_without_valid_slot(dev, dtype, B, W, H, KV, hd):
    """A row with no valid slot gives the mean of V over the W slots of
    its kv head, as the plain version and JAX's reference do: through
    the op (several splits, so the combine takes it), and at n_split = 1
    (the split kernel's epilogue) and one split per tile."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention.kernel import (
        TILE, decode_attention_bkv, sm_count, split_plan,
    )
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    g = torch.Generator(device=dev).manual_seed(W + hd)
    q, kc, vc = (torch.randn(s, generator=g, device=dev, dtype=dtype)
                 for s in ((B, 1, H, hd), (B, W, KV, hd), (B, W, KV, hd)))
    valid = torch.zeros(W, dtype=torch.bool, device=dev)
    want = decode_attention_ref(q, kc, vc, valid)
    mean = vc.float().mean(1).repeat_interleave(H // KV, dim=1)[:, None]
    torch.testing.assert_close(want.float(), mean, **ATTN_TOL[dtype])
    assert split_plan(B, W, KV, sm_count(dev.index or 0))[0] > 1
    assert_attn_close(da_ops.decode_attention(q, kc, vc, valid), want, dtype)
    tiles = -(-W // TILE)
    G = H // KV
    for n_split, per in ((1, tiles), (tiles, 1)):
        ws = (None, None)
        if n_split > 1:
            ws = (torch.empty((B, KV, n_split, G, hd), device=dev),
                  torch.empty((B, KV, n_split, G, 2), device=dev))
        out = torch.empty_like(q)
        decode_attention_bkv(q, kc, vc, valid, out, *ws, n_split=n_split,
                             tiles_per_split=per, scale=1.0 / hd ** 0.5)
        assert_attn_close(out, want, dtype)


BF16, F32 = torch.bfloat16, torch.float32
SSD_TOL = {BF16: 0.08, F32: 2e-4}   # the JAX SSD tests' bars


def _ssd_inputs(dev, B, L, H, P, N, dtype, offset=0):
    """The SSD operands on the model's layout: x, B and C as views of one
    (B, L, offset + H P + 2 N) projection, as mamba2_forward passes them
    (``offset`` leading columns shift the views off 16-byte
    boundaries)."""
    g = torch.Generator(device=dev).manual_seed(L + P + N)
    xBC = torch.randn((B, L, offset + H * P + 2 * N), generator=g,
                      device=dev, dtype=dtype)[..., offset:]
    xs, Bi, Ci = torch.split(xBC, [H * P, N, N], dim=-1)
    dt = torch.rand((B, L, H), generator=g, device=dev) * 0.099 + 0.001
    A = -(torch.rand((H,), generator=g, device=dev) * 3.5 + 0.5)
    D = torch.randn((H,), generator=g, device=dev)
    return xs.reshape(B, L, H, P), dt, A, Bi, Ci, D


def _assert_ssd_close(got, want, dtype):
    y, h = got
    assert y.dtype == dtype and h.dtype == torch.float32
    tol = SSD_TOL[dtype]
    torch.testing.assert_close(y.float(), want[0].float(), rtol=tol,
                               atol=tol)
    torch.testing.assert_close(h, want[1], rtol=tol, atol=tol)


@pytest.mark.parametrize("B,L,H,P,N,chunk,dtype,route", [
    # the served prompts (pad to 32, kept up to 128): one chunk
    (1, 32, 32, 64, 128, 128, BF16, "one_chunk"),
    (1, 64, 32, 64, 128, 128, BF16, "one_chunk"),
    (1, 96, 32, 64, 128, 128, BF16, "one_chunk"),
    (1, 128, 32, 64, 128, 128, BF16, "one_chunk"),
    (1, 1, 8, 64, 128, 128, BF16, "one_chunk"),
    # long prompts: the chunk-parallel route, ragged last chunks
    (1, 2048, 32, 64, 128, 128, BF16, "chunked"),
    (1, 129, 8, 64, 128, 128, BF16, "chunked"),
    (1, 256, 8, 64, 128, 128, BF16, "chunked"),
    (1, 300, 8, 64, 128, 128, BF16, "chunked"),
    (1, 300, 3, 64, 128, 128, BF16, "chunked"),
    # chunks that are not 16-row multiples, and small ones
    (1, 100, 4, 64, 128, 40, BF16, "chunked"),
    (1, 50, 4, 64, 128, 8, BF16, "chunked"),
    # other widths, B = 2
    (2, 100, 4, 24, 64, 32, BF16, "chunked"),
    (2, 40, 4, 24, 16, 16, BF16, "chunked"),
    (2, 20, 4, 32, 16, 128, BF16, "one_chunk"),
    # N % 16 != 0: bf16 on the FP32-FMA route
    (1, 40, 4, 24, 24, 16, BF16, "fma"),
    (1, 24, 4, 32, 24, 128, BF16, "fma"),
    # f32 takes the FP32-FMA route
    (2, 40, 4, 8, 16, 16, F32, "fma"),
    (1, 32, 32, 64, 128, 128, F32, "fma"),
    (1, 300, 4, 64, 128, 128, F32, "fma"),
])
def test_ssd_kernel_matches_plain(dev, B, L, H, P, N, chunk, dtype, route):
    """The op against its plain version on the model's layout, on the
    route its plan picks (asserted through the route counter).
    Tolerance: the JAX SSD tests' 2e-4 (f32) and 0.08 (bf16 inputs), on y
    and on the final state."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    args = _ssd_inputs(dev, B, L, H, P, N, dtype)
    n, n_route = ssd_ops.LAUNCHES[0], ssd_ops.ROUTE_LAUNCHES[route]
    got = ssd_ops.ssd_scan(*args, chunk=chunk)
    assert ssd_ops.LAUNCHES[0] == n + 1
    assert ssd_ops.ROUTE_LAUNCHES[route] == n_route + 1
    _assert_ssd_close(got, ssd_scan_ref(*args, chunk=min(chunk, L)), dtype)


@pytest.mark.parametrize("L,chunk", [(32, 128), (300, 128)])
def test_ssd_kernel_misaligned_view(dev, L, chunk):
    """bf16 views whose data is off 16-byte boundaries cannot be staged by
    16-byte copies: the plan sends them to the FP32-FMA route."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    args = _ssd_inputs(dev, 1, L, 4, 64, 128, BF16, offset=1)
    assert args[0].data_ptr() % 16
    n = ssd_ops.ROUTE_LAUNCHES["fma"]
    got = ssd_ops.ssd_scan(*args, chunk=chunk)
    assert ssd_ops.ROUTE_LAUNCHES["fma"] == n + 1
    _assert_ssd_close(got, ssd_scan_ref(*args, chunk=min(chunk, L)), BF16)


@pytest.mark.parametrize("G,TP", [(1, 8), (2, 64), (3, 32), (4, 16)])
@pytest.mark.parametrize("B,L,H,P,N,chunk", [
    (1, 300, 3, 64, 128, 128), (2, 32, 5, 32, 64, 32),
    (1, 70, 9, 64, 32, 48)])
def test_ssd_kernel_plans_match_plain(dev, G, TP, B, L, H, P, N, chunk):
    """The tensor-core kernels under plans the heuristic may not pick:
    heads per block that do not divide H, P tiles from 8 columns to wider
    than P (the tile's columns past P are masked), several chunks and
    one."""
    from repro_torch.kernels.ssd_scan.kernel import (
        ssd_plan, ssd_scan_bhp, workspace,
    )
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    args = _ssd_inputs(dev, B, L, H, P, N, BF16)
    chunk = min(chunk, L)
    plan = dict(ssd_plan(B, L, H, P, N, chunk, BF16, True),
                heads_per_block=G, p_tile=TP)
    assert plan["tensor_cores"]
    y = torch.empty_like(args[0])
    h = torch.empty((B, H, N, P), device=dev)
    ssd_scan_bhp(*args, y, h, *workspace(plan, B, H, N, P, dev), plan=plan)
    _assert_ssd_close((y, h), ssd_scan_ref(*args, chunk=chunk), BF16)


def test_portfolio_serves_on_card(dev):
    """The JAX driver's trio as a SMOKE portfolio served on the card
    through the kernels: every request generates, both attention kernels
    and the SSD scan launch, and the kernel route's prefill logits agree
    with the plain route's."""
    from repro_torch import configs
    from repro_torch.core.costs import price_from_active_params
    from repro_torch.core.features import fit_pca_whitener, hash_encode_batch
    from repro_torch.data import make_request_stream
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.serving import PortfolioServer, ServedModel

    arms = ("olmo-1b", "mamba2-370m", "deepseek-67b")
    models = [ServedModel.init(
        configs.get_smoke(a),
        price_from_active_params(a, configs.get_config(a).active_params(),
                                 mean_req_tokens=600),
        tier, seed=i, device=dev)
        for i, (a, tier) in enumerate(zip(arms, ("budget", "mid",
                                                 "frontier")))]
    corpus = [r["prompt"] for r in make_request_stream(200, seed=7)]
    srv = PortfolioServer(models, fit_pca_whitener(hash_encode_batch(corpus),
                                                   device=dev),
                          budget=6.6e-4, max_new_tokens=4, device=dev)
    fa0, da0, ssd0 = (fa_ops.LAUNCHES[0], da_ops.LAUNCHES[0],
                      ssd_ops.LAUNCHES[0])
    res = srv.serve_batch(make_request_stream(8, seed=11))
    assert len(res) == 8 and all(r.tokens_out == 4 for r in res)
    assert fa_ops.LAUNCHES[0] > fa0 and da_ops.LAUNCHES[0] > da0
    assert ssd_ops.LAUNCHES[0] > ssd0
    from repro_torch.models import prefill_forward

    toks = torch.arange(2, 34, device=dev)[None]
    for m in models:
        got, _ = prefill_forward(m.params, m.cfg, toks, impl="cuda")
        want, _ = prefill_forward(m.params, m.cfg, toks, impl="chunked")
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)

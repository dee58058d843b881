"""The port's attention against the JAX package's, on the CPU in f32.

The plain versions of the two CUDA kernels (``flash_attention``,
``decode_attention``; on CPU tensors their wrappers run them) are held
against the JAX Pallas ops in interpret mode, as ``tests/test_kernels.py``
runs them, and against JAX's ``naive_attention`` / ``_masked_decode``:
causal, sliding and full masks, MHA and GQA (H = 8, KV = 2), ragged S and
W, a wrapped ring buffer. Tolerance: rtol 2e-4, atol 2e-5, the f32 bar of
``tests/test_kernels.py``. The kernels themselves are held against the
same plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.decode_attention.ops import decode_attention as jdecode  # noqa: E402
from repro.kernels.flash_attention.ops import flash_attention as jflash  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import checks  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.models import attention  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-5)


def _qkv(seed, B, S, T, H, KV, hd):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, S, H, hd), (B, T, KV, hd), (B, T, KV, hd)))


@pytest.mark.parametrize("mode,window", [("causal", 0), ("sliding", 12),
                                         ("full", 0)])
@pytest.mark.parametrize("B,S,H,KV,hd", [(2, 32, 4, 4, 16),   # MHA
                                         (1, 40, 8, 2, 32),   # GQA, ragged
                                         (2, 64, 8, 2, 16)])  # GQA
def test_flash_plain_matches_jax(mode, window, B, S, H, KV, hd):
    q, k, v = _qkv(S + H + hd, B, S, S, H, KV, hd)
    got = fa_ops.flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                                 torch.as_tensor(v), mode=mode, window=window)
    assert got.dtype == torch.float32 and got.shape == (B, S, H, hd)
    pos = jnp.arange(S)
    naive = jattn.naive_attention(q, k, v, pos, pos, mode, window)
    np.testing.assert_allclose(got.numpy(), np.asarray(naive), **TOL)
    # The Pallas op in interpret mode; full mode needs S % block_kv == 0.
    blk = 16 if mode != "full" or S % 16 == 0 else 8
    pallas = jflash(q, k, v, mode=mode, window=window, block_q=blk,
                    block_kv=blk)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)


@pytest.mark.parametrize("impl", ["naive", "chunked", "cuda"])
def test_attention_routes_agree(impl):
    """The model's three routes (``cuda`` runs the kernel's plain version
    on the CPU) against JAX's chunked route, GQA and sliding window."""
    q, k, v = _qkv(3, 2, 48, 48, 8, 2, 16)
    pos = np.arange(48)
    want = jattn.chunked_attention(q, k, v, jnp.asarray(pos), jnp.asarray(pos),
                                   "sliding", 20, q_block=16, kv_block=16)
    tq, tk, tv = map(torch.as_tensor, (q, k, v))
    tpos = torch.as_tensor(pos)
    if impl == "naive":
        got = attention.naive_attention(tq, tk, tv, tpos, tpos, "sliding", 20)
    elif impl == "chunked":
        got = attention.chunked_attention(tq, tk, tv, tpos, tpos, "sliding",
                                          20, q_block=16, kv_block=16)
    else:
        got = fa_ops.flash_attention(tq, tk, tv, mode="sliding", window=20)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _ring_valid_jax(pos, W, window):
    idx = jnp.arange(W)
    wraps = (pos - idx) // W
    abs_pos = idx + wraps * W
    valid = (abs_pos >= 0) & (abs_pos <= pos) & (abs_pos > pos - W)
    if window > 0:
        valid &= abs_pos > pos - window
    return np.array(valid)


@pytest.mark.parametrize("pos,W,window", [(0, 8, 0), (5, 8, 0), (7, 8, 0),
                                          (8, 8, 0), (19, 8, 0), (19, 8, 5),
                                          (30, 40, 0), (30, 40, 12)])
def test_ring_valid_matches_jax(pos, W, window):
    """Floor division of the negative (pos - idx) // W included."""
    got = attention.ring_valid(pos, W, window, "cpu").numpy()
    np.testing.assert_array_equal(got, _ring_valid_jax(pos, W, window))


@pytest.mark.parametrize("B,W,H,KV,hd,pos,window", [
    (2, 40, 8, 2, 32, 33, 0),     # GQA G = 4, ragged W, unwritten tail
    (1, 24, 4, 4, 16, 50, 0),     # MHA, wrapped ring
    (2, 32, 8, 2, 16, 70, 20),    # GQA, wrapped ring inside a window
    (1, 136, 4, 1, 32, 129, 0),   # G = 4 on one kv head, W past a tile
])
def test_decode_plain_matches_jax(B, W, H, KV, hd, pos, window):
    rng = np.random.default_rng(W + pos)
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    kc = rng.standard_normal((B, W, KV, hd)).astype(np.float32)
    vc = rng.standard_normal((B, W, KV, hd)).astype(np.float32)
    valid = _ring_valid_jax(pos, W, window)
    assert 0 < valid.sum() <= W
    got = da_ops.decode_attention(
        torch.as_tensor(q), torch.as_tensor(kc), torch.as_tensor(vc),
        torch.as_tensor(valid))
    assert got.shape == (B, 1, H, hd)
    masked = jattn._masked_decode(q, kc, vc, jnp.asarray(valid), 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(masked), **TOL)
    pallas = jdecode(q, kc, vc, jnp.asarray(valid), block_kv=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    # The model's plain decode routes on the same inputs.
    tq, tk, tv = map(torch.as_tensor, (q, kc, vc))
    tval = torch.as_tensor(valid)
    for out in (attention._masked_decode(tq, tk, tv, tval, 16),
                attention._einsum_decode(tq, tk, tv, tval)):
        np.testing.assert_allclose(out.numpy(), np.asarray(masked), **TOL)


def test_attention_operand_checks():
    """What the CUDA wrappers refuse before a launch (checked here on CPU
    tensors; the device check is the same)."""
    f = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt)  # noqa: E731
    ok = dict(q=(f(1, 4, 2, 8), (1, 4, 2, 8)), k=(f(1, 4, 1, 8), (1, 4, 1, 8)))
    checks.attention_operands("t", 8, 2, 1, **ok)
    with pytest.raises(ValueError):
        checks.attention_operands("t", 160, 2, 1, **ok)        # hd > 128
    with pytest.raises(ValueError):
        checks.attention_operands("t", 8, 3, 2, **ok)          # H % KV
    with pytest.raises(TypeError):
        half = f(1, 4, 2, 8, dt=torch.float16)
        checks.attention_operands("t", 8, 2, 1, q=(half, (1, 4, 2, 8)))
    with pytest.raises(TypeError):
        checks.attention_operands(
            "t", 8, 2, 1, q=ok["q"],
            k=(f(1, 4, 1, 8, dt=torch.bfloat16), (1, 4, 1, 8)))
    with pytest.raises(ValueError):
        nc = f(1, 8, 4, 2).transpose(1, 3)
        checks.attention_operands("t", 8, 2, 1, q=(nc, (1, 2, 4, 8)))
    with pytest.raises(ValueError):
        fa_ops.flash_attention(*(f(1, 4, 2, 8),) * 3, mode="banded")


@pytest.mark.parametrize("B,W,KV,n_sm,want", [
    (1, 4096, 8, 132, (32, 2)),    # deepseek-67b's KV at a long cache
    (1, 40, 16, 132, (1, 1)),      # the served token: one tile
    (1, 136, 16, 132, (3, 1)),     # fewer tiles than the waves want
    (8, 4096, 8, 132, (5, 13)),    # B * KV = 64: 5 splits of 13 tiles
    (64, 4096, 8, 132, (1, 64)),   # B * KV fills the card alone
    (1, 100, 2, 132, (2, 1)),      # ragged last tile
    (1, 4096, 1, 4, (8, 8)),       # a small card
])
def test_split_plan(B, W, KV, n_sm, want):
    """The decode wrapper's split over the cache: every split gets at
    least one tile, all tiles are covered, and blocks reach about two
    waves of the SMs where the tiles allow."""
    from repro_torch.kernels.decode_attention.kernel import TILE, split_plan

    n_split, per = split_plan(B, W, KV, n_sm)
    assert (n_split, per) == want
    tiles = -(-W // TILE)
    assert n_split * per >= tiles > (n_split - 1) * per
    assert B * KV * n_split >= min(2 * n_sm, B * KV * tiles) // 2


def _split_plans(B, W, KV):
    """The plan of a 132-SM card, one split, one split per tile, and two
    uneven ones."""
    from repro_torch.kernels.decode_attention.kernel import TILE, split_plan

    tiles = -(-W // TILE)
    plans = {split_plan(B, W, KV, 132), (1, tiles), (tiles, 1)}
    for per in (2, 3):
        if per < tiles:
            plans.add((-(-tiles // per), per))
    return sorted(plans)


@pytest.mark.parametrize("B,W,H,KV,hd,pos,window", [
    (1, 40, 8, 8, 32, 39, 0),       # the served shape, cut in width
    (1, 1024, 16, 2, 32, 1500, 600),  # wholly invalid splits beside valid
    (2, 200, 8, 2, 16, 150, 0),     # ragged W, unwritten tail, G = 4
    (1, 300, 4, 1, 32, 1000, 100),  # one valid tile of five
    (2, 136, 8, 4, 16, 129, 0),     # W past a tile, G = 2
])
def test_decode_split_ref_matches_jax(B, W, H, KV, hd, pos, window):
    """The kernels' two passes in plain PyTorch, at several n_split
    (including splits with no valid slot), against the one-pass plain
    version, JAX's ``_masked_decode`` and JAX's Pallas op in interpret
    mode, at the f32 tolerance."""
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_ref, decode_attention_split_ref,
    )

    rng = np.random.default_rng(W + pos + hd)
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    kc = rng.standard_normal((B, W, KV, hd)).astype(np.float32)
    vc = rng.standard_normal((B, W, KV, hd)).astype(np.float32)
    valid = _ring_valid_jax(pos, W, window)
    tq, tk, tv, tval = map(torch.as_tensor, (q, kc, vc, valid))
    one_pass = decode_attention_ref(tq, tk, tv, tval).numpy()
    masked = np.asarray(jattn._masked_decode(q, kc, vc, jnp.asarray(valid),
                                             16))
    pallas = np.asarray(jdecode(q, kc, vc, jnp.asarray(valid), block_kv=16))
    plans = _split_plans(B, W, KV)
    assert len(plans) >= min(3, -(-W // 64))
    for n_split, per in plans:
        got = decode_attention_split_ref(tq, tk, tv, tval, n_split,
                                         per).numpy()
        assert got.shape == (B, 1, H, hd)
        for want in (one_pass, masked, pallas):
            np.testing.assert_allclose(got, want, **TOL)


def test_decode_split_ref_without_valid_slot():
    """A row with no valid slot, which the model never produces: the two
    passes (at n_split 1, 3 and 5; the combine sees m = -1e30 from every
    split) and the one-pass version give the mean of V over the W slots of
    each kv head, as JAX's ``decode_attention_ref`` (every p = exp(0))."""
    from repro.kernels.decode_attention.ref import (
        decode_attention_ref as jref,
    )
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_ref, decode_attention_split_ref,
    )

    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((1, 1, 4, 8), (1, 130, 2, 8), (1, 130, 2, 8)))
    valid = np.zeros(130, dtype=bool)
    want = np.asarray(jref(q, k, v, jnp.asarray(valid)))
    mean = v.mean(axis=1).repeat(2, axis=1)[:, None]
    np.testing.assert_allclose(want, mean, **TOL)
    tq, tk, tv, tval = map(torch.as_tensor, (q, k, v, valid))
    for n_split, per in ((1, 3), (3, 1), (2, 2)):
        got = decode_attention_split_ref(tq, tk, tv, tval, n_split, per)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(decode_attention_ref(tq, tk, tv, tval).numpy(),
                               want, **TOL)


def test_decode_without_valid_slot_matches_jax_op():
    """The same at W = 512, one block of JAX's Pallas op (which pads W to
    its 512-slot block, so only there do the op and the reference agree):
    the two passes at several n_split against the op in interpret mode."""
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_split_ref,
    )

    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((1, 1, 4, 8), (1, 512, 2, 8), (1, 512, 2, 8)))
    valid = np.zeros(512, dtype=bool)
    pallas = np.asarray(jdecode(q, k, v, jnp.asarray(valid)))
    tq, tk, tv, tval = map(torch.as_tensor, (q, k, v, valid))
    for n_split, per in ((1, 8), (4, 2), (8, 1)):
        got = decode_attention_split_ref(tq, tk, tv, tval, n_split, per)
        np.testing.assert_allclose(got.numpy(), pallas, **TOL)


@pytest.mark.parametrize("dtype,hd,want", [
    (torch.bfloat16, 128, "tensor_cores"), (torch.bfloat16, 64,
                                            "tensor_cores"),
    (torch.bfloat16, 48, "tensor_cores"), (torch.bfloat16, 8,
                                           "tensor_cores"),
    (torch.bfloat16, 36, "fma"), (torch.bfloat16, 17, "fma"),
    (torch.float32, 128, "fma"), (torch.float32, 64, "fma"),
])
def test_flash_route(dtype, hd, want):
    """bf16 with hd % 8 == 0 goes to the tensor-core kernel (a TMA map's
    strides are multiples of 16 bytes); f32 and other hd to the FP32 FMA
    kernel, which keeps the f32 contract."""
    from repro_torch.kernels.flash_attention.kernel import ROUTES, route

    assert route(dtype, hd) == want
    assert want in ROUTES and set(fa_ops.ROUTE_LAUNCHES) == set(ROUTES)


def test_aligned16_check():
    """The tensor-core route refuses a view whose data is not 16-byte
    aligned (a TMA map's base address must be)."""
    t = torch.zeros(64, dtype=torch.bfloat16)
    checks.aligned16("t", a=t[8:])
    with pytest.raises(ValueError):
        checks.aligned16("t", a=t[1:])


def _chip_smoke():
    """``chip_smoke.py`` at the repository root, as a module."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _attn_bf16(q, k, v, mask, p_bf16):
    """Attention of (S, H, hd) q against (T, 1, hd) k / v under an (S, T)
    mask, softmax in f32, P optionally rounded to bf16 (as the kernels
    do), the output in bf16."""
    s = torch.einsum("shd,td->hst", q.float(), k[:, 0].float())
    s = torch.where(mask, s / q.shape[-1] ** 0.5, -1e30)
    p = torch.softmax(s, dim=-1)
    if p_bf16:
        p = p.to(torch.bfloat16).float()
    return torch.einsum("hst,td->shd", p, v[:, 0].float()).to(torch.bfloat16)


@pytest.mark.parametrize("case", ["causal", "full", "sliding", "decode"])
def test_row_rel_check_catches_a_dropped_tile(case):
    """chip_smoke.py's second attention check, at long rows of random
    bf16 inputs: a right result (P rounded to bf16) is within
    ATTN_ROW_REL_TOL of the plain version; one that drops a 64-key tile
    for a 128-row query tile, or a 128-slot decode split, is at least
    three times over it."""
    smoke = _chip_smoke()
    rng = np.random.default_rng(3)
    bf16 = torch.bfloat16
    if case == "decode":
        S, T, H = 1, 2048, 8            # one token, 1,500 valid slots
        mask = torch.zeros(S, T, dtype=torch.bool)
        mask[:, :1500] = True
        drop = (slice(None), slice(512, 640))
    else:
        S = T = 1024
        H = 2
        d = torch.arange(S)[:, None] - torch.arange(T)[None, :]
        mask = {"causal": d >= 0, "full": torch.ones(S, T, dtype=torch.bool),
                "sliding": (d >= 0) & (d < 300)}[case]
        drop = (slice(768, 896), slice(640, 704))
    q = torch.from_numpy(rng.standard_normal((S, H, 128))).to(bf16)
    k, v = (torch.from_numpy(rng.standard_normal((T, 1, 128))).to(bf16)
            for _ in range(2))
    want = _attn_bf16(q, k, v, mask, p_bf16=False)
    tol = smoke.ATTN_ROW_REL_TOL["bfloat16"]
    rel, ok = smoke._row_rel_err(_attn_bf16(q, k, v, mask, True), want,
                                 "bfloat16")
    assert ok and rel <= tol, rel
    dropped = mask.clone()
    dropped[drop] = False
    rel, ok = smoke._row_rel_err(_attn_bf16(q, k, v, dropped, True), want,
                                 "bfloat16")
    assert not ok and rel > 3 * tol, rel

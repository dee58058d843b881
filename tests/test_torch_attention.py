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

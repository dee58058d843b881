"""The SSD scan's chunk-parallel plain version, the tensor-core kernel's
roundings and its launch plan, on the CPU.

``ssd_scan_chunk_parallel_ref`` (the three phases of the CUDA kernels'
``chunked`` route in plain PyTorch) is held against JAX's ``ssd_scan`` op
(the Pallas kernel in interpret mode) and ``ssd_sequential`` at 2e-4, the
bar of ``tests/test_kernels.py``'s SSD tests. With
``tensor_core_rounding`` it rounds where the tensor-core kernel rounds
(M to bf16 once, the state operands split into bf16 high and low parts):
held within the bf16 bar (0.08) of JAX's f32 op on bf16 inputs, with the
final state within 1e-4. ``ssd_plan`` picks each route from shapes,
dtype and alignment alone. The kernels themselves are held against the
plain version on the card (``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.ssd_scan.ops import ssd_scan as jssd_scan  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_scan_chunk_parallel_ref, ssd_scan_ref,
)

SSD_TOL = dict(rtol=2e-4, atol=2e-4)
BF16, F32 = torch.bfloat16, torch.float32


def _inputs(seed, B=2, L=64, H=4, P=8, N=16, bf16_values=False):
    """The SSD operands as ``tests/test_kernels.py`` draws them, in f32
    (x, B and C rounded to bf16 values with ``bf16_values``)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x, Bi, Ci = f(B, L, H, P), f(B, L, N), f(B, L, N)
    if bf16_values:
        x, Bi, Ci = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                     for a in (x, Bi, Ci))
    return (x, rng.uniform(0.001, 0.1, (B, L, H)).astype(np.float32),
            -rng.uniform(0.5, 4.0, (H,)).astype(np.float32), Bi, Ci, f(H))


def _t(arrays):
    return [torch.as_tensor(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("B,L,chunk", [
    (2, 64, 8), (2, 64, 16), (2, 64, 32), (2, 64, 64),   # the chunk sweep
    (2, 100, 32), (2, 40, 16),                           # ragged last chunk
    (2, 40, 64), (1, 16, 16)])                           # a single chunk
def test_chunk_parallel_ref_matches_jax(B, L, chunk):
    """The three phases against JAX's op (its own chunk) and the
    sequential scan; the op takes min(chunk, L), as the CUDA op does."""
    ins = _inputs(B * 1000 + L + chunk, B=B, L=L)
    y, h = ssd_scan_chunk_parallel_ref(*_t(ins), chunk=min(chunk, L))
    assert y.shape == (B, L, 4, 8) and h.shape == (B, 4, 16, 8)
    assert y.dtype == F32 and h.dtype == F32
    for want in (jssm.ssd_sequential(*ins), jssd_scan(*ins, chunk=chunk)):
        for g, w in zip((y, h), want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32),
                                       **SSD_TOL)


def test_chunk_parallel_ref_matches_serial_ref():
    """The chunk-parallel and the serial plain versions at mamba2-370m's
    widths (H 32, P 64, N 128) over three chunks of 128."""
    ins = _t(_inputs(5, B=1, L=300, H=32, P=64, N=128))
    got = ssd_scan_chunk_parallel_ref(*ins, chunk=128)
    want = ssd_scan_ref(*ins, chunk=128)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("L,chunk", [(32, 32), (128, 128), (64, 16),
                                     (100, 32)])
def test_tensor_core_roundings_stay_within_bf16_bar(L, chunk):
    """M rounded to bf16 once and the state operands (w o x, and h_c in
    C h_c) as bf16 high + low parts, on bf16 inputs at mamba2-370m's
    widths: y within 0.08 of JAX's f32 op, the final state within 1e-4."""
    ins = _inputs(L + chunk, B=1, L=L, H=4, P=64, N=128, bf16_values=True)
    y, h = ssd_scan_chunk_parallel_ref(*_t(ins), chunk=chunk,
                                       tensor_core_rounding=True)
    jy, jh = jssd_scan(*ins, chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0.08,
                               atol=0.08)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-4,
                               atol=1e-4)
    # The roundings do move y (the check above is not vacuous) but not h
    # by more than the split's ~2^-16.
    y32, h32 = ssd_scan_chunk_parallel_ref(*_t(ins), chunk=chunk)
    assert float((y - y32).abs().max()) > 1e-4
    assert float((h - h32).abs().max()) < 1e-5 * float(h32.abs().max())


def test_split_bf16_keeps_sixteen_bits():
    """The high/low split of an f32 tensor: two bf16 values whose sum is
    within 2^-16 of it (relative), where one bf16 is within 2^-8."""
    from repro_torch.kernels.ssd_scan.ref import _split_bf16

    t = torch.as_tensor(np.random.default_rng(3).standard_normal(4096)
                        .astype(np.float32))
    rel = lambda a: float(((a - t).abs() / t.abs()).max())  # noqa: E731
    assert rel(_split_bf16(t)) <= 2.0 ** -16
    assert 2.0 ** -9 < rel(t.to(BF16).float()) <= 2.0 ** -8


SERVED = dict(B=1, H=32, P=64, N=128)


@pytest.mark.parametrize("L", [32, 64, 96, 128])
def test_plan_served_prompts_take_one_chunk(L):
    """Every prompt the server keeps (padded to 32, at most 128) is one
    launch on the tensor cores."""
    plan = ssd_kernel.ssd_plan(L=L, chunk=min(128, L), dtype=BF16,
                               aligned=True, **SERVED)
    assert plan["route"] == "one_chunk" and plan["tensor_cores"]
    assert plan["n_chunks"] == 1 and plan["launches"] == 1
    assert plan["chunk"] == L
    assert plan["smem_bytes"] <= ssd_kernel.SMEM_LIMIT


def test_plan_long_prompt_is_chunked():
    plan = ssd_kernel.ssd_plan(L=2048, chunk=128, dtype=BF16, aligned=True,
                               **SERVED)
    assert plan["route"] == "chunked" and plan["n_chunks"] == 16
    assert plan["launches"] == 3
    assert plan["grid"][1:] == (16, 1)
    assert plan["smem_bytes"] <= ssd_kernel.SMEM_LIMIT


@pytest.mark.parametrize("dtype,N,P,aligned", [
    (F32, 128, 64, True),     # f32 stays off the tensor cores
    (BF16, 24, 64, True),     # N % 16 != 0
    (BF16, 128, 36, True),    # P % 8 != 0
    (BF16, 128, 64, False),   # a view off 16-byte boundaries
])
def test_plan_fma_route(dtype, N, P, aligned):
    for L in (32, 300):
        plan = ssd_kernel.ssd_plan(1, L, 8, P, N, min(128, L), dtype,
                                   aligned)
        assert plan["route"] == "fma" and not plan["tensor_cores"]
        assert plan["p_tile"] == ssd_kernel.FMA_P_TILE
        assert plan["launches"] == (1 if L <= 128 else 3)
        assert plan["grid"] == (-(-P // 16) * 8, plan["n_chunks"], 1)


@pytest.mark.parametrize("B,L,H,P,N,chunk", [
    (1, 32, 32, 64, 128, 32), (1, 128, 32, 64, 128, 128),
    (1, 2048, 32, 64, 128, 128), (8, 2048, 32, 64, 128, 128),
    (1, 300, 3, 64, 128, 128), (2, 100, 5, 24, 64, 32),
    (4, 40, 7, 8, 16, 16), (1, 1, 32, 64, 128, 1)])
def test_plan_tiles_cover_the_heads_and_columns(B, L, H, P, N, chunk):
    """The heads per block and the P tile divide into a grid that covers
    every head and column, within the kernel's limits and its shared
    memory."""
    plan = ssd_kernel.ssd_plan(B, L, H, P, N, chunk, BF16, True)
    G, TP = plan["heads_per_block"], plan["p_tile"]
    assert 1 <= G <= ssd_kernel.MAX_HEADS_PER_BLOCK
    assert TP % 8 == 0 and 8 <= TP <= ssd_kernel.MAX_P_TILE and P % TP == 0
    assert plan["grid"] == (-(-H // G) * (P // TP), -(-L // chunk), B)
    assert plan["grid"][0] * G >= H
    assert plan["smem_bytes"] <= ssd_kernel.SMEM_LIMIT


def test_plan_prefers_more_blocks_at_the_served_shape():
    """At B = 1, H = 32 a block per head and 64 columns gives 32 blocks:
    the plan narrows the P tile until the grid covers the SMs, and groups
    heads only where the grid stays that large."""
    plan = ssd_kernel.ssd_plan(L=32, chunk=32, dtype=BF16, aligned=True,
                               n_sm=132, **SERVED)
    assert plan["grid"][0] >= 128 and plan["heads_per_block"] == 1
    big = ssd_kernel.ssd_plan(L=2048, chunk=128, dtype=BF16, aligned=True,
                              n_sm=132, **dict(SERVED, B=8))
    assert big["heads_per_block"] > 1
    assert big["grid"][0] * big["grid"][1] * big["grid"][2] >= 132


def test_mma_smem_bytes_by_mode():
    """Mode 1 (the chunk states) stages no C and keeps no C B^T; mode 2
    (the outputs) keeps h_c's planes (N rows) in place of w o x's (Qp)."""
    one, state, out = (ssd_kernel.mma_smem_bytes(m, 128, 128, 64, 1)
                       for m in (0, 1, 2))
    nb, cb = (2 * 128 + 16) * 128, 128 * 136 * 4
    assert one - state == nb + cb
    assert out == one     # N = Qp: the planes are the same size
    assert (ssd_kernel.mma_smem_bytes(2, 32, 128, 16, 1)
            - ssd_kernel.mma_smem_bytes(0, 32, 128, 16, 1)
            == 2 * (128 - 32) * (2 * 16 + 16))


def test_tensor_core_alignment():
    """Views of one bf16 projection at the served widths are aligned; a
    view shifted by one element, or rows an odd number of elements apart,
    is not."""
    xBC = torch.zeros((1, 32, 32 * 64 + 256), dtype=BF16)
    xs, Bi, Ci = torch.split(xBC, [2048, 128, 128], dim=-1)
    x = xs.reshape(1, 32, 32, 64)
    assert ssd_kernel.tensor_core_aligned(x, Bi, Ci)
    shifted = torch.zeros((1, 32, 1 + 2048 + 256), dtype=BF16)[..., 1:]
    xs2, Bi2, Ci2 = torch.split(shifted, [2048, 128, 128], dim=-1)
    assert not ssd_kernel.tensor_core_aligned(xs2.reshape(1, 32, 32, 64),
                                              Bi2, Ci2)
    odd = torch.zeros((1, 32, 2048 + 256 + 3), dtype=BF16)[..., :2304]
    xs3, Bi3, Ci3 = torch.split(odd, [2048, 128, 128], dim=-1)
    assert not ssd_kernel.tensor_core_aligned(xs3.reshape(1, 32, 32, 64),
                                              Bi3, Ci3)

"""Launch of the CUDA SSD scan kernels (``csrc/ssd_scan.cu``), and the plan
that picks their route.

Three routes, each one op call:

* ``one_chunk`` (L <= chunk, bf16 on the tensor cores): one launch of
  ``ssd_chunk_mma_kernel``, grid (head groups x P tiles, 1, B).
* ``chunked`` (L > chunk, bf16 on the tensor cores): the chunk-parallel
  form in three launches chained by programmatic dependent launch: the
  chunks' own states, the serial pass over them
  (``ssd_state_pass_kernel``), the outputs.
* ``fma`` (f32, and bf16 that the tensor cores cannot take: N % 16 != 0,
  P % 8 != 0, or x / B / C off 16-byte boundaries):
  ``ssd_chunk_fma_kernel`` on FP32 FMAs, one launch for one chunk, else
  the same three phases.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("one_chunk", "chunked", "fma")

MAX_P_TILE = 64           # csrc/ssd_scan.cu kMaxTP
MAX_HEADS_PER_BLOCK = 8   # kMaxG
FMA_P_TILE = 16           # kFmaTP
SMEM_LIMIT = 232448       # an H100 block's opt-in shared memory, bytes
# A P tile is halved (down to 16 columns) while the grid has fewer blocks
# than SMs; heads are grouped (C B^T computed once for the group) while
# the grid keeps a block for every SM. On the H100 (NVIDIA H100 80GB HBM3,
# 700.00 W; ``tune.py``, graph ms a call) the served (1, 32, 32, 64, 128)
# launch read 0.0058 at one head and 16 columns a block, 0.0060 / 0.0066
# at 32 / 64 columns, 0.0079 at two heads; L = 2048 read 0.0764 at two
# heads of 64 columns, 0.0894 at one, 0.0988 at four heads of 32.


def mma_smem_bytes(mode: int, Qp: int, N: int, TP: int, G: int) -> int:
    """Shared memory of one ``ssd_chunk_mma_kernel`` block (``MmaSmem``):
    B, C and G x tiles in bf16 rows padded by 16 bytes, two bf16 planes of
    w o x (Qp rows) or, in mode 2 (the outputs), of h_c (N rows), C B^T in
    f32 (rows Qp + 8 apart), and cum, dt, w and D per head in f32. Mode 1
    (the chunk states) has no C and no C B^T."""
    nb, xb = 2 * N + 16, 2 * TP + 16
    y = mode != 1
    return (Qp * nb * (2 if y else 1) + G * Qp * xb
            + 2 * (N if mode == 2 else Qp) * xb
            + (Qp * (Qp + 8) * 4 if y else 0) + 3 * G * Qp * 4 + G * 4)


def tensor_core_aligned(x, B_in, C_in) -> bool:
    """True when x, B_in and C_in can be staged by 16-byte copies: data on
    16-byte boundaries and batch and row strides whole multiples of 16
    bytes."""
    for t in (x, B_in, C_in):
        es = t.element_size()
        if (t.data_ptr() % 16 or t.stride(0) * es % 16
                or t.stride(1) * es % 16):
            return False
    return True


def ssd_plan(B: int, L: int, H: int, P: int, N: int, chunk: int, dtype,
             aligned: bool, n_sm: int = 132) -> dict:
    """The launch of an ssd_scan call on x (B, L, H, P), B/C (B, L, N), for
    ``chunk`` (already min(chunk, L)) on a card with ``n_sm`` SMs: the
    route (tensor cores for bf16 with N % 16 == 0, P % 8 == 0 and
    ``aligned`` operands, else ``fma``), the heads per block and the P tile
    (the tensor-core routes'), the number of chunks, the chunk kernels'
    grid, the kernel launches and a tensor-core block's shared memory."""
    Q = min(chunk, L)
    nc = -(-L // Q)
    launches = 1 if nc == 1 else 3
    if not (dtype == torch.bfloat16 and N % 16 == 0 and P % 8 == 0
            and aligned):
        return dict(route="fma", tensor_cores=False, heads_per_block=1,
                    p_tile=FMA_P_TILE, n_chunks=nc, chunk=Q,
                    grid=(-(-P // FMA_P_TILE) * H, nc, B),
                    launches=launches, smem_bytes=None)
    Qp = -(-Q // 16) * 16
    modes = (0,) if nc == 1 else (1, 2)

    def blocks(g, tp):
        return -(-H // g) * (P // tp) * nc * B

    def smem(g, tp):
        return max(mma_smem_bytes(m, Qp, N, tp, g) for m in modes)

    tp = max(t for t in range(8, MAX_P_TILE + 1, 8) if P % t == 0)
    while blocks(1, tp) < n_sm and tp % 32 == 0:
        tp //= 2
    g = 1
    while (2 * g <= MAX_HEADS_PER_BLOCK
           and blocks(2 * g, tp) >= n_sm
           and smem(2 * g, tp) <= SMEM_LIMIT):
        g *= 2
    return dict(route="one_chunk" if nc == 1 else "chunked",
                tensor_cores=True, heads_per_block=g, p_tile=tp,
                n_chunks=nc, chunk=Q, grid=(blocks(g, tp) // (nc * B), nc, B),
                launches=launches, smem_bytes=smem(g, tp))


def workspace(plan: dict, B: int, H: int, N: int, P: int, device):
    """The f32 workspaces of a plan with more than one chunk: the chunks'
    states (B, nc, H, N, P), which the pass overwrites with each chunk's
    entering state, and their cum_Q (B, nc, H); (None, None) for one
    chunk."""
    nc = plan["n_chunks"]
    if nc == 1:
        return None, None
    return (torch.empty((B, nc, H, N, P), dtype=torch.float32, device=device),
            torch.empty((B, nc, H), dtype=torch.float32, device=device))


def ssd_scan_bhp(x, dt, A, B_in, C_in, D_skip, y, h, ws, ws_cum, *,
                 plan: dict) -> None:
    """The scan into ``y`` (B, L, H, P) and ``h`` (B, H, N, P) on the
    current stream, by ``plan`` (``ssd_plan``), with its ``workspace``.
    Operands are checked CUDA tensors (``checks.ssd_operands``): x (B, L,
    H, P) and B_in/C_in (B, L, N) with unit-stride rows read through their
    batch and row strides, dt (B, L, H), A and D_skip (H,) contiguous
    f32."""
    Bb, L, H, P = x.shape
    N = B_in.shape[-1]
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = build.library().ssd_scan_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_in.data_ptr(),
        C_in.data_ptr(), D_skip.data_ptr(), y.data_ptr(), h.data_ptr(),
        ptr(ws), ptr(ws_cum), Bb, L, H, P, N, plan["chunk"], x.stride(0),
        x.stride(1), B_in.stride(0), B_in.stride(1), C_in.stride(0),
        C_in.stride(1), DTYPES[x.dtype], ROUTES.index(plan["route"]),
        plan["heads_per_block"], plan["p_tile"],
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_scan ({plan['route']}) launch failed: CUDA "
                           f"error {err}")

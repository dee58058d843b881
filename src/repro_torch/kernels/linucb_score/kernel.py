"""Launch of the CUDA scoring kernel (``csrc/linucb_score.cu``), and its
tile plan.

Grid (row tiles of 128, K, S): each block stages one arm's (d x d)
inverse, zero-padded to DP columns, with its tile of contexts, and
computes the tile's products in (DP / 16) x 8 register micro-tiles with
256 threads.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

TILE_ROWS = 128     # rows per block (csrc/linucb_common.cuh kTileRows)
THREADS = 256       # threads per block (kScoreThreads)
WIDTHS = (32, 64, 128)   # the padded widths DP the kernel is built for


def score_plan(S: int, R: int, K: int, d: int) -> dict:
    """The launch of an (S, R, K, d) scoring call: DP, the smallest width
    of ``WIDTHS`` that holds d (zero padding is exact); DP / 16 rows of 8
    columns a thread; grid (R / 128, K, S); and the block's shared memory
    in bytes (the (128, DP + 4) context tile, the (DP, DP) inverse and
    theta)."""
    dp = next(w for w in WIDTHS if d <= w)
    return dict(dp=dp, threads=THREADS, rows_per_thread=dp // 16,
                grid=(-(-R // TILE_ROWS), K, S),
                smem_bytes=4 * (TILE_ROWS * (dp + 4) + dp * dp + dp))


def state_ptr(t, start: int) -> int:
    """The address of state ``start`` of a contiguous tensor whose axis 0
    is the state axis."""
    if not start:     # every stack of at most MAX_STATES: one slice
        return t.data_ptr()
    return t.data_ptr() + start * t.stride(0) * t.element_size()


def linucb_score_blocked(x, theta, ainv, pen, infl, alpha, out,
                         states=None) -> None:
    """Scores into ``out`` (S, R, K) on the current stream. All operands
    are checked, contiguous f32 CUDA tensors (``ops.linucb_score``).
    ``states`` = (start, stop) scores only those states (at most
    ``checks.MAX_STATES``; default all)."""
    S, R, d = x.shape
    K = theta.shape[1]
    a, z = states or (0, S)
    err = build.library().linucb_score_launch(
        *(state_ptr(t, a) for t in (x, theta, ainv, pen, infl, alpha, out)),
        z - a, R, K, d, score_plan(S, R, K, d)["dp"],
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"linucb_score launch failed: CUDA error {err}")

"""Launch of the CUDA scoring kernel (``csrc/linucb_score.cu``), and its
tile plan.

Grid (row tiles of ``block_r``, K, S): each block stages one arm's
(d x d) inverse, zero-padded to DP columns, with its tile of contexts,
and computes the tile's products in (DP / 16) x 8 register micro-tiles
with 2 x ``block_r`` threads. ``block_r`` is 128 unless a caller (the
autotune, ``kernels/tune.py``) passes another of ``BLOCK_ROWS``; every
choice gives the same scores bit for bit.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

TILE_ROWS = 128     # default rows per block (csrc/linucb_common.cuh kTileRows)
BLOCK_ROWS = (32, 64, 128, 256)   # the rows per block the kernel is built for
WIDTHS = (32, 64, 128)   # the padded widths DP the kernel is built for


def score_plan(S: int, R: int, K: int, d: int,
               block_r: int = TILE_ROWS) -> dict:
    """The launch of an (S, R, K, d) scoring call at ``block_r`` rows a
    block: DP, the smallest width of ``WIDTHS`` that holds d (zero
    padding is exact); 2 x ``block_r`` threads of DP / 16 rows of 8
    columns each; grid (R / block_r, K, S); and the block's shared memory
    in bytes (the (block_r, DP + 4) context tile, the (DP, DP) inverse
    and theta)."""
    if block_r not in BLOCK_ROWS:
        raise ValueError(f"block_r={block_r}: the kernel is built for "
                         f"{BLOCK_ROWS}")
    dp = next(w for w in WIDTHS if d <= w)
    return dict(dp=dp, block_r=block_r, threads=2 * block_r,
                rows_per_thread=dp // 16, grid=(-(-R // block_r), K, S),
                smem_bytes=4 * (block_r * (dp + 4) + dp * dp + dp))


def state_ptr(t, start: int) -> int:
    """The address of state ``start`` of a contiguous tensor whose axis 0
    is the state axis."""
    if not start:     # every stack of at most MAX_STATES: one slice
        return t.data_ptr()
    return t.data_ptr() + start * t.stride(0) * t.element_size()


def linucb_score_blocked(x, theta, ainv, pen, infl, alpha, out,
                         states: Optional[tuple] = None,
                         block_r: int = TILE_ROWS) -> None:
    """Scores into ``out`` (S, R, K) on the current stream, ``block_r``
    rows a block. All operands are checked, contiguous f32 CUDA tensors
    (``ops.linucb_score``). ``states`` = (start, stop) scores only those
    states (at most ``checks.MAX_STATES``; default all)."""
    S, R, d = x.shape
    K = theta.shape[1]
    a, z = states or (0, S)
    plan = score_plan(S, R, K, d, block_r)
    err = build.library().linucb_score_launch(
        *(state_ptr(t, a) for t in (x, theta, ainv, pen, infl, alpha, out)),
        z - a, R, K, d, plan["dp"], plan["block_r"],
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"linucb_score launch failed: CUDA error {err}")

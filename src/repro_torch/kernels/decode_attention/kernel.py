"""Launch of the CUDA decode attention kernels
(``csrc/decode_attention.cu``), and the split plan.

Pass 1, ``decode_split_kernel``, grid (n_split, KV, B): each block takes
a contiguous run of 64-slot tiles for the G query heads of one kv head
and writes a partial (m, l, acc). Pass 2, ``decode_combine_kernel``,
grid (G, KV, B), merges the partials; with n_split = 1 pass 1 writes the
output and pass 2 is not launched. K / V are of q's dtype or fp8
(``KV_DTYPES``), read as they are: the kernels widen fp8 on the card.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.kernel import DTYPES

TILE = 64          # cache slots per tile (csrc/decode_attention.cu kBK)
MAX_SPLIT = 1024   # splits the combine takes (kMaxSplit)
WAVES = 2          # blocks aimed at per SM when B * KV is small
# The cache dtypes the kernels read (the C entry point's kv_dtype code):
# q's own, or either fp8 format.
KV_DTYPES = {**DTYPES, torch.float8_e4m3fn: 2, torch.float8_e5m2: 3}


def split_plan(B: int, W: int, KV: int, n_sm: int) -> tuple[int, int]:
    """(n_split, tiles_per_split) for a (B, W, KV, ...) cache on a card
    with ``n_sm`` SMs: about WAVES blocks per SM when B * KV falls short
    of that, never more splits than tiles, and the tiles dealt out so
    that every split gets at least one."""
    tiles = max(1, -(-W // TILE))
    want = max(1, -(-WAVES * n_sm // max(1, B * KV)))
    n = min(tiles, want, MAX_SPLIT)
    per = -(-tiles // n)
    return -(-tiles // per), per


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SMs of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_attention_bkv(q, k_cache, v_cache, valid, out, part_acc, part_ml,
                         *, n_split: int, tiles_per_split: int,
                         scale: float) -> None:
    """Attention of one token into ``out`` (B, 1, H, hd) on the current
    stream. q (B, 1, H, hd), k/v (B, W, KV, hd) of q's dtype or fp8 and
    valid (W,) bool are checked, contiguous CUDA tensors
    (``ops.decode_attention``); with n_split > 1, ``part_acc`` (B, KV,
    n_split, G, hd) and ``part_ml`` (B, KV, n_split, G, 2) are f32
    workspaces, else None."""
    B, _, H, hd = q.shape
    W, KV = k_cache.shape[1], k_cache.shape[2]
    ws = (None, None) if part_acc is None else (part_acc.data_ptr(),
                                                 part_ml.data_ptr())
    err = build.library().decode_attention_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        valid.data_ptr(), out.data_ptr(), *ws, B, W, KV, H // KV, hd,
        n_split, tiles_per_split, scale, DTYPES[q.dtype],
        KV_DTYPES[k_cache.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"decode_attention launch failed: CUDA error {err}")

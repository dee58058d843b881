"""Launch of the CUDA decode attention kernel (``csrc/decode_attention.cu``).

Grid (B * KV,): each block keeps the G query heads of one kv head and
walks the cache in tiles of 64 slots.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.kernel import DTYPES


def decode_attention_bkv(q, k_cache, v_cache, valid, out, *,
                         scale: float) -> None:
    """Attention of one token into ``out`` (B, 1, H, hd) on the current
    stream. q (B, 1, H, hd), k/v (B, W, KV, hd) of one dtype and valid
    (W,) bool are checked, contiguous CUDA tensors
    (``ops.decode_attention``)."""
    B, _, H, hd = q.shape
    W, KV = k_cache.shape[1], k_cache.shape[2]
    err = build.library().decode_attention_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        valid.data_ptr(), out.data_ptr(), B, W, KV, H // KV, hd, scale,
        DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"decode_attention launch failed: CUDA error {err}")

"""Launch of the CUDA prefill attention kernel (``csrc/flash_attention.cu``).

Grid (query tiles of 64, H, B): each block loops over the kv tiles its
query tile can see, with the online-softmax state in registers.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

MODES = {"causal": 0, "sliding": 1, "full": 2}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_bshd(q, k, v, out, *, mode: str, window: int,
                         scale: float) -> None:
    """Attention into ``out`` (B, S, H, hd) on the current stream. q (B, S,
    H, hd) and k/v (B, T, KV, hd) are checked, contiguous CUDA tensors of
    one dtype (``ops.flash_attention``)."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    err = build.library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, S, T, H, KV, hd, MODES[mode], window, scale, DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")

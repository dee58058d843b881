"""Launches of the CUDA prefill attention kernels
(``csrc/flash_attention.cu``).

Two routes. ``tensor_cores``: bf16 with hd a multiple of 8 runs
``flash_wgmma_kernel``, grid (query tiles of 128, H, B), TMA loads of
Q and of a K/V ring, wgmma for QK^T and P.V. ``fma``: f32, and bf16 at
any other hd (a TMA map's strides must be multiples of 16 bytes), runs
``flash_kernel``, grid (query tiles of 64, H, B), FP32 FMAs.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

MODES = {"causal": 0, "sliding": 1, "full": 2}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("tensor_cores", "fma")


def route(dtype: torch.dtype, hd: int) -> str:
    """The kernel that takes q of ``dtype`` and head dimension ``hd``."""
    if dtype == torch.bfloat16 and hd % 8 == 0:
        return "tensor_cores"
    return "fma"


def flash_attention_bshd(q, k, v, out, *, mode: str, window: int,
                         scale: float) -> str:
    """Attention into ``out`` (B, S, H, hd) on the current stream, through
    the route of ``route(q.dtype, hd)``, which it returns. q (B, S, H, hd)
    and k/v (B, T, KV, hd) are checked, contiguous CUDA tensors of one
    dtype (``ops.flash_attention``); on the tensor-core route their data
    is 16-byte aligned."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    lib = build.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    which = route(q.dtype, hd)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    if which == "tensor_cores":
        err = lib.flash_attention_tc_launch(
            *ptrs, B, S, T, H, KV, hd, MODES[mode], window, scale, stream)
    else:
        err = lib.flash_attention_launch(
            *ptrs, B, S, T, H, KV, hd, MODES[mode], window, scale,
            DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError(f"flash_attention ({which}) launch failed: "
                           f"error {err} (CUDA's, or 9000: no "
                           f"cuTensorMapEncodeTiled, 10000 + CUresult: a "
                           f"tensor map refused)")
    return which

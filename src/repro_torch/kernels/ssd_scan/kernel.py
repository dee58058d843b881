"""Launch of the CUDA SSD scan kernel (``csrc/ssd_scan.cu``).

Grid (head-dim tiles of 16, H, B): each block loops over the chunks of
its (b, h) in order, with its (N, 16) slice of the state in shared
memory.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def ssd_scan_bhp(x, dt, A, B_in, C_in, D_skip, y, h, *, chunk: int) -> None:
    """The scan into ``y`` (B, L, H, P) and ``h`` (B, H, N, P) on the
    current stream. Operands are checked CUDA tensors
    (``checks.ssd_operands``): x (B, L, H, P) and B_in/C_in (B, L, N) with
    unit-stride rows read through their batch and row strides, dt (B, L,
    H), A and D_skip (H,) contiguous f32."""
    Bb, L, H, P = x.shape
    N = B_in.shape[-1]
    err = build.library().ssd_scan_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_in.data_ptr(),
        C_in.data_ptr(), D_skip.data_ptr(), y.data_ptr(), h.data_ptr(),
        Bb, L, H, P, N, chunk, x.stride(0), x.stride(1), B_in.stride(0),
        B_in.stride(1), C_in.stride(0), C_in.stride(1), DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err}")

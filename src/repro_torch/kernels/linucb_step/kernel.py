"""Launch of the CUDA step kernel (``csrc/linucb_step.cu``).

Two launches on one stream make up the kernel: score + select over
(row tiles, S), then the serial update loop with one block per state.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def linucb_step_blocked(ins, outs, *, num_valid: int, dt_max: int) -> None:
    """Run one block step. ``ins`` are the 23 operands of
    ``ref.linucb_step_ref`` in order; ``outs`` the 10 preallocated
    outputs (A', A_inv', b', theta', last_upd', arms, r, c, lam', c_ema').
    All are checked, contiguous CUDA tensors (``ops.linucb_step``)."""
    S, B, d = ins[5].shape
    K = ins[2].shape[1]
    err = build.library().linucb_step_launch(
        *(t.data_ptr() for t in ins), *(t.data_ptr() for t in outs),
        S, B, K, d, num_valid, dt_max,
        torch.cuda.current_stream(ins[0].device).cuda_stream)
    if err:
        raise RuntimeError(f"linucb_step launch failed: CUDA error {err}")

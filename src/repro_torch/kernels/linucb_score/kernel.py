"""Launch of the CUDA scoring kernel (``csrc/linucb_score.cu``).

Grid (row tiles of 32, S): each block stages one arm's (d x d) inverse at
a time in shared memory while its tile of contexts stays resident.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def linucb_score_blocked(x, theta, ainv, pen, infl, alpha, out) -> None:
    """Scores into ``out`` (S, R, K) on the current stream. All operands
    are checked, contiguous f32 CUDA tensors (``ops.linucb_score``)."""
    S, R, d = x.shape
    K = theta.shape[1]
    err = build.library().linucb_score_launch(
        x.data_ptr(), theta.data_ptr(), ainv.data_ptr(), pen.data_ptr(),
        infl.data_ptr(), alpha.data_ptr(), out.data_ptr(), S, R, K, d,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"linucb_score launch failed: CUDA error {err}")

"""Wrapper of the batched UCB scoring kernel.

On CPU tensors it runs the plain version (``ref.py``); on CUDA tensors it
checks the operands and launches the CUDA kernel, or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import checks
from repro_torch.kernels.linucb_score.kernel import (
    TILE_ROWS, linucb_score_blocked,
)
from repro_torch.kernels.linucb_score.ref import linucb_score_ref

# Kernel launches since import (or since a caller reset it to 0).
LAUNCHES = [0]


def linucb_score(x, theta, ainv, pen, infl, alpha, *,
                 block_r: int = TILE_ROWS):
    """x (S,R,d), theta (S,K,d), ainv (S,K,d,d), pen/infl (S,K),
    alpha (S,) -> scores (S,R,K) f32. ``block_r`` is the kernel's rows
    per block (``kernel.BLOCK_ROWS``), the JAX op's knob of that name:
    every choice gives the same scores, and the plain version ignores
    it."""
    if checks.on_cpu(x, theta, ainv, pen, infl, alpha):
        return linucb_score_ref(x, theta, ainv, pen, infl, alpha)
    return _launch(x, theta, ainv, pen, infl, alpha, block_r)


def _launch(x, theta, ainv, pen, infl, alpha, block_r=TILE_ROWS):
    """The CUDA path: check the operands, allocate the output, launch the
    kernel on the current stream, once per slice of at most
    ``checks.MAX_STATES`` states, and count each launch. The kernel masks
    ragged row tiles itself, so nothing is padded."""
    S, R, d = x.shape
    K = theta.shape[1]
    checks.cuda_operands(
        "linucb_score", (S, K, d),
        x=(x, (S, R, d)), theta=(theta, (S, K, d)),
        ainv=(ainv, (S, K, d, d)), pen=(pen, (S, K)), infl=(infl, (S, K)),
        alpha=(alpha, (S,)))
    out = torch.empty((S, R, K), dtype=torch.float32, device=x.device)
    for states in checks.state_slices(S):
        linucb_score_blocked(x, theta, ainv, pen, infl, alpha, out, states,
                             block_r)
        LAUNCHES[0] += 1
    return out

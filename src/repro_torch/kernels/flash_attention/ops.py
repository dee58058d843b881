"""Wrapper of the prefill attention kernels.

On CPU tensors it runs the plain version (``ref.py``); on CUDA tensors it
checks the operands and launches a CUDA kernel, or raises. As the JAX
op, it assumes positions 0..S-1 and 0..T-1 (the JAX op takes and ignores
``q_pos``/``k_pos``; this one does not take them).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import checks
from repro_torch.kernels.flash_attention.kernel import (
    MODES, ROUTES, flash_attention_bshd, route,
)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

# Kernel launches since import (or since a caller reset it to 0), and the
# same launches by route (``kernel.route``).
LAUNCHES = [0]
ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)


def flash_attention(q, k, v, *, mode: str = "causal", window: int = 0):
    """q (B,S,H,hd), k/v (B,T,KV,hd) -> (B,S,H,hd) in q's dtype."""
    if mode not in MODES:
        raise ValueError(f"mode={mode!r}: have {tuple(MODES)}")
    if checks.on_cpu(q, k, v):
        return flash_attention_ref(q, k, v, mode=mode, window=window)
    return _launch(q, k, v, mode, window)


def _launch(q, k, v, mode: str, window: int):
    """The CUDA path: check the operands, allocate the output, launch the
    kernel on the current stream and count the launch. The kernels mask
    ragged query and key tiles themselves, so nothing is padded."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    checks.attention_operands("flash_attention", hd, H, KV,
                              q=(q, (B, S, H, hd)), k=(k, (B, T, KV, hd)),
                              v=(v, (B, T, KV, hd)))
    if mode == "sliding" and window < 1:
        raise ValueError(f"flash_attention: sliding mode needs window >= 1, "
                         f"got {window}")
    out = torch.empty_like(q)
    if route(q.dtype, hd) == "tensor_cores":
        checks.aligned16("flash_attention", q=q, k=k, v=v, out=out)
    which = flash_attention_bshd(q, k, v, out, mode=mode, window=int(window),
                                 scale=1.0 / hd ** 0.5)
    LAUNCHES[0] += 1
    ROUTE_LAUNCHES[which] += 1
    return out

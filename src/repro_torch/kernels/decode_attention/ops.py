"""Wrapper of the decode attention kernel.

On CPU tensors it runs the plain version (``ref.py``); on CUDA tensors it
checks the operands and launches the CUDA kernel, or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import checks
from repro_torch.kernels.decode_attention.kernel import decode_attention_bkv
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

# Kernel launches since import (or since a caller reset it to 0).
LAUNCHES = [0]


def decode_attention(q, k_cache, v_cache, valid):
    """q (B,1,H,hd), k/v (B,W,KV,hd), valid (W,) bool -> (B,1,H,hd) in
    q's dtype."""
    if checks.on_cpu(q, k_cache, v_cache, valid):
        return decode_attention_ref(q, k_cache, v_cache, valid)
    return _launch(q, k_cache, v_cache, valid)


def _launch(q, k_cache, v_cache, valid):
    """The CUDA path: check the operands, allocate the output, launch the
    kernel on the current stream and count the launch. The kernel masks
    the ragged last tile of the cache itself, so nothing is padded."""
    B, _, H, hd = q.shape
    W, KV = k_cache.shape[1], k_cache.shape[2]
    checks.attention_operands(
        "decode_attention", hd, H, KV, q=(q, (B, 1, H, hd)),
        k_cache=(k_cache, (B, W, KV, hd)), v_cache=(v_cache, (B, W, KV, hd)),
        valid=(valid, (W,), torch.bool))
    G = H // KV
    if G > checks.MAX_G or G * hd > checks.MAX_G_HD:
        raise ValueError(f"decode_attention: kernel takes G <= {checks.MAX_G}"
                         f" and G * hd <= {checks.MAX_G_HD}; got G={G}, "
                         f"hd={hd}")
    out = torch.empty_like(q)
    decode_attention_bkv(q, k_cache, v_cache, valid, out,
                         scale=1.0 / hd ** 0.5)
    LAUNCHES[0] += 1
    return out

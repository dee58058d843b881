"""Wrapper of the decode attention kernels.

On CPU tensors it runs the plain version (``ref.py``); on CUDA tensors it
checks the operands, plans the split over the cache
(``kernel.split_plan``), allocates the output and the partials'
workspace, and launches the CUDA kernels, or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import checks
from repro_torch.kernels.decode_attention.kernel import (
    decode_attention_bkv, sm_count, split_plan,
)
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

# Calls of the op on CUDA tensors since import (or since a caller reset it
# to 0): one per call, whether it launches one kernel or two.
LAUNCHES = [0]


def decode_attention(q, k_cache, v_cache, valid):
    """q (B,1,H,hd), k/v (B,W,KV,hd), valid (W,) bool -> (B,1,H,hd) in
    q's dtype."""
    if checks.on_cpu(q, k_cache, v_cache, valid):
        return decode_attention_ref(q, k_cache, v_cache, valid)
    return _launch(q, k_cache, v_cache, valid)


def _launch(q, k_cache, v_cache, valid):
    """The CUDA path: check the operands, plan the split, allocate the
    output and (with more than one split) the f32 partials, launch on the
    current stream and count the call. The kernels mask the ragged last
    tile of the cache themselves, so nothing is padded."""
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
    n_split, per = split_plan(B, W, KV, sm_count(q.device.index or 0))
    out = torch.empty_like(q)
    part_acc = part_ml = None
    if n_split > 1:
        f32 = dict(dtype=torch.float32, device=q.device)
        part_acc = torch.empty((B, KV, n_split, G, hd), **f32)
        part_ml = torch.empty((B, KV, n_split, G, 2), **f32)
    decode_attention_bkv(q, k_cache, v_cache, valid, out, part_acc, part_ml,
                         n_split=n_split, tiles_per_split=per,
                         scale=1.0 / hd ** 0.5)
    LAUNCHES[0] += 1
    return out

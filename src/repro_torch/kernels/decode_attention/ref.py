"""Plain PyTorch version of the decode attention kernel: a naive softmax
in f32 of one query token against the cache, masked by ``valid``."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention_ref(q, k_cache, v_cache, valid):
    """q (B,1,H,hd), k/v (B,W,KV,hd), valid (W,) bool -> (B,1,H,hd) in
    q's dtype."""
    B, _, H, hd = q.shape
    KV = k_cache.shape[2]
    q4 = q[:, 0].float().reshape(B, KV, H // KV, hd)
    s = torch.einsum("bkgd,bwkd->bkgw", q4, k_cache.float()) / hd ** 0.5
    s = torch.where(valid, s, NEG_INF)
    out = torch.einsum("bkgw,bwkd->bkgd", torch.softmax(s, dim=-1),
                       v_cache.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)

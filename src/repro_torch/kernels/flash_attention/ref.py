"""Plain PyTorch version of the prefill attention kernel: a naive softmax
in f32 over positions 0..S-1 and 0..T-1, masked as the kernel masks."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, mode: str = "causal", window: int = 0):
    """q (B,S,H,hd), k/v (B,T,KV,hd) -> (B,S,H,hd) in q's dtype."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    kx = k.float().repeat_interleave(G, dim=2)
    vx = v.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bshd,bthd->bhst", q.float(), kx) * (1.0 / hd ** 0.5)
    d = (torch.arange(S, device=q.device)[:, None]
         - torch.arange(T, device=q.device)[None, :])
    if mode == "causal":
        mask = d >= 0
    elif mode == "sliding":
        mask = (d >= 0) & (d < window)
    elif mode == "full":
        mask = torch.ones_like(d, dtype=torch.bool)
    else:
        raise ValueError(mode)
    s = torch.where(mask, s, NEG_INF)
    out = torch.einsum("bhst,bthd->bshd", torch.softmax(s, dim=-1), vx)
    return out.to(q.dtype)

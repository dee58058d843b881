"""Plain PyTorch versions of the decode attention kernels: a naive
softmax in f32 of one query token against the cache, masked by
``valid``, and the same in the kernels' two passes (partials per split
of the cache, then their combination)."""
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


def decode_attention_split_ref(q, k_cache, v_cache, valid, n_split: int,
                               tiles_per_split: int, tile: int = 64):
    """The two passes of the CUDA kernel in plain PyTorch. Split i takes
    slots [i * tiles_per_split * tile, ...) and keeps its partial in f32:
    m (the max of its valid scores, -1e30 if it has none), l = sum of
    exp(s - m) and acc = sum of exp(s - m) v over its valid slots. The
    combine rescales each by exp(m_i - M) and divides by max(L, 1e-30).
    Where every split has m = -1e30 the row has no valid slot, and the
    combine gives the mean of V over the W slots, as
    ``decode_attention_ref`` (every p = exp(0)); the kernel still skips
    every tile of such a row."""
    B, _, H, hd = q.shape
    W, KV = k_cache.shape[1], k_cache.shape[2]
    q4 = q[:, 0].float().reshape(B, KV, H // KV, hd)
    s = torch.einsum("bkgd,bwkd->bkgw", q4, k_cache.float()) / hd ** 0.5
    span = tiles_per_split * tile
    ms, ls, accs = [], [], []
    for i in range(n_split):
        sl = slice(i * span, min(W, (i + 1) * span))
        ok = valid[sl]
        si = torch.where(ok, s[..., sl], NEG_INF)
        m = si.amax(dim=-1, keepdim=True)
        p = torch.where(ok, torch.exp(si - m), 0.0)
        ms.append(m)
        ls.append(p.sum(dim=-1, keepdim=True))
        accs.append(torch.einsum("bkgw,bwkd->bkgd", p, v_cache[:, sl].float()))
    M = torch.stack(ms).amax(dim=0)
    w = [torch.exp(m - M) for m in ms]
    L = sum(l_i * w_i for l_i, w_i in zip(ls, w))
    acc = sum(a_i * w_i for a_i, w_i in zip(accs, w))
    out = acc / torch.clamp_min(L, 1e-30)
    mean = v_cache.float().mean(dim=1).reshape(B, KV, 1, hd)
    out = torch.where(M <= NEG_INF, mean, out)
    return out.reshape(B, 1, H, hd).to(q.dtype)

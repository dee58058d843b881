"""GQA attention: causal, sliding-window, bidirectional and cross;
prefill and decode.

Three interchangeable inner implementations (``impl``), as in the JAX
package, with the hand-written kernel in the place of its Pallas one:

  * ``naive``   — materialises (S, T) scores; reference and small tests.
  * ``chunked`` — loops over query and key blocks with an online softmax
                  (the flash-attention recurrence in plain torch ops).
  * ``cuda``    — the CUDA kernels in ``repro_torch.kernels``
                  (``flash_attention`` for prefill, ``decode_attention``
                  for one token against the cache). On CPU tensors their
                  wrappers run the plain versions.

``impl=None`` picks ``cuda`` for CUDA tensors and ``chunked`` on the CPU,
so the card's route is the kernel. Decode's plain routes are ``chunked``
(the online softmax over cache blocks) and ``einsum``.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.utils.checkpoint

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.pspec import (gathered, grad_gathered,
                                      on_head_shards, reduced, reshaped,
                                      softmax_last, write_slot)

Tensor = torch.Tensor

NEG_INF = -1e30


def _impl(impl: Optional[str], x: Tensor) -> str:
    return impl or ("cuda" if x.is_cuda else "chunked")


def init_attention(gen: torch.Generator, cfg: ModelConfig, *, device,
                   dtype=torch.float32, lead: tuple = ()):
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    kw = dict(device=device, dtype=dtype, lead=lead)
    p = {
        "w_q": layers.dense_init(gen, D, H * hd, **kw),
        "w_k": layers.dense_init(gen, D, KV * hd, **kw),
        "w_v": layers.dense_init(gen, D, KV * hd, **kw),
        "w_o": layers.dense_init(gen, H * hd, D, **kw),
    }
    if cfg.attn_bias:
        for name, n in (("b_q", H * hd), ("b_k", KV * hd), ("b_v", KV * hd)):
            p[name] = torch.zeros(tuple(lead) + (n,), device=device,
                                  dtype=dtype)
    return p


def qkv_project(p, cfg: ModelConfig, x: Tensor,
                kv_src: Optional[Tensor] = None):
    """x: (B, S, D) -> q (B, S, H, hd), k/v (B, T, KV, hd); K and V come
    from ``kv_src`` (B, T, D) when given (cross-attention), else from x."""
    dt = x.dtype
    B, S, _ = x.shape
    src = x if kv_src is None else kv_src
    T = src.shape[1]
    q = x @ p["w_q"].to(dt)
    k = src @ p["w_k"].to(dt)
    v = src @ p["w_v"].to(dt)
    if "b_q" in p:
        q = q + p["b_q"].to(dt)
        k = k + p["b_k"].to(dt)
        v = v + p["b_v"].to(dt)
    # On a mesh, fewer heads than the model axis's shards need the
    # projection gathered before the head split (pspec.reshaped).
    H, KV = cfg.num_heads, cfg.num_kv_heads
    return (reshaped(q, (B, S, H, cfg.hd), -1, H),
            reshaped(k, (B, T, KV, cfg.hd), -1, KV),
            reshaped(v, (B, T, KV, cfg.hd), -1, KV))


def _expand_kv(k: Tensor, groups: int) -> Tensor:
    """(B, T, KV, hd) -> (B, T, KV*G, hd) by repeat (GQA). On a mesh the
    gradient's heads are gathered before the repeat's backward folds them
    into (KV, G) (pspec.grad_gathered); G = 1 folds nothing."""
    kx = k.repeat_interleave(groups, dim=2)
    return grad_gathered(kx, 2) if groups > 1 else kx


def _mask(mode: str, q_pos: Tensor, k_pos: Tensor, window: int) -> Tensor:
    """Boolean validity mask (Sq, Tk) from absolute positions."""
    d = q_pos[:, None] - k_pos[None, :]
    if mode == "causal":
        return d >= 0
    if mode == "sliding":
        return (d >= 0) & (d < window)
    if mode == "full":
        return torch.ones_like(d, dtype=torch.bool)
    raise ValueError(mode)


def naive_attention(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor,
                    k_pos: Tensor, mode: str = "causal",
                    window: int = 0) -> Tensor:
    """Reference: q (B,S,H,hd), k/v (B,T,KV,hd) -> (B,S,H,hd)."""
    hd = q.shape[-1]
    G = q.shape[2] // k.shape[2]
    kx = _expand_kv(k, G).float()
    vx = _expand_kv(v, G).float()
    scores = torch.einsum("bshd,bthd->bhst", q.float(), kx) * (
        1.0 / hd ** 0.5)
    scores = torch.where(_mask(mode, q_pos, k_pos, window), scores, NEG_INF)
    out = torch.einsum("bhst,bthd->bshd", torch.softmax(scores, dim=-1), vx)
    return out.to(q.dtype)


def _fit_block(n: int, b: int) -> int:
    """Largest block <= b that divides n (e.g. 1500 @ 512 -> 500)."""
    b = min(b, n)
    while n % b:
        b -= 1
    return b


def _block_probs(q32: Tensor, kx: Tensor, msk: Tensor, m_run: Tensor,
                 scale: float):
    """One block's unnormalised probabilities p (B, H, q_block, kv_block)
    and the running max after it."""
    s = torch.einsum("bqhd,bkhd->bhqk", q32, kx) * scale
    s = torch.where(msk, s, NEG_INF)
    m_new = torch.maximum(m_run, s.amax(-1))
    return torch.exp(s - m_new[..., None]), m_new


def chunked_attention(
    q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor, k_pos: Tensor,
    mode: str = "causal", window: int = 0,
    q_block: int = 512, kv_block: int = 512,
) -> Tensor:
    """Online-softmax attention over query blocks and key/value blocks,
    every block visited and the invalid ones masked, as in the JAX
    package. Under autograd a block's scores are recomputed in the
    backward, as the JAX package's ``jax.checkpoint`` on its key/value
    step does: its backward recomputes each block's scores and
    probabilities, and no other product. On a mesh it runs on each
    device's shards of the batch and the heads (``pspec.on_head_shards``),
    so no collective runs inside its loops, forward or backward."""
    return on_head_shards(functools.partial(
        _chunked, q_pos=q_pos, k_pos=k_pos, mode=mode, window=window,
        q_block=q_block, kv_block=kv_block), q, k, v)


def _chunked(q: Tensor, k: Tensor, v: Tensor, *, q_pos: Tensor,
             k_pos: Tensor, mode: str, window: int, q_block: int,
             kv_block: int) -> Tensor:
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    q_block = _fit_block(S, q_block)
    kv_block = _fit_block(T, kv_block)
    scale = 1.0 / float(hd) ** 0.5
    probs = _block_probs
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad):
        probs = functools.partial(torch.utils.checkpoint.checkpoint,
                                  _block_probs, use_reentrant=False)
    outs = []
    for i in range(0, S, q_block):
        q32 = q[:, i:i + q_block].float()
        qp = q_pos[i:i + q_block]
        m_run = torch.full((B, H, q_block), NEG_INF, device=q.device)
        l_run = torch.zeros((B, H, q_block), device=q.device)
        acc = torch.zeros((B, H, q_block, hd), device=q.device)
        for j in range(0, T, kv_block):
            kx = _expand_kv(k[:, j:j + kv_block], G).float()
            vx = _expand_kv(v[:, j:j + kv_block], G).float()
            msk = _mask(mode, qp, k_pos[j:j + kv_block], window)
            p, m_new = probs(q32, kx, msk, m_run, scale)
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd",
                                                       p, vx)
            m_run = m_new
        out = acc / torch.clamp_min(l_run, 1e-30)[..., None]
        outs.append(out.transpose(1, 2))                   # (B, qb, H, hd)
    return torch.cat(outs, dim=1).to(q.dtype)


def attention(
    p,
    cfg: ModelConfig,
    x: Tensor,
    positions: Tensor,
    *,
    kv_src: Optional[Tensor] = None,
    kv_positions: Optional[Tensor] = None,
    mode: str = "causal",
    rope: bool = True,
    impl: Optional[str] = None,
    return_kv: bool = False,
):
    """Full attention block (projections + RoPE + inner attention +
    output projection).

    x: (B, S, D); positions: (S,) absolute positions. kv_src: the
    encoder's output (B, T, D) for cross-attention (mode="full",
    rope=False), with ``kv_positions`` (T,). return_kv=True also returns
    the (roped) K and V, the cache content a batched prefill emits. The
    ``cuda`` route, like the TPU op it replaces, assumes positions 0..S-1
    and 0..T-1 (prefill; full mode ignores them).
    """
    B, S, _ = x.shape
    impl = _impl(impl, x)
    q, k, v = qkv_project(p, cfg, x, kv_src)
    k_pos = positions if kv_positions is None else kv_positions
    if rope:
        q = layers.apply_rope(q, positions.expand(B, S), cfg.rope_theta)
        k = layers.apply_rope(k, k_pos.expand(B, k.shape[1]), cfg.rope_theta)
    window = cfg.window
    if mode == "causal" and window > 0:
        mode = "sliding"
    if impl == "naive":
        out = naive_attention(q, k, v, positions, k_pos, mode, window)
    elif impl == "chunked":
        out = chunked_attention(q, k, v, positions, k_pos, mode, window)
    elif impl == "cuda":
        from repro_torch.kernels.flash_attention import ops as fa_ops
        out = fa_ops.flash_attention(q, k, v, mode=mode, window=window)
    else:
        raise ValueError(impl)
    out = reshaped(out, (B, S, cfg.num_heads * cfg.hd), 2,
                   cfg.num_heads) @ p["w_o"].to(x.dtype)
    if return_kv:
        return out, (k, v)
    return out


# ---------------------------------------------------------------------------
# decode: one new token against a KV cache (ring buffer when windowed)
# ---------------------------------------------------------------------------

def ring_valid(pos: int, W: int, window: int, device) -> Tensor:
    """(W,) bool: which ring-buffer slots hold a position the token at
    ``pos`` attends to. Slot i holds the largest absolute position
    <= pos congruent to i (mod W); negative means never written. Valid
    iff that position is in [0, pos], within the last W, and (when
    windowed) within the window."""
    idx = torch.arange(W, device=device)
    wraps = torch.div(pos - idx, W, rounding_mode="floor")
    abs_pos = idx + wraps * W
    valid = (abs_pos >= 0) & (abs_pos <= pos) & (abs_pos > pos - W)
    if window > 0:
        valid &= abs_pos > pos - window
    return valid


def decode_attention(
    p,
    cfg: ModelConfig,
    x: Tensor,           # (B, 1, D) current-token activations
    k_cache: Tensor,     # (B, W, KV, hd)
    v_cache: Tensor,     # (B, W, KV, hd)
    pos: int,            # absolute position of the new token
    *,
    impl: Optional[str] = None,
    kv_block: int = 1024,
):
    """Serve-step attention. Writes the new K/V at slot ``pos mod W`` of
    the caches IN PLACE (the JAX package returns updated copies; the port
    saves the copy) and attends over the valid slots. Returns (out
    (B,1,D), k_cache, v_cache)."""
    B = x.shape[0]
    W = k_cache.shape[1]
    impl = _impl(impl, x)
    q, k_new, v_new = qkv_project(p, cfg, x)
    posb = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q = layers.apply_rope(q, posb, cfg.rope_theta)
    k_new = layers.apply_rope(k_new, posb, cfg.rope_theta)
    # On a mesh that shards W, the shard holding the slot writes it.
    slot = pos % W
    write_slot(k_cache, slot, layers.astype(k_new[:, 0], k_cache.dtype))
    write_slot(v_cache, slot, layers.astype(v_new[:, 0], v_cache.dtype))
    valid = ring_valid(pos, W, cfg.window, x.device)
    if impl == "cuda":
        from repro_torch.kernels.decode_attention import ops as da_ops
        out = da_ops.decode_attention(q, k_cache, v_cache, valid)
    elif impl == "einsum":
        out = _einsum_decode(q, k_cache, v_cache, valid)
    elif impl == "chunked":
        out = _masked_decode(q, k_cache, v_cache, valid, kv_block)
    else:
        raise ValueError(impl)
    out = reshaped(out, (B, 1, cfg.num_heads * cfg.hd), 2, cfg.num_heads)
    return out @ p["w_o"].to(x.dtype), k_cache, v_cache


def _einsum_decode(q, k_cache, v_cache, valid):
    """One contraction over the whole cache. As in the JAX package, the
    products run on the query dtype's values with f32 accumulation, and
    the softmax weights are rounded to the query dtype before P.V."""
    B, _, H, hd = q.shape
    KV = k_cache.shape[2]
    cdt = q.dtype
    # On a mesh the contractions batch (b, k) as one flattened dimension,
    # which DTensor cannot form with k sharded: the token's query heads
    # are gathered first (pspec.gathered).
    q4 = gathered(q[:, 0], 1).reshape(B, KV, H // KV, hd).float()
    s = torch.einsum("bkgd,bwkd->bkgw", q4,
                     k_cache.to(cdt).float()) * (1.0 / float(hd) ** 0.5)
    s = torch.where(valid, s, NEG_INF)
    # A cache sharded on W leaves the scores sharded on w: the softmax
    # stays on the shards and P.V's partial sums are reduced once.
    w = softmax_last(s).to(cdt).float()
    o = reduced(torch.einsum("bkgw,bwkd->bkgd", w, v_cache.to(cdt).float()))
    return o.reshape(B, 1, H, hd).to(cdt)


def _masked_decode(q, k_cache, v_cache, valid, kv_block):
    """Online softmax over cache blocks; q (B, 1, H, hd)."""
    B, _, H, hd = q.shape
    W, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    kv_block = _fit_block(W, kv_block)
    scale = 1.0 / float(hd) ** 0.5
    q32 = q[:, 0].float()                                  # (B, H, hd)
    m_run = torch.full((B, H), NEG_INF, device=q.device)
    l_run = torch.zeros((B, H), device=q.device)
    acc = torch.zeros((B, H, hd), device=q.device)
    for j in range(0, W, kv_block):
        # Widened before the repeat (exact either way), so that an fp8
        # cache needs no index kernel of its dtype.
        kx = _expand_kv(k_cache[:, j:j + kv_block].float(), G)
        vx = _expand_kv(v_cache[:, j:j + kv_block].float(), G)
        s = torch.einsum("bhd,bkhd->bhk", q32, kx) * scale
        s = torch.where(valid[j:j + kv_block], s, NEG_INF)
        m_new = torch.maximum(m_run, s.amax(-1))
        pw = torch.exp(s - m_new[..., None])
        corr = torch.exp(m_run - m_new)
        l_run = l_run * corr + pw.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhk,bkhd->bhd", pw, vx)
        m_run = m_new
    out = acc / torch.clamp_min(l_run, 1e-30)[..., None]
    return out[:, None].to(q.dtype)

"""Token-choice top-k Mixture-of-Experts with capacity-bounded dispatch,
as in the JAX package's ``models/moe.py``.

Routing scatters each token's k routed copies into per-expert buffers of
``capacity`` rows, in arrival order: a cumulative count over the
token-major (N * k) copies. A copy that arrives past its expert's
capacity is dropped: it is scattered as zeros into the buffer's last row
and gathered back with weight 0. The expert FFNs run as one batched
product over the expert axis (the JAX package computes it outside any
Pallas kernel too), and the results gather back weighted by the router's
gates, renormalised over the top k. Every expert's buffer runs through its
FFN whatever it holds, so a step reads every expert's weights. The
buffers carry the JAX package's sharding hints (``pspec.hint``:
"moe_buffer", and "moe_group_local" for the grouped dispatch's per-group
buffers), which place them on a mesh and do nothing without one.

Covers DBRX (16 experts, top-4, fine-grained) and Llama-4 Maverick (128
experts, top-1).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.pspec import (grad_like, hint, on_rows, reduced,
                                      reshaped, rows_like, scatter_rows,
                                      take_rows)

Tensor = torch.Tensor


def init_moe(gen: torch.Generator, cfg: ModelConfig, *, device,
             dtype=torch.float32, lead: tuple = ()):
    """JAX's distributions from ``gen``, stacked over ``lead``: the router
    (D, E) and the experts' SwiGLU weights (E, D, F), (E, D, F), (E, F, D)."""
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    lead = tuple(lead)
    kw = dict(generator=gen, device=device, dtype=dtype)
    return {
        "router": layers.dense_init(gen, D, E, device=device, dtype=dtype,
                                    lead=lead),
        "w_gate": torch.randn(lead + (E, D, Fd), **kw).mul_(1 / math.sqrt(D)),
        "w_up": torch.randn(lead + (E, D, Fd), **kw).mul_(1 / math.sqrt(D)),
        "w_down": torch.randn(lead + (E, Fd, D), **kw).mul_(
            1 / math.sqrt(Fd)),
    }


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = int(n_tokens * cfg.experts_per_token * cfg.capacity_factor
            / cfg.num_experts)
    return max(8, (c + 7) // 8 * 8)  # pad to a multiple of 8


def _top_k(probs: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """The k largest probabilities and their experts, ties to the lowest
    expert index first (``jax.lax.top_k``'s order; ``torch.topk`` promises
    none among ties). On a mesh it runs on each device's tokens
    (``pspec.on_rows``)."""
    def top(p):
        vals, idx = torch.sort(p, dim=-1, descending=True, stable=True)
        return vals[..., :k], idx[..., :k]

    return on_rows(top, probs, 2)


def _positions_in_expert(flat_eids: Tensor, E: int) -> Tensor:
    """Arrival order of each routed copy within its expert's buffer, along
    the last axis of ``flat_eids``."""
    pos = F.one_hot(flat_eids, E).cumsum(-2) - 1
    return pos.gather(-1, flat_eids[..., None])[..., 0]


def _ffn(p, buf: Tensor, dt) -> Tensor:
    """(E, C, D) buffers through each expert's SwiGLU, one batched product
    per weight."""
    g = torch.bmm(buf, p["w_gate"].to(dt))
    u = torch.bmm(buf, p["w_up"].to(dt))
    return torch.bmm(F.silu(g) * u, p["w_down"].to(dt))


def apply_moe(p, cfg: ModelConfig, x: Tensor) -> Tuple[Tensor, Tensor]:
    """x: (B, S, D) -> (out (B, S, D), aux load-balance loss scalar)."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    # On a mesh the tokens' gradient comes back sharded over every axis
    # on its rows, which the batch may not divide (pspec.reshaped).
    tokens = reshaped(x, (B * S, D), 0, B)
    N = B * S

    logits = tokens @ p["router"].to(x.dtype)               # (N, E)
    probs = torch.softmax(logits.float(), dim=-1)
    gates, eids = _top_k(probs, K)                          # (N, K)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)

    # Load-balance auxiliary loss (Switch-style): E * sum_e f_e * p_e. On
    # a mesh the means over the token shards are completed at once, and
    # the loss's gradient reaches probs on probs' shards (pspec.grad_like).
    frac_tokens = reduced(F.one_hot(eids, E).float().sum(1).mean(0) / K)
    aux = E * torch.sum(frac_tokens * reduced(grad_like(probs).mean(0)))

    G = cfg.moe_dispatch_groups
    if G > 1 and N % G == 0:
        out = _dispatch_grouped(p, cfg, tokens, gates, eids, G)
    else:
        out = _dispatch_flat(p, cfg, tokens, gates, eids)
    return reshaped(out, (B, S, D), 0, B), aux


def _dispatch_flat(p, cfg: ModelConfig, tokens, gates, eids) -> Tensor:
    """One global capacity buffer of (E, C) rows."""
    return _dispatch_grouped(p, cfg, tokens, gates, eids, 1)


def _dispatch_grouped(p, cfg: ModelConfig, tokens, gates, eids,
                      G: int) -> Tensor:
    """Tokens split into G contiguous groups, each scattered into its own
    (E, Cg) buffer with a per-group capacity Cg; the experts then run over
    (E, G * Cg) rows and each group gathers back from its own rows. G = 1
    is the flat dispatch. (In the JAX package the groups align with the
    data shards, so the exchange is an all-to-all; on one card it is a
    transpose.)"""
    dt = tokens.dtype
    N, D = tokens.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    Ng = N // G
    Cg = capacity(cfg, Ng)

    # G groups on a data axis they do not divide: gathered before the
    # split (pspec.reshaped).
    eids_g = reshaped(eids, (G, Ng * K), 0, G)
    pos = _positions_in_expert(eids_g, E)
    keep = pos < Cg                                         # capacity drop
    slot = eids_g * Cg + pos.clamp(0, Cg - 1)               # (G, Ng*K)
    # Each group's rows in one (G * E * Cg) buffer: a kept copy lands on a
    # row of its own, a dropped one adds zeros.
    rows = (slot + torch.arange(G, device=slot.device)[:, None] * E * Cg
            ).reshape(-1)
    vals = tokens.repeat_interleave(K, dim=0) * keep.reshape(-1, 1).to(dt)
    # On a mesh the scatter and the gather back run on each device's
    # shards of the routed copies (pspec.scatter_rows, take_rows), whose
    # rows are taken on the copies' shards first.
    rows = rows_like(rows, vals)
    if G == 1:                                  # the flat dispatch
        buf = scatter_rows(rows, vals, "moe_buffer", (E, Cg, D))
        buf = hint(buf.reshape(E, Cg, D), "moe_buffer")
        back = hint(_ffn(p, buf, dt), "moe_buffer").reshape(E * Cg, D)
    else:
        # (G, E, Cg, D) data-sharded -> (E, G * Cg, D) expert-sharded.
        buf = scatter_rows(rows, vals, "moe_group_local", (G, E, Cg, D))
        buf = hint(buf.reshape(G, E, Cg, D), "moe_group_local")
        buf = hint(buf.transpose(0, 1).reshape(E, G * Cg, D), "moe_buffer")
        out = hint(_ffn(p, buf, dt), "moe_buffer")
        back = hint(out.reshape(E, G, Cg, D).transpose(0, 1),
                    "moe_group_local").reshape(G * E * Cg, D)

    w = (gates.reshape(-1) * keep.reshape(-1).float()).to(dt)
    return take_rows(back, rows, w, K)

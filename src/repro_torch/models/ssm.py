"""Mamba2 blocks via state-space duality (SSD), arXiv:2405.21060.

Prefill runs the SSD scan in one of three interchangeable routes
(``impl``), as attention does in ``models/attention.py``:

  * ``naive``   — ``ssd_sequential``, the token-by-token recurrence: the
                  oracle.
  * ``chunked`` — ``ssd_chunked``: per chunk of Q rows, the intra-chunk
                  term as a masked (Q x Q) product and the carried (N, P)
                  state between chunks, in plain torch ops.
  * ``cuda``    — the CUDA kernel ``repro_torch.kernels.ssd_scan`` (the
                  chunked scan in one launch); on CPU tensors its wrapper
                  runs its plain version.

``impl=None`` picks ``cuda`` for CUDA tensors and ``chunked`` on the CPU,
so the card's route is the kernel. The JAX package runs ``ssd_chunked``
in prefill; its Pallas kernel has the same contract as the CUDA one.

Projections are separate matrices (wz/wx/wB/wC/wdt) as in the JAX
package. Decode is the O(1) recurrent update h <- exp(dt A) h + dt B (x) x
with a rolling conv window, in plain tensor ops (the JAX package has no
kernel for it either).
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.pspec import (gathered, on_conv_shards,
                                      on_ssd_shards, placed_like, reduced)

Tensor = torch.Tensor


class SSMState(NamedTuple):
    conv: Tensor  # (B, conv_width-1, d_in + 2N) rolling raw conv inputs
    h: Tensor     # (B, H, N, P) recurrent state (f32)


def init_mamba2(gen: torch.Generator, cfg: ModelConfig, *, device,
                dtype=torch.float32, lead: tuple = ()):
    """JAX's distributions from ``gen``, stacked over ``lead``. The
    projections and the conv are stored in ``dtype`` (JAX casts them to
    the activations' dtype at use); A_log, dt_bias, D and norm_w stay f32,
    as JAX uses them in f32."""
    D = cfg.d_model
    d_in, N, H = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    w = cfg.conv_width
    lead = tuple(lead)
    f32 = dict(device=device, dtype=torch.float32)
    kw = dict(device=device, dtype=dtype, lead=lead)

    def uniform(lo, hi, shape):
        u = torch.rand(lead + shape, generator=gen, **f32)
        return u * (hi - lo) + lo

    # dt bias: softplus^{-1} of log-spaced dt in [1e-3, 0.1]
    dt = torch.exp(uniform(0.0, 1.0, (H,))
                   * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    C = d_in + 2 * N
    conv_w = torch.randn(lead + (w, C), generator=gen, **f32) / math.sqrt(w)
    return {
        "wz": layers.dense_init(gen, D, d_in, **kw),
        "wx": layers.dense_init(gen, D, d_in, **kw),
        "wB": layers.dense_init(gen, D, N, **kw),
        "wC": layers.dense_init(gen, D, N, **kw),
        "wdt": layers.dense_init(gen, D, H, **kw),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros(lead + (C,), device=device, dtype=dtype),
        "A_log": torch.log(uniform(1.0, 16.0, (H,))),
        "dt_bias": dt_bias,
        "D": torch.ones(lead + (H,), **f32),
        "norm_w": torch.ones(lead + (d_in,), **f32),
        "out_proj": layers.dense_init(gen, d_in, D, **kw),
    }


def _causal_conv(xBC: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Depthwise causal conv, width W, as a sum of shifted slices in the
    input's dtype (JAX's order of additions). On a mesh it runs on each
    device's shards of the batch and the channels
    (``pspec.on_conv_shards``)."""
    return on_conv_shards(_conv, xBC, w, b)


def _conv(xBC: Tensor, w: Tensor, b: Tensor) -> Tensor:
    W = w.shape[0]
    L = xBC.shape[1]
    xp = F.pad(xBC, (0, 0, W - 1, 0))                # (B, L+W-1, C)
    out = torch.zeros_like(xBC)
    for k in range(W):
        out = out + xp[:, k:k + L, :] * w[k].to(xBC.dtype)
    return F.silu(out + b.to(xBC.dtype))


def _project_xBC(p, x: Tensor) -> Tensor:
    """Raw (pre-conv) concat [x_ssd | B | C] channels."""
    dt_ = x.dtype
    return torch.cat([x @ p["wx"].to(dt_), x @ p["wB"].to(dt_),
                      x @ p["wC"].to(dt_)], dim=-1)


def _outer(a: Tensor, b: Tensor) -> Tensor:
    """The outer product of a's and b's last axes over their shared
    leading axes, (..., m) x (..., n) -> (..., m, n), as a batched product
    with a depth of 1. It is what the JAX package's einsums compute for
    their products without a summed axis (a ``dot_general``), and its
    value is the elementwise product's."""
    lead = a.shape[:-1]
    return torch.bmm(a.reshape(-1, a.shape[-1], 1),
                     b.reshape(-1, 1, b.shape[-1])).reshape(
        lead + (a.shape[-1], b.shape[-1]))


def _chunk_step(x32, dtq, A, Bq, Cq, h, tri):
    """One chunk of ``ssd_chunked``: the intra-chunk mixing matrix M
    (B, Q, Q, H), the carried state's share of y (B, Q, H, P) and the
    state after the chunk. Under autograd it runs under a checkpoint, as
    the JAX package's chunk step does (``jax.checkpoint``): the backward
    recomputes the products it needs here (C.B, the state's share of y,
    the state's input) and stops before the state's update, which comes
    last; the intra-chunk product of M and x runs outside."""
    cum = torch.cumsum(dtq * A, dim=1)                      # inclusive
    seg = cum[:, :, None, :] - cum[:, None, :, :]           # (B,Q,Q,H)
    Ldec = torch.where(tri, torch.exp(torch.where(tri, seg, 0.0)), 0.0)
    CB = torch.einsum("bin,bjn->bij", Cq, Bq)               # (B,Q,Q)
    M = CB[..., None] * Ldec * dtq[:, None, :, :]           # (B,Q,Q,H)
    y_inter = torch.einsum("bin,bhnp->bihp", Cq, h)
    y_inter = y_inter * torch.exp(cum)[..., None]
    decay_to_end = torch.exp(cum[:, -1:, :] - cum)          # (B,Q,H)
    wx = _outer((decay_to_end * dtq)[..., None], x32)[..., 0, :]
    h = h * torch.exp(cum[:, -1])[:, :, None, None]
    return M, y_inter, h + torch.einsum("bjn,bjhp->bhnp", Bq, wx)


def ssd_chunked(x: Tensor, dt: Tensor, A: Tensor, B_in: Tensor,
                C_in: Tensor, D_skip: Tensor, chunk: int,
                h0: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Chunked SSD scan in f32. x (B, L, H, P), dt (B, L, H) positive step
    sizes, A (H,) negative, B_in/C_in (B, L, N), D_skip (H,). L is padded
    up to a multiple of ``chunk``, dt with zeros, so that padded steps
    neither decay the state (exp(0) = 1) nor inject input: h_final stays
    exact for prefill -> decode. Returns (y (B, L, H, P) in x's dtype,
    h_final (B, H, N, P) f32).

    With inclusive in-chunk cumulants ``cum_i = sum_{k<=i} dt_k A``:

      y_i = C_i h_prev e^{cum_i}
            + sum_{j<=i} (C_i . B_j) e^{cum_i - cum_j} dt_j x_j + D x_i
      h'  = e^{cum_Q} h_prev + sum_j e^{cum_Q - cum_j} dt_j B_j (x) x_j

    The decay e^{cum_i - cum_j} is taken only where j <= i: above the
    diagonal the exponent is positive and could overflow. On a mesh it
    runs on each device's shards of the batch and the heads
    (``pspec.on_ssd_shards``), so no collective runs inside its loop,
    forward or backward.
    """
    return on_ssd_shards(functools.partial(_ssd_chunked, chunk=chunk),
                         x, dt, A, B_in, C_in, D_skip, h0)


def _ssd_chunked(x: Tensor, dt: Tensor, A: Tensor, B_in: Tensor,
                 C_in: Tensor, D_skip: Tensor, h0: Optional[Tensor], *,
                 chunk: int) -> Tuple[Tensor, Tensor]:
    L = x.shape[1]
    pad = (-L) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt, B_in, C_in = (F.pad(t, (0, 0, 0, pad)) for t in (dt, B_in, C_in))
    Bb, Lp, H, P = x.shape
    N = B_in.shape[-1]
    f32 = torch.float32
    A = A.to(f32)
    D_skip = D_skip.to(f32)
    h = (torch.zeros((Bb, H, N, P), dtype=f32, device=x.device)
         if h0 is None else h0.to(f32))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))[None, :, :, None]
    step = _chunk_step
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, B_in, C_in, h)):
        step = functools.partial(torch.utils.checkpoint.checkpoint,
                                 _chunk_step, use_reentrant=False)
    ys = []
    for c0 in range(0, Lp, chunk):
        sl = slice(c0, c0 + chunk)
        x32 = x[:, sl].to(f32)                              # (B,Q,H,P)
        M, y_inter, h = step(x32, dt[:, sl].to(f32), A, B_in[:, sl].to(f32),
                             C_in[:, sl].to(f32), h, tri)
        y_intra = torch.einsum("bijh,bjhp->bihp", M, x32)
        y = y_intra + y_inter + x32 * D_skip[None, None, :, None]
        ys.append(y.to(x.dtype))
    return torch.cat(ys, dim=1)[:, :L], h


def mamba2_forward(p, cfg: ModelConfig, x: Tensor, *,
                   return_state: bool = False, impl: Optional[str] = None):
    """Full Mamba2 block for prefill. x: (B, L, D) -> (B, L, D), and with
    ``return_state`` the decode state after the last token."""
    Bb, L, D = x.shape
    dt_ = x.dtype
    d_in, N, H, P = (cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads,
                     cfg.ssm_head_dim)
    impl = impl or ("cuda" if x.is_cuda else "chunked")
    z = x @ p["wz"].to(dt_)
    xBC_raw = _project_xBC(p, x)
    xBC = _causal_conv(xBC_raw, p["conv_w"], p["conv_b"])
    xs, B_in, C_in = torch.split(xBC, [d_in, N, N], dim=-1)
    dt_raw = x @ p["wdt"].to(dt_)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    if impl == "cuda":
        # The kernel reads xs / B_in / C_in, views of xBC, through their
        # strides and masks the rows of a ragged last chunk itself.
        from repro_torch.kernels.ssd_scan import ops as ssd_ops
        y, h_final = ssd_ops.ssd_scan(xs.reshape(Bb, L, H, P), dt, A, B_in,
                                      C_in, p["D"], chunk=cfg.ssm_chunk)
    elif impl == "chunked":
        y, h_final = ssd_chunked(xs.reshape(Bb, L, H, P), dt, A, B_in, C_in,
                                 p["D"], cfg.ssm_chunk)
    elif impl == "naive":
        y, h_final = ssd_sequential(xs.reshape(Bb, L, H, P), dt, A, B_in,
                                    C_in, p["D"])
    else:
        raise ValueError(impl)
    y = y.reshape(Bb, L, d_in)
    y = layers.rms_norm(y * F.silu(z), p["norm_w"])
    out = y @ p["out_proj"].to(dt_)
    if return_state:
        conv_state = xBC_raw[:, -(cfg.conv_width - 1):, :]
        return out, SSMState(conv=conv_state, h=h_final)
    return out


def init_ssm_state(cfg: ModelConfig, batch: int, dtype, device) -> SSMState:
    d_in, N, H, P = (cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads,
                     cfg.ssm_head_dim)
    return SSMState(
        conv=torch.zeros((batch, cfg.conv_width - 1, d_in + 2 * N),
                         dtype=dtype, device=device),
        h=torch.zeros((batch, H, N, P), dtype=torch.float32, device=device),
    )


def mamba2_decode(p, cfg: ModelConfig, x: Tensor,
                  state: SSMState) -> Tuple[Tensor, SSMState]:
    """One-token recurrent update. x: (B, 1, D) -> (B, 1, D) and the new
    state (fresh tensors; ``state`` is not modified)."""
    Bb = x.shape[0]
    dt_ = x.dtype
    d_in, N, H, P = (cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads,
                     cfg.ssm_head_dim)
    if state.conv.dtype in layers.FP8_DTYPES:
        # The JAX package concatenates the conv state with the new column
        # and fp8 does not promote there: a TypePromotionError, which is a
        # ValueError.
        raise ValueError(f"{cfg.name}: an SSM conv state in "
                         f"{state.conv.dtype} does not promote with the "
                         f"{dt_} input column")
    # On a mesh the residual stream may arrive as a partial sum: it is
    # completed before the projections (pspec.reduced).
    x0 = reduced(x[:, 0])
    z = x0 @ p["wz"].to(dt_)
    xBC_new = _project_xBC(p, x0)                           # (B, d_in + 2N)

    # rolling causal conv over the last conv_width raw inputs
    window = torch.cat([state.conv, xBC_new[:, None]], dim=1)
    w = p["conv_w"].to(dt_)
    conv_out = torch.einsum("bwc,wc->bc", window, w) + p["conv_b"].to(dt_)
    xBC = F.silu(conv_out)
    new_conv = window[:, 1:]

    xs, B_in, C_in = torch.split(xBC, [d_in, N, N], dim=-1)
    xs = xs.reshape(Bb, H, P).float()
    dt_raw = x0 @ p["wdt"].to(dt_)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])         # (B, H)
    A = -torch.exp(p["A_log"].float())
    dA = torch.exp(dt * A)                                  # (B, H)
    Bdt = _outer(B_in.float(), dt)                           # (B, N, H)
    # _outer flattens (B, H): on a mesh the heads are gathered first,
    # since DTensor cannot flatten a sharded inner dimension.
    h = state.h * dA[:, :, None, None] + _outer(
        gathered(Bdt.transpose(1, 2), 1), gathered(xs, 1))
    # The skip term on the state term's shards of the heads
    # (pspec.placed_like), where the torches' rules differ.
    y = torch.einsum("bn,bhnp->bhp", C_in.float(), h)
    y = y + placed_like(xs, y) * p["D"][None, :, None]
    y = y.reshape(Bb, d_in).to(dt_)
    y = layers.rms_norm(y * F.silu(z), p["norm_w"])
    out = (y @ p["out_proj"].to(dt_))[:, None]
    return out, SSMState(conv=new_conv, h=h)


# ---------------------------------------------------------------------------
# sequential reference (oracle of the chunked scan and of the kernel)
# ---------------------------------------------------------------------------

def ssd_sequential(x, dt, A, B_in, C_in, D_skip, h0=None):
    """O(L) token-by-token recurrence; ground truth for ``ssd_chunked``."""
    Bb, L, H, P = x.shape
    N = B_in.shape[-1]
    f32 = torch.float32
    A = A.to(f32)
    D_skip = D_skip.to(f32)
    h = (torch.zeros((Bb, H, N, P), dtype=f32, device=x.device)
         if h0 is None else h0.to(f32))
    ys = []
    for t in range(L):
        x_t = x[:, t].to(f32)                               # (B, H, P)
        dt_t = dt[:, t].to(f32)                             # (B, H)
        dA = torch.exp(dt_t * A)
        h = h * dA[:, :, None, None] + torch.einsum(
            "bn,bh,bhp->bhnp", B_in[:, t].to(f32), dt_t, x_t)
        y = torch.einsum("bn,bhnp->bhp", C_in[:, t].to(f32), h)
        ys.append(y + x_t * D_skip[None, :, None])
    return torch.stack(ys, dim=1).to(x.dtype), h

"""Shared layer primitives: norms, RoPE, MLPs, initialisers.

Functional style as in the JAX package: ``init_*`` returns a dict of
tensors, the ``apply`` functions are pure. Weights keep JAX's
``(d_in, d_out)`` layout, so a projection is ``x @ w``, and are cast to
the activations' dtype at use (a no-op when they are stored in it).
Initialisers draw from an explicit ``torch.Generator`` with JAX's
distributions; they do not reproduce JAX's bits (tests carry JAX's
weights across through ``interop``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.pspec import grad_reduced, mean_last

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# initialisers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, *, device,
               dtype=torch.float32, scale: float = 1.0,
               lead: tuple = ()) -> Tensor:
    """N(0, scale^2 / d_in) of shape ``lead + (d_in, d_out)``: ``lead`` is
    the stacked layer axis of a decoder's blocks."""
    w = torch.randn(tuple(lead) + (d_in, d_out), generator=gen,
                    device=device, dtype=dtype)
    return w.mul_(scale / math.sqrt(d_in))


def embed_init(gen: torch.Generator, vocab: int, d: int, *, device,
               dtype=torch.float32) -> Tensor:
    w = torch.randn((vocab, d), generator=gen, device=device, dtype=dtype)
    return w.mul_(0.02)


# ---------------------------------------------------------------------------
# norms (f32 math, cast back)
# ---------------------------------------------------------------------------

def rms_norm(x: Tensor, weight: Optional[Tensor], eps: float = 1e-6) -> Tensor:
    """RMSNorm; ``weight=None`` is OLMo's parameter-free variant. On a
    mesh that shards the last dimension (the SSM's gated output) the mean
    square is completed once (``pspec.mean_last``), and so is the
    gradient of its inverse root, a sum over that dimension
    (``pspec.grad_reduced``)."""
    x32 = x.float()
    var = mean_last(x32 * x32)
    y = x32 * grad_reduced(torch.rsqrt(var + eps))
    if weight is not None:
        y = y * weight.float()
    return y.to(x.dtype)


def layer_norm(x: Tensor, weight: Optional[Tensor], bias: Optional[Tensor],
               eps: float = 1e-5) -> Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# casts into a cache of another dtype
# ---------------------------------------------------------------------------

FP8_DTYPES = (torch.float8_e4m3fn, torch.float8_e5m2)
# e4m3fn's largest finite value is 448; XLA rounds to it up to the tie
# with the next step (480), 464, and gives NaN past that.
_E4M3_EDGE = 464.0


def astype(x: Tensor, dtype: torch.dtype) -> Tensor:
    """``x`` in ``dtype`` with the bits of the JAX package's
    ``x.astype(dtype)`` for f32 and bf16 sources. For fp8 targets torch's
    ``.to()`` differs from XLA's convert in two places, mended here: an
    e4m3fn target gives NaN (the sign kept) where |x| > 464 or x is
    infinite, where torch saturates to ±448; an e5m2 target encodes NaN
    as XLA does, 0x7E with the sign from f32 and 0x7F from bf16, where
    torch gives 0x7F with the sign. Every other value has the same bits
    either way (round to nearest even, subnormals kept)."""
    if x.dtype == dtype:
        return x
    y = x.to(dtype)
    if dtype not in FP8_DTYPES:
        return y
    sign = torch.signbit(x).to(torch.uint8) << 7
    if dtype == torch.float8_e4m3fn:
        fix, nan = ~(x.abs() <= _E4M3_EDGE), sign | 0x7F
    else:
        fix = torch.isnan(x)
        nan = sign | 0x7E if x.dtype == torch.float32 else 0x7F
    return torch.where(fix, nan, y.view(torch.uint8)).view(dtype)


def init_norm(cfg_norm: str, d: int, *, device, dtype=torch.float32,
              lead: tuple = ()):
    if cfg_norm == "nonparametric":
        return {}
    return {"w": torch.ones(tuple(lead) + (d,), device=device, dtype=dtype)}


def apply_norm(cfg_norm: str, p, x: Tensor) -> Tensor:
    if cfg_norm == "nonparametric":
        return rms_norm(x, None)
    return rms_norm(x, p["w"])


# ---------------------------------------------------------------------------
# RoPE (f32 math, cast back)
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None) -> Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)     # (hd/2,)
    angles = positions[..., :, None].float() * freqs           # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                      # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, kind: str, d: int, f: int, *, device,
             dtype=torch.float32, lead: tuple = ()):
    kw = dict(device=device, dtype=dtype, lead=lead)
    if kind == "swiglu":
        return {"w_gate": dense_init(gen, d, f, **kw),
                "w_up": dense_init(gen, d, f, **kw),
                "w_down": dense_init(gen, f, d, **kw)}
    return {"w_in": dense_init(gen, d, f, **kw),
            "w_out": dense_init(gen, f, d, **kw)}


def apply_mlp(kind: str, p, x: Tensor) -> Tensor:
    dt = x.dtype
    if kind == "swiglu":
        g = x @ p["w_gate"].to(dt)
        u = x @ p["w_up"].to(dt)
        return (F.silu(g) * u) @ p["w_down"].to(dt)
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(x @ p["w_in"].to(dt), approximate="tanh")
    return h @ p["w_out"].to(dt)

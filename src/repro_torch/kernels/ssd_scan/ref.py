"""Plain PyTorch versions of the SSD scan kernels.

``ssd_scan_ref`` is the chunked scan in f32 (``models/ssm.py::ssd_chunked``)
on the model's layout, with the time axis zero-padded to a chunk
multiple, which is exact: padded steps carry dt = x = 0, so they neither
decay nor feed the state. The D skip is added in f32 before the cast to
x's dtype, as in the kernels' epilogue. The CUDA wrapper runs it on CPU
tensors.

``ssd_scan_chunk_parallel_ref`` is the same scan in the three phases of
the kernels' ``chunked`` route: every chunk's own state, the serial pass
over the chunk states, then every chunk's outputs. With
``tensor_core_rounding`` it also rounds where the tensor-core kernel
rounds: M = C B^T o decay o dt to bf16 once, and each f32 operand that
meets a bf16 one (w o x in the states, h_c in C h_c) split into a bf16
high part and a bf16 low part.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.ssm import ssd_chunked


def _pad(x, dt, B_in, C_in, chunk: int):
    pad = (-x.shape[1]) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt, B_in, C_in = (F.pad(t, (0, 0, 0, pad)) for t in (dt, B_in, C_in))
    return x, dt, B_in, C_in


def ssd_scan_ref(x, dt, A, B_in, C_in, D_skip, chunk: int = 128):
    """x (B,L,H,P), dt (B,L,H), A (H,), B_in/C_in (B,L,N), D_skip (H,) ->
    (y (B,L,H,P) in x's dtype, h_final (B,H,N,P) f32)."""
    xp, dtp, Bp, Cp = _pad(x, dt, B_in, C_in, chunk)
    y, h = ssd_chunked(xp, dtp, A, Bp, Cp, D_skip, chunk)
    return y[:, :x.shape[1]], h


def _split_bf16(t):
    """An f32 tensor as the sum of its bf16 rounding and the bf16 rounding
    of the rest, back in f32."""
    hi = t.to(torch.bfloat16).float()
    return hi + (t - hi).to(torch.bfloat16).float()


def ssd_scan_chunk_parallel_ref(x, dt, A, B_in, C_in, D_skip,
                                chunk: int = 128, *,
                                tensor_core_rounding: bool = False):
    """The scan in the ``chunked`` route's three phases, in f32. Same
    signature and result as ``ssd_scan_ref``."""
    Bb, L, H, P = x.shape
    N = B_in.shape[-1]
    f32 = torch.float32
    xp, dtp, Bp, Cp = _pad(x, dt, B_in, C_in, chunk)
    nc = xp.shape[1] // chunk
    xc = xp.to(f32).reshape(Bb, nc, chunk, H, P)
    dtc = dtp.to(f32).reshape(Bb, nc, chunk, H)
    Bc = Bp.to(f32).reshape(Bb, nc, chunk, N)
    Cc = Cp.to(f32).reshape(Bb, nc, chunk, N)
    split = _split_bf16 if tensor_core_rounding else (lambda t: t)
    cum = torch.cumsum(dtc * A.to(f32), dim=2)             # (B,nc,Q,H)

    # Phase 1: each chunk's own state, from h = 0.
    w = torch.exp(cum[:, :, -1:] - cum) * dtc              # (B,nc,Q,H)
    wx = split(w[..., None] * xc)                          # (B,nc,Q,H,P)
    S = torch.einsum("bcjn,bcjhp->bchnp", Bc, wx)
    # Phase 2: the serial pass; hs[:, c] is the state entering chunk c.
    h = torch.zeros((Bb, H, N, P), dtype=f32, device=x.device)
    hs = []
    for c in range(nc):
        hs.append(h)
        h = torch.exp(cum[:, c, -1])[..., None, None] * h + S[:, c]
    hs = torch.stack(hs, dim=1)                            # (B,nc,H,N,P)
    # Phase 3: each chunk's outputs.
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))[:, :, None]
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (B,nc,Q,Q,H)
    decay = torch.where(tri, torch.exp(torch.where(tri, seg, 0.0)), 0.0)
    CB = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    M = CB[..., None] * decay * dtc[:, :, None, :, :]
    if tensor_core_rounding:
        M = M.to(torch.bfloat16).float()
    y = torch.einsum("bcijh,bcjhp->bcihp", M, xc)
    y = y + (torch.einsum("bcin,bchnp->bcihp", Cc, split(hs))
             * torch.exp(cum)[..., None])
    y = y + xc * D_skip.to(f32)[:, None]
    return y.reshape(Bb, nc * chunk, H, P)[:, :L].to(x.dtype), h

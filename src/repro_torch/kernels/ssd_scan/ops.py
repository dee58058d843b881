"""Wrapper of the SSD scan kernels with the model-facing layout (the JAX
op's signature, ``h0 = 0``).

On CPU tensors it runs the plain version (``ref.py``); on CUDA tensors it
checks the operands, plans the launch (``kernel.ssd_plan``) and launches
the CUDA kernels, or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import checks
from repro_torch.kernels.decode_attention.kernel import sm_count
from repro_torch.kernels.ssd_scan.kernel import (
    ROUTES, ssd_plan, ssd_scan_bhp, tensor_core_aligned, workspace,
)
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

# Op calls that launched the kernels since import (or since a caller reset
# it to 0), and the same calls by route (``kernel.ROUTES``).
LAUNCHES = [0]
ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)


def ssd_scan(x, dt, A, B_in, C_in, D_skip, *, chunk: int = 128):
    """x (B,L,H,P), dt (B,L,H), A (H,), B_in/C_in (B,L,N), D_skip (H,) ->
    (y (B,L,H,P) in x's dtype, h_final (B,H,N,P) f32). As in the JAX op,
    a sequence shorter than ``chunk`` is one chunk of its own length."""
    chunk = min(chunk, x.shape[1])
    if checks.on_cpu(x, dt, A, B_in, C_in, D_skip):
        return ssd_scan_ref(x, dt, A, B_in, C_in, D_skip, chunk=chunk)
    return _launch(x, dt, A, B_in, C_in, D_skip, chunk)


def _launch(x, dt, A, B_in, C_in, D_skip, chunk):
    """The CUDA path: check the operands, plan, allocate the outputs and
    the workspace, launch on the current stream and count the call and
    its route. The kernels mask the rows of a ragged last chunk
    themselves, so nothing is padded, and read x / B_in / C_in through
    their strides, so views are not copied."""
    Bb, L, H, P = x.shape
    N = B_in.shape[-1]
    checks.ssd_operands("ssd_scan", chunk, x=x, dt=dt, A=A, B_in=B_in,
                        C_in=C_in, D_skip=D_skip)
    plan = ssd_plan(Bb, L, H, P, N, chunk, x.dtype,
                    tensor_core_aligned(x, B_in, C_in),
                    n_sm=sm_count(x.device.index or 0))
    y = torch.empty((Bb, L, H, P), dtype=x.dtype, device=x.device)
    h = torch.empty((Bb, H, N, P), dtype=torch.float32, device=x.device)
    ssd_scan_bhp(x, dt, A, B_in, C_in, D_skip, y, h,
                 *workspace(plan, Bb, H, N, P, x.device), plan=plan)
    LAUNCHES[0] += 1
    ROUTE_LAUNCHES[plan["route"]] += 1
    return y, h

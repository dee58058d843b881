"""Wrapper of the SSD scan kernel with the model-facing layout (the JAX
op's signature, ``h0 = 0``).

On CPU tensors it runs the plain version (``ref.py``); on CUDA tensors it
checks the operands and launches the CUDA kernel, or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import checks
from repro_torch.kernels.ssd_scan.kernel import ssd_scan_bhp
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

# Kernel launches since import (or since a caller reset it to 0).
LAUNCHES = [0]


def ssd_scan(x, dt, A, B_in, C_in, D_skip, *, chunk: int = 128):
    """x (B,L,H,P), dt (B,L,H), A (H,), B_in/C_in (B,L,N), D_skip (H,) ->
    (y (B,L,H,P) in x's dtype, h_final (B,H,N,P) f32). As in the JAX op,
    a sequence shorter than ``chunk`` is one chunk of its own length."""
    chunk = min(chunk, x.shape[1])
    if checks.on_cpu(x, dt, A, B_in, C_in, D_skip):
        return ssd_scan_ref(x, dt, A, B_in, C_in, D_skip, chunk=chunk)
    return _launch(x, dt, A, B_in, C_in, D_skip, chunk)


def _launch(x, dt, A, B_in, C_in, D_skip, chunk):
    """The CUDA path: check the operands, allocate the outputs, launch the
    kernel on the current stream and count the launch. The kernel masks
    the rows of a ragged last chunk itself, so nothing is padded, and
    reads x / B_in / C_in through their strides, so views are not
    copied."""
    Bb, L, H, P = x.shape
    N = B_in.shape[-1]
    checks.ssd_operands("ssd_scan", chunk, x=x, dt=dt, A=A, B_in=B_in,
                        C_in=C_in, D_skip=D_skip)
    y = torch.empty((Bb, L, H, P), dtype=x.dtype, device=x.device)
    h = torch.empty((Bb, H, N, P), dtype=torch.float32, device=x.device)
    ssd_scan_bhp(x, dt, A, B_in, C_in, D_skip, y, h, chunk=chunk)
    LAUNCHES[0] += 1
    return y, h

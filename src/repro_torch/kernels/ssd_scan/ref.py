"""Plain PyTorch version of the SSD scan kernel: the chunked scan in f32
(``models/ssm.py::ssd_chunked``) on the model's layout, with the time axis
zero-padded to a chunk multiple, which is exact: padded steps carry
dt = x = 0, so they neither decay nor feed the state. The D skip is
added in f32 before the cast to x's dtype, as in the kernel's epilogue."""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.models.ssm import ssd_chunked


def ssd_scan_ref(x, dt, A, B_in, C_in, D_skip, chunk: int = 128):
    """x (B,L,H,P), dt (B,L,H), A (H,), B_in/C_in (B,L,N), D_skip (H,) ->
    (y (B,L,H,P) in x's dtype, h_final (B,H,N,P) f32)."""
    L = x.shape[1]
    pad = (-L) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt, B_in, C_in = (F.pad(t, (0, 0, 0, pad)) for t in (dt, B_in, C_in))
    y, h = ssd_chunked(x, dt, A, B_in, C_in, D_skip, chunk)
    return y[:, :L], h

"""Plain PyTorch version of the batched UCB scoring kernel (Eq. 2)."""
from __future__ import annotations

import torch


def linucb_score_ref(x, theta, ainv, pen, infl, alpha):
    """x (S,R,d), theta (S,K,d), ainv (S,K,d,d), pen/infl (S,K),
    alpha (S,) -> (S,R,K)."""
    exploit = torch.einsum("srd,skd->srk", x, theta)
    t = torch.einsum("srd,skde->srke", x, ainv)
    quad = torch.clamp_min(torch.einsum("srke,sre->srk", t, x), 0.0)
    v = quad / infl[:, None, :]
    return exploit + alpha[:, None, None] * torch.sqrt(v) - pen[:, None, :]

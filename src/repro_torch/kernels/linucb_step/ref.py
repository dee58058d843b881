"""Plain PyTorch version of the fused step kernel.

Mirrors ``csrc/linucb_step.cu`` (and the JAX package's
``kernels/linucb_step``) step for step: score, noise + hard-ceiling
mask, argmax, forced override, (reward, cost) gather, then the
``num_valid`` requests in order — decay of the chosen arm, A += x x^T,
Sherman-Morrison, b and ``last_upd``, the pacer fold — and the
block-final theta refresh for every arm. Leading axis S: one state per
entry.
"""
from __future__ import annotations

import torch

# Mirrors of the JAX kernel's constants (kernels/linucb_step/kernel.py).
GAMMA_FLOOR = 1e-6
NEG_INF = -1e30


def linucb_step_ref(
    A, A_inv, b, theta,    # (S,K,d,d), (S,K,d,d), (S,K,d), (S,K,d)
    last_upd,              # (S,K) i32
    X,                     # (S,B,d) contexts
    rewards, costs,        # (S,B,K) environment matrices
    noise,                 # (S,B,K) pre-drawn tiebreak noise
    cand,                  # (S,K) bool hard-ceiling candidate mask
    pen, infl,             # (S,K) penalty / staleness-inflation vectors
    alpha, gamma, eta, alpha_ema, lambda_bar,  # (S,) hyper leaves
    lam, c_ema, budget,    # (S,) pacer leaves
    t_sel,                 # (S,) i32 post-select clock (t + B)
    force_arm,             # (S,) i32 forced-exploration target (>= 0)
    forced,                # (S,B) bool forced-override mask
    *, num_valid: int, dt_max: int,
):
    """Returns (A', A_inv', b', theta', last_upd', arms (S,B) i32,
    r (S,B), c (S,B), lam' (S,), c_ema' (S,)). Only the first
    ``num_valid`` requests are fed back."""
    S = b.shape[0]
    exploit = torch.einsum("sbd,skd->sbk", X, theta)
    t = torch.einsum("sbd,skde->sbke", X, A_inv)
    quad = torch.clamp_min((t * X[:, :, None, :]).sum(-1), 0.0)
    v = quad / infl[:, None, :]
    scores = exploit + alpha[:, None, None] * torch.sqrt(v) - pen[:, None, :]

    masked = torch.where(cand[:, None, :], scores + noise, NEG_INF)
    arms = masked.argmax(-1).to(torch.int32)
    arms = torch.where(forced, force_arm[:, None].to(torch.int32), arms)
    pick = arms.long()[..., None]
    r_all = rewards.gather(2, pick)[..., 0]
    c_all = costs.gather(2, pick)[..., 0]

    gamma = torch.clamp(gamma, GAMMA_FLOOR, 1.0)
    A, A_inv, b, lu = A.clone(), A_inv.clone(), b.clone(), last_upd.clone()
    rows = torch.arange(S, device=A.device)
    for i in range(num_valid):
        arm = arms[:, i].long()
        xi = X[:, i]
        dtf = torch.clamp(t_sel - lu[rows, arm], 0, dt_max).to(torch.float32)
        g = torch.pow(gamma, dtf)
        A_a = A[rows, arm] * g[:, None, None] + xi[:, :, None] * xi[:, None, :]
        Ainv_a = A_inv[rows, arm] / g[:, None, None]
        Ax = (Ainv_a @ xi[..., None])[..., 0]
        denom = 1.0 + (xi * Ax).sum(-1)
        Ainv_a = Ainv_a - (Ax[:, :, None] * Ax[:, None, :]) / denom[:, None, None]
        b_a = b[rows, arm] * g[:, None] + r_all[:, i, None] * xi
        A[rows, arm] = A_a
        A_inv[rows, arm] = Ainv_a
        b[rows, arm] = b_a
        lu[rows, arm] = t_sel.to(lu.dtype)
        c_ema = (1.0 - alpha_ema) * c_ema + alpha_ema * c_all[:, i]  # Eq. 3
        lam = torch.minimum(                                         # Eq. 4
            torch.clamp_min(lam + eta * (c_ema / budget - 1.0), 0.0),
            lambda_bar)
    theta_out = (A_inv @ b[..., None])[..., 0]
    return A, A_inv, b, theta_out, lu, arms, r_all, c_all, lam, c_ema

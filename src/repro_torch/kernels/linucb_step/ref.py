"""Plain PyTorch versions of the fused step kernel.

``linucb_step_ref`` mirrors the JAX package's ``kernels/linucb_step``
step for step: score, noise + hard-ceiling mask, argmax, forced
override, (reward, cost) gather, then the ``num_valid`` requests in
order — decay of the chosen arm, A += x x^T, Sherman-Morrison, b and
``last_upd``, the pacer fold — and the block-final theta refresh for
every arm. ``linucb_step_per_arm_ref`` does the same in the order of
``csrc/linucb_step.cu``: arm by arm, the pacer apart. Leading axis S: one
state per entry.
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
    arms, r_all, c_all = _select(A_inv, theta, X, rewards, costs, noise,
                                 cand, pen, infl, alpha, force_arm, forced)
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


def _select(A_inv, theta, X, rewards, costs, noise, cand, pen, infl, alpha,
            force_arm, forced):
    """Score, noise + hard-ceiling mask, argmax, forced override and the
    (reward, cost) gather: (arms (S,B) i32, r (S,B), c (S,B))."""
    exploit = torch.einsum("sbd,skd->sbk", X, theta)
    t = torch.einsum("sbd,skde->sbke", X, A_inv)
    quad = torch.clamp_min((t * X[:, :, None, :]).sum(-1), 0.0)
    v = quad / infl[:, None, :]
    scores = exploit + alpha[:, None, None] * torch.sqrt(v) - pen[:, None, :]

    masked = torch.where(cand[:, None, :], scores + noise, NEG_INF)
    arms = masked.argmax(-1).to(torch.int32)
    arms = torch.where(forced, force_arm[:, None].to(torch.int32), arms)
    pick = arms.long()[..., None]
    return arms, rewards.gather(2, pick)[..., 0], costs.gather(2, pick)[..., 0]


def linucb_step_per_arm_ref(
    A, A_inv, b, theta, last_upd, X, rewards, costs, noise, cand, pen, infl,
    alpha, gamma, eta, alpha_ema, lambda_bar, lam, c_ema, budget, t_sel,
    force_arm, forced, *, num_valid: int, dt_max: int,
):
    """The CUDA kernel's order in plain PyTorch: the same select, then the
    arms one at a time, each applying the requests that chose it in block
    order (the arms' update chains are independent: request i reads and
    writes arm arms[i]'s statistics alone), and the pacer folded apart.
    Operands and results as ``linucb_step_ref``, whose serial loop it
    equals bit for bit."""
    arms, r_all, c_all = _select(A_inv, theta, X, rewards, costs, noise,
                                 cand, pen, infl, alpha, force_arm, forced)
    gamma = torch.clamp(gamma, GAMMA_FLOOR, 1.0)
    A, A_inv, b, lu = A.clone(), A_inv.clone(), b.clone(), last_upd.clone()
    for a in range(b.shape[1]):
        for i in range(num_valid):
            mine = arms[:, i] == a                       # (S,) states
            if not bool(mine.any()):
                continue
            xi = X[:, i]
            dtf = torch.clamp(t_sel - lu[:, a], 0, dt_max).to(torch.float32)
            g = torch.pow(gamma, dtf)
            A_a = A[:, a] * g[:, None, None] + xi[:, :, None] * xi[:, None, :]
            Ainv_a = A_inv[:, a] / g[:, None, None]
            Ax = (Ainv_a @ xi[..., None])[..., 0]
            denom = 1.0 + (xi * Ax).sum(-1)
            Ainv_a = Ainv_a - (Ax[:, :, None] * Ax[:, None, :]) / denom[:, None, None]
            b_a = b[:, a] * g[:, None] + r_all[:, i, None] * xi
            A[:, a] = torch.where(mine[:, None, None], A_a, A[:, a])
            A_inv[:, a] = torch.where(mine[:, None, None], Ainv_a, A_inv[:, a])
            b[:, a] = torch.where(mine[:, None], b_a, b[:, a])
            lu[:, a] = torch.where(mine, t_sel.to(lu.dtype), lu[:, a])
    for i in range(num_valid):
        c_ema = (1.0 - alpha_ema) * c_ema + alpha_ema * c_all[:, i]  # Eq. 3
        lam = torch.minimum(                                         # Eq. 4
            torch.clamp_min(lam + eta * (c_ema / budget - 1.0), 0.0),
            lambda_bar)
    theta_out = (A_inv @ b[..., None])[..., 0]
    return A, A_inv, b, theta_out, lu, arms, r_all, c_all, lam, c_ema

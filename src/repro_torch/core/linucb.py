"""LinUCB sufficient-statistic operations (§3.2-§3.3) over a state stack.

The O(d^2) primitives of the paper: geometric forgetting as a scalar
multiply on (A, b) and a scalar divide on the cached inverse,
Sherman-Morrison rank-1 updates, and the staleness-inflated UCB variance.
Every tensor carries the leading state axis S; ``hp`` leaves are (S,).
"""
from __future__ import annotations

import torch

from repro_torch.core.types import HyperParams, RouterConfig, lead

Tensor = torch.Tensor

# Runtime floor for the forgetting factor: gamma is validated to (0, 1]
# at construction, but a stacked leaf can carry any value, so the kernel
# clamps (identity for every valid gamma).
GAMMA_FLOOR = 1e-6


def forgetting_factor(cfg: RouterConfig, hp: HyperParams, dt: Tensor) -> Tensor:
    """gamma^dt with dt clamped to [0, cfg.dt_max] (DESIGN.md §4).

    ``dt`` is (S,) or (S, K); the result has its shape.
    """
    dt = torch.clamp(dt, 0, cfg.dt_max).to(torch.float32)
    g = torch.clamp(hp.gamma, GAMMA_FLOOR, 1.0)
    return torch.pow(lead(g, dt.ndim), dt)


def decay_statistics(cfg: RouterConfig, hp: HyperParams, A: Tensor,
                     A_inv: Tensor, b: Tensor, dt: Tensor):
    """Algorithm 1 lines 18-20 for one arm per state: A (S, d, d),
    b (S, d), dt (S,). A_inv scales by 1/gamma^dt."""
    g = forgetting_factor(cfg, hp, dt)
    return A * g[:, None, None], A_inv / g[:, None, None], b * g[:, None]


def sherman_morrison(A_inv: Tensor, x: Tensor) -> Tensor:
    """Rank-1 inverse update (A + x x^T)^{-1} from A^{-1}: (S, d, d)."""
    Ax = (A_inv @ x[..., None])[..., 0]                   # (S, d)
    denom = 1.0 + (x * Ax).sum(-1)
    return A_inv - (Ax[:, :, None] * Ax[:, None, :]) / denom[:, None, None]


def rank1_update(cfg: RouterConfig, hp: HyperParams, A: Tensor,
                 A_inv: Tensor, b: Tensor, x: Tensor, r: Tensor, dt: Tensor):
    """Decay-then-update for each state's chosen arm (Algorithm 1 lines
    18-23). Returns (A, A_inv, b, theta)."""
    A, A_inv, b = decay_statistics(cfg, hp, A, A_inv, b, dt)
    A = A + x[:, :, None] * x[:, None, :]
    A_inv = sherman_morrison(A_inv, x)
    b = b + r[:, None] * x
    theta = (A_inv @ b[..., None])[..., 0]
    return A, A_inv, b, theta


def staleness_inflation(cfg: RouterConfig, hp: HyperParams,
                        dt: Tensor) -> Tensor:
    """Eq. 9 denominator: max(gamma^dt, 1/V_max), dt (S, K) -> (S, K)."""
    return torch.maximum(forgetting_factor(cfg, hp, dt),
                         1.0 / lead(hp.v_max, dt.ndim))


def ucb_variance(cfg: RouterConfig, hp: HyperParams, A_inv: Tensor,
                 x: Tensor, dt: Tensor) -> Tensor:
    """Eq. 9, the staleness-inflated posterior variance of one arm per
    state: x^T A^-1 x (clamped at 0 against f32 round-off) over
    max(gamma^dt, 1/V_max). A_inv (S, d, d), x (S, d), dt (S,) -> (S,).

    The products are ``ucb_scores_batch``'s, on one context and one arm,
    so the value is its variance term bit for bit on those operands."""
    X = x[:, None]                                            # (S, 1, d)
    t = torch.einsum("sbd,skde->sbke", X, A_inv[:, None])
    quad = torch.clamp_min(torch.einsum("sbke,sbe->sbk", t, X), 0.0)
    return (quad / staleness_inflation(cfg, hp, dt[:, None])[:, None, :])[:, 0, 0]


def ucb_scores_batch(
    cfg: RouterConfig,
    hp: HyperParams,
    theta: Tensor,    # (S, K, d)
    A_inv: Tensor,    # (S, K, d, d)
    c_tilde: Tensor,  # (S, K)
    X: Tensor,        # (S, B, d) block of request contexts per state
    dt: Tensor,       # (S, K) staleness per arm, shared by the block
    lam: Tensor,      # (S,) dual variable, or (S, B) per-request duals
) -> Tensor:
    """Eq. 2 scores for a block of B contexts against all arms: (S, B, K).

    The plain torch oracle of the data plane; the ``linucb_score`` CUDA
    kernel computes the same quantity on the card.

    ``lam`` may be (S, B) per-request duals (the tenant plane gathers each
    request's tenant lambda, §15). Only the cost penalty depends on
    lambda and it is elementwise, so row b of the per-request path is
    bit-identical to scoring the whole block under ``lam[:, b]``.
    """
    exploit = torch.einsum("sbd,skd->sbk", X, theta)
    t = torch.einsum("sbd,skde->sbke", X, A_inv)
    quad = torch.clamp_min(torch.einsum("sbke,sbe->sbk", t, X), 0.0)
    v = quad / staleness_inflation(cfg, hp, dt)[:, None, :]
    explore = hp.alpha[:, None, None] * torch.sqrt(v)
    if lam.ndim == 2:
        penalty = ((hp.lambda_c[:, None] + lam)[:, :, None]
                   * c_tilde[:, None, :])                         # (S, B, K)
        return exploit + explore - penalty
    penalty = (hp.lambda_c + lam)[:, None] * c_tilde              # (S, K)
    return exploit + explore - penalty[:, None, :]


def ucb_scores(cfg: RouterConfig, hp: HyperParams, theta: Tensor,
               A_inv: Tensor, c_tilde: Tensor, x: Tensor, dt: Tensor,
               lam: Tensor) -> Tensor:
    """Eq. 2 scores of one context per state, x (S, d): (S, K)."""
    return ucb_scores_batch(cfg, hp, theta, A_inv, c_tilde, x[:, None],
                            dt, lam)[:, 0]

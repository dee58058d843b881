"""Budget pacer: smoothed primal-dual rate control (§3.2, Eqs. 3-4).

Two-layer enforcement:
  * soft penalty   — lambda_t enters the UCB score (router.py, Eq. 2);
  * hard ceiling   — when lambda_t > 0, arms priced above
                     c_max / (1 + lambda_t) are excluded (circuit breaker).

Every ``PacerState`` leaf is (S,): one pacer per state of the stack.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.types import HyperParams, PacerState

Tensor = torch.Tensor

# Floor for the Eq. 4 gradient's 1/B. Budgets are validated > 0 at every
# host boundary; the floor keeps the dual finite if a zero still arrives.
BUDGET_EPS = 1e-12


def validate_budget(budget, *, what: str = "budget") -> None:
    """Host-boundary positivity check on a number or a host array (every
    entry > 0). A tensor passes unchecked and without a device sync, as a
    traced budget does in the JAX package: the ``BUDGET_EPS`` floor in
    ``pacer_update`` covers it."""
    if isinstance(budget, Tensor):
        return
    b = np.asarray(budget, np.float64)
    if not np.all(b > 0.0):
        raise ValueError(f"{what}={budget!r}: must be > 0 ($/request ceiling)")


def pacer_update(hp: HyperParams, p: PacerState, cost: Tensor) -> PacerState:
    """Algorithm 1 lines 25-26 for every state, cost (S,).

    c_ema <- (1 - a_ema) c_ema + a_ema * c_t                       (Eq. 3)
    lam   <- clip(lam + eta * (c_ema / B - 1), 0, lambda_bar)      (Eq. 4)

    A disabled pacer (ablations) keeps lambda and c_ema frozen.
    """
    c_ema = (1.0 - hp.alpha_ema) * p.c_ema + hp.alpha_ema * cost
    denom = torch.clamp_min(p.budget, BUDGET_EPS)
    lam = torch.minimum(
        torch.clamp_min(p.lam + hp.eta * (c_ema / denom - 1.0), 0.0),
        hp.lambda_bar)
    lam = torch.where(p.enabled, lam, p.lam)
    c_ema = torch.where(p.enabled, c_ema, p.c_ema)
    return PacerState(lam=lam, c_ema=c_ema, budget=p.budget,
                      enabled=p.enabled)


def pacer_update_batch(hp: HyperParams, p: PacerState,
                       costs: Tensor) -> PacerState:
    """Fold Eqs. 3-4 over a block of costs (S, B) in arrival order.

    A sequential fold, exactly ``pacer_update`` B times: the per-step clip
    on lambda makes the recursion non-associative (DESIGN.md §2), so no
    closed-form EMA may replace it.
    """
    for i in range(costs.shape[1]):
        p = pacer_update(hp, p, costs[:, i])
    return p


def hard_ceiling_mask(p: PacerState, price: Tensor, active: Tensor) -> Tensor:
    """Algorithm 1 lines 4-8: candidate sets (S, K) under the price ceiling.

    A_t = {a : c_a <= c_max^A / (1 + lambda_t)}  when lambda_t > 0, else A,
    with c_max^A the most expensive *active* rate. If the mask empties,
    it falls back to the cheapest active arm; with zero active arms it
    stays all-False (callers check ``registry.num_active`` first).
    """
    neg = torch.full_like(price, -float("inf"))
    c_max = torch.where(active, price, neg).amax(-1)               # (S,)
    ceiling = c_max / (1.0 + p.lam)
    mask = torch.where((p.lam > 0.0)[:, None], price <= ceiling[:, None],
                       True) & active
    mask = torch.where(p.enabled[:, None], mask, active)
    cheapest = torch.where(active, price, -neg).argmin(-1)         # (S,)
    fallback = torch.zeros_like(mask)
    fallback[torch.arange(mask.shape[0], device=mask.device), cheapest] = True
    empty = ~mask.any(-1)
    return torch.where(empty[:, None], fallback & active, mask)


def set_budget(p: PacerState, budget) -> PacerState:
    """Operator retargets the ceiling at runtime: one budget or one per
    state, as numbers (validated here, before they become a tensor) or as
    a tensor (a scenario payload, unchecked)."""
    validate_budget(budget)
    if not isinstance(budget, Tensor):
        budget = torch.from_numpy(np.asarray(budget, np.float32))
    b = budget.to(device=p.budget.device, dtype=torch.float32)
    return PacerState(lam=p.lam, c_ema=p.c_ema,
                      budget=b.expand(p.budget.shape).contiguous(),
                      enabled=p.enabled)

"""Offline-to-online warm-start priors (§3.4, Eqs. 10-12).

Offline sufficient statistics (A_off, b_off) fitted on historical
prompt-reward data are scaled to a target pseudo-observation count n_eff
and regularised with a mean-preserving correction so that
A^{-1} b ~= theta_off at the desired confidence level.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from repro_torch.core.types import (
    ArmPrior, HyperParams, RouterConfig, RouterState, lead,
)

Tensor = torch.Tensor


def fit_offline_prior(xs: Tensor, rs: Tensor, lambda0: float = 1.0) -> ArmPrior:
    """Ridge sufficient statistics from offline (context, reward) pairs for
    one arm: A_off = lambda0*I + X^T X, b_off = X^T r."""
    d = xs.shape[-1]
    eye = torch.eye(d, dtype=torch.float32, device=xs.device)
    return ArmPrior(A_off=(lambda0 * eye + xs.T @ xs).to(torch.float32),
                    b_off=(xs.T @ rs).to(torch.float32))


def scale_prior(cfg: RouterConfig, hp: HyperParams, prior: ArmPrior,
                n_eff):
    """Eqs. 10-12 for every state of a stack (``hp`` leaves (S,),
    ``n_eff`` a number or (S,)):

      s   = n_eff / A_off[d-1, d-1]          (bias-direction precision mass)
      A   = s * A_off + lambda0 * I
      b   = s * b_off + lambda0 * theta_off   (mean-preserving correction)

    The prior is one (d, d) / (d,) pair shared by every state, or one per
    state, (S, d, d) / (S, d). Returns A (S, d, d), b (S, d).
    """
    d = cfg.d
    if tuple(prior.A_off.shape[-2:]) != (d, d):
        raise ValueError(f"prior A_off shape {tuple(prior.A_off.shape)}")
    lam0 = hp.lambda0
    n_eff = torch.as_tensor(n_eff, dtype=torch.float32,
                            device=lam0.device).expand(lam0.shape)
    mass = prior.A_off[..., d - 1, d - 1]
    s = n_eff / torch.clamp_min(mass, 1e-12)
    theta_off = prior.theta_off
    eye = torch.eye(d, dtype=torch.float32, device=lam0.device)
    A = lead(s, 3) * prior.A_off + lead(lam0, 3) * eye
    b = lead(s, 2) * prior.b_off + lead(lam0, 2) * theta_off
    return A, b


def apply_warmup(
    cfg: RouterConfig,
    state: RouterState,
    priors: Sequence[ArmPrior | None],
    n_eff,
) -> RouterState:
    """Load scaled offline priors into every arm slot that has one, in
    every state of the stack."""
    A, A_inv = state.A.clone(), state.A_inv.clone()
    b, theta = state.b.clone(), state.theta.clone()
    for k, prior in enumerate(priors):
        if prior is None:
            continue
        A_k, b_k = scale_prior(cfg, state.hyper, prior, n_eff)
        Ainv_k = torch.linalg.inv(A_k)
        A[:, k], A_inv[:, k], b[:, k] = A_k, Ainv_k, b_k
        theta[:, k] = (Ainv_k @ b_k[..., None])[..., 0]
    return dataclasses.replace(state, A=A, A_inv=A_inv, b=b, theta=theta)


def t_adapt_to_n_eff(t_adapt: float, gamma: float) -> float:
    """Appendix A, Eq. 13 inverted: n_eff = (gamma^{-T} - 1) / (1 - gamma),
    -> T as gamma -> 1 (L'Hopital)."""
    if gamma >= 1.0:
        return float(t_adapt)
    return float((gamma ** (-t_adapt) - 1.0) / (1.0 - gamma))


def n_eff_to_t_adapt(n_eff: float, gamma: float) -> float:
    """Appendix A, Eq. 13: T_adapt = -log(n_eff (1-gamma) + 1) / log(gamma)."""
    if gamma >= 1.0:
        return float(n_eff)
    return -math.log(n_eff * (1.0 - gamma) + 1.0) / math.log(gamma)

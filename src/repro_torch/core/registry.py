"""Hot-swap model registry (§3.6) over a stack of states.

Arms live in fixed-capacity slots of ``RouterState``; adding/removing a
model flips the ``active`` mask and (re)initialises that slot's
statistics in every state of the stack, so no shape ever changes.

``add_arm`` supports three initialisations:
  * uninformative    — A = lambda0*I, b = 0 (cold start);
  * heuristic prior  — n_eff pseudo-observations at isotropic uncertainty
                       with a bias-only reward prediction (§3.4);
  * offline prior    — scaled offline sufficient statistics (warmup.py).

A newly added arm can be given a forced-exploration burn-in
(cfg.forced_pulls unconditional routes, §4.5), after which UCB takes over.
All functions return new states and leave their input untouched.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import warmup as warmup_lib
from repro_torch.core.types import (
    ArmPrior, RouterConfig, RouterState, lead, log_normalized_cost,
)

Tensor = torch.Tensor


def _put(leaf: Tensor, slot: int, value) -> Tensor:
    """``leaf`` with slot ``slot`` of every state set to ``value``: one
    value for every state, or a leading (S,) axis of them."""
    out = leaf.clone()
    out[:, slot] = value
    return out


def _per_state(v, S: int, device) -> Tensor:
    """A payload as an (S,) f32 tensor: a number rounds to f32 once, as
    ``_put`` rounds it; a tensor (one value or (S,)) is taken as it is."""
    if isinstance(v, Tensor):
        return v.to(device=device, dtype=torch.float32).expand(S)
    return torch.full((S,), float(v), dtype=torch.float32, device=device)


def heuristic_prior(cfg: RouterConfig, hp, n_eff: float, bias_reward: float):
    """§3.4: for models absent from offline data — n_eff pseudo-observations
    at isotropic uncertainty with a bias-only reward prediction. Assumes the
    bias coordinate is the last feature (features.py appends it).
    ``n_eff`` and ``bias_reward`` are numbers or (S,) tensors.
    Returns A (S, d, d), b (S, d)."""
    d = cfg.d
    lam0 = hp.lambda0
    eye = torch.eye(d, dtype=torch.float32, device=lam0.device)
    A = eye * lead(lam0 + n_eff / d, 3)
    b = torch.zeros((lam0.shape[0], d), dtype=torch.float32,
                    device=lam0.device)
    b[:, d - 1] = bias_reward * n_eff / d
    return A, b


def add_arm(
    cfg: RouterConfig,
    state: RouterState,
    slot: int,
    price_per_req,
    price_per_1k,
    *,
    prior: Optional[ArmPrior] = None,
    n_eff=None,
    bias_reward=0.5,
    forced_exploration: bool = True,
) -> RouterState:
    """Register a model into ``slot`` of every state at runtime.

    ``price_per_req``, ``price_per_1k``, ``n_eff`` and ``bias_reward`` are
    numbers shared by every state or (S,) tensors (a scenario's payloads).
    A tensor ``n_eff`` cannot be branched on without a device sync, so it
    always takes the prior or heuristic branch, as a traced one does in
    the JAX package (the heuristic prior at n_eff = 0 is the cold start).
    """
    d = cfg.d
    hp = state.hyper
    S = state.num_states
    dev = state.A.device
    tensor_ne = isinstance(n_eff, Tensor)
    if prior is not None:
        A, b = warmup_lib.scale_prior(cfg, hp, prior,
                                      n_eff if tensor_ne else (n_eff or 1.0))
    elif n_eff is not None and (tensor_ne or n_eff > 0):
        A, b = heuristic_prior(cfg, hp, n_eff, bias_reward)
    else:
        eye = torch.eye(d, dtype=torch.float32, device=dev)
        A = eye * lead(hp.lambda0, 3)
        b = torch.zeros((S, d), dtype=torch.float32, device=dev)
    A_inv, theta = warmup_lib.ridge_solve(A, b)
    p1k = _per_state(price_per_1k, S, dev)[:, None]
    c_t = log_normalized_cost(p1k, hp)[:, 0]
    state = dataclasses.replace(
        state,
        A=_put(state.A, slot, A),
        A_inv=_put(state.A_inv, slot, A_inv),
        b=_put(state.b, slot, b),
        theta=_put(state.theta, slot, theta),
        last_upd=_put(state.last_upd, slot, state.t),
        last_play=_put(state.last_play, slot, state.t),
        active=_put(state.active, slot, True),
        price=_put(state.price, slot, _per_state(price_per_req, S, dev)),
        c_tilde=_put(state.c_tilde, slot, c_t),
    )
    if forced_exploration:
        state = dataclasses.replace(
            state,
            force_arm=torch.full_like(state.force_arm, slot),
            force_left=torch.full_like(state.force_left, cfg.forced_pulls),
        )
    return state


def delete_arm(cfg: RouterConfig, state: RouterState, slot: int) -> RouterState:
    """Retire a model. Its statistics are reset so a future ``add_arm``
    into the same slot starts clean; any in-flight forced exploration of
    the slot is cancelled."""
    d = cfg.d
    eye = torch.eye(d, dtype=torch.float32, device=state.A.device)
    lam0 = lead(state.hyper.lambda0, 3)
    cancel = state.force_arm == slot
    return dataclasses.replace(
        state,
        A=_put(state.A, slot, eye * lam0),
        A_inv=_put(state.A_inv, slot, eye / lam0),
        b=_put(state.b, slot, 0.0),
        theta=_put(state.theta, slot, 0.0),
        active=_put(state.active, slot, False),
        force_arm=torch.where(cancel, -1, state.force_arm),
        force_left=torch.where(cancel, 0, state.force_left),
    )


def set_price(cfg: RouterConfig, state: RouterState, slot: int,
              price_per_req, price_per_1k) -> RouterState:
    """Reprice an arm (provider price change). The pacer reacts to realised
    costs automatically; this keeps the hard ceiling and Eq. 6 in sync.
    Prices are numbers shared by every state or (S,) tensors."""
    S, dev = state.num_states, state.A.device
    p1k = _per_state(price_per_1k, S, dev)[:, None]
    c_t = log_normalized_cost(p1k, state.hyper)[:, 0]
    return dataclasses.replace(
        state,
        price=_put(state.price, slot, _per_state(price_per_req, S, dev)),
        c_tilde=_put(state.c_tilde, slot, c_t),
    )


def num_active(state: RouterState) -> Tensor:
    """(S,) i32 number of active arms per state."""
    return state.active.sum(-1, dtype=torch.int32)


def free_slot(state: RouterState) -> Optional[int]:
    """Lowest slot inactive in every state, or None at capacity. Host-side
    (one device sync): the control plane's slot scan."""
    free = (~state.active).all(0).nonzero()
    return int(free[0, 0]) if free.numel() else None

"""Carry states, priors, environments, model parameters, training states
and decode caches between the two packages.

The JAX package's objects reach this module as numpy leaves: a mapping of
field names to arrays, or any object with those attributes (such as a
JAX ``RouterState``, whose arrays ``np.asarray`` reads). Nothing here
imports JAX. The tests use these functions so that both packages start
from one state.

A JAX ``RouterState`` is either unstacked (one router: ``A`` is
(K, d, d)) or seed-stacked by ``vmap`` (``A`` is (S, K, d, d)); the
port's always carries the leading state axis, which ``state_from_numpy``
adds and ``state_to_numpy(stacked=False)`` removes.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from repro_torch.core import tenancy
from repro_torch.core.simulator import Environment
from repro_torch.core.types import (
    HYPER_FIELDS, ArmPrior, HyperParams, PacerState, RouterState,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import DecodeCaches, stack_sizes
from repro_torch.optim.adamw import AdamWState
from repro_torch.training.train_step import TrainState
from repro_torch.tree import leaves

_F32 = ("A", "A_inv", "b", "theta", "price", "c_tilde")
_I32 = ("last_upd", "last_play", "t", "force_arm", "force_left")
_PACER = ("lam", "c_ema", "budget", "enabled")
_ENV = ("contexts", "rewards", "costs", "families", "prices_per_req",
        "prices_per_1k")


_TENANT_DTYPES = {"lam": torch.float32, "c_ema": torch.float32,
                  "budget": torch.float32, "enabled": torch.bool,
                  "pulls": torch.int32, "spend": torch.float32}


def _get(leaves, name):
    if isinstance(leaves, Mapping):
        return leaves[name]
    return getattr(leaves, name)


def _tenants_of(leaves):
    """The state's tenant table leaves, or None (absent or None)."""
    if isinstance(leaves, Mapping):
        return leaves.get("tenants")
    return getattr(leaves, "tenants", None)


def state_from_numpy(leaves, device) -> RouterState:
    """A port ``RouterState`` from a JAX state's leaves (unstacked or
    seed-stacked). ``pacer``, ``hyper`` and ``tenants`` (when present and
    not None) are nested the same way."""
    stacked = np.asarray(_get(leaves, "A")).ndim == 4

    def tensor(v, dtype):
        a = np.array(v)
        if not stacked:
            a = a[None]
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    kw = {n: tensor(_get(leaves, n), torch.float32) for n in _F32}
    kw.update({n: tensor(_get(leaves, n), torch.int32) for n in _I32})
    kw["active"] = tensor(_get(leaves, "active"), torch.bool)
    key = np.asarray(_get(leaves, "key"))
    if key.dtype != np.uint32 or key.shape[-1] != 2:
        raise ValueError(f"expected raw uint32 threefry keys (..., 2); got "
                         f"{key.dtype} {key.shape}")
    kw["key"] = tensor(key.astype(np.int64), torch.int64)
    p = _get(leaves, "pacer")
    kw["pacer"] = PacerState(
        lam=tensor(_get(p, "lam"), torch.float32),
        c_ema=tensor(_get(p, "c_ema"), torch.float32),
        budget=tensor(_get(p, "budget"), torch.float32),
        enabled=tensor(_get(p, "enabled"), torch.bool))
    h = _get(leaves, "hyper")
    kw["hyper"] = HyperParams(**{
        n: tensor(_get(h, n), torch.float32) for n in HYPER_FIELDS})
    tab = _tenants_of(leaves)
    if tab is not None:
        kw["tenants"] = tenancy.TenantTable(**{
            n: tensor(_get(tab, n), dt) for n, dt in _TENANT_DTYPES.items()})
    return RouterState(**kw)


def state_to_numpy(state: RouterState, *, stacked: bool = True) -> dict:
    """The port state's leaves as numpy, in the JAX package's dtypes (the
    key back to uint32) and in ``RouterState``'s field order, the tenant
    table included when the state has one. ``stacked=False`` drops the
    state axis of an S = 1 stack, giving a single router's leaves."""
    if not stacked and state.num_states != 1:
        raise ValueError(f"cannot unstack {state.num_states} states")

    def arr(t):
        a = t.detach().cpu().numpy()
        return a if stacked else a[0]

    nested = {"pacer": _PACER, "hyper": HYPER_FIELDS,
              "tenants": tenancy.LEAVES}
    out = {}
    for f in dataclasses.fields(RouterState):
        v = getattr(state, f.name)
        if v is None:
            continue
        if f.name in nested:
            out[f.name] = {n: arr(getattr(v, n)) for n in nested[f.name]}
        elif f.name == "key":
            out["key"] = arr(v).astype(np.uint32)
        else:
            out[f.name] = arr(v)
    return out


def prior_from_numpy(prior, device) -> ArmPrior:
    """An ``ArmPrior`` from (A_off, b_off) leaves."""
    def f32(name):
        return torch.as_tensor(np.array(_get(prior, name)),
                               dtype=torch.float32, device=device)
    return ArmPrior(A_off=f32("A_off"), b_off=f32("b_off"))


def prior_to_numpy(prior: ArmPrior) -> dict:
    return {"A_off": prior.A_off.cpu().numpy(),
            "b_off": prior.b_off.cpu().numpy()}


def env_from_numpy(env) -> Environment:
    """A port ``Environment`` (numpy, like the JAX package's) from any
    environment's fields."""
    kw = {n: np.array(_get(env, n)) for n in _ENV}
    return Environment(names=tuple(_get(env, "names")), **kw)


def env_to_numpy(env: Environment) -> dict:
    return {f.name: getattr(env, f.name) for f in dataclasses.fields(env)}


def params_from_numpy(tree, cfg: ModelConfig, device) -> dict:
    """The port's parameters from a JAX ``init_model`` tree of any family:
    the same nested dicts, per-layer leaves stacked on axis 0, weights in
    JAX's ``(d_in, d_out)`` layout, f32 as JAX stores them. Each stacked
    subtree must have the config's layers (``transformer.stack_sizes``),
    and the hybrid's ``shared_attn`` must be one unstacked block."""
    if not isinstance(tree, Mapping):
        return torch.as_tensor(np.array(tree, np.float32), device=device)
    out = {k: params_from_numpy(v, cfg, device) for k, v in tree.items()}
    if "embed" in out:                  # the top of a model tree
        for name, n in stack_sizes(cfg).items():
            L = next(leaves(out[name])).shape[0] if name in out else 0
            if L != n:
                raise ValueError(f"{cfg.name}: {name} has {L} stacked "
                                 f"layers, config {n}")
        if "shared_attn" in out and out["shared_attn"]["attn"][
                "w_q"].dim() != 2:
            raise ValueError(f"{cfg.name}: shared_attn is stacked; the "
                             "hybrid's shared block is one block")
    return out


def params_to_numpy(params) -> dict:
    """The port's parameters as a nested dict of f32 numpy arrays."""
    if not isinstance(params, Mapping):
        return params.detach().float().cpu().numpy()
    return {k: params_to_numpy(v) for k, v in params.items()}


def train_state_from_numpy(state, cfg: ModelConfig, device) -> TrainState:
    """The port's ``TrainState`` from a JAX ``TrainState`` (or a mapping
    of its fields): the parameters and the f32 moments as
    ``params_from_numpy`` reads them, the step as a 0-d int32 tensor."""
    opt = _get(state, "opt")
    return TrainState(
        params=params_from_numpy(_get(state, "params"), cfg, device),
        opt=AdamWState(
            step=torch.as_tensor(np.array(_get(opt, "step")),
                                 dtype=torch.int32, device=device),
            mu=params_from_numpy(_get(opt, "mu"), cfg, device),
            nu=params_from_numpy(_get(opt, "nu"), cfg, device)))


def train_state_to_numpy(state: TrainState) -> dict:
    """The port's ``TrainState`` as nested numpy leaves in the JAX
    package's structure: params, opt/step (int32), opt/mu, opt/nu."""
    return {"params": params_to_numpy(state.params),
            "opt": {"step": np.int32(state.opt.step.item()),
                    "mu": params_to_numpy(state.opt.mu),
                    "nu": params_to_numpy(state.opt.nu)}}


_CACHE_FIELDS = ("k", "v", "ssm_conv", "ssm_h", "shared_k", "shared_v",
                 "cross_k", "cross_v")


def caches_from_numpy(caches, device) -> DecodeCaches:
    """The port's ``DecodeCaches`` from a JAX ``DecodeCaches`` of any
    family (or a mapping of its stacks), and its scalar ``pos``; the
    stacks it does not hold stay None."""
    def tensor(name):
        a = (caches.get(name) if isinstance(caches, Mapping)
             else getattr(caches, name, None))
        return None if a is None else torch.as_tensor(np.array(a),
                                                      device=device)
    return DecodeCaches(**{n: tensor(n) for n in _CACHE_FIELDS},
                        pos=int(np.asarray(_get(caches, "pos"))))


def caches_to_numpy(caches: DecodeCaches) -> dict:
    """The caches' present stacks as f32 numpy arrays, and ``pos``."""
    out = {n: getattr(caches, n).detach().float().cpu().numpy()
           for n in _CACHE_FIELDS if getattr(caches, n) is not None}
    out["pos"] = np.int32(caches.pos)
    return out

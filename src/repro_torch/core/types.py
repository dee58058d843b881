"""Core datatypes for the ParetoBandit router, over a stack of states.

``RouterState`` is a frozen dataclass of fixed-capacity tensors
(``max_arms`` slots with an ``active`` mask), so ``add_arm``/``delete_arm``
never change shapes. Every leaf carries a leading state axis ``(S, ...)``:
the JAX package writes the router for one state and ``vmap``s it over
seeds, while here the router functions and both CUDA kernels take the
whole stack. S = 1 is the single-router case.

Configuration is split as in the JAX package:

  * ``Statics``      — shape-affecting knobs (``d``, ``max_arms``,
                       ``backend``, ``dt_max``, ``forced_pulls``).
  * ``HyperParams``  — the continuous knobs of Algorithm 1 (α, γ, λ_c, ...).
                       They ride in ``RouterState.hyper`` as (S,) f32
                       tensors, so every state of a stack may hold its own.

``RouterConfig`` is the user-facing constructor: its static fields ARE the
statics and ``cfg.hyper`` is the default ``HyperParams`` of new states.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

Tensor = torch.Tensor

BACKENDS = ("torch", "score", "fused")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller
    names another. Without a GPU and without an explicit device this
    raises; it never carries on quietly on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def lead(v: Tensor, ndim: int) -> Tensor:
    """A per-state (S,) leaf reshaped to broadcast against an (S, ...)
    tensor of ``ndim`` dimensions."""
    return v.reshape(v.shape + (1,) * (ndim - v.ndim))


@dataclasses.dataclass(frozen=True)
class HyperParams:
    """Algorithm 1's continuous hyper-parameters.

    Defaults are the paper's production configuration (knee-point
    selection, Appendix A Table 3): alpha=0.01, gamma=0.997, n_eff=1164.
    Fields hold Python floats at construction time and (S,) f32 tensors
    once loaded into ``RouterState.hyper`` via ``as_leaves``.
    """

    alpha: float | Tensor = 0.01          # UCB exploration coefficient
    gamma: float | Tensor = 0.997         # geometric forgetting factor, §3.3
    lambda_c: float | Tensor = 0.3        # static cost penalty weight, Eq. 2
    lambda0: float | Tensor = 1.0         # ridge regularisation A_a = lambda0*I
    eta: float | Tensor = 0.05            # dual ascent step size, Eq. 4
    alpha_ema: float | Tensor = 0.05      # EMA smoothing of the cost, Eq. 3
    lambda_bar: float | Tensor = 5.0      # projection cap for lambda_t, Eq. 4
    v_max: float | Tensor = 200.0         # staleness-inflation cap, Eq. 9
    c_floor: float | Tensor = 1e-4        # market cost floor ($/1k tok), Eq. 6
    c_ceil: float | Tensor = 0.1          # market cost ceiling ($/1k tok), Eq. 6
    tiebreak_scale: float | Tensor = 1e-7  # random tiebreak noise amplitude

    _RANGES = {
        "alpha": (lambda v: v >= 0.0, ">= 0"),
        "gamma": (lambda v: 0.0 < v <= 1.0, "in (0, 1]"),
        "lambda_c": (lambda v: v >= 0.0, ">= 0"),
        "lambda0": (lambda v: v > 0.0, "> 0"),
        "eta": (lambda v: v >= 0.0, ">= 0"),
        "alpha_ema": (lambda v: 0.0 < v <= 1.0, "in (0, 1]"),
        "lambda_bar": (lambda v: v >= 0.0, ">= 0"),
        "v_max": (lambda v: v >= 1.0, ">= 1"),
        "c_floor": (lambda v: v > 0.0, "> 0"),
        "c_ceil": (lambda v: v > 0.0, "> 0"),
        "tiebreak_scale": (lambda v: v >= 0.0, ">= 0"),
    }

    @staticmethod
    def validate_fields(**fields) -> None:
        """Range-check the given concrete (Python number) values, raising
        ``ValueError``; tensor leaves pass unchecked (``gamma`` is also
        clamped at runtime, ``linucb.forgetting_factor``). Unknown names
        raise ``TypeError``."""
        for name, v in fields.items():
            if name not in HYPER_FIELDS:
                raise TypeError(f"unknown hyper-parameter: {name!r}")
            if not isinstance(v, (int, float)):
                continue
            ok, want = HyperParams._RANGES[name]
            if not ok(float(v)):
                raise ValueError(f"HyperParams.{name}={v!r}: must be {want}")
        cf, cc = fields.get("c_floor"), fields.get("c_ceil")
        if (isinstance(cf, (int, float)) and isinstance(cc, (int, float))
                and not float(cc) > float(cf)):
            raise ValueError(
                f"HyperParams.c_ceil={cc!r} must exceed c_floor={cf!r}")

    def validate(self) -> "HyperParams":
        """Range-check every concrete field (see ``validate_fields``)."""
        self.validate_fields(**{n: getattr(self, n) for n in HYPER_FIELDS})
        return self

    def updated(self, **overrides) -> "HyperParams":
        """Copy with ``overrides`` applied (validated when concrete)."""
        bad = set(overrides) - set(HYPER_FIELDS)
        if bad:
            raise TypeError(f"unknown hyper-parameters: {sorted(bad)}")
        return dataclasses.replace(self, **overrides).validate()

    def as_leaves(self, n: int, device) -> "HyperParams":
        """Every field as an (n,) f32 tensor: scalars broadcast, (n,)
        stacks pass through — the state-leaf representation."""
        out = {}
        for name in HYPER_FIELDS:
            leaf = torch.as_tensor(getattr(self, name), dtype=torch.float32,
                                   device=device)
            if leaf.ndim not in (0, 1) or (leaf.ndim == 1
                                           and leaf.shape[0] != n):
                raise ValueError(
                    f"hyper.{name} must be a scalar or a ({n},) stack; got "
                    f"shape {tuple(leaf.shape)}")
            out[name] = leaf.expand(n).contiguous()
        return HyperParams(**out)


HYPER_FIELDS = tuple(f.name for f in dataclasses.fields(HyperParams))


@dataclasses.dataclass(frozen=True)
class Statics:
    """Shape-affecting router configuration."""

    d: int = 26                  # context dim (25 PCA + bias), §2.2
    max_arms: int = 8            # fixed registry capacity (K <= max_arms)
    forced_pulls: int = 20       # burn-in pulls for a hot-swapped arm, §4.5
    dt_max: int = 4096           # numerical clamp on forgetting exponents
    backend: str = "fused"       # "torch" oracle, "score" scoring kernel,
                                 # or "fused" step kernel

    def __post_init__(self):
        if self.d < 2:
            raise ValueError(f"d={self.d}: need >= 2 (features + bias)")
        if self.max_arms < 1:
            raise ValueError(f"max_arms={self.max_arms}: need >= 1")
        if self.forced_pulls < 0:
            raise ValueError(f"forced_pulls={self.forced_pulls}: need >= 0")
        if self.dt_max < 1:
            raise ValueError(f"dt_max={self.dt_max}: need >= 1")
        if self.backend not in BACKENDS:
            raise ValueError(f"backend={self.backend!r}: have {BACKENDS}")

    @property
    def statics(self) -> "Statics":
        """The shape-affecting projection: the key of the scenario
        runners' caches, so configs that differ only in hyper-parameters
        share one entry."""
        return Statics(self.d, self.max_arms, self.forced_pulls,
                       self.dt_max, self.backend)


@dataclasses.dataclass(frozen=True)
class RouterConfig(Statics):
    """User-facing router configuration: ``Statics`` fields + the default
    ``HyperParams`` of new states. The default backend is the step
    kernel, so the main path on a card always runs the kernels."""

    hyper: HyperParams = HyperParams()

    def __post_init__(self):
        super().__post_init__()
        self.hyper.validate()


@dataclasses.dataclass(frozen=True)
class PacerState:
    """Budget pacer state (Eqs. 3-4), one entry per state: (S,) leaves."""

    lam: Tensor      # (S,) f32 dual variable lambda_t >= 0
    c_ema: Tensor    # (S,) f32 EMA-smoothed realised cost (init: B)
    budget: Tensor   # (S,) f32 per-request ceiling B ($/req)
    enabled: Tensor  # (S,) bool — False recovers the "no pacer" ablations


@dataclasses.dataclass(frozen=True)
class RouterState:
    """Full ParetoBandit state for a stack of S routers.

    Shapes use K = cfg.max_arms, d = cfg.d. Integer leaves keep the JAX
    package's i32; the PRNG key holds its two uint32 words in int64
    (``prng`` works on uint32 values held in int64 and masked).
    """

    A: Tensor          # (S, K, d, d) f32 design matrices (ridge included)
    A_inv: Tensor      # (S, K, d, d) f32 cached inverses (Sherman-Morrison)
    b: Tensor          # (S, K, d)    f32 reward accumulators
    theta: Tensor      # (S, K, d)    f32 ridge solutions A^{-1} b
    last_upd: Tensor   # (S, K) i32  step of last statistics update
    last_play: Tensor  # (S, K) i32  step of last dispatch
    active: Tensor     # (S, K) bool registry mask
    price: Tensor      # (S, K) f32  blended $/request
    c_tilde: Tensor    # (S, K) f32  log-normalised unit cost in [0,1], Eq. 6
    t: Tensor          # (S,) i32 global step
    pacer: PacerState
    force_arm: Tensor   # (S,) i32, -1 when no forced exploration
    force_left: Tensor  # (S,) i32, remaining forced pulls
    key: Tensor         # (S, 2) int64: threefry key words (uint32 values)
    hyper: HyperParams  # (S,) f32 leaves
    # Optional tenant plane (DESIGN.md §15): a ``tenancy.TenantTable`` of
    # (S, T) per-tenant pacer leaves sharing the state's LinUCB
    # statistics, or None for the single-tenant paper configuration.
    # Typed ``object`` to keep this module free of tenancy.py (which
    # imports PacerState from here).
    tenants: Optional[object] = None

    @property
    def num_states(self) -> int:
        return self.A.shape[0]


# Plane ownership of RouterState leaves (the gateway's double buffering):
# ``select_batch`` writes only SELECT_LEAVES, ``update_batch`` only
# LEARN_LEAVES; control-plane ops write CONTROL_LEAVES.
LEARN_LEAVES = ("A", "A_inv", "b", "theta", "last_upd", "pacer", "tenants")
SELECT_LEAVES = ("t", "last_play", "key", "force_left")
CONTROL_LEAVES = ("active", "price", "c_tilde", "force_arm", "hyper")


def validate_leaf_partition() -> None:
    """Raise unless LEARN/SELECT/CONTROL exactly partition RouterState's
    fields: pairwise disjoint, union = every field."""
    fields = {f.name for f in dataclasses.fields(RouterState)}
    planes = {"LEARN_LEAVES": LEARN_LEAVES, "SELECT_LEAVES": SELECT_LEAVES,
              "CONTROL_LEAVES": CONTROL_LEAVES}
    union: set = set()
    for name, leaves in planes.items():
        s = set(leaves)
        if len(s) != len(leaves):
            raise ValueError(f"{name} has duplicate entries: {leaves}")
        dup = union & s
        if dup:
            raise ValueError(
                f"leaf plane overlap: {sorted(dup)} claimed by {name} "
                "and an earlier plane — two writer planes on one leaf")
        union |= s
    if union != fields:
        raise ValueError(
            "LEARN/SELECT/CONTROL_LEAVES must exactly partition "
            f"RouterState fields; missing={sorted(fields - union)} "
            f"unknown={sorted(union - fields)}")


def merge_learn_leaves(select_side: RouterState,
                       learn_side: RouterState) -> RouterState:
    """The gateway publish merge: LEARN_LEAVES from the learner's output,
    everything else (select bookkeeping + control plane) from the live
    select-side state."""
    return dataclasses.replace(
        select_side,
        **{n: getattr(learn_side, n) for n in LEARN_LEAVES})


def with_hyperparams(state: RouterState, hyper: Optional[HyperParams] = None,
                     **overrides) -> RouterState:
    """Retune a state's hyper-parameters: a full replacement ``hyper`` (a
    scalar or (S,) per field) or field ``overrides`` on the state's
    current values, each a number or an (S,) tensor.

    Numbers are range-checked on the host before they become leaves, and
    a number given for c_floor or c_ceil is held against the merged other
    bound (read from the state when it is not overridden). Tensor values
    pass unchecked and without a device sync, as the JAX package's traced
    leaves do (``gamma`` is clamped at runtime)."""
    S = state.num_states
    device = state.A.device
    hp = (state.hyper if hyper is None
          else hyper.validate().as_leaves(S, device))
    if overrides:
        HyperParams.validate_fields(**overrides)
        hp = dataclasses.replace(hp, **{
            k: torch.as_tensor(v, dtype=torch.float32, device=device)
            .expand(S).contiguous() for k, v in overrides.items()})
        bounds = [overrides[n] for n in ("c_floor", "c_ceil")
                  if n in overrides]
        if (bounds and all(isinstance(v, (int, float)) for v in bounds)
                and not bool((hp.c_ceil > hp.c_floor).all())):
            raise ValueError(
                "HyperParams.c_ceil must exceed c_floor (merged with the "
                "state's current values)")
    return dataclasses.replace(state, hyper=hp)


def map_leaves(fn, *states):
    """``fn`` over the matching tensor leaves of one or more states (the
    pacer's, the hyper-parameters' and the tenant table's included),
    rebuilt into a state: the port's ``jax.tree.map`` over
    ``RouterState``. An absent tenant table stays None."""
    first = states[0]
    if first is None:
        return None
    if not dataclasses.is_dataclass(first):
        return fn(*states)
    return type(first)(**{
        f.name: map_leaves(fn, *(getattr(s, f.name) for s in states))
        for f in dataclasses.fields(first)})


def state_where(mask: Tensor, new: RouterState,
                old: RouterState) -> RouterState:
    """Per state, ``new`` where ``mask`` (S,) bool is set, else ``old``:
    every leaf, the pacer's, the hyper-parameters' and the tenant
    table's included."""
    return map_leaves(lambda a, b: torch.where(lead(mask, a.ndim), a, b),
                      new, old)


def state_slice(state: RouterState, start: int, stop: int) -> RouterState:
    """States ``[start:stop]`` of a stack, every leaf a view."""
    return map_leaves(lambda a: a[start:stop], state)


def state_concat(states: Sequence[RouterState], device=None) -> RouterState:
    """Stacks joined along the state axis, in order, on ``device``
    (default: the first stack's)."""
    device = states[0].A.device if device is None else torch.device(device)
    return map_leaves(lambda *ls: torch.cat([a.to(device) for a in ls]),
                      *states)


@dataclasses.dataclass(frozen=True)
class ArmPrior:
    """Offline sufficient statistics for warm start (§3.4): one (d, d) /
    (d,) pair, or a stack of them, (..., d, d) / (..., d)."""

    A_off: Tensor   # (d, d) or (..., d, d)
    b_off: Tensor   # (d,) or (..., d)

    @property
    def theta_off(self) -> Tensor:
        """A_off^-1 b_off. A per-state stack is solved one distinct system
        at a time (``warmup.ridge_solve``), so a state's bits do not depend
        on the stack it sits in."""
        if self.A_off.dim() == 2:
            return torch.linalg.solve(self.A_off, self.b_off)
        from repro_torch.core.warmup import ridge_solve  # warmup imports us
        d = self.b_off.shape[-1]
        theta = ridge_solve(self.A_off.reshape(-1, d, d),
                            self.b_off.reshape(-1, d))[1]
        return theta.reshape(self.b_off.shape)


def log_normalized_cost(price_per_1k: Tensor, hp: HyperParams) -> Tensor:
    """Eq. 6: compress the ~530x price range into [0, 1] on a log scale.

    ``price_per_1k`` is (..., K); the (S,) ``c_floor``/``c_ceil`` leaves
    broadcast over the trailing arm axis. Values at or below the market
    floor map to 0.
    """
    c_floor = torch.as_tensor(hp.c_floor, dtype=torch.float32,
                              device=price_per_1k.device)
    c_ceil = torch.as_tensor(hp.c_ceil, dtype=torch.float32,
                             device=price_per_1k.device)
    c_floor, c_ceil = c_floor[..., None], c_ceil[..., None]
    num = (torch.log(torch.maximum(price_per_1k, c_floor))
           - torch.log(c_floor))
    den = torch.log(c_ceil) - torch.log(c_floor)
    return torch.clamp(num / den, 0.0, 1.0)


def init_state(
    cfg: RouterConfig,
    prices_per_req,
    prices_per_1k,
    budget: float | Sequence[float],
    *,
    key: Optional[Tensor] = None,
    active=None,
    pacer_enabled: bool = True,
    hyper: Optional[HyperParams] = None,
    num_states: Optional[int] = None,
    device=None,
    tenants: Optional[object] = None,
) -> RouterState:
    """Uninformative (tabula-rasa) initial states; warm start via warmup.py.

    Args:
      prices_per_req: (K,) blended realised $/request per arm, shared by
        every state (hard ceiling + reported compliance).
      prices_per_1k: (K,) blended $/1k-token rate per arm (Eq. 6).
      budget: one ceiling B ($/request) or one per state.
      key: (S, 2) threefry keys; default ``PRNGKey(0)`` for every state.
      num_states: S; default the length of ``key`` or ``budget``, else 1.
      hyper: overrides ``cfg.hyper`` (scalar or (S,) leaves).
      device: default the card (raises without one).
      tenants: optional ``tenancy.TenantTable`` enabling per-tenant pacing
        (DESIGN.md §15): (T,) leaves copied into every state or (S, T)
        leaves, one row per state. The scalar pacer stays as the
        portfolio-wide view but is inert when a table is present.
    """
    from repro_torch.core import prng, tenancy

    device = resolve_device(device)
    K, d = cfg.max_arms, cfg.d
    b_host = np.atleast_1d(np.asarray(budget, np.float32))
    if num_states is None:
        num_states = (key.shape[0] if key is not None
                      else b_host.shape[0])
    S = num_states
    hp = (cfg.hyper if hyper is None else hyper).validate().as_leaves(
        S, device)
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    prices_per_req = torch.as_tensor(np.asarray(prices_per_req), **f32)
    prices_per_1k = torch.as_tensor(np.asarray(prices_per_1k), **f32)
    if tuple(prices_per_req.shape) != (K,):
        raise ValueError(f"prices_per_req shape {tuple(prices_per_req.shape)}"
                         f" != ({K},)")
    if active is None:
        active = torch.ones((K,), dtype=torch.bool, device=device)
    active = torch.as_tensor(np.asarray(active), dtype=torch.bool,
                             device=device).expand(S, K).contiguous()
    eye = torch.eye(d, **f32)
    lam0 = lead(hp.lambda0, 4)
    A = eye.expand(S, K, d, d) * lam0
    A_inv = eye.expand(S, K, d, d) / lam0
    if key is None:
        key = prng.PRNGKey(0, device=device).expand(S, 2).contiguous()
    budgets = torch.as_tensor(np.broadcast_to(b_host, (S,)).copy(), **f32)
    return RouterState(
        A=A.contiguous(),
        A_inv=A_inv.contiguous(),
        b=torch.zeros((S, K, d), **f32),
        theta=torch.zeros((S, K, d), **f32),
        last_upd=torch.zeros((S, K), **i32),
        last_play=torch.zeros((S, K), **i32),
        active=active,
        price=prices_per_req.expand(S, K).contiguous(),
        c_tilde=log_normalized_cost(prices_per_1k.expand(S, K), hp),
        t=torch.zeros((S,), **i32),
        pacer=PacerState(
            lam=torch.zeros((S,), **f32),
            c_ema=budgets.clone(),          # \bar c_0 <- B (Alg. 1)
            budget=budgets,
            enabled=torch.full((S,), bool(pacer_enabled), dtype=torch.bool,
                               device=device),
        ),
        force_arm=torch.full((S,), -1, **i32),
        force_left=torch.zeros((S,), **i32),
        key=key.to(device=device, dtype=torch.int64),
        hyper=hp,
        tenants=(None if tenants is None
                 else tenancy.expand(tenants, S, device)),
    )

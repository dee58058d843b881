"""Multi-seed simulation harness: Algorithm 1 over an offline Environment
stream for a stack of per-seed states, reduced to the paper's metrics
(mean reward, mean cost, compliance ratio, per-arm allocation, regret).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import prng, router, tenancy, warmup
from repro_torch.core import scenario as scenario_lib
from repro_torch.core.pacer import validate_budget
from repro_torch.core.simulator import Environment
from repro_torch.core.types import (
    ArmPrior, HyperParams, RouterConfig, RouterState, init_state,
    resolve_device,
)


@dataclasses.dataclass(frozen=True)
class RunResult:
    arms: np.ndarray     # (S, T) chosen arm per seed/step
    rewards: np.ndarray  # (S, T)
    costs: np.ndarray    # (S, T)
    lams: np.ndarray     # (S, T) dual variable trace
    # Segment boundaries (0, ..., T) when the run came from a concat;
    # None for a plain single-segment run.
    bounds: Optional[tuple] = None

    @property
    def mean_reward(self) -> float:
        return float(self.rewards.mean())

    @property
    def mean_cost(self) -> float:
        return float(self.costs.mean())

    def compliance(self, budget: float) -> float:
        """Realised mean cost as a multiple of the ceiling (1.0 = at)."""
        return float(self.costs.mean() / budget)

    def allocation(self, k: int) -> np.ndarray:
        """(K,) fraction of traffic per arm."""
        return np.asarray(
            [(self.arms == a).mean() for a in range(k)], dtype=np.float64
        )

    def phase(self, start: int, stop: int) -> "RunResult":
        arms = self.arms[:, start:stop]
        bounds = None
        if self.bounds is not None:
            # Boundaries strictly inside [start, stop) survive, re-based.
            L = arms.shape[1]
            inner = sorted({b - start for b in self.bounds
                            if start < b < start + L})
            bounds = (0, *inner, L)
        return RunResult(
            arms=arms,
            rewards=self.rewards[:, start:stop],
            costs=self.costs[:, start:stop],
            lams=self.lams[:, start:stop],
            bounds=bounds,
        )

    @property
    def n_segments(self) -> int:
        return 1 if self.bounds is None else len(self.bounds) - 1

    def segment(self, j: int) -> "RunResult":
        """Slice to segment ``j`` (between boundaries); out-of-range
        indices raise ValueError."""
        if self.bounds is None:
            raise ValueError("run has no segment boundaries")
        if not 0 <= j < self.n_segments:
            raise ValueError(
                f"segment index {j} out of range: run has "
                f"{self.n_segments} segments (bounds={self.bounds})")
        return self.phase(self.bounds[j], self.bounds[j + 1])

    @classmethod
    def concat(cls, parts: Sequence["RunResult"]) -> "RunResult":
        """Stitch per-segment results along the time axis; the joins (and
        any internal boundaries of the parts) become segment bounds."""
        parts = list(parts)
        bounds, off = [0], 0
        for p in parts:
            inner = p.bounds if p.bounds is not None else (0, p.arms.shape[1])
            bounds.extend(off + b for b in inner[1:])
            off += p.arms.shape[1]
        return cls(
            arms=np.concatenate([p.arms for p in parts], axis=1),
            rewards=np.concatenate([p.rewards for p in parts], axis=1),
            costs=np.concatenate([p.costs for p in parts], axis=1),
            lams=np.concatenate([p.lams for p in parts], axis=1),
            bounds=tuple(bounds),
        )

    def regret_vs_oracle(self, env_rewards: np.ndarray) -> np.ndarray:
        """(S,) cumulative regret vs the per-prompt oracle."""
        oracle = env_rewards.max(axis=1)  # (T,)
        return (oracle[None, :] - self.rewards).sum(axis=1)


def pad_priors(cfg: RouterConfig, priors: Sequence[ArmPrior | None]):
    """Pad a per-arm prior list out to ``max_arms`` slots (the layout
    ``warmup.apply_warmup`` expects)."""
    pad = cfg.max_arms - len(priors)
    if pad < 0:
        raise ValueError(f"{len(priors)} priors for {cfg.max_arms} slots")
    return list(priors) + [None] * pad


def _tenant_stack(tenants: "tenancy.TenantTable", n: int, device):
    """A tenant table as (n, T) leaves on ``device``: one shared (T,)
    table copied into every stacked state, or one with (n, T) leaves (a
    per-state axis, the sweep fabric's flattened grid). Budgets are
    positivity-checked here (host boundary, one device sync)."""
    if not bool((tenants.budget > 0.0).all()):
        raise ValueError(
            "tenant budgets must be > 0 ($/request ceilings); got "
            f"min={float(tenants.budget.min())!r}")
    return tenancy.expand(tenants, n, device)


def make_states(
    cfg: RouterConfig,
    env: Environment,
    budget: float | Sequence[float],
    seeds: Sequence[int],
    *,
    priors: Optional[Sequence[ArmPrior | None]] = None,
    n_eff: float | Sequence[float] = 0.0,
    pacer_enabled: bool = True,
    active_arms: Optional[int] = None,
    hyper: Optional[HyperParams] = None,
    tenants: Optional["tenancy.TenantTable"] = None,
    device=None,
) -> RouterState:
    """A stack of initial states, one per seed, with key
    ``PRNGKey(seed)``.

    ``budget``, ``n_eff`` and every ``hyper`` field are either one value
    shared by every state or one value per seed. A warm stack (priors
    given and some ``n_eff`` > 0) must be warm in every state: warm-up at
    n_eff = 0 is not a no-op.

    ``tenants`` attaches a per-tenant pacer table (DESIGN.md §15): one
    shared (T,) ``tenancy.TenantTable`` copied into every state, or one
    with (len(seeds), T) leaves for a per-state tenant axis.
    """
    device = resolve_device(device)
    k = env.k
    if k > cfg.max_arms:
        raise ValueError(f"{k} arms for {cfg.max_arms} slots")
    S = len(seeds)
    validate_budget(budget)
    b_host = np.asarray(budget, np.float32)
    if b_host.ndim and b_host.shape != (S,):
        raise ValueError(f"budget must be a scalar or one value per state; "
                         f"got shape {b_host.shape} for {S} states")
    pad = cfg.max_arms - k
    preq = np.concatenate([env.prices_per_req, np.full(pad, 1e9)]).astype(np.float32)
    p1k = np.concatenate([env.prices_per_1k, np.full(pad, 1e9)]).astype(np.float32)
    n_active = k if active_arms is None else active_arms
    active = np.zeros(cfg.max_arms, bool)
    active[:n_active] = True
    ne = np.asarray(n_eff, np.float32)
    if ne.ndim and ne.shape != (S,):
        raise ValueError(
            f"n_eff must be a scalar or one value per state; got shape "
            f"{ne.shape} for {S} states")
    warm = priors is not None and bool(np.any(ne > 0))
    if warm and ne.ndim and not np.all(ne > 0):
        raise ValueError(
            "mixed warm/cold n_eff in one stack: apply_warmup at n_eff=0 "
            "is not a no-op")
    keys = torch.stack([prng.PRNGKey(s, device=device) for s in seeds])
    state = init_state(
        cfg, preq, p1k, np.broadcast_to(b_host, (S,)), key=keys,
        active=active, pacer_enabled=pacer_enabled, hyper=hyper,
        device=device,
        tenants=None if tenants is None else _tenant_stack(tenants, S,
                                                           device))
    if warm:
        ne_t = torch.as_tensor(ne, device=device)
        state = warmup.apply_warmup(cfg, state, pad_priors(cfg, priors), ne_t)
    return state


def _pad_env_arrays(cfg: RouterConfig, env: Environment):
    """Pad (T, K) matrices out to max_arms with harmless fillers."""
    pad = cfg.max_arms - env.k
    rewards = np.concatenate(
        [env.rewards, np.zeros((env.n, pad), np.float32)], axis=1)
    costs = np.concatenate(
        [env.costs, np.full((env.n, pad), 1e9, np.float32)], axis=1)
    return env.contexts.astype(np.float32), rewards, costs


def build_run_streams(
    cfg: RouterConfig,
    env: Environment | Sequence[Environment],
    seeds: Sequence[int],
    shuffle: bool = True,
    device=None,
):
    """Per-seed stream tensors (S, T, d), (S, T, K), (S, T, K) on
    ``device``, plus the environment whose rate card labels the run.

    A sequence of environments gives one stream per seed; one environment
    is permuted per seed (``default_rng(seed).permutation``, as in the
    JAX package) unless ``shuffle=False``, when every seed sees it as is.
    """
    device = resolve_device(device)
    if isinstance(env, (list, tuple)):
        if len(env) != len(seeds):
            raise ValueError(f"{len(env)} environments for {len(seeds)} seeds")
        padded = [_pad_env_arrays(cfg, e) for e in env]
        arrays = [np.stack([p[j] for p in padded]) for j in range(3)]
        env0 = env[0]
    else:
        xs, rm, cm = _pad_env_arrays(cfg, env)
        if shuffle:
            perms = np.stack([np.random.default_rng(int(s)).permutation(env.n)
                              for s in seeds])
            arrays = [xs[perms], rm[perms], cm[perms]]
        else:
            arrays = [np.broadcast_to(a, (len(seeds),) + a.shape)
                      for a in (xs, rm, cm)]
        env0 = env
    xs, rm, cm = (torch.as_tensor(np.require(a, requirements=("C", "W")),
                                  device=device)
                  for a in arrays)
    return xs, rm, cm, env0


def run(
    cfg: RouterConfig,
    env: Environment | Sequence[Environment],
    budget: float,
    seeds: Sequence[int] = tuple(range(20)),
    *,
    priors: Optional[Sequence[ArmPrior | None]] = None,
    n_eff: float = 0.0,
    pacer_enabled: bool = True,
    states: Optional[RouterState] = None,
    shuffle: bool = True,
    return_states: bool = False,
    batch_size: Optional[int] = None,
    hyper: Optional[HyperParams] = None,
    tenants=None,
    tenant_ids=None,
    device=None,
):
    """Multi-seed run of Algorithm 1 over an environment stream, all seeds
    as one state stack.

    ``env`` is one Environment (per-seed prompt order is a seed-specific
    permutation unless ``shuffle=False``) or a sequence of per-seed
    Environments of equal length. ``batch_size`` runs the stream through
    the batched data plane in blocks of that size; None is the
    per-request closed loop (blocks of one). ``states`` continues from a
    given stack instead of fresh states. ``device`` defaults to the card.

    ``tenants`` + ``tenant_ids`` switch the run to the tenant plane
    (DESIGN.md §15): ``tenants`` is a shared (T,) or per-seed (S, T)
    ``tenancy.TenantTable`` and ``tenant_ids`` tags each stream step with
    its tenant — (L,) shared by every seed or (S, L) per seed. Requires
    ``batch_size`` (tenant routing runs on the batched data plane) and
    the ``torch`` backend (``router._tenant_mode_check``).
    """
    if (tenants is None) != (tenant_ids is None) and states is None:
        raise ValueError("pass tenants and tenant_ids together")
    if states is not None:
        device = states.A.device
    device = resolve_device(device)
    xs, rmat, cmat, env0 = build_run_streams(cfg, env, seeds, shuffle,
                                             device=device)
    if states is None:
        states = make_states(
            cfg, env0, budget, seeds, priors=priors, n_eff=n_eff,
            pacer_enabled=pacer_enabled, hyper=hyper, tenants=tenants,
            device=device)
    if tenant_ids is not None:
        if not batch_size:
            raise ValueError(
                "tenant runs need batch_size: tenant routing is a batched-"
                "data-plane feature (DESIGN.md §15)")
        finals, trace = stream_body_tenants(cfg, batch_size)(
            states, xs, rmat, cmat, tenant_ids)
    else:
        finals, trace = stream_body(cfg, batch_size)(states, xs, rmat, cmat)
    res = _result(trace)
    if return_states:
        return res, finals
    return res


def _result(trace, h: Optional[int] = None, bounds=None) -> RunResult:
    """A run's (S, T) device traces as a ``RunResult`` on the host, cut
    to the first ``h`` steps."""
    arms, r, c, lam = (t[:, :h].cpu().numpy() for t in trace)
    return RunResult(arms=arms, rewards=r, costs=c, lams=lam, bounds=bounds)


def stream_body(cfg: RouterConfig, batch_size=None):
    """The stack's stream program: one (S, T) stream through the data
    plane in blocks of ``batch_size`` (None: the per-request loop)."""

    def run(state, x, rm, cm):
        return router.run_stream_batched(cfg, state, x, rm, cm,
                                         batch_size or 1)

    return run


def stream_body_tenants(cfg: RouterConfig, batch_size):
    """Tenant-mode stream program: ``stream_body`` with an (S, L)
    ``tenant_ids`` operand threaded to the batched data plane."""

    def run(state, x, rm, cm, tids):
        return router.run_stream_batched(cfg, state, x, rm, cm, batch_size,
                                         tenant_ids=tids)

    return run


def run_scenario(
    cfg: RouterConfig,
    spec: "scenario_lib.ScenarioSpec",
    env: Environment,
    budget: float,
    seeds: Sequence[int] = tuple(range(20)),
    *,
    priors: Optional[Sequence[ArmPrior | None]] = None,
    n_eff: float = 0.0,
    pacer_enabled: bool = True,
    batch_size: Optional[int] = None,
    return_states: bool = False,
    hyper: Optional[HyperParams] = None,
    scenario_params: Optional["scenario_lib.ScenarioParams"] = None,
    timeline: Optional["scenario_lib.Timeline"] = None,
    tenants=None,
    tenant_ids=None,
    device=None,
):
    """Run a declarative ``ScenarioSpec`` over ``env`` for every seed as
    one state stack (scenario.py).

    The spec's event timeline becomes a per-seed stream stack plus state
    edits applied between segments; ``batch_size`` > 1 runs every segment
    through the batched data plane instead of the per-request loop. The
    returned ``RunResult`` carries the spec's segment ``bounds``, so
    metrics reduce per segment via ``res.segment(j)``.

    ``scenario_params`` resolves any ``Param`` payload references in the
    spec (DESIGN.md §10): leaves are shared by every seed or per-seed
    ``(len(seeds),)`` stacks.

    ``timeline`` moves the spec's event *times* (and optionally shrinks
    the effective horizon, padding the run) through the masked timeline
    runner (DESIGN.md §12): identical to running the concrete retimed
    spec on live steps. Traces and bounds come back cut to the effective
    horizon. ``device`` defaults to the card.

    ``tenants`` + ``tenant_ids`` run the spec on the tenant plane
    (DESIGN.md §15): a shared (T,) or per-seed (S, T) table and ids of
    ``(spec.horizon,)`` shared or ``(len(seeds), spec.horizon)`` per seed
    (``data.synthetic.tenant_stream_for_spec`` honours the spec's
    ``TenantMixShift`` events); ``TenantBudgetChange`` edits the table.
    Needs ``batch_size`` > 1; as in the JAX package, tenant runs do not go
    through the masked timeline runner.
    """
    if (tenants is None) != (tenant_ids is None):
        raise ValueError("pass tenants and tenant_ids together")
    if tenants is not None and timeline is not None:
        raise NotImplementedError(
            "tenant runs are not wired through the masked timeline "
            "runner; use the concrete scenario path (timeline=None)")
    device = resolve_device(device)
    params = scenario_lib.resolve_params(spec, scenario_params)
    full = params.updated(**scenario_lib.auto_param_values(spec))
    states = make_states(
        cfg, env, budget, seeds, priors=priors, n_eff=n_eff,
        pacer_enabled=pacer_enabled, active_arms=spec.init_active,
        hyper=hyper, tenants=tenants, device=device)
    S = len(seeds)
    bp = scenario_lib.broadcast_params(full, S, device)
    if timeline is not None:
        rspec = scenario_lib.retime(spec, timeline)
        scenario_lib.validate_timeline_alignment(
            rspec, batch_size, spec.horizon)
        xs, rmat, cmat = scenario_lib.build_streams(
            cfg, rspec, env, seeds, params=params, pad_to=spec.horizon,
            device=device)
        run_fn = scenario_lib.compiled_timeline_runner(
            cfg, spec, env, batch_size)
        ev = np.broadcast_to(
            np.asarray([e.t for e in rspec.events], np.int64),
            (S, len(spec.events)))
        hz = np.full((S,), rspec.horizon, np.int64)
        finals, trace = run_fn(states, xs, rmat, cmat, bp, ev, hz)
        res = _result(trace, rspec.horizon, rspec.bounds)
    else:
        xs, rmat, cmat = scenario_lib.build_streams(
            cfg, spec, env, seeds, params=params, device=device)
        run_fn = scenario_lib.compiled_runner(
            cfg, spec, env, batch_size, with_tenants=tenants is not None)
        if tenants is not None:
            tids = router.tenant_id_stack(tenant_ids, S, spec.horizon,
                                          device)
            finals, trace = run_fn(states, xs, rmat, cmat, bp, tids)
        else:
            finals, trace = run_fn(states, xs, rmat, cmat, bp)
        res = _result(trace, bounds=spec.bounds)
    if return_states:
        return res, finals
    return res


def fit_warmup_priors(cfg: RouterConfig, env: Environment,
                      lambda0: float = 1.0, device=None):
    """Fit per-arm offline priors from a train-split environment, emulating
    the paper's offline characterisation (every arm sees every prompt)."""
    device = resolve_device(device)
    xs = torch.as_tensor(env.contexts, dtype=torch.float32, device=device)
    rs = torch.as_tensor(env.rewards, dtype=torch.float32, device=device)
    return [warmup.fit_offline_prior(xs, rs[:, a], lambda0=lambda0)
            for a in range(env.k)]

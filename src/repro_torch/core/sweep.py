"""Grid-sweep fabric: a whole (condition x seed) grid as one state stack.

The paper's headline results are grids: seven budget ceilings x 20 seeds
(Fig. 1), scenario x budget matrices, (alpha, gamma) selection grids,
thousands of sampled timelines. Looping over the conditions pays the
router's per-block host cost once per condition; here the grid is one
stack of N = C x S states and runs as one closed loop:

  * the condition axis is stacked into state leaves: the budget ceiling
    lives in ``PacerState.budget`` (``evaluate.make_states`` takes one
    budget per state), hyper-parameters in ``RouterState.hyper`` ((C,)
    ``HyperParams`` leaves and a (C,) ``n_eff`` repeat S times), and any
    other knob rides ``condition_edits``: functions over a condition's
    S-state block (``hyper_edit``, ``warmup_edit``, ``param_edit``,
    ``chain_edits``), applied once before the run;

  * the (condition, seed) grid is flattened condition-major (element
    c*S + s is (budgets[c], seeds[s])) onto the leading state axis that
    every leaf, kernel and stream already has. The JAX package ``vmap``s
    its per-seed program; here the same program (``evaluate.stream_body``
    or the scenario engine's cached runners) takes the wider stack, and
    with the ``fused`` backend every block of every state runs through
    one ``linucb_step`` launch;

  * ``chunk_size`` runs the stack as consecutive sub-stacks of that many
    states (the JAX fabric's scan over chunks), and ``devices`` splits it
    over a ``launch.mesh`` grid mesh, one contiguous part per device, run
    from one thread per device and joined on the host. Both give the
    unchunked call's bits: a state's arithmetic does not depend on the
    stack it sits in (``warmup.ridge_solve``).

Per-condition results equal the looped per-condition ``evaluate.run`` /
``run_scenario`` bit for bit: the fabric reuses the same stream builder,
the same state constructor and the same run bodies.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import evaluate, tenancy, warmup
from repro_torch.core import scenario as scenario_lib
from repro_torch.core import types as types_lib
from repro_torch.core.simulator import Environment
from repro_torch.core.types import (
    ArmPrior, HyperParams, RouterConfig, RouterState, resolve_device,
)
from repro_torch.launch import mesh as mesh_lib


@dataclasses.dataclass(frozen=True)
class GridResult:
    """Traces for a (condition x seed) grid, shaped (C, S, T)."""

    budgets: tuple       # (C,) condition axis (the stacked ceilings)
    seeds: tuple         # (S,)
    arms: np.ndarray     # (C, S, T)
    rewards: np.ndarray  # (C, S, T)
    costs: np.ndarray    # (C, S, T)
    lams: np.ndarray     # (C, S, T)
    # Segment boundaries shared by every condition (scenario grids).
    bounds: Optional[tuple] = None
    # Per-condition scenario payload values (name -> (C,)+payload_shape),
    # recorded for reporting when a payload axis rides the grid.
    params: Optional[dict] = None
    # Timeline grids: per-condition effective bounds / horizons; the
    # (C, S, T) arrays are padded to T_max and ``condition(i)`` trims to
    # horizons[i].
    cond_bounds: Optional[tuple] = None
    horizons: Optional[tuple] = None

    def __len__(self) -> int:
        return len(self.budgets)

    def condition(self, i: int) -> evaluate.RunResult:
        """One condition as the multi-seed ``RunResult`` (timeline grids:
        trimmed to its effective horizon, with its own segment bounds)."""
        h = None if self.horizons is None else self.horizons[i]
        b = self.bounds if self.cond_bounds is None else self.cond_bounds[i]
        return evaluate.RunResult(
            arms=self.arms[i][:, :h], rewards=self.rewards[i][:, :h],
            costs=self.costs[i][:, :h], lams=self.lams[i][:, :h], bounds=b,
        )

    def conditions(self):
        for i, b in enumerate(self.budgets):
            yield b, self.condition(i)


def _check_grid_args(budgets, seeds, condition_edits):
    """Explicit ValueErrors for degenerate grids (an empty axis, a
    misaligned edit list). Materializes (and returns) the axes once so
    one-shot iterables stay valid."""
    budgets, seeds = tuple(budgets), tuple(seeds)
    if not budgets:
        raise ValueError(
            "budgets is empty: the grid needs at least one condition")
    if not seeds:
        raise ValueError(
            "seeds is empty: the grid needs at least one seed")
    if condition_edits is not None and len(condition_edits) != len(budgets):
        raise ValueError(
            f"condition_edits has {len(condition_edits)} entries but the "
            f"grid has {len(budgets)} conditions (one edit — or "
            "None — per budget)")
    return budgets, seeds


def _flatten_grid(budgets, seeds):
    """(C,) x (S,) -> aligned flat (C*S,) budget / seed vectors, ordered
    condition-major so element c*S + s is (budgets[c], seeds[s])."""
    budgets = tuple(float(b) for b in budgets)
    seeds = tuple(int(s) for s in seeds)
    flat_b = np.repeat(np.asarray(budgets, np.float32), len(seeds))
    flat_s = seeds * len(budgets)
    return budgets, seeds, flat_b, flat_s


def _per_condition_axis(value, C: int, S: int):
    """A per-condition (C,) vector (numpy or tensor) repeated S times to
    align with the condition-major (C*S,) stack; scalars and already-flat
    (C*S,) values pass through."""
    if isinstance(value, torch.Tensor):
        if value.ndim == 1 and value.shape[0] == C and C != C * S:
            return value.repeat_interleave(S)
        return value
    arr = np.asarray(value)
    if arr.ndim == 1 and arr.shape[0] == C and C != C * S:
        return np.repeat(arr, S)
    return value


def _expand_hyper(hyper, C: int, S: int):
    """Per-condition (C,) hyper leaves -> flattened (C*S,) stacks."""
    if hyper is None:
        return None
    return HyperParams(**{
        n: _per_condition_axis(getattr(hyper, n), C, S)
        for n in types_lib.HYPER_FIELDS
    })


def _expand_tenants(tables, C: int, S: int):
    """A tenant-table spec for the flattened grid (DESIGN.md §15):
    shared (T,) leaves pass through (every grid element gets a copy),
    per-condition (C, T) leaves repeat S times to (C*S, T), and
    pre-flattened (C*S, T) leaves pass through."""
    if tables is None:
        return None
    ndim = tables.budget.ndim
    if ndim == 1:
        return tables
    n0 = tables.budget.shape[0]
    if ndim == 2 and n0 == C and C != C * S:
        return tenancy.TenantTable(**{
            n: getattr(tables, n).repeat_interleave(S, dim=0)
            for n in tenancy.LEAVES})
    if ndim == 2 and n0 == C * S:
        return tables
    raise ValueError(
        f"tenant_tables.budget must be (T,) shared, ({C}, T) per-"
        f"condition or ({C * S}, T) pre-flattened; got shape "
        f"{tuple(tables.budget.shape)}")


def _grid_tenant_ids(tenant_ids, C: int, S: int, device) -> torch.Tensor:
    """Tenant ids (L,) shared, (S, L) per seed or (C*S, L) per element,
    as a (C*S, L) int64 tensor on ``device``."""
    tids = np.asarray(tenant_ids, np.int32)
    if tids.ndim == 1:
        tids = np.broadcast_to(tids, (C * S,) + tids.shape)
    elif tids.ndim == 2 and tids.shape[0] == S and S != C * S:
        tids = np.broadcast_to(tids[None], (C,) + tids.shape).reshape(
            C * S, -1)
    elif not (tids.ndim == 2 and tids.shape[0] == C * S):
        raise ValueError(
            f"tenant_ids must be (L,) shared, ({S}, L) per-seed or "
            f"({C * S}, L) per-element; got shape {tids.shape}")
    return torch.as_tensor(np.ascontiguousarray(tids),
                           device=device).long()


def _n_chunks(n: int, chunk_size) -> int:
    """Validate a ``chunk_size`` knob against the flattened grid size."""
    if chunk_size is None:
        return 1
    chunk_size = int(chunk_size)
    if chunk_size < 1 or n % chunk_size:
        raise ValueError(
            f"chunk_size={chunk_size}: must be a positive divisor of the "
            f"flattened grid size C*S = {n} (sweep.fit_chunk picks one)")
    return n // chunk_size


def fit_chunk(n: int, chunk_size: int) -> int:
    """The largest divisor of ``n`` that is <= ``chunk_size`` (always
    >= 1), for callers whose grid size is not known to divide evenly."""
    c = max(1, min(int(chunk_size), int(n)))
    while n % c:
        c -= 1
    return c


def _tile(a: torch.Tensor, C: int) -> torch.Tensor:
    """Per-seed (S, ...) streams stacked C times along the state axis:
    (C*S, ...), condition-major."""
    return a.repeat((C,) + (1,) * (a.ndim - 1))


def _take(x, start: int, stop: int, device):
    """Elements [start:stop) of a per-element operand, on ``device``: a
    state stack, a ``ScenarioParams``, a tensor, or host numpy (event
    times, horizons)."""
    if isinstance(x, RouterState):
        return types_lib.map_leaves(lambda a: a[start:stop].to(device), x)
    if isinstance(x, scenario_lib.ScenarioParams):
        return scenario_lib.ScenarioParams(**{
            n: x.get(n)[start:stop].to(device) for n in x.names})
    if isinstance(x, torch.Tensor):
        return x[start:stop].to(device)
    return x[start:stop]


def _run_stack(body: Callable, states: RouterState, operands: tuple,
               n_chunks: int, devices, device):
    """``body(states, *operands) -> (finals, traces)`` over the whole
    stack: split over the grid mesh of ``devices`` (None: ``device``
    alone), each part run in its sub-stacks of N / ``n_chunks`` states in
    order. Returns the final stack on ``device`` and the (N, T) traces as
    host numpy."""
    N = states.num_states
    mesh = ((device,) if devices is None
            else mesh_lib.make_grid_mesh(N, devices))
    step = N // n_chunks

    def part(i, dev):
        lo, hi = mesh_lib.part_bounds(N, mesh)[i]
        cuts = sorted({lo, hi} | {c for c in range(0, N, step) if lo < c < hi})
        out = []
        for a, b in zip(cuts, cuts[1:]):
            finals, trace = body(_take(states, a, b, dev),
                                 *(_take(x, a, b, dev) for x in operands))
            out.append((finals, tuple(t.cpu().numpy() for t in trace)))
        return out

    runs = [r for rs in mesh_lib.run_parts(part, mesh) for r in rs]
    finals = types_lib.state_concat([f for f, _ in runs], device=device)
    traces = tuple(np.concatenate(p) for p in zip(*(t for _, t in runs)))
    return finals, traces


def _grid_result(budgets, seeds, traces, **kw) -> GridResult:
    C, S = len(budgets), len(seeds)
    arms, r, c, lam = (t.reshape(C, S, -1) for t in traces)
    return GridResult(budgets=budgets, seeds=seeds, arms=arms, rewards=r,
                      costs=c, lams=lam, **kw)


def _stack_device(devices, device) -> torch.device:
    """Where the stack is built: ``device``, else the first of
    ``devices``, else the card."""
    if device is None and devices is not None:
        device = list(devices)[0]
    return resolve_device(device)


# ---------------------------------------------------------------------------
# Condition-edit helpers (DESIGN.md §7 stacking rules)
# ---------------------------------------------------------------------------


def _apply_condition_edits(
    states: RouterState,
    condition_edits: Sequence[Optional[Callable[[RouterState], RouterState]]],
    S: int,
) -> RouterState:
    """Apply each condition's edit to its S-state block (once per grid,
    before the run) and join the blocks."""
    parts = []
    for c, edit in enumerate(condition_edits):
        block = types_lib.state_slice(states, c * S, (c + 1) * S)
        parts.append(block if edit is None else edit(block))
    return types_lib.state_concat(parts)


def hyper_edit(hyper: Optional[HyperParams] = None, **overrides):
    """A condition edit pinning hyper-parameter leaves: the way an
    (alpha, gamma, ...) grid joins the condition axis (DESIGN.md §9).

    ``sweep.run_grid(cfg, env, budgets, condition_edits=[
        sweep.hyper_edit(alpha=0.05, gamma=0.997), ...])``
    """
    if hyper is not None:
        hyper.validate()
    if overrides:
        HyperParams.validate_fields(**overrides)

    def edit(st: RouterState) -> RouterState:
        return types_lib.with_hyperparams(st, hyper=hyper, **overrides)

    return edit


def warmup_edit(cfg: RouterConfig, priors, n_eff: float):
    """A condition edit applying the §3.4 warm start at a per-condition
    ``n_eff`` (e.g. derived from gamma via Eq. 13). The same operations as
    ``make_states(priors=..., n_eff=...)``, so fused cells equal their
    looped counterparts bit for bit."""
    padded = evaluate.pad_priors(cfg, list(priors))

    def edit(st: RouterState) -> RouterState:
        return warmup.apply_warmup(cfg, st, padded, n_eff)

    return edit


def param_edit(**overrides):
    """A condition edit pinning scenario payload leaves: the way a payload
    axis (price multiplier, quality target, ...) joins a scenario grid's
    condition axis (DESIGN.md §10), mirroring ``hyper_edit``.

    ``sweep.run_scenario_grid(cfg, spec, env, budgets, condition_edits=[
        sweep.chain_edits(sweep.hyper_edit(alpha=a), sweep.param_edit(mult=m))
        for a, m in cells])``

    The state part is the identity: payload leaves are ``ScenarioParams``
    operands, so ``run_scenario_grid`` folds the per-condition overrides
    into the stacked params (``run_grid`` has no payloads and rejects
    them).
    """

    def edit(st: RouterState) -> RouterState:
        return st

    # Normalized through ScenarioParams so payload kinds (floats, weight
    # vectors, ArmPrior -> packed (d, d+1) leaves) behave as on the
    # scenario_params= path.
    normalized = scenario_lib.ScenarioParams(**overrides)
    edit.param_overrides = {n: normalized.get(n) for n in normalized.names}
    return edit


def chain_edits(*edits):
    """Compose condition edits left to right (``None`` entries skipped);
    None when nothing remains. ``param_edit`` overrides carried by the
    inputs are merged (rightmost wins) onto the composite."""
    live = tuple(e for e in edits if e is not None)
    if not live:
        return None
    if len(live) == 1:
        return live[0]

    def edit(st: RouterState) -> RouterState:
        for e in live:
            st = e(st)
        return st

    merged = {}
    for e in live:
        merged.update(getattr(e, "param_overrides", {}))
    if merged:
        edit.param_overrides = merged
    return edit


def run_grid(
    cfg: RouterConfig,
    env: Environment | Sequence[Environment],
    budgets: Sequence[float],
    seeds: Sequence[int] = tuple(range(20)),
    *,
    priors: Optional[Sequence[ArmPrior | None]] = None,
    n_eff: float | Sequence[float] = 0.0,
    pacer_enabled: bool = True,
    shuffle: bool = True,
    batch_size: Optional[int] = None,
    condition_edits: Optional[Sequence[Optional[Callable]]] = None,
    devices=None,
    return_states: bool = False,
    hyper: Optional[HyperParams] = None,
    chunk_size: Optional[int] = None,
    tenant_tables=None,
    tenant_ids=None,
    device=None,
):
    """Evaluate a (budget x seed) grid as one state stack of C*S states.

    Per condition the same as ``evaluate.run(cfg, env, budgets[c],
    seeds=seeds, ...)`` bit for bit: the same per-seed shuffles, initial
    states and run body. ``condition_edits`` applies one extra edit per
    condition (aligned with ``budgets``) for state-leaf axes beyond the
    ceiling. ``hyper`` leaves and ``n_eff`` may be per-condition (C,)
    vectors (DESIGN.md §9), repeated S times onto the stack inside
    ``make_states``.

    Per-seed streams are built once and tiled C times; a stream shared by
    every seed (one environment, ``shuffle=False``) is expanded, not
    copied. ``chunk_size`` (a divisor of C*S; ``fit_chunk`` picks one)
    runs the stack in sub-stacks of that many states; ``devices`` splits
    it over the grid mesh of those devices (``launch.mesh``); None runs
    it on ``device`` (default the card) alone. Both give the same bits.

    ``tenant_tables`` + ``tenant_ids`` put the tenant plane on the grid
    (DESIGN.md §15): tables with (T,) shared, (C, T) per-condition or
    (C*S, T) pre-flattened leaves, ids shaped (L,) shared, (S, L)
    per-seed or (C*S, L) per-element — so a (tenants x budgets x seeds)
    grid runs as one stack, split with it by ``chunk_size`` and
    ``devices``. Requires ``batch_size`` (tenant routing is a
    batched-data-plane feature) and the ``torch`` backend.
    """
    budgets, seeds = _check_grid_args(budgets, seeds, condition_edits)
    if (tenant_tables is None) != (tenant_ids is None):
        raise ValueError("pass tenant_tables and tenant_ids together")
    if tenant_tables is not None and not batch_size:
        raise ValueError(
            "tenant grids need batch_size: tenant routing is a batched-"
            "data-plane feature (DESIGN.md §15)")
    if condition_edits is not None and any(
            getattr(e, "param_overrides", None) for e in condition_edits):
        raise ValueError(
            "param_edit pins scenario payload leaves; use it with "
            "run_scenario_grid (run_grid evaluates plain streams with "
            "no scenario events)")
    budgets, seeds, flat_b, flat_s = _flatten_grid(budgets, seeds)
    C, S = len(budgets), len(seeds)
    n_chunks = _n_chunks(C * S, chunk_size)
    device = _stack_device(devices, device)
    shared = not isinstance(env, (list, tuple)) and not shuffle
    xs, rmat, cmat, env0 = evaluate.build_run_streams(
        cfg, env, seeds[:1] if shared else seeds, shuffle, device=device)
    if shared:
        streams = tuple(a.expand((C * S,) + a.shape[1:])
                        for a in (xs, rmat, cmat))
    else:
        streams = tuple(_tile(a, C) for a in (xs, rmat, cmat))
    states = evaluate.make_states(
        cfg, env0, flat_b, flat_s, priors=priors,
        n_eff=_per_condition_axis(n_eff, C, S), pacer_enabled=pacer_enabled,
        hyper=_expand_hyper(hyper, C, S),
        tenants=_expand_tenants(tenant_tables, C, S), device=device)
    if condition_edits is not None:
        states = _apply_condition_edits(states, condition_edits, S)
    if tenant_ids is not None:
        body = evaluate.stream_body_tenants(cfg, batch_size)
        streams = streams + (_grid_tenant_ids(tenant_ids, C, S, device),)
    else:
        body = evaluate.stream_body(cfg, batch_size)
    finals, traces = _run_stack(body, states, streams, n_chunks, devices,
                                device)
    res = _grid_result(budgets, seeds, traces)
    if return_states:
        return res, finals
    return res


# ---------------------------------------------------------------------------
# Scenario grids: (budget x seed) over one ScenarioSpec
# ---------------------------------------------------------------------------


def _merged_scenario_params(base, condition_edits, C: int, S: int):
    """Fold per-condition ``param_edit`` overrides (riding
    ``condition_edits``) into the base ``ScenarioParams``: any name
    touched by an override becomes a (C,)-stacked leaf whose untouched
    conditions fall back to the base leaf."""
    over = [dict(getattr(e, "param_overrides", {}) or {})
            for e in (condition_edits or ())]
    names = set().union(*over) if over else set()
    if not names:
        return base
    base_vals = {n: scenario_lib._host(base.get(n)) for n in base.names}
    merged = dict(base_vals)
    for name in sorted(names):
        stacked = []
        for c in range(C):
            if name in over[c]:
                stacked.append(np.asarray(scenario_lib._host(over[c][name]),
                                          np.float32))
                continue
            if name not in base_vals:
                raise ValueError(
                    f"param_edit sets {name!r} for some conditions but "
                    f"condition {c} has no override and scenario_params "
                    "provides no base value")
            v = base_vals[name]
            if v.ndim and v.shape[0] == C * S and C != C * S:
                raise ValueError(
                    f"param_edit overrides {name!r} but the base leaf is "
                    f"a pre-flattened ({C * S},) stack: a per-condition "
                    "override of a per-element leaf is ambiguous — pass "
                    f"a (C,) = ({C},) stacked base leaf instead")
            # A base leaf already stacked per condition contributes its
            # c-th entry; a shared leaf contributes itself.
            stacked.append(v[c] if (v.ndim and v.shape[0] == C) else v)
        merged[name] = np.stack(stacked)
    return scenario_lib.ScenarioParams(**merged)


def _expand_params(params, C: int, S: int, device):
    """Param leaves on the flattened condition-major (C*S,) axis:
    (C,)-leading leaves repeat each entry S times (like budgets),
    (C*S,)-leading leaves pass through, the rest broadcast to every
    element (``scenario.broadcast_params``)."""
    def ex(leaf):
        if leaf.ndim and leaf.shape[0] == C and C != C * S:
            return leaf.repeat_interleave(S, dim=0)
        return leaf

    stacked = scenario_lib.ScenarioParams(
        **{n: ex(params.get(n)) for n in params.names})
    return scenario_lib.broadcast_params(stacked, C * S, device)


def _normalize_timelines(timelines, C: int, S: int):
    """One shared Timeline, a (C,) per-condition sequence, or a (C*S,)
    per-element sequence -> (tuple of timelines, per_condition flag)."""
    if isinstance(timelines, scenario_lib.Timeline):
        return (timelines,) * C, True
    tls = tuple(timelines)
    for tl in tls:
        if not isinstance(tl, scenario_lib.Timeline):
            raise ValueError(f"timelines entries must be Timeline, got "
                             f"{type(tl).__name__}")
    if len(tls) == C:
        return tls, True
    if len(tls) == C * S:
        return tls, False
    raise ValueError(
        f"timelines must be one Timeline, ({C},) per condition or "
        f"({C * S},) per element; got {len(tls)}")


def _timeline_grid_operands(cfg, spec, env, tls, per_cond, seeds, flat_s,
                            params, batch_size, device):
    """Host-side lowering of a timeline axis: per-timeline retimed specs
    (validated), padded stream stacks along the flat grid axis
    (``scenario.build_timeline_streams``, one seed group per timeline),
    and the (N, E) event times / (N,) horizons as host integers."""
    t_max, E = spec.horizon, len(spec.events)
    rspecs = [scenario_lib.retime(spec, tl) for tl in tls]
    for r_ in rspecs:
        scenario_lib.validate_timeline_alignment(r_, batch_size, t_max)
    if per_cond:
        seed_groups = [tuple(int(s) for s in seeds)] * len(rspecs)
        rep = len(seeds)
    else:
        seed_groups = [(int(flat_s[i]),) for i in range(len(rspecs))]
        rep = 1
    streams = scenario_lib.build_timeline_streams(
        cfg, spec, env, rspecs, seed_groups, params=params, pad_to=t_max,
        device=device)
    ev = np.repeat(
        np.asarray([[e.t for e in r_.events] for r_ in rspecs],
                   np.int64).reshape(len(rspecs), E), rep, axis=0)
    hz = np.repeat(np.asarray([r_.horizon for r_ in rspecs], np.int64), rep)
    return rspecs, streams, ev, hz


def run_scenario_grid(
    cfg: RouterConfig,
    spec: "scenario_lib.ScenarioSpec",
    env: Environment,
    budgets: Sequence[float],
    seeds: Sequence[int] = tuple(range(20)),
    *,
    priors: Optional[Sequence[ArmPrior | None]] = None,
    n_eff: float | Sequence[float] = 0.0,
    pacer_enabled: bool = True,
    batch_size: Optional[int] = None,
    devices=None,
    return_states: bool = False,
    hyper: Optional[HyperParams] = None,
    condition_edits: Optional[Sequence[Optional[Callable]]] = None,
    scenario_params: Optional["scenario_lib.ScenarioParams"] = None,
    chunk_size: Optional[int] = None,
    timelines=None,
    device=None,
):
    """One multi-event scenario across a budget grid as one state stack:
    per condition the same as ``evaluate.run_scenario`` at that budget
    (same streams, same edits, same segment bounds), bit for bit.

    A ``BudgetChange`` event overrides the stacked initial ceiling from
    its boundary onward in every condition: the grid axis is the initial
    operating point.

    ``scenario_params`` resolves ``Param`` payload references (DESIGN.md
    §10): leaves may be shared, ``(C,)`` stacks aligned with ``budgets``
    (a payload condition axis: a whole spec family in one grid), or
    pre-flattened ``(C*S,)`` stacks. Per-condition ``param_edit`` entries
    on ``condition_edits`` fold into the same stacked leaves.

    ``timelines`` puts the spec's event times and effective horizon on the
    condition axis (DESIGN.md §12): one shared ``Timeline``, a ``(C,)``
    per-condition sequence or a ``(C*S,)`` per-element sequence, run
    through the masked timeline runner; every element equals
    ``evaluate.run_scenario`` on its retimed spec, and every timeline
    assignment shares one cached runner (the Monte Carlo substrate).
    Per-condition timelines record ``cond_bounds`` / ``horizons`` so that
    ``condition(i)`` trims the padding.

    ``chunk_size``, ``devices`` and ``device`` as in ``run_grid``.
    """
    budgets, seeds = _check_grid_args(budgets, seeds, condition_edits)
    budgets, seeds, flat_b, flat_s = _flatten_grid(budgets, seeds)
    C, S = len(budgets), len(seeds)
    n_chunks = _n_chunks(C * S, chunk_size)
    device = _stack_device(devices, device)
    params = _merged_scenario_params(
        scenario_params if scenario_params is not None
        else scenario_lib.ScenarioParams(), condition_edits, C, S)
    params = scenario_lib.resolve_params(spec, params)
    full = params.updated(**scenario_lib.auto_param_values(spec))
    states = evaluate.make_states(
        cfg, env, flat_b, flat_s, priors=priors,
        n_eff=_per_condition_axis(n_eff, C, S), pacer_enabled=pacer_enabled,
        active_arms=spec.init_active, hyper=_expand_hyper(hyper, C, S),
        device=device)
    if condition_edits is not None:
        states = _apply_condition_edits(states, condition_edits, S)
    pstack = _expand_params(full, C, S, device)
    cond_bounds = horizons = bounds = None
    if timelines is None:
        xs, rmat, cmat = scenario_lib.build_streams(
            cfg, spec, env, seeds, params=params, device=device)
        operands = tuple(_tile(a, C) for a in (xs, rmat, cmat)) + (pstack,)
        body = scenario_lib.compiled_runner(cfg, spec, env, batch_size)
        bounds = spec.bounds
    else:
        tls, per_cond = _normalize_timelines(timelines, C, S)
        rspecs, streams, ev, hz = _timeline_grid_operands(
            cfg, spec, env, tls, per_cond, seeds, flat_s, params,
            batch_size, device)
        operands = tuple(streams) + (pstack, ev, hz)
        body = scenario_lib.compiled_timeline_runner(cfg, spec, env,
                                                     batch_size)
        if per_cond:
            cond_bounds = tuple(r_.bounds for r_ in rspecs)
            horizons = tuple(r_.horizon for r_ in rspecs)
    finals, traces = _run_stack(body, states, operands, n_chunks, devices,
                                device)
    cond_params = {
        n: scenario_lib._host(params.get(n)) for n in params.names
        if params.get(n).ndim and params.get(n).shape[0] == C
    } or None
    res = _grid_result(budgets, seeds, traces, bounds=bounds,
                       params=cond_params, cond_bounds=cond_bounds,
                       horizons=horizons)
    if return_states:
        return res, finals
    return res

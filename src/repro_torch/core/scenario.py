"""Declarative scenario engine: timed control-plane events lowered onto
segmented runs of the router over a stack of per-seed states.

The paper's headline experiments (§4.3-§4.5, Appendix G) are all
*scenarios*: a base environment plus a timeline of control-plane events —
provider repricings, silent quality regressions, hot-swap onboardings,
retirements, budget retargets, traffic-mix drift. A scenario is data:

    spec = ScenarioSpec(
        horizon=3 * 608,
        events=(
            PriceChange(t=608, arm=2, multiplier=1 / 56),
            PriceChange(t=1216, arm=2, multiplier=1.0),
        ),
        replay=((2, 0),),          # phase 3 reuses phase 1 prompts
    )
    res = evaluate.run_scenario(cfg, spec, env, budget, seeds=range(20))

The spec lowers into

  (a) a per-seed stream tensor stack (S, T, ...) built on the host in
      numpy: segment boundaries are the sorted event times; each
      segment's (contexts, rewards, costs) slice is gathered from the base
      ``Environment`` transformed by the stream events in force (price
      multipliers, quality targets, traffic mix); and

  (b) state-edit functions over the whole (S,) stack, applied between
      segments: ``registry.add_arm`` / ``delete_arm`` / ``set_price``,
      ``pacer.set_budget`` and ``types.with_hyperparams``.

Each segment is one ``router.run_stream_batched`` call: the seed axis is
the state's leading S axis, so there is no per-seed loop, and with the
``fused`` backend every block runs through the ``linucb_step`` kernel.
The runners are cached per (statics, spec structure, environment, block
size) as built closures; there is no compiled program to reuse.

Event semantics (DESIGN.md §6):

  * an event at step ``t`` takes effect *before* request ``t`` is routed;
  * events sharing a ``t`` apply in listed order at that boundary;
  * stream events (PriceChange, QualityShift, TrafficMixShift) are
    *absolute* w.r.t. the base environment — ``multiplier=1.0`` restores
    the base rate card, ``target_mean=None`` restores base quality;
  * state events (AddArm, DeleteArm, BudgetChange, HyperShift, and
    PriceChange with ``recalibrate=True``) edit ``RouterState`` between
    segments. A PriceChange without ``recalibrate`` is *silent*: realised
    costs drift but the router's rate card is not updated.

Payloads as data (DESIGN.md §10): every event payload field may also be a
``Param("name")`` reference, resolved at run time from a
``ScenarioParams`` of named f32 tensors with one value per state (or one
shared by all). Concrete price multipliers and budgets are lifted onto
``__auto{i}`` leaves, so a concrete spec and its ``Param`` twin run the
same float operations and give the same bits. Event times, arm slots and
traffic-mix weights stay structural.

Timelines as data (DESIGN.md §12): ``Timeline`` moves the event times and
the effective horizon; the masked runner steps over the padded horizon,
fires each state edit on the rows whose event time it reaches and keeps
padding steps from changing the state, bit for bit the concrete retimed
spec's run on live steps. Event times and horizons are host numpy here,
so every mask is known on the host before the step that needs it.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import pacer as pacer_lib
from repro_torch.core import registry, router, simulator
from repro_torch.core import types as types_lib
from repro_torch.core.types import (
    HYPER_FIELDS, ArmPrior, HyperParams, RouterConfig, RouterState,
    resolve_device,
)

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Parameterized payloads: Param references + ScenarioParams
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Param:
    """A named reference into ``ScenarioParams``, usable wherever an
    event takes a float/tuple payload (``PriceChange.multiplier``,
    ``QualityShift.target_mean``, ``BudgetChange.budget``, ``HyperShift``
    fields, ``AddArm.n_eff``/``bias_reward``/``prior``,
    ``TrafficMixShift.weights``). The spec's structure is fixed and the
    value is resolved at run time (DESIGN.md §10)."""

    name: str

    def __post_init__(self):
        if not (isinstance(self.name, str) and self.name):
            raise ValueError(f"Param name must be a non-empty str: "
                             f"{self.name!r}")


def _f32(v) -> Tensor:
    """A payload value as an f32 tensor: tensors keep their device,
    everything else rounds to f32 once, through numpy, on the CPU."""
    if isinstance(v, Tensor):
        return v.detach().to(torch.float32)
    return torch.from_numpy(np.array(v, np.float32))


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, Tensor) else np.asarray(v)


class ScenarioParams:
    """Named payload leaves for ``Param`` references: f32 tensors, scalars
    for float payloads, ``(F,)`` vectors for traffic-mix weights, ``(d,
    d+1)`` packed priors (``pack_prior``). A leading axis equal to the
    number of states is taken as one value per state by
    ``broadcast_params``; anything else is shared by every state."""

    __slots__ = ("_values",)

    def __init__(self, **values):
        vals = {}
        for k in sorted(values):
            v = values[k]
            if isinstance(v, ArmPrior):
                v = pack_prior(v)
            vals[k] = _f32(v)
        object.__setattr__(self, "_values", vals)

    @classmethod
    def _from_leaves(cls, names, leaves) -> "ScenarioParams":
        obj = object.__new__(cls)
        object.__setattr__(obj, "_values", dict(zip(names, leaves)))
        return obj

    @property
    def names(self):
        return tuple(self._values)

    def get(self, name: str) -> Tensor:
        try:
            return self._values[name]
        except KeyError:
            raise KeyError(
                f"scenario param {name!r} not provided; have "
                f"{sorted(self._values)}") from None

    def updated(self, **overrides) -> "ScenarioParams":
        merged = dict(self._values)
        merged.update(ScenarioParams(**overrides)._values)
        return ScenarioParams._from_leaves(
            tuple(sorted(merged)), tuple(merged[k] for k in sorted(merged)))

    def __repr__(self):
        inner = ", ".join(f"{k}={tuple(v.shape)}" for k, v in
                          self._values.items())
        return f"ScenarioParams({inner})"


def pack_prior(prior: ArmPrior) -> Tensor:
    """An ``ArmPrior`` as one ``(d, d+1)`` f32 leaf ``[A_off | b_off]``
    so warm-start payloads can ride ``ScenarioParams``."""
    A, b = _f32(prior.A_off), _f32(prior.b_off)
    return torch.cat([A, b[..., None].to(A.device)], dim=-1)


def _unpack_prior(leaf: Tensor, d: int) -> ArmPrior:
    """A ``(..., d, d+1)`` leaf back to an ``ArmPrior`` (one per state
    when the leaf is stacked)."""
    assert tuple(leaf.shape[-2:]) == (d, d + 1), (tuple(leaf.shape), d)
    return ArmPrior(A_off=leaf[..., :d], b_off=leaf[..., d])


def _resolve(v, params: ScenarioParams):
    """A payload value: a ``Param`` resolves from the params leaf;
    anything else passes through unchanged."""
    return params.get(v.name) if isinstance(v, Param) else v


def resolve_params(
    spec: "ScenarioSpec", params: Optional[ScenarioParams]
) -> ScenarioParams:
    """Validate ``params`` against the spec's ``Param`` references:
    every referenced name must be provided and (for typo safety) every
    provided name must be referenced."""
    params = params if params is not None else ScenarioParams()
    reserved = [n for n in params.names if n.startswith(_AUTO_PREFIX)]
    if reserved:
        raise ValueError(
            f"param names {reserved} use the reserved {_AUTO_PREFIX!r} "
            "prefix (auto-lifted concrete payloads)")
    want, have = set(spec.param_names), set(params.names)
    if want - have:
        raise ValueError(
            f"ScenarioSpec references params {sorted(want - have)} but "
            f"scenario_params provides only {sorted(have)}")
    if have - want:
        raise ValueError(
            f"scenario_params provides {sorted(have - want)} but the "
            f"spec only references {sorted(want)}")
    return params


def broadcast_params(params: ScenarioParams, n: int,
                     device=None) -> ScenarioParams:
    """Leaves -> per-state ``(n,) + payload_shape`` f32 tensors on
    ``device`` (default the card): a leaf whose leading axis is already
    ``n`` is taken as stacked; everything else broadcasts."""
    device = resolve_device(device)

    def bc(leaf: Tensor) -> Tensor:
        if not (leaf.ndim and leaf.shape[0] == n):
            leaf = leaf.expand((n,) + tuple(leaf.shape))
        return leaf.to(device=device, dtype=torch.float32).contiguous()

    vals = {k: bc(v) for k, v in params._values.items()}
    return ScenarioParams._from_leaves(tuple(vals), tuple(vals.values()))


# ---------------------------------------------------------------------------
# Typed control-plane events
# ---------------------------------------------------------------------------


Payload = Union[float, Param]


@dataclasses.dataclass(frozen=True)
class PriceChange:
    """Provider reprices ``arm`` to ``multiplier`` x the BASE rate card.

    Realised per-request costs in the stream scale from step ``t`` onward.
    With ``recalibrate=True`` the router's price / c_tilde are also updated
    at the boundary (the paper's oracle-recalibration baseline); default is
    a silent drift the router only sees through realised costs. A
    ``Param`` multiplier is never treated as the 1.0 restore — restoring
    is structural, declare it with a concrete 1.0.
    """

    t: int
    arm: int
    multiplier: Payload
    recalibrate: bool = False


@dataclasses.dataclass(frozen=True)
class QualityShift:
    """Silent quality regression (Appendix G): from step ``t``, ``arm``'s
    rewards are mean-shifted to ``target_mean`` (None restores base)."""

    t: int
    arm: int
    target_mean: Optional[Payload]


@dataclasses.dataclass(frozen=True)
class AddArm:
    """Hot-swap ``slot`` into the portfolio at step ``t`` (§3.6/§4.5).

    The base environment must already carry the arm's reward/cost columns
    (slot < env.k); before this event the slot is simply inactive. Prices
    default to the base rate card times any price multiplier in force.
    ``prior``/``n_eff``/``bias_reward`` follow ``registry.add_arm``; each
    may be a ``Param`` (a ``Param`` prior resolves from a ``(d, d+1)``
    ``pack_prior`` leaf; a ``Param`` n_eff always takes the heuristic- or
    offline-prior branch, so it must be > 0).
    """

    t: int
    slot: int
    n_eff: Optional[Payload] = None
    bias_reward: Payload = 0.5
    forced_exploration: bool = True
    prior: Optional[Union[ArmPrior, Param]] = None


@dataclasses.dataclass(frozen=True)
class DeleteArm:
    """Retire ``slot`` at step ``t``; cancels its forced exploration."""

    t: int
    slot: int


@dataclasses.dataclass(frozen=True)
class BudgetChange:
    """Operator retargets the pacer ceiling to ``budget`` $/req at ``t``."""

    t: int
    budget: Payload


@dataclasses.dataclass(frozen=True)
class HyperShift:
    """Operator retunes the router's live hyper-parameters at step ``t``
    (DESIGN.md §9): any subset of ``HyperParams`` fields; ``None`` leaves
    a field unchanged, and any field may be a ``Param``."""

    t: int
    alpha: Optional[Payload] = None
    gamma: Optional[Payload] = None
    lambda_c: Optional[Payload] = None
    lambda0: Optional[Payload] = None
    eta: Optional[Payload] = None
    alpha_ema: Optional[Payload] = None
    lambda_bar: Optional[Payload] = None
    v_max: Optional[Payload] = None
    c_floor: Optional[Payload] = None
    c_ceil: Optional[Payload] = None
    tiebreak_scale: Optional[Payload] = None

    def overrides(self) -> dict:
        ov = {n: getattr(self, n) for n in HYPER_FIELDS
              if getattr(self, n) is not None}
        # Concrete values fail here; Param values pass unchecked (gamma is
        # clamped at runtime, linucb.forgetting_factor).
        HyperParams.validate_fields(
            **{k: v for k, v in ov.items() if not isinstance(v, Param)})
        return ov


@dataclasses.dataclass(frozen=True)
class TrafficMixShift:
    """From step ``t``, prompts are drawn with per-family ``weights``
    (proportional sampling over ``simulator.FAMILIES``; None restores the
    uniform-over-prompts draw). A ``Param`` names an ``(F,)`` leaf,
    resolved on the host when the streams are built: the weights change
    which prompts are drawn."""

    t: int
    weights: Optional[Union[Tuple[float, ...], Param]]


@dataclasses.dataclass(frozen=True)
class TenantBudgetChange:
    """Operator retargets ONE tenant's ceiling at step ``t`` (DESIGN.md
    §15). Tenant tables are not ported yet: a spec may hold this event,
    but running it raises ``NotImplementedError``."""

    t: int
    tenant: int
    budget: Payload


@dataclasses.dataclass(frozen=True)
class TenantMixShift:
    """From step ``t``, requests are tagged with tenants drawn with the
    given ``(T,)`` weights (DESIGN.md §15). Tenant streams are not ported
    yet: running a spec that holds this event raises
    ``NotImplementedError``."""

    t: int
    weights: Optional[Tuple[float, ...]]


Event = Union[
    PriceChange, QualityShift, AddArm, DeleteArm, BudgetChange,
    TrafficMixShift, HyperShift, TenantBudgetChange, TenantMixShift,
]

_STATE_EVENTS = (PriceChange, AddArm, DeleteArm, BudgetChange, HyperShift,
                 TenantBudgetChange)
_TENANT_EVENTS = (TenantBudgetChange, TenantMixShift)


def _no_tenant_events(spec: "ScenarioSpec") -> None:
    bad = [type(e).__name__ for e in spec.events
           if isinstance(e, _TENANT_EVENTS)]
    if bad:
        raise NotImplementedError(
            f"{sorted(set(bad))}: tenant scenarios are not ported yet")


# ---------------------------------------------------------------------------
# ScenarioSpec
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """A scenario as data: a base-environment stream of ``horizon`` steps
    with typed events pinned to step indices.

    Stream-generation knobs (host-side numpy, the hand-rolled benchmarks'
    draws):

      * ``stream_seed_base`` — per-seed generator ``default_rng(base + s)``
        shared *sequentially* across segments;
      * ``segment_seeds`` — optional per-segment bases; segment ``j`` then
        draws from a fresh ``default_rng(segment_seeds[j] + s)``;
      * ``replay`` — ``(j, i)`` pairs: segment ``j`` reuses segment
        ``i``'s prompt indices and consumes no generator draws;
      * ``mode`` — "iid" (sample with replacement) or "permutation" (a
        seed-specific permutation of the split);
      * ``init_active`` — initially active arm-slot prefix (default: all
        env arms); slots awaiting an ``AddArm`` start inactive.
    """

    horizon: int
    events: Tuple[Event, ...] = ()
    stream_seed_base: int = 1000
    segment_seeds: Optional[Tuple[int, ...]] = None
    replay: Tuple[Tuple[int, int], ...] = ()
    mode: str = "iid"
    init_active: Optional[int] = None

    def __post_init__(self):
        assert self.horizon > 0, self.horizon
        assert self.mode in ("iid", "permutation"), self.mode
        for e in self.events:
            assert isinstance(e, Event.__args__), type(e)
            assert 0 <= e.t < self.horizon, (e, self.horizon)
            # permutation mode draws uniform permutations per segment; a
            # mix shift would be silently ignored there
            assert not (self.mode == "permutation"
                        and isinstance(e, TrafficMixShift)), (
                "TrafficMixShift requires mode='iid'")
        n_seg = len(self.bounds) - 1
        if self.segment_seeds is not None:
            assert len(self.segment_seeds) == n_seg, (
                len(self.segment_seeds), n_seg)
        for j, i in self.replay:
            assert 0 <= i < j < n_seg, (i, j, n_seg)

    @property
    def bounds(self) -> Tuple[int, ...]:
        """Segment boundaries: (0, sorted interior event times, horizon)."""
        ts = sorted({e.t for e in self.events if 0 < e.t < self.horizon})
        return (0, *ts, self.horizon)

    @property
    def segments(self) -> Tuple[Tuple[int, int], ...]:
        b = self.bounds
        return tuple(zip(b[:-1], b[1:]))

    @property
    def param_names(self) -> Tuple[str, ...]:
        """Sorted names of every ``Param`` referenced by the timeline."""
        names = set()
        for e in self.events:
            for f in dataclasses.fields(e):
                v = getattr(e, f.name)
                if isinstance(v, Param):
                    names.add(v.name)
        return tuple(sorted(names))


def _hashable(obj):
    """Nested hashable signature; arrays and tensors become (shape, dtype,
    bytes)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,) + tuple(
            _hashable(getattr(obj, f.name)) for f in dataclasses.fields(obj)
        )
    if isinstance(obj, (Tensor, np.ndarray)):
        a = _host(obj)
        return (a.shape, str(a.dtype), a.tobytes())
    if isinstance(obj, (tuple, list)):
        return tuple(_hashable(x) for x in obj)
    if isinstance(obj, dict):
        return tuple(sorted((k, _hashable(v)) for k, v in obj.items()))
    return obj


def spec_key(spec: ScenarioSpec):
    return _hashable(spec)


# ---------------------------------------------------------------------------
# Auto-lifted payloads: concrete values as ScenarioParams operands
# ---------------------------------------------------------------------------

# Concrete BudgetChange / PriceChange payloads are lifted onto synthetic
# ScenarioParams leaves (one per event index), so the concrete and Param
# lowerings run the same float operations on the same f32 operands.
_AUTO_PREFIX = "__auto"


def _auto_name(i: int) -> str:
    return f"{_AUTO_PREFIX}{i}"


def auto_param_values(spec: ScenarioSpec) -> Dict[str, np.ndarray]:
    """Synthetic param leaves for the spec's concrete operand payloads:
    every concrete ``PriceChange.multiplier`` and every concrete
    ``BudgetChange.budget``. Values are time-independent, so the same
    scalars serve every retimed ``Timeline`` of the spec."""
    out: Dict[str, np.ndarray] = {}
    for i, e in enumerate(spec.events):
        if isinstance(e, PriceChange) and not isinstance(e.multiplier, Param):
            out[_auto_name(i)] = np.float32(e.multiplier)
        elif (isinstance(e, (BudgetChange, TenantBudgetChange))
                and not isinstance(e.budget, Param)):
            out[_auto_name(i)] = np.float32(e.budget)
    return out


def _budget_ref(spec: ScenarioSpec, i: int) -> Param:
    e = spec.events[i]
    return e.budget if isinstance(e.budget, Param) else Param(_auto_name(i))


def _mult_ref(spec: ScenarioSpec, i: int) -> Param:
    e = spec.events[i]
    return (e.multiplier if isinstance(e.multiplier, Param)
            else Param(_auto_name(i)))


def _inforce_price_ref(spec: ScenarioSpec, i: int) -> Optional[Param]:
    """The payload reference for the price multiplier in force on
    ``spec.events[i].slot`` at that AddArm's boundary: the last same-arm
    ``PriceChange`` with ``t <= events[i].t`` (listed order breaks ties,
    matching ``_segment_mods``). None when no PriceChange touched the
    slot (base price exactly)."""
    e = spec.events[i]
    win = None
    for j, ev in enumerate(spec.events):
        if (isinstance(ev, PriceChange) and ev.arm == e.slot
                and ev.t <= e.t):
            if win is None or (ev.t, j) >= win[:2]:
                win = (ev.t, j)
    return None if win is None else _mult_ref(spec, win[1])


# Sentinel replacing operand / stream-data payload values in runner cache
# keys: a concrete silent price or quality value is baked into the stream
# tensors, and a concrete budget / recalibrate multiplier is an auto-lifted
# operand, so specs differing only in those values share one runner.
_LIFTED = "<lifted>"


def _key_event(e: Event, mask_times: bool = False):
    t = 0 if mask_times else e.t
    if isinstance(e, PriceChange):
        m = e.multiplier
        if not isinstance(m, Param) and m != 1.0:
            m = _LIFTED   # concrete 1.0 restore stays structural
        return ("PriceChange", t, e.arm, _hashable(m), e.recalibrate)
    if isinstance(e, QualityShift):
        tm = e.target_mean
        if tm is not None and not isinstance(tm, Param):
            tm = _LIFTED  # concrete target: stream data (None restores)
        return ("QualityShift", t, e.arm, _hashable(tm))
    if isinstance(e, BudgetChange):
        b = e.budget if isinstance(e.budget, Param) else _LIFTED
        return ("BudgetChange", t, _hashable(b))
    if isinstance(e, TenantBudgetChange):
        b = e.budget if isinstance(e.budget, Param) else _LIFTED
        return ("TenantBudgetChange", t, e.tenant, _hashable(b))
    # AddArm / DeleteArm / HyperShift / TrafficMixShift payloads stay
    # structural (concrete values are closure constants or host-side).
    return (type(e).__name__, t) + tuple(
        _hashable(getattr(e, f.name))
        for f in dataclasses.fields(e) if f.name != "t")


def runner_spec_key(spec: ScenarioSpec, mask_times: bool = False):
    """The part of a spec that shapes a runner. Operand and stream-data
    payload values are masked (``_key_event``); with ``mask_times`` the
    event times and rng/stream knobs are masked too — the timeline
    runner's contract that event times, like payloads, are data (the
    horizon stays: it is the padded length T_max)."""
    if mask_times:
        return ("timeline", spec.horizon,
                tuple(_key_event(e, True) for e in spec.events))
    return ("concrete", spec.horizon,
            tuple(_key_event(e) for e in spec.events))


# ---------------------------------------------------------------------------
# Timeline: event times & horizon as data
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Timeline:
    """Retimed event steps (aligned with ``spec.events``, listed order)
    plus an optional effective horizon ``<= spec.horizon`` — the *data*
    half of a scenario's timing (DESIGN.md §12). ``retime(spec, tl)``
    gives the equivalent concrete spec."""

    event_ts: Tuple[int, ...]
    horizon: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(
            self, "event_ts", tuple(int(t) for t in self.event_ts))
        if self.horizon is not None:
            object.__setattr__(self, "horizon", int(self.horizon))


def retime(spec: ScenarioSpec, tl: Timeline) -> ScenarioSpec:
    """The concrete spec equivalent to running ``spec`` under ``tl``.
    Invalid timelines (times outside [0, horizon), rng-mode segment
    mismatches, Add/Delete reorderings) fail this spec's own
    validation."""
    if len(tl.event_ts) != len(spec.events):
        raise ValueError(
            f"Timeline has {len(tl.event_ts)} event times but the spec "
            f"has {len(spec.events)} events")
    h = spec.horizon if tl.horizon is None else tl.horizon
    if not 1 <= h <= spec.horizon:
        raise ValueError(
            f"Timeline horizon {h} must be in [1, spec.horizon="
            f"{spec.horizon}] (spec.horizon is the padded scan length)")
    events = tuple(dataclasses.replace(e, t=t)
                   for e, t in zip(spec.events, tl.event_ts))
    return dataclasses.replace(spec, horizon=h, events=events)


# ---------------------------------------------------------------------------
# Stream compilation (host-side numpy)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _SegmentMods:
    """Stream settings in force during one segment. Values may be
    ``Param`` references — those are skipped by the numpy baking and
    lowered to stream transforms instead (``_stream_tfs``)."""

    price_mults: Tuple[Tuple[int, Payload], ...]  # (arm, multiplier != 1)
    quality: Tuple[Tuple[int, Payload], ...]      # (arm, target_mean)
    mix: Optional[Union[Tuple[float, ...], Param]]  # family weights


def _segment_mods(spec: ScenarioSpec) -> Tuple[_SegmentMods, ...]:
    """Fold stream events into per-segment absolute settings."""
    price: Dict[int, Payload] = {}
    quality: Dict[int, Payload] = {}
    mix: Optional[Union[Tuple[float, ...], Param]] = None
    out = []
    for start, _ in spec.segments:
        for e in spec.events:
            if e.t != start:
                continue
            if isinstance(e, PriceChange):
                # A Param multiplier is never the 1.0 restore (restoring
                # is structural); it stays in force until a concrete 1.0.
                if e.multiplier == 1.0:
                    price.pop(e.arm, None)
                else:
                    price[e.arm] = e.multiplier
            elif isinstance(e, QualityShift):
                if e.target_mean is None:
                    quality.pop(e.arm, None)
                else:
                    quality[e.arm] = e.target_mean
            elif isinstance(e, TrafficMixShift):
                if e.weights is None or isinstance(e.weights, Param):
                    mix = e.weights
                else:
                    mix = tuple(e.weights)
        out.append(_SegmentMods(
            price_mults=tuple(sorted(price.items())),
            quality=tuple(sorted(quality.items())),
            mix=mix,
        ))
    return tuple(out)


def _transformed_env(env: simulator.Environment, mods: _SegmentMods):
    """Bake the segment's *concrete* stream settings into the env;
    ``Param`` payloads are left to the stream transforms."""
    e = env
    for arm, target in mods.quality:
        if not isinstance(target, Param):
            e = simulator.with_quality_shift(e, arm, target)
    for arm, mult in mods.price_mults:
        if not isinstance(mult, Param):
            e = simulator.with_price_multiplier(e, arm, mult)
    return e


def _quality_shift(col: Tensor, base_mean: np.float32,
                   target: Tensor) -> Tensor:
    """``simulator.with_quality_shift`` on an (S, L) reward column with a
    per-state f32 target (S,): one f32 subtract for the shift (the base
    env's numpy column mean is exact in f32), one subtract and a clip per
    entry — the numpy baking's operations, bit for bit."""
    shift = float(base_mean) - target
    return torch.clamp(col - shift[:, None], 0.0, 1.0)


def _stream_tfs(spec: ScenarioSpec, env: simulator.Environment):
    """Per-segment stream transforms for ``Param`` payloads:
    ``(xs, rmat, cmat, params) -> (xs, rmat, cmat)`` on the segment's
    (S, L, ...) slices (None when the segment has no parameterized
    stream settings). The math mirrors the numpy baking bit for bit, and
    elementwise ops commute with the prompt gather, so a concrete spec
    and a ``Param`` spec resolved to the same value give the same bits.
    The slices are views of the cached stream stack: the transforms
    write copies."""
    mods = _segment_mods(spec)
    out = []
    for m in mods:
        pmult = tuple((arm, p) for arm, p in m.price_mults
                      if isinstance(p, Param))
        qual = tuple((arm, t) for arm, t in m.quality
                     if isinstance(t, Param))
        if not pmult and not qual:
            out.append(None)
            continue
        # Absolute semantics: the shift targets the BASE env's arm mean
        # (numpy f32 accumulation, matching with_quality_shift).
        base_mean = {arm: env.rewards[:, arm].mean() for arm, _ in qual}

        def tf(xs, rmat, cmat, params, _p=pmult, _q=qual, _bm=base_mean):
            rmat, cmat = rmat.clone(), cmat.clone()
            for arm, t in _q:
                rmat[:, :, arm] = _quality_shift(
                    rmat[:, :, arm], _bm[arm], params.get(t.name))
            for arm, p in _p:
                cmat[:, :, arm] = cmat[:, :, arm] * params.get(p.name)[:, None]
            return xs, rmat, cmat

        out.append(tf)
    return tuple(out)


def _host_mix_values(
    spec: ScenarioSpec, params: Optional[ScenarioParams]
) -> Dict[str, np.ndarray]:
    """Resolve ``TrafficMixShift`` ``Param`` weights to concrete host
    vectors. Mix weights change which prompt indices are drawn, so they
    must be host-concrete at stream-build time and cannot be stacked."""
    names = sorted({m.mix.name for m in _segment_mods(spec)
                    if isinstance(m.mix, Param)})
    out = {}
    for nm in names:
        if params is None or nm not in params.names:
            raise ValueError(
                f"TrafficMixShift references param {nm!r}; pass "
                "scenario_params providing it")
        v = _host(params.get(nm))
        if v.ndim != 1:
            raise ValueError(
                f"traffic-mix param {nm!r} must be one (F,) weight "
                f"vector, got shape {v.shape}: mix weights change which "
                "prompts are drawn (structural), so they cannot stack "
                "on a grid's condition axis")
        out[nm] = v
    return out


def compile_indices(
    spec: ScenarioSpec, env: simulator.Environment, seed: int,
    mix_values: Optional[Dict[str, np.ndarray]] = None,
) -> Tuple[np.ndarray, ...]:
    """Per-segment prompt indices for one seed.

    A shared ``default_rng(stream_seed_base + seed)`` consumed
    sequentially across segments (or fresh per-segment generators when
    ``segment_seeds`` is set); replayed segments reuse earlier indices and
    consume no draws. ``mix_values`` supplies host-resolved weight vectors
    for parameterized ``TrafficMixShift`` events.
    """
    mods = _segment_mods(spec)
    replay = dict(spec.replay)
    rng = np.random.default_rng(spec.stream_seed_base + int(seed))
    idxs = []
    for j, (a, b) in enumerate(spec.segments):
        n, L = env.n, b - a
        if j in replay:
            src = idxs[replay[j]]
            assert len(src) == L, (
                f"replay segment {j} (len {L}) != source "
                f"{replay[j]} (len {len(src)})")
            idxs.append(src)
            continue
        r = (np.random.default_rng(spec.segment_seeds[j] + int(seed))
             if spec.segment_seeds is not None else rng)
        if spec.mode == "permutation":
            assert L <= n, (L, n)
            idx = r.permutation(n)[:L]
        elif mods[j].mix is not None:
            mix = mods[j].mix
            if isinstance(mix, Param):
                assert mix_values is not None and mix.name in mix_values, (
                    f"unresolved mix param {mix.name!r}")
                mix = mix_values[mix.name]
            w = np.asarray(mix, np.float64)
            assert env.families.max() < len(w), (env.families.max(), len(w))
            p = w[env.families]
            idx = r.choice(n, size=L, p=p / p.sum())
        else:
            idx = r.integers(0, n, size=L)
        idxs.append(idx)
    return tuple(idxs)


def _validate_state_events(spec: ScenarioSpec, k: int) -> None:
    """Walk the timeline tracking the active set: AddArm must target an
    inactive slot (an active arm's statistics would silently reset) and
    DeleteArm an active one. Delete-then-re-add of a slot is fine."""
    n0 = k if spec.init_active is None else spec.init_active
    assert n0 <= k, (n0, k)
    active = set(range(n0))
    for e in sorted(spec.events, key=lambda e: e.t):  # stable within a t
        if isinstance(e, AddArm):
            assert e.slot < k, (
                f"AddArm slot {e.slot} has no environment columns (k={k})")
            assert e.slot not in active, (
                f"AddArm at t={e.t}: slot {e.slot} is already active "
                "(set init_active, or DeleteArm it first)")
            active.add(e.slot)
        elif isinstance(e, DeleteArm):
            assert e.slot in active, (
                f"DeleteArm at t={e.t}: slot {e.slot} is not active")
            active.discard(e.slot)


_STREAM_CACHE: collections.OrderedDict = collections.OrderedDict()
_STREAM_CACHE_MAX = 32


def _env_content_sig(env: simulator.Environment) -> bytes:
    h = hashlib.sha1()
    for a in (env.contexts, env.rewards, env.costs, env.families,
              env.prices_per_req, env.prices_per_1k):
        arr = np.ascontiguousarray(a)
        h.update(str((arr.shape, str(arr.dtype))).encode())
        h.update(arr.tobytes())
    return h.digest()


def _stack_to(device, xs, rs, cs):
    """Host (S, T, ...) arrays as f32 tensors on ``device``."""
    return tuple(torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                 device=device) for a in (xs, rs, cs))


def build_streams(
    cfg: RouterConfig,
    spec: ScenarioSpec,
    env: simulator.Environment,
    seeds: Sequence[int],
    params: Optional[ScenarioParams] = None,
    pad_to: Optional[int] = None,
    device=None,
):
    """Lower the spec to stacked (S, T, d) / (S, T, max_arms) f32 tensors
    on ``device`` (default the card).

    Concrete stream payloads are baked in; ``Param`` price/quality
    payloads are NOT — their segments gather base-env values and the
    stream transforms (``_stream_tfs``) apply the payload, so the stream
    stack (and this cache) is shared across every payload value.
    Parameterized traffic-mix weights are resolved here (they change the
    prompt draw itself).

    ``pad_to`` pads the time axis out to T_max steps (zero contexts /
    rewards, 1e9 costs) for the masked timeline runner.

    Cached (bounded LRU) on (spec, padding, seeds, env content, resolved
    mix weights, device): a cached stack is never handed to another
    device.
    """
    device = resolve_device(device)
    assert env.k <= cfg.max_arms, (env.k, cfg.max_arms)
    assert pad_to is None or pad_to >= spec.horizon, (pad_to, spec.horizon)
    _validate_state_events(spec, env.k)
    mix_values = _host_mix_values(spec, params)
    cache_key = (spec_key(spec), cfg.max_arms, pad_to,
                 tuple(int(s) for s in seeds), _env_content_sig(env),
                 tuple((nm, v.tobytes()) for nm, v in mix_values.items()),
                 str(device))

    def make():
        mods = _segment_mods(spec)
        envs, cache = [], {}
        for m in mods:
            if m not in cache:
                cache[m] = _transformed_env(env, m)
            envs.append(cache[m])
        pad = cfg.max_arms - env.k
        xs, rs, cs = [], [], []
        for s in seeds:
            idxs = compile_indices(spec, env, int(s), mix_values)
            x = np.concatenate(
                [envs[j].contexts[i] for j, i in enumerate(idxs)])
            r = np.concatenate(
                [envs[j].rewards[i] for j, i in enumerate(idxs)])
            c = np.concatenate(
                [envs[j].costs[i] for j, i in enumerate(idxs)])
            if pad:
                r = np.concatenate(
                    [r, np.zeros((len(r), pad), np.float32)], 1)
                c = np.concatenate(
                    [c, np.full((len(c), pad), 1e9, np.float32)], 1)
            extra = 0 if pad_to is None else pad_to - len(x)
            if extra:
                x = np.concatenate(
                    [x, np.zeros((extra,) + x.shape[1:], x.dtype)])
                r = np.concatenate(
                    [r, np.zeros((extra, r.shape[1]), np.float32)])
                c = np.concatenate(
                    [c, np.full((extra, c.shape[1]), 1e9, np.float32)])
            xs.append(x), rs.append(r), cs.append(c)
        return _stack_to(device, np.stack(xs), np.stack(rs), np.stack(cs))

    return lru_get(_STREAM_CACHE, cache_key, make, _STREAM_CACHE_MAX)


# ---------------------------------------------------------------------------
# Vectorized timeline stream stacks (the Monte Carlo rebuild)
# ---------------------------------------------------------------------------


def timeline_streams_vectorizable(spec: ScenarioSpec) -> bool:
    """Whether the cross-timeline fast path applies to ``spec``: each
    seed's prompt indices are drawn ONCE over the full padded horizon and
    reused by every timeline, which is exact only for a plain sequential
    ``integers`` stream from the shared per-seed generator (numpy's
    ``Generator.integers`` draws of lengths (L1, L2, ...) equal one draw
    of sum(L_j) split at the boundaries). Permutation mode, replayed
    segments, per-segment seeds and traffic-mix reweighting break that,
    so those specs take the per-timeline ``build_streams`` loop."""
    return (spec.mode == "iid" and not spec.replay
            and spec.segment_seeds is None
            and not any(isinstance(e, TrafficMixShift) for e in spec.events))


def build_timeline_streams(
    cfg: RouterConfig,
    spec: ScenarioSpec,
    env: simulator.Environment,
    rspecs: Sequence[ScenarioSpec],
    seed_groups: Sequence[Sequence[int]],
    params: Optional[ScenarioParams] = None,
    pad_to: Optional[int] = None,
    device=None,
):
    """Stacked (N_flat, T, ...) streams for a whole timeline axis.

    ``rspecs`` are the retimed specs of one base ``spec`` (one per
    timeline); ``seed_groups[i]`` lists the seeds whose rows follow
    timeline ``i`` (all of timeline 0's seeds, then timeline 1's, ...).
    Equal to concatenating per-timeline ``build_streams`` calls, bit for
    bit, with the host work batched across timelines: one rng draw per
    seed over the padded horizon, one transformed env per distinct
    ``_SegmentMods``, one fancy gather per (timeline, seed) block.
    Ineligible specs (``timeline_streams_vectorizable``) take the
    per-timeline loop — same contract, same cache.
    """
    device = resolve_device(device)
    N = len(rspecs)
    assert N == len(seed_groups) and N > 0, (N, len(seed_groups))
    T = pad_to if pad_to is not None else spec.horizon
    cache_key = (
        "timeline-stack", spec_key(spec), cfg.max_arms, pad_to,
        tuple((r_.horizon, tuple(e.t for e in r_.events)) for r_ in rspecs),
        tuple(tuple(int(s) for s in g) for g in seed_groups),
        _env_content_sig(env),
        tuple((nm, v.tobytes())
              for nm, v in _host_mix_values(spec, params).items()),
        str(device),
    )

    def make_fallback():
        parts = [build_streams(cfg, r_, env, tuple(g), params=params,
                               pad_to=pad_to, device=device)
                 for r_, g in zip(rspecs, seed_groups)]
        return tuple(torch.cat([p[j] for p in parts]) for j in range(3))

    if not timeline_streams_vectorizable(spec):
        return lru_get(_STREAM_CACHE, cache_key, make_fallback,
                       _STREAM_CACHE_MAX)

    def make():
        k, n, d = env.k, env.n, env.contexts.shape[1]
        assert k <= cfg.max_arms, (k, cfg.max_arms)
        pad = cfg.max_arms - k
        ctx = np.ascontiguousarray(env.contexts)
        heff = np.asarray([r_.horizon for r_ in rspecs], np.int64)
        assert int(heff.max()) <= T, (int(heff.max()), T)

        # One full-horizon index draw per seed, shared by every timeline.
        uniq = sorted({int(s) for g in seed_groups for s in g})
        idx_full = {
            s: np.random.default_rng(spec.stream_seed_base + s)
            .integers(0, n, size=T)
            for s in uniq
        }

        # One transformed env per distinct segment-settings value.
        variants: Dict[_SegmentMods, int] = {}
        rew_list, cost_list = [], []
        vt = np.zeros((N, T), np.int64)   # variant in force at each step
        for i, r_ in enumerate(rspecs):
            _validate_state_events(r_, k)
            vids = []
            for m in _segment_mods(r_):
                if m not in variants:
                    variants[m] = len(variants)
                    e = _transformed_env(env, m)
                    rew_list.append(np.asarray(e.rewards, np.float32))
                    cost_list.append(np.asarray(e.costs, np.float32))
                vids.append(variants[m])
            lens = [b - a for a, b in r_.segments]
            vt[i, :heff[i]] = np.repeat(vids, lens)
        REW = np.stack(rew_list)          # (V, n, k)
        COST = np.stack(cost_list)
        if pad:
            REW = np.concatenate(
                [REW, np.zeros((len(REW), n, pad), np.float32)], 2)
            COST = np.concatenate(
                [COST, np.full((len(COST), n, pad), 1e9, np.float32)], 2)

        total = sum(len(g) for g in seed_groups)
        xs = np.zeros((total, T, d), ctx.dtype)
        rs = np.zeros((total, T, cfg.max_arms), np.float32)
        cs = np.full((total, T, cfg.max_arms), 1e9, np.float32)
        row = 0
        for i in range(N):
            S = len(seed_groups[i])
            if not S:
                continue
            idx = np.stack([idx_full[int(s)] for s in seed_groups[i]])
            h = int(heff[i])
            # one gather per block; steps >= h stay at the padding
            # values (zero contexts/rewards, 1e9 costs)
            xs[row:row + S, :h] = ctx[idx[:, :h]]
            v = vt[i, None, :h]
            rs[row:row + S, :h] = REW[v, idx[:, :h]]
            cs[row:row + S, :h] = COST[v, idx[:, :h]]
            row += S
        return _stack_to(device, xs, rs, cs)

    return lru_get(_STREAM_CACHE, cache_key, make, _STREAM_CACHE_MAX)


# ---------------------------------------------------------------------------
# State-edit compilation: functions over the whole (S,) stack
# ---------------------------------------------------------------------------


def _f32_value(v) -> float:
    """A host price as the Python float of its f32 rounding: multiplied
    with an f32 tensor, it is exactly the f32 operand."""
    return float(np.float32(v))


def _add_arm_fn(cfg: RouterConfig, spec: ScenarioSpec, i: int,
                env: simulator.Environment):
    """Lower ``spec.events[i]`` (an AddArm) to an edit ``(state, params,
    m)`` taking the in-force price multiplier: None (base price) or an
    (S,) tensor — selected statically on the concrete path, folded from
    the event times on the timeline path."""
    e = spec.events[i]
    assert e.slot < env.k, (
        f"AddArm slot {e.slot} has no environment columns (k={env.k})")
    preq0 = _f32_value(env.prices_per_req[e.slot])
    p1k0 = _f32_value(env.prices_per_1k[e.slot])

    def add(st, ps, m):
        preq = preq0 if m is None else m * preq0
        p1k = p1k0 if m is None else m * p1k0
        prior = e.prior
        if isinstance(prior, Param):
            prior = _unpack_prior(ps.get(prior.name), cfg.d)
        return registry.add_arm(
            cfg, st, e.slot, preq, p1k,
            prior=prior, n_eff=_resolve(e.n_eff, ps),
            bias_reward=_resolve(e.bias_reward, ps),
            forced_exploration=e.forced_exploration)

    return add


def _one_edit(cfg: RouterConfig, spec: ScenarioSpec, i: int,
              env: simulator.Environment):
    """Lower state event ``spec.events[i]`` to a (RouterState,
    ScenarioParams) -> RouterState function over the whole stack (None
    for a silent PriceChange or an empty HyperShift). Every float payload
    — concrete or ``Param`` — resolves from the (S,) params leaves.
    Closures capture per-arm price scalars, never ``env`` itself."""
    e = spec.events[i]
    if isinstance(e, PriceChange):
        if not e.recalibrate:
            return None
        preq0 = _f32_value(env.prices_per_req[e.arm])
        p1k0 = _f32_value(env.prices_per_1k[e.arm])
        ref = _mult_ref(spec, i)

        def reprice(st, ps):
            m = ps.get(ref.name)
            return registry.set_price(cfg, st, e.arm, m * preq0, m * p1k0)

        return reprice
    if isinstance(e, AddArm):
        add = _add_arm_fn(cfg, spec, i, env)
        ref = _inforce_price_ref(spec, i)
        return lambda st, ps: add(
            st, ps, None if ref is None else ps.get(ref.name))
    if isinstance(e, DeleteArm):
        return lambda st, ps: registry.delete_arm(cfg, st, e.slot)
    if isinstance(e, BudgetChange):
        ref = _budget_ref(spec, i)
        return lambda st, ps: dataclasses.replace(
            st, pacer=pacer_lib.set_budget(st.pacer, ps.get(ref.name)))
    if isinstance(e, HyperShift):
        ov = e.overrides()
        if not ov:
            return None
        return lambda st, ps: types_lib.with_hyperparams(
            st, **{k: _resolve(v, ps) for k, v in ov.items()})
    return None


def _edit_fns(cfg: RouterConfig, spec: ScenarioSpec,
              env: simulator.Environment):
    """Per-segment composite edit applied before the segment's first
    request (None when the boundary carries no state events)."""
    out = []
    for start, _ in spec.segments:
        fns = []
        for i, e in enumerate(spec.events):  # listed order at a boundary
            if e.t != start or not isinstance(e, _STATE_EVENTS):
                continue
            f = _one_edit(cfg, spec, i, env)
            if f is not None:
                fns.append(f)
        if not fns:
            out.append(None)
            continue

        def composite(st, ps, _fns=tuple(fns)):
            for f in _fns:
                st = f(st, ps)
            return st

        out.append(composite)
    return tuple(out)


# ---------------------------------------------------------------------------
# Timeline lowering: the padded masked run (DESIGN.md §12)
# ---------------------------------------------------------------------------


def validate_timeline_alignment(rspec: ScenarioSpec, batch_size,
                                t_max: int) -> None:
    """The batched data plane consumes uniform B-blocks, so a timeline's
    event times, effective horizon and the padded length must all be
    multiples of B — then every block is entirely live or entirely
    padding and block boundaries coincide with the concrete path's
    segment blocks (bit-identity)."""
    if batch_size is None or batch_size <= 1:
        return
    bad = sorted({e.t for e in rspec.events if e.t % batch_size})
    if bad or rspec.horizon % batch_size or t_max % batch_size:
        raise ValueError(
            f"timeline is not aligned to batch_size={batch_size}: event "
            f"times {bad or '[]'}, horizon {rspec.horizon}, padded length "
            f"{t_max} must all be multiples of the block size")


def _device_mask(mask: np.ndarray, device) -> Tensor:
    """A host bool mask on ``device`` without a device sync: a pinned
    staging copy, sent asynchronously on the current stream."""
    t = torch.from_numpy(np.ascontiguousarray(mask))
    if torch.device(device).type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _timeline_stream_tfs(spec: ScenarioSpec, env: simulator.Environment):
    """The timeline counterpart of ``_stream_tfs``: one transform over the
    full padded (S, T_max, ...) tensors, applying each ``Param``
    price/quality payload on its in-force window [t_i, end_i) per state,
    where end_i is the next same-(kind, arm) event in time (listed order
    breaks ties, matching ``_segment_mods``) or the state's horizon. Same
    f32 ops on in-force rows as the per-segment transforms, other rows
    untouched. None when the spec has no Param stream payloads."""
    pmult = tuple((i, e.arm, e.multiplier.name)
                  for i, e in enumerate(spec.events)
                  if isinstance(e, PriceChange)
                  and isinstance(e.multiplier, Param))
    qual = tuple((i, e.arm, e.target_mean.name)
                 for i, e in enumerate(spec.events)
                 if isinstance(e, QualityShift)
                 and isinstance(e.target_mean, Param))
    if not pmult and not qual:
        return None
    base_mean = {arm: env.rewards[:, arm].mean() for _, arm, _ in qual}
    by_kind = {
        "p": [(j, e.arm) for j, e in enumerate(spec.events)
              if isinstance(e, PriceChange)],
        "q": [(j, e.arm) for j, e in enumerate(spec.events)
              if isinstance(e, QualityShift)],
    }

    def window(i, arm, kind, ev_ts, horizon, T):
        """(S, T) host mask of event i's in-force steps."""
        end = horizon.copy()
        for j, arm_j in by_kind[kind]:
            if j == i or arm_j != arm:
                continue
            later = ((ev_ts[:, j] > ev_ts[:, i]) if j < i
                     else (ev_ts[:, j] >= ev_ts[:, i]))
            end = np.where(later, np.minimum(end, ev_ts[:, j]), end)
        steps = np.arange(T)[None, :]
        return (steps >= ev_ts[:, i, None]) & (steps < end[:, None])

    def tf(xs, rmat, cmat, params, ev_ts, horizon):
        T, dev = rmat.shape[1], rmat.device
        rmat, cmat = rmat.clone(), cmat.clone()
        for i, arm, name in qual:
            m = _device_mask(window(i, arm, "q", ev_ts, horizon, T), dev)
            col = _quality_shift(rmat[:, :, arm], base_mean[arm],
                                 params.get(name))
            rmat[:, :, arm] = torch.where(m, col, rmat[:, :, arm])
        for i, arm, name in pmult:
            m = _device_mask(window(i, arm, "p", ev_ts, horizon, T), dev)
            scaled = cmat[:, :, arm] * params.get(name)[:, None]
            cmat[:, :, arm] = torch.where(m, scaled, cmat[:, :, arm])
        return xs, rmat, cmat

    return tf


def _timeline_edits(cfg: RouterConfig, spec: ScenarioSpec,
                    env: simulator.Environment):
    """State events lowered for timed activation: a list of ``(i, fn)``
    with ``fn(state, params, ev_ts) -> state`` over the whole stack, fired
    by the runner on the rows whose event time ``ev_ts[:, i]`` it
    reaches. An ``AddArm``'s in-force price multiplier — a time-dependent
    quantity — is folded per state on the host from the event times (the
    last same-arm PriceChange with ``t_j <= t_add``, listed order breaking
    ties), reading the same auto-lifted / ``Param`` leaves as the
    concrete path's static selection."""
    out = []
    for i, e in enumerate(spec.events):
        if not isinstance(e, _STATE_EVENTS):
            continue
        if isinstance(e, AddArm):
            add = _add_arm_fn(cfg, spec, i, env)
            cands = tuple(
                (j, _mult_ref(spec, j)) for j, ev in enumerate(spec.events)
                if isinstance(ev, PriceChange) and ev.arm == e.slot)

            def fn(st, ps, ev_ts, _i=i, _add=add, _cands=cands):
                win = np.full(ev_ts.shape[0], -1)   # candidate in force
                cur_t = np.full(ev_ts.shape[0], -1)
                for c, (j, _) in enumerate(_cands):  # ascending j
                    applies = ((ev_ts[:, j] <= ev_ts[:, _i])
                               & (ev_ts[:, j] >= cur_t))
                    win = np.where(applies, c, win)
                    cur_t = np.where(applies, ev_ts[:, j], cur_t)
                if (win < 0).all():
                    return _add(st, ps, None)
                m = torch.ones_like(st.pacer.lam)
                for c in np.unique(win[win >= 0]):
                    leaf = ps.get(_cands[c][1].name)
                    m = (leaf if (win == c).all() else torch.where(
                        _device_mask(win == c, m.device), leaf, m))
                return _add(st, ps, m)

            out.append((i, fn))
            continue
        f = _one_edit(cfg, spec, i, env)
        if f is not None:
            out.append((i, lambda st, ps, ev_ts, _f=f: _f(st, ps)))
    return tuple(out)


def _pad_trace(tr, live: Tensor):
    """The step's trace with padding rows (``live`` False) at arm -1 and
    r / c / lam 0."""
    arms, r, c, lam = tr
    m = live[:, None]
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    return (torch.where(m, arms, torch.full_like(arms, -1)),
            torch.where(m, r, zero), torch.where(m, c, zero),
            torch.where(m, lam, zero))


def timeline_body(cfg: RouterConfig, spec: ScenarioSpec,
                  env: simulator.Environment, batch_size=None):
    """The masked timeline program over the padded T_max steps, with
    event times ``ev_ts`` (S, E) and horizons (S,) as host integer data.

    Per block (of B requests, or one): the state edits whose event time
    it reaches fire in listed order (on every state, or blended in with
    ``types.state_where`` on the states that fire), the router steps, and
    on padding steps (``t >= horizon``) the state keeps its old value and
    the trace reads arm -1, r / c / lam 0 — so the PRNG chain, pacer and
    statistics advance exactly as the concrete retimed spec's run on live
    steps. The router steps on padding too, as the JAX scan does; masks
    come from the host, so no step waits on the device."""
    _no_tenant_events(spec)
    edits = _timeline_edits(cfg, spec, env)
    tf = _timeline_stream_tfs(spec, env)
    B = batch_size if batch_size is not None and batch_size > 1 else 1

    def run(state: RouterState, xs, rmat, cmat, params: ScenarioParams,
            ev_ts, horizon):
        ev_ts = np.asarray(ev_ts, np.int64).reshape(xs.shape[0], -1)
        horizon = np.asarray(horizon, np.int64)
        if tf is not None:
            xs, rmat, cmat = tf(xs, rmat, cmat, params, ev_ts, horizon)
        T, dev = xs.shape[1], xs.device
        assert T % B == 0, (T, B)
        traces = []
        for t0 in range(0, T, B):
            for i, fn in edits:
                fire = ev_ts[:, i] == t0
                if fire.all():
                    state = fn(state, params, ev_ts)
                elif fire.any():
                    state = types_lib.state_where(
                        _device_mask(fire, dev), fn(state, params, ev_ts),
                        state)
            sl = slice(t0, t0 + B)
            new, tr = router.step_batch(cfg, state, xs[:, sl].contiguous(),
                                        rmat[:, sl].contiguous(),
                                        cmat[:, sl].contiguous())
            live = t0 < horizon
            if live.all():
                state = new
            else:
                mask = _device_mask(live, dev)
                tr = _pad_trace(tr, mask)
                if live.any():
                    state = types_lib.state_where(mask, new, state)
            traces.append(tr)
        return state, tuple(torch.cat(p, dim=1) for p in zip(*traces))

    return run


# ---------------------------------------------------------------------------
# The segmented runner
# ---------------------------------------------------------------------------

def lru_get(cache: collections.OrderedDict, key, make, maxsize: int):
    """Bounded-LRU lookup shared by the stream and runner caches."""
    hit = cache.get(key)
    if hit is not None:
        cache.move_to_end(key)
        return hit
    hit = cache[key] = make()
    if len(cache) > maxsize:
        cache.popitem(last=False)
    return hit


_RUNNER_CACHE: collections.OrderedDict = collections.OrderedDict()
_RUNNER_CACHE_MAX = 64


def segment_body(cfg: RouterConfig, seg_lens, edits, batch_size,
                 stream_tfs=None):
    """The segmented program over a state stack: per segment, its edit
    (if any) on the whole stack, its stream transform (if any), then one
    ``router.run_stream_batched`` call in blocks of ``batch_size`` (or
    one request at a time). ``edits`` and ``stream_tfs`` take the (S,)
    ``ScenarioParams`` (payloads as data, DESIGN.md §10). Returns
    ``run(state, xs, rmat, cmat, params) -> (final_state, (arms, r, c,
    lam))`` with (S, T) traces."""
    tfs = stream_tfs if stream_tfs is not None else (None,) * len(seg_lens)
    B = batch_size if batch_size is not None and batch_size > 1 else 1

    def run(state: RouterState, xs, rmat, cmat, params: ScenarioParams):
        traces, off = [], 0
        for L, edit, tf in zip(seg_lens, edits, tfs):
            if edit is not None:
                state = edit(state, params)
            seg = (xs[:, off:off + L], rmat[:, off:off + L],
                   cmat[:, off:off + L])
            if tf is not None:
                seg = tf(*seg, params)
            state, tr = router.run_stream_batched(cfg, state, *seg,
                                                  batch_size=B)
            traces.append(tr)
            off += L
        return state, tuple(torch.cat(p, dim=1) for p in zip(*traces))

    return run


def spec_body(cfg: RouterConfig, spec: ScenarioSpec,
              env: simulator.Environment, batch_size=None):
    """``segment_body`` built from a spec (edits + segment lengths +
    stream transforms for parameterized payloads)."""
    _no_tenant_events(spec)
    seg_lens = tuple(b - a for a, b in spec.segments)
    return segment_body(cfg, seg_lens, _edit_fns(cfg, spec, env),
                        batch_size, _stream_tfs(spec, env))


def _env_sig(env: simulator.Environment):
    # Edits capture the base rate card; the quality transforms capture
    # the base reward means.
    return (env.prices_per_req.tobytes(), env.prices_per_1k.tobytes(), env.k,
            hashlib.sha1(np.ascontiguousarray(env.rewards)).digest())


def compiled_runner(
    cfg: RouterConfig,
    spec: ScenarioSpec,
    env: simulator.Environment,
    batch_size: Optional[int] = None,
):
    """Cached runner for (statics, spec structure, env, batch size): the
    built closures of ``spec_body``. Budgets, priors, seeds, hyper-
    parameters and ``Param`` payload values are data (state leaves and
    ``ScenarioParams``), and concrete operand payloads are auto-lifted,
    so a spec family differing only in values shares one runner."""
    key = (cfg.statics, runner_spec_key(spec), _env_sig(env), batch_size)
    return lru_get(_RUNNER_CACHE, key,
                   lambda: spec_body(cfg, spec, env, batch_size),
                   _RUNNER_CACHE_MAX)


def compiled_timeline_runner(
    cfg: RouterConfig,
    spec: ScenarioSpec,
    env: simulator.Environment,
    batch_size: Optional[int] = None,
):
    """Cached masked-timeline runner: like ``compiled_runner``, but event
    times (S, E) and effective horizons (S,) are run-time data (``spec``
    contributes its event structure and T_max = ``spec.horizon``), so
    every ``Timeline`` of a spec shares one runner."""
    key = (cfg.statics, runner_spec_key(spec, mask_times=True),
           _env_sig(env), batch_size)
    return lru_get(_RUNNER_CACHE, key,
                   lambda: timeline_body(cfg, spec, env, batch_size),
                   _RUNNER_CACHE_MAX)

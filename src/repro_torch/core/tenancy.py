"""Tenant plane: T independent budget pacers over ONE shared portfolio.

Production portfolios serve many tenants with independent dollar
contracts against the same model pool. The LinUCB sufficient statistics
(A, A_inv, b, theta) stay shared — quality estimates are a property of
the portfolio, not the customer — while the §3.2 primal-dual pacer
(Eqs. 3-4) is replicated per tenant: each request is scored under ITS
tenant's dual lambda and hard price ceiling, and each realised cost
folds into ITS tenant's EMA only.

Representation: a ``TenantTable`` of (..., T) leaves — a ``PacerState``
per tenant plus per-tenant pull/spend accumulators. ``make_table`` gives
one (T,) table; on ``RouterState.tenants`` (a LEARN-plane leaf,
DESIGN.md §13/§15) every leaf carries the stack's leading state axis,
(S, T), and ``stack_tables`` gives a (C, T) table for the sweep fabric's
condition axis.

The exactness contract (DESIGN.md §15): ``tenant_fold`` over a mixed
block is bit-identical to grouping the block by tenant and folding each
group through ``pacer.pacer_update_batch`` in arrival order. Distinct
tenants touch disjoint table rows and the per-step clip (the reason the
fold is sequential, not a closed form) only ever sees one tenant's
carry, so interleaving commutes across tenants while preserving
within-tenant order.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Union

import numpy as np
import torch

from repro_torch.core import pacer as pacer_lib
from repro_torch.core.types import (
    HyperParams, PacerState, Statics, resolve_device,
)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class TenantTable:
    """T per-tenant pacers + spend accounting, all (..., T) f32/i32/bool
    leaves. Column i is tenant i's ``PacerState`` plus its accumulators;
    leading dims (if any) are stacking axes (states, sweep conditions)."""

    lam: Tensor      # (..., T) f32  per-tenant dual lambda_t >= 0
    c_ema: Tensor    # (..., T) f32  per-tenant EMA-smoothed cost (init: B_i)
    budget: Tensor   # (..., T) f32  per-tenant ceiling B_i ($/req)
    enabled: Tensor  # (..., T) bool per-tenant pacer gate
    pulls: Tensor    # (..., T) i32  requests routed per tenant
    spend: Tensor    # (..., T) f32  cumulative realised cost per tenant


LEAVES = tuple(f.name for f in dataclasses.fields(TenantTable))


def num_tenants(table: TenantTable) -> int:
    return int(table.budget.shape[-1])


def make_table(
    budgets: Union[Sequence[float], np.ndarray, Tensor],
    *,
    enabled: Union[bool, Sequence[bool], np.ndarray] = True,
    device=None,
) -> TenantTable:
    """Fresh (T,) tenant table from per-tenant budgets (host boundary).

    Every budget is validated > 0 with ``ValueError`` (a zero ceiling
    would NaN the dual). ``c_ema`` initialises at each tenant's budget,
    mirroring ``init_state``'s ``\\bar c_0 <- B`` (Algorithm 1).
    ``device`` defaults to the card.
    """
    if isinstance(budgets, Tensor):
        budgets = budgets.detach().cpu().numpy()
    b = np.asarray(budgets, np.float32)
    if b.ndim != 1 or b.size < 1:
        raise ValueError(
            f"budgets must be a non-empty 1-D sequence; got shape {b.shape}")
    if not np.all(b > 0.0):
        bad = np.flatnonzero(~(b > 0.0))
        raise ValueError(
            f"tenant budgets must be > 0 ($/request ceilings); "
            f"tenants {bad.tolist()} have {b[bad].tolist()}")
    device = resolve_device(device)
    T = b.shape[0]
    en = np.broadcast_to(np.asarray(enabled, bool), (T,))
    f32 = dict(dtype=torch.float32, device=device)
    return TenantTable(
        lam=torch.zeros((T,), **f32),
        c_ema=torch.as_tensor(b, **f32).clone(),
        budget=torch.as_tensor(b, **f32).clone(),
        enabled=torch.as_tensor(en.copy(), dtype=torch.bool, device=device),
        pulls=torch.zeros((T,), dtype=torch.int32, device=device),
        spend=torch.zeros((T,), **f32),
    )


def _map(fn, *tables: TenantTable) -> TenantTable:
    return TenantTable(**{n: fn(*(getattr(t, n) for t in tables))
                          for n in LEAVES})


def expand(table: TenantTable, n: int, device=None) -> TenantTable:
    """The table as (n, T) leaves on ``device`` (default: the table's):
    a (T,) table is copied into every row, an (n, T) one moves as is."""
    device = table.budget.device if device is None else torch.device(device)
    if table.budget.ndim == 1:
        return _map(lambda a: a.to(device).expand(n, -1).contiguous(), table)
    if table.budget.ndim == 2 and table.budget.shape[0] == n:
        return _map(lambda a: a.to(device), table)
    raise ValueError(
        f"tenants.budget must be (T,) shared or ({n}, T) per-state; got "
        f"shape {tuple(table.budget.shape)}")


def set_tenant_budget(table: TenantTable, tenant: int, budget) -> TenantTable:
    """Operator retargets ONE tenant's ceiling (host boundary: numbers
    are validated > 0, tensors pass unchecked and are floor-guarded in
    the fold). Pure — budgets are data leaves."""
    pacer_lib.validate_budget(budget, what=f"tenant[{tenant}] budget")
    b = table.budget.clone()
    b[..., tenant] = torch.as_tensor(budget, dtype=torch.float32,
                                     device=b.device)
    return dataclasses.replace(table, budget=b)


def gather_rows(table: TenantTable, tenant_ids: Tensor) -> PacerState:
    """Rows ``tenant_ids`` (S, B) of an (S, T) table as a ``PacerState``
    with (S, B) leaves — the per-request view the router scores under."""
    tid = tenant_ids.long()
    return PacerState(
        lam=table.lam.gather(1, tid),
        c_ema=table.c_ema.gather(1, tid),
        budget=table.budget.gather(1, tid),
        enabled=table.enabled.gather(1, tid),
    )


def tenant_fold(
    hp: HyperParams,
    table: TenantTable,
    tenant_ids: Tensor,
    costs: Tensor,
) -> TenantTable:
    """One dual-ascent pass over a mixed-tenant block, in arrival order.

    ``table`` has (S, T) leaves, ``tenant_ids`` / ``costs`` are (S, B)
    and ``hp`` leaves (S,). A host loop over the B requests, each step
    vectorised over the S states: gather each state's row
    ``tenant_ids[:, i]``, apply ``pacer.pacer_update`` (Eqs. 3-4 with the
    per-step clip), scatter the row back, and add 1 to that tenant's
    pulls and the cost to its spend. Bit-identical to grouping the block
    by tenant and folding each group through ``pacer_update_batch``:
    distinct tenants touch disjoint rows, so the interleaved loop and the
    grouped folds compute the same per-tenant recursions in the same
    within-tenant order.
    """
    tid = tenant_ids.long()
    costs = costs.to(torch.float32)
    rows = torch.arange(tid.shape[0], device=tid.device)
    lam, c_ema, pulls, spend = (table.lam.clone(), table.c_ema.clone(),
                                table.pulls.clone(), table.spend.clone())
    for i in range(tid.shape[1]):
        at = (rows, tid[:, i])
        c = costs[:, i]
        row = pacer_lib.pacer_update(hp, PacerState(
            lam=lam[at], c_ema=c_ema[at], budget=table.budget[at],
            enabled=table.enabled[at]), c)
        lam.index_put_(at, row.lam)
        c_ema.index_put_(at, row.c_ema)
        pulls.index_put_(at, pulls[at] + 1)
        spend.index_put_(at, spend[at] + c)
    return dataclasses.replace(table, lam=lam, c_ema=c_ema, pulls=pulls,
                               spend=spend)


def decay_table(
    statics: Statics,
    hp: HyperParams,
    table: TenantTable,
    elapsed: int,
) -> TenantTable:
    """Per-tenant ``gamma^Δt`` relaxation on snapshot restore (§8/§15).

    While a snapshot sits on disk no requests flow, so each tenant's
    dual pressure and cost EMA relax toward their quiescent anchors with
    the same geometric clock the LinUCB statistics use:

        g      = gamma^min(Δt, dt_max)
        lam   <- g * lam                       (dual decays toward 0)
        c_ema <- B + g * (c_ema - B)           (EMA decays toward its
                                                init anchor \\bar c_0 = B)

    Both maps compose: decaying by Δt1 then Δt2 equals decaying by
    Δt1 + Δt2 (up to the dt_max clamp). Pull/spend accumulators are
    lifetime counters and survive untouched. ``hp`` leaves are (S,)
    against an (S, T) table (or scalars against a (T,) one).
    """
    if elapsed < 0:
        raise ValueError(f"elapsed={elapsed}: must be >= 0")
    if elapsed == 0:
        return table
    gamma = torch.as_tensor(hp.gamma, dtype=torch.float32,
                            device=table.lam.device)
    g = torch.pow(gamma, torch.tensor(float(min(elapsed, statics.dt_max)),
                                      dtype=torch.float32,
                                      device=gamma.device))
    g = g.reshape(g.shape + (1,) * (table.lam.ndim - g.ndim))
    return dataclasses.replace(
        table,
        lam=g * table.lam,
        c_ema=table.budget + g * (table.c_ema - table.budget),
    )


def stack_tables(tables: Sequence[TenantTable]) -> TenantTable:
    """C single tables -> one (C, T) stacked table (sweep condition axis)."""
    if not tables:
        raise ValueError("need at least one table to stack")
    T = {num_tenants(t) for t in tables}
    if len(T) != 1:
        raise ValueError(f"cannot stack tables with mixed T: {sorted(T)}")
    return _map(lambda *xs: torch.stack(xs), *tables)


def table_row(table: TenantTable, tenant: int) -> PacerState:
    """Tenant ``tenant``'s pacer as a ``PacerState`` with the table's
    leading dims (the single-tenant baseline the bit-identity gates
    compare to)."""
    return PacerState(
        lam=table.lam[..., tenant],
        c_ema=table.c_ema[..., tenant],
        budget=table.budget[..., tenant],
        enabled=table.enabled[..., tenant],
    )

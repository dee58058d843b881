"""ParetoBandit Algorithm 1: budget-paced non-stationary routing, over a
stack of S router states.

The data plane is batched (DESIGN.md §2): ``select_batch`` scores an
(S, B, d) block of contexts against all arms in one backend call,
``update_batch`` folds a block of delayed feedback in arrival order, and
``step_batch`` closes the loop against a (S, B, K) environment. With the
``fused`` backend (the default) ``step_batch`` runs the whole block body
— score, select, decay + Sherman-Morrison, pacer — in the ``linucb_step``
CUDA kernel.

The scalar functions ``select``/``update``/``step`` are the B = 1 blocks:
a block of one request *is* the sequential step (same scores, same noise,
same bookkeeping), which is how the JAX package's scalar path is kept.

Hyper-parameters are read from ``state.hyper`` ((S,) leaves), never from
``cfg``, which contributes only statics (shapes, backend, dt_max,
forced_pulls).

Tenant mode (DESIGN.md §15): with ``tenant_ids`` (S, B) and a tenant
table on the state, each request is scored under its tenant's dual and
hard ceiling and each cost folds into its tenant's pacer only. As in the
JAX package, where the Pallas kernels refuse it, tenant mode runs on the
``torch`` backend alone: the ``score`` and ``fused`` kernels take one
dual per state and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import backend as backend_lib
from repro_torch.core import linucb, pacer, prng, tenancy
from repro_torch.core.types import PacerState, RouterConfig, RouterState

Tensor = torch.Tensor

NEG_INF = -1e30


class Decision(NamedTuple):
    arm: Tensor         # (S,) i32 — chosen arm slot
    scores: Tensor      # (S, K) f32 — Eq. 2 scores (NEG_INF for excluded)
    candidates: Tensor  # (S, K) bool — post-hard-ceiling candidate set
    lam: Tensor         # (S,) f32 — dual variable at decision time
    forced: Tensor      # (S,) bool — forced-exploration override fired


class BatchDecision(NamedTuple):
    arms: Tensor        # (S, B) i32 — chosen arm per request
    scores: Tensor      # (S, B, K) f32 — Eq. 2 + tiebreak (NEG_INF masked)
    candidates: Tensor  # (S, K) bool candidate set — (S, B, K) in tenant
                        # mode, where each row carries its tenant's ceiling
    lam: Tensor         # (S,) f32 — portfolio dual at block-decision time
    forced: Tensor      # (S, B) bool — forced-exploration override fired
    # (S, B) f32 per-request tenant duals (tenant mode only, else None).
    row_lams: Optional[Tensor] = None


def _tenant_mode_check(cfg: RouterConfig, state: RouterState, what: str):
    """Host-side guards for the tenant routing path (DESIGN.md §15)."""
    if state.tenants is None:
        raise ValueError(
            f"{what}: tenant_ids given but state.tenants is None — build "
            "the state with a tenancy.TenantTable (init_state(tenants=...))")
    if cfg.backend != "torch":
        raise NotImplementedError(
            f"{what}: tenant-aware routing needs per-request duals, which "
            f"the {cfg.backend!r} kernels take as a (K,) operand; use "
            "backend='torch' for tenant mode (DESIGN.md §15)")


def tenant_id_stack(tenant_ids, S: int, B: int, device) -> Tensor:
    """Tenant ids as an (S, B) int64 tensor on ``device``: (B,) shared by
    every state, or (S, B) one row per state."""
    if not isinstance(tenant_ids, Tensor):
        tenant_ids = np.ascontiguousarray(tenant_ids)
    tid = torch.as_tensor(tenant_ids, device=device).long()
    if tid.ndim == 1:
        tid = tid.expand(S, -1)
    if tuple(tid.shape) != (S, B):
        raise ValueError(
            f"tenant_ids must be ({B},) shared or ({S}, {B}) per-state; "
            f"got shape {tuple(tid.shape)}")
    return tid


def _tiebreak_noise(cfg: RouterConfig, hp, key: Tensor, B: int):
    """B sequentially chained tiebreak draws per state: key_{i+1}, sub_i =
    split(key_i), noise_i = tiebreak_scale * uniform(sub_i, (K,)), bit for
    bit ``jax.random``'s. Returns (advanced keys (S, 2), noise (S, B, K))."""
    subs = []
    for _ in range(B):
        pair = prng.split(key)                      # (S, 2, 2)
        key = pair[:, 0]
        subs.append(pair[:, 1])
    u = prng.uniform(torch.stack(subs, dim=1), (cfg.max_arms,))
    return key, hp.tiebreak_scale[:, None, None] * u


def _forced_mask(state: RouterState, B: int):
    """Forced-exploration burn-in for a block (§3.6/§4.5): the first
    ``force_left`` requests route unconditionally to the newcomer.
    Returns (idx (B,) i32, farm (S,) i32, forced (S, B) bool)."""
    idx = torch.arange(B, dtype=torch.int32, device=state.t.device)
    farm = torch.clamp_min(state.force_arm, 0)
    rows = torch.arange(state.num_states, device=state.t.device)
    forced = ((idx[None, :] < state.force_left[:, None])
              & (state.force_arm >= 0)[:, None]
              & state.active[rows, farm.long()][:, None])
    return idx, farm, forced


def _bookkeeping(state: RouterState, arms: Tensor, idx: Tensor,
                 forced: Tensor, key: Tensor) -> dict:
    """The select-plane leaves after a block: ``t`` advances by B,
    ``last_play`` lands on each arm's last in-block dispatch step, the
    forced counter drops by the forced rows, the key advances."""
    played_at = state.t[:, None] + 1 + idx[None, :]
    return dict(
        last_play=state.last_play.scatter_reduce(
            1, arms.long(), played_at, reduce="amax"),
        t=state.t + arms.shape[1],
        force_left=state.force_left - forced.sum(1, dtype=torch.int32),
        key=key,
    )


def select_batch(cfg: RouterConfig, state: RouterState, X: Tensor,
                 tenant_ids=None):
    """Algorithm 1 lines 3-15 for an (S, B, d) block of concurrent
    requests. Returns (BatchDecision, new_state).

    All B requests of a state are scored against the same snapshot of its
    statistics, with staleness ``dt`` taken at block entry; the tiebreak
    chain splits once per request in order, forced burn-in diverts the
    first ``force_left`` requests, ``t`` advances by B. ``argmax`` breaks
    exact ties on the lowest slot.

    With ``tenant_ids`` (S, B) each request is scored under ITS tenant's
    dual: the tenant plane gathers per-row ``PacerState``s, the cost
    penalty uses the (S, B) lambdas, and the hard price ceiling is
    per row — row b is bit-identical to scoring the whole block under
    tenant ``tenant_ids[:, b]``'s pacer. The portfolio pacer is ignored
    for scoring in tenant mode.
    """
    S, B = X.shape[:2]
    hp = state.hyper
    row_lams = None
    if tenant_ids is not None:
        _tenant_mode_check(cfg, state, "select_batch")
        tid = tenant_id_stack(tenant_ids, S, B, X.device)
        rows = tenancy.gather_rows(state.tenants, tid)            # (S, B)
        K = state.price.shape[1]
        flat = PacerState(*(getattr(rows, f).reshape(-1) for f in
                            ("lam", "c_ema", "budget", "enabled")))
        cand = pacer.hard_ceiling_mask(
            flat, state.price[:, None].expand(S, B, K).reshape(-1, K),
            state.active[:, None].expand(S, B, K).reshape(-1, K),
        ).reshape(S, B, K)
        lam_op = row_lams = rows.lam
    else:
        cand = pacer.hard_ceiling_mask(state.pacer, state.price,
                                       state.active)              # (S, K)
        lam_op = state.pacer.lam
    dt = state.t[:, None] - torch.maximum(state.last_upd, state.last_play)
    scores = backend_lib.get_backend(cfg.backend).score(
        cfg, hp, state.theta, state.A_inv, state.c_tilde, X, dt,
        lam_op)                                                   # (S, B, K)
    key, noise = _tiebreak_noise(cfg, hp, state.key, B)
    cand_rows = cand if cand.ndim == 3 else cand[:, None, :]
    masked = torch.where(cand_rows, scores + noise, NEG_INF)
    arms = masked.argmax(-1).to(torch.int32)
    idx, farm, forced = _forced_mask(state, B)
    arms = torch.where(forced, farm[:, None], arms)
    new_state = dataclasses.replace(
        state, **_bookkeeping(state, arms, idx, forced, key))
    dec = BatchDecision(arms=arms, scores=masked, candidates=cand,
                        lam=state.pacer.lam, forced=forced,
                        row_lams=row_lams)
    return dec, new_state


def _apply_feedback(cfg: RouterConfig, state: RouterState, arm: Tensor,
                    x: Tensor, reward: Tensor) -> RouterState:
    """Algorithm 1 lines 17-23: each state's played-arm statistics update
    (decay + rank-1), without the pacer step. arm (S,), x (S, d)."""
    rows = torch.arange(state.num_states, device=arm.device)
    at = (rows, arm.long())
    dt = state.t - state.last_upd[at]                             # line 18
    A_a, Ainv_a, b_a, theta_a = linucb.rank1_update(
        cfg, state.hyper, state.A[at], state.A_inv[at], state.b[at],
        x, reward, dt)
    return dataclasses.replace(
        state,
        A=state.A.index_put(at, A_a),
        A_inv=state.A_inv.index_put(at, Ainv_a),
        b=state.b.index_put(at, b_a),
        theta=state.theta.index_put(at, theta_a),
        last_upd=state.last_upd.index_put(at, state.t),           # line 23
    )


def update_batch(cfg: RouterConfig, state: RouterState, arms: Tensor,
                 X: Tensor, rewards: Tensor, costs: Tensor,
                 tenant_ids=None) -> RouterState:
    """Apply a block of delayed feedback — arms (S, B), X (S, B, d),
    rewards / costs (S, B) — as the sequential fold of ``update``: the
    per-arm rank-1 updates in arrival order (order matters under
    forgetting), then one pacer pass over the block's costs.

    With ``tenant_ids`` (S, B) each cost folds into ITS tenant's pacer via
    ``tenancy.tenant_fold`` — bit-identical to grouping the block by
    tenant and folding each group through ``pacer_update_batch`` in
    arrival order. The portfolio pacer is left untouched in tenant mode
    (it is inert; the tenant rows ARE the duals)."""
    if tenant_ids is not None:
        _tenant_mode_check(cfg, state, "update_batch")
        tid = tenant_id_stack(tenant_ids, *arms.shape, arms.device)
    for i in range(arms.shape[1]):
        state = _apply_feedback(cfg, state, arms[:, i], X[:, i],
                                rewards[:, i])
    if tenant_ids is not None:
        tab = tenancy.tenant_fold(state.hyper, state.tenants, tid,
                                  costs)                          # l. 25-26
        return dataclasses.replace(state, tenants=tab)
    p = pacer.pacer_update_batch(state.hyper, state.pacer, costs)  # l. 25-26
    return dataclasses.replace(state, pacer=p)


def _gather(mat: Tensor, arms: Tensor) -> Tensor:
    """mat (S, B, K) at each request's arm: (S, B)."""
    return mat.gather(2, arms.long()[..., None])[..., 0]


def _step_batch_fused(cfg: RouterConfig, backend, state: RouterState,
                      X: Tensor, rewards: Tensor, costs: Tensor):
    """The ``fused`` closed-loop block step. Bookkeeping that needs the
    PRNG chain or the forced counters stays here; the backend's kernel
    does everything that touches the statistics. State reassembly mirrors
    ``select_batch`` + ``update_batch``, including the ``pacer.enabled``
    gate."""
    B = X.shape[1]
    key, noise = _tiebreak_noise(cfg, state.hyper, state.key, B)
    idx, farm, forced = _forced_mask(state, B)
    (A2, Ainv2, b2, theta2, lu2, arms, r, c, lam_k, cema_k) = (
        backend.step_block(cfg, state, X, rewards, costs, noise, farm,
                           forced))
    p = state.pacer
    new_pacer = PacerState(
        lam=torch.where(p.enabled, lam_k, p.lam),
        c_ema=torch.where(p.enabled, cema_k, p.c_ema),
        budget=p.budget, enabled=p.enabled)
    new_state = dataclasses.replace(
        state, A=A2, A_inv=Ainv2, b=b2, theta=theta2, last_upd=lu2,
        pacer=new_pacer, **_bookkeeping(state, arms, idx, forced, key))
    lam = p.lam[:, None].expand(-1, B)       # block-decision-time dual
    return new_state, (arms, r, c, lam)


def step_batch(cfg: RouterConfig, state: RouterState, X: Tensor,
               rewards: Tensor, costs: Tensor, tenant_ids=None):
    """One closed-loop block step against (S, B, K) environment matrices:
    route, observe the chosen arms' (reward, cost), feed back.

    Returns (new_state, (arms, r, c, lam)), each trace (S, B). The fused
    backend runs the block through its kernel; the others go through
    ``select_batch`` + ``update_batch``. In tenant mode the traced ``lam``
    is each request's tenant dual at block-decision time, and the block
    always takes the select/update path (``_tenant_mode_check`` rejects
    the kernel backends before dispatch).
    """
    backend = backend_lib.get_backend(cfg.backend)
    if getattr(backend, "fused_step", False):
        if tenant_ids is not None:
            _tenant_mode_check(cfg, state, "step_batch")
        return _step_batch_fused(cfg, backend, state, X, rewards, costs)
    dec, state = select_batch(cfg, state, X, tenant_ids)
    r, c = _gather(rewards, dec.arms), _gather(costs, dec.arms)
    state = update_batch(cfg, state, dec.arms, X, r, c, tenant_ids)
    lam = (dec.row_lams if dec.row_lams is not None
           else dec.lam[:, None].expand(-1, X.shape[1]))
    return state, (dec.arms, r, c, lam)


def select(cfg: RouterConfig, state: RouterState, x: Tensor):
    """Algorithm 1 lines 3-15 for one request per state, x (S, d):
    the B = 1 block. Returns (Decision, new_state)."""
    dec, state = select_batch(cfg, state, x[:, None])
    return Decision(arm=dec.arms[:, 0], scores=dec.scores[:, 0],
                    candidates=dec.candidates, lam=dec.lam,
                    forced=dec.forced[:, 0]), state


def update(cfg: RouterConfig, state: RouterState, arm: Tensor, x: Tensor,
           reward: Tensor, cost: Tensor) -> RouterState:
    """Algorithm 1 lines 17-26 for one request per state."""
    return update_batch(cfg, state, arm[:, None], x[:, None],
                        reward[:, None], cost[:, None])


def step(cfg: RouterConfig, state: RouterState, x: Tensor, rewards: Tensor,
         costs: Tensor):
    """One closed-loop step per state against (S, K) environment vectors.
    Returns (new_state, (arm, reward, cost, lam)), each (S,)."""
    state, trace = step_batch(cfg, state, x[:, None], rewards[:, None],
                              costs[:, None])
    return state, tuple(t[:, 0] for t in trace)


def run_stream_batched(cfg: RouterConfig, state: RouterState, xs: Tensor,
                       rewards: Tensor, costs: Tensor, batch_size: int,
                       tenant_ids: Optional[Tensor] = None):
    """Algorithm 1 over (S, T) request streams in blocks of
    ``batch_size``: xs (S, T, d), rewards / costs (S, T, K). A trailing
    partial block (T mod B requests) runs as one smaller block.
    ``tenant_ids`` (S, T) tags each request with its tenant (DESIGN.md
    §15); blocks then route and pace per tenant.

    Returns (final_state, (arms, r, c, lam)) with (S, T) traces.
    """
    T = xs.shape[1]
    tids = (None if tenant_ids is None
            else tenant_id_stack(tenant_ids, xs.shape[0], T, xs.device))
    traces = []
    for t0 in range(0, T, batch_size):
        sl = slice(t0, min(t0 + batch_size, T))
        state, tr = step_batch(cfg, state, xs[:, sl].contiguous(),
                               rewards[:, sl].contiguous(),
                               costs[:, sl].contiguous(),
                               None if tids is None else tids[:, sl])
        traces.append(tr)
    if not traces:
        raise ValueError("empty request stream")
    return state, tuple(torch.cat(parts, dim=1) for parts in zip(*traces))


def run_stream(cfg: RouterConfig, state: RouterState, xs: Tensor,
               rewards: Tensor, costs: Tensor):
    """The per-request closed loop: ``run_stream_batched`` with B = 1."""
    return run_stream_batched(cfg, state, xs, rewards, costs, 1)

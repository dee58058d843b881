"""Serving gateway: admission, selection plane, learner plane.

Three layers with one state-publication point between them, as in the JAX
package:

  * ``MicroBatcher`` — admission: collects requests into a time/size
    bounded window; a full window (or an expired deadline) flushes as
    one block into the batched data plane.
  * selection plane — ``route_block``: scores a block with ONE
    ``router.select_batch`` call against the live state (the last
    published statistics: the learner is the only writer of
    ``types.LEARN_LEAVES``), caches (context, arm, snapshot version) in
    the feedback store, and records telemetry.
  * learner plane — ``enqueue_feedback`` + ``learn_tick``: feedback
    blocks accumulate off the request path; a tick folds them through
    ``router.update_batch`` on a grabbed state outside the state lock,
    merges the learned leaves back and publishes a new versioned
    snapshot through ``core.statehandle.StateHandle``.

Selection and learning write disjoint leaves, so the publish merge is
conflict-free however many blocks routed while the learner computed.
Control ops (hot-swap, budget, hyper retune) run under the state lock and
bump a control epoch; a learner tick that grabbed state before one lands
discards its result and retries. With a ``learn_tick`` after every block
(publish cadence 1) the gateway is the sequential select/update fold.

The gateway serves one router: the port's state axis has S = 1. The JAX
package's ``select_batch`` is a jitted call; here it is a direct call.

With a tenant table on the live state (DESIGN.md §15) every request
carries a tenant id: ``submit(..., tenant=)`` tags it in the admission
window, ``route_block`` scores each row under its tenant's dual and
ceiling, and the learner folds each row's cost into its tenant's pacer.
As in the JAX package, tenant routing needs the ``torch`` backend.
``save`` / ``restore`` persist the published snapshot
(``statehandle.save_snapshot``) and age it on the way back in.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import router as router_lib
from repro_torch.core import statehandle
from repro_torch.core.statehandle import Snapshot, StateHandle
from repro_torch.core.types import (
    RouterConfig, RouterState, merge_learn_leaves, validate_leaf_partition,
)
from repro_torch.serving.feedback_store import InMemoryFeedbackStore
from repro_torch.serving.telemetry import Telemetry

# The publish merge below is only sound if the writer planes exactly
# partition RouterState; fail at import, not mid-serve.
validate_leaf_partition()


@dataclasses.dataclass(frozen=True)
class RouteResult:
    """One routed block: slot choices + the snapshot version they were
    scored under (recorded in the feedback store per request)."""

    request_ids: Tuple[int, ...]
    arms: np.ndarray       # (B,) i64 chosen slots
    lam: float             # pacer dual at decision time
    version: int           # snapshot version the block was scored under
    route_us: float        # per-decision route latency (µs)
    forced: np.ndarray     # (B,) bool forced-exploration dispatches


class MicroBatcher:
    """Admission window: size- and time-bounded request collection.

    ``submit`` returns a flushed window when it fills to ``max_batch``;
    ``poll`` flushes a partial window whose deadline (first admission +
    ``max_wait_s``) has expired; ``drain`` flushes unconditionally. The
    clock is injectable for tests."""

    def __init__(self, max_batch: int = 64, max_wait_s: float = 0.002,
                 clock: Callable[[], float] = time.monotonic):
        if max_batch < 1:
            raise ValueError(f"max_batch={max_batch}: need >= 1")
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._ids: List[int] = []
        self._rows: List[np.ndarray] = []
        self._opened_at: Optional[float] = None

    def __len__(self) -> int:
        return len(self._ids)

    def submit(self, request_id: int, context: np.ndarray
               ) -> Optional[Tuple[List[int], np.ndarray]]:
        with self._lock:
            if self._opened_at is None:
                self._opened_at = self._clock()
            self._ids.append(int(request_id))
            self._rows.append(np.asarray(context, np.float32))
            if len(self._ids) >= self.max_batch:
                return self._flush_locked()
            return None

    def poll(self) -> Optional[Tuple[List[int], np.ndarray]]:
        with self._lock:
            if (self._opened_at is not None and self._ids
                    and self._clock() - self._opened_at >= self.max_wait_s):
                return self._flush_locked()
            return None

    def drain(self) -> Optional[Tuple[List[int], np.ndarray]]:
        with self._lock:
            return self._flush_locked() if self._ids else None

    def _flush_locked(self):
        ids, rows = self._ids, self._rows
        self._ids, self._rows = [], []
        self._opened_at = None
        return ids, np.stack(rows)


class RouterGateway:
    """Decoupled select/learn planes over one double-buffered state.

    The live state (S = 1) is the single source of truth; ``handle``
    exposes the versioned published snapshots and the version stamped on
    every routed decision."""

    def __init__(
        self,
        cfg: RouterConfig,
        state: RouterState,
        *,
        store=None,
        telemetry: Optional[Telemetry] = None,
        batcher: Optional[MicroBatcher] = None,
        tenant_names: Optional[Sequence[str]] = None,
    ):
        if state.num_states != 1:
            raise ValueError(f"the gateway serves one router state; got "
                             f"{state.num_states}")
        self.cfg = cfg
        self.device = state.A.device
        self._lock = threading.Lock()
        self._live = state
        self._epoch = 0                 # bumped by every control op
        self._t_host = int(state.t[0])  # host mirror of state.t (no syncs)
        self.handle = StateHandle(state, step=self._t_host)
        # Explicit None checks: an empty store/batcher is falsy.
        self.store = InMemoryFeedbackStore() if store is None else store
        self.telemetry = telemetry or Telemetry(
            cfg.max_arms, tenant_names=tenant_names)
        self.batcher = MicroBatcher() if batcher is None else batcher
        self._pending: List[Tuple[np.ndarray, np.ndarray, np.ndarray,
                                  np.ndarray, np.ndarray, List[int]]] = []
        # tenant tag for requests sitting in the admission window — the
        # MicroBatcher flush contract stays (ids, rows); tenants rejoin
        # the block here at route time (DESIGN.md §15)
        self._tenant_of: Dict[int, int] = {}

    # -- selection plane ---------------------------------------------------
    @property
    def live_state(self) -> RouterState:
        return self._live

    @property
    def version(self) -> int:
        return self.handle.version

    def route_block(self, request_ids: Sequence[int], X,
                    tenant_ids=None) -> RouteResult:
        """Route one admission window (X (B, d)) with a single
        ``select_batch``; the state swap under the lock is the whole
        critical section.

        When the live state carries a tenant table, each row is scored
        under ITS tenant's dual and ceiling (``tenant_ids`` (B,); None =
        all tenant 0); passing tenant_ids without a table is an error."""
        B = len(request_ids)
        tenanted = self._live.tenants is not None
        if tenant_ids is not None and not tenanted:
            raise ValueError(
                "route_block: tenant_ids given but the live state has no "
                "tenant table (init_state(..., tenants=make_table(...)))")
        t0 = time.perf_counter()
        Xt = torch.as_tensor(X, dtype=torch.float32, device=self.device)
        tids_np = tids = None
        if tenanted:
            tids_np = (np.zeros(B, np.int32) if tenant_ids is None
                       else np.asarray(tenant_ids, np.int32))
            tids = torch.as_tensor(tids_np, device=self.device)[None]
        with self._lock:
            dec, self._live = router_lib.select_batch(
                self.cfg, self._live, Xt[None], tenant_ids=tids)
            self._t_host += B
            version = self.handle.version
        arms = dec.arms[0].cpu().numpy()
        forced = dec.forced[0].cpu().numpy()
        lam = float(dec.lam[0])
        route_us = (time.perf_counter() - t0) * 1e6 / B
        X_np = Xt.cpu().numpy()
        put_block = getattr(self.store, "put_block", None)
        if put_block is not None:
            if tids_np is None:    # keep pre-tenancy store compatibility
                put_block(request_ids, X_np, arms, version=version)
            else:
                put_block(request_ids, X_np, arms, version=version,
                          tenants=tids_np)
        else:  # third-party stores: per-row contract
            for i, (rid, x, a) in enumerate(zip(request_ids, X_np, arms)):
                if tids_np is None:
                    self.store.put(rid, x, int(a), version=version)
                else:
                    self.store.put(rid, x, int(a), version=version,
                                   tenant=int(tids_np[i]))
        self.telemetry.record_route(
            arms, route_us, lam, forced=int(forced.sum()), version=version)
        return RouteResult(
            request_ids=tuple(int(r) for r in request_ids), arms=arms,
            lam=lam, version=version, route_us=route_us, forced=forced)

    def submit(self, request_id: int, context,
               tenant: int = 0) -> Optional[RouteResult]:
        """Admission path: collect into the micro-batch window; routes and
        returns the block when the window fills. ``tenant`` tags the
        request for per-tenant pacing (ignored without a tenant table)."""
        if tenant:
            self._tenant_of[int(request_id)] = int(tenant)
        win = self.batcher.submit(request_id, context)
        self.telemetry.record_admission(
            len(self.batcher), len(self.batcher), self.batcher.max_batch)
        return self._route_window(win)

    def poll(self) -> Optional[RouteResult]:
        """Flush a partial window whose time bound expired."""
        return self._route_window(self.batcher.poll())

    def drain(self) -> Optional[RouteResult]:
        """Flush whatever is pending (shutdown / test determinism)."""
        return self._route_window(self.batcher.drain())

    def _route_window(self, win) -> Optional[RouteResult]:
        if win is None:
            return None
        ids, rows = win
        self.telemetry.record_admission(
            len(self.batcher), len(ids), self.batcher.max_batch)
        if self._live.tenants is not None:
            tids = np.asarray(
                [self._tenant_of.pop(int(r), 0) for r in ids], np.int32)
            return self.route_block(ids, rows, tenant_ids=tids)
        for r in ids:                       # tags are no-ops without a table
            self._tenant_of.pop(int(r), None)
        return self.route_block(ids, rows)

    # -- learner plane -----------------------------------------------------
    def enqueue_feedback(self, request_ids: Sequence[int], arms, rewards,
                         costs) -> int:
        """Resolve a feedback block against the store and queue it for
        the next learner tick. Returns the number of rows kept.

        Unknown, duplicate/replayed and retired-arm rows are skipped and
        counted (``dropped_feedback``), never raised on. Rows routed under
        an older snapshot version are kept (they decay against current
        statistics when applied) and counted in ``feedback_late_total``.
        """
        n = len(request_ids)
        if not n:
            return 0
        if arms is None:
            arms = np.full(n, -1, np.int64)
        arms = np.asarray(arms, np.int64)
        rewards = np.asarray(rewards, np.float32)
        costs = np.asarray(costs, np.float32)
        if not (len(arms) == len(rewards) == len(costs) == n):
            raise ValueError(
                "feedback length mismatch: "
                f"{n} ids, {len(arms)} arms, "
                f"{len(rewards)} rewards, {len(costs)} costs")
        active = self._live.active[0].cpu().numpy()  # one host sync, not B
        version = self.handle.version
        pop_block = getattr(self.store, "pop_block", None)
        if pop_block is not None:
            recs = pop_block(request_ids)
        else:  # third-party stores: per-row contract
            recs = [self.store.pop_record(rid) for rid in request_ids]
        kept_X, kept_a, kept_r, kept_c = [], [], [], []
        kept_t, kept_ids = [], []
        for rid, a, rw, co, rec in zip(
                request_ids, arms, rewards, costs, recs):
            if rec is None:          # unknown, duplicate, or replayed id
                self.telemetry.inc("dropped_feedback")
                continue
            # pre-tenancy stores return 3-tuples; tenant then defaults 0
            x, cached_arm, routed_version = rec[:3]
            tenant = rec[3] if len(rec) > 3 else 0
            arm = int(a) if a >= 0 else cached_arm
            if not (0 <= arm < self.cfg.max_arms and bool(active[arm])):
                self.telemetry.inc("dropped_feedback")  # retired in flight
                continue
            self.telemetry.record_feedback_version(routed_version, version)
            kept_X.append(x), kept_a.append(arm)
            kept_r.append(rw), kept_c.append(co)
            kept_t.append(int(tenant)), kept_ids.append(int(rid))
        if not kept_a:
            return 0
        block = (np.stack(kept_X).astype(np.float32),
                 np.asarray(kept_a, np.int32),
                 np.asarray(kept_r, np.float32),
                 np.asarray(kept_c, np.float32),
                 np.asarray(kept_t, np.int32),
                 kept_ids)
        with self._lock:
            self._pending.append(block)
        return len(kept_a)

    def learn_tick(self) -> Optional[Snapshot]:
        """Fold every pending feedback block through ``update_batch`` and
        publish a new snapshot. Returns it, or None when there was nothing
        to apply. The update runs on a state grabbed outside the lock; the
        merge copies only ``types.LEARN_LEAVES`` back. If a control op
        bumped the epoch mid-compute, the tick retries against the
        post-op state."""
        with self._lock:
            blocks, self._pending = self._pending, []
        if not blocks:
            return None
        n_rows = sum(len(b[1]) for b in blocks)
        # Stage each feedback block on the device once (not again on an
        # epoch-bump retry), with the state axis S = 1 in front.
        staged = [tuple(torch.as_tensor(a, device=self.device)[None]
                        for a in (X, arm, r, c, t))
                  for X, arm, r, c, t, _ids in blocks]
        while True:
            with self._lock:
                base = self._live
                epoch = self._epoch
            learned = base
            tenanted = base.tenants is not None
            for X, a, r, c, t in staged:
                # in tenant mode each row folds into ITS tenant's pacer
                learned = router_lib.update_batch(
                    self.cfg, learned, a, X, r, c,
                    tenant_ids=t if tenanted else None)
            with self._lock:
                if self._epoch != epoch:
                    self.telemetry.inc("learn_retries_total")
                    continue
                self._live = merge_learn_leaves(self._live, learned)
                snap = self.handle.publish(self._live, step=self._t_host)
            break
        self.telemetry.record_publish(
            snap.version, n_feedback=n_rows, n_blocks=len(blocks))
        tab = snap.state.tenants
        if tab is not None:
            # host readback off the request path: latest table reading for
            # the per-tenant operator series
            self.telemetry.record_tenants(
                *(getattr(tab, n)[0].cpu().numpy()
                  for n in ("spend", "pulls", "lam", "budget")))
        return snap

    # -- control plane (hot swap goes through the publish path) ------------
    def apply_control(
        self, fn: Callable[[RouterState], RouterState]
    ) -> Snapshot:
        """Apply a whole-state control op (registry add/delete, budget,
        hyper retune) atomically w.r.t. both planes, bump the control
        epoch, and publish the result as a new snapshot."""
        with self._lock:
            self._live = fn(self._live)
            self._epoch += 1
            snap = self.handle.publish(self._live, step=self._t_host)
        return snap

    # -- persistence -------------------------------------------------------
    def save(self, path: str) -> Snapshot:
        """Persist the latest published snapshot (.npz + manifest, in the
        JAX package's format)."""
        snap = self.handle.read()
        statehandle.save_snapshot(path, snap)
        return snap

    def restore(self, path: str, *, elapsed: int = 0,
                template: Optional[RouterState] = None) -> Snapshot:
        """Load a snapshot, age it by ``elapsed`` offline steps
        (``statehandle.decay_on_restore``) and adopt it as the live
        state; versioning continues from the stored version."""
        snap = statehandle.load_snapshot(
            path, template if template is not None else self._live)
        state = statehandle.decay_on_restore(self.cfg, snap.state, elapsed)
        step = snap.step + int(elapsed)
        with self._lock:
            self._live = state
            self._epoch += 1
            self._t_host = step
            self._pending.clear()
            self.handle = StateHandle(state, version=snap.version, step=step)
        return self.handle.read()

    # -- export ------------------------------------------------------------
    def metrics(self) -> Dict[str, float]:
        """Telemetry + feedback-store gauges, all floats (never None)."""
        store = self.store
        if hasattr(store, "sweep_expired"):
            store.sweep_expired()   # fold aged-out entries into the count
        out = self.telemetry.metrics()
        ttl = getattr(store, "ttl", None)
        out.update(
            store_depth=float(len(store)),
            store_ttl_s=float(ttl) if ttl is not None else -1.0,
        )
        # Store-side TTL expiries add to the telemetry-side counter.
        out["expired_feedback"] = float(
            self.telemetry.counter("expired_feedback")
            + int(getattr(store, "expired_total", 0)))
        return out

    def prometheus_text(self) -> str:
        store = self.store
        ttl = getattr(store, "ttl", None)
        return self.telemetry.prometheus_text(extra={
            "store_depth": float(len(store)),
            "store_ttl_s": float(ttl) if ttl is not None else -1.0,
        })

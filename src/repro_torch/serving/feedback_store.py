"""Context caching for asynchronous feedback (§3.6).

The router caches the context vector at route time so rewards arriving
hours later (human RLHF labels, batch metrics) can update the bandit
without re-encoding the prompt. Two backends, as in the paper: in-memory
(process-local) and SQLite (survives restarts, sharable across gateway
workers).

Both stores support a TTL: entries whose rewards never arrive (client
crashed, judge queue dropped the job) would otherwise live forever and
leak memory at gateway QPS. An entry older than ``ttl`` seconds is
treated as absent — ``pop`` deletes it and counts it in
``expired_total`` — and ``sweep_expired()`` bulk-evicts for periodic
housekeeping. ``PortfolioServer.metrics()`` exports depth / drop /
expiry counters for operators.

Each entry also carries the router-state snapshot ``version`` the
request was routed under (gateway double-buffering, DESIGN.md §13), so
feedback arriving after later publishes can be attributed: ``pop``
keeps its original ``(ctx, arm)`` signature for existing callers, and
``pop_record`` returns ``(ctx, arm, version, tenant)`` for the gateway.
The ``tenant`` id (DESIGN.md §15) rides alongside the version so the
learner can fold each reward into the right tenant's pacer row; rows
written before multi-tenancy read back as tenant 0.
"""
from __future__ import annotations

import collections
import sqlite3
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np


class InMemoryFeedbackStore:
    """Process-local context cache with optional ageing.

    ``ttl`` is in seconds (None = keep forever); ``clock`` is injectable
    for tests (defaults to ``time.monotonic``).
    """

    def __init__(self, ttl: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        # insertion-ordered: puts are timestamped monotonically, so the
        # expired prefix is always at the front and sweeps are O(expired)
        self._d: "collections.OrderedDict[int, Tuple[np.ndarray, int, float, int, int]]" = (
            collections.OrderedDict())
        self._lock = threading.Lock()
        self.ttl = ttl
        self._clock = clock
        self.expired_total = 0

    def put(self, request_id: int, context: np.ndarray, arm: int,
            version: int = 0, tenant: int = 0) -> None:
        now = self._clock()
        with self._lock:
            self._d[request_id] = (
                np.asarray(context, np.float32), int(arm), now, int(version),
                int(tenant))
            self._d.move_to_end(request_id)  # re-put keeps time order
            self._sweep_locked(now)

    def put_block(self, request_ids, contexts: np.ndarray, arms,
                  version: int = 0, tenants=None) -> None:
        """Batched ``put``: one lock round-trip for a whole routed block
        (the gateway's select-plane hot path). ``tenants`` is a per-row
        sequence of tenant ids (None = tenant 0 for every row)."""
        now = self._clock()
        ctxs = np.asarray(contexts, np.float32)
        v = int(version)
        tids = ([0] * len(ctxs) if tenants is None
                else [int(t) for t in tenants])
        with self._lock:
            for rid, x, a, tid in zip(request_ids, ctxs, arms, tids):
                self._d[rid] = (x, int(a), now, v, tid)
                self._d.move_to_end(rid)
            self._sweep_locked(now)

    def pop(self, request_id: int) -> Optional[Tuple[np.ndarray, int]]:
        rec = self.pop_record(request_id)
        return None if rec is None else rec[:2]

    def pop_record(
        self, request_id: int
    ) -> Optional[Tuple[np.ndarray, int, int, int]]:
        """Like ``pop`` but also returns the snapshot version and tenant
        id the request was routed under (0/0 for pre-gateway writers)."""
        with self._lock:
            hit = self._d.pop(request_id, None)
            if hit is None:
                return None
            ctx, arm, ts, version, tenant = hit
            if self.ttl is not None and self._clock() - ts > self.ttl:
                self.expired_total += 1   # reward arrived after the TTL
                return None
            return ctx, arm, version, tenant

    def pop_block(self, request_ids):
        """Batched ``pop_record``: one lock round-trip, one record (or
        None for unknown/expired ids) per requested id, in order."""
        out = []
        with self._lock:
            now = self._clock()
            for rid in request_ids:
                hit = self._d.pop(rid, None)
                if hit is None:
                    out.append(None)
                    continue
                ctx, arm, ts, version, tenant = hit
                if self.ttl is not None and now - ts > self.ttl:
                    self.expired_total += 1
                    out.append(None)
                else:
                    out.append((ctx, arm, version, tenant))
        return out

    def sweep_expired(self) -> int:
        """Evict every aged-out entry; returns how many were dropped."""
        with self._lock:
            before = self.expired_total
            self._sweep_locked(self._clock())
            return self.expired_total - before

    def _sweep_locked(self, now: float) -> None:
        if self.ttl is None:
            return
        while self._d:
            rid, rec = next(iter(self._d.items()))
            ts = rec[2]
            if now - ts <= self.ttl:
                break
            del self._d[rid]
            self.expired_total += 1

    def __len__(self) -> int:
        return len(self._d)


class SQLiteFeedbackStore:
    """Durable context cache: (request_id, context blob, arm, created_at).

    Same TTL contract as ``InMemoryFeedbackStore``. ``clock`` defaults to
    ``time.time`` so ``created_at`` stays meaningful across process
    restarts (the whole point of the durable store).
    """

    def __init__(self, path: str = ":memory:", ttl: Optional[float] = None,
                 clock: Callable[[], float] = time.time):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        self.ttl = ttl
        self._clock = clock
        self.expired_total = 0
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS ctx ("
            " request_id INTEGER PRIMARY KEY,"
            " context BLOB NOT NULL,"
            " dim INTEGER NOT NULL,"
            " arm INTEGER NOT NULL,"
            " created_at REAL NOT NULL DEFAULT 0,"
            " version INTEGER NOT NULL DEFAULT 0,"
            " tenant INTEGER NOT NULL DEFAULT 0)"
        )
        # Migrate pre-TTL databases (no created_at column) in place.
        # Legacy rows are stamped with the migration time, NOT 0: a
        # created_at of 0 would read as decades old, so the first TTL'd
        # reopen would expire every in-flight context written seconds
        # before the restart — exactly what the durable store exists to
        # survive. Ageing starts at upgrade instead.
        cols = {r[1] for r in self._conn.execute("PRAGMA table_info(ctx)")}
        if "created_at" not in cols:
            self._conn.execute(
                "ALTER TABLE ctx ADD COLUMN created_at REAL NOT NULL "
                "DEFAULT 0")
            self._conn.execute("UPDATE ctx SET created_at = ?",
                               (float(self._clock()),))
        # Pre-gateway databases lack the snapshot-version column; the
        # DEFAULT 0 ("routed before versioning") is already the right
        # stamp for legacy rows, so no UPDATE pass is needed.
        if "version" not in cols:
            self._conn.execute(
                "ALTER TABLE ctx ADD COLUMN version INTEGER NOT NULL "
                "DEFAULT 0")
        # Pre-tenancy databases likewise gain the tenant column; DEFAULT 0
        # ("the operator's own traffic") is the right legacy stamp.
        if "tenant" not in cols:
            self._conn.execute(
                "ALTER TABLE ctx ADD COLUMN tenant INTEGER NOT NULL "
                "DEFAULT 0")
        self._conn.commit()

    def put(self, request_id: int, context: np.ndarray, arm: int,
            version: int = 0, tenant: int = 0) -> None:
        c = np.asarray(context, np.float32)
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO ctx VALUES (?, ?, ?, ?, ?, ?, ?)",
                (int(request_id), c.tobytes(), c.size, int(arm),
                 float(self._clock()), int(version), int(tenant)),
            )
            self._conn.commit()

    def put_block(self, request_ids, contexts: np.ndarray, arms,
                  version: int = 0, tenants=None) -> None:
        """Batched ``put``: one transaction for a whole routed block.
        ``tenants`` is a per-row sequence of tenant ids (None = 0)."""
        ctxs = np.asarray(contexts, np.float32)
        now, v = float(self._clock()), int(version)
        tids = ([0] * len(ctxs) if tenants is None
                else [int(t) for t in tenants])
        with self._lock:
            self._conn.executemany(
                "INSERT OR REPLACE INTO ctx VALUES (?, ?, ?, ?, ?, ?, ?)",
                [(int(rid), x.tobytes(), x.size, int(a), now, v, tid)
                 for rid, x, a, tid in zip(request_ids, ctxs, arms, tids)],
            )
            self._conn.commit()

    def pop(self, request_id: int) -> Optional[Tuple[np.ndarray, int]]:
        rec = self.pop_record(request_id)
        return None if rec is None else rec[:2]

    def pop_block(self, request_ids):
        """Batched ``pop_record``: one SELECT + one DELETE per block,
        one record (or None) per requested id, in order."""
        ids = [int(r) for r in request_ids]
        rows = []
        with self._lock:
            # chunked IN lists stay under SQLITE_MAX_VARIABLE_NUMBER
            for lo in range(0, len(ids), 500):
                chunk = ids[lo:lo + 500]
                marks = ",".join("?" * len(chunk))
                rows += self._conn.execute(
                    f"SELECT request_id, context, dim, arm, created_at,"
                    f" version, tenant FROM ctx WHERE request_id IN"
                    f" ({marks})",
                    chunk).fetchall()
                self._conn.execute(
                    f"DELETE FROM ctx WHERE request_id IN ({marks})", chunk)
            self._conn.commit()
            now = self._clock()
            by_id = {}
            for rid, blob, dim, arm, created, version, tenant in rows:
                if (self.ttl is not None
                        and now - float(created) > self.ttl):
                    self.expired_total += 1
                    continue
                by_id[rid] = (
                    np.frombuffer(blob, np.float32, count=dim).copy(),
                    int(arm), int(version), int(tenant))
        return [by_id.get(rid) for rid in ids]

    def pop_record(
        self, request_id: int
    ) -> Optional[Tuple[np.ndarray, int, int, int]]:
        """Like ``pop`` but also returns the snapshot version and tenant
        id the request was routed under (0/0 for pre-gateway rows)."""
        with self._lock:
            row = self._conn.execute(
                "SELECT context, dim, arm, created_at, version, tenant "
                "FROM ctx WHERE request_id = ?",
                (int(request_id),),
            ).fetchone()
            if row is None:
                return None
            self._conn.execute(
                "DELETE FROM ctx WHERE request_id = ?", (int(request_id),)
            )
            self._conn.commit()
            blob, dim, arm, created, version, tenant = row
            if (self.ttl is not None
                    and self._clock() - float(created) > self.ttl):
                self.expired_total += 1   # reward arrived after the TTL
                return None
        return (np.frombuffer(blob, np.float32, count=dim).copy(),
                int(arm), int(version), int(tenant))

    def sweep_expired(self) -> int:
        """Evict every aged-out row; returns how many were dropped."""
        if self.ttl is None:
            return 0
        with self._lock:
            cur = self._conn.execute(
                "DELETE FROM ctx WHERE created_at < ?",
                (float(self._clock()) - self.ttl,),
            )
            self._conn.commit()
            n = cur.rowcount if cur.rowcount and cur.rowcount > 0 else 0
            self.expired_total += n
            return n

    def __len__(self) -> int:
        return self._conn.execute("SELECT COUNT(*) FROM ctx").fetchone()[0]
